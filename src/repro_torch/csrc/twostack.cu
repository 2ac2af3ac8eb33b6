// The flip of the flip-batched two-stack SWAG: one block per epoch row.
//
// Replaces: src/repro/kernels/swag/kernel.py, twostack_flip_pallas (its body
// _twostack_kernel runs repro.core.twostack.flip_scans per grid row).
//
// What it computes, per epoch row of [NE, W] (W = wcap, a power of two) and
// per op: the inclusive suffix scan of the front region's keys and the
// inclusive prefix scan of the back region's keys, lanes whose bool mask is
// 0 pinned to the op's identity (any mask, not only a prefix).  The ops are
// the single-state monoids sum, count, min and max; count's state is int32
// for any key.
//
// Float sums, min and max sweep in the plain version's order: log2(W)
// Hillis-Steele steps, front f[i] = op(f[i], f[i + d]) and back b[i] =
// op(b[i - d], b[i]), each lane reading the identity past the row's edge.
// Every lane thus combines the same operands in the same tree as
// flip_scans does, so float sums equal the plain version bit for bit.  The
// ops on int32 states (int32 keys, and count) give the same bits in any
// order: int32 sums wrap, min and max pick one of their operands.  They
// take a work-efficient block scan instead.
//
// What bounds it on this card, and what the design does: device memory, 10
// bytes read and 8 a lane written per op (42 bytes a lane for the four
// ops).  The block reads the row's two key rows and two mask rows once,
// with coalesced 16-byte loads, into shared memory, and the ops run in turn
// from there; each thread lifts its L = 8 consecutive lanes into registers
// and runs both scans there.  (Keeping the inputs in registers too
// spilled: 16 more words past the 64 registers a thread has at 1024
// threads.)  An int32 state's scans: each thread scans its lanes, warps
// their thread totals by shuffles, warp 0 the warp totals, two barriers an
// op.  The plain tree's steps: a step's partner lanes come from the
// thread's own registers or, by one shuffle, its neighbour's (d < L), from
// thread t +- d / L by one shuffle (L <= d < 32 L), and through shared
// memory only across a warp's edge or for d >= 32 L; each step publishes
// those lanes to one of two shared buffers and passes one barrier, so an op
// takes log2(W) barriers and no full pass of shared memory below 32 L.
// The outputs leave registers as 16-byte stores.  Shared memory: 2 buffers
// x 2 regions x 4 bytes a lane (padded) and 10 bytes a lane of inputs, so
// W <= MAX_WCAP = 8192 (212 KiB of the 227 KiB a block may use).  The
// two-lane window picks and the final combine stay in torch, as they stay
// outside the TPU kernel.
#include "tile.cuh"

namespace rt {

constexpr int MAX_WCAP = 8192;
constexpr int FLIP_LANES = 8;  // lanes a thread

template <int OP, typename K> struct Ident;
template <typename K> struct Ident<OP_SUM, K> {
  static __device__ K v() { return K(0); }
};
template <typename K> struct Ident<OP_COUNT, K> {
  static __device__ int v() { return 0; }
};
template <> struct Ident<OP_MIN, int> {
  static __device__ int v() { return 0x7fffffff; }
};
template <> struct Ident<OP_MIN, float> {
  static __device__ float v() { return __int_as_float(0x7f800000); }  // +inf
};
template <> struct Ident<OP_MAX, int> {
  static __device__ int v() { return -0x7fffffff - 1; }
};
template <> struct Ident<OP_MAX, float> {
  static __device__ float v() { return __int_as_float(0xff800000); }  // -inf
};

__device__ __forceinline__ unsigned word_of(int x) {
  return static_cast<unsigned>(x);
}
__device__ __forceinline__ unsigned word_of(float x) {
  return __float_as_uint(x);
}
template <typename S> __device__ __forceinline__ S of_word(unsigned u);
template <> __device__ __forceinline__ int of_word<int>(unsigned u) {
  return static_cast<int>(u);
}
template <> __device__ __forceinline__ float of_word<float>(unsigned u) {
  return __uint_as_float(u);
}

template <typename S>
__device__ __forceinline__ S shfl_down_word(S v, int d) {
  return of_word<S>(__shfl_down_sync(FULL_MASK, word_of(v), d));
}
template <typename S>
__device__ __forceinline__ S shfl_up_word(S v, int d) {
  return of_word<S>(__shfl_up_sync(FULL_MASK, word_of(v), d));
}

// The thread's L states to p (16-byte aligned) as 16-byte stores.
template <typename S, int L>
__device__ __forceinline__ void store_lanes(S* p, const S (&x)[L]) {
#pragma unroll
  for (int q = 0; q < L / 4; ++q)
    reinterpret_cast<uint4*>(p)[q] =
        make_uint4(word_of(x[4 * q]), word_of(x[4 * q + 1]),
                   word_of(x[4 * q + 2]), word_of(x[4 * q + 3]));
}

// The thread's L lanes of one staged region, lifted, the identity where
// the mask is 0 or past the row; with vec (W >= 16) by vector reads.
template <class C, int L>
__device__ __forceinline__ void lift_lanes(const typename C::Key* sk,
                                           const unsigned char* sv, int W,
                                           int base, int vec,
                                           typename C::S id,
                                           typename C::S (&x)[L]) {
  using K = typename C::Key;
  static_assert(L == 8, "the vector reads take 8 lanes");
  if (vec) {
    if (base >= W) {
#pragma unroll
      for (int j = 0; j < L; ++j) x[j] = id;
      return;
    }
    const uint4 k0 = reinterpret_cast<const uint4*>(sk + base)[0];
    const uint4 k1 = reinterpret_cast<const uint4*>(sk + base)[1];
    const uint2 m = *reinterpret_cast<const uint2*>(sv + base);
    const unsigned kw[L] = {k0.x, k0.y, k0.z, k0.w, k1.x, k1.y, k1.z, k1.w};
#pragma unroll
    for (int j = 0; j < L; ++j) {
      const unsigned mw = j < 4 ? m.x : m.y;
      x[j] = (mw >> (8 * (j & 3))) & 0xffu
          ? C::lift(of_word<K>(kw[j]), base + j) : id;
    }
  } else {
#pragma unroll
    for (int j = 0; j < L; ++j) {
      const int i = base + j;
      x[j] = i < W && sv[i] ? C::lift(sk[i], i) : id;
    }
  }
}

// Step d = D < L of both scans (then D * 2, up to L / 2): the partners of
// the thread's lanes are its own lanes or the first (front) or last (back)
// D lanes of its neighbour, by one shuffle each; across a warp's edge
// through shared memory.  D is a template argument so that every register
// index is known at compile time.
template <int D, int OP, typename K, int L>
__device__ __forceinline__ void near_steps(typename Comb<OP, K>::S (&f)[L],
                                           typename Comb<OP, K>::S (&b)[L],
                                           int W, typename Comb<OP, K>::S* sh,
                                           int P, int& step) {
  if constexpr (D < L) {
    using C = Comb<OP, K>;
    using S = typename C::S;
    if (D >= W) return;
    const S id = Ident<OP, K>::v();
    const int lane = threadIdx.x & 31, base = threadIdx.x * L;
    S* sf = sh + (step & 1) * 2 * P;
    S* sb = sf + P;
    if (lane == 0)
#pragma unroll
      for (int j = 0; j < L; ++j) sf[pad32(base + j)] = f[j];
    if (lane == 31)
#pragma unroll
      for (int j = 0; j < L; ++j) sb[pad32(base + j)] = b[j];
    __syncthreads();
    S o[D];
#pragma unroll
    for (int m = 0; m < D; ++m) {
      o[m] = shfl_down_word(f[m], 1);
      const int i = base + L + m;
      if (i >= W) o[m] = id;
      else if (lane == 31) o[m] = sf[pad32(i)];
    }
#pragma unroll
    for (int j = 0; j < L; ++j)  // ascending: f[j + D] is still the old one
      f[j] = C::op(f[j], j + D < L ? f[j + D] : o[j + D - L]);
#pragma unroll
    for (int m = 0; m < D; ++m) {
      o[m] = shfl_up_word(b[L - D + m], 1);
      const int i = base - D + m;
      if (i < 0) o[m] = id;
      else if (lane == 0) o[m] = sb[pad32(i)];
    }
#pragma unroll
    for (int j = L - 1; j >= 0; --j)  // descending: b[j - D] is the old one
      b[j] = C::op(j >= D ? b[j - D] : o[j], b[j]);
    ++step;
    near_steps<2 * D, OP, K, L>(f, b, W, sh, P, step);
  }
}

// Both scans of an op whose result does not depend on the order of its
// combines (int32 sums wrap, so they form a group; min, max and count are
// exact in any order): each thread scans its L lanes in registers, warps
// scan the thread totals by shuffles and warp 0 the warp totals, two
// barriers in all.  wt: 64 words of shared memory for the warp totals.
template <class C, int L>
__device__ __forceinline__ void block_scans(typename C::S (&f)[L],
                                            typename C::S (&b)[L],
                                            typename C::S id,
                                            typename C::S* wt) {
  using S = typename C::S;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
#pragma unroll
  for (int j = 1; j < L; ++j) b[j] = C::op(b[j - 1], b[j]);
#pragma unroll
  for (int j = L - 2; j >= 0; --j) f[j] = C::op(f[j], f[j + 1]);
  S tb = b[L - 1], tf = f[0];  // prefix / suffix over the warp's threads
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const S ob = shfl_up_word(tb, d), of = shfl_down_word(tf, d);
    if (lane >= d) tb = C::op(ob, tb);
    if (lane + d < 32) tf = C::op(tf, of);
  }
  S* wb = wt;
  S* wf = wt + 32;
  if (lane == 31) wb[warp] = tb;
  if (lane == 0) wf[warp] = tf;
  __syncthreads();
  if (warp == 0) {
    S x = lane < nwarps ? wb[lane] : id, y = lane < nwarps ? wf[lane] : id;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const S ox = shfl_up_word(x, d), oy = shfl_down_word(y, d);
      if (lane >= d) x = C::op(ox, x);
      if (lane + d < 32) y = C::op(y, oy);
    }
    if (lane < nwarps) {
      wb[lane] = x;
      wf[lane] = y;
    }
  }
  __syncthreads();
  S eb = shfl_up_word(tb, 1), ef = shfl_down_word(tf, 1);
  if (lane == 0) eb = id;
  if (lane == 31) ef = id;
  if (warp > 0) eb = C::op(wb[warp - 1], eb);
  if (warp + 1 < nwarps) ef = C::op(ef, wf[warp + 1]);
#pragma unroll
  for (int j = 0; j < L; ++j) {
    b[j] = C::op(eb, b[j]);
    f[j] = C::op(f[j], ef);
  }
}

// Both scans of an op in the plain version's tree (float sums, min and
// max): the Hillis-Steele steps d = 1, 2, 4, ... < W, each combining the
// same two operands as flip_scans does.
template <int OP, typename K, int L>
__device__ __forceinline__ void tree_scans(typename Comb<OP, K>::S (&f)[L],
                                           typename Comb<OP, K>::S (&b)[L],
                                           int W, typename Comb<OP, K>::S* sh,
                                           int P, int& step) {
  using C = Comb<OP, K>;
  using S = typename C::S;
  const S id = Ident<OP, K>::v();
  const int lane = threadIdx.x & 31, base = threadIdx.x * L;
  near_steps<1, OP, K, L>(f, b, W, sh, P, step);
  int d = L;
  // L <= d < 32 L: lane j of thread t +- d / L, across a warp's edge
  // through shared memory
  for (; d < W && d < 32 * L; d <<= 1) {
    const int dt = d / L;
    S* sf = sh + (step & 1) * 2 * P;
    S* sb = sf + P;
    if (lane < dt)
#pragma unroll
      for (int j = 0; j < L; ++j) sf[pad32(base + j)] = f[j];
    if (lane >= 32 - dt)
#pragma unroll
      for (int j = 0; j < L; ++j) sb[pad32(base + j)] = b[j];
    __syncthreads();
#pragma unroll
    for (int j = 0; j < L; ++j) {
      S o = shfl_down_word(f[j], dt);
      const int i = base + j + d;
      if (i >= W) o = id;
      else if (lane + dt >= 32) o = sf[pad32(i)];
      f[j] = C::op(f[j], o);
    }
#pragma unroll
    for (int j = 0; j < L; ++j) {
      S o = shfl_up_word(b[j], dt);
      const int i = base + j - d;
      if (i < 0) o = id;
      else if (lane < dt) o = sb[pad32(i)];
      b[j] = C::op(o, b[j]);
    }
    ++step;
  }
  // d >= 32 L: every lane through shared memory
  for (; d < W; d <<= 1) {
    S* sf = sh + (step & 1) * 2 * P;
    S* sb = sf + P;
#pragma unroll
    for (int j = 0; j < L; ++j) {
      sf[pad32(base + j)] = f[j];
      sb[pad32(base + j)] = b[j];
    }
    __syncthreads();
#pragma unroll
    for (int j = 0; j < L; ++j) {
      const int i = base + j + d, k = base + j - d;
      f[j] = C::op(f[j], i < W ? sf[pad32(i)] : id);
      b[j] = C::op(k >= 0 ? sb[pad32(k)] : id, b[j]);
    }
    ++step;
  }
}

// The two scans of one op over the staged row (keys skf/skb, masks
// svf/svb).  sh: two buffers of the front and back exchange rows (P words
// each); step: the buffer parity, carried across ops.
template <int OP, typename K, int L>
__device__ __forceinline__ void flip_op(const K* skf, const unsigned char* svf,
                                        const K* skb, const unsigned char* svb,
                                        int W, long long row, void* out_f,
                                        void* out_b, int vec,
                                        unsigned char* smem, int& step) {
  using C = Comb<OP, K>;
  using S = typename C::S;
  static_assert(sizeof(S) == 4, "two-stack states are one 32-bit word");
  const S id = Ident<OP, K>::v();
  const int base = threadIdx.x * L;
  const int P = pad32(blockDim.x * L);
  S* const sh = reinterpret_cast<S*>(smem);
  S f[L], b[L];
  lift_lanes<C, L>(skf, svf, W, base, vec, id, f);
  lift_lanes<C, L>(skb, svb, W, base, vec, id, b);
  if constexpr (std::is_same<S, int>::value) {
    block_scans<C, L>(f, b, id, sh + (step & 1) * 2 * P);
    ++step;
  } else {
    tree_scans<OP, K, L>(f, b, W, sh, P, step);
  }
  S* of = static_cast<S*>(out_f) + row + base;
  S* ob = static_cast<S*>(out_b) + row + base;
  if (vec) {
    if (base < W) {
      store_lanes(of, f);
      store_lanes(ob, b);
    }
  } else {
#pragma unroll
    for (int j = 0; j < L; ++j)
      if (base + j < W) {
        of[j] = f[j];
        ob[j] = b[j];
      }
  }
}

// The exchange rows reuse one buffer every other step: a thread writes
// buffer s & 1 at step s only after the barrier of step s - 1, which every
// thread passes after its reads of step s - 2.
template <typename K, int L>
__global__ void __launch_bounds__(1024)
twostack_flip_kernel(const K* __restrict__ kf, const unsigned char* __restrict__ vf,
                     const K* __restrict__ kb, const unsigned char* __restrict__ vb,
                     int W, OpList ops, int vec) {
  extern __shared__ __align__(16) unsigned char dyn[];
  const int t = threadIdx.x, n = blockDim.x;
  const long long row = static_cast<long long>(blockIdx.x) * W;
  // the row's inputs, read once: keys and masks after the exchange rows
  K* skf = reinterpret_cast<K*>(dyn + 16 * static_cast<size_t>(pad32(n * L)));
  K* skb = skf + W;
  unsigned char* svf = reinterpret_cast<unsigned char*>(skb + W);
  unsigned char* svb = svf + W;
  if (vec) {  // W >= 16: whole 16-byte chunks
    for (int c = t; c < W / 4; c += n) {
      reinterpret_cast<uint4*>(skf)[c] = reinterpret_cast<const uint4*>(kf + row)[c];
      reinterpret_cast<uint4*>(skb)[c] = reinterpret_cast<const uint4*>(kb + row)[c];
    }
    for (int c = t; c < W / 16; c += n) {
      reinterpret_cast<uint4*>(svf)[c] = reinterpret_cast<const uint4*>(vf + row)[c];
      reinterpret_cast<uint4*>(svb)[c] = reinterpret_cast<const uint4*>(vb + row)[c];
    }
  } else {
    for (int i = t; i < W; i += n) {
      skf[i] = kf[row + i];
      skb[i] = kb[row + i];
      svf[i] = vf[row + i];
      svb[i] = vb[row + i];
    }
  }
  __syncthreads();
  int step = 0;
  for (int o = 0; o < ops.n; ++o) {
    void* out_f = ops.out[2 * o];
    void* out_b = ops.out[2 * o + 1];
    switch (ops.code[o]) {
      case OP_SUM: flip_op<OP_SUM, K, L>(skf, svf, skb, svb, W, row, out_f, out_b, vec, dyn, step); break;
      case OP_COUNT: flip_op<OP_COUNT, K, L>(skf, svf, skb, svb, W, row, out_f, out_b, vec, dyn, step); break;
      case OP_MIN: flip_op<OP_MIN, K, L>(skf, svf, skb, svb, W, row, out_f, out_b, vec, dyn, step); break;
      case OP_MAX: flip_op<OP_MAX, K, L>(skf, svf, skb, svb, W, row, out_f, out_b, vec, dyn, step); break;
      default: break;
    }
  }
}

// Launch shape of an epoch row of W lanes: L lanes a thread, threads =
// max(W, 32 L) / L, and in shared memory the two exchange buffers of the
// front and back rows and the row's keys and masks.
struct FlipGeometry { int lanes, threads; size_t smem; };

FlipGeometry flip_geometry(int W) {
  FlipGeometry g;
  g.lanes = FLIP_LANES;
  const int tp = W > 32 * g.lanes ? W : 32 * g.lanes;
  g.threads = tp / g.lanes;
  g.smem = 2 * 2 * 4 * static_cast<size_t>(pad32(tp)) +
           (2 * 4 + 2) * static_cast<size_t>(W);
  return g;
}

template <typename K>
cudaError_t launch_twostack(const void* kf, const unsigned char* vf,
                            const void* kb, const unsigned char* vb, int ne,
                            int W, const OpList& ops, cudaStream_t st) {
  const FlipGeometry geo = flip_geometry(W);
  auto kern = twostack_flip_kernel<K, FLIP_LANES>;
  if (geo.smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(geo.smem));
    if (err != cudaSuccess) return err;
  }
  // two blocks an SM at W = 4096 need the largest shared-memory carveout
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributePreferredSharedMemoryCarveout,
      cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return err;
  int vec = W >= 16 && aligned16(kf) && aligned16(kb) && aligned16(vf) &&
            aligned16(vb);
  for (int i = 0; i < 2 * ops.n; ++i) vec = vec && aligned16(ops.out[i]);
  kern<<<ne, geo.threads, geo.smem, st>>>(
      static_cast<const K*>(kf), vf, static_cast<const K*>(kb), vb, W, ops,
      vec);
  return cudaGetLastError();
}

}  // namespace rt

// The launch shape rt_twostack_flip takes for epoch rows of W lanes.
extern "C" int rt_twostack_geometry(int W, int* lanes, int* threads,
                                    long long* smem) {
  using namespace rt;
  if (W < 1 || W > MAX_WCAP || (W & (W - 1))) return cudaErrorInvalidValue;
  const FlipGeometry g = flip_geometry(W);
  *lanes = g.lanes;
  *threads = g.threads;
  *smem = static_cast<long long>(g.smem);
  return 0;
}

// kf/kb: [ne, W] keys; vf/vb: [ne, W] bool masks (one byte a lane); codes[i]
// one of sum/count/min/max; outs[2i], outs[2i + 1]: op i's front suffix and
// back prefix, [ne, W] each, in the op's state type.
extern "C" int rt_twostack_flip(const void* kf, const void* vf, const void* kb,
                                const void* vb, int key_type, int ne, int W,
                                const int* codes, void* const* outs, int nops,
                                void* stream) {
  using namespace rt;
  if (ne <= 0 || W < 1 || W > MAX_WCAP || (W & (W - 1)) || nops < 1 ||
      2 * nops > MAX_OPS)
    return cudaErrorInvalidValue;
  OpList ops;
  ops.n = nops;
  for (int i = 0; i < nops; ++i) {
    if (codes[i] != OP_SUM && codes[i] != OP_COUNT && codes[i] != OP_MIN &&
        codes[i] != OP_MAX)
      return cudaErrorInvalidValue;
    ops.code[i] = codes[i];
    ops.out[2 * i] = outs[2 * i];
    ops.out[2 * i + 1] = outs[2 * i + 1];
  }
  auto st = static_cast<cudaStream_t>(stream);
  auto mf = static_cast<const unsigned char*>(vf);
  auto mb = static_cast<const unsigned char*>(vb);
  if (key_type == KEY_INT32) return launch_twostack<int>(kf, mf, kb, mb, ne, W, ops, st);
  if (key_type == KEY_FLOAT32) return launch_twostack<float>(kf, mf, kb, mb, ne, W, ops, st);
  return cudaErrorInvalidValue;
}
