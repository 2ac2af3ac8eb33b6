// The flip of the flip-batched two-stack SWAG: one block per epoch row.
//
// Replaces: src/repro/kernels/swag/kernel.py, twostack_flip_pallas (its body
// _twostack_kernel runs repro.core.twostack.flip_scans per grid row).
//
// What it computes, per epoch row of [NE, W] (W = wcap, a power of two) and
// per op: the inclusive suffix scan of the front region's keys and the
// inclusive prefix scan of the back region's keys, lanes outside each region
// (mask 0) pinned to the op's identity.  The ops are the single-state monoids
// sum, count, min and max; count's state is int32 for any key.
//
// The sweeps are the plain version's, in its order: log2(W) Hillis-Steele
// steps, front f = op(f, shift_left(f, d)) and back b = op(shift_right(b, d),
// b), each lane reading the identity past the row's edge.  Every lane thus
// combines the same operands in the same tree as flip_scans does, so float
// sums equal the plain version bit for bit.  Each step reads one buffer and
// writes the other (double buffering), with one barrier a step.
//
// Bound on this card: memory.  Per lane the work reads two keys and two
// one-byte masks and writes two states per op (42 bytes a lane for the four
// ops); the sweeps run in shared memory, 2 regions x 2 buffers x 4 bytes a
// lane: 16 * W bytes, so W <= MAX_WCAP = 8192 (128 KiB of the 227 KiB a
// block may use).  The two-lane window picks and the final combine stay in
// torch, as they stay outside the TPU kernel.
#include "tile.cuh"

namespace rt {

constexpr int MAX_WCAP = 8192;

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

template <int OP, typename K>
__device__ void flip_op(const K* kf, const unsigned char* vf, const K* kb,
                        const unsigned char* vb, int W, long long base,
                        void* out_f, void* out_b, unsigned char* smem) {
  using C = Comb<OP, K>;
  using S = typename C::S;
  static_assert(sizeof(S) == 4, "two-stack states are one 32-bit word");
  S* f0 = reinterpret_cast<S*>(smem);
  S* f1 = f0 + W;
  S* b0 = f1 + W;
  S* b1 = b0 + W;
  const S id = Ident<OP, K>::v();
  for (int i = threadIdx.x; i < W; i += blockDim.x) {
    f0[i] = vf[base + i] ? C::lift(kf[base + i], i) : id;
    b0[i] = vb[base + i] ? C::lift(kb[base + i], i) : id;
  }
  __syncthreads();
  for (int d = 1; d < W; d <<= 1) {
    for (int i = threadIdx.x; i < W; i += blockDim.x) {
      f1[i] = C::op(f0[i], i + d < W ? f0[i + d] : id);
      b1[i] = C::op(i >= d ? b0[i - d] : id, b0[i]);
    }
    __syncthreads();
    S* t = f0; f0 = f1; f1 = t;
    t = b0; b0 = b1; b1 = t;
  }
  S* of = static_cast<S*>(out_f) + base;
  S* ob = static_cast<S*>(out_b) + base;
  for (int i = threadIdx.x; i < W; i += blockDim.x) {
    of[i] = f0[i];
    ob[i] = b0[i];
  }
  __syncthreads();  // the buffers are reused by the next op
}

template <typename K>
__global__ void __launch_bounds__(1024)
twostack_flip_kernel(const K* __restrict__ kf, const unsigned char* __restrict__ vf,
                     const K* __restrict__ kb, const unsigned char* __restrict__ vb,
                     int W, OpList ops) {
  extern __shared__ __align__(16) unsigned char dyn[];
  const long long base = static_cast<long long>(blockIdx.x) * W;
  for (int o = 0; o < ops.n; ++o) {
    void* out_f = ops.out[2 * o];
    void* out_b = ops.out[2 * o + 1];
    switch (ops.code[o]) {
      case OP_SUM: flip_op<OP_SUM, K>(kf, vf, kb, vb, W, base, out_f, out_b, dyn); break;
      case OP_COUNT: flip_op<OP_COUNT, K>(kf, vf, kb, vb, W, base, out_f, out_b, dyn); break;
      case OP_MIN: flip_op<OP_MIN, K>(kf, vf, kb, vb, W, base, out_f, out_b, dyn); break;
      case OP_MAX: flip_op<OP_MAX, K>(kf, vf, kb, vb, W, base, out_f, out_b, dyn); break;
      default: break;
    }
  }
}

template <typename K>
cudaError_t launch_twostack(const void* kf, const unsigned char* vf,
                            const void* kb, const unsigned char* vb, int ne,
                            int W, const OpList& ops, cudaStream_t st) {
  const size_t smem = static_cast<size_t>(W) * 16;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        twostack_flip_kernel<K>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const int threads = W < 32 ? 32 : (W > 1024 ? 1024 : W);
  twostack_flip_kernel<K><<<ne, threads, smem, st>>>(
      static_cast<const K*>(kf), vf, static_cast<const K*>(kb), vb, W, ops);
  return cudaGetLastError();
}

}  // namespace rt

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
