// Row-wise bitonic sort by 1-4 keys with payloads: one block per row.
//
// Replaces: src/repro/kernels/bitonic/kernel.py, bitonic_pallas (its body
// runs kernels/common.bitonic_sort_tile on each grid row).
//
// What it computes: each row of [R, T] operands (T a power of two) sorted by
// the leading num_keys operands, lexicographically, ascending; every other
// operand (a payload) follows its keys.  The network is the TPU kernel's:
// stage (kk, j) pairs lane i (bit j clear) with i + j, ascending iff bit kk
// of i is clear, and a pair swaps only when the later lane's keys are
// strictly less (floats compare as floats: -0.0 == 0.0, a NaN stops the
// compare).  So every input, ties, signed zeros and NaNs included, ends in
// the TPU network's permutation; the swaps depend on the keys alone, so the
// kernel sorts the raw key words with each lane's index and gathers every
// payload once through the final permutation.
//
// What bounds it on this card, and what the design does: the network's
// log2(T) (log2(T) + 1) / 2 compare-exchange stages (55 at 1024 lanes).
// Device memory sees each operand read once and written once.  Each thread
// holds L = 8 consecutive lanes as their NK key words and lane index in
// registers: a stage of stride j < L runs in registers, L <= j < 32 L by
// __shfl_xor_sync of every word, both partners evaluating the same strict
// compare on the same (lower, upper) pair and each keeping its own side;
// only the strides of 32 L and more go through shared memory behind a
// barrier (3 of the 55 stages at 1024 lanes).  A block has at most 1024
// threads (512 with three or four keys, whose words take more registers),
// so a longer row lives in shared memory and each thread runs the stages
// under 32 L on its two chunks of it in turn.  The keys are never packed
// into one order-keeping word: that would put -0.0 below +0.0 (or drop its
// sign) and give a NaN a place in the order.  Keys are read and written
// with 16-byte vector accesses; a payload row is staged in shared memory
// by coalesced loads and gathered from there through the lane indices.  A
// row must fit one block's shared memory: T <= 16384 with one or two keys,
// T <= 8192 with three or four (the wrapper states both limits).
#include "tile.cuh"

namespace rt {

constexpr int MAX_SORT_KEYS = 4;
constexpr int MAX_PAYLOADS = 16;
constexpr int SMEM_LIMIT = 232448;  // shared memory a block may use

struct SortArgs {
  const void* key[MAX_SORT_KEYS];
  void* okey[MAX_SORT_KEYS];
  unsigned float_keys;  // bit j set: key j is float32, else int32
  int np;
  const void* pay[MAX_PAYLOADS];
  void* opay[MAX_PAYLOADS];
  int psize[MAX_PAYLOADS];  // element bytes: 1, 2, 4 or 8
  int vec;                  // keys in and out are 16-byte aligned, T >= L
};

// How the keys compare, the kernel's FK: with one or two keys, FK is the
// float_keys mask itself, known at compile time; with three or four, 0
// (all int32) or KEYS_AT_RUN_TIME (each key as bit j of float_keys says).
constexpr int KEYS_AT_RUN_TIME = -1;

template <int NK> struct SortLane {
  unsigned k[NK];  // the raw key words
  int ix;          // the lane the keys came from
};

// Strict lexicographic a < b, as _lex_less: a key that is neither less nor
// equal (a NaN) ends the compare with "not less".
template <int NK, int FK>
__device__ __forceinline__ bool lane_less(const SortLane<NK>& a,
                                          const SortLane<NK>& b, unsigned fk) {
  bool less = false, eq = true;
#pragma unroll
  for (int j = 0; j < NK; ++j) {
    const bool is_float = FK == KEYS_AT_RUN_TIME ? ((fk >> j) & 1u) != 0
                                                 : ((FK >> j) & 1) != 0;
    const int xi = static_cast<int>(a.k[j]), yi = static_cast<int>(b.k[j]);
    bool lt = xi < yi, e = xi == yi;
    if (is_float) {
      const float xf = __uint_as_float(a.k[j]), yf = __uint_as_float(b.k[j]);
      lt = xf < yf;
      e = xf == yf;
    }
    less = less || (eq && lt);
    eq = eq && e;
  }
  return less;
}

// The pair (lo, hi) of a stage swaps when hi < lo ascending, lo < hi
// descending.
template <int NK, int FK>
__device__ __forceinline__ bool must_swap(const SortLane<NK>& lo,
                                          const SortLane<NK>& hi, bool up,
                                          unsigned fk) {
  return up ? lane_less<NK, FK>(hi, lo, fk) : lane_less<NK, FK>(lo, hi, fk);
}

template <int NK>
__device__ __forceinline__ void swap_if(bool sw, SortLane<NK>& a,
                                        SortLane<NK>& b) {
#pragma unroll
  for (int w = 0; w < NK; ++w) {
    const unsigned x = sw ? b.k[w] : a.k[w];
    b.k[w] = sw ? a.k[w] : b.k[w];
    a.k[w] = x;
  }
  const int x = sw ? b.ix : a.ix;
  b.ix = sw ? a.ix : b.ix;
  a.ix = x;
}

template <int NK>
__device__ __forceinline__ SortLane<NK> shfl_xor_lane(const SortLane<NK>& v,
                                                      int d) {
  SortLane<NK> o;
#pragma unroll
  for (int w = 0; w < NK; ++w) o.k[w] = __shfl_xor_sync(FULL_MASK, v.k[w], d);
  o.ix = __shfl_xor_sync(FULL_MASK, v.ix, d);
  return o;
}

// Shared-memory row of the wide strides: NK key arrays and the lane
// indices, each of P = pad32(lanes) words.
template <int NK>
__device__ __forceinline__ void put_lane(unsigned* s, int P, int i,
                                         const SortLane<NK>& v) {
#pragma unroll
  for (int w = 0; w < NK; ++w) s[w * P + pad32(i)] = v.k[w];
  s[NK * P + pad32(i)] = static_cast<unsigned>(v.ix);
}
template <int NK>
__device__ __forceinline__ SortLane<NK> get_lane(const unsigned* s, int P,
                                                 int i) {
  SortLane<NK> v;
#pragma unroll
  for (int w = 0; w < NK; ++w) v.k[w] = s[w * P + pad32(i)];
  v.ix = static_cast<int>(s[NK * P + pad32(i)]);
  return v;
}

// One payload row through the final lane indices (sidx, pad32 layout):
// staged in shared memory by coalesced loads, then gathered with coalesced
// stores.
template <typename P>
__device__ void gather_payload(const void* in, void* out, long long row,
                               int T, const int* sidx, unsigned char* buf) {
  const P* src = static_cast<const P*>(in) + row;
  P* dst = static_cast<P*>(out) + row;
  P* sb = reinterpret_cast<P*>(buf);
  const int bytes = T * static_cast<int>(sizeof(P));
  if ((reinterpret_cast<uintptr_t>(src) & 15) == 0 && bytes % 16 == 0) {
    const uint4* s4 = reinterpret_cast<const uint4*>(src);
    uint4* b4 = reinterpret_cast<uint4*>(buf);
    for (int c = threadIdx.x; c < bytes / 16; c += blockDim.x) b4[c] = s4[c];
  } else {
    for (int i = threadIdx.x; i < T; i += blockDim.x) sb[i] = src[i];
  }
  __syncthreads();
  for (int i = threadIdx.x; i < T; i += blockDim.x) dst[i] = sb[sidx[pad32(i)]];
  __syncthreads();  // the buffer is reused by the next payload
}

// Lanes a thread, and the largest block: 1024 threads with one or two keys
// (at most 64 registers a thread), 512 with three or four (128).  A block
// of n threads holds n * SORT_LANES lanes; a longer row (16384 lanes, or
// 8192 with three or four keys) lives in shared memory and each thread
// sorts its V = 2 chunks of it in turn.
constexpr int SORT_LANES = 8;
__host__ __device__ constexpr int sort_max_threads(int nk) {
  return nk <= 2 ? 1024 : 512;
}

// One thread's L lanes at `base` of the row, from device memory.
template <int NK, int L>
__device__ __forceinline__ void load_row_lanes(const SortArgs& a, long long row,
                                               int T, int base,
                                               SortLane<NK> (&v)[L]) {
#pragma unroll
  for (int j = 0; j < L; ++j) v[j].ix = base + j;
  if (a.vec) {
#pragma unroll
    for (int w = 0; w < NK; ++w) {
      const uint4* src = reinterpret_cast<const uint4*>(
          static_cast<const unsigned*>(a.key[w]) + row + base);
#pragma unroll
      for (int q = 0; q < L / 4; ++q) {
        const uint4 x = base < T ? src[q] : make_uint4(0, 0, 0, 0);
        v[4 * q].k[w] = x.x;
        v[4 * q + 1].k[w] = x.y;
        v[4 * q + 2].k[w] = x.z;
        v[4 * q + 3].k[w] = x.w;
      }
    }
  } else {
#pragma unroll
    for (int j = 0; j < L; ++j)
#pragma unroll
      for (int w = 0; w < NK; ++w)
        v[j].k[w] = base + j < T
            ? static_cast<const unsigned*>(a.key[w])[row + base + j] : 0u;
  }
}

// The sorted keys of the thread's lanes to device memory, and their lane
// indices to sidx (pad32 layout), at positions only this thread reads.
template <int NK, int L>
__device__ __forceinline__ void finish_lanes(const SortArgs& a, long long row,
                                             int T, int base,
                                             const SortLane<NK> (&v)[L],
                                             int* sidx) {
#pragma unroll
  for (int w = 0; w < NK; ++w) {
    unsigned* dst = static_cast<unsigned*>(a.okey[w]) + row + base;
    if (a.vec) {
      if (base < T) {
#pragma unroll
        for (int q = 0; q < L / 4; ++q)
          reinterpret_cast<uint4*>(dst)[q] =
              make_uint4(v[4 * q].k[w], v[4 * q + 1].k[w], v[4 * q + 2].k[w],
                         v[4 * q + 3].k[w]);
      }
    } else {
#pragma unroll
      for (int j = 0; j < L; ++j)
        if (base + j < T) dst[j] = v[j].k[w];
    }
  }
  if (a.np > 0)  // no payload: the row may have no shared memory at all
#pragma unroll
    for (int j = 0; j < L; ++j) sidx[pad32(base + j)] = v[j].ix;
}

// Stage (kk, jj) for every jj < jj0: strides of L and more by shuffles
// (jj0 <= 16 L), then the strides under L in registers.  up: bit kk of the
// thread's lanes is clear (kk >= 2 L, so all its lanes agree).
template <int NK, int FK, int L>
__device__ __forceinline__ void sub_warp_stages(SortLane<NK> (&v)[L], int jj0,
                                                bool up, unsigned fk) {
  const int lane = threadIdx.x & 31;
  for (int jj = jj0; jj >= L; jj >>= 1) {
    // partner thread t ^ d holds the other lane of each of this thread's
    // pairs; both test the pair in (lower, upper) order, so they agree
    const int d = jj / L;
    const bool lower = (lane & d) == 0;
#pragma unroll
    for (int j = 0; j < L; ++j) {
      const SortLane<NK> o = shfl_xor_lane(v[j], d);
      const bool sw = lower ? must_swap<NK, FK>(v[j], o, up, fk)
                            : must_swap<NK, FK>(o, v[j], up, fk);
      if (sw) v[j] = o;
    }
  }
#pragma unroll
  for (int jj = L / 2; jj > 0; jj >>= 1)
#pragma unroll
    for (int j = 0; j < L; ++j)
      if ((j & jj) == 0)
        swap_if(must_swap<NK, FK>(v[j], v[j + jj], up, fk), v[j], v[j + jj]);
}

// Every stage kk <= head (head <= 32 L): the network of each warp's span.
template <int NK, int FK, int L>
__device__ __forceinline__ void head_stages(SortLane<NK> (&v)[L], int base,
                                            int head, unsigned fk) {
#pragma unroll
  for (int kk = 2; kk <= L; kk <<= 1) {
    if (kk > head) break;
#pragma unroll
    for (int jj = kk >> 1; jj > 0; jj >>= 1)
#pragma unroll
      for (int j = 0; j < L; ++j)
        if ((j & jj) == 0)
          swap_if(must_swap<NK, FK>(v[j], v[j + jj],
                                    ((base + j) & kk) == 0, fk),
                  v[j], v[j + jj]);
  }
  for (int kk = 2 * L; kk <= head; kk <<= 1)
    sub_warp_stages<NK, FK, L>(v, kk >> 1, (base & kk) == 0, fk);
}

// Stage (kk, jj) for jj = kk / 2 down to 32 L over the shared row, one
// barrier after each.
template <int NK, int FK>
__device__ __forceinline__ void wide_stages(unsigned* s, int P, int Tp, int kk,
                                            int span, unsigned fk) {
  for (int jj = kk >> 1; jj >= span; jj >>= 1) {
    for (int p = threadIdx.x; p < Tp / 2; p += blockDim.x) {
      const int i = ((p & ~(jj - 1)) << 1) | (p & (jj - 1));
      SortLane<NK> x = get_lane<NK>(s, P, i), y = get_lane<NK>(s, P, i + jj);
      if (must_swap<NK, FK>(x, y, (i & kk) == 0, fk)) {
        put_lane(s, P, i, y);
        put_lane(s, P, i + jj, x);
      }
    }
    __syncthreads();
  }
}

// Lanes past T (rows shorter than 32 L) are never paired with a lane of
// the row: every stage pairs lanes inside one kk-block, kk <= T.  Each
// thread reads back from the shared row only its own lanes, which no other
// thread writes before the next barrier.
template <int NK, int FK>
__global__ void __launch_bounds__(NK <= 2 ? 1024 : 512)
bitonic_rows_kernel(SortArgs a, int T) {
  constexpr int L = SORT_LANES;
  extern __shared__ __align__(16) unsigned char dyn[];
  unsigned* s = reinterpret_cast<unsigned*>(dyn);
  int* sidx = reinterpret_cast<int*>(dyn);
  const int t = threadIdx.x, n = blockDim.x;
  const int Tp = T > 32 * L ? T : 32 * L, P = pad32(Tp);
  const int V = Tp / (n * L);  // chunks a thread sorts in turn
  const long long row = static_cast<long long>(blockIdx.x) * T;
  const unsigned fk = a.float_keys;
  SortLane<NK> v[L];
  if (V == 1) {  // the row in registers; shared memory for jj >= 32 L
    const int base = t * L;
    load_row_lanes(a, row, T, base, v);
    head_stages<NK, FK, L>(v, base, T < 32 * L ? T : 32 * L, fk);
    for (int kk = 64 * L; kk <= T; kk <<= 1) {
#pragma unroll
      for (int j = 0; j < L; ++j) put_lane(s, P, base + j, v[j]);
      __syncthreads();
      wide_stages<NK, FK>(s, P, Tp, kk, 32 * L, fk);
#pragma unroll
      for (int j = 0; j < L; ++j) v[j] = get_lane<NK>(s, P, base + j);
      sub_warp_stages<NK, FK, L>(v, 16 * L, (base & kk) == 0, fk);
    }
    finish_lanes(a, row, T, base, v, sidx);
  } else {  // the row in shared memory (T >= 64 L), each chunk in turn
    for (int c = 0; c < V; ++c) {
      const int base = (c * n + t) * L;
      load_row_lanes(a, row, T, base, v);
      head_stages<NK, FK, L>(v, base, 32 * L, fk);
#pragma unroll
      for (int j = 0; j < L; ++j) put_lane(s, P, base + j, v[j]);
    }
    for (int kk = 64 * L; kk <= T; kk <<= 1) {
      __syncthreads();
      wide_stages<NK, FK>(s, P, Tp, kk, 32 * L, fk);
      for (int c = 0; c < V; ++c) {
        const int base = (c * n + t) * L;
#pragma unroll
        for (int j = 0; j < L; ++j) v[j] = get_lane<NK>(s, P, base + j);
        sub_warp_stages<NK, FK, L>(v, 16 * L, (base & kk) == 0, fk);
        if (kk == T) {
          finish_lanes(a, row, T, base, v, sidx);
        } else {
#pragma unroll
          for (int j = 0; j < L; ++j) put_lane(s, P, base + j, v[j]);
        }
      }
    }
  }
  if (a.np == 0) return;
  // every thread has read its lanes back: the row's other words may go
  unsigned char* buf = dyn + ((4 * P + 15) & ~15);
  __syncthreads();
  for (int p = 0; p < a.np; ++p) {
    switch (a.psize[p]) {
      case 1: gather_payload<unsigned char>(a.pay[p], a.opay[p], row, T, sidx, buf); break;
      case 2: gather_payload<unsigned short>(a.pay[p], a.opay[p], row, T, sidx, buf); break;
      case 4: gather_payload<unsigned>(a.pay[p], a.opay[p], row, T, sidx, buf); break;
      case 8: gather_payload<unsigned long long>(a.pay[p], a.opay[p], row, T, sidx, buf); break;
      default: break;
    }
  }
}

// Launch shape of a row of T lanes sorted by nk keys with payloads of at
// most max_psize bytes an element (0: none): L lanes a thread, threads =
// max(T, 32 L) / L up to sort_max_threads(nk), and the dynamic shared
// memory: the padded key words and indices of the row (rows past 32 L), or
// the indices and one staged payload row, whichever is larger.
struct SortGeometry { int lanes, threads; size_t smem; };

SortGeometry sort_geometry(int nk, int T, int max_psize) {
  SortGeometry g;
  g.lanes = SORT_LANES;
  const int tp = T > 32 * g.lanes ? T : 32 * g.lanes;
  g.threads = tp / g.lanes < sort_max_threads(nk) ? tp / g.lanes
                                                  : sort_max_threads(nk);
  const size_t words = 4 * static_cast<size_t>(pad32(tp));
  const size_t wide = T > 32 * g.lanes ? (nk + 1) * words : 0;
  const size_t gather = max_psize > 0
      ? ((words + 15) & ~static_cast<size_t>(15)) +
            static_cast<size_t>(max_psize) * T
      : 0;
  g.smem = wide > gather ? wide : gather;
  return g;
}

template <int NK, int FK>
cudaError_t launch_bitonic(const SortArgs& a, int R, int T,
                           const SortGeometry& geo, cudaStream_t st) {
  auto kern = bitonic_rows_kernel<NK, FK>;
  if (geo.smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(geo.smem));
    if (err != cudaSuccess) return err;
  }
  kern<<<R, geo.threads, geo.smem, st>>>(a, T);
  return cudaGetLastError();
}

// One or two keys: an instantiation a float_keys mask (their key words
// fill the 64 registers of a 1024-thread block, and a compare of both
// types would spill); three or four: all int32, or typed at run time.
template <int NK>
cudaError_t launch_keys(const SortArgs& a, int R, int T,
                        const SortGeometry& geo, cudaStream_t st) {
  if constexpr (NK == 1) {
    if (a.float_keys) return launch_bitonic<1, 1>(a, R, T, geo, st);
    return launch_bitonic<1, 0>(a, R, T, geo, st);
  } else if constexpr (NK == 2) {
    switch (a.float_keys) {
      case 0: return launch_bitonic<2, 0>(a, R, T, geo, st);
      case 1: return launch_bitonic<2, 1>(a, R, T, geo, st);
      case 2: return launch_bitonic<2, 2>(a, R, T, geo, st);
      default: return launch_bitonic<2, 3>(a, R, T, geo, st);
    }
  } else {
    if (a.float_keys) return launch_bitonic<NK, KEYS_AT_RUN_TIME>(a, R, T, geo, st);
    return launch_bitonic<NK, 0>(a, R, T, geo, st);
  }
}

}  // namespace rt

// The launch shape rt_bitonic_sort takes for nk keys, rows of T lanes and
// payloads of at most max_psize bytes an element (0: none).
extern "C" int rt_bitonic_geometry(int nk, int T, int max_psize, int* lanes,
                                   int* threads, long long* smem) {
  using namespace rt;
  if (nk < 1 || nk > MAX_SORT_KEYS || T < 1 || T > MAX_ROW || (T & (T - 1)))
    return cudaErrorInvalidValue;
  const SortGeometry g = sort_geometry(nk, T, max_psize);
  *lanes = g.lanes;
  *threads = g.threads;
  *smem = static_cast<long long>(g.smem);
  return 0;
}

// keys[j]: [R, T] int32 or float32 (bit j of float_keys), 1 <= nk <= 4;
// pays[p]: [R, T] payloads of psize[p] bytes an element; outputs alike.
extern "C" int rt_bitonic_sort(const void* const* keys, void* const* okeys,
                               int nk, int float_keys, const void* const* pays,
                               void* const* opays, const int* psize, int np,
                               int R, int T, void* stream) {
  using namespace rt;
  if (nk < 1 || nk > MAX_SORT_KEYS || np < 0 || np > MAX_PAYLOADS || R <= 0 ||
      T < 1 || T > MAX_ROW || (T & (T - 1)) ||
      static_cast<size_t>(nk + 1) * 4 * T > SMEM_LIMIT)
    return cudaErrorInvalidValue;
  SortArgs a;
  int max_psize = 0;
  for (int j = 0; j < nk; ++j) {
    a.key[j] = keys[j];
    a.okey[j] = okeys[j];
  }
  a.float_keys = static_cast<unsigned>(float_keys);
  a.np = np;
  for (int p = 0; p < np; ++p) {
    if (psize[p] != 1 && psize[p] != 2 && psize[p] != 4 && psize[p] != 8)
      return cudaErrorInvalidValue;
    a.pay[p] = pays[p];
    a.opay[p] = opays[p];
    a.psize[p] = psize[p];
    max_psize = psize[p] > max_psize ? psize[p] : max_psize;
  }
  const SortGeometry geo = sort_geometry(nk, T, max_psize);
  if (geo.smem > SMEM_LIMIT) return cudaErrorInvalidValue;
  a.vec = T >= geo.lanes;
  for (int j = 0; j < nk; ++j)
    a.vec = a.vec && aligned16(keys[j]) && aligned16(okeys[j]);
  auto st = static_cast<cudaStream_t>(stream);
  switch (nk) {
    case 1: return launch_keys<1>(a, R, T, geo, st);
    case 2: return launch_keys<2>(a, R, T, geo, st);
    case 3: return launch_keys<3>(a, R, T, geo, st);
    case 4: return launch_keys<4>(a, R, T, geo, st);
    default: return cudaErrorInvalidValue;
  }
}
