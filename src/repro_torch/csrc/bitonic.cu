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
// compare).  The block sorts the key words and each lane's index in shared
// memory; the swaps depend on the keys alone, so every payload lands where
// the TPU network drags it, and the kernel gathers each payload through the
// final permutation instead of moving it through every stage.
//
// Bound on this card: shared memory.  The network makes log2(T) *
// (log2(T) + 1) / 2 passes over (num_keys + 1) * 4 * T bytes, a barrier
// each; device memory sees each operand read once and written once.  A row
// must fit one block: T <= 16384 with one or two keys, T <= 8192 with three
// or four (the wrapper states both limits).
#include "tile.cuh"

namespace rt {

constexpr int MAX_SORT_KEYS = 4;
constexpr int MAX_PAYLOADS = 16;

struct SortArgs {
  const void* key[MAX_SORT_KEYS];
  void* okey[MAX_SORT_KEYS];
  unsigned float_keys;  // bit j set: key j is float32, else int32
  int np;
  const void* pay[MAX_PAYLOADS];
  void* opay[MAX_PAYLOADS];
  int psize[MAX_PAYLOADS];  // element bytes: 1, 2, 4 or 8
};

template <int NK>
__device__ __forceinline__ bool keys_less(const unsigned* const* kw,
                                          unsigned float_keys, int a, int b) {
#pragma unroll
  for (int j = 0; j < NK; ++j) {
    if (float_keys & (1u << j)) {
      const float x = __uint_as_float(kw[j][a]), y = __uint_as_float(kw[j][b]);
      if (x < y) return true;
      if (!(x == y)) return false;
    } else {
      const int x = static_cast<int>(kw[j][a]), y = static_cast<int>(kw[j][b]);
      if (x < y) return true;
      if (x != y) return false;
    }
  }
  return false;
}

template <typename T>
__device__ __forceinline__ void gather_row(const void* in, void* out,
                                           long long base, const int* idx,
                                           int n) {
  const T* src = static_cast<const T*>(in) + base;
  T* dst = static_cast<T*>(out) + base;
  for (int i = threadIdx.x; i < n; i += blockDim.x) dst[i] = src[idx[i]];
}

template <int NK>
__global__ void __launch_bounds__(1024)
bitonic_rows_kernel(SortArgs a, int T) {
  extern __shared__ __align__(16) unsigned char dyn[];
  unsigned* words = reinterpret_cast<unsigned*>(dyn);
  unsigned* kw[NK];
#pragma unroll
  for (int j = 0; j < NK; ++j) kw[j] = words + static_cast<size_t>(j) * T;
  int* idx = reinterpret_cast<int*>(words + static_cast<size_t>(NK) * T);
  const long long base = static_cast<long long>(blockIdx.x) * T;
  for (int i = threadIdx.x; i < T; i += blockDim.x) {
#pragma unroll
    for (int j = 0; j < NK; ++j)
      kw[j][i] = static_cast<const unsigned*>(a.key[j])[base + i];
    idx[i] = i;
  }
  __syncthreads();
  for (int kk = 2; kk <= T; kk <<= 1) {
    for (int j = kk >> 1; j > 0; j >>= 1) {
      for (int p = threadIdx.x; p < T / 2; p += blockDim.x) {
        const int i = ((p & ~(j - 1)) << 1) | (p & (j - 1));
        const int q = i + j;
        const bool up = (i & kk) == 0;
        const bool sw = up ? keys_less<NK>(kw, a.float_keys, q, i)
                           : keys_less<NK>(kw, a.float_keys, i, q);
        if (sw) {
#pragma unroll
          for (int w = 0; w < NK; ++w) {
            const unsigned t = kw[w][i]; kw[w][i] = kw[w][q]; kw[w][q] = t;
          }
          const int t = idx[i]; idx[i] = idx[q]; idx[q] = t;
        }
      }
      __syncthreads();
    }
  }
  for (int i = threadIdx.x; i < T; i += blockDim.x) {
#pragma unroll
    for (int j = 0; j < NK; ++j)
      static_cast<unsigned*>(a.okey[j])[base + i] = kw[j][i];
  }
  for (int p = 0; p < a.np; ++p) {
    switch (a.psize[p]) {
      case 1: gather_row<unsigned char>(a.pay[p], a.opay[p], base, idx, T); break;
      case 2: gather_row<unsigned short>(a.pay[p], a.opay[p], base, idx, T); break;
      case 4: gather_row<unsigned>(a.pay[p], a.opay[p], base, idx, T); break;
      case 8: gather_row<unsigned long long>(a.pay[p], a.opay[p], base, idx, T); break;
      default: break;
    }
  }
}

template <int NK>
cudaError_t launch_bitonic(const SortArgs& a, int R, int T, cudaStream_t st) {
  const size_t smem = static_cast<size_t>(NK + 1) * 4 * T;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        bitonic_rows_kernel<NK>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const int half = T / 2;
  const int threads = half < 32 ? 32 : (half > 1024 ? 1024 : half);
  bitonic_rows_kernel<NK><<<R, threads, smem, st>>>(a, T);
  return cudaGetLastError();
}

}  // namespace rt

// keys[j]: [R, T] int32 or float32 (bit j of float_keys), 1 <= nk <= 4;
// pays[p]: [R, T] payloads of psize[p] bytes an element; outputs alike.
extern "C" int rt_bitonic_sort(const void* const* keys, void* const* okeys,
                               int nk, int float_keys, const void* const* pays,
                               void* const* opays, const int* psize, int np,
                               int R, int T, void* stream) {
  using namespace rt;
  if (nk < 1 || nk > MAX_SORT_KEYS || np < 0 || np > MAX_PAYLOADS || R <= 0 ||
      T < 1 || (T & (T - 1)) || static_cast<size_t>(nk + 1) * 4 * T > 232448)
    return cudaErrorInvalidValue;
  SortArgs a;
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
  }
  auto st = static_cast<cudaStream_t>(stream);
  switch (nk) {
    case 1: return launch_bitonic<1>(a, R, T, st);
    case 2: return launch_bitonic<2>(a, R, T, st);
    case 3: return launch_bitonic<3>(a, R, T, st);
    case 4: return launch_bitonic<4>(a, R, T, st);
    default: return cudaErrorInvalidValue;
  }
}
