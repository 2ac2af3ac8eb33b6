// Fused sliding-window aggregation kernels (paper Fig. 4): one block per
// window row, everything in shared memory.
//
// Replaces, in src/repro/kernels/swag/kernel.py (the JAX package's Pallas
// TPU kernels):
//   * swag_pallas        -> swag_rows_kernel with run == 1: sort each row by
//                           (group, key), then every op's tail;
//   * swag_pallas_panes  -> swag_rows_kernel with run == WA: window i is the
//                           P presorted panes i .. i+P-1, which lie back to
//                           back in the [NP, WA] pane array, so the block
//                           reads WS contiguous lanes at i * WA (where the TPU
//                           kernel used P overlapping BlockSpecs) and merges
//                           them instead of sorting;
//   * sort_panes_pallas  -> sort_rows_kernel: sort each WA-lane pane once.
//
// Rows are read with a row stride, so the re-sort path frames its windows
// as a strided view of the stream (stride WA) and never materialises the
// [NW, WS] frames.
//
// Bound on this card: shared memory.  A row of WS (int32 group, 4-byte key)
// pairs takes 8 * WS bytes; the bitonic network makes log2(WS) * (log2(WS)
// + 1) / 2 passes over it, each a block barrier, so the sort dominates and
// the row must fit one block: WS <= 16384 (128 KiB; above 48 KiB the
// kernel opts in to large dynamic shared memory).  Device memory traffic is
// 8 * WS bytes read and 4 * WS * (1 + ops) written per row.
#include "tile.cuh"

namespace rt {

template <typename K, int L>
__global__ void __launch_bounds__(1024)
swag_rows_kernel(const int* __restrict__ g,
                 const K* __restrict__ k, long long stride,
                 int T, int run, OpList ops, int* og,
                 int* oc) {
  extern __shared__ __align__(16) unsigned char dyn[];
  __shared__ ScanSmem sm;
  int* sg = reinterpret_cast<int*>(dyn);
  K* sk = reinterpret_cast<K*>(dyn + static_cast<size_t>(T) * sizeof(int));
  const long long row = blockIdx.x;
  const int* gr = g + row * stride;
  const K* kr = k + row * stride;
  for (int i = threadIdx.x; i < T; i += blockDim.x) {
    sg[i] = gr[i];
    sk[i] = kr[i];
  }
  __syncthreads();
  if (run == 1)
    block_bitonic_sort<K>(sg, sk, T);
  else
    block_merge_presorted<K>(sg, sk, T, run);
  multi_tails<K, L>(sg, sk, T, ops, row, og, oc, sm);
}

template <typename K>
__global__ void __launch_bounds__(1024)
sort_rows_kernel(const int* __restrict__ g,
                 const K* __restrict__ k, int T, int* og,
                 K* ok) {
  extern __shared__ __align__(16) unsigned char dyn[];
  int* sg = reinterpret_cast<int*>(dyn);
  K* sk = reinterpret_cast<K*>(dyn + static_cast<size_t>(T) * sizeof(int));
  const long long base = static_cast<long long>(blockIdx.x) * T;
  for (int i = threadIdx.x; i < T; i += blockDim.x) {
    sg[i] = g[base + i];
    sk[i] = k[base + i];
  }
  __syncthreads();
  block_bitonic_sort<K>(sg, sk, T);
  for (int i = threadIdx.x; i < T; i += blockDim.x) {
    og[base + i] = sg[i];
    ok[base + i] = sk[i];
  }
}

template <typename Kern>
cudaError_t allow_smem(Kern kern, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

template <typename K, int L>
cudaError_t launch_rows(const int* g, const void* k, long long stride,
                        int nrows, int T, int run, const OpList& ops, int* og,
                        int* oc, cudaStream_t st) {
  const size_t smem = static_cast<size_t>(T) * 8;
  cudaError_t err = allow_smem(swag_rows_kernel<K, L>, smem);
  if (err != cudaSuccess) return err;
  swag_rows_kernel<K, L><<<nrows, threads_for(T), smem, st>>>(
      g, static_cast<const K*>(k), stride, T, run, ops, og, oc);
  return cudaGetLastError();
}

template <typename K>
cudaError_t dispatch_rows(const int* g, const void* k, long long stride,
                          int nrows, int T, int run, const OpList& ops,
                          int* og, int* oc, cudaStream_t st) {
  switch (lanes_per_thread(T)) {
    case 1: return launch_rows<K, 1>(g, k, stride, nrows, T, run, ops, og, oc, st);
    case 4: return launch_rows<K, 4>(g, k, stride, nrows, T, run, ops, og, oc, st);
    case 16: return launch_rows<K, 16>(g, k, stride, nrows, T, run, ops, og, oc, st);
    default: return cudaErrorInvalidValue;
  }
}

template <typename K>
cudaError_t launch_sort(const int* g, const void* k, int nrows, int T, int* og,
                        void* ok, cudaStream_t st) {
  const size_t smem = static_cast<size_t>(T) * 8;
  cudaError_t err = allow_smem(sort_rows_kernel<K>, smem);
  if (err != cudaSuccess) return err;
  sort_rows_kernel<K><<<nrows, threads_for(T), smem, st>>>(
      g, static_cast<const K*>(k), T, og, static_cast<K*>(ok));
  return cudaGetLastError();
}

bool row_ok(int nrows, int T) {
  return nrows > 0 && T >= 1 && T <= MAX_ROW && (T & (T - 1)) == 0;
}

}  // namespace rt

// Window rows: row r is the T lanes at g + r * stride (and k likewise).
// run == 1 sorts each row; run > 1 merges its T / run presorted runs.
// codes[i] is the OpCode of ops i, outs[i] its [nrows, T] output.
extern "C" int rt_swag_rows(const int* g, const void* k, int key_type,
                            long long stride, int nrows, int T, int run,
                            const int* codes, void* const* outs, int nops,
                            int* og, int* oc, void* stream) {
  using namespace rt;
  if (!row_ok(nrows, T) || run < 1 || (run & (run - 1)) || T % run ||
      nops < 1 || nops > MAX_OPS)
    return cudaErrorInvalidValue;
  OpList ops;
  ops.n = nops;
  for (int i = 0; i < nops; ++i) {
    ops.code[i] = codes[i];
    ops.out[i] = outs[i];
  }
  auto st = static_cast<cudaStream_t>(stream);
  if (key_type == KEY_INT32)
    return dispatch_rows<int>(g, k, stride, nrows, T, run, ops, og, oc, st);
  if (key_type == KEY_FLOAT32)
    return dispatch_rows<float>(g, k, stride, nrows, T, run, ops, og, oc, st);
  return cudaErrorInvalidValue;
}

extern "C" int rt_sort_rows(const int* g, const void* k, int key_type,
                            int nrows, int T, int* og, void* ok,
                            void* stream) {
  using namespace rt;
  if (!row_ok(nrows, T)) return cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
  if (key_type == KEY_INT32) return launch_sort<int>(g, k, nrows, T, og, ok, st);
  if (key_type == KEY_FLOAT32) return launch_sort<float>(g, k, nrows, T, og, ok, st);
  return cudaErrorInvalidValue;
}
