// Fused group-by-aggregate engine, per tile (paper Fig. 2, steps b-e).
//
// Replaces: src/repro/kernels/groupagg/kernel.py, groupagg_pallas (the JAX
// package's Pallas TPU kernel).
//
// What it computes, per tile of T lanes of a group-sorted stream: run
// boundaries, the segmented scan of one op's state, the merge with the run
// still pending from the previous tile, finalize at run ends, and a dense
// compaction.  The trailing run of a tile is withheld (it may continue),
// and a tile that does not continue the pending run emits it at its lane 0.
// Outputs are per tile: og/ov [NT, T], oc [NT], as the TPU kernel's.
//
// The TPU kernel carries the pending run in VMEM scratch across an ordered
// grid.  Blocks on this card run in no fixed order, so the carry becomes a
// reduce-then-scan over tiles:
//   1. ga_summary, one block per tile: the state of the tile's last run,
//      whether the tile is one run, its first and last group;
//   2. ga_carry, one block: a segmented scan of those summaries gives the
//      run pending after every tile (a tile that is one run continuing the
//      pending group extends it, any other tile restarts it);
//   3. ga_emit, one block per tile: the tile's scan again with the incoming
//      pending run folded into its first run, finalize, compaction.
//
// Bound on this card: memory.  Per tuple the work reads 8 bytes (group,
// key) and writes 8 (og, ov); at N = 2^24 that is 268 MB, about 80 us at
// 3.35 TB/s.  Passes 1 and 3 both read the input, so this design moves 24
// bytes per tuple instead of 16; the scan is a handful of integer
// operations per lane and stays far below the compute roofline.
#include "tile.cuh"

namespace rt {

struct GroupaggScratch {
  int* g0;      // [NT] first group of each tile
  int* gl;      // [NT] last group of each tile
  int* single;  // [NT] 1 when the tile is one run
  void* c;      // [NT] S: scan state at lane T-1 (the last run)
  void* pend;   // [NT] S: the run pending after each tile
};

template <class C, int L>
__global__ void __launch_bounds__(1024)
ga_summary(const int* __restrict__ g,
           const typename C::Key* __restrict__ k, int T,
           GroupaggScratch sc) {
  using S = typename C::S;
  __shared__ ScanSmem sm;
  const long long base = static_cast<long long>(blockIdx.x) * T;
  S s[L];
  bool f[L];
  bool inner = false;
#pragma unroll
  for (int j = 0; j < L; ++j) {
    const int i = threadIdx.x * L + j;
    if (i < T) {
      const int gi = g[base + i];
      f[j] = i == 0 || gi != g[base + i - 1];
      inner = inner || (i > 0 && f[j]);
      s[j] = C::lift(k[base + i], i);
    } else {
      f[j] = true;
      s[j] = C::lift(k[base], 0);
    }
  }
  block_seg_scan<C, L>(s, f, false, s[0], sm);
  const int any_inner = __syncthreads_or(inner ? 1 : 0);
#pragma unroll
  for (int j = 0; j < L; ++j) {
    if (threadIdx.x * L + j == T - 1) {
      static_cast<S*>(sc.c)[blockIdx.x] = s[j];
      sc.gl[blockIdx.x] = g[base + T - 1];
    }
  }
  if (threadIdx.x == 0) {
    sc.g0[blockIdx.x] = g[base];
    sc.single[blockIdx.x] = any_inner ? 0 : 1;
  }
}

template <class C>
__global__ void __launch_bounds__(1024)
ga_carry(int nt, GroupaggScratch sc) {
  using S = typename C::S;
  constexpr int L = 4;
  __shared__ ScanSmem sm;
  __shared__ S carry_s;
  const S* c = static_cast<const S*>(sc.c);
  S* pend = static_cast<S*>(sc.pend);
  bool has = false;
  S carry = c[0];
  const int per_round = blockDim.x * L;
  for (int r0 = 0; r0 < nt; r0 += per_round) {
    const int last = (r0 + per_round < nt ? r0 + per_round : nt) - 1;
    S s[L];
    bool f[L];
#pragma unroll
    for (int j = 0; j < L; ++j) {
      const int t = r0 + threadIdx.x * L + j;
      if (t < nt) {
        const bool cont = t > 0 && sc.gl[t - 1] != PAD_GROUP &&
                          sc.gl[t - 1] == sc.g0[t];
        f[j] = !(sc.single[t] && cont);
        s[j] = c[t];
      } else {
        f[j] = true;
        s[j] = c[0];
      }
    }
    block_seg_scan<C, L>(s, f, has, carry, sm);
#pragma unroll
    for (int j = 0; j < L; ++j) {
      const int t = r0 + threadIdx.x * L + j;
      if (t < nt) pend[t] = s[j];
      if (t == last) carry_s = s[j];
    }
    __syncthreads();
    carry = carry_s;
    has = true;
    __syncthreads();
  }
}

template <class C, int L>
__global__ void __launch_bounds__(1024)
ga_emit(const int* __restrict__ g,
        const typename C::Key* __restrict__ k, int T,
        GroupaggScratch sc, int* __restrict__ og,
        typename C::Out* __restrict__ ov,
        int* __restrict__ oc) {
  using S = typename C::S;
  using Out = typename C::Out;
  __shared__ ScanSmem sm;
  const int tile = blockIdx.x;
  const long long base = static_cast<long long>(tile) * T;
  const int g0 = g[base];
  const int pg = tile > 0 ? sc.gl[tile - 1] : PAD_GROUP;
  const bool pvalid = pg != PAD_GROUP;
  const S ps = static_cast<const S*>(sc.pend)[tile > 0 ? tile - 1 : 0];
  const bool cont = pvalid && pg == g0;   // this tile extends the pending run
  const bool emit_pending = pvalid && pg != g0;

  S s[L];
  bool f[L];
  int em[L], rk[L], gi[L];
#pragma unroll
  for (int j = 0; j < L; ++j) {
    const int i = threadIdx.x * L + j;
    if (i < T) {
      gi[j] = g[base + i];
      f[j] = i == 0 ? !cont : gi[j] != g[base + i - 1];
      // the trailing lane is withheld: its run may continue
      em[j] = (i < T - 1 && gi[j] != g[base + i + 1] && gi[j] != PAD_GROUP)
                  ? 1 : 0;
      s[j] = C::lift(k[base + i], i);
    } else {
      gi[j] = PAD_GROUP;
      f[j] = true;
      em[j] = 0;
      s[j] = C::lift(k[base], 0);
    }
  }
  block_seg_scan<C, L>(s, f, cont, ps, sm);
  const int cnt = block_excl_sum<L>(em, rk, sm);
  const int off = emit_pending ? 1 : 0;
#pragma unroll
  for (int j = 0; j < L; ++j) {
    if (em[j]) {
      og[base + off + rk[j]] = gi[j];
      ov[base + off + rk[j]] = C::fin(s[j]);
    }
  }
  if (threadIdx.x == 0 && emit_pending) {
    og[base] = pg;
    ov[base] = C::fin(ps);
  }
  for (int r = cnt + off + threadIdx.x; r < T; r += blockDim.x) {
    og[base + r] = PAD_GROUP;
    ov[base + r] = Out(0);
  }
  if (threadIdx.x == 0) oc[tile] = cnt + off;
}

template <class C, int L>
void launch_groupagg(const int* g, const void* k, int nt, int T,
                     GroupaggScratch sc, int* og, void* ov, int* oc,
                     cudaStream_t stream) {
  using K = typename C::Key;
  const int threads = threads_for(T);
  ga_summary<C, L><<<nt, threads, 0, stream>>>(g, static_cast<const K*>(k), T, sc);
  ga_carry<C><<<1, 1024, 0, stream>>>(nt, sc);
  ga_emit<C, L><<<nt, threads, 0, stream>>>(
      g, static_cast<const K*>(k), T, sc, og,
      static_cast<typename C::Out*>(ov), oc);
}

template <int OP, typename K>
cudaError_t run_groupagg(const int* g, const void* k, int nt, int T,
                         unsigned char* scratch, int* og, void* ov, int* oc,
                         cudaStream_t stream) {
  using C = Comb<OP, K>;
  GroupaggScratch sc;
  sc.g0 = reinterpret_cast<int*>(scratch);
  sc.gl = sc.g0 + nt;
  sc.single = sc.gl + nt;
  sc.c = scratch + 3ll * nt * sizeof(int);
  sc.pend = static_cast<unsigned char*>(sc.c) + 1ll * nt * sizeof(typename C::S);
  switch (lanes_per_thread(T)) {
    case 1: launch_groupagg<C, 1>(g, k, nt, T, sc, og, ov, oc, stream); break;
    case 4: launch_groupagg<C, 4>(g, k, nt, T, sc, og, ov, oc, stream); break;
    default: return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

template <typename K>
cudaError_t dispatch_groupagg(int op, const int* g, const void* k, int nt,
                              int T, unsigned char* scratch, int* og, void* ov,
                              int* oc, cudaStream_t st) {
  switch (op) {
    case OP_SUM: return run_groupagg<OP_SUM, K>(g, k, nt, T, scratch, og, ov, oc, st);
    case OP_MIN: return run_groupagg<OP_MIN, K>(g, k, nt, T, scratch, og, ov, oc, st);
    case OP_MAX: return run_groupagg<OP_MAX, K>(g, k, nt, T, scratch, og, ov, oc, st);
    case OP_COUNT: return run_groupagg<OP_COUNT, K>(g, k, nt, T, scratch, og, ov, oc, st);
    case OP_MEAN: return run_groupagg<OP_MEAN, K>(g, k, nt, T, scratch, og, ov, oc, st);
    case OP_DC: return run_groupagg<OP_DC, K>(g, k, nt, T, scratch, og, ov, oc, st);
    case OP_FIRST: return run_groupagg<OP_FIRST, K>(g, k, nt, T, scratch, og, ov, oc, st);
    case OP_LAST: return run_groupagg<OP_LAST, K>(g, k, nt, T, scratch, og, ov, oc, st);
    case OP_VARIANCE: return run_groupagg<OP_VARIANCE, K>(g, k, nt, T, scratch, og, ov, oc, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace rt

// Scratch: 3 * NT int32 + 2 * NT states of at most 16 bytes (48 * NT bytes
// covers every op).  Tiles are powers of two, 1 <= T <= 4096.
extern "C" int rt_groupagg(const int* g, const void* k, int key_type, int op,
                           int nt, int tile, void* scratch, int* og, void* ov,
                           int* oc, void* stream) {
  using namespace rt;
  if (nt <= 0 || tile < 1 || tile > 4096 || (tile & (tile - 1)))
    return cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
  auto sc = static_cast<unsigned char*>(scratch);
  if (key_type == KEY_INT32)
    return dispatch_groupagg<int>(op, g, k, nt, tile, sc, og, ov, oc, st);
  if (key_type == KEY_FLOAT32)
    return dispatch_groupagg<float>(op, g, k, nt, tile, sc, og, ov, oc, st);
  return cudaErrorInvalidValue;
}
