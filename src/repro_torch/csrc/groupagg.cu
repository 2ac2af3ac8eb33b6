// Fused group-by-aggregate engine (paper Fig. 2, steps b-e), one pass.
//
// Replaces: src/repro/kernels/groupagg/kernel.py, groupagg_pallas (the JAX
// package's Pallas TPU kernel), and, in the flat layout, the stitch of its
// per-tile outputs in src/repro/kernels/groupagg/ops.py,
// _groupagg_kernel_exec.
//
// What it computes, per tile of T lanes of a group-sorted stream: run
// boundaries, each op's segmented scan, the merge with the run still pending
// from the previous tile, finalize at run ends, and a dense compaction.  The
// trailing run of a tile is withheld (it may continue), and a tile that does
// not continue the pending run emits it at its lane 0.  Two layouts, one
// kernel body (the FLAT template flag):
//   * per tile, the TPU kernel's: og/ov [NT, T] and oc [NT], one op, the
//     input closed by a PAD_GROUP tile;
//   * flat, the main path's: every op of a query in one launch, written
//     straight to groups/values [N] at the tile's flat offset, valid [N]
//     set there, and num, the count of groups, on the device.  Lanes at or
//     past min(lim, *nvalid) read as PAD_GROUP / 0 (the n_valid mask and the
//     padding, with no copy); one more tile past the input closes the last
//     run.  groupagg_fill_kernel then fills [num, N) from num on the device.
//
// The TPU kernel carries the pending run in VMEM scratch across an ordered
// grid.  Here the carry is the chained tile prefix of tile.cuh, in the same
// pass.  A block reads its tile once (16-byte loads), computes boundaries
// and compaction ranks once, then scans each op in turn, staging the op's
// emitted values in shared memory at their ranks and keeping of the op only
// two states: its trailing run's (the tile's aggregate) and its first run's
// end, the one emitted lane that needs the carry.  Then one descriptor
// (emitted count, restart flag, every op's trailing state) is published
// and one warp looks back: the prefix gives the tile its flat offset and
// its incoming pending run.  A tile restarts the pending run unless it is
// one run continuing the group of lane base - 1, which it reads itself.
// Last, the staged lanes leave shared memory as contiguous stores at the
// tile's offset: each output lane is written once.  Staging costs (1 +
// ops) x T x 4 bytes of shared memory (160 KiB for nine ops at T = 4096).
//
// Bound on this card: memory.  Per tuple the flat launch reads 8 bytes
// (group, key) and writes 5 + 4 an op (group, valid, values): at N = 2^24
// and five ops 554 MB, about 0.165 ms at 3.35 TB/s.  The per-tile layout
// writes 8 (og, ov).  Each op's scan is a few integer operations a lane.
#include "tile.cuh"

namespace rt {

struct GaArgs {
  const int* g;
  const void* k;
  long long lim;        // lanes at or past lim (and *nvalid) read as PAD
  const int* nvalid;    // device count of valid lanes, or nullptr
  int T, nt, vec;
  unsigned* ticket;
  unsigned* status;     // the chain: status, then per tile the emitted
  int* cagg;            // count (aggregate and inclusive), whether the tile
  int* cincl;           // restarts the pending run, and each op's state
  int* rst;             // ([nops][nt] slots)
  uint4* sagg;
  uint4* sincl;
  int* og;              // flat: groups [N]; per tile: og [NT, T]
  unsigned char* valid; // flat: valid [N]
  int* oc;              // per tile: oc [NT]
  int* num;             // flat: the count of groups
};

// What a tile keeps of each op across the op loop, and its flat offset.
struct GaShared {
  uint4 first[MAX_OPS];  // state at the first run's end (it continues)
  uint4 last[MAX_OPS];   // state at lane T - 1: the trailing run's
  uint4 in[MAX_OPS];     // the pending run coming in
  int pg, g0, off;
};

// One op of the tile: scan (lane 0 starts a run), write every emitted lane
// to its place in sv (staged in shared memory, or the tile's output row)
// but the first run's end when the tile continues the pending run, keep
// that state and the trailing run's; per tile, fill the row past cnt.
template <class C, int L, bool FLAT>
__device__ __forceinline__ void ga_op(const typename C::Key (&k)[L],
                                      unsigned fm, unsigned em, int r,
                                      bool cont, int T, int cnt,
                                      typename C::Out* sv, GaShared& sh,
                                      int o, ScanSmem& sm) {
  using S = typename C::S;
  const int i0 = threadIdx.x * L;
  S s[L];
  bool f[L];
#pragma unroll
  for (int j = 0; j < L; ++j) {
    s[j] = C::lift(k[j], i0 + j);
    f[j] = (fm >> j) & 1u;
  }
  block_seg_scan<C, L>(s, f, false, s[0], sm);
#pragma unroll
  for (int j = 0; j < L; ++j) {
    if ((em >> j) & 1u) {
      if (cont && r == 0) sh.first[o] = pack_state(s[j]);
      else sv[r] = C::fin(s[j]);
      ++r;
    }
    if (i0 + j == T - 1) sh.last[o] = pack_state(s[j]);
  }
  if (!FLAT)
    for (int q = cnt + threadIdx.x; q < T; q += blockDim.x) sv[q] = 0;
}

// Thread 0, once the pending run has come in: the op's inclusive state
// (unless published already), and the value at place 0 when the tile emits
// the pending run there or merges it into its first run's end.
template <class C>
__device__ __forceinline__ void ga_tail(const GaShared& sh, int o,
                                        bool published, bool restart,
                                        bool emit_pending, bool merge_first,
                                        uint4* incl, typename C::Out* sv) {
  using S = typename C::S;
  const S in = unpack_state<S>(sh.in[o]);
  const S last = unpack_state<S>(sh.last[o]);
  if (!published) *incl = pack_state(restart ? last : C::op(in, last));
  if (emit_pending) sv[0] = C::fin(in);
  if (merge_first) sv[0] = C::fin(C::op(in, unpack_state<S>(sh.first[o])));
}

#define GA_OPS(X) \
  X(OP_SUM) X(OP_MIN) X(OP_MAX) X(OP_COUNT) X(OP_MEAN) X(OP_DC) X(OP_FIRST) \
  X(OP_LAST) X(OP_VARIANCE)

// The look-back's fold: the emitted count of the earlier tiles in every
// lane, and, when the tile needs it, every op's pending state in sh.in.  A
// tile's state chain restarts at a tile whose restart flag is set (and at
// an inclusive prefix): windows earlier than one are not folded.
template <typename K>
struct GaFold {
  const OpList& ops;
  const GaArgs& a;
  GaShared& sh;
  bool need;   // whether the tile needs its incoming pending run
  int sum;
  bool has, held;
  __device__ __forceinline__ void operator()(int j, bool in, bool inc) {
    const int c = in ? __ldcg((inc ? a.cincl : a.cagg) + j) : 0;
    sum += __reduce_add_sync(FULL_MASK, c);
    if (!need || held) return;
    const bool r = in && (inc || __ldcg(a.rst + j) != 0);
    for (int o = 0; o < ops.n; ++o) {
      const uint4* ag = a.sagg + static_cast<long long>(o) * a.nt;
      const uint4* ic = a.sincl + static_cast<long long>(o) * a.nt;
      switch (ops.code[o]) {
#define X(OP) case OP: chain_fold_state<Comb<OP, K>>(ag, ic, j, in, inc, r, sh.in[o], has); break;
        GA_OPS(X)
#undef X
        default: break;
      }
    }
    has = true;
    held = __any_sync(FULL_MASK, r);
  }
};

// Lanes a thread: GA_LANES in tiles of at least 32 * GA_LANES lanes (a
// whole warp), else one; a block is a tile of at most 4096 lanes.  (8 and
// 16 lanes took 110 and 202 registers and were no faster at T = 1024.)
constexpr int GA_LANES = 4;

// A minimum of one block: without it ptxas spilled the one-lane kernel.
template <typename K, int L, bool FLAT>
__global__ void __launch_bounds__(L == 1 ? 32 * GA_LANES : 4096 / L, 1)
groupagg_kernel(GaArgs a, OpList ops) {
  __shared__ ScanSmem sm;
  __shared__ GaShared sh;
  extern __shared__ __align__(16) unsigned char stage[];
  const int tile = chain_ticket(a.ticket);
  const int T = a.T;
  const long long base = static_cast<long long>(tile) * T;
  long long lim = a.lim;
  if (a.nvalid) {
    const long long v = *a.nvalid;
    lim = v < lim ? (v > 0 ? v : 0) : lim;
  }
  const K* kp = static_cast<const K*>(a.k);
  const int lane = threadIdx.x & 31;
  const int i0 = threadIdx.x * L;
  // where the compacted lanes go: flat, staged in shared memory (the
  // groups, then each op's values, T lanes each) until the offset is known;
  // per tile, straight to the tile's rows
  int* sg = FLAT ? reinterpret_cast<int*>(stage) : a.og + base;
  auto dst = [&](int o) -> void* {
    return FLAT ? static_cast<void*>(sg + static_cast<long long>(1 + o) * T)
                : static_cast<void*>(static_cast<int*>(ops.out[o]) + base);
  };

  // the tile's lanes, read once; lanes past lim are PAD_GROUP / 0
  int g[L];
  K k[L];
  if (L % 4 == 0 && a.vec && base + i0 + L <= lim) {
#pragma unroll
    for (int q = 0; q < L / 4; ++q) {
      const int4 gv = *reinterpret_cast<const int4*>(a.g + base + i0 + 4 * q);
      const int4 kv = *reinterpret_cast<const int4*>(kp + base + i0 + 4 * q);
      const int gw[4] = {gv.x, gv.y, gv.z, gv.w};
      const int kw[4] = {kv.x, kv.y, kv.z, kv.w};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        g[4 * q + j] = gw[j];
        memcpy(&k[4 * q + j], &kw[j], 4);
      }
    }
  } else {
#pragma unroll
    for (int j = 0; j < L; ++j) {
      const long long idx = base + i0 + j;
      const bool live = i0 + j < T && idx < lim;
      g[j] = live ? a.g[idx] : PAD_GROUP;
      k[j] = live ? kp[idx] : K(0);
    }
  }
  // the neighbours of the thread's first and last lanes: by shuffle, or
  // read at a warp's edge (lane base - 1 is the pending run's group)
  int prev0 = __shfl_up_sync(FULL_MASK, g[L - 1], 1);
  int next1 = __shfl_down_sync(FULL_MASK, g[0], 1);
  if (lane == 0) {
    const long long idx = base + i0 - 1;
    prev0 = idx >= 0 && idx < lim ? a.g[idx] : PAD_GROUP;
  }
  if (lane == 31) {
    const long long idx = base + i0 + L;
    next1 = i0 + L < T && idx < lim ? a.g[idx] : PAD_GROUP;
  }
  // fm: lanes that start a run of the tile's own scan (lane 0 always);
  // em: lanes that end a run the tile emits (never the trailing lane)
  unsigned fm = 0u, em = 0u;
  bool inner = false;
#pragma unroll
  for (int j = 0; j < L; ++j) {
    const int i = i0 + j;
    const int pv = j == 0 ? prev0 : g[j - 1];
    const int nx = j == L - 1 ? next1 : g[j + 1];
    const bool starts = g[j] != pv;
    if (i >= T || i == 0 || starts) fm |= 1u << j;
    if (i > 0 && i < T && starts) inner = true;
    if (i < T - 1 && g[j] != nx && g[j] != PAD_GROUP) em |= 1u << j;
  }
  if (threadIdx.x == 0) {
    sh.pg = prev0;
    sh.g0 = g[0];
  }
  const bool single = !__syncthreads_or(inner ? 1 : 0);
  const int pg = sh.pg;
  const bool pvalid = pg != PAD_GROUP;  // tile 0: lane -1 reads as PAD
  const bool cont = pvalid && pg == sh.g0;
  const bool emit_pending = pvalid && !cont;
  const bool restart = !(single && cont);
  const int pend = emit_pending ? 1 : 0;

  int ne[1] = {__popc(em)}, rk[1];
  const int cnt = block_excl_sum<1>(ne, rk, sm) + pend;
  {
    int r = pend + rk[0];
#pragma unroll
    for (int j = 0; j < L; ++j)
      if ((em >> j) & 1u) sg[r++] = g[j];
  }
  if (threadIdx.x == 0 && emit_pending) sg[0] = pg;
  if (!FLAT)
    for (int q = cnt + threadIdx.x; q < T; q += blockDim.x) sg[q] = PAD_GROUP;

  for (int o = 0; o < ops.n; ++o) {
    void* sv = dst(o);
    switch (ops.code[o]) {
#define X(OP) case OP: ga_op<Comb<OP, K>, L, FLAT>(k, fm, em, pend + rk[0], cont, T, cnt, static_cast<typename Comb<OP, K>::Out*>(sv), sh, o, sm); break;
      GA_OPS(X)
#undef X
      default: break;
    }
  }
  __syncthreads();  // sh.first, sh.last (and the staged lanes)

  // the descriptor: tile 0's (and, per tile, a restarting tile's: no count
  // is needed there) is its inclusive prefix at once
  const bool published = tile == 0 || (!FLAT && restart);
  if (threadIdx.x == 0) {
    if (published) {
      a.cincl[tile] = cnt;
      for (int o = 0; o < ops.n; ++o)
        a.sincl[static_cast<long long>(o) * a.nt + tile] = sh.last[o];
    } else {
      a.cagg[tile] = cnt;
      a.rst[tile] = restart ? 1 : 0;
      for (int o = 0; o < ops.n; ++o)
        a.sagg[static_cast<long long>(o) * a.nt + tile] = sh.last[o];
    }
    chain_publish(a.status, tile, published ? CH_PREFIX : CH_AGG);
    sh.off = 0;
  }
  if (tile > 0 && (FLAT || pvalid) && threadIdx.x < 32) {
    GaFold<K> fold{ops, a, sh, pvalid, 0, false, false};
    chain_lookback(a.status, tile, fold);
    if (threadIdx.x == 0) {
      const bool merge_first = cont && !single;
      for (int o = 0; o < ops.n; ++o) {
        uint4* incl = a.sincl + static_cast<long long>(o) * a.nt + tile;
        void* sv = dst(o);
        switch (ops.code[o]) {
#define X(OP) case OP: ga_tail<Comb<OP, K>>(sh, o, published, restart, emit_pending, merge_first, incl, static_cast<typename Comb<OP, K>::Out*>(sv)); break;
          GA_OPS(X)
#undef X
          default: break;
        }
      }
      if (!published) {
        a.cincl[tile] = fold.sum + cnt;
        chain_publish(a.status, tile, CH_PREFIX);
      }
      sh.off = fold.sum;
    }
  }
  if (!FLAT) {
    if (threadIdx.x == 0) a.oc[tile] = cnt;
    return;
  }
  __syncthreads();  // sh.off, the staged place 0

  // the staged lanes, as contiguous stores at the tile's place
  const long long off = sh.off;
  if (tile == a.nt - 1 && threadIdx.x == 0) *a.num = sh.off + cnt;
  for (int q = threadIdx.x; q < cnt; q += blockDim.x) {
    a.og[off + q] = sg[q];
    a.valid[off + q] = 1;
    for (int o = 0; o < ops.n; ++o)
      static_cast<int*>(ops.out[o])[off + q] =
          sg[static_cast<long long>(1 + o) * T + q];
  }
}

// [num, N) of the flat outputs: PAD_GROUP, invalid, every op's value 0
// (each op's output is 4 bytes); with vec, 4 lanes a thread as one 16-byte
// store a column.
__global__ void __launch_bounds__(256)
groupagg_fill_kernel(const int* num, long long n, int* og,
                     unsigned char* valid, OpList ops, int vec) {
  const long long from = *num;
  const long long tid = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  const long long a4 = vec ? (from + 3) & ~3ll : n;
  auto fill = [&](long long i) {
    og[i] = PAD_GROUP;
    valid[i] = 0;
    for (int o = 0; o < ops.n; ++o) static_cast<int*>(ops.out[o])[i] = 0;
  };
  for (long long i = from + tid; i < (a4 < n ? a4 : n); i += stride) fill(i);
  if (!vec) return;
  const int4 pad = make_int4(PAD_GROUP, PAD_GROUP, PAD_GROUP, PAD_GROUP);
  const int4 zero = make_int4(0, 0, 0, 0);
  for (long long q = a4 / 4 + tid; q < n / 4; q += stride) {
    reinterpret_cast<int4*>(og)[q] = pad;
    reinterpret_cast<unsigned*>(valid)[q] = 0u;
    for (int o = 0; o < ops.n; ++o) reinterpret_cast<int4*>(ops.out[o])[q] = zero;
  }
  for (long long i = (a4 > n / 4 * 4 ? a4 : n / 4 * 4) + tid; i < n; i += stride) fill(i);
}

template <typename K, int L, bool FLAT>
cudaError_t launch_kernel(const GaArgs& a, const OpList& ops, cudaStream_t st) {
  auto kern = groupagg_kernel<K, L, FLAT>;
  const size_t smem = FLAT ? static_cast<size_t>(1 + ops.n) * a.T * 4 : 0;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  kern<<<a.nt, L == 1 ? (a.T < 32 ? 32 : a.T) : a.T / L, smem, st>>>(a, ops);
  return cudaGetLastError();
}

template <typename K, bool FLAT>
cudaError_t launch_groupagg(const GaArgs& a, const OpList& ops, cudaStream_t st) {
  return a.T >= 32 * GA_LANES ? launch_kernel<K, GA_LANES, FLAT>(a, ops, st)
                              : launch_kernel<K, 1, FLAT>(a, ops, st);
}

}  // namespace rt

// One launch of the group-by-aggregate over n lanes in tiles of `tile`
// (a power of two, 1..4096).  codes/outs: nops ops (groupagg's nine) and
// their outputs (4-byte values).  flat = 0: the per-tile layout, n a whole
// number of tiles closed by a PAD_GROUP tile, one op, og/outs [n], oc
// [n / tile]; flat = 1: n_tiles = n / tile + 1 (the last closes the last
// run), og/outs/valid [n], num the count of groups, lanes at or past
// min(lim, *nvalid) (nvalid may be null) read as PAD_GROUP.  status:
// 4 + n_tiles zeroed int32 words (the ticket, the chain's status); payload:
// 32 * nops * n_tiles + 12 * n_tiles bytes, 16-byte aligned.
extern "C" int rt_groupagg(const int* g, const void* k, int key_type,
                           long long n, long long lim, const int* nvalid,
                           int tile, int flat, const int* codes,
                           void* const* outs, int nops, void* status,
                           void* payload, int* og, unsigned char* valid,
                           int* oc, int* num, void* stream) {
  using namespace rt;
  if (n < 0 || tile < 1 || tile > 4096 || (tile & (tile - 1)) || nops < 1 ||
      nops > MAX_OPS || (!flat && (nops != 1 || n == 0 || n % tile)))
    return cudaErrorInvalidValue;
  const long long nt = flat ? n / tile + 1 : n / tile;
  if (nt > 0x7fffffffll) return cudaErrorInvalidValue;
  OpList ops;
  ops.n = nops;
  for (int i = 0; i < nops; ++i) {
    if (codes[i] < OP_SUM || codes[i] > OP_VARIANCE) return cudaErrorInvalidValue;
    ops.code[i] = codes[i];
    ops.out[i] = outs[i];
  }
  GaArgs a;
  a.g = g;
  a.k = k;
  a.lim = lim < n ? (lim > 0 ? lim : 0) : n;
  a.nvalid = nvalid;
  a.T = tile;
  a.nt = static_cast<int>(nt);
  a.vec = aligned16(g) && aligned16(k);
  auto words = static_cast<unsigned*>(status);
  a.ticket = words;
  a.status = words + 4;
  a.sagg = static_cast<uint4*>(payload);
  a.sincl = a.sagg + nops * nt;
  a.cagg = reinterpret_cast<int*>(a.sincl + nops * nt);
  a.cincl = a.cagg + nt;
  a.rst = a.cincl + nt;
  a.og = og;
  a.valid = valid;
  a.oc = oc;
  a.num = num;
  auto st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (key_type == KEY_INT32)
    err = flat ? launch_groupagg<int, true>(a, ops, st) : launch_groupagg<int, false>(a, ops, st);
  else if (key_type == KEY_FLOAT32)
    err = flat ? launch_groupagg<float, true>(a, ops, st) : launch_groupagg<float, false>(a, ops, st);
  else
    return cudaErrorInvalidValue;
  if (err != cudaSuccess || !flat) return err;
  int vec = aligned16(og) && reinterpret_cast<uintptr_t>(valid) % 4 == 0;
  for (int i = 0; i < nops; ++i) vec = vec && aligned16(outs[i]);
  const long long work = (n + 3) / 4 + 1;
  const int blocks = static_cast<int>(work / 256 + 1 < 132 * 16 ? work / 256 + 1 : 132 * 16);
  groupagg_fill_kernel<<<blocks, 256, 0, st>>>(num, n, og, valid, ops, vec);
  return cudaGetLastError();
}
