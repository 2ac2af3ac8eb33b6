// Per-group windows on the shared pane store: the placement scan, the
// per-slot partial evaluation, and the merge-replay tails.
//
// Replaces, in src/repro/kernels/swag/kernel.py (the JAX package's Pallas
// TPU kernels):
//   * pergroup_fused_pallas  -> pergroup_fused_kernel;
//   * pergroup_replay_pallas -> pergroup_replay_kernel;
// and, with no TPU kernel behind it, the XLA lax.scans of _push_decide
// and _push_one_time (src/repro/core/panestore.py) -> pergroup_scan_kernel
// and pergroup_scan_time_kernel.
//
// pergroup_scan_kernel — one warp places the whole stream.  Placement is
// sequential (each tuple's slot depends on the global eviction order), so
// the design makes the common tuple constant-time and takes 32 of them at
// once.  The wrapper gives every group a dense index, its window size and
// its panes as a chain ordered by base.  Shared memory holds, per slot, the
// owner (dense index and id), count, base, stamp and the next pane of the
// same group, and a bitmap of the free slots; per group, its newest and
// oldest pane (up to GROUP_SMEM_MAX groups: more stay in device memory,
// where L1 and L2 serve them); the stream is staged through shared memory
// by cp.async a window ahead.  Within a group the live panes' bases are
// distinct and WA apart, ordered like their stamps, so a group's newest
// pane is the chain's tail, only the chain's head can fall behind the
// group's horizon, and an evicted pane (the minimum stamp) is its group's
// head.  A batch of 32 tuples: __match_any_sync ranks each lane among the
// lanes of its group; a lane whose group's newest pane has room (count +
// rank < WA) places itself at lane count + rank, and the first lane of a
// group whose head falls behind retires it.  The batch commits the lanes
// before its first event (an allocation, or a second pane of a group
// falling behind), the last lane of each group writing the count; the
// event tuple then runs the full step (the warp finds the first free slot
// in the bitmap, else the first minimum stamp, as _push_decide's
// first-index ties pick; the victim leaves its group's chain; the group's
// stale heads retire in a loop), and the next batch starts after it.  A
// batch scan records each tuple's (slot, lane, seq) and the directory
// after every WA chunk; a streaming push places every tuple (the last
// chunk may be short) and keeps only the store after the last.  Both
// record the evictions and retirements; given keys it also keeps the [C, WA] ring in device
// memory (L2): the panes that close in a chunk are sorted by (key, seq) at
// its end by the block's warps, one pane a warp, before they copy the ring
// out (a pane reallocated in the chunk it closed is sorted by the scanning
// warp first).  Bound: the latency of one warp,
// a few dependent shared-memory loads a batch and the full step a WA
// tuples a group; bytes are ~20 a tuple, so the card's memory is idle.
//
// pergroup_scan_time_kernel — the placement of an event-time stream's
// time-mode store: a reorder buffer's emission (a live mask, not a
// prefix), each tuple into the slot of its (group, time pane ts / slide)
// that has room, else the first free slot, else the globally oldest
// (evicted; first index on ties, as _push_one_time's argmin picks).  It
// follows the count-mode scan's design: the common tuple costs O(1) and
// 32 are placed at once.  The directory (owner, count, base, stamp) sits
// in shared memory with an index of the open panes, open-addressed by the
// (group, pane) pair (at most one open pane a pair: a chain's earlier
// links are full): an entry holds the pane's slot and count, and its slot
// becomes -1 the moment the pane fills, is evicted or retires, so a probe
// needs no check against the directory (the index is rebuilt when half of
// it is taken).  Beside them: a bitmap of the free slots, one of the panes
// closed and not yet sorted, and a word a slot for a batch's lanes of
// each pane.  The block's eight warps build the index at launch; then one
// warp places: a window of 32 lanes looks its pairs up, each lane sets its
// bit in its pane's word (an atomic OR; __match_any_sync costs several
// times as much on this card), so a lane's rank among the lanes of its
// pane is a popcount, and the lanes before the first event (no open pane,
// or one that fills before the lane) write their key and timestamp into
// the [C, WA] ring at count + rank, the last lane of a pane the count.
// The event lane is an allocation: the first free slot by a reduction over
// the bitmap, else an argmin pass over the stamps (an eviction: every slot
// is live then, and the signed argmin is right across a wrapped clock),
// the pane allocated behind the horizon retired at once; the window
// resumes after it.  Retirement (a pane wholly below retire_below) runs on
// every cycle in the JAX package, dead lanes included; the horizon is one
// value for the push, so after the first tuple's full pass over every slot
// only a slot a cycle allocates can newly fall behind.  A pane that fills
// is sorted once (stable by key: -0.0 beside 0.0 and NaN last, as
// torch.sort orders them, the lane breaking ties; the timestamp rides
// along): by all eight warps after the last tuple, 32 / WA panes a warp at
// once in registers (a shared buffer for WA > 32), or by the placing warp
// before a slot it closed is reallocated.  Bound: the latency of one warp,
// a probe, an atomic and two ballots a batch, a reduction and one lane's
// stores an allocation; bytes (about 16 a tuple and the panes that close)
// leave the card's memory idle.
//
// pergroup_fused_kernel — parallel over chunks, one block a chunk.  The
// ring is scratch (the fused regime returns only op values) and sum,
// count, min, max and mean do not depend on the order of a pane's lanes,
// so the close sort changes no output and is dropped.  A pane fills lanes
// 0, 1, ... in order and a reallocation overwrites from lane 0, so at
// chunk e the live lanes of slot s are the last cnt[e, s] writes to s at
// or before chunk e (lanes a carried-in pane wrote before the stream are
// the ring's zeros), filtered by seq >= lo[e, s].  The wrapper groups the
// writes by slot (stable, in stream order) and gives each (chunk, slot)
// the end of its run; a warp per slot reduces the run into per-slot
// partials in shared memory, then a thread per output row adds up the
// slots of its group, found by binary search in the chunk's owner-sorted
// slots (stable, so slot order within a group).  Bound: L2 reads of the
// runs, every SM busy.
//
// pergroup_replay_kernel — a row is one live group's window: S runs of WA
// lanes, each run key-sorted but for the group's open pane.  One warp a
// row, with no barrier beyond its own: a block holds a few warps, each
// looping over rows in its own stretch of shared memory, so many rows are
// in flight on an SM.  The ring form reads a group's runs straight from the
// scan's ring snapshot through the slot directory (no gathered [NE*C, S*WA]
// rows; a warp takes its evaluation's live groups only); the row form
// reads gathered rows with a liveness mask.  Dead lanes become the fill
// (the int32 maximum, or a NaN) and set no bit of the row's live bitmap; a
// closed run's live lanes move to the run's front at their rank (a prefix
// count of the bitmap), which keeps the run sorted; the open pane is sorted
// in shared memory; merge-path rounds over the runs that can hold live
// lanes make the row one sorted run, its live keys first; min, max, lower
// median and distinct count come off that prefix, while count, sum and
// mean are taken as the lanes load.  Keys compare as keys (no packing), in
// the panes' order: -0.0 beside +0.0 (both keep their bits), NaN after
// every number, as the close sort and the plain version's merge put it.  Bound: bytes, 8 a
// live slot lane of the ring read once (4.5 a lane of the row form); the
// work is a few shared-memory passes a row.  The time form (TIME, a
// time-mode store) makes a lane live iff it is filled and its timestamp
// (the ring's seq) lies in the evaluation's [lo, hi); a group then owns
// several unfilled panes (one a time pane that did not fill), and every
// run with count < R is sorted as the open run is; each row's live count
// is written out, so the wrapper can drop the rows of groups with none.
#include <cuda_pipeline.h>

#include "tile.cuh"

namespace rt {
namespace {

template <typename K> __device__ __forceinline__ K key_max();
template <> __device__ __forceinline__ int key_max<int>() { return 0x7fffffff; }
template <> __device__ __forceinline__ float key_max<float>() { return __int_as_float(0x7f800000); }
template <typename K> __device__ __forceinline__ K key_min();
template <> __device__ __forceinline__ int key_min<int>() { return SHIFT_FILL; }
template <> __device__ __forceinline__ float key_min<float>() { return __int_as_float(0xff800000); }

// The key order of the panes and the replay's merge: numbers by value
// (-0.0 beside +0.0), NaN after every number and equal to NaN, as
// torch.sort places it.
template <typename K>
__device__ __forceinline__ bool key_lt(K a, K b) { return a < b; }
template <>
__device__ __forceinline__ bool key_lt<float>(float a, float b) {
  return a < b || (a == a && b != b);
}
// What a dead lane of a replay row holds: after every live key in the
// order above (a NaN for float keys, so a live NaN ties with it).
template <typename K> __device__ __forceinline__ K key_fill();
template <> __device__ __forceinline__ int key_fill<int>() { return 0x7fffffff; }
template <> __device__ __forceinline__ float key_fill<float>() { return __int_as_float(0x7fc00000); }

template <typename K>
__device__ __forceinline__ bool key_seq_less(K ka, int sa, K kb, int sb) {
  return key_lt(ka, kb) || (!key_lt(kb, ka) && sa < sb);
}

// Bitonic sort of n (a power of two) (key, seq) pairs in shared memory by
// `nthreads` threads starting at thread 0; `sync` is the barrier between
// passes (a warp's or the block's).
template <typename K, typename Sync>
__device__ void sort_key_seq(K* k, int* s, int n, int tid, int nthreads,
                             Sync sync) {
  for (int kk = 2; kk <= n; kk <<= 1) {
    for (int j = kk >> 1; j > 0; j >>= 1) {
      for (int p = tid; p < n / 2; p += nthreads) {
        const int i = ((p & ~(j - 1)) << 1) | (p & (j - 1));
        const int q = i + j;
        const bool up = (i & kk) == 0;
        const bool sw = up ? key_seq_less(k[q], s[q], k[i], s[i])
                           : key_seq_less(k[i], s[i], k[q], s[q]);
        if (sw) {
          const K tk = k[i]; k[i] = k[q]; k[q] = tk;
          const int ts = s[i]; s[i] = s[q]; s[q] = ts;
        }
      }
      sync();
    }
  }
}

struct WarpSync { __device__ void operator()() const { __syncwarp(); } };
struct BlockSync {
  __device__ void operator()() const { __syncthreads(); }
};

// ------------------------------------------------------- placement scan

// Dynamic shared memory a block may use: the card's 227 KiB less room for
// the kernels' static variables.
constexpr int SMEM_BUDGET = 227 * 1024 - 256;
// Threads of the scan block: the scanning warp, plus seven that sort the
// closed panes and copy the ring after every chunk when the scan keeps it
// (no more: a block of 256 threads keeps up to 255 registers a thread, and
// the scanning warp's loop must not spill).
constexpr int SCAN_RING_THREADS = 256;
constexpr int MAX_SCAN_SLOTS = 4096;
// Group tables (newest, oldest, ws: 12 bytes a group) stay in shared memory
// up to this many groups (48 KiB), in device memory beyond.
constexpr int GROUP_SMEM_MAX = 4096;
// Tuples (group index, key) are staged in shared memory in windows of
// SCAN_STAGE, a ring of SCAN_WINDOWS: the current window and the next are
// resident while the one after is in flight (cp.async), so the scanning
// warp never waits for device memory.
constexpr int SCAN_STAGE = 512;
constexpr int SCAN_WINDOWS = 4;
constexpr int SCAN_RING_MASK = SCAN_STAGE * SCAN_WINDOWS - 1;

struct ScanArgs {
  const int* g;       // [N] dense group index of every tuple
  const void* k;      // [N] keys, or null: no ring
  long long n;        // tuples in NE = ceil(N / WA) chunks, the last one
                      // short only in a push
  int ne, wa, c, ng;
  const int* gid;     // [ng] group id of each dense index
  const int* slots0;  // [5, C] owner (dense, -1 free), count, base, stamp,
                      // next pane of the group (-1: none)
  int* gtab;          // [3, ng] newest, oldest pane, ws of each group; used
                      // in place when not copied to shared memory
  int gsmem;          // 1: the group tables live in shared memory
  int nbuf;           // sort buffers of WA pairs (ring only)
  int* dir;           // [4, C] owner, count, base, stamp after the scan
  int* clock;         // [1] (in/out)
  void* ring_k;       // [C, WA] (in/out) when k
  int* ring_s;        // [C, WA] (in/out) when k
  int* plan;          // [3, NE, WA] slot, lane, seq of every tuple
  int* snaps;         // [4, NE, C] the directory after every chunk (both
                      // null in a push)
  int* clock_s;       // [NE]
  void* rk_s;         // [NE, C, WA] the ring after every chunk, when k
  int* rs_s;          // [NE, C, WA]
  int* events;        // [2] evictions, retirements (out)
  int* stats;         // [2] batches, batches without an event (out)
};

// The ring after chunk e, copied by every thread of the block (16 bytes a
// load when the row length allows, sixteen loads a thread in flight: one SM
// copying from L2 is bound by the loads it keeps in flight).
template <typename K>
__device__ void copy_ring(const K* ring_k, const int* ring_s, K* rk, int* rs,
                          long long cw) {
  if ((cw & 3) == 0) {
    const long long n4 = cw >> 2;
    const int4* sk = reinterpret_cast<const int4*>(ring_k);
    const int4* ss = reinterpret_cast<const int4*>(ring_s);
    int4* dk = reinterpret_cast<int4*>(rk);
    int4* ds = reinterpret_cast<int4*>(rs);
    const long long nt = blockDim.x;
    for (long long x0 = threadIdx.x; x0 < n4; x0 += 8 * nt) {
      int4 vk[8], vs[8];
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        const long long x = x0 + q * nt;
        if (x < n4) {
          vk[q] = sk[x];
          vs[q] = ss[x];
        }
      }
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        const long long x = x0 + q * nt;
        if (x < n4) {
          dk[x] = vk[q];
          ds[x] = vs[q];
        }
      }
    }
  } else {
    for (long long x = threadIdx.x; x < cw; x += blockDim.x) {
      rk[x] = ring_k[x];
      rs[x] = ring_s[x];
    }
  }
}

// The directory and scratch of the scan in shared memory.
template <typename K>
struct ScanSmem {
  int *own, *cnt, *base, *stamp, *next;  // [C]
  int* oid;                               // [C] owner id (PAD_GROUP free)
  unsigned* freew;                        // [ceil(C/32)] bit s: slot s free
  int *pend, *plist;                      // [C] ring: closed in this chunk
  int* st_g;                              // [SCAN_WINDOWS * SCAN_STAGE]
  K* st_k;                                // the same, ring
  int *g_new, *g_old;                     // [ng] (shared or device memory)
  const int* g_ws;                        // [ng]
  int* sbuf;                              // [nbuf, 2, WA] ring sort buffers
};

// Sort pane `s` of the ring by (key, seq) with one warp and its buffer.
template <typename K>
__device__ void sort_pane(K* ring_k, int* ring_s, int s, int wa, int* buf,
                          int lane) {
  int* bs = buf;
  K* bk = reinterpret_cast<K*>(buf + wa);
  const long long row = static_cast<long long>(s) * wa;
  for (int l = lane; l < wa; l += 32) {
    bk[l] = ring_k[row + l];
    bs[l] = ring_s[row + l];
  }
  __syncwarp();
  sort_key_seq<K>(bk, bs, wa, lane, 32, WarpSync());
  for (int l = lane; l < wa; l += 32) {
    ring_k[row + l] = bk[l];
    ring_s[row + l] = bs[l];
  }
  __syncwarp();
}

// The directory after chunk e into its snapshot, by every thread of the
// block.
template <typename K>
__device__ __forceinline__ void snap_directory(const ScanArgs& a,
                                               const ScanSmem<K>& m, int e) {
  const int C = a.c, tid = threadIdx.x, nt = blockDim.x;
  const long long nc = static_cast<long long>(a.ne) * C;
  const long long ec = static_cast<long long>(e) * C;
  if ((C & 3) == 0) {  // 16 bytes a load and a store
    const int c4 = C >> 2;
    const int4* cols[4] = {reinterpret_cast<const int4*>(m.oid),
                           reinterpret_cast<const int4*>(m.cnt),
                           reinterpret_cast<const int4*>(m.base),
                           reinterpret_cast<const int4*>(m.stamp)};
    for (int x = tid; x < c4; x += nt) {
      int4 v[4];
#pragma unroll
      for (int f = 0; f < 4; ++f) v[f] = cols[f][x];
#pragma unroll
      for (int f = 0; f < 4; ++f)
        reinterpret_cast<int4*>(a.snaps + f * nc + ec)[x] = v[f];
    }
  } else {
    for (int x = tid; x < C; x += nt) {
      a.snaps[ec + x] = m.oid[x];
      a.snaps[nc + ec + x] = m.cnt[x];
      a.snaps[2 * nc + ec + x] = m.base[x];
      a.snaps[3 * nc + ec + x] = m.stamp[x];
    }
  }
}

// End of chunk e, run by every thread of the block: the panes that closed
// in the chunk sorted (ring); in a batch scan (SNAP), the ring copied out
// and the directory and clock recorded.
template <typename K, bool RING, bool SNAP>
__device__ __forceinline__ void chunk_end(const ScanArgs& a,
                                          const ScanSmem<K>& m, int e,
                                          const int* s_clock, int* s_npend) {
  const int WA = a.wa;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  __syncthreads();
  if (RING) {
    K* ring_k = static_cast<K*>(a.ring_k);
    const int np = *s_npend;
    if (warp < a.nbuf) {
      for (int p = warp; p < np; p += a.nbuf) {
        const int s = m.plist[p];
        if (m.pend[s])
          sort_pane<K>(ring_k, a.ring_s, s, WA, m.sbuf + 2 * warp * WA, lane);
      }
    }
    __syncthreads();
    for (int p = tid; p < np; p += blockDim.x) m.pend[m.plist[p]] = 0;
    if (SNAP) {
      const long long cw = static_cast<long long>(a.c) * WA;
      copy_ring<K>(ring_k, a.ring_s, static_cast<K*>(a.rk_s) + e * cw,
                   a.rs_s + e * cw, cw);
    }
  }
  if (SNAP) snap_directory<K>(a, m, e);
  if (tid == 0) {
    if (SNAP) a.clock_s[e] = *s_clock;
    *s_npend = 0;
  }
  __syncthreads();
}

// Start copying window w of the stream (its group indices and, with a
// ring, keys) into its place in the staging ring; one cp.async group.
template <typename K, bool RING>
__device__ __forceinline__ void stage_window(const ScanArgs& a,
                                             const ScanSmem<K>& m,
                                             long long w, long long n,
                                             int lane) {
  const long long w0 = w * SCAN_STAGE;
  const int len = static_cast<int>(n - w0 < SCAN_STAGE ? n - w0 : SCAN_STAGE);
  const int at = static_cast<int>(w0 & SCAN_RING_MASK);
  for (int x = lane; x < len; x += 32) {
    __pipeline_memcpy_async(m.st_g + at + x, a.g + w0 + x, sizeof(int));
    if (RING)
      __pipeline_memcpy_async(m.st_k + at + x,
                              static_cast<const K*>(a.k) + w0 + x, sizeof(K));
  }
  __pipeline_commit();
}

// RING: keys given, the ring kept; GS: the group tables in shared memory;
// SNAP: a batch scan, the plan and the store after every chunk recorded
// (else a push: only the store after the last tuple).
template <typename K, bool RING, bool GS, bool SNAP>
__global__ void __launch_bounds__(RING ? SCAN_RING_THREADS : 32)
pergroup_scan_kernel(ScanArgs a) {
  extern __shared__ __align__(16) unsigned char dyn[];
  __shared__ int s_clock, s_npend;
  const int C = a.c, WA = a.wa, NG = a.ng;
  constexpr bool ring = RING;
  const int tid = threadIdx.x, lane = tid & 31;

  ScanSmem<K> m;
  m.own = reinterpret_cast<int*>(dyn);
  m.cnt = m.own + C;
  m.base = m.cnt + C;
  m.stamp = m.base + C;
  m.next = m.stamp + C;
  m.oid = m.next + C;
  const int nwords = (C + 31) / 32;
  m.freew = reinterpret_cast<unsigned*>(m.oid + C);
  m.pend = reinterpret_cast<int*>(m.freew + nwords);
  m.plist = m.pend + (ring ? C : 0);
  m.st_g = m.plist + (ring ? C : 0);
  m.st_k = reinterpret_cast<K*>(m.st_g + SCAN_WINDOWS * SCAN_STAGE);
  int* gsh = reinterpret_cast<int*>(
      m.st_k + (ring ? SCAN_WINDOWS * SCAN_STAGE : 0));
  m.sbuf = gsh + (GS ? 3 * NG : 0);
  m.g_new = GS ? gsh : a.gtab;
  m.g_old = m.g_new + NG;
  m.g_ws = m.g_old + NG;

  for (int s = tid; s < C; s += blockDim.x) {
    m.own[s] = a.slots0[s];
    m.oid[s] = m.own[s] >= 0 ? a.gid[m.own[s]] : PAD_GROUP;
    m.cnt[s] = a.slots0[C + s];
    m.base[s] = a.slots0[2 * C + s];
    m.stamp[s] = a.slots0[3 * C + s];
    m.next[s] = a.slots0[4 * C + s];
    if (ring) m.pend[s] = 0;
  }
  __syncthreads();
  for (int w = tid; w < nwords; w += blockDim.x) {
    unsigned bits = 0;
    for (int j = 0; j < 32 && w * 32 + j < C; ++j)
      if (m.own[w * 32 + j] < 0) bits |= 1u << j;
    m.freew[w] = bits;
  }
  if (GS)
    for (int x = tid; x < 3 * NG; x += blockDim.x) gsh[x] = a.gtab[x];
  if (tid == 0) {
    s_clock = a.clock[0];
    s_npend = 0;
  }
  __syncthreads();

  if (tid >= 32) {  // helpers: the chunk ends
    for (int e = 0; e < a.ne; ++e)
      chunk_end<K, RING, SNAP>(a, m, e, &s_clock, &s_npend);
    return;
  }

  const K* keys = static_cast<const K*>(a.k);
  K* ring_k = static_cast<K*>(a.ring_k);
  const long long n = a.n;
  const unsigned below = (1u << lane) - 1;
  int clock = s_clock;
  int evictions = 0, retired = 0, batches = 0, clean = 0, npend = 0;
  long long i = 0;
  // windows 0 and 1 resident, 2 in flight
  const long long nwin = (n + SCAN_STAGE - 1) / SCAN_STAGE;
  for (long long w = 0; w < 3 && w < nwin; ++w)
    stage_window<K, RING>(a, m, w, n, lane);
  __pipeline_wait_prior(nwin > 2 ? 1 : 0);
  __syncwarp();
  long long cur = 0;    // the window batches start in
  long long stop = WA < n ? WA : n;  // batches stay in a chunk
  int e = 0;
  while (i < n) {
    const int nb = static_cast<int>(stop - i < 32 ? stop - i : 32);
    if (i >= (cur + 1) * SCAN_STAGE) {  // next window: the one after in
      ++cur;                              // flight, the old one's place free
      __pipeline_wait_prior(0);
      __syncwarp();
      if (cur + 2 < nwin) stage_window<K, RING>(a, m, cur + 2, n, lane);
    }
    const bool in = lane < nb;
    const int off = static_cast<int>((i + lane) & SCAN_RING_MASK);
    const int d = in ? m.st_g[off] : -1 - lane;
    const K kv = (ring && in) ? m.st_k[off] : K(0);

    // the fast path: the group's newest pane has room for this lane, and
    // no more than its oldest pane falls behind the window
    const unsigned peers = __match_any_sync(FULL_MASK, d);
    const int rank = __popc(peers & below);
    const int t = in ? m.g_new[d] : -1;
    const int h = in ? m.g_old[d] : -1;
    const int ws = in ? m.g_ws[d] : 0;
    int c = 0, b = 0, nh = -1;
    bool ev = true, r1 = false;
    if (t >= 0) {
      const int bh = m.base[h];
      nh = m.next[h];
      c = m.cnt[t] + rank;
      b = m.base[t];
      const int horizon = b + c + 1 - ws;
      // r1: the head falls behind (never the pane written, so nh >= 0);
      // its successor too is an event
      r1 = bh + WA <= horizon;
      ev = c >= WA || (r1 && m.base[nh] + WA <= horizon);
    }
    const unsigned evm = __ballot_sync(FULL_MASK, in && ev);
    const int f = evm ? __ffs(evm) - 1 : nb;  // the first event lane
    const unsigned before = f >= 32 ? FULL_MASK : (1u << f) - 1;
    // the first lane of each group before f whose head falls behind
    // retires it (horizons rise with rank: later lanes find it gone)
    const unsigned rm = __ballot_sync(FULL_MASK, r1) & before;
    const bool retires = r1 && lane < f && lane == __ffs(rm & peers) - 1;
    retired += __popc(__ballot_sync(FULL_MASK, retires));
    ++batches;
    clean += evm == 0 ? 1 : 0;
    if (lane < f) {
      const long long at = i + lane;
      if (SNAP) {
        a.plan[at] = t;
        a.plan[n + at] = c;
        a.plan[2 * n + at] = b + c;
      }
      if (lane == 31 - __clz(peers & before)) m.cnt[t] = c + 1;
      if (retires) {
        m.own[h] = -1;
        m.oid[h] = PAD_GROUP;
        m.cnt[h] = 0;
        m.stamp[h] = -1;
        atomicOr(m.freew + (h >> 5), 1u << (h & 31));
        m.g_old[d] = nh;
      }
      if (ring) {
        const long long at_r = static_cast<long long>(t) * WA + c;
        ring_k[at_r] = kv;
        a.ring_s[at_r] = b + c;
      }
    }
    if (ring) {
      const bool closes = lane < f && c + 1 == WA;
      const unsigned cm = __ballot_sync(FULL_MASK, closes);
      if (closes) {
        m.pend[t] = 1;
        m.plist[npend + __popc(cm & below)] = t;
      }
      npend += __popc(cm);
    }
    __syncwarp();

    if (f < nb) {  // the full step for tuple i + f (warp-uniform values)
      const long long at = i + f;
      const int dg = __shfl_sync(FULL_MASK, d, f);
      const K kg = __shfl_sync(FULL_MASK, kv, f);
      const int tn = m.g_new[dg];
      const int cn = tn >= 0 ? m.cnt[tn] : 0;
      const int mg = tn >= 0 ? m.base[tn] + cn : 0;
      int slot, ln;
      if (tn >= 0 && cn < WA) {
        slot = tn;
        ln = cn;
        if (lane == 0) m.cnt[tn] = cn + 1;
      } else {
        // the first free slot (the bitmap), else the first minimum stamp
        int ff = 0x7fffffff;
        for (int w = lane; w < nwords; w += 32) {
          const unsigned bits = m.freew[w];
          if (bits != 0 && ff == 0x7fffffff) ff = w * 32 + __ffs(bits) - 1;
        }
        ff = __reduce_min_sync(FULL_MASK, ff);
        const bool evict = ff == 0x7fffffff;
        if (evict) {
          int ov = 0x7fffffff, oi = 0x7fffffff;
          for (int s0 = lane; s0 < C; s0 += 128) {
            int sv[4];
#pragma unroll
            for (int q = 0; q < 4; ++q)
              sv[q] = s0 + q * 32 < C ? m.stamp[s0 + q * 32] : 0x7fffffff;
#pragma unroll
            for (int q = 0; q < 4; ++q)
              if (sv[q] < ov) {
                ov = sv[q];
                oi = s0 + q * 32;
              }
          }
          const int omin = __reduce_min_sync(FULL_MASK, ov);
          slot = __reduce_min_sync(FULL_MASK, ov == omin ? oi : 0x7fffffff);
          ++evictions;
        } else {
          slot = ff;
        }
        ln = 0;
        if (ring && m.pend[slot]) {  // closed in this chunk: sort it first
          sort_pane<K>(ring_k, a.ring_s, slot, WA, m.sbuf, lane);
          if (lane == 0) m.pend[slot] = 0;
        }
        if (lane == 0) {
          if (evict) {  // the victim leaves its group's chain
            const int v = m.own[slot];
            const int nx = m.next[slot];
            int p = m.g_old[v];
            if (p == slot) {
              m.g_old[v] = nx;
            } else {  // not the head: only on a state the scan never makes
              while (m.next[p] != slot) p = m.next[p];
              m.next[p] = nx;
            }
            if (m.g_new[v] == slot) m.g_new[v] = p == slot ? -1 : p;
          }
          m.freew[slot >> 5] &= ~(1u << (slot & 31));
          const int tail = m.g_new[dg];
          if (tail >= 0) m.next[tail] = slot; else m.g_old[dg] = slot;
          m.g_new[dg] = slot;
          m.own[slot] = dg;
          m.oid[slot] = a.gid[dg];
          m.cnt[slot] = 1;
          m.base[slot] = mg;
          m.stamp[slot] = clock;
          m.next[slot] = -1;
        }
        ++clock;
      }
      if (lane == 0) {
        if (SNAP) {
          a.plan[at] = slot;
          a.plan[n + at] = ln;
          a.plan[2 * n + at] = mg;
        }
        if (ring) {
          const long long at_r = static_cast<long long>(slot) * WA + ln;
          ring_k[at_r] = kg;
          a.ring_s[at_r] = mg;
          if (ln + 1 == WA) {
            m.pend[slot] = 1;
            m.plist[npend] = slot;
          }
        }
      }
      if (ring && ln + 1 == WA) ++npend;
      __syncwarp();
      // retire the group's panes that no longer intersect its last WS_g:
      // the oldest first (the pane just written never retires)
      const int horizon = mg + 1 - m.g_ws[dg];
      for (;;) {
        const int old = m.g_old[dg];
        if (m.base[old] + WA > horizon) break;
        if (lane == 0) {
          m.own[old] = -1;
          m.oid[old] = PAD_GROUP;
          m.freew[old >> 5] |= 1u << (old & 31);
          m.cnt[old] = 0;
          m.stamp[old] = -1;
          m.g_old[dg] = m.next[old];
        }
        ++retired;
        __syncwarp();
      }
      i = at + 1;
    } else {
      i += nb;
    }
    if (i == stop) {
      if (lane == 0) {
        s_clock = clock;
        s_npend = npend;
      }
      chunk_end<K, RING, SNAP>(a, m, e, &s_clock, &s_npend);
      npend = 0;
      ++e;
      stop = stop + WA < n ? stop + WA : n;
    }
  }
  for (int s = lane; s < C; s += 32) {
    a.dir[s] = m.oid[s];
    a.dir[C + s] = m.cnt[s];
    a.dir[2 * C + s] = m.base[s];
    a.dir[3 * C + s] = m.stamp[s];
  }
  if (lane == 0) {
    a.clock[0] = clock;
    a.events[0] = evictions;
    a.events[1] = retired;
    a.stats[0] = batches;
    a.stats[1] = clean;
  }
}

// ---------------------------------------------- time-mode placement scan

constexpr int TS_FLOOR = -(1 << 30);  // no retirement
constexpr int I32_MAX = 0x7fffffff;

__device__ __forceinline__ int floor_div(int t, int s) {  // s > 0
  const int q = t / s;
  return (t % s != 0 && t < 0) ? q - 1 : q;
}

__device__ __forceinline__ int mul_wrap(int a, int b) {
  return static_cast<int>(static_cast<unsigned>(a) * static_cast<unsigned>(b));
}

// Stable key order of torch.sort: ties (and -0.0 beside 0.0) by lane, NaN
// after every number.
template <typename K>
__device__ __forceinline__ bool stable_less(K a, int ia, K b, int ib) {
  return a < b || (!(b < a) && ia < ib);
}
template <>
__device__ __forceinline__ bool stable_less<float>(float a, int ia, float b,
                                                   int ib) {
  const bool an = a != a, bn = b != b;
  if (an || bn) return an && bn ? ia < ib : bn;
  return a < b || (a == b && ia < ib);
}

// Sort row `s` of the ring stably by key (its timestamps along) with one
// warp, through the buffers bk, bs, bi of WA entries.
template <typename K>
__device__ void sort_row_stable(K* ring_k, int* ring_s, long long s, int wa,
                                K* bk, int* bs, int* bi, int lane) {
  const long long row = s * wa;
  for (int l = lane; l < wa; l += 32) {
    bk[l] = ring_k[row + l];
    bs[l] = ring_s[row + l];
    bi[l] = l;
  }
  __syncwarp();
  for (int kk = 2; kk <= wa; kk <<= 1) {
    for (int jj = kk >> 1; jj > 0; jj >>= 1) {
      for (int p = lane; p < wa / 2; p += 32) {
        const int i = ((p & ~(jj - 1)) << 1) | (p & (jj - 1));
        const int q = i + jj;
        const bool up = (i & kk) == 0;
        const bool sw = up ? stable_less<K>(bk[q], bi[q], bk[i], bi[i])
                           : stable_less<K>(bk[i], bi[i], bk[q], bi[q]);
        if (sw) {
          const K tk = bk[i]; bk[i] = bk[q]; bk[q] = tk;
          int x = bs[i]; bs[i] = bs[q]; bs[q] = x;
          x = bi[i]; bi[i] = bi[q]; bi[q] = x;
        }
      }
      __syncwarp();
    }
  }
  for (int l = lane; l < wa; l += 32) {
    ring_k[row + l] = bk[l];
    ring_s[row + l] = bs[l];
  }
  __syncwarp();
}

// Threads of the time-mode placement's block: the placing warp, and seven
// more that help build its index at launch and sort the panes that closed
// in the push at its end.
constexpr int TIME_THREADS = 256;

struct TimeScanArgs {
  const int* g;             // [n] group ids
  const void* k;            // [n] keys
  const int* ts;            // [n] timestamps
  const bool* live;         // [n]
  int n;
  const int* retire_below;  // [] or null: TS_FLOOR
  int wa, c, slide;
  int *owner, *count, *base, *stamp, *clock;  // [C], [] (in/out)
  void* ring_k;             // [C, WA] (in/out)
  int* ring_s;              // [C, WA] timestamps (in/out)
  int* events;              // [2] evictions, retirements
  int hsize;                // index entries (a power of two, >= 2C)
  void* aux;                // device memory for the index and bitmaps, or
                            // null: they sit in shared memory
};

// The index, bitmaps and list of the time-mode placement (in shared memory,
// or in device memory when they do not fit beside the directory).
struct TimeAux {
  int4* ht;         // [hsize] (group, pane id, slot, count): a pair's open
                    // pane (slot -1 once it is not open)
  unsigned* freew;  // [ceil(C/32)] bit s: slot s free
  unsigned* pendw;  // [ceil(C/32)] bit s: pane s closed, not yet sorted
  int* list;        // [C] the panes to sort at the end
  unsigned* peer;   // [C] a batch's lanes of each open pane (zero between)
};

__host__ __device__ inline size_t time_aux_bytes(int c, int hsize) {
  const size_t nw = (static_cast<size_t>(c) + 31) / 32;
  return 16 * static_cast<size_t>(hsize) + 4 * (2 * nw + 2 * c);
}

__device__ __forceinline__ TimeAux time_aux(void* p, int c, int hsize) {
  TimeAux x;
  x.ht = static_cast<int4*>(p);
  x.freew = reinterpret_cast<unsigned*>(x.ht + hsize);
  x.pendw = x.freew + (c + 31) / 32;
  x.list = reinterpret_cast<int*>(x.pendw + (c + 31) / 32);
  x.peer = reinterpret_cast<unsigned*>(x.list + c);
  return x;
}

__device__ __forceinline__ unsigned pair_hash(int g, int pid) {
  unsigned h = static_cast<unsigned>(g) * 0x9E3779B1u ^
               (static_cast<unsigned>(pid) + 0x7F4A7C15u) * 0x85EBCA77u;
  h ^= h >> 15;
  h *= 0x2C1B3C6Du;
  return h ^ (h >> 13);
}

__device__ __forceinline__ unsigned long long pair_word(int g, int pid) {
  return static_cast<unsigned>(g) |
         (static_cast<unsigned long long>(static_cast<unsigned>(pid)) << 32);
}

// Where (g, pid) sits in the index: its entry, or the empty entry where it
// would go (linear probing; an entry whose group is PAD_GROUP is empty).
// An entry's slot is -1 once its pane is no longer open.
__device__ __forceinline__ unsigned index_at(const int4* ht, unsigned hmask,
                                             int g, int pid) {
  unsigned h = pair_hash(g, pid) & hmask;
  for (int4 e = ht[h]; e.x != PAD_GROUP && (e.x != g || e.y != pid);
       e = ht[h])
    h = (h + 1) & hmask;
  return h;
}

// Enter open pane `slot` of (g, pid) with its count at launch, among
// concurrent threads: the pair claims its entry by a 64-bit
// compare-and-swap, and the least slot of a pair wins, as argmax's first
// index (counts are filled in after).  Returns 1 if it took a new entry.
__device__ __forceinline__ int index_claim(int4* ht, unsigned hmask, int g,
                                           int pid, int slot) {
  const unsigned long long want = pair_word(g, pid);
  const unsigned long long empty = pair_word(PAD_GROUP, 0);
  for (unsigned h = pair_hash(g, pid) & hmask;; h = (h + 1) & hmask) {
    const unsigned long long old = atomicCAS(
        reinterpret_cast<unsigned long long*>(ht + h), empty, want);
    if (old == empty || old == want) {
      atomicMin(&ht[h].z, slot);
      return old == empty;
    }
  }
}

// The index anew from the directory (every thread of `nt` from `tid`, a
// barrier `sync` between the passes): every open pane, with its count.
template <typename Sync>
__device__ __forceinline__ void index_build(int4* ht, int hsize,
                                            const int* own, const int* cnt,
                                            const int* base, int C, int WA,
                                            int tid, int nt, Sync sync) {
  const unsigned hmask = static_cast<unsigned>(hsize - 1);
  for (int h = tid; h < hsize; h += nt)
    ht[h] = make_int4(PAD_GROUP, 0, I32_MAX, 0);
  sync();
  for (int s = tid; s < C; s += nt)
    if (own[s] != PAD_GROUP && cnt[s] < WA)
      index_claim(ht, hmask, own[s], base[s], s);
  sync();
  for (int h = tid; h < hsize; h += nt)
    if (ht[h].x != PAD_GROUP) ht[h].w = cnt[ht[h].z];
  sync();
}

// Sort the panes `slot` names (one a run of WA lanes, -1: none) stably by
// key with one warp, their timestamps along: a bitonic network of shuffles
// within runs of WA <= 32 lanes, in registers.
template <typename K>
__device__ void sort_runs_warp(K* ring_k, int* ring_s, int slot, int wa,
                               int lane) {
  const int e = lane & (wa - 1);
  const bool on = slot >= 0;
  const long long at = static_cast<long long>(on ? slot : 0) * wa + e;
  K k = on ? ring_k[at] : K(0);
  int t = on ? ring_s[at] : 0, id = e;
  for (int kk = 2; kk <= wa; kk <<= 1) {
    for (int jj = kk >> 1; jj > 0; jj >>= 1) {
      const K pk = __shfl_xor_sync(FULL_MASK, k, jj);
      const int pt = __shfl_xor_sync(FULL_MASK, t, jj);
      const int pi = __shfl_xor_sync(FULL_MASK, id, jj);
      const bool lt = stable_less<K>(pk, pi, k, id);
      // the lower lane of an ascending pair keeps the less, of a
      // descending one the greater
      if (((e & jj) == 0) == ((e & kk) == 0) ? lt : !lt) {
        k = pk;
        t = pt;
        id = pi;
      }
    }
  }
  if (on) {
    ring_k[at] = k;
    ring_s[at] = t;
  }
}

// Sort pane `slot` with the placing warp (WA > 32: through the buffers).
template <typename K>
__device__ __forceinline__ void sort_pane_time(K* ring_k, int* ring_s,
                                               int slot, int wa, K* bk,
                                               int* bs, int* bi, int lane) {
  if (wa <= 32)
    sort_runs_warp<K>(ring_k, ring_s, lane < wa ? slot : -1, wa, lane);
  else
    sort_row_stable<K>(ring_k, ring_s, slot, wa, bk, bs, bi, lane);
}

template <typename K>
__global__ void __launch_bounds__(TIME_THREADS, 1)
pergroup_scan_time_kernel(TimeScanArgs a) {
  extern __shared__ __align__(16) unsigned char dyn[];
  __shared__ int s_events[2], s_npend;
  const int C = a.c, WA = a.wa, H = a.hsize;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nt = blockDim.x, nw = (C + 31) / 32;
  const unsigned hmask = static_cast<unsigned>(H - 1);
  int* own = reinterpret_cast<int*>(dyn);
  int* cnt = own + C;
  int* base = cnt + C;
  int* stamp = base + C;
  K* bk = reinterpret_cast<K*>(stamp + C);  // WA > 32: the sort buffers
  int* bs = reinterpret_cast<int*>(bk + (WA > 32 ? WA : 0));
  int* bi = bs + (WA > 32 ? WA : 0);
  const TimeAux x = time_aux(a.aux ? a.aux : bi + (WA > 32 ? WA : 0), C, H);
  K* ring_k = static_cast<K*>(a.ring_k);

  // the launch's build, every thread: the directory, the free bitmap, the
  // index of the open panes
  for (int s = tid; s < C; s += nt) {
    own[s] = a.owner[s];
    cnt[s] = a.count[s];
    base[s] = a.base[s];
    stamp[s] = a.stamp[s];
    x.peer[s] = 0;
  }
  for (int w = tid; w < nw; w += nt) x.pendw[w] = 0;
  if (tid == 0) s_npend = 0;
  __syncthreads();
  for (int w = warp; w < nw; w += nt / 32) {
    const int s = w * 32 + lane;
    const unsigned b = __ballot_sync(FULL_MASK, s < C && own[s] == PAD_GROUP);
    if (lane == 0) x.freew[w] = b;
  }
  index_build(x.ht, H, own, cnt, base, C, WA, tid, nt, BlockSync());

  if (warp == 0) {
    const K* keys = static_cast<const K*>(a.k);
    const int n = a.n, slide = a.slide;
    const int rb = a.retire_below ? *a.retire_below : TS_FLOOR;
    const unsigned below = (1u << lane) - 1;
    int clock = *a.clock, evictions = 0, retired = 0;
    int used = 0;  // index entries taken, an upper bound
    for (int h = lane; h < H; h += 32) used += x.ht[h].x != PAD_GROUP;
    used = __reduce_add_sync(FULL_MASK, used);

    // An allocation for tuple i (warp-uniform arguments): the first free
    // slot, else the first oldest (evicted); the pane opened in the index,
    // or retired at once when it lies behind the horizon (but on the
    // first tuple, whose retirement pass follows).
    auto allocate = [&](int g, K kv, int t, int pid, int i) {
      int ff = I32_MAX;
      for (int w = lane; w < nw; w += 32) {
        const unsigned bits = x.freew[w];
        if (bits != 0 && ff == I32_MAX) ff = w * 32 + __ffs(bits) - 1;
      }
      int slot = __reduce_min_sync(FULL_MASK, ff);
      const bool evict = slot == I32_MAX;
      if (evict) {  // every slot is live: argmin of the stamps
        int ov = I32_MAX, oi = I32_MAX;
        for (int s0 = lane; s0 < C; s0 += 128) {
          int sv[4];
#pragma unroll
          for (int q = 0; q < 4; ++q)
            sv[q] = s0 + q * 32 < C ? stamp[s0 + q * 32] : I32_MAX;
#pragma unroll
          for (int q = 0; q < 4; ++q)
            if (s0 + q * 32 < C && (sv[q] < ov || oi == I32_MAX)) {
              ov = sv[q];
              oi = s0 + q * 32;
            }
        }
        const int om = __reduce_min_sync(FULL_MASK, ov);
        slot = __reduce_min_sync(FULL_MASK, ov == om ? oi : I32_MAX);
        ++evictions;
        if (lane == 0 && cnt[slot] < WA)  // the victim's pane closes
          x.ht[index_at(x.ht, hmask, own[slot], base[slot])].z = -1;
      }
      if ((x.pendw[slot >> 5] >> (slot & 31)) & 1) {  // closed: sort first
        sort_pane_time<K>(ring_k, a.ring_s, slot, WA, bk, bs, bi, lane);
        if (lane == 0) x.pendw[slot >> 5] &= ~(1u << (slot & 31));
      }
      __syncwarp();
      const bool behind =
          i > 0 && mul_wrap(add_wrap(pid, 1), slide) <= rb;
      if (lane == 0) {
        const long long at = static_cast<long long>(slot) * WA;
        own[slot] = behind ? PAD_GROUP : g;
        base[slot] = pid;
        stamp[slot] = behind ? -1 : clock;
        cnt[slot] = behind ? 0 : 1;
        ring_k[at] = kv;
        a.ring_s[at] = t;
        const unsigned bit = 1u << (slot & 31);  // taken, or free again
        x.freew[slot >> 5] = behind ? x.freew[slot >> 5] | bit
                                    : x.freew[slot >> 5] & ~bit;
        if (!behind && WA > 1)
          x.ht[index_at(x.ht, hmask, g, pid)] = make_int4(g, pid, slot, 1);
      }
      clock = add_wrap(clock, 1);
      retired += behind;
      used += !behind && WA > 1;
      __syncwarp();
      if (2 * used > H) {  // too many entries of closed panes: anew
        index_build(x.ht, H, own, cnt, base, C, WA, lane, 32, WarpSync());
        used = 0;
        for (int h = lane; h < H; h += 32) used += x.ht[h].x != PAD_GROUP;
        used = __reduce_add_sync(FULL_MASK, used);
      }
    };

    // 32 tuples a window, one a lane; the next window loaded meanwhile
    bool nl = false;
    int ng = 0, nt_ = 0;
    K nk = K(0);
    if (lane < n) {
      nl = a.live[lane];
      ng = a.g[lane];
      nt_ = a.ts[lane];
      nk = keys[lane];
    }
    for (int w0 = 0; w0 < n; w0 += 32) {
      const bool lv = nl;
      const int g = ng, t = nt_;
      const K kv = nk;
      nl = false;  // lanes past the last tuple are dead
      if (w0 + 32 + lane < n) {
        nl = a.live[w0 + 32 + lane];
        ng = a.g[w0 + 32 + lane];
        nt_ = a.ts[w0 + 32 + lane];
        nk = keys[w0 + 32 + lane];
      }
      const int pid = floor_div(t, slide);
      // batches: the lanes of `todo` look their pane up; a lane whose open
      // pane has room at its rank among the lanes of that pane is placed
      // at once, up to the first that is not (an allocation)
      auto place = [&](unsigned todo) {
        while (todo) {
          const bool on = (todo >> lane) & 1;
          unsigned h = 0;
          int s = -1, c0 = 0;
          if (on) {
            h = index_at(x.ht, hmask, g, pid);
            const int4 e = x.ht[h];
            if (e.x != PAD_GROUP) {
              s = e.z;
              c0 = e.w;
            }
          }
          // the lanes of each open pane: a bit each in the pane's word
          if (s >= 0) atomicOr(x.peer + s, 1u << lane);
          __syncwarp();
          const unsigned peers = s >= 0 ? x.peer[s] : 1u << lane;
          __syncwarp();
          if (s >= 0) x.peer[s] = 0;
          const int c = c0 + __popc(peers & below);
          const unsigned evm =
              __ballot_sync(FULL_MASK, on && (s < 0 || c >= WA));
          const int f = evm ? __ffs(evm) - 1 : 32;
          const unsigned before = f >= 32 ? FULL_MASK : (1u << f) - 1;
          if (on && lane < f) {
            const long long at = static_cast<long long>(s) * WA + c;
            ring_k[at] = kv;
            a.ring_s[at] = t;
            if (lane == 31 - __clz(peers & before)) {  // the pair's last
              cnt[s] = c + 1;
              x.ht[h].w = c + 1;
              if (c + 1 == WA) {  // the pane closes
                x.ht[h].z = -1;
                atomicOr(x.pendw + (s >> 5), 1u << (s & 31));
              }
            }
          }
          __syncwarp();
          if (f == 32) break;
          // the event: no open pane for lane f (the index missed, or its
          // pane filled before it)
          allocate(__shfl_sync(FULL_MASK, g, f),
                   __shfl_sync(FULL_MASK, kv, f),
                   __shfl_sync(FULL_MASK, t, f),
                   __shfl_sync(FULL_MASK, pid, f), w0 + f);
          todo &= f >= 31 ? 0u : FULL_MASK << (f + 1);
        }
      };
      unsigned todo = __ballot_sync(FULL_MASK, lv);
      if (w0 == 0) {
        place(todo & 1u);  // the first tuple alone
        // every pane behind the horizon, once, after the first tuple; an
        // open one leaves the index
        for (int s0 = 0; s0 < C; s0 += 32) {
          const int s = s0 + lane;
          const bool r = s < C && own[s] != PAD_GROUP &&
                         mul_wrap(add_wrap(base[s], 1), slide) <= rb;
          if (r) {
            if (cnt[s] < WA) x.ht[index_at(x.ht, hmask, own[s], base[s])].z = -1;
            own[s] = PAD_GROUP;
            cnt[s] = 0;
            stamp[s] = -1;
          }
          const unsigned b = __ballot_sync(FULL_MASK, r);
          if (lane == 0 && b) x.freew[s0 >> 5] |= b;
          retired += __popc(b);
        }
        __syncwarp();
        todo &= ~1u;
      }
      place(todo);
    }
    if (lane == 0) {
      *a.clock = clock;
      s_events[0] = evictions;
      s_events[1] = retired;
    }
  }
  __syncthreads();

  // the end, every thread: the panes that closed, sorted once; the
  // directory out
  for (int w = tid; w < nw; w += nt) {
    unsigned bits = x.pendw[w];
    if (bits) {
      int at = atomicAdd(&s_npend, __popc(bits));
      for (; bits; bits &= bits - 1) x.list[at++] = w * 32 + __ffs(bits) - 1;
    }
  }
  __syncthreads();
  const int np = s_npend;
  if (WA <= 32) {
    const int per = 32 / WA;  // panes a warp sorts at once
    for (int p0 = warp * per; p0 < np; p0 += (nt / 32) * per) {
      const int p = p0 + lane / WA;
      sort_runs_warp<K>(ring_k, a.ring_s, p < np ? x.list[p] : -1, WA, lane);
    }
  } else if (warp == 0) {
    for (int p = 0; p < np; ++p)
      sort_row_stable<K>(ring_k, a.ring_s, x.list[p], WA, bk, bs, bi, lane);
  }
  for (int s = tid; s < C; s += nt) {
    a.owner[s] = own[s];
    a.count[s] = cnt[s];
    a.base[s] = base[s];
    a.stamp[s] = stamp[s];
  }
  if (tid == 0) {
    a.events[0] = s_events[0];
    a.events[1] = s_events[1];
  }
}

// ---------------------------------------------------- per-slot partials

struct FusedArgs {
  const void* wk;     // [NE*WA] keys of the writes, by slot, stream order
  const int* wq;      // [NE*WA] seqs of the writes, the same order
  const int* start;   // [C] where each slot's writes begin
  const int* endp;    // [NE, C] one past the last write to the slot at or
                      // before the chunk
  const int *own, *cnt, *lo, *ug, *perm;  // [NE, C]; perm: owner-sorted
  int ne, wa, c;
};

constexpr int FUSED_THREADS = 256;

template <typename K>
__global__ void __launch_bounds__(FUSED_THREADS)
pergroup_fused_kernel(FusedArgs a, OpList ops) {
  using Acc = K;  // int32 sums wrap; float32 sums stay float32
  extern __shared__ __align__(16) unsigned char dyn[];
  const int C = a.c, WA = a.wa;
  int* s_own = reinterpret_cast<int*>(dyn);          // [C]
  int* s_perm = s_own + C;                           // [C]
  int* s_so = s_perm + C;                            // [C] sorted owners
  int* s_pc = s_so + C;                              // [C]
  Acc* s_psum = reinterpret_cast<Acc*>(s_pc + C);    // [C]
  K* s_pmin = reinterpret_cast<K*>(s_psum + C);      // [C]
  K* s_pmax = s_pmin + C;                            // [C]
  const K* wk = static_cast<const K*>(a.wk);
  const int tid = threadIdx.x, nt = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, nwarps = nt >> 5;
  const K hi = key_max<K>(), lo_sent = key_min<K>();
  const long long ec = static_cast<long long>(blockIdx.x) * C;

  for (int s = tid; s < C; s += nt) {
    s_own[s] = a.own[ec + s];
    s_perm[s] = a.perm[ec + s];
  }
  __syncthreads();
  for (int p = tid; p < C; p += nt) s_so[p] = s_own[s_perm[p]];
  // per-slot partials of the live lanes, one warp a slot: the slot's last
  // min(cnt, writes) writes (a carried-in pane's earlier lanes are the
  // ring's zeros, seq 0); four loads a lane in flight at once
  for (int s = warp; s < C; s += nwarps) {
    const bool occ = s_own[s] != PAD_GROUP;
    const int cs = occ ? min(a.cnt[ec + s], WA) : 0;
    const int los = a.lo[ec + s];
    const int end = a.endp[ec + s];
    const int nw = min(cs, end - a.start[s]);
    const int p0 = end - nw;
    int pc = 0;
    Acc ps = Acc(0);
    K pmin = hi, pmax = lo_sent;
    for (int l0 = 0; l0 < nw; l0 += 128) {
      int sq[4];
      K kv[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int l = l0 + q * 32 + lane;
        sq[q] = l < nw ? a.wq[p0 + l] : 0;
        kv[q] = l < nw ? wk[p0 + l] : K(0);
      }
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        if (l0 + q * 32 + lane < nw && sq[q] >= los) {
          ++pc;
          ps = add_wrap(ps, kv[q]);
          pmin = kv[q] < pmin ? kv[q] : pmin;
          pmax = pmax < kv[q] ? kv[q] : pmax;
        }
      }
    }
    if (lane == 0 && cs > nw && los <= 0) {
      pc += cs - nw;
      pmin = K(0) < pmin ? K(0) : pmin;
      pmax = pmax < K(0) ? K(0) : pmax;
    }
#pragma unroll
    for (int d = 16; d > 0; d >>= 1) {
      pc += __shfl_xor_sync(FULL_MASK, pc, d);
      ps = add_wrap(ps, __shfl_xor_sync(FULL_MASK, ps, d));
      const K omin = __shfl_xor_sync(FULL_MASK, pmin, d);
      const K omax = __shfl_xor_sync(FULL_MASK, pmax, d);
      pmin = omin < pmin ? omin : pmin;
      pmax = pmax < omax ? omax : pmax;
    }
    if (lane == 0) {
      s_pc[s] = pc;
      s_psum[s] = ps;
      s_pmin[s] = pmin;
      s_pmax[s] = pmax;
    }
  }
  __syncthreads();
  // every output row: its group's slots (a run of the owner-sorted slots)
  for (int r = tid; r < C; r += nt) {
    const int u = a.ug[ec + r];
    int cnt = 0;
    Acc sum = Acc(0);
    K vmin = hi, vmax = lo_sent;
    if (u != PAD_GROUP) {
      int lo = 0, hi_p = C;  // the first sorted position with owner >= u
      while (lo < hi_p) {
        const int mid = (lo + hi_p) >> 1;
        if (s_so[mid] < u) lo = mid + 1; else hi_p = mid;
      }
      for (int p = lo; p < C && s_so[p] == u; ++p) {
        const int s = s_perm[p];
        cnt += s_pc[s];
        sum = add_wrap(sum, s_psum[s]);
        vmin = s_pmin[s] < vmin ? s_pmin[s] : vmin;
        vmax = vmax < s_pmax[s] ? s_pmax[s] : vmax;
      }
    }
    const long long at = ec + r;
    for (int o = 0; o < ops.n; ++o) {
      void* out = ops.out[o];
      switch (ops.code[o]) {
        case OP_COUNT: static_cast<int*>(out)[at] = cnt; break;
        case OP_SUM: static_cast<Acc*>(out)[at] = sum; break;
        case OP_MEAN:
          static_cast<float*>(out)[at] =
              static_cast<float>(sum) / static_cast<float>(cnt > 1 ? cnt : 1);
          break;
        case OP_MIN: static_cast<K*>(out)[at] = cnt > 0 ? vmin : K(0); break;
        case OP_MAX: static_cast<K*>(out)[at] = cnt > 0 ? vmax : K(0); break;
        default: break;
      }
    }
  }
}

// ------------------------------------------------------ merge-replay tails

// Where a replay warp's rows come from.
//   * Row form (pergroup_replay_pallas's own signature): rows of T lanes,
//     keys and liveness `live` [nrows, T] (nonzero = live), runs of R lanes
//     whose live lanes are ascending.
//   * Ring form: evaluation e's rows are its live groups r < num[e]; row
//     r's runs are the group's first min(nslots, T / R) slots in base
//     order, perm[e, offsets[e, r] + j], read straight from the scan's ring
//     snapshot keys/seqs [NE, C, R] with count/base [NE, C].  A lane is live
//     when it is filled (lane < count) and inside the group's window (seq
//     >= lo, lo = the newest slot's base + count - ws[e, r]): the mask
//     panestore.gather_runs builds.  A closed pane (count == R) is
//     key-sorted; the open one (count < R, the group's newest) is in
//     arrival order.
struct ReplayArgs {
  const void* keys;    // row form [nrows, T]; ring form [NE, C, R]
  const int* live;     // row form [nrows, T]
  const int* seqs;     // ring form [NE, C, R]
  const int *count, *base, *perm, *offsets, *nslots;  // [NE, C]
  const int* ws;       // [NE, C]; time form [NE, 2]: lo, hi
  const int* num;      // [NE]
  int* live_out;       // time form [NE, C]: each row's live lanes
  long long nrows;     // row form
  int c, T, R, vec;    // vec: 16-byte loads (R % 4 == 0, aligned rows)
};

// A replay warp's shared memory, in 4-byte words: two row buffers (pad32
// layout), the row's live-lane bitmap and each bitmap word's exclusive
// prefix count, and (ring form) each run's slot and count.
struct ReplayLayout {
  int row, words, runs;
  __host__ __device__ ReplayLayout(int T, int R, bool ring)
      : row(pad32(T)), words((T + 31) / 32), runs(ring ? T / R : 0) {}
  __host__ __device__ int size() const {
    return 2 * row + 2 * words + 2 * runs;
  }
};

template <typename K> __device__ __forceinline__ K from_bits(int b);
template <> __device__ __forceinline__ int from_bits<int>(int b) { return b; }
template <> __device__ __forceinline__ float from_bits<float>(int b) {
  return __int_as_float(b);
}

// One warp merges the sorted runs of `len` lanes of src[0, W) pairwise
// into dst (pad32 layouts): lane l writes outputs [l * per, (l + 1) * per),
// each stretch inside one pair found by a co-rank binary search, then
// merged serially.  Keys compare as K values by key_lt, so -0.0 and +0.0
// (equal) keep their bits, NaN goes last, and the co-ranks of float runs
// are well defined.
template <typename K>
__device__ __forceinline__ void warp_merge_round(const K* src, K* dst,
                                                 int len, int W) {
  const int per = (W + 31) >> 5;
  const int lane = threadIdx.x & 31;
  const int end = min((lane + 1) * per, W);
  for (int o = lane * per; o < end;) {
    const int a0 = o & ~(2 * len - 1), b0 = a0 + len;
    const int stop = min(end, a0 + 2 * len);
    const int d = o - a0;
    // co-rank: the first d outputs of the pair take A[0, i), B[0, d - i)
    int lo = d > len ? d - len : 0, hi = d < len ? d : len;
    while (lo < hi) {
      const int i = (lo + hi) >> 1;
      if (!key_lt(src[pad32(b0 + d - i - 1)], src[pad32(a0 + i)])) lo = i + 1;
      else hi = i;
    }
    int i = lo, j = d - lo;
    K x = i < len ? src[pad32(a0 + i)] : K(0);
    K y = j < len ? src[pad32(b0 + j)] : K(0);
    for (; o < stop; ++o) {
      const bool take_x = i < len && (j >= len || !key_lt(y, x));
      dst[pad32(o)] = take_x ? x : y;
      if (take_x) {
        if (++i < len) x = src[pad32(a0 + i)];
      } else {
        if (++j < len) y = src[pad32(b0 + j)];
      }
    }
  }
}

// Live lanes of the row before lane x: no lane at or past `limit` is live.
__device__ __forceinline__ int live_before(const unsigned* bits,
                                           const int* wpre, int x, int cnt,
                                           int limit) {
  if (x >= limit) return cnt;
  return wpre[x >> 5] + __popc(bits[x >> 5] & ((1u << (x & 31)) - 1u));
}

// One warp a replay row: blocks of blockDim.x / 32 warps; warp w of block
// (e, y) replays rows y * warps + w, stepping by gridDim.y * warps, of
// evaluation e (ring form) or of all rows (row form, e = 0).  A row: load
// its lanes (dead ones the fill) and its live-lane bitmap; move
// each closed run's live lanes to the run's front at their rank (a prefix
// count of the bitmap), sort each open run in shared memory; merge-path
// rounds over the runs that can hold live lanes; then min, max, lower
// median and distinct count off the sorted live prefix (count and sum
// come from the load).
// No barrier beyond the warp's own.  Rows at or past num[e] (ring form)
// are not written.
// Warps a replay block: each replays rows of its own, in its own stretch
// of shared memory (REPLAY_WARPS of them, or as many as fit; small blocks
// pack the SM's shared memory closely).  Shared memory, not registers,
// bounds the warps an SM holds, so the kernel may take the registers it
// needs (without the minimum of one block, ptxas held it to 40-48 and
// spilled).
constexpr int REPLAY_WARPS = 2;

template <typename K, bool RING, bool TIME>
__global__ void __launch_bounds__(REPLAY_WARPS * 32, 1)
pergroup_replay_kernel(ReplayArgs a, OpList ops) {
  static_assert(RING || !TIME, "the time form reads the ring");
  extern __shared__ __align__(16) unsigned char dyn[];
  // float keys sum in double, so the rounding a float32 sum of a long
  // window picks up in one order or another stays far below the plain
  // version's own; int32 keys sum with wrap-around
  using Acc =
      typename std::conditional<std::is_same<K, float>::value, double, K>::type;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  const int T = a.T, R = a.R, lr = __ffs(R) - 1;
  const ReplayLayout lay(T, R, RING);
  K* bufa = reinterpret_cast<K*>(dyn) + static_cast<size_t>(warp) * lay.size();
  K* bufb = bufa + lay.row;
  unsigned* bits = reinterpret_cast<unsigned*>(bufb + lay.row);
  int* wpre = reinterpret_cast<int*>(bits + lay.words);
  int* s_slot = wpre + lay.words;
  int* s_cnt = s_slot + lay.runs;
  const K sent = key_max<K>(), fill = key_fill<K>();
  const int* kb = static_cast<const int*>(a.keys);  // keys as 32-bit words
  const long long e = blockIdx.x, ec = e * a.c;
  const long long rows = RING ? a.num[e] : a.nrows;
  const long long step = static_cast<long long>(gridDim.y) * nwarps;

  for (long long r = static_cast<long long>(blockIdx.y) * nwarps + warp;
       r < rows; r += step) {
    const long long orow = RING ? ec + r : r;
    // the runs: ring form, the group's first nr slots; row form, all
    int nr = T >> lr, lo = 0, hi = 0;
    if (RING) {
      nr = min(a.nslots[orow], nr);
      const int off = a.offsets[orow];
      for (int j = lane; j < nr; j += 32) {
        const int sl = a.perm[ec + off + j], cs = a.count[ec + sl];
        s_slot[j] = sl;
        s_cnt[j] = cs;
        if (!TIME && j == nr - 1) lo = a.base[ec + sl] + cs - a.ws[orow];
      }
      if (TIME) {
        lo = a.ws[2 * e];
        hi = a.ws[2 * e + 1];
      } else {
        lo = __shfl_sync(FULL_MASK, lo, (nr - 1) & 31);
      }
      __syncwarp();
    }
    // a filled lane's seq (timestamp) inside the window
    auto in_window = [lo, hi](int q) { return q >= lo && (!TIME || q < hi); };
    const int loaded = nr * R;  // lanes read; the rest are dead

    // load: four lanes a thread a step (16-byte loads where the row
    // allows; a dead quad's keys are not read), the masked keys to bufa,
    // the live bits to the bitmap; the sum of the live keys (it needs no
    // order, so keys that do not order — NaN — leave it whole)
    int cnt = 0, last = -1;
    Acc sum = Acc(0);
#pragma unroll 8
    for (int i0 = 4 * lane; i0 - 4 * lane < loaded; i0 += 128) {
      unsigned qm = 0;
      if (i0 < loaded && a.vec) {
        // the quad lies in one run and inside the lanes read
        long long at;
        if (RING) {
          const int j = i0 >> lr, p0 = i0 & (R - 1), cs = s_cnt[j];
          at = (ec + s_slot[j]) * R + p0;
          const int4 q4 = __ldg(reinterpret_cast<const int4*>(a.seqs + at));
          qm = (p0 < cs && in_window(q4.x)) |
               (p0 + 1 < cs && in_window(q4.y)) << 1 |
               (p0 + 2 < cs && in_window(q4.z)) << 2 |
               (p0 + 3 < cs && in_window(q4.w)) << 3;
        } else {
          at = r * T + i0;
          const int4 l4 = __ldg(reinterpret_cast<const int4*>(a.live + at));
          qm = (l4.x != 0) | (l4.y != 0) << 1 | (l4.z != 0) << 2 |
               (l4.w != 0) << 3;
        }
        int4 k4 = make_int4(0, 0, 0, 0);
        if (qm) k4 = __ldg(reinterpret_cast<const int4*>(kb + at));
        bufa[pad32(i0)] = qm & 1 ? from_bits<K>(k4.x) : fill;
        bufa[pad32(i0 + 1)] = qm & 2 ? from_bits<K>(k4.y) : fill;
        bufa[pad32(i0 + 2)] = qm & 4 ? from_bits<K>(k4.z) : fill;
        bufa[pad32(i0 + 3)] = qm & 8 ? from_bits<K>(k4.w) : fill;
        if (qm & 1) sum = add_wrap(sum, static_cast<Acc>(from_bits<K>(k4.x)));
        if (qm & 2) sum = add_wrap(sum, static_cast<Acc>(from_bits<K>(k4.y)));
        if (qm & 4) sum = add_wrap(sum, static_cast<Acc>(from_bits<K>(k4.z)));
        if (qm & 8) sum = add_wrap(sum, static_cast<Acc>(from_bits<K>(k4.w)));
      } else if (i0 < loaded) {
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int i = i0 + u;
          bool live = false;
          int w = 0;
          if (i < loaded) {
            long long at;
            if (RING) {
              const int j = i >> lr, p = i & (R - 1);
              at = (ec + s_slot[j]) * R + p;
              live = p < s_cnt[j] && in_window(a.seqs[at]);
            } else {
              at = r * T + i;
              live = a.live[at] != 0;
            }
            if (live) {
              w = kb[at];
              sum = add_wrap(sum, static_cast<Acc>(from_bits<K>(w)));
            }
            bufa[pad32(i)] = live ? from_bits<K>(w) : fill;
          }
          qm |= static_cast<unsigned>(live) << u;
        }
      }
      cnt += __popc(qm);
      if (qm) last = i0 + 31 - __clz(qm);
      // eight threads' four bits make one bitmap word
      unsigned w = qm << (4 * (lane & 7));
      w |= __shfl_xor_sync(FULL_MASK, w, 1);
      w |= __shfl_xor_sync(FULL_MASK, w, 2);
      w |= __shfl_xor_sync(FULL_MASK, w, 4);
      if ((lane & 7) == 0 && i0 < loaded) bits[i0 >> 5] = w;
    }
#pragma unroll
    for (int d = 16; d > 0; d >>= 1) {
      cnt += __shfl_xor_sync(FULL_MASK, cnt, d);
      last = max(last, __shfl_xor_sync(FULL_MASK, last, d));
      sum = add_wrap(sum, __shfl_xor_sync(FULL_MASK, sum, d));
    }
    __syncwarp();

    int dc = 0;
    const K* fin = bufb;  // the merged row
    if (cnt > 0) {
      // the runs that can hold live lanes: W lanes, a power of two
      const int used = RING ? nr : (last >> lr) + 1;
      int W = R;
      while (W < used * R) W <<= 1;
      // each bitmap word's exclusive prefix count: a lane sums its stretch
      // of words, a warp scan, then the stretch again
      const int limit = min(loaded, W);
      const int nw = (limit + 31) >> 5, wper = (nw + 31) >> 5;
      const int w0 = min(lane * wper, nw), w1 = min(w0 + wper, nw);
      int tot = 0;
      for (int w = w0; w < w1; ++w) tot += __popc(bits[w]);
      int inc = tot;
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const int o = __shfl_up_sync(FULL_MASK, inc, d);
        if (lane >= d) inc += o;
      }
      for (int w = w0, p = inc - tot; w < w1; ++w) {
        wpre[w] = p;
        p += __popc(bits[w]);
      }
      __syncwarp();
      // closed runs: each live lane to its rank among the run's live
      // lanes, the rest of the run the fill; open runs as loaded
      for (int i = lane; i < W; i += 32) {
        const int j = i >> lr, rs = j << lr;
        if (RING && j < nr && s_cnt[j] < R) {
          bufb[pad32(i)] = bufa[pad32(i)];
          continue;
        }
        const int before = live_before(bits, wpre, rs, cnt, limit);
        const int in_run = live_before(bits, wpre, rs + R, cnt, limit) - before;
        if (i < limit && (bits[i >> 5] >> (i & 31)) & 1)
          bufb[pad32(rs + live_before(bits, wpre, i, cnt, limit) - before)] =
              bufa[pad32(i)];
        if (i - rs >= in_run) bufb[pad32(i)] = fill;
      }
      __syncwarp();
      // open runs (the group's open pane): a bitonic sort in place; the
      // dead lanes, the fill, end up last
      for (int j = 0; RING && j < nr; ++j) {
        if (s_cnt[j] >= R) continue;
        for (int kk = 2; kk <= R; kk <<= 1)
          for (int jj = kk >> 1; jj > 0; jj >>= 1) {
            for (int p = lane; p < R / 2; p += 32) {
              const int i = ((p & ~(jj - 1)) << 1) | (p & (jj - 1));
              const int rb = (j << lr) + i;
              K x = bufb[pad32(rb)], y = bufb[pad32(rb + jj)];
              if (kk == R || (i & kk) == 0 ? key_lt(y, x) : key_lt(x, y)) {
                bufb[pad32(rb)] = y;
                bufb[pad32(rb + jj)] = x;
              }
            }
            __syncwarp();
          }
      }
      // merge-path rounds, bufb and bufa in turn
      K* src = bufb;
      K* dst = bufa;
      for (int len = R; len < W; len <<= 1) {
        warp_merge_round<K>(src, dst, len, W);
        __syncwarp();
        K* t = src;
        src = dst;
        dst = t;
      }
      fin = src;
      // the order tails off the sorted live prefix fin[0, cnt)
      for (int i = lane; i < cnt; i += 32) {
        const K x = fin[pad32(i)];
        // lane 0 is held against the sentinel, as the plain version does
        dc += x != (i == 0 ? sent : fin[pad32(i - 1)]);
      }
#pragma unroll
      for (int d = 16; d > 0; d >>= 1)
        dc += __shfl_xor_sync(FULL_MASK, dc, d);
    }
    if (lane == 0) {
      if (TIME) a.live_out[orow] = cnt;
      for (int o = 0; o < ops.n; ++o) {
        void* out = ops.out[o];
        switch (ops.code[o]) {
          case OP_COUNT: static_cast<int*>(out)[orow] = cnt; break;
          case OP_SUM: static_cast<K*>(out)[orow] = static_cast<K>(sum); break;
          case OP_MEAN:  // float32(sum) / float32(max(count, 1))
            static_cast<float*>(out)[orow] =
                static_cast<float>(static_cast<K>(sum)) /
                static_cast<float>(cnt > 1 ? cnt : 1);
            break;
          case OP_MIN:
            static_cast<K*>(out)[orow] = cnt > 0 ? fin[pad32(0)] : K(0);
            break;
          case OP_MAX:
            static_cast<K*>(out)[orow] = cnt > 0 ? fin[pad32(cnt - 1)] : K(0);
            break;
          case OP_MEDIAN:  // the lower median
            static_cast<K*>(out)[orow] =
                cnt > 0 ? fin[pad32((cnt - 1) / 2)] : K(0);
            break;
          case OP_DC: static_cast<int*>(out)[orow] = dc; break;
          default: break;
        }
      }
    }
    __syncwarp();  // the row's buffers are reused by the next
  }
}

template <typename Kern>
cudaError_t opt_in_smem(Kern kern, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

bool ops_ok(const int* codes, int nops, bool partial_only) {
  if (nops < 1 || nops > MAX_OPS) return false;
  for (int i = 0; i < nops; ++i) {
    const int c = codes[i];
    const bool partial = c == OP_SUM || c == OP_COUNT || c == OP_MIN ||
                         c == OP_MAX || c == OP_MEAN;
    if (!(partial || (!partial_only && (c == OP_MEDIAN || c == OP_DC))))
      return false;
  }
  return true;
}

OpList make_ops(const int* codes, void* const* outs, int nops) {
  OpList ops;
  ops.n = nops;
  for (int i = 0; i < nops; ++i) {
    ops.code[i] = codes[i];
    ops.out[i] = outs[i];
  }
  return ops;
}

bool pow2(int x) { return x >= 1 && (x & (x - 1)) == 0; }

// Shared memory of the scan: six [C] slot columns, the free-slot bitmap
// and the staged tuples;
// with a ring, two more [C] columns, staged keys and `nbuf` sort buffers of
// WA (key, seq) pairs (as many as fit, at most one a warp); the group
// tables when they hold at most GROUP_SMEM_MAX groups and fit beside the
// rest.  Returns 0 when even one sort buffer does not fit.
size_t scan_smem(int c, int wa, int ng, bool ring, int* gsmem, int* nbuf) {
  const size_t staged = SCAN_WINDOWS * SCAN_STAGE;
  size_t base = 4 * (6 * static_cast<size_t>(c) + (c + 31) / 32 + staged);
  if (ring) base += 4 * (2 * static_cast<size_t>(c) + staged);
  const size_t per = ring ? static_cast<size_t>(wa) * 8 : 0;
  const size_t groups = 12 * static_cast<size_t>(ng);
  *gsmem = ng <= GROUP_SMEM_MAX && base + groups + per <= SMEM_BUDGET;
  if (*gsmem) base += groups;
  *nbuf = 0;
  if (!ring) return base;
  if (base + per > SMEM_BUDGET) return 0;
  size_t nb = (SMEM_BUDGET - base) / per;
  nb = nb > SCAN_RING_THREADS / 32 ? SCAN_RING_THREADS / 32 : nb;
  *nbuf = static_cast<int>(nb);
  return base + per * nb;
}

template <typename K, bool RING, bool GS, bool SNAP>
cudaError_t launch_scan_kernel(const ScanArgs& a, size_t smem,
                               cudaStream_t st) {
  auto kern = pergroup_scan_kernel<K, RING, GS, SNAP>;
  cudaError_t err = opt_in_smem(kern, smem);
  if (err != cudaSuccess) return err;
  kern<<<1, RING ? SCAN_RING_THREADS : 32, smem, st>>>(a);
  return cudaGetLastError();
}

template <typename K, bool RING, bool GS>
cudaError_t launch_scan_snap(const ScanArgs& a, size_t smem,
                             cudaStream_t st) {
  return a.snaps ? launch_scan_kernel<K, RING, GS, true>(a, smem, st)
                 : launch_scan_kernel<K, RING, GS, false>(a, smem, st);
}

template <typename K, bool RING>
cudaError_t launch_scan(const ScanArgs& a, size_t smem, cudaStream_t st) {
  return a.gsmem ? launch_scan_snap<K, RING, true>(a, smem, st)
                 : launch_scan_snap<K, RING, false>(a, smem, st);
}

// Shared memory of the fused kernel: seven [C] columns.
size_t fused_smem(int c) { return static_cast<size_t>(c) * 28; }

template <typename K>
cudaError_t launch_fused(const FusedArgs& a, const OpList& ops,
                         cudaStream_t st) {
  const size_t smem = fused_smem(a.c);
  cudaError_t err = opt_in_smem(pergroup_fused_kernel<K>, smem);
  if (err != cudaSuccess) return err;
  pergroup_fused_kernel<K><<<a.ne, FUSED_THREADS, smem, st>>>(a, ops);
  return cudaGetLastError();
}

// Warps in flight the replay grid aims at: 132 SMs, about 12 warps each,
// four times over.
constexpr int REPLAY_TARGET_WARPS = 132 * 12 * 4;

template <typename K, bool RING, bool TIME>
cudaError_t launch_replay_kernel(const ReplayArgs& a, const OpList& ops,
                                 int ne, long long rows_per_e,
                                 cudaStream_t st) {
  const size_t per_warp =
      4 * static_cast<size_t>(ReplayLayout(a.T, a.R, RING).size());
  long long warps = SMEM_BUDGET / per_warp;
  if (warps < 1) return cudaErrorInvalidValue;  // a row past shared memory
  warps = warps < REPLAY_WARPS ? warps : REPLAY_WARPS;
  // blocks an evaluation: enough warps in all, at most one a row
  long long nblk = (REPLAY_TARGET_WARPS + ne * warps - 1) / (ne * warps);
  const long long most = (rows_per_e + warps - 1) / warps;
  nblk = nblk < most ? nblk : most;
  nblk = nblk < 1 ? 1 : (nblk < 65535 ? nblk : 65535);
  auto kern = pergroup_replay_kernel<K, RING, TIME>;
  cudaError_t err = opt_in_smem(kern, warps * per_warp);
  if (err != cudaSuccess) return err;
  // as much of the SM's 256 KiB for shared memory as it gives, so as many
  // warps as fit are in flight
  err = cudaFuncSetAttribute(kern, cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return err;
  kern<<<dim3(ne, static_cast<unsigned>(nblk)), static_cast<int>(warps) * 32,
         warps * per_warp, st>>>(a, ops);
  return cudaGetLastError();
}

template <bool RING, bool TIME>
cudaError_t launch_replay(const ReplayArgs& a, int key_type,
                          const OpList& ops, int ne, long long rows_per_e,
                          cudaStream_t st) {
  if (key_type == KEY_INT32)
    return launch_replay_kernel<int, RING, TIME>(a, ops, ne, rows_per_e, st);
  if (key_type == KEY_FLOAT32)
    return launch_replay_kernel<float, RING, TIME>(a, ops, ne, rows_per_e,
                                                   st);
  return cudaErrorInvalidValue;
}

// Shared memory of the time-mode placement: the four [C] directory
// columns, and for WA > 32 one sort buffer of WA (key, timestamp, lane)
// triples (panes of up to 32 lanes sort in registers); its index, bitmaps
// and list (time_aux_bytes) join them when they fit, else lie in device
// memory the caller gives.
size_t time_scan_smem(int c, int wa) {
  return 16 * static_cast<size_t>(c) +
         (wa > 32 ? 12 * static_cast<size_t>(wa) : 0);
}

// Entries of the time-mode placement's index: at least twice the slots.
int time_index_size(int c) {
  int h = 1;
  while (h < 2 * c) h <<= 1;
  return h;
}

template <typename K>
cudaError_t launch_scan_time(const TimeScanArgs& a, cudaStream_t st) {
  const size_t smem = time_scan_smem(a.c, a.wa) +
                      (a.aux ? 0 : time_aux_bytes(a.c, a.hsize));
  auto kern = pergroup_scan_time_kernel<K>;
  cudaError_t err = opt_in_smem(kern, smem);
  if (err != cudaSuccess) return err;
  kern<<<1, TIME_THREADS, smem, st>>>(a);
  return cudaGetLastError();
}

}  // namespace
}  // namespace rt

// The placement scan over n tuples in ne = ceil(n / wa) chunks of wa (one
// warp).  g holds each
// tuple's dense group index in [0, ng), gid the group id of each index;
// k may be null (no ring: ring_k, ring_s, rk_s and rs_s are then unused).
// slots0 [5, C]: each slot's owner (dense index, -1 free), count, base,
// stamp and the next pane of its group in base order (-1 at the chain's
// end); gtab [3, ng] each group's newest and oldest pane (-1: none) and
// window size, scratch the kernel may update.  dir [4, C] (owner id,
// count, base, stamp) gets the store after the scan; clock [1] is read and
// written back; ring_k/ring_s [C, wa] are read and written in place.  A
// batch scan (wa divides n): plan [3, ne, wa] gets each tuple's slot, lane
// and seq, snaps [4, ne, C] and clock_s [ne] the directory after every
// chunk, and rk_s/rs_s [ne, C, wa] the ring after every chunk.  A
// streaming push passes plan and snaps null: the last chunk may be short
// and only the store after the last tuple is kept.  events [2] gets the
// evictions and retirements; stats [2] the batches and the batches that
// committed all their tuples at once.
extern "C" int rt_pergroup_scan(const int* g, const void* k, int key_type,
                                int n, int wa, int c, int ng,
                                const int* gid, const int* slots0, int* gtab,
                                int* dir, int* clock, void* ring_k,
                                int* ring_s, int* plan, int* snaps,
                                int* clock_s, void* rk_s, int* rs_s,
                                int* events, int* stats, void* stream) {
  using namespace rt;
  int gsmem = 0, nbuf = 0;
  const bool ring = k != nullptr;
  if (n < 1 || !pow2(wa) || wa > MAX_ROW || c < 1 || c > MAX_SCAN_SLOTS ||
      ng < 1 || (plan == nullptr) != (snaps == nullptr) ||
      (plan != nullptr && n % wa != 0))
    return cudaErrorInvalidValue;
  const int ne = static_cast<int>((static_cast<long long>(n) + wa - 1) / wa);
  const size_t smem = scan_smem(c, wa, ng, ring, &gsmem, &nbuf);
  if (smem == 0) return cudaErrorInvalidValue;
  ScanArgs a{g, k, n, ne, wa, c, ng, gid, slots0, gtab, gsmem, nbuf, dir,
             clock, ring_k, ring_s, plan, snaps, clock_s, rk_s, rs_s, events,
             stats};
  auto st = static_cast<cudaStream_t>(stream);
  if (!ring) return launch_scan<int, false>(a, smem, st);
  if (key_type == KEY_INT32) return launch_scan<int, true>(a, smem, st);
  if (key_type == KEY_FLOAT32) return launch_scan<float, true>(a, smem, st);
  return cudaErrorInvalidValue;
}

// Per-slot partials and their per-row combination over ne chunks (one
// block a chunk).  wk/wq: the keys and seqs of the ne*wa writes grouped by
// slot, in stream order within a slot; start [C] where each slot's writes
// begin; endp [ne, C] one past the slot's last write at or before the
// chunk; own, cnt, lo, ug [ne, C] the plan's directory; perm [ne, C] each
// chunk's slots sorted by owner (stable).  codes/outs: ops among sum,
// count, min, max, mean, each output [ne, C].
extern "C" int rt_pergroup_fused(const void* wk, const int* wq,
                                 const int* start, const int* endp,
                                 const int* own, const int* cnt, const int* lo,
                                 const int* ug, const int* perm, int key_type,
                                 int ne, int wa, int c, const int* codes,
                                 void* const* outs, int nops, void* stream) {
  using namespace rt;
  if (ne < 1 || !pow2(wa) || wa > MAX_ROW || c < 1 || !ops_ok(codes, nops, true) ||
      static_cast<long long>(ne) * wa > 0x7fffffffLL ||
      fused_smem(c) > SMEM_BUDGET)
    return cudaErrorInvalidValue;
  FusedArgs a{wk, wq, start, endp, own, cnt, lo, ug, perm, ne, wa, c};
  const OpList ops = make_ops(codes, outs, nops);
  auto st = static_cast<cudaStream_t>(stream);
  if (key_type == KEY_INT32) return launch_fused<int>(a, ops, st);
  if (key_type == KEY_FLOAT32) return launch_fused<float>(a, ops, st);
  return cudaErrorInvalidValue;
}

// The replay tails over nrows rows of T lanes (row form, one block a row):
// keys rk, liveness rv (int32, nonzero = live), each row T / run runs of
// `run` lanes whose live lanes are ascending.  codes/outs: DIRECT ops (sum,
// count, min, max, mean, median, distinct count), each output [nrows].
extern "C" int rt_pergroup_replay(const void* rk, const int* rv, int key_type,
                                  int nrows, int T, int run, const int* codes,
                                  void* const* outs, int nops, void* stream) {
  using namespace rt;
  if (nrows < 1 || !pow2(T) || T < 2 || T > MAX_ROW || !pow2(run) ||
      run > T || !ops_ok(codes, nops, false))
    return cudaErrorInvalidValue;
  ReplayArgs a{};
  a.keys = rk;
  a.live = rv;
  a.nrows = nrows;
  a.T = T;
  a.R = run;
  a.vec = T % 4 == 0 && aligned16(rk) && aligned16(rv);
  return launch_replay<false, false>(a, key_type,
                                     make_ops(codes, outs, nops), 1, nrows,
                                     static_cast<cudaStream_t>(stream));
}

// The replay tails straight from the placement scan's ring snapshots (ring
// form): keys/seqs [ne, c, wa] and count/base [ne, c] the store after every
// chunk; perm/offsets/nslots [ne, c] and num [ne] its slot directory (the
// slots sorted by (owner, base), each live group's first position in perm
// and slot count, the live groups); ws [ne, c] each live group's window.
// Row r < num[e] of evaluation e replays the group's first min(nslots,
// runs) slots; outputs [ne, c], rows at or past num[e] not written.  The
// time form (time_win, a time-mode store): ws [ne, 2] is each
// evaluation's [lo, hi), a lane live iff filled and lo <= seq < hi, and
// live_out [ne, c] gets each row's live lanes.
extern "C" int rt_pergroup_replay_ring(
    const void* keys, const int* seqs, const int* count, const int* base,
    const int* perm, const int* offsets, const int* nslots, const int* num,
    const int* ws, int* live_out, int key_type, int ne, int c, int wa,
    int runs, int time_win, const int* codes, void* const* outs, int nops,
    void* stream) {
  using namespace rt;
  if (ne < 1 || c < 1 || !pow2(wa) || !pow2(runs) ||
      static_cast<long long>(runs) * wa > MAX_ROW ||
      !ops_ok(codes, nops, false) || (time_win && live_out == nullptr))
    return cudaErrorInvalidValue;
  ReplayArgs a{};
  a.keys = keys;
  a.seqs = seqs;
  a.count = count;
  a.base = base;
  a.perm = perm;
  a.offsets = offsets;
  a.nslots = nslots;
  a.ws = ws;
  a.num = num;
  a.live_out = live_out;
  a.c = c;
  a.T = runs * wa;
  a.R = wa;
  a.vec = wa % 4 == 0 && aligned16(keys) && aligned16(seqs);
  const OpList ops = make_ops(codes, outs, nops);
  auto st = static_cast<cudaStream_t>(stream);
  if (time_win) return launch_replay<true, true>(a, key_type, ops, ne, c, st);
  return launch_replay<true, false>(a, key_type, ops, ne, c, st);
}

// The time-mode placement of n timestamped tuples (g, k, ts; the lanes
// `live` marks) into a store of c slots of wa lanes, time panes of `slide`:
// owner/count/base/stamp [c] and clock [1] the directory, ring_k/ring_s
// [c, wa] the keys and timestamps, all read and written in place; panes
// wholly below *retire_below (TS_FLOOR when null) retire.  events [2] gets
// the evictions and retirements.  aux: device memory of
// time_aux_bytes(c, time_index_size(c)) bytes for the index and bitmaps,
// needed only when they do not fit shared memory beside the directory
// (else null).  One block: one warp places, seven help.
extern "C" int rt_pergroup_scan_time(
    const int* g, const void* k, const int* ts, const bool* live, int n,
    const int* retire_below, int key_type, int wa, int c, int slide,
    int* owner, int* count, int* base, int* stamp, int* clock, void* ring_k,
    int* ring_s, int* events, void* aux, void* stream) {
  using namespace rt;
  const int hsize = c >= 1 && c <= (1 << 28) ? time_index_size(c) : 0;
  if (n < 0 || !pow2(wa) || c < 1 || hsize == 0 || slide < 1 ||
      time_scan_smem(c, wa) > SMEM_BUDGET ||
      (aux == nullptr &&
       time_scan_smem(c, wa) + time_aux_bytes(c, hsize) > SMEM_BUDGET))
    return cudaErrorInvalidValue;
  TimeScanArgs a{g, k, ts, live, n, retire_below, wa, c, slide, owner, count,
                 base, stamp, clock, ring_k, ring_s, events, hsize, aux};
  auto st = static_cast<cudaStream_t>(stream);
  if (key_type == KEY_INT32) return launch_scan_time<int>(a, st);
  if (key_type == KEY_FLOAT32) return launch_scan_time<float>(a, st);
  return cudaErrorInvalidValue;
}
