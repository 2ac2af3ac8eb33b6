// The bounded-lateness reorder buffer of an event-time stream.
//
// No TPU kernel stands behind it: it replaces the JAX package's lax.scan
// of _reorder_cycle and the _reorder_drain after it
// (src/repro/core/eventtime.py).  A push is sequential: every cycle takes
// one tuple in and releases at most one, and what it releases depends on
// the buffer the cycles before it left.  So one warp runs the push, and the
// design keeps a cycle's chain of dependent steps short:
//   * the buffer's slots (ts, group, key, arrival seq) sit in shared
//     memory, its occupancy in registers (a word a lane); the held entries
//     are kept in their release order, (ts, seq, slot), in registers: S =
//     max(1, C / 32) consecutive ranks a lane (a template on S), built at
//     launch by counting each entry's rank;
//   * so the least is rank 0, a broadcast; a cycle that releases it and
//     takes a tuple in moves the ranks between the two by one (a shuffle
//     and S predicated moves a lane), the new tuple's rank being a count
//     of the entries before it (one warp sum);
//   * the slot a cycle releases is the JAX package's argmin: the least, or
//     slot 0 when no slot at the least ts has a seq below INT32_MAX; an
//     insert takes the first free slot, argmax(~occ), by a ballot over the
//     occupancy words, found after each insert for the next;
//   * the tuples come in 32 at a time, one a lane, the next 32 loaded while
//     these cycle; cycle j's emission (ts, group, key, live, late) is kept
//     by lane j, and the 32 are stored at once after the last;
//   * after the last tuple, the drain: the held entries the gate has
//     passed are a prefix of the order, written in it as the [capacity]
//     tail of the emissions (the drain lanes past them dead, zero).
// Keys ride as 32-bit words and are never compared.  A flush is the same
// launch with no tuple and every held slot drained.  With stats on (a
// template flag), each cycle also counts a pop that a full buffer forced
// past the release gate and raises the depth high-water mark to the held
// entries after it, as the JAX package's counters do.
//
// A sharded event-time stream (JAX: a vmap of the scan over the shards,
// src/repro/distributed/query_exec.py, stream_push_eventtime_sharded)
// stacks S buffers, [S, C] slots and [S] scalars, and runs them in one
// launch of S one-warp blocks: block s reads buffer s, row s of the [S, L]
// tuples with its own live count, clip(nvalid - s L, 0, L), and writes row
// s of the [S, L + C] emissions.  Its release and late gates are the
// previous push's merged watermark and its drain gate this push's, 0-d
// values on the card.  A template flag (STACK) selects this form: without
// it the launch is the one-buffer kernel, one block under its local
// watermark, with no shard offset or external gate to compute.  The
// counters take every block's pops by an atomic add (wrapping, as
// add_wrap) and its depth by an atomic max, the JAX package's sum and max
// over the shards.  Bound: the latency of one
// warp, a few shuffles, one warp sum and a ballot a tuple; bytes (about 30
// a tuple) leave the card's memory idle.
#include <type_traits>

#include "tile.cuh"

namespace rt {
namespace {

constexpr int RO_TS_MIN = -(1 << 30);
constexpr int RO_I32_MAX = 0x7fffffff;
constexpr int MAX_REORDER = 1024;

// Reorder buffers: [S, C] slots and [S] scalars (S = 1: one buffer).
struct ReorderBuf {
  int *ts, *grp, *val, *seq;  // [S, C] (val: keys as 32-bit words)
  bool* occ;                  // [S, C]
  int *max_ts, *last_emit, *seq_clock, *dropped;  // [S]
};

struct ReorderArgs {
  const int* ts;          // [S, n] (null when n == 0)
  const int* g;           // [S, n]
  const int* k;           // [S, n] keys as 32-bit words
  int n;                  // tuples a shard
  int nvalid;             // live lanes of the [S n] when nvalid_dev is null
  const int* nvalid_dev;  // [] or null
  const int* drain;       // [] drain gate, or null: the watermark
  const int* release;     // [] release gate, or null: the watermark
  const int* late;        // [] lateness floor, or null: the watermark
  int drain_all;          // 1: drain every held slot (a flush)
  ReorderBuf in, out;  // the buffers read, and written (the same: in place)
  int c, lateness;
  int *o_ts, *o_g, *o_k;  // [S, n + C] emissions
  bool *o_live, *o_late;  // [S, n + C]
  int* c_forced;          // [] stats on: forced pops added (wrapping)
  int* c_depth;           // [] stats on: raised to the held entries after
                          // any cycle of any buffer
};

// An entry of the buffer's order: (ts, arrival seq, slot).  Each lane holds
// S consecutive ranks of it in registers; the ranks past the held entries
// are empty, (INT32_MAX, INT32_MAX, INT32_MAX), after every entry.
struct Entry {
  int t, q, s;
};

__device__ __forceinline__ Entry empty_entry() {
  return Entry{RO_I32_MAX, RO_I32_MAX, RO_I32_MAX};
}

// (ts, seq) lexicographic, then the slot: does a come first?  (Bitwise,
// so it stays predicate logic, never a branch.)
__device__ __forceinline__ bool before(int t, int sq, int s, int t2, int sq2,
                                       int s2) {
  return (t < t2) | ((t == t2) & ((sq < sq2) | ((sq == sq2) & (s < s2))));
}
__device__ __forceinline__ bool before(const Entry& a, const Entry& b) {
  return before(a.t, a.q, a.s, b.t, b.q, b.s);
}

__device__ __forceinline__ Entry shfl_entry(const Entry& e, int src) {
  return Entry{__shfl_sync(FULL_MASK, e.t, src),
               __shfl_sync(FULL_MASK, e.q, src),
               __shfl_sync(FULL_MASK, e.s, src)};
}

// The entry of the next lane (empty past the last lane), and of the
// previous one.
__device__ __forceinline__ Entry next_lane(const Entry& e) {
  Entry x{__shfl_down_sync(FULL_MASK, e.t, 1),
          __shfl_down_sync(FULL_MASK, e.q, 1),
          __shfl_down_sync(FULL_MASK, e.s, 1)};
  return threadIdx.x == 31 ? empty_entry() : x;
}
__device__ __forceinline__ Entry prev_lane(const Entry& e) {
  return Entry{__shfl_up_sync(FULL_MASK, e.t, 1),
               __shfl_up_sync(FULL_MASK, e.q, 1),
               __shfl_up_sync(FULL_MASK, e.s, 1)};
}

// Entries that come before x, over the warp.
template <int S>
__device__ __forceinline__ int count_before(const Entry (&e)[S],
                                            const Entry& x) {
  int c = 0;
#pragma unroll
  for (int q = 0; q < S; ++q) c += before(e[q], x);
  return __reduce_add_sync(FULL_MASK, c);
}

// Rank d taken out, then x put at rank p (of the order without d); d < 0:
// nothing taken out, p < 0: nothing put in.  Predicated moves:
// ranks between the two shift by one, across a lane by a shuffle.
template <int S>
__device__ __forceinline__ void take_put(Entry (&e)[S], int d, int p,
                                         const Entry& x) {
  const int r0 = threadIdx.x * S;
  if (d >= 0) {
    if (p == d) {  // x takes d's place (the common release and insert)
#pragma unroll
      for (int q = 0; q < S; ++q) e[q] = r0 + q == d ? x : e[q];
      return;
    }
    if (p > d) {  // ranks (d, p] move down one, x at p
      const Entry nx = next_lane(e[0]);
#pragma unroll
      for (int q = 0; q < S; ++q) {
        const int r = r0 + q;
        const Entry up = q + 1 < S ? e[q + 1] : nx;
        e[q] = (r < d) | (r > p) ? e[q] : (r == p ? x : up);
      }
      return;
    }
    if (p < 0) {  // ranks past d move down one
      const Entry nx = next_lane(e[0]);
#pragma unroll
      for (int q = 0; q < S; ++q) {
        const Entry up = q + 1 < S ? e[q + 1] : nx;
        e[q] = r0 + q < d ? e[q] : up;
      }
      return;
    }
  }
  // x at p, ranks [p, d) (all past p when nothing left) move up one
  const int end = d >= 0 ? d : 0x7fffffff;
  const Entry pv = prev_lane(e[S - 1]);
#pragma unroll
  for (int q = S - 1; q >= 0; --q) {
    const int r = r0 + q;
    const Entry dn = q > 0 ? e[q - 1] : pv;
    e[q] = (r < p) | (r > end) ? e[q] : (r == p ? x : dn);
  }
}

// The first free slot (argmax(~occ)) from the lanes' occupancy words, C
// if none.
__device__ __forceinline__ int first_free(unsigned occw, unsigned wmask,
                                          int C) {
  const unsigned fm = ~occw & wmask;
  const unsigned fb = __ballot_sync(FULL_MASK, fm != 0);
  const int fl = fb ? __ffs(fb) - 1 : 0;
  const unsigned fw = __shfl_sync(FULL_MASK, fm, fl);
  return fb ? fl * 32 + __ffs(fw) - 1 : C;
}

template <int S, bool CNT, bool STACK>
__global__ void __launch_bounds__(32, 1) reorder_kernel(ReorderArgs a) {
  extern __shared__ __align__(16) int sm[];
  const int C = a.c, lane = threadIdx.x, n = a.n, nw = (C + 31) / 32;
  // this block's buffer, tuples and emissions: shard b of the stack (one
  // buffer: offsets 0, and int indexing as ever)
  using Off = typename std::conditional<STACK, size_t, int>::type;
  const int b = STACK ? blockIdx.x : 0;
  const Off bs = static_cast<Off>(b) * C;
  const Off bi = static_cast<Off>(b) * n;
  const Off be = static_cast<Off>(b) * (n + C);
  int* sts = sm;  // [C] the buffer by slot
  int* sseq = sts + C;
  int* grp = sseq + C;
  int* val = grp + C;
  int* occ = val + C;
  int* at_rank = occ + C;  // [C] the slot at each rank (the launch's build)

  for (int s = lane; s < C; s += 32) {
    sts[s] = a.in.ts[bs + s];
    sseq[s] = a.in.seq[bs + s];
    grp[s] = a.in.grp[bs + s];
    val[s] = a.in.val[bs + s];
    occ[s] = a.in.occ[bs + s] ? 1 : 0;
  }
  __syncwarp();
  // occupancy: lane w holds the bits of slots [32w, 32w + 32)
  unsigned occw = 0;
  for (int w = 0; w < nw; ++w) {
    const unsigned b = __ballot_sync(FULL_MASK, w * 32 + lane < C &&
                                                    occ[w * 32 + lane]);
    if (lane == w) occw = b;
  }
  const unsigned wmask =
      lane >= nw ? 0u
                 : (lane == nw - 1 && (C & 31) ? (1u << (C & 31)) - 1
                                               : FULL_MASK);
  int held = __reduce_add_sync(FULL_MASK, __popc(occw));
  // the order of the held slots: each one's rank, by counting
  for (int s = lane; s < C; s += 32) {
    if (!occ[s]) continue;
    const int t = sts[s], sq = sseq[s];
    int r = 0;
    for (int f = 0; f < C; ++f)
      r += occ[f] && before(sts[f], sseq[f], f, t, sq, s);
    at_rank[r] = s;
  }
  __syncwarp();
  Entry e[S];
#pragma unroll
  for (int q = 0; q < S; ++q) {
    const int r = lane * S + q;
    const int s = r < held ? at_rank[r] : 0;
    e[q] = r < held ? Entry{sts[s], sseq[s], s} : empty_entry();
  }
  Entry m0 = shfl_entry(e[0], 0);  // the least
  int ffree = first_free(occw, wmask, C);
  int max_ts = a.in.max_ts[b], last_emit = a.in.last_emit[b];
  int seq_clock = a.in.seq_clock[b], dropped = a.in.dropped[b];
  // the live tuples: the first nvalid, for shard b of a stack
  // clip(nvalid - b n, 0, n)
  const int nv_all = a.nvalid_dev ? *a.nvalid_dev : a.nvalid;
  const int nv = STACK ? static_cast<int>(min(
      max(static_cast<long long>(nv_all) - static_cast<long long>(b) * n,
          0LL), static_cast<long long>(n))) : nv_all;
  // STACK: the external release gate and lateness floor (each null: the
  // watermark)
  const int rel_g = STACK && a.release ? *a.release : 0;
  const int late_g = STACK && a.late ? *a.late : 0;
  int forced = 0, depth = -1;  // CNT

  int nt = 0, ng = 0, nk = 0;  // the next 32 tuples, one a lane
  if (lane < n) {
    nt = a.ts[bi + lane];
    ng = a.g[bi + lane];
    nk = a.k[bi + lane];
  }
  for (int i0 = 0; i0 < n; i0 += 32) {
    const int nb = n - i0 < 32 ? n - i0 : 32;
    const int my_t = nt, my_g = ng, my_k = nk;
    if (i0 + 32 + lane < n) {
      nt = a.ts[bi + i0 + 32 + lane];
      ng = a.g[bi + i0 + 32 + lane];
      nk = a.k[bi + i0 + 32 + lane];
    }
    int ot = 0, og = my_g, ok = my_k;  // this lane's cycle's emission
    bool olive = false, olate = false;
    for (int j = 0; j < nb; ++j) {
      const int t = __shfl_sync(FULL_MASK, my_t, j);
      const bool lv = i0 + j < nv;
      const int mx = max(max_ts, lv ? t : RO_TS_MIN);
      const int wm = sub_wrap(mx, a.lateness);  // the watermark
      const int rel = STACK && a.release ? rel_g : wm;  // the release gate
      const int floor_t = STACK && a.late ? late_g : wm;
      const bool late = lv && (t < floor_t || t < last_emit);
      const bool insert = lv && !late;
      const bool any_occ = held > 0, full = held == C;

      // the incoming tuple never wins a tie (its seq is the largest)
      const bool inc_min = insert && (t < m0.t || !any_occ);
      const bool pop_inc = inc_min && (t <= rel || full);
      const bool pop_buf =
          !pop_inc && any_occ && (m0.t <= rel || (full && insert));
      if (CNT) forced += (pop_inc && t > rel) || (pop_buf && m0.t > rel);
      int et = t, d = -1;  // d: the rank released from the buffer
      Entry gone = m0;
      if (pop_buf) {
        int pl = m0.s;
        et = m0.t;
        d = 0;
        if (m0.q == RO_I32_MAX) {
          // argmin's slot when every seq at the least ts is INT32_MAX: 0,
          // held or not
          pl = 0;
          et = sts[0];
          d = -1;
          if (__shfl_sync(FULL_MASK, occw, 0) & 1u) {
            int at = -1;
#pragma unroll
            for (int q = 0; q < S; ++q) at = e[q].s == 0 ? q : at;
            const unsigned b = __ballot_sync(FULL_MASK, at >= 0);
            const int fl = __ffs(b) - 1;
            d = fl * S + __shfl_sync(FULL_MASK, at, fl);
            gone = Entry{sts[0], sseq[0], 0};
          }
        }
        if (lane == j) {
          og = grp[pl];
          ok = val[pl];
        }
        if (d >= 0) {
          occw &= lane == pl >> 5 ? ~(1u << (pl & 31)) : FULL_MASK;
          --held;
          ffree = min(ffree, pl);
        }
      }
      const bool ev = pop_inc || pop_buf;
      ot = lane == j ? (ev ? et : 0) : ot;
      olive = lane == j ? ev : olive;
      olate = lane == j ? late : olate;
      if (insert && !pop_inc) {  // into the first free slot (one exists)
        const Entry x{t, seq_clock, ffree};
        const int p = count_before(e, x) - (d >= 0 && before(gone, x));
        take_put<S>(e, d, p, x);
        if (lane == j) {
          sts[x.s] = t;
          sseq[x.s] = seq_clock;
          grp[x.s] = my_g;
          val[x.s] = my_k;
        }
        occw |= lane == x.s >> 5 ? 1u << (x.s & 31) : 0u;
        ++held;
        seq_clock = add_wrap(seq_clock, 1);
        ffree = first_free(occw, wmask, C);
        if (d >= 0 || p == 0) m0 = shfl_entry(e[0], 0);
        __syncwarp();
      } else if (d >= 0) {
        take_put<S>(e, d, -1, gone);
        m0 = shfl_entry(e[0], 0);
      }
      if (ev) last_emit = max(last_emit, et);
      max_ts = mx;
      if (late) dropped = add_wrap(dropped, 1);
      if (CNT) depth = max(depth, held);
    }
    if (lane < nb) {
      a.o_ts[be + i0 + lane] = ot;
      a.o_g[be + i0 + lane] = og;
      a.o_k[be + i0 + lane] = ok;
      a.o_live[be + i0 + lane] = olive;
      a.o_late[be + i0 + lane] = olate;
    }
  }

  // the drain: the held entries the gate has passed, a prefix of the order
  // (ts first), out in that order; the other drain lanes dead
  const int gate = a.drain ? *a.drain : sub_wrap(max_ts, a.lateness);
  int num = 0;
#pragma unroll
  for (int q = 0; q < S; ++q)
    num += lane * S + q < held && (a.drain_all || e[q].t <= gate);
  num = __reduce_add_sync(FULL_MASK, num);
  for (int w = 0; w < nw; ++w) {
    const unsigned b = __shfl_sync(FULL_MASK, occw, w);
    if (w * 32 + lane < C) occ[w * 32 + lane] = (b >> lane) & 1;
  }
  __syncwarp();
  int last = last_emit;
#pragma unroll
  for (int q = 0; q < S; ++q) {
    const int r = lane * S + q;
    if (r < C) {
      const bool rel = r < num;
      a.o_ts[be + n + r] = rel ? e[q].t : 0;
      a.o_g[be + n + r] = rel ? grp[e[q].s] : 0;
      a.o_k[be + n + r] = rel ? val[e[q].s] : 0;
      a.o_live[be + n + r] = rel;
      a.o_late[be + n + r] = false;
      if (rel) occ[e[q].s] = 0;
      if (r == num - 1) last = e[q].t;
    }
  }
  __syncwarp();
  if (num > 0)
    last_emit = max(last_emit,
                    __shfl_sync(FULL_MASK, last, (num - 1) / S));
  for (int s = lane; s < C; s += 32) {
    a.out.ts[bs + s] = sts[s];
    a.out.seq[bs + s] = sseq[s];
    a.out.grp[bs + s] = grp[s];
    a.out.val[bs + s] = val[s];
    a.out.occ[bs + s] = occ[s] != 0;
  }
  if (lane == 0) {
    a.out.max_ts[b] = max_ts;
    a.out.last_emit[b] = last_emit;
    a.out.seq_clock[b] = seq_clock;
    a.out.dropped[b] = dropped;
    if (CNT && STACK) {  // every block's: the sum (two's complement
      atomicAdd(a.c_forced, forced);  // wraps, as add_wrap) and the max
      atomicMax(a.c_depth, depth);
    } else if (CNT) {
      *a.c_forced = add_wrap(*a.c_forced, forced);
      *a.c_depth = max(*a.c_depth, depth);
    }
  }
}

template <int S, bool CNT>
cudaError_t launch_reorder(const ReorderArgs& a, int shards,
                           cudaStream_t st) {
  const size_t smem = 6 * sizeof(int) * static_cast<size_t>(a.c);
  if (shards > 1 || a.release || a.late)
    reorder_kernel<S, CNT, true><<<shards, 32, smem, st>>>(a);
  else
    reorder_kernel<S, CNT, false><<<1, 32, smem, st>>>(a);
  return cudaGetLastError();
}

template <int S>
cudaError_t launch_reorder(const ReorderArgs& a, int shards,
                           cudaStream_t st) {
  return a.c_forced ? launch_reorder<S, true>(a, shards, st)
                    : launch_reorder<S, false>(a, shards, st);
}

}  // namespace
}  // namespace rt

// One push through `shards` stacked reorder buffers of c slots each (a
// power of two, at most 1024) with lateness contract `lateness`, one
// one-warp block a buffer: buffer s takes n tuples, row s of the [shards,
// n] ts, g, k (live: the first clip(nvalid - s n, 0, n), nvalid the host's
// or *nvalid_dev when given), a cycle a tuple, then the drain of every
// slot at or below the gate (drain, else its watermark after the push;
// every held slot when drain_all).  release and late (each null: the
// buffer's watermark) are the release gate and the lateness floor of every
// cycle.  The buffers are read from the i_* pointers (slots ts, grp, val,
// seq, occ [shards, c]; scalars max_ts, last_emit, seq_clock, dropped
// [shards]) and written to the o_* ones (the same pointers: in place);
// e_* [shards, n + c] get the emissions.  c_forced and c_depth (both null:
// stats off) are int32 counters the cycles of every buffer add their
// forced pops to and raise to the held entries after any cycle.
extern "C" int rt_reorder(const int* ts, const int* g, const void* k, int n,
                          int nvalid, const int* nvalid_dev,
                          const int* drain, const int* release,
                          const int* late, int drain_all, int shards,
                          int* i_ts, int* i_grp, void* i_val, int* i_seq,
                          bool* i_occ, int* i_max_ts, int* i_last_emit,
                          int* i_seq_clock, int* i_dropped, int* o_ts,
                          int* o_grp, void* o_val, int* o_seq, bool* o_occ,
                          int* o_max_ts, int* o_last_emit, int* o_seq_clock,
                          int* o_dropped, int c, int lateness, int* e_ts,
                          int* e_g, void* e_k, bool* e_live, bool* e_late,
                          int* c_forced, int* c_depth, void* stream) {
  using namespace rt;
  if (n < 0 || shards < 1 || c < 1 || c > MAX_REORDER || (c & (c - 1)) != 0 ||
      lateness < 0 ||
      (n > 0 && (ts == nullptr || g == nullptr || k == nullptr)) ||
      (c_forced == nullptr) != (c_depth == nullptr))
    return cudaErrorInvalidValue;
  const ReorderBuf in{i_ts, i_grp, static_cast<int*>(i_val), i_seq, i_occ,
                      i_max_ts, i_last_emit, i_seq_clock, i_dropped};
  const ReorderBuf out{o_ts, o_grp, static_cast<int*>(o_val), o_seq, o_occ,
                       o_max_ts, o_last_emit, o_seq_clock, o_dropped};
  ReorderArgs a{ts, g, static_cast<const int*>(k), n, nvalid, nvalid_dev,
                drain, release, late, drain_all, in, out, c, lateness, e_ts,
                e_g, static_cast<int*>(e_k), e_live, e_late, c_forced,
                c_depth};
  auto st = static_cast<cudaStream_t>(stream);
  switch (c <= 32 ? 1 : c / 32) {  // slots a lane
    case 1: return launch_reorder<1>(a, shards, st);
    case 2: return launch_reorder<2>(a, shards, st);
    case 4: return launch_reorder<4>(a, shards, st);
    case 8: return launch_reorder<8>(a, shards, st);
    case 16: return launch_reorder<16>(a, shards, st);
    default: return launch_reorder<32>(a, shards, st);
  }
}
