// The bounded-lateness reorder buffer of an event-time stream.
//
// No TPU kernel stands behind it: it replaces the JAX package's lax.scan
// of _reorder_cycle and the _reorder_drain after it
// (src/repro/core/eventtime.py).  A push is sequential: every cycle takes
// one tuple in and releases at most one, and what it releases depends on
// the buffer the cycles before it left.  So one warp runs the push:
//   * the buffer's `capacity` slots (ts, group, key, arrival seq,
//     occupancy) sit in shared memory, C / 32 slots a lane; the scalars
//     (largest timestamp seen, last emission, arrival clock, drop count)
//     in registers;
//   * the tuples come in 32 at a time, one a lane, and are broadcast by
//     shuffles;
//   * a cycle is the JAX package's: the late test against both floors (the
//     watermark, the last emission); a warp minimum of the buffered ts,
//     then a warp minimum of seq among the slots at that ts (two int32
//     steps; with nothing buffered, slot 0, as argmin gives it); the
//     incoming tuple or the buffered minimum released once the gate passes
//     it, or forced out by a full buffer; the first free slot (a warp
//     minimum) takes the tuple when it stays; one emission written;
//   * after the last tuple, the drain: the slots the gate has passed
//     sorted by (ts, seq, slot) in shared memory by a bitonic network
//     (the slot breaks the ties of the unreleased ones, which keep slot
//     order, as the JAX package's stable sort leaves them), written as the
//     [capacity] tail of the emissions.
// Keys ride as 32-bit words and are never compared.  A flush is the same
// launch with no tuple and every held slot drained.  Bound: the latency
// of one warp, a few shared-memory passes over C / 32 slots and four warp
// reductions a tuple; bytes (about 30 a tuple) leave the card's memory
// idle.
#include "tile.cuh"

namespace rt {
namespace {

constexpr int RO_TS_MIN = -(1 << 30);
constexpr int RO_I32_MAX = 0x7fffffff;
constexpr int MAX_REORDER = 1024;

struct ReorderArgs {
  const int* ts;          // [n] (null when n == 0)
  const int* g;           // [n]
  const int* k;           // [n] keys as 32-bit words
  int n;
  int nvalid;             // live lanes when nvalid_dev is null
  const int* nvalid_dev;  // [] or null
  const int* drain;       // [] drain gate, or null: the watermark
  int drain_all;          // 1: drain every held slot (a flush)
  int *s_ts, *s_grp, *s_val, *s_seq;  // [C] the buffer (in/out)
  bool* s_occ;                        // [C]
  int *max_ts, *last_emit, *seq_clock, *dropped;  // [] (in/out)
  int c, lateness;
  int *o_ts, *o_g, *o_k;  // [n + C] emissions
  bool *o_live, *o_late;  // [n + C]
};

__device__ __forceinline__ int warp_sum(int v) {
  return __reduce_add_sync(FULL_MASK, v);
}

// (ts, seq, slot) of drain entries i and j: i < j
__device__ __forceinline__ bool drain_less(const int* kt, const int* ks,
                                           const int* ki, int i, int j) {
  if (kt[i] != kt[j]) return kt[i] < kt[j];
  if (ks[i] != ks[j]) return ks[i] < ks[j];
  return ki[i] < ki[j];
}

__global__ void __launch_bounds__(32) reorder_kernel(ReorderArgs a) {
  extern __shared__ __align__(16) int sm[];
  const int C = a.c, lane = threadIdx.x, n = a.n;
  int* ts = sm;
  int* grp = ts + C;
  int* val = grp + C;
  int* seq = val + C;
  int* occ = seq + C;
  int* kt = occ + C;  // the drain's sort keys: ts, seq, slot
  int* ks = kt + C;
  int* ki = ks + C;

  int held = 0;
  for (int s = lane; s < C; s += 32) {
    ts[s] = a.s_ts[s];
    grp[s] = a.s_grp[s];
    val[s] = a.s_val[s];
    seq[s] = a.s_seq[s];
    occ[s] = a.s_occ[s] ? 1 : 0;
    held += occ[s];
  }
  held = warp_sum(held);
  int max_ts = *a.max_ts, last_emit = *a.last_emit;
  int seq_clock = *a.seq_clock, dropped = *a.dropped;
  const int nv = a.nvalid_dev ? *a.nvalid_dev : a.nvalid;
  __syncwarp();

  for (int i0 = 0; i0 < n; i0 += 32) {
    const int nb = n - i0 < 32 ? n - i0 : 32;
    int my_t = 0, my_g = 0, my_k = 0;
    if (lane < nb) {
      my_t = a.ts[i0 + lane];
      my_g = a.g[i0 + lane];
      my_k = a.k[i0 + lane];
    }
    for (int j = 0; j < nb; ++j) {
      const int i = i0 + j;
      const int t = __shfl_sync(FULL_MASK, my_t, j);
      const int g = __shfl_sync(FULL_MASK, my_g, j);
      const int k = __shfl_sync(FULL_MASK, my_k, j);
      const bool lv = i < nv;
      const int mx = max(max_ts, lv ? t : RO_TS_MIN);
      const int wm = sub_wrap(mx, a.lateness);  // the release gate
      const bool late = lv && (t < wm || t < last_emit);
      const bool insert = lv && !late;

      // the buffered minimum by (ts, seq): first its ts, then the first
      // slot of the least seq among the slots at that ts
      int lm = RO_I32_MAX;
      for (int s = lane; s < C; s += 32)
        if (occ[s] && ts[s] < lm) lm = ts[s];
      const int mts = __reduce_min_sync(FULL_MASK, lm);
      int bv = RO_I32_MAX, bi = RO_I32_MAX;
      for (int s = lane; s < C; s += 32) {
        const int v = occ[s] && ts[s] == mts ? seq[s] : RO_I32_MAX;
        if (v < bv || bi == RO_I32_MAX) {
          bv = v;
          bi = s;
        }
      }
      const int bmin = __reduce_min_sync(FULL_MASK, bv);
      const int pl = __reduce_min_sync(FULL_MASK,
                                       bv == bmin ? bi : RO_I32_MAX);
      const bool any_occ = held > 0, full = held == C;

      // the incoming tuple never wins a tie (its seq is the largest)
      const bool inc_min = insert && (t < mts || !any_occ);
      const bool pop_inc = inc_min && (t <= wm || full);
      const bool pop_buf =
          !pop_inc && any_occ && (mts <= wm || (full && insert));
      const int et = pop_inc ? t : ts[pl];
      const int eg = pop_inc ? g : grp[pl];
      const int ek = pop_inc ? k : val[pl];
      const bool ev = pop_inc || pop_buf;
      if (lane == 0) {
        a.o_ts[i] = et;
        a.o_g[i] = eg;
        a.o_k[i] = ek;
        a.o_live[i] = ev;
        a.o_late[i] = late;
      }
      __syncwarp();
      if (pop_buf) {
        if (lane == 0) occ[pl] = 0;
        --held;
      }
      __syncwarp();
      if (insert && !pop_inc) {  // a free slot exists
        int lf = RO_I32_MAX;
        for (int s = lane; s < C; s += 32)
          if (!occ[s]) {
            lf = s;
            break;
          }
        const int slot = __reduce_min_sync(FULL_MASK, lf);
        if (lane == 0) {
          ts[slot] = t;
          grp[slot] = g;
          val[slot] = k;
          seq[slot] = seq_clock;
          occ[slot] = 1;
        }
        ++held;
        seq_clock = add_wrap(seq_clock, 1);
      }
      __syncwarp();
      if (ev) last_emit = max(last_emit, et);
      max_ts = mx;
      if (late) dropped = add_wrap(dropped, 1);
    }
  }

  // the drain: every slot the gate has passed, sorted by (ts, seq)
  const int gate = a.drain ? *a.drain : sub_wrap(max_ts, a.lateness);
  int num = 0;
  for (int s = lane; s < C; s += 32) {
    const bool rel = occ[s] && (a.drain_all || ts[s] <= gate);
    kt[s] = rel ? ts[s] : RO_I32_MAX;
    ks[s] = rel ? seq[s] : RO_I32_MAX;
    ki[s] = s;
    num += rel;
    if (rel) occ[s] = 0;
  }
  num = warp_sum(num);
  __syncwarp();
  for (int kk = 2; kk <= C; kk <<= 1) {
    for (int jj = kk >> 1; jj > 0; jj >>= 1) {
      for (int p = lane; p < C / 2; p += 32) {
        const int i = ((p & ~(jj - 1)) << 1) | (p & (jj - 1));
        const int q = i + jj;
        const bool up = (i & kk) == 0;
        if (up ? drain_less(kt, ks, ki, q, i) : drain_less(kt, ks, ki, i, q)) {
          int x = kt[i]; kt[i] = kt[q]; kt[q] = x;
          x = ks[i]; ks[i] = ks[q]; ks[q] = x;
          x = ki[i]; ki[i] = ki[q]; ki[q] = x;
        }
      }
      __syncwarp();
    }
  }
  for (int j = lane; j < C; j += 32) {
    const int s = ki[j];
    a.o_ts[n + j] = j < num ? kt[j] : 0;
    a.o_g[n + j] = grp[s];
    a.o_k[n + j] = val[s];
    a.o_live[n + j] = j < num;
    a.o_late[n + j] = false;
  }
  if (num > 0) last_emit = max(last_emit, kt[num - 1]);
  for (int s = lane; s < C; s += 32) {
    a.s_ts[s] = ts[s];
    a.s_grp[s] = grp[s];
    a.s_val[s] = val[s];
    a.s_seq[s] = seq[s];
    a.s_occ[s] = occ[s] != 0;
  }
  if (lane == 0) {
    *a.max_ts = max_ts;
    *a.last_emit = last_emit;
    *a.seq_clock = seq_clock;
    *a.dropped = dropped;
  }
}

}  // namespace
}  // namespace rt

// One push of n tuples (ts, g, k; the first nvalid live, or *nvalid_dev
// when given) through a reorder buffer of c slots (a power of two, at most
// 1024) with lateness contract `lateness`: a cycle a tuple, then the drain
// of every slot at or below the gate (drain, else the watermark after the
// push; every held slot when drain_all).  The buffer (s_*, max_ts, last_emit, seq_clock, dropped) is read and
// written in place; o_* [n + c] get the emissions.  One warp.
extern "C" int rt_reorder(const int* ts, const int* g, const void* k, int n,
                          int nvalid, const int* nvalid_dev,
                          const int* drain, int drain_all, int* s_ts,
                          int* s_grp, void* s_val, int* s_seq, bool* s_occ,
                          int* max_ts, int* last_emit, int* seq_clock,
                          int* dropped, int c, int lateness, int* o_ts,
                          int* o_g, void* o_k, bool* o_live, bool* o_late,
                          void* stream) {
  using namespace rt;
  if (n < 0 || c < 1 || c > MAX_REORDER || (c & (c - 1)) != 0 ||
      lateness < 0 || (n > 0 && (ts == nullptr || g == nullptr || k == nullptr)))
    return cudaErrorInvalidValue;
  ReorderArgs a{ts, g, static_cast<const int*>(k), n, nvalid, nvalid_dev,
                drain, drain_all, s_ts, s_grp,
                static_cast<int*>(s_val), s_seq, s_occ, max_ts, last_emit,
                seq_clock, dropped, c, lateness, o_ts, o_g,
                static_cast<int*>(o_k), o_live, o_late};
  const size_t smem = 8 * sizeof(int) * static_cast<size_t>(c);
  reorder_kernel<<<1, 32, smem, static_cast<cudaStream_t>(stream)>>>(a);
  return cudaGetLastError();
}
