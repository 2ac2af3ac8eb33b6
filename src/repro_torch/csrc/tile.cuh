// Shared device functions of the engine kernels: the in-tile primitives of
// the JAX package's kernels/common.py, rethought for one thread block.
//
//   * combiner states as plain structs, one trait per op (Comb<OP, K>);
//   * a block segmented inclusive scan that keeps operand order (the
//     distinct-count state (dc, first, last) is not commutative): each
//     thread scans L consecutive lanes in registers, warps scan the thread
//     totals with shuffles, warp 0 scans the warp totals, and every lane
//     folds in its prefix;
//   * a block exclusive prefix sum (the compaction ranks: where the TPU
//     kernels route lanes through a reverse butterfly because Mosaic has no
//     scatter, a Hopper block scatters each lane to its rank);
//   * the padded shared-memory layouts of the rows that swag.cu and
//     pergroup.cu sort and merge;
//   * a chained tile prefix (decoupled look-back): the carry of groupagg.cu
//     and segscan.cu from each tile to the next, in the same pass as the
//     tiles' own work.
//
// Group ids lie strictly between INT32_MIN (the shift fill) and INT32_MAX
// (PAD_GROUP, the padding sentinel).  Integer sums add as uint32 and
// reinterpret, so they wrap as the JAX package's int32 sums do (signed
// overflow is undefined in C++).
#pragma once

#include <cstdint>
#include <cstring>
#include <type_traits>
#include <cuda_runtime.h>

namespace rt {

constexpr int PAD_GROUP = 0x7fffffff;
constexpr int SHIFT_FILL = (-0x7fffffff - 1);
constexpr unsigned FULL_MASK = 0xffffffffu;
// rows longer than this do not fit one block's shared memory as (g, k)
// pairs of 8 bytes (16384 * 8 = 128 KiB of the 227 KiB a block may use)
constexpr int MAX_ROW = 16384;
constexpr int MAX_OPS = 12;

enum OpCode {
  OP_SUM = 0, OP_MIN, OP_MAX, OP_COUNT, OP_MEAN, OP_DC, OP_FIRST, OP_LAST,
  OP_VARIANCE, OP_ARGMIN, OP_ARGMAX, OP_MEDIAN
};

enum KeyType { KEY_INT32 = 0, KEY_FLOAT32 = 1 };

__device__ __forceinline__ int add_wrap(int a, int b) {
  return static_cast<int>(static_cast<unsigned>(a) + static_cast<unsigned>(b));
}
__device__ __forceinline__ float add_wrap(float a, float b) { return a + b; }
__device__ __forceinline__ double add_wrap(double a, double b) { return a + b; }
__device__ __forceinline__ int sub_wrap(int a, int b) {
  return static_cast<int>(static_cast<unsigned>(a) - static_cast<unsigned>(b));
}

template <typename T>
__device__ __forceinline__ T shfl_down(T v, int d) {
  static_assert(sizeof(T) % 4 == 0, "states are whole 32-bit words");
  union U { T t; int w[sizeof(T) / 4]; };
  U in, out;
  in.t = v;
#pragma unroll
  for (int i = 0; i < static_cast<int>(sizeof(T) / 4); ++i)
    out.w[i] = __shfl_down_sync(FULL_MASK, in.w[i], d);
  return out.t;
}

template <typename T>
__device__ __forceinline__ T shfl_up(T v, int d) {
  static_assert(sizeof(T) % 4 == 0, "states are whole 32-bit words");
  union U { T t; int w[sizeof(T) / 4]; };
  U in, out;
  in.t = v;
#pragma unroll
  for (int i = 0; i < static_cast<int>(sizeof(T) / 4); ++i)
    out.w[i] = __shfl_up_sync(FULL_MASK, in.w[i], d);
  return out.t;
}

// ---------------------------------------------------------------- combiners
// lift(key, lane) -> S; op(a, b) with a the earlier range; fin(S) -> Out.

template <typename K> struct MeanS { K sum; int cnt; };
template <typename K> struct DcS { int dc; K first; K last; };
struct VarS { float n, mean, m2; };
template <typename K> struct ArgS { K k; int idx; };

template <int OP, typename K> struct Comb;

template <typename K> struct Comb<OP_SUM, K> {
  using Key = K; using S = K; using Out = K;
  static __device__ S lift(K k, int) { return k; }
  static __device__ S op(S a, S b) { return add_wrap(a, b); }
  static __device__ Out fin(S s) { return s; }
};
template <typename K> struct Comb<OP_MIN, K> {
  using Key = K; using S = K; using Out = K;
  static __device__ S lift(K k, int) { return k; }
  static __device__ S op(S a, S b) { return b < a ? b : a; }
  static __device__ Out fin(S s) { return s; }
};
template <typename K> struct Comb<OP_MAX, K> {
  using Key = K; using S = K; using Out = K;
  static __device__ S lift(K k, int) { return k; }
  static __device__ S op(S a, S b) { return a < b ? b : a; }
  static __device__ Out fin(S s) { return s; }
};
template <typename K> struct Comb<OP_COUNT, K> {
  using Key = K; using S = int; using Out = int;
  static __device__ S lift(K, int) { return 1; }
  static __device__ S op(S a, S b) { return add_wrap(a, b); }
  static __device__ Out fin(S s) { return s; }
};
template <typename K> struct Comb<OP_MEAN, K> {
  using Key = K; using S = MeanS<K>; using Out = float;
  static __device__ S lift(K k, int) { return S{k, 1}; }
  static __device__ S op(S a, S b) {
    return S{add_wrap(a.sum, b.sum), add_wrap(a.cnt, b.cnt)};
  }
  // float32(total) / float32(max(cnt, 1)): one IEEE divide, as in JAX
  static __device__ Out fin(S s) {
    return static_cast<float>(s.sum) / static_cast<float>(s.cnt > 1 ? s.cnt : 1);
  }
};
template <typename K> struct Comb<OP_DC, K> {
  using Key = K; using S = DcS<K>; using Out = int;
  static __device__ S lift(K k, int) { return S{1, k, k}; }
  static __device__ S op(S a, S b) {
    return S{sub_wrap(add_wrap(a.dc, b.dc), a.last == b.first ? 1 : 0),
             a.first, b.last};
  }
  static __device__ Out fin(S s) { return s.dc; }
};
template <typename K> struct Comb<OP_FIRST, K> {
  using Key = K; using S = K; using Out = K;
  static __device__ S lift(K k, int) { return k; }
  static __device__ S op(S a, S) { return a; }
  static __device__ Out fin(S s) { return s; }
};
template <typename K> struct Comb<OP_LAST, K> {
  using Key = K; using S = K; using Out = K;
  static __device__ S lift(K k, int) { return k; }
  static __device__ S op(S, S b) { return b; }
  static __device__ Out fin(S s) { return s; }
};
template <typename K> struct Comb<OP_VARIANCE, K> {
  using Key = K; using S = VarS; using Out = float;
  static __device__ S lift(K k, int) { return S{1.0f, static_cast<float>(k), 0.0f}; }
  static __device__ S op(S a, S b) {
    float n = a.n + b.n;
    float d = b.mean - a.mean;
    float safe_n = n > 1.0f ? n : 1.0f;
    float mean = a.mean + d * b.n / safe_n;
    float m2 = a.m2 + b.m2 + d * d * a.n * b.n / safe_n;
    return S{n, mean, m2};
  }
  static __device__ Out fin(S s) { return s.m2 / (s.n > 1.0f ? s.n : 1.0f); }
};
template <typename K> struct Comb<OP_ARGMIN, K> {
  using Key = K; using S = ArgS<K>; using Out = int;
  static __device__ S lift(K k, int lane) { return S{k, lane}; }
  static __device__ S op(S a, S b) { return b.k < a.k ? b : a; }
  static __device__ Out fin(S s) { return s.idx; }
};
template <typename K> struct Comb<OP_ARGMAX, K> {
  using Key = K; using S = ArgS<K>; using Out = int;
  static __device__ S lift(K k, int lane) { return S{k, lane}; }
  static __device__ S op(S a, S b) { return b.k > a.k ? b : a; }
  static __device__ Out fin(S s) { return s.idx; }
};

// ------------------------------------------------------------------- scans

// Shared scratch of one block scan: warp totals (states up to 16 bytes),
// their flags, and the warp sums of the rank scan.
struct ScanSmem {
  alignas(16) unsigned char states[32 * 16];
  int flags[32];
  int sums[32];
  int misc[4];
};

// Segmented inclusive scan of the block's lanes; thread t holds lanes
// t*L .. t*L+L-1 in s[] with their segment-start flags in f[].  With
// has_carry, `carry` (the state of a run that began before lane 0) folds
// into the lanes ahead of the first set flag.
template <class C, int L>
__device__ void block_seg_scan(typename C::S (&s)[L], const bool (&f)[L],
                               bool has_carry, typename C::S carry,
                               ScanSmem& sm) {
  using S = typename C::S;
  static_assert(sizeof(S) <= 16, "state too wide for the scan scratch");
  S* wstate = reinterpret_cast<S*>(sm.states);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;

  bool tf = f[0];
#pragma unroll
  for (int j = 1; j < L; ++j) {
    if (!f[j]) s[j] = C::op(s[j - 1], s[j]);
    tf = tf || f[j];
  }
  S ta = s[L - 1];
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    S oa = shfl_up(ta, d);
    int of = __shfl_up_sync(FULL_MASK, tf ? 1 : 0, d);
    if (lane >= d) {
      if (!tf) ta = C::op(oa, ta);
      tf = tf || of;
    }
  }
  const S ea = shfl_up(ta, 1);  // exclusive prefix inside the warp
  const bool ef = __shfl_up_sync(FULL_MASK, tf ? 1 : 0, 1) != 0;
  if (lane == 31) {
    wstate[warp] = ta;
    sm.flags[warp] = tf ? 1 : 0;
  }
  __syncthreads();
  if (warp == 0) {
    // lanes past nwarps hold stale values; a Hillis-Steele step only pulls
    // from the left, so they never reach a live lane
    S wa = wstate[lane < nwarps ? lane : 0];
    bool wf = lane < nwarps ? sm.flags[lane] != 0 : true;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      S oa = shfl_up(wa, d);
      int of = __shfl_up_sync(FULL_MASK, wf ? 1 : 0, d);
      if (lane >= d) {
        if (!wf) wa = C::op(oa, wa);
        wf = wf || of;
      }
    }
    if (lane < nwarps) {
      wstate[lane] = wa;
      sm.flags[lane] = wf ? 1 : 0;
    }
  }
  __syncthreads();
  // this thread's prefix: carry, then the earlier warps, then the earlier
  // threads of this warp — a later flag restarts the running state
  bool has = has_carry;
  S pre = carry;
  if (warp > 0) {
    const S w = wstate[warp - 1];
    pre = (has && sm.flags[warp - 1] == 0) ? C::op(pre, w) : w;
    has = true;
  }
  if (lane > 0) {
    pre = (has && !ef) ? C::op(pre, ea) : ea;
    has = true;
  }
  bool live = has;
#pragma unroll
  for (int j = 0; j < L; ++j) {
    live = live && !f[j];
    if (live) s[j] = C::op(pre, s[j]);
  }
  __syncthreads();  // the scratch is reused by the next scan
}

// Exclusive prefix sum of v[] over the block's lanes into r[]; returns the
// block total.
template <int L>
__device__ int block_excl_sum(const int (&v)[L], int (&r)[L], ScanSmem& sm) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  int t = 0;
#pragma unroll
  for (int j = 0; j < L; ++j) {
    r[j] = t;
    t += v[j];
  }
  int inc = t;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    int o = __shfl_up_sync(FULL_MASK, inc, d);
    if (lane >= d) inc += o;
  }
  if (lane == 31) sm.sums[warp] = inc;
  __syncthreads();
  if (warp == 0) {
    int w = lane < nwarps ? sm.sums[lane] : 0;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      int o = __shfl_up_sync(FULL_MASK, w, d);
      if (lane >= d) w += o;
    }
    sm.sums[lane] = w;
  }
  __syncthreads();
  const int base = (warp > 0 ? sm.sums[warp - 1] : 0) + inc - t;
#pragma unroll
  for (int j = 0; j < L; ++j) r[j] += base;
  const int total = sm.sums[nwarps - 1];
  __syncthreads();
  return total;
}

// ------------------------------------------------------ chained tile prefix
//
// A single-pass prefix over the tiles of one launch, by decoupled look-back
// (Merrill and Garland, "Single-pass Parallel Prefix Scan with Decoupled
// Look-back", 2016).  It carries a value from every tile to all later ones
// while the tiles' own work runs, where a reduce-then-scan needs a pass of
// tile summaries, a one-block scan of them and a second pass.
//
//   * A block takes its tile from an atomic ticket (chain_ticket), not from
//     blockIdx: every tile it then waits on belongs to a block that has
//     already started, and a block publishes its aggregate before it waits
//     on anything, so no block order or oversubscription can deadlock.
//   * A tile's descriptor has two payload slots, each written once: its
//     aggregate (its own range; status CH_AGG) and its inclusive prefix
//     (tiles 0..t; CH_PREFIX).  A tile whose aggregate already is its
//     inclusive prefix (tile 0; where nothing but a segmented state is
//     carried, a tile that restarts the segment) writes the inclusive slot
//     and publishes CH_PREFIX at once.  A segmented state in an aggregate
//     carries a restart flag: the fold takes nothing from before it.
//   * Payload first, then the status: the writer stores the payload,
//     __threadfence(), then the status with a release store; a reader loads
//     the status with an acquire load and only then the slot it names, past
//     L1 (__ldcg).
//   * One warp looks back 32 tiles a step (lane l: tile hi - l), until the
//     nearest CH_PREFIX, and folds each window's payloads in tile order: a
//     higher lane is an earlier tile and goes on the left (distinct count
//     is not commutative; int32 sums wrap through add_wrap in every combine
//     of Comb::op).
//   * The caller zeroes the ticket and the status words on every launch, so
//     no status of an earlier launch is ever read.

enum ChainStatus : unsigned { CH_NONE = 0, CH_AGG = 1, CH_PREFIX = 2 };

__device__ __forceinline__ unsigned ld_acquire(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.u32 %0, [%1];"
               : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void st_release(unsigned* p, unsigned v) {
  asm volatile("st.release.gpu.u32 [%0], %1;"
               : : "l"(p), "r"(v) : "memory");
}

// The block's tile: the launch's next ticket (counter zeroed by the caller).
__device__ __forceinline__ int chain_ticket(unsigned* counter) {
  __shared__ int ticket;
  if (threadIdx.x == 0) ticket = static_cast<int>(atomicAdd(counter, 1u));
  __syncthreads();
  return ticket;
}

// Publishes `tile`'s status once the payload this thread stored is out.
__device__ __forceinline__ void chain_publish(unsigned* status, int tile,
                                              unsigned st) {
  __threadfence();
  st_release(status + tile, st);
}

// A state in a 16-byte payload slot or shared-memory word.
template <typename S>
__device__ __forceinline__ uint4 pack_state(S s) {
  static_assert(sizeof(S) <= 16, "state too wide for a slot");
  uint4 u = make_uint4(0u, 0u, 0u, 0u);
  memcpy(&u, &s, sizeof(S));
  return u;
}
template <typename S>
__device__ __forceinline__ S unpack_state(uint4 u) {
  S s;
  memcpy(&s, &u, sizeof(S));
  return s;
}

// The look-back of tile `tile` > 0, run by one whole warp.  For each window
// of predecessors (lane l: tile j = hi - l), once every tile up to the
// window's nearest CH_PREFIX (or all 32) has published, every lane calls
// fold(j, in, inc): `in` whether tile j lies in the fold (lanes 0..last),
// `inc` whether it is read from its inclusive slot (the last lane, when its
// tile had published CH_PREFIX).  Windows come latest first; the fold puts
// each to the left of what it holds.  Each lane's payload read follows its
// own acquire load.
template <class Fold>
__device__ __forceinline__ void chain_lookback(const unsigned* status,
                                               int tile, Fold& fold) {
  const int lane = threadIdx.x & 31;
  for (int hi = tile - 1;; hi -= 32) {
    const int j = hi - lane;
    unsigned pref;
    for (;;) {
      // tile 0 always publishes CH_PREFIX, so no lane past it is folded
      const unsigned st = j >= 0 ? ld_acquire(status + j) : CH_AGG;
      pref = __ballot_sync(FULL_MASK, st == CH_PREFIX);
      const unsigned none = __ballot_sync(FULL_MASK, st == CH_NONE);
      // lanes 0..nearest prefix (all 32 without one) must have published
      const unsigned need =
          pref ? (((pref & (0u - pref)) << 1) - 1u) : FULL_MASK;
      if (!(none & need)) break;
      __nanosleep(32);
    }
    const int last = pref ? __ffs(pref) - 1 : 31;
    fold(j, lane <= last, pref != 0u && lane == last);
    if (pref) return;
  }
}

// The ordered fold of a warp's states: lane l holds tile hi - l (`in` a
// prefix of the lanes), so the partner d lanes up is earlier and goes on the
// left; r: the lane's range restarts the run (nothing earlier reaches it).
// Lane 0 returns the fold of every `in` lane.
template <class C>
__device__ __forceinline__ typename C::S warp_fold_left(typename C::S v,
                                                        bool r, bool in) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const typename C::S o = shfl_down(v, d);
    const bool orr = __shfl_down_sync(FULL_MASK, r ? 1 : 0, d) != 0;
    const bool oin = __shfl_down_sync(FULL_MASK, in ? 1 : 0, d) != 0;
    if (lane + d < 32 && oin) {  // oin implies in: the in lanes are a prefix
      if (!r) v = C::op(o, v);
      r = r || orr;
    }
  }
  return v;
}

// One look-back window of an op's states, folded to the left of acc (the
// fold of the later windows, `has`: whether there is one; the caller stops
// folding states once a window held a restart).  r: the lane's tile
// restarts the run (an inclusive prefix always does).  Lane 0 writes acc.
template <class C>
__device__ __forceinline__ void chain_fold_state(const uint4* agg,
                                                 const uint4* incl, int j,
                                                 bool in, bool inc, bool r,
                                                 uint4& acc, bool has) {
  using S = typename C::S;
  S v{};
  if (in) v = unpack_state<S>(__ldcg((inc ? incl : agg) + j));
  v = warp_fold_left<C>(v, r, in);
  if ((threadIdx.x & 31) == 0)
    acc = pack_state(has ? C::op(v, unpack_state<S>(acc)) : v);
}

// The fold of a chain of one op's states whose aggregates never restart
// (a restarting tile publishes its inclusive prefix at once): the state
// pending before the tile, in *acc.
template <class C>
struct StateFold {
  const uint4* agg;
  const uint4* incl;
  uint4* acc;
  bool has;
  __device__ __forceinline__ void operator()(int j, bool in, bool inc) {
    chain_fold_state<C>(agg, incl, j, in, inc, inc, *acc, has);
    has = true;
  }
};

// --------------------------------------------------- shared-memory layouts

// Shared-memory index with one pad word per 16 (8-byte) or 32 (4-byte)
// words, so a warp storing its threads' L consecutive lanes hits distinct
// banks.
__host__ __device__ __forceinline__ int pad64(int i) { return i + (i >> 4); }
__host__ __device__ __forceinline__ int pad32(int i) { return i + (i >> 5); }

inline bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// ------------------------------------------------------------- op lists

struct OpList {
  int n;
  int code[MAX_OPS];
  void* out[MAX_OPS];
};

}  // namespace rt
