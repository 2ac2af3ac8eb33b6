// Fused sliding-window aggregation kernels (paper Fig. 4): one block per
// window row.
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
//   * sort_panes_pallas  -> sort_rows_kernel: sort each WA-lane pane once,
//                           by the same register sort of packed words.
//
// Rows are read with a row stride, so the re-sort path frames its windows
// as a strided view of the stream (stride WA) and never materialises the
// [NW, WS] frames.
//
// What bounds swag_rows_kernel on this card, and what the design does:
//   * the sort: each lane's (group, key) is packed into one order-keeping
//     uint64, and each thread holds L consecutive lanes in registers.  A
//     bitonic stage of stride j < L runs in registers, L <= j < 32 L by
//     warp shuffles, and only the strides past a warp's span go through
//     shared memory behind a block barrier (3 of the 55 stages at 1024
//     lanes, 6 of 78 at 4096);
//   * presorted panes (run > 1): log2(T / run) merge-path rounds, each
//     thread finding its co-rank by a binary search over the shared row
//     and merging its L outputs in registers, one barrier a round;
//   * the tails: in a (group, key)-sorted row each group is one segment
//     [s, e], so count, min, max, first, last, argmin, argmax and the
//     median are read off its ends, an int32 sum and a distinct count are
//     differences of two prefix sums (one fused block scan gives them and
//     the emit ranks); the thread for rank r writes rank r of every op, so
//     the stores of consecutive ranks are coalesced.  Float sums, means and
//     variances keep an ordered segmented scan;
//   * device memory: 8 * WS bytes read and 4 * WS * (1 + ops) written per
//     row, most of it the zero and PAD_GROUP tails of the [NW, WS] outputs
//     (the TPU kernels' layout), written with 16-byte stores.
//
// Float keys are packed with -0.0 made +0.0, so the packed order is the
// float order (NaN excepted, which neither version defines) and the merge
// of runs sorted by float compare is well defined: outputs differ from the
// plain version's at most in the sign of a zero.  sort_rows_kernel packs
// with -0.0 just below +0.0 instead (ExactCode), so a sorted pane holds
// exactly its input's bit patterns; it differs from the plain network only
// in the order of a group's -0.0 and +0.0 keys, an order that is sorted
// under both packings.
#include "tile.cuh"

namespace rt {

using u64 = unsigned long long;

constexpr unsigned SIGN = 0x80000000u;
constexpr u64 PAD_LANE = ~0ull;           // fills lanes past the row

// Order-keeping 32-bit codes of the keys: unsigned order of the code is
// the key's order.
template <typename K> struct KeyCode;
template <> struct KeyCode<int> {
  static constexpr bool kFloat = false;
  static __device__ __forceinline__ unsigned enc(unsigned bits) {
    return bits ^ SIGN;
  }
  static __device__ __forceinline__ int dec(unsigned u) {
    return static_cast<int>(u ^ SIGN);
  }
};
template <> struct KeyCode<float> {
  static constexpr bool kFloat = true;
  static __device__ __forceinline__ unsigned enc(unsigned bits) {
    if ((bits & ~SIGN) == 0) bits = 0;  // -0.0 -> +0.0
    return (bits & SIGN) ? ~bits : (bits | SIGN);
  }
  static __device__ __forceinline__ float dec(unsigned u) {
    return __uint_as_float((u & SIGN) ? (u ^ SIGN) : ~u);
  }
};

// The order-keeping bijection of a key's bits (-0.0 below +0.0), and its
// inverse: sort_rows_kernel returns the bits it was given.
template <typename K> struct ExactCode;
template <> struct ExactCode<int> {
  static __device__ __forceinline__ unsigned enc(unsigned bits) {
    return bits ^ SIGN;
  }
  static __device__ __forceinline__ unsigned dec(unsigned u) {
    return u ^ SIGN;
  }
};
template <> struct ExactCode<float> {
  static __device__ __forceinline__ unsigned enc(unsigned bits) {
    return (bits & SIGN) ? ~bits : (bits | SIGN);
  }
  static __device__ __forceinline__ unsigned dec(unsigned u) {
    return (u & SIGN) ? (u ^ SIGN) : ~u;
  }
};

__device__ __forceinline__ u64 pack(int g, unsigned code) {
  return (static_cast<u64>(static_cast<unsigned>(g) ^ SIGN) << 32) | code;
}
__device__ __forceinline__ unsigned hi_word(u64 v) {
  return static_cast<unsigned>(v >> 32);
}
__device__ __forceinline__ int group_of(u64 v) {
  return static_cast<int>(hi_word(v) ^ SIGN);
}

// ------------------------------------------------------------------ sort

__device__ __forceinline__ void cas(u64& a, u64& b, bool up) {
  const bool sw = up ? (b < a) : (a < b);
  const u64 x = sw ? b : a;
  b = sw ? a : b;
  a = x;
}

// Bitonic sort of the block's blockDim.x * L lanes; thread t holds lanes
// t*L .. t*L+L-1 in v[] and gets them back sorted.  s: the row's shared
// buffer (pad64 layout) for the strides past a warp's span.
template <int L>
__device__ void block_sort_packed(u64 (&v)[L], u64* s) {
  const int t = threadIdx.x, lane = t & 31, n = blockDim.x;
  const int Tp = n * L, base = t * L;
#pragma unroll
  for (int kk = 2; kk <= L; kk <<= 1)
#pragma unroll
    for (int jj = kk >> 1; jj > 0; jj >>= 1)
#pragma unroll
      for (int j = 0; j < L; ++j)
        if ((j & jj) == 0) cas(v[j], v[j + jj], ((base + j) & kk) == 0);
  for (int kk = 2 * L; kk <= Tp; kk <<= 1) {
    const bool up = (base & kk) == 0;
    int jj = kk >> 1;
    if (jj >= 32 * L) {
#pragma unroll
      for (int j = 0; j < L; ++j) s[pad64(base + j)] = v[j];
      __syncthreads();
      for (; jj >= 32 * L; jj >>= 1) {
        for (int p = t; p < Tp / 2; p += n) {
          const int i = ((p & ~(jj - 1)) << 1) | (p & (jj - 1));
          u64 a = s[pad64(i)], b = s[pad64(i + jj)];
          if ((i & kk) == 0 ? (b < a) : (a < b)) {
            s[pad64(i)] = b;
            s[pad64(i + jj)] = a;
          }
        }
        __syncthreads();
      }
      // each thread reads back only its own lanes, which no other thread
      // writes before the next barrier
#pragma unroll
      for (int j = 0; j < L; ++j) v[j] = s[pad64(base + j)];
    }
    for (; jj >= L; jj >>= 1) {
      const int d = jj / L;
      const bool keep_min = ((lane & d) == 0) == up;
#pragma unroll
      for (int j = 0; j < L; ++j) {
        const u64 o = __shfl_xor_sync(FULL_MASK, v[j], d);
        v[j] = (keep_min == (o < v[j])) ? o : v[j];
      }
    }
#pragma unroll
    for (int jj2 = L / 2; jj2 > 0; jj2 >>= 1)
#pragma unroll
      for (int j = 0; j < L; ++j)
        if ((j & jj2) == 0) cas(v[j], v[j + jj2], up);
  }
}

// Merge of the row's presorted runs of `run` lanes (run >= L), held in s
// (pad64 layout): pairwise merge-path rounds.  Thread t ends with the
// merged lanes t*L .. t*L+L-1 in v[].  Equal packed words are equal
// (group, key) pairs, so any tie order gives the same row.
template <int L>
__device__ void block_merge_packed(u64 (&v)[L], u64* s, int run) {
  const int t = threadIdx.x, n = blockDim.x;
  const int Tp = n * L, base = t * L;
  if (run >= Tp) {
#pragma unroll
    for (int j = 0; j < L; ++j) v[j] = s[pad64(base + j)];
    return;
  }
  for (int len = run; len < Tp; len <<= 1) {
    const int a0 = base & ~(2 * len - 1), b0 = a0 + len;
    const int d = base - a0;  // this thread's first output in the pair
    // co-rank: the first d outputs take A[0, i) and B[0, d - i)
    int lo = d > len ? d - len : 0, hi = d < len ? d : len;
    while (lo < hi) {
      const int i = (lo + hi) >> 1;
      if (s[pad64(a0 + i)] <= s[pad64(b0 + d - i - 1)]) lo = i + 1;
      else hi = i;
    }
    int i = lo, j = d - lo;
    u64 a = i < len ? s[pad64(a0 + i)] : 0;
    u64 b = j < len ? s[pad64(b0 + j)] : 0;
#pragma unroll
    for (int m = 0; m < L; ++m) {
      const bool take_a = i < len && (j >= len || a <= b);
      v[m] = take_a ? a : b;
      if (take_a) {
        if (++i < len) a = s[pad64(a0 + i)];
      } else {
        if (++j < len) b = s[pad64(b0 + j)];
      }
    }
    if (2 * len < Tp) {
      __syncthreads();
#pragma unroll
      for (int m = 0; m < L; ++m) s[pad64(base + m)] = v[m];
      __syncthreads();
    }
  }
}

// ----------------------------------------------------------------- scans

struct Sum3 { unsigned r, p, d; };

// Exclusive prefix of three uint32 sums over the block's threads (the
// emit ranks, the wrapped key sum, the distinct-key starts); `total` gets
// the block's sums.
__device__ Sum3 block_excl3(Sum3 x, Sum3& total, ScanSmem& sm) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  unsigned* ws = reinterpret_cast<unsigned*>(sm.states);  // 32 x 3 words
  Sum3 inc = x;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const unsigned r = __shfl_up_sync(FULL_MASK, inc.r, d);
    const unsigned p = __shfl_up_sync(FULL_MASK, inc.p, d);
    const unsigned q = __shfl_up_sync(FULL_MASK, inc.d, d);
    if (lane >= d) { inc.r += r; inc.p += p; inc.d += q; }
  }
  if (lane == 31) {
    ws[3 * warp] = inc.r; ws[3 * warp + 1] = inc.p; ws[3 * warp + 2] = inc.d;
  }
  __syncthreads();
  if (warp == 0) {
    Sum3 w = {0, 0, 0};
    if (lane < nwarps) w = {ws[3 * lane], ws[3 * lane + 1], ws[3 * lane + 2]};
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const unsigned r = __shfl_up_sync(FULL_MASK, w.r, d);
      const unsigned p = __shfl_up_sync(FULL_MASK, w.p, d);
      const unsigned q = __shfl_up_sync(FULL_MASK, w.d, d);
      if (lane >= d) { w.r += r; w.p += p; w.d += q; }
    }
    if (lane < nwarps) {
      ws[3 * lane] = w.r; ws[3 * lane + 1] = w.p; ws[3 * lane + 2] = w.d;
    }
  }
  __syncthreads();
  Sum3 ex = {inc.r - x.r, inc.p - x.p, inc.d - x.d};
  if (warp > 0) {
    ex.r += ws[3 * (warp - 1)];
    ex.p += ws[3 * (warp - 1) + 1];
    ex.d += ws[3 * (warp - 1) + 2];
  }
  total = {ws[3 * (nwarps - 1)], ws[3 * (nwarps - 1) + 1],
           ws[3 * (nwarps - 1) + 2]};
  __syncthreads();
  return ex;
}

// The state each thread's lanes continue from in a segmented scan whose
// thread totals are (ta, tf) (tf: a segment starts among the thread's
// lanes): block_seg_scan's combination, in its order.  Returns whether
// there is one (false for thread 0).
template <class C>
__device__ bool block_seg_prefix(typename C::S ta, bool tf,
                                 typename C::S& pre, ScanSmem& sm) {
  using S = typename C::S;
  static_assert(sizeof(S) <= 16, "state too wide for the scan scratch");
  S* wstate = reinterpret_cast<S*>(sm.states);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const S oa = shfl_up(ta, d);
    const int of = __shfl_up_sync(FULL_MASK, tf ? 1 : 0, d);
    if (lane >= d) {
      if (!tf) ta = C::op(oa, ta);
      tf = tf || of;
    }
  }
  const S ea = shfl_up(ta, 1);
  const bool ef = __shfl_up_sync(FULL_MASK, tf ? 1 : 0, 1) != 0;
  if (lane == 31) {
    wstate[warp] = ta;
    sm.flags[warp] = tf ? 1 : 0;
  }
  __syncthreads();
  if (warp == 0) {
    S wa = wstate[lane < nwarps ? lane : 0];
    bool wf = lane < nwarps ? sm.flags[lane] != 0 : true;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const S oa = shfl_up(wa, d);
      const int of = __shfl_up_sync(FULL_MASK, wf ? 1 : 0, d);
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
  bool has = false;
  pre = ta;
  if (warp > 0) {
    pre = wstate[warp - 1];
    has = true;
  }
  if (lane > 0) {
    pre = (has && !ef) ? C::op(pre, ea) : ea;
    has = true;
  }
  __syncthreads();
  return has;
}

// ----------------------------------------------------------------- tails

// What a row's tails share in shared memory after the sort: the keys and
// groups by lane, and per emit rank of the current chunk (slot 0: the rank
// before it) its segment's end lane and prefix sums.
template <typename K>
struct TailSmem {
  K* key;
  int* grp;
  int* end;
  unsigned* psum;
  unsigned* pdc;
};

// Ops whose value needs an ordered float reduction of the segment.
template <typename K>
__device__ __forceinline__ bool by_scan(int code) {
  return code == OP_VARIANCE ||
         (KeyCode<K>::kFloat && (code == OP_SUM || code == OP_MEAN));
}

// One segment-scanned op: two serial passes over the thread's lanes around
// one block prefix; each emitting lane writes its rank's value.
template <class C, int L>
__device__ void scan_tail(const typename C::Key* key, unsigned stm,
                          unsigned emm, int rank, typename C::Out* out,
                          ScanSmem& sm) {
  using S = typename C::S;
  const int base = threadIdx.x * L;
  S acc = C::lift(key[pad32(base)], base);
  // not unrolled: the variance's divides, unrolled L times, spill at L = 16
#pragma unroll 1
  for (int j = 1; j < L; ++j) {
    const S x = C::lift(key[pad32(base + j)], base + j);
    acc = ((stm >> j) & 1) ? x : C::op(acc, x);
  }
  S pre;
  const bool has = block_seg_prefix<C>(acc, stm != 0, pre, sm);
  bool live = has;
#pragma unroll 1
  for (int j = 0; j < L; ++j) {
    const S x = C::lift(key[pad32(base + j)], base + j);
    const bool st = (stm >> j) & 1;
    acc = (j == 0 || st) ? x : C::op(acc, x);
    live = live && !st;
    if ((emm >> j) & 1) out[rank++] = C::fin(live ? C::op(pre, acc) : acc);
  }
}

// out[from, T) = word, 16 bytes a store where the row allows it.
__device__ void fill_tail(int* out, int from, int T, int word, bool vec) {
  const int t = threadIdx.x, n = blockDim.x;
  const int head = vec ? min((from + 3) & ~3, T) : T;
  for (int r = from + t; r < head; r += n) out[r] = word;
  if (!vec) return;
  const int4 w4 = make_int4(word, word, word, word);
  for (int r = head + 4 * t; r < T; r += 4 * n)
    *reinterpret_cast<int4*>(out + r) = w4;
}

// One emit rank's value of one op, read off its segment [s, e] (not the
// by_scan ops).
template <typename K>
__device__ __forceinline__ void rank_value(int code, void* out_row, int r,
                                           const K* key, int s, int e,
                                           unsigned psum, int dc) {
  const int c = e - s + 1;
  switch (code) {
    case OP_SUM:  // int32 keys: the wrapped difference is exact mod 2^32
      static_cast<int*>(out_row)[r] = static_cast<int>(psum);
      break;
    case OP_MEAN:  // int32 keys: float32(wrapped sum) / float32(count)
      static_cast<float*>(out_row)[r] =
          static_cast<float>(static_cast<int>(psum)) /
          static_cast<float>(c > 1 ? c : 1);
      break;
    case OP_MIN:
    case OP_FIRST:
      static_cast<K*>(out_row)[r] = key[pad32(s)];
      break;
    case OP_MAX:
    case OP_LAST:
      static_cast<K*>(out_row)[r] = key[pad32(e)];
      break;
    case OP_COUNT:
      static_cast<int*>(out_row)[r] = c;
      break;
    case OP_DC:
      static_cast<int*>(out_row)[r] = dc;
      break;
    case OP_ARGMIN:
      static_cast<int*>(out_row)[r] = s;
      break;
    case OP_ARGMAX: {  // the first lane holding the segment's largest key
      const K top = key[pad32(e)];
      int lo = s, hi = e;
      while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if (key[pad32(mid)] < top) lo = mid + 1;
        else hi = mid;
      }
      static_cast<int*>(out_row)[r] = lo;
      break;
    }
    case OP_MEDIAN:  // the lower median
      static_cast<K*>(out_row)[r] = key[pad32(s + (c - 1) / 2)];
      break;
    default:
      break;
  }
}

// Every requested tail of one sorted row: v[] holds the thread's L lanes
// (t*L ..), lanes past T are PAD_LANE.  Writes og/ov rows at `row` and
// oc[row].
template <typename K, int L>
__device__ void row_tails(const u64 (&v)[L], int T, const OpList& ops,
                          long long row, int* og, int* oc, bool vec,
                          unsigned char* dyn, ScanSmem& sm) {
  const int t = threadIdx.x, n = blockDim.x, Tp = n * L, base = t * L;
  const int cap = Tp / 4;  // emit ranks staged at a time
  TailSmem<K> ts;
  ts.key = reinterpret_cast<K*>(dyn);
  ts.grp = reinterpret_cast<int*>(dyn) + pad32(Tp);
  ts.end = ts.grp + pad32(Tp);
  ts.psum = reinterpret_cast<unsigned*>(ts.end + cap + 1);
  ts.pdc = ts.psum + cap + 1;

  // the sorted lanes by lane; v[] dies here, and the marks read the
  // neighbouring lanes from shared memory
#pragma unroll
  for (int j = 0; j < L; ++j) {
    ts.key[pad32(base + j)] = KeyCode<K>::dec(static_cast<unsigned>(v[j]));
    ts.grp[pad32(base + j)] = group_of(v[j]);
  }
  __syncthreads();

  // bit j of stm / emm / dm: lane base+j starts a segment / ends a
  // non-pad segment (emits) / starts a run of equal keys.  Partly unrolled:
  // a full unroll hoists every lane's loads and spills at L = 16.
  unsigned stm = 0, pm = 0, dm = 0;
  Sum3 x = {0, 0, 0};
  int gp = base > 0 ? ts.grp[pad32(base - 1)] : 0;
  K kp = base > 0 ? ts.key[pad32(base - 1)] : K(0);
#pragma unroll 4
  for (int j = 0; j < L; ++j) {
    const int i = base + j;
    const int gi = ts.grp[pad32(i)];
    const K ki = ts.key[pad32(i)];
    const bool st = i == 0 || gi != gp;
    const bool dd = st || ki != kp;
    stm |= static_cast<unsigned>(st) << j;
    pm |= static_cast<unsigned>(gi == PAD_GROUP) << j;
    dm |= static_cast<unsigned>(dd) << j;
    x.d += dd;
    if (!KeyCode<K>::kFloat) x.p += static_cast<unsigned>(ki);
    gp = gi;
    kp = ki;
  }
  // a lane ends its segment where the next lane starts one
  const bool last_end = base + L == Tp || ts.grp[pad32(base + L)] != gp;
  const unsigned emm =
      ((stm >> 1) | (static_cast<unsigned>(last_end) << (L - 1))) & ~pm;
  x.r = __popc(emm);
  Sum3 tot;
  const Sum3 ex = block_excl3(x, tot, sm);
  const int cnt = static_cast<int>(tot.r);
  const long long obase = row * T;

  for (int c0 = 0; c0 < cnt; c0 += cap) {
    // stage the ends of ranks c0-1 .. c0+cap-1
    unsigned r = ex.r, p = ex.p, dc = ex.d;
#pragma unroll 4
    for (int j = 0; j < L; ++j) {
      if (!KeyCode<K>::kFloat)
        p += static_cast<unsigned>(ts.key[pad32(base + j)]);
      dc += (dm >> j) & 1;
      if ((emm >> j) & 1) {
        const int q = static_cast<int>(r) - c0 + 1;
        if (q >= 0 && q <= cap) {
          ts.end[q] = base + j;
          ts.psum[q] = p;
          ts.pdc[q] = dc;
        }
        ++r;
      }
    }
    if (c0 == 0 && t == 0) {
      ts.end[0] = -1;
      ts.psum[0] = 0;
      ts.pdc[0] = 0;
    }
    __syncthreads();
    const int hi = min(c0 + cap, cnt);
    for (int rr = c0 + t; rr < hi; rr += n) {
      const int q = rr - c0 + 1;
      const int e = ts.end[q], s = ts.end[q - 1] + 1;
      const unsigned psum = ts.psum[q] - ts.psum[q - 1];
      const int dcount = static_cast<int>(ts.pdc[q] - ts.pdc[q - 1]);
      og[obase + rr] = ts.grp[pad32(e)];
      for (int o = 0; o < ops.n; ++o)
        if (!by_scan<K>(ops.code[o]))
          rank_value<K>(ops.code[o],
                        static_cast<int*>(ops.out[o]) + obase, rr, ts.key,
                        s, e, psum, dcount);
    }
    __syncthreads();
  }
  fill_tail(og + obase, cnt, T, PAD_GROUP, vec);
  for (int o = 0; o < ops.n; ++o)
    fill_tail(static_cast<int*>(ops.out[o]) + obase, cnt, T, 0, vec);

  // the ordered float reductions; every lane's key is in shared memory
  for (int o = 0; o < ops.n; ++o) {
    const int code = ops.code[o];
    if (!by_scan<K>(code)) continue;
    const int rank = static_cast<int>(ex.r);
    if (code == OP_VARIANCE)
      scan_tail<Comb<OP_VARIANCE, K>, L>(
          ts.key, stm, emm, rank, static_cast<float*>(ops.out[o]) + obase, sm);
    else if (code == OP_MEAN)
      scan_tail<Comb<OP_MEAN, K>, L>(
          ts.key, stm, emm, rank, static_cast<float*>(ops.out[o]) + obase, sm);
    else
      scan_tail<Comb<OP_SUM, K>, L>(
          ts.key, stm, emm, rank,
          static_cast<typename Comb<OP_SUM, K>::Out*>(ops.out[o]) + obase, sm);
  }
  if (t == 0) oc[row] = cnt;
}

// ---------------------------------------------------------------- kernels

// One block a row of T lanes, padded to blockDim.x * L (>= 32 L) with
// PAD_LANE.  MAXT: the most threads the instantiation is launched with;
// registers are held to 64 a thread so an SM takes 1024 threads' blocks.
template <typename K, int L, int MAXT>
__global__ void __launch_bounds__(MAXT, 1024 / MAXT)
swag_rows_kernel(const int* __restrict__ g, const K* __restrict__ k,
                 long long stride, int T, int run, OpList ops,
                 int* __restrict__ og, int* __restrict__ oc, int vec_in,
                 int vec_out) {
  extern __shared__ __align__(16) unsigned char dyn[];
  __shared__ ScanSmem sm;
  u64* s = reinterpret_cast<u64*>(dyn);
  const long long row = blockIdx.x;
  const int* gr = g + row * stride;
  const unsigned* kr = reinterpret_cast<const unsigned*>(k) + row * stride;
  const int t = threadIdx.x, n = blockDim.x, Tp = n * L, base = t * L;
  u64 v[L];
  if (run < L) {
    // unsorted rows (or runs shorter than a thread's lanes): sort
    if (vec_in && base + L <= T) {
#pragma unroll
      for (int q = 0; q < L / 4; ++q) {
        const int4 gq = __ldg(reinterpret_cast<const int4*>(gr + base) + q);
        const int4 kq = __ldg(reinterpret_cast<const int4*>(kr + base) + q);
        v[4 * q] = pack(gq.x, KeyCode<K>::enc(kq.x));
        v[4 * q + 1] = pack(gq.y, KeyCode<K>::enc(kq.y));
        v[4 * q + 2] = pack(gq.z, KeyCode<K>::enc(kq.z));
        v[4 * q + 3] = pack(gq.w, KeyCode<K>::enc(kq.w));
      }
    } else {
#pragma unroll
      for (int j = 0; j < L; ++j) {
        const int i = base + j;
        v[j] = i < T ? pack(gr[i], KeyCode<K>::enc(kr[i])) : PAD_LANE;
      }
    }
    block_sort_packed<L>(v, s);
  } else {
    for (int i = t; i < Tp; i += n)
      s[pad64(i)] = i < T ? pack(gr[i], KeyCode<K>::enc(kr[i])) : PAD_LANE;
    __syncthreads();
    block_merge_packed<L>(v, s, run);
  }
  __syncthreads();  // the tails reuse the row's shared memory
  row_tails<K, L>(v, T, ops, row, og, oc, vec_out != 0, dyn, sm);
}

// One block a pane row of T lanes: the register sort of swag_rows_kernel
// over packed (group, ExactCode key) words, padded to blockDim.x * L lanes
// with PAD_LANE, then unpacked and stored (16 bytes a store where the row
// allows it).  Equal words are the same (group, key) pair, so any order of
// ties gives the same row.
template <typename K, int L, int MAXT>
__global__ void __launch_bounds__(MAXT, 1024 / MAXT)
sort_rows_kernel(const int* __restrict__ g, const K* __restrict__ k, int T,
                 int* __restrict__ og, K* __restrict__ ok, int vec) {
  extern __shared__ __align__(16) unsigned char dyn[];
  u64* s = reinterpret_cast<u64*>(dyn);
  const long long row = static_cast<long long>(blockIdx.x) * T;
  const int* gr = g + row;
  const unsigned* kr = reinterpret_cast<const unsigned*>(k) + row;
  const int base = threadIdx.x * L;
  const bool full = vec && base + L <= T;
  u64 v[L];
  if (full) {
#pragma unroll
    for (int q = 0; q < L / 4; ++q) {
      const int4 gq = __ldg(reinterpret_cast<const int4*>(gr + base) + q);
      const int4 kq = __ldg(reinterpret_cast<const int4*>(kr + base) + q);
      v[4 * q] = pack(gq.x, ExactCode<K>::enc(kq.x));
      v[4 * q + 1] = pack(gq.y, ExactCode<K>::enc(kq.y));
      v[4 * q + 2] = pack(gq.z, ExactCode<K>::enc(kq.z));
      v[4 * q + 3] = pack(gq.w, ExactCode<K>::enc(kq.w));
    }
  } else {
#pragma unroll
    for (int j = 0; j < L; ++j) {
      const int i = base + j;
      v[j] = i < T ? pack(gr[i], ExactCode<K>::enc(kr[i])) : PAD_LANE;
    }
  }
  block_sort_packed<L>(v, s);
  int* go = og + row;
  unsigned* ko = reinterpret_cast<unsigned*>(ok) + row;
  if (full) {
#pragma unroll
    for (int q = 0; q < L / 4; ++q) {
      const int j = 4 * q;
      reinterpret_cast<int4*>(go + base)[q] = make_int4(
          group_of(v[j]), group_of(v[j + 1]), group_of(v[j + 2]),
          group_of(v[j + 3]));
      reinterpret_cast<uint4*>(ko + base)[q] = make_uint4(
          ExactCode<K>::dec(static_cast<unsigned>(v[j])),
          ExactCode<K>::dec(static_cast<unsigned>(v[j + 1])),
          ExactCode<K>::dec(static_cast<unsigned>(v[j + 2])),
          ExactCode<K>::dec(static_cast<unsigned>(v[j + 3])));
    }
  } else {
#pragma unroll
    for (int j = 0; j < L; ++j) {
      const int i = base + j;
      if (i < T) {
        go[i] = group_of(v[j]);
        ko[i] = ExactCode<K>::dec(static_cast<unsigned>(v[j]));
      }
    }
  }
}

template <typename Kern>
cudaError_t allow_smem(Kern kern, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

// Launch shape of a window row of T lanes: L lanes a thread (8 up to 1024
// lanes, 16 above), threads = max(T, 32 L) / L, and the dynamic shared
// memory: the larger of the sort's padded row and the tails' keys and
// groups plus their rank staging.
struct RowGeometry { int lanes, threads; size_t smem; };

RowGeometry row_geometry(int T) {
  RowGeometry r;
  r.lanes = T <= 1024 ? 8 : 16;
  const int tp = T > 32 * r.lanes ? T : 32 * r.lanes;
  r.threads = tp / r.lanes;
  const size_t sort = 8 * static_cast<size_t>(pad64(tp));
  const size_t tails = 8 * static_cast<size_t>(pad32(tp)) +
                       12 * static_cast<size_t>(tp / 4 + 1);
  r.smem = sort > tails ? sort : tails;
  return r;
}

template <typename K, int L, int MAXT>
cudaError_t launch_rows(const int* g, const void* k, long long stride,
                        int nrows, int T, int run, const OpList& ops, int* og,
                        int* oc, cudaStream_t st) {
  const RowGeometry geo = row_geometry(T);
  auto kern = swag_rows_kernel<K, L, MAXT>;
  cudaError_t err = allow_smem(kern, geo.smem);
  if (err != cudaSuccess) return err;
  const int vec_in = aligned16(g) && aligned16(k) && stride % 4 == 0;
  int vec_out = T % 4 == 0 && aligned16(og);
  for (int i = 0; i < ops.n; ++i) vec_out = vec_out && aligned16(ops.out[i]);
  kern<<<nrows, geo.threads, geo.smem, st>>>(
      g, static_cast<const K*>(k), stride, T, run, ops, og, oc, vec_in,
      vec_out);
  return cudaGetLastError();
}

template <typename K>
cudaError_t dispatch_rows(const int* g, const void* k, long long stride,
                          int nrows, int T, int run, const OpList& ops,
                          int* og, int* oc, cudaStream_t st) {
  if (T <= 1024)
    return launch_rows<K, 8, 128>(g, k, stride, nrows, T, run, ops, og, oc, st);
  if (T <= 4096)
    return launch_rows<K, 16, 256>(g, k, stride, nrows, T, run, ops, og, oc, st);
  return launch_rows<K, 16, 1024>(g, k, stride, nrows, T, run, ops, og, oc, st);
}

template <typename K, int L, int MAXT>
cudaError_t launch_sort(const int* g, const void* k, int nrows, int T,
                        int* og, void* ok, cudaStream_t st) {
  const RowGeometry geo = row_geometry(T);
  // the sort's padded row only; the tails' staging is not needed
  const size_t smem = 8 * static_cast<size_t>(pad64(geo.threads * L));
  auto kern = sort_rows_kernel<K, L, MAXT>;
  cudaError_t err = allow_smem(kern, smem);
  if (err != cudaSuccess) return err;
  const int vec = T % 4 == 0 && aligned16(g) && aligned16(k) &&
                  aligned16(og) && aligned16(ok);
  kern<<<nrows, geo.threads, smem, st>>>(
      g, static_cast<const K*>(k), T, og, static_cast<K*>(ok), vec);
  return cudaGetLastError();
}

template <typename K>
cudaError_t dispatch_sort(const int* g, const void* k, int nrows, int T,
                          int* og, void* ok, cudaStream_t st) {
  if (T <= 1024) return launch_sort<K, 8, 128>(g, k, nrows, T, og, ok, st);
  if (T <= 4096) return launch_sort<K, 16, 256>(g, k, nrows, T, og, ok, st);
  return launch_sort<K, 16, 1024>(g, k, nrows, T, og, ok, st);
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

// The launch shape rt_swag_rows takes for rows of T lanes.
extern "C" int rt_swag_geometry(int T, int* lanes, int* threads,
                                long long* smem) {
  using namespace rt;
  if (!row_ok(1, T)) return cudaErrorInvalidValue;
  const RowGeometry geo = row_geometry(T);
  *lanes = geo.lanes;
  *threads = geo.threads;
  *smem = static_cast<long long>(geo.smem);
  return cudaSuccess;
}

extern "C" int rt_sort_rows(const int* g, const void* k, int key_type,
                            int nrows, int T, int* og, void* ok,
                            void* stream) {
  using namespace rt;
  if (!row_ok(nrows, T)) return cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
  if (key_type == KEY_INT32) return dispatch_sort<int>(g, k, nrows, T, og, ok, st);
  if (key_type == KEY_FLOAT32)
    return dispatch_sort<float>(g, k, nrows, T, og, ok, st);
  return cudaErrorInvalidValue;
}
