// Per-group windows on the shared pane store: the placement scan, the
// fused push + partial evaluation, and the merge-replay tails.
//
// Replaces, in src/repro/kernels/swag/kernel.py (the JAX package's Pallas
// TPU kernels):
//   * pergroup_fused_pallas  -> pergroup_fused_kernel;
//   * pergroup_replay_pallas -> pergroup_replay_kernel;
// and, with no TPU kernel behind it, the XLA lax.scan of _push_decide
// (src/repro/core/panestore.py) -> pergroup_scan_kernel.
//
// pergroup_scan_kernel — one warp for the whole stream.  Placement is
// sequential (each tuple's slot depends on the global eviction order), so
// one warp holds the [C] directory (owner, count, base, stamp) in
// registers, lane l owning slots l, l+32, ... (up to 32 a lane; larger
// stores spill to local memory).  Per tuple, single-instruction warp
// reductions (__reduce_*_sync) give the group's newest slot (first max
// base), the first free slot and the oldest slot (first min stamp); the
// owning lane applies the update and every lane retires the group's stale
// panes in its own registers.  It records each tuple's (slot, lane, seq),
// the directory after every WA chunk and the evictions and retirements of
// the scan; given keys it also keeps the
// [C, WA] ring in device memory (L2), sorts a pane by (key, seq) when it
// closes, and after every chunk eight warps copy the ring out.  Bound:
// the latency of one warp, some hundred cycles a tuple; bytes are ~20 a
// tuple, so the card's memory is idle.
//
// pergroup_fused_kernel — one persistent block loops over the NE chunks in
// order, in place of the TPU kernel's sequential grid with the ring in
// VMEM scratch.  The ring is C*WA*8 bytes (299,008 at C = 292, WA = 128),
// above the 232,448 a block may hold, so it lives in device memory and
// stays in L2.  Per chunk: the WA writes in parallel, where of several
// writes to one (slot, lane) only the chunk's last lands (an atomicMax of
// the writer's stream index into a tag per lane: the TPU kernel's in-order
// loop); the panes the plan marks as closing sorted by (key, seq), one
// warp a pane; per-slot partials of the live lanes (one warp a slot);
// per-row combination over the slots of each group.  Bound: one SM and L2
// latency; the other 131 SMs idle.
//
// pergroup_replay_kernel — one block per replay row of S*WA lanes: dead
// lanes become the key sentinel, the row is sorted (no merge: every tail
// depends only on the live multiset, and the live keys are the first cnt
// lanes of the sorted row), then count, sum, min, max, mean, lower median
// and distinct count off the sorted live prefix.  Rows with no live lane
// (free candidate rows, most of them) write zeros and stop.  Bound: shared
// memory passes of the sort, log2(L)(log2(L)+1)/2 barriers a live row;
// bytes are 8 per lane read.
#include "tile.cuh"

namespace rt {
namespace {

template <typename K> __device__ __forceinline__ K key_max();
template <> __device__ __forceinline__ int key_max<int>() { return 0x7fffffff; }
template <> __device__ __forceinline__ float key_max<float>() { return __int_as_float(0x7f800000); }
template <typename K> __device__ __forceinline__ K key_min();
template <> __device__ __forceinline__ int key_min<int>() { return SHIFT_FILL; }
template <> __device__ __forceinline__ float key_min<float>() { return __int_as_float(0xff800000); }

// (value, index) reductions across a warp: the first index of the maximum
// (resp. minimum), as jnp.argmax / jnp.argmin pick.
__device__ __forceinline__ void warp_argmax(int& v, int& i) {
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) {
    const int ov = __shfl_xor_sync(FULL_MASK, v, d);
    const int oi = __shfl_xor_sync(FULL_MASK, i, d);
    if (ov > v || (ov == v && oi < i)) { v = ov; i = oi; }
  }
}
__device__ __forceinline__ void warp_argmin(int& v, int& i) {
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) {
    const int ov = __shfl_xor_sync(FULL_MASK, v, d);
    const int oi = __shfl_xor_sync(FULL_MASK, i, d);
    if (ov < v || (ov == v && oi < i)) { v = ov; i = oi; }
  }
}
__device__ __forceinline__ int warp_min(int v) {
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) v = min(v, __shfl_xor_sync(FULL_MASK, v, d));
  return v;
}
__device__ __forceinline__ int warp_max(int v) {
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) v = max(v, __shfl_xor_sync(FULL_MASK, v, d));
  return v;
}

template <typename K>
__device__ __forceinline__ bool key_seq_less(K ka, int sa, K kb, int sb) {
  return ka < kb || (!(kb < ka) && sa < sb);
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
struct BlockSync { __device__ void operator()() const { __syncthreads(); } };

// ------------------------------------------------------- placement scan

struct ScanArgs {
  const int* g;       // [NE*WA] group ids
  const void* k;      // [NE*WA] keys, or null: no ring
  int ne, wa, c;
  const int* pg;      // [npg, 2] sorted (group id, ws) overrides
  int npg, default_ws;
  int* dir;           // [4, C] owner, count, base, stamp (in/out)
  int* clock;         // [1] (in/out)
  void* ring_k;       // [C, WA] (in/out) when k
  int* ring_s;        // [C, WA] (in/out) when k
  int* plan;          // [3, NE, WA] slot, lane, seq of every tuple
  int* snaps;         // [4, NE, C] the directory after every chunk
  int* clock_s;       // [NE]
  void* rk_s;         // [NE, C, WA] the ring after every chunk, when k
  int* rs_s;          // [NE, C, WA]
  int* events;        // [2] evictions, retirements (out)
};

// Threads of the scan block: the scanning warp, plus seven that help copy
// the ring after every chunk when the scan keeps it.
constexpr int SCAN_RING_THREADS = 256;
constexpr int MAX_SCAN_SLOTS = 128 * 32;

// The ring after chunk e, copied by every thread of the block (16 bytes a
// load when the row length allows).
template <typename K>
__device__ void copy_ring(const K* ring_k, const int* ring_s, K* rk, int* rs,
                          long long cw) {
  if ((cw & 3) == 0) {
    const long long n4 = cw >> 2;
    const int4* sk = reinterpret_cast<const int4*>(ring_k);
    const int4* ss = reinterpret_cast<const int4*>(ring_s);
    int4* dk = reinterpret_cast<int4*>(rk);
    int4* ds = reinterpret_cast<int4*>(rs);
    for (long long x = threadIdx.x; x < n4; x += blockDim.x) {
      dk[x] = sk[x];
      ds[x] = ss[x];
    }
  } else {
    for (long long x = threadIdx.x; x < cw; x += blockDim.x) {
      rk[x] = ring_k[x];
      rs[x] = ring_s[x];
    }
  }
}

// J: slots a lane holds in registers (slot j * 32 + lane for j < J).
template <typename K, int J>
__global__ void __launch_bounds__(SCAN_RING_THREADS)
pergroup_scan_kernel(ScanArgs a) {
  extern __shared__ __align__(16) unsigned char dyn[];
  const int C = a.c, WA = a.wa;
  int* sseq = reinterpret_cast<int*>(dyn);        // [WA] sort buffer
  K* skey = reinterpret_cast<K*>(sseq + WA);      // [WA]
  const int lane = threadIdx.x & 31;
  const K* keys = static_cast<const K*>(a.k);
  K* ring_k = static_cast<K*>(a.ring_k);
  const bool ring = keys != nullptr;
  const long long cw = static_cast<long long>(C) * WA;
  const long long nc = static_cast<long long>(a.ne) * C;

  if (threadIdx.x >= 32) {  // helpers: the ring copy after every chunk
    for (int e = 0; e < a.ne; ++e) {
      __syncthreads();
      copy_ring<K>(ring_k, a.ring_s, static_cast<K*>(a.rk_s) + e * cw,
                   a.rs_s + e * cw, cw);
      __syncthreads();
    }
    return;
  }

  int own[J], cnt[J], bas[J], stp[J];
#pragma unroll
  for (int j = 0; j < J; ++j) {
    const int s = j * 32 + lane;
    const bool have = s < C;
    own[j] = have ? a.dir[s] : PAD_GROUP;
    cnt[j] = have ? a.dir[C + s] : 0;
    bas[j] = have ? a.dir[2 * C + s] : 0;
    stp[j] = have ? a.dir[3 * C + s] : -1;
  }
  int clock = a.clock[0];
  int evictions = 0, retired = 0;  // retired: this lane's slots

  const long long n = static_cast<long long>(a.ne) * WA;
  int gl = 0, my_slot = 0, my_lane = 0, my_seq = 0;
  K kl = K(0);
  for (long long i = 0; i < n; ++i) {
    const int w = static_cast<int>(i & 31);
    if (w == 0 && i + lane < n) {  // the next 32 tuples, one per lane
      gl = a.g[i + lane];
      if (ring) kl = keys[i + lane];
    }
    const int gi = __shfl_sync(FULL_MASK, gl, w);

    // the group's newest slot (first max base), the first free slot and
    // the oldest slot (first min stamp)
    int nv = SHIFT_FILL, ni = 0x7fffffff;
    int ov = 0x7fffffff, oi = 0x7fffffff;
    int fi = 0x7fffffff;
#pragma unroll
    for (int j = 0; j < J; ++j) {
      const int s = j * 32 + lane;
      if (s < C) {
        const int v = own[j] == gi ? bas[j] : -1;
        if (v > nv) { nv = v; ni = s; }
        const bool fr = own[j] == PAD_GROUP;
        if (fr && fi == 0x7fffffff) fi = s;
        const int sv = fr ? 0x7fffffff : stp[j];
        if (sv < ov || oi == 0x7fffffff) { ov = sv; oi = s; }
      }
    }
    const int nmax = __reduce_max_sync(FULL_MASK, nv);
    const int newest = __reduce_min_sync(FULL_MASK, nv == nmax ? ni : 0x7fffffff);
    const int omin = __reduce_min_sync(FULL_MASK, ov);
    const int oldest = __reduce_min_sync(FULL_MASK, ov == omin ? oi : 0x7fffffff);
    const int first_free = __reduce_min_sync(FULL_MASK, fi);
    const bool any_mine = nmax >= 0;  // bases are never negative
    int ws_g = a.default_ws;
    if (a.npg > 0) {  // the last matching override wins
      int pi = -1;
      for (int p = lane; p < a.npg; p += 32)
        if (a.pg[2 * p] == gi) pi = p;
      pi = __reduce_max_sync(FULL_MASK, pi);
      if (pi >= 0) ws_g = a.pg[2 * pi + 1];
    }

    int cn_l = 0, bn_l = 0;
#pragma unroll
    for (int j = 0; j < J; ++j)
      if (j == (newest >> 5)) { cn_l = cnt[j]; bn_l = bas[j]; }
    const int cn = __shfl_sync(FULL_MASK, cn_l, newest & 31);
    const int bn = __shfl_sync(FULL_MASK, bn_l, newest & 31);
    const int m_g = any_mine ? bn + cn : 0;
    const bool has_open = any_mine && cn < WA;
    const int slot = has_open ? newest
                              : (first_free != 0x7fffffff ? first_free : oldest);
    const int ln = has_open ? cn : 0;
    const int new_cs = has_open ? cn + 1 : 1;
    const int horizon = m_g + 1 - ws_g;
#pragma unroll
    for (int j = 0; j < J; ++j) {
      if (j * 32 + lane == slot) {
        cnt[j] = new_cs;
        if (!has_open) { own[j] = gi; bas[j] = m_g; stp[j] = clock; }
      }
      // retire this group's panes that no longer intersect its last WS_g
      if (j * 32 + lane < C && own[j] == gi && bas[j] + WA <= horizon) {
        ++retired;
        own[j] = PAD_GROUP;
        cnt[j] = 0;
        stp[j] = -1;
      }
    }
    if (!has_open) ++clock;
    if (!has_open && first_free == 0x7fffffff) ++evictions;
    if (lane == w) { my_slot = slot; my_lane = ln; my_seq = m_g; }
    if (ring) {
      const K kv = __shfl_sync(FULL_MASK, kl, w);
      const long long row = static_cast<long long>(slot) * WA;
      if (lane == 0) {
        ring_k[row + ln] = kv;
        a.ring_s[row + ln] = m_g;
      }
      if (new_cs == WA) {  // sort the pane once, when it closes
        __syncwarp();
        for (int l = lane; l < WA; l += 32) {
          skey[l] = ring_k[row + l];
          sseq[l] = a.ring_s[row + l];
        }
        __syncwarp();
        sort_key_seq<K>(skey, sseq, WA, lane, 32, WarpSync());
        for (int l = lane; l < WA; l += 32) {
          ring_k[row + l] = skey[l];
          a.ring_s[row + l] = sseq[l];
        }
      }
      __syncwarp();
    }

    if (w == 31 || i == n - 1) {  // flush the plan of the last 32 tuples
      const long long t = i - w + lane;
      if (lane <= w) {
        a.plan[t] = my_slot;
        a.plan[n + t] = my_lane;
        a.plan[2 * n + t] = my_seq;
      }
    }
    if (((i + 1) & (WA - 1)) == 0) {  // chunk end: snapshot the store
      const long long e = i / WA;
#pragma unroll
      for (int j = 0; j < J; ++j) {
        const int s = j * 32 + lane;
        if (s < C) {
          a.snaps[e * C + s] = own[j];
          a.snaps[nc + e * C + s] = cnt[j];
          a.snaps[2 * nc + e * C + s] = bas[j];
          a.snaps[3 * nc + e * C + s] = stp[j];
        }
      }
      if (lane == 0) a.clock_s[e] = clock;
      if (ring) {
        __syncthreads();
        copy_ring<K>(ring_k, a.ring_s, static_cast<K*>(a.rk_s) + e * cw,
                     a.rs_s + e * cw, cw);
        __syncthreads();
      }
    }
  }
#pragma unroll
  for (int j = 0; j < J; ++j) {
    const int s = j * 32 + lane;
    if (s < C) {
      a.dir[s] = own[j];
      a.dir[C + s] = cnt[j];
      a.dir[2 * C + s] = bas[j];
      a.dir[3 * C + s] = stp[j];
    }
  }
  retired = __reduce_add_sync(FULL_MASK, retired);
  if (lane == 0) {
    a.clock[0] = clock;
    a.events[0] = evictions;
    a.events[1] = retired;
  }
}

// ------------------------------------------------- fused push + partials

struct FusedArgs {
  const void* ck;                           // [NE, WA] keys
  const int *slots, *lanes, *seqs;          // [NE, WA]
  const int *own, *cnt, *lo, *sortmask, *ug;  // [NE, C]
  int ne, wa, c;
  void* ring_k;                             // [C, WA] scratch, zeroed
  int* ring_s;                              // [C, WA] scratch, zeroed
  int* tag;                                 // [C, WA] scratch, all -1
  int nbuf;                                 // warps with a sort buffer
};

constexpr int FUSED_THREADS = 1024;

template <typename K>
__global__ void __launch_bounds__(FUSED_THREADS)
pergroup_fused_kernel(FusedArgs a, OpList ops) {
  using Acc = K;  // int32 sums wrap; float32 sums stay float32
  extern __shared__ __align__(16) unsigned char dyn[];
  const int C = a.c, WA = a.wa;
  int* s_own = reinterpret_cast<int*>(dyn);          // [C]
  int* s_pc = s_own + C;                             // [C]
  int* s_mark = s_pc + C;                            // [C]
  Acc* s_psum = reinterpret_cast<Acc*>(s_mark + C);  // [C]
  K* s_pmin = reinterpret_cast<K*>(s_psum + C);      // [C]
  K* s_pmax = s_pmin + C;                            // [C]
  int* s_seq = reinterpret_cast<int*>(s_pmax + C);   // [nbuf, WA]
  K* s_key = reinterpret_cast<K*>(s_seq + a.nbuf * WA);  // [nbuf, WA]
  __shared__ int nmark;
  const K* ck = static_cast<const K*>(a.ck);
  K* ring_k = static_cast<K*>(a.ring_k);
  const int tid = threadIdx.x, nt = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, nwarps = nt >> 5;
  const K hi = key_max<K>(), lo_sent = key_min<K>();

  for (int e = 0; e < a.ne; ++e) {
    const long long ew = static_cast<long long>(e) * WA;
    const long long ec = static_cast<long long>(e) * C;
    for (int s = tid; s < C; s += nt) s_own[s] = a.own[ec + s];
    if (tid == 0) nmark = 0;
    // of several writes to one (slot, lane) the chunk's last wins: each
    // lane's tag is the stream index of its latest writer
    for (int t = tid; t < WA; t += nt)
      atomicMax(a.tag + static_cast<long long>(a.slots[ew + t]) * WA +
                    a.lanes[ew + t],
                static_cast<int>(ew + t));
    __syncthreads();
    for (int t = tid; t < WA; t += nt) {
      const long long at = static_cast<long long>(a.slots[ew + t]) * WA +
                           a.lanes[ew + t];
      if (a.tag[at] == static_cast<int>(ew + t)) {
        ring_k[at] = ck[ew + t];
        a.ring_s[at] = a.seqs[ew + t];
      }
    }
    for (int s = tid; s < C; s += nt)
      if (a.sortmask[ec + s] != 0) s_mark[atomicAdd(&nmark, 1)] = s;
    __syncthreads();
    // the panes that closed in this chunk, sorted by (key, seq), one warp
    // a pane
    const int nm = nmark;
    if (warp < a.nbuf) {
      K* bk = s_key + warp * WA;
      int* bs = s_seq + warp * WA;
      for (int m = warp; m < nm; m += a.nbuf) {
        const long long row = static_cast<long long>(s_mark[m]) * WA;
        for (int l = lane; l < WA; l += 32) {
          bk[l] = ring_k[row + l];
          bs[l] = a.ring_s[row + l];
        }
        __syncwarp();
        sort_key_seq<K>(bk, bs, WA, lane, 32, WarpSync());
        for (int l = lane; l < WA; l += 32) {
          ring_k[row + l] = bk[l];
          a.ring_s[row + l] = bs[l];
        }
        __syncwarp();
      }
    }
    __syncthreads();
    // per-slot partials of the live lanes, one warp a slot; four loads a
    // lane in flight at once
    for (int s = warp; s < C; s += nwarps) {
      const bool occ = s_own[s] != PAD_GROUP;
      const int cs = occ ? min(a.cnt[ec + s], WA) : 0;
      const int los = a.lo[ec + s];
      const long long row = static_cast<long long>(s) * WA;
      int pc = 0;
      Acc ps = Acc(0);
      K pmin = hi, pmax = lo_sent;
      for (int l0 = 0; l0 < cs; l0 += 128) {
        int sq[4];
        K kv[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int l = l0 + q * 32 + lane;
          sq[q] = l < cs ? a.ring_s[row + l] : 0;
          kv[q] = l < cs ? ring_k[row + l] : K(0);
        }
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          if (l0 + q * 32 + lane < cs && sq[q] >= los) {
            ++pc;
            ps = add_wrap(ps, kv[q]);
            pmin = kv[q] < pmin ? kv[q] : pmin;
            pmax = pmax < kv[q] ? kv[q] : pmax;
          }
        }
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
    // every output row: its group's slots combined
    for (int r = tid; r < C; r += nt) {
      const int u = a.ug[ec + r];
      int cnt = 0;
      Acc sum = Acc(0);
      K vmin = hi, vmax = lo_sent;
      if (u != PAD_GROUP) {
        for (int s = 0; s < C; ++s) {
          if (s_own[s] == u) {
            cnt += s_pc[s];
            sum = add_wrap(sum, s_psum[s]);
            vmin = s_pmin[s] < vmin ? s_pmin[s] : vmin;
            vmax = vmax < s_pmax[s] ? s_pmax[s] : vmax;
          }
        }
      }
      for (int o = 0; o < ops.n; ++o) {
        void* out = ops.out[o];
        const long long at = ec + r;
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
    __syncthreads();
  }
}

// ------------------------------------------------------ merge-replay tails

template <typename T>
__device__ T block_sum(T v, T* scratch) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) v = add_wrap(v, __shfl_xor_sync(FULL_MASK, v, d));
  if (lane == 0) scratch[warp] = v;
  __syncthreads();
  T t = T(0);
  if (threadIdx.x == 0)
    for (int w = 0; w < static_cast<int>(blockDim.x >> 5); ++w) t = add_wrap(t, scratch[w]);
  __syncthreads();
  return t;  // in thread 0
}

template <typename K>
__global__ void __launch_bounds__(1024)
pergroup_replay_kernel(const K* __restrict__ rk, const int* __restrict__ rv,
                       int L, OpList ops) {
  extern __shared__ __align__(16) unsigned char dyn[];
  K* sk = reinterpret_cast<K*>(dyn);
  __shared__ int cnt_s;
  __shared__ K ksum[32];
  __shared__ int isum[32];
  const long long row = blockIdx.x;
  const K* kr = rk + row * L;
  const int* vr = rv + row * L;
  const K sent = key_max<K>();
  if (threadIdx.x == 0) cnt_s = 0;
  __syncthreads();
  int live = 0;
  for (int i = threadIdx.x; i < L; i += blockDim.x) {
    const bool v = vr[i] != 0;
    sk[i] = v ? kr[i] : sent;
    live += v ? 1 : 0;
  }
  if (live) atomicAdd(&cnt_s, live);
  __syncthreads();
  const int cnt = cnt_s;
  K sum = K(0);
  int dc = 0;
  if (cnt > 0) {
    for (int kk = 2; kk <= L; kk <<= 1) {
      for (int j = kk >> 1; j > 0; j >>= 1) {
        for (int p = threadIdx.x; p < L / 2; p += blockDim.x) {
          const int i = ((p & ~(j - 1)) << 1) | (p & (j - 1));
          const int q = i + j;
          const bool up = (i & kk) == 0;
          const K a = sk[i], b = sk[q];
          if (up ? b < a : a < b) { sk[i] = b; sk[q] = a; }
        }
        __syncthreads();
      }
    }
    K ps = K(0);
    int pd = 0;
    for (int i = threadIdx.x; i < cnt; i += blockDim.x) {
      ps = add_wrap(ps, sk[i]);
      pd += sk[i] != (i == 0 ? sent : sk[i - 1]) ? 1 : 0;
    }
    sum = block_sum<K>(ps, ksum);
    dc = block_sum<int>(pd, isum);
  }
  if (threadIdx.x != 0) return;
  for (int o = 0; o < ops.n; ++o) {
    void* out = ops.out[o];
    switch (ops.code[o]) {
      case OP_COUNT: static_cast<int*>(out)[row] = cnt; break;
      case OP_SUM: static_cast<K*>(out)[row] = sum; break;
      case OP_MEAN:
        static_cast<float*>(out)[row] =
            static_cast<float>(sum) / static_cast<float>(cnt > 1 ? cnt : 1);
        break;
      case OP_MIN: static_cast<K*>(out)[row] = cnt > 0 ? sk[0] : K(0); break;
      case OP_MAX: static_cast<K*>(out)[row] = cnt > 0 ? sk[cnt - 1] : K(0); break;
      case OP_MEDIAN:
        static_cast<K*>(out)[row] = cnt > 0 ? sk[(cnt - 1) / 2] : K(0);
        break;
      case OP_DC: static_cast<int*>(out)[row] = dc; break;
      default: break;
    }
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

template <typename K, int J>
cudaError_t launch_scan_j(const ScanArgs& a, cudaStream_t st) {
  const size_t smem = static_cast<size_t>(a.wa) * 8;
  cudaError_t err = opt_in_smem(pergroup_scan_kernel<K, J>, smem);
  if (err != cudaSuccess) return err;
  const int threads = a.k != nullptr ? SCAN_RING_THREADS : 32;
  pergroup_scan_kernel<K, J><<<1, threads, smem, st>>>(a);
  return cudaGetLastError();
}

// The slots a lane holds, J = ceil(C / 32), rounded up to an instantiated
// width: 10 is the repo's per-group store (C = 292); up to 32 stay in
// registers, 128 spills to local memory.  Without a ring the key type does
// not matter, and the int32 variants run.
template <typename K>
cudaError_t launch_scan(const ScanArgs& a, cudaStream_t st) {
  const int need = (a.c + 31) / 32;
  if (need <= 1) return launch_scan_j<K, 1>(a, st);
  if (need <= 2) return launch_scan_j<K, 2>(a, st);
  if (need <= 4) return launch_scan_j<K, 4>(a, st);
  if (need <= 10) return launch_scan_j<K, 10>(a, st);
  if (need <= 16) return launch_scan_j<K, 16>(a, st);
  if (need <= 32) return launch_scan_j<K, 32>(a, st);
  if (need <= 128) return launch_scan_j<K, 128>(a, st);
  return cudaErrorInvalidValue;
}

// Shared memory of the fused kernel: six [C] columns and `nbuf` [WA] sort
// buffers, as many as fit beside them (one a warp, at least one).
size_t fused_smem(int c, int wa, int* nbuf) {
  const size_t base = static_cast<size_t>(c) * 24;
  const size_t per = static_cast<size_t>(wa) * 8;
  const size_t room = base + per <= 100 * 1024 ? 100 * 1024 - base : per;
  int n = static_cast<int>(room / per);
  n = n < 1 ? 1 : (n > FUSED_THREADS / 32 ? FUSED_THREADS / 32 : n);
  *nbuf = n;
  return base + per * n;
}

template <typename K>
cudaError_t launch_fused(FusedArgs a, const OpList& ops, cudaStream_t st) {
  const size_t smem = fused_smem(a.c, a.wa, &a.nbuf);
  cudaError_t err = opt_in_smem(pergroup_fused_kernel<K>, smem);
  if (err != cudaSuccess) return err;
  pergroup_fused_kernel<K><<<1, FUSED_THREADS, smem, st>>>(a, ops);
  return cudaGetLastError();
}

template <typename K>
cudaError_t launch_replay(const K* rk, const int* rv, int nrows, int L,
                          const OpList& ops, cudaStream_t st) {
  const size_t smem = static_cast<size_t>(L) * sizeof(K);
  cudaError_t err = opt_in_smem(pergroup_replay_kernel<K>, smem);
  if (err != cudaSuccess) return err;
  int threads = L / 2;
  threads = threads < 32 ? 32 : (threads > 1024 ? 1024 : threads);
  pergroup_replay_kernel<K><<<nrows, threads, smem, st>>>(rk, rv, L, ops);
  return cudaGetLastError();
}

}  // namespace
}  // namespace rt

// The placement scan over ne chunks of wa tuples (one warp).  k may be null
// (no ring: ring_k, ring_s, rk_s and rs_s are then unused).  pg holds npg
// sorted (group id, ws) pairs.  dir [4, C] (owner, count, base, stamp) and
// clock [1] are read and written back; plan [3, ne, wa] gets each tuple's
// slot, lane and seq; snaps [4, ne, C] and clock_s [ne] the directory after
// every chunk, rk_s/rs_s [ne, C, wa] the ring after every chunk; events
// [2] the evictions and retirements of the scan.
extern "C" int rt_pergroup_scan(const int* g, const void* k, int key_type,
                                int ne, int wa, int c, const int* pg, int npg,
                                int default_ws, int* dir, int* clock,
                                void* ring_k, int* ring_s, int* plan,
                                int* snaps, int* clock_s, void* rk_s,
                                int* rs_s, int* events, void* stream) {
  using namespace rt;
  if (ne < 1 || !pow2(wa) || wa > MAX_ROW || c < 1 || c > MAX_SCAN_SLOTS ||
      npg < 0 || default_ws < 1)
    return cudaErrorInvalidValue;
  ScanArgs a{g, k, ne, wa, c, pg, npg, default_ws, dir, clock, ring_k, ring_s,
             plan, snaps, clock_s, rk_s, rs_s, events};
  auto st = static_cast<cudaStream_t>(stream);
  if (k == nullptr || key_type == KEY_INT32) return launch_scan<int>(a, st);
  if (key_type == KEY_FLOAT32) return launch_scan<float>(a, st);
  return cudaErrorInvalidValue;
}

// The fused push + partial evaluation over ne chunks (one block); ring_k
// and ring_s are [C, wa] zeroed scratch, tag [C, wa] scratch set to -1.  codes/outs: ops among sum, count,
// min, max, mean, each output [ne, C].
extern "C" int rt_pergroup_fused(const void* ck, const int* slots,
                                 const int* lanes, const int* seqs,
                                 const int* own, const int* cnt, const int* lo,
                                 const int* sortmask, const int* ug,
                                 int key_type, int ne, int wa, int c,
                                 const int* codes, void* const* outs, int nops,
                                 void* ring_k, int* ring_s, int* tag,
                                 void* stream) {
  using namespace rt;
  int nbuf = 0;
  if (ne < 1 || !pow2(wa) || wa > MAX_ROW || c < 1 || !ops_ok(codes, nops, true) ||
      static_cast<long long>(ne) * wa > 0x7fffffffLL ||
      fused_smem(c, wa, &nbuf) > 227 * 1024)
    return cudaErrorInvalidValue;
  FusedArgs a{ck, slots, lanes, seqs, own, cnt, lo, sortmask, ug, ne, wa, c,
              ring_k, ring_s, tag, nbuf};
  const OpList ops = make_ops(codes, outs, nops);
  auto st = static_cast<cudaStream_t>(stream);
  if (key_type == KEY_INT32) return launch_fused<int>(a, ops, st);
  if (key_type == KEY_FLOAT32) return launch_fused<float>(a, ops, st);
  return cudaErrorInvalidValue;
}

// The replay tails over nrows rows of L lanes (one block a row): keys rk,
// liveness rv (int32, nonzero = live).  codes/outs: DIRECT ops (sum,
// count, min, max, mean, median, distinct count), each output [nrows].
extern "C" int rt_pergroup_replay(const void* rk, const int* rv, int key_type,
                                  int nrows, int L, const int* codes,
                                  void* const* outs, int nops, void* stream) {
  using namespace rt;
  if (nrows < 1 || !pow2(L) || L < 2 || L > MAX_ROW || !ops_ok(codes, nops, false))
    return cudaErrorInvalidValue;
  const OpList ops = make_ops(codes, outs, nops);
  auto st = static_cast<cudaStream_t>(stream);
  if (key_type == KEY_INT32)
    return launch_replay<int>(static_cast<const int*>(rk), rv, nrows, L, ops, st);
  if (key_type == KEY_FLOAT32)
    return launch_replay<float>(static_cast<const float*>(rk), rv, nrows, L, ops, st);
  return cudaErrorInvalidValue;
}
