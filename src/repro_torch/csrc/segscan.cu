// Tiled segmented inclusive scan of a combiner state over one stream, one
// pass.
//
// Replaces: src/repro/kernels/segscan/kernel.py, segscan_pallas (the JAX
// package's Pallas TPU kernel, wrapped by segmented_scan_tpu).
//
// What it computes: for flags [N] (1 where a segment starts) and a combiner
// state given as its leaves [N] (struct of arrays, in the JAX treedef's
// order), the inclusive scan of the state within each segment.  The ops are
// sum, min, max, count, mean and distinct count (Comb<OP, K> of tile.cuh);
// distinct count is not commutative, so every combine keeps the earlier
// range on the left.  The last tile may be ragged: its lanes past N are
// masked (they start segments of their own and are not written).
//
// The TPU kernel carries the trailing run of each tile to the next through
// VMEM scratch across an ordered grid.  Here the carry is the chained tile
// prefix of tile.cuh, in the same pass: a block reads its tile once (flags
// 4 lanes a 4-byte word, leaves as 16-byte loads), scans it with a segment
// forced at lane 0, publishes the state at its last lane (as its inclusive
// prefix at once when a flag lies in the tile, which restarts the run),
// looks back only when its first lanes continue a run from before the tile,
// folds the incoming run into the lanes ahead of its first flag, and writes
// the leaves once (16-byte stores).
//
// Bound on this card: memory.  Per lane the function reads a one-byte flag
// and the state's leaves and writes the leaves (9 bytes a lane for an int32
// sum, 17 for a mean); the scan is a few operations a lane.
#include "tile.cuh"

namespace rt {

struct Leaves {
  const void* in[3];
  void* out[3];
};

template <typename T> __device__ __forceinline__ T from_word(unsigned w) {
  T t;
  memcpy(&t, &w, 4);
  return t;
}
template <typename T> __device__ __forceinline__ unsigned to_word(T t) {
  unsigned w;
  memcpy(&w, &t, 4);
  return w;
}

// A state from and to its leaves' 4-byte words (the JAX treedef's order).
template <int OP, typename K> struct LeafIO {
  using S = typename Comb<OP, K>::S;
  static constexpr int NL = 1;
  static __device__ S make(const unsigned (&w)[3]) { return from_word<S>(w[0]); }
  static __device__ void split(S s, unsigned (&w)[3]) { w[0] = to_word(s); }
};
template <typename K> struct LeafIO<OP_MEAN, K> {
  using S = MeanS<K>;
  static constexpr int NL = 2;
  static __device__ S make(const unsigned (&w)[3]) {
    return S{from_word<K>(w[0]), from_word<int>(w[1])};
  }
  static __device__ void split(S s, unsigned (&w)[3]) {
    w[0] = to_word(s.sum);
    w[1] = to_word(s.cnt);
  }
};
template <typename K> struct LeafIO<OP_DC, K> {
  using S = DcS<K>;
  static constexpr int NL = 3;
  static __device__ S make(const unsigned (&w)[3]) {
    return S{from_word<int>(w[0]), from_word<K>(w[1]), from_word<K>(w[2])};
  }
  static __device__ void split(S s, unsigned (&w)[3]) {
    w[0] = to_word(s.dc);
    w[1] = to_word(s.first);
    w[2] = to_word(s.last);
  }
};

struct SsArgs {
  const unsigned char* flags;
  Leaves lv;
  long long n;
  int T, vec;
  unsigned* ticket;
  unsigned* status;  // [nt], then the slots [nt] each
  uint4* agg;        // the tile's trailing run (a segment forced at lane 0)
  uint4* incl;       // the run open after the tile
};

// Lanes a thread: SS_LANES in tiles of at least 32 * SS_LANES lanes (a
// whole warp), else one; a block is a tile of at most 4096 lanes.
constexpr int SS_LANES = 8;

// A minimum of one block: without it ptxas held the float min and max
// scans to 32 registers and spilled.
template <int OP, typename K, int L>
__global__ void __launch_bounds__(L == 1 ? 32 * SS_LANES : 4096 / L, 1)
segscan_kernel(SsArgs a) {
  using C = Comb<OP, K>;
  using IO = LeafIO<OP, K>;
  using S = typename C::S;
  __shared__ ScanSmem sm;
  __shared__ int first_flag;
  __shared__ uint4 carry;
  if (threadIdx.x == 0) first_flag = a.T;
  const int tile = chain_ticket(a.ticket);  // its barrier publishes first_flag
  const int T = a.T;
  const long long base = static_cast<long long>(tile) * T;
  const int i0 = threadIdx.x * L;
  const bool whole = L % 4 == 0 && a.vec && base + i0 + L <= a.n;

  // the tile's lanes, read once; lanes past N (or the tile) start segments
  S s[L];
  bool f[L];
  if (whole) {
#pragma unroll
    for (int q = 0; q < L / 4; ++q) {
      const unsigned fw =
          *reinterpret_cast<const unsigned*>(a.flags + base + i0 + 4 * q);
      unsigned w[3][4] = {};
#pragma unroll
      for (int l = 0; l < IO::NL; ++l) {
        const uint4 v = *reinterpret_cast<const uint4*>(
            static_cast<const unsigned*>(a.lv.in[l]) + base + i0 + 4 * q);
        w[l][0] = v.x; w[l][1] = v.y; w[l][2] = v.z; w[l][3] = v.w;
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        f[4 * q + j] = ((fw >> (8 * j)) & 0xffu) != 0u;
        const unsigned lw[3] = {w[0][j], w[1][j], w[2][j]};
        s[4 * q + j] = IO::make(lw);
      }
    }
  } else {
#pragma unroll
    for (int j = 0; j < L; ++j) {
      const long long idx = base + i0 + j;
      unsigned lw[3] = {0u, 0u, 0u};
      if (i0 + j < T && idx < a.n) {
        f[j] = a.flags[idx] != 0;
#pragma unroll
        for (int l = 0; l < IO::NL; ++l)
          lw[l] = static_cast<const unsigned*>(a.lv.in[l])[idx];
      } else {
        f[j] = true;
      }
      s[j] = IO::make(lw);
    }
  }
  int ff = T;
#pragma unroll
  for (int j = L - 1; j >= 0; --j)
    if (f[j]) ff = i0 + j;
  if (ff < T) atomicMin(&first_flag, ff);
  const bool any_flag = __syncthreads_or(ff < T ? 1 : 0) != 0;
  const bool restart = tile == 0 || any_flag;
  bool fs[L];
#pragma unroll
  for (int j = 0; j < L; ++j) fs[j] = f[j] || i0 + j == 0;
  block_seg_scan<C, L>(s, fs, false, s[0], sm);
  const int ffirst = first_flag;

  // publish the state at the last lane; a tile with a flag restarts the run
#pragma unroll
  for (int j = 0; j < L; ++j)
    if (i0 + j == T - 1) {
      (restart ? a.incl : a.agg)[tile] = pack_state(s[j]);
      chain_publish(a.status, tile, restart ? CH_PREFIX : CH_AGG);
    }
  // the lanes ahead of the first flag continue the run open before the tile
  if (tile > 0 && ffirst > 0) {
    if (threadIdx.x < 32) {
      StateFold<C> fold{a.agg, a.incl, &carry, false};
      chain_lookback(a.status, tile, fold);
    }
    __syncthreads();
    const S in = unpack_state<S>(carry);
#pragma unroll
    for (int j = 0; j < L; ++j)
      if (i0 + j < ffirst) s[j] = C::op(in, s[j]);
    if (!restart)
#pragma unroll
      for (int j = 0; j < L; ++j)
        if (i0 + j == T - 1) {
          a.incl[tile] = pack_state(s[j]);
          chain_publish(a.status, tile, CH_PREFIX);
        }
  }

  if (whole) {
#pragma unroll
    for (int q = 0; q < L / 4; ++q) {
      unsigned w[3][4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        unsigned lw[3] = {0u, 0u, 0u};
        IO::split(s[4 * q + j], lw);
#pragma unroll
        for (int l = 0; l < 3; ++l) w[l][j] = lw[l];
      }
#pragma unroll
      for (int l = 0; l < IO::NL; ++l)
        *reinterpret_cast<uint4*>(static_cast<unsigned*>(a.lv.out[l]) + base +
                                  i0 + 4 * q) =
            make_uint4(w[l][0], w[l][1], w[l][2], w[l][3]);
    }
  } else {
#pragma unroll
    for (int j = 0; j < L; ++j) {
      const long long idx = base + i0 + j;
      if (i0 + j < T && idx < a.n) {
        unsigned lw[3] = {0u, 0u, 0u};
        IO::split(s[j], lw);
#pragma unroll
        for (int l = 0; l < IO::NL; ++l)
          static_cast<unsigned*>(a.lv.out[l])[idx] = lw[l];
      }
    }
  }
}

template <int OP, typename K>
cudaError_t launch_segscan(const SsArgs& a, int nt, cudaStream_t st) {
  if (a.T >= 32 * SS_LANES)
    segscan_kernel<OP, K, SS_LANES><<<nt, a.T / SS_LANES, 0, st>>>(a);
  else
    segscan_kernel<OP, K, 1><<<nt, a.T < 32 ? 32 : a.T, 0, st>>>(a);
  return cudaGetLastError();
}

template <typename K>
cudaError_t dispatch_segscan(int op, const SsArgs& a, int nt, cudaStream_t st) {
  switch (op) {
    case OP_SUM: return launch_segscan<OP_SUM, K>(a, nt, st);
    case OP_MIN: return launch_segscan<OP_MIN, K>(a, nt, st);
    case OP_MAX: return launch_segscan<OP_MAX, K>(a, nt, st);
    case OP_COUNT: return launch_segscan<OP_COUNT, K>(a, nt, st);
    case OP_MEAN: return launch_segscan<OP_MEAN, K>(a, nt, st);
    case OP_DC: return launch_segscan<OP_DC, K>(a, nt, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace rt

// flags: [n] one byte a lane; ins/outs: the state's leaves (up to 3 of
// [n], 4 bytes a lane); key_type: the key leaf's type (count's leaf is int32
// for either); tiles of `tile` lanes (a power of two, 1..4096), the last one
// possibly ragged.  status: 4 + ceil(n / tile) zeroed int32 words (ticket,
// then the chain's status); payload: 32 * ceil(n / tile) bytes, 16-byte
// aligned.
extern "C" int rt_segscan(const void* flags, const void* const* ins,
                          void* const* outs, int nleaves, int key_type, int op,
                          long long n, int tile, void* status, void* payload,
                          void* stream) {
  using namespace rt;
  if (n <= 0 || tile < 1 || tile > 4096 || (tile & (tile - 1)) ||
      nleaves < 1 || nleaves > 3)
    return cudaErrorInvalidValue;
  const long long nt = (n + tile - 1) / tile;
  if (nt > 0x7fffffffll) return cudaErrorInvalidValue;
  SsArgs a;
  a.flags = static_cast<const unsigned char*>(flags);
  a.vec = reinterpret_cast<uintptr_t>(flags) % 4 == 0;
  for (int i = 0; i < 3; ++i) {
    a.lv.in[i] = i < nleaves ? ins[i] : nullptr;
    a.lv.out[i] = i < nleaves ? outs[i] : nullptr;
    if (i < nleaves) a.vec = a.vec && aligned16(ins[i]) && aligned16(outs[i]);
  }
  a.n = n;
  a.T = tile;
  auto words = static_cast<unsigned*>(status);
  a.ticket = words;
  a.status = words + 4;
  a.agg = static_cast<uint4*>(payload);
  a.incl = a.agg + nt;
  auto st = static_cast<cudaStream_t>(stream);
  const int nti = static_cast<int>(nt);
  if (key_type == KEY_INT32) return dispatch_segscan<int>(op, a, nti, st);
  if (key_type == KEY_FLOAT32) return dispatch_segscan<float>(op, a, nti, st);
  return cudaErrorInvalidValue;
}
