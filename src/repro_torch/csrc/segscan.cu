// Tiled segmented inclusive scan of a combiner state over one stream.
//
// Replaces: src/repro/kernels/segscan/kernel.py, segscan_pallas (the JAX
// package's Pallas TPU kernel, wrapped by segmented_scan_tpu).
//
// What it computes: for flags [N] (1 where a segment starts) and a combiner
// state given as its leaves [N] (struct of arrays, in the JAX treedef's
// order), the inclusive scan of the state within each segment.  N is a
// multiple of the tile T.  The ops are sum, min, max, count, mean and
// distinct count (Comb<OP, K> of tile.cuh); distinct count is not
// commutative, so every combine keeps the earlier range on the left.
//
// The TPU kernel carries the trailing run of each tile to the next through
// VMEM scratch across an ordered grid.  Blocks on this card run in no fixed
// order, so the carry becomes a reduce-then-scan over tiles (as in
// groupagg.cu):
//   1. ss_summary, one block per tile: the scan state at the tile's last
//      lane with a segment forced at lane 0 (the tile's trailing run), and
//      whether any flag lies in the tile;
//   2. ss_carry, one block: a segmented scan of those summaries gives the
//      run open after every tile (a tile with a flag restarts it, a tile
//      without extends it; tile 0 starts it);
//   3. ss_emit, one block per tile: the tile's scan again, the run open
//      after the previous tile folded into the lanes before the tile's
//      first flag, written back as leaves.
//
// Bound on this card: memory.  Per lane the function reads a one-byte flag
// and the state's leaves and writes the leaves (9 bytes a lane for an int32
// sum, 13 for a mean); passes 1 and 3 both read the input, so this design
// moves the flag and the leaves twice.  The scan is a few operations a lane.
#include "tile.cuh"

namespace rt {

struct Leaves {
  const void* in[3];
  void* out[3];
};

// Load and store a state from and to its leaves (the JAX treedef's order).
template <int OP, typename K> struct LeafIO {
  using S = typename Comb<OP, K>::S;
  static __device__ S load(const Leaves& l, long long i) {
    return static_cast<const S*>(l.in[0])[i];
  }
  static __device__ void store(const Leaves& l, long long i, S s) {
    static_cast<S*>(l.out[0])[i] = s;
  }
};
template <typename K> struct LeafIO<OP_MEAN, K> {
  using S = MeanS<K>;
  static __device__ S load(const Leaves& l, long long i) {
    return S{static_cast<const K*>(l.in[0])[i],
             static_cast<const int*>(l.in[1])[i]};
  }
  static __device__ void store(const Leaves& l, long long i, S s) {
    static_cast<K*>(l.out[0])[i] = s.sum;
    static_cast<int*>(l.out[1])[i] = s.cnt;
  }
};
template <typename K> struct LeafIO<OP_DC, K> {
  using S = DcS<K>;
  static __device__ S load(const Leaves& l, long long i) {
    return S{static_cast<const int*>(l.in[0])[i],
             static_cast<const K*>(l.in[1])[i],
             static_cast<const K*>(l.in[2])[i]};
  }
  static __device__ void store(const Leaves& l, long long i, S s) {
    static_cast<int*>(l.out[0])[i] = s.dc;
    static_cast<K*>(l.out[1])[i] = s.first;
    static_cast<K*>(l.out[2])[i] = s.last;
  }
};

struct SegscanScratch {
  void* agg;     // [NT] S: the tile's trailing run (segment forced at lane 0)
  void* pend;    // [NT] S: the run open after each tile
  int* hasflag;  // [NT] 1 when a flag lies in the tile
};

template <int OP, typename K, int L>
__global__ void __launch_bounds__(1024)
ss_summary(const unsigned char* __restrict__ flags, Leaves lv, int T,
           SegscanScratch sc) {
  using C = Comb<OP, K>;
  using IO = LeafIO<OP, K>;
  using S = typename C::S;
  __shared__ ScanSmem sm;
  const long long base = static_cast<long long>(blockIdx.x) * T;
  S s[L];
  bool f[L];
  bool any = false;
#pragma unroll
  for (int j = 0; j < L; ++j) {
    const int i = threadIdx.x * L + j;
    if (i < T) {
      const bool fl = flags[base + i] != 0;
      any = any || fl;
      f[j] = i == 0 || fl;
      s[j] = IO::load(lv, base + i);
    } else {
      f[j] = true;
      s[j] = IO::load(lv, base);
    }
  }
  block_seg_scan<C, L>(s, f, false, s[0], sm);
  const int any_flag = __syncthreads_or(any ? 1 : 0);
#pragma unroll
  for (int j = 0; j < L; ++j)
    if (threadIdx.x * L + j == T - 1) static_cast<S*>(sc.agg)[blockIdx.x] = s[j];
  if (threadIdx.x == 0) sc.hasflag[blockIdx.x] = any_flag;
}

template <int OP, typename K>
__global__ void __launch_bounds__(1024)
ss_carry(int nt, SegscanScratch sc) {
  using C = Comb<OP, K>;
  using S = typename C::S;
  constexpr int L = 4;
  __shared__ ScanSmem sm;
  __shared__ S carry_s;
  const S* agg = static_cast<const S*>(sc.agg);
  S* pend = static_cast<S*>(sc.pend);
  bool has = false;
  S carry = agg[0];
  const int per_round = blockDim.x * L;
  for (int r0 = 0; r0 < nt; r0 += per_round) {
    const int last = (r0 + per_round < nt ? r0 + per_round : nt) - 1;
    S s[L];
    bool f[L];
#pragma unroll
    for (int j = 0; j < L; ++j) {
      const int t = r0 + threadIdx.x * L + j;
      if (t < nt) {
        f[j] = t == 0 || sc.hasflag[t] != 0;
        s[j] = agg[t];
      } else {
        f[j] = true;
        s[j] = agg[0];
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

template <int OP, typename K, int L>
__global__ void __launch_bounds__(1024)
ss_emit(const unsigned char* __restrict__ flags, Leaves lv, int T,
        SegscanScratch sc) {
  using C = Comb<OP, K>;
  using IO = LeafIO<OP, K>;
  using S = typename C::S;
  __shared__ ScanSmem sm;
  const int tile = blockIdx.x;
  const long long base = static_cast<long long>(tile) * T;
  const bool has_carry = tile > 0;
  const S carry = static_cast<const S*>(sc.pend)[tile > 0 ? tile - 1 : 0];
  S s[L];
  bool f[L];
#pragma unroll
  for (int j = 0; j < L; ++j) {
    const int i = threadIdx.x * L + j;
    if (i < T) {
      f[j] = flags[base + i] != 0;
      s[j] = IO::load(lv, base + i);
    } else {
      f[j] = true;
      s[j] = IO::load(lv, base);
    }
  }
  block_seg_scan<C, L>(s, f, has_carry, carry, sm);
#pragma unroll
  for (int j = 0; j < L; ++j) {
    const int i = threadIdx.x * L + j;
    if (i < T) IO::store(lv, base + i, s[j]);
  }
}

template <int OP, typename K, int L>
void launch_segscan(const unsigned char* flags, const Leaves& lv, int nt,
                    int T, SegscanScratch sc, cudaStream_t st) {
  const int threads = threads_for(T);
  ss_summary<OP, K, L><<<nt, threads, 0, st>>>(flags, lv, T, sc);
  ss_carry<OP, K><<<1, 1024, 0, st>>>(nt, sc);
  ss_emit<OP, K, L><<<nt, threads, 0, st>>>(flags, lv, T, sc);
}

template <int OP, typename K>
cudaError_t run_segscan(const unsigned char* flags, const Leaves& lv, int nt,
                        int T, unsigned char* scratch, cudaStream_t st) {
  SegscanScratch sc;
  sc.agg = scratch;
  sc.pend = scratch + 16ll * nt;
  sc.hasflag = reinterpret_cast<int*>(scratch + 32ll * nt);
  switch (lanes_per_thread(T)) {
    case 1: launch_segscan<OP, K, 1>(flags, lv, nt, T, sc, st); break;
    case 4: launch_segscan<OP, K, 4>(flags, lv, nt, T, sc, st); break;
    default: return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

template <typename K>
cudaError_t dispatch_segscan(int op, const unsigned char* flags,
                             const Leaves& lv, int nt, int T,
                             unsigned char* scratch, cudaStream_t st) {
  switch (op) {
    case OP_SUM: return run_segscan<OP_SUM, K>(flags, lv, nt, T, scratch, st);
    case OP_MIN: return run_segscan<OP_MIN, K>(flags, lv, nt, T, scratch, st);
    case OP_MAX: return run_segscan<OP_MAX, K>(flags, lv, nt, T, scratch, st);
    case OP_COUNT: return run_segscan<OP_COUNT, K>(flags, lv, nt, T, scratch, st);
    case OP_MEAN: return run_segscan<OP_MEAN, K>(flags, lv, nt, T, scratch, st);
    case OP_DC: return run_segscan<OP_DC, K>(flags, lv, nt, T, scratch, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace rt

// flags: [nt * tile] one byte a lane; ins/outs: the state's leaves (up to 3
// of [nt * tile]); key_type: the key leaf's type (count's leaf is int32 for
// either); scratch: 36 * nt bytes.  Tiles are powers of two, 1 <= T <= 4096.
extern "C" int rt_segscan(const void* flags, const void* const* ins,
                          void* const* outs, int nleaves, int key_type, int op,
                          int nt, int tile, void* scratch, void* stream) {
  using namespace rt;
  if (nt <= 0 || tile < 1 || tile > 4096 || (tile & (tile - 1)) ||
      nleaves < 1 || nleaves > 3)
    return cudaErrorInvalidValue;
  Leaves lv;
  for (int i = 0; i < 3; ++i) {
    lv.in[i] = i < nleaves ? ins[i] : nullptr;
    lv.out[i] = i < nleaves ? outs[i] : nullptr;
  }
  auto st = static_cast<cudaStream_t>(stream);
  auto fl = static_cast<const unsigned char*>(flags);
  auto sc = static_cast<unsigned char*>(scratch);
  if (key_type == KEY_INT32) return dispatch_segscan<int>(op, fl, lv, nt, tile, sc, st);
  if (key_type == KEY_FLOAT32) return dispatch_segscan<float>(op, fl, lv, nt, tile, sc, st);
  return cudaErrorInvalidValue;
}
