// K2: group re-rank of sorted BWT keys, fused with the inverse permutation.
//
// Replaces rerank_pallas (bz2tpu/ops/bwt_pallas.py:242-288) AND the third
// bitonic sort of every doubling round (its inverse-permutation use,
// bwt_pallas.py:320,329). Over the sorted packed keys (group bits above
// idx_bits, the index below), it finds group heads by comparing
// neighbours, takes the inclusive running max of head positions (the
// Larsson-Sadakane position rank) and writes rank[order[i]] = pos[i]
// straight to its final place; `active` counts positions in groups of
// size >= 2.
//
// Bound on this card: device-memory traffic, ~3 reads of the keys plus one
// scattered int32 write per position. The TPU kernel walks its tiles in
// order with the running max carried in SMEM; CUDA blocks run in no order,
// so the carry becomes three launches: per-tile maxima and singleton
// counts, a one-block scan of the tile maxima, then the per-element scan
// and scatter. `active` is n minus the singleton count, an integer atomic
// sum and therefore deterministic.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kItems = 8;
constexpr int kTile = kThreads * kItems;
constexpr int kWarps = kThreads / 32;
constexpr int kScanThreads = 1024;

__device__ __forceinline__ bool is_head(const u64* __restrict__ keys, int i,
                                        int gshift, u64 g) {
  return i == 0 || (keys[i - 1] >> gshift) != g;
}

// Per tile: the last head position and the number of singleton groups.
__global__ void rerank_tiles(const u64* __restrict__ keys, int n, int gshift,
                             int* __restrict__ tile_max, int* __restrict__ singles) {
  __shared__ int s_max[kWarps];
  __shared__ int s_single[kWarps];
  const int tile = blockIdx.x * kTile;
  int mx = -1;
  int single = 0;
  for (int j = threadIdx.x; j < kTile; j += kThreads) {
    const int i = tile + j;
    if (i >= n) break;
    const u64 g = keys[i] >> gshift;
    const bool head = is_head(keys, i, gshift, g);
    const bool next_head = i == n - 1 || (keys[i + 1] >> gshift) != g;
    if (head) mx = i;
    single += (head && next_head) ? 1 : 0;
  }
  for (int o = 16; o > 0; o >>= 1) {
    mx = max(mx, __shfl_xor_sync(BZ2T_FULL_MASK, mx, o));
    single += __shfl_xor_sync(BZ2T_FULL_MASK, single, o);
  }
  const int warp = threadIdx.x >> 5;
  if ((threadIdx.x & 31) == 0) {
    s_max[warp] = mx;
    s_single[warp] = single;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    int m = -1;
    int s = 0;
    for (int w = 0; w < kWarps; ++w) {
      m = max(m, s_max[w]);
      s += s_single[w];
    }
    tile_max[blockIdx.x] = m;
    atomicAdd(singles, s);
  }
}

// One block: tile_max becomes its exclusive running max (the carry into
// each tile); active = n - singletons.
__global__ void rerank_scan(int* __restrict__ tile_max, int n_tiles,
                            const int* __restrict__ singles, int n,
                            int* __restrict__ active) {
  block_exclusive_scan<kScanThreads, 8>(tile_max, n_tiles, -1, MaxOp());
  if (threadIdx.x == 0) *active = n - *singles;
}

// Per element: pos = max(carry into the tile, in-tile inclusive running
// max of head positions); rank[order] = pos. Thread t owns kItems
// consecutive positions; a warp shuffle scan plus a pass over the warp
// totals gives each thread the running max before its first item.
__global__ void rerank_scatter(const u64* __restrict__ keys, int n, int gshift,
                               u64 idx_mask, const int* __restrict__ tile_prefix,
                               int* __restrict__ rank) {
  __shared__ int s_warp[kWarps];
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  const int first = blockIdx.x * kTile + t * kItems;
  int pos[kItems];
  u32 order[kItems];
  int run = -1;
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const int i = first + k;
    pos[k] = -1;
    order[k] = 0;
    if (i < n) {
      const u64 key = keys[i];
      if (is_head(keys, i, gshift, key >> gshift)) run = i;
      pos[k] = run;
      order[k] = (u32)(key & idx_mask);
    }
  }
  int incl = run;
  for (int o = 1; o < 32; o <<= 1) {
    const int v = __shfl_up_sync(BZ2T_FULL_MASK, incl, o);
    if (lane >= o) incl = max(incl, v);
  }
  if (lane == 31) s_warp[warp] = incl;
  __syncthreads();
  int before = tile_prefix[blockIdx.x];
  for (int w = 0; w < warp; ++w) before = max(before, s_warp[w]);
  const int prev_lanes = __shfl_up_sync(BZ2T_FULL_MASK, incl, 1);
  if (lane > 0) before = max(before, prev_lanes);
#pragma unroll
  for (int k = 0; k < kItems; ++k)
    if (first + k < n) rank[order[k]] = max(before, pos[k]);
}

}  // namespace

extern "C" int bz2t_rerank_scratch(int n) { return (n + kTile - 1) / kTile + 1; }

// keys: n sorted packed keys (group bits above idx_bits); rank: n int32
// outputs; active: one int32 output; scratch: bz2t_rerank_scratch(n) ints.
extern "C" int bz2t_rerank(const u64* keys, int n, int idx_bits, int* rank,
                           int* active, int* scratch, cudaStream_t stream) {
  if (n <= 0) return (int)cudaMemsetAsync(active, 0, sizeof(int), stream);
  const int n_tiles = (n + kTile - 1) / kTile;
  int* tile_max = scratch;
  int* singles = scratch + n_tiles;
  cudaMemsetAsync(singles, 0, sizeof(int), stream);
  rerank_tiles<<<n_tiles, kThreads, 0, stream>>>(keys, n, idx_bits, tile_max, singles);
  rerank_scan<<<1, kScanThreads, 0, stream>>>(tile_max, n_tiles, singles, n, active);
  rerank_scatter<<<n_tiles, kThreads, 0, stream>>>(
      keys, n, idx_bits, (1ull << idx_bits) - 1ull, tile_max, rank);
  return (int)cudaGetLastError();
}
