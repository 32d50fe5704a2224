// K2: group re-rank of sorted BWT keys, fused with the inverse permutation,
// for every block of a batch at once.
//
// Replaces rerank_pallas (bz2tpu/ops/bwt_pallas.py:242-288) AND the third
// bitonic sort of every doubling round (its inverse-permutation use,
// bwt_pallas.py:320,329). Over the sorted packed keys of a batch (group
// bits above idx_bits, the block's slot from slot_shift up, the index
// below idx_bits), it finds group heads by comparing neighbours, takes the
// inclusive running max of head positions (the Larsson-Sadakane position
// rank) and writes rank[off[slot] + order[i]] = pos[i] - off[slot]: each
// block's ranks are positions within its own range, written into its own
// slice. Slots are contiguous and in order after the sort, and a slot
// change is a group change, so a block's groups never reach into another's.
// active[slot] counts the slot's positions in groups of size >= 2.
//
// Bound on this card: device-memory traffic, ~3 reads of the keys plus one
// scattered int32 write per position. The TPU kernel walks its tiles in
// order with the running max carried in SMEM; CUDA blocks run in no order,
// so the carry becomes three launches: per-tile maxima and per-slot counts,
// a one-block scan of the tile maxima, then the per-element scan and
// scatter. The counts are integer atomic sums and therefore deterministic.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kItems = 8;
constexpr int kTile = kThreads * kItems;
constexpr int kWarps = kThreads / 32;
constexpr int kScanThreads = 1024;
constexpr int kMaxSlots = 64;  // bz2tpu_torch/ops/bwt.py MAX_SLOTS

__device__ __forceinline__ bool is_head(const u64* __restrict__ keys, int i,
                                        int gshift, u64 g) {
  return i == 0 || (keys[i - 1] >> gshift) != g;
}

// Per tile: the last head position, and per slot the positions in groups
// of size >= 2 (added to active[slot]).
__global__ void rerank_tiles(const u64* __restrict__ keys, int n, int gshift, int slot_shift,
                             int n_slots, int* __restrict__ tile_max, int* __restrict__ active) {
  __shared__ int s_max[kWarps];
  __shared__ int s_active[kMaxSlots];
  for (int s = threadIdx.x; s < n_slots; s += kThreads) s_active[s] = 0;
  __syncthreads();
  const int tile = blockIdx.x * kTile;
  int mx = -1;
  int slot = -1;  // the slot `tied` counts for
  int tied = 0;
  for (int j = threadIdx.x; j < kTile; j += kThreads) {
    const int i = tile + j;
    if (i >= n) break;
    const u64 key = keys[i];
    const u64 g = key >> gshift;
    const bool head = is_head(keys, i, gshift, g);
    const bool next_head = i == n - 1 || (keys[i + 1] >> gshift) != g;
    if (head) mx = i;
    if (!(head && next_head)) {
      const int s = (int)(key >> slot_shift);
      if (s != slot) {
        if (tied) atomicAdd(&s_active[slot], tied);
        slot = s;
        tied = 0;
      }
      ++tied;
    }
  }
  if (tied) atomicAdd(&s_active[slot], tied);
  for (int o = 16; o > 0; o >>= 1) mx = max(mx, __shfl_xor_sync(BZ2T_FULL_MASK, mx, o));
  const int warp = threadIdx.x >> 5;
  if ((threadIdx.x & 31) == 0) s_max[warp] = mx;
  __syncthreads();
  if (threadIdx.x == 0) {
    int m = -1;
    for (int w = 0; w < kWarps; ++w) m = max(m, s_max[w]);
    tile_max[blockIdx.x] = m;
  }
  for (int s = threadIdx.x; s < n_slots; s += kThreads)
    if (s_active[s]) atomicAdd(&active[s], s_active[s]);
}

// One block: tile_max becomes its exclusive running max (the carry into
// each tile).
__global__ void rerank_scan(int* __restrict__ tile_max, int n_tiles) {
  block_exclusive_scan<kScanThreads, 8>(tile_max, n_tiles, -1, MaxOp());
}

// Per element: pos = max(carry into the tile, in-tile inclusive running
// max of head positions); rank[off + order] = pos - off. Thread t owns
// kItems consecutive positions; a warp shuffle scan plus a pass over the
// warp totals gives each thread the running max before its first item.
__global__ void rerank_scatter(const u64* __restrict__ keys, int n, int gshift,
                               u64 idx_mask, int slot_shift, const int* __restrict__ offsets,
                               const int* __restrict__ tile_prefix, int* __restrict__ rank) {
  __shared__ int s_warp[kWarps];
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  const int first = blockIdx.x * kTile + t * kItems;
  int pos[kItems];
  int off[kItems];
  u32 order[kItems];
  int run = -1;
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const int i = first + k;
    pos[k] = -1;
    off[k] = 0;
    order[k] = 0;
    if (i < n) {
      const u64 key = keys[i];
      if (is_head(keys, i, gshift, key >> gshift)) run = i;
      pos[k] = run;
      off[k] = offsets[key >> slot_shift];
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
    if (first + k < n) rank[off[k] + order[k]] = max(before, pos[k]) - off[k];
}

}  // namespace

extern "C" int bz2t_rerank_scratch(int n) { return (n + kTile - 1) / kTile; }

// keys: n sorted packed keys (group bits above idx_bits, the slot from
// slot_shift up); offsets: n_slots int32 slot starts (the slot ranges tile
// 0..n in order); rank: n int32 outputs; active: n_slots int32 outputs;
// scratch: bz2t_rerank_scratch(n) ints.
extern "C" int bz2t_rerank(const u64* keys, int n, int idx_bits, int slot_shift,
                           const int* offsets, int n_slots, int* rank, int* active,
                           int* scratch, cudaStream_t stream) {
  if (n_slots < 1 || n_slots > kMaxSlots) return (int)cudaErrorInvalidValue;
  cudaMemsetAsync(active, 0, sizeof(int) * (size_t)n_slots, stream);
  if (n <= 0) return (int)cudaGetLastError();
  const int n_tiles = (n + kTile - 1) / kTile;
  int* tile_max = scratch;
  rerank_tiles<<<n_tiles, kThreads, 0, stream>>>(keys, n, idx_bits, slot_shift, n_slots,
                                                 tile_max, active);
  rerank_scan<<<1, kScanThreads, 0, stream>>>(tile_max, n_tiles);
  rerank_scatter<<<n_tiles, kThreads, 0, stream>>>(
      keys, n, idx_bits, (1ull << idx_bits) - 1ull, slot_shift, offsets, tile_max, rank);
  return (int)cudaGetLastError();
}
