// K2: group re-rank of sorted BWT keys, fused with the inverse permutation,
// for every block of a batch at once, in one pass over the keys.
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
// Bound on this card: device-memory traffic, the keys read once (8 bytes a
// position) and one int32 written a position. The write is a scatter (the
// inverse permutation): 4 bytes into a 32-byte sector of the block's slice
// of `rank`, which the L2 cache holds, and the rate at which L2 takes such
// sectors, not the bytes, is what the kernel runs at; everything else is
// arranged to overlap with it. The TPU kernel walks its tiles in order
// with the running max carried in SMEM; CUDA blocks run in no order, so
// the carry between tiles is a decoupled look-back inside ONE kernel:
//   * a CTA takes its tile id from an atomic counter, so every smaller id
//     belongs to a CTA already running and the look-back cannot deadlock;
//   * it loads its tile once, coalesced, into shared memory with one key of
//     halo on each side; heads, ties and the in-tile running max (a ballot
//     and a count of leading zeros per 32 positions, then a scan over the
//     tile's 32-position segments) all come from there;
//   * it publishes one status word (flag in the top two bits, last head
//     position + 1 below, 0 for "no head here") and reads its predecessors'
//     32 at a time until it meets an inclusive one. Head positions grow
//     with the tile id, so a tile that holds a head knows its inclusive
//     value without looking back and publishes it at once; only a tile
//     inside a group of equal keys waits for the carry before it can;
//   * the positions at or after the tile's first head need no carry: their
//     stores go out first, and warp 0 looks back while they are in flight.
//     Only the positions before the first head wait for it.
// The per-slot counts go through shared counters to one global atomic a
// slot a CTA: integer sums, so deterministic.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kItems = 8;
constexpr int kTile = kThreads * kItems;
constexpr int kSegs = kTile / 32;  // 32-position segments of a tile
constexpr int kPer = kSegs / 32;   // segments a lane of warp 0 scans
constexpr int kMaxSlots = 64;      // bz2tpu_torch/ops/bwt.py MAX_SLOTS
static_assert(kPer * 32 == kSegs, "warp 0 scans the segments, kPer a lane");

// The last head position of all tiles before `tile` (>= 1): the statuses of
// 32 predecessors a step, nearest first, up to the first inclusive one.
// Tile 0 holds position 0, a head, so the walk ends there at the latest.
__device__ __forceinline__ int look_back(const u32* status, int tile, int lane) {
  int carry = -1;
  for (int hi = tile - 1;; hi -= 32) {
    const int p = hi - lane;
    u32 s, inclusive;
    for (;;) {
      s = p >= 0 ? load_status(status + p) : kInclusive;
      inclusive = __ballot_sync(BZ2T_FULL_MASK, (s >> 30) == 2u);
      const u32 ready = __ballot_sync(BZ2T_FULL_MASK, (s >> 30) != 0u);
      // Every predecessor up to the nearest inclusive one has published.
      const u32 needed = inclusive ? ((inclusive & (0u - inclusive)) << 1) - 1u : 0xffffffffu;
      if ((ready & needed) == needed) break;
    }
    const int stop = inclusive ? __ffs(inclusive) - 1 : 31;
    const int v = lane <= stop ? (int)(s & kValue) - 1 : -1;
    carry = max(carry, __reduce_max_sync(BZ2T_FULL_MASK, v));
    if (inclusive) return carry;
  }
}

__global__ void __launch_bounds__(kThreads)
rerank_onepass(const u64* __restrict__ keys, int n, int gshift, u64 idx_mask, int slot_shift,
               const int* __restrict__ offsets, int n_slots, int* __restrict__ rank,
               int* __restrict__ active, u32* __restrict__ tile_counter,
               u32* __restrict__ status) {
  // The tile sits at s_key[0, kTile), the key before it at s_key[-1], the
  // key after it at s_key[len]; s_key is 16-byte aligned.
  __shared__ __align__(16) u64 s_raw[kTile + 4];
  __shared__ int s_seg[kSegs];  // per segment: its last head, then the last head before it in the tile
  __shared__ int s_off[kMaxSlots];
  __shared__ int s_active[kMaxSlots];
  __shared__ u32 s_tile;
  __shared__ int s_carry;  // the tile's last head, then the last head before the tile
  u64* s_key = s_raw + 2;
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  if (t == 0) s_tile = atomicAdd(tile_counter, 1u);
  if (t < n_slots) {
    s_off[t] = offsets[t];
    s_active[t] = 0;
  }
  __syncthreads();
  const int tile = (int)s_tile;
  const int base = tile * kTile;
  const int len = min(kTile, n - base);

  if ((reinterpret_cast<uintptr_t>(keys) & 15u) == 0) {
    const ulonglong2* src = reinterpret_cast<const ulonglong2*>(keys + base);
    ulonglong2* dst = reinterpret_cast<ulonglong2*>(s_key);
#pragma unroll
    for (int k = 0; k < kItems / 2; ++k) {
      const int j = k * kThreads + t;
      if (2 * j + 1 < len) dst[j] = src[j];
      else if (2 * j < len) s_key[2 * j] = keys[base + 2 * j];
    }
  } else {
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      const int j = k * kThreads + t;
      if (j < len) s_key[j] = keys[base + j];
    }
  }
  if (t == 0 && base > 0) s_key[-1] = keys[base - 1];
  if (t == 32 && base + len < n) s_key[len] = keys[base + len];
  __syncthreads();

  // Item k of thread t is position k * kThreads + t of the tile: a warp
  // holds 32 consecutive positions, one segment, per item.
  u64 key[kItems];
  int pos[kItems];  // the last head at or before the position within its segment, or -1
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const int j = k * kThreads + t;
    const int i = base + j;
    const bool valid = j < len;
    key[k] = valid ? s_key[j] : 0ull;
    const u64 g = key[k] >> gshift;
    const bool head = valid && (i == 0 || (s_key[j - 1] >> gshift) != g);
    const bool next_head = i == n - 1 || (s_key[j + 1] >> gshift) != g;
    const u32 heads = __ballot_sync(BZ2T_FULL_MASK, head);
    const u32 below = heads & (0xffffffffu >> (31 - lane));
    pos[k] = below ? i - lane + 31 - __clz(below) : -1;
    if (lane == 31) s_seg[j >> 5] = pos[k];
    // Positions in groups of size >= 2, counted per slot: one shared
    // atomic a warp where the 32 positions share a slot (all but the
    // segments that straddle a block boundary).
    const bool tied = valid && !(head && next_head);
    const u32 ties = __ballot_sync(BZ2T_FULL_MASK, tied);
    if (ties) {
      const int slot = (int)(key[k] >> slot_shift);
      const int lead = __ffs(ties) - 1;
      const int lead_slot = __shfl_sync(BZ2T_FULL_MASK, slot, lead);
      if (__all_sync(BZ2T_FULL_MASK, !tied || slot == lead_slot)) {
        if (lane == lead) atomicAdd(&s_active[lead_slot], __popc(ties));
      } else if (tied) {
        atomicAdd(&s_active[slot], 1);
      }
    }
  }
  __syncthreads();

  if (warp == 0) {
    // Exclusive running max over the tile's segments, kPer a lane; the
    // status word goes out before anything waits.
    int v[kPer];
    int incl = -1;
#pragma unroll
    for (int q = 0; q < kPer; ++q) {
      v[q] = s_seg[kPer * lane + q];
      incl = max(incl, v[q]);
    }
    for (int o = 1; o < 32; o <<= 1) {
      const int x = __shfl_up_sync(BZ2T_FULL_MASK, incl, o);
      if (lane >= o) incl = max(incl, x);
    }
    int run = __shfl_up_sync(BZ2T_FULL_MASK, incl, 1);
    if (lane == 0) run = -1;
    const int last_head = __shfl_sync(BZ2T_FULL_MASK, incl, 31);  // -1: no head in the tile
    if (lane == 0) {
      s_carry = last_head;
      store_status(status + tile, tile == 0 || last_head >= 0 ? (kInclusive | (u32)(last_head + 1))
                                                             : kAggregate);
    }
#pragma unroll
    for (int q = 0; q < kPer; ++q) {
      s_seg[kPer * lane + q] = run;
      run = max(run, v[q]);
    }
  }
  __syncthreads();
  const int last_head = s_carry;

  // Positions at or after the tile's first head have their rank now; the
  // few before it (all of them in a tile inside one long group) wait for
  // the carry, which warp 0 fetches while the other stores are in flight.
  u32 waiting = 0;
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const int j = k * kThreads + t;
    if (j < len) {
      const int p = pos[k] >= 0 ? pos[k] : s_seg[j >> 5];
      if (p >= 0) {
        const int off = s_off[key[k] >> slot_shift];
        rank[off + (int)(key[k] & idx_mask)] = p - off;
      } else {
        waiting |= 1u << k;
      }
    }
  }
  if (t < n_slots && s_active[t]) atomicAdd(&active[t], s_active[t]);
  if (tile == 0) return;  // position 0 is a head: nothing waits
  __syncthreads();  // s_carry was read
  if (warp == 0) {
    const int carry = look_back(status, tile, lane);
    if (lane == 0) {
      s_carry = carry;
      if (last_head < 0) store_status(status + tile, kInclusive | (u32)(carry + 1));
    }
  }
  __syncthreads();
  if (waiting) {
    const int carry = s_carry;
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      if (waiting >> k & 1u) {
        const int off = s_off[key[k] >> slot_shift];
        rank[off + (int)(key[k] & idx_mask)] = carry - off;
      }
    }
  }
}

int tiles(int n) { return (n + kTile - 1) / kTile; }

}  // namespace

// Work words for n keys in n_slots slots: the per-slot active counts (the
// kernel's second output), then the tile counter and one status word a tile.
extern "C" int bz2t_rerank_work(int n, int n_slots) { return n_slots + 1 + tiles(n); }

// keys: n < 2^30 sorted packed keys (group bits above idx_bits, the slot
// from slot_shift up); offsets: n_slots int32 slot starts (the slot ranges
// tile 0..n in order); rank: n int32 outputs; work: bz2t_rerank_work(n,
// n_slots) words, whose first n_slots are the active counts on return.
extern "C" int bz2t_rerank(const u64* keys, int n, int idx_bits, int slot_shift,
                           const int* offsets, int n_slots, int* rank, u32* work,
                           cudaStream_t stream) {
  if (n_slots < 1 || n_slots > kMaxSlots || n > (int)kValue) return (int)cudaErrorInvalidValue;
  const int n_tiles = n > 0 ? tiles(n) : 0;
  cudaMemsetAsync(work, 0, sizeof(u32) * (size_t)(n_slots + 1 + n_tiles), stream);
  if (n <= 0) return (int)cudaGetLastError();
  int* active = reinterpret_cast<int*>(work);
  u32* counter = work + n_slots;
  rerank_onepass<<<n_tiles, kThreads, 0, stream>>>(
      keys, n, idx_bits, (1ull << idx_bits) - 1ull, slot_shift, offsets, n_slots, rank, active,
      counter, counter + 1);
  return (int)cudaGetLastError();
}
