// K1: stable LSD radix sort of packed 64-bit BWT keys, single-pass passes
// (Onesweep: Adinets and Merrill, 2022).
//
// Replaces bitonic_sort_pallas (bz2tpu/ops/bwt_pallas.py:117-153), the
// TPU's VMEM-resident bitonic network over k int32 operands. Here the whole
// lexicographic key of a doubling round is ONE u64, for every block of a
// batch at once (bz2tpu_torch/ops/bwt.py): round 0 packs (slot << (nb+24))
// | (key24 << nb) | idx, a pair round (slot << 3nb) | (rank << 2nb) |
// ((s1+1) << nb) | idx, with the block's slot above its key and nb =
// bit_length(max n) <= 20 at level 9 (63 bits with 8 blocks). Keys arrive
// in (slot, index) order, so a STABLE sort of bits [lo_bit, hi_bit) alone
// is the lexicographic sort with the index tie-break, and each block comes
// out contiguous, in its own order: the index bits never need a pass, and
// no payload travels with the key (order = key & (2^nb - 1)).
//
// Bound on this card: device-memory traffic. A sort must read each key
// once and write it once (16 bytes a key); an LSD pass cannot do better
// than that either. The design is built to get there, pass by pass:
//   * one upfront kernel reads the keys once and builds the histograms of
//     every digit pass at the same time, so the passes need no histogram
//     read of their own;
//   * each pass is ONE kernel: a CTA takes its tile id from an atomic
//     counter (so every smaller id belongs to a CTA already running, and
//     the look-back below cannot deadlock), counts its tile's digits,
//     publishes them as per-(tile, digit) status words (aggregate, then
//     inclusive prefix), and gets its global offset by decoupled look-back
//     over its predecessors' words; then it ranks its keys stably (each
//     warp against its own digit counters, with __match_any_sync, and no
//     block-wide barrier until one scan over the warps), sorts the tile by
//     digit in shared memory, and writes each digit's run out in order, so
//     the stores coalesce. So a sort of P passes is
//     1 + P launches, each reading the keys once and writing them once,
//     and no one-SM scan sits between the passes.
// Digits are 8 bits: 6 passes over the 43 bits of a level-9 pair round of
// 8 blocks, 4 over round 0's 27. 11-bit digits would save two passes but
// need 2,048 counters a warp in the in-tile rank (8x the shared state and
// 8x the scan over it in every tile), which costs more than the two
// passes' 16 bytes a key at these sizes.
#include "common.cuh"

namespace {

constexpr int kBits = 8;
constexpr int kRadix = 1 << kBits;
constexpr int kThreads = 256;  // == kRadix: one digit per thread
constexpr int kItems = 16;
constexpr int kTile = kThreads * kItems;
constexpr int kWarpKeys = 32 * kItems;  // keys a warp ranks in a tile
constexpr int kSweepBlocksPerSM = 3;  // registers for 3 CTAs an SM: 85 a thread
constexpr int kWarps = kThreads / 32;
constexpr int kMaxPasses = (63 + kBits - 1) / kBits;
constexpr int kHistBlocks = 264;  // two CTAs an SM for the upfront histogram

__device__ __forceinline__ u32 digit_mask(int lo_bit, int hi_bit, int pass) {
  const int bits = min(kBits, hi_bit - (lo_bit + kBits * pass));
  return (1u << bits) - 1u;
}

// hist[pass * kRadix + d] += the number of keys whose digit `pass` is d.
__global__ void __launch_bounds__(kThreads)
radix_upfront_histogram(const u64* __restrict__ keys, int n, int lo_bit, int hi_bit,
                        int passes, u32* __restrict__ hist) {
  __shared__ u32 cnt[kMaxPasses][kRadix];
  for (int p = 0; p < passes; ++p) cnt[p][threadIdx.x] = 0;
  __syncthreads();
  u32 mask[kMaxPasses];
#pragma unroll
  for (int p = 0; p < kMaxPasses; ++p) mask[p] = p < passes ? digit_mask(lo_bit, hi_bit, p) : 0u;
  for (int i = blockIdx.x * kThreads + threadIdx.x; i < n; i += gridDim.x * kThreads) {
    const u64 k = keys[i] >> lo_bit;
#pragma unroll
    for (int p = 0; p < kMaxPasses; ++p)
      if (p < passes) atomicAdd(&cnt[p][(u32)(k >> (kBits * p)) & mask[p]], 1u);
  }
  __syncthreads();
  for (int p = 0; p < passes; ++p) {
    const u32 c = cnt[p][threadIdx.x];
    if (c) atomicAdd(&hist[p * kRadix + threadIdx.x], c);
  }
}

// Exclusive sum over the block of one value per thread (kThreads ==
// kRadix: thread t holds digit t's value).
__device__ __forceinline__ u32 digit_exclusive_sum(u32 v, u32* warp_sum) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  u32 incl = v;
  for (int o = 1; o < 32; o <<= 1) {
    const u32 x = __shfl_up_sync(BZ2T_FULL_MASK, incl, o);
    if (lane >= o) incl += x;
  }
  if (lane == 31) warp_sum[warp] = incl;
  __syncthreads();
  u32 excl = incl - v;
  for (int w = 0; w < warp; ++w) excl += warp_sum[w];
  return excl;
}

// One pass: the stable scatter of one tile by digit (key >> shift) & mask.
// Warp w ranks its own kWarpKeys consecutive keys of the tile, item by
// item, lanes in order, against its own per-digit counters in shared
// memory (__match_any_sync gives the peers of a key within an item), so
// the ranking needs no block-wide barrier; one scan over the warps per
// digit then gives each warp's start within the digit. Each key lands at
// its place in the tile sorted by digit, in shared memory, and
// consecutive threads write consecutive keys of a digit's run out, so the
// stores to device memory coalesce.
__global__ void __launch_bounds__(kThreads, kSweepBlocksPerSM)
radix_onesweep(const u64* __restrict__ in, u64* __restrict__ out, int n, int shift, u32 mask,
               const u32* __restrict__ hist, u32* __restrict__ tile_counter,
               u32* __restrict__ status) {
  __shared__ u32 s_tile;
  __shared__ u32 warp_sum[2][kWarps];
  __shared__ u32 to_global[kRadix];  // global position - tile-local slot, per digit
  // Per warp and digit: the warp's count of the digit, then its first slot.
  __shared__ unsigned short cnt[kWarps][kRadix];
  __shared__ u64 stage[kTile];       // the tile, sorted by digit
  const int t = threadIdx.x;
  const int warp = t >> 5;
  const int lane = t & 31;
  const u32 lower_lanes = (1u << lane) - 1u;
  if (t == 0) s_tile = atomicAdd(tile_counter, 1u);
  for (int w = 0; w < kWarps; ++w) cnt[w][t] = 0;
  __syncthreads();
  const u32 tile = s_tile;
  const int tile_len = min(kTile, n - (int)tile * kTile);

  u64 key[kItems];
  u32 rank[kItems];  // keys of the same digit before this one in the warp
  // All loads first, so that every thread has kItems of them in flight.
#pragma unroll
  for (int it = 0; it < kItems; ++it) {
    const int j = warp * kWarpKeys + it * 32 + lane;
    key[it] = j < tile_len ? in[(size_t)tile * kTile + j] : 0ull;
  }
#pragma unroll
  for (int it = 0; it < kItems; ++it) {
    const bool ok = warp * kWarpKeys + it * 32 + lane < tile_len;
    const u32 d = ok ? ((u32)(key[it] >> shift) & mask) : (u32)kRadix;
    const u32 peers = __match_any_sync(BZ2T_FULL_MASK, d);
    const u32 seen = ok ? cnt[warp][d] : 0u;
    rank[it] = seen + __popc(peers & lower_lanes);
    __syncwarp();
    if (ok && lane == __ffs(peers) - 1) cnt[warp][d] = (unsigned short)(seen + __popc(peers));
    __syncwarp();
  }
  __syncthreads();

  // Thread t owns digit t: each warp's start within the digit, and the
  // tile's count of it.
  u32 mine = 0;
  for (int w = 0; w < kWarps; ++w) {
    const u32 c = cnt[w][t];
    cnt[w][t] = (unsigned short)mine;
    mine += c;
  }

  // Publish this tile's count of digit t, then look back for the keys of
  // digit t in all earlier tiles.
  u32* my_status = status + (size_t)tile * kRadix + t;
  u32 before = 0;
  if (tile == 0) {
    store_status(my_status, kInclusive | mine);
  } else {
    store_status(my_status, kAggregate | mine);
    for (int prev = (int)tile - 1;; --prev) {
      u32 s;
      do {
        s = load_status(status + (size_t)prev * kRadix + t);
      } while ((s & ~kValue) == 0);
      before += s & kValue;
      if ((s & ~kValue) == kInclusive) break;
    }
    store_status(my_status, kInclusive | (before + mine));
  }

  // Keys of smaller digits in the whole array and in this tile.
  const u32 global_base = digit_exclusive_sum(hist[t], warp_sum[0]) + before;
  const u32 local_base = digit_exclusive_sum(mine, warp_sum[1]);
  for (int w = 0; w < kWarps; ++w) cnt[w][t] += (unsigned short)local_base;
  to_global[t] = global_base - local_base;
  __syncthreads();
#pragma unroll
  for (int it = 0; it < kItems; ++it)
    if (warp * kWarpKeys + it * 32 + lane < tile_len)
      stage[cnt[warp][(u32)(key[it] >> shift) & mask] + rank[it]] = key[it];
  __syncthreads();
  for (int j = t; j < tile_len; j += kThreads) {
    const u64 k = stage[j];
    out[to_global[(u32)(k >> shift) & mask] + j] = k;
  }
}

int sort_passes(int lo_bit, int hi_bit) { return (hi_bit - lo_bit + kBits - 1) / kBits; }

int tiles(int n) { return (n + kTile - 1) / kTile; }

}  // namespace

// Scratch in 32-bit words for n keys: kMaxPasses histograms, tile
// counters and (tile, digit) status words.
extern "C" int bz2t_radix_sort_scratch(int n) {
  return kMaxPasses * (kRadix + 1 + tiles(n) * kRadix);
}

// Sorts n < 2^30 keys by bits [lo_bit, hi_bit), stably; `keys` is left
// untouched, the result lands in `out` (`tmp` is the ping-pong buffer,
// `scratch` holds bz2t_radix_sort_scratch(n) words).
extern "C" int bz2t_radix_sort_u64(const u64* keys, u64* out, u64* tmp, u32* scratch,
                                   int n, int lo_bit, int hi_bit, cudaStream_t stream) {
  const int passes = hi_bit > lo_bit ? sort_passes(lo_bit, hi_bit) : 0;
  if (n <= 0 || passes == 0) {
    if (n > 0)
      cudaMemcpyAsync(out, keys, sizeof(u64) * (size_t)n, cudaMemcpyDeviceToDevice, stream);
    return (int)cudaGetLastError();
  }
  if (n > (int)kValue || passes > kMaxPasses) return (int)cudaErrorInvalidValue;
  const int n_tiles = tiles(n);
  u32* hist = scratch;                                 // passes x kRadix
  u32* counters = hist + passes * kRadix;              // passes
  u32* status = counters + passes;                     // passes x n_tiles x kRadix
  const size_t words = (size_t)passes * (kRadix + 1 + (size_t)n_tiles * kRadix);
  cudaMemsetAsync(scratch, 0, words * sizeof(u32), stream);
  radix_upfront_histogram<<<min(n_tiles, kHistBlocks), kThreads, 0, stream>>>(
      keys, n, lo_bit, hi_bit, passes, hist);
  const u64* src = keys;
  for (int p = 0; p < passes; ++p) {
    const int shift = lo_bit + kBits * p;
    const int bits = hi_bit - shift < kBits ? hi_bit - shift : kBits;
    u64* dst = ((passes - 1 - p) % 2 == 0) ? out : tmp;  // last pass -> out
    radix_onesweep<<<n_tiles, kThreads, 0, stream>>>(
        src, dst, n, shift, (1u << bits) - 1u, hist + p * kRadix, counters + p,
        status + (size_t)p * n_tiles * kRadix);
    src = dst;
  }
  return (int)cudaGetLastError();
}
