// K1: stable LSD radix sort of packed 64-bit BWT keys.
//
// Replaces bitonic_sort_pallas (bz2tpu/ops/bwt_pallas.py:117-153), the
// TPU's VMEM-resident bitonic network over k int32 operands. Here the whole
// lexicographic key of a doubling round is ONE u64: round 0 packs
// (key24 << nb) | idx, a pair round packs (rank << 2nb) | ((s1+1) << nb) |
// idx, with nb = bit_length(n) <= 20 at level 9 (60 bits). Keys arrive in
// index order, so a STABLE sort of bits [lo_bit, hi_bit) alone equals the
// lexicographic sort with the index tie-break: the index bits never need a
// pass, and no payload travels with the key (order = key & (2^nb - 1)).
//
// Bound on this card: device-memory traffic. Each 8-bit pass reads the keys
// twice (histogram, scatter) and writes them once: 24 bytes per key per
// pass, ~5 passes per pair round at n = 900k. The design keeps the passes
// few (only the bits the key has) and the scan tiny (256 x tiles counters);
// the scatter's in-tile stable ranks come from __match_any_sync plus a
// per-warp, per-digit exclusive scan in shared memory, so no sorting
// network and no global atomics are involved.
#include "common.cuh"

namespace {

constexpr int kRadix = 256;
constexpr int kThreads = 256;  // == kRadix: one digit counter per thread
constexpr int kItems = 16;
constexpr int kTile = kThreads * kItems;
constexpr int kWarps = kThreads / 32;
constexpr int kScanThreads = 1024;

// Per-tile digit counts, stored digit-major (hist[d * n_tiles + tile]) so
// that one exclusive scan yields every (digit, tile) scatter base.
__global__ void radix_histogram(const u64* __restrict__ keys, int n, int shift,
                                u32 mask, u32* __restrict__ hist, int n_tiles) {
  __shared__ u32 cnt[kRadix];
  cnt[threadIdx.x] = 0;
  __syncthreads();
  const int base = blockIdx.x * kTile;
  const int end = min(base + kTile, n);
  for (int p = base + threadIdx.x; p < end; p += kThreads)
    atomicAdd(&cnt[(u32)(keys[p] >> shift) & mask], 1u);
  __syncthreads();
  hist[threadIdx.x * n_tiles + blockIdx.x] = cnt[threadIdx.x];
}

// In-place exclusive sum over the 256 x n_tiles counters, one block.
__global__ void exclusive_scan(u32* __restrict__ data, int len) {
  block_exclusive_scan<kScanThreads, 8>(data, len, 0u, SumOp());
}

// Stable scatter of one tile. The tile is walked in kItems rounds of
// kThreads consecutive keys; within a round, warp w holds keys
// [32w, 32w+32) in lane order, so (earlier rounds, earlier warps, lower
// lanes) is exactly input order.
__global__ void radix_scatter(const u64* __restrict__ in, u64* __restrict__ out,
                              int n, int shift, u32 mask,
                              const u32* __restrict__ offsets, int n_tiles) {
  __shared__ u32 base[kRadix];         // next free slot per digit
  __shared__ u32 cnt[kWarps][kRadix];  // this round's count per warp, digit
  __shared__ u32 off[kWarps][kRadix];  // this round's base per warp, digit
  const int t = threadIdx.x;
  const int warp = t >> 5;
  const int lane = t & 31;
  const u32 lower_lanes = (1u << lane) - 1u;
  base[t] = offsets[t * n_tiles + blockIdx.x];
  for (int w = 0; w < kWarps; ++w) cnt[w][t] = 0;
  __syncthreads();
  const int tile = blockIdx.x * kTile;
  for (int it = 0; it < kItems; ++it) {
    const int p = tile + it * kThreads + t;
    const bool ok = p < n;
    const u64 key = ok ? in[p] : 0ull;
    const u32 d = ok ? ((u32)(key >> shift) & mask) : (u32)kRadix;
    const u32 peers = __match_any_sync(BZ2T_FULL_MASK, d);
    if (ok && lane == __ffs(peers) - 1) cnt[warp][d] = __popc(peers);
    __syncthreads();
    // Thread t owns digit t: exclusive scan over the warps, reset counts.
    u32 run = base[t];
    for (int w = 0; w < kWarps; ++w) {
      off[w][t] = run;
      run += cnt[w][t];
      cnt[w][t] = 0;
    }
    base[t] = run;
    __syncthreads();
    if (ok) out[off[warp][d] + __popc(peers & lower_lanes)] = key;
  }
}

}  // namespace

extern "C" int bz2t_radix_sort_scratch(int n) {
  return kRadix * ((n + kTile - 1) / kTile);
}

// Sorts n keys by bits [lo_bit, hi_bit), stably; `keys` is left untouched,
// the result lands in `out` (`tmp` is the ping-pong buffer, `hist` holds
// bz2t_radix_sort_scratch(n) counters).
extern "C" int bz2t_radix_sort_u64(const u64* keys, u64* out, u64* tmp, u32* hist,
                                   int n, int lo_bit, int hi_bit,
                                   cudaStream_t stream) {
  const int passes = hi_bit > lo_bit ? (hi_bit - lo_bit + 7) / 8 : 0;
  if (n <= 0 || passes == 0) {
    if (n > 0)
      cudaMemcpyAsync(out, keys, sizeof(u64) * (size_t)n, cudaMemcpyDeviceToDevice,
                      stream);
    return (int)cudaGetLastError();
  }
  const int n_tiles = (n + kTile - 1) / kTile;
  const u64* src = keys;
  for (int p = 0; p < passes; ++p) {
    const int shift = lo_bit + 8 * p;
    const int bits = hi_bit - shift < 8 ? hi_bit - shift : 8;
    const u32 mask = (1u << bits) - 1u;
    u64* dst = ((passes - 1 - p) % 2 == 0) ? out : tmp;  // last pass -> out
    radix_histogram<<<n_tiles, kThreads, 0, stream>>>(src, n, shift, mask, hist,
                                                      n_tiles);
    exclusive_scan<<<1, kScanThreads, 0, stream>>>(hist, kRadix * n_tiles);
    radix_scatter<<<n_tiles, kThreads, 0, stream>>>(src, dst, n, shift, mask, hist,
                                                    n_tiles);
    src = dst;
  }
  return (int)cudaGetLastError();
}
