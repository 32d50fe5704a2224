// block_cuts: stock bzip2's block-fill rule over a chunk's RLE1 pieces.
//
// Replaces the greedy cut loop of the device intake
// (bz2tpu/ops/rle1.py:block_cuts, the lax.fori_loop at :162, body
// :141-160), not a Pallas kernel: XLA keeps its max_blocks steps on the
// device, while eager torch issues each step's search and selects from the
// host. Block b takes the pieces through the first one whose inclusive
// output sum reaches out_cuts[b - 1] + cap (it overshoots by up to 4 bytes),
// or the rest when none does:
//
//   hi = min(first i with piece_out_cum[i] >= base + cap, n_pieces - 1)
//
// clamped at 0; out_cuts[b] = piece_out_cum[hi], raw_cuts[b] =
// piece_raw_cum[hi] while base is below the chunk's output total, and the
// unused slots repeat the final cut. n_pieces is read on the device, so the
// caller never synchronises.
//
// Its bytes are negligible; what bounds it is the latency of max_blocks
// dependent searches over up to n sorted entries. One warp searches
// 32-ary: each lane probes the last entry of one of 32 equal parts, and a
// ballot keeps the first part that reaches the target, so a search takes
// ceil(log32(n)) dependent loads (5 on an 8 MiB chunk) instead of a binary
// search's 23.
#include "common.cuh"

namespace {

// First i in [0, n) with a[i] >= target, or n where there is none (a
// sorted ascending). Every lane of the warp returns the same index.
__device__ long long first_at_least(const int* __restrict__ a, long long n, long long target) {
  const int lane = threadIdx.x & 31;
  long long lo = 0, hi = n;  // the answer lies in [lo, hi]
  while (lo < hi) {
    const long long step = (hi - lo + 31) / 32;
    const long long first = lo + lane * step;
    const bool hit = first < hi && (long long)a[min(first + step, hi) - 1] >= target;
    const u32 mask = __ballot_sync(BZ2T_FULL_MASK, hit);
    if (mask == 0) return hi;  // every entry of [lo, hi) is below the target
    const long long f_first = lo + (long long)(__ffs(mask) - 1) * step;
    hi = min(f_first + step, hi) - 1;  // a[hi] >= target, and a[f_first - 1] < target
    lo = f_first;
  }
  return lo;
}

__global__ void __launch_bounds__(32)
block_cuts(const int* __restrict__ out_cum, const int* __restrict__ raw_cum, long long n,
           const int* __restrict__ n_pieces, long long cap, int max_blocks, int* __restrict__ out_cuts,
           int* __restrict__ raw_cuts, int* __restrict__ n_blocks) {
  const int np = *n_pieces;
  // Indices stay inside the arrays whatever n_pieces says (memory safety).
  const long long last = min(max((long long)np - 1, 0ll), n - 1);
  const long long total = np > 0 ? out_cum[last] : 0;
  long long base = 0;
  int raw = 0, live = 0;
  for (int b = 0; b < max_blocks; ++b) {
    if (base < total) {
      const long long hi = min(max(min(first_at_least(out_cum, n, base + cap), (long long)np - 1), 0ll), n - 1);
      base = out_cum[hi];
      raw = raw_cum[hi];
      ++live;
    }
    if (threadIdx.x == 0) {
      out_cuts[b] = (int)base;
      raw_cuts[b] = raw;
    }
  }
  if (threadIdx.x == 0) *n_blocks = live;
}

}  // namespace

// out_cum, raw_cum: (n,) int32 inclusive per-piece output and raw sums,
// sorted (INT32_MAX past n_pieces); n_pieces: int32 on the device;
// out_cuts, raw_cuts: (max_blocks,) int32 and n_blocks: one int32, written.
extern "C" int bz2t_block_cuts(const int* out_cum, const int* raw_cum, long long n, const int* n_pieces,
                               long long cap, int max_blocks, int* out_cuts, int* raw_cuts, int* n_blocks,
                               cudaStream_t stream) {
  if (n <= 0 || max_blocks <= 0) return (int)cudaErrorInvalidValue;
  block_cuts<<<1, 32, 0, stream>>>(out_cum, raw_cum, n, n_pieces, cap, max_blocks, out_cuts, raw_cuts, n_blocks);
  return (int)cudaGetLastError();
}
