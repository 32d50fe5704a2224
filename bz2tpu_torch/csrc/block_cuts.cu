// block_cuts: stock bzip2's block-fill rule over a chunk's RLE1 pieces.
//
// Replaces the greedy cut loop of the device intake
// (bz2tpu/ops/rle1.py:block_cuts, the lax.fori_loop at :162, body
// :141-160), not a Pallas kernel: XLA keeps its max_blocks steps on the
// device, while eager torch issues each step's search and selects from the
// host. Block b takes the pieces through the first one whose inclusive
// output sum reaches out_cuts[b - 1] + cap, or the rest when none does:
//
//   hi = min(first i with piece_out_cum[i] >= base + cap, n_pieces - 1)
//
// clamped at 0; out_cuts[b] = piece_out_cum[hi], raw_cuts[b] =
// piece_raw_cum[hi] while base is below the chunk's output total, and the
// unused slots repeat the final cut. n_pieces is read on the device, so the
// caller never synchronises.
//
// Its bytes are negligible; what bounds it is the latency of dependent
// loads. Each cut's target is the sum the cut before found plus cap, a
// chain; but a piece's output is 1 to 5 bytes, so a cut overshoots its
// target by at most 4, and cut m of a group that starts at a resolved sum
// B has its target in [B + (m + 1) cap, B + (m + 1) cap + 4 m]. So every cut
// is searched at once:
//   * one CTA, warp 0 plus a warp a cut of the group (up to 31 cuts a
//     group, the groups in turn where max_blocks is larger); warp 0 reads
//     n_pieces and the sums at the last piece meanwhile;
//   * warp 1 + m finds lo_m, the first entry >= B + (m + 1) cap, by a
//     32-ary search (ceil(log32 n) dependent loads: 5 on an 8 MiB chunk;
//     more probes a lane in flight cost more than the steps they save, as
//     the warps of the one CTA share an SM's load path), whose last step
//     also loads the 64 entries after its first probe, with their raw
//     sums: the window of the 4 m + 5 entries from lo_m on lies among them
//     for the first seven cuts of a group (else it is loaded on its own),
//     and goes to shared memory;
//   * each such warp then works out, for every entry of its window, where
//     the next cut lands in the next window (a binary search in shared
//     memory), so that one thread walks the chain with a shared-memory load
//     a cut: where the cut lands, then where its successor does; the cuts
//     are written after the walk, all at once.
// Exact for every sorted input: a cut's answer is never before lo_m (every
// live cut adds at least cap), so a windowed entry at or above the target
// is the answer; where none is and the window stops short of n (steps
// above 5, duplicates), warp 0 searches the rest of the array for it, the
// slow path, which the optional `slow` output counts, and the cuts after
// it look for their answers in their windows by a ballot.
#include "common.cuh"

namespace {

constexpr int kMaxWarps = 32;         // warp 0 and up to 31 cuts a group
constexpr int kGroup = kMaxWarps - 1;
constexpr int kWindows = 2 * kGroup * (kGroup - 1) + 5 * kGroup;  // sum of 4 m + 5 over the group

__device__ __forceinline__ int window_len(int m) { return 4 * m + 5; }
__device__ __forceinline__ int window_at(int m) { return 2 * m * (m - 1) + 5 * m; }

// The 64 entries (and their raw sums) from `at` on, in two registers a
// lane, which a 32-ary search's last step loads beside its probes.
struct Tail {
  long long at = -1;
  int out0, out1, raw0, raw1;
};

// First i in [lo, hi) with a[i] >= target, or hi where there is none (a
// sorted ascending). The warp probes the last entry of each of 32 equal
// parts and keeps the first part that reaches the target; every lane
// returns the same index. With a tail, the last step, whose probes are the
// entries themselves, also loads the 64 entries from its first probe on
// and their raw sums.
__device__ long long first_at_least(const int* __restrict__ a, long long lo, long long hi, long long target,
                                    const int* __restrict__ raw = nullptr, Tail* tail = nullptr) {
  const int lane = threadIdx.x & 31;
  const long long n = hi;
  while (lo < hi) {
    const long long step = (hi - lo + 31) / 32;
    const long long part = lo + (long long)lane * step;
    int val;
    if (tail && step == 1) {
      tail->at = lo;
      tail->out0 = val = a[min(lo + lane, n - 1)];
      tail->out1 = a[min(lo + 32 + lane, n - 1)];
      tail->raw0 = raw[min(lo + lane, n - 1)];
      tail->raw1 = raw[min(lo + 32 + lane, n - 1)];
    } else {
      val = a[part < hi ? min(part + step, hi) - 1 : hi - 1];
    }
    const u32 mask = __ballot_sync(BZ2T_FULL_MASK, part < hi && (long long)val >= target);
    if (mask == 0) return hi;  // every entry of [lo, hi) is below the target
    const long long f_first = lo + (long long)(__ffs(mask) - 1) * step;
    hi = min(f_first + step, hi) - 1;  // a[hi] >= target, and a[f_first - 1] < target
    lo = f_first;
  }
  return lo;
}

// The slow path of a cut whose answer lies past its window: a search of
// the rest of the array. Kept out of line, so that the chain's walk over
// the windows stays a short loop.
__device__ __noinline__ long long past_window(const int* __restrict__ a, long long lo, long long n,
                                              long long target) {
  return first_at_least(a, lo, n, target);
}

__global__ void __launch_bounds__(kMaxWarps * 32)
block_cuts(const int* __restrict__ out_cum, const int* __restrict__ raw_cum, long long n,
           const int* __restrict__ n_pieces, long long cap, int max_blocks, int* __restrict__ out_cuts,
           int* __restrict__ raw_cuts, int* __restrict__ n_blocks, int* __restrict__ slow) {
  __shared__ int w_out[kWindows], w_raw[kWindows];
  __shared__ signed char w_next[kWindows];  // per windowed entry: where its successor lands in the next window
  __shared__ long long w_lo[kGroup];
  __shared__ long long s_base, s_total;
  __shared__ int s_np, s_raw_last, s_first, s_walked, s_k;
  __shared__ int w_pick[kGroup];  // the walk's answer in each cut's window
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, group = (int)(blockDim.x >> 5) - 1;
  // Warp 0's state: the chain's sum and raw sum, live cuts, slow cuts.
  long long base = 0;
  int raw = 0, live = 0, n_slow = 0;
  if (warp == 0) {
    const int np = *n_pieces;
    // Indices stay inside the arrays whatever n_pieces says (memory safety).
    const long long last = min(max((long long)np - 1, 0ll), n - 1);
    if (lane == 0) {
      s_np = np;
      s_total = np > 0 ? out_cum[last] : 0;
      s_raw_last = raw_cum[last];
      s_base = 0;
    }
  }
  for (int b0 = 0; b0 < max_blocks; b0 += group) {
    const bool speculate = warp > 0 && b0 + warp - 1 < max_blocks && (b0 == 0 || s_base < s_total);
    const long long group_base = b0 ? s_base : 0;
    const int m = warp - 1;
    if (speculate) {
      Tail tail;
      const long long lo = first_at_least(out_cum, 0, n, group_base + (long long)(m + 1) * cap, raw_cum, &tail);
      const int len = (int)min((long long)window_len(m), n - lo);
      if (lane == 0) w_lo[m] = lo;
      if (tail.at >= 0 && lo - tail.at + len <= 64) {
        // The window is among the tail's 64 entries: no load of its own.
        for (int i0 = 0; i0 < len; i0 += 32) {
          const int src = (int)(lo - tail.at) + i0 + lane;
          const int o0 = __shfl_sync(BZ2T_FULL_MASK, tail.out0, src & 31);
          const int o1 = __shfl_sync(BZ2T_FULL_MASK, tail.out1, src & 31);
          const int r0 = __shfl_sync(BZ2T_FULL_MASK, tail.raw0, src & 31);
          const int r1 = __shfl_sync(BZ2T_FULL_MASK, tail.raw1, src & 31);
          if (i0 + lane < len) {
            w_out[window_at(m) + i0 + lane] = src < 32 ? o0 : o1;
            w_raw[window_at(m) + i0 + lane] = src < 32 ? r0 : r1;
          }
        }
      } else {
        for (int i = lane; i < len; i += 32) {
          w_out[window_at(m) + i] = out_cum[lo + i];
          w_raw[window_at(m) + i] = raw_cum[lo + i];
        }
      }
    }
    __syncthreads();
    // For each windowed entry of cut m, the first entry of cut m + 1's
    // window at or above it + cap (-1: none there), so that the walk below
    // is one shared-memory load a cut; and for the group's first cut, the
    // first entry at or above its start + cap.
    if (speculate) {
      const int len = (int)min((long long)window_len(m), n - w_lo[m]);
      const bool has_next = m + 1 < group && b0 + m + 1 < max_blocks;
      const int len_next = has_next ? (int)min((long long)window_len(m + 1), n - w_lo[m + 1]) : 0;
      const int* wn = w_out + window_at(m + 1);
      for (int k = lane; k <= len; k += 32) {
        // k == len stands for the group's start (cut m == 0 only).
        if (k == len && m != 0) break;
        const long long tgt = (k == len ? group_base : (long long)w_out[window_at(m) + k]) + cap;
        const int* w = k == len ? w_out + window_at(0) : wn;
        int a = 0, b = k == len ? len : len_next;
        while (a < b) {
          const int mid = (a + b) >> 1;
          if ((long long)w[mid] >= tgt) b = mid; else a = mid + 1;
        }
        const int found = a < (k == len ? len : len_next) ? a : -1;
        if (k == len) s_first = found; else w_next[window_at(m) + k] = (signed char)found;
      }
    }
    __syncthreads();
    if (warp == 0) {
      const int np = s_np;
      const long long total = s_total;
      const long long last = min(max((long long)np - 1, 0ll), n - 1);
      // The walk while every cut's answer is windowed: lane 0 follows the
      // successors, one shared-memory load a cut, up to the first cut it
      // cannot take so (a clamp, a window that misses, the end of the
      // chunk's output); the warp writes those cuts at once, and the loop
      // below takes the rest.
      const int cuts = min(group, max_blocks - b0);
      if (lane == 0) {
        int k = s_first, m = 0;
        for (long long b = base; m < cuts && b < total && k >= 0 && w_lo[m] + k <= (long long)np - 1; ++m) {
          w_pick[m] = k;
          b = w_out[window_at(m) + k];
          k = w_next[window_at(m) + k];
        }
        s_walked = m;
        s_k = k;
      }
      __syncwarp();
      const int walked = s_walked;
      for (int m = lane; m < walked; m += 32) {
        out_cuts[b0 + m] = w_out[window_at(m) + w_pick[m]];
        raw_cuts[b0 + m] = w_raw[window_at(m) + w_pick[m]];
      }
      if (walked > 0) {
        base = w_out[window_at(walked - 1) + w_pick[walked - 1]];
        raw = w_raw[window_at(walked - 1) + w_pick[walked - 1]];
        live += walked;
      }
      int k = s_k;  // the next cut's answer in its window, where known (-1: search the window)
      for (int m = walked; m < cuts; ++m) {
        if (base < total && k >= 0) {
          // The answer is windowed entry k: a shared-memory load a cut.
          if (w_lo[m] + k <= (long long)np - 1) {
            base = w_out[window_at(m) + k];
            raw = w_raw[window_at(m) + k];
            k = w_next[window_at(m) + k];
          } else {  // past the last piece: the cut clamps to it
            base = total;
            raw = s_raw_last;
            k = -1;
          }
          ++live;
        } else if (base < total) {
          const long long target = base + cap, lo = w_lo[m];
          const int len = (int)min((long long)window_len(m), n - lo);
          const int* wo = w_out + window_at(m);
          long long found = -1;
          for (int i0 = 0; i0 < len && found < 0; i0 += 32) {
            const u32 mask = __ballot_sync(BZ2T_FULL_MASK, i0 + lane < len && (long long)wo[i0 + lane] >= target);
            if (mask) found = lo + i0 + __ffs(mask) - 1;
          }
          if (found < 0) {
            found = n;
            if (lo + len < n) {
              found = past_window(out_cum, lo + len, n, target);
              ++n_slow;
            }
          }
          const long long hi = min(max(min(found, (long long)np - 1), 0ll), n - 1);
          k = -1;
          if (hi >= lo && hi < lo + len) {
            base = wo[hi - lo];
            raw = w_raw[window_at(m) + (hi - lo)];
            k = w_next[window_at(m) + (hi - lo)];
          } else if (hi == last) {
            base = total;
            raw = s_raw_last;
          } else {
            base = out_cum[hi];
            raw = raw_cum[hi];
          }
          ++live;
        }
        if (lane == 0) {
          out_cuts[b0 + m] = (int)base;
          raw_cuts[b0 + m] = raw;
        }
      }
      if (lane == 0) s_base = base;
    }
    __syncthreads();
  }
  if (threadIdx.x == 0) {
    *n_blocks = live;
    if (slow) *slow = n_slow;
  }
}

}  // namespace

// out_cum, raw_cum: (n,) int32 inclusive per-piece output and raw sums,
// sorted (INT32_MAX past n_pieces); n_pieces: int32 on the device;
// out_cuts, raw_cuts: (max_blocks,) int32 and n_blocks: one int32, written;
// slow: one int32, the cuts that searched past their window, or null.
extern "C" int bz2t_block_cuts(const int* out_cum, const int* raw_cum, long long n, const int* n_pieces,
                               long long cap, int max_blocks, int* out_cuts, int* raw_cuts, int* n_blocks, int* slow,
                               cudaStream_t stream) {
  if (n <= 0 || max_blocks <= 0) return (int)cudaErrorInvalidValue;
  const int warps = 1 + (max_blocks < kGroup ? max_blocks : kGroup);
  block_cuts<<<1, 32 * warps, 0, stream>>>(out_cum, raw_cum, n, n_pieces, cap, max_blocks, out_cuts, raw_cuts,
                                          n_blocks, slow);
  return (int)cudaGetLastError();
}
