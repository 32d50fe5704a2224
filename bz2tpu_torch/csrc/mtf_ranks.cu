// K3: MTF rank of every position of a batch of run-collapsed sequences.
//
// Replaces mtf_ranks_pallas (bz2tpu/ops/mtf_pallas.py:71-112), which walks
// the chunks of one block in order with a 256-lane last-occurrence carry in
// VMEM. The rank of position t with symbol s is the number of list lanes
// whose last occurrence before t is later than s's, with never-seen lanes
// at the virtual times -(lane + 1) (the initial list order) and lanes
// outside the alphabet far below.
//
// Bound on this card: instruction issue, not bytes (some fifty instructions
// for two positions of a block that uses 128 list lanes, and the SMs issue
// them back to back). The list is a serial dependence along a block, so
// the design cuts each block into chunks that run in parallel and gets
// each chunk's starting list from a parallel max-scan:
//   * a WARP owns a chunk, with the 256 last-occurrence times in a table
//     of its own in shared memory. A step ranks two positions: the lookup
//     of both symbols' times, one vector load of the thread's share of the
//     table (only as many list lanes as the block's alphabet needs), a
//     subtraction and a shift-and-add per entry and position, one warp sum
//     (__reduce_add_sync) for both counts, and the two new times stored:
//     warp-level synchronisation only, no block barrier. (Keeping the
//     times in registers instead costs the owner lane's update of one of
//     eight registers, more instructions than the vector load.);
//   * kWarps consecutive chunks of a block form a segment, one CTA. The
//     carry into a segment is an exclusive max-scan over the segments'
//     last-occurrence vectors: pass 1 writes each live segment's vector,
//     pass 2 scans them, in parallel over the segments (each warp folds a
//     run of segments, the warp totals are scanned, each warp rewrites its
//     run), pass 3 recomputes its chunks' vectors, scans them over its
//     warps in shared memory and ranks;
//   * only live segments get work: every CTA derives the prefix of the
//     blocks' live segment counts from m on the device and strides over
//     those items, so neither the host nor the grid needs m. Ranks at and
//     past m are zeroed by one memset.
#include "common.cuh"

namespace {

constexpr int kLanes = 256;  // MTF list lanes
constexpr int kWarps = 16;   // chunks a segment: one CTA of passes 1 and 3
constexpr int kThreads = kWarps * 32;
constexpr int kRankCtasPerSM = 3;
constexpr int kScanWarps = 32;
constexpr int kNeg = -(1 << 30);  // below every time: "never", and lanes outside the alphabet

__device__ __forceinline__ int live_length(const int* __restrict__ m, int b, int cap) {
  return min(max(m[b], 0), cap);
}

// s_start[0 .. batch]: the exclusive prefix over the blocks of their live
// segments (segments that begin below m), by warp 0; then a barrier.
__device__ void live_segment_starts(const int* __restrict__ m, int batch, int cap, int seg_len,
                                    int* s_start) {
  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
    int carry = 0;
    for (int b0 = 0; b0 < batch; b0 += 32) {
      const int b = b0 + lane;
      const int v = b < batch ? (live_length(m, b, cap) + seg_len - 1) / seg_len : 0;
      int incl = v;
      for (int o = 1; o < 32; o <<= 1) {
        const int x = __shfl_up_sync(BZ2T_FULL_MASK, incl, o);
        if (lane >= o) incl += x;
      }
      if (b < batch) s_start[b] = carry + incl - v;
      carry += __shfl_sync(BZ2T_FULL_MASK, incl, 31);
    }
    if (lane == 0) s_start[batch] = carry;
  }
  __syncthreads();
}

// The block of live segment `item`: the largest b with s_start[b] <= item.
__device__ __forceinline__ int block_of(const int* s_start, int batch, int item) {
  int lo = 0, hi = batch - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (s_start[mid] <= item) lo = mid;
    else hi = mid - 1;
  }
  return lo;
}

// last[0, 256) of one warp: the time of each list lane's last occurrence in
// row[start, start + len), kNeg where it has none.
__device__ __forceinline__ void chunk_last(const int* __restrict__ row, int start, int len,
                                           int* last) {
  const int lane = threadIdx.x & 31;
  for (int k = lane; k < kLanes; k += 32) last[k] = kNeg;
  __syncwarp();
  for (int p = lane; p < len; p += 32) atomicMax(&last[row[start + p] & (kLanes - 1)], start + p);
  __syncwarp();
}

// Pass 1: per live segment, the last occurrence of every list lane in it.
__global__ void __launch_bounds__(kThreads)
mtf_segment_last(const int* __restrict__ seq, const int* __restrict__ m, int batch, int cap,
                 int chunk, int n_segs, int* __restrict__ carry) {
  extern __shared__ int s_start[];
  __shared__ __align__(16) int s_last[kWarps][kLanes];
  live_segment_starts(m, batch, cap, kWarps * chunk, s_start);
  const int warp = threadIdx.x >> 5;
  for (int item = blockIdx.x; item < s_start[batch]; item += gridDim.x) {
    const int b = block_of(s_start, batch, item);
    const int seg = item - s_start[b];
    const int start = (seg * kWarps + warp) * chunk;
    const int len = max(0, min(chunk, live_length(m, b, cap) - start));
    chunk_last(seq + (size_t)b * cap, start, len, s_last[warp]);
    __syncthreads();
    if (threadIdx.x < kLanes) {
      int v = kNeg;
      for (int w = 0; w < kWarps; ++w) v = max(v, s_last[w][threadIdx.x]);
      carry[((size_t)b * n_segs + seg) * kLanes + threadIdx.x] = v;
    }
    __syncthreads();
  }
}

// Pass 2: per block and list lane, the segments' last occurrences become
// their exclusive running max over the block's live segments, seeded with
// the initial list order. A CTA takes 32 list lanes of one block (a row of
// them is one 128-byte line); warp w folds the w-th run of segments.
__global__ void __launch_bounds__(kScanWarps * 32)
mtf_segment_scan(int* __restrict__ carry, const int* __restrict__ n_in_use,
                 const int* __restrict__ m, int cap, int seg_len, int n_segs) {
  __shared__ int s_total[kScanWarps][32];
  const int b = blockIdx.y;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int col = blockIdx.x * 32 + lane;
  const int live = (live_length(m, b, cap) + seg_len - 1) / seg_len;
  const int per_warp = (live + kScanWarps - 1) / kScanWarps;
  const int first = min(warp * per_warp, live);
  const int last = min(first + per_warp, live);
  int* column = carry + (size_t)b * n_segs * kLanes + col;
  int total = kNeg;
  for (int s = first; s < last; ++s) total = max(total, column[(size_t)s * kLanes]);
  s_total[warp][lane] = total;
  __syncthreads();
  int run = col < n_in_use[b] ? -(col + 1) : kNeg;
  for (int w = 0; w < warp; ++w) run = max(run, s_total[w][lane]);
  for (int s = first; s < last; ++s) {
    const int v = column[(size_t)s * kLanes];
    column[(size_t)s * kLanes] = run;
    run = max(run, v);
  }
}

// Every time lies in [-2^30, 2^30), so ls - a cannot overflow and its sign
// bit says a > ls: a subtraction and a shift-and-add, with no predicate.
__device__ __forceinline__ int later_than(int a, int ls) { return (int)((unsigned)(ls - a) >> 31); }

// A thread's share of one warp's table, V list lanes in one or two vector
// loads (32 V lanes cover the block's alphabet): how many of them are later
// than ls0, and in the upper half-word how many are later than ls1.
template <int V>
__device__ __forceinline__ int count_later(const int* last, int lane, int ls0, int ls1) {
  int c0 = 0, c1 = 0;
  const auto count = [&](int a) {
    c0 += later_than(a, ls0);
    c1 += later_than(a, ls1);
  };
  if (V == 1) {
    count(last[lane]);
  } else if (V == 2) {
    const int2 a = reinterpret_cast<const int2*>(last)[lane];
    count(a.x), count(a.y);
  } else {
    const int4 a = reinterpret_cast<const int4*>(last)[lane];
    count(a.x), count(a.y), count(a.z), count(a.w);
    if (V == 6) {
      const int2 b = reinterpret_cast<const int2*>(last + 128)[lane];
      count(b.x), count(b.y);
    }
    if (V == 8) {
      const int4 b = reinterpret_cast<const int4*>(last + 128)[lane];
      count(b.x), count(b.y), count(b.z), count(b.w);
    }
  }
  return c0 | (c1 << 16);
}

// Positions j and j + 1 of the staged symbols in one step: both symbols'
// last occurrences are looked up, every thread counts its share of the
// table against both, and one warp sum carries both counts. The second
// position sees the first one's symbol at the front: that symbol counts
// once, whether or not it did before (adjacent symbols differ). Lanes j and
// j + 1 keep the ranks. The __syncwarp orders every lane's reads before
// any lane's stores; every lane stores the same new times, so each reads
// its own stores back and none waits for another's.
template <int V>
__device__ __forceinline__ void rank_pair(int* last, const int* syms, int j, int lane, int time,
                                          int& keep) {
  const int s0 = syms[j], s1 = syms[j + 1];
  const int ls0 = last[s0], ls1 = last[s1];
  const int r = __reduce_add_sync(BZ2T_FULL_MASK, count_later<V>(last, lane, ls0, ls1));
  if (lane == j) keep = r & 0xffff;
  if (lane == j + 1) keep = (r >> 16) + 1 - later_than(ls0, ls1);
  __syncwarp();
  last[s0] = time;
  last[s1] = time + 1;
}

template <int V>
__device__ __forceinline__ void rank_single(int* last, const int* syms, int j, int lane, int time,
                                            int& keep) {
  const int s = syms[j];
  const int ls = last[s];
  const int r = __reduce_add_sync(BZ2T_FULL_MASK, count_later<V>(last, lane, ls, ls));
  if (lane == j) keep = r & 0xffff;
  __syncwarp();
  last[s] = time;
}

// The ranks of one chunk by one warp. `last` holds the chunk's starting
// list (each lane's last occurrence before `start`) and then follows the
// chunk; `syms` stages 32 symbols at a time.
template <int V>
__device__ __forceinline__ void rank_chunk(const int* __restrict__ row, int* __restrict__ out,
                                           int start, int len, int* last, int* syms) {
  const int lane = threadIdx.x & 31;
  int sym = lane < len ? row[start + lane] & (kLanes - 1) : 0;
  for (int t0 = 0; t0 < len; t0 += 32) {
    syms[lane] = sym;
    __syncwarp();
    const int ahead = t0 + 32 + lane;
    sym = ahead < len ? row[start + ahead] & (kLanes - 1) : 0;
    const int steps = min(32, len - t0);
    int keep = 0;  // lane j keeps the rank of position t0 + j
    if (steps == 32) {
#pragma unroll
      for (int j = 0; j < 32; j += 2) rank_pair<V>(last, syms, j, lane, start + t0 + j, keep);
    } else {
      int j = 0;
      for (; j + 1 < steps; j += 2) rank_pair<V>(last, syms, j, lane, start + t0 + j, keep);
      if (j < steps) rank_single<V>(last, syms, j, lane, start + t0 + j, keep);
    }
    if (lane < steps) out[start + t0 + lane] = keep;
    __syncwarp();  // syms is rewritten
  }
}

// Pass 3: per live segment, each warp ranks its chunk.
__global__ void __launch_bounds__(kThreads, kRankCtasPerSM)
mtf_rank_segments(const int* __restrict__ seq, const int* __restrict__ n_in_use,
                  const int* __restrict__ m, const int* __restrict__ carry, int batch, int cap,
                  int chunk, int n_segs, int* __restrict__ ranks) {
  extern __shared__ int s_start[];
  __shared__ __align__(16) int s_last[kWarps][kLanes];
  __shared__ int s_syms[kWarps][32];
  live_segment_starts(m, batch, cap, kWarps * chunk, s_start);
  const int warp = threadIdx.x >> 5;
  for (int item = blockIdx.x; item < s_start[batch]; item += gridDim.x) {
    const int b = block_of(s_start, batch, item);
    const int seg = item - s_start[b];
    const int start = (seg * kWarps + warp) * chunk;
    const int len = max(0, min(chunk, live_length(m, b, cap) - start));
    const int* row = seq + (size_t)b * cap;
    chunk_last(row, start, len, s_last[warp]);
    __syncthreads();
    // Each chunk's vector becomes the list it starts from: the carry into
    // the segment, then the chunks before it.
    if (threadIdx.x < kLanes) {
      int run = carry[((size_t)b * n_segs + seg) * kLanes + threadIdx.x];
      for (int w = 0; w < kWarps; ++w) {
        const int v = s_last[w][threadIdx.x];
        s_last[w][threadIdx.x] = run;
        run = max(run, v);
      }
    }
    __syncthreads();
    if (len > 0) {
      int* out = ranks + (size_t)b * cap;
      const int alphabet = n_in_use[b];
      if (alphabet <= 32) rank_chunk<1>(row, out, start, len, s_last[warp], s_syms[warp]);
      else if (alphabet <= 64) rank_chunk<2>(row, out, start, len, s_last[warp], s_syms[warp]);
      else if (alphabet <= 128) rank_chunk<4>(row, out, start, len, s_last[warp], s_syms[warp]);
      else if (alphabet <= 192) rank_chunk<6>(row, out, start, len, s_last[warp], s_syms[warp]);
      else rank_chunk<8>(row, out, start, len, s_last[warp], s_syms[warp]);
    }
    __syncthreads();  // s_last is rewritten by the next item
  }
}

int segments(int cap, int chunk) { return (cap + kWarps * chunk - 1) / (kWarps * chunk); }

// CTAs of pass 3 the card holds at once: the grid of passes 1 and 3.
int resident_ctas(size_t shared_bytes) {
  int device = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, mtf_rank_segments, kThreads,
                                                shared_bytes);
  return sms * (per_sm > 0 ? per_sm : 1);
}

}  // namespace

// Scratch words: one 256-lane vector a (block, segment); -1 where that
// count does not fit an int.
extern "C" int bz2t_mtf_scratch(int batch, int cap, int chunk) {
  const long long words = (long long)batch * segments(cap, chunk) * kLanes;
  return words <= 0x7fffffffLL ? (int)words : -1;
}

// seq: (batch, cap) int32 collapsed dense symbols (adjacent entries
// distinct, -1 padding); n_in_use, m: (batch,) int32; ranks: (batch, cap)
// int32 output, 0 at and past m; scratch: bz2t_mtf_scratch ints.
extern "C" int bz2t_mtf_ranks(const int* seq, const int* n_in_use, const int* m,
                              int batch, int cap, int chunk, int* ranks, int* scratch,
                              cudaStream_t stream) {
  if (batch <= 0 || cap <= 0) return (int)cudaGetLastError();
  if (chunk < 1) return (int)cudaErrorInvalidValue;
  const int n_segs = segments(cap, chunk);
  const size_t shared = sizeof(int) * (size_t)(batch + 1);
  const long long items = (long long)batch * n_segs;
  const int resident = resident_ctas(shared);
  const int grid = items < resident ? (int)items : resident;
  cudaMemsetAsync(ranks, 0, sizeof(int) * (size_t)batch * cap, stream);
  mtf_segment_last<<<grid, kThreads, shared, stream>>>(seq, m, batch, cap, chunk, n_segs,
                                                       scratch);
  mtf_segment_scan<<<dim3(kLanes / 32, batch), kScanWarps * 32, 0, stream>>>(
      scratch, n_in_use, m, cap, kWarps * chunk, n_segs);
  mtf_rank_segments<<<grid, kThreads, shared, stream>>>(seq, n_in_use, m, scratch, batch, cap,
                                                        chunk, n_segs, ranks);
  return (int)cudaGetLastError();
}
