// K3: MTF rank of every position of a batch of run-collapsed sequences.
//
// Replaces mtf_ranks_pallas (bz2tpu/ops/mtf_pallas.py:71-112), which walks
// the chunks of one block in order with a 256-lane last-occurrence carry in
// VMEM. CUDA blocks run in no order, so the carry takes the closed form of
// _mtf_ranks_batch (bz2tpu/ops/mtf.py:221-243): pass 1 records the last
// local occurrence of every lane in every (block, chunk) slot, pass 2 turns
// them into an exclusive running max over the chunks (seeded with the
// initial list order -(lane+1)), and pass 3 runs one CTA per live slot.
//
// In pass 3, thread u owns lane u's last-occurrence time. For position t
// with symbol s, rank = #{lanes whose last occurrence is later than s's},
// one __syncthreads_count; then the owner of s moves it to the front
// (last[s] = t). The chunk's symbols and ranks stay in shared memory.
//
// Bound on this card: one block barrier per position (latency, not
// bandwidth); the design gets its parallelism from the number of live
// slots (sum over blocks of ceil(m_b / chunk), ~hundreds at level 9).
// Slots at or past m only write zeros.
#include "common.cuh"

namespace {

constexpr int kLanes = 256;  // one thread per MTF list lane
constexpr int kNeg = -(1 << 30);

__global__ void mtf_chunk_last(const int* __restrict__ seq, const int* __restrict__ m,
                               int cap, int chunk, int n_chunks,
                               int* __restrict__ carry) {
  __shared__ int last[kLanes];
  const int b = blockIdx.y;
  const int c = blockIdx.x;
  last[threadIdx.x] = -1;
  __syncthreads();
  const int start = c * chunk;
  const int end = min(min(start + chunk, m[b]), cap);
  const int* row = seq + (size_t)b * cap;
  for (int p = start + threadIdx.x; p < end; p += kLanes)
    atomicMax(&last[row[p]], p - start);
  __syncthreads();
  carry[((size_t)b * n_chunks + c) * kLanes + threadIdx.x] = last[threadIdx.x];
}

__global__ void mtf_carry_scan(int* __restrict__ carry, const int* __restrict__ n_in_use,
                               int chunk, int n_chunks) {
  const int b = blockIdx.x;
  const int lane = threadIdx.x;
  int run = lane < n_in_use[b] ? -(lane + 1) : kNeg;
  int* col = carry + (size_t)b * n_chunks * kLanes + lane;
  for (int c = 0; c < n_chunks; ++c) {
    const int v = col[(size_t)c * kLanes];
    col[(size_t)c * kLanes] = run;
    if (v >= 0) run = max(run, c * chunk + v);
  }
}

__global__ void mtf_rank_chunks(const int* __restrict__ seq, const int* __restrict__ m,
                                const int* __restrict__ carry, int cap, int chunk,
                                int n_chunks, int* __restrict__ ranks) {
  extern __shared__ int smem[];
  __shared__ int last[kLanes];
  int* s_seq = smem;
  int* s_rank = smem + chunk;
  const int b = blockIdx.y;
  const int c = blockIdx.x;
  const int u = threadIdx.x;
  const int start = c * chunk;
  const int len_all = min(chunk, cap - start);
  const int len = max(0, min(len_all, m[b] - start));
  int* out = ranks + (size_t)b * cap + start;
  if (len == 0) {
    for (int p = u; p < len_all; p += kLanes) out[p] = 0;
    return;
  }
  const int* row = seq + (size_t)b * cap + start;
  int mine = carry[((size_t)b * n_chunks + c) * kLanes + u];
  last[u] = mine;
  for (int p = u; p < len; p += kLanes) s_seq[p] = row[p];
  __syncthreads();
  for (int t = 0; t < len; ++t) {
    const int s = s_seq[t];
    // last[s] is stable here: only its owner writes it, after the barrier
    // below, and the next position's symbol differs from s (collapsed).
    const int r = __syncthreads_count(mine > last[s]);
    if (u == 0) s_rank[t] = r;
    if (u == s) {
      mine = start + t;
      last[s] = mine;
    }
  }
  __syncthreads();
  for (int p = u; p < len_all; p += kLanes) out[p] = p < len ? s_rank[p] : 0;
}

}  // namespace

extern "C" int bz2t_mtf_scratch(int batch, int cap, int chunk) {
  return batch * ((cap + chunk - 1) / chunk) * kLanes;
}

// seq: (batch, cap) int32 collapsed dense symbols (adjacent entries
// distinct, -1 padding); n_in_use, m: (batch,) int32; ranks: (batch, cap)
// int32 output, 0 at and past m; scratch: bz2t_mtf_scratch ints.
extern "C" int bz2t_mtf_ranks(const int* seq, const int* n_in_use, const int* m,
                              int batch, int cap, int chunk, int* ranks, int* scratch,
                              cudaStream_t stream) {
  if (batch <= 0 || cap <= 0) return (int)cudaGetLastError();
  const int n_chunks = (cap + chunk - 1) / chunk;
  const dim3 grid(n_chunks, batch);
  mtf_chunk_last<<<grid, kLanes, 0, stream>>>(seq, m, cap, chunk, n_chunks, scratch);
  mtf_carry_scan<<<batch, kLanes, 0, stream>>>(scratch, n_in_use, chunk, n_chunks);
  mtf_rank_chunks<<<grid, kLanes, 2 * chunk * sizeof(int), stream>>>(
      seq, m, scratch, cap, chunk, n_chunks, ranks);
  return (int)cudaGetLastError();
}
