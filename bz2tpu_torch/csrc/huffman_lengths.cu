// D2: length-limited Huffman code lengths, one CTA per table row.
//
// Replaces the device loop of bz2tpu/ops/huffman.py:124-145 (code_lengths,
// vmapped at :148): the lax.scan at :111 over the 257 steps of the
// two-queue merge, inside the depth cap's lax.while_loop at :144. There is
// no pl.pallas_call behind it; under eager torch the same loop is a Python
// loop of ~50 small launches a step (code_lengths_ref in
// bz2tpu_torch/ops/huffman_cuda.py), once per refinement iteration and
// once more per cap retry, with a host sync on each retry.
//
// What it computes, row by row: the leaf depths of the Huffman tree over
// w[i] = max(freq[i], 1), i < alpha (0 beyond); while any depth exceeds
// 17, w <- 1 + (w >> 1) on the row and the tree is rebuilt. Ties break as
// the JAX form's: leaves in stable ascending order of weight (equal weights
// by symbol), and a leaf wins a weight tie against an internal node.
//
// Bound on this card: latency, not bytes (a row reads 4 KB and writes 2
// KB). The merge is serial by nature: each step picks the two lightest
// queue heads that the previous step left. So one thread walks it over
// shared memory, ~257 steps of a few dependent shared loads each, and
// everything around it is parallel and stays on the card:
//   * the stable leaf sort is a counting rank, all threads: a leaf's rank
//     is the number of lighter leaves plus the equal ones at lower index;
//   * a parent is always created after its children, so the internal
//     nodes' depths come from one walk in reverse creation order, and every
//     leaf then looks its depth up in parallel;
//   * the cap retry loops inside the kernel (__syncthreads_or on the
//     over-cap flag), so the host never waits on it.
// Rows are independent CTAs, one per SM (48 rows at the main path's batch
// of 8 blocks x 6 tables). Weights stay int64, as the torch callers hold
// them; no sum can overflow.
#include "common.cuh"

namespace {

constexpr int kAlpha = 258;
constexpr int kThreads = 256;
constexpr int kMaxLength = 17;  // stock bzip2's encoder cap

__global__ void __launch_bounds__(kThreads)
huffman_lengths(const long long* __restrict__ freqs, const long long* __restrict__ alphas,
                long long* __restrict__ out) {
  __shared__ long long w[kAlpha];           // this pass's weights by symbol
  __shared__ long long leaf_w[kAlpha];      // leaf weights, stably sorted
  __shared__ int order[kAlpha];             // symbol of each sorted leaf
  __shared__ long long node_w[kAlpha - 1];  // internal node j's weight
  __shared__ int parent[2 * kAlpha - 1];    // symbol i, internal j at kAlpha + j
  __shared__ int depth_int[kAlpha - 1];     // internal node j's depth
  const int t = threadIdx.x;
  const long long* f = freqs + (size_t)blockIdx.x * kAlpha;
  long long* o = out + (size_t)blockIdx.x * kAlpha;
  const int alpha = (int)alphas[blockIdx.x];
  for (int i = t; i < kAlpha; i += kThreads) w[i] = i < alpha ? max(f[i], 1LL) : 0LL;
  __syncthreads();
  while (true) {
    for (int i = t; i < alpha; i += kThreads) {
      const long long wi = w[i];
      int rank = 0;
      for (int j = 0; j < alpha; ++j) {
        const long long wj = w[j];
        rank += (wj < wi) | ((wj == wi) & (j < i));
      }
      leaf_w[rank] = wi;
      order[rank] = i;
    }
    __syncthreads();
    if (t == 0 && alpha >= 2) {
      int li = 0;  // next unpicked sorted leaf
      int ii = 0;  // next unpicked internal node
      for (int j = 0; j < alpha - 1; ++j) {
        int id[2];
        long long pw[2];
#pragma unroll
        for (int k = 0; k < 2; ++k) {
          const bool leaf_ok = li < alpha;
          const bool node_ok = ii < j;
          const long long lw = leaf_ok ? leaf_w[li] : 0LL;
          const long long nw = node_ok ? node_w[ii] : 0LL;
          if (leaf_ok && (!node_ok || lw <= nw)) {
            id[k] = order[li++];
            pw[k] = lw;
          } else {
            id[k] = kAlpha + ii++;
            pw[k] = nw;
          }
        }
        node_w[j] = pw[0] + pw[1];
        parent[id[0]] = kAlpha + j;
        parent[id[1]] = kAlpha + j;
      }
      depth_int[alpha - 2] = 0;  // the root: the last node created
      for (int j = alpha - 3; j >= 0; --j) depth_int[j] = depth_int[parent[kAlpha + j] - kAlpha] + 1;
    }
    __syncthreads();
    int over = 0;
    for (int i = t; i < alpha; i += kThreads)
      over |= alpha >= 2 && depth_int[parent[i] - kAlpha] + 1 > kMaxLength;
    if (!__syncthreads_or(over)) break;
    for (int i = t; i < alpha; i += kThreads) w[i] = 1 + (w[i] >> 1);
    __syncthreads();
  }
  for (int i = t; i < kAlpha; i += kThreads)
    o[i] = (i < alpha && alpha >= 2) ? depth_int[parent[i] - kAlpha] + 1 : 0;
}

}  // namespace

// freqs: rows x 258 int64 counts; alphas: rows int64 alphabet sizes in
// 0..258; out: rows x 258 int64 code lengths (0 at and beyond alpha).
extern "C" int bz2t_huffman_lengths(const long long* freqs, const long long* alphas,
                                    long long* out, int rows, cudaStream_t stream) {
  if (rows <= 0) return (int)cudaGetLastError();
  huffman_lengths<<<rows, kThreads, 0, stream>>>(freqs, alphas, out);
  return (int)cudaGetLastError();
}
