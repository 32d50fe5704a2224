// dec_chain: the serial chain of Huffman group starts of a batch of blocks.
//
// Replaces the lax.fori_loop of the jump-map decode
// (bz2tpu/ops/huffman_dec.py:231-239), not a Pallas kernel: XLA keeps that
// loop on the device, while eager torch would pay several host launches
// for each of up to 18,002 groups a block. Group g of block b starts where
// 50 symbols of its table from the previous start end:
//
//   starts[b][g] = cur;  if (g < n_groups[b]) cur = jump50[b][tbl[b][g]][cur]
//
// The chain is serial by nature, so one thread walks one block: the
// kernel removes launches, not arithmetic. Its bound is the latency of
// one dependent load from device memory per group; the table ids are
// independent loads the compiler may issue ahead.
#include "common.cuh"

namespace {

__global__ void dec_chain(const int* __restrict__ jump50, const int* __restrict__ tbl,
                          const int* __restrict__ n_groups, int batch, int n_tables,
                          int nbc, int groups, int* __restrict__ starts) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= batch) return;
  const int ng = n_groups[b];
  const int* row_tbl = tbl + (size_t)b * groups;
  const int* maps = jump50 + (size_t)b * n_tables * nbc;
  int* out = starts + (size_t)b * groups;
  int cur = 0;
  for (int g = 0; g < groups; ++g) {
    out[g] = cur;
    if (g < ng) {
      const int t = min(max(row_tbl[g], 0), n_tables - 1);
      cur = maps[(size_t)t * nbc + min(max(cur, 0), nbc - 1)];
    }
  }
}

}  // namespace

// jump50: (batch, n_tables, nbc) int32 relative 50-symbol jump maps;
// tbl: (batch, groups) int32 table per group; n_groups: (batch,) int32;
// starts: (batch, groups) int32 output, each block's final position
// repeated at and past its n_groups.
extern "C" int bz2t_dec_chain(const int* jump50, const int* tbl, const int* n_groups,
                              int batch, int n_tables, int nbc, int groups, int* starts,
                              cudaStream_t stream) {
  if (batch <= 0 || groups <= 0) return (int)cudaGetLastError();
  constexpr int kThreads = 32;
  dec_chain<<<(batch + kThreads - 1) / kThreads, kThreads, 0, stream>>>(
      jump50, tbl, n_groups, batch, n_tables, nbc, groups, starts);
  return (int)cudaGetLastError();
}
