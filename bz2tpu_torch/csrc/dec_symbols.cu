// dec_symbols: the 50 symbols of every Huffman group of a batch of blocks,
// each group decoded from its known start bit.
//
// Replaces the second lax.fori_loop of the jump-map decode
// (bz2tpu/ops/huffman_dec.py:247-267), not a Pallas kernel: XLA keeps its
// 50 steps on the device, while eager torch issues some 30 launches for
// each of them. Step 4 of ops/huffman_dec.py: with the group starts from
// dec_chain, a group's symbols no longer depend on any other group's, so
// one thread walks one (block, group) pair through its 50 codes:
//
//   v   = the 23-bit big-endian window at bit pos (one 32-bit word a byte)
//   len = lut[lut_idx[b][t]][v >> 3]            (> 20: no code, length 1)
//   sym = perm[b][t][(v >> (23 - len)) - base[b][t][len]]   (-2 if outside)
//   pos += len
//
// Every step depends on the length the step before found, so a thread's
// walk is a chain of two dependent loads a symbol (the window word, then
// the LUT byte); the batch's tens of thousands of groups keep enough
// chains in flight to hide their latency. The LUT rows (1 MiB each, up to
// 1 + 6 x 8 of them) are read at random, a byte a symbol; the window words
// are read in order and stay in L1. The block's canonical tables (base and
// perm of up to six tables, 6.7 kB) sit in shared memory, one CTA a tile
// of kThreads groups of one block.
//
// The bound is the bytes it must write: two int32 a symbol (the symbol and
// its length) against about one byte read. What holds it back is the
// latency of the two dependent loads a step, and the 200-byte stride
// between neighbouring threads' stores.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;  // groups a CTA
constexpr int kGroup = 50;     // symbols a group
constexpr int kTables = 6;     // at most six tables a block
constexpr int kLens = 21;      // base entries a table (lengths 0..20)
constexpr int kAlpha = 258;    // perm entries a table
constexpr int kMaxLen = 20;    // longer codes are invalid
constexpr int kLutBits = 20;   // a LUT row is indexed by the top 20 window bits

__global__ void __launch_bounds__(kThreads)
dec_symbols(const long long* __restrict__ words, long long n_words, const long long* __restrict__ offs,
            const int* __restrict__ tbl, const signed char* __restrict__ lut, int n_rows,
            const int* __restrict__ lut_idx, const int* __restrict__ base, const int* __restrict__ perm,
            int n_tables, int groups, int* __restrict__ syms, int* __restrict__ lens) {
  __shared__ int s_base[kTables * kLens];
  __shared__ int s_perm[kTables * kAlpha];
  __shared__ long long s_row[kTables];
  const int b = blockIdx.y;
  const int T = n_tables;
  for (int i = threadIdx.x; i < T * kLens; i += kThreads) s_base[i] = base[(size_t)b * T * kLens + i];
  for (int i = threadIdx.x; i < T * kAlpha; i += kThreads) s_perm[i] = perm[(size_t)b * T * kAlpha + i];
  if (threadIdx.x < T)
    s_row[threadIdx.x] = (long long)min(max(lut_idx[b * T + threadIdx.x], 0), n_rows - 1) << kLutBits;
  __syncthreads();
  const int g = blockIdx.x * kThreads + threadIdx.x;
  if (g >= groups) return;
  const size_t at = (size_t)b * groups + g;
  const int t = min(max(tbl[at], 0), T - 1);
  const signed char* row = lut + s_row[t];
  const int* tb = s_base + t * kLens;
  const int* tp = s_perm + t * kAlpha;
  int* out_s = syms + at * kGroup;
  int* out_l = lens + at * kGroup;
  long long pos = offs[at];
#pragma unroll 5
  for (int i = 0; i < kGroup; ++i) {
    const long long w = words[min(max(pos >> 3, 0ll), n_words - 1)];
    const long long v = (w >> (9 - (pos & 7))) & ((1ll << 23) - 1);
    int len = row[v >> 3];
    const bool matched = len <= kMaxLen;
    len = matched ? max(len, 1) : 1;
    const long long pidx = (v >> (23 - len)) - tb[len];
    const bool bad = !matched || pidx < 0 || pidx >= kAlpha;
    out_s[i] = bad ? -2 : tp[bad ? 0 : (int)pidx];
    out_l[i] = len;
    pos += len;
  }
}

}  // namespace

// words: (n_words,) int64 window words of the stream; offs: (batch, groups)
// int64 absolute start bit of each group; tbl: (batch, groups) int32 table
// per group; lut: (n_rows, 2^20) int8 code lengths; lut_idx: (batch,
// n_tables) int32 LUT row per table; base: (batch, n_tables, 21) and perm:
// (batch, n_tables, 258) int32 canonical tables. syms, lens: (batch, groups
// * 50) int32 outputs.
extern "C" int bz2t_dec_symbols(const long long* words, long long n_words, const long long* offs, const int* tbl,
                                const signed char* lut, int n_rows, const int* lut_idx, const int* base,
                                const int* perm, int batch, int n_tables, int groups, int* syms, int* lens,
                                cudaStream_t stream) {
  if (batch <= 0 || groups <= 0) return (int)cudaGetLastError();
  if (n_tables < 1 || n_tables > kTables || n_rows < 1 || n_words < 1 || batch > 65535)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((groups + kThreads - 1) / kThreads, batch);
  dec_symbols<<<grid, kThreads, 0, stream>>>(words, n_words, offs, tbl, lut, n_rows, lut_idx, base, perm, n_tables,
                                             groups, syms, lens);
  return (int)cudaGetLastError();
}
