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
//   v   = the 23-bit big-endian window at bit pos
//   len = lut[lut_idx[b][t]][v >> 3]            (> 20: no code, length 1)
//   sym = perm[b][t][(v >> (23 - len)) - base[b][t][len]]   (-2 if outside)
//   pos += len
//
// The first design read a byte of a 1 MiB LUT row at random for every
// symbol (3.5M reads over 49 MiB on the largest batch, about the L2's
// size) and stored each symbol's two int32 to its own 32-byte sector; on
// the card the stores cost three quarters of its time and the LUT reads
// half (tools/probe_dec_kernels.py times it with each cut out). This
// design moves neither through device memory a symbol:
//
//   1. lut_first_level, once a call, reads each LUT row once and keeps,
//      for each of its 2^kFirstBits buckets of 2^(20 - kFirstBits)
//      entries, the length where all of the bucket's entries agree on it,
//      else 0. It compares the lengths as the step uses them (above 20:
//      21, "no code"; below 1: 1), so it is exact for any LUT, monotone or
//      not; in a real table only codes longer than kFirstBits bits share a
//      bucket with another length (1.8% of the symbols of the largest
//      batch at 10 bits), and a warp whose buckets each hold one byte
//      value skips the byte-wise min and max.
//   2. dec_symbols: a CTA loads its block's T first-level tables (1 KiB
//      each) into shared memory with the canonical tables, every load
//      issued before the first store, and reads the 1 MiB row only for a
//      window in a marked bucket (an L2 hit mostly: the first pass has
//      just read the row). A CTA takes 32 kWarps groups of one block.
//   3. Each thread keeps 64 bits of the stream in two registers and the
//      next three 32-bit words in three more, refilled from `words` (the
//      big-endian word at each byte, window_words form) four bytes at a
//      time, three refills ahead: no load sits on the chain of a code's
//      length. A group that starts before the stream or whose words could
//      reach its last 148 bytes reads each window as the plain gather does,
//      clamped.
//   4. Symbols and lengths collect in shared memory, a warp's 32
//      consecutive groups at a time (1,600 entries of each output, in
//      order), and the warp writes them in whole 128-byte lines.
//
// The bound is the bytes it must move: two int32 written a symbol, the
// window words and LUT entries its codes reach, the tables. What is left is
// the decode's chain of dependent steps (a third of the time), the first
// pass over the LUT rows (a third) and the writes.
#include "common.cuh"

namespace {

#ifndef BZ2T_D3_FIRST_BITS
#define BZ2T_D3_FIRST_BITS 10
#endif
#ifndef BZ2T_D3_WARPS
#define BZ2T_D3_WARPS 4
#endif

constexpr int kFirstBits = BZ2T_D3_FIRST_BITS;  // first-level index bits (10-16)
constexpr int kWarps = BZ2T_D3_WARPS;            // warps a CTA, 32 groups each
constexpr int kThreads = 32 * kWarps;
constexpr int kGroup = 50;     // symbols a group
constexpr int kSpan = 32 * kGroup;  // symbols a warp
constexpr int kTables = 6;     // at most six tables a block
constexpr int kLens = 21;      // base entries a table (lengths 0..20)
constexpr int kAlpha = 258;    // perm entries a table
constexpr int kMaxLen = 20;    // longer codes are invalid
constexpr int kLutBits = 20;   // a LUT row is indexed by the top 20 window bits
constexpr int kFirst = 1 << kFirstBits;                // first-level entries a row
constexpr int kBucket = 1 << (kLutBits - kFirstBits);  // LUT entries a bucket
constexpr int kBucketLanes = kBucket / 16 < 32 ? kBucket / 16 : 32;  // lanes a bucket, 16 B or more each
constexpr int kLaneBytes = kBucket / kBucketLanes;
static_assert(kFirstBits >= 10 && kFirstBits <= 16, "a bucket spans 16 B to 1 KiB");

// A LUT byte as the step uses it: above 20 -> 21 (no code), below 1 -> 1;
// four at once in step_lengths4.
__device__ __forceinline__ u32 step_length(u32 byte) {
  const int x = (signed char)byte;
  return x > kMaxLen ? kMaxLen + 1 : max(x, 1);
}
__device__ __forceinline__ u32 step_lengths4(u32 x) { return __vmaxs4(__vmins4(x, 0x15151515u), 0x01010101u); }

__global__ void __launch_bounds__(256)
lut_first_level(const signed char* __restrict__ lut, long long n_buckets, unsigned char* __restrict__ first) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long bucket = t / kBucketLanes;
  const bool live = bucket < n_buckets;
  const int lane = threadIdx.x & 31, leader = lane & ~(kBucketLanes - 1);
  uint4 v[kLaneBytes / 16];
  const uint4* p = reinterpret_cast<const uint4*>(lut + bucket * kBucket + (t % kBucketLanes) * kLaneBytes);
#pragma unroll
  for (int i = 0; i < kLaneBytes / 16; ++i) v[i] = live ? p[i] : make_uint4(0, 0, 0, 0);
  // A real table's buckets mostly hold one byte value: if every bucket of
  // the warp does, its length is that byte's.
  const u32 head = __shfl_sync(BZ2T_FULL_MASK, v[0].x, leader) & 0xffu;
  const u32 rep = head * 0x01010101u;
  bool same = true;
#pragma unroll
  for (int i = 0; i < kLaneBytes / 16; ++i) same &= v[i].x == rep && v[i].y == rep && v[i].z == rep && v[i].w == rep;
  u32 lo, hi;
  if (__all_sync(BZ2T_FULL_MASK, same || !live)) {
    lo = hi = step_length(head);
  } else {
    lo = 0xffffffffu;
    hi = 0u;
#pragma unroll
    for (int i = 0; i < kLaneBytes / 16; ++i) {
      const u32 w[4] = {v[i].x, v[i].y, v[i].z, v[i].w};
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const u32 len = step_lengths4(w[k]);
        lo = __vminu4(lo, len);
        hi = __vmaxu4(hi, len);
      }
    }
    // The four byte lanes, then the bucket's lanes.
    lo = __vminu4(lo, lo >> 16);
    lo = __vminu4(lo, lo >> 8) & 0xffu;
    hi = __vmaxu4(hi, hi >> 16);
    hi = __vmaxu4(hi, hi >> 8) & 0xffu;
#pragma unroll
    for (int d = 1; d < kBucketLanes; d <<= 1) {
      lo = min(lo, __shfl_xor_sync(BZ2T_FULL_MASK, lo, d));
      hi = max(hi, __shfl_xor_sync(BZ2T_FULL_MASK, hi, d));
    }
  }
  if (live && lane == leader) first[bucket] = lo == hi ? (unsigned char)lo : 0;
}

// One group's code table: its first-level table, LUT row and canonical
// tables.
struct Code {
  const unsigned char* first;
  const signed char* row;
  const int* base;
  const int* perm;
};

// The code at window v (23 bits): its symbol into *sym (-2 where none is
// valid) and its length, as the decode step takes them.
__device__ __forceinline__ int decode_one(const Code& c, u32 v, int* sym) {
  u32 len = c.first[v >> (23 - kFirstBits)];
  if (len == 0) len = step_length((u32)c.row[v >> 3]);  // a bucket of several lengths: the row
  const bool matched = len <= (u32)kMaxLen;
  len = matched ? len : 1u;
  const u32 pidx = (v >> (23 - len)) - (u32)c.base[len];  // < 258 exactly when in [0, 258)
  const bool bad = !matched || pidx >= (u32)kAlpha;
  *sym = bad ? -2 : c.perm[bad ? 0 : pidx];
  return (int)len;
}

// The most words a group's refills read past its first: 50 codes of at
// most 20 bits, and the words held ahead.
constexpr int kSpanWords = 4 * ((kGroup * kMaxLen + 31) / 32 + 5);

// One group from bit `start`, its 50 symbols and lengths into out_s /
// out_l. Where all its words lie inside `words`, two registers hold 64 bits
// of the stream and three more the next words (loaded three refills ahead),
// so no load sits on the chain of a code's length; elsewhere (a start
// before the stream, or the stream's last words) each code reads its window
// as the plain gather does, clamped into `words`.
__device__ __forceinline__ void decode_group(const long long* __restrict__ words, long long n_words, long long start,
                                             const Code& c, int* out_s, unsigned char* out_l) {
  if (start >= 0 && (start >> 3) + kSpanWords < n_words) {
    const long long* p = words + (start >> 3);
    u32 o = (u32)(start & 7);  // bit offset into hi:lo, below 32
    u32 hi = (u32)p[0], lo = (u32)p[4], n1 = (u32)p[8], n2 = (u32)p[12], n3 = (u32)p[16];
    p += 20;
#pragma unroll 5
    for (int i = 0; i < kGroup; ++i) {
      int sym;
      const int len = decode_one(c, __funnelshift_l(lo, hi, o) >> 9, &sym);
      out_s[i] = sym;
      out_l[i] = (unsigned char)len;
      o += len;
      if (o >= 32) {
        o -= 32;
        hi = lo;
        lo = n1;
        n1 = n2;
        n2 = n3;
        n3 = (u32)*p;
        p += 4;
      }
    }
  } else {
    long long pos = start;
    for (int i = 0; i < kGroup; ++i) {
      const u32 w = (u32)words[min(max(pos >> 3, 0ll), n_words - 1)];
      int sym;
      const int len = decode_one(c, (w >> (9 - (pos & 7))) & ((1u << 23) - 1), &sym);
      out_s[i] = sym;
      out_l[i] = (unsigned char)len;
      pos += len;
    }
  }
}

__global__ void __launch_bounds__(kThreads)
dec_symbols(const long long* __restrict__ words, long long n_words, const long long* __restrict__ offs,
            const int* __restrict__ tbl, const signed char* __restrict__ lut, int n_rows,
            const unsigned char* __restrict__ first, const int* __restrict__ lut_idx,
            const int* __restrict__ base, const int* __restrict__ perm, int n_tables, int groups,
            int* __restrict__ syms, int* __restrict__ lens) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int T = n_tables;
  int* s_sym = reinterpret_cast<int*>(smem);                                        // kWarps x kSpan
  unsigned char* s_first = smem + kWarps * kSpan * 4;                               // T x kFirst
  int* s_perm = reinterpret_cast<int*>(s_first + T * kFirst);                      // T x 258
  int* s_base = s_perm + T * kAlpha;                                                // T x 21
  unsigned char* s_len = reinterpret_cast<unsigned char*>(s_base + T * kLens);      // kWarps x kSpan
  __shared__ long long s_row[kTables];

  const int b = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  // Every load of the tables is issued before the first store: a loop of
  // load-store rounds would wait out the memory's latency once a round.
  constexpr int kPermLoads = (kTables * kAlpha + kThreads - 1) / kThreads;
  constexpr int kBaseLoads = (kTables * kLens + kThreads - 1) / kThreads;
  constexpr int kFirstLoads = (kTables * kFirst / 16 + kThreads - 1) / kThreads;
  int pv[kPermLoads], bv[kBaseLoads];
  uint4 fv[kFirstLoads];
#pragma unroll
  for (int k = 0; k < kPermLoads; ++k) {
    const int i = threadIdx.x + k * kThreads;
    pv[k] = i < T * kAlpha ? perm[(size_t)b * T * kAlpha + i] : 0;
  }
#pragma unroll
  for (int k = 0; k < kBaseLoads; ++k) {
    const int i = threadIdx.x + k * kThreads;
    bv[k] = i < T * kLens ? base[(size_t)b * T * kLens + i] : 0;
  }
#pragma unroll
  for (int k = 0; k < kFirstLoads; ++k) {
    const int i = threadIdx.x + k * kThreads, t = i / (kFirst / 16);
    if (t < T) {
      const long long row = min(max(lut_idx[b * T + t], 0), n_rows - 1);
      fv[k] = reinterpret_cast<const uint4*>(first + row * kFirst)[i % (kFirst / 16)];
    }
  }
#pragma unroll
  for (int k = 0; k < kPermLoads; ++k)
    if (threadIdx.x + k * kThreads < T * kAlpha) s_perm[threadIdx.x + k * kThreads] = pv[k];
#pragma unroll
  for (int k = 0; k < kBaseLoads; ++k)
    if (threadIdx.x + k * kThreads < T * kLens) s_base[threadIdx.x + k * kThreads] = bv[k];
#pragma unroll
  for (int k = 0; k < kFirstLoads; ++k)
    if (threadIdx.x + k * kThreads < T * (kFirst / 16))
      reinterpret_cast<uint4*>(s_first)[threadIdx.x + k * kThreads] = fv[k];
  if (threadIdx.x < T) s_row[threadIdx.x] = min(max(lut_idx[b * T + threadIdx.x], 0), n_rows - 1);
  __syncthreads();
  const int g0 = blockIdx.x * kThreads + warp * 32;  // the warp's first group
  if (g0 >= groups) return;
  int* w_sym = s_sym + warp * kSpan;
  unsigned char* w_len = s_len + warp * kSpan;
  if (g0 + lane < groups) {
    const size_t at = (size_t)b * groups + g0 + lane;
    const int t = min(max(tbl[at], 0), T - 1);
    const Code c{s_first + t * kFirst, lut + (s_row[t] << kLutBits), s_base + t * kLens, s_perm + t * kAlpha};
    decode_group(words, n_words, offs[at], c, w_sym + lane * kGroup, w_len + lane * kGroup);
  }
  __syncwarp();
  // The warp's groups are kSpan consecutive entries of each output row.
  const int n = min(32, groups - g0) * kGroup;
  int* out_s = syms + ((size_t)b * groups + g0) * kGroup;
  int* out_l = lens + ((size_t)b * groups + g0) * kGroup;
#pragma unroll 5
  for (int e = lane; e < n; e += 32) {
    out_s[e] = w_sym[e];
    out_l[e] = w_len[e];
  }
}

}  // namespace

// Shared memory of a dec_symbols CTA with n_tables tables, in bytes.
static int dec_symbols_smem(int n_tables) {
  return kWarps * kSpan * 5 + n_tables * (kAlpha * 4 + kLens * 4 + kFirst);
}

// Entries a first-level table row: 2^kFirstBits.
extern "C" int bz2t_lut_first_entries() { return kFirst; }

// lut: (n_rows, 2^20) int8 code lengths (16-byte aligned); first: (n_rows,
// 2^kFirstBits) uint8 output, each bucket's length as the step uses it,
// or 0 where the bucket's entries differ.
extern "C" int bz2t_lut_first_level(const signed char* lut, int n_rows, unsigned char* first,
                                    cudaStream_t stream) {
  if (n_rows <= 0) return (int)cudaGetLastError();
  const long long threads = (long long)n_rows * kFirst * kBucketLanes;
  lut_first_level<<<(unsigned)((threads + 255) / 256), 256, 0, stream>>>(lut, (long long)n_rows * kFirst, first);
  return (int)cudaGetLastError();
}

// words: (n_words,) int64 window words of the stream; offs: (batch, groups)
// int64 absolute start bit of each group; tbl: (batch, groups) int32 table
// per group; lut: (n_rows, 2^20) int8 code lengths; first: (n_rows,
// 2^kFirstBits) uint8 from bz2t_lut_first_level of the same lut; lut_idx:
// (batch, n_tables) int32 LUT row per table; base: (batch, n_tables, 21)
// and perm: (batch, n_tables, 258) int32 canonical tables. syms, lens:
// (batch, groups * 50) int32 outputs.
extern "C" int bz2t_dec_symbols(const long long* words, long long n_words, const long long* offs, const int* tbl,
                                const signed char* lut, int n_rows, const unsigned char* first, const int* lut_idx,
                                const int* base, const int* perm, int batch, int n_tables, int groups, int* syms,
                                int* lens, cudaStream_t stream) {
  if (batch <= 0 || groups <= 0) return (int)cudaGetLastError();
  if (n_tables < 1 || n_tables > kTables || n_rows < 1 || n_words < 1 || batch > 65535)
    return (int)cudaErrorInvalidValue;
  // Once a process: the largest shared memory a launch asks for.
  static const cudaError_t attr = cudaFuncSetAttribute(dec_symbols, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                       dec_symbols_smem(kTables));
  if (attr != cudaSuccess) return (int)attr;
  const int smem = dec_symbols_smem(n_tables);
  const dim3 grid((groups + kThreads - 1) / kThreads, batch);
  dec_symbols<<<grid, kThreads, smem, stream>>>(words, n_words, offs, tbl, lut, n_rows, first, lut_idx, base, perm,
                                                n_tables, groups, syms, lens);
  return (int)cudaGetLastError();
}
