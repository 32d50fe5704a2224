// Variants of the decode's dec_symbols (D3) and mtf_dec (D4) kernels for
// tools/probe_dec_kernels.py, which times them on the card beside the
// kernels of bz2tpu_torch/csrc on the same inputs. None of them is part of
// the port.
//
//   d3_first<kSink, kConstLut>: D3's first design (one thread a group, a
//     LUT byte read from device memory and two scattered int32 stores a
//     symbol); kSink sends the stores to a shared-memory sink (one word a
//     thread leaves at the end), kConstLut takes every length as 5 instead
//     of reading the LUT. Only <false, false> computes the function.
//   d4_first: D4's first design (one warp a chunk, the list in a u64 a
//     lane, two 64-bit shuffles a step, every step walked).
//   d4_multi<kLanes>: kLanes lanes a chunk (32: one warp a chunk as in
//     d4_first), the list in 64 / kLanes u32 a lane (funnel shifts and byte
//     permutes), the steps after the last nonzero index of the warp's
//     chunks not walked.
//   d4_lane: one thread a chunk, its list in 64 registers, a step jumping
//     into a fall-through chain of word updates at the warp's largest word.
#include "../bz2tpu_torch/csrc/common.cuh"

namespace {

constexpr int kGroup = 50, kTables = 6, kLens = 21, kAlpha = 258, kMaxLen = 20, kLutBits = 20;
constexpr int kD3Threads = 256;
constexpr int kChunk = 128;
constexpr int kD4Warps = 8;

template <bool kSink, bool kConstLut>
__global__ void __launch_bounds__(kD3Threads)
d3_first(const long long* __restrict__ words, long long n_words, const long long* __restrict__ offs,
         const int* __restrict__ tbl, const signed char* __restrict__ lut, int n_rows,
         const int* __restrict__ lut_idx, const int* __restrict__ base, const int* __restrict__ perm, int n_tables,
         int groups, int* __restrict__ syms, int* __restrict__ lens) {
  __shared__ int s_base[kTables * kLens];
  __shared__ int s_perm[kTables * kAlpha];
  __shared__ long long s_row[kTables];
  __shared__ int s_sink[kD3Threads];
  const int b = blockIdx.y;
  const int T = n_tables;
  for (int i = threadIdx.x; i < T * kLens; i += kD3Threads) s_base[i] = base[(size_t)b * T * kLens + i];
  for (int i = threadIdx.x; i < T * kAlpha; i += kD3Threads) s_perm[i] = perm[(size_t)b * T * kAlpha + i];
  if (threadIdx.x < T)
    s_row[threadIdx.x] = (long long)min(max(lut_idx[b * T + threadIdx.x], 0), n_rows - 1) << kLutBits;
  s_sink[threadIdx.x] = 0;
  __syncthreads();
  const int g = blockIdx.x * kD3Threads + threadIdx.x;
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
    int len = kConstLut ? 5 : row[v >> 3];
    const bool matched = len <= kMaxLen;
    len = matched ? max(len, 1) : 1;
    const long long pidx = (v >> (23 - len)) - tb[len];
    const bool bad = !matched || pidx < 0 || pidx >= kAlpha;
    const int sym = bad ? -2 : tp[bad ? 0 : (int)pidx];
    if (kSink) {
      s_sink[threadIdx.x] += sym + len;
    } else {
      out_s[i] = sym;
      out_l[i] = len;
    }
    pos += len;
  }
  if (kSink) out_s[0] = s_sink[threadIdx.x];
}

__global__ void __launch_bounds__(kD4Warps * 32)
d4_first(const unsigned char* __restrict__ js, long long n_chunks, unsigned char* __restrict__ q,
         unsigned char* __restrict__ emit) {
  const long long c = (long long)blockIdx.x * kD4Warps + (threadIdx.x >> 5);
  if (c >= n_chunks) return;
  const int lane = threadIdx.x & 31;
  const u32 jw = reinterpret_cast<const u32*>(js + c * kChunk)[lane];
  u64 w = 0;
#pragma unroll
  for (int k = 0; k < 8; ++k) w |= (u64)(8 * lane + k) << (8 * k);
  u32 em = 0;
  for (int src = 0; src < 32; ++src) {
    const u32 four = __shfl_sync(BZ2T_FULL_MASK, jw, src);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int j = (four >> (8 * k)) & 0xff;
      const int jl = j >> 3, jb = j & 7;
      const u32 e = (u32)(__shfl_sync(BZ2T_FULL_MASK, w, jl) >> (8 * jb)) & 0xffu;
      const u64 below = __shfl_up_sync(BZ2T_FULL_MASK, w, 1) >> 56;
      const u64 shifted = (w << 8) | (lane == 0 ? (u64)e : below);
      const u64 keep = lane < jl ? 0ull : lane > jl ? ~0ull : jb == 7 ? 0ull : ~0ull << (8 * (jb + 1));
      w = (shifted & ~keep) | (w & keep);
      if (lane == src) em |= e << (8 * k);
    }
  }
  reinterpret_cast<u64*>(q + c * 256)[lane] = w;
  reinterpret_cast<u32*>(emit + c * kChunk)[lane] = em;
}

// kLanes lanes a chunk (32 / kLanes chunks a warp): lane L of a chunk holds
// entries 256 / kLanes L .. in kW u32 and index words m kLanes + L; the warp
// walks its chunks' steps up to the last nonzero index of any of them.
template <int kLanes>
__global__ void __launch_bounds__(kD4Warps * 32)
d4_multi(const unsigned char* __restrict__ js, long long n_chunks, unsigned char* __restrict__ q,
         unsigned char* __restrict__ emit) {
  constexpr int kPer = 32 / kLanes;  // chunks a warp
  constexpr int kW = 64 / kLanes;    // list words a lane
  constexpr int kJ = 32 / kLanes;    // index words (and emit words) a lane
  constexpr int kLaneShift = kLanes == 32 ? 3 : kLanes == 16 ? 4 : 5;  // entry j's lane: j >> kLaneShift
  static_assert(kLanes == 32 || kLanes == 16 || kLanes == 8, "8 to 32 lanes a chunk");
  const long long c0 = ((long long)blockIdx.x * kD4Warps + (threadIdx.x >> 5)) * kPer;
  if (c0 >= n_chunks) return;
  const int sub = (threadIdx.x & 31) / kLanes, lane = threadIdx.x & (kLanes - 1);
  const long long c = c0 + sub;
  const bool live = c < n_chunks;
  const u32* src = reinterpret_cast<const u32*>(js + c * kChunk);
  u32 jw[kJ];
#pragma unroll
  for (int m = 0; m < kJ; ++m) jw[m] = live ? src[m * kLanes + lane] : 0u;
  int n_steps = 0;
#pragma unroll
  for (int m = 0; m < kJ; ++m) {
    const u32 nz = (__ballot_sync(BZ2T_FULL_MASK, jw[m] != 0) >> (sub * kLanes)) & (u32)((1ull << kLanes) - 1);
    const int top = nz ? 31 - __clz(nz) : 0;
    const u32 tw = __shfl_sync(BZ2T_FULL_MASK, jw[m], top, kLanes);
    if (nz) n_steps = 4 * (m * kLanes + top) + ((31 - __clz(tw)) >> 3) + 1;
  }
  const int n_groups = __reduce_max_sync(BZ2T_FULL_MASK, (unsigned)((n_steps + 3) >> 2));
  u32 w[kW];
#pragma unroll
  for (int i = 0; i < kW; ++i) w[i] = 0x03020100u + 0x04040404u * (kW * lane + i);
  const int t_lane = 8 - 32 * kW * lane;
  u32 em[kJ], ring = 0;
#pragma unroll
  for (int m = 0; m < kJ; ++m) em[m] = 0;
  for (int gi = 0; gi < n_groups; ++gi) {
    u32 word = jw[0];
#pragma unroll
    for (int m = 1; m < kJ; ++m) word = gi / kLanes == m ? jw[m] : word;
    const u32 four = __shfl_sync(BZ2T_FULL_MASK, word, gi % kLanes, kLanes);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int j = __byte_perm(four, 0u, 0x4440u | k);
      // Word (j >> 2) mod kW of each lane, by a tree of selects.
      u32 sel[kW];
#pragma unroll
      for (int i = 0; i < kW; ++i) sel[i] = w[i];
#pragma unroll
      for (int half = kW / 2, bit = 2 * kW; half >= 1; half /= 2, bit /= 2)
#pragma unroll
        for (int i = 0; i < half; ++i) sel[i] = j & bit ? sel[i + half] : sel[i];
      const u32 e = __byte_perm(__shfl_sync(BZ2T_FULL_MASK, sel[0], j >> kLaneShift, kLanes), 0u, 0x4440u | (j & 3));
      const u32 below = __shfl_up_sync(BZ2T_FULL_MASK, w[kW - 1], 1, kLanes) >> 24;
      const int t = 8 * j + t_lane;
      u32 prev = w[0];
      {
        const u32 keep = __funnelshift_lc(0u, ~0u, (u32)max(t, 0));
        w[0] = (__byte_perm(lane == 0 ? e : below, w[0], 0x6540) & ~keep) | (w[0] & keep);
      }
#pragma unroll
      for (int i = 1; i < kW; ++i) {
        const u32 old = w[i];
        const u32 keep = __funnelshift_lc(0u, ~0u, (u32)max(t - 32 * i, 0));
        w[i] = (__funnelshift_l(prev, old, 8) & ~keep) | (old & keep);
        prev = old;
      }
      ring = __byte_perm(ring, e, 0x4321);  // the last four emits, the oldest in byte 0
    }
    if (lane == gi % kLanes) {
#pragma unroll
      for (int m = 0; m < kJ; ++m) em[m] = gi / kLanes == m ? ring : em[m];
    }
  }
  const u32 front = (__shfl_sync(BZ2T_FULL_MASK, w[0], 0, kLanes) & 0xffu) * 0x01010101u;
#pragma unroll
  for (int m = 0; m < kJ; ++m) em[m] = m * kLanes + lane >= n_groups ? front : em[m];
  if (live) {
    u32* dq = reinterpret_cast<u32*>(q + c * 256) + kW * lane;
#pragma unroll
    for (int i = 0; i < kW; i += 2) reinterpret_cast<uint2*>(dq)[i / 2] = make_uint2(w[i], w[i + 1]);
    u32* de = reinterpret_cast<u32*>(emit + c * kChunk);
#pragma unroll
    for (int m = 0; m < kJ; ++m) de[m * kLanes + lane] = em[m];
  }
}

// One thread a chunk, its list in 64 registers; a step jumps into a chain
// of word updates at the warp's largest word index and falls through to
// word 1 (descending, so each word still sees the old word below it).
__global__ void __launch_bounds__(kD4Warps * 32)
d4_lane(const unsigned char* __restrict__ js, long long n_chunks, unsigned char* __restrict__ q,
        unsigned char* __restrict__ emit) {
  __shared__ u32 s_io[kD4Warps][32 * 32];  // chunk r's word w at w * 32 + (r ^ w)
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long c0 = ((long long)blockIdx.x * kD4Warps + warp) * 32;
  if (c0 >= n_chunks) return;
  const int n_here = (int)min(32ll, n_chunks - c0);
  u32* io = s_io[warp];
  const u32* src = reinterpret_cast<const u32*>(js + c0 * kChunk);
  int last = -1;
  for (int r = 0; r < 32; ++r) {
    const u32 word = r < n_here ? src[r * 32 + lane] : 0u;
    io[lane * 32 + (r ^ lane)] = word;
    const u32 nz = __ballot_sync(BZ2T_FULL_MASK, word != 0);
    const int top = nz ? 31 - __clz(nz) : 0;
    const u32 top_word = __shfl_sync(BZ2T_FULL_MASK, word, top);
    if (lane == r && nz) last = 4 * top + ((31 - __clz(top_word)) >> 3);
  }
  __syncwarp();
  const int n_steps = __reduce_max_sync(BZ2T_FULL_MASK, (unsigned)(last + 1));
  u32 w[64];
#pragma unroll
  for (int k = 0; k < 64; ++k) w[k] = 0x03020100u + 0x04040404u * k;
  u32 four = 0, ring = 0;
#pragma unroll 1
  for (int i = 0; i < n_steps; ++i) {
    if ((i & 3) == 0) four = io[(i >> 2) * 32 + (lane ^ (i >> 2))];
    const int j = (four >> (8 * (i & 3))) & 0xff;
    const int jw = j >> 2;
    const int mx = __reduce_max_sync(BZ2T_FULL_MASK, (unsigned)jw);
    const int t8 = 8 * j + 8;
    u32 cap = w[0];
#define BZ2T_WORD(k)                                                                   \
  case k: {                                                                            \
    const u32 old = w[k];                                                              \
    cap = jw == k ? old : cap;                                                         \
    const u32 keep = __funnelshift_lc(0u, ~0u, (u32)max(t8 - 32 * k, 0));              \
    w[k] = (__funnelshift_l(w[k - 1], old, 8) & ~keep) | (old & keep);                 \
  }
    switch (mx) {
      BZ2T_WORD(63) BZ2T_WORD(62) BZ2T_WORD(61) BZ2T_WORD(60) BZ2T_WORD(59) BZ2T_WORD(58) BZ2T_WORD(57)
      BZ2T_WORD(56) BZ2T_WORD(55) BZ2T_WORD(54) BZ2T_WORD(53) BZ2T_WORD(52) BZ2T_WORD(51) BZ2T_WORD(50)
      BZ2T_WORD(49) BZ2T_WORD(48) BZ2T_WORD(47) BZ2T_WORD(46) BZ2T_WORD(45) BZ2T_WORD(44) BZ2T_WORD(43)
      BZ2T_WORD(42) BZ2T_WORD(41) BZ2T_WORD(40) BZ2T_WORD(39) BZ2T_WORD(38) BZ2T_WORD(37) BZ2T_WORD(36)
      BZ2T_WORD(35) BZ2T_WORD(34) BZ2T_WORD(33) BZ2T_WORD(32) BZ2T_WORD(31) BZ2T_WORD(30) BZ2T_WORD(29)
      BZ2T_WORD(28) BZ2T_WORD(27) BZ2T_WORD(26) BZ2T_WORD(25) BZ2T_WORD(24) BZ2T_WORD(23) BZ2T_WORD(22)
      BZ2T_WORD(21) BZ2T_WORD(20) BZ2T_WORD(19) BZ2T_WORD(18) BZ2T_WORD(17) BZ2T_WORD(16) BZ2T_WORD(15)
      BZ2T_WORD(14) BZ2T_WORD(13) BZ2T_WORD(12) BZ2T_WORD(11) BZ2T_WORD(10) BZ2T_WORD(9) BZ2T_WORD(8)
      BZ2T_WORD(7) BZ2T_WORD(6) BZ2T_WORD(5) BZ2T_WORD(4) BZ2T_WORD(3) BZ2T_WORD(2) BZ2T_WORD(1)
      default: break;
    }
#undef BZ2T_WORD
    const u32 w0 = w[0];
    const u32 e = (cap >> (8 * (j & 3))) & 0xffu;
    const u32 keep0 = __funnelshift_lc(0u, ~0u, (u32)t8);
    w[0] = (((w0 << 8) | e) & ~keep0) | (w0 & keep0);
    ring = __byte_perm(ring, e, 0x4321);
    if ((i & 3) == 3) io[(i >> 2) * 32 + (lane ^ (i >> 2))] = ring;
  }
  if (n_steps & 3) {  // a last group of fewer than four steps: its tail steps emit q[0]
    const u32 front = w[0] & 0xffu;
    for (int i = n_steps; i & 3; ++i) ring = __byte_perm(ring, front, 0x4321);
    io[(n_steps >> 2) * 32 + (lane ^ (n_steps >> 2))] = ring;
  }
  const u32 front = (w[0] & 0xffu) * 0x01010101u;
  for (int gi = (n_steps + 3) >> 2; gi < 32; ++gi) io[gi * 32 + (lane ^ gi)] = front;
  __syncwarp();
  u32* dst_e = reinterpret_cast<u32*>(emit + c0 * kChunk);
  for (int r = 0; r < n_here; ++r) dst_e[r * 32 + lane] = io[lane * 32 + (r ^ lane)];
  u32* dst_q = reinterpret_cast<u32*>(q + c0 * 256);
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    __syncwarp();
#pragma unroll
    for (int k = 0; k < 32; ++k) io[k * 32 + (lane ^ k)] = w[32 * half + k];
    __syncwarp();
    for (int r = 0; r < n_here; ++r) dst_q[r * 64 + 32 * half + lane] = io[lane * 32 + (r ^ lane)];
  }
}

}  // namespace

// D3's first design; variant 0: as it was, 1: stores to a shared sink,
// 2: every length 5 with no LUT read, 3: both.
extern "C" int probe_d3_first(int variant, const long long* words, long long n_words, const long long* offs,
                              const int* tbl, const signed char* lut, int n_rows, const int* lut_idx, const int* base,
                              const int* perm, int batch, int n_tables, int groups, int* syms, int* lens,
                              cudaStream_t stream) {
  if (batch <= 0 || groups <= 0) return (int)cudaGetLastError();
  if (variant < 0 || variant > 3) return (int)cudaErrorInvalidValue;
  void (*const kernels[4])(const long long*, long long, const long long*, const int*, const signed char*, int,
                           const int*, const int*, const int*, int, int, int*, int*) = {
      d3_first<false, false>, d3_first<true, false>, d3_first<false, true>, d3_first<true, true>};
  const dim3 grid((groups + kD3Threads - 1) / kD3Threads, batch);
  kernels[variant]<<<grid, kD3Threads, 0, stream>>>(words, n_words, offs, tbl, lut, n_rows, lut_idx, base, perm,
                                                    n_tables, groups, syms, lens);
  return (int)cudaGetLastError();
}

// D4 variants; variant 0: the first design; 1-3: 32, 16 or 8 lanes a
// chunk (d4_multi); 4: one thread a chunk (d4_lane).
extern "C" int probe_d4(int variant, const unsigned char* js, long long n_chunks, unsigned char* q,
                        unsigned char* emit, cudaStream_t stream) {
  if (n_chunks <= 0) return (int)cudaGetLastError();
  if (variant < 0 || variant > 4) return (int)cudaErrorInvalidValue;
  const long long per_cta[5] = {kD4Warps, kD4Warps, 2 * kD4Warps, 4 * kD4Warps, 32 * kD4Warps};
  void (*const kernels[5])(const unsigned char*, long long, unsigned char*, unsigned char*) = {
      d4_first, d4_multi<32>, d4_multi<16>, d4_multi<8>, d4_lane};
  const unsigned grid = (unsigned)((n_chunks + per_cta[variant] - 1) / per_cta[variant]);
  kernels[variant]<<<grid, kD4Warps * 32, 0, stream>>>(js, n_chunks, q, emit);
  return (int)cudaGetLastError();
}
