// The first designs of the device intake's crc_ranges (D5) and block_cuts
// (D6) kernels, cut into parts, for tools/probe_intake_kernels.py, which
// times them on the card beside the kernels of bz2tpu_torch/csrc on the
// same inputs. None of them is part of the port.
//
//   d5_spans<kScan>: D5's first pass 1 (a thread's 64 bytes through the
//     byte table in shared memory from state 0, then a Kogge-Stone scan of
//     the CTA's 256 states by carry-less products, each thread's exclusive
//     state and each CTA's state written out); kScan = false patches the
//     scan out, so only the byte chain and the stores are left.
//   d5_finish: D5's first pass 2 (one CTA of 1,024 threads: the CTA states
//     scanned, each endpoint's state, each range's CRC); it writes the CTA
//     prefixes beside its input rather than over it, so it can run again
//     on the same pass-1 output.
//   d6_first: D6's first design (one warp, max_blocks dependent 32-ary
//     searches, each from the sum the one before found).
//   d6_given: the same searches with every cut's target given (a warp a
//     cut, all at once), so no chain: what the chain costs.
#include "../bz2tpu_torch/csrc/common.cuh"

namespace {

constexpr u32 kPoly = 0x04C11DB7u;
constexpr int kLogSeg = 6;
constexpr int kSeg = 1 << kLogSeg;
constexpr int kLogThreads = 8;
constexpr int kThreads = 1 << kLogThreads;
constexpr int kLogSpan = kLogSeg + kLogThreads;
constexpr int kLogFinish = 10;
constexpr int kFinish = 1 << kLogFinish;

// x^(2^k) mod P for k = 0..31 (the first design's table).
__constant__ u32 kXPow2[32] = {
    0x00000002u, 0x00000004u, 0x00000010u, 0x00000100u, 0x00010000u, 0x04c11db7u, 0x490d678du, 0xe8a45605u,
    0x75be46b7u, 0xe6228b11u, 0x567fddebu, 0x88fe2237u, 0x0e857e71u, 0x7001e426u, 0x075de2b2u, 0xf12a7f90u,
    0xf0b4a1c1u, 0x58f46c0cu, 0xc3395adeu, 0x96837f8cu, 0x544037f9u, 0x23b7b136u, 0xb2e16ba8u, 0x725e7bfau,
    0xec709b5du, 0xf77a7274u, 0x2845d572u, 0x034e2515u, 0x79695942u, 0x540cb128u, 0x0b65d023u, 0x3c344723u,
};

__device__ void build_table(u32* tab) {
  for (int i = threadIdx.x; i < 256; i += blockDim.x) {
    u32 c = (u32)i << 24;
    for (int k = 0; k < 8; ++k) c = (c << 1) ^ ((c >> 31) ? kPoly : 0u);
    tab[i] = c;
  }
}

__device__ __forceinline__ u32 crc_step(u32 s, u32 byte, const u32* tab) {
  return (s << 8) ^ tab[(s >> 24) ^ byte];
}

__device__ u32 mulmod(u32 a, u32 b, const u32* tab) {
  u64 p = 0;
#pragma unroll
  for (int i = 0; i < 32; ++i) p ^= ((u64)a << i) & (0ull - (u64)((b >> i) & 1u));
  u32 h = (u32)(p >> 32);
#pragma unroll
  for (int k = 0; k < 4; ++k) h = (h << 8) ^ tab[h >> 24];
  return (u32)p ^ h;
}

__device__ u32 xpow8(unsigned long long n, const u32* tab) {
  u32 r = 1;
  for (int k = 3; n; ++k, n >>= 1)
    if (n & 1) r = mulmod(r, kXPow2[k & 31], tab);
  return r;
}

__device__ void scan_states(u32 v, int log_bytes, int log_threads, u32* buf, const u32* tab, u32* incl,
                            u32* excl) {
  const int t = threadIdx.x, n = 1 << log_threads;
  int cur = 0;
  buf[t] = v;
  __syncthreads();
  for (int r = 0; r < log_threads; ++r) {
    const int d = 1 << r;
    u32 x = buf[cur * n + t];
    if (t >= d) x ^= mulmod(buf[cur * n + t - d], kXPow2[(3 + log_bytes + r) & 31], tab);
    buf[(cur ^ 1) * n + t] = x;
    cur ^= 1;
    __syncthreads();
  }
  *incl = buf[cur * n + t];
  *excl = t ? buf[cur * n + t - 1] : 0u;
}

template <bool kScan>
__global__ void __launch_bounds__(kThreads)
d5_spans(const unsigned char* __restrict__ chunk, long long n, int aligned, u32* __restrict__ seg_prefix,
         u32* __restrict__ cta_state) {
  __shared__ u32 tab[256];
  __shared__ u32 buf[2 * kThreads];
  build_table(tab);
  __syncthreads();
  const long long seg = (long long)blockIdx.x * kThreads + threadIdx.x;
  const long long lo = seg << kLogSeg;
  u32 s = 0;
  if (aligned && lo + kSeg <= n) {
    const uint4* p = reinterpret_cast<const uint4*>(chunk + lo);
#pragma unroll
    for (int q = 0; q < kSeg / 16; ++q) {
      const uint4 w = p[q];
      const u32 words[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
      for (int k = 0; k < 4; ++k)
#pragma unroll
        for (int j = 0; j < 4; ++j) s = crc_step(s, (words[k] >> (8 * j)) & 0xffu, tab);
    }
  } else {
    for (long long i = lo; i < n && i < lo + kSeg; ++i) s = crc_step(s, chunk[i], tab);
  }
  u32 incl = s, excl = s;
  if (kScan) scan_states(s, kLogSeg, kLogThreads, buf, tab, &incl, &excl);
  seg_prefix[seg] = excl;
  if (threadIdx.x == kThreads - 1) cta_state[blockIdx.x] = incl;
}

__global__ void __launch_bounds__(kFinish)
d5_finish(const unsigned char* __restrict__ chunk, long long n, const long long* __restrict__ pts, int n_ranges,
          const u32* __restrict__ seg_prefix, const u32* __restrict__ cta_in, u32* __restrict__ cta_state,
          long long n_ctas, int log_run, u32* __restrict__ pt_state, long long* __restrict__ crcs) {
  __shared__ u32 tab[256];
  __shared__ u32 buf[2 * kFinish];
  build_table(tab);
  __syncthreads();
  const int t = threadIdx.x;
  const long long c0 = (long long)t << log_run, c1 = min(c0 + (1ll << log_run), n_ctas);
  const u32 cta_shift = kXPow2[(3 + kLogSpan) & 31];
  u32 v = 0;
  for (long long c = c0; c < c1; ++c) v = mulmod(v, cta_shift, tab) ^ cta_in[c];
  u32 incl, excl;
  scan_states(v, kLogSpan + log_run, kLogFinish, buf, tab, &incl, &excl);
  for (long long c = c0; c < c1; ++c) {
    const u32 own = cta_in[c];
    cta_state[c] = excl;
    excl = mulmod(excl, cta_shift, tab) ^ own;
  }
  __syncthreads();
  for (int i = t; i < 2 * n_ranges; i += kFinish) {
    const long long p = min(max(pts[i], 0ll), n);
    const long long seg = p ? (p - 1) >> kLogSeg : 0, lo = seg << kLogSeg, cta = seg >> kLogThreads;
    u32 s = mulmod(cta_state[cta], xpow8(lo - (cta << kLogSpan), tab), tab) ^ seg_prefix[seg];
    for (long long j = lo; j < p; ++j) s = crc_step(s, chunk[j], tab);
    pt_state[i] = s;
  }
  __syncthreads();
  for (int b = t; b < n_ranges; b += kFinish) {
    const long long s = min(max(pts[b], 0ll), n), e = min(max(pts[n_ranges + b], 0ll), n);
    const u32 moved = mulmod(pt_state[b] ^ 0xffffffffu, xpow8(e > s ? e - s : 0, tab), tab);
    crcs[b] = (long long)(moved ^ pt_state[n_ranges + b] ^ 0xffffffffu);
  }
}

// D6's first design: a warp's 32-ary search.
__device__ long long first_at_least(const int* __restrict__ a, long long n, long long target) {
  const int lane = threadIdx.x & 31;
  long long lo = 0, hi = n;
  while (lo < hi) {
    const long long step = (hi - lo + 31) / 32;
    const long long first = lo + lane * step;
    const bool hit = first < hi && (long long)a[min(first + step, hi) - 1] >= target;
    const u32 mask = __ballot_sync(BZ2T_FULL_MASK, hit);
    if (mask == 0) return hi;
    const long long f_first = lo + (long long)(__ffs(mask) - 1) * step;
    hi = min(f_first + step, hi) - 1;
    lo = f_first;
  }
  return lo;
}

__global__ void __launch_bounds__(32)
d6_first(const int* __restrict__ out_cum, const int* __restrict__ raw_cum, long long n,
         const int* __restrict__ n_pieces, long long cap, int max_blocks, int* __restrict__ out_cuts,
         int* __restrict__ raw_cuts, int* __restrict__ n_blocks) {
  const int np = *n_pieces;
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

// Warp b searches targets[b] (every cut's target given: no chain) and
// writes that cut; the slots past the live cuts are the caller's.
__global__ void d6_given(const int* __restrict__ out_cum, const int* __restrict__ raw_cum, long long n,
                         const int* __restrict__ n_pieces, const long long* __restrict__ targets, int n_live,
                         int* __restrict__ out_cuts, int* __restrict__ raw_cuts) {
  const int b = threadIdx.x >> 5;
  if (b >= n_live) return;
  const int np = *n_pieces;
  const long long hi = min(max(min(first_at_least(out_cum, n, targets[b]), (long long)np - 1), 0ll), n - 1);
  const int base = out_cum[hi], raw = raw_cum[hi];
  if ((threadIdx.x & 31) == 0) {
    out_cuts[b] = base;
    raw_cuts[b] = raw;
  }
}

long long n_ctas_of(long long n) { return (n + (1ll << kLogSpan) - 1) >> kLogSpan; }

}  // namespace

// Scratch words of the first D5 design: seg_prefix, the CTA states from
// pass 1, the CTA prefixes of pass 2 and the endpoint states.
extern "C" long long probe_d5_work(long long n, int n_ranges) {
  return n_ctas_of(n) * (kThreads + 2) + 2ll * n_ranges;
}

// D5's first design in parts; parts: 1 pass 1, 2 pass 2 (on the pass-1
// output already in work), 3 both (the function); scan = 0 patches pass
// 1's scan out.
extern "C" int probe_d5_first(int parts, int scan, const unsigned char* chunk, long long n, const long long* pts,
                              int n_ranges, u32* work, long long* crcs, cudaStream_t stream) {
  if (n <= 0 || n_ranges <= 0) return (int)cudaErrorInvalidValue;
  const long long n_ctas = n_ctas_of(n);
  int log_run = 0;
  while (((long long)kFinish << log_run) < n_ctas) ++log_run;
  u32* seg_prefix = work;
  u32* cta_state = work + n_ctas * kThreads;
  u32* cta_prefix = cta_state + n_ctas;
  u32* pt_state = cta_prefix + n_ctas;
  const int aligned = (reinterpret_cast<uintptr_t>(chunk) & 15) == 0;
  if (parts & 1) {
    if (scan)
      d5_spans<true><<<(unsigned)n_ctas, kThreads, 0, stream>>>(chunk, n, aligned, seg_prefix, cta_state);
    else
      d5_spans<false><<<(unsigned)n_ctas, kThreads, 0, stream>>>(chunk, n, aligned, seg_prefix, cta_state);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  if (parts & 2)
    d5_finish<<<1, kFinish, 0, stream>>>(chunk, n, pts, n_ranges, seg_prefix, cta_state, cta_prefix, n_ctas, log_run,
                                         pt_state, crcs);
  return (int)cudaGetLastError();
}

// D6's first design (given = 0) or its searches with the targets given
// (given = 1: targets holds the n_live live cuts' targets).
extern "C" int probe_d6(int given, const int* out_cum, const int* raw_cum, long long n, const int* n_pieces,
                        long long cap, int max_blocks, const long long* targets, int n_live, int* out_cuts,
                        int* raw_cuts, int* n_blocks, cudaStream_t stream) {
  if (n <= 0 || max_blocks <= 0 || n_live > 32) return (int)cudaErrorInvalidValue;
  if (given)
    d6_given<<<1, 32 * (n_live > 0 ? n_live : 1), 0, stream>>>(out_cum, raw_cum, n, n_pieces, targets, n_live, out_cuts,
                                                     raw_cuts);
  else
    d6_first<<<1, 32, 0, stream>>>(out_cum, raw_cum, n, n_pieces, cap, max_blocks, out_cuts, raw_cuts, n_blocks);
  return (int)cudaGetLastError();
}
