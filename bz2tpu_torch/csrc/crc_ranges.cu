// crc_ranges: the finalised CRC-32/BZIP2 of many byte ranges of one chunk.
//
// Replaces the lane loop of the device intake's range CRCs
// (bz2tpu/ops/crc.py:crc32_ranges, the lax.fori_loop at :166, body
// :158-164), its Kogge-Stone lane fold (:176-183) and its operator ladders
// (the lax.fori_loop at :111), not a Pallas kernel: XLA keeps those loops on
// the device, while eager torch issues every step of them from the host
// (most of the 3,415 host-issued ops of an 8 MiB chunk's intake on the
// H100, tools/time_intake.py).
//
// The bzip2 CRC is MSB-first and not reflected. A state s is a polynomial
// over GF(2) of degree < 32, and a byte b takes it to (s x^8 + b x^32) mod P,
// P = x^32 + 0x04C11DB7: one lookup in the byte table. So advancing past n
// zero bytes is a multiplication by x^(8n) mod P, and with S(p) the state
// of the prefix [0, p) from 0, a range's CRC follows from its endpoints:
//
//   crc[s, e) = x^(8(e - s)) (0xFFFFFFFF ^ S(s)) ^ S(e) ^ 0xFFFFFFFF.
//
// Pass 1 (crc_spans): a thread steps its 64 contiguous bytes (four 16-byte
// loads) through the byte table in shared memory from state 0; the CTA's
// 256 states fold by a Kogge-Stone scan in shared memory, in which every
// shift is by x^(2^k) for a fixed k (the spans are powers of two), one
// table entry of kXPow2 and one carry-less product. Each thread writes the
// state of its CTA's bytes before its own, each CTA the state of all 16 KiB.
// Pass 2 (crc_finish, one CTA of 1,024 threads): the CTA states scan the
// same way (each thread first folds a run of them, a power of two long);
// each endpoint's S(p) is its CTA's prefix moved past the CTA's bytes
// before its segment, xor its segment's prefix, stepped through the at most
// 64 bytes of its segment before p; then each range's CRC as above. The
// result does not depend on any lane count.
//
// The bound is the chunk's bytes, read once: 8 MiB in 2.5 us at 3.35 TB/s.
// The byte steps are a dependent chain of table lookups, 64 a thread, hidden
// by some 130,000 threads in flight on an 8 MiB chunk; the scans add eight
// and ten dependent rounds of one carry-less product each (~100
// instructions), and the two launches' own overhead is of the same order.
#include "common.cuh"

namespace {

constexpr u32 kPoly = 0x04C11DB7u;
constexpr int kLogSeg = 6;  // 64 bytes a thread of pass 1
constexpr int kSeg = 1 << kLogSeg;
constexpr int kLogThreads = 8;  // 256 threads a CTA of pass 1
constexpr int kThreads = 1 << kLogThreads;
constexpr int kLogSpan = kLogSeg + kLogThreads;  // 16 KiB a CTA of pass 1
constexpr int kLogFinish = 10;  // 1,024 threads in pass 2
constexpr int kFinish = 1 << kLogFinish;

// x^(2^k) mod P for k = 0..31; x^(2^32) = x mod P, so k is taken mod 32.
__constant__ u32 kXPow2[32] = {
    0x00000002u, 0x00000004u, 0x00000010u, 0x00000100u, 0x00010000u, 0x04c11db7u, 0x490d678du, 0xe8a45605u,
    0x75be46b7u, 0xe6228b11u, 0x567fddebu, 0x88fe2237u, 0x0e857e71u, 0x7001e426u, 0x075de2b2u, 0xf12a7f90u,
    0xf0b4a1c1u, 0x58f46c0cu, 0xc3395adeu, 0x96837f8cu, 0x544037f9u, 0x23b7b136u, 0xb2e16ba8u, 0x725e7bfau,
    0xec709b5du, 0xf77a7274u, 0x2845d572u, 0x034e2515u, 0x79695942u, 0x540cb128u, 0x0b65d023u, 0x3c344723u,
};

// The byte table: tab[i] = i x^32 mod P. Needs 256 threads or a loop.
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

// a b mod P: the carry-less product, whose high word h is then reduced as a
// state fed four zero bytes (h x^32 mod P).
__device__ u32 mulmod(u32 a, u32 b, const u32* tab) {
  u64 p = 0;
#pragma unroll
  for (int i = 0; i < 32; ++i) p ^= ((u64)a << i) & (0ull - (u64)((b >> i) & 1u));
  u32 h = (u32)(p >> 32);
#pragma unroll
  for (int k = 0; k < 4; ++k) h = (h << 8) ^ tab[h >> 24];
  return (u32)p ^ h;
}

// x^(8 n) mod P, by the set bits of n.
__device__ u32 xpow8(unsigned long long n, const u32* tab) {
  u32 r = 1;
  for (int k = 3; n; ++k, n >>= 1)
    if (n & 1) r = mulmod(r, kXPow2[k & 31], tab);
  return r;
}

// Inclusive and exclusive scans of the CTA's states in thread order, each
// thread's v the state of 2^log_bytes bytes from 0: *incl the state of the
// bytes of threads 0..t, *excl of threads 0..t-1. buf: 2 * blockDim.x words.
__device__ void scan_states(u32 v, int log_bytes, int log_threads, u32* buf, const u32* tab, u32* incl,
                            u32* excl) {
  const int t = threadIdx.x, n = 1 << log_threads;
  int cur = 0;
  buf[t] = v;
  __syncthreads();
  for (int r = 0; r < log_threads; ++r) {
    const int d = 1 << r;
    u32 x = buf[cur * n + t];
    // The later span (x's, d threads long) moves its predecessor past it.
    if (t >= d) x ^= mulmod(buf[cur * n + t - d], kXPow2[(3 + log_bytes + r) & 31], tab);
    buf[(cur ^ 1) * n + t] = x;
    cur ^= 1;
    __syncthreads();
  }
  *incl = buf[cur * n + t];
  *excl = t ? buf[cur * n + t - 1] : 0u;
}

__global__ void __launch_bounds__(kThreads)
crc_spans(const unsigned char* __restrict__ chunk, long long n, int aligned, u32* __restrict__ seg_prefix,
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
    // The chunk's last segment, which may be short (or empty past n); the
    // spans after it feed no endpoint, so their scan values go unused.
    for (long long i = lo; i < n && i < lo + kSeg; ++i) s = crc_step(s, chunk[i], tab);
  }
  u32 incl, excl;
  scan_states(s, kLogSeg, kLogThreads, buf, tab, &incl, &excl);
  seg_prefix[seg] = excl;
  if (threadIdx.x == kThreads - 1) cta_state[blockIdx.x] = incl;
}

__global__ void __launch_bounds__(kFinish)
crc_finish(const unsigned char* __restrict__ chunk, long long n, const long long* __restrict__ pts, int n_ranges,
           const u32* __restrict__ seg_prefix, u32* __restrict__ cta_state, long long n_ctas, int log_run,
           u32* __restrict__ pt_state, long long* __restrict__ crcs) {
  __shared__ u32 tab[256];
  __shared__ u32 buf[2 * kFinish];
  build_table(tab);
  __syncthreads();
  const int t = threadIdx.x;
  const long long c0 = (long long)t << log_run, c1 = min(c0 + (1ll << log_run), n_ctas);
  const u32 cta_shift = kXPow2[(3 + kLogSpan) & 31];
  u32 v = 0;
  for (long long c = c0; c < c1; ++c) v = mulmod(v, cta_shift, tab) ^ cta_state[c];
  u32 incl, excl;
  scan_states(v, kLogSpan + log_run, kLogFinish, buf, tab, &incl, &excl);
  // Every CTA's state becomes its exclusive prefix, S(its first byte).
  for (long long c = c0; c < c1; ++c) {
    const u32 own = cta_state[c];
    cta_state[c] = excl;
    excl = mulmod(excl, cta_shift, tab) ^ own;
  }
  __syncthreads();
  // S(p) of each endpoint, from the segment holding byte p - 1 (every
  // segment and CTA before it is whole).
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

long long n_ctas_of(long long n) { return (n + (1ll << kLogSpan) - 1) >> kLogSpan; }

}  // namespace

// Scratch words for a chunk of n bytes and n_ranges ranges (-1 if too large).
extern "C" int bz2t_crc_ranges_work(long long n, int n_ranges) {
  const long long words = n_ctas_of(n) * (kThreads + 1) + 2ll * n_ranges;
  return n <= 0 || n_ranges < 0 || words > 0x7fffffffll ? -1 : (int)words;
}

// chunk: (n,) bytes; pts: (2 n_ranges,) int64, the starts then the ends,
// 0 <= start <= end <= n (clamped into [0, n]); work: the scratch words
// above; crcs: (n_ranges,) int64 finalised CRCs.
extern "C" int bz2t_crc_ranges(const unsigned char* chunk, long long n, const long long* pts, int n_ranges,
                               u32* work, long long* crcs, cudaStream_t stream) {
  if (bz2t_crc_ranges_work(n, n_ranges) < 0 || n_ranges == 0) return (int)cudaErrorInvalidValue;
  const long long n_ctas = n_ctas_of(n);
  int log_run = 0;
  while (((long long)kFinish << log_run) < n_ctas) ++log_run;
  u32* seg_prefix = work;
  u32* cta_state = work + n_ctas * kThreads;
  u32* pt_state = cta_state + n_ctas;
  const int aligned = (reinterpret_cast<uintptr_t>(chunk) & 15) == 0;
  crc_spans<<<(unsigned)n_ctas, kThreads, 0, stream>>>(chunk, n, aligned, seg_prefix, cta_state);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  crc_finish<<<1, kFinish, 0, stream>>>(chunk, n, pts, n_ranges, seg_prefix, cta_state, n_ctas, log_run, pt_state,
                                         crcs);
  return (int)cudaGetLastError();
}
