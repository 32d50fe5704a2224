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
// The chain is serial by nature: one thread walks one block (one CTA a
// block). Each step is one load whose address depends on the step before,
// and the jump maps (hundreds of MB a batch) are far beyond L2, so a walk
// that reads the map pays one device-memory latency a group (~160 ns).
// Here the walker reads group g's jump from a window of the map in shared
// memory instead, fetched by a bulk asynchronous copy (cp.async.bulk,
// completion on an mbarrier) that a producer warp issued as soon as the
// walker had fixed cur_{g-K+1}: the walker's dependent step is a clamp, a
// bounds check and one shared-memory read, and the device-memory traffic
// runs K = kLookahead steps ahead of it.
//
// Where a window goes. Group g can start anywhere from 50 bits a group
// later to 50 * max_len bits a group later, a span tens of times wider than
// a window one SM can fetch each step, so a window of kWindow positions is
// centred where the K - 1 groups in between put it, each at its table's
// recent group width (a moving average: a table's groups are of like
// width, while widths differ by hundreds of bits from table to table in
// text). On the text and random blocks of a mixed corpus about 1% of the
// steps fall outside their window. A position outside its window (a miss,
// and each of the first K groups) costs one direct load, so the kernel is
// exact for every input.
//
// Who does what. Three producer warps, on the SM's other three
// schedulers, take the windows in turn (each has three walker steps to
// place and issue one: a warp sum over the K - 1 groups' widths, one lane
// issuing the copy); they back off between polls of the walker's progress,
// whose shared-memory traffic otherwise slows the walker's own reads by a
// tenth. The walker is unrolled over the K slots of its window ring, so a
// slot's address and barrier phase are constants, and it waits for a
// window two steps before it reads it.
//
// The limit: the walker's step, ~115 ns of dependent instructions and
// shared-memory reads against ~160 ns of device-memory latency a step for
// a walk that reads the map; only one SM walks a block, so a batch of 8
// blocks keeps 8 SMs busy. Each step fetches a window of 4 KB, ~35 GB/s an
// SM.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;   // all stage the table ids; one walks, kProducers fetch
constexpr int kProducers = 3;   // warps 1-3: the other three schedulers of the SM
constexpr int kLookahead = 16;  // windows in flight (>= 3: the walker waits two steps ahead)
constexpr int kWindow = 1024;   // positions a window (a multiple of 4)
constexpr int kGroup = 50;
constexpr int kTables = 6;
constexpr int kRing = 64;       // recent starts kept (a power of two, > 2 * kLookahead)
constexpr int kSlack = 8;       // a window's 16-byte alignment at both ends
constexpr int kFrac = 8;        // fraction bits of the width averages
constexpr int kMaxWidth = 1 << 14;  // widths clipped (a malformed map jumps anywhere)
constexpr int kPollNs = 64;     // a producer's back-off between polls of the ring
static_assert(kLookahead >= 3 && 2 * kLookahead < kRing && kWindow % 4 == 0, "window ring");

__device__ __forceinline__ u32 smem_u32(const void* p) {
  return static_cast<u32>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void bar_init(u64* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" :: "r"(smem_u32(bar)) : "memory");
}

// Wait for the phase of the mbarrier at shared address `bar` with this parity.
__device__ __forceinline__ void bar_wait(u32 bar, u32 parity) {
  u32 done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

// cur_g from the walker's ring, once the walker has published it.
__device__ __forceinline__ int ring_read(const u64* ring, int g) {
  while (true) {
    const u64 e = *reinterpret_cast<const volatile u64*>(&ring[g & (kRing - 1)]);
    if ((int)(e >> 32) == g) return (int)(u32)e;
    __nanosleep(kPollNs);
  }
}

// Copy `bytes` (a multiple of 16, both addresses 16-byte aligned) from
// device memory into shared memory; the mbarrier completes when they land.
// The slot's previous contents were read by the same thread into the value
// this copy's address depends on, so no proxy fence is needed (one would
// also wait for every copy in flight).
__device__ __forceinline__ void bulk_load(void* dst, const void* src, u32 bytes, u64* bar) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
  asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];"
               :: "r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(smem_u32(bar)) : "memory");
}

__global__ void __launch_bounds__(kThreads)
dec_chain(const int* __restrict__ jump50, const int* __restrict__ tbl, const int* __restrict__ n_groups,
          int batch, int n_tables, int nbc, int groups, int* __restrict__ starts, int* __restrict__ misses) {
  constexpr int K = kLookahead;
  constexpr int slot_words = kWindow + kSlack;
  extern __shared__ __align__(16) unsigned char smem[];
  int* win = reinterpret_cast<int*>(smem);           // K windows
  u64* bars = reinterpret_cast<u64*>(win + K * slot_words);
  int2* meta = reinterpret_cast<int2*>(bars + K);   // window start (position in the row), length
  u64* ring = reinterpret_cast<u64*>(meta + K);      // (g << 32 | cur_g) of the last kRing groups
  unsigned char* tsel = reinterpret_cast<unsigned char*>(ring + kRing);  // each group's table
  const int b = blockIdx.x;
  const int T = n_tables;
  const int ng = min(max(n_groups[b], 0), groups);
  const int* row_tbl = tbl + (size_t)b * groups;
  const size_t row0 = (size_t)b * T * nbc;
  const int* maps = jump50 + row0;
  int* out = starts + (size_t)b * groups;
  const bool fetch = (size_t)batch * T * nbc >= 4;  // 16 bytes to copy a window from
  for (int g = threadIdx.x; g < ng; g += kThreads) tsel[g] = (unsigned char)min(max(row_tbl[g], 0), T - 1);
  if (threadIdx.x < K) bar_init(&bars[threadIdx.x]);
  if (threadIdx.x < kRing) ring[threadIdx.x] = threadIdx.x ? ~0ull : 0ull;  // cur_0 = 0; no other tag
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  __syncthreads();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (warp > kProducers || (warp == 0 && lane != 0)) return;

  if (warp > 0) {
    if (!fetch) return;
    // Producer warp p = warp - 1: the windows of groups h = K + p, K + p + P,
    // ... each as soon as the walker has fixed cur_{h-K+1}. Its width
    // averages (the same in every lane; 8 fraction bits, -1 before the
    // first): est[t] for table t (bzip2 has at most six; any more share the
    // last), est[kTables] for any table, each moved a quarter of the way to
    // the width of group h - K, whose end it has just read (a sample of one
    // group in kProducers guides as well as all of them). Lane q < K - 1
    // looks up group known + q's width; one warp sum gives the span.
    const size_t end_al = ((size_t)batch * T * nbc) & ~(size_t)3;  // last whole 16 bytes
    int est[kTables + 1];
#pragma unroll
    for (int k = 0; k <= kTables; ++k) est[k] = -1;
    for (int h = K + warp - 1; h < ng; h += kProducers) {
      const int known = h - K + 1;
      const int cur = ring_read(ring, known);
      const int w = min(max(cur - ring_read(ring, known - 1), 0), kMaxWidth) << kFrac;
      const int tw = min((int)tsel[known - 1], kTables - 1);
#pragma unroll
      for (int k = 0; k <= kTables; ++k)
        if (k == tw || k == kTables) est[k] = est[k] < 0 ? w : est[k] + ((w - est[k]) >> 2);
      int e = 0;
      if (lane < K - 1) {
        const int t = min((int)tsel[known + lane], kTables - 1);
        e = est[kTables];
#pragma unroll
        for (int k = 0; k < kTables; ++k)
          if (k == t && est[k] >= 0) e = est[k];
      }
      const int span = __reduce_add_sync(BZ2T_FULL_MASK, e);
      if (lane != 0) continue;
      // Group h starts at least 50 bits a group later; the widths of the
      // groups before it, table by table, say where.
      const int pred = cur + (span >> kFrac);
      const int lo = cur + kGroup * (K - 1);
      const int wlo = min(max(lo, pred - kWindow / 2), nbc - 1);
      const int whi = min(wlo + kWindow, nbc);
      // Whole 16-byte words inside the batch's maps; at the ragged end the
      // window starts earlier (its positions map to elements all the same).
      const size_t e0 = row0 + (size_t)tsel[h] * nbc + wlo;
      const size_t e_end = (e0 + (whi - wlo) + 3) & ~(size_t)3;
      const size_t e0w = e0 & ~(size_t)3;
      const size_t e0a = e0w < end_al - 4 ? e0w : end_al - 4;
      const size_t e1c = e_end < end_al ? e_end : end_al;
      const size_t e1 = e1c > e0a + 4 ? e1c : e0a + 4;
      const int s = h % K;
      meta[s] = make_int2(wlo - (int)(e0 - e0a), (int)(e1 - e0a));
      bulk_load(win + (size_t)s * slot_words, jump50 + e0a, (u32)(e1 - e0a) * 4u, &bars[s]);
    }
    return;
  }

  // The walker, unrolled over the K slots of a round of K groups (the
  // slot, its window's shared-memory address and its mbarrier phase are
  // then constants): group g reads its jump from its window or, for a
  // miss and for the first K groups, from the map. While that load is in
  // flight it waits for group g + 2's window and reads where it lies, so
  // the dependent chain is the clamp, the bounds check and one load, with
  // the wait and its reads two steps ahead of their use. (Group g + 2's
  // producer needs only cur_{g+3-K}, so K >= 3 keeps the wait from
  // waiting on this step.)
  int miss = 0, cur = 0;
  int lo[K], n[K];  // the window of the group in each slot (n = 0: none)
#pragma unroll
  for (int s = 0; s < K; ++s) lo[s] = n[s] = 0;
  const u32 bars_sa = smem_u32(bars);
  for (int base = 0; base < ng; base += K) {
    const u32 round_bit = (u32)(base / K) & 1u;
#pragma unroll
    for (int s = 0; s < K; ++s) {
      const int g = base + s;
      if (g >= ng) break;
      out[g] = cur;
      const int idx = min(max(cur, 0), nbc - 1);
      const u32 off = (u32)(idx - lo[s]);
      int next;
      if (off < (u32)n[s]) {
        next = win[s * slot_words + off];
      } else {
        next = maps[(size_t)tsel[g] * nbc + idx];
        ++miss;
      }
      const int s2 = s + 2 < K ? s + 2 : s + 2 - K;
      if (fetch && g + 2 >= K && g + 2 < ng) {
        // Window g + 2 completes phase (g + 2) / K - 1 of its barrier.
        bar_wait(bars_sa + 8u * s2, s + 2 < K ? round_bit ^ 1u : round_bit);
        const int2 m = meta[s2];
        lo[s2] = m.x;
        n[s2] = m.y;
      }
      cur = next;
      // One 64-bit store publishes cur_{g+1} with its group: no fence (the
      // slot this step read fed the value, so those reads are done).
      *reinterpret_cast<volatile u64*>(&ring[(g + 1) & (kRing - 1)]) = (u64)(g + 1) << 32 | (u32)cur;
    }
  }
  for (int g = ng; g < groups; ++g) out[g] = cur;
  if (misses) misses[b] = miss;
}

}  // namespace

// jump50: (batch, n_tables, nbc) int32 relative 50-symbol jump maps (16-byte
// aligned); tbl: (batch, groups) int32 table per group; n_groups: (batch,)
// int32. starts: (batch, groups) int32 output, each block's final position
// repeated at and past its n_groups; misses: (batch,) int32 steps that read
// device memory directly, or null.
extern "C" int bz2t_dec_chain_smem(int groups) {
  return kLookahead * (kWindow + kSlack) * 4 + kLookahead * 16 + kRing * 8 + groups;
}

extern "C" int bz2t_dec_chain(const int* jump50, const int* tbl, const int* n_groups, int batch,
                              int n_tables, int nbc, int groups, int* starts, int* misses, cudaStream_t stream) {
  if (batch <= 0 || groups <= 0) return (int)cudaGetLastError();
  if (n_tables < 1) return (int)cudaErrorInvalidValue;
  const int smem = bz2t_dec_chain_smem(groups);
  cudaError_t err = cudaFuncSetAttribute(dec_chain, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  dec_chain<<<batch, kThreads, smem, stream>>>(jump50, tbl, n_groups, batch, n_tables, nbc, groups, starts,
                                               misses);
  return (int)cudaGetLastError();
}
