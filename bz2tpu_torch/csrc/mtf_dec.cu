// mtf_dec: each 128-literal chunk's inverse-MTF permutation and local emits.
//
// Replaces the chunk lax.fori_loop of the inverse MTF
// (bz2tpu/ops/mtf_dec.py:100-112), not a Pallas kernel: XLA keeps its 128
// steps on the device, while eager torch issues some 8 launches over the
// whole (B, m / 128, 256) uint8 state for each of them. Each literal of a
// chunk moves list entry j to the front of a 256-entry list that starts as
// the identity:
//
//   e = q[j];  emit[i] = e;  q[1..j] = q[0..j-1];  q[0] = e
//
// so after the chunk q is the chunk's permutation (later composed across
// chunks by a scan, ops/mtf_dec.py) and emit holds each literal's entry in
// the list as the chunk found it. j = 0 (the padding past the last
// literal) leaves q as it is and emits q[0].
//
// A warp owns two chunks, 16 lanes each. Lane L of a chunk holds entries
// 16 L .. 16 L + 15 in four 32-bit words (one byte an entry) and index
// words L and L + 16 of the chunk. A step:
//
//   * picks word (j >> 2) & 3 of every lane by a tree of selects and reads
//     entry j from lane j >> 4 with one shuffle (a byte permute takes e);
//   * shifts the entries at or below j up by one: each word takes the top
//     byte of the word below it in front of its own (a funnel shift; word
//     0 takes lane L - 1's entry 15 by a second shuffle, lane 0 takes e),
//     and keeps its entries above j (a mask 8 (j + 1) - 32 (4 L + i) bits
//     up, then one LOP3);
//   * shifts e into a register of the last four emits, which the lane that
//     owns them keeps every fourth step.
//
// The steps after the last nonzero index of both chunks are not walked:
// they leave the lists as they are and emit q[0], which is written for
// them. Zeros in the middle of a chunk are walked (exact, j = 0 moves
// nothing). A literal's index is sym - 1 >= 1, so in the decode the zeros
// are exactly the padding past each block's literals.
//
// The first design gave a chunk a whole warp (eight entries a lane in a
// u64) and walked all 128 steps: 37 SASS instructions a step for one chunk.
// Two chunks a warp with 32-bit words take about 33 for two
// (tools/probe_dec_kernels.py times one, two and four chunks a warp and
// one a thread). The bound is the bytes it moves, a byte read and three
// written a literal; what holds it back is integer instruction issue,
// some 17 instructions a literal.
#include "common.cuh"

namespace {

constexpr int kChunk = 128;  // literals a chunk (the JAX form's _CHUNK)
constexpr int kLanes = 16;   // lanes a chunk, two chunks a warp
constexpr int kW = 4;        // list words a lane (16 entries)
constexpr int kWarps = 8;    // warps a CTA

__global__ void __launch_bounds__(kWarps * 32)
mtf_dec(const unsigned char* __restrict__ js, long long n_chunks, unsigned char* __restrict__ q,
        unsigned char* __restrict__ emit) {
  const long long c0 = ((long long)blockIdx.x * kWarps + (threadIdx.x >> 5)) * 2;  // the warp's first chunk
  if (c0 >= n_chunks) return;
  const int half = (threadIdx.x >> 4) & 1, lane = threadIdx.x & (kLanes - 1);
  const long long c = c0 + half;
  const bool live = c < n_chunks;
  const u32* src = reinterpret_cast<const u32*>(js + c * kChunk);
  const u32 jw0 = live ? src[lane] : 0u, jw1 = live ? src[kLanes + lane] : 0u;  // index words L, L + 16

  // The chunk's last nonzero index: the top nonzero word's top nonzero byte.
  int n_steps = 0;
  {
    const u32 nz0 = (__ballot_sync(BZ2T_FULL_MASK, jw0 != 0) >> (kLanes * half)) & 0xffffu;
    const u32 nz1 = (__ballot_sync(BZ2T_FULL_MASK, jw1 != 0) >> (kLanes * half)) & 0xffffu;
    const int top0 = nz0 ? 31 - __clz(nz0) : 0, top1 = nz1 ? 31 - __clz(nz1) : 0;
    const u32 tw0 = __shfl_sync(BZ2T_FULL_MASK, jw0, top0, kLanes);
    const u32 tw1 = __shfl_sync(BZ2T_FULL_MASK, jw1, top1, kLanes);
    if (nz1)
      n_steps = 4 * (kLanes + top1) + ((31 - __clz(tw1)) >> 3) + 1;
    else if (nz0)
      n_steps = 4 * top0 + ((31 - __clz(tw0)) >> 3) + 1;
  }
  const int n_groups = __reduce_max_sync(BZ2T_FULL_MASK, (unsigned)((n_steps + 3) >> 2));  // of four steps

  u32 w[kW];
#pragma unroll
  for (int i = 0; i < kW; ++i) w[i] = 0x03020100u + 0x04040404u * (kW * lane + i);  // the identity
  const int t_lane = 8 - 32 * kW * lane;  // + 8 j: bits of the lane's entries at or below j
  u32 em0 = 0, em1 = 0, ring = 0;
  for (int gi = 0; gi < n_groups; ++gi) {
    const u32 four = __shfl_sync(BZ2T_FULL_MASK, gi < kLanes ? jw0 : jw1, gi % kLanes, kLanes);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int j = __byte_perm(four, 0u, 0x4440u | k);
      const u32 s01 = j & 8 ? w[2] : w[0], s11 = j & 8 ? w[3] : w[1];
      const u32 e = __byte_perm(__shfl_sync(BZ2T_FULL_MASK, j & 4 ? s11 : s01, j >> 4, kLanes), 0u,
                                0x4440u | (j & 3));
      const u32 below = __shfl_up_sync(BZ2T_FULL_MASK, w[kW - 1], 1, kLanes) >> 24;  // lane L - 1's entry 15
      const int t = 8 * j + t_lane;
      u32 prev = w[0];
      {
        const u32 keep = __funnelshift_lc(0u, ~0u, (u32)max(t, 0));  // entries above j
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
      if (gi < kLanes)
        em0 = ring;
      else
        em1 = ring;
    }
  }
  // Past the last step walked every step emits q[0].
  const u32 front = (__shfl_sync(BZ2T_FULL_MASK, w[0], 0, kLanes) & 0xffu) * 0x01010101u;
  if (lane >= n_groups) em0 = front;
  if (kLanes + lane >= n_groups) em1 = front;
  if (live) {
    reinterpret_cast<uint4*>(q + c * 256)[lane] = make_uint4(w[0], w[1], w[2], w[3]);
    u32* dst = reinterpret_cast<u32*>(emit + c * kChunk);
    dst[lane] = em0;
    dst[kLanes + lane] = em1;
  }
}

}  // namespace

// js: (n_chunks, 128) uint8 move indices (16-byte aligned); q: (n_chunks,
// 256) uint8 chunk permutations and emit: (n_chunks, 128) uint8 local
// emits, both outputs (16-byte aligned).
extern "C" int bz2t_mtf_dec(const unsigned char* js, long long n_chunks, unsigned char* q, unsigned char* emit,
                            cudaStream_t stream) {
  if (n_chunks <= 0) return (int)cudaGetLastError();
  const long long grid = (n_chunks + 2 * kWarps - 1) / (2 * kWarps);
  if (grid > 0x7fffffffll) return (int)cudaErrorInvalidValue;
  mtf_dec<<<(unsigned)grid, kWarps * 32, 0, stream>>>(js, n_chunks, q, emit);
  return (int)cudaGetLastError();
}
