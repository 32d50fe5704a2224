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
// literal) leaves q as it is.
//
// One warp owns one chunk and holds its list in registers: lane L keeps
// entries 8L..8L+7, one byte each, in a 64-bit word. A step reads entry j
// from lane j >> 3 with one shuffle, and shifts entries 0..j up by one with
// a second: every lane below j >> 3 takes the top byte of the lane below
// it as its new first byte, the lane of j does so only up to byte j & 7,
// and lane 0 takes e. The chunk's 128 indices are read once, four a lane,
// and passed to the step that needs them by shuffle; the emits collect
// four a lane and leave with the list in one coalesced store each.
//
// The bound is the bytes it moves, a byte read and three written a
// literal (or, on a chunk of mostly large moves, the j + 1 entries each
// move shifts); what holds it back is instruction issue, some twenty
// warp instructions a literal.
#include "common.cuh"

namespace {

constexpr int kChunk = 128;  // literals a chunk (the JAX form's _CHUNK)
constexpr int kWarps = 8;    // chunks a CTA

__global__ void __launch_bounds__(kWarps * 32)
mtf_dec(const unsigned char* __restrict__ js, long long n_chunks, unsigned char* __restrict__ q,
        unsigned char* __restrict__ emit) {
  const long long c = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (c >= n_chunks) return;
  const int lane = threadIdx.x & 31;
  const u32 jw = reinterpret_cast<const u32*>(js + c * kChunk)[lane];  // indices 4 lane .. 4 lane + 3
  u64 w = 0;
#pragma unroll
  for (int k = 0; k < 8; ++k) w |= (u64)(8 * lane + k) << (8 * k);  // the identity
  u32 em = 0;
  for (int src = 0; src < 32; ++src) {
    const u32 four = __shfl_sync(BZ2T_FULL_MASK, jw, src);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int j = (four >> (8 * k)) & 0xff;
      const int jl = j >> 3, jb = j & 7;
      const u32 e = (u32)(__shfl_sync(BZ2T_FULL_MASK, w, jl) >> (8 * jb)) & 0xffu;
      const u64 below = __shfl_up_sync(BZ2T_FULL_MASK, w, 1) >> 56;  // lane - 1's last entry
      const u64 shifted = (w << 8) | (lane == 0 ? (u64)e : below);
      const u64 keep = lane < jl ? 0ull : lane > jl ? ~0ull : jb == 7 ? 0ull : ~0ull << (8 * (jb + 1));
      w = (shifted & ~keep) | (w & keep);
      if (lane == src) em |= e << (8 * k);
    }
  }
  reinterpret_cast<u64*>(q + c * 256)[lane] = w;
  reinterpret_cast<u32*>(emit + c * kChunk)[lane] = em;
}

}  // namespace

// js: (n_chunks, 128) uint8 move indices (16-byte aligned); q: (n_chunks,
// 256) uint8 chunk permutations and emit: (n_chunks, 128) uint8 local
// emits, both outputs (16-byte aligned).
extern "C" int bz2t_mtf_dec(const unsigned char* js, long long n_chunks, unsigned char* q, unsigned char* emit,
                            cudaStream_t stream) {
  if (n_chunks <= 0) return (int)cudaGetLastError();
  const long long grid = (n_chunks + kWarps - 1) / kWarps;
  if (grid > 0x7fffffffll) return (int)cudaErrorInvalidValue;
  mtf_dec<<<(unsigned)grid, kWarps * 32, 0, stream>>>(js, n_chunks, q, emit);
  return (int)cudaGetLastError();
}
