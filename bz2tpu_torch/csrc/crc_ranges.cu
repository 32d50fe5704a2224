// crc_ranges: the finalised CRC-32/BZIP2 of many byte ranges of one chunk.
//
// Replaces the lane loop of the device intake's range CRCs
// (bz2tpu/ops/crc.py:crc32_ranges, the lax.fori_loop at :166, body
// :158-164), its Kogge-Stone lane fold (:176-183) and its operator ladders
// (the lax.fori_loop at :111), not a Pallas kernel: XLA keeps those loops on
// the device, while eager torch issues every step of them from the host.
//
// The bzip2 CRC is MSB-first and not reflected. A state s is a polynomial
// over GF(2) of degree < 32, and a byte b takes it to (s x^8 + b x^32) mod P,
// P = x^32 + 0x04C11DB7: one lookup in the byte table. Moving a state past
// n zero bytes multiplies it by x^(8n) mod P, a linear map on 32 bits; with
// S(p) the state of the prefix [0, p) from 0, a range's CRC follows from
// its endpoints:
//
//   crc[s, e) = x^(8(e - s)) (0xFFFFFFFF ^ S(s)) ^ S(e) ^ 0xFFFFFFFF.
//
// Shifts by tables. Map k moves a state past 2^k zero bytes; it is held as
// eight 16-entry tables, one a nibble of the state (`maps`, 32 maps x 128
// words, built once a device by ops/crc_cuda.py), so applying it is eight
// lookups and seven xors, and a shift by any n < 2^32 bytes is one map a set
// bit of n. The 16 entries of a nibble table sit in 16 banks, so a warp
// that applies one map reads shared memory without conflicts.
//
// One launch a call:
//   * a CTA takes its tile (2^kLogSpan bytes) from an atomic counter, so
//     every smaller tile belongs to a CTA already running and the look-back
//     below cannot deadlock (the CTA that takes the last tile sets the
//     tile count back to 0 and adds one to the calls counted above it); it
//     builds the byte table (map 2 of a byte) in shared memory, one copy
//     (32 copies, one a lane, would spare the chains' bank conflicts, but
//     time slower: tools/probe_intake_kernels.py), and copies the maps
//     there;
//   * a thread steps its 64 bytes (four 16-byte loads) from state 0, as four
//     chains of 16 bytes side by side joined by maps; a warp scans its 32
//     states by shuffles, each round one fixed map; warp 0 scans the warp
//     totals the same way, which gives the tile's state from 0;
//   * the tile publishes that aggregate in a 64-bit status word (flag above
//     the state). A tile that holds no range endpoint (p whose byte p - 1
//     lies in it) is then done: only an endpoint needs its tile's prefix;
//   * an endpoint's tile works out the state of [tile start, p) from 0 (the
//     segment's prefix in the scan, then the bytes of its segment before
//     p), then looks back with every warp at once, warp w over the 32
//     predecessors at distances 32 w + 1 .. 32 w + 32, each word moved past
//     the tiles between by the maps, and the windows up to the nearest
//     inclusive word fold into S(tile start): one round reaches 32 kWarps
//     tiles back, all of an 8 MiB chunk's; it publishes S(its end);
//   * with that prefix, each endpoint's S(p); a start s is moved on to its
//     range's end at once, x^(8(e - s)) (0xFFFFFFFF ^ S(s)), and handed to
//     the end's tile in a 64-bit word; the end's tile (never before the
//     start's) waits for it, writes the CRC and clears the word;
//   * the status words come in two arrays that alternate between calls,
//     by the parity of the calls counted in the counter word, which only
//     the card reads and writes: a call clears the array it does not use,
//     so the workspace needs no clearing launch, and calls issued from
//     several host threads on one stream stay apart.
//
// The bound is the chunk's bytes, read once: 8 MiB in 2.5 us at 3.35 TB/s.
// The byte chains are a lookup a byte, on an SM that holds two tiles 64 Ki
// of them; the scans, the look-back and the endpoints add a few dozen map
// applications on an endpoint tile's critical path.
#include "common.cuh"

namespace {

constexpr int kLogSeg = 6;  // 64 bytes a thread
constexpr int kSeg = 1 << kLogSeg;
constexpr int kLogThreads = 9;  // 512 threads a tile
constexpr int kThreads = 1 << kLogThreads;
constexpr int kWarps = kThreads / 32;
constexpr int kLogSpan = kLogSeg + kLogThreads;  // bytes a tile
constexpr int kMapWords = 8 * 16;                // a map: eight nibble tables
constexpr int kTableWords = 32 * kMapWords;      // maps 0..31
constexpr u32 kPoly = 0x04C11DB7u;               // P = x^32 + kPoly
constexpr u64 kAggregate64 = 1ull << 32;         // status: the tile's own state
constexpr u64 kInclusive64 = 2ull << 32;         // status: S(the tile's end)
static_assert(kThreads >= 256 && kWarps <= 32, "a thread an entry of the byte table; warp 0 scans the warps");

__device__ __forceinline__ u64 load_status64(const u64* p) { return *reinterpret_cast<const volatile u64*>(p); }

__device__ __forceinline__ void store_status64(u64* p, u64 v) { *reinterpret_cast<volatile u64*>(p) = v; }

// v moved past 2^k zero bytes: map = maps + k * kMapWords.
__device__ __forceinline__ u32 apply_map(const u32* map, u32 v) {
  u32 r = 0;
#pragma unroll
  for (int j = 0; j < 8; ++j) r ^= map[16 * j + ((v >> (4 * j)) & 15u)];
  return r;
}

// v moved past n zero bytes (n < 2^32): one map a set bit, lowest first.
__device__ u32 shift_bytes(const u32* maps, u32 v, unsigned long long n) {
  for (u32 bits = (u32)n; bits; bits &= bits - 1) v = apply_map(maps + (__ffs(bits) - 1) * kMapWords, v);
  return v;
}

// Endpoint i of 2 n_ranges (the starts, then the ends), clamped into [0, n];
// an end is taken as at least its start, so its tile is never before the
// start's.
struct Endpoints {
  const void* starts;
  const void* ends;
  int n_ranges, wide;  // wide: int64 indices, else int32
  __device__ __forceinline__ long long read(const void* base, int k, long long n) const {
    const long long p = wide ? static_cast<const long long*>(base)[k] : static_cast<const int*>(base)[k];
    return min(max(p, 0ll), n);
  }
  __device__ __forceinline__ long long at(int i, long long n) const {
    return i < n_ranges ? read(starts, i, n) : max(read(ends, i - n_ranges, n), read(starts, i - n_ranges, n));
  }
};

// a b mod P for two states: the carry-less product, whose high word h
// comes back as h x^32 mod P, map 2 of h.
__device__ u32 clmul_mod(u32 a, u32 b, const u32* maps) {
  u32 lo = 0, hi = 0;
#pragma unroll 1
  for (int i = 0; i < 32; ++i) {
    const u32 take = 0u - ((b >> i) & 1u);
    lo ^= (a << i) & take;
    hi ^= (i ? a >> (32 - i) : 0u) & take;
  }
  return lo ^ apply_map(maps + 2 * kMapWords, hi);
}

// The look-back warps' own barrier: the endpoint warp does not take part.
__device__ __forceinline__ void lookback_sync() {
  asm volatile("bar.sync 1, %0;" ::"r"((kWarps - 1) * 32) : "memory");
}

// The tile's prefix handed from the look-back warps to the endpoint warp.
__device__ __forceinline__ void prefix_arrive() { asm volatile("bar.arrive 2, %0;" ::"r"(kThreads) : "memory"); }
__device__ __forceinline__ void prefix_wait() { asm volatile("bar.sync 2, %0;" ::"r"(kThreads) : "memory"); }

// One byte into state s; tab: the byte table.
__device__ __forceinline__ u32 crc_step(u32 s, u32 byte, const u32* tab) {
  return (s << 8) ^ tab[((s >> 24) ^ byte) & 0xffu];
}

size_t smem_bytes() { return sizeof(u32) * (kTableWords + kWarps + kThreads); }

__global__ void __launch_bounds__(kThreads, 1024 / kThreads)
crc_ranges(const unsigned char* __restrict__ chunk, long long n, int aligned, Endpoints pts, int n_ranges,
           const u32* __restrict__ maps_g, u64* __restrict__ counter, u64* __restrict__ statuses,
           unsigned capacity, u64* __restrict__ handoff, long long* __restrict__ crcs, unsigned n_tiles) {
  extern __shared__ __align__(16) u32 smem[];
  u32* maps = smem;                  // kTableWords
  u32* wsum = maps + kTableWords;    // kWarps: warp totals, then their inclusive scan
  u32* xs = wsum + kWarps;           // kThreads: each thread's exclusive state in its warp
  __shared__ unsigned s_tile, s_parity;
  __shared__ u32 tab[256];
  __shared__ u32 win_val[kWarps];
  __shared__ bool win_inclusive[kWarps];
  __shared__ int s_owns;
  __shared__ u32 s_prefix;
  const int t = threadIdx.x, lane = t & 31, w = t >> 5;
  if (t == 0) {
    // The counter word: the tiles taken in this call, and above them the
    // calls before it on this workspace. Every other tile of the call is
    // taken once the last one is: the next call starts from tile 0 and
    // takes the other status array.
    const u64 got = atomicAdd(counter, 1ull);
    if ((unsigned)got == n_tiles - 1) *counter = ((got >> 32) + 1) << 32;
    const unsigned tile = (unsigned)got;
    s_tile = tile;
    s_parity = (unsigned)(got >> 32) & 1u;
    s_owns = 0;
  }
  // The maps' loads go out now and land in shared memory after the byte
  // chains, which do not need them.
  constexpr int kMapLoads = kTableWords / 4 / kThreads;
  uint4 mreg[kMapLoads];
#pragma unroll
  for (int r = 0; r < kMapLoads; ++r) mreg[r] = __ldg(reinterpret_cast<const uint4*>(maps_g) + t + r * kThreads);
  if (t < 256) {  // b x^32 mod P, b the byte t
    u32 c = (u32)t << 24;
#pragma unroll
    for (int k = 0; k < 8; ++k) c = (c << 1) ^ ((c >> 31) ? kPoly : 0u);
    tab[t] = c;
  }
  __syncthreads();
  const unsigned tile = s_tile;
  u64* status = statuses + (long long)s_parity * capacity;
  u64* status_next = statuses + (long long)(s_parity ^ 1u) * capacity;
  const long long tile_lo = (long long)tile << kLogSpan;
  const long long lo = tile_lo + ((long long)t << kLogSeg);
  const bool whole = aligned && lo + kSeg <= n;
  uint4 d[kSeg / 16];
  if (whole) {
    const uint4* p = reinterpret_cast<const uint4*>(chunk + lo);
#pragma unroll
    for (int q = 0; q < kSeg / 16; ++q) d[q] = __ldg(p + q);
  }
  // The next call's status words start at zero: each tile clears its own,
  // the last tile the rest of the array.
  if (t == 0) status_next[tile] = 0;
  if (tile == n_tiles - 1)
    for (unsigned i = n_tiles + t; i < capacity; i += kThreads) status_next[i] = 0;
  for (int i = t; i < 2 * n_ranges; i += kThreads) {
    const long long p = pts.at(i, n);
    if (((p ? (p - 1) : 0) >> kLogSpan) == (long long)tile) s_owns = 1;
  }
  __syncthreads();

  // This thread's 64 bytes from state 0 (the chunk's last segment may be
  // short, or empty past n).
  u32 s = 0;
  if (whole) {
#pragma unroll
    for (int q = 0; q < kSeg / 16; ++q) {
      const u32 words[4] = {d[q].x, d[q].y, d[q].z, d[q].w};
#pragma unroll
      for (int k = 0; k < 4; ++k)
#pragma unroll
        for (int j = 0; j < 4; ++j) s = crc_step(s, words[k] >> (8 * j), tab);
    }
  } else {
    for (long long i = lo; i < n && i < lo + kSeg; ++i) s = crc_step(s, chunk[i], tab);
  }
#pragma unroll
  for (int r = 0; r < kMapLoads; ++r) reinterpret_cast<uint4*>(maps)[t + r * kThreads] = mreg[r];
  __syncthreads();
  // Inclusive scan of the warp's states: after round r a lane holds the
  // state of its last 2^(r + 1) segments, and the lane d = 2^r below it
  // covers the 2^r segments before those.
  u32 x = s;
#pragma unroll
  for (int r = 0; r < 5; ++r) {
    const u32 y = __shfl_up_sync(BZ2T_FULL_MASK, x, 1 << r);
    const u32 moved = apply_map(maps + (kLogSeg + r) * kMapWords, y);
    if (lane >= (1 << r)) x ^= moved;
  }
  const u32 xe = __shfl_up_sync(BZ2T_FULL_MASK, x, 1);
  xs[t] = lane ? xe : 0u;
  if (lane == 31) wsum[w] = x;
  __syncthreads();

  // Warp 0: the warp totals' inclusive scan (warp w's entry becomes the
  // state of warps 0..w from 0), the tile's aggregate published.
  u32 agg = 0;
  if (w == 0) {
    u32 v = lane < kWarps ? wsum[lane] : 0u;
#pragma unroll
    for (int r = 0; (1 << r) < kWarps; ++r) {
      const u32 y = __shfl_up_sync(BZ2T_FULL_MASK, v, 1 << r);
      const u32 moved = apply_map(maps + (kLogSeg + 5 + r) * kMapWords, y);
      if (lane >= (1 << r)) v ^= moved;
    }
    if (lane < kWarps) wsum[lane] = v;
    agg = __shfl_sync(BZ2T_FULL_MASK, v, kWarps - 1);
    if (lane == 0) store_status64(status + tile, (tile == 0 ? kInclusive64 : kAggregate64) | agg);
  }
  __syncthreads();
  // A tile that holds no endpoint is done: its aggregate is out.
  if (!s_owns) return;

  // The last warp takes this tile's endpoints while the other warps look
  // back. For an endpoint p (a start s or an end e) of a range that ends at
  // e, with P = S(tile start):
  //   S(p) = x^(8(p - tile start)) P ^ L(p), L(p) the state of
  //   [tile start, p) from 0; an end's part is L(e), a start's is
  //   K = x^(8(e - s)) (0xFFFFFFFF ^ L(s)), and both then add
  //   x^(8(e - tile start)) P, one carry-less product once P is known;
  //   so a start's word is x^(8(e - s)) (0xFFFFFFFF ^ S(s)).
  // Two lanes an endpoint, 16 endpoints a pass in the order of their
  // index (every start before every end): the even lane works out the
  // part, L(p) being the segment's prefix in the scan and then the bytes
  // of the segment before p, four at a time where the chunk is aligned
  // (four bytes b0..b3 take a state v to map 2 of v ^ (b0 b1 b2 b3 as a
  // big-endian word)); the odd lane the constant x^(8(e - tile start)).
  // Then the even lane adds the product: a start hands its word to the
  // end's tile in a 64-bit word (flag above the state); an end (its tile
  // never before its start's: e is taken as at least s) waits for that
  // word, writes the CRC and clears the word for the next call. A pass's
  // starts go out before its ends wait, so a warp never waits on itself.
  if (w == kWarps - 1) {
    bool have_prefix = false;
    u32 prefix = 0;
    for (int ep0 = 0; ep0 < 2 * n_ranges; ep0 += 16) {
      const int ep = ep0 + (lane >> 1);
      long long p = 0, e = 0;
      bool mine = false;
      if (ep < 2 * n_ranges) {
        p = pts.at(ep, n);
        mine = ((p ? (p - 1) : 0) >> kLogSpan) == (long long)tile;
        e = ep < n_ranges ? pts.at(n_ranges + ep, n) : p;
      }
      u32 v = 0;
      if (mine && (lane & 1)) {
        v = shift_bytes(maps, 1u, (unsigned long long)(e - tile_lo));
      } else if (mine) {
        const long long seg = p ? (p - 1) >> kLogSeg : 0;
        const int ts = (int)(seg - ((long long)tile << kLogThreads));
        const int ws = ts >> 5;
        v = shift_bytes(maps, ws ? wsum[ws - 1] : 0u, (unsigned long long)(ts & 31) << kLogSeg) ^ xs[ts];
        long long q = seg << kLogSeg;
        if (aligned)
          for (; q + 4 <= p; q += 4)
            v = apply_map(maps + 2 * kMapWords, v ^ __byte_perm(*reinterpret_cast<const u32*>(chunk + q), 0, 0x0123));
        for (; q < p; ++q) v = crc_step(v, chunk[q], tab);
        if (ep < n_ranges) v = shift_bytes(maps, v ^ 0xffffffffu, (unsigned long long)(e - p));
      }
      const u32 constant = __shfl_xor_sync(BZ2T_FULL_MASK, v, 1);
      if (!have_prefix) {
        prefix_wait();
        prefix = s_prefix;
        have_prefix = true;
      }
      const bool even = (lane & 1) == 0;
      if (mine && even) v ^= clmul_mod(prefix, constant, maps);
      if (mine && even && ep < n_ranges) store_status64(handoff + ep, kInclusive64 | v);
      __syncwarp();
      if (mine && even && ep >= n_ranges) {
        u64 moved;
        while (((moved = load_status64(handoff + ep - n_ranges)) >> 32) == 0) __nanosleep(64);
        store_status64(handoff + ep - n_ranges, 0);
        crcs[ep - n_ranges] = (long long)((u32)moved ^ v ^ 0xffffffffu);
      }
    }
    if (!have_prefix) prefix_wait();
  } else {
    // Look back, the other warps at once: S(tile start) from the
    // predecessors' words, warp w taking the 32 at distances 32 w + lane + 1
    // (then the next 32 (kWarps - 1)), each moved past the tiles after it;
    // the windows count up to the nearest one that holds an inclusive word,
    // and within it the lanes up to that word (a lane before tile 0 reads
    // S(0) = 0).
    u32 prefix = 0;
    if (tile > 0) {
      for (long long round = 0;; ++round) {
        const long long d = (round * (kWarps - 1) + w) * 32 + lane;
        const long long j = (long long)tile - 1 - d;
        u64 st;
        u32 inclusive;
        for (;;) {
          st = j >= 0 ? load_status64(status + j) : kInclusive64;
          inclusive = __ballot_sync(BZ2T_FULL_MASK, (st >> 32) == 2u);
          const u32 ready = __ballot_sync(BZ2T_FULL_MASK, (st >> 32) != 0u);
          const u32 needed = inclusive ? ((inclusive & (0u - inclusive)) << 1) - 1u : 0xffffffffu;
          if ((ready & needed) == needed) break;
          __nanosleep(64);  // a predecessor is still stepping its bytes: spare the L2 the polls
        }
        const int stop = inclusive ? __ffs(inclusive) - 1 : 31;
        u32 v = lane <= stop ? shift_bytes(maps, (u32)st, (unsigned long long)d << kLogSpan) : 0u;
#pragma unroll
        for (int o = 16; o; o >>= 1) v ^= __shfl_xor_sync(BZ2T_FULL_MASK, v, o);
        if (lane == 0) {
          win_val[w] = v;
          win_inclusive[w] = inclusive != 0;
        }
        lookback_sync();
        bool done = false;
        for (int k = 0; k < kWarps - 1 && !done; ++k) {
          prefix ^= win_val[k];
          done = win_inclusive[k];
        }
        lookback_sync();
        if (done) break;
      }
      if (t == 0) store_status64(status + tile, kInclusive64 | (apply_map(maps + kLogSpan * kMapWords, prefix) ^ agg));
    }
    if (t == 0) s_prefix = prefix;
    prefix_arrive();
  }
}

long long n_tiles_of(long long n) { return (n + (1ll << kLogSpan) - 1) >> kLogSpan; }

}  // namespace

// Tiles of a chunk of n bytes (-1 if n is out of range).
extern "C" int bz2t_crc_ranges_tiles(long long n) { return n <= 0 || n > 0x7fffffffll ? -1 : (int)n_tiles_of(n); }

// Workspace words for chunks of up to `capacity` tiles and up to
// `range_capacity` ranges: the 64-bit counter word (tiles taken, calls
// made), two arrays of `capacity` 64-bit status words (a call reads and
// writes the one its calls' parity picks and clears the other for the next
// call) and a 64-bit handoff word a range. Zero when made; each call
// leaves the tiles taken, the next call's status words and the handoff
// words zero.
extern "C" int bz2t_crc_ranges_work(int capacity, int range_capacity) {
  const long long words = 2 + 4ll * capacity + 2ll * range_capacity;
  return capacity < 0 || range_capacity < 0 || words > 0x7fffffffll ? -1 : (int)words;
}

// chunk: (n,) bytes; starts, ends: (n_ranges,) int64 where wide, else
// int32 (clamped into [0, n]); maps: (32, 8, 16) words, map k moving a state
// past 2^k zero bytes, entry [k][j][v] the image of nibble j of the state
// holding v; work: the workspace above (8-byte aligned), used by one
// stream; crcs: (n_ranges,) int64 finalised CRCs.
extern "C" int bz2t_crc_ranges(const unsigned char* chunk, long long n, const void* starts, const void* ends,
                               int wide, int n_ranges, const u32* maps, u32* work, int capacity, int range_capacity,
                               long long* crcs, cudaStream_t stream) {
  const int n_tiles = bz2t_crc_ranges_tiles(n);
  if (n_tiles < 0 || n_tiles > capacity || n_ranges <= 0 || n_ranges > range_capacity ||
      (reinterpret_cast<uintptr_t>(work) & 7))
    return (int)cudaErrorInvalidValue;
  const cudaError_t attr =
      cudaFuncSetAttribute(crc_ranges, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_bytes());
  if (attr != cudaSuccess) return (int)attr;
  const int aligned = (reinterpret_cast<uintptr_t>(chunk) & 15) == 0;
  u64* counter = reinterpret_cast<u64*>(work);
  u64* statuses = counter + 1;
  u64* handoff = statuses + 2ll * capacity;
  crc_ranges<<<(unsigned)n_tiles, kThreads, smem_bytes(), stream>>>(
      chunk, n, aligned, Endpoints{starts, ends, n_ranges, wide}, n_ranges, maps, counter, statuses,
      (unsigned)capacity, handoff, crcs, (unsigned)n_tiles);
  return (int)cudaGetLastError();
}
