// rle1_dec: the decode's inverse RLE1 of a batch of rows (D7), in two
// launches: rle1_dec_parse, then rle1_dec_expand.
//
// Replaces no Pallas kernel: bz2tpu inverts RLE1 on the host, after the
// inverse BWT's copy back (bz2tpu/runtime/device_decode.py:285, the native
// inverse_rle1), and so did the port, one block after another in one
// serial C loop (150-265 MB/s on one host core). Here the rows stay on the
// card after the inverse BWT, and each batch's final bytes are made there;
// D5 (crc_ranges.cu) then takes each row's CRC over them.
//
// The parse. bzip2 writes a run of 4 to 255 equal bytes as 4 of them and a
// count byte. Reading a row, a state k counts the data bytes of the
// current run (0 right after a count); a byte read in state 4 is a count,
// whatever its value, and the state after it is 0, so the byte after a
// count starts a run of 1 even where it equals the run byte. Per byte:
//
//   k = 4 -> 0 (a count: the run byte, the byte before it, c times);
//   k = 0 -> 1; k = 1..3 -> k + 1 if the byte equals the one before it, else 1
//
// A byte's step depends on the data alone (it equals the byte before it or
// not), so a stretch of bytes is a map of the five states, and maps
// compose associatively: 3 bits a state, one 32-bit word a map. Since the
// state before a byte decides whether it is a count, a stretch's output
// from each of the five entry states goes with its map (an Agg).
//
// rle1_dec_parse: a CTA of 256 threads takes 4,096 bytes of a row (a
// tile), 16 a thread; each thread walks its bytes from all five states,
// and an ordered reduction gives the tile's Agg. The CTA that finishes a
// row's last tile (an atomic count a row, which it sets back to 0) scans
// the row's Aggs from state 0 at the row's start: each tile's entry state
// and output offset, and the row's output. The CTA that finishes the last
// row (a count after the rows' counts) turns the rows' outputs into their
// offsets in the batch's output. No CTA waits for another.
//
// rle1_dec_expand: the same tiles. A scan of the threads' maps gives each
// thread its entry state, a scan of their output counts its offset; each
// byte's output end and the byte it writes go to shared memory, and the
// CTA then writes the tile's output 16 aligned bytes a thread, each
// thread finding its first source byte by a binary search (a count of
// 255 spreads over 16 threads instead of one), with one 16-byte store
// where the segment is the tile's alone.
//
// Bound: a row of n bytes writes at most 259 ceil(n / 5) bytes (a count
// follows 4 data bytes of its own and writes at most 255), so a level-9
// batch of 8 rows of at most 900,000 bytes writes at most 373 MB (under
// 400 MB), and rows of the decode's capacity 2^20 at most 435 MB: below
// D5's 2^31. On the card it moves each input byte in about twice (once a
// launch) and each output byte out once: for a batch of 8 x 900 kB rows
// of text, some 22 MB, 6.5 us at 3.35 TB/s; its work is a few dozen
// integer instructions a byte. The two launches take 0.124 ms of device
// time there (H100 SXM, 700 W), so what holds it back is latency: each
// launch's CTAs in a wave or two, each loading its tile before it can
// step, and the row scan in the last CTA after all of a row's tiles.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;             // a CTA
constexpr int kBytes = 16;                // bytes a thread
constexpr int kTile = kThreads * kBytes;  // 4,096 bytes a CTA
constexpr int kWarps = kThreads / 32;
constexpr int kAggWords = 6;              // an Agg in device memory: its map, its five outputs
constexpr u32 kIdentity = 0x4688u;        // the map s -> s

__device__ __forceinline__ u32 field(u32 map, u32 s) { return (map >> (3u * s)) & 7u; }

// The state after a byte, from the state before it (see the head).
__device__ __forceinline__ u32 step(u32 k, bool eq) { return k == 4u ? 0u : (k == 0u || !eq) ? 1u : k + 1u; }

// Map a, then map b.
__device__ __forceinline__ u32 then(u32 a, u32 b) {
  u32 r = 0;
#pragma unroll
  for (u32 s = 0; s < 5; ++s) r |= field(b, field(a, s)) << (3u * s);
  return r;
}

struct Agg {
  u32 map;     // the state after the stretch, from each state before it
  u32 out[5];  // the bytes the stretch writes, from each state before it
};

__device__ __forceinline__ u32 pick(const u32 (&v)[5], u32 s) {
  return s == 0 ? v[0] : s == 1 ? v[1] : s == 2 ? v[2] : s == 3 ? v[3] : v[4];
}

// Stretch a, then stretch b.
__device__ __forceinline__ Agg combine(const Agg& a, const Agg& b) {
  Agg r;
  r.map = then(a.map, b.map);
#pragma unroll
  for (u32 s = 0; s < 5; ++s) r.out[s] = a.out[s] + pick(b.out, field(a.map, s));
  return r;
}

__device__ __forceinline__ Agg identity_agg() {
  Agg r;
  r.map = kIdentity;
#pragma unroll
  for (int s = 0; s < 5; ++s) r.out[s] = 0;
  return r;
}

__device__ __forceinline__ Agg load_agg(const u32* p) {
  Agg r;
  r.map = __ldcg(p);
#pragma unroll
  for (int s = 0; s < 5; ++s) r.out[s] = __ldcg(p + 1 + s);
  return r;
}

// The tile's bytes into s[1..count], the byte before the tile into s[0] (0
// at the row's start, where the state is 0 and no step reads it); returns
// count, the tile's bytes below n.
__device__ __forceinline__ int load_tile(const unsigned char* __restrict__ row, int start, int n, unsigned char* s) {
  const int count = min(kTile, n - start);
  for (int j = (int)threadIdx.x; j < count; j += kThreads) s[1 + j] = row[start + j];
  if (threadIdx.x == 0) s[0] = start ? row[start - 1] : 0;
  __syncthreads();
  return count;
}

// A row's valid bytes: n clamped into [0, width].
__device__ __forceinline__ int row_bytes(const int* n_of, int row, long long width) {
  return (int)min((long long)max(n_of[row], 0), width);
}

__global__ void __launch_bounds__(kThreads)
rle1_dec_parse(const unsigned char* __restrict__ rows, long long stride, long long width,
               const int* __restrict__ n_of, int n_rows, int tiles, u32* __restrict__ agg,
               int* __restrict__ prefix, long long* __restrict__ offsets, u32* __restrict__ counters) {
  __shared__ unsigned char s[kTile + 1];
  __shared__ Agg part[kThreads];
  __shared__ int last;
  __shared__ u32 row_out;
  const int row = blockIdx.y, tile = blockIdx.x, lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n = row_bytes(n_of, row, width);
  const int n_tiles = max(1, (n + kTile - 1) / kTile);
  if (tile >= n_tiles) return;
  const int count = load_tile(rows + row * stride, tile * kTile, n, s);

  // This thread's bytes, from each entry state.
  Agg a;
  {
    u32 k[5] = {0u, 1u, 2u, 3u, 4u}, out[5] = {0u, 0u, 0u, 0u, 0u};
    const int j0 = (int)threadIdx.x * kBytes;
#pragma unroll
    for (int i = 0; i < kBytes; ++i) {
      if (j0 + i < count) {
        const u32 c = s[1 + j0 + i];
        const bool eq = c == s[j0 + i];
#pragma unroll
        for (int st = 0; st < 5; ++st) {
          out[st] += k[st] == 4u ? c : 1u;
          k[st] = step(k[st], eq);
        }
      }
    }
    a.map = k[0] | k[1] << 3 | k[2] << 6 | k[3] << 9 | k[4] << 12;
#pragma unroll
    for (int st = 0; st < 5; ++st) a.out[st] = out[st];
  }
  // In order over the warp: lane 0 ends with the warp's 512 bytes.
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    Agg b;
    b.map = __shfl_down_sync(BZ2T_FULL_MASK, a.map, o);
#pragma unroll
    for (int st = 0; st < 5; ++st) b.out[st] = __shfl_down_sync(BZ2T_FULL_MASK, a.out[st], o);
    if ((lane & (2 * o - 1)) == 0) a = combine(a, b);
  }
  if (lane == 0) part[warp] = a;
  __syncthreads();
  if (threadIdx.x == 0) {
    Agg t = part[0];
    for (int w = 1; w < kWarps; ++w) t = combine(t, part[w]);
    u32* dst = agg + ((long long)row * tiles + tile) * kAggWords;
    dst[0] = t.map;
    for (int st = 0; st < 5; ++st) dst[1 + st] = t.out[st];
    __threadfence();
    last = atomicAdd(&counters[row], 1u) == (u32)(n_tiles - 1);
  }
  __syncthreads();
  if (!last) return;

  // The row's last tile to finish: its tiles' Aggs, a thread's run of them,
  // scanned in order; then each tile's entry state and output offset from
  // state 0 at the row's start.
  __threadfence();
  const u32* base = agg + (long long)row * tiles * kAggWords;
  const int tid = threadIdx.x, per = (n_tiles + kThreads - 1) / kThreads;
  const int t0 = min(tid * per, n_tiles), t1 = min(t0 + per, n_tiles);
  Agg mine = identity_agg();
  for (int t = t0; t < t1; ++t) mine = combine(mine, load_agg(base + t * kAggWords));
  __syncthreads();  // part[] is free again
  part[tid] = mine;
  __syncthreads();
  for (int o = 1; o < kThreads; o <<= 1) {
    Agg v = part[tid];
    if (tid >= o) v = combine(part[tid - o], v);
    __syncthreads();
    part[tid] = v;
    __syncthreads();
  }
  u32 st = 0, off = 0;
  if (tid) {
    st = field(part[tid - 1].map, 0);
    off = part[tid - 1].out[0];
  }
  for (int t = t0; t < t1; ++t) {
    int* p = prefix + 2 * ((long long)row * tiles + t);
    p[0] = (int)st;
    p[1] = (int)off;
    const Agg g = load_agg(base + t * kAggWords);
    off += pick(g.out, st);
    st = field(g.map, st);
  }
  if (t0 < t1 && t1 == n_tiles) row_out = off;
  __syncthreads();
  if (threadIdx.x == 0) {
    offsets[row + 1] = row_out;
    counters[row] = 0;
    __threadfence();
    if (atomicAdd(&counters[n_rows], 1u) == (u32)(n_rows - 1)) {
      // The last row: each row's output becomes its end in the batch's.
      __threadfence();
      long long sum = 0;
      offsets[0] = 0;
      for (int r = 1; r <= n_rows; ++r) {
        sum += __ldcg(offsets + r);
        offsets[r] = sum;
      }
      counters[n_rows] = 0;
    }
  }
}

__global__ void __launch_bounds__(kThreads)
rle1_dec_expand(const unsigned char* __restrict__ rows, long long stride, long long width,
                const int* __restrict__ n_of, int tiles, const int* __restrict__ prefix,
                const long long* __restrict__ offsets, unsigned char* __restrict__ out) {
  __shared__ unsigned char s[kTile + 1];
  __shared__ u32 ends[kTile];            // each byte's output end, from the tile's output start
  __shared__ unsigned char val[kTile];   // the byte it writes
  __shared__ u32 warp_map[kWarps], warp_out[kWarps];
  const int row = blockIdx.y, tile = blockIdx.x, lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n = row_bytes(n_of, row, width);
  if (tile * kTile >= n) return;
  const int count = load_tile(rows + row * stride, tile * kTile, n, s);
  const int* pre = prefix + 2 * ((long long)row * tiles + tile);
  const u32 entry = (u32)pre[0], tile_off = (u32)pre[1];
  const int j0 = (int)threadIdx.x * kBytes;

  // This thread's map, then the maps before it in the tile: its entry state.
  u32 map;
  {
    u32 k[5] = {0u, 1u, 2u, 3u, 4u};
#pragma unroll
    for (int i = 0; i < kBytes; ++i) {
      if (j0 + i < count) {
        const bool eq = s[1 + j0 + i] == s[j0 + i];
#pragma unroll
        for (int st = 0; st < 5; ++st) k[st] = step(k[st], eq);
      }
    }
    map = k[0] | k[1] << 3 | k[2] << 6 | k[3] << 9 | k[4] << 12;
  }
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const u32 m = __shfl_up_sync(BZ2T_FULL_MASK, map, o);
    if (lane >= o) map = then(m, map);
  }
  u32 before = __shfl_up_sync(BZ2T_FULL_MASK, map, 1);
  if (lane == 31) warp_map[warp] = map;
  __syncthreads();
  if (lane == 0) before = kIdentity;
  {
    u32 w_before = kIdentity;
    for (int w = 0; w < warp; ++w) w_before = then(w_before, warp_map[w]);
    before = then(w_before, before);
  }

  // This thread's bytes: each one's output count and the byte it writes.
  u32 st = field(before, entry), len[kBytes], total = 0;
#pragma unroll
  for (int i = 0; i < kBytes; ++i) {
    len[i] = 0;
    if (j0 + i < count) {
      const u32 c = s[1 + j0 + i];
      const bool eq = c == s[j0 + i];
      const bool is_count = st == 4u;
      len[i] = is_count ? c : 1u;
      val[j0 + i] = is_count ? s[j0 + i] : (unsigned char)c;
      total += len[i];
      st = step(st, eq);
    }
  }
  u32 incl = total;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const u32 v = __shfl_up_sync(BZ2T_FULL_MASK, incl, o);
    if (lane >= o) incl += v;
  }
  if (lane == 31) warp_out[warp] = incl;
  __syncthreads();
  u32 run = incl - total, tile_out = 0;
  for (int w = 0; w < kWarps; ++w) {
    if (w < warp) run += warp_out[w];
    tile_out += warp_out[w];
  }
#pragma unroll
  for (int i = 0; i < kBytes; ++i) {
    if (j0 + i < count) {
      run += len[i];
      ends[j0 + i] = run;
    }
  }
  __syncthreads();
  if (tile_out == 0) return;

  // The tile's output, [d0, d1) of the batch's, 16 aligned bytes a thread.
  const long long d0 = offsets[row] + tile_off, d1 = d0 + tile_out;
  for (long long seg = (d0 >> 4) + (long long)threadIdx.x; seg <= (d1 - 1) >> 4; seg += kThreads) {
    const long long p0 = seg << 4;
    const int lo = (int)max(0ll, d0 - p0), hi = (int)min(16ll, d1 - p0);
    u32 rel = (u32)(p0 + lo - d0);
    // The first byte whose output ends past rel.
    int a = 0, b = count - 1;
    while (a < b) {
      const int mid = (a + b) >> 1;
      if (ends[mid] > rel) b = mid;
      else a = mid + 1;
    }
    u32 w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      if (i >= lo && i < hi) {
        while (ends[a] <= rel) ++a;
        w[i >> 2] |= (u32)val[a] << (8 * (i & 3));
        ++rel;
      }
    }
    if (lo == 0 && hi == 16) {
      *reinterpret_cast<uint4*>(out + p0) = make_uint4(w[0], w[1], w[2], w[3]);
    } else {
#pragma unroll
      for (int i = 0; i < 16; ++i)
        if (i >= lo && i < hi) out[p0 + i] = (unsigned char)(w[i >> 2] >> (8 * (i & 3)));
    }
  }
}

}  // namespace

// Tiles a row of `width` bytes takes (at least 1).
extern "C" int bz2t_rle1_dec_tiles(long long width) {
  const long long t = (width + kTile - 1) / kTile;
  return t < 1 ? 1 : t > 0x7fffffffll ? -1 : (int)t;
}

// rows: (n_rows, width) uint8 with row stride `stride` bytes; n: (n_rows,)
// int32 valid bytes a row (clamped into [0, width]); agg: n_rows x tiles x
// 6 words of scratch; prefix: (n_rows, tiles, 2) int32, each tile's entry
// state and output offset in its row; offsets: (n_rows + 1,) int64, each
// row's start in the batch's output and the end; counters: n_rows + 1 zero
// words, left zero.
extern "C" int bz2t_rle1_dec_parse(const unsigned char* rows, long long stride, long long width, const int* n,
                                   int n_rows, int tiles, u32* agg, int* prefix, long long* offsets, u32* counters,
                                   cudaStream_t stream) {
  if (n_rows <= 0 || n_rows > 65535 || tiles <= 0) return (int)cudaErrorInvalidValue;
  rle1_dec_parse<<<dim3((unsigned)tiles, (unsigned)n_rows), kThreads, 0, stream>>>(
      rows, stride, width, n, n_rows, tiles, agg, prefix, offsets, counters);
  return (int)cudaGetLastError();
}

// The batch's output into out (offsets[n_rows] bytes, 16-byte aligned), from
// rle1_dec_parse's prefix and offsets.
extern "C" int bz2t_rle1_dec_expand(const unsigned char* rows, long long stride, long long width, const int* n,
                                    int n_rows, int tiles, const int* prefix, const long long* offsets,
                                    unsigned char* out, cudaStream_t stream) {
  if (n_rows <= 0 || n_rows > 65535 || tiles <= 0) return (int)cudaErrorInvalidValue;
  rle1_dec_expand<<<dim3((unsigned)tiles, (unsigned)n_rows), kThreads, 0, stream>>>(
      rows, stride, width, n, tiles, prefix, offsets, out);
  return (int)cudaGetLastError();
}
