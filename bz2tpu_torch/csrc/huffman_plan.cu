// D2: the whole Huffman refinement of a batch, one launch, one thread-block
// cluster per block.
//
// Replaces the device loops of bz2tpu/ops/huffman.py:huffman_assign: the
// refinement's lax.while_loop (:243-289) around the code-length tree scan
// (code_lengths, the lax.scan at :111 inside the cap's lax.while_loop at
// :144) and the choice between the iteration-4 and the converged state
// (:291-316) with its selector MTF ranks (selector_mtf_ranks). There is no
// pl.pallas_call behind it. The plain version is huffman_plan_ref in
// bz2tpu_torch/ops/huffman_cuda.py: ~20 torch ops, two float64 products over
// the (B, maxsel, 258) group histogram and one host sync an iteration.
//
// What it computes, per block (all integers, so every sum is exact):
//   iteration i = 0..31, from the seed lengths:
//     cost[g][t] = sum of table t's lengths over group g's <= 50 symbols,
//     sel[g] = argmin over the block's live tables (first index on ties);
//     done when i > 0 and no selector changed; else refit every table's
//     lengths to the histogram of its groups (Huffman depths of
//     w = max(freq, 1) below alpha, w <- 1 + (w >> 1) while a depth is over
//     17; leaves in stable ascending order of weight, a leaf winning a weight
//     tie against an internal node);
//   keep the state after iteration 4 (if the loop ran past it) where its
//   stream bits (symbol codes + selector unaries + delta-coded table rows)
//   are fewer than the last state's; then the chosen selectors' MTF ranks.
//
// Design for the H100. Blocks are independent: each is one cluster of
// kCluster = 8 CTAs, the portable cluster size (16, one CTA per SM for a
// batch of 8, is no faster: the six tables' builds set the time). A CTA
// owns a contiguous range of the block's groups and keeps, in shared memory,
// the six tables' lengths packed 10 bits a table into one u64 per symbol (a
// group's cost under a table is at most 50 * 17 < 1024), so a group's six
// costs are 50 loads and 50 adds; its groups' selectors; and a 6 x 258
// histogram of its groups by selector, updated only for the groups whose
// selector changed (add to the new table, subtract from the old), so late
// iterations touch a few groups. Through distributed shared memory the owner
// CTA of each table sums the cluster's histograms and builds that table's
// lengths (the six builds run on six SMs at once); every CTA then reads the
// six new rows back. Two cluster barriers an iteration; the done flag is an
// OR over the CTAs' flags. After the loop the owners count each candidate's
// symbol and table bits, and the selector MTF ranks are a max-scan of the
// tables' last occurrences (within a thread's run of groups, over the
// threads by warp shuffles, over the CTAs through DSMEM), then a walk of each
// thread's run. Nothing returns to the host before the end.
//
// The symbols are read from device memory every iteration; a level-9 batch
// holds at most ~29 MB of them, so they stay in the 50 MB L2 across
// iterations. What bounds the kernel on this card is the serial two-queue
// merge of each table's tree (257 dependent steps by one thread), once per
// iteration and again per cap retry, times 2-32 iterations; the parallel
// phases (costs, histograms, depths, scans) take less. A parallel exact
// tree construction is the lever left.
#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kAlpha = 258;
constexpr int kTables = 6;
constexpr int kGroup = 50;
constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxLength = 17;  // stock bzip2's encoder cap
constexpr int kIters = 32;      // HUFFMAN_REFINE_ITERS
constexpr int kSnapIter = 3;    // the state after 4 iterations
constexpr int kField = 10;      // bits of one table's cost in a packed sum
constexpr int kFieldMask = (1 << kField) - 1;
constexpr int kCluster = 8;  // CTAs a block: CTA t < 6 owns table t
static_assert(kCluster >= kTables, "one owner CTA a table");
constexpr int kNone = -(1 << 30);  // "no occurrence" in the MTF scan
constexpr unsigned char kNoTable = 0xFF;

// format/constants.py: TABLE_COUNT_THRESHOLDS.
__device__ __forceinline__ int table_count(int n_sym) {
  return 2 + (n_sym >= 200) + (n_sym >= 600) + (n_sym >= 1200) + (n_sym >= 2400);
}

struct Tree {  // one table's code-length build
  int w[kAlpha];                 // this pass's weights by symbol
  int leaf_w[kAlpha];            // leaf weights, stably sorted
  int node_w[kAlpha - 1];        // internal node j's weight
  short order[kAlpha];           // symbol of each sorted leaf
  short up[2 * kAlpha - 1];      // symbol i, internal j at kAlpha + j: its ancestor
  short hops[2 * kAlpha - 1];    // ... and the hops to it
};

struct Shared {
  u64 packed[kAlpha];                  // the six tables' lengths by symbol
  int hist[kTables][kAlpha];           // this CTA's groups' symbols, by selector
  int rfreq[kTables][kAlpha];          // owned tables: the cluster's histogram
  int rfreq4[kTables][kAlpha];         // ... at the snapshot
  unsigned char len[kTables][kAlpha];  // owned tables: the lengths (read by all)
  unsigned char len4[kTables][kAlpha]; // ... at the snapshot
  Tree tree;
  long long table_bits[2][kTables];    // owned tables' bits, [last, snapshot]
  long long sel_bits[2];               // this CTA's selector unary bits
  long long warp_sum[kWarps];
  int last_agg[2][kTables];            // this CTA's last occurrence of each table
  int warp_last[kWarps][kTables];
  int changed;
};

__device__ long long block_sum(long long v, long long* scratch) {
  for (int d = 16; d; d >>= 1) v += __shfl_down_sync(BZ2T_FULL_MASK, v, d);
  if ((threadIdx.x & 31) == 0) scratch[threadIdx.x >> 5] = v;
  __syncthreads();
  long long total = 0;
  for (int w = 0; w < kWarps; ++w) total += scratch[w];
  __syncthreads();
  return total;
}

// Code lengths of one table from its histogram, by all threads of the CTA:
// a counting-rank stable sort of the leaves, the serial two-queue merge in
// one thread (the queue heads in registers, the next leaf loaded a pick
// ahead), then every leaf's depth by pointer doubling over the parents.
__device__ void build_lengths(const int* freq, int alpha, Tree& tr, unsigned char* out) {
  constexpr int kInf = 0x7fffffff;  // above any weight (at most ~2^21)
  const int t = threadIdx.x;
  const int root = kAlpha + alpha - 2;
  for (int i = t; i < kAlpha; i += kThreads) tr.w[i] = i < alpha ? max(freq[i], 1) : 0;
  __syncthreads();
  while (true) {
    for (int i = t; i < alpha; i += kThreads) {
      const int wi = tr.w[i];
      int rank = 0;
      for (int j = 0; j < alpha; ++j) {
        const int wj = tr.w[j];
        rank += (wj < wi) | ((wj == wi) & (j < i));
      }
      tr.leaf_w[rank] = wi;
      tr.order[rank] = (short)i;
    }
    __syncthreads();
    if (t == 0 && alpha >= 2) {
      int li = 0, ii = 0;  // next unpicked sorted leaf, internal node
      int lw = tr.leaf_w[0], lid = tr.order[0];
      int lw_next = tr.leaf_w[1], lid_next = tr.order[1];
      int nw = kInf;  // the node queue's head weight (kInf: empty)
      for (int j = 0; j < alpha - 1; ++j) {
        int id[2], pw[2];
#pragma unroll
        for (int k = 0; k < 2; ++k) {
          if (lw <= nw) {  // a leaf wins a weight tie
            id[k] = lid;
            pw[k] = lw;
            ++li;
            lw = lw_next;
            lid = lid_next;
            lw_next = li + 1 < alpha ? tr.leaf_w[li + 1] : kInf;
            lid_next = li + 1 < alpha ? tr.order[li + 1] : 0;
          } else {
            id[k] = kAlpha + ii;
            pw[k] = nw;
            ++ii;
            nw = ii < j ? tr.node_w[ii] : kInf;
          }
        }
        const int wj = pw[0] + pw[1];
        tr.node_w[j] = wj;
        if (ii == j) nw = wj;  // node j heads an empty queue
        tr.up[id[0]] = (short)(kAlpha + j);
        tr.up[id[1]] = (short)(kAlpha + j);
      }
      tr.up[root] = (short)root;
    }
    __syncthreads();
    for (int v = t; v < 2 * kAlpha - 1; v += kThreads) tr.hops[v] = v != root;
    __syncthreads();
    for (int round = 0; alpha >= 2 && round < 9; ++round) {  // 2^9 > any depth (<= 257)
      short h[2], u[2];
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const int v = t + q * kThreads;
        const bool live = (v < alpha) || (v >= kAlpha && v <= root);
        h[q] = live ? (short)(tr.hops[v] + tr.hops[tr.up[v]]) : 0;
        u[q] = live ? tr.up[tr.up[v]] : 0;
      }
      __syncthreads();
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const int v = t + q * kThreads;
        if ((v < alpha) || (v >= kAlpha && v <= root)) {
          tr.hops[v] = h[q];
          tr.up[v] = u[q];
        }
      }
      __syncthreads();
    }
    int over = 0;
    for (int i = t; i < alpha; i += kThreads) over |= alpha >= 2 && tr.hops[i] > kMaxLength;
    if (!__syncthreads_or(over)) break;
    for (int i = t; i < alpha; i += kThreads) tr.w[i] = 1 + (tr.w[i] >> 1);
    __syncthreads();
  }
  for (int i = t; i < kAlpha; i += kThreads) out[i] = (i < alpha && alpha >= 2) ? (unsigned char)tr.hops[i] : 0;
  __syncthreads();
}

// Move a run of `count` copies of symbol s from table `from` (none on the
// first assignment) to table `to` in this CTA's histogram.
__device__ __forceinline__ void move_run(int (*hist)[kAlpha], int from, int to, int s, int count) {
  if (from != kNoTable) atomicSub(&hist[from][s], count);
  atomicAdd(&hist[to][s], count);
}

__global__ void __cluster_dims__(kCluster, 1, 1) __launch_bounds__(kThreads)
huffman_plan(const int* __restrict__ symbols, int width, const int* __restrict__ n_syms,
             const int* __restrict__ n_in_uses, const int* __restrict__ seed, int maxsel,
             int* __restrict__ selectors, int* __restrict__ sel_mtf, int* __restrict__ lengths,
             int* __restrict__ iters) {
  __shared__ Shared sm;
  extern __shared__ __align__(16) unsigned char dyn[];
  cg::cluster_group cluster = cg::this_cluster();
  constexpr int csize = kCluster;
  const int rank = (int)cluster.block_rank();
  const int b = blockIdx.x / csize;
  const int t = threadIdx.x;
  const int lane = t & 31, warp = t >> 5;
  const int n_sym = min(max(n_syms[b], 0), width);
  const int alpha = min(max(n_in_uses[b] + 2, 0), kAlpha);
  const int n_tab = table_count(n_sym);
  const int n_sel = min((n_sym + kGroup - 1) / kGroup, maxsel);
  const int per = (n_sel + csize - 1) / csize;
  const int g0 = min(rank * per, n_sel);
  const int n_own = min(g0 + per, n_sel) - g0;
  const int cap = (maxsel + csize - 1) / csize;
  unsigned char* sel = dyn;              // own groups' selectors
  unsigned char* sel4 = dyn + cap;       // ... at the snapshot
  unsigned char* rnk = dyn + 2 * cap;    // their MTF ranks
  unsigned char* rnk4 = dyn + 3 * cap;
  const int* sym = symbols + (size_t)b * width;

  for (int i = t; i < kAlpha; i += kThreads) {
    u64 p = 0;
    for (int k = 0; k < kTables; ++k)
      p |= (u64)(seed[((size_t)b * kTables + k) * kAlpha + i] & kFieldMask) << (kField * k);
    sm.packed[i] = p;
  }
  for (int i = t; i < kTables * kAlpha; i += kThreads) (&sm.hist[0][0])[i] = 0;
  for (int k = t; k < n_own; k += kThreads) sel[k] = kNoTable;
  __syncthreads();

  int i_fin = 0;
  bool have_snap = false;
  for (int it = 0; it < kIters; ++it) {
    // A. Each own group's costs, its table, and the histogram moves.
    int changed = 0;
    for (int k = t; k < n_own; k += kThreads) {
      const int p0 = (g0 + k) * kGroup, p1 = min(p0 + kGroup, n_sym);
      u64 acc = 0;
#pragma unroll 10
      for (int p = p0; p < p1; ++p) {
        const int s = sym[p];
        acc += s < 0 ? 0ull : sm.packed[min(s, kAlpha - 1)];
      }
      int best = 0, best_cost = (int)(acc & kFieldMask);
#pragma unroll
      for (int k2 = 1; k2 < kTables; ++k2) {
        const int c = (int)((acc >> (kField * k2)) & kFieldMask);
        if (k2 < n_tab && c < best_cost) {
          best = k2;
          best_cost = c;
        }
      }
      const int old = sel[k];
      if (best != old) {
        changed = 1;
        sel[k] = (unsigned char)best;
        int run_s = -1, run = 0;
        for (int p = p0; p < p1; ++p) {
          const int s = sym[p];
          if (s < 0) continue;
          const int sc = min(s, kAlpha - 1);
          if (sc == run_s) {
            ++run;
            continue;
          }
          if (run) move_run(sm.hist, old, best, run_s, run);
          run_s = sc;
          run = 1;
        }
        if (run) move_run(sm.hist, old, best, run_s, run);
      }
    }
    changed = __syncthreads_or(changed);
    if (t == 0) sm.changed = changed;
    cluster.sync();
    int any = 0;
    for (int c = 0; c < csize; ++c) any |= *cluster.map_shared_rank(&sm.changed, c);
    i_fin = it + 1;
    if (it > 0 && !any) break;  // the fixed point: lengths would repeat

    // B. Owners: the cluster's histogram of the owned table, its lengths.
    if (rank < kTables) {  // the owner of table tb = rank
      const int tb = rank;
      for (int s = t; s < kAlpha; s += kThreads) {
        int f = 0;
        for (int c = 0; c < csize; ++c) f += cluster.map_shared_rank(&sm.hist[tb][0], c)[s];
        sm.rfreq[tb][s] = f;
        if (it == kSnapIter) sm.rfreq4[tb][s] = f;
      }
      __syncthreads();
      build_lengths(sm.rfreq[tb], alpha, sm.tree, sm.len[tb]);
      if (it == kSnapIter)
        for (int s = t; s < kAlpha; s += kThreads) sm.len4[tb][s] = sm.len[tb][s];
    }
    cluster.sync();

    // C. Every CTA: the six new rows.
    for (int s = t; s < kAlpha; s += kThreads) {
      u64 p = 0;
      for (int k = 0; k < kTables; ++k)
        p |= (u64)cluster.map_shared_rank(&sm.len[k][0], k)[s] << (kField * k);
      sm.packed[s] = p;
    }
    if (it == kSnapIter) {
      for (int k = t; k < n_own; k += kThreads) sel4[k] = sel[k];
      have_snap = true;
    }
    __syncthreads();
  }

  // The candidates: 0 = the last state, 1 = the snapshot (if taken).
  const int n_cand = have_snap ? 2 : 1;
  if (rank < kTables) {  // the owner of table tb = rank
    const int tb = rank;
    for (int cand = 0; cand < n_cand; ++cand) {
      const int* f = cand ? sm.rfreq4[tb] : sm.rfreq[tb];
      const unsigned char* L = cand ? sm.len4[tb] : sm.len[tb];
      long long v = 0;
      for (int s = t; s < kAlpha; s += kThreads) {
        v += (long long)f[s] * L[s];
        if (tb < n_tab && s < alpha) v += 2 * abs((int)L[s] - (int)L[max(s - 1, 0)]) + 1;
      }
      v = block_sum(v, sm.warp_sum);
      if (t == 0) sm.table_bits[cand][tb] = v;
    }
  }

  // Selector MTF ranks: thread t walks own groups [k0, k1), after the last
  // occurrence of each table before k0, from a scan over threads and CTAs.
  const int chunk = (n_own + kThreads - 1) / kThreads;
  const int k0 = min(t * chunk, n_own), k1 = min(k0 + chunk, n_own);
  int excl[2][kTables];
#pragma unroll
  for (int cand = 0; cand < 2; ++cand) {
    if (cand == n_cand) break;
    const unsigned char* X = cand ? sel4 : sel;
    int v[kTables];
#pragma unroll
    for (int k = 0; k < kTables; ++k) v[k] = kNone;
    for (int j = k0; j < k1; ++j) {
      const int s = X[j];
#pragma unroll
      for (int k = 0; k < kTables; ++k)
        if (k == s) v[k] = g0 + j;
    }
#pragma unroll
    for (int k = 0; k < kTables; ++k) {
      int x = v[k];
      for (int d = 1; d < 32; d <<= 1) {
        const int y = __shfl_up_sync(BZ2T_FULL_MASK, x, d);
        if (lane >= d) x = max(x, y);
      }
      const int before = __shfl_up_sync(BZ2T_FULL_MASK, x, 1);
      excl[cand][k] = lane ? before : kNone;
      if (lane == 31) sm.warp_last[warp][k] = x;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kTables; ++k) {
      int agg = kNone;
      for (int w = 0; w < kWarps; ++w) {
        if (w == warp) excl[cand][k] = max(excl[cand][k], agg);
        agg = max(agg, sm.warp_last[w][k]);
      }
      if (t == 0) sm.last_agg[cand][k] = agg;
    }
    __syncthreads();
  }
  cluster.sync();
  int tail[2] = {0, 0};
#pragma unroll
  for (int cand = 0; cand < 2; ++cand) {
    if (cand == n_cand) break;
    const unsigned char* X = cand ? sel4 : sel;
    unsigned char* R = cand ? rnk4 : rnk;
    int last[kTables], total[kTables];
#pragma unroll
    for (int k = 0; k < kTables; ++k) last[k] = total[k] = -(k + 1);
    for (int c = 0; c < csize; ++c) {
      const int* agg = cluster.map_shared_rank(&sm.last_agg[cand][0], c);
#pragma unroll
      for (int k = 0; k < kTables; ++k) {
        const int a = agg[k];
        if (c < rank) last[k] = max(last[k], a);
        total[k] = max(total[k], a);
      }
    }
#pragma unroll
    for (int k = 0; k < kTables; ++k) {
      last[k] = max(last[k], excl[cand][k]);
      tail[cand] += total[k] > total[0];
    }
    long long bits = 0;
    for (int j = k0; j < k1; ++j) {
      const int s = X[j];
      int own = 0;
#pragma unroll
      for (int k = 0; k < kTables; ++k)
        if (k == s) own = last[k];
      int r = 0;
#pragma unroll
      for (int k = 0; k < kTables; ++k) {
        r += last[k] > own;
        if (k == s) last[k] = g0 + j;
      }
      R[j] = (unsigned char)r;
      bits += r + 1;
    }
    bits = block_sum(bits, sm.warp_sum);
    if (t == 0) sm.sel_bits[cand] = bits;
  }
  cluster.sync();

  // The choice, the same in every CTA: the snapshot only if it is shorter.
  long long total_bits[2] = {0, 0};
  for (int cand = 0; cand < n_cand; ++cand) {
    for (int k = 0; k < kTables; ++k)
      total_bits[cand] += cluster.map_shared_rank(&sm.table_bits[cand][0], k)[k];
    for (int c = 0; c < csize; ++c) total_bits[cand] += *cluster.map_shared_rank(&sm.sel_bits[cand], c);
  }
  const int pick = (have_snap && total_bits[1] < total_bits[0]) ? 1 : 0;
  const unsigned char* X = pick ? sel4 : sel;
  const unsigned char* R = pick ? rnk4 : rnk;
  int* out_sel = selectors + (size_t)b * maxsel;
  int* out_mtf = sel_mtf + (size_t)b * maxsel;
  for (int k = t; k < n_own; k += kThreads) {
    out_sel[g0 + k] = X[k];
    out_mtf[g0 + k] = R[k];
  }
  for (int g = n_sel + rank * kThreads + t; g < maxsel; g += csize * kThreads) {
    out_sel[g] = 0;
    out_mtf[g] = tail[pick];
  }
  if (rank < kTables) {  // the owner of table tb = rank
    const int tb = rank;
    const unsigned char* L = pick ? sm.len4[tb] : sm.len[tb];
    for (int s = t; s < kAlpha; s += kThreads) lengths[((size_t)b * kTables + tb) * kAlpha + s] = L[s];
  }
  if (rank == 0 && t == 0) iters[b] = i_fin;
  cluster.sync();  // no CTA leaves while another may still read its shared memory
}

}  // namespace

// symbols: (batch, width) int32 RLE2 symbols, -1 past n_sym; n_sym,
// n_in_use: (batch,) int32; seed: (batch, 6, 258) int32 seed lengths;
// maxsel: selector slots a block. Outputs: selectors, sel_mtf (batch,
// maxsel), lengths (batch, 6, 258), iters (batch,), all int32.
extern "C" int bz2t_huffman_plan(const int* symbols, const int* n_sym, const int* n_in_use,
                                 const int* seed, int batch, int width, int maxsel,
                                 int* selectors, int* sel_mtf, int* lengths, int* iters,
                                 cudaStream_t stream) {
  if (batch <= 0) return (int)cudaGetLastError();
  if (maxsel < 1) return (int)cudaErrorInvalidValue;
  const int cap = (maxsel + kCluster - 1) / kCluster;
  const int dyn = (4 * cap + 15) & ~15;
  cudaError_t err = cudaFuncSetAttribute(huffman_plan, cudaFuncAttributeMaxDynamicSharedMemorySize, dyn);
  if (err != cudaSuccess) return (int)err;
  huffman_plan<<<batch * kCluster, kThreads, dyn, stream>>>(symbols, width, n_sym, n_in_use, seed, maxsel,
                                                            selectors, sel_mtf, lengths, iters);
  return (int)cudaGetLastError();
}
