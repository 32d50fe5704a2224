// Shared definitions for the bz2tpu_torch CUDA kernels.
//
// Every kernel file exposes a plain C interface (extern "C"): device
// pointers and the CUDA stream arrive as void-pointer-sized integers from
// ctypes (bz2tpu_torch/_build.py), scratch buffers are allocated by the
// Python wrapper, and each host entry point returns cudaGetLastError() so
// the wrapper raises on a refused launch.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

typedef unsigned long long u64;
typedef unsigned int u32;

#define BZ2T_FULL_MASK 0xffffffffu

struct SumOp {
  template <typename T>
  __device__ __forceinline__ T operator()(T a, T b) const { return a + b; }
};

struct MaxOp {
  template <typename T>
  __device__ __forceinline__ T operator()(T a, T b) const { return a > b ? a : b; }
};

// In-place exclusive scan of data[0, len) under `op` (SumOp, MaxOp) with
// identity `id`, run by ONE block of kThreads threads. The array is walked
// in chunks of kThreads * kPer: a coalesced load into shared memory, each
// thread folds kPer consecutive elements, a warp shuffle scan plus the
// chunk's warp totals gives each thread its exclusive prefix, the thread
// writes its run's prefixes back, and a coalesced store follows; the chunk
// total is carried into the next chunk. A scan this small is bound by the
// latency of its serial chunks, so the chunks are wide. Shared indices
// are padded by one word per 32 so that neither access pattern conflicts.
__device__ __forceinline__ int padded(int k) { return k + (k >> 5); }

template <int kThreads, int kPer, typename T, typename Op>
__device__ void block_exclusive_scan(T* __restrict__ data, int len, T id, Op op) {
  constexpr int kWarps = kThreads / 32;
  constexpr int kChunk = kThreads * kPer;
  __shared__ T tile[kChunk + kChunk / 32];
  __shared__ T warp_total[kWarps];
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  T carry = id;
  for (int base = 0; base < len; base += kChunk) {
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const int i = base + j * kThreads + t;
      tile[padded(j * kThreads + t)] = i < len ? data[i] : id;
    }
    __syncthreads();
    T incl = id;
#pragma unroll
    for (int j = 0; j < kPer; ++j) incl = op(incl, tile[padded(t * kPer + j)]);
    for (int o = 1; o < 32; o <<= 1) {
      const T v = __shfl_up_sync(BZ2T_FULL_MASK, incl, o);
      if (lane >= o) incl = op(v, incl);
    }
    const T excl_in_warp = __shfl_up_sync(BZ2T_FULL_MASK, incl, 1);
    if (lane == 31) warp_total[warp] = incl;
    __syncthreads();
    T before = carry;
    T total = carry;
    for (int w = 0; w < kWarps; ++w) {
      if (w == warp) before = total;
      total = op(total, warp_total[w]);
    }
    T run = lane > 0 ? op(before, excl_in_warp) : before;
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const T v = tile[padded(t * kPer + j)];
      tile[padded(t * kPer + j)] = run;
      run = op(run, v);
    }
    __syncthreads();
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const int i = base + j * kThreads + t;
      if (i < len) data[i] = tile[padded(j * kThreads + t)];
    }
    carry = total;
    __syncthreads();  // tile and warp_total are rewritten by the next chunk
  }
}
