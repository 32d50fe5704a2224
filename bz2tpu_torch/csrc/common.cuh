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

// A status word of a single-pass scan with decoupled look-back (K1's
// digit offsets, K2's running max): a tile publishes its own aggregate,
// then the inclusive prefix over all tiles up to it; the flag sits in the
// top two bits (0: nothing yet), a value below 2^30 under it. One 32-bit
// word carries both, so a volatile access is all the ordering it needs.
constexpr u32 kAggregate = 1u << 30;
constexpr u32 kInclusive = 2u << 30;
constexpr u32 kValue = (1u << 30) - 1u;

__device__ __forceinline__ u32 load_status(const u32* p) {
  return *reinterpret_cast<const volatile u32*>(p);
}

__device__ __forceinline__ void store_status(u32* p, u32 v) {
  *reinterpret_cast<volatile u32*>(p) = v;
}
