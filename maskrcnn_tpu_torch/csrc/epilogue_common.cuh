// Shared by the epilogue passes (conv_epilogue.cu, vit_epilogue.cu): the
// bf16 rounding both spell, the alignment check of their 16-byte vector
// accesses, and the host's sizing of a grid that fills the SMs once.
//
// A slice kernel gives each thread one 8-channel slice of a row (one
// 16-byte load and store a row) and walks the rows with a grid stride that
// is a multiple of the row's slices, so the slice's constants stay in
// registers. `slice_grid` sizes its grid.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace epilogue {

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

inline bool aligned16(const void* p) { return (uintptr_t)p % 16 == 0; }

inline int gcd(int a, int b) { return b ? gcd(b, a % b) : a; }

// Blocks of one kernel that fit on the current device at once, worked out
// once per device (the queries cost more host time than a small launch
// takes). One static Residency per kernel.
struct Residency {
  int dev_plus1 = 0;  // 0: not yet worked out
  int blocks = 0;

  cudaError_t get(const void* kernel, int threads, int* out) {
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return err;
    if (dev + 1 != dev_plus1) {
      int sms = 0, per_sm = 0;
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
      if (err == cudaSuccess) {
        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                            threads, 0);
      }
      if (err != cudaSuccess) return err;
      blocks = sms * per_sm;
      dev_plus1 = dev + 1;
    }
    *out = blocks;
    return cudaSuccess;
  }
};

// A slice kernel's grid: one slice a thread, no more blocks than `fit`;
// then rounded up so the grid's threads are a multiple of the row's
// `slices` (threads past the last row do nothing).
inline long slice_grid(long rows, int slices, int threads, int fit) {
  const long want = (rows * slices + threads - 1) / threads;
  const int unit = slices / gcd(slices, threads);
  const long grid = want < fit ? want : fit;
  return (grid + unit - 1) / unit * unit;
}

}  // namespace epilogue
