// Shared by K3 (stem.cu), K4 (bottleneck.cu), K5 (roi_classifier_head.cu)
// and K6 (roi_mask_head.cu): the warp-level bf16 tensor-core product and
// the shared-memory loads that feed it (ldmatrix, cp.async).
//
// The product is the warp-level mma.sync m16n8k16 (bf16 in, float32
// accumulate) with its fragments loaded by hand, not through WMMA: the
// register layout is then known (PTX ISA, "Matrix Fragments for
// mma.m16n8k16"), so a kernel can gather A rows from anywhere (K4's 3x3
// taps read shifted rows, K3 its conv positions' rows of the input patch)
// and apply an epilogue to each element where it sits. For lane = 4 * g + t:
//   A (16x16, row-major): a0 = A[g][2t..2t+1],   a1 = A[g+8][2t..2t+1],
//                         a2 = A[g][2t+8..2t+9], a3 = A[g+8][2t+8..2t+9]
//   B (16x8), read from its transpose Bt (N x K, K contiguous):
//                         b0 = Bt[g][2t..2t+1],  b1 = Bt[g][2t+8..2t+9]
//   C (16x8, float32):    c0, c1 = C[g][2t], C[g][2t+1];
//                         c2, c3 = C[g+8][2t], C[g+8][2t+1]
// From shared memory, ldsm_x4 gives A with lane l addressing row
// (l & 7) + 8 * ((l >> 3) & 1), column 8 * (l >> 4) of the 16x16 tile;
// ldsm_x4_trans gives the B fragments of two n8 tiles from B stored K-major
// (row k, N contiguous) with lane l addressing row (l & 7) + 8 * ((l >> 3)
// & 1), column 8 * (l >> 4): registers b0, b1 of columns 0-7, then b0, b1
// of columns 8-15.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace mrt {

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ uint32_t pack_bf16(float a, float b) {
  __nv_bfloat162 v = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t lds32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// d += A (16x16 bf16) * B (16x8 bf16), float32 accumulation.
__device__ __forceinline__ void mma16816(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += A * B as a float32 sum rounds it: the product's 16 terms summed by
// the tensor core into a zero accumulator, then added to d in FADDs (round
// to nearest). The tensor core's own d += A * B rounds toward zero at
// every step, which over a long K grows each sum's error (K4: 1.6-3.7x
// the plain version's, PERF.md).
__device__ __forceinline__ void mma16816_rn(float (&d)[4],
                                            const uint32_t (&a)[4],
                                            uint32_t b0, uint32_t b1) {
  float t[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  mma16816(t, a, b0, b1);
#pragma unroll
  for (int e = 0; e < 4; ++e) d[e] += t[e];
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4],
                                              uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// 16 bytes global -> shared, asynchronous; zero-filled when !full.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool full) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(full ? 16 : 0) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

}  // namespace mrt
