// Shared by K5 (roi_classifier_head.cu) and K6 (roi_mask_head.cu): the
// Hopper GEMM tile both heads run. A block owns 128 rows x 256 columns of
// the output. One producer thread asks TMA for the A tile (128 x 64,
// K-major) and the B tile (64 x 256 of a row-major (K, N) weight, as four
// 64 x 64 boxes: wgmma's transposed-B mode reads it as it is) of each K
// chunk of 64, both 128-byte swizzled, into a 4-stage ring (48 KB a
// stage). A full barrier per stage counts the TMA bytes; an empty barrier
// counts the eight consumer warps that are done with it. Two consumer
// warpgroups each hold a 64 x 256 float32 accumulator fed by wgmma
// m64n256k16 (descriptors step 32 B per k16 in A, 2 KB in B; LBO 8 KB
// between B's 64-column atoms, SBO 1 KB between 8-row groups).
//
// What differs between the kernels is where each chunk's A tile comes from
// (a 2-D map over rows, or for K6's 3x3 convs an im2col map over the
// (ROI, y, x, channel) activation, shifted by the tap) and the epilogue,
// which each kernel applies to `d` where it sits. Accumulator layout
// (m64nNk16, float32): d[4j + 2h + e] is row 16 * warp + lane / 4 + 8h of
// the warpgroup's 64, column 8j + 2 * (lane % 4) + e.

#pragma once

#include <cuda.h>

#include "roi_head_common.cuh"

namespace mrt {

constexpr int kGemmBM = 128;                   // rows per block
constexpr int kGemmBN = 256;                   // columns per block
constexpr int kGemmBK = 64;                    // K chunk: one 128-byte atom
constexpr int kGemmStages = 4;
constexpr int kGemmThreads = 288;              // 2 consumer WGs + 1 warp
constexpr int kGemmABytes = kGemmBM * kGemmBK * 2;   // 16 KB
constexpr int kGemmBAtom = kGemmBK * 64 * 2;         // 8 KB: 64 K-rows x 64
constexpr int kGemmBBytes = kGemmBK * kGemmBN * 2;   // 32 KB
constexpr int kGemmStageBytes = kGemmABytes + kGemmBBytes;
constexpr int kGemmConsumerWarps = 8;
constexpr size_t kGemmSmem =
    1024 + (size_t)kGemmStages * kGemmStageBytes + 16 * kGemmStages;

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

__device__ __forceinline__ void tma_load_2d(uint32_t dst,
                                            const CUtensorMap* map, int c0,
                                            int c1, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(bar)
      : "memory");
}

// im2col mode: the tensor map's pixel box walks output positions (W, then
// H, then N) from (n, h, w), each read at input pixel (h + off_h, w + off_w)
// with zeros outside the image; see tensor_map_im2col.
__device__ __forceinline__ void tma_load_im2col_4d(uint32_t dst,
                                                   const CUtensorMap* map,
                                                   int c, int w, int h, int n,
                                                   uint16_t off_w,
                                                   uint16_t off_h,
                                                   uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.im2col.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%2, %3, %4, %5}], [%6], {%7, %8};\n" ::
          "r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c), "r"(w), "r"(h), "r"(n),
      "r"(bar), "h"(off_w), "h"(off_h)
      : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Shared-memory matrix descriptor, 128-byte swizzle: start address,
// leading and stride byte offsets (16-byte units), layout type 1 (bits
// 62-63). K-major A: rows of 128 B, 8-row groups SBO = 1024 B apart, LBO
// unused (16). N-major B: 64-column atoms LBO = 8 KB apart, 8-row K groups
// SBO = 1024 B apart.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

// d (64 x 256 float32, this thread's 128) += A (64 x 16, K-major, from
// shared memory) * B (16 x 256, N-major, from shared memory): the
// warpgroup's m64n256k16, B transposed (imm-trans-b = 1).
__device__ __forceinline__ void wgmma_256(float (&d)[128], uint64_t da,
                                          uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, "
      "%104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p, 1, 1, 0, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
        "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
        "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
        "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]),
        "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(da), "l"(db), "r"(1));
}

// The ring in dynamic shared memory (aligned up to 1024 B for the swizzle).
struct GemmRing {
  uint32_t ring, full0, empty0;
};

// Call with every thread of the block; ends in __syncthreads().
__device__ __forceinline__ GemmRing gemm_ring_init(unsigned char* smem_raw) {
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~(uintptr_t)1023);
  GemmRing r;
  r.ring = smem_u32(smem);
  r.full0 = r.ring + kGemmStages * kGemmStageBytes;
  r.empty0 = r.full0 + 8 * kGemmStages;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kGemmStages; ++s) {
      mbar_init(r.full0 + 8 * s, 1);
      mbar_init(r.empty0 + 8 * s, kGemmConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  return r;
}

// The producer thread: for chunk j of `chunks`, load_a(dst, j, bar) brings
// the A tile, and B rows [(kb0 + j) * 64, +64) x columns [col0, col0 + 256)
// come from `tmap_b`.
template <class LoadA>
__device__ __forceinline__ void gemm_produce(const GemmRing& r, int chunks,
                                             LoadA load_a,
                                             const CUtensorMap* tmap_b,
                                             int kb0, int col0) {
  for (int j = 0; j < chunks; ++j) {
    const int st = j % kGemmStages, round = j / kGemmStages;
    if (round > 0) mbar_wait(r.empty0 + 8 * st, (round - 1) & 1);
    const uint32_t a_st = r.ring + st * kGemmStageBytes;
    const uint32_t full = r.full0 + 8 * st;
    const int kk = (kb0 + j) * kGemmBK;
    mbar_expect_tx(full, kGemmABytes + kGemmBBytes);
    load_a(a_st, j, full);
#pragma unroll
    for (int a = 0; a < kGemmBN / 64; ++a) {
      tma_load_2d(a_st + kGemmABytes + a * kGemmBAtom, tmap_b, col0 + 64 * a,
                  kk, full);
    }
  }
}

// A consumer warpgroup `wg`: d = rows wg*64 .. wg*64+63 of A @ B over the
// ring's `chunks` chunks; returns when every product has landed in d.
__device__ __forceinline__ void gemm_consume(const GemmRing& r, int chunks,
                                             int wg, float (&d)[128]) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int i = 0; i < 128; ++i) d[i] = 0.0f;
  for (int j = 0; j < chunks; ++j) {
    const int st = j % kGemmStages;
    mbar_wait(r.full0 + 8 * st, (j / kGemmStages) & 1);
    const uint32_t a_st = r.ring + st * kGemmStageBytes + wg * 64 * 128;
    const uint32_t b_st = r.ring + st * kGemmStageBytes + kGemmABytes;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kGemmBK / 16; ++kk) {
      wgmma_256(d, sw128_desc(a_st + kk * 32, 16, 1024),
                sw128_desc(b_st + kk * 2048, kGemmBAtom, 1024));
    }
    wgmma_commit();
    wgmma_wait<1>();
    if (j > 0 && lane == 0)
      mbar_arrive(r.empty0 + 8 * ((j - 1) % kGemmStages));
  }
  wgmma_wait<0>();
#pragma unroll
  for (int i = 0; i < 128; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType,
                                cuuint32_t, void*, const cuuint64_t*,
                                const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave,
                                CUtensorMapSwizzle, CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);
typedef CUresult (*EncodeIm2col)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const int*, const int*,
                                 cuuint32_t, cuuint32_t, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// A driver function through the runtime's entry point (no -lcuda at link
// time); nullptr if there is none.
inline void* driver_fn(const char* name) {
  void* p = nullptr;
  cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
  cudaError_t err = cudaGetDriverEntryPointByVersion(name, &p, 12000,
                                                     cudaEnableDefault, &q);
#else
  cudaError_t err = cudaGetDriverEntryPoint(name, &p, cudaEnableDefault, &q);
#endif
  return err == cudaSuccess && q == cudaDriverEntryPointSuccess ? p : nullptr;
}

// A row-major (outer, inner) bf16 matrix, read in 128-byte-swizzled boxes
// of (box_outer, 64); rows and columns outside it read as zero.
inline bool tensor_map_2d(CUtensorMap* map, const void* base, uint64_t inner,
                          uint64_t outer, uint32_t box_outer) {
  static EncodeTiled enc =
      reinterpret_cast<EncodeTiled>(driver_fn("cuTensorMapEncodeTiled"));
  if (enc == nullptr) return false;
  cuuint64_t dims[2] = {inner, outer};
  cuuint64_t strides[1] = {inner * sizeof(bf16)};
  cuuint32_t box[2] = {64, box_outer};
  cuuint32_t es[2] = {1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
             const_cast<void*>(base), dims, strides, box, es,
             CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// An NHWC bf16 activation (C, W, H, N innermost first) read as im2col rows
// for a 3x3 convolution with SAME padding: a load at (c, x0 - 1, y0 - 1,
// n0) with offsets (dx, dy) brings `pixels` consecutive output positions
// from (n0, y0, x0) on (x fastest, then y, then n, across images), each the
// 64 channels from c of input pixel (y + dy - 1, x + dx - 1), zero outside
// the image: the A tile of tap (dy, dx). The pixel box's lower and upper
// corners are -1 in W and H (lower = -padding, upper = padding - (filter -
// 1), as CUTLASS sets them), so a row's start positions are x - 1 = -1 ..
// 12 for output columns 0 .. 13.
inline bool tensor_map_im2col(CUtensorMap* map, const void* base,
                              const uint64_t* dims, uint32_t pixels) {
  static EncodeIm2col enc =
      reinterpret_cast<EncodeIm2col>(driver_fn("cuTensorMapEncodeIm2col"));
  if (enc == nullptr) return false;
  cuuint64_t gd[4], strides[3];
  cuuint32_t es[4] = {1, 1, 1, 1};
  uint64_t stride = sizeof(bf16);
  for (int i = 0; i < 4; ++i) {
    gd[i] = dims[i];
    if (i > 0) strides[i - 1] = stride;
    stride *= dims[i];
  }
  const int lower[2] = {-1, -1}, upper[2] = {-1, -1};
  if (enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base),
          gd, strides, lower, upper, 64, pixels, es,
          CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
          CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
          CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS) {
    return false;
  }
  // As CUTLASS does (cute/atom/copy_traits_sm90_im2col.hpp): drivers up to
  // 13.1 need bit 21 of the descriptor's second word cleared for an im2col
  // tensor under 128 KB.
  int driver = 0;
  if (cudaDriverGetVersion(&driver) != cudaSuccess) return false;
  if (driver <= 13010 && stride < 131072) {
    reinterpret_cast<uint64_t*>(map)[1] &= ~(1ull << 21);
  }
  return true;
}

}  // namespace mrt
