// Shared by K5 (roi_classifier_head.cu) and K6 (roi_mask_head.cu): the
// Hopper GEMM tile both heads run. A block owns 128 rows x 256 columns of
// the output. A producer warpgroup, one thread of which works, asks TMA
// for the A tile (128 x 64, K-major) and the B tile (64 x 256 of a
// row-major (K, N) weight, as four 64 x 64 boxes: wgmma's transposed-B
// mode reads it as it is) of each K chunk of 64, both 128-byte swizzled,
// into a 4-stage ring (48 KB a stage). A full barrier per stage counts the
// TMA bytes; an empty barrier counts the eight consumer warps that are
// done with it. Two consumer warpgroups each hold a 64 x 256 float32 sum
// `d` (descriptors step 32 B per k16 in A, 2 KB in B; LBO 8 KB between B's
// 64-column atoms, SBO 1 KB between 8-row groups).
//
// Each chunk's product goes, one 128-column half at a time, to a fresh
// 64 x 128 accumulator `t` (four wgmma m64n128k16, the first with scale-d
// 0) and joins d in FADDs, which round to nearest, as the plain version's
// float32 sums do. The tensor core's own accumulation (d += A * B) rounds
// its result toward zero: over K5's 784 k16 steps (dense 1, 12544 deep)
// and K6's 144 (each 3x3 conv) into d, that is the error PERF.md
// measures. Inside t it rounds a 64-deep partial sum, whose ulp is a
// small part of d's, three times. Adding each k16 step to d on its own
// instead left d's round-to-nearest chain 4x longer and its error about
// twice this one's, no smaller than cuBLAS's float32 sums at 200 ROIs
// (PERF.md). The halves run one after another in a warpgroup (t is read
// before the next product lands in it); the other consumer warpgroup's
// products fill the gaps. d and t hold 192 registers a thread: the
// producer warpgroup gives its registers up (setmaxnreg 24) so that each
// consumer may hold 240 (with one producer warp, 288 threads of 224
// registers, ptxas spilled 2.3-2.6 KB a kernel).
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
constexpr int kGemmThreads = 384;              // 2 consumer WGs + producer
constexpr int kGemmProducerRegs = 24;          // setmaxnreg: 128 x 24 +
constexpr int kGemmConsumerRegs = 240;         // 256 x 240 = 384 x 168
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

// t (64 x 128 float32, this thread's 64) = A (64 x 16, K-major, from
// shared memory) * B (16 x 128, N-major, from shared memory) + (acc ? t :
// 0): the warpgroup's m64n128k16, B transposed (imm-trans-b = 1), scale-d
// acc.
__device__ __forceinline__ void wgmma_128(float (&t)[64], uint64_t da,
                                          uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 1;\n}\n"
      :
        "+f"(t[0]), "+f"(t[1]), "+f"(t[2]), "+f"(t[3]),
        "+f"(t[4]), "+f"(t[5]), "+f"(t[6]), "+f"(t[7]),
        "+f"(t[8]), "+f"(t[9]), "+f"(t[10]), "+f"(t[11]),
        "+f"(t[12]), "+f"(t[13]), "+f"(t[14]), "+f"(t[15]),
        "+f"(t[16]), "+f"(t[17]), "+f"(t[18]), "+f"(t[19]),
        "+f"(t[20]), "+f"(t[21]), "+f"(t[22]), "+f"(t[23]),
        "+f"(t[24]), "+f"(t[25]), "+f"(t[26]), "+f"(t[27]),
        "+f"(t[28]), "+f"(t[29]), "+f"(t[30]), "+f"(t[31]),
        "+f"(t[32]), "+f"(t[33]), "+f"(t[34]), "+f"(t[35]),
        "+f"(t[36]), "+f"(t[37]), "+f"(t[38]), "+f"(t[39]),
        "+f"(t[40]), "+f"(t[41]), "+f"(t[42]), "+f"(t[43]),
        "+f"(t[44]), "+f"(t[45]), "+f"(t[46]), "+f"(t[47]),
        "+f"(t[48]), "+f"(t[49]), "+f"(t[50]), "+f"(t[51]),
        "+f"(t[52]), "+f"(t[53]), "+f"(t[54]), "+f"(t[55]),
        "+f"(t[56]), "+f"(t[57]), "+f"(t[58]), "+f"(t[59]),
        "+f"(t[60]), "+f"(t[61]), "+f"(t[62]), "+f"(t[63])
      : "l"(da), "l"(db), "r"(acc));
}

// setmaxnreg: call with every thread of the producer warpgroup (threads
// 256-383), and of the consumer warpgroups (0-255), before anything else
// they do after gemm_ring_init.
__device__ __forceinline__ void gemm_producer_regs() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(
      kGemmProducerRegs));
}

__device__ __forceinline__ void gemm_consumer_regs() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(
      kGemmConsumerRegs));
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
// ring's `chunks` chunks, each chunk's product added to d in FADDs;
// returns when every product has landed in d.
__device__ __forceinline__ void gemm_consume(const GemmRing& r, int chunks,
                                             int wg, float (&d)[128]) {
  const int lane = threadIdx.x & 31;
  float t[64];
#pragma unroll
  for (int i = 0; i < 128; ++i) d[i] = 0.0f;
  for (int j = 0; j < chunks; ++j) {
    const int st = j % kGemmStages;
    mbar_wait(r.full0 + 8 * st, (j / kGemmStages) & 1);
    const uint32_t a_st = r.ring + st * kGemmStageBytes + wg * 64 * 128;
    const uint32_t b_st = r.ring + st * kGemmStageBytes + kGemmABytes;
    // a k16 step moves A's start 32 B and B's 2 KB: 2 and 128 in the
    // descriptors' 16-byte address field
    const uint64_t da = sw128_desc(a_st, 16, 1024);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const uint64_t db =
          sw128_desc(b_st + 2 * h * kGemmBAtom, kGemmBAtom, 1024);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kGemmBK / 16; ++kk) {
        wgmma_128(t, da + 2 * kk, db + 128 * kk, kk > 0);
      }
      wgmma_commit();
      wgmma_wait<0>();
      // the chunk's sum joins the running one in round-to-nearest adds
#pragma unroll
      for (int i = 0; i < 64; ++i) {
        asm volatile("" : "+f"(t[i])::"memory");
        d[64 * h + i] += t[i];
      }
    }
    // every product of this stage has landed: the producer may refill it
    if (lane == 0) mbar_arrive(r.empty0 + 8 * st);
  }
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
