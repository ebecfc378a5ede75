// K5: pool-7 ROIAlign with the whole classifier head behind it. Per ROI:
// the 7x7xC pool (K2's sampling, rounded to bf16), flattened NHWC
// row-major to 49*C values, h1 = bf16(relu(row @ W1 + b1)),
// h2 = bf16(relu(h1 @ W2 + b2)), out = h2 @ W3 + b3 in float32 (512 packed
// lanes: logits, then box deltas from lane 128). BN is folded into W and b
// by the caller (ops/roi_align_cuda.py::pack_classifier_head), and the
// kernels read the packed (K, N) weights as they are.
//
// Replaces: maskrcnn_tpu/ops/roi_align_pallas.py::pyramid_roi_align_pallas
// with head_params (pallas_call :716, head body _kernel :474-502, packing
// pack_classifier_head :84).
//
// What bounds it on an H100: operations. 2 * M * (12544*1024 + 1024^2 +
// 1024*512) = 57.7 GFLOP at M = 2000 ROIs (batch 2) against ~29 MB of
// weights, far above the ~295 flops/byte where the tensor cores limit. To
// get near that, the tensor cores must be fed from shared memory by wgmma,
// and each weight byte must come from L2 once per block, not once per warp.
//
// Design: pool once, then three TMA-fed wgmma products (five launches).
//  * The pool: roi_align.cu's kernel (K2, through mrt_roi_align) writes the
//    (M, 49*C) bf16 tile once, 50 MB at M = 2000. The first design pooled
//    inside the dense-1 kernel, in a producer warpgroup, straight into
//    shared memory, and the gathers bound it (PERF.md, PR 3): each of the
//    4 column blocks of a row tile sampled the same ROIs again, with 4
//    warps per SM to hide their L2 latency.
//  * head_gemm_kernel: a block owns 128 rows x 256 columns. Two consumer
//    warpgroups each hold a 64 x 256 float32 accumulator fed by wgmma
//    m64n256k16 (A K-major, B N-major, both 128-byte swizzled in shared
//    memory); one producer warp's first thread asks TMA for the A tile
//    (128 x 64) and the B tile (64 x 256, four 64 x 64 boxes) of each K
//    chunk of 64, through a 4-stage ring (48 KB a stage). A full barrier
//    per stage counts the TMA bytes; an empty barrier counts the eight
//    consumer warps that are done with it.
//  * Dense 1 at M = 2000 has 16 x 4 = 64 output tiles; the wrapper splits
//    its 196 K chunks into groups (ops/roi_align_cuda.py::
//    classifier_head_plan: 2 at M = 2000, 128 blocks for 132 SMs). Each
//    group writes float32 partial sums; split_sum_kernel adds them in group
//    order (no atomics: the result does not depend on timing) and applies
//    b1, ReLU and the bf16 rounding. Dense 2 and 3 apply their epilogues
//    (bias, ReLU, bf16; bias only for the float32 output) on the
//    accumulator registers where they sit.
//  * One block per SM: 197,632 B of shared memory, 288 threads.
//  * ROIs past M read as zero rows (TMA fills rows out of bounds with 0);
//    invalid ROIs pool to zero rows. Both still run through the head (as
//    in the TPU kernel); the outputs have M rounded up to 128 rows and the
//    wrapper returns the first M.

#include <cuda.h>

#include "roi_head_common.cuh"

extern "C" int mrt_roi_align(const void* f0, const void* f1, const void* f2,
                             const void* f3, int h0, int w0, int h1, int w1,
                             int h2, int w2, int h3, int w3, int c,
                             const void* ys, const void* xs,
                             const void* level, const void* valid, int m,
                             int rois_per_image, int p, int is_bf16,
                             void* out, void* stream);

namespace {

using namespace mrt;

constexpr int kBM = 128;                       // rows per block
constexpr int kBN = 256;                       // columns per block
constexpr int kBK = 64;                        // K chunk: one 128-byte atom
constexpr int kStages = 4;
constexpr int kThreads = 288;                  // 2 consumer WGs + 1 warp
constexpr int kABytes = kBM * kBK * 2;         // 16 KB
constexpr int kBAtom = kBK * 64 * 2;           // 8 KB: 64 K-rows x 64 cols
constexpr int kBBytes = kBK * kBN * 2;         // 32 KB
constexpr int kStageBytes = kABytes + kBBytes;
constexpr int kConsumerWarps = 8;
constexpr size_t kSmem = 1024 + (size_t)kStages * kStageBytes + 16 * kStages;

enum Mode { kPartial = 0, kDenseRelu = 1, kDenseOut = 2 };

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

// out = epilogue(A @ B) on one 128 x 256 tile. A (rows, k) and B (k, n)
// bf16 come by TMA. kPartial: K chunks [z * chunks / split, (z + 1) *
// chunks / split) of grid layer z, float32 sums to out[z] (split, mp, n).
template <int kMode>
__global__ void __launch_bounds__(kThreads, 1)
head_gemm_kernel(const __grid_constant__ CUtensorMap tmap_a,
                 const __grid_constant__ CUtensorMap tmap_b, int k, int split,
                 int n, int mp, const float* __restrict__ bias,
                 void* __restrict__ out) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~(uintptr_t)1023);
  const uint32_t ring = smem_u32(smem);
  const uint32_t full0 = ring + kStages * kStageBytes;
  const uint32_t empty0 = full0 + 8 * kStages;

  const int row0 = blockIdx.x * kBM;
  const int col0 = blockIdx.y * kBN;
  const int chunks = k / kBK;
  const int c_lo = blockIdx.z * chunks / split;
  const int c_hi = (blockIdx.z + 1) * chunks / split;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= 256) {
    // ---- producer: one thread keeps the ring full --------------------------
    if (threadIdx.x == 256) {
      for (int j = 0; j < c_hi - c_lo; ++j) {
        const int st = j % kStages, round = j / kStages;
        if (round > 0) mbar_wait(empty0 + 8 * st, (round - 1) & 1);
        const uint32_t a_st = ring + st * kStageBytes;
        const uint32_t full = full0 + 8 * st;
        const int kk = (c_lo + j) * kBK;
        mbar_expect_tx(full, kABytes + kBBytes);
        tma_load_2d(a_st, &tmap_a, kk, row0, full);
#pragma unroll
        for (int a = 0; a < kBN / 64; ++a) {
          tma_load_2d(a_st + kABytes + a * kBAtom, &tmap_b, col0 + 64 * a, kk,
                      full);
        }
      }
    }
  } else {
    // ---- consumer warpgroups: rows wg*64 .. wg*64+63 of the tile ----------
    const int wg = threadIdx.x / 128;
    const int warp = (threadIdx.x / 32) & 3, lane = threadIdx.x & 31;
    float d[128];
#pragma unroll
    for (int i = 0; i < 128; ++i) d[i] = 0.0f;
    for (int j = 0; j < c_hi - c_lo; ++j) {
      const int st = j % kStages;
      mbar_wait(full0 + 8 * st, (j / kStages) & 1);
      const uint32_t a_st = ring + st * kStageBytes + wg * 64 * 128;
      const uint32_t b_st = ring + st * kStageBytes + kABytes;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk) {
        wgmma_256(d, sw128_desc(a_st + kk * 32, 16, 1024),
                  sw128_desc(b_st + kk * 2048, kBAtom, 1024));
      }
      wgmma_commit();
      wgmma_wait<1>();
      if (j > 0 && lane == 0) mbar_arrive(empty0 + 8 * ((j - 1) % kStages));
    }
    wgmma_wait<0>();
#pragma unroll
    for (int i = 0; i < 128; ++i) asm volatile("" : "+f"(d[i])::"memory");

    // Accumulator layout (m64nNk16, float32): d[4j + 2h + e] is row
    // 16 * warp + lane / 4 + 8h, column 8j + 2 * (lane % 4) + e.
    const int r_lo = row0 + wg * 64 + warp * 16 + (lane >> 2);
#pragma unroll
    for (int jn = 0; jn < kBN / 8; ++jn) {
      const int col = col0 + jn * 8 + 2 * (lane & 3);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const size_t r = r_lo + 8 * h;
        const float v0 = d[4 * jn + 2 * h], v1 = d[4 * jn + 2 * h + 1];
        if (kMode == kPartial) {
          float* part = reinterpret_cast<float*>(out);
          *reinterpret_cast<float2*>(
              part + ((size_t)blockIdx.z * mp + r) * n + col) =
              make_float2(v0, v1);
        } else if (kMode == kDenseRelu) {
          bf16* o = reinterpret_cast<bf16*>(out);
          *reinterpret_cast<uint32_t*>(o + r * n + col) =
              pack_bf16(fmaxf(v0 + __ldg(bias + col), 0.0f),
                        fmaxf(v1 + __ldg(bias + col + 1), 0.0f));
        } else {
          float* o = reinterpret_cast<float*>(out);
          *reinterpret_cast<float2*>(o + r * n + col) =
              make_float2(v0 + __ldg(bias + col), v1 + __ldg(bias + col + 1));
        }
      }
    }
  }
}

// h1 = bf16(relu((part[0] + part[1] + ...) + b1)), groups added in order.
__global__ void split_sum_kernel(const float* __restrict__ part, int split,
                                 size_t count, int n,
                                 const float* __restrict__ b1,
                                 bf16* __restrict__ h1) {
  const size_t i = ((size_t)blockIdx.x * blockDim.x + threadIdx.x) * 4;
  if (i >= count) return;
  float4 s = *reinterpret_cast<const float4*>(part + i);
  for (int g = 1; g < split; ++g) {
    const float4 q = *reinterpret_cast<const float4*>(part + g * count + i);
    s.x += q.x;
    s.y += q.y;
    s.z += q.z;
    s.w += q.w;
  }
  const int col = (int)(i % n);
  uint2 v;
  v.x = pack_bf16(fmaxf(s.x + b1[col], 0.0f), fmaxf(s.y + b1[col + 1], 0.0f));
  v.y = pack_bf16(fmaxf(s.z + b1[col + 2], 0.0f),
                  fmaxf(s.w + b1[col + 3], 0.0f));
  *reinterpret_cast<uint2*>(h1 + i) = v;
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType,
                                cuuint32_t, void*, const cuuint64_t*,
                                const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave,
                                CUtensorMapSwizzle, CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                              cudaEnableDefault, &q);
#endif
    if (err == cudaSuccess && q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A row-major (outer, inner) bf16 matrix, read in 128-byte-swizzled boxes
// of (box_outer, 64); rows past `outer` read as zero.
bool tensor_map(CUtensorMap* map, const void* base, uint64_t inner,
                uint64_t outer, uint32_t box_outer) {
  EncodeTiled enc = encoder();
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

// out = epilogue(a @ w) for a (m, k) and w (k, n) bf16.
template <int kMode>
cudaError_t gemm(const void* a, int m, int k, const void* w, int n,
                 int split, const float* bias, void* out, cudaStream_t st) {
  CUtensorMap ta, tb;
  if (!tensor_map(&ta, a, k, m, kBM) || !tensor_map(&tb, w, n, k, kBK))
    return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      head_gemm_kernel<kMode>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)kSmem);
  if (err != cudaSuccess) return err;
  const int tiles = (m + kBM - 1) / kBM;
  head_gemm_kernel<kMode><<<dim3(tiles, n / kBN, split), kThreads, kSmem,
                            st>>>(ta, tb, k, split, n, tiles * kBM, bias,
                                  out);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// f0..f3: (B, H_l, W_l, C) bf16 levels; ys/xs (M, P) f32; level (M,)
// int32; valid (M,) bool; w1 (P*P*C, N1), w2 (N1, N2), w3 (N2, N3) bf16 as
// packed (K, N); b1, b2, b3 f32; split: K groups of dense 1. Scratch:
// pooled (M, P*P*C) bf16, part (split, Mp, N1) f32, h1 (Mp, N1) and h2
// (Mp, N2) bf16; out (Mp, N3) f32; Mp = M rounded up to 128.
int mrt_roi_classifier_head(
    const void* f0, const void* f1, const void* f2, const void* f3, int fh0,
    int fw0, int fh1, int fw1, int fh2, int fw2, int fh3, int fw3, int c,
    const void* ys, const void* xs, const void* level, const void* valid,
    int m, int rois_per_image, int p, const void* w1, const void* b1, int n1,
    const void* w2, const void* b2, int n2, const void* w3, const void* b3,
    int n3, int split, void* pooled, void* part, void* h1, void* h2,
    void* out, void* stream) {
  if (m == 0) return 0;
  const int k1 = p * p * c;
  if (k1 % kBK || n1 % kBN || n2 % kBN || n3 % kBN || split < 1 ||
      split > k1 / kBK) {
    return (int)cudaErrorInvalidValue;
  }
  const int mp = (m + kBM - 1) / kBM * kBM;
  cudaStream_t st = (cudaStream_t)stream;
  int rc = mrt_roi_align(f0, f1, f2, f3, fh0, fw0, fh1, fw1, fh2, fw2, fh3,
                         fw3, c, ys, xs, level, valid, m, rois_per_image, p,
                         1, pooled, stream);
  if (rc != 0) return rc;
  cudaError_t err = gemm<kPartial>(pooled, m, k1, w1, n1, split, nullptr,
                                   part, st);
  if (err != cudaSuccess) return (int)err;
  const size_t count = (size_t)mp * n1;
  split_sum_kernel<<<(unsigned)((count / 4 + 255) / 256), 256, 0, st>>>(
      (const float*)part, split, count, n1, (const float*)b1, (bf16*)h1);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  err = gemm<kDenseRelu>(h1, mp, n1, w2, n2, 1, (const float*)b2, h2, st);
  if (err != cudaSuccess) return (int)err;
  return (int)gemm<kDenseOut>(h2, mp, n2, w3, n3, 1, (const float*)b3, out,
                              st);
}

}  // extern "C"
