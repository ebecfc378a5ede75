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
//  * head_gemm_kernel: a block owns 128 rows x 256 columns, on the GEMM
//    tile K6 shares (head_gemm.cuh: TMA into a 4-stage mbarrier ring, one
//    producer thread, two consumer warpgroups on wgmma m64n128k16, each
//    64-deep chunk's product added to the float32 sum in FADDs).
//  * Dense 1 at M = 2000 has 16 x 4 = 64 output tiles; the wrapper splits
//    its 196 K chunks into groups (ops/roi_align_cuda.py::
//    classifier_head_plan: 2 at M = 2000, 128 blocks for 132 SMs). Each
//    group writes float32 partial sums; split_sum_kernel adds them in group
//    order (no atomics: the result does not depend on timing) and applies
//    b1, ReLU and the bf16 rounding. Dense 2 and 3 apply their epilogues
//    (bias, ReLU, bf16; bias only for the float32 output) on the
//    accumulator registers where they sit.
//  * One block per SM: 197,696 B of shared memory, 384 threads (a
//    producer warpgroup at 40 registers, two consumers at 232).
//  * ROIs past M read as zero rows (TMA fills rows out of bounds with 0);
//    invalid ROIs pool to zero rows. Both still run through the head (as
//    in the TPU kernel); the outputs have M rounded up to 128 rows and the
//    wrapper returns the first M.

#include "head_gemm.cuh"

extern "C" int mrt_roi_align(const void* f0, const void* f1, const void* f2,
                             const void* f3, int h0, int w0, int h1, int w1,
                             int h2, int w2, int h3, int w3, int c,
                             const void* ys, const void* xs,
                             const void* level, const void* valid, int m,
                             int rois_per_image, int p, int is_bf16,
                             void* out, void* stream);

namespace {

using namespace mrt;

constexpr int kBM = kGemmBM;
constexpr int kBN = kGemmBN;
constexpr int kBK = kGemmBK;

enum Mode { kPartial = 0, kDenseRelu = 1, kDenseOut = 2 };

// out = epilogue(A @ B) on one 128 x 256 tile. A (rows, k) and B (k, n)
// bf16 come by TMA. kPartial: K chunks [z * chunks / split, (z + 1) *
// chunks / split) of grid layer z, float32 sums to out[z] (split, mp, n).
template <int kMode>
__global__ void __launch_bounds__(kGemmThreads, 1)
head_gemm_kernel(const __grid_constant__ CUtensorMap tmap_a,
                 const __grid_constant__ CUtensorMap tmap_b, int k, int split,
                 int n, int mp, const float* __restrict__ bias,
                 void* __restrict__ out) {
  extern __shared__ unsigned char smem_raw[];
  const GemmRing ring = gemm_ring_init(smem_raw);
  const int row0 = blockIdx.x * kBM;
  const int col0 = blockIdx.y * kBN;
  const int chunks = k / kBK;
  const int c_lo = blockIdx.z * chunks / split;
  const int c_hi = (blockIdx.z + 1) * chunks / split;

  if (threadIdx.x >= 256) {
    // ---- producer: one thread keeps the ring full --------------------------
    gemm_producer_regs();
    if (threadIdx.x == 256) {
      gemm_produce(
          ring, c_hi - c_lo,
          [&](uint32_t dst, int j, uint32_t bar) {
            tma_load_2d(dst, &tmap_a, (c_lo + j) * kBK, row0, bar);
          },
          &tmap_b, c_lo, col0);
    }
  } else {
    // ---- consumer warpgroups: rows wg*64 .. wg*64+63 of the tile ----------
    gemm_consumer_regs();
    const int wg = threadIdx.x / 128;
    const int warp = (threadIdx.x / 32) & 3, lane = threadIdx.x & 31;
    float d[128];
    gemm_consume(ring, c_hi - c_lo, wg, d);

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

// out = epilogue(a @ w) for a (m, k) and w (k, n) bf16.
template <int kMode>
cudaError_t gemm(const void* a, int m, int k, const void* w, int n,
                 int split, const float* bias, void* out, cudaStream_t st) {
  CUtensorMap ta, tb;
  if (!tensor_map_2d(&ta, a, k, m, kBM) ||
      !tensor_map_2d(&tb, w, n, k, kBK))
    return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      head_gemm_kernel<kMode>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)kGemmSmem);
  if (err != cudaSuccess) return err;
  const int tiles = (m + kBM - 1) / kBM;
  head_gemm_kernel<kMode><<<dim3(tiles, n / kBN, split), kGemmThreads,
                            kGemmSmem, st>>>(ta, tb, k, split, n,
                                             tiles * kBM, bias, out);
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
