// K6: pool-14 ROIAlign with the whole mask head behind it. Per ROI: the
// 14x14x256 pool (K2's sampling, rounded to bf16); four times
// a = bf16(relu(conv3x3_SAME(a) @ Wk + bk)) with zeros outside the 14x14;
// z = relu(a @ Wdec[ab] + bdec) in float32 for the four deconv output
// parities ab = 2a + b; logit = sum_c z[c] * bf16(kcls[class])[c] +
// bcls[class]; mask[2y + a][2x + b] = sigmoid(logit). BN is folded into W
// and b by the caller (ops/roi_align_cuda.py::pack_mask_head), and the
// kernels read the packed (9C, C) and (C, 4C) weights as they are.
//
// Replaces: maskrcnn_tpu/ops/roi_align_pallas.py::pyramid_roi_align_pallas
// with mask_params + class_ids (pallas_call :716, mask body _kernel
// :504-552, packing pack_mask_head :134).
//
// What bounds it on an H100: operations. 4 * 196 * 2304 * 256 * 2 +
// 196 * 256 * 1024 * 2 = 1.03 GFLOP per ROI (206 GFLOP at 200 ROIs)
// against ~5.2 MB of weights. To get near the tensor cores' rate, the
// products must run on wgmma fed from shared memory, and each weight byte
// must leave L2 a few times per call, not per ROI.
//
// Design: layer by layer over all ROIs on K5's GEMM tile (head_gemm.cuh),
// six launches:
//  * The pool: roi_align.cu's kernel (K2, through mrt_roi_align) writes the
//    (M, 14, 14, 256) bf16 activation once (20 MB at M = 200, held in L2).
//  * mask_conv_kernel, four times, ping-ponging between two such buffers:
//    an implicit GEMM over the M x 196 output positions taken in order, 128
//    to a tile (307 tiles at M = 200, 2.3 waves on 132 SMs; tiles cross
//    ROI boundaries), N = 256, K = 9 taps x 256 channels in 36 chunks of
//    64. The A chunk of tap (dy, dx) and channels [c0, c0 + 64) is one TMA
//    load in im2col mode (head_gemm.cuh::tensor_map_im2col): 128 positions
//    from the tile's first, each read at its neighbour (y + dy - 1,
//    x + dx - 1) in its own ROI, zero outside the 14x14, which is the SAME
//    border. There is no padded copy, no per-lane predicate and no padded
//    row. The B chunk is 64 rows of the packed (2304, 256) layer matrix.
//    Epilogue: + b, ReLU, bf16, stored from the accumulator registers.
//  * mask_deconv_kernel: the same tiles, A read as rows of the (M x 196,
//    256) activation, against the (256, 1024) deconv matrix, one
//    256-column tile per output parity ab (grid y), so a block holds all
//    256 channels of one parity. Epilogue: z = relu(acc + bdec), its dot
//    product with its ROI's class row (each lane's 64 columns, then across
//    the 4 lanes of a quad that share a row), + bcls, sigmoid, one float
//    per (position, parity) into the (M, 28, 28) mask. The (M, 196, 1024)
//    z never reaches memory.
//  * The weights (1.2 MB a conv layer) stay in L2; each block reads them
//    once.

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

constexpr int kC = 256;                      // channels
constexpr int kP = 14;                       // pool
constexpr int kPos = kP * kP;                // positions per ROI
constexpr int kCChunks = kC / kGemmBK;       // 4 channel chunks per tap
constexpr int kConvChunks = 9 * kCChunks;    // 36 K chunks per conv

static_assert(kC == kGemmBN, "one column block holds every channel");

// out = bf16(relu(conv3x3_SAME(in) @ w + b)) for output positions
// [p0, p0 + 128) of the M x 14 x 14 grid (rows past `rows` dropped).
__global__ void __launch_bounds__(kGemmThreads, 1)
mask_conv_kernel(const __grid_constant__ CUtensorMap tmap_in,
                 const __grid_constant__ CUtensorMap tmap_w, int rows,
                 int chunks, const float* __restrict__ bias,
                 bf16* __restrict__ out) {
  extern __shared__ unsigned char smem_raw[];
  const GemmRing ring = gemm_ring_init(smem_raw);
  const int p0 = blockIdx.x * kGemmBM;

  if (threadIdx.x >= 256) {
    gemm_producer_regs();
    if (threadIdx.x == 256) {
      const int n0 = p0 / kPos, y0 = p0 % kPos / kP, x0 = p0 % kP;
      gemm_produce(
          ring, chunks,
          [&](uint32_t dst, int j, uint32_t bar) {
            const int tap = j / kCChunks, c0 = (j % kCChunks) * kGemmBK;
            tma_load_im2col_4d(dst, &tmap_in, c0, x0 - 1, y0 - 1, n0,
                               (uint16_t)(tap % 3), (uint16_t)(tap / 3), bar);
          },
          &tmap_w, 0, 0);
    }
    return;
  }
  gemm_consumer_regs();
  const int wg = threadIdx.x / 128;
  const int warp = (threadIdx.x / 32) & 3, lane = threadIdx.x & 31;
  float d[128];
  gemm_consume(ring, chunks, wg, d);

  const int r0 = p0 + wg * 64 + warp * 16 + (lane >> 2);
#pragma unroll
  for (int jn = 0; jn < kC / 8; ++jn) {
    const int col = jn * 8 + 2 * (lane & 3);
    const float b0 = __ldg(bias + col), b1 = __ldg(bias + col + 1);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = r0 + 8 * h;
      if (r < rows) {
        *reinterpret_cast<uint32_t*>(out + (size_t)r * kC + col) =
            pack_bf16(fmaxf(d[4 * jn + 2 * h] + b0, 0.0f),
                      fmaxf(d[4 * jn + 2 * h + 1] + b1, 0.0f));
      }
    }
  }
}

// For output positions [p0, p0 + 128) and parity ab: out[roi][2y + a][2x +
// b] = sigmoid(relu(in @ wdec[:, ab] + bdec) . bf16(kcls[class]) +
// bcls[class]).
__global__ void __launch_bounds__(kGemmThreads, 1)
mask_deconv_kernel(const __grid_constant__ CUtensorMap tmap_in,
                   const __grid_constant__ CUtensorMap tmap_w, int rows,
                   int chunks, const float* __restrict__ bdec,
                   const float* __restrict__ kcls,
                   const float* __restrict__ bcls,
                   const int* __restrict__ class_ids, int num_classes,
                   float* __restrict__ out) {
  extern __shared__ unsigned char smem_raw[];
  const GemmRing ring = gemm_ring_init(smem_raw);
  const int p0 = blockIdx.x * kGemmBM;
  const int ab = blockIdx.y;

  if (threadIdx.x >= 256) {
    gemm_producer_regs();
    if (threadIdx.x == 256) {
      gemm_produce(
          ring, chunks,
          [&](uint32_t dst, int j, uint32_t bar) {
            tma_load_2d(dst, &tmap_in, j * kGemmBK, p0, bar);
          },
          &tmap_w, 0, ab * kC);
    }
    return;
  }
  gemm_consumer_regs();
  const int wg = threadIdx.x / 128;
  const int warp = (threadIdx.x / 32) & 3, lane = threadIdx.x & 31;
  float d[128];
  gemm_consume(ring, chunks, wg, d);

  // This thread's two rows, their ROIs and class rows.
  const int r0 = p0 + wg * 64 + warp * 16 + (lane >> 2);
  int roi[2], cls[2];
  const float* wrow[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    roi[h] = min(r0 + 8 * h, rows - 1) / kPos;
    cls[h] = min(max(class_ids[roi[h]], 0), num_classes - 1);
    wrow[h] = kcls + (size_t)cls[h] * kC;
  }
  const float* brow = bdec + ab * kC;
  float s[2] = {0.0f, 0.0f};
#pragma unroll
  for (int jn = 0; jn < kC / 8; ++jn) {
    const int ch = jn * 8 + 2 * (lane & 3);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      // float2 loads: with one load a float, the loads the compiler hoists
      // beside d spilled 16 B (PERF.md)
      const float2 c = __ldg(reinterpret_cast<const float2*>(brow + ch));
      const float2 w = __ldg(reinterpret_cast<const float2*>(wrow[h] + ch));
      const float w0 = __bfloat162float(__float2bfloat16_rn(w.x));
      const float w1 = __bfloat162float(__float2bfloat16_rn(w.y));
      const float c0 = c.x, c1 = c.y;
      s[h] += fmaxf(d[4 * jn + 2 * h] + c0, 0.0f) * w0 +
              fmaxf(d[4 * jn + 2 * h + 1] + c1, 0.0f) * w1;
    }
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float v = s[h];
    v += __shfl_xor_sync(0xffffffffu, v, 1);
    v += __shfl_xor_sync(0xffffffffu, v, 2);
    const int r = r0 + 8 * h;
    if ((lane & 3) == 0 && r < rows) {
      const int pos = r % kPos, y = pos / kP, x = pos % kP;
      out[(size_t)roi[h] * 4 * kPos + (2 * y + ab / 2) * 2 * kP + 2 * x +
          ab % 2] = 1.0f / (1.0f + expf(-(v + __ldg(bcls + cls[h]))));
    }
  }
}

}  // namespace

extern "C" {

// f0..f3: (B, H_l, W_l, 256) bf16 levels; ys/xs (M, 14) f32; level (M,)
// int32; valid (M,) bool; wconv (4, 2304, 256) and wdec (256, 1024) bf16
// as packed (K, N); bconv (4, 256), bdec (1024,), kcls (nc, 256), bcls
// (nc,) f32; class_ids (M,) int32. The launch plan
// (ops/roi_align_cuda.py::mask_head_plan): `tiles` blocks of 128 positions
// a layer (x 4 parities for the deconv), `conv_chunks` and `dec_chunks` K
// chunks of 64; a plan that does not cover the M x 196 positions once or
// does not match the weights' K is refused. Scratch: act0, act1 (M, 14, 14,
// 256) bf16. out (M, 28, 28) f32.
int mrt_roi_mask_head(const void* f0, const void* f1, const void* f2,
                      const void* f3, int h0, int w0, int h1, int w1, int h2,
                      int w2, int h3, int w3, int c, const void* ys,
                      const void* xs, const void* level, const void* valid,
                      int m, int rois_per_image, int p, const void* wconv,
                      const void* bconv, const void* wdec, const void* bdec,
                      const void* kcls, const void* bcls,
                      const void* class_ids, int num_classes, int tiles,
                      int conv_chunks, int dec_chunks, void* act0,
                      void* act1, void* out, void* stream) {
  if (m == 0) return 0;
  const int rows = m * kPos;
  if (c != kC || p != kP || rois_per_image <= 0 || num_classes <= 0 ||
      tiles <= 0 || (int64_t)tiles * kGemmBM < rows ||
      (int64_t)(tiles - 1) * kGemmBM >= rows || conv_chunks != kConvChunks ||
      dec_chunks != kCChunks) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t st = (cudaStream_t)stream;
  int rc = mrt_roi_align(f0, f1, f2, f3, h0, w0, h1, w1, h2, w2, h3, w3, c,
                         ys, xs, level, valid, m, rois_per_image, p, 1, act0,
                         stream);
  if (rc != 0) return rc;

  const uint64_t dims[4] = {kC, kP, kP, (uint64_t)m};
  CUtensorMap t_act[2], t_conv[4], t_rows, t_dec;
  bool ok = tensor_map_im2col(&t_act[0], act0, dims, kGemmBM) &&
            tensor_map_im2col(&t_act[1], act1, dims, kGemmBM) &&
            tensor_map_2d(&t_rows, act0, kC, rows, kGemmBM) &&
            tensor_map_2d(&t_dec, wdec, 4 * kC, kC, kGemmBK);
  for (int l = 0; l < 4; ++l) {
    ok = ok && tensor_map_2d(&t_conv[l],
                             (const bf16*)wconv + (size_t)l * 9 * kC * kC, kC,
                             9 * kC, kGemmBK);
  }
  if (!ok) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      mask_conv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)kGemmSmem);
  if (err == cudaSuccess) {
    err = cudaFuncSetAttribute(mask_deconv_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)kGemmSmem);
  }
  if (err != cudaSuccess) return (int)err;

  bf16* act[2] = {(bf16*)act0, (bf16*)act1};
  for (int l = 0; l < 4; ++l) {
    mask_conv_kernel<<<tiles, kGemmThreads, kGemmSmem, st>>>(
        t_act[l % 2], t_conv[l], rows, conv_chunks,
        (const float*)bconv + l * kC, act[(l + 1) % 2]);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  mask_deconv_kernel<<<dim3(tiles, 4), kGemmThreads, kGemmSmem, st>>>(
      t_rows, t_dec, rows, dec_chunks, (const float*)bdec,
      (const float*)kcls, (const float*)bcls, (const int*)class_ids,
      num_classes, (float*)out);
  return (int)cudaGetLastError();
}

}  // extern "C"
