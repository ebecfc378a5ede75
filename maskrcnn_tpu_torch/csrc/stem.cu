// K3: fused ResNet stem. conv1 7x7/2 (zero pad 3) with inference BN folded
// into bf16 weights and a float32 bias, ReLU, then the 3x3/2 TF-SAME
// max-pool (pad 0 left, 1 right). Only the pooled (B, H/4, W/4, 64) bf16
// map is written; the (B, H/2, W/2, 64) conv map never reaches memory.
//
// Replaces: maskrcnn_tpu/ops/stem_pallas.py::stem_pallas (pallas_call :197,
// kernel _stem_kernel :113, via apply_stem_pallas :230). The TPU kernel's
// 4x4 space-to-depth packing (stem_pallas.py:11-15) is a Mosaic lane-layout
// device and is not carried over.
//
// What bounds it on an H100: by the roofline, bytes (the f32 image in and
// the pooled map out, 21 MB per 1024^2 image, against 4.9 GFLOP). This
// first version computes the conv on the float32 CUDA cores (3 input
// channels give a 147-deep contraction that a tensor-core tile would pad
// badly), so in practice it is bound by float32 FMA issue plus the
// one-row/one-column pool halo it recomputes (17x17 conv positions per
// 8x8 pooled tile: 1.13x).
//
// Design: one block per 8x8 tile of pooled outputs. The block stages the
// 39x39x3 input patch (rounded to bf16, as the plain version rounds it) and
// the folded weights in shared memory, computes the 17x17x64 conv tile
// (thread = output channel x row group, 17 column accumulators in
// registers; a warp reads each input value as one broadcast), applies bias
// and ReLU, zeroes conv positions past the image (post-ReLU values are >= 0,
// so a zero never beats the window max: the SAME pool's -inf padding), and
// keeps the tile in shared memory as bf16. Rounding is monotone, so pooling
// the rounded values equals rounding the pooled float32 value. Each thread
// then pools its channel over its share of the 8x8 outputs and writes them
// with 64 consecutive channels per pixel (128 B coalesced).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 8;                  // pooled outputs per tile side
constexpr int kConv = 2 * kTile + 1;      // conv positions per side (17)
constexpr int kIn = 2 * (kConv - 1) + 7;  // input patch side (39)
constexpr int kCo = 64;
constexpr int kTaps = 7 * 7 * 3;
constexpr int kThreads = 256;
constexpr int kGroups = kThreads / kCo;   // row groups (4)

constexpr size_t kSmem = sizeof(float) * (kIn * kIn * 3 + kTaps * kCo) +
                         sizeof(__nv_bfloat16) * kConv * kConv * kCo;

__global__ void __launch_bounds__(kThreads)
stem_kernel(const float* __restrict__ img, const __nv_bfloat16* __restrict__ w,
            const float* __restrict__ bias, __nv_bfloat16* __restrict__ out,
            int h, int wd) {
  extern __shared__ float smem[];
  float* in_s = smem;                       // [kIn][kIn][3]
  float* w_s = in_s + kIn * kIn * 3;        // [kTaps][kCo]
  __nv_bfloat16* conv_s =
      reinterpret_cast<__nv_bfloat16*>(w_s + kTaps * kCo);  // [17][17][64]

  const int b = blockIdx.z;
  const int pr0 = blockIdx.y * kTile, pc0 = blockIdx.x * kTile;
  const int hc = h / 2, wc = wd / 2;        // conv grid
  const int ho = h / 4, wo = wd / 4;        // pooled grid
  const int tid = threadIdx.x;

  const int iy0 = 4 * pr0 - 3, ix0 = 4 * pc0 - 3;
  const float* im = img + (size_t)b * h * wd * 3;
  for (int i = tid; i < kIn * kIn * 3; i += kThreads) {
    const int c = i % 3, px = (i / 3) % kIn, py = i / (3 * kIn);
    const int gy = iy0 + py, gx = ix0 + px;
    float v = 0.0f;
    if (gy >= 0 && gy < h && gx >= 0 && gx < wd) {
      v = __bfloat162float(
          __float2bfloat16_rn(im[((size_t)gy * wd + gx) * 3 + c]));
    }
    in_s[i] = v;
  }
  for (int i = tid; i < kTaps * kCo; i += kThreads) {
    w_s[i] = __bfloat162float(w[i]);
  }
  __syncthreads();

  const int o = tid % kCo;
  const int g = tid / kCo;
  const float bo = bias[o];
  for (int cr = g; cr < kConv; cr += kGroups) {
    float acc[kConv];
#pragma unroll
    for (int j = 0; j < kConv; ++j) acc[j] = 0.0f;
    for (int dy = 0; dy < 7; ++dy) {
      const float* row = in_s + (2 * cr + dy) * kIn * 3;
#pragma unroll
      for (int dx = 0; dx < 7; ++dx) {
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          const float wv = w_s[((dy * 7 + dx) * 3 + c) * kCo + o];
#pragma unroll
          for (int j = 0; j < kConv; ++j) {
            acc[j] = fmaf(row[(2 * j + dx) * 3 + c], wv, acc[j]);
          }
        }
      }
    }
    const int r = 2 * pr0 + cr;
#pragma unroll
    for (int j = 0; j < kConv; ++j) {
      const int q = 2 * pc0 + j;
      float v = fmaxf(acc[j] + bo, 0.0f);
      if (r >= hc || q >= wc) v = 0.0f;
      conv_s[(cr * kConv + j) * kCo + o] = __float2bfloat16_rn(v);
    }
  }
  __syncthreads();

  for (int k = g; k < kTile * kTile; k += kGroups) {
    const int pr = k / kTile, pc = k % kTile;
    if (pr0 + pr >= ho || pc0 + pc >= wo) continue;
    float m = 0.0f;
#pragma unroll
    for (int a = 0; a < 3; ++a) {
#pragma unroll
      for (int bb = 0; bb < 3; ++bb) {
        m = fmaxf(m, __bfloat162float(
                         conv_s[((2 * pr + a) * kConv + 2 * pc + bb) * kCo + o]));
      }
    }
    out[(((size_t)b * ho + pr0 + pr) * wo + pc0 + pc) * kCo + o] =
        __float2bfloat16_rn(m);
  }
}

}  // namespace

extern "C" {

// img (B, H, W, 3) f32, w (7, 7, 3, 64) bf16 folded, bias (64,) f32,
// out (B, H/4, W/4, 64) bf16.
int mrt_stem(const void* img, const void* w, const void* bias, void* out,
             int b, int h, int wd, void* stream) {
  if (h % 4 || wd % 4) return (int)cudaErrorInvalidValue;
  if (b == 0) return 0;
  cudaError_t err = cudaFuncSetAttribute(
      stem_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSmem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((wd / 4 + kTile - 1) / kTile, (h / 4 + kTile - 1) / kTile, b);
  stem_kernel<<<grid, kThreads, kSmem, (cudaStream_t)stream>>>(
      (const float*)img, (const __nv_bfloat16*)w, (const float*)bias,
      (__nv_bfloat16*)out, h, wd);
  return (int)cudaGetLastError();
}

}  // extern "C"
