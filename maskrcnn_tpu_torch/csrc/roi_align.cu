// K2: pyramid ROIAlign, plain mode (tf crop_and_resize bilinear sampling
// on each ROI's FPN level), one thread block per ROI and output row.
//
// Replaces: maskrcnn_tpu/ops/roi_align_pallas.py::pyramid_roi_align_pallas
// without head fusion (pallas_call :716, kernel _kernel :279, prep _prepare
// :222 and _axis_slots :200).
//
// What bounds it on an H100: bytes. Each output value reads four corner
// values and blends them with a handful of flops (~4 flops per byte moved
// at bf16, far below the ~295 flops/byte where the tensor cores would
// limit). The least traffic is one pass over the pyramid cells the ROIs
// sample plus the pooled output (25 MB per image at pool 7 x 1000 ROIs).
//
// Design:
//  * Level choice and sample positions come from the caller
//    (ops/roi_align.py::prepare, computed in torch and shared with the plain
//    version), so kernel and plain version pick the same level for every ROI
//    whatever the device's log2.
//  * The four levels come in as four pointers; nothing stacks or pads the
//    pyramid (stacking cost a full pass over it on the TPU,
//    roi_align_pallas.py:12-18).
//  * One block per (ROI, output row): 7 or 14 blocks per ROI, enough to
//    fill the card at pool-14's 100 ROIs per image.
//  * Threads of the block run over the channels, two per thread, so each
//    corner read is one coalesced run of C values (512 B at C=256 bf16)
//    from the level's NHWC tensor; neighbouring samples reuse corners
//    through L1/L2.
//  * Blends in float32 with each operation rounded on its own, in the order
//    of the plain version (x first, then y), then rounds once to the
//    output type. Out-of-range samples and invalid ROIs write zeros.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

template <typename T>
struct Pair;

template <>
struct Pair<__nv_bfloat16> {
  using V = __nv_bfloat162;
  static __device__ __forceinline__ float2 load(const __nv_bfloat16* p) {
    return __bfloat1622float2(*reinterpret_cast<const V*>(p));
  }
  static __device__ __forceinline__ void store(__nv_bfloat16* p, float2 v) {
    *reinterpret_cast<V*>(p) = __floats2bfloat162_rn(v.x, v.y);
  }
};

template <>
struct Pair<float> {
  static __device__ __forceinline__ float2 load(const float* p) {
    return *reinterpret_cast<const float2*>(p);
  }
  static __device__ __forceinline__ void store(float* p, float2 v) {
    *reinterpret_cast<float2*>(p) = v;
  }
};

__device__ __forceinline__ float lerp_rn(float a, float b, float w) {
  // a * (1 - w) + b * w, each operation rounded on its own.
  return __fadd_rn(__fmul_rn(a, __fsub_rn(1.0f, w)), __fmul_rn(b, w));
}

struct Levels {
  const void* f[4];
  int h[4];
  int w[4];
};

template <typename T>
__global__ void roi_align_kernel(Levels lv, int c,
                                 const float* __restrict__ ys,
                                 const float* __restrict__ xs,
                                 const int* __restrict__ level,
                                 const uint8_t* __restrict__ valid,
                                 int rois_per_image, int p,
                                 T* __restrict__ out) {
  const int m = blockIdx.x;
  const int py = blockIdx.y;
  const int c2 = c / 2;
  T* o = out + ((size_t)m * p + py) * p * c;
  const int l = level[m];
  if (!valid[m] || l < 0 || l > 3) {
    for (int s = 0; s < p; ++s)
      for (int k = threadIdx.x; k < c2; k += blockDim.x)
        Pair<T>::store(o + (size_t)s * c + 2 * k, make_float2(0.f, 0.f));
    return;
  }
  const int fh = lv.h[l], fw = lv.w[l];
  const T* f = static_cast<const T*>(lv.f[l]) +
               (size_t)(m / rois_per_image) * fh * fw * c;
  const float fh1 = (float)(fh - 1), fw1 = (float)(fw - 1);
  const float y = ys[m * p + py];
  const bool y_in = y >= 0.0f && y <= fh1;
  const float y0 = floorf(y);
  const float wy = __fsub_rn(y, y0);
  const int y0i = (int)fminf(fmaxf(y0, 0.0f), fh1);
  const int y1i = min(y0i + 1, fh - 1);
  const T* r0 = f + ((size_t)y0i * fw) * c;
  const T* r1 = f + ((size_t)y1i * fw) * c;

  for (int s = 0; s < p; ++s) {
    const float x = xs[m * p + s];
    T* os = o + (size_t)s * c;
    if (!(y_in && x >= 0.0f && x <= fw1)) {
      for (int k = threadIdx.x; k < c2; k += blockDim.x)
        Pair<T>::store(os + 2 * k, make_float2(0.f, 0.f));
      continue;
    }
    const float x0 = floorf(x);
    float wx = __fsub_rn(x, x0);
    const int x0i = (int)fminf(fmaxf(x0, 0.0f), fw1);
    const int x1i = min(x0i + 1, fw - 1);
    if (x1i <= x0i) wx = 0.0f;
    const size_t a0 = (size_t)x0i * c, a1 = (size_t)x1i * c;
    for (int k = threadIdx.x; k < c2; k += blockDim.x) {
      const int ch = 2 * k;
      const float2 v00 = Pair<T>::load(r0 + a0 + ch);
      const float2 v01 = Pair<T>::load(r0 + a1 + ch);
      const float2 v10 = Pair<T>::load(r1 + a0 + ch);
      const float2 v11 = Pair<T>::load(r1 + a1 + ch);
      float2 r;
      r.x = lerp_rn(lerp_rn(v00.x, v01.x, wx), lerp_rn(v10.x, v11.x, wx), wy);
      r.y = lerp_rn(lerp_rn(v00.y, v01.y, wx), lerp_rn(v10.y, v11.y, wx), wy);
      Pair<T>::store(os + ch, r);
    }
  }
}

}  // namespace

extern "C" {

// f0..f3: (B, H_l, W_l, C) levels; ys/xs (M, P) f32; level (M,) int32;
// valid (M,) bool; out (M, P, P, C). is_bf16 selects bf16 or f32 features.
int mrt_roi_align(const void* f0, const void* f1, const void* f2,
                  const void* f3, int h0, int w0, int h1, int w1, int h2,
                  int w2, int h3, int w3, int c, const void* ys,
                  const void* xs, const void* level, const void* valid,
                  int m, int rois_per_image, int p, int is_bf16, void* out,
                  void* stream) {
  if (m == 0) return 0;
  if (c % 2 || rois_per_image <= 0) return (int)cudaErrorInvalidValue;
  Levels lv{{f0, f1, f2, f3}, {h0, h1, h2, h3}, {w0, w1, w2, w3}};
  int threads = c / 2 < 128 ? ((c / 2 + 31) / 32) * 32 : 128;
  cudaStream_t st = (cudaStream_t)stream;
  const dim3 grid(m, p);
  if (is_bf16) {
    roi_align_kernel<__nv_bfloat16><<<grid, threads, 0, st>>>(
        lv, c, (const float*)ys, (const float*)xs, (const int*)level,
        (const uint8_t*)valid, rois_per_image, p, (__nv_bfloat16*)out);
  } else {
    roi_align_kernel<float><<<grid, threads, 0, st>>>(
        lv, c, (const float*)ys, (const float*)xs, (const int*)level,
        (const uint8_t*)valid, rois_per_image, p, (float*)out);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
