// The epilogue of a ResNet layer-path convolution: the conv's bias,
// inference BatchNorm, the block's shortcut and ReLU, in one pass over
// cuDNN's raw bf16 NHWC output (`ops/conv_epilogue_cuda.py`).
//
// Replaces no TPU kernel: the JAX package leaves these layers to XLA, which
// fuses the elementwise work into the convolution. In the port each layer
// was a chain of PyTorch passes (bias add; cast to float32; multiply; add;
// cast back; ReLU; residual add; ReLU), some nine passes over a bf16
// activation a conv and 30-36 bytes of device memory traffic an element.
//
// Numerics: bit-equal to that chain. Per element, in its order and with its
// roundings:
//   t = bf16(y + bias)                              (bias rounded to bf16)
//   t = bf16(f32(f32(t * scale) + shift))           (BN: two f32 roundings)
//   form 1 (identity block): t = bf16(t + x)
//   form 2 (projection block): s = bf16(bf16(r + rbias) * rscale + rshift)
//                              as above, then t = bf16(t + s)
//   t = relu(t)                                      (NaN passes, as torch)
// Built with -fmad=false and spelt with __fmul_rn / __fadd_rn, so no
// multiply-add contraction changes a bit.
//
// What bounds it on an H100: bytes. A form-0 element reads 2 bytes and
// writes 2, for a handful of float operations; forms 1 and 2 read 2 more.
// At 3.35 TB/s a (8, 64, 64, 1024) map takes 40 us (form 0) or 60 us
// (forms 1, 2).
//
// Design: each thread owns one 8-channel slice of the row (16 bytes, one
// vector load and one store a row) and walks the rows with a grid stride
// that is a multiple of the row's slices, so the slice's constants (bias,
// scale, shift: 80 bytes, 160 for form 2) are loaded once into registers
// and never again. Neighbouring threads hold neighbouring slices, so a warp
// reads and writes 512 contiguous bytes. Two rows are in flight a thread.
// The grid fills the SMs (an occupancy query, once per device and form).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "epilogue_common.cuh"

namespace {

using bf16 = __nv_bfloat16;
using epilogue::round_bf16;

constexpr int kThreads = 256;
constexpr int kForms = 3;

// torch.relu on CUDA: clamp_min(v, 0), which returns a NaN as it is and
// otherwise max(v, 0) in float.
__device__ __forceinline__ float relu(float v) {
  return isnan(v) ? v : fmaxf(v, 0.0f);
}

// One layer's per-channel constants for an 8-channel slice.
struct Slice {
  float bias[8], scale[8], shift[8];

  __device__ __forceinline__ void load(const bf16* __restrict__ b,
                                       const float* __restrict__ s,
                                       const float* __restrict__ h, int c0) {
    const uint4 bv = __ldg(reinterpret_cast<const uint4*>(b + c0));
    const bf16* bb = reinterpret_cast<const bf16*>(&bv);
    const float4 s0 = __ldg(reinterpret_cast<const float4*>(s + c0));
    const float4 s1 = __ldg(reinterpret_cast<const float4*>(s + c0 + 4));
    const float4 h0 = __ldg(reinterpret_cast<const float4*>(h + c0));
    const float4 h1 = __ldg(reinterpret_cast<const float4*>(h + c0 + 4));
    const float sv[8] = {s0.x, s0.y, s0.z, s0.w, s1.x, s1.y, s1.z, s1.w};
    const float hv[8] = {h0.x, h0.y, h0.z, h0.w, h1.x, h1.y, h1.z, h1.w};
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      bias[j] = __bfloat162float(bb[j]);
      scale[j] = sv[j];
      shift[j] = hv[j];
    }
  }

  // bf16(bf16(y + bias) * scale + shift), element j
  __device__ __forceinline__ float apply(float y, int j) const {
    const float t = round_bf16(__fadd_rn(y, bias[j]));
    return round_bf16(__fadd_rn(__fmul_rn(t, scale[j]), shift[j]));
  }
};

template <int F>
__device__ __forceinline__ uint4 finish(uint4 yv, uint4 rv, const Slice& a,
                                        const Slice& r) {
  const bf16* y = reinterpret_cast<const bf16*>(&yv);
  const bf16* x = reinterpret_cast<const bf16*>(&rv);
  uint4 ov;
  bf16* o = reinterpret_cast<bf16*>(&ov);
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    float t = a.apply(__bfloat162float(y[j]), j);
    if (F == 1) t = round_bf16(__fadd_rn(t, __bfloat162float(x[j])));
    if (F == 2) t = round_bf16(__fadd_rn(t, r.apply(__bfloat162float(x[j]),
                                                      j)));
    o[j] = __float2bfloat16_rn(relu(t));
  }
  return ov;
}

// y, res, out (rows, C) bf16, C = 8 * slices; res unread in form 0. The
// grid's threads are a multiple of `slices`.
template <int F>
__global__ void __launch_bounds__(kThreads) conv_epilogue_kernel(
    const bf16* __restrict__ y, const bf16* __restrict__ res,
    const bf16* __restrict__ bias, const float* __restrict__ scale,
    const float* __restrict__ shift, const bf16* __restrict__ rbias,
    const float* __restrict__ rscale, const float* __restrict__ rshift,
    bf16* __restrict__ out, int rows, int slices) {
  const long tid = (long)blockIdx.x * kThreads + threadIdx.x;
  const int c0 = (int)(tid % slices) * 8;
  const long step = (long)gridDim.x * kThreads / slices;
  const long c = (long)slices * 8;
  Slice a, r;
  a.load(bias, scale, shift, c0);
  if (F == 2) r.load(rbias, rscale, rshift, c0);
  long row = tid / slices;
  const uint4 zero = make_uint4(0, 0, 0, 0);
  for (; row + step < rows; row += 2 * step) {
    const long o0 = row * c + c0, o1 = (row + step) * c + c0;
    const uint4 y0 = *reinterpret_cast<const uint4*>(y + o0);
    const uint4 y1 = *reinterpret_cast<const uint4*>(y + o1);
    const uint4 r0 = F ? *reinterpret_cast<const uint4*>(res + o0) : zero;
    const uint4 r1 = F ? *reinterpret_cast<const uint4*>(res + o1) : zero;
    *reinterpret_cast<uint4*>(out + o0) = finish<F>(y0, r0, a, r);
    *reinterpret_cast<uint4*>(out + o1) = finish<F>(y1, r1, a, r);
  }
  if (row < rows) {
    const long o0 = row * c + c0;
    const uint4 y0 = *reinterpret_cast<const uint4*>(y + o0);
    const uint4 r0 = F ? *reinterpret_cast<const uint4*>(res + o0) : zero;
    *reinterpret_cast<uint4*>(out + o0) = finish<F>(y0, r0, a, r);
  }
}

using Kernel = void (*)(const bf16*, const bf16*, const bf16*, const float*,
                        const float*, const bf16*, const float*, const float*,
                        bf16*, int, int);
constexpr Kernel kKernels[kForms] = {conv_epilogue_kernel<0>,
                                     conv_epilogue_kernel<1>,
                                     conv_epilogue_kernel<2>};

}  // namespace

extern "C" {

// y (rows, C) bf16 raw conv output; bias (C,) bf16, scale / shift (C,) f32;
// form 0: relu(bn(y)); form 1: relu(bn(y) + res), res (rows, C) bf16;
// form 2: relu(bn(y) + bn_r(res)) with rbias / rscale / rshift, res the raw
// shortcut conv output. out (rows, C) bf16. C % 8 == 0; every pointer read
// or written 16-byte aligned.
int mrt_conv_epilogue(const void* y, const void* res, const void* bias,
                      const void* scale, const void* shift, const void* rbias,
                      const void* rscale, const void* rshift, void* out,
                      int rows, int channels, int form, void* stream) {
  using epilogue::aligned16;
  if (form < 0 || form >= kForms || channels <= 0 || channels % 8 ||
      rows < 0 || !aligned16(y) || !aligned16(bias) || !aligned16(scale) ||
      !aligned16(shift) || !aligned16(out) || (form && !aligned16(res)) ||
      (form == 2 && (!aligned16(rbias) || !aligned16(rscale) ||
                     !aligned16(rshift)))) {
    return (int)cudaErrorInvalidValue;
  }
  if (rows == 0) return 0;
  static epilogue::Residency fits[kForms];
  int fit = 0;
  const cudaError_t err = fits[form].get(
      reinterpret_cast<const void*>(kKernels[form]), kThreads, &fit);
  if (err != cudaSuccess) return (int)err;
  const int slices = channels / 8;
  const long grid = epilogue::slice_grid(rows, slices, kThreads, fit);
  kKernels[form]<<<(int)grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const bf16*)y, (const bf16*)res, (const bf16*)bias,
      (const float*)scale, (const float*)shift, (const bf16*)rbias,
      (const float*)rscale, (const float*)rshift, (bf16*)out, rows, slices);
  return (int)cudaGetLastError();
}

}  // extern "C"
