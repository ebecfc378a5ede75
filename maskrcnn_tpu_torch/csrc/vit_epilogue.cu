// The epilogue of a ViT or Swin block's linear in one pass over the GEMM's
// raw bf16 output (`ops/vit_epilogue_cuda.py`): the dense layer's bias, then
// GELU after fc1, or the float32 residual add and the LayerNorm that follows
// it after proj and fc2, with a windowed block's padding, shift and window
// layout as an index map of the pass.
//
// Replaces no TPU kernel: the JAX package leaves these layers to XLA, which
// fuses the elementwise work into the matmuls. In the port each linear was
// a chain of PyTorch passes (bias add; GELU; cast to float32; residual add;
// LayerNorm; zero pad, roll and window partition or the inverse and crop;
// cast to bf16), some fourteen passes a block over a 25-100 M-element
// activation.
//
// Numerics: the layers' op sequence, per element and with its roundings
// (`models/vit.py`, `models/swin.py`, `nn.dense`):
//   t = bf16(y + bias)                          (bias rounded to bf16)
//   bias_gelu:  bf16(f32(t) * 0.5 * (1 + erf(f32(t) * M_SQRT1_2)))
//   bias_residual_norm:  x' = x + f32(t)        (the float32 stream)
//               n = bf16(gamma * (rstd * (x' - mean)) + beta)
// Every add and multiply is spelt with an intrinsic (__fadd_rn, __fmul_rn;
// the LayerNorm's output as the one __fmaf_rn that PyTorch's kernel
// contracts to), so no contraction of the compiler changes a bit. The file
// builds with the default -fmad=true, as PyTorch does, so `erff` is the
// same libdevice code PyTorch's GELU runs. The bias, GELU and x' are equal
// to the layers bit for bit. The LayerNorm's mean and variance are summed in
// another order than PyTorch's Welford kernel (a lane's 24 values in turn,
// then a butterfly over the row's lanes; the variance from the deviations),
// so n may differ from the layers' by one bf16 ulp where the float32 value
// lies at a rounding boundary. rstd is rsqrtf, as PyTorch's.
//
// What bounds it on an H100: bytes. Per element `bias` and `bias_gelu` read
// 2 bytes and write 2; `bias_residual_norm` reads 2 + 4 and writes 4 + 2.
// At batch 8 and 1024^2 that is 0.30-0.40 GB a call on ViT-B's 64x64 grid
// of 768 channels (90-120 us at 3.35 TB/s), 0.60-0.81 GB on Swin-S's
// first stage (256x256 of 96), half as much at each later stage.
//
// Design:
//   bias / bias_gelu (`vit_epilogue_kernel`): each thread owns one
//   8-channel slice of the row (one 16-byte load and store a row) and walks
//   the rows with a grid stride that is a multiple of the row's slices, so
//   the slice's bias stays in registers; two rows in flight a thread.
//   bias_residual_norm (`vit_epilogue_norm_kernel<kNorm, kLanes>`): a group
//   of kLanes lanes a token row of C = 24 kLanes channels (Swin-S's 96,
//   192, 384, 768: 4, 8, 16, 32 lanes; ViT-B's 768: a warp), a lane
//   holding 3 chunks of 8 channels (16 bytes of y and 32 of x a chunk,
//   neighbouring lanes on neighbouring addresses); a warp holds 32 / kLanes
//   rows, and the statistics' butterfly runs within a row's group. The row
//   stays in registers from the residual add through the statistics to the
//   normalised write, so x' is written once and never read back. The warp
//   walks rows with a grid stride, all its lanes together (a row past the
//   end or a pad token is summed as zeros, so every lane runs every
//   shuffle); a row's index maps to its token in the grid and in the padded
//   windows (window_partition's layout: image, window row, window column,
//   token row, token column, with Swin's shift: window position p holds
//   the padded map's (p + shift) mod (windows x window) on both axes,
//   torch.roll's map), so the proj output is read in windows and x'
//   written in the grid, or the next block's LN1 written straight into its
//   rolled, padded windows with zero pad rows. The bias, LayerNorm scale
//   and shift are read from L1 each row (10 bytes a channel against 12 of
//   device memory).
// Both grids fill the SMs (an occupancy query, once per device and kernel;
// `epilogue_common.cuh`, as the conv epilogue).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "epilogue_common.cuh"

namespace {

using bf16 = __nv_bfloat16;
using epilogue::round_bf16;

constexpr int kThreads = 256;
constexpr int kChunks = 3;            // 8-channel chunks a lane
// lanes a row of the LayerNorm form: residual widths 24 x {4, 8, 16, 32}
constexpr int kLaneCounts[4] = {4, 8, 16, 32};

// F.gelu (erf form) on CUDA, in float: x * 0.5 * (1 + erf(x * M_SQRT1_2))
__device__ __forceinline__ float gelu(float x) {
  const float e = erff(__fmul_rn(x, 0.70710678118654752440f));
  return __fmul_rn(__fmul_rn(x, 0.5f), __fadd_rn(1.0f, e));
}

__device__ __forceinline__ void unpack(uint4 v, float (&f)[8]) {
  const bf16* b = reinterpret_cast<const bf16*>(&v);
#pragma unroll
  for (int j = 0; j < 8; ++j) f[j] = __bfloat162float(b[j]);
}

template <bool kGelu>
__device__ __forceinline__ uint4 finish(uint4 yv, const float (&b)[8]) {
  float y[8];
  unpack(yv, y);
  uint4 ov;
  bf16* o = reinterpret_cast<bf16*>(&ov);
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    float t = round_bf16(__fadd_rn(y[j], b[j]));
    if (kGelu) t = gelu(t);
    o[j] = __float2bfloat16_rn(t);
  }
  return ov;
}

// y, out (rows, C) bf16, C = 8 * slices. The grid's threads are a multiple
// of `slices`.
template <bool kGelu>
__global__ void __launch_bounds__(kThreads) vit_epilogue_kernel(
    const bf16* __restrict__ y, const bf16* __restrict__ bias,
    bf16* __restrict__ out, int rows, int slices) {
  const long tid = (long)blockIdx.x * kThreads + threadIdx.x;
  const int c0 = (int)(tid % slices) * 8;
  const long step = (long)gridDim.x * kThreads / slices;
  const long c = (long)slices * 8;
  float b[8];
  unpack(__ldg(reinterpret_cast<const uint4*>(bias + c0)), b);
  long row = tid / slices;
  for (; row + step < rows; row += 2 * step) {
    const long o0 = row * c + c0, o1 = (row + step) * c + c0;
    const uint4 y0 = *reinterpret_cast<const uint4*>(y + o0);
    const uint4 y1 = *reinterpret_cast<const uint4*>(y + o1);
    *reinterpret_cast<uint4*>(out + o0) = finish<kGelu>(y0, b);
    *reinterpret_cast<uint4*>(out + o1) = finish<kGelu>(y1, b);
  }
  if (row < rows) {
    const long o0 = row * c + c0;
    *reinterpret_cast<uint4*>(out + o0) =
        finish<kGelu>(*reinterpret_cast<const uint4*>(y + o0), b);
  }
}

// Where the rows of a `bias_residual_norm` call lie. Without a window the
// rows are the grid's tokens, (image, h, w) in order. With one, the rows
// walked are those of the padded windows, and y or the LayerNorm's output
// lies in that layout.
struct Layout {
  int height, width;       // the token grid of an image
  int window;              // side of a window, 0: no window layout
  int win_h, win_w;        // windows down and across an image
  int shift;               // with a window: window position p holds the
                           // padded map's (p + shift) mod its side
  int norm_windowed;       // with a window: the LayerNorm's output lies in
                           // the padded windows, else y does
  long rows;               // rows walked
};

template <int kLanes>
__device__ __forceinline__ float row_sum(float v) {
  // a butterfly within the row's group of kLanes aligned lanes, run by
  // every lane of the warp: every lane of a group adds the same two partial
  // sums at each step, so the group ends with the same bits
#pragma unroll
  for (int m = kLanes / 2; m > 0; m >>= 1) {
    v = __fadd_rn(v, __shfl_xor_sync(~0u, v, m));
  }
  return v;
}

// y bf16 (grid or padded windows, C), x float32 (grid, C), x_out float32
// (grid, C), norm_out bf16 (grid or padded windows, C) when kNorm;
// C = 24 kLanes.
template <bool kNorm, int kLanes>
__global__ void __launch_bounds__(kThreads) vit_epilogue_norm_kernel(
    const bf16* __restrict__ y, const bf16* __restrict__ bias,
    const float* __restrict__ x, const float* __restrict__ scale,
    const float* __restrict__ shift, float* __restrict__ x_out,
    bf16* __restrict__ norm_out, Layout L, float eps) {
  constexpr int C = kChunks * 8 * kLanes;
  const int lane = threadIdx.x & (kLanes - 1);
  // the row's group in its warp: the warp's rows are base + group
  const int group = (threadIdx.x & 31) / kLanes;
  const long slots = (long)gridDim.x * (kThreads / kLanes);
  for (long r = ((long)blockIdx.x * kThreads + threadIdx.x) / kLanes;
       r - group < L.rows; r += slots) {
    bool live = r < L.rows;
    long g = r, yr = r, nr = r;
    if (L.window && live) {
      const int area = L.window * L.window;
      const int per_image = L.win_h * L.win_w;
      const long n = r / area;
      const int t = (int)(r - n * area);
      const long img = n / per_image;
      const int wi = (int)(n - img * per_image);
      int h = (wi / L.win_w) * L.window + t / L.window + L.shift;
      int w = (wi % L.win_w) * L.window + t % L.window + L.shift;
      const int hp = L.win_h * L.window, wp = L.win_w * L.window;
      if (h >= hp) h -= hp;
      if (w >= wp) w -= wp;
      if (h >= L.height || w >= L.width) {  // a pad token
        if (kNorm && L.norm_windowed) {
#pragma unroll
          for (int k = 0; k < kChunks; ++k) {
            *reinterpret_cast<uint4*>(norm_out + r * C +
                                      (k * kLanes + lane) * 8) =
                make_uint4(0, 0, 0, 0);
          }
        }
        live = false;
      } else {
        g = (img * L.height + h) * L.width + w;
        yr = L.norm_windowed ? g : r;
        nr = L.norm_windowed ? r : g;
      }
    }
    if (kNorm) {
      // the warp's rows go on together (their statistics' shuffles) while
      // one of them is a token
      if (!__any_sync(~0u, live)) continue;
    } else if (!live) {
      continue;
    }
    float v[kChunks][8];
#pragma unroll
    for (int k = 0; k < kChunks; ++k) {
#pragma unroll
      for (int j = 0; j < 8; ++j) v[k][j] = 0.0f;
    }
    if (live) {
      uint4 yv[kChunks];
      float4 xv[kChunks][2];
#pragma unroll
      for (int k = 0; k < kChunks; ++k) {
        const int c0 = (k * kLanes + lane) * 8;
        yv[k] = *reinterpret_cast<const uint4*>(y + yr * C + c0);
        xv[k][0] = *reinterpret_cast<const float4*>(x + g * C + c0);
        xv[k][1] = *reinterpret_cast<const float4*>(x + g * C + c0 + 4);
      }
#pragma unroll
      for (int k = 0; k < kChunks; ++k) {
        const int c0 = (k * kLanes + lane) * 8;
        float yf[8], bf[8];
        unpack(yv[k], yf);
        unpack(__ldg(reinterpret_cast<const uint4*>(bias + c0)), bf);
        const float xs[8] = {xv[k][0].x, xv[k][0].y, xv[k][0].z, xv[k][0].w,
                             xv[k][1].x, xv[k][1].y, xv[k][1].z, xv[k][1].w};
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          v[k][j] = __fadd_rn(xs[j], round_bf16(__fadd_rn(yf[j], bf[j])));
        }
        *reinterpret_cast<float4*>(x_out + g * C + c0) =
            make_float4(v[k][0], v[k][1], v[k][2], v[k][3]);
        *reinterpret_cast<float4*>(x_out + g * C + c0 + 4) =
            make_float4(v[k][4], v[k][5], v[k][6], v[k][7]);
      }
    }
    if (!kNorm) continue;
    float s = 0.0f;
#pragma unroll
    for (int k = 0; k < kChunks; ++k) {
#pragma unroll
      for (int j = 0; j < 8; ++j) s = __fadd_rn(s, v[k][j]);
    }
    const float mean = __fdiv_rn(row_sum<kLanes>(s), (float)C);
    float q = 0.0f;
#pragma unroll
    for (int k = 0; k < kChunks; ++k) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        v[k][j] = __fsub_rn(v[k][j], mean);
        q = __fadd_rn(q, __fmul_rn(v[k][j], v[k][j]));
      }
    }
    const float rstd =
        rsqrtf(__fadd_rn(__fdiv_rn(row_sum<kLanes>(q), (float)C), eps));
    if (!live) continue;
#pragma unroll
    for (int k = 0; k < kChunks; ++k) {
      const int c0 = (k * kLanes + lane) * 8;
      const float4 s0 = __ldg(reinterpret_cast<const float4*>(scale + c0));
      const float4 s1 = __ldg(reinterpret_cast<const float4*>(scale + c0 + 4));
      const float4 h0 = __ldg(reinterpret_cast<const float4*>(shift + c0));
      const float4 h1 = __ldg(reinterpret_cast<const float4*>(shift + c0 + 4));
      const float sv[8] = {s0.x, s0.y, s0.z, s0.w, s1.x, s1.y, s1.z, s1.w};
      const float hv[8] = {h0.x, h0.y, h0.z, h0.w, h1.x, h1.y, h1.z, h1.w};
      uint4 ov;
      bf16* o = reinterpret_cast<bf16*>(&ov);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        o[j] = __float2bfloat16_rn(
            __fmaf_rn(sv[j], __fmul_rn(rstd, v[k][j]), hv[j]));
      }
      *reinterpret_cast<uint4*>(norm_out + nr * C + c0) = ov;
    }
  }
}

using BiasKernel = void (*)(const bf16*, const bf16*, bf16*, int, int);
constexpr BiasKernel kBiasKernels[2] = {vit_epilogue_kernel<false>,
                                        vit_epilogue_kernel<true>};

using NormKernel = void (*)(const bf16*, const bf16*, const float*,
                            const float*, const float*, float*, bf16*, Layout,
                            float);
// [with the LayerNorm][lanes a row: 4, 8, 16, 32]
constexpr NormKernel kNormKernels[2][4] = {
    {vit_epilogue_norm_kernel<false, 4>, vit_epilogue_norm_kernel<false, 8>,
     vit_epilogue_norm_kernel<false, 16>, vit_epilogue_norm_kernel<false, 32>},
    {vit_epilogue_norm_kernel<true, 4>, vit_epilogue_norm_kernel<true, 8>,
     vit_epilogue_norm_kernel<true, 16>, vit_epilogue_norm_kernel<true, 32>}};

}  // namespace

extern "C" {

// y, out (rows, C) bf16; bias (C,) bf16. gelu 0: out = bf16(y + bias);
// gelu 1: out = gelu(bf16(y + bias)). C % 8 == 0; every pointer 16-byte
// aligned.
int mrt_vit_epilogue(const void* y, const void* bias, void* out, int rows,
                     int channels, int gelu, void* stream) {
  using epilogue::aligned16;
  if ((gelu != 0 && gelu != 1) || channels <= 0 || channels % 8 || rows < 0 ||
      !aligned16(y) || !aligned16(bias) || !aligned16(out)) {
    return (int)cudaErrorInvalidValue;
  }
  if (rows == 0) return 0;
  static epilogue::Residency fits[2];
  int fit = 0;
  const cudaError_t err = fits[gelu].get(
      reinterpret_cast<const void*>(kBiasKernels[gelu]), kThreads, &fit);
  if (err != cudaSuccess) return (int)err;
  const int slices = channels / 8;
  const long grid = epilogue::slice_grid(rows, slices, kThreads, fit);
  kBiasKernels[gelu]<<<(int)grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const bf16*)y, (const bf16*)bias, (bf16*)out, rows, slices);
  return (int)cudaGetLastError();
}

// x' = x + f32(bf16(y + bias)) into x_out (batch, height, width, C)
// float32, and where norm_out is not null LN(x') (scale, shift float32,
// eps) into norm_out as bf16. window > 0: one side lies in padded windows
// of that side (batch * win_h * win_w, window, window, C), rolled by
// (-shift, -shift) (0 <= shift < window): norm_out where norm_windowed,
// its pad rows written as zeros, else y, its pad tokens unread; window 0:
// both in the grid, whatever shift. C in {96, 192, 384, 768}; every
// pointer 16-byte aligned.
int mrt_vit_epilogue_norm(const void* y, const void* bias, const void* x,
                          const void* scale, const void* shift, void* x_out,
                          void* norm_out, int batch, int height, int width,
                          int channels, int window, int window_shift,
                          int norm_windowed, float eps, void* stream) {
  using epilogue::aligned16;
  const bool norm = norm_out != nullptr;
  int which = -1;
  for (int i = 0; i < 4; ++i) {
    if (channels == kChunks * 8 * kLaneCounts[i]) which = i;
  }
  if (which < 0 || batch < 0 || height <= 0 || width <= 0 || window < 0 ||
      (window && (window_shift < 0 || window_shift >= window)) ||
      (window && norm_windowed && !norm) || !aligned16(y) ||
      !aligned16(bias) || !aligned16(x) || !aligned16(x_out) ||
      (norm && (!aligned16(scale) || !aligned16(shift) ||
                !aligned16(norm_out)))) {
    return (int)cudaErrorInvalidValue;
  }
  Layout L;
  L.height = height;
  L.width = width;
  L.window = window;
  L.win_h = window ? (height + window - 1) / window : 0;
  L.win_w = window ? (width + window - 1) / window : 0;
  L.shift = window ? window_shift : 0;
  L.norm_windowed = window && norm_windowed;
  L.rows = window ? (long)batch * L.win_h * L.win_w * window * window
                  : (long)batch * height * width;
  if (L.rows == 0) return 0;
  static epilogue::Residency fits[2][4];
  const NormKernel kernel = kNormKernels[norm][which];
  int fit = 0;
  const cudaError_t err = fits[norm][which].get(
      reinterpret_cast<const void*>(kernel), kThreads, &fit);
  if (err != cudaSuccess) return (int)err;
  const long per_block = kThreads / kLaneCounts[which];
  const long want = (L.rows + per_block - 1) / per_block;
  const long grid = want < fit ? want : fit;
  kernel<<<(int)grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const bf16*)y, (const bf16*)bias, (const float*)x, (const float*)scale,
      (const float*)shift, (float*)x_out, (bf16*)norm_out, L, eps);
  return (int)cudaGetLastError();
}

}  // extern "C"
