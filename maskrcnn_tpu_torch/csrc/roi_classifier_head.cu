// K5: pool-7 ROIAlign with the whole classifier head behind it. Per ROI:
// the 7x7xC pool (K2's sampling, rounded to bf16), flattened NHWC
// row-major to 49*C values, h1 = bf16(relu(row @ W1 + b1)),
// h2 = bf16(relu(h1 @ W2 + b2)), out = h2 @ W3 + b3 in float32 (512 packed
// lanes: logits, then box deltas from lane 128). BN is folded into W and b
// by the caller (ops/roi_align_cuda.py::pack_classifier_head).
//
// Replaces: maskrcnn_tpu/ops/roi_align_pallas.py::pyramid_roi_align_pallas
// with head_params (pallas_call :716, head body _kernel :474-502, packing
// pack_classifier_head :84).
//
// What bounds it on an H100: operations. 2 * M * (12544*1024 + 1024^2 +
// 1024*512) = 57.7 GFLOP at M = 2000 ROIs (batch 2) against ~29 MB of
// weights, far above the ~295 flops/byte where the tensor cores limit.
//
// Design (first version: right and simple, tensor cores through mma.sync,
// no TMA or wgmma):
//  * Launch 1 (pool_dense1_kernel): a block owns 64 ROIs x 256 columns of
//    W1 (so 4 blocks share each ROI tile at fc 1024: one wave of 128 blocks
//    at M = 2000). It walks K one sample point (py, px) at a time: C values
//    per ROI, pooled straight into shared memory (double-buffered: the
//    next point is sampled while the tensor cores consume this one) and
//    multiplied against the matching rows of W1. The pooled tile never
//    reaches device memory. W1 fragments are read from device memory (L2)
//    through the transposed (1024, 12544) copy the wrapper hands in.
//    Each of the 4 column blocks samples its ROIs again (reads from L2).
//  * Launches 2 and 3 (dense_kernel): h1 -> h2 -> out, 64 x 128 tiles, A
//    and B fragments from device memory. h1 and h2 (M x 1024 bf16, 4 MB
//    each) make one round trip through memory; the TPU kernel kept them in
//    VMEM.
//  * Epilogues apply bias, ReLU and rounding per element in the plain
//    version's order. ROIs past M and invalid ROIs pool to zero rows and
//    still run through the head (as in the TPU kernel).

#include "roi_head_common.cuh"

namespace {

using namespace mrt;

constexpr int kThreads = 256;  // 8 warps
constexpr int kRows = 64;      // ROIs per block
constexpr int kCols1 = 256;    // W1 columns per block (warps 2 x 4 of 32 x 64)
constexpr int kCols = 128;     // W2/W3 columns per block (warps 2 x 4 of 32 x 32)
constexpr int kMaxC = 256;
constexpr int kLdA = kMaxC + 8;  // staged row stride: conflict-free A loads

size_t pool_smem(int p) {
  return 2 * (size_t)kRows * kLdA * sizeof(bf16) +
         2 * (size_t)kRows * p * sizeof(float) + kRows * sizeof(int);
}

__global__ void __launch_bounds__(kThreads)
pool_dense1_kernel(Levels lv, int c, const float* __restrict__ ys,
                   const float* __restrict__ xs,
                   const int* __restrict__ level,
                   const uint8_t* __restrict__ valid, int m, int rpi, int p,
                   const bf16* __restrict__ w1t, const float* __restrict__ b1,
                   int n1, bf16* __restrict__ h1) {
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* stage = reinterpret_cast<bf16*>(smem);
  float* sy = reinterpret_cast<float*>(smem + 2 * (size_t)kRows * kLdA *
                                                  sizeof(bf16));
  float* sx = sy + kRows * p;
  int* sl = reinterpret_cast<int*>(sx + kRows * p);  // level, -1: zero row

  const int row0 = blockIdx.x * kRows;
  const int col0 = blockIdx.y * kCols1;
  for (int i = threadIdx.x; i < kRows; i += kThreads) {
    const int r = row0 + i;
    int l = -1;
    if (r < m && valid[r]) {
      l = level[r];
      if (l < 0 || l > 3) l = -1;
    }
    sl[i] = l;
  }
  for (int i = threadIdx.x; i < kRows * p; i += kThreads) {
    const bool in = row0 + i / p < m;
    sy[i] = in ? ys[(size_t)row0 * p + i] : 0.0f;
    sx[i] = in ? xs[(size_t)row0 * p + i] : 0.0f;
  }
  __syncthreads();

  const int c2 = c / 2;
  const int points = p * p;
  const size_t k1 = (size_t)points * c;
  // Pool sample point s = (py, px) of the block's ROIs into buf (kRows x c).
  auto pool_point = [&](int s, bf16* buf) {
    const int py = s / p, px = s % p;
    for (int i = threadIdx.x; i < kRows * c2; i += kThreads) {
      const int r = i / c2, cp = i - r * c2;
      const int l = sl[r];
      uint32_t v = 0u;
      if (l >= 0) {
        const Sample smp = locate(lv, l, (row0 + r) / rpi, c,
                                  sy[r * p + py], sx[r * p + px]);
        v = sample_pair(smp, 2 * cp);
      }
      *reinterpret_cast<uint32_t*>(buf + r * kLdA + 2 * cp) = v;
    }
  };

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int wr = (warp & 1) * 32, wc = (warp >> 1) * 64;
  float acc[2][8][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.0f;

  pool_point(0, stage);
  __syncthreads();
  for (int s = 0; s < points; ++s) {
    const bf16* cur = stage + (s & 1) * kRows * kLdA;
    if (s + 1 < points) pool_point(s + 1, stage + ((s + 1) & 1) * kRows * kLdA);
    const bf16* wrow = w1t + (size_t)(col0 + wc + g) * k1 + (size_t)s * c + 2 * t;
    for (int kk = 0; kk < c; kk += 16) {
      uint32_t a[2][4];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const bf16* ap = cur + (wr + i * 16 + g) * kLdA + kk + 2 * t;
        a[i][0] = lds32(ap);
        a[i][1] = lds32(ap + 8 * kLdA);
        a[i][2] = lds32(ap + 8);
        a[i][3] = lds32(ap + 8 * kLdA + 8);
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const bf16* bp = wrow + (size_t)j * 8 * k1 + kk;
        const uint32_t b0 = ldg32(bp), b1v = ldg32(bp + 8);
        mma16816(acc[0][j], a[0], b0, b1v);
        mma16816(acc[1][j], a[1], b0, b1v);
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int col = col0 + wc + j * 8 + 2 * t;
    const float c0 = b1[col], c1 = b1[col + 1];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const size_t r = row0 + wr + i * 16 + g;
      *reinterpret_cast<uint32_t*>(h1 + r * n1 + col) =
          pack_bf16(fmaxf(acc[i][j][0] + c0, 0.0f),
                    fmaxf(acc[i][j][1] + c1, 0.0f));
      *reinterpret_cast<uint32_t*>(h1 + (r + 8) * n1 + col) =
          pack_bf16(fmaxf(acc[i][j][2] + c0, 0.0f),
                    fmaxf(acc[i][j][3] + c1, 0.0f));
    }
  }
}

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}

__device__ __forceinline__ void store2(bf16* p, float a, float b) {
  *reinterpret_cast<uint32_t*>(p) = pack_bf16(a, b);
}

// out = act(a @ w + bias) on one 64 x 128 tile: a (rows, k) bf16, wt the
// transposed (n, k) bf16 weight, bias (n,) float32.
template <bool kRelu, typename OutT>
__global__ void __launch_bounds__(kThreads)
dense_kernel(const bf16* __restrict__ a, int k, const bf16* __restrict__ wt,
             const float* __restrict__ bias, int n, OutT* __restrict__ out) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = blockIdx.x * kRows + (warp & 1) * 32;
  const int c0 = blockIdx.y * kCols + (warp >> 1) * 32;
  float acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.0f;

  const bf16* ar = a + (size_t)(r0 + g) * k + 2 * t;
  const bf16* br = wt + (size_t)(c0 + g) * k + 2 * t;
  const size_t k8 = (size_t)8 * k;
  for (int kk = 0; kk < k; kk += 16) {
    uint32_t af[2][4];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const bf16* ap = ar + 2 * (size_t)i * k8 + kk;
      af[i][0] = ldg32(ap);
      af[i][1] = ldg32(ap + k8);
      af[i][2] = ldg32(ap + 8);
      af[i][3] = ldg32(ap + k8 + 8);
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const bf16* bp = br + (size_t)j * k8 + kk;
      const uint32_t b0 = ldg32(bp), b1 = ldg32(bp + 8);
      mma16816(acc[0][j], af[0], b0, b1);
      mma16816(acc[1][j], af[1], b0, b1);
    }
  }

#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int col = c0 + j * 8 + 2 * t;
    const float bb0 = bias[col], bb1 = bias[col + 1];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const size_t r = r0 + i * 16 + g + 8 * h;
        float v0 = acc[i][j][2 * h] + bb0, v1 = acc[i][j][2 * h + 1] + bb1;
        if (kRelu) {
          v0 = fmaxf(v0, 0.0f);
          v1 = fmaxf(v1, 0.0f);
        }
        store2(out + r * n + col, v0, v1);
      }
    }
  }
}

}  // namespace

extern "C" {

// f0..f3: (B, H_l, W_l, C) bf16 levels; ys/xs (M, P) f32; level (M,)
// int32; valid (M,) bool; w1t (N1, P*P*C), w2t (N2, N1), w3t (N3, N2) bf16
// (transposed weights); b1, b2, b3 f32; h1 (Mp, N1) and h2 (Mp, N2) bf16
// scratch and out (Mp, N3) f32 with Mp = M rounded up to 64.
int mrt_roi_classifier_head(
    const void* f0, const void* f1, const void* f2, const void* f3, int h0,
    int w0, int h1_, int w1_, int h2_, int w2_, int h3, int w3, int c,
    const void* ys, const void* xs, const void* level, const void* valid,
    int m, int rois_per_image, int p, const void* w1t, const void* b1, int n1,
    const void* w2t, const void* b2, int n2, const void* w3t, const void* b3,
    int n3, void* h1, void* h2, void* out, void* stream) {
  if (m == 0) return 0;
  if (c % 16 || c > kMaxC || n1 % kCols1 || n2 % kCols || n3 % kCols ||
      rois_per_image <= 0 || p <= 0) {
    return (int)cudaErrorInvalidValue;
  }
  Levels lv{{(const bf16*)f0, (const bf16*)f1, (const bf16*)f2,
             (const bf16*)f3},
            {h0, h1_, h2_, h3},
            {w0, w1_, w2_, w3}};
  const int tiles = (m + kRows - 1) / kRows;
  cudaStream_t st = (cudaStream_t)stream;
  const size_t smem = pool_smem(p);
  cudaError_t err = cudaFuncSetAttribute(
      pool_dense1_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  pool_dense1_kernel<<<dim3(tiles, n1 / kCols1), kThreads, smem, st>>>(
      lv, c, (const float*)ys, (const float*)xs, (const int*)level,
      (const uint8_t*)valid, m, rois_per_image, p, (const bf16*)w1t,
      (const float*)b1, n1, (bf16*)h1);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  dense_kernel<true, bf16><<<dim3(tiles, n2 / kCols), kThreads, 0, st>>>(
      (const bf16*)h1, n1, (const bf16*)w2t, (const float*)b2, n2,
      (bf16*)h2);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  dense_kernel<false, float><<<dim3(tiles, n3 / kCols), kThreads, 0, st>>>(
      (const bf16*)h2, n2, (const bf16*)w3t, (const float*)b3, n3,
      (float*)out);
  return (int)cudaGetLastError();
}

}  // extern "C"
