// K6: pool-14 ROIAlign with the whole mask head behind it. Per ROI: the
// 14x14x256 pool (K2's sampling, rounded to bf16); four times
// a = bf16(relu(conv3x3_SAME(a) @ Wk + bk)) with zeros outside the 14x14;
// z = relu(a @ Wdec[ab] + bdec) in float32 for the four deconv output
// parities ab = 2a + b; logit = sum_c z[c] * bf16(kcls[class])[c] +
// bcls[class]; mask[2y + a][2x + b] = sigmoid(logit). BN is folded into W
// and b by the caller (ops/roi_align_cuda.py::pack_mask_head).
//
// Replaces: maskrcnn_tpu/ops/roi_align_pallas.py::pyramid_roi_align_pallas
// with mask_params + class_ids (pallas_call :716, mask body _kernel
// :504-552, packing pack_mask_head :134).
//
// What bounds it on an H100: operations. 4 * 196 * 2304 * 256 * 2 +
// 196 * 256 * 1024 * 2 = 1.03 GFLOP per ROI (206 GFLOP at 200 ROIs)
// against ~5 MB of weights.
//
// Design (first version: right and simple, mma.sync, no TMA or wgmma):
//  * One block of 8 warps per ROI. The pool and every activation stay in
//    shared memory: two 196 x (256 + 8) bf16 buffers (the 14x14 interior
//    only, 2 x 101 KB) that the four convs ping-pong between. The TPU
//    kernel's padded 16x16 grid would take 2 x 128 KB, over the 227 KB a
//    block may have.
//  * The SAME border is predicated, not stored: the convs are implicit
//    GEMMs (M = 196 positions, N = 256, K = 9 taps x 256), and each A row a
//    lane loads for tap (dy, dx) is the neighbour position's row, or zero
//    where the neighbour falls outside the 14x14. Loading A fragments by
//    hand (roi_head_common.cuh) is what makes that per-row choice possible.
//  * Warp w owns output columns [32w, 32w + 32) and walks the 13 16-row
//    tiles in groups of 4; weight fragments are read from device memory
//    (the 4.7 MB of conv weights stay in L2) through the transposed copy
//    the wrapper hands in.
//  * Deconv, class select and sigmoid are one epilogue: each warp's
//    (positions x 32 channels) tile of z is multiplied by the class row and
//    summed across its lanes into a partial logit per position and parity,
//    kept in the free activation buffer; one pass then adds the 8 partials
//    of each (position, parity) in a fixed order, adds the class bias and
//    writes the (28, 28) float32 mask. The (M, 28, 28, 256) deconv output
//    is never formed.
//  * 200 ROIs on 132 SMs is 1.5 waves (one block per SM: 208 KB of shared
//    memory each).

#include "roi_head_common.cuh"

namespace {

using namespace mrt;

constexpr int kC = 256;                      // channels
constexpr int kP = 14;                       // pool
constexpr int kPos = kP * kP;                // 196 positions
constexpr int kLd = kC + 8;                  // activation row stride
constexpr int kTiles = (kPos + 15) / 16;     // 13 row tiles of 16
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kNT = kC / kWarps / 8;         // n8 tiles per warp (4)
constexpr int kGroups = (kTiles + 3) / 4;    // row-tile groups of 4
constexpr int kChunks = 4 * kC / 32;         // 32-column chunks of z (32)
constexpr size_t kAct = (size_t)kPos * kLd * sizeof(bf16);
constexpr size_t kSmem = 2 * kAct + kC * sizeof(float) + 2 * kP * sizeof(float);

static_assert(kAct % 16 == 0, "activation buffers stay 16-byte aligned");
static_assert(kPos * kChunks * sizeof(float) <= kAct,
              "partial logits fit the free activation buffer");

__device__ __forceinline__ void zero_acc(float (&acc)[4][kNT][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < kNT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.0f;
}

// A fragment of one 16-row tile whose lane rows g and g + 8 start at
// src + off0 / src + off1 (-1: a zero row), columns kk .. kk + 15.
__device__ __forceinline__ void load_a(uint32_t (&a)[4], const bf16* src,
                                       int off0, int off1, int col) {
  a[0] = off0 >= 0 ? lds32(src + off0 + col) : 0u;
  a[1] = off1 >= 0 ? lds32(src + off1 + col) : 0u;
  a[2] = off0 >= 0 ? lds32(src + off0 + col + 8) : 0u;
  a[3] = off1 >= 0 ? lds32(src + off1 + col + 8) : 0u;
}

// dst = bf16(relu(conv3x3_SAME(src) @ w + b)) over the 14x14 positions;
// w is the layer's transposed (C, 9C) weight, K index tap * C + cin.
__device__ void conv3x3(const bf16* src, bf16* dst,
                        const bf16* __restrict__ w,
                        const float* __restrict__ b, int warp, int g,
                        int t) {
  const int n0 = warp * kNT * 8;
  for (int grp = 0; grp < kGroups; ++grp) {
    const int tile0 = grp * 4;
    const int tiles = min(4, kTiles - tile0);
    float acc[4][kNT][4];
    zero_acc(acc);
    for (int tap = 0; tap < 9; ++tap) {
      const int dy = tap / 3 - 1, dx = tap % 3 - 1;
      int off[4][2];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int o = (tile0 + i) * 16 + g + 8 * h;
          const int yy = o / kP + dy, xx = o % kP + dx;
          off[i][h] = (i < tiles && o < kPos && yy >= 0 && yy < kP &&
                       xx >= 0 && xx < kP)
                          ? (yy * kP + xx) * kLd
                          : -1;
        }
      }
      const bf16* wt = w + (size_t)(n0 + g) * 9 * kC + tap * kC + 2 * t;
#pragma unroll 4
      for (int kk = 0; kk < kC; kk += 16) {
        uint32_t a[4][4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          if (i < tiles) load_a(a[i], src, off[i][0], off[i][1], kk + 2 * t);
#pragma unroll
        for (int j = 0; j < kNT; ++j) {
          const bf16* bp = wt + (size_t)j * 8 * 9 * kC + kk;
          const uint32_t b0 = ldg32(bp), b1 = ldg32(bp + 8);
#pragma unroll
          for (int i = 0; i < 4; ++i)
            if (i < tiles) mma16816(acc[i][j], a[i], b0, b1);
        }
      }
    }
#pragma unroll
    for (int j = 0; j < kNT; ++j) {
      const int col = n0 + j * 8 + 2 * t;
      const float c0 = b[col], c1 = b[col + 1];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int o = (tile0 + i) * 16 + g + 8 * h;
          if (i < tiles && o < kPos) {
            *reinterpret_cast<uint32_t*>(dst + o * kLd + col) =
                pack_bf16(fmaxf(acc[i][j][2 * h] + c0, 0.0f),
                          fmaxf(acc[i][j][2 * h + 1] + c1, 0.0f));
          }
        }
      }
    }
  }
}

// part[o][chunk] = sum over the chunk's 32 channels of
// relu(src[o] @ wdec + bdec) * wsel, for the chunks warp w owns
// (chunk = w + 8 * ab: parity ab, channels [32w, 32w + 32)).
__device__ void deconv_select(const bf16* src, const bf16* __restrict__ wdec,
                              const float* __restrict__ bdec,
                              const float* wsel, float* part, int warp,
                              int g, int t) {
  for (int ab = 0; ab < 4; ++ab) {
    const int chunk = warp + kWarps * ab;
    const int n0 = chunk * kNT * 8;   // column of z (ab * C + channel)
    const int ch0 = warp * kNT * 8;   // channel
    for (int grp = 0; grp < kGroups; ++grp) {
      const int tile0 = grp * 4;
      const int tiles = min(4, kTiles - tile0);
      int off[4][2];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int o = (tile0 + i) * 16 + g + 8 * h;
          off[i][h] = (i < tiles && o < kPos) ? o * kLd : -1;
        }
      float acc[4][kNT][4];
      zero_acc(acc);
      const bf16* wt = wdec + (size_t)(n0 + g) * kC + 2 * t;
#pragma unroll 4
      for (int kk = 0; kk < kC; kk += 16) {
        uint32_t a[4][4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          if (i < tiles) load_a(a[i], src, off[i][0], off[i][1], kk + 2 * t);
#pragma unroll
        for (int j = 0; j < kNT; ++j) {
          const bf16* bp = wt + (size_t)j * 8 * kC + kk;
          const uint32_t b0 = ldg32(bp), b1 = ldg32(bp + 8);
#pragma unroll
          for (int i = 0; i < 4; ++i)
            if (i < tiles) mma16816(acc[i][j], a[i], b0, b1);
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        if (i >= tiles) continue;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float s = 0.0f;
#pragma unroll
          for (int j = 0; j < kNT; ++j) {
            const int col = j * 8 + 2 * t;
            s += fmaxf(acc[i][j][2 * h] + bdec[n0 + col], 0.0f) *
                     wsel[ch0 + col] +
                 fmaxf(acc[i][j][2 * h + 1] + bdec[n0 + col + 1], 0.0f) *
                     wsel[ch0 + col + 1];
          }
          s += __shfl_xor_sync(0xffffffffu, s, 1);
          s += __shfl_xor_sync(0xffffffffu, s, 2);
          const int o = (tile0 + i) * 16 + g + 8 * h;
          if (t == 0 && o < kPos) part[o * kChunks + chunk] = s;
        }
      }
    }
  }
}

__global__ void __launch_bounds__(kThreads, 1)
mask_head_kernel(Levels lv, const float* __restrict__ ys,
                 const float* __restrict__ xs, const int* __restrict__ level,
                 const uint8_t* __restrict__ valid, int rpi,
                 const bf16* __restrict__ wconv,
                 const float* __restrict__ bconv,
                 const bf16* __restrict__ wdec,
                 const float* __restrict__ bdec,
                 const float* __restrict__ kcls,
                 const float* __restrict__ bcls,
                 const int* __restrict__ class_ids, int num_classes,
                 float* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* act0 = reinterpret_cast<bf16*>(smem);
  bf16* act1 = reinterpret_cast<bf16*>(smem + kAct);
  float* wsel = reinterpret_cast<float*>(smem + 2 * kAct);
  float* sy = wsel + kC;
  float* sx = sy + kP;

  const int m = blockIdx.x;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int cls = min(max(class_ids[m], 0), num_classes - 1);
  for (int i = threadIdx.x; i < kC; i += kThreads)
    wsel[i] = __bfloat162float(__float2bfloat16_rn(kcls[cls * kC + i]));
  if (threadIdx.x < kP) {
    sy[threadIdx.x] = ys[m * kP + threadIdx.x];
    sx[threadIdx.x] = xs[m * kP + threadIdx.x];
  }
  __syncthreads();

  int l = valid[m] ? level[m] : -1;
  if (l > 3) l = -1;
  const int img = m / rpi;
  for (int i = threadIdx.x; i < kPos * (kC / 2); i += kThreads) {
    const int pos = i / (kC / 2), cp = i % (kC / 2);
    uint32_t v = 0u;
    if (l >= 0) {
      const Sample s = locate(lv, l, img, kC, sy[pos / kP], sx[pos % kP]);
      v = sample_pair(s, 2 * cp);
    }
    *reinterpret_cast<uint32_t*>(act0 + pos * kLd + 2 * cp) = v;
  }
  __syncthreads();

  bf16* src = act0;
  bf16* dst = act1;
  for (int layer = 0; layer < 4; ++layer) {
    conv3x3(src, dst, wconv + (size_t)layer * kC * 9 * kC, bconv + layer * kC,
            warp, g, t);
    __syncthreads();
    bf16* tmp = src;
    src = dst;
    dst = tmp;
  }

  float* part = reinterpret_cast<float*>(dst);  // [kPos][kChunks]
  deconv_select(src, wdec, bdec, wsel, part, warp, g, t);
  __syncthreads();

  const float bsel = bcls[cls];
  float* o = out + (size_t)m * 4 * kPos;
  for (int i = threadIdx.x; i < kPos * 4; i += kThreads) {
    const int pos = i / 4, ab = i % 4;
    float s = 0.0f;
#pragma unroll
    for (int q = 0; q < kWarps; ++q) s += part[pos * kChunks + ab * kWarps + q];
    const float logit = s + bsel;
    const int y = pos / kP, x = pos % kP;
    o[(2 * y + ab / 2) * 2 * kP + 2 * x + ab % 2] = 1.0f / (1.0f + expf(-logit));
  }
}

}  // namespace

extern "C" {

// f0..f3: (B, H_l, W_l, 256) bf16 levels; ys/xs (M, 14) f32; level (M,)
// int32; valid (M,) bool; wconv (4, 256, 2304) and wdec (1024, 256) bf16
// (transposed weights); bconv (4, 256), bdec (1024,), kcls (nc, 256),
// bcls (nc,) f32; class_ids (M,) int32; out (M, 28, 28) f32.
int mrt_roi_mask_head(const void* f0, const void* f1, const void* f2,
                      const void* f3, int h0, int w0, int h1, int w1, int h2,
                      int w2, int h3, int w3, int c, const void* ys,
                      const void* xs, const void* level, const void* valid,
                      int m, int rois_per_image, int p, const void* wconv,
                      const void* bconv, const void* wdec, const void* bdec,
                      const void* kcls, const void* bcls,
                      const void* class_ids, int num_classes, void* out,
                      void* stream) {
  if (m == 0) return 0;
  if (c != kC || p != kP || rois_per_image <= 0 || num_classes <= 0) {
    return (int)cudaErrorInvalidValue;
  }
  Levels lv{{(const bf16*)f0, (const bf16*)f1, (const bf16*)f2,
             (const bf16*)f3},
            {h0, h1, h2, h3},
            {w0, w1, w2, w3}};
  cudaError_t err = cudaFuncSetAttribute(
      mask_head_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)kSmem);
  if (err != cudaSuccess) return (int)err;
  mask_head_kernel<<<m, kThreads, kSmem, (cudaStream_t)stream>>>(
      lv, (const float*)ys, (const float*)xs, (const int*)level,
      (const uint8_t*)valid, rois_per_image, (const bf16*)wconv,
      (const float*)bconv, (const bf16*)wdec, (const float*)bdec,
      (const float*)kcls, (const float*)bcls, (const int*)class_ids,
      num_classes, (float*)out);
  return (int)cudaGetLastError();
}

}  // extern "C"
