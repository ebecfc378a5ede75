// K4: one stride-1 ResNet bottleneck block, fused: 1x1 -> 3x3 SAME -> 1x1,
// BN folded into bf16 weights and float32 biases, identity or projection
// shortcut, ReLU. The chain wrapper (ops/bottleneck_cuda.py) launches it
// once per block of the chain.
//
// Replaces: maskrcnn_tpu/ops/bottleneck_pallas.py::fused_bottleneck_chain
// (pallas_call :213, kernel _chain_kernel :80, fold_bottleneck_chain :40).
// Difference from the TPU kernel: that one ran the whole chain (res2 a-c,
// res3 b-d) in one call and wrote only the chain's output; this one writes
// each block's output, so a 3-block chain sends two intermediate maps
// through device memory. Fusing the chain is later work.
//
// What bounds it on an H100: operations (28 GFLOP per image and chain at
// 1024^2 against ~100 MB moved). This first version uses the tensor cores
// through the warp-level WMMA API (bf16 16x16x16 tiles, float32
// accumulation) with weight fragments read straight from device memory
// (they stay in L2), no wgmma and no TMA, so it sits well below the
// card's bf16 peak.
//
// Design: one block of 8 warps per 8x16 tile of output pixels.
//  1. t1 = relu(x @ w1 + b1) on the tile plus its one-pixel halo (10x18 =
//     180 positions, padded to 192 rows), contracting over Cin in chunks of
//     64 channels staged in shared memory; halo positions outside the image
//     are set to zero: the 3x3's SAME padding (_chain_kernel:126-132).
//  2. t2 = relu(conv3x3(t1) + b2): warp w owns output row w (16 pixels),
//     and for tap (dy, dx) its A operand is 16 consecutive t1 positions,
//     ((w + dy) * 18 + dx), one strided shared-memory fragment.
//  3. out = relu((t2 @ w3 + b3) + shortcut), shortcut = x @ ws + bs (A read
//     from device memory) or x, in column chunks of 64.
// t1 and t2 stay in shared memory as bf16. Every epilogue goes through a
// per-warp 16x16 float32 scratch so bias, ReLU, masking and rounding are
// applied per element in the plain version's order.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kTH = 8, kTW = 16;            // output tile
constexpr int kHW = kTW + 2;                // halo width (18)
constexpr int kHP = (kTH + 2) * kHW;        // halo positions (180)
constexpr int kHPP = 192;                   // padded to 16-row fragments
constexpr int kKC = 64;                     // Cin chunk of stage 1
constexpr int kLdX = kKC + 16;              // staged-x row stride (elements)
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;

using FragA = wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major>;
using FragB = wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major>;
using FragC = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;

template <int M>
struct Layout {
  static constexpr int kLdT = M + 16;       // t1/t2 row stride (32 B multiple)
  static constexpr size_t kT1 = (size_t)kHPP * kLdT * sizeof(bf16);
  static constexpr size_t kX = (size_t)kHPP * kLdX * sizeof(bf16);
  static constexpr size_t kT2 = (size_t)kTH * kTW * kLdT * sizeof(bf16);
  static constexpr size_t kXT2 = kX > kT2 ? kX : kT2;  // x chunk / t2 alias
  static constexpr size_t kScratch = (size_t)kWarps * 2 * 256 * sizeof(float);
  static constexpr size_t kTotal = kT1 + kXT2 + kScratch;
};

template <int M>
__global__ void __launch_bounds__(kThreads)
bottleneck_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w1,
                  const float* __restrict__ b1, const bf16* __restrict__ w2,
                  const float* __restrict__ b2, const bf16* __restrict__ w3,
                  const float* __restrict__ b3, const bf16* __restrict__ ws,
                  const float* __restrict__ bs, bf16* __restrict__ out, int h,
                  int wd, int cin, int cout, int proj) {
  using L = Layout<M>;
  constexpr int kLdT = L::kLdT;
  constexpr int kNF = M / 16;               // column fragments of M
  constexpr int kNT1 = (kHPP / 16) * kNF / kWarps;  // stage-1 tiles per warp

  extern __shared__ __align__(128) unsigned char smem[];
  bf16* t1 = reinterpret_cast<bf16*>(smem);
  bf16* xs = reinterpret_cast<bf16*>(smem + L::kT1);
  bf16* t2 = xs;  // x chunks are dead once stage 1 is done
  float* scratch = reinterpret_cast<float*>(smem + L::kT1 + L::kXT2);

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float* sa = scratch + warp * 512;
  float* sb = sa + 256;
  const int b = blockIdx.z;
  const int y0 = blockIdx.y * kTH, x0 = blockIdx.x * kTW;
  const bf16* xb = x + (size_t)b * h * wd * cin;

  // ---- stage 1: t1 over the halo tile ------------------------------------
  FragC acc1[kNT1];
#pragma unroll
  for (int i = 0; i < kNT1; ++i) wmma::fill_fragment(acc1[i], 0.0f);

  for (int kc = 0; kc < cin; kc += kKC) {
    __syncthreads();
    // 8 x 16-byte pieces per position and chunk.
    for (int i = threadIdx.x; i < kHPP * 8; i += kThreads) {
      const int pos = i / 8, piece = i % 8;
      const int gy = y0 - 1 + pos / kHW, gx = x0 - 1 + pos % kHW;
      uint4 v = make_uint4(0, 0, 0, 0);
      if (pos < kHP && gy >= 0 && gy < h && gx >= 0 && gx < wd) {
        v = *reinterpret_cast<const uint4*>(
            xb + ((size_t)gy * wd + gx) * cin + kc + piece * 8);
      }
      *reinterpret_cast<uint4*>(xs + pos * kLdX + piece * 8) = v;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kKC / 16; ++kk) {
#pragma unroll
      for (int i = 0; i < kNT1; ++i) {
        const int t = warp + kWarps * i;
        const int rf = t / kNF, cf = t % kNF;
        FragA a;
        FragB bm;
        wmma::load_matrix_sync(a, xs + rf * 16 * kLdX + kk * 16, kLdX);
        wmma::load_matrix_sync(bm, w1 + (size_t)(kc + kk * 16) * M + cf * 16,
                               M);
        wmma::mma_sync(acc1[i], a, bm, acc1[i]);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < kNT1; ++i) {
    const int t = warp + kWarps * i;
    const int rf = t / kNF, cf = t % kNF;
    wmma::store_matrix_sync(sa, acc1[i], 16, wmma::mem_row_major);
    __syncwarp();
    for (int e = lane; e < 256; e += 32) {
      const int pos = rf * 16 + e / 16, col = cf * 16 + e % 16;
      const int gy = y0 - 1 + pos / kHW, gx = x0 - 1 + pos % kHW;
      float v = fmaxf(sa[e] + b1[col], 0.0f);
      if (pos >= kHP || gy < 0 || gy >= h || gx < 0 || gx >= wd) v = 0.0f;
      t1[pos * kLdT + col] = __float2bfloat16_rn(v);
    }
    __syncwarp();
  }
  __syncthreads();

  // ---- stage 2: t2 = relu(conv3x3(t1) + b2), warp = output row -----------
  {
    FragC acc2[kNF];
#pragma unroll
    for (int j = 0; j < kNF; ++j) wmma::fill_fragment(acc2[j], 0.0f);
    for (int tap = 0; tap < 9; ++tap) {
      const int dy = tap / 3, dx = tap % 3;
      const bf16* arow = t1 + ((warp + dy) * kHW + dx) * kLdT;
      const bf16* wt = w2 + (size_t)tap * M * M;
#pragma unroll
      for (int kk = 0; kk < kNF; ++kk) {
        FragA a;
        wmma::load_matrix_sync(a, arow + kk * 16, kLdT);
#pragma unroll
        for (int j = 0; j < kNF; ++j) {
          FragB bm;
          wmma::load_matrix_sync(bm, wt + (size_t)kk * 16 * M + j * 16, M);
          wmma::mma_sync(acc2[j], a, bm, acc2[j]);
        }
      }
    }
#pragma unroll
    for (int j = 0; j < kNF; ++j) {
      wmma::store_matrix_sync(sa, acc2[j], 16, wmma::mem_row_major);
      __syncwarp();
      for (int e = lane; e < 256; e += 32) {
        const int r = e / 16, col = j * 16 + e % 16;
        t2[(warp * 16 + r) * kLdT + col] =
            __float2bfloat16_rn(fmaxf(sa[e] + b2[col], 0.0f));
      }
      __syncwarp();
    }
  }
  // t2 rows of this warp are written and read by this warp only.
  __syncwarp();

  // ---- stage 3: out = relu((t2 @ w3 + b3) + shortcut) -------------------
  const int gy = y0 + warp;
  const size_t pix0 = ((size_t)b * h + gy) * wd + x0;  // first pixel of row
  for (int nc = 0; nc < cout; nc += 64) {
    FragC acc3[4], accs[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      wmma::fill_fragment(acc3[j], 0.0f);
      wmma::fill_fragment(accs[j], 0.0f);
    }
#pragma unroll
    for (int kk = 0; kk < kNF; ++kk) {
      FragA a;
      wmma::load_matrix_sync(a, t2 + warp * 16 * kLdT + kk * 16, kLdT);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        FragB bm;
        wmma::load_matrix_sync(bm, w3 + (size_t)kk * 16 * cout + nc + j * 16,
                               cout);
        wmma::mma_sync(acc3[j], a, bm, acc3[j]);
      }
    }
    if (proj) {
      for (int kk = 0; kk < cin / 16; ++kk) {
        FragA a;
        wmma::load_matrix_sync(a, x + pix0 * cin + kk * 16, cin);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          FragB bm;
          wmma::load_matrix_sync(
              bm, ws + (size_t)kk * 16 * cout + nc + j * 16, cout);
          wmma::mma_sync(accs[j], a, bm, accs[j]);
        }
      }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      wmma::store_matrix_sync(sa, acc3[j], 16, wmma::mem_row_major);
      if (proj) wmma::store_matrix_sync(sb, accs[j], 16, wmma::mem_row_major);
      __syncwarp();
      for (int e = lane; e < 256; e += 32) {
        const int r = e / 16, col = nc + j * 16 + e % 16;
        const size_t pix = pix0 + r;
        const float t3 = sa[e] + b3[col];
        const float sh = proj ? sb[e] + bs[col]
                              : __bfloat162float(x[pix * cin + col]);
        out[pix * cout + col] = __float2bfloat16_rn(fmaxf(t3 + sh, 0.0f));
      }
      __syncwarp();
    }
  }
}

template <int M>
int launch(const void* x, const void* w1, const void* b1, const void* w2,
           const void* b2, const void* w3, const void* b3, const void* ws,
           const void* bs, void* out, int b, int h, int wd, int cin,
           int cout, int proj, cudaStream_t st) {
  const size_t smem = Layout<M>::kTotal;
  cudaError_t err = cudaFuncSetAttribute(
      bottleneck_kernel<M>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(wd / kTW, h / kTH, b);
  bottleneck_kernel<M><<<grid, kThreads, smem, st>>>(
      (const bf16*)x, (const bf16*)w1, (const float*)b1, (const bf16*)w2,
      (const float*)b2, (const bf16*)w3, (const float*)b3, (const bf16*)ws,
      (const float*)bs, (bf16*)out, h, wd, cin, cout, proj);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// x (B, H, W, Cin) bf16; w1 (Cin, M), w2 (9, M, M), w3 (M, Cout), ws
// (Cin, Cout) bf16; b1 (M,), b2 (M,), b3 (Cout,), bs (Cout,) f32; out
// (B, H, W, Cout) bf16. ws/bs are read only when proj != 0.
int mrt_bottleneck(const void* x, const void* w1, const void* b1,
                   const void* w2, const void* b2, const void* w3,
                   const void* b3, const void* ws, const void* bs, void* out,
                   int b, int h, int wd, int cin, int m, int cout, int proj,
                   void* stream) {
  if (h % kTH || wd % kTW || cin % kKC || cout % 64 ||
      (proj && (ws == nullptr || bs == nullptr)) || (!proj && cin != cout)) {
    return (int)cudaErrorInvalidValue;
  }
  if (b == 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  if (m == 64)
    return launch<64>(x, w1, b1, w2, b2, w3, b3, ws, bs, out, b, h, wd, cin,
                      cout, proj, st);
  if (m == 128)
    return launch<128>(x, w1, b1, w2, b2, w3, b3, ws, bs, out, b, h, wd, cin,
                       cout, proj, st);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
