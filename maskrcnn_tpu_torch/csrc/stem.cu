// K3: fused ResNet stem. conv1 7x7/2 (zero pad 3) with inference BN folded
// into bf16 weights and a float32 bias, ReLU, then the 3x3/2 TF-SAME
// max-pool (pad 0 left, 1 right). Only the pooled (B, H/4, W/4, 64) bf16
// map is written; the (B, H/2, W/2, 64) conv map never reaches memory.
//
// Replaces: maskrcnn_tpu/ops/stem_pallas.py::stem_pallas (pallas_call :197,
// kernel _stem_kernel :113, via apply_stem_pallas :230). The TPU kernel's
// 4x4 space-to-depth packing (stem_pallas.py:11-23) is a Mosaic lane-layout
// device and is not carried over.
//
// What bounds it on an H100: bytes (the f32 image in and the pooled bf16
// map out, 21 MB per 1024^2 image, against 4.9 GFLOP that the bf16 tensor
// cores do in a tenth of the time the bytes take). On the float32 CUDA
// cores the same conv is 3x over the bytes bound even at their peak, so the
// conv runs on the tensor cores. What holds it back now is shared-memory
// traffic per tile (A fragments, wgmma's B reads, the conv tile written and
// read by the pool: PERF.md).
//
// Design: an implicit GEMM per 12 x 7 tile of pooled outputs, M = the
// tile's 25 x 15 conv positions (375, six 64-row tiles, three for each of
// the block's two warpgroups), N = 64 channels, K = the 7x7x3 taps ordered
// (dy, dx, c) and padded to 22 per dy (21 taps and a zero), 154 padded to
// 160: 10 steps of wgmma m64n64k16, bf16 in, float32 out.
//  * Each step's 16-term product goes to a fresh accumulator (scale-d 0)
//    and joins the running float32 sum in an FADD, which rounds to nearest.
//    The tensor core's own accumulation (d += A * B) rounds its result
//    toward zero: over 10 steps that leaned the kernel's outputs down
//    against its float32 plain version, 20 elements below the float64
//    reference for each one above, and doubled its mean error (PERF.md).
//    The steps run one after another: a second partial accumulator to
//    overlap them would pass the 128 registers a thread of two blocks per
//    SM may hold.
//  * A comes from registers, loaded straight from the staged bf16 input
//    patch (55 rows of 35 pixels x 3 channels, row stride 106 elements): for
//    a fixed dy the 21 (dx, c) values of conv position (r, q) are contiguous
//    at patch[2r + dy][6q ..]. With 22 taps per dy and an even row stride,
//    every (k, k+1) pair of a fragment sits at an even element of one row:
//    one 32-bit shared load per fragment register (mma.m16n8k16's A layout,
//    which wgmma's register A shares). Their 12-byte row starts suit
//    neither ldmatrix nor a wgmma descriptor; an im2col tile that would
//    suit them cost more to write than it saved (PERF.md). The A
//    registers of a k step are kept until the wait that retires it.
//  * B is the folded kernel, repacked to the padded K layout ([160][64]
//    bf16, 20 KB, 128-byte swizzled as TMA would write it) once per
//    persistent block, and read by wgmma in its transposed-B mode.
//  * The patch comes in as 16-byte cp.async copies of the raw f32 rows
//    (55 x 108 floats), the next tile's issued before this tile's products
//    so that their latency hides behind them. W % 4 == 0 puts every image
//    row on a 16-byte boundary, so each copy lies in one row or wholly
//    outside the image (zero-filled: conv1's pad 3). One pass then rounds
//    the raw rows to the bf16 patch, as the plain version rounds the image.
//  * Epilogue in registers: bias, ReLU, conv positions past the grid set to
//    0 (post-ReLU values are >= 0, so a zero never beats the window max:
//    the SAME pool's -inf padding), bf16 rounding, into a [375][72] conv
//    tile. Rounding is monotone, so pooling the rounded values equals
//    rounding the pooled float32 value. The 3x3/2 pool reads 16-byte rows
//    of the tile (8 channels, __hmax2) and writes 16-byte stores, 64
//    channels per pixel.
//  * Persistent: as many 256-thread blocks as fit (two per SM, 109 KB and
//    at most 128 registers a thread) walk the tiles, so weights are staged
//    once per block and one block's passes overlap the other's products.
//    The tile recomputes 1.12x the conv positions (8 x 7: 1.14x and more
//    passes per output; 16 x 7 leaves one block per SM).
//  * Edge tiles: any H, W divisible by 4; pooled outputs past (H/4, W/4)
//    are not written.

#include "head_gemm.cuh"

namespace {

using namespace mrt;

constexpr int kTileH = 12, kTileW = 7;    // pooled outputs per tile
constexpr int kConvH = 2 * kTileH + 1;    // conv positions (25 x 15)
constexpr int kConvW = 2 * kTileW + 1;
constexpr int kIn = 2 * (kConvH - 1) + 7; // input patch rows (55)
constexpr int kInW = 2 * (kConvW - 1) + 7;  // input patch pixels a row (35)
constexpr int kRow = 3 * kInW + 1;        // patch row stride (105 + 1 zero)
constexpr int kChunks = (3 * kInW + 3 + 3) / 4;  // float4 copies a row (27)
constexpr int kRaw = 4 * kChunks;         // raw f32 row stride (108)
constexpr int kPos = kConvH * kConvW;     // 375 conv positions
constexpr int kM64 = (kPos + 63) / 64;    // 64-row M tiles (6, 3 a WG)
constexpr int kKDy = 22;                  // K per dy: 21 taps + 1 zero
constexpr int kKUsed = 7 * kKDy;          // 154
constexpr int kK = 160;                   // padded to 10 k16 steps
constexpr int kCo = 64;
constexpr int kLd = kCo + 8;              // conv tile row stride
constexpr int kThreads = 256;

constexpr size_t kRawBytes = (size_t)kIn * kRaw * 4;
constexpr size_t kPatchBytes = (kIn * kRow * 2 + 15) / 16 * 16;
constexpr size_t kBBytes = (size_t)kK * kCo * 2;   // 128-byte rows
constexpr size_t kConvBytes = (size_t)kPos * kLd * 2;
constexpr size_t kSmem = 1024 + kBBytes + kRawBytes + kPatchBytes +
                        kConvBytes + kCo * sizeof(float);

// d (64 x 64 float32, this thread's 32) = A (64 x 16, this warp's 16 rows
// in registers, mma.m16n8k16's A layout) * B (16 x 64, N-major, from shared
// memory, 128-byte swizzled): the warpgroup's m64n64k16, B transposed,
// scale-d 0 (d is written, not read).
__device__ __forceinline__ void wgmma_64(float (&d)[32],
                                         const uint32_t (&a)[4],
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(0));
}

// Keeps registers an asynchronous wgmma reads alive (and unmoved) until
// after the wait that retires it.
__device__ __forceinline__ void keep(uint32_t (&r)[4]) {
#pragma unroll
  for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[j])::"memory");
}

// Patch offset of K index k (even) relative to a position's first element:
// tap row dy = k / 22, (dx, c) = k % 22; the padded K past 154 reads
// element 0 (its weight is 0).
__device__ __forceinline__ int k_offset(int k) {
  const int dy = k / kKDy;
  return k < kKUsed ? dy * kRow + (k - dy * kKDy) : 0;
}

// Patch offset of conv position p (clamped into the tile) of the tile.
__device__ __forceinline__ int pos_offset(int p) {
  p = min(p, kPos - 1);
  const int cr = p / kConvW, cc = p - (p / kConvW) * kConvW;
  return 2 * cr * kRow + 6 * cc;
}

__global__ void __launch_bounds__(kThreads, 2)
stem_kernel(const float* __restrict__ img, const bf16* __restrict__ w,
            const float* __restrict__ bias, bf16* __restrict__ out, int nb,
            int h, int wd) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~(uintptr_t)1023);
  bf16* wb = reinterpret_cast<bf16*>(smem);            // 1024-byte aligned
  const float* raw = reinterpret_cast<const float*>(smem + kBBytes);
  bf16* patch = reinterpret_cast<bf16*>(smem + kBBytes + kRawBytes);
  bf16* conv =
      reinterpret_cast<bf16*>(smem + kBBytes + kRawBytes + kPatchBytes);
  float* bias_s = reinterpret_cast<float*>(smem + kBBytes + kRawBytes +
                                           kPatchBytes + kConvBytes);
  const uint32_t raws = smem_u32(raw), wbs = smem_u32(wb);

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int gq = lane >> 2, tq = lane & 3;
  const int wg = warp >> 2, wq = warp & 3;  // warpgroup, warp in it
  const int hc = h / 2, wc = wd / 2;        // conv grid
  const int ho = h / 4, wo = wd / 4;        // pooled grid
  const int tiles_x = (wo + kTileW - 1) / kTileW;
  const int tiles_y = (ho + kTileH - 1) / kTileH;
  const int tiles = nb * tiles_x * tiles_y;
  const int row_len = wd * 3;               // floats per image row

  // B: row k of the padded K layout = folded tap (dy, k % 22) or zeros.
  for (int i = tid; i < kK * 8; i += kThreads) {
    const int k = i >> 3, c8 = i & 7;
    const int dy = k / kKDy, j = k - dy * kKDy;
    uint4 v = make_uint4(0, 0, 0, 0);
    if (k < kKUsed && j < 21) {
      v = __ldg(reinterpret_cast<const uint4*>(w + (dy * 21 + j) * kCo) + c8);
    }
    // 128-byte swizzle: 16-byte chunk c8 of row k at chunk c8 ^ (k % 8)
    *reinterpret_cast<uint4*>(wb + k * kCo + ((c8 ^ (k & 7)) * 8)) = v;
  }
  for (int i = tid; i < kIn; i += kThreads) {
    patch[i * kRow + kRow - 1] = __float2bfloat16_rn(0.0f);
  }
  if (tid < kCo) bias_s[tid] = bias[tid];

  // The patch of tile t as raw f32 rows, 16 bytes a copy, asynchronous:
  // out-of-image copies zero-fill (conv1's pad 3).
  auto fetch = [&](int t) {
    const int pc0 = (t % tiles_x) * kTileW;
    const int iy0 = 4 * ((t / tiles_x) % tiles_y) * kTileH - 3;
    const float* im = img + (size_t)(t / (tiles_x * tiles_y)) * h * row_len;
    for (int i = tid; i < kIn * kChunks; i += kThreads) {
      const int py = i / kChunks, ch = i - py * kChunks;
      const int gy = iy0 + py;
      const int e = 12 * pc0 - 12 + 4 * ch;   // row element of the float4
      const bool ok = gy >= 0 && gy < h && e >= 0 && e < row_len;
      cp_async16(raws + (py * kRaw + 4 * ch) * 4,
                 ok ? im + (size_t)gy * row_len + e : img, ok);
    }
    cp_async_commit();
  };
  if (blockIdx.x < tiles) fetch(blockIdx.x);

  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int tx = tile % tiles_x;
    const int ty = (tile / tiles_x) % tiles_y;
    const int b = tile / (tiles_x * tiles_y);
    const int pr0 = ty * kTileH, pc0 = tx * kTileW;

    // ---- the fetched patch, rounded to bf16; then fetch the next tile's
    cp_async_wait<0>();
    __syncthreads();
    for (int i = tid; i < kIn * kChunks; i += kThreads) {
      const int py = i / kChunks, ch = i - py * kChunks;
      const float4 v = *reinterpret_cast<const float4*>(raw + py * kRaw +
                                                        4 * ch);
      bf16* dst = patch + py * kRow + 4 * ch - 3;
      if (ch > 0) dst[0] = __float2bfloat16_rn(v.x);
      if (ch > 0) dst[1] = __float2bfloat16_rn(v.y);
      if (ch > 0) dst[2] = __float2bfloat16_rn(v.z);
      dst[3] = __float2bfloat16_rn(v.w);
    }
    __syncthreads();
    if (tile + gridDim.x < tiles) fetch(tile + gridDim.x);
    // ---- conv: implicit GEMM on wgmma, warpgroup g takes the 64-row M
    // tiles g, g + 2, ..., warp q of it rows 16q..16q+15 of each
#pragma unroll 1
    for (int mt = wg; mt < kM64; mt += 2) {
      float acc[32], part[32];
#pragma unroll
      for (int r = 0; r < 32; ++r) acc[r] = 0.0f;
      const int row0 = 64 * mt + 16 * wq + gq;
      const int base0 = pos_offset(row0), base1 = pos_offset(row0 + 8);
      uint32_t a[4];
#pragma unroll
      for (int ks = 0; ks < kK / 16; ++ks) {
        const int o0 = k_offset(16 * ks + 2 * tq);
        const int o1 = k_offset(16 * ks + 2 * tq + 8);
        a[0] = lds32(patch + base0 + o0);
        a[1] = lds32(patch + base1 + o0);
        a[2] = lds32(patch + base0 + o1);
        a[3] = lds32(patch + base1 + o1);
        wgmma_fence();
        wgmma_64(part, a, sw128_desc(wbs + ks * 2048, 8192, 1024));
        wgmma_commit();
        wgmma_wait<0>();
        keep(a);
        // the step's sum joins the running one in a round-to-nearest add
#pragma unroll
        for (int r = 0; r < 32; ++r) {
          asm volatile("" : "+f"(part[r])::"memory");
          acc[r] += part[r];
        }
      }
      // epilogue: bias, ReLU, zero past the conv grid, bf16 into the tile
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int p = row0 + 8 * hh;
        if (p >= kPos) continue;
        const int r = 2 * pr0 + p / kConvW, q = 2 * pc0 + p % kConvW;
        const bool inside = r < hc && q < wc;
#pragma unroll
        for (int n = 0; n < 8; ++n) {
          const int col = 8 * n + 2 * tq;
          const float2 bb = *reinterpret_cast<const float2*>(bias_s + col);
          float v0 = fmaxf(acc[4 * n + 2 * hh] + bb.x, 0.0f);
          float v1 = fmaxf(acc[4 * n + 2 * hh + 1] + bb.y, 0.0f);
          if (!inside) v0 = v1 = 0.0f;
          *reinterpret_cast<uint32_t*>(conv + p * kLd + col) =
              pack_bf16(v0, v1);
        }
      }
    }
    __syncthreads();

    // ---- pool 3x3/2 from the conv tile, 8 channels (16 B) a thread
    for (int i = tid; i < kTileH * kTileW * 8; i += kThreads) {
      const int pix = i >> 3, c8 = i & 7;
      const int pr = pix / kTileW, pc = pix - (pix / kTileW) * kTileW;
      if (pr0 + pr >= ho || pc0 + pc >= wo) continue;
      const bf16* src = conv + ((2 * pr) * kConvW + 2 * pc) * kLd + 8 * c8;
      uint4 m = *reinterpret_cast<const uint4*>(src);
      __nv_bfloat162* mv = reinterpret_cast<__nv_bfloat162*>(&m);
#pragma unroll
      for (int a = 0; a < 3; ++a) {
#pragma unroll
        for (int bb = 0; bb < 3; ++bb) {
          const uint4 v = *reinterpret_cast<const uint4*>(
              src + (a * kConvW + bb) * kLd);
          const __nv_bfloat162* vv =
              reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
          for (int j = 0; j < 4; ++j) mv[j] = __hmax2(mv[j], vv[j]);
        }
      }
      *reinterpret_cast<uint4*>(
          out + (((size_t)b * ho + pr0 + pr) * wo + pc0 + pc) * kCo +
          8 * c8) = m;
    }
  }
}

}  // namespace

extern "C" {

// img (B, H, W, 3) f32, w (7, 7, 3, 64) bf16 folded, bias (64,) f32, out
// (B, H/4, W/4, 64) bf16; img, w and out 16-byte aligned, bias 8.
int mrt_stem(const void* img, const void* w, const void* bias, void* out,
             int b, int h, int wd, void* stream) {
  if (h % 4 || wd % 4 || (uintptr_t)img % 16 || (uintptr_t)w % 16 ||
      (uintptr_t)bias % 8 || (uintptr_t)out % 16) {
    return (int)cudaErrorInvalidValue;
  }
  if (b == 0) return 0;
  // The persistent grid: as many blocks as fit, worked out once per device
  // (the attribute call and the occupancy query cost more host time than
  // the kernel takes).
  static int grid_dev = -1, grid_max = 0;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev != grid_dev) {
    int sms = 0, per_sm = 0;
    err = cudaFuncSetAttribute(
        stem_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSmem);
    if (err == cudaSuccess) {
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    }
    if (err == cudaSuccess) {
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, stem_kernel,
                                                          kThreads, kSmem);
    }
    if (err != cudaSuccess) return (int)err;
    grid_max = sms * per_sm;
    grid_dev = dev;
  }
  const long tiles = (long)b * ((h / 4 + kTileH - 1) / kTileH) *
                     ((wd / 4 + kTileW - 1) / kTileW);
  const int grid = (int)(tiles < grid_max ? tiles : grid_max);
  stem_kernel<<<grid, kThreads, kSmem, (cudaStream_t)stream>>>(
      (const float*)img, (const bf16*)w, (const float*)bias, (bf16*)out, b,
      h, wd);
  return (int)cudaGetLastError();
}

}  // extern "C"
