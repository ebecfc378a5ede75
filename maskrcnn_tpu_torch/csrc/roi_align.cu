// K2: pyramid ROIAlign, plain mode (tf crop_and_resize bilinear sampling
// on each ROI's FPN level).
//
// Replaces: maskrcnn_tpu/ops/roi_align_pallas.py::pyramid_roi_align_pallas
// without head fusion (pallas_call :716, kernel _kernel :279, prep _prepare
// :222 and _axis_slots :200). K5 and K6 run this kernel as their pool pass
// (mrt_roi_align).
//
// What bounds it on an H100: bytes. Each output value reads four corner
// values and blends them with a handful of flops (~4 flops per byte moved
// at bf16, far below the ~295 flops/byte where the tensor cores would
// limit). The least traffic is one pass over the pyramid cells the ROIs
// sample plus the pooled output (25 MB per image at pool 7 x 1000 ROIs).
// In practice it is bound by latency: every sample is four dependent-free
// gathers whose addresses come from the sample positions, so the kernel
// has to keep many of them in flight.
//
// Design:
//  * Level choice and sample positions come from the caller
//    (ops/roi_align.py::prepare, computed in torch and shared with the plain
//    version), so kernel and plain version pick the same level for every ROI
//    whatever the device's log2. The four levels come in as four pointers;
//    nothing stacks or pads the pyramid.
//  * A block takes `rows` output rows of one ROI (all P rows where there
//    are enough ROIs to fill the card: 1 block per ROI at 2 x 1000; P = 14
//    at 2 x 100 splits into 7 blocks of 2 rows, 1400 blocks in all). It
//    first reads the rows' ys and the ROI's xs once, coalesced, and keeps
//    each row's and column's corner offsets, weight and in-range flag in
//    shared memory, so no gather waits on a position load.
//  * Work items are (sample, 16-byte chunk of channels): at C = 256 bf16 one
//    warp carries one sample (32 lanes x 8 channels), in f32 two chunks a
//    lane. Each thread takes kUnroll = 2 items at once and issues all
//    their corner loads (4 x 16 B each) before it blends any: 256 threads x
//    2 items x 64 B in flight per block, 4 blocks per SM (64 registers a
//    thread; 4 items a thread were slower: PERF.md).
//  * Where C x element size is not a multiple of 16 bytes (or a pointer is
//    not 16-byte aligned), chunks are one channel pair (4 or 8 bytes): any
//    even C.
//  * Blends in float32 with each operation rounded on its own, in the order
//    of the plain version (x first, then y), then rounds once to the output
//    type: the output equals the plain version's. Out-of-range samples and
//    invalid ROIs write zeros. Stores are the same chunks, 16 B a lane.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 2;

__device__ __forceinline__ float lerp_rn(float a, float b, float w) {
  // a * (1 - w) + b * w, each operation rounded on its own.
  return __fadd_rn(__fmul_rn(a, __fsub_rn(1.0f, w)), __fmul_rn(b, w));
}

struct Levels {
  const void* f[4];
  int h[4];
  int w[4];
};

// One axis of the sample grid: corner offsets (elements) on the level, the
// weight of the second corner, and whether the position is in range.
struct Axis {
  int o0, o1;
  float w;
  int in;
};

// V bytes of channels as 32-bit words.
template <int V>
struct Chunk {
  uint32_t w[V / 4];
};

template <int V>
__device__ __forceinline__ Chunk<V> load(const void* p) {
  Chunk<V> c;
  if constexpr (V == 16) {
    const uint4 v = __ldg(reinterpret_cast<const uint4*>(p));
    c.w[0] = v.x, c.w[1] = v.y, c.w[2] = v.z, c.w[3] = v.w;
  } else if constexpr (V == 8) {
    const uint2 v = __ldg(reinterpret_cast<const uint2*>(p));
    c.w[0] = v.x, c.w[1] = v.y;
  } else {
    c.w[0] = __ldg(reinterpret_cast<const unsigned int*>(p));
  }
  return c;
}

template <int V>
__device__ __forceinline__ void store(void* p, const Chunk<V>& c) {
  if constexpr (V == 16) {
    *reinterpret_cast<uint4*>(p) = make_uint4(c.w[0], c.w[1], c.w[2], c.w[3]);
  } else if constexpr (V == 8) {
    *reinterpret_cast<uint2*>(p) = make_uint2(c.w[0], c.w[1]);
  } else {
    *reinterpret_cast<uint32_t*>(p) = c.w[0];
  }
}

__device__ __forceinline__ float blend(float v00, float v01, float v10,
                                       float v11, float wx, float wy) {
  return lerp_rn(lerp_rn(v00, v01, wx), lerp_rn(v10, v11, wx), wy);
}

// One 32-bit word of each corner -> the blended word.
template <typename T>
__device__ __forceinline__ uint32_t blend_word(uint32_t a, uint32_t b,
                                               uint32_t c, uint32_t d,
                                               float wx, float wy) {
  if constexpr (sizeof(T) == 2) {
    const float2 v00 = __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&a));
    const float2 v01 = __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&b));
    const float2 v10 = __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&c));
    const float2 v11 = __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&d));
    __nv_bfloat162 r = __floats2bfloat162_rn(
        blend(v00.x, v01.x, v10.x, v11.x, wx, wy),
        blend(v00.y, v01.y, v10.y, v11.y, wx, wy));
    return *reinterpret_cast<uint32_t*>(&r);
  } else {
    return __float_as_uint(blend(__uint_as_float(a), __uint_as_float(b),
                                 __uint_as_float(c), __uint_as_float(d), wx,
                                 wy));
  }
}

template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
roi_align_kernel(Levels lv, int c, const float* __restrict__ ys,
                 const float* __restrict__ xs, const int* __restrict__ level,
                 const uint8_t* __restrict__ valid, int rois_per_image, int p,
                 int rows, T* __restrict__ out) {
  constexpr int E = V / (int)sizeof(T);     // channels per chunk
  extern __shared__ Axis axes[];            // [nr] then [p]
  const int m = blockIdx.x;
  const int py0 = blockIdx.y * rows;
  const int nr = min(rows, p - py0);
  const Axis* ay = axes;
  const Axis* ax = axes + nr;
  const int chunks = c / E;
  const int items = nr * p * chunks;
  T* o = out + ((size_t)m * p + py0) * p * c;
  const int l = level[m];
  if (!valid[m] || l < 0 || l > 3) {
    const Chunk<V> zero{};
    for (int i = threadIdx.x; i < items; i += kThreads) {
      store<V>(o + (size_t)i * E, zero);
    }
    return;
  }
  // a select, not lv.f[l]: indexing the parameter by l would copy it to
  // local memory
  const int fh = l == 0 ? lv.h[0] : l == 1 ? lv.h[1] : l == 2 ? lv.h[2]
                                                               : lv.h[3];
  const int fw = l == 0 ? lv.w[0] : l == 1 ? lv.w[1] : l == 2 ? lv.w[2]
                                                               : lv.w[3];
  const void* fl = l == 0 ? lv.f[0] : l == 1 ? lv.f[1] : l == 2 ? lv.f[2]
                                                                : lv.f[3];
  const T* f = static_cast<const T*>(fl) +
               (size_t)(m / rois_per_image) * fh * fw * c;
  const float fh1 = (float)(fh - 1), fw1 = (float)(fw - 1);
  for (int i = threadIdx.x; i < nr + p; i += kThreads) {
    const bool is_y = i < nr;
    const float v = is_y ? ys[m * p + py0 + i] : xs[m * p + i - nr];
    const float hi = is_y ? fh1 : fw1;
    const float v0 = floorf(v);
    Axis a;
    a.w = __fsub_rn(v, v0);
    const int i0 = (int)fminf(fmaxf(v0, 0.0f), hi);
    const int i1 = min(i0 + 1, (int)hi);
    a.in = v >= 0.0f && v <= hi;
    const int stride = is_y ? fw * c : c;
    a.o0 = i0 * stride;
    a.o1 = i1 * stride;
    if (!is_y && i1 <= i0) a.w = 0.0f;      // both x corners the same cell
    axes[i] = a;
  }
  __syncthreads();

  for (int i0 = threadIdx.x; i0 < items; i0 += kThreads * kUnroll) {
    Chunk<V> v[kUnroll][4];
    float wx[kUnroll], wy[kUnroll];
    bool live[kUnroll];
    // every item's corner loads first ...
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int it = i0 + u * kThreads;
      const int s = it / chunks;
      const int ch = (it - s * chunks) * E;
      const int r = s / p;
      const Axis a = ay[min(r, nr - 1)], b = ax[s - r * p];
      live[u] = it < items && a.in && b.in;
      wx[u] = b.w;
      wy[u] = a.w;
      if (live[u]) {
        v[u][0] = load<V>(f + a.o0 + b.o0 + ch);
        v[u][1] = load<V>(f + a.o0 + b.o1 + ch);
        v[u][2] = load<V>(f + a.o1 + b.o0 + ch);
        v[u][3] = load<V>(f + a.o1 + b.o1 + ch);
      }
    }
    // ... then the blends and stores
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int it = i0 + u * kThreads;
      if (it >= items) continue;
      Chunk<V> res{};
      if (live[u]) {
#pragma unroll
        for (int k = 0; k < V / 4; ++k) {
          res.w[k] = blend_word<T>(v[u][0].w[k], v[u][1].w[k], v[u][2].w[k],
                                   v[u][3].w[k], wx[u], wy[u]);
        }
      }
      store<V>(o + (size_t)it * E, res);
    }
  }
}

template <typename T, int V>
cudaError_t launch(const Levels& lv, int c, const void* ys, const void* xs,
                   const void* level, const void* valid, int m,
                   int rois_per_image, int p, int rows, void* out,
                   cudaStream_t st) {
  const dim3 grid(m, (p + rows - 1) / rows);
  roi_align_kernel<T, V><<<grid, kThreads, (rows + p) * sizeof(Axis), st>>>(
      lv, c, (const float*)ys, (const float*)xs, (const int*)level,
      (const uint8_t*)valid, rois_per_image, p, rows, (T*)out);
  return cudaGetLastError();
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
  if (c % 2 || c <= 0 || p <= 0 || rois_per_image <= 0) {
    return (int)cudaErrorInvalidValue;
  }
  Levels lv{{f0, f1, f2, f3}, {h0, h1, h2, h3}, {w0, w1, w2, w3}};
  // Rows per block: all P, halved until the blocks fill the SMs 8 times.
  int dev = 0, sms = 132;
  if (cudaGetDevice(&dev) == cudaSuccess) {
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  int rows = p;
  while (rows > 1 && (long)m * ((p + rows - 1) / rows) < 8L * sms) {
    rows = (rows + 1) / 2;
  }
  const int esize = is_bf16 ? 2 : 4;
  const bool wide = (c * esize) % 16 == 0 &&
                    ((uintptr_t)f0 | (uintptr_t)f1 | (uintptr_t)f2 |
                     (uintptr_t)f3 | (uintptr_t)out) % 16 == 0;
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err;
  if (is_bf16) {
    err = wide ? launch<__nv_bfloat16, 16>(lv, c, ys, xs, level, valid, m,
                                           rois_per_image, p, rows, out, st)
               : launch<__nv_bfloat16, 4>(lv, c, ys, xs, level, valid, m,
                                          rois_per_image, p, rows, out, st);
  } else {
    err = wide ? launch<float, 16>(lv, c, ys, xs, level, valid, m,
                                   rois_per_image, p, rows, out, st)
               : launch<float, 8>(lv, c, ys, xs, level, valid, m,
                                  rois_per_image, p, rows, out, st);
  }
  return (int)err;
}

}  // extern "C"
