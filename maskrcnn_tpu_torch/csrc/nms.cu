// K1: greedy non-max suppression keep flags, one thread block per image.
//
// Replaces: maskrcnn_tpu/ops/nms_pallas.py::nms_keep_pallas (pallas_call
// :184, kernel _nms_kernel :64, IoU test _pairwise_hit :41).
//
// What bounds it on an H100: neither bytes (6000 boxes are 96 KB per image)
// nor the card's arithmetic rate. The greedy selection is a chain of
// dependent decisions, so the kernel is latency-bound: the in-tile
// resolution is a serial walk over the tile, and each image is one block on
// one SM while the other SMs idle (the batch is the only parallel axis).
//
// Design:
//  * All N boxes of the image and the compact buffer of the first max_out
//    keepers live in shared memory (6000 x 16 B + 1000 x 16 B = 112 KB at
//    the proposal stage: dynamic shared memory above 48 KB).
//  * Tiles of TILE boxes (one per thread) are walked in order. A thread
//    tests its box against the kept buffer (stops at the first hit), then
//    records which earlier boxes of its tile hit it as a bit row. One
//    thread then resolves the tile in index order on those bit rows
//    (greedy = a box survives iff no kept earlier box of the tile hits it)
//    and appends the keepers to the buffer.
//  * The walk stops once max_out boxes are kept: selection order is index
//    order, so later keepers can never enter the first max_out output slots.
//  * The IoU test is `inter > t * union` with every operation rounded on
//    its own (__fmul_rn, __fadd_rn, __fsub_rn; the file is also compiled
//    with -fmad=false), the same operations in the same order as the plain
//    version (ops/boxes.py::box_overlap_mask), so near-threshold pairs
//    decide the same way and the kept indices equal the plain version's.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxTile = 256;
constexpr int kWords = kMaxTile / 32;

__device__ __forceinline__ float area_of(float4 a) {
  return __fmul_rn(__fsub_rn(a.z, a.x), __fsub_rn(a.w, a.y));
}

// (y1, x1, y2, x2) = (x, y, z, w). Symmetric in (a, b).
__device__ __forceinline__ bool hit(float4 a, float4 b, float t) {
  float area_a = area_of(a);
  float area_b = area_of(b);
  float iy = fmaxf(__fsub_rn(fminf(a.z, b.z), fmaxf(a.x, b.x)), 0.0f);
  float ix = fmaxf(__fsub_rn(fminf(a.w, b.w), fmaxf(a.y, b.y)), 0.0f);
  float inter = __fmul_rn(iy, ix);
  float uni = __fsub_rn(__fadd_rn(area_a, area_b), inter);
  return (inter > __fmul_rn(t, uni)) && (area_a > 0.0f) && (area_b > 0.0f);
}

__global__ void nms_kernel(const float4* __restrict__ boxes,
                           const uint8_t* __restrict__ cand,
                           uint8_t* __restrict__ keep, int n, float t,
                           int max_out, int cap) {
  extern __shared__ float4 smem[];
  float4* sb = smem;          // n boxes of this image
  float4* kb = smem + n;      // first `cap` keepers
  uint32_t* over = reinterpret_cast<uint32_t*>(kb + cap);  // tile x kWords
  __shared__ uint8_t alive[kMaxTile];
  __shared__ int s_cnt;

  const int img = blockIdx.x;
  const int tid = threadIdx.x;
  const int tile = blockDim.x;
  const float4* bx = boxes + (size_t)img * n;
  const uint8_t* cd = cand + (size_t)img * n;
  uint8_t* kp = keep + (size_t)img * n;

  for (int i = tid; i < n; i += tile) {
    sb[i] = bx[i];
    kp[i] = 0;
  }
  if (tid == 0) s_cnt = 0;
  __syncthreads();

  for (int start = 0; start < n; start += tile) {
    const int cnt = s_cnt;
    if (cnt >= max_out) break;
    const int j = start + tid;
    bool c = false;
    float4 bj = make_float4(0.f, 0.f, 0.f, 0.f);
    if (j < n) {
      bj = sb[j];
      c = cd[j] != 0 && area_of(bj) > 0.0f;
      const int kn = cnt < cap ? cnt : cap;
      for (int k = 0; c && k < kn; ++k) {
        if (hit(kb[k], bj, t)) c = false;
      }
    }
    alive[tid] = c;
    __syncthreads();

    // Bit row of this box: which alive earlier boxes of the tile hit it.
    for (int w = 0; w < kWords; ++w) {
      uint32_t word = 0;
      if (c) {
        for (int bit = 0; bit < 32; ++bit) {
          const int i = w * 32 + bit;
          if (i < tid && alive[i] && hit(sb[start + i], bj, t)) {
            word |= 1u << bit;
          }
        }
      }
      over[tid * kWords + w] = word;
    }
    __syncthreads();

    if (tid == 0) {
      uint32_t kept[kWords] = {0};
      int cnt2 = cnt;
      const int lim = (n - start) < tile ? (n - start) : tile;
      for (int i = 0; i < lim; ++i) {
        if (!alive[i]) continue;
        uint32_t sup = 0;
        for (int w = 0; w < kWords; ++w) sup |= over[i * kWords + w] & kept[w];
        if (sup) continue;
        kept[i >> 5] |= 1u << (i & 31);
        kp[start + i] = 1;
        if (cnt2 < cap) kb[cnt2] = sb[start + i];
        ++cnt2;
      }
      s_cnt = cnt2 < cap ? cnt2 : cap;
    }
    __syncthreads();
  }
}

size_t smem_bytes(int n, int cap, int tile) {
  return (size_t)(n + cap) * sizeof(float4) +
         (size_t)tile * kWords * sizeof(uint32_t);
}

constexpr size_t kSmemLimit = 227 * 1024;

}  // namespace

extern "C" {

// Largest box count per image the kernel can hold with a `cap`-box buffer.
int mrt_nms_max_boxes(int cap) {
  return (int)((kSmemLimit - smem_bytes(0, cap, kMaxTile)) / sizeof(float4));
}

// boxes (B, N, 4) f32, cand (B, N) bool, keep (B, N) bool out.
int mrt_nms_keep(const void* boxes, const void* cand, void* keep, int b,
                 int n, float t, int max_out, int tile, void* stream) {
  if (tile <= 0 || tile > kMaxTile || tile % 32) return (int)cudaErrorInvalidValue;
  if (b == 0 || n == 0) return 0;
  const int cap = max_out < n ? max_out : n;
  const size_t smem = smem_bytes(n, cap, tile);
  if (smem > kSmemLimit) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      nms_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  nms_kernel<<<b, tile, smem, (cudaStream_t)stream>>>(
      (const float4*)boxes, (const uint8_t*)cand, (uint8_t*)keep, n, t,
      max_out, cap);
  return (int)cudaGetLastError();
}

}  // extern "C"
