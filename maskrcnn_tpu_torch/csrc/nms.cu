// K1: greedy non-max suppression keep flags.
//
// Replaces: maskrcnn_tpu/ops/nms_pallas.py::nms_keep_pallas (pallas_call
// :184, kernel _nms_kernel :64, IoU test _pairwise_hit :41).
//
// What bounds it on an H100: neither bytes (6000 boxes are 96 KB per image)
// nor the card's arithmetic rate (the pair tests are ~0.7 GFLOP of float32
// at 2 x 6000 boxes). The greedy selection is a chain of dependent
// decisions, so the kernel is latency-bound: the design puts the
// independent pair tests on every SM and keeps the dependent walk short.
//
// Design: two launches.
//  * nms_mask_kernel computes every pair test on all SMs: one block of 64
//    threads per 64 x 64 block of the upper triangle (linear block index,
//    no empty blocks) and image. Thread i writes one 64-bit word whose bit
//    j is set iff box j comes after box i and hits it. The IoU comparison
//    runs unrolled over the 64 columns; the positive-area and j > i tests
//    are applied once per word as masks. Rows of boxes that are not
//    candidates are never read and not computed. The diagonal blocks also
//    write each chunk's candidate word (two ballots) into row N. The mask
//    is B x (N + 1) x ceil(N / 64) words of scratch (4.5 MB per image at
//    N = 6000).
//  * nms_walk_kernel, one block per image, walks the boxes in chunks of 64
//    with the removed set held as N / 64 words in shared memory. While
//    chunk c resolves, cp.async brings chunk c + 1's rows (up to 128 words
//    of each) into the other half of a shared-memory double buffer. One
//    warp resolves chunk c: its greedy keep set K is the one fixpoint of
//    K = avail & ~OR(diag word of i, i in K), since the diagonal words only
//    point forward; iterating from K = avail reaches it in at most (the
//    longest chain of hits + 1) steps of two warp OR-reductions each, not
//    one step per kept box. Then each thread ORs the kept rows' bits into
//    the removed words it owns. The walk stops at max_out keepers (the
//    last of the chunk's K dropped past it: selection is in index order);
//    flags past the max_out-th read False.
//  * Every decision reads a bit computed by the same test on the same
//    pair, so the kept indices equal the sequential greedy's bit for bit.
//    The IoU test is `inter > t * union` with every operation rounded on
//    its own (__fmul_rn, __fadd_rn, __fsub_rn; the file is also compiled
//    with -fmad=false), the same operations in the same order as the plain
//    version (ops/boxes.py::box_overlap_mask).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kChunk = 64;          // boxes per mask word
constexpr int kWalkThreads = 256;
constexpr int kWin = 128;           // words of a chunk's rows staged

typedef unsigned long long u64;

__device__ __forceinline__ float area_of(float4 a) {
  return __fmul_rn(__fsub_rn(a.z, a.x), __fsub_rn(a.w, a.y));
}

// (y1, x1, y2, x2) = (x, y, z, w), with their areas; the whole test is
// this and area_a > 0 and area_b > 0, which the callers apply per row and
// per column. Symmetric in (a, b).
__device__ __forceinline__ bool overlaps(float4 a, float area_a, float4 b,
                                         float area_b, float t) {
  float iy = fmaxf(__fsub_rn(fminf(a.z, b.z), fmaxf(a.x, b.x)), 0.0f);
  float ix = fmaxf(__fsub_rn(fminf(a.w, b.w), fmaxf(a.y, b.y)), 0.0f);
  float inter = __fmul_rn(iy, ix);
  float uni = __fsub_rn(__fadd_rn(area_a, area_b), inter);
  return inter > __fmul_rn(t, uni);
}

__device__ __forceinline__ bool candidate(const float4* bx,
                                          const uint8_t* cd, int i) {
  return cd[i] != 0 && area_of(bx[i]) > 0.0f;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void cp_async8(uint32_t dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(dst),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Block (rb, cb), cb >= rb, of the upper triangle from its linear index.
__device__ __forceinline__ void triangle_block(int id, int words, int& rb,
                                              int& cb) {
  // Row rb starts at rb * words - rb * (rb - 1) / 2.
  const float w2 = 2.0f * words + 1.0f;
  rb = (int)((w2 - sqrtf(w2 * w2 - 8.0f * id)) * 0.5f);
  rb = max(0, min(rb, words - 1));
  while (rb > 0 && rb * words - rb * (rb - 1) / 2 > id) --rb;
  while (rb + 1 < words && (rb + 1) * words - (rb + 1) * rb / 2 <= id) ++rb;
  cb = rb + id - (rb * words - rb * (rb - 1) / 2);
}

// mask[img][i][w]: the 64 rows of row block rb, word w = cb >= rb (words
// below the diagonal are never read), and on the diagonal the candidate
// word of the chunk, mask[img][n][rb].
__global__ void __launch_bounds__(kChunk)
nms_mask_kernel(const float4* __restrict__ boxes,
                const uint8_t* __restrict__ cand, u64* __restrict__ mask,
                int n, int words, float t) {
  int rb, cb;
  triangle_block(blockIdx.x, words, rb, cb);
  __shared__ float4 cols[kChunk];
  __shared__ float col_area[kChunk];
  const size_t img = blockIdx.y;
  const float4* bx = boxes + img * n;
  const uint8_t* cd = cand + img * n;
  u64* mk = mask + img * (n + 1) * words;
  const int j0 = cb * kChunk;
  if (j0 + threadIdx.x < n) {
    const float4 b = bx[j0 + threadIdx.x];
    cols[threadIdx.x] = b;
    col_area[threadIdx.x] = area_of(b);
  }
  __syncthreads();
  const int i = rb * kChunk + threadIdx.x;
  const bool ci = i < n && candidate(bx, cd, i);
  if (cb == rb) {
    const unsigned half = __ballot_sync(0xffffffffu, ci);
    unsigned* cw = reinterpret_cast<unsigned*>(mk + (size_t)n * words + rb);
    if ((threadIdx.x & 31) == 0) cw[threadIdx.x / 32] = half;
  }
  // Columns that can be hit: positive area, after box i.
  const int l = threadIdx.x & 31;
  const u64 live =
      __ballot_sync(0xffffffffu, col_area[l] > 0.0f) |
      (u64)__ballot_sync(0xffffffffu, col_area[32 + l] > 0.0f) << 32;
  if (!ci) return;
  const float4 bi = bx[i];
  const float ai = area_of(bi);
  const int lim = min(kChunk, n - j0);
  u64 word = 0ull;
  if (lim == kChunk) {
    // Whole block, unrolled: constant bit positions.
#pragma unroll
    for (int j = 0; j < kChunk; ++j) {
      if (overlaps(bi, ai, cols[j], col_area[j], t)) word |= 1ull << j;
    }
  } else {
    for (int j = 0; j < lim; ++j) {
      if (overlaps(bi, ai, cols[j], col_area[j], t)) word |= 1ull << j;
    }
  }
  word &= live;
  // On the diagonal only boxes after i; past n nothing.
  if (cb == rb) word &= ~((2ull << threadIdx.x) - 1ull);
  if (lim < kChunk) word &= (1ull << lim) - 1ull;
  mk[(size_t)i * words + cb] = word;
}

// Rows of chunk c, words [c, c + kWin), into buf[r][w - c] (asynchronous;
// one commit group).
__device__ __forceinline__ void stage_rows(u64* buf, const u64* mk, int c,
                                           int n, int words) {
  const int span = min(kWin, words - c);
  const int rows = min(kChunk, n - c * kChunk);
  const int w = threadIdx.x % kWin;
  if (w < span) {
    for (int r = threadIdx.x / kWin; r < rows; r += kWalkThreads / kWin) {
      cp_async8(smem_u32(buf + r * kWin + w),
                mk + (size_t)(c * kChunk + r) * words + c + w);
    }
  }
  cp_async_commit();
}

__device__ __forceinline__ u64 warp_or(u64 v) {
  const unsigned lo = __reduce_or_sync(0xffffffffu, (unsigned)v);
  const unsigned hi = __reduce_or_sync(0xffffffffu, (unsigned)(v >> 32));
  return ((u64)hi << 32) | lo;
}

__global__ void __launch_bounds__(kWalkThreads)
nms_walk_kernel(const u64* __restrict__ mask, uint8_t* __restrict__ keep,
                int n, int words, int max_out) {
  extern __shared__ u64 sw[];
  u64* stage = sw;                             // [2][kChunk][kWin]
  u64* removed = sw + 2 * kChunk * kWin;       // [words]
  u64* cands = removed + words;                // [words]
  u64* kept = cands + words;                   // [words]
  __shared__ int rows[kChunk];
  __shared__ int s_nk, s_count;

  const size_t img = blockIdx.x;
  const u64* mk = mask + img * (n + 1) * words;
  const int tid = threadIdx.x, lane = tid & 31;

  stage_rows(stage, mk, 0, n, words);
  for (int w = tid; w < words; w += kWalkThreads) {
    cands[w] = mk[(size_t)n * words + w];
    removed[w] = 0ull;
    kept[w] = 0ull;
  }
  if (tid == 0) s_count = 0;

  for (int c = 0; c < words; ++c) {
    // Chunk c + 1's rows load while chunk c resolves.
    if (c + 1 < words) {
      stage_rows(stage + ((c + 1) & 1) * kChunk * kWin, mk, c + 1, n, words);
    } else {
      cp_async_commit();
    }
    cp_async_wait<1>();
    __syncthreads();
    const u64* rb = stage + (c & 1) * kChunk * kWin;   // rb[r][w - c]
    if (tid < 32) {
      // The chunk's greedy keep set K is the one fixpoint of K = avail &
      // ~OR(diag[i], i in K) (diag bits point only forward), reached from
      // K = avail in at most (longest chain of hits + 1) steps. Lane l
      // holds the diagonal words of boxes l and l + 32.
      const u64 avail = cands[c] & ~removed[c];
      const u64 d0 = (avail >> lane) & 1ull ? rb[lane * kWin] : 0ull;
      const u64 d1 = (avail >> (lane + 32)) & 1ull
                         ? rb[(lane + 32) * kWin] : 0ull;
      u64 k = avail;
      while (true) {
        const u64 hitk = warp_or(((k >> lane) & 1ull ? d0 : 0ull) |
                                 ((k >> (lane + 32)) & 1ull ? d1 : 0ull));
        const u64 next = avail & ~hitk;
        if (next == k) break;
        k = next;
      }
      // Selection is in index order: past max_out keepers, drop the last.
      const int count = s_count;
      while (count + __popcll(k) > max_out) k &= ~(1ull << (63 - __clzll(k)));
      const u64 below_lo = (1ull << lane) - 1ull;
      if ((k >> lane) & 1ull) rows[__popcll(k & below_lo)] = lane;
      if ((k >> (lane + 32)) & 1ull)
        rows[__popcll(k & ((below_lo << 32) | 0xffffffffull))] = lane + 32;
      if (lane == 0) {
        kept[c] = k;
        s_nk = __popcll(k);
        s_count = count + __popcll(k);
      }
    }
    __syncthreads();
    const int nk = s_nk;
    if (s_count >= max_out || c + 1 == words) break;
    // Removed set: each thread ORs the kept rows' bits into its own words.
    for (int w = c + 1 + tid; w < words; w += kWalkThreads) {
      u64 v = 0ull;
      if (w - c < kWin) {
#pragma unroll 8
        for (int q = 0; q < nk; ++q) v |= rb[rows[q] * kWin + w - c];
      } else {
        for (int q = 0; q < nk; ++q)
          v |= mk[(size_t)(c * kChunk + rows[q]) * words + w];
      }
      removed[w] |= v;
    }
    __syncthreads();
  }
  cp_async_wait<0>();
  __syncthreads();
  uint8_t* kp = keep + img * n;
  for (int i = tid; i < n; i += kWalkThreads) {
    kp[i] = (uint8_t)((kept[i / kChunk] >> (i % kChunk)) & 1ull);
  }
}

}  // namespace

extern "C" {

// boxes (B, N, 4) f32, cand (B, N) bool, mask (B, N + 1, ceil(N / 64)) u64
// scratch (row N: the candidate words), keep (B, N) bool out.
int mrt_nms_keep(const void* boxes, const void* cand, void* mask, void* keep,
                 int b, int n, float t, int max_out, void* stream) {
  if (b == 0 || n == 0) return 0;
  if (max_out < 0) return (int)cudaErrorInvalidValue;
  const int words = (n + kChunk - 1) / kChunk;
  const size_t smem = (size_t)(2 * kChunk * kWin + 3 * words) * sizeof(u64);
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err = cudaFuncSetAttribute(
      nms_walk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  nms_mask_kernel<<<dim3(words * (words + 1) / 2, b), kChunk, 0, st>>>(
      (const float4*)boxes, (const uint8_t*)cand, (u64*)mask, n, words, t);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  nms_walk_kernel<<<b, kWalkThreads, smem, st>>>((const u64*)mask,
                                                 (uint8_t*)keep, n, words,
                                                 max_out);
  return (int)cudaGetLastError();
}

}  // extern "C"
