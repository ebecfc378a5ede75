// K4: one stride-1 ResNet bottleneck block, fused: 1x1 -> 3x3 SAME -> 1x1,
// BN folded into bf16 weights and float32 biases, identity or projection
// shortcut, ReLU. The chain wrapper (ops/bottleneck_cuda.py) launches it
// once per block of the chain.
//
// Replaces: maskrcnn_tpu/ops/bottleneck_pallas.py::fused_bottleneck_chain
// (pallas_call :213, kernel _chain_kernel :80, fold_bottleneck_chain :40).
// Difference from the TPU kernel: that one ran the whole chain (res2 a-c,
// res3 b-d) in one call and wrote only the chain's output; this one writes
// each block's output. The two maps a chain sends through device memory
// are 134 MB (res3) and 268 MB (res2) written and read back, 0.04-0.08 ms
// at 3.35 TB/s; a fused chain would need a tile with a three-block halo of
// 512-channel maps, far over the 227 KB a block has. One launch per block
// stays.
//
// What bounds it on an H100: operations (18.3 GFLOP per res3 block at
// batch 2, 1024^2, against ~100 MB moved). What held the first version
// back was memory traffic, not the tensor cores: every warp loaded every B
// fragment from L2 (~5 MB per block at res3, ~3.8 GB per chain), every
// epilogue went through a float32 scratch, and the output left in 4-byte
// stores that each wrote half of a 32-byte sector, with the residual reads
// waiting behind them (ablations: PERF.md, PR 3).
//
// Design: one block of 8 warps per 8 x 16 tile of output pixels. The grid
// covers the image rounded up to whole tiles and the kernel masks the
// ragged edge itself, so any H and W are taken.
//  * Weights stream through a 3-stage ring of shared-memory chunks (64
//    K-rows x up to 128 columns) brought by cp.async and shared by all 8
//    warps: each weight byte is read from L2 once per block (557 KB per
//    res3 block, 34 chunks). Stage 1's x halo chunk (and a projection's x
//    chunk) rides in the same ring slot.
//  * Every product through mma16816_rn (roi_head_common.cuh): each
//    m16n8k16's 16-term sum lands in a zero accumulator and joins the
//    running float32 sum in an FADD, round to nearest, as a float32 sum
//    rounds. Accumulating in the tensor core (d += A * B) rounds toward
//    zero at each of the 4-72 steps of a K: that made each block's mean
//    error 1.6-3.7x the plain version's (PERF.md).
//  * Tensor cores through mma.sync m16n8k16 fed by ldmatrix: A rows are
//    addressed per lane, which the 3x3 needs (its A rows are the t1
//    positions shifted by the tap, a window that starts on any row and
//    skips two rows between output rows). wgmma's shared-memory
//    descriptors want 8-row groups on a fixed stride from a 1024-byte-
//    aligned swizzle atom, which such a window breaks; mma.sync is the
//    simpler correct choice here.
//  * 1. t1 = relu(x @ w1 + b1) on the tile plus its one-pixel halo (10 x 18
//       = 180 positions, padded to 192 rows), zero outside the image: the
//       3x3's SAME padding (_chain_kernel:126-132). Warps 4 x 2: 48 rows x
//       M/2 columns each.
//    2. t2 = relu(conv3x3(t1) + b2): per tap (dy, dx) the A row of output
//       pixel (r, c) is t1 position (r + dy) * 18 + c + dx. Warps 4 x 2: two
//       output rows x M/2 columns each.
//    3. out = relu((t2 @ w3 + b3) + shortcut), in column chunks of 128 (64
//       where Cout is not a multiple of 128, or the block projects); an
//       identity shortcut is read from x (issued before the chunk's
//       products). A projection sums x @ ws in an accumulator of its own
//       and adds (t2 @ w3 + b3) + (x @ ws + bs), in the order of the
//       plain version and the TPU kernel. One running sum of both
//       products with both biases added last had kept the uncentred sums
//       (before BN's shift) in its intermediates: at trained weights
//       res2a's mean error was 2.2x the plain version's (PERF.md).
//       The rounded chunk is staged in shared memory (t1 is dead by then)
//       and leaves in 16-byte pieces, each pixel's columns contiguous.
//  * t1 and t2 stay in shared memory as bf16. Epilogues (bias, ReLU, SAME
//    mask, residual, bf16 rounding) act on the accumulator registers where
//    they sit, with the plain version's bf16 rounding points.
//  * Shared memory: ring 3 x 45,056 B + t1 52,224 B + t2 34,816 B =
//    222,208 B at mid 128; 135,168 + 34,816 (t1 sized for the staged
//    output) + 18,432 = 188,416 B at mid 64: one block per SM. res3 (128^2,
//    batch 2) is 256 blocks, 1.94 waves on 132 SMs; res2 (256^2) 1024
//    blocks, 7.8 waves. A 16 x 16 tile would cut the halo recompute from
//    1.41x to 1.27x, but its t1 (324 rows) does not fit beside the ring at
//    mid 128, and at res3 it leaves 128 blocks for 132 SMs.

#include "roi_head_common.cuh"

namespace {

using namespace mrt;

constexpr int kTH = 8, kTW = 16;            // output tile
constexpr int kHW = kTW + 2;                // halo width (18)
constexpr int kHP = (kTH + 2) * kHW;        // halo positions (180)
constexpr int kHPP = 192;                   // padded to 16-row fragments
constexpr int kPix = kTH * kTW;             // output pixels (128)
constexpr int kKC = 64;                     // K rows of a weight chunk
constexpr int kLdA = kKC + 8;               // x chunk row stride (elements)
constexpr int kLdB = 128 + 8;               // weight chunk row stride
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kSlotB = kKC * kLdB * 2;      // 17,408 B
constexpr int kSlotA = kHPP * kLdA * 2;     // 27,648 B
constexpr int kSlot = kSlotB + kSlotA;
constexpr int kStages = 3;                  // ring slots

template <int M>
struct Layout {
  static constexpr int kLdT = M + 8;        // t1/t2 row stride (elements)
  // t1, and in stage 3 (t1 dead) the output tile staged for coalesced
  // stores: kPix rows of up to 128 columns.
  static constexpr size_t kT1 =
      (size_t)(kHPP * kLdT > kPix * kLdB ? kHPP * kLdT : kPix * kLdB) * 2;
  static constexpr size_t kT2 = (size_t)kPix * kLdT * 2;
  static constexpr size_t kTotal = (size_t)kStages * kSlot + kT1 + kT2;
};

struct Args {
  const bf16* x;
  const bf16* w1;
  const float* b1;
  const bf16* w2;
  const float* b2;
  const bf16* w3;
  const float* b3;
  const bf16* ws;
  const float* bs;
  bf16* out;
  int h, wd, cin, cout, proj;
};

template <int M, int NB3, bool PROJ>
__global__ void __launch_bounds__(kThreads, 1)
bottleneck_kernel(Args g) {
  using L = Layout<M>;
  constexpr int S = kStages;
  constexpr int kLdT = L::kLdT;
  constexpr int kN12 = M / 16;              // n8 tiles per warp, stages 1-2
  constexpr int kN3 = NB3 / 16;             // n8 tiles per warp, stage 3
  constexpr int kMC = M / kKC;              // K chunks of M

  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t ring = smem_u32(smem);
  bf16* t1 = reinterpret_cast<bf16*>(smem + (size_t)S * kSlot);
  bf16* t2 = reinterpret_cast<bf16*>(smem + (size_t)S * kSlot + L::kT1);
  const uint32_t t1s = smem_u32(t1), t2s = smem_u32(t2);

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int gq = lane >> 2, tq = lane & 3;
  const int wm = warp & 3, wn = warp >> 2;
  const int lrow = (lane & 7) + 8 * ((lane >> 3) & 1), lcol = 8 * (lane >> 4);
  const int bimg = blockIdx.z;
  const int y0 = blockIdx.y * kTH, x0 = blockIdx.x * kTW;
  const int h = g.h, wd = g.wd, cin = g.cin, cout = g.cout;
  const bf16* xb = g.x + (size_t)bimg * h * wd * cin;

  const int n1c = cin / kKC;
  const int n2c = 9 * kMC;
  const int per_q = kMC + (PROJ ? n1c : 0);
  const int total = n1c + n2c + (cout / NB3) * per_q;

  // Chunk j of the block's weight stream into ring slot j % S, with the x
  // chunk it pairs with (stage 1: the halo; projection: the tile's pixels).
  auto load_chunk = [&](int j) {
    const uint32_t slot = ring + (j % S) * kSlot;
    const uint32_t sa = slot + kSlotB;
    const bf16* src;
    int stride, ncols, xc = -1;
    bool halo = false;
    if (j < n1c) {
      src = g.w1 + (size_t)j * kKC * M;
      stride = M;
      ncols = M;
      xc = j * kKC;
      halo = true;
    } else if (j < n1c + n2c) {
      const int jj = j - n1c, tap = jj / kMC, kc = jj % kMC;
      src = g.w2 + (size_t)tap * M * M + (size_t)kc * kKC * M;
      stride = M;
      ncols = M;
    } else {
      const int jj = j - n1c - n2c, q = jj / per_q, r = jj % per_q;
      stride = cout;
      ncols = NB3;
      if (r < kMC) {
        src = g.w3 + (size_t)r * kKC * cout + q * NB3;
      } else {
        xc = (r - kMC) * kKC;
        src = g.ws + (size_t)xc * cout + q * NB3;
      }
    }
    // Two loops with constant divisors: this runs for every chunk on every
    // thread, where a division by a runtime width showed in the time.
    if (ncols == 128) {
      for (int i = tid; i < kKC * 16; i += kThreads) {
        const int row = i >> 4, pc = i & 15;
        cp_async16(slot + (row * kLdB + pc * 8) * 2,
                   src + (size_t)row * stride + pc * 8, true);
      }
    } else {
      for (int i = tid; i < kKC * 8; i += kThreads) {
        const int row = i >> 3, pc = i & 7;
        cp_async16(slot + (row * kLdB + pc * 8) * 2,
                   src + (size_t)row * stride + pc * 8, true);
      }
    }
    if (xc >= 0) {
      const int rows = halo ? kHPP : kPix;
      for (int i = tid; i < rows * 8; i += kThreads) {
        const int pos = i / 8, pc = i % 8;
        int gy, gx;
        bool ok;
        if (halo) {
          gy = y0 - 1 + pos / kHW;
          gx = x0 - 1 + pos % kHW;
          ok = pos < kHP;
        } else {
          gy = y0 + pos / kTW;
          gx = x0 + pos % kTW;
          ok = true;
        }
        ok = ok && gy >= 0 && gy < h && gx >= 0 && gx < wd;
        const bf16* s = ok ? xb + ((size_t)gy * wd + gx) * cin + xc + pc * 8
                           : g.x;
        cp_async16(sa + (pos * kLdA + pc * 8) * 2, s, ok);
      }
    }
  };

  // Chunk j is in its slot for every thread, and the slot chunk j - 1 used
  // is free again: refill it with chunk j + S - 1.
  auto acquire = [&](int j) {
    cp_async_wait<S - 2>();
    __syncthreads();
    if (j + S - 1 < total) load_chunk(j + S - 1);
    cp_async_commit();
  };

  for (int j = 0; j < S - 1; ++j) {
    if (j < total) load_chunk(j);
    cp_async_commit();
  }
  int j = 0;

  // ---- stage 1: t1 over the halo tile ------------------------------------
  {
    float acc[3][kN12][4];
#pragma unroll
    for (int i = 0; i < 3; ++i)
#pragma unroll
      for (int n = 0; n < kN12; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][n][e] = 0.0f;
    for (int kc = 0; kc < n1c; ++kc, ++j) {
      acquire(j);
      const uint32_t slot = ring + (j % S) * kSlot;
      const uint32_t sa = slot + kSlotB;
#pragma unroll
      for (int kk = 0; kk < kKC / 16; ++kk) {
        uint32_t a[3][4];
#pragma unroll
        for (int i = 0; i < 3; ++i)
          ldsm_x4(a[i], sa + ((wm * 48 + i * 16 + lrow) * kLdA + kk * 16 +
                              lcol) * 2);
#pragma unroll
        for (int np = 0; np < kN12 / 2; ++np) {
          uint32_t b[4];
          ldsm_x4_trans(b, slot + ((kk * 16 + lrow) * kLdB + wn * (M / 2) +
                                   np * 16 + lcol) * 2);
#pragma unroll
          for (int i = 0; i < 3; ++i) {
            mma16816_rn(acc[i][2 * np], a[i], b[0], b[1]);
            mma16816_rn(acc[i][2 * np + 1], a[i], b[2], b[3]);
          }
        }
      }
    }
#pragma unroll
    for (int n = 0; n < kN12; ++n) {
      const int col = wn * (M / 2) + n * 8 + 2 * tq;
      const float c0 = g.b1[col], c1 = g.b1[col + 1];
#pragma unroll
      for (int i = 0; i < 3; ++i) {
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int pos = wm * 48 + i * 16 + gq + 8 * hh;
          const int gy = y0 - 1 + pos / kHW, gx = x0 - 1 + pos % kHW;
          const bool in = pos < kHP && gy >= 0 && gy < h && gx >= 0 &&
                          gx < wd;
          const float v0 = in ? fmaxf(acc[i][n][2 * hh] + c0, 0.0f) : 0.0f;
          const float v1 = in ? fmaxf(acc[i][n][2 * hh + 1] + c1, 0.0f)
                              : 0.0f;
          *reinterpret_cast<uint32_t*>(t1 + pos * kLdT + col) =
              pack_bf16(v0, v1);
        }
      }
    }
  }

  // ---- stage 2: t2 = relu(conv3x3(t1) + b2) ------------------------------
  {
    float acc[2][kN12][4];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int n = 0; n < kN12; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][n][e] = 0.0f;
    for (int tap = 0; tap < 9; ++tap) {
      const int dy = tap / 3, dx = tap % 3;
      for (int kc = 0; kc < kMC; ++kc, ++j) {
        acquire(j);
        const uint32_t slot = ring + (j % S) * kSlot;
#pragma unroll
        for (int kk = 0; kk < kKC / 16; ++kk) {
          uint32_t a[2][4];
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            const int pos = (2 * wm + i + dy) * kHW + lrow + dx;
            ldsm_x4(a[i], t1s + (pos * kLdT + kc * kKC + kk * 16 + lcol) * 2);
          }
#pragma unroll
          for (int np = 0; np < kN12 / 2; ++np) {
            uint32_t b[4];
            ldsm_x4_trans(b, slot + ((kk * 16 + lrow) * kLdB + wn * (M / 2) +
                                     np * 16 + lcol) * 2);
#pragma unroll
            for (int i = 0; i < 2; ++i) {
              mma16816_rn(acc[i][2 * np], a[i], b[0], b[1]);
              mma16816_rn(acc[i][2 * np + 1], a[i], b[2], b[3]);
            }
          }
        }
      }
    }
#pragma unroll
    for (int n = 0; n < kN12; ++n) {
      const int col = wn * (M / 2) + n * 8 + 2 * tq;
      const float c0 = g.b2[col], c1 = g.b2[col + 1];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int p = (2 * wm + i) * kTW + gq + 8 * hh;
          *reinterpret_cast<uint32_t*>(t2 + p * kLdT + col) =
              pack_bf16(fmaxf(acc[i][n][2 * hh] + c0, 0.0f),
                        fmaxf(acc[i][n][2 * hh + 1] + c1, 0.0f));
        }
      }
    }
  }

  // ---- stage 3: out = relu((t2 @ w3 + b3) + shortcut) -------------------
  for (int q = 0; q < cout / NB3; ++q) {
    // t2 @ w3, and a projection's x @ ws apart from it (as the plain
    // version sums them)
    float acc[2][kN3][4], accs[2][kN3][4];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int n = 0; n < kN3; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][n][e] = accs[i][n][e] = 0.0f;
    // The epilogue's global reads (biases, identity residual), issued
    // before the products so their latency hides under them.
    float2 bias[kN3], sbias[kN3];
    uint32_t res[2][kN3][2];
#pragma unroll
    for (int n = 0; n < kN3; ++n) {
      const int col = q * NB3 + wn * (NB3 / 2) + n * 8 + 2 * tq;
      bias[n] = make_float2(__ldg(g.b3 + col), __ldg(g.b3 + col + 1));
      sbias[n] = PROJ ? make_float2(__ldg(g.bs + col), __ldg(g.bs + col + 1))
                      : make_float2(0.0f, 0.0f);
#pragma unroll
      for (int i = 0; i < 2; ++i) {
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int p = wm * 32 + i * 16 + gq + 8 * hh;
          const int gy = y0 + p / kTW, gx = x0 + p % kTW;
          res[i][n][hh] = 0u;
          if (!PROJ && gy < h && gx < wd) {
            const size_t pix = ((size_t)bimg * h + gy) * wd + gx;
            res[i][n][hh] = __ldg(reinterpret_cast<const unsigned int*>(
                g.x + pix * cin + col));
          }
        }
      }
    }
    // One chunk's products into d: A rows from abase (row stride lda,
    // from column acol), B from the ring slot.
    auto products = [&](float (&d)[2][kN3][4], uint32_t slot,
                        uint32_t abase, int lda, int acol) {
#pragma unroll
      for (int kk = 0; kk < kKC / 16; ++kk) {
        uint32_t a[2][4];
#pragma unroll
        for (int i = 0; i < 2; ++i)
          ldsm_x4(a[i], abase + ((wm * 32 + i * 16 + lrow) * lda + acol +
                                 kk * 16 + lcol) * 2);
#pragma unroll
        for (int np = 0; np < kN3 / 2; ++np) {
          uint32_t b[4];
          ldsm_x4_trans(b, slot + ((kk * 16 + lrow) * kLdB + wn * (NB3 / 2) +
                                   np * 16 + lcol) * 2);
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            mma16816_rn(d[i][2 * np], a[i], b[0], b[1]);
            mma16816_rn(d[i][2 * np + 1], a[i], b[2], b[3]);
          }
        }
      }
    };
    for (int r = 0; r < per_q; ++r, ++j) {
      acquire(j);
      const uint32_t slot = ring + (j % S) * kSlot;
      // A: t2 for the first M/64 chunks, then the staged x (projection).
      if (PROJ && r >= kMC) {
        products(accs, slot, slot + kSlotB, kLdA, 0);
      } else {
        products(acc, slot, t2s, kLdT, r * kKC);
      }
    }
#pragma unroll
    for (int n = 0; n < kN3; ++n) {
      const int col = q * NB3 + wn * (NB3 / 2) + n * 8 + 2 * tq;
#pragma unroll
      for (int i = 0; i < 2; ++i) {
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int p = wm * 32 + i * 16 + gq + 8 * hh;
          float v0 = acc[i][n][2 * hh] + bias[n].x;
          float v1 = acc[i][n][2 * hh + 1] + bias[n].y;
          if (PROJ) {
            v0 += accs[i][n][2 * hh] + sbias[n].x;
            v1 += accs[i][n][2 * hh + 1] + sbias[n].y;
          } else {
            const float2 xv = __bfloat1622float2(
                *reinterpret_cast<const __nv_bfloat162*>(&res[i][n][hh]));
            v0 += xv.x;
            v1 += xv.y;
          }
          *reinterpret_cast<uint32_t*>(t1 + p * kLdB + col - q * NB3) =
              pack_bf16(fmaxf(v0, 0.0f), fmaxf(v1, 0.0f));
        }
      }
    }
    // The staged tile leaves in 16-byte pieces, a pixel's NB3 columns
    // contiguous: whole sectors, where the accumulator layout would write
    // 4 bytes a lane and half sectors.
    __syncthreads();
    for (int i = tid; i < kPix * (NB3 / 8); i += kThreads) {
      const int p = i / (NB3 / 8), pc = i % (NB3 / 8);
      const int gy = y0 + p / kTW, gx = x0 + p % kTW;
      if (gy >= h || gx >= wd) continue;
      const size_t pix = ((size_t)bimg * h + gy) * wd + gx;
      *reinterpret_cast<uint4*>(g.out + pix * cout + q * NB3 + pc * 8) =
          *reinterpret_cast<const uint4*>(t1 + p * kLdB + pc * 8);
    }
  }
  cp_async_wait<0>();
}

template <int M, int NB3, bool PROJ>
int launch(const Args& a, int b, cudaStream_t st) {
  const size_t smem = Layout<M>::kTotal;
  cudaError_t err = cudaFuncSetAttribute(
      bottleneck_kernel<M, NB3, PROJ>,
      cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((a.wd + kTW - 1) / kTW, (a.h + kTH - 1) / kTH, b);
  bottleneck_kernel<M, NB3, PROJ><<<grid, kThreads, smem, st>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// x (B, H, W, Cin) bf16; w1 (Cin, M), w2 (9, M, M), w3 (M, Cout), ws
// (Cin, Cout) bf16; b1 (M,), b2 (M,), b3 (Cout,), bs (Cout,) f32; out
// (B, H, W, Cout) bf16. ws/bs are read only when proj != 0. Any H, W.
int mrt_bottleneck(const void* x, const void* w1, const void* b1,
                   const void* w2, const void* b2, const void* w3,
                   const void* b3, const void* ws, const void* bs, void* out,
                   int b, int h, int wd, int cin, int m, int cout, int proj,
                   void* stream) {
  if (h <= 0 || wd <= 0 || cin % kKC || cout % 64 ||
      (proj && (ws == nullptr || bs == nullptr)) || (!proj && cin != cout)) {
    return (int)cudaErrorInvalidValue;
  }
  if (b == 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  const Args a{(const bf16*)x, (const bf16*)w1, (const float*)b1,
               (const bf16*)w2, (const float*)b2, (const bf16*)w3,
               (const float*)b3, (const bf16*)ws, (const float*)bs,
               (bf16*)out, h, wd, cin, cout, proj};
  // A projection block takes 64-column chunks: its two stage-3
  // accumulators then hold what one does at 128.
  if (proj) {
    if (m == 64) return launch<64, 64, true>(a, b, st);
    if (m == 128) return launch<128, 64, true>(a, b, st);
    return (int)cudaErrorInvalidValue;
  }
  const bool wide = cout % 128 == 0;
  if (m == 64)
    return wide ? launch<64, 128, false>(a, b, st)
                : launch<64, 64, false>(a, b, st);
  if (m == 128)
    return wide ? launch<128, 128, false>(a, b, st)
                : launch<128, 64, false>(a, b, st);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
