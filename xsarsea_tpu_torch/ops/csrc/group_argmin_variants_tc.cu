// K6 on the tensor cores: the coarse group-argmin pass in expanded (matmul)
// form, the engine "tensor_cores" of ops/experiment_kernels.py.
//
// Replaces scripts/bench_kernel_variants.py:make_variant.run (body kernel)
// as the TPU computes it: the cost of 4 tiles x 2048 entries per pixel as
// one product j = G^T . F of K = 4 on the matrix unit, then the variant's
// reduction to 32 rows and the first row holding their minimum (any NaN row
// gives 31). The CUDA-core engine (group_argmin_variants.cu) is its baseline,
// bit-equal to a left-to-right f32 sum; this one asks whether the TPU's own
// K1 design, the product on the matrix unit, pays on Hopper.
//
// The product is mma.sync bf16 -> f32 with entries on M (16 a tile) and
// pixels on N (8 a tile), as the JAX K1 lays it out
// (xsarsea_tpu/ops/pallas_inversion.py:_group_argmin_kernel):
//   * precision default: both operands rounded to bf16 (RNE), K = 4 padded to
//     8, one m16n8k8 per (entry tile, pixel tile): the TPU's single bf16 pass;
//   * precision highest: both operands split exactly into three bf16 terms
//     (_split3_bf16), and the nine cross products summed: K = 36 padded to
//     48 as three m16n8k16 steps. Each step's A row is (g0 c0-3, g1 c0-3,
//     g2 c0-3, four zeros), the same fragment for all three; step s's B
//     column holds f_s's four channels, repeated: the zeros of A meet them.
// The products are exact, but the tensor core aligns and truncates their sum,
// so neither form is bit-equal to a left-to-right f32 sum: a pixel may flip
// where its two best rows lie within a few f32 ulps of S_p = max_e sum_k
// |g_k[e] f_k[p]|, as the TPU's DEFAULT and HIGHEST passes do against each
// other. The wrapper's card gate allows only such near-ties.
//
// g4 is split once per band set by split_g4_kernel into the A fragments'
// own layout: per (band, tile, 16-entry M-tile) the 32 lanes' 4 (k16) or 2
// (k8) words, one 16- or 8-byte load a lane. The main kernel stages them
// through shared memory one 256-entry group (16 M-tiles, 8 or 4 KB) at a time,
// double-buffered by 16-byte cp.async; the features are split in registers
// at the start, into B fragments that stay there (a 256-pixel pass: 8 warps x
// 4 pixel tiles; 512- and 1024-pixel blocks take two and four passes per
// staged group). The split's loop over a group's M-tiles is unrolled by 2
// only: fully unrolled, the A fragments it loaded ahead spilled registers at
// every block size (ptxas, under the 128 registers of two blocks an SM).
//
// The group minimum stays on the FP32 pipe: each lane folds its accumulator
// fragments into a running NaN-propagating minimum (min.NaN.f32) per pixel
// across the group's M-tiles, one minimum per entry and pixel, and one
// shuffle reduction across the 8 lanes of a pixel column ends the group
// (flat_min: the tile). Lane (g, t) keeps the rows' first minimum of pixel
// tile g & 3, a strict '<' over rows in order.
//
// Bound on the H100: the bf16 products at 989 TFLOP/s (8 flops an entry and
// pixel for default, 72 for highest's nine terms; issued: 16 and 96, the
// padding of K) against one FP32 minimum an entry at 67 TFLOP/s: highest's
// product bounds it; default's minimum does.
#include "inversion_common.cuh"

#include <cuda_bf16.h>

#include <cstdint>

namespace {

constexpr int kTiles = 4;
constexpr int kTile = 2048;
constexpr int kGroupSize = 256;
constexpr int kGroupsPerTile = kTile / kGroupSize;  // 8 rows per tile
constexpr int kLastGroup = kTiles * kGroupsPerTile - 1;
constexpr int kM = 16;                       // entries per MMA: the M dimension
constexpr int kMPerTile = kTile / kM;        // 128
constexpr int kMPerGroup = kGroupSize / kM;  // 16
constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kNT = 4;                   // pixel tiles (8 pixels, the N dimension) a warp holds
constexpr int kPassPx = kWarps * kNT * 8;  // 256 pixels a pass

enum Reduction { kGroupMin = 0, kFlatMin = 1, kNone = 2 };

// 32-bit words a lane holds of one M-tile's A fragment: m16n8k16 (split3) or
// m16n8k8 (bf16).
template <bool kSplit3>
__host__ __device__ constexpr int a_words() {
  return kSplit3 ? 4 : 2;
}

__device__ __forceinline__ uint32_t pack(__nv_bfloat16 lo, __nv_bfloat16 hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(lo)) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(hi)) << 16);
}

// f32 a - b with subnormal operands and result flushed to zero of their
// sign, as the TPU and XLA's CPU backend subtract.
__device__ __forceinline__ float sub_ftz(float a, float b) {
  float r;
  asm("sub.rn.ftz.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

// The three-term bf16 split of _split3_bf16: round, subtract, round; exact
// where the residuals are normal (|x| >= 2^-102), flushed where not, as the
// JAX package's split is.
__device__ __forceinline__ void split3(float x, __nv_bfloat16 (&t)[3]) {
  t[0] = __float2bfloat16_rn(x);
  const float r1 = sub_ftz(x, __bfloat162float(t[0]));
  t[1] = __float2bfloat16_rn(r1);
  t[2] = __float2bfloat16_rn(sub_ftz(r1, __bfloat162float(t[1])));
}

// A's element (row e of the tile, column k): split term k / 4 of channel
// k % 4 for k < 12 (split3), channel k for k < 4 (bf16), else 0.
template <bool kSplit3>
__device__ __forceinline__ __nv_bfloat16 a_element(const float* g_e, int k) {
  const __nv_bfloat16 zero = __ushort_as_bfloat16(0);
  if constexpr (kSplit3) {
    if (k >= 12) return zero;
    __nv_bfloat16 t[3];
    split3(g_e[(k & 3) * kTile], t);
    return t[k >> 2];
  } else {
    return k < 4 ? __float2bfloat16_rn(g_e[k * kTile]) : zero;
  }
}

// g4 (n_bands, 4 tiles, 4, 2048) f32 -> the A fragments, word i of
// ((band * 4 + tile) * 128 + M-tile) * 32 + lane, W words a lane: word w
// holds rows g + 8 (w & 1) and columns 2t + 8 (w >> 1) + {0, 1} (lane = 4g +
// t), the register order of mma.sync's A operand.
template <bool kSplit3>
__global__ void split_g4_kernel(const float* __restrict__ g4, uint32_t* __restrict__ out,
                                size_t n_words) {
  constexpr int W = a_words<kSplit3>();
  const size_t i = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n_words) return;
  const int w = static_cast<int>(i % W);
  size_t rest = i / W;
  const int lane = static_cast<int>(rest % 32);
  rest /= 32;
  const int mt = static_cast<int>(rest % kMPerTile);
  const size_t band_tile = rest / kMPerTile;
  const int row = (lane >> 2) + 8 * (w & 1);
  const int k0 = 2 * (lane & 3) + 8 * (w >> 1);
  const float* g_e = g4 + band_tile * 4 * kTile + mt * kM + row;  // channel c at g_e[c * kTile]
  out[i] = pack(a_element<kSplit3>(g_e, k0), a_element<kSplit3>(g_e, k0 + 1));
}

__device__ __forceinline__ void mma_k16(float (&c)[4], uint4 a, uint32_t b) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a.x), "r"(a.y), "r"(a.z), "r"(a.w), "r"(b), "r"(b));
}

__device__ __forceinline__ void mma_k8(float (&c)[4], uint2 a, uint32_t b) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5}, {%6}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a.x), "r"(a.y), "r"(b));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src) : "memory");
}

// v[mine], with mine known only at run time.
__device__ __forceinline__ float pick(const float (&v)[kNT], int mine) {
  float x = v[0];
#pragma unroll
  for (int n = 1; n < kNT; ++n) x = mine == n ? v[n] : x;
  return x;
}

template <bool kSplit3, int kReduction, int kPasses>
__global__ void __launch_bounds__(kThreads, 2)
    group_argmin_tc_kernel(const uint32_t* __restrict__ g4s, const float* __restrict__ feats,
                           const int* __restrict__ band_of_block, int* __restrict__ out) {
  constexpr int W = a_words<kSplit3>();
  constexpr int kS = kSplit3 ? 3 : 1;                               // K steps: split terms of F
  constexpr int kMPerStage = kReduction == kNone ? 1 : kMPerGroup;  // M-tiles a stage holds
  constexpr int kStagesPerTile = kReduction == kNone ? 1 : kGroupsPerTile;
  constexpr int kStages = kTiles * kStagesPerTile;
  constexpr int kStageWords = kMPerStage * 32 * W;
  constexpr int kBlock = kPasses * kPassPx;
  __shared__ __align__(16) uint32_t s_a[2][kStageWords];

  const int b = blockIdx.x;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int mine = g & 3;  // the pixel tile whose pixels 2t, 2t + 1 this lane keeps
  const float* f_b = feats + static_cast<size_t>(b) * 4 * kBlock;  // (4, kBlock)

  // B fragments, per pass, pixel tile and K step: channels 2 (t & 1) and
  // 2 (t & 1) + 1 of pixel column g (k8: lanes t >= 2 hold K's padding, 0)
  uint32_t bf[kPasses][kNT][kS];
#pragma unroll
  for (int p = 0; p < kPasses; ++p) {
#pragma unroll
    for (int n = 0; n < kNT; ++n) {
      const int px = p * kPassPx + warp * kNT * 8 + n * 8 + g;
      const int c = 2 * (t & 1);
      const float x = f_b[c * kBlock + px];
      const float y = f_b[(c + 1) * kBlock + px];
      if constexpr (kSplit3) {
        __nv_bfloat16 xs[3], ys[3];
        split3(x, xs);
        split3(y, ys);
#pragma unroll
        for (int s = 0; s < kS; ++s) bf[p][n][s] = pack(xs[s], ys[s]);
      } else {
        bf[p][n][0] = t < 2 ? pack(__float2bfloat16_rn(x), __float2bfloat16_rn(y)) : 0u;
      }
    }
  }

  float best[kPasses][2];  // the rows' running first minimum per kept pixel
  int best_row[kPasses][2];
  bool nan[kPasses][2];
#pragma unroll
  for (int p = 0; p < kPasses; ++p) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      best[p][j] = CUDART_INF_F;
      best_row[p][j] = 0;  // row 0 is the answer when every row is +inf
      nan[p][j] = false;
    }
  }
  auto keep = [&](int p, int j, float v, int row) {
    nan[p][j] |= (v != v);
    if (v < best[p][j]) {
      best[p][j] = v;
      best_row[p][j] = row;
    }
  };

  const uint32_t* g_band =
      g4s + static_cast<size_t>(band_of_block[b]) * kTiles * kMPerTile * 32 * W;
  auto stage = [&](int s, int buf) {
    const uint32_t* src =
        g_band + (static_cast<size_t>(s / kStagesPerTile) * kMPerTile +
                  (s % kStagesPerTile) * kMPerStage) * 32 * W;
    for (int i = threadIdx.x; i < kStageWords / 4; i += kThreads)
      cp_async16(&s_a[buf][4 * i], src + 4 * i);
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  };

  // running minima per pixel tile and kept column; flat_min keeps them
  // across the 8 stages of a tile, one set per pass
  float run[kReduction == kFlatMin ? kPasses : 1][kNT][2];
  stage(0, 0);
  for (int s = 0; s < kStages; ++s) {
    if (s + 1 < kStages) {  // prefetch the next group into the other buffer
      stage(s + 1, (s + 1) & 1);
      asm volatile("cp.async.wait_group 1;\n" ::: "memory");
    } else {
      asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    }
    __syncthreads();
    const uint32_t* a_s = s_a[s & 1];
    const int tile = s / kStagesPerTile;
#pragma unroll
    for (int p = 0; p < kPasses; ++p) {
      if constexpr (kReduction == kNone) {
        // the tile's first M-tile; rows tile * 8 + k are its entries k < 8,
        // the accumulator rows g of lanes 4k + t
        float c[kNT][4];
#pragma unroll
        for (int n = 0; n < kNT; ++n) {
          c[n][0] = c[n][1] = c[n][2] = c[n][3] = 0.0f;
          if constexpr (kSplit3) {
            const uint4 a = reinterpret_cast<const uint4*>(a_s)[lane];
#pragma unroll
            for (int k = 0; k < kS; ++k) mma_k16(c[n], a, bf[p][n][k]);
          } else {
            mma_k8(c[n], reinterpret_cast<const uint2*>(a_s)[lane], bf[p][n][0]);
          }
        }
#pragma unroll
        for (int k = 0; k < kGroupsPerTile; ++k) {
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            float v[kNT];
#pragma unroll
            for (int n = 0; n < kNT; ++n) v[n] = __shfl_sync(0xffffffffu, c[n][j], 4 * k + t);
            keep(p, j, pick(v, mine), tile * kGroupsPerTile + k);
          }
        }
      } else {
        float(&r)[kNT][2] = run[kReduction == kFlatMin ? p : 0];
        if (kReduction == kGroupMin || s % kStagesPerTile == 0) {
#pragma unroll
          for (int n = 0; n < kNT; ++n) r[n][0] = r[n][1] = CUDART_INF_F;
        }
#pragma unroll (kSplit3 ? 2 : kMPerStage)
        for (int m = 0; m < kMPerStage; ++m) {
#pragma unroll
          for (int n = 0; n < kNT; ++n) {
            float c[4] = {0.0f, 0.0f, 0.0f, 0.0f};
            if constexpr (kSplit3) {
              const uint4 a = reinterpret_cast<const uint4*>(a_s)[m * 32 + lane];
#pragma unroll
              for (int k = 0; k < kS; ++k) mma_k16(c, a, bf[p][n][k]);
            } else {
              mma_k8(c, reinterpret_cast<const uint2*>(a_s)[m * 32 + lane], bf[p][n][0]);
            }
            r[n][0] = xs::min_nan(r[n][0], xs::min_nan(c[0], c[2]));
            r[n][1] = xs::min_nan(r[n][1], xs::min_nan(c[1], c[3]));
          }
        }
        if (kReduction == kGroupMin || s % kStagesPerTile == kStagesPerTile - 1) {
          // the row's minimum per pixel, over the 8 lanes of its column
          const int row = kReduction == kGroupMin ? s : tile * kGroupsPerTile;
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            float v[kNT];
#pragma unroll
            for (int n = 0; n < kNT; ++n) {
              float x = r[n][j];
              x = xs::min_nan(x, __shfl_xor_sync(0xffffffffu, x, 4));
              x = xs::min_nan(x, __shfl_xor_sync(0xffffffffu, x, 8));
              v[n] = xs::min_nan(x, __shfl_xor_sync(0xffffffffu, x, 16));
            }
            keep(p, j, pick(v, mine), row);
          }
        }
      }
    }
    __syncthreads();  // the buffer is refilled next
  }

  if (g < kNT) {
#pragma unroll
    for (int p = 0; p < kPasses; ++p) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int px = p * kPassPx + warp * kNT * 8 + g * 8 + 2 * t + j;
        out[static_cast<size_t>(b) * kBlock + px] = nan[p][j] ? kLastGroup : best_row[p][j];
      }
    }
  }
}

template <bool kSplit3, int kReduction>
int launch(const uint32_t* g4s, const float* feats, const int* band_of_block, int* out,
           int n_blocks, int block, cudaStream_t stream) {
  switch (block) {
    case kPassPx:
      group_argmin_tc_kernel<kSplit3, kReduction, 1><<<n_blocks, kThreads, 0, stream>>>(
          g4s, feats, band_of_block, out);
      break;
    case 2 * kPassPx:
      group_argmin_tc_kernel<kSplit3, kReduction, 2><<<n_blocks, kThreads, 0, stream>>>(
          g4s, feats, band_of_block, out);
      break;
    case 4 * kPassPx:
      group_argmin_tc_kernel<kSplit3, kReduction, 4><<<n_blocks, kThreads, 0, stream>>>(
          g4s, feats, band_of_block, out);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

template <bool kSplit3>
int launch_reduction(int reduction, const uint32_t* g4s, const float* feats,
                     const int* band_of_block, int* out, int n_blocks, int block,
                     cudaStream_t stream) {
  switch (reduction) {
    case kGroupMin:
      return launch<kSplit3, kGroupMin>(g4s, feats, band_of_block, out, n_blocks, block, stream);
    case kFlatMin:
      return launch<kSplit3, kFlatMin>(g4s, feats, band_of_block, out, n_blocks, block, stream);
    case kNone:
      return launch<kSplit3, kNone>(g4s, feats, band_of_block, out, n_blocks, block, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// g4 (n_bands, 4, 4, 2048) f32 -> out, n_bands x 4 x 128 x 32 x (4 or 2)
// words: the A fragments of the product, split3 or rounded to bf16.
extern "C" int xs_split_g4(const float* g4, uint32_t* out, int n_bands, int split3,
                           void* stream) {
  if (n_bands == 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t n_words =
      static_cast<size_t>(n_bands) * kTiles * kMPerTile * 32 * (split3 ? 4 : 2);
  const unsigned blocks = static_cast<unsigned>((n_words + 255) / 256);
  if (split3) {
    split_g4_kernel<true><<<blocks, 256, 0, s>>>(g4, out, n_words);
  } else {
    split_g4_kernel<false><<<blocks, 256, 0, s>>>(g4, out, n_words);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int xs_group_argmin_variant_tc(const uint32_t* g4s, const float* feats,
                                          const int* band_of_block, int* out, int n_blocks,
                                          int block, int split3, int reduction, void* stream) {
  if (n_blocks == 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return split3 ? launch_reduction<true>(reduction, g4s, feats, band_of_block, out, n_blocks,
                                         block, s)
                : launch_reduction<false>(reduction, g4s, feats, band_of_block, out, n_blocks,
                                          block, s);
}
