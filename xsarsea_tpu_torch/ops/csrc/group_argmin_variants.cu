// K6 on CUDA cores: the coarse group-argmin pass in expanded (matmul) form,
// in the variants scripts/bench_kernel_variants.py measures; the engine
// "cuda_cores" of ops/experiment_kernels.py, the baseline of the tensor-core
// engine (group_argmin_variants_tc.cu).
//
// Replaces scripts/bench_kernel_variants.py:make_variant.run (body kernel),
// the TPU's K1 as an MXU product: per pixel p of a block sharing one band,
//   j[e] = g4[band, tile, 0, e] * f[0] + ... + g4[band, tile, 3, e] * f[3]
// over 4 tiles x 2048 entries, a reduction of each tile to 8 scratch rows and
// the first row holding the minimum of the 32, NaN propagating (any NaN row
// gives 2^30, clipped to 31). The variants:
//   * precision highest: f32 products summed left to right, no contraction;
//     default: both operands rounded to bf16 (RNE) first, which is the
//     TPU's single-pass bf16 Precision.DEFAULT; the products are then exact
//     in f32 and summed left to right in f32;
//   * reduction reshape / static_slices: the minimum of each 256-entry group
//     (two Mosaic codegen routes to one function: one code path here);
//     flat_min: the minimum of the whole tile in the tile's first row; the
//     TPU leaves the other 7 rows of scratch undefined, the port defines them
//     as +inf; none: the tile's first 8 entries as its 8 rows. The other 2040
//     entries of a tile are never read, so this kernel does not compute them.
//   * block: 256, 512 or 1024 pixels per CUDA block (the thread count).
//
// One thread per pixel, the product on the FP32 pipe, bit-equal to its plain
// version. Each tile of g4[band] is staged in shared memory as one float4 per
// entry (32 KB), all threads then read the same entry at once (a broadcast).
// A group's minimum is PTX min.NaN.f32, NaN propagating as the TPU's jnp.min;
// across the 32 rows a strict '<' keeps the first minimum.
//
// Bound on the H100: FP32 issue for the reducing variants. Per pixel
// 8,192 entries x (4 multiplies + 3 adds + 1 min) FP32 operations; the
// operand comes from shared memory, the pixel's features from 4 coalesced
// loads. Device-memory traffic is 16 B/px in, 4 B/px out and 128 KB of g4
// per band (L2-resident across the blocks of one band). 'none' reads 32
// entries per pixel and is bound by that traffic.
#include "inversion_common.cuh"

#include <cuda_bf16.h>

namespace {

constexpr int kTiles = 4;
constexpr int kTile = 2048;
constexpr int kGroupSize = 256;
constexpr int kGroupsPerTile = kTile / kGroupSize;  // 8 scratch rows per tile
constexpr int kLastGroup = kTiles * kGroupsPerTile - 1;

enum Reduction { kGroupMin = 0, kFlatMin = 1, kNone = 2 };

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ float dot4(float4 g, float f0, float f1, float f2, float f3) {
  return __fadd_rn(__fadd_rn(__fadd_rn(__fmul_rn(g.x, f0), __fmul_rn(g.y, f1)),
                             __fmul_rn(g.z, f2)),
                   __fmul_rn(g.w, f3));
}

template <bool kBf16, int kReduction>
__global__ void group_argmin_variant_kernel(const float* __restrict__ g4,
                                            const float* __restrict__ feats,
                                            const int* __restrict__ band_of_block,
                                            int* __restrict__ out) {
  __shared__ float4 s_g[kReduction == kNone ? kGroupsPerTile : kTile];
  constexpr int kRead = kReduction == kNone ? kGroupsPerTile : kTile;  // entries read per tile
  const int b = blockIdx.x;
  const int t = threadIdx.x;
  const int block = blockDim.x;
  const float* f_b = feats + static_cast<size_t>(b) * 4 * block;  // (4, block) per block
  float f0 = f_b[t], f1 = f_b[block + t], f2 = f_b[2 * block + t], f3 = f_b[3 * block + t];
  if (kBf16) {
    f0 = bf16_round(f0);
    f1 = bf16_round(f1);
    f2 = bf16_round(f2);
    f3 = bf16_round(f3);
  }
  const float* g_band = g4 + static_cast<size_t>(band_of_block[b]) * kTiles * 4 * kTile;

  float best = CUDART_INF_F;  // the rows' running first minimum
  int best_row = 0;           // row 0 is the answer when every row is +inf
  bool nan = false;
  for (int tile = 0; tile < kTiles; ++tile) {
    __syncthreads();  // the previous tile's reads are done
    const float* g_t = g_band + static_cast<size_t>(tile) * 4 * kTile;
    for (int e = t; e < kRead; e += block) {
      float4 g = make_float4(g_t[e], g_t[kTile + e], g_t[2 * kTile + e], g_t[3 * kTile + e]);
      if (kBf16) g = make_float4(bf16_round(g.x), bf16_round(g.y), bf16_round(g.z),
                                 bf16_round(g.w));
      s_g[e] = g;
    }
    __syncthreads();

    const int row0 = tile * kGroupsPerTile;
    if (kReduction == kNone) {
      for (int k = 0; k < kGroupsPerTile; ++k) {
        const float j = dot4(s_g[k], f0, f1, f2, f3);
        nan |= (j != j);
        if (j < best) {
          best = j;
          best_row = row0 + k;
        }
      }
    } else if (kReduction == kGroupMin) {
      for (int k = 0; k < kGroupsPerTile; ++k) {
        float m = CUDART_INF_F;
        for (int e = k * kGroupSize; e < (k + 1) * kGroupSize; ++e) {
          m = xs::min_nan(m, dot4(s_g[e], f0, f1, f2, f3));
        }
        nan |= (m != m);
        if (m < best) {
          best = m;
          best_row = row0 + k;
        }
      }
    } else {  // kFlatMin: rows row0 + 1 .. row0 + 7 are +inf and never win
      float m = CUDART_INF_F;
      for (int e = 0; e < kTile; ++e) m = xs::min_nan(m, dot4(s_g[e], f0, f1, f2, f3));
      nan |= (m != m);
      if (m < best) {
        best = m;
        best_row = row0;
      }
    }
  }
  out[static_cast<size_t>(b) * block + t] = nan ? kLastGroup : best_row;
}

template <bool kBf16, int kReduction>
int launch(const float* g4, const float* feats, const int* band_of_block, int* out,
           int n_blocks, int block, cudaStream_t stream) {
  group_argmin_variant_kernel<kBf16, kReduction><<<n_blocks, block, 0, stream>>>(
      g4, feats, band_of_block, out);
  return static_cast<int>(cudaGetLastError());
}

template <bool kBf16>
int launch_reduction(int reduction, const float* g4, const float* feats,
                     const int* band_of_block, int* out, int n_blocks, int block,
                     cudaStream_t stream) {
  switch (reduction) {
    case kGroupMin:
      return launch<kBf16, kGroupMin>(g4, feats, band_of_block, out, n_blocks, block, stream);
    case kFlatMin:
      return launch<kBf16, kFlatMin>(g4, feats, band_of_block, out, n_blocks, block, stream);
    case kNone:
      return launch<kBf16, kNone>(g4, feats, band_of_block, out, n_blocks, block, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" int xs_group_argmin_variant(const float* g4, const float* feats,
                                       const int* band_of_block, int* out, int n_blocks,
                                       int block, int bf16, int reduction, void* stream) {
  if (n_blocks == 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bf16 ? launch_reduction<true>(reduction, g4, feats, band_of_block, out, n_blocks,
                                       block, s)
              : launch_reduction<false>(reduction, g4, feats, band_of_block, out, n_blocks,
                                        block, s);
}
