// K1: coarse copol wind-speed-group argmin.
//
// Replaces xsarsea_tpu/ops/pallas_inversion.py:copol_group_argmin_pallas
// (body _group_argmin_kernel). One CUDA block per 256-pixel bucket block;
// every pixel of a block shares one incidence band. The band's coarse grid
// (about 64 rows x 46 phi columns at the production 0.1 m/s x 1 deg LUT;
// rows sampled every ~0.8 m/s, columns every ~4 deg) is staged in shared
// memory with the halved u/v grids, about 35 KB. Each thread owns one pixel:
// it evaluates the direct-form cost of every coarse entry, keeps the running
// minimum of the current wind-speed group (16 LUT rows) and, at each group
// boundary, keeps the group with the strictly lower minimum, so the lowest
// group wins among equal minima. A pixel with no finite cost gets the last
// group, as the reference clips its no-hit sentinel.
//
// The TPU kernel evaluated an expanded-form cost as one bf16-split MXU
// matmul; the H100's CUDA cores evaluate the direct form, the same op order
// as K2 (slab_refine_fused.cu), which is the more accurate candidate.
//
// Bound on the H100: FP32 issue. Per pixel ~3k entries x ~9 FP32 operations
// plus a compare; the operand comes from shared memory as a broadcast (all
// threads read the same entry at the same time), pixels' features from one
// 16-byte load. Device-memory traffic is ~16 B/px in and 4 B/px out.
#include "inversion_common.cuh"

#include <math_constants.h>

namespace {

__global__ void group_argmin_kernel(const float* __restrict__ lut_c,
                                    const float* __restrict__ u_half,
                                    const float* __restrict__ v_half,
                                    const int* __restrict__ row_group,
                                    const float* __restrict__ feats,
                                    const int* __restrict__ band_of_block,
                                    int* __restrict__ out, int n_rows, int n_cols,
                                    int n_groups) {
  extern __shared__ float smem[];
  const int entries = n_rows * n_cols;
  float* s_lut = smem;
  float* s_u = smem + entries;
  float* s_v = smem + 2 * entries;
  const int b = blockIdx.x;
  const float* lut_b = lut_c + static_cast<size_t>(band_of_block[b]) * entries;
  for (int i = threadIdx.x; i < entries; i += blockDim.x) {
    s_lut[i] = lut_b[i];
    s_u[i] = u_half[i];
    s_v[i] = v_half[i];
  }
  __syncthreads();

  const size_t p = static_cast<size_t>(b) * blockDim.x + threadIdx.x;
  const float4 f = reinterpret_cast<const float4*>(feats)[p];  // s0, ma/2, mz/2, 1/dsig
  float best_min = CUDART_INF_F;
  int best_group = n_groups - 1;
  float group_min = CUDART_INF_F;
  for (int r = 0; r < n_rows; ++r) {
    const int base = r * n_cols;
    for (int c = 0; c < n_cols; ++c) {
      const float j = xs::copol_cost(s_lut[base + c], s_u[base + c], s_v[base + c], f.x, f.y,
                                     f.z, f.w);
      if (j < group_min) group_min = j;  // NaN never wins
    }
    const int g = row_group[r];
    if (r + 1 == n_rows || row_group[r + 1] != g) {
      if (group_min < best_min) {
        best_min = group_min;
        best_group = g;
      }
      group_min = CUDART_INF_F;
    }
  }
  out[p] = best_group;
}

}  // namespace

extern "C" const char* xs_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

extern "C" int xs_group_argmin(const float* lut_c, const float* u_half, const float* v_half,
                               const int* row_group, const float* feats,
                               const int* band_of_block, int* out, int n_blocks, int block,
                               int n_rows, int n_cols, int n_groups, void* stream) {
  if (n_blocks == 0) return 0;
  const size_t smem = 3 * static_cast<size_t>(n_rows) * n_cols * sizeof(float);
  cudaError_t err = xs::allow_smem(group_argmin_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  group_argmin_kernel<<<n_blocks, block, smem, static_cast<cudaStream_t>(stream)>>>(
      lut_c, u_half, v_half, row_group, feats, band_of_block, out, n_rows, n_cols, n_groups);
  return static_cast<int>(cudaGetLastError());
}
