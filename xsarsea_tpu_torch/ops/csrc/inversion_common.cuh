// Shared device helpers of the inversion kernels.
//
// The per-entry Bayesian cost of the copol argmin, in the exact op order of
// the reference sweep (xsarsea_tpu/ops/pallas_inversion.py:_slab_sweep):
//   j = ((l - s0) * inv_dsig)^2 + (u/2 - ma/2)^2 + (v/2 - mz/2)^2
// summed left to right, each square a plain product. The __f*_rn intrinsics
// pin every rounding (no multiply-add contraction, whatever the flags), so
// the kernels agree bit for bit with their plain PyTorch versions.
#pragma once

#include <cuda_runtime.h>
#include <math_constants.h>

namespace xs {

__device__ __forceinline__ float copol_cost(float l, float u_half, float v_half, float s0,
                                            float ma_half, float mz_half, float inv_dsig) {
  const float d0 = __fmul_rn(__fsub_rn(l, s0), inv_dsig);
  const float d1 = __fsub_rn(u_half, ma_half);
  const float d2 = __fsub_rn(v_half, mz_half);
  return __fadd_rn(__fadd_rn(__fmul_rn(d0, d0), __fmul_rn(d1, d1)), __fmul_rn(d2, d2));
}

// The two rewrites of that cost that scripts/bench_slab_forms.py measures
// (K5), with the operands their builders give:
//   prescaled:   (l' - s0')^2 + (u/2 - ma/2)^2 + (v/2 - mz/2)^2, where
//                l' = l * inv_dsig and s0' = s0 * inv_dsig, each rounded f32;
//   expanded_uv: ((t*t + kr) + u2 * ma/2) + v2 * mz/2, t = l' - s0', with
//                kr = (u/2)^2 + (v/2)^2 and u2 = -2 * u/2, v2 = -2 * v/2 per
//                entry, dropping the per-pixel constant (ma/2)^2 + (mz/2)^2.
__device__ __forceinline__ float prescaled_cost(float l, float u_half, float v_half, float s0,
                                                float ma_half, float mz_half) {
  const float d0 = __fsub_rn(l, s0);
  const float d1 = __fsub_rn(u_half, ma_half);
  const float d2 = __fsub_rn(v_half, mz_half);
  return __fadd_rn(__fadd_rn(__fmul_rn(d0, d0), __fmul_rn(d1, d1)), __fmul_rn(d2, d2));
}

__device__ __forceinline__ float expanded_uv_cost(float l, float kr, float u2, float v2,
                                                  float s0, float ma_half, float mz_half) {
  const float t = __fsub_rn(l, s0);
  return __fadd_rn(__fadd_rn(__fadd_rn(__fmul_rn(t, t), kr), __fmul_rn(u2, ma_half)),
                   __fmul_rn(v2, mz_half));
}

// The first minimum of one pixel's slab sweep: its row within the slab
// (-1 when no cost is finite and below +inf), its column, and whether any
// cost was NaN (the reference's NaN-propagating min poisons the pixel).
struct SlabArgmin {
  int row;
  int col;
  bool poisoned;
};

// Direct-form copol argmin over an n_rows x n_phi LUT slab (K2, K3 and K5's
// direct form). The slab sits in shared memory; u_b/v_b point at the slab's
// first row of the halved wind-component grids in device memory. One thread
// sweeps its pixel in row-major (wspd-major, phi-minor) order with a strict
// '<': the first minimum wins, numpy's rule.
__device__ __forceinline__ SlabArgmin copol_slab_argmin(const float* slab,
                                                        const float* __restrict__ u_b,
                                                        const float* __restrict__ v_b,
                                                        int n_rows, int n_phi, float s0,
                                                        float ma_half, float mz_half,
                                                        float inv_dsig) {
  float best = CUDART_INF_F;
  SlabArgmin m{-1, 0, false};
  for (int r = 0; r < n_rows; ++r) {
    const int base = r * n_phi;
    for (int c = 0; c < n_phi; ++c) {
      const float j = copol_cost(slab[base + c], __ldg(u_b + base + c), __ldg(v_b + base + c),
                                 s0, ma_half, mz_half, inv_dsig);
      m.poisoned |= (j != j);
      if (j < best) {
        best = j;
        m.row = r;
        m.col = c;
      }
    }
  }
  return m;
}

// Sentinels of K3's and K5's flat index: a NaN cost anywhere in the slab
// (the TPU kernel's NaN min matches no lane), and the no-hit index the caller
// passes, ((2^30 / n_phi) & ~1) * n_phi (the sweep's init row at lane 0).
constexpr int kNanIdx = 1 << 30;

__device__ __forceinline__ int slab_flat_index(SlabArgmin m, int r0, int n_phi, int no_hit) {
  if (m.poisoned) return kNanIdx;
  if (m.row < 0) return no_hit;
  return (r0 + m.row) * n_phi + m.col;
}

// Crosspol 1-D argmin over one LUT row (K2 and K4), the reference's
// _crosspol_kernel: j = ((lut - s0) / dsig)^2 + (w/2 - wco/2)^2 * has_co, a
// true divide, first minimum by index. Returns the winning wind speed
// (w/2 + w/2 == w exactly), or 0 when any cost is NaN.
__device__ __forceinline__ float crosspol_argmin(const float* row, const float* w_half, int n_cr,
                                                 float s0_cr, float dsig_cr, float wco_half,
                                                 float has_co) {
  float best = CUDART_INF_F;
  int best_k = 0;
  bool poisoned = false;
  for (int k = 0; k < n_cr; ++k) {
    const float d = __fdiv_rn(__fsub_rn(row[k], s0_cr), dsig_cr);
    const float dw = __fsub_rn(w_half[k], wco_half);
    const float j = __fadd_rn(__fmul_rn(d, d), __fmul_rn(__fmul_rn(dw, dw), has_co));
    poisoned |= (j != j);
    if (j < best) {
      best = j;
      best_k = k;
    }
  }
  const float wh = w_half[best_k];
  return poisoned ? 0.0f : __fadd_rn(wh, wh);
}

// Dynamic shared memory above the 48 KB default needs an explicit opt-in.
template <typename Kernel>
inline cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

}  // namespace xs
