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

namespace xs {

__device__ __forceinline__ float copol_cost(float l, float u_half, float v_half, float s0,
                                            float ma_half, float mz_half, float inv_dsig) {
  const float d0 = __fmul_rn(__fsub_rn(l, s0), inv_dsig);
  const float d1 = __fsub_rn(u_half, ma_half);
  const float d2 = __fsub_rn(v_half, mz_half);
  return __fadd_rn(__fadd_rn(__fmul_rn(d0, d0), __fmul_rn(d1, d1)), __fmul_rn(d2, d2));
}

// Dynamic shared memory above the 48 KB default needs an explicit opt-in.
template <typename Kernel>
inline cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

}  // namespace xs
