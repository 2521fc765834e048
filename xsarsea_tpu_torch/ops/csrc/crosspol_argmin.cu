// K4: bucketed crosspol wind-speed argmin.
//
// Replaces xsarsea_tpu/ops/pallas_inversion.py:crosspol_argmin_pallas (body
// _crosspol_kernel). It serves the inversion's unfused tail, where pixels are
// re-bucketed by the crosspol LUT's own incidence axis: one CUDA block per
// 256-pixel bucket block, every pixel of a block sharing one crosspol band.
// The band's LUT row and the halved wind-speed row (Wc floats each, 155 for
// the sarwing crosspol LUT) are staged in shared memory. Each thread owns one
// pixel, features (s0_cr, dsig_cr, wco/2, has_co) in one 16-byte load, and
// runs K2's crosspol loop (xs::crosspol_argmin): j = ((lut - s0) / dsig)^2 +
// (w/2 - wco/2)^2 * has_co with a true divide, the first minimum by index,
// output w/2 + w/2 in m/s, 0 when any cost is NaN (padding slots included).
//
// Bound on the H100: launch and memory, not arithmetic. Per pixel ~155
// entries x 7 FP32 operations (one a divide) against 16 B in and 4 B out; the
// row is read from shared memory as a broadcast.
#include "inversion_common.cuh"

namespace {

__global__ void crosspol_argmin_kernel(const float* __restrict__ cr_lut,
                                       const float* __restrict__ w_half,
                                       const float* __restrict__ feats,
                                       const int* __restrict__ band_of_block,
                                       float* __restrict__ out, int n_cr) {
  extern __shared__ float smem[];
  float* s_row = smem;
  float* s_wh = smem + n_cr;
  const int b = blockIdx.x;
  const float* row = cr_lut + static_cast<size_t>(band_of_block[b]) * n_cr;
  for (int i = threadIdx.x; i < n_cr; i += blockDim.x) {
    s_row[i] = row[i];
    s_wh[i] = w_half[i];
  }
  __syncthreads();

  const size_t p = static_cast<size_t>(b) * blockDim.x + threadIdx.x;
  const float4 f = reinterpret_cast<const float4*>(feats)[p];
  out[p] = xs::crosspol_argmin(s_row, s_wh, n_cr, f.x, f.y, f.z, f.w);
}

}  // namespace

extern "C" int xs_crosspol_argmin(const float* cr_lut, const float* w_half, const float* feats,
                                  const int* band_of_block, float* out, int n_blocks, int block,
                                  int n_cr, void* stream) {
  if (n_blocks == 0) return 0;
  const size_t smem = 2 * static_cast<size_t>(n_cr) * sizeof(float);
  cudaError_t err = xs::allow_smem(crosspol_argmin_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  crosspol_argmin_kernel<<<n_blocks, block, smem, static_cast<cudaStream_t>(stream)>>>(
      cr_lut, w_half, feats, band_of_block, out, n_cr);
  return static_cast<int>(cudaGetLastError());
}
