// K2: fused direct-form slab refine + decode + crosspol argmin.
//
// Replaces xsarsea_tpu/ops/pallas_inversion.py:slab_refine_fused_pallas
// (bodies _slab_cr_block and _slab_sweep). One CUDA block per 128-pixel
// bucket block; every pixel of a block shares one (incidence band, wind-speed
// group), hence one 48-row x all-phi LUT slab, staged in shared memory
// (48 x 181 x 4 B = 35 KB at the production LUT). Blocks that hold only
// padding (vmask == 0) write zeros and stop.
//
// Each thread owns one pixel and sweeps the slab in row-major (wspd-major,
// phi-minor) order with a strict '<' (xs::copol_slab_argmin, shared with K3):
// the first minimum wins, numpy's rule, with no cross-lane bookkeeping. A NaN
// cost anywhere poisons the pixel to (wspd 0, phi 0), as the reference's
// NaN-propagating min does. The winner
// decodes to wspd = w_pad[row] and phi = co_phir[col]. Then the crosspol
// cost ((lut - s0cr) / dsig_cr)^2 + (w/2 - wco/2)^2 * has_co (a true divide,
// as _crosspol_kernel; xs::crosspol_argmin, shared with K4) is minimized over
// the band's crosspol row, first minimum, emitting the winning wspd in m/s.
//
// Bound on the H100: FP32 issue. Per pixel 48 x 181 = 8,688 entries x ~9
// FP32 operations plus a compare and the NaN test, then ~800 crosspol
// entries. The slab is read from shared memory as a broadcast; u/v and the
// crosspol row come through the read-only cache, the same address for every
// thread of a warp. Device-memory traffic is ~32 B/px in and 16 B/px out.
#include "inversion_common.cuh"

namespace {

__global__ void slab_refine_fused_kernel(
    const float* __restrict__ lut_pad, const float* __restrict__ u_half,
    const float* __restrict__ v_half, const float* __restrict__ w_pad,
    const float* __restrict__ co_phir, const float* __restrict__ cr_lut,
    const float* __restrict__ cr_whalf, const float* __restrict__ feats,
    const int* __restrict__ sband, const int* __restrict__ srow0,
    const int* __restrict__ vmask, float* __restrict__ out, int wp_rows, int n_phi, int n_rows,
    int n_cr, int has_cr) {
  extern __shared__ float slab[];
  const int b = blockIdx.x;
  const int t = threadIdx.x;
  const int block = blockDim.x;
  float* out_b = out + static_cast<size_t>(b) * 4 * block;
  if (vmask[b] == 0) {
    out_b[t] = 0.0f;
    out_b[block + t] = 0.0f;
    out_b[2 * block + t] = 0.0f;
    out_b[3 * block + t] = 0.0f;
    return;
  }
  const int band = sband[b];
  const int r0 = srow0[b];
  const int entries = n_rows * n_phi;
  const float* src = lut_pad + (static_cast<size_t>(band) * wp_rows + r0) * n_phi;
  for (int i = t; i < entries; i += block) slab[i] = src[i];
  __syncthreads();

  const float* f = feats + (static_cast<size_t>(b) * block + t) * 8;
  const float s0 = f[0];
  const xs::SlabArgmin m = xs::copol_slab_argmin(
      slab, u_half + static_cast<size_t>(r0) * n_phi, v_half + static_cast<size_t>(r0) * n_phi,
      n_rows, n_phi, s0, f[1], f[2], f[3]);
  const bool hit = !m.poisoned && m.row >= 0;
  const float wspd_co = hit ? w_pad[r0 + m.row] : 0.0f;
  const float phi = m.poisoned ? 0.0f : co_phir[m.col];

  float wspd_cr = 0.0f;
  if (has_cr) {
    const float has_co = (s0 != s0) ? 0.0f : 1.0f;
    const float wco_half = __fmul_rn(hit ? __fmul_rn(wspd_co, 0.5f) : 0.0f, has_co);
    wspd_cr = xs::crosspol_argmin(cr_lut + static_cast<size_t>(band) * n_cr, cr_whalf, n_cr,
                                  f[4], f[5], wco_half, has_co);
  }
  out_b[t] = wspd_co;
  out_b[block + t] = phi;
  out_b[2 * block + t] = wspd_cr;
  out_b[3 * block + t] = 0.0f;
}

}  // namespace

extern "C" int xs_slab_refine_fused(const float* lut_pad, const float* u_half,
                                    const float* v_half, const float* w_pad,
                                    const float* co_phir, const float* cr_lut,
                                    const float* cr_whalf, const float* feats, const int* sband,
                                    const int* srow0, const int* vmask, float* out,
                                    int n_blocks, int block, int wp_rows, int n_phi, int n_rows,
                                    int n_cr, int has_cr, void* stream) {
  if (n_blocks == 0) return 0;
  const size_t smem = static_cast<size_t>(n_rows) * n_phi * sizeof(float);
  cudaError_t err = xs::allow_smem(slab_refine_fused_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  slab_refine_fused_kernel<<<n_blocks, block, smem, static_cast<cudaStream_t>(stream)>>>(
      lut_pad, u_half, v_half, w_pad, co_phir, cr_lut, cr_whalf, feats, sband, srow0, vmask,
      out, wp_rows, n_phi, n_rows, n_cr, has_cr);
  return static_cast<int>(cudaGetLastError());
}
