// K3: direct-form slab refine, emitting the flat argmin index.
//
// Replaces xsarsea_tpu/ops/pallas_inversion.py:slab_refine_pallas (bodies
// _slab_block and _slab_sweep). It serves the inversion's unfused tail, taken
// when the crosspol LUT has its own incidence axis: the copol winner goes
// back to pixel order as an index, is decoded there, and the crosspol argmin
// runs re-bucketed by the crosspol axis (K4, crosspol_argmin.cu).
//
// One CUDA block per 128-pixel bucket block; every pixel of a block shares one
// (incidence band, wind-speed group), hence one 48-row x all-phi LUT slab,
// staged in shared memory (48 x 181 x 4 B = 35 KB at the production LUT).
// Each thread owns one pixel and runs K2's sweep (xs::copol_slab_argmin):
// row-major order, strict '<', first minimum. The output is the reference's
// raw index, sentinels included:
//   * a winner at slab row r, column c: (srow0 + r) * n_phi + c;
//   * any NaN cost in the slab: 2^30 (the TPU kernel's NaN min matches no lane);
//   * no finite cost: no_hit = ((2^30 / n_phi) & ~1) * n_phi (its init row, lane 0).
// The caller clips both sentinels to the last grid cell. Blocks that hold only
// padding (vmask == 0) write 0; nothing reads them.
//
// Bound on the H100: FP32 issue, as K2. Per pixel 48 x 181 = 8,688 entries x
// ~9 FP32 operations plus a compare and the NaN test. The slab is read from
// shared memory as a broadcast, u/v through the read-only cache at one address
// per warp. Device-memory traffic is 16 B/px in and 4 B/px out.
#include "inversion_common.cuh"

namespace {

__global__ void slab_refine_kernel(const float* __restrict__ lut_pad,
                                   const float* __restrict__ u_half,
                                   const float* __restrict__ v_half,
                                   const float* __restrict__ feats,
                                   const int* __restrict__ sband, const int* __restrict__ srow0,
                                   const int* __restrict__ vmask, int* __restrict__ out,
                                   int wp_rows, int n_phi, int n_rows, int no_hit) {
  extern __shared__ float slab[];
  const int b = blockIdx.x;
  const int t = threadIdx.x;
  const int block = blockDim.x;
  int* out_b = out + static_cast<size_t>(b) * block;
  if (vmask[b] == 0) {
    out_b[t] = 0;
    return;
  }
  const int r0 = srow0[b];
  const int entries = n_rows * n_phi;
  const float* src = lut_pad + (static_cast<size_t>(sband[b]) * wp_rows + r0) * n_phi;
  for (int i = t; i < entries; i += block) slab[i] = src[i];
  __syncthreads();

  // s0, ma/2, mz/2, 1/dsig in one 16-byte load
  const float4 f = reinterpret_cast<const float4*>(feats)[static_cast<size_t>(b) * block + t];
  const xs::SlabArgmin m = xs::copol_slab_argmin(
      slab, u_half + static_cast<size_t>(r0) * n_phi, v_half + static_cast<size_t>(r0) * n_phi,
      n_rows, n_phi, f.x, f.y, f.z, f.w);
  out_b[t] = xs::slab_flat_index(m, r0, n_phi, no_hit);
}

}  // namespace

extern "C" int xs_slab_refine(const float* lut_pad, const float* u_half, const float* v_half,
                              const float* feats, const int* sband, const int* srow0,
                              const int* vmask, int* out, int n_blocks, int block, int wp_rows,
                              int n_phi, int n_rows, int no_hit, void* stream) {
  if (n_blocks == 0) return 0;
  const size_t smem = static_cast<size_t>(n_rows) * n_phi * sizeof(float);
  cudaError_t err = xs::allow_smem(slab_refine_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  slab_refine_kernel<<<n_blocks, block, smem, static_cast<cudaStream_t>(stream)>>>(
      lut_pad, u_half, v_half, feats, sband, srow0, vmask, out, wp_rows, n_phi, n_rows, no_hit);
  return static_cast<int>(cudaGetLastError());
}
