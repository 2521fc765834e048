// K2: fused direct-form slab refine + decode + crosspol argmin.
//
// Replaces xsarsea_tpu/ops/pallas_inversion.py:slab_refine_fused_pallas
// (bodies _slab_cr_block and _slab_sweep). One CUDA block of 128 threads per
// 128-pixel bucket block; every pixel of a block shares one (incidence band,
// wind-speed group), hence one slab of n_rows LUT rows x all phi columns: 48
// rows in the fused mode, 32 in fused_exact (any height the sweep's 8-row
// chunks cover). Blocks that hold only padding (vmask == 0) write zeros and
// stop.
//
// The copol sweep is xs::slab::sweep (inversion_common.cuh), shared with K3
// and K5: four pixels a thread, one row chain a warp (rows r = w mod 4)
// merged by (cost, flat index), the slab's LUT, u and v rows streamed through
// shared memory 8 rows at a time (chunk_rows 16, 24 or 48 on request, for
// scripts/bench_slab_variants.py: the same bits), and 32-pixel groups whose
// s0 are all NaN not swept.
// The first minimum over (wspd-major, phi-minor) order wins, numpy's rule. A
// NaN cost anywhere (a NaN s0 included) poisons the pixel to (wspd 0, phi 0),
// as the reference's NaN-propagating min does. Then thread t takes pixel t:
// the winner decodes to wspd = w_pad[row] and phi = co_phir[col], and the
// crosspol cost ((lut - s0cr) / dsig_cr)^2 + (w/2 - wco/2)^2 * has_co (a
// correctly rounded quotient, as _crosspol_kernel) is minimized over the
// band's crosspol row, first minimum, emitting the winning wspd in m/s. That
// tail is xs::crosspol::argmin, K4's loop, one pixel a thread: once the
// sweep's partial minima are merged, the band's crosspol row and w/2 (771
// floats each, 6 KB) are staged into the sweep's shared memory and read from
// there as float4s, the divide hoisted to one reciprocal a pixel. It runs
// for every pixel whose crosspol sigma0 is not NaN, a pixel of a group that
// was not swept included (dual-pol data can miss copol alone); with a NaN
// crosspol sigma0 every crosspol cost is NaN and it gives 0.
//
// The kernel reads each slot's row of the pixel table through the bucket
// permutation (index: slot -> pixel, -1 for a padding slot, whose features
// are NaN) and writes wspd_co, phi and wspd_cr straight into pixel order,
// out[k * n_px + pixel]; padding slots and all-padding blocks write nothing.
// So neither copy exists: not the rows gathered into bucket order before the
// kernel, nor the results scattered back after it.
//
// Bound on the H100: FP32 issue. Per pixel (48-row slab) 48 x 181 = 8,688 entries x 10
// counted FP32 operations (see slab_refine.cu), then 771 crosspol entries x 8.
// Device-memory traffic is ~32 B/px in and 16 B/px out.
#include "inversion_common.cuh"

#include <algorithm>

namespace {

using xs::slab::kPixels;
using xs::slab::kThreads;

template <int kChunk>
__global__ void __launch_bounds__(kThreads) slab_refine_fused_kernel(
    const float* __restrict__ lut_pad, const float* __restrict__ u_half,
    const float* __restrict__ v_half, const float* __restrict__ w_pad,
    const float* __restrict__ co_phir, const float* __restrict__ cr_lut,
    const float* __restrict__ cr_whalf, const float* __restrict__ feats,
    const long long* __restrict__ index, int stride, const int* __restrict__ sband,
    const int* __restrict__ srow0, const int* __restrict__ vmask, float* __restrict__ out,
    long long n_px, int wp_rows, int n_phi, int n_rows, int n_cr, int has_cr) {
  extern __shared__ __align__(16) float smem[];
  const int b = blockIdx.x;
  const int t = threadIdx.x;
  if (vmask[b] == 0) return;
  const int band = sband[b];
  const int r0 = srow0[b];
  const size_t row0 = static_cast<size_t>(r0) * n_phi;
  const xs::slab::Slab slab{lut_pad + static_cast<size_t>(band) * wp_rows * n_phi + row0,
                            u_half + row0, v_half + row0, n_rows, n_phi};
  // feats rows: s0, ma/2, mz/2, 1/dsig, s0_cr, dsig_cr, 0, 0
  const xs::Rows f{feats, stride, index + static_cast<size_t>(b) * kPixels};
  const xs::SlabArgmin m = xs::slab::sweep<xs::kDirect, kChunk>(smem, slab, f);
  const bool hit = !m.poisoned && m.row >= 0;
  const float wspd_co = hit ? w_pad[r0 + m.row] : 0.0f;
  const float phi = m.poisoned ? 0.0f : co_phir[m.col];

  float wspd_cr = 0.0f;
  if (has_cr) {
    __syncthreads();  // every thread has read the sweep's partial minima
    xs::crosspol::stage(smem, cr_lut + static_cast<size_t>(band) * n_cr, cr_whalf, n_cr,
                        kThreads);
    __syncthreads();
    const float s0_cr = f.at(t, 4);
    if (s0_cr == s0_cr) {
      const float s0 = f.at(t, 0);
      const float has_co = (s0 != s0) ? 0.0f : 1.0f;
      const float wco_half = __fmul_rn(hit ? __fmul_rn(wspd_co, 0.5f) : 0.0f, has_co);
      const float4 fc[1] = {make_float4(s0_cr, f.at(t, 5), wco_half, has_co)};
      float speed[1];
      xs::crosspol::argmin<1>(smem, smem + xs::crosspol::row_stride(n_cr), n_cr, fc, speed);
      wspd_cr = speed[0];
    }
  }
  const long long px = f.pixel(t);
  if (px >= 0) {
    out[px] = wspd_co;
    out[n_px + px] = phi;
    out[2 * n_px + px] = wspd_cr;
  }
}

template <int kChunk>
int launch(const float* lut_pad, const float* u_half, const float* v_half, const float* w_pad,
           const float* co_phir, const float* cr_lut, const float* cr_whalf, const float* feats,
           const long long* index, int stride, const int* sband, const int* srow0,
           const int* vmask, float* out, long long n_px, int n_blocks, int wp_rows, int n_phi,
           int n_rows, int n_cr, int has_cr, cudaStream_t stream) {
  size_t smem = xs::slab::smem_bytes<xs::kDirect, kChunk>(n_phi, n_rows);
  if (has_cr) smem = std::max(smem, xs::crosspol::smem_bytes(n_cr));  // the staged row
  cudaError_t err = xs::allow_smem(slab_refine_fused_kernel<kChunk>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  slab_refine_fused_kernel<kChunk><<<n_blocks, kThreads, smem, stream>>>(
      lut_pad, u_half, v_half, w_pad, co_phir, cr_lut, cr_whalf, feats, index, stride, sband,
      srow0, vmask, out, n_px, wp_rows, n_phi, n_rows, n_cr, has_cr);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// index: the slot -> pixel permutation (-1 for padding); feats: the pixel
// table, rows of stride >= 6 floats; out: (3, n_px) in pixel order.
// chunk_rows: the sweep's stage height, 8 on every path (16, 24 and 48 for
// scripts/bench_slab_variants.py).
extern "C" int xs_slab_refine_fused(const float* lut_pad, const float* u_half,
                                    const float* v_half, const float* w_pad,
                                    const float* co_phir, const float* cr_lut,
                                    const float* cr_whalf, const float* feats,
                                    const long long* index, int stride, const int* sband,
                                    const int* srow0, const int* vmask, float* out,
                                    long long n_px, int n_blocks, int block, int wp_rows,
                                    int n_phi, int n_rows, int n_cr, int has_cr, int chunk_rows,
                                    void* stream) {
  if (block != kPixels) return static_cast<int>(cudaErrorInvalidValue);
  if (n_blocks == 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto run = [&](auto launcher) {
    return launcher(lut_pad, u_half, v_half, w_pad, co_phir, cr_lut, cr_whalf, feats, index,
                    stride, sband, srow0, vmask, out, n_px, n_blocks, wp_rows, n_phi, n_rows,
                    n_cr, has_cr, s);
  };
  switch (chunk_rows) {
    case 8: return run(launch<8>);
    case 16: return run(launch<16>);
    case 24: return run(launch<24>);
    case 48: return run(launch<48>);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
