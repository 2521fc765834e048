// K3: direct-form slab refine, emitting the flat argmin index.
//
// Replaces xsarsea_tpu/ops/pallas_inversion.py:slab_refine_pallas (bodies
// _slab_block and _slab_sweep). It serves the inversion's unfused tail, taken
// when the crosspol LUT has its own incidence axis: the copol winner goes
// back to pixel order as an index, is decoded there, and the crosspol argmin
// runs re-bucketed by the crosspol axis (K4, crosspol_argmin.cu).
//
// One CUDA block of 128 threads per 128-pixel bucket block; every pixel of a
// block shares one (incidence band, wind-speed group), hence one slab of
// n_rows x all-phi LUT entries (48 rows in the fused mode, 32 in
// fused_exact). The sweep is xs::slab::sweep (inversion_common.cuh), shared
// with K2 and K5: four pixels a thread, one row chain a warp (rows r = w mod
// 4), the slab's LUT, u and v rows streamed through shared memory 8 rows at a
// time (chunk_rows 16, 24 or 48 on request, for
// scripts/bench_slab_variants.py: the same bits), and 32-pixel groups of
// padding (all s0 NaN) not swept. The first minimum
// over (wspd-major, phi-minor) order wins, numpy's rule. The output is the
// reference's raw index, sentinels included:
//   * a winner at slab row r, column c: (srow0 + r) * n_phi + c;
//   * any NaN cost in the slab: 2^30 (the TPU kernel's NaN min matches no lane);
//     a pixel whose s0 is NaN gets it too, swept or not;
//   * no finite cost: no_hit = ((2^30 / n_phi) & ~1) * n_phi (its init row, lane 0).
// The caller clips both sentinels to the last grid cell. Blocks that hold only
// padding (vmask == 0) write 0; nothing reads them.
//
// As K2, the kernel reads its features through the bucket permutation from
// the pixel table (the first 4 floats of rows of stride floats; a padding
// slot's are NaN), and writes each pixel's index into pixel order,
// out[pixel]; padding slots and all-padding blocks write nothing there.
//
// Bound on the H100: FP32 issue, as K2. Per pixel (48 rows) 48 x 181 = 8,688 entries x
// 9 FP32 operations plus the compare (10 counted; none may fuse into an FMA,
// so half the 67 TFLOP/s peak is the ceiling). Issued per entry and pixel:
// the 9 and a NaN-propagating min, plus a quarter of a compare, a min and an
// index select (once per float4) and 3/16 of a float4 shared load: 11.25 in
// the SASS, against 29.25 for the one-pixel-a-thread loop this replaced; it
// runs at ~83% of that issue floor. Device-memory traffic is 16 B/px in and
// 4 B/px out.
#include "inversion_common.cuh"

namespace {

using xs::slab::kPixels;
using xs::slab::kThreads;

template <int kChunk>
__global__ void __launch_bounds__(kThreads)
    slab_refine_kernel(const float* __restrict__ lut_pad, const float* __restrict__ u_half,
                       const float* __restrict__ v_half, const float* __restrict__ feats,
                       const long long* __restrict__ index, int stride,
                       const int* __restrict__ sband, const int* __restrict__ srow0,
                       const int* __restrict__ vmask, int* __restrict__ out, int wp_rows,
                       int n_phi, int n_rows, int no_hit) {
  extern __shared__ __align__(16) float smem[];
  const int b = blockIdx.x;
  const int t = threadIdx.x;
  if (vmask[b] == 0) return;
  const int r0 = srow0[b];
  const size_t row0 = static_cast<size_t>(r0) * n_phi;
  const xs::slab::Slab slab{lut_pad + static_cast<size_t>(sband[b]) * wp_rows * n_phi + row0,
                            u_half + row0, v_half + row0, n_rows, n_phi};
  // feats rows: s0, ma/2, mz/2, 1/dsig
  const xs::Rows f{feats, stride, index + static_cast<size_t>(b) * kPixels};
  const xs::SlabArgmin m = xs::slab::sweep<xs::kDirect, kChunk>(smem, slab, f);
  const int flat = xs::slab_flat_index(m, r0, n_phi, no_hit);
  const long long px = f.pixel(t);
  if (px >= 0) out[px] = flat;
}

template <int kChunk>
int launch(const float* lut_pad, const float* u_half, const float* v_half, const float* feats,
           const long long* index, int stride, const int* sband, const int* srow0,
           const int* vmask, int* out, int n_blocks, int wp_rows, int n_phi, int n_rows,
           int no_hit, cudaStream_t stream) {
  const size_t smem = xs::slab::smem_bytes<xs::kDirect, kChunk>(n_phi, n_rows);
  cudaError_t err = xs::allow_smem(slab_refine_kernel<kChunk>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  slab_refine_kernel<kChunk><<<n_blocks, kThreads, smem, stream>>>(
      lut_pad, u_half, v_half, feats, index, stride, sband, srow0, vmask, out, wp_rows, n_phi,
      n_rows, no_hit);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// index: the slot -> pixel permutation (-1 for padding); feats: the pixel
// table, rows of stride >= 4 floats; out: (n_px,) in pixel order.
// chunk_rows: the sweep's stage height, 8 on every path (16, 24 and 48 for
// scripts/bench_slab_variants.py).
extern "C" int xs_slab_refine(const float* lut_pad, const float* u_half, const float* v_half,
                              const float* feats, const long long* index, int stride,
                              const int* sband, const int* srow0, const int* vmask, int* out,
                              int n_blocks, int block, int wp_rows, int n_phi, int n_rows,
                              int no_hit, int chunk_rows, void* stream) {
  if (block != kPixels) return static_cast<int>(cudaErrorInvalidValue);
  if (n_blocks == 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto run = [&](auto launcher) {
    return launcher(lut_pad, u_half, v_half, feats, index, stride, sband, srow0, vmask, out,
                    n_blocks, wp_rows, n_phi, n_rows, no_hit, s);
  };
  switch (chunk_rows) {
    case 8: return run(launch<8>);
    case 16: return run(launch<16>);
    case 24: return run(launch<24>);
    case 48: return run(launch<48>);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
