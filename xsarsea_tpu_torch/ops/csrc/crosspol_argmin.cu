// K4: bucketed crosspol wind-speed argmin.
//
// Replaces xsarsea_tpu/ops/pallas_inversion.py:crosspol_argmin_pallas (body
// _crosspol_kernel). It serves the inversion's unfused tail, where pixels are
// re-bucketed by the crosspol LUT's own incidence axis: one CUDA block per
// 256-pixel bucket block, every pixel of a block sharing one crosspol band.
// Per pixel, features (s0_cr, dsig_cr, wco/2, has_co) in one 16-byte load:
// j = ((lut - s0) / dsig)^2 + (w/2 - wco/2)^2 * has_co with a correctly
// rounded quotient, the first minimum by index, output w/2 + w/2 in m/s, 0
// when any cost is NaN (padding slots included).
//
// Bound on the H100: FP32 instructions at the path's 155 entries (8 counted
// operations an entry against 16 B in and 4 B out a pixel). The loop is
// xs::crosspol::argmin (inversion_common.cuh), shared with K2's tail: the
// divide hoisted to one reciprocal a pixel, NaN through the propagating min,
// a float4's four costs reduced before one compare and select. Here a block
// is 64 threads, two warps of 128 pixels each; lane l owns the pixels l, l +
// 32, l + 64, l + 96 of its warp's 128 (4 a thread, the whole row each: the
// row is short, no chain split), so one float4 read of the row and of w/2
// from shared memory feeds sixteen costs. A 32-pixel group whose s0_cr are
// all NaN (padding) has only NaN costs and gets 0 without a sweep; the loop
// is compiled per count of live groups (1-4).
//
// The features come through the bucket permutation: slot s reads row
// index[s] of the pixel table (its first 4 floats, one 16-byte load; NaN for
// a padding slot) and writes its speed into pixel order, out[index[s]];
// padding slots write nothing there.
#include "inversion_common.cuh"

namespace {

constexpr int kPixels = 256;           // pixels per block: CR_BLOCK
constexpr int kPix = 4;                // pixels a thread
constexpr int kWarpPixels = 32 * kPix;
constexpr int kThreads = kPixels / kPix;

// The G live 32-pixel groups (the set bits of live) of a warp's 128 slots,
// the first of which is slot w0.
template <int G>
__device__ __forceinline__ void solve_groups(const float* s_row, const float* s_wh, int n_cr,
                                             const xs::Rows& feats, int w0,
                                             unsigned live, float* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  int grp[G];
  float4 f[G];
  float speed[G];
#pragma unroll
  for (int k = 0; k < G; ++k) {
    grp[k] = __ffs(live) - 1;
    live &= live - 1;
    f[k] = feats.head4(w0 + 32 * grp[k] + lane);
  }
  xs::crosspol::argmin<G>(s_row, s_wh, n_cr, f, speed);
#pragma unroll
  for (int k = 0; k < G; ++k) {
    const long long px = feats.pixel(w0 + 32 * grp[k] + lane);
    if (px >= 0) out[px] = speed[k];
  }
}

__global__ void __launch_bounds__(kThreads) crosspol_argmin_kernel(
    const float* __restrict__ cr_lut, const float* __restrict__ w_half,
    const float* __restrict__ feats, const long long* __restrict__ index, int stride,
    const int* __restrict__ band_of_block, float* __restrict__ out, int n_cr) {
  extern __shared__ __align__(16) float smem[];
  const int b = blockIdx.x;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  xs::crosspol::stage(smem, cr_lut + static_cast<size_t>(band_of_block[b]) * n_cr, w_half, n_cr,
                      kThreads);
  __syncthreads();
  const float* s_wh = smem + xs::crosspol::row_stride(n_cr);

  // features and results of the block's slots
  const xs::Rows f{feats, stride, index + static_cast<size_t>(b) * kPixels};
  const int w0 = warp * kWarpPixels;
  unsigned live = 0;
#pragma unroll
  for (int k = 0; k < kPix; ++k) {
    const float s0 = f.at(w0 + 32 * k + lane, 0);
    const bool any = __any_sync(0xffffffffu, s0 == s0) != 0;
    live |= static_cast<unsigned>(any) << k;
    if (!any) {  // every cost NaN
      const long long px = f.pixel(w0 + 32 * k + lane);
      if (px >= 0) out[px] = 0.0f;
    }
  }
  switch (__popc(live)) {
    case 1: solve_groups<1>(smem, s_wh, n_cr, f, w0, live, out); break;
    case 2: solve_groups<2>(smem, s_wh, n_cr, f, w0, live, out); break;
    case 3: solve_groups<3>(smem, s_wh, n_cr, f, w0, live, out); break;
    case 4: solve_groups<4>(smem, s_wh, n_cr, f, w0, live, out); break;
    default: break;  // padding only
  }
}

}  // namespace

// index: the slot -> pixel permutation (-1 for padding); feats: the pixel
// table, 16-byte aligned rows of stride floats, a multiple of 4; out: (n_px,)
// in pixel order.
extern "C" int xs_crosspol_argmin(const float* cr_lut, const float* w_half, const float* feats,
                                  const long long* index, int stride, const int* band_of_block,
                                  float* out, int n_blocks, int block, int n_cr, void* stream) {
  if (block != kPixels) return static_cast<int>(cudaErrorInvalidValue);
  if (n_blocks == 0) return 0;
  const size_t smem = xs::crosspol::smem_bytes(n_cr);
  cudaError_t err = xs::allow_smem(crosspol_argmin_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  crosspol_argmin_kernel<<<n_blocks, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      cr_lut, w_half, feats, index, stride, band_of_block, out, n_cr);
  return static_cast<int>(cudaGetLastError());
}
