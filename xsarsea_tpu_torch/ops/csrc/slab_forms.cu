// K5: the slab-refine sweep in three cost forms, emitting the flat argmin index.
//
// Replaces scripts/bench_slab_forms.py:run_form (body _form_kernel), the
// experiment that asks which cost form the slab sweep should use:
//   * direct:      ((l - s0) * inv_dsig)^2 + (u/2 - ma/2)^2 + (v/2 - mz/2)^2,
//                  K3's cost (xs::copol_cost);
//   * prescaled:   the LUT and s0 scaled by inv_dsig beforehand, one multiply
//                  fewer per entry (xs::prescaled_cost);
//   * expanded_uv: the wind terms expanded against a per-entry row operand
//                  kr = (u/2)^2 + (v/2)^2, two FP32 operations fewer than
//                  direct but a fourth operand (xs::expanded_uv_cost); near-ties
//                  can flip.
// The TPU kernel's pack-2 lanes, 128-lane padding and rows_per_iter were
// Mosaic scheduling: the flat index into the (W, P) grid does not depend on
// them, so the operands here are the port's unpacked K3 layout. Either loop
// writes K3's index with K3's sentinels: 2^30 for a NaN cost anywhere in the
// slab, no_hit for no finite cost, 0 in all-padding blocks (vmask == 0).
//
// Two loops, so that the experiment prices the forms on the sweep the path
// runs and keeps its "before":
//   * shared (the default): xs::slab::sweep<form, 8>, the sweep of K2 and K3
//     (inversion_common.cuh), its feature rows read as K2 and K3 read them,
//     through an index (the wrapper passes the identity permutation): 128
//     threads a 128-pixel block, four pixels a lane, one row chain a warp,
//     the slab's planes (l, u, v, and kr for expanded_uv) streamed through
//     shared memory 8 rows a stage by cp.async and read as float4s, the
//     NaN-propagating minimum, the (cost, flat index) merge. Its direct
//     form is K3, bit for bit. Bound on the H100: FP32 issue, as K3
//     (slab_refine.cu): 11.25 SASS instructions per entry and pixel for the
//     direct form, of which the cost is 9 FP32 operations; prescaled drops a
//     multiply, expanded_uv a subtraction and a multiply but adds a shared
//     load (a fourth float4 per four entries) and a fourth plane to every
//     stage (47 KB a block at 181 phi, 35 KB for the others).
//   * thread: the one-pixel-a-thread loop K2 and K3 ran before their sweep
//     was redesigned (xs::copol_slab_argmin's loop, written out per form): a
//     block per bucket block, one thread per pixel, the 48-row slab (and
//     kr) staged whole in shared memory, u/v through the read-only cache.
//     ~29 instructions per entry and pixel (two loads with their 64-bit
//     address arithmetic, the compare, three selects and the NaN test
//     around the FP32 operations) bound it, at ~12% of its FP32 bound, and
//     its prescaled form's multiply fewer gained nothing there.
// Device-memory traffic is 16 B/px in and 4 B/px out for both.
#include "inversion_common.cuh"

namespace {

using xs::kDirect;
using xs::kExpandedUV;
using xs::kPrescaled;
using xs::slab::kPixels;
using xs::slab::kThreads;

// The sweep of xs::copol_slab_argmin with the cost of a rewritten form: the
// same loop written out per form. (Through a template taking the cost as a
// lambda, the direct sweep measured ~8% slower here and ~4% in K2.)
template <int kForm>
__device__ __forceinline__ xs::SlabArgmin form_slab_argmin(const float* slab, const float* s_kr,
                                                           const float* __restrict__ u_b,
                                                           const float* __restrict__ v_b,
                                                           int n_rows, int n_phi, float s0,
                                                           float ma_half, float mz_half) {
  float best = CUDART_INF_F;
  xs::SlabArgmin m{-1, 0, false};
  for (int r = 0; r < n_rows; ++r) {
    const int base = r * n_phi;
    for (int c = 0; c < n_phi; ++c) {
      const int i = base + c;
      const float j =
          kForm == kPrescaled
              ? xs::prescaled_cost(slab[i], __ldg(u_b + i), __ldg(v_b + i), s0, ma_half, mz_half)
              : xs::expanded_uv_cost(slab[i], s_kr[i], __ldg(u_b + i), __ldg(v_b + i), s0,
                                     ma_half, mz_half);
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

template <int kForm>
__global__ void slab_forms_kernel(const float* __restrict__ lut, const float* __restrict__ u,
                                  const float* __restrict__ v, const float* __restrict__ kr,
                                  const float* __restrict__ feats, const int* __restrict__ sband,
                                  const int* __restrict__ srow0, const int* __restrict__ vmask,
                                  int* __restrict__ out, int wp_rows, int n_phi, int n_rows,
                                  int no_hit) {
  extern __shared__ float smem[];
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
  float* slab = smem;
  float* s_kr = smem + entries;  // expanded_uv only
  const float* src = lut + (static_cast<size_t>(sband[b]) * wp_rows + r0) * n_phi;
  const size_t row0 = static_cast<size_t>(r0) * n_phi;
  for (int i = t; i < entries; i += block) {
    slab[i] = src[i];
    if (kForm == kExpandedUV) s_kr[i] = kr[row0 + i];
  }
  __syncthreads();

  // (s0, ma/2, mz/2, 1/dsig) for direct; (s0 * inv_dsig, ma/2, mz/2, -) otherwise
  const float4 f = reinterpret_cast<const float4*>(feats)[static_cast<size_t>(b) * block + t];
  const float* u_b = u + row0;
  const float* v_b = v + row0;
  const xs::SlabArgmin m =
      kForm == kDirect
          ? xs::copol_slab_argmin(slab, u_b, v_b, n_rows, n_phi, f.x, f.y, f.z, f.w)
          : form_slab_argmin<kForm>(slab, s_kr, u_b, v_b, n_rows, n_phi, f.x, f.y, f.z);
  out_b[t] = xs::slab_flat_index(m, r0, n_phi, no_hit);
}

// The shared loop: K3's kernel on the sweep in form F, slot s's row of 4
// floats read at index[s]. feats rows (s0, ma/2, mz/2, 1/dsig) for the direct
// form, (s0 * inv_dsig, ma/2, mz/2, 1) for the other two.
template <xs::Form F>
__global__ void __launch_bounds__(kThreads)
    slab_forms_shared_kernel(const float* __restrict__ lut, const float* __restrict__ u,
                             const float* __restrict__ v, const float* __restrict__ kr,
                             const float* __restrict__ feats,
                             const long long* __restrict__ index, const int* __restrict__ sband,
                             const int* __restrict__ srow0, const int* __restrict__ vmask,
                             int* __restrict__ out, int wp_rows, int n_phi, int n_rows,
                             int no_hit) {
  extern __shared__ __align__(16) float sweep_smem[];
  const int b = blockIdx.x;
  const int t = threadIdx.x;
  int* out_b = out + static_cast<size_t>(b) * kPixels;
  if (vmask[b] == 0) {
    out_b[t] = 0;
    return;
  }
  const int r0 = srow0[b];
  const size_t row0 = static_cast<size_t>(r0) * n_phi;
  const xs::slab::Slab slab{lut + static_cast<size_t>(sband[b]) * wp_rows * n_phi + row0,
                            u + row0, v + row0, n_rows, n_phi,
                            F == kExpandedUV ? kr + row0 : nullptr};
  const xs::Rows f{feats, 4, index + static_cast<size_t>(b) * kPixels};
  const xs::SlabArgmin m = xs::slab::sweep<F>(sweep_smem, slab, f);
  out_b[t] = xs::slab_flat_index(m, r0, n_phi, no_hit);
}

template <int kForm>
int launch_shared(const float* lut, const float* u, const float* v, const float* kr,
                  const float* feats, const long long* index, const int* sband,
                  const int* srow0, const int* vmask, int* out, int n_blocks, int block,
                  int wp_rows, int n_phi, int n_rows, int no_hit, cudaStream_t stream) {
  constexpr xs::Form F = static_cast<xs::Form>(kForm);
  if (block != kPixels) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = xs::slab::smem_bytes<F>(n_phi, n_rows);
  cudaError_t err = xs::allow_smem(slab_forms_shared_kernel<F>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  slab_forms_shared_kernel<F><<<n_blocks, kThreads, smem, stream>>>(
      lut, u, v, kr, feats, index, sband, srow0, vmask, out, wp_rows, n_phi, n_rows, no_hit);
  return static_cast<int>(cudaGetLastError());
}

template <int kForm>
int launch(const float* lut, const float* u, const float* v, const float* kr,
           const float* feats, const int* sband, const int* srow0, const int* vmask, int* out,
           int n_blocks, int block, int wp_rows, int n_phi, int n_rows, int no_hit,
           cudaStream_t stream) {
  const size_t smem =
      (kForm == kExpandedUV ? 2 : 1) * static_cast<size_t>(n_rows) * n_phi * sizeof(float);
  cudaError_t err = xs::allow_smem(slab_forms_kernel<kForm>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  slab_forms_kernel<kForm><<<n_blocks, block, smem, stream>>>(
      lut, u, v, kr, feats, sband, srow0, vmask, out, wp_rows, n_phi, n_rows, no_hit);
  return static_cast<int>(cudaGetLastError());
}

template <int kForm>
int launch_loop(int loop, const float* lut, const float* u, const float* v, const float* kr,
                const float* feats, const long long* index, const int* sband, const int* srow0,
                const int* vmask, int* out, int n_blocks, int block, int wp_rows, int n_phi,
                int n_rows, int no_hit, cudaStream_t stream) {
  switch (loop) {
    case 0:
      return launch_shared<kForm>(lut, u, v, kr, feats, index, sband, srow0, vmask, out,
                                  n_blocks, block, wp_rows, n_phi, n_rows, no_hit, stream);
    case 1:
      return launch<kForm>(lut, u, v, kr, feats, sband, srow0, vmask, out, n_blocks, block,
                           wp_rows, n_phi, n_rows, no_hit, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// The experiment library's error names (ops/experiment_kernels.py).
extern "C" const char* xs_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// loop 0: the shared sweep, reading slot s's features at index[s]; 1: the
// one-pixel-a-thread baseline, reading them in slot order (index unused).
extern "C" int xs_slab_forms(int form, int loop, const float* lut, const float* u,
                             const float* v, const float* kr, const float* feats,
                             const long long* index, const int* sband, const int* srow0,
                             const int* vmask, int* out, int n_blocks, int block, int wp_rows,
                             int n_phi, int n_rows, int no_hit, void* stream) {
  if (n_blocks == 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (form) {
    case kDirect:
      return launch_loop<kDirect>(loop, lut, u, v, kr, feats, index, sband, srow0, vmask, out,
                                  n_blocks, block, wp_rows, n_phi, n_rows, no_hit, s);
    case kPrescaled:
      return launch_loop<kPrescaled>(loop, lut, u, v, kr, feats, index, sband, srow0, vmask,
                                     out, n_blocks, block, wp_rows, n_phi, n_rows, no_hit, s);
    case kExpandedUV:
      return launch_loop<kExpandedUV>(loop, lut, u, v, kr, feats, index, sband, srow0, vmask,
                                      out, n_blocks, block, wp_rows, n_phi, n_rows, no_hit, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
