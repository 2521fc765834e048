// K1: copol wind-speed-group argmin, in two forms.
//
// Replaces xsarsea_tpu/ops/pallas_inversion.py:copol_group_argmin_pallas
// (body _group_argmin_kernel). One CUDA block per 256-pixel bucket block;
// every pixel of a block shares one incidence band. Per pixel: the direct-form
// cost (xs::copol_cost, K2's op order) over the band's grid, the minimum per
// wind-speed group (row_group, 16 LUT rows a group), and the group with the
// lowest minimum, the lowest group among equal minima. A NaN cost never wins;
// a pixel with no cost below +inf gets the last group, as the reference clips
// its no-hit sentinel.
//
// The grid is the coarse one of the fused mode (64 rows x 46 phi columns at
// the production 0.1 m/s x 1 deg LUT; rows sampled every ~0.8 m/s, columns
// every ~4 deg), or the full one of the fused_exact mode (499 x 181). The
// staged form (group_argmin_kernel) holds the band's whole grid in shared
// memory; the streamed form (group_argmin_streamed_kernel) passes it through
// shared memory 16 rows at a time, for grids that do not fit (the full grid's
// three planes take 1.1 MB).
//
// The TPU kernel evaluated an expanded-form cost as one bf16-split MXU
// matmul; the H100's CUDA cores evaluate the direct form, which is the more
// accurate candidate.
//
// Bound on the H100: FP32 instructions (9 cost operations and a min per
// entry and pixel against 16 B in and 4 B out a pixel), so the loop is built
// to execute little else, in the shape of the slab sweep (xs::slab::sweep):
//  * 256 threads, 8 warps = 2 pixel sets x 4 chains. Lane l of a set's warps
//    owns the pixels l, l + 32, l + 64, l + 96 of its 128-pixel set (4 a
//    thread), so one broadcast read of (l, u, v) from shared memory feeds four
//    cost evaluations and a thread carries four independent chains.
//  * Staged form: chain c takes the groups g = c (mod 4): a group's minimum
//    lives in one chain, and a chain meets its groups in ascending order
//    (row_group is non-decreasing), so a strict '<' at each group boundary
//    keeps the lowest group. Streamed form: chain c takes the rows r = c
//    (mod 4), so each chain has work in every 16-row chunk; a chain keeps the
//    lowest (row minimum, group) it met, by a strict '<' at each row's end,
//    which over ascending rows keeps the lowest group among equal minima. In
//    both, the answer is the least (minimum, group) over all entries, so the
//    four chains' (minimum, group) merge through shared memory by (minimum,
//    group).
//  * Only the group's minimum is needed, not the entry: a float4's four costs
//    reduce by fminf (FMNMX, which drops a NaN operand exactly as 'if (j <
//    m) m = j' does) and one more fminf folds them into the running minimum.
//    No compare and no select per entry; they happen once per group boundary
//    (staged) or row (streamed).
//  * Rows are held with a stride rounded up to 4 floats (46 -> 48, 181 ->
//    184) and read as float4s with no scalar tail: the LUT plane's padding is
//    NaN, whose cost is NaN, which fminf drops. The slab sweep cannot do this
//    (there a NaN poisons the pixel and no finite pad is safe for every s0
//    and 1/dsig); here a NaN never wins, so the pad is safe.
//  * A 32-pixel group whose s0 are all NaN (padding slots, or pixels without
//    copol sigma0) has only NaN costs: its pixels get the last group without a
//    sweep, a block with no other pixel stops before staging, and the sweep is
//    compiled per count of live groups (1-4).
// Shared memory, staged: 3 x 64 x 48 floats of operands, the row groups and
// 2 x 4 x 256 partials, 45 KB a block at the production LUT. Streamed: two
// stages of 3 x 16 x 184 floats filled by 4-byte cp.async (a LUT row of 181
// floats is not 16-byte aligned in device memory), the next chunk's copies in
// flight while this one is swept, and the partials written over the stages at
// the end: 71 KB, three blocks an SM.
#include "inversion_common.cuh"

#include <climits>

namespace {

constexpr int kPixels = 256;                     // pixels per block: GROUP_BLOCK
constexpr int kPix = 4;                          // pixels a thread
constexpr int kChains = 4;                       // group chains per pixel set
constexpr int kSetPixels = 32 * kPix;            // pixels per set
constexpr int kSets = kPixels / kSetPixels;
constexpr int kWarps = kSets * kChains;
constexpr int kThreads = 32 * kWarps;

__host__ __device__ constexpr int row_stride(int n_cols) { return (n_cols + 3) & ~3; }

size_t smem_bytes(int n_rows, int n_cols) {
  return (3 * static_cast<size_t>(n_rows) * row_stride(n_cols) + 2 * kChains * kPixels +
          n_rows) * sizeof(float);
}

// The block's staged operands: l, u/2, v/2 planes of n_rows x ld floats and
// the group of each row.
struct Coarse {
  const float* l;
  const float* u;
  const float* v;
  const int* row_group;
  int n_rows;
  int ld;
};

// A block of padding only (every s0 NaN) gets the last group everywhere and
// stops; true for every thread of such a block.
__device__ __forceinline__ bool padding_only(const float4* __restrict__ feats_b, int* out_b,
                                             int n_groups) {
  bool live_any = false;  // an s0 that is not NaN
  for (int p = threadIdx.x; p < kPixels; p += kThreads) {
    const float s0 = feats_b[p].x;
    live_any |= s0 == s0;
  }
  if (__syncthreads_or(live_any)) return false;
  for (int p = threadIdx.x; p < kPixels; p += kThreads) out_b[p] = n_groups - 1;
  return true;
}

// Merge the chains' partial (minimum, group) of each pixel by (minimum,
// group) and write the block's groups; a pixel with no minimum below +inf,
// or of a 32-pixel group that was not swept, gets the last group.
__device__ __forceinline__ void merge_partials(const float4* __restrict__ feats_b,
                                               const float* part_best, const int* part_g,
                                               int* out_b, int n_groups) {
  for (int p = threadIdx.x; p < kPixels; p += kThreads) {
    const float s0 = feats_b[p].x;
    int group = n_groups - 1;
    // a warp meets one whole 32-pixel group here (kThreads is a multiple of 32)
    if (__any_sync(0xffffffffu, s0 == s0)) {  // the group was swept
      float best = CUDART_INF_F;
      int best_g = INT_MAX;
      for (int c = 0; c < kChains; ++c) {
        const float m = part_best[c * kPixels + p];
        const int g = part_g[c * kPixels + p];
        if (m < best || (m == best && g < best_g)) {  // (minimum, group) order
          best = m;
          best_g = g;
        }
      }
      if (best < CUDART_INF_F) group = best_g;
    }
    out_b[p] = group;
  }
}

// One chain's sweep for the G live 32-pixel groups (the set bits of live) of
// its pixel set: feats_set points at the set's first pixel, part_best/part_g
// at the chain's partials of that pixel.
template <int G>
__device__ __forceinline__ void sweep_groups(const Coarse& t, int chain,
                                             const float4* __restrict__ feats_set, unsigned live,
                                             float* part_best, int* part_g) {
  const int lane = threadIdx.x & 31;
  int grp[G];
  float4 f[G];  // s0, ma/2, mz/2, 1/dsig
  float gmin[G], best[G];
  int best_g[G];
#pragma unroll
  for (int k = 0; k < G; ++k) {
    grp[k] = __ffs(live) - 1;
    live &= live - 1;
    f[k] = feats_set[32 * grp[k] + lane];
    gmin[k] = CUDART_INF_F;
    best[k] = CUDART_INF_F;
    best_g[k] = INT_MAX;
  }

  int cur = -1;  // the group whose minimum gmin holds
  for (int r = 0; r < t.n_rows; ++r) {
    const int g = t.row_group[r];
    if (g % kChains != chain) continue;
    if (g != cur) {
#pragma unroll
      for (int k = 0; k < G; ++k) {
        if (gmin[k] < best[k]) {
          best[k] = gmin[k];
          best_g[k] = cur;
        }
        gmin[k] = CUDART_INF_F;
      }
      cur = g;
    }
    const float* L = t.l + r * t.ld;
    const float* U = t.u + r * t.ld;
    const float* V = t.v + r * t.ld;
    for (int c = 0; c < t.ld; c += 4) {
      const float4 l = *reinterpret_cast<const float4*>(L + c);
      const float4 u = *reinterpret_cast<const float4*>(U + c);
      const float4 v = *reinterpret_cast<const float4*>(V + c);
#pragma unroll
      for (int k = 0; k < G; ++k) {
        const float j01 = fminf(xs::copol_cost(l.x, u.x, v.x, f[k].x, f[k].y, f[k].z, f[k].w),
                                xs::copol_cost(l.y, u.y, v.y, f[k].x, f[k].y, f[k].z, f[k].w));
        const float j23 = fminf(xs::copol_cost(l.z, u.z, v.z, f[k].x, f[k].y, f[k].z, f[k].w),
                                xs::copol_cost(l.w, u.w, v.w, f[k].x, f[k].y, f[k].z, f[k].w));
        gmin[k] = fminf(gmin[k], fminf(j01, j23));
      }
    }
  }
#pragma unroll
  for (int k = 0; k < G; ++k) {
    if (gmin[k] < best[k]) {  // the chain's last group
      best[k] = gmin[k];
      best_g[k] = cur;
    }
    part_best[32 * grp[k] + lane] = best[k];
    part_g[32 * grp[k] + lane] = best_g[k];
  }
}

__global__ void __launch_bounds__(kThreads) group_argmin_kernel(
    const float* __restrict__ lut_c, const float* __restrict__ u_half,
    const float* __restrict__ v_half, const int* __restrict__ row_group,
    const float* __restrict__ feats, const int* __restrict__ band_of_block,
    int* __restrict__ out, int n_rows, int n_cols, int n_groups) {
  extern __shared__ __align__(16) float smem[];
  const int b = blockIdx.x;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const float4* feats_b = reinterpret_cast<const float4*>(feats) + static_cast<size_t>(b) * kPixels;
  int* out_b = out + static_cast<size_t>(b) * kPixels;

  if (padding_only(feats_b, out_b, n_groups)) return;

  const int ld = row_stride(n_cols);
  const int plane = n_rows * ld;
  float* s_l = smem;
  float* s_u = smem + plane;
  float* s_v = smem + 2 * plane;
  float* part_best = smem + 3 * plane;
  int* part_g = reinterpret_cast<int*>(part_best + kChains * kPixels);
  int* s_rg = part_g + kChains * kPixels;
  const float* lut_b = lut_c + static_cast<size_t>(band_of_block[b]) * n_rows * n_cols;
  for (int r = warp; r < n_rows; r += kWarps) {
    for (int c = lane; c < ld; c += 32) {
      const bool real = c < n_cols;
      s_l[r * ld + c] = real ? lut_b[r * n_cols + c] : CUDART_NAN_F;  // a NaN cost never wins
      s_u[r * ld + c] = real ? u_half[r * n_cols + c] : 0.0f;
      s_v[r * ld + c] = real ? v_half[r * n_cols + c] : 0.0f;
    }
  }
  for (int r = threadIdx.x; r < n_rows; r += kThreads) s_rg[r] = row_group[r];
  __syncthreads();

  {
    const int set = warp / kChains;
    const int chain = warp % kChains;
    const float4* feats_set = feats_b + set * kSetPixels;
    unsigned live = 0;
#pragma unroll
    for (int k = 0; k < kPix; ++k) {
      const float s0 = feats_set[32 * k + lane].x;
      live |= static_cast<unsigned>(__any_sync(0xffffffffu, s0 == s0)) << k;
    }
    const Coarse t{s_l, s_u, s_v, s_rg, n_rows, ld};
    float* pb = part_best + chain * kPixels + set * kSetPixels;
    int* pg = part_g + chain * kPixels + set * kSetPixels;
    switch (__popc(live)) {
      case 1: sweep_groups<1>(t, chain, feats_set, live, pb, pg); break;
      case 2: sweep_groups<2>(t, chain, feats_set, live, pb, pg); break;
      case 3: sweep_groups<3>(t, chain, feats_set, live, pb, pg); break;
      case 4: sweep_groups<4>(t, chain, feats_set, live, pb, pg); break;
      default: break;  // no live group in this set
    }
  }
  __syncthreads();

  merge_partials(feats_b, part_best, part_g, out_b, n_groups);
}

// ------------------------------------------------------------ streamed form

constexpr int kChunkRows = 16;  // grid rows per shared-memory stage

size_t streamed_smem_bytes(int n_cols) {
  const size_t stages = 2 * 3 * static_cast<size_t>(kChunkRows) * row_stride(n_cols);
  const size_t partials = 2 * kChains * kPixels;
  return (stages > partials ? stages : partials) * sizeof(float);
}

// Issue the copies of grid rows [row0, row0 + rows) of the band's LUT plane
// and of u/2, v/2 into one stage (l, u, v planes of kChunkRows x ld floats,
// the pad columns set once beforehand), as one cp.async group.
__device__ __forceinline__ void stage_chunk(float* stage, const float* __restrict__ lut_b,
                                            const float* __restrict__ u_half,
                                            const float* __restrict__ v_half, int row0, int rows,
                                            int n_cols, int ld) {
  const int plane = kChunkRows * ld;
  const size_t src0 = static_cast<size_t>(row0) * n_cols;
  for (int i = threadIdx.x; i < rows * n_cols; i += kThreads) {
    const int rr = i / n_cols;
    const int c = i - rr * n_cols;
    const int dst = rr * ld + c;
    xs::slab::cp_async4(stage + dst, lut_b + src0 + i);
    xs::slab::cp_async4(stage + plane + dst, u_half + src0 + i);
    xs::slab::cp_async4(stage + 2 * plane + dst, v_half + src0 + i);
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// One chain's pixels in the streamed form: features and the least (row
// minimum, group) met so far, across chunks.
struct StreamChains {
  float4 f[kPix];  // s0, ma/2, mz/2, 1/dsig
  float best[kPix];
  int best_g[kPix];
  int grp[kPix];  // the live 32-pixel groups of the set, in order
};

// Sweep the chain's rows of one staged chunk (rows rr = chain, chain + 4, ...
// of `rows`) for the G live groups.
template <int G>
__device__ __forceinline__ void sweep_chunk(StreamChains& ch, const float* stage,
                                            const int* __restrict__ row_group, int row0,
                                            int rows, int chain, int ld) {
  const int plane = kChunkRows * ld;
  for (int rr = chain; rr < rows; rr += kChains) {
    const float* L = stage + rr * ld;
    const float* U = L + plane;
    const float* V = U + plane;
    float rmin[G];
#pragma unroll
    for (int k = 0; k < G; ++k) rmin[k] = CUDART_INF_F;
    for (int c = 0; c < ld; c += 4) {
      const float4 l = *reinterpret_cast<const float4*>(L + c);
      const float4 u = *reinterpret_cast<const float4*>(U + c);
      const float4 v = *reinterpret_cast<const float4*>(V + c);
#pragma unroll
      for (int k = 0; k < G; ++k) {
        const float4 f = ch.f[k];
        const float j01 = fminf(xs::copol_cost(l.x, u.x, v.x, f.x, f.y, f.z, f.w),
                                xs::copol_cost(l.y, u.y, v.y, f.x, f.y, f.z, f.w));
        const float j23 = fminf(xs::copol_cost(l.z, u.z, v.z, f.x, f.y, f.z, f.w),
                                xs::copol_cost(l.w, u.w, v.w, f.x, f.y, f.z, f.w));
        rmin[k] = fminf(rmin[k], fminf(j01, j23));
      }
    }
    const int g = __ldg(row_group + row0 + rr);
#pragma unroll
    for (int k = 0; k < G; ++k) {
      if (rmin[k] < ch.best[k]) {  // rows ascend: the first (lowest) group keeps a tie
        ch.best[k] = rmin[k];
        ch.best_g[k] = g;
      }
    }
  }
}

__global__ void __launch_bounds__(kThreads, 3) group_argmin_streamed_kernel(
    const float* __restrict__ lut_c, const float* __restrict__ u_half,
    const float* __restrict__ v_half, const int* __restrict__ row_group,
    const float* __restrict__ feats, const int* __restrict__ band_of_block,
    int* __restrict__ out, int n_rows, int n_cols, int n_groups) {
  extern __shared__ __align__(16) float smem[];
  const int b = blockIdx.x;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const float4* feats_b = reinterpret_cast<const float4*>(feats) + static_cast<size_t>(b) * kPixels;
  int* out_b = out + static_cast<size_t>(b) * kPixels;

  if (padding_only(feats_b, out_b, n_groups)) return;

  const int ld = row_stride(n_cols);
  const int plane = kChunkRows * ld;
  const float* lut_b = lut_c + static_cast<size_t>(band_of_block[b]) * n_rows * n_cols;
  // the stride's pad columns of both stages, which no copy touches: a NaN
  // LUT value (its cost never wins) and zero u/2, v/2
  const int pad = ld - n_cols;
  for (int i = threadIdx.x; i < 2 * 3 * kChunkRows * pad; i += kThreads) {
    const int row = i / pad;  // over the 2 x 3 x kChunkRows rows of both stages
    smem[row * ld + n_cols + (i - row * pad)] = ((row / kChunkRows) % 3 == 0) ? CUDART_NAN_F
                                                                             : 0.0f;
  }

  const int set = warp / kChains;
  const int chain = warp % kChains;
  const float4* feats_set = feats_b + set * kSetPixels;
  unsigned live = 0;
#pragma unroll
  for (int k = 0; k < kPix; ++k) {
    const float s0 = feats_set[32 * k + lane].x;
    live |= static_cast<unsigned>(__any_sync(0xffffffffu, s0 == s0)) << k;
  }
  const int n_live = __popc(live);
  StreamChains ch;
#pragma unroll
  for (int k = 0; k < kPix; ++k) {
    ch.grp[k] = live ? __ffs(live) - 1 : 0;
    live &= live - 1;
    ch.f[k] = k < n_live ? feats_set[32 * ch.grp[k] + lane] : make_float4(0.f, 0.f, 0.f, 0.f);
    ch.best[k] = CUDART_INF_F;
    ch.best_g[k] = INT_MAX;
  }

  // every thread takes part in the staging and its barriers; a set with no
  // live group sweeps nothing
  const int n_chunks = (n_rows + kChunkRows - 1) / kChunkRows;
  stage_chunk(smem, lut_b, u_half, v_half, 0, min(kChunkRows, n_rows), n_cols, ld);
  for (int k = 0; k < n_chunks; ++k) {
    const int row0 = k * kChunkRows;
    if (k + 1 < n_chunks) {  // prefetch the next chunk into the other stage
      const int next = row0 + kChunkRows;
      stage_chunk(smem + ((k + 1) & 1) * 3 * plane, lut_b, u_half, v_half, next,
                  min(kChunkRows, n_rows - next), n_cols, ld);
      asm volatile("cp.async.wait_group 1;\n" ::: "memory");
    } else {
      asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    }
    __syncthreads();
    const float* stage = smem + (k & 1) * 3 * plane;
    const int rows = min(kChunkRows, n_rows - row0);
    switch (n_live) {
      case 1: sweep_chunk<1>(ch, stage, row_group, row0, rows, chain, ld); break;
      case 2: sweep_chunk<2>(ch, stage, row_group, row0, rows, chain, ld); break;
      case 3: sweep_chunk<3>(ch, stage, row_group, row0, rows, chain, ld); break;
      case 4: sweep_chunk<4>(ch, stage, row_group, row0, rows, chain, ld); break;
      default: break;  // no live group in this set
    }
    __syncthreads();  // the stage is refilled next, or reused for the partials
  }

  float* part_best = smem;
  int* part_g = reinterpret_cast<int*>(part_best + kChains * kPixels);
  float* pb = part_best + chain * kPixels + set * kSetPixels;
  int* pg = part_g + chain * kPixels + set * kSetPixels;
#pragma unroll
  for (int k = 0; k < kPix; ++k) {
    if (k < n_live) {
      pb[32 * ch.grp[k] + lane] = ch.best[k];
      pg[32 * ch.grp[k] + lane] = ch.best_g[k];
    }
  }
  __syncthreads();

  merge_partials(feats_b, part_best, part_g, out_b, n_groups);
}

}  // namespace

extern "C" const char* xs_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

extern "C" int xs_group_argmin(const float* lut_c, const float* u_half, const float* v_half,
                               const int* row_group, const float* feats,
                               const int* band_of_block, int* out, int n_blocks, int block,
                               int n_rows, int n_cols, int n_groups, void* stream) {
  if (block != kPixels) return static_cast<int>(cudaErrorInvalidValue);
  if (n_blocks == 0) return 0;
  const size_t smem = smem_bytes(n_rows, n_cols);
  cudaError_t err = xs::allow_smem(group_argmin_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  group_argmin_kernel<<<n_blocks, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      lut_c, u_half, v_half, row_group, feats, band_of_block, out, n_rows, n_cols, n_groups);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int xs_group_argmin_streamed(const float* lut_c, const float* u_half,
                                        const float* v_half, const int* row_group,
                                        const float* feats, const int* band_of_block, int* out,
                                        int n_blocks, int block, int n_rows, int n_cols,
                                        int n_groups, void* stream) {
  if (block != kPixels) return static_cast<int>(cudaErrorInvalidValue);
  if (n_blocks == 0) return 0;
  const size_t smem = streamed_smem_bytes(n_cols);
  cudaError_t err = xs::allow_smem(group_argmin_streamed_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  group_argmin_streamed_kernel<<<n_blocks, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      lut_c, u_half, v_half, row_group, feats, band_of_block, out, n_rows, n_cols, n_groups);
  return static_cast<int>(cudaGetLastError());
}
