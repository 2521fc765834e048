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
//    (mod 4), so each chain has work in every 16-row chunk; groups are met
//    out of order (below), so a chain keeps the least (row minimum, group)
//    lexicographically at each row's end. In both, the answer is the least
//    (minimum, group) over all entries, so the four chains' (minimum, group)
//    merge through shared memory by (minimum, group).
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
// flight while this one is swept, the partials written over the stages at
// the end, 256 merged best costs, the chunks' radii and ten masks of a bit a
// chunk: 72 KB at the full grid's 32 chunks, three blocks an SM.
//
// The streamed form sweeps only the grid rows a pixel can still win in. What
// bounds it is FP32 instructions on the cells it sweeps, so the work it skips
// is what it gains (at the full grid, every pixel's 499 x 181 cells
// otherwise). The unit of pruning is a chunk: the 16 rows of one stage. At
// the full grid (row_group = row / 16) a chunk is one wind-speed group; on
// any other non-decreasing row_group each of its rows keeps its own group.
//  * The bound. A cell's cost is (t1 + t2) + t3 with t1 = ((l - s0) *
//    inv_dsig)^2 >= 0 (or NaN, which never wins), t2 = fl(fl(u/2 - ma/2)^2) and
//    t3 likewise, each step rounded to nearest. Rounding is monotone and t2
//    is a float, so fl(t1 + t2) >= t2 and the cost >= fl(t2 + t3). With the
//    exact distance D from the prior P = (ma/2, mz/2) to the cell (u/2, v/2),
//    each subtraction, square and sum loses at most a factor (1 - 2^-24)
//    (a subtraction or sum landing in the subnormal range is exact, a square
//    landing there loses at most 2^-150), so fl(t2 + t3) >= D^2 (1 - 2^-22)
//    - 2^-149; an overflow gives +inf, above any bound. The cells of chunk c
//    lie on the annulus r_lo(c) <= |(u/2, v/2)| <= r_hi(c) (host-built in
//    float64 from the float32 grids over the real columns, rounded outward),
//    so by the triangle inequality D >= max(0, |P| - r_hi, r_lo - |P|).
//    chunk_lower_bound computes that gap with |P| rounded down for the first
//    term and up for the second, every subtraction and the square rounded
//    down (__f*_rd, __f*_ru: no reliance on the rounding's size), then takes
//    the relative margin 2^-20 (which covers the 2^-22) and 2^-149 off,
//    rounding down. So lb(p, c) <= every cost of chunk c for pixel p, whatever
//    its s0 and dsig: exact, not approximate.
//  * The rule. A chunk whose lb is strictly above a cost the pixel already
//    reached holds no cell at or below the pixel's final minimum. Skipping it
//    can raise a group's minimum only where that minimum was above the final
//    one, and every cell at the final minimum is swept: the first-minimum
//    group stays bit for bit. The comparison keeps ties and a NaN lb or best;
//    a pixel with a NaN feature has only NaN costs and needs no chunk.
//  * The schedule. Each set first marks its pixels' home chunks (those of
//    least lb: the annuli that hold |P|, or the nearest); the block sweeps
//    their union first, from the one nearest the centre of their span, so
//    that every pixel holds a good best cost early. After each chunk the
//    chains' best costs merge into the block's (atomicMin on the bits of
//    non-negative floats) and each warp marks, in a mask of a bit a chunk,
//    the chunks of its quarter (c = chain mod 4) that a pixel of its set
//    still needs by them. The block streams next the needed chunk nearest
//    the centre through the double-buffered stages (the one in flight was
//    chosen a chunk earlier), never copying a chunk that no mask names.
//    Before it sweeps a staged chunk each warp re-checks its set's pixels
//    against its own best costs and skips the chunk if none needs it. Blocks
//    whose pixels have close priors (the fused_exact mode sorts each band's
//    pixels by |P|) need few chunks; a prior far from the pixel's minimum
//    costs the chunks between them.
//  * With prune = 0 every chunk is streamed in ascending order through the
//    same code: the A/B and test switch.
//
// Features. Both forms read a block's features three times: the padding
// test, the sweep and the merge. They take them through the bucket
// permutation: each thread loads its slot's row of the pixel table (row
// index[slot], its first 4 floats in one 16-byte load, NaN for a padding
// slot) once into shared memory (4 KB a block: 49 KB staged, 76 KB streamed
// at the full grid, still three streamed blocks an SM), and the three reads
// take them from there. The output stays in slot order: the re-bucketing
// reads it slot by slot.
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

// The gathered features: a float4 a slot, after the rest of the block's
// shared memory (n_floats of it), 16-byte aligned.
__host__ __device__ constexpr size_t feats_offset(size_t n_floats) { return (n_floats + 3) & ~3; }
constexpr size_t kFeatsFloats = 4 * static_cast<size_t>(kPixels);

__host__ __device__ inline size_t smem_floats(int n_rows, int n_cols) {
  return 3 * static_cast<size_t>(n_rows) * row_stride(n_cols) + 2 * kChains * kPixels + n_rows;
}

size_t smem_bytes(int n_rows, int n_cols) {
  return (feats_offset(smem_floats(n_rows, n_cols)) + kFeatsFloats) * sizeof(float);
}

// The block's features, a float4 a slot (s0, ma/2, mz/2, 1/dsig), gathered
// through the bucket permutation into s_feats, thread t taking slot t
// (kThreads == kPixels, so each thread reads its own slot back before the
// first barrier).
__device__ __forceinline__ const float4* block_feats(const float* __restrict__ feats,
                                                     const long long* __restrict__ index,
                                                     int stride, float4* s_feats) {
  static_assert(kThreads == kPixels, "a thread gathers one slot");
  const size_t slot0 = static_cast<size_t>(blockIdx.x) * kPixels;
  s_feats[threadIdx.x] = xs::Rows{feats, stride, index + slot0}.head4(threadIdx.x);
  return s_feats;
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
    const float* __restrict__ feats, const long long* __restrict__ index, int stride,
    const int* __restrict__ band_of_block, int* __restrict__ out, int n_rows, int n_cols,
    int n_groups) {
  extern __shared__ __align__(16) float smem[];
  const int b = blockIdx.x;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const float4* feats_b = block_feats(
      feats, index, stride,
      reinterpret_cast<float4*>(smem + feats_offset(smem_floats(n_rows, n_cols))));
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

constexpr int kChunkRows = 16;  // grid rows per shared-memory stage: a chunk, the unit of pruning
constexpr float kShrink = 0x1p-20f;  // the lower bound's relative margin (see the note)

// words of a mask of one bit a chunk
__host__ __device__ constexpr int mask_words(int n_chunks) { return (n_chunks + 31) >> 5; }

__host__ __device__ inline size_t streamed_smem_floats(int n_cols, int n_chunks) {
  const size_t stages = 2 * 3 * static_cast<size_t>(kChunkRows) * row_stride(n_cols);
  const size_t partials = 2 * kChains * kPixels;
  // the stages (or the partials written over them at the end), the merged
  // best costs, the chunks' radii, a need mask per warp, the home mask and
  // the chunks done
  return (stages > partials ? stages : partials) + kPixels + 2 * static_cast<size_t>(n_chunks) +
         (kWarps + 2) * static_cast<size_t>(mask_words(n_chunks));
}

size_t streamed_smem_bytes(int n_cols, int n_chunks) {
  return (feats_offset(streamed_smem_floats(n_cols, n_chunks)) + kFeatsFloats) * sizeof(float);
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

// The lower bound of a pixel's cost over a chunk's cells, from the pixel's
// prior (ma/2, mz/2) and the chunk's radii [r_lo, r_hi] (see the note). Every
// operation rounds toward the side that keeps it a lower bound. NaN for a
// NaN prior.
__device__ __forceinline__ float chunk_lower_bound(float ma_half, float mz_half, float r_lo,
                                                   float r_hi) {
  const float rho_lo = __fsqrt_rd(__fadd_rd(__fmul_rd(ma_half, ma_half),
                                            __fmul_rd(mz_half, mz_half)));
  const float rho_hi = __fsqrt_ru(__fadd_ru(__fmul_ru(ma_half, ma_half),
                                            __fmul_ru(mz_half, mz_half)));
  float gap = fmaxf(__fsub_rd(rho_lo, r_hi), __fsub_rd(r_lo, rho_hi));
  gap = gap < 0.0f ? 0.0f : gap;  // a NaN gap stays NaN
  return __fsub_rd(__fmul_rd(__fmul_rd(gap, gap), 1.0f - kShrink), 0x1p-149f);
}

// Whether a pixel may still find its minimum in a chunk: its features hold
// no NaN (else every cost is NaN) and the chunk's bound is not above its
// best cost so far (not strict: a tie survives; a NaN bound keeps it).
__device__ __forceinline__ bool pixel_live(const float4& f) {
  return f.x == f.x && f.y == f.y && f.z == f.z && f.w == f.w;
}

__device__ __forceinline__ bool pixel_needs(const float4& f, float best, float2 radii) {
  return pixel_live(f) && !(chunk_lower_bound(f.y, f.z, radii.x, radii.y) > best);
}

// One chain's pixels in the streamed form: features, the least (row
// minimum, group) met so far, and the block's best cost of each pixel when
// the warp last formed its need mask (+inf before).
struct StreamChains {
  float4 f[kPix];  // s0, ma/2, mz/2, 1/dsig
  float best[kPix];
  int best_g[kPix];
  float known[kPix];
  int grp[kPix];  // the live 32-pixel groups of the set, in order
};

template <int G>
struct Live {
  static constexpr int value = G;
};

// Call f(Live<G>{}) for the set's count G of live 32-pixel groups (1-4);
// nothing for a set without one.
template <typename F>
__device__ __forceinline__ void with_live(int n_live, F&& f) {
  switch (n_live) {
    case 1: f(Live<1>{}); break;
    case 2: f(Live<2>{}); break;
    case 3: f(Live<3>{}); break;
    case 4: f(Live<4>{}); break;
    default: break;
  }
}

// Whether any pixel of the warp's set still needs a chunk, by this chain's
// best costs: the set's re-check before it sweeps a staged chunk.
template <int G>
__device__ __forceinline__ bool set_needs(const StreamChains& ch, float2 radii) {
  bool need = false;
#pragma unroll
  for (int k = 0; k < G; ++k) need |= pixel_needs(ch.f[k], fminf(ch.known[k], ch.best[k]), radii);
  return __any_sync(0xffffffffu, need);
}

// Sweep the chain's rows of the staged chunk of grid rows [row0, row0 +
// rows) (rows rr = chain, chain + 4, ...) for the G live 32-pixel groups;
// each row's minimum updates the chain's (minimum, group) lexicographically,
// since chunks are met out of order.
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
      if (rmin[k] < ch.best[k] || (rmin[k] == ch.best[k] && g < ch.best_g[k])) {
        ch.best[k] = rmin[k];
        ch.best_g[k] = g;
      }
    }
  }
}

// OR into mask (n_chunks bits) the home chunks of the warp's set: each live
// pixel's chunks of least bound (the annuli that hold its prior's radius, or
// the nearest where none does).
template <int G>
__device__ __forceinline__ void or_home_mask(const StreamChains& ch, const float2* radii,
                                             int n_chunks, unsigned* mask) {
  const int lane = threadIdx.x & 31;
  float least[G];
#pragma unroll
  for (int k = 0; k < G; ++k) {
    least[k] = CUDART_INF_F;
    for (int c = 0; c < n_chunks; ++c)
      least[k] = fminf(least[k], chunk_lower_bound(ch.f[k].y, ch.f[k].z, radii[c].x,
                                                   radii[c].y));
  }
  for (int w = 0; w * 32 < n_chunks; ++w) {
    unsigned bits = 0;
    for (int j = 0; j < 32 && w * 32 + j < n_chunks; ++j) {
      const float2 r = radii[w * 32 + j];
      bool home = false;
#pragma unroll
      for (int k = 0; k < G; ++k)
        home |= pixel_live(ch.f[k]) &&
                chunk_lower_bound(ch.f[k].y, ch.f[k].z, r.x, r.y) == least[k];
      bits |= static_cast<unsigned>(home) << j;
    }
    bits = __reduce_or_sync(0xffffffffu, bits);
    if (lane == 0 && bits) atomicOr(mask + w, bits);
  }
}

// Write the warp's row of the need masks: bit c for each chunk c = chain
// (mod 4) that a pixel of its set needs by the block's best costs so far,
// read from the merged known_set into ch.known.
template <int G>
__device__ __forceinline__ void need_row(StreamChains& ch, const int* known_set,
                                         const float2* radii, int n_chunks, int chain,
                                         unsigned* row) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int k = 0; k < G; ++k) ch.known[k] = __int_as_float(known_set[32 * ch.grp[k] + lane]);
  for (int w = 0; w * 32 < n_chunks; ++w) {
    unsigned bits = 0;
    for (int c = 32 * w + chain; c < min(32 * w + 32, n_chunks); c += kChains) {
      bool need = false;
#pragma unroll
      for (int k = 0; k < G; ++k) need |= pixel_needs(ch.f[k], ch.known[k], radii[c]);
      bits |= static_cast<unsigned>(need) << (c - 32 * w);
    }
    bits = __reduce_or_sync(0xffffffffu, bits);
    if (lane == 0) row[w] = bits;
  }
}

// The block's candidate chunks in word w: the OR of its kMasks masks (mw
// words apart), less the chunks done and `exclude`.
constexpr int kMasks = kWarps + 1;  // a need mask per warp, and the home mask

__device__ __forceinline__ unsigned candidates(const unsigned* masks, const unsigned* done,
                                               int mw, int exclude, int w) {
  unsigned bits = 0;
#pragma unroll
  for (int m = 0; m < kMasks; ++m) bits |= masks[m * mw + w];
  bits &= ~done[w];
  if (exclude >> 5 == w) bits &= ~(1u << (exclude & 31));
  return bits;
}

// The candidate chunk nearest to the centre center2 / 2, the lower of two as
// near; -1 if none. center2 = -1 visits in ascending order.
__device__ __forceinline__ int nearest_chunk(const unsigned* masks, const unsigned* done,
                                             int n_chunks, int center2, int exclude) {
  const int mw = mask_words(n_chunks);
  const int mid = center2 >> 1;  // the last chunk at or below the centre
  int down = -1, up = -1;
  for (int w = min(mid, n_chunks - 1) >> 5; w >= 0 && mid >= 0; --w) {
    unsigned bits = candidates(masks, done, mw, exclude, w);
    if (w == mid >> 5 && (mid & 31) < 31) bits &= (2u << (mid & 31)) - 1u;
    if (bits) {
      down = w * 32 + 31 - __clz(bits);
      break;
    }
  }
  for (int w = (mid + 1) >> 5; w * 32 < n_chunks; ++w) {
    unsigned bits = candidates(masks, done, mw, exclude, w);
    if (w == (mid + 1) >> 5) bits &= ~0u << ((mid + 1) & 31);
    if (bits) {
      up = w * 32 + __ffs(bits) - 1;
      break;
    }
  }
  if (down < 0 || up < 0) return down < 0 ? up : down;
  return abs(2 * down - center2) <= abs(2 * up - center2) ? down : up;
}

__global__ void __launch_bounds__(kThreads, 3) group_argmin_streamed_kernel(
    const float* __restrict__ lut_c, const float* __restrict__ u_half,
    const float* __restrict__ v_half, const int* __restrict__ row_group,
    const float2* __restrict__ radii, const float* __restrict__ feats,
    const long long* __restrict__ index, int stride, const int* __restrict__ band_of_block,
    int* __restrict__ out, int* __restrict__ swept, int n_rows, int n_cols, int n_groups,
    int prune) {
  extern __shared__ __align__(16) float smem[];
  const int b = blockIdx.x;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n_chunks = (n_rows + kChunkRows - 1) / kChunkRows;
  const float4* feats_b = block_feats(
      feats, index, stride,
      reinterpret_cast<float4*>(smem + feats_offset(streamed_smem_floats(n_cols, n_chunks))));
  int* out_b = out + static_cast<size_t>(b) * kPixels;

  if (padding_only(feats_b, out_b, n_groups)) {
    if (swept != nullptr && threadIdx.x < 3) swept[3 * b + threadIdx.x] = 0;
    return;
  }
  __shared__ int s_pixel_rows;  // the (pixel, row) pairs swept, for `swept`

  const int mw = mask_words(n_chunks);
  const int ld = row_stride(n_cols);
  const int plane = kChunkRows * ld;
  const size_t stages = 2 * 3 * plane;
  const size_t partials = 2 * kChains * kPixels;
  int* s_known = reinterpret_cast<int*>(smem + (stages > partials ? stages : partials));
  float2* s_radii = reinterpret_cast<float2*>(s_known + kPixels);
  unsigned* s_masks = reinterpret_cast<unsigned*>(s_radii + n_chunks);  // warps', then home
  unsigned* s_home = s_masks + kWarps * mw;
  unsigned* s_done = s_masks + kMasks * mw;
  const float* lut_b = lut_c + static_cast<size_t>(band_of_block[b]) * n_rows * n_cols;
  // the stride's pad columns of both stages, which no copy touches: a NaN
  // LUT value (its cost never wins) and zero u/2, v/2
  const int pad = ld - n_cols;
  for (int i = threadIdx.x; i < 2 * 3 * kChunkRows * pad; i += kThreads) {
    const int row = i / pad;  // over the 2 x 3 x kChunkRows rows of both stages
    smem[row * ld + n_cols + (i - row * pad)] = ((row / kChunkRows) % 3 == 0) ? CUDART_NAN_F
                                                                             : 0.0f;
  }
  for (int i = threadIdx.x; i < n_chunks; i += kThreads) s_radii[i] = radii[i];
  if (threadIdx.x == 0) s_pixel_rows = 0;
  for (int i = threadIdx.x; i < kPixels; i += kThreads) s_known[i] = __float_as_int(CUDART_INF_F);
  for (int i = threadIdx.x; i < (kMasks + 1) * mw; i += kThreads) {
    // without pruning every chunk is a home chunk and stays one
    const int left = n_chunks - 32 * (i % mw);
    const bool home = i / mw == kWarps;
    s_masks[i] = prune || !home ? 0u : left >= 32 ? ~0u : left > 0 ? (1u << left) - 1u : 0u;
  }

  const int set = warp / kChains;
  const int chain = warp % kChains;
  const float4* feats_set = feats_b + set * kSetPixels;
  int* known_set = s_known + set * kSetPixels;
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
    ch.known[k] = CUDART_INF_F;
  }
  int set_px = 0;  // the set's pixels with an s0
#pragma unroll
  for (int k = 0; k < kPix; ++k) {
    if (k < n_live) set_px += __popc(__ballot_sync(0xffffffffu, ch.f[k].x == ch.f[k].x));
  }
  __syncthreads();

  // the home chunks (chain 0's warps mark them) and their centre
  if (prune && chain == 0) {
    with_live(n_live, [&](auto n) {
      or_home_mask<decltype(n)::value>(ch, s_radii, n_chunks, s_home);
    });
  }
  __syncthreads();
  int center2 = -1;  // without pruning: ascending
  if (prune) {
    const int first = nearest_chunk(s_masks, s_done, n_chunks, -1, -1);
    const int last = nearest_chunk(s_masks, s_done, n_chunks, 2 * n_chunks, -1);
    center2 = first + last;
  }

  // Stream the chunks through the two stages, the next chunk's copies in
  // flight while this one is swept: the candidate nearest the centre, chosen
  // before the sweep from the masks formed after the previous chunk (or
  // after it, when there was none). A set sweeps a staged chunk only if one
  // of its pixels still needs it; its chains' best costs then merge into the
  // block's (non-negative floats order as integers).
  int n_swept = 0, rows_swept = 0;
  int cur = nearest_chunk(s_masks, s_done, n_chunks, center2, -1);
  if (cur >= 0) {
    stage_chunk(smem, lut_b, u_half, v_half, cur * kChunkRows,
                min(kChunkRows, n_rows - cur * kChunkRows), n_cols, ld);
  }
  for (int k = 0; cur >= 0; ++k) {
    int next = nearest_chunk(s_masks, s_done, n_chunks, center2, cur);
    if (next >= 0) {  // prefetch the next chunk into the other stage
      stage_chunk(smem + ((k + 1) & 1) * 3 * plane, lut_b, u_half, v_half, next * kChunkRows,
                  min(kChunkRows, n_rows - next * kChunkRows), n_cols, ld);
      asm volatile("cp.async.wait_group 1;\n" ::: "memory");
    } else {
      asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    }
    __syncthreads();
    const int row0 = cur * kChunkRows;
    const int rows = min(kChunkRows, n_rows - row0);
    with_live(n_live, [&](auto n) {
      constexpr int G = decltype(n)::value;
      if (!prune || set_needs<G>(ch, s_radii[cur])) {
        sweep_chunk<G>(ch, smem + (k & 1) * 3 * plane, row_group, row0, rows, chain, ld);
        if (swept != nullptr && lane == 0)
          atomicAdd(&s_pixel_rows, (rows - chain + kChains - 1) / kChains * set_px);
      }
      if (prune) {
#pragma unroll
        for (int j = 0; j < G; ++j)
          atomicMin(known_set + 32 * ch.grp[j] + lane, __float_as_int(ch.best[j]));
      }
    });
    __syncthreads();  // the stage is refilled next; the merged best costs are complete
    if (prune) {
      with_live(n_live, [&](auto n) {
        need_row<decltype(n)::value>(ch, known_set, s_radii, n_chunks, chain,
                                     s_masks + warp * mw);
      });
    }
    // from now on the need masks alone name the candidates
    if (prune && threadIdx.x < mw) s_home[threadIdx.x] = 0u;
    if (threadIdx.x == 0) {
      s_done[cur >> 5] |= 1u << (cur & 31);
      if (next >= 0) s_done[next >> 5] |= 1u << (next & 31);
    }
    __syncthreads();
    ++n_swept;
    rows_swept += rows;
    if (next < 0) {  // nothing was in flight: choose again from the new masks
      next = nearest_chunk(s_masks, s_done, n_chunks, center2, -1);
      if (next >= 0) {
        stage_chunk(smem + ((k + 1) & 1) * 3 * plane, lut_b, u_half, v_half, next * kChunkRows,
                    min(kChunkRows, n_rows - next * kChunkRows), n_cols, ld);
      }
    }
    cur = next;
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
  if (swept != nullptr && threadIdx.x == 0) {
    swept[3 * b] = n_swept;
    swept[3 * b + 1] = rows_swept;
    swept[3 * b + 2] = s_pixel_rows;
  }
}

// The streamed form's lower bound for each (pixel, chunk): test entry.
__global__ void chunk_lower_bounds_kernel(const float4* __restrict__ feats,
                                          const float2* __restrict__ radii, float* __restrict__ out,
                                          int n_px, int n_chunks) {
  const size_t i = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= static_cast<size_t>(n_px) * n_chunks) return;
  const float4 f = feats[i / n_chunks];
  const float2 r = radii[i % n_chunks];
  out[i] = chunk_lower_bound(f.y, f.z, r.x, r.y);
}

}  // namespace

extern "C" const char* xs_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// index: the slot -> pixel permutation (-1 for padding); feats: the pixel
// table, 16-byte aligned rows of stride floats, a multiple of 4, of which the
// first 4 are read.
extern "C" int xs_group_argmin(const float* lut_c, const float* u_half, const float* v_half,
                               const int* row_group, const float* feats, const long long* index,
                               int stride, const int* band_of_block, int* out, int n_blocks,
                               int block, int n_rows, int n_cols, int n_groups, void* stream) {
  if (block != kPixels) return static_cast<int>(cudaErrorInvalidValue);
  if (n_blocks == 0) return 0;
  const size_t smem = smem_bytes(n_rows, n_cols);
  cudaError_t err = xs::allow_smem(group_argmin_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  group_argmin_kernel<<<n_blocks, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      lut_c, u_half, v_half, row_group, feats, index, stride, band_of_block, out, n_rows, n_cols,
      n_groups);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int xs_group_argmin_streamed(const float* lut_c, const float* u_half,
                                        const float* v_half, const int* row_group,
                                        const float* radii, const float* feats,
                                        const long long* index, int stride,
                                        const int* band_of_block, int* out, int* swept,
                                        int n_blocks, int block, int n_rows, int n_cols,
                                        int n_groups, int prune, void* stream) {
  if (block != kPixels) return static_cast<int>(cudaErrorInvalidValue);
  if (n_blocks == 0) return 0;
  const size_t smem = streamed_smem_bytes(n_cols, (n_rows + kChunkRows - 1) / kChunkRows);
  cudaError_t err = xs::allow_smem(group_argmin_streamed_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  group_argmin_streamed_kernel<<<n_blocks, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      lut_c, u_half, v_half, row_group, reinterpret_cast<const float2*>(radii), feats, index,
      stride, band_of_block, out, swept, n_rows, n_cols, n_groups, prune);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int xs_chunk_lower_bounds(const float* feats, const float* radii, float* out,
                                     int n_px, int n_chunks, void* stream) {
  const size_t n = static_cast<size_t>(n_px) * n_chunks;
  if (n == 0) return 0;
  chunk_lower_bounds_kernel<<<static_cast<unsigned>((n + 255) / 256), 256, 0,
                              static_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const float4*>(feats), reinterpret_cast<const float2*>(radii), out, n_px,
      n_chunks);
  return static_cast<int>(cudaGetLastError());
}
