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
#include <math_constants.h>

namespace xs {

__device__ __forceinline__ float copol_cost(float l, float u_half, float v_half, float s0,
                                            float ma_half, float mz_half, float inv_dsig) {
  const float d0 = __fmul_rn(__fsub_rn(l, s0), inv_dsig);
  const float d1 = __fsub_rn(u_half, ma_half);
  const float d2 = __fsub_rn(v_half, mz_half);
  return __fadd_rn(__fadd_rn(__fmul_rn(d0, d0), __fmul_rn(d1, d1)), __fmul_rn(d2, d2));
}

// The slab sweep's cost forms: K2 and K3 take the direct one; K5 prices the
// other two (scripts/bench_slab_forms.py).
enum Form : int { kDirect = 0, kPrescaled = 1, kExpandedUV = 2 };

// The two rewrites of that cost that scripts/bench_slab_forms.py measures
// (K5), with the operands their builders give:
//   prescaled:   (l' - s0')^2 + (u/2 - ma/2)^2 + (v/2 - mz/2)^2, where
//                l' = l * inv_dsig and s0' = s0 * inv_dsig, each rounded f32;
//   expanded_uv: ((t*t + kr) + u2 * ma/2) + v2 * mz/2, t = l' - s0', with
//                kr = (u/2)^2 + (v/2)^2 and u2 = -2 * u/2, v2 = -2 * v/2 per
//                entry, dropping the per-pixel constant (ma/2)^2 + (mz/2)^2.
__device__ __forceinline__ float prescaled_cost(float l, float u_half, float v_half, float s0,
                                                float ma_half, float mz_half) {
  const float d0 = __fsub_rn(l, s0);
  const float d1 = __fsub_rn(u_half, ma_half);
  const float d2 = __fsub_rn(v_half, mz_half);
  return __fadd_rn(__fadd_rn(__fmul_rn(d0, d0), __fmul_rn(d1, d1)), __fmul_rn(d2, d2));
}

__device__ __forceinline__ float expanded_uv_cost(float l, float kr, float u2, float v2,
                                                  float s0, float ma_half, float mz_half) {
  const float t = __fsub_rn(l, s0);
  return __fadd_rn(__fadd_rn(__fadd_rn(__fmul_rn(t, t), kr), __fmul_rn(u2, ma_half)),
                   __fmul_rn(v2, mz_half));
}

// The first minimum of one pixel's slab sweep: its row within the slab
// (-1 when no cost is finite and below +inf), its column, and whether any
// cost was NaN (the reference's NaN-propagating min poisons the pixel).
struct SlabArgmin {
  int row;
  int col;
  bool poisoned;
};

// Direct-form copol argmin over an n_rows x n_phi LUT slab, one pixel per
// thread: the loop K2 and K3 ran before their redesign, kept as the baseline
// of K5's experiment (slab_forms.cu, loop "thread"; everything else sweeps
// with xs::slab::sweep below). The slab sits in shared memory;
// u_b/v_b point at the slab's first row of the halved wind-component grids in
// device memory. One thread sweeps its pixel in row-major (wspd-major,
// phi-minor) order with a strict '<': the first minimum wins, numpy's rule.
__device__ __forceinline__ SlabArgmin copol_slab_argmin(const float* slab,
                                                        const float* __restrict__ u_b,
                                                        const float* __restrict__ v_b,
                                                        int n_rows, int n_phi, float s0,
                                                        float ma_half, float mz_half,
                                                        float inv_dsig) {
  float best = CUDART_INF_F;
  SlabArgmin m{-1, 0, false};
  for (int r = 0; r < n_rows; ++r) {
    const int base = r * n_phi;
    for (int c = 0; c < n_phi; ++c) {
      const float j = copol_cost(slab[base + c], __ldg(u_b + base + c), __ldg(v_b + base + c),
                                 s0, ma_half, mz_half, inv_dsig);
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

// Sentinels of K3's and K5's flat index: a NaN cost anywhere in the slab
// (the TPU kernel's NaN min matches no lane), and the no-hit index the caller
// passes, ((2^30 / n_phi) & ~1) * n_phi (the sweep's init row at lane 0).
constexpr int kNanIdx = 1 << 30;

__device__ __forceinline__ int slab_flat_index(SlabArgmin m, int r0, int n_phi, int no_hit) {
  if (m.poisoned) return kNanIdx;
  if (m.row < 0) return no_hit;
  return (r0 + m.row) * n_phi + m.col;
}

// min that propagates NaN (PTX min.NaN.f32, sm_80+), as jnp.minimum does.
__device__ __forceinline__ float min_nan(float a, float b) {
  float r;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

// A block's feature rows as the kernels read them, through the bucket
// permutation: slot p's row is row index[p] of the pixel table rows, and a
// slot whose index is negative (padding) reads NaN features. index points at
// the block's first slot, rows at the table's first row; a row holds stride
// floats, of which the kernel reads the first few (K1 the first 4 of the fused
// tail's 8). A caller whose rows are already in slot order passes the identity
// permutation.
struct Rows {
  const float* __restrict__ rows;
  int stride;
  const long long* __restrict__ index;

  // The pixel of slot p (negative for padding).
  __device__ __forceinline__ long long pixel(int p) const { return index[p]; }

  // Feature j of slot p.
  __device__ __forceinline__ float at(int p, int j) const {
    const long long i = pixel(p);
    if (i < 0) return CUDART_NAN_F;
    return rows[i * stride + j];
  }

  // Features 0-3 of slot p, one load each.
  __device__ __forceinline__ float4 head(int p) const {
    const long long i = pixel(p);
    if (i < 0) return make_float4(CUDART_NAN_F, CUDART_NAN_F, CUDART_NAN_F, CUDART_NAN_F);
    const float* r = rows + i * stride;
    return make_float4(r[0], r[1], r[2], r[3]);
  }

  // Features 0-3 of slot p as one 16-byte load (rows 16-byte aligned, stride
  // a multiple of 4).
  __device__ __forceinline__ float4 head4(int p) const {
    const long long i = pixel(p);
    if (i < 0) return make_float4(CUDART_NAN_F, CUDART_NAN_F, CUDART_NAN_F, CUDART_NAN_F);
    return *reinterpret_cast<const float4*>(rows + i * stride);
  }
};

// The slab sweep of K2, K3 and K5 on Hopper.
//
// A CUDA block holds one 128-pixel (band, group) bucket block and kWarps = 4
// warps. Lane l of every warp owns the pixels l, l + 32, l + 64 and l + 96
// (P = 4 a thread, one per 32-pixel group), and warp w sweeps the slab rows
// r = w (mod 4). So each entry's operands read from shared memory (one
// broadcast for the whole warp) feed four cost evaluations, a thread runs
// four independent compare chains, and each pixel keeps four running minima,
// one per warp; they merge at the end by (cost, flat index), which is
// numpy's first minimum over the whole slab. A running minimum is the
// NaN-propagating min of the TPU kernel (_slab_sweep: jnp.minimum beside a
// strict '<'), so a NaN cost anywhere in a chain leaves its minimum NaN and
// poisons the pixel, with no separate NaN test per entry. The four entries
// of a float4 are reduced to their minimum first, and only that meets the
// chain's compare and index select; after the sweep each chain rescans its
// winning four for the first entry that holds the minimum.
//
// The sweep is a template on the cost form (Form: K2 and K3 take kDirect,
// K5 all three) and on the chunk height kChunk, the slab rows a
// shared-memory stage holds (8, the default, or 16, 24, 48: multiples of
// kWarps, so every warp keeps its rows r = w mod 4 in every chunk). The form
// is chosen with if constexpr and plain inline calls: each instantiation is
// the loop written out for its cost (a cost passed as a lambda made the
// direct sweep ~8% slower in K5's old loop and ~4% in K2). The chunk height
// changes the trip counts only, never the per-entry operations, so every
// height gives the same bits.
//
// The slab streams through shared memory kChunk rows at a time, one plane
// per operand (l, u, v, and kr for expanded_uv), double-buffered with 4-byte
// cp.async (the rows of an odd-width LUT are not 16-byte aligned in device
// memory); a slab of one chunk takes one stage. Rows are stored with a
// stride rounded up to 4 floats, so the sweep reads float4s; it stops at
// n_phi and never evaluates the stride's padding. At the production LUT
// (181 phi) and 8 rows: 2 x 3 x 8 x 184 x 4 B = 35 KB (47 KB with kr), what
// one 48-row slab took before; at 48 rows a 48-row slab is one stage of
// 106 KB.
//
// A 32-pixel group whose s0 are all NaN (the padding slots at a bucket's end,
// or pixels with no copol sigma0) is not swept: a NaN s0 makes every cost
// NaN, so each of its pixels is poisoned, which is what the sweep would give.
// The groups left are swept by a loop compiled for their count (1-4), so a
// block whose padding fills whole groups does proportionally less work.
namespace slab {

constexpr int kPixels = 128;              // pixels per block: SLAB_BLOCK
constexpr int kWarps = 4;                 // row chains per pixel
constexpr int kThreads = 32 * kWarps;     // == kPixels: thread t merges pixel t
constexpr int kGroups = kPixels / 32;     // pixels per thread
constexpr int kChunkRows = 8;             // default slab rows per shared-memory stage

__host__ __device__ constexpr int row_stride(int n_phi) { return (n_phi + 3) & ~3; }

// Operand planes a stage holds: l, u, v, and kr for expanded_uv.
template <Form F>
__host__ __device__ constexpr int planes() { return F == kExpandedUV ? 4 : 3; }

// Dynamic shared memory of a block: the stages (two, or one for a slab of a
// single chunk) of every plane, reused at the end for the per-warp partial
// minima.
template <Form F = kDirect, int kChunk = kChunkRows>
inline size_t smem_bytes(int n_phi, int n_rows) {
  const size_t n_stages = n_rows > kChunk ? 2 : 1;
  const size_t stages = n_stages * planes<F>() * static_cast<size_t>(kChunk) * row_stride(n_phi);
  const size_t partials = 2 * static_cast<size_t>(kWarps) * kPixels;
  return (stages > partials ? stages : partials) * sizeof(float);
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src) : "memory");
}

// A block's slab in device memory: the first of its n_rows rows of each
// operand, n_phi floats a row. lut, u and v are l, u/2 and v/2 for the direct
// form; prescaled takes l * inv_dsig for lut; expanded_uv takes l * inv_dsig,
// -2 u/2 and -2 v/2, and kr = (u/2)^2 + (v/2)^2 (nullptr for the others).
struct Slab {
  const float* __restrict__ lut;
  const float* __restrict__ u;
  const float* __restrict__ v;
  int n_rows;
  int n_phi;
  const float* __restrict__ kr = nullptr;
};

// Issue the copies of slab rows [row0, row0 + rows) of every operand into
// one stage (planes of kChunk x ld floats each), as one group.
template <Form F, int kChunk>
__device__ __forceinline__ void stage_rows(float* stage, const Slab& s, int row0, int rows,
                                           int ld) {
  const int plane = kChunk * ld;
  for (int rr = 0; rr < rows; ++rr) {
    const size_t src = static_cast<size_t>(row0 + rr) * s.n_phi;
    for (int c = threadIdx.x; c < s.n_phi; c += kThreads) {
      cp_async4(stage + rr * ld + c, s.lut + src + c);
      cp_async4(stage + plane + rr * ld + c, s.u + src + c);
      cp_async4(stage + 2 * plane + rr * ld + c, s.v + src + c);
      if constexpr (F == kExpandedUV) cp_async4(stage + 3 * plane + rr * ld + c, s.kr + src + c);
    }
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// The G pixels one thread sweeps: their features and running minima. idx is
// a slab-local flat index r * n_phi + c, -1 while no cost has been finite:
// during the sweep the first entry of the float4 (or the tail entry) where
// the chain's minimum was first reached, after resolve() the entry itself.
// inv is read by the direct form only (the others take 1 there).
template <int G, Form F = kDirect>
struct Chains {
  float s0[G], ma[G], mz[G], inv[G];
  float best[G];
  int idx[G];

  // The form's cost of one entry; kr is read by expanded_uv only.
  __device__ __forceinline__ float cost(int k, float l, float u, float v, float kr) const {
    if constexpr (F == kDirect) {
      return copol_cost(l, u, v, s0[k], ma[k], mz[k], inv[k]);
    } else if constexpr (F == kPrescaled) {
      return prescaled_cost(l, u, v, s0[k], ma[k], mz[k]);
    } else {
      return expanded_uv_cost(l, kr, u, v, s0[k], ma[k], mz[k]);
    }
  }

  // The strict '<' keeps the chain's first minimum; NaN propagates into best.
  __device__ __forceinline__ void keep(int k, float j, int e) {
    const bool better = j < best[k];
    best[k] = min_nan(best[k], j);
    idx[k] = better ? e : idx[k];
  }

  // Entries e..e+3 of one row: their NaN-propagating minimum against the
  // chain's, one compare and one select for four entries.
  __device__ __forceinline__ void step4(float4 l, float4 u, float4 v, float4 kr, int e) {
#pragma unroll
    for (int k = 0; k < G; ++k) {
      const float j01 = min_nan(cost(k, l.x, u.x, v.x, kr.x), cost(k, l.y, u.y, v.y, kr.y));
      const float j23 = min_nan(cost(k, l.z, u.z, v.z, kr.z), cost(k, l.w, u.w, v.w, kr.w));
      keep(k, min_nan(j01, j23), e);
    }
  }

  __device__ __forceinline__ void step(float l, float u, float v, float kr, int e) {
#pragma unroll
    for (int k = 0; k < G; ++k) keep(k, cost(k, l, u, v, kr), e);
  }

  // The first entry at or after idx, within its four, whose cost is the
  // chain's minimum: the chain's first minimum (every earlier four's
  // minimum is larger). The costs are recomputed from device memory, bit
  // for bit those of the sweep.
  __device__ __forceinline__ void resolve(const Slab& s) {
#pragma unroll
    for (int k = 0; k < G; ++k) {
      if (idx[k] < 0 || best[k] != best[k]) continue;
      const int row = idx[k] / s.n_phi;
      const int c0 = idx[k] - row * s.n_phi;
      const int end = min(c0 + 4, s.n_phi);
      for (int c = c0; c < end; ++c) {
        const size_t i = static_cast<size_t>(row) * s.n_phi + c;
        const float kr = F == kExpandedUV ? s.kr[i] : 0.0f;
        if (cost(k, s.lut[i], s.u[i], s.v[i], kr) == best[k]) {
          idx[k] = row * s.n_phi + c;
          break;
        }
      }
    }
  }
};

// Sweep the slab for the G live groups (the set bits of live), then leave
// each warp's partial (minimum, index) per pixel in smem: part_best[w *
// kPixels + p], part_idx likewise (p = 32 * group + lane). Every thread of
// the block calls it with the same G.
template <int G, Form F, int kChunk>
__device__ void sweep_groups(float* smem, const Slab& s, const Rows& feats, unsigned live) {
  static_assert(kChunk % kWarps == 0, "every warp keeps its rows r = w mod 4 in every chunk");
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  int grp[G];  // the live groups, in order
  Chains<G, F> ch;
#pragma unroll
  for (int k = 0; k < G; ++k) {
    grp[k] = __ffs(live) - 1;
    live &= live - 1;
    const float4 f = feats.head(32 * grp[k] + lane);
    ch.s0[k] = f.x;
    ch.ma[k] = f.y;
    ch.mz[k] = f.z;
    ch.inv[k] = F == kDirect ? f.w : 1.0f;
    ch.best[k] = CUDART_INF_F;
    ch.idx[k] = -1;
  }

  const int n_phi = s.n_phi;
  const int ld = row_stride(n_phi);
  const int plane = kChunk * ld;
  constexpr int kStage = planes<F>();  // planes a stage holds
  const int n_chunks = (s.n_rows + kChunk - 1) / kChunk;
  stage_rows<F, kChunk>(smem, s, 0, min(kChunk, s.n_rows), ld);
  for (int k = 0; k < n_chunks; ++k) {
    const int row0 = k * kChunk;
    if (k + 1 < n_chunks) {  // prefetch the next chunk into the other stage
      const int next = row0 + kChunk;
      stage_rows<F, kChunk>(smem + ((k + 1) & 1) * kStage * plane, s, next,
                            min(kChunk, s.n_rows - next), ld);
      asm volatile("cp.async.wait_group 1;\n" ::: "memory");
    } else {
      asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    }
    __syncthreads();
    const float* stage = smem + (k & 1) * kStage * plane;
    const int rows = min(kChunk, s.n_rows - row0);
    for (int rr = warp; rr < rows; rr += kWarps) {
      const float* L = stage + rr * ld;
      const float* U = L + plane;
      const float* V = U + plane;
      const float* R = V + plane;  // kr: read by expanded_uv only
      int e = (row0 + rr) * n_phi;
      int c = 0;
      for (; c + 4 <= n_phi; c += 4, e += 4) {
        const float4 l4 = *reinterpret_cast<const float4*>(L + c);
        const float4 u4 = *reinterpret_cast<const float4*>(U + c);
        const float4 v4 = *reinterpret_cast<const float4*>(V + c);
        float4 r4 = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        if constexpr (F == kExpandedUV) r4 = *reinterpret_cast<const float4*>(R + c);
        ch.step4(l4, u4, v4, r4, e);
      }
      for (; c < n_phi; ++c, ++e) ch.step(L[c], U[c], V[c], F == kExpandedUV ? R[c] : 0.0f, e);
    }
    __syncthreads();  // the stage is refilled next, or reused for the partials
  }
  ch.resolve(s);

  float* part_best = smem;
  int* part_idx = reinterpret_cast<int*>(smem + kWarps * kPixels);
#pragma unroll
  for (int k = 0; k < G; ++k) {
    const int p = warp * kPixels + 32 * grp[k] + lane;
    part_best[p] = ch.best[k];
    part_idx[p] = ch.idx[k];
  }
}

// The first minimum of pixel threadIdx.x of the block over its slab in cost
// form F. feats: the block's feature rows (s0, ma/2, mz/2, 1/dsig for the
// direct form; s0 * inv_dsig, ma/2, mz/2, 1 for the other two; then others),
// read through the bucket permutation. Needs kThreads threads and
// smem_bytes<F, kChunk>(s.n_phi, s.n_rows) of 16-byte aligned dynamic shared
// memory.
template <Form F = kDirect, int kChunk = kChunkRows>
__device__ __forceinline__ SlabArgmin sweep(float* smem, const Slab& s, const Rows& feats) {
  const int lane = threadIdx.x & 31;
  // groups with a pixel whose s0 is not NaN; every warp finds the same ones
  unsigned live = 0;
#pragma unroll
  for (int g = 0; g < kGroups; ++g) {
    const float s0 = feats.at(32 * g + lane, 0);
    live |= static_cast<unsigned>(__any_sync(0xffffffffu, s0 == s0)) << g;
  }
  switch (__popc(live)) {
    case 1: sweep_groups<1, F, kChunk>(smem, s, feats, live); break;
    case 2: sweep_groups<2, F, kChunk>(smem, s, feats, live); break;
    case 3: sweep_groups<3, F, kChunk>(smem, s, feats, live); break;
    case 4: sweep_groups<4, F, kChunk>(smem, s, feats, live); break;
    default: break;  // no live group: nothing to sweep
  }
  __syncthreads();

  SlabArgmin m{-1, 0, true};
  if ((live >> (threadIdx.x >> 5)) & 1) {
    const float* part_best = smem;
    const int* part_idx = reinterpret_cast<const int*>(smem + kWarps * kPixels);
    float best = CUDART_INF_F;
    int idx = -1;
    m.poisoned = false;
    for (int w = 0; w < kWarps; ++w) {
      const float b = part_best[w * kPixels + threadIdx.x];
      const int i = part_idx[w * kPixels + threadIdx.x];
      m.poisoned |= (b != b);
      if (b < best || (b == best && i < idx)) {  // (cost, flat index) order
        best = b;
        idx = i;
      }
    }
    if (!m.poisoned && idx >= 0) {
      m.row = idx / s.n_phi;
      m.col = idx % s.n_phi;
    }
  }
  return m;
}

}  // namespace slab

// The crosspol 1-D argmin over one LUT row, K4's body and K2's tail (the
// reference's _crosspol_kernel): j = ((lut - s0) / dsig)^2 + (w/2 - wco/2)^2
// * has_co with a correctly rounded quotient, the first minimum by index, the
// winning wind speed w/2 + w/2 (== w exactly), 0 when any cost is NaN.
//
// The divisor is one value per pixel, so the divide is hoisted: r = RN(1 /
// dsig) once per pixel, then per entry q0 = RN(d * r) and one residual step
// e = fma(-q0, dsig, d), q = fma(e, r, q0), the residual exact (Markstein's
// correction); explicit __fmaf_rn, which --fmad=false leaves alone. That
// equals __fdiv_rn(d, dsig) whenever no intermediate overflows or underflows
// (held on all 2^46 pairs of significands by
// scripts/check_crosspol_quotient.py), which the pixel's features decide
// (hoistable()): dsig within
// [2^-20, 2^20] and |s0| >= 2^-10, so that a nonzero d = l - s0 is at least
// 2^-34 in magnitude (two floats of magnitude >= 2^-11 differ by a multiple
// of 2^-34, and a smaller l leaves |d| >= |s0| / 2), q0 at least 2^-54 and
// every residual a multiple of 2^-120: all normal numbers. On the large side
// nothing is checked per entry: an infinite d or an overflowing q0 turns the
// hoisted quotient into NaN (inf - inf in the residual), the pixel's minimum
// is then NaN, and a pixel whose features hold no NaN but whose minimum does
// is solved again with the true divide. NaN features give NaN either way.
// xs_crosspol_quotient (crosspol_quotient.cu) exposes the quotient for the
// tests that hold it against the true divide, bit for bit.
//
// The loop has the slab sweep's shape: the row and w/2 come from shared memory
// as float4s (both 16-byte aligned, rows padded to a multiple of 4 floats), G
// pixels a thread share each read, the running minimum is the NaN-propagating
// min, so a NaN cost poisons it for good and needs no test per entry, a
// float4's four costs are reduced before one strict compare and one index
// select, and the winning four are rescanned for the first entry that holds
// the minimum. The stride's padding is never evaluated (a NaN pad would
// poison, and no finite or infinite pad is safe for every dsig): scalar tail.
namespace crosspol {

constexpr float kDsigLo = 0x1p-20f;    // |dsig| window of the hoisted quotient
constexpr float kDsigHi = 0x1p20f;
constexpr float kS0Lo = 0x1p-10f;      // least |s0|: bounds a nonzero l - s0 from below
constexpr float kDividendLo = 0x1p-34f;

__host__ __device__ constexpr int row_stride(int n_cr) { return (n_cr + 3) & ~3; }

// Shared memory of a block: the LUT row and the halved wind speeds.
inline size_t smem_bytes(int n_cr) {
  return 2 * static_cast<size_t>(row_stride(n_cr)) * sizeof(float);
}

// RN(a / b) from r = RN(1 / b), for operands inside the windows above.
__device__ __forceinline__ float hoisted_quotient(float a, float b, float r) {
  const float q = __fmul_rn(a, r);
  return __fmaf_rn(__fmaf_rn(-q, b, a), r, q);
}

// The quotient as the argmin computes it, for one (a, b): hoisted inside the
// windows, the true divide outside them or when the hoisted one gives NaN. A
// dividend of -0, which l - s0 never is under round-to-nearest, takes the
// true divide too: the hoisted route gives +0 for it under a positive b.
__device__ __forceinline__ float quotient(float a, float b, bool* hoisted) {
  const float mb = fabsf(b), ma = fabsf(a);
  *hoisted = false;
  if (!(mb >= kDsigLo && mb <= kDsigHi) || (ma < kDividendLo && __float_as_uint(a) != 0u))
    return __fdiv_rn(a, b);
  const float q = hoisted_quotient(a, b, __frcp_rn(b));
  if (q != q) return __fdiv_rn(a, b);
  *hoisted = true;
  return q;
}

// Whether a pixel's quotients may be hoisted. NaN features pass: they give
// NaN costs with either quotient.
__device__ __forceinline__ bool hoistable(float s0, float dsig) {
  const float md = fabsf(dsig);
  return !(fabsf(s0) < kS0Lo) && !(md < kDsigLo) && !(md > kDsigHi);
}

// The G pixels one thread solves: features (s0_cr, dsig_cr, wco/2, has_co)
// and running minima, as slab::Chains keeps them. idx is the first entry of
// the float4 (or the tail entry) where the minimum was first reached, -1
// while no cost has been below +inf; after resolve() the entry itself.
template <int G, bool kHoisted>
struct Pixels {
  float s0[G], dsig[G], rcp[G], wco[G], has[G];
  float best[G];
  int idx[G];

  __device__ __forceinline__ void load(const float4 (&f)[G]) {
#pragma unroll
    for (int k = 0; k < G; ++k) {
      s0[k] = f[k].x;
      dsig[k] = f[k].y;
      rcp[k] = kHoisted ? __frcp_rn(f[k].y) : 0.0f;
      wco[k] = f[k].z;
      has[k] = f[k].w;
      best[k] = CUDART_INF_F;
      idx[k] = -1;
    }
  }

  __device__ __forceinline__ float cost(int k, float l, float wh) const {
    const float d = __fsub_rn(l, s0[k]);
    const float q = kHoisted ? hoisted_quotient(d, dsig[k], rcp[k]) : __fdiv_rn(d, dsig[k]);
    const float dw = __fsub_rn(wh, wco[k]);
    return __fadd_rn(__fmul_rn(q, q), __fmul_rn(__fmul_rn(dw, dw), has[k]));
  }

  // The strict '<' keeps the first minimum; NaN propagates into best.
  __device__ __forceinline__ void keep(int k, float j, int e) {
    const bool better = j < best[k];
    best[k] = min_nan(best[k], j);
    idx[k] = better ? e : idx[k];
  }

  __device__ __forceinline__ void sweep(const float* row, const float* w_half, int n_cr) {
    int c = 0;
    for (; c + 4 <= n_cr; c += 4) {
      const float4 l = *reinterpret_cast<const float4*>(row + c);
      const float4 w = *reinterpret_cast<const float4*>(w_half + c);
#pragma unroll
      for (int k = 0; k < G; ++k) {
        const float j01 = min_nan(cost(k, l.x, w.x), cost(k, l.y, w.y));
        const float j23 = min_nan(cost(k, l.z, w.z), cost(k, l.w, w.w));
        keep(k, min_nan(j01, j23), c);
      }
    }
    for (; c < n_cr; ++c) {
#pragma unroll
      for (int k = 0; k < G; ++k) keep(k, cost(k, row[c], w_half[c]), c);
    }
    // the first entry at or after idx, within its four, that holds the minimum
#pragma unroll
    for (int k = 0; k < G; ++k) {
      if (idx[k] < 0 || best[k] != best[k]) continue;
      const int end = min(idx[k] + 4, n_cr);
      for (int e = idx[k]; e < end; ++e) {
        if (cost(k, row[e], w_half[e]) == best[k]) {
          idx[k] = e;
          break;
        }
      }
    }
  }

  __device__ __forceinline__ bool poisoned(int k) const { return best[k] != best[k]; }

  // No cost below +inf leaves the first entry, as argmin over equal costs does.
  __device__ __forceinline__ float speed(int k, const float* w_half) const {
    const float wh = w_half[max(idx[k], 0)];
    return poisoned(k) ? 0.0f : __fadd_rn(wh, wh);
  }
};

// Solve G pixels over the row (n_cr entries, in shared memory with w_half):
// out[k] is pixel k's winning speed. Pixels whose features allow it share the
// hoisted loop; one pixel outside the windows, or one whose minimum came out
// NaN from features without a NaN, sends the thread's pixels through the
// loop with the true divide.
template <int G>
__device__ __forceinline__ void argmin(const float* row, const float* w_half, int n_cr,
                                       const float4 (&f)[G], float (&out)[G]) {
  bool hoist = true;
#pragma unroll
  for (int k = 0; k < G; ++k) hoist &= hoistable(f[k].x, f[k].y);
  if (hoist) {
    Pixels<G, true> p;
    p.load(f);
    p.sweep(row, w_half, n_cr);
    bool again = false;
#pragma unroll
    for (int k = 0; k < G; ++k) {
      const bool clean = f[k].x == f[k].x && f[k].y == f[k].y && f[k].z == f[k].z &&
                         f[k].w == f[k].w;
      again |= p.poisoned(k) && clean;
      out[k] = p.speed(k, w_half);
    }
    if (!again) return;
  }
  Pixels<G, false> p;
  p.load(f);
  p.sweep(row, w_half, n_cr);
#pragma unroll
  for (int k = 0; k < G; ++k) out[k] = p.speed(k, w_half);
}

// Copy the band's LUT row and w_half into shared memory (s_row, then s_wh at
// row_stride(n_cr)); the caller synchronizes.
__device__ __forceinline__ void stage(float* smem, const float* __restrict__ row,
                                      const float* __restrict__ w_half, int n_cr, int n_threads) {
  float* s_wh = smem + row_stride(n_cr);
  for (int i = threadIdx.x; i < n_cr; i += n_threads) {
    smem[i] = row[i];
    s_wh[i] = w_half[i];
  }
}

}  // namespace crosspol

// Dynamic shared memory above the 48 KB default needs an explicit opt-in.
template <typename Kernel>
inline cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

}  // namespace xs
