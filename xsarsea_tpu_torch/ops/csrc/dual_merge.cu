// dual_merge: the dual-pol merge of a piece's winds, with their pack into
// complex64.
//
// Replaces no pallas_call: the JAX package merges on the host once the winds
// are back (xsarsea_tpu/windspeed/inversion.py:1652-1659, the reference's
// windspeed.py:425-428), four numpy passes over the scene while the card
// waits. Here each piece is merged on the card before its copy out, in the
// pass that packs the closure's four float32 planes into complex winds:
//
//   wind_co   = co_re + i co_im
//   wind_dual = wind_co where h(co) < 5 or h(du) < 5 (m/s), else du_re + i du_im
//
// h(re, im) is the float32 modulus rounded once from float64:
// __double2float_rn(__dsqrt_rn(re * re + im * im)), each step correctly
// rounded (__dmul_rn, __dadd_rn: no contraction), so that the decision is
// defined and its plain version (inversion_kernels._dual_merge_plain) makes
// it bit for bit. A NaN modulus compares false. The selection copies bits.
//
// Bound on the H100: bytes, 16 B in and 16 B out a pixel (~0.04 ms a 2^22-px
// piece at 3.35 TB/s); the two float64 moduli a pixel are far below the FP64
// rate at that speed. A thread takes four pixels: one float4 load of each
// plane, two float4 stores (four complex64) of each output. Planes that are
// not 16-byte aligned, and the last n mod 4 pixels, go one pixel a thread.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr float kMergeBelow = 5.0f;  // m/s: the reference's threshold

__device__ __forceinline__ bool below(float re, float im) {
  const double r = re, i = im;
  const double m = __dsqrt_rn(__dadd_rn(__dmul_rn(r, r), __dmul_rn(i, i)));
  return __double2float_rn(m) < kMergeBelow;
}

__device__ __forceinline__ float2 pick(bool take_co, float co_re, float co_im, float du_re,
                                       float du_im) {
  return take_co ? make_float2(co_re, co_im) : make_float2(du_re, du_im);
}

// Threads [0, n_quads) take pixels 4t .. 4t + 3 as float4s; the threads after
// them take one pixel each of [4 n_quads, n).
__global__ void __launch_bounds__(kThreads) dual_merge_kernel(
    const float* __restrict__ co_re, const float* __restrict__ co_im,
    const float* __restrict__ du_re, const float* __restrict__ du_im,
    float* __restrict__ wind_co, float* __restrict__ wind_dual, long long n_quads,
    long long n) {
  const long long t = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (t < n_quads) {
    const float4 cr = reinterpret_cast<const float4*>(co_re)[t];
    const float4 ci = reinterpret_cast<const float4*>(co_im)[t];
    const float4 dr = reinterpret_cast<const float4*>(du_re)[t];
    const float4 di = reinterpret_cast<const float4*>(du_im)[t];
    float4* co = reinterpret_cast<float4*>(wind_co) + 2 * t;
    float4* du = reinterpret_cast<float4*>(wind_dual) + 2 * t;
    co[0] = make_float4(cr.x, ci.x, cr.y, ci.y);
    co[1] = make_float4(cr.z, ci.z, cr.w, ci.w);
    const float2 p0 = pick(below(cr.x, ci.x) || below(dr.x, di.x), cr.x, ci.x, dr.x, di.x);
    const float2 p1 = pick(below(cr.y, ci.y) || below(dr.y, di.y), cr.y, ci.y, dr.y, di.y);
    const float2 p2 = pick(below(cr.z, ci.z) || below(dr.z, di.z), cr.z, ci.z, dr.z, di.z);
    const float2 p3 = pick(below(cr.w, ci.w) || below(dr.w, di.w), cr.w, ci.w, dr.w, di.w);
    du[0] = make_float4(p0.x, p0.y, p1.x, p1.y);
    du[1] = make_float4(p2.x, p2.y, p3.x, p3.y);
    return;
  }
  const long long i = 4 * n_quads + (t - n_quads);
  if (i >= n) return;
  const float a = co_re[i], b = co_im[i], c = du_re[i], d = du_im[i];
  reinterpret_cast<float2*>(wind_co)[i] = make_float2(a, b);
  reinterpret_cast<float2*>(wind_dual)[i] = pick(below(a, b) || below(c, d), a, b, c, d);
}

}  // namespace

extern "C" int xs_dual_merge(const float* co_re, const float* co_im, const float* du_re,
                             const float* du_im, float* wind_co, float* wind_dual, long long n,
                             void* stream) {
  if (n == 0) return 0;
  const std::uintptr_t addresses =
      reinterpret_cast<std::uintptr_t>(co_re) | reinterpret_cast<std::uintptr_t>(co_im) |
      reinterpret_cast<std::uintptr_t>(du_re) | reinterpret_cast<std::uintptr_t>(du_im) |
      reinterpret_cast<std::uintptr_t>(wind_co) | reinterpret_cast<std::uintptr_t>(wind_dual);
  const long long n_quads = (addresses % 16) ? 0 : n / 4;
  const long long threads = n_quads + (n - 4 * n_quads);
  const long long blocks = (threads + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  dual_merge_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(co_re, co_im, du_re, du_im, wind_co,
                                                           wind_dual, n_quads, n);
  return static_cast<int>(cudaGetLastError());
}
