// The crosspol argmin's hoisted quotient (xs::crosspol::quotient,
// inversion_common.cuh) against the true divide: test entries, on no path of
// the inversion.
//
// xs_crosspol_quotient maps the quotient over arrays (a, b) and reports which
// elements took the hoisted route, so a test can hold it bit for bit against
// a / b on random bit patterns and on edge values. xs_crosspol_quotient_sweep
// is the exhaustive check behind the windows: for divisors 1 + i * 2^-23, i
// in [b_first, b_first + b_count), and every dividend in [1, 2), it counts
// the pairs where the hoisted quotient differs from __fdiv_rn. A quotient's
// rounding depends on the two significands alone while every intermediate
// stays a normal number (scaling by powers of two is exact), which the
// windows guarantee, so the 2^46 significand pairs cover every operand pair
// the hoisted route is given.
#include "inversion_common.cuh"

namespace {

__global__ void quotient_map_kernel(const float* __restrict__ a, const float* __restrict__ b,
                                    float* __restrict__ out, int* __restrict__ hoisted, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  bool h;
  out[i] = xs::crosspol::quotient(a[i], b[i], &h);
  hoisted[i] = h;
}

constexpr int kSweepThreads = 256;
constexpr unsigned kSignificands = 1u << 23;
constexpr int kExamples = 16;

// One block per divisor; found[0] counts the differing pairs, found[1] the
// examples written (dividend bits, divisor bits).
__global__ void __launch_bounds__(kSweepThreads) quotient_sweep_kernel(
    unsigned b_first, unsigned long long* __restrict__ found, unsigned* __restrict__ examples) {
  const unsigned b_bits = 0x3f800000u | (b_first + blockIdx.x);
  const float b = __uint_as_float(b_bits);
  const float r = __frcp_rn(b);
  unsigned bad = 0;
  for (unsigned i = threadIdx.x; i < kSignificands; i += kSweepThreads) {
    const float a = __uint_as_float(0x3f800000u | i);
    if (xs::crosspol::hoisted_quotient(a, b, r) != __fdiv_rn(a, b)) {
      ++bad;
      const unsigned long long slot = atomicAdd(found + 1, 1ull);
      if (slot < kExamples) {
        examples[2 * slot] = __float_as_uint(a);
        examples[2 * slot + 1] = b_bits;
      }
    }
  }
  if (bad) atomicAdd(found, static_cast<unsigned long long>(bad));
}

}  // namespace

extern "C" int xs_crosspol_quotient(const float* a, const float* b, float* out, int* hoisted,
                                    int n, void* stream) {
  if (n == 0) return 0;
  const int threads = 256;
  quotient_map_kernel<<<(n + threads - 1) / threads, threads, 0,
                        static_cast<cudaStream_t>(stream)>>>(a, b, out, hoisted, n);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int xs_crosspol_quotient_sweep(unsigned b_first, unsigned b_count,
                                          unsigned long long* found, unsigned* examples,
                                          void* stream) {
  if (b_count == 0) return 0;
  if (b_first + b_count > kSignificands) return static_cast<int>(cudaErrorInvalidValue);
  quotient_sweep_kernel<<<b_count, kSweepThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      b_first, found, examples);
  return static_cast<int>(cudaGetLastError());
}
