// bucket_sort: the bucketings' stable radix sort over the bits their keys
// hold, and the 32-bit order-preserving key of a float32 value.
//
// Replaces no pallas_call: the JAX package sorts with jax.lax.sort on uint32
// keys (xsarsea_tpu/ops/pallas_inversion.py, bucket_by_band and
// bucket_by_value), and the port first sorted them with torch.sort on int64
// keys with int64 indices: cub's onesweep over all 64 bits, 8 passes of 32 B
// a pixel. Here a key is 32 bits with a 32-bit payload, and the sort covers
// only bits [0, end_bit) of it: 32 for the incidence key, the bit length of
// the largest band for a band key (14 for the re-bucketing of a 501 x 499
// table, 7 for a 67-incidence crosspol axis). A radix pass of 8 bits moves
// 16 B a pixel (key and payload, read and written), so the sort's bytes fall
// with its passes: ~68 B a pixel at 32 bits, ~36 at 14, ~20 at 7.
//
// xs_f32_sort_key writes the key, int32: the float's bits where the sign bit
// is clear, the bits xor 0x7fffffff where it is set, INT32_MIN for +-inf and
// INT32_MAX for NaN: bucketing._f32_sort_key_np's key, the JAX package's
// unsigned key less 2^31, so that its signed order is the unsigned one.
// Bound: bytes, 4 B in and 4 B out a pixel.
//
// xs_radix_sort_pairs is cub::DeviceRadixSort::SortPairs on int keys and int
// values, stable, on the caller's stream, into the temporary storage the
// caller allocates (xs_radix_sort_temp_bytes says how much). At end_bit 32
// the keys compare as signed integers; below it only their low end_bit bits
// count, so the keys must lie in [0, 2^end_bit).
#include <cuda_runtime.h>

#include <climits>
#include <cub/device/device_radix_sort.cuh>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
    f32_sort_key_kernel(const int* __restrict__ bits, int* __restrict__ key, long long n) {
  const long long i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= n) return;
  const int b = bits[i];
  int k = b >= 0 ? b : b ^ 0x7fffffff;
  if ((b & 0x7f800000) == 0x7f800000) k = (b & 0x007fffff) ? INT_MAX : INT_MIN;
  key[i] = k;
}

}  // namespace

// values: the float32 values' bits (the tensor viewed as int32).
extern "C" int xs_f32_sort_key(const int* values, int* key, long long n, void* stream) {
  if (n == 0) return 0;
  const long long blocks = (n + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  f32_sort_key_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(values, key, n);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int xs_radix_sort_temp_bytes(long long n, int end_bit, unsigned long long* bytes) {
  if (n > INT_MAX || end_bit < 1 || end_bit > 32) return static_cast<int>(cudaErrorInvalidValue);
  size_t temp = 0;
  const cudaError_t err = cub::DeviceRadixSort::SortPairs(
      nullptr, temp, static_cast<const int*>(nullptr), static_cast<int*>(nullptr),
      static_cast<const int*>(nullptr), static_cast<int*>(nullptr), static_cast<int>(n), 0,
      end_bit);
  *bytes = temp;
  return static_cast<int>(err);
}

extern "C" int xs_radix_sort_pairs(void* temp, unsigned long long temp_bytes, const int* keys_in,
                                   int* keys_out, const int* values_in, int* values_out,
                                   long long n, int end_bit, void* stream) {
  if (n > INT_MAX || end_bit < 1 || end_bit > 32) return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  size_t temp_size = temp_bytes;
  const cudaError_t err = cub::DeviceRadixSort::SortPairs(
      temp, temp_size, keys_in, keys_out, values_in, values_out, static_cast<int>(n), 0, end_bit,
      static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
