// K1: exact median of the strictly positive entries of a field.
//
// Replaces the TPU kernel `_median_pos_pallas` / `_median_pos_pallas_kernel`
// (qingdai_tpu/ops/reductions.py), which brackets the two middle order
// statistics by two 34-step value bisections over a VMEM-resident block.
//
// Here one block of 1024 threads runs an exact radix select over the bit
// patterns of the positive entries. A positive IEEE float (+inf included)
// orders like its bit pattern read as an unsigned integer, so the k-th
// smallest positive value is found digit by digit, 8 bits per pass, most
// significant first: 4 passes for float, 8 for double, after one pass that
// counts the positives. Both middle order statistics, (n-1)/2 and n/2, are
// selected in the same passes with one shared-memory histogram each. The
// result is written to a 0-d device tensor, so nothing returns to the host:
//   out = n > 0 ? 0.5 * (s1 + s2) : fallback
// `v > 0` is false for NaN and for -0.0 and true for +inf, as in the sort
// version; the result is bit-equal to `masked_median_of_positive_ref`.
//
// What bounds it on the H100: latency. The 181x360 float field is 260 KB;
// one CTA re-reads it from L2 five times, each pass a dependent round of
// loads, shared-memory atomics and a 256-bin scan. The other 131 SMs idle,
// which is acceptable for a 3-call-per-step reduction in this first form.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kBins = 256;

template <typename T> struct BitsOf;
template <> struct BitsOf<float> {
  using U = unsigned int;
  static constexpr int kBits = 32;
  __device__ static U get(float v) { return __float_as_uint(v); }
  __device__ static float put(U b) { return __uint_as_float(b); }
};
template <> struct BitsOf<double> {
  using U = unsigned long long;
  static constexpr int kBits = 64;
  __device__ static U get(double v) { return (U)__double_as_longlong(v); }
  __device__ static double put(U b) { return __longlong_as_double((long long)b); }
};

template <typename T>
__global__ void __launch_bounds__(kThreads)
median_pos_kernel(const T* __restrict__ x, long long n_elem, T fallback,
                  T* __restrict__ out) {
  using B = BitsOf<T>;
  using U = typename B::U;
  __shared__ unsigned int hist[2][kBins];
  __shared__ unsigned long long s_n;
  __shared__ unsigned long long s_k[2];
  __shared__ U s_prefix[2];
  const int tid = threadIdx.x;

  if (tid == 0) s_n = 0ull;
  __syncthreads();
  unsigned long long local = 0ull;
  for (long long i = tid; i < n_elem; i += kThreads) local += (x[i] > T(0)) ? 1ull : 0ull;
  if (local) atomicAdd(&s_n, local);
  __syncthreads();
  const unsigned long long n = s_n;
  if (n == 0ull) {
    if (tid == 0) out[0] = fallback;
    return;
  }
  if (tid < 2) {
    s_k[tid] = (tid == 0) ? (n - 1ull) / 2ull : n / 2ull;
    s_prefix[tid] = U(0);
  }

  for (int shift = B::kBits - 8; shift >= 0; shift -= 8) {
    // bits above `shift` already fixed by earlier passes
    const U mask = (shift + 8 == B::kBits) ? U(0) : (~U(0)) << (shift + 8);
    for (int b = tid; b < 2 * kBins; b += kThreads) hist[b / kBins][b % kBins] = 0u;
    __syncthreads();
    const U p0 = s_prefix[0], p1 = s_prefix[1];
    for (long long i = tid; i < n_elem; i += kThreads) {
      const T v = x[i];
      if (v > T(0)) {
        const U bits = B::get(v);
        const unsigned int d = (unsigned int)((bits >> shift) & U(0xFF));
        if ((bits & mask) == p0) atomicAdd(&hist[0][d], 1u);
        if ((bits & mask) == p1) atomicAdd(&hist[1][d], 1u);
      }
    }
    __syncthreads();
    // one thread per target, in different warps
    if (tid == 0 || tid == 32) {
      const int t = tid / 32;
      unsigned long long k = s_k[t], cum = 0ull;
      for (int d = 0; d < kBins; ++d) {
        const unsigned long long c = hist[t][d];
        if (k < cum + c) {
          s_prefix[t] |= U(d) << shift;
          s_k[t] = k - cum;
          break;
        }
        cum += c;
      }
    }
    __syncthreads();
  }
  if (tid == 0) out[0] = T(0.5) * (B::put(s_prefix[0]) + B::put(s_prefix[1]));
}

}  // namespace

extern "C" int qd_median_pos_f32(const void* x, long long n, double fallback,
                                 void* out, void* stream) {
  median_pos_kernel<float><<<1, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)x, n, (float)fallback, (float*)out);
  return (int)cudaGetLastError();
}

extern "C" int qd_median_pos_f64(const void* x, long long n, double fallback,
                                 void* out, void* stream) {
  median_pos_kernel<double><<<1, kThreads, 0, (cudaStream_t)stream>>>(
      (const double*)x, n, fallback, (double*)out);
  return (int)cudaGetLastError();
}
