// K2: bilinear interpolation of a field stack at departure points, periodic
// in both axes.
//
// Replaces the TPU kernel `advect_windowed_pallas` / `_window_kernel`
// (qingdai_tpu/ops/pallas_advect.py), which forms the interpolation as a
// masked sum of shifted copies over a bounded (m, k) window, and with it the
// exact-row gather and the polar band pass of `_advect_windowed`
// (qingdai_tpu/ops/advect.py). A gather costs the H100 nothing special, so
// one thread per output cell (j, i) reads its four corners directly, on
// every row, the polar rows included:
//   j0 = floor(dep_j) mod H, i0 = floor(dep_i) mod W (floor mod, as jnp.mod:
//   C's % truncates, so a negative index is folded back into [0, n)),
//   corners (j0,i0), (j0,i0+1), (j0+1,i0), (j0+1,i0+1), all mod (H, W),
//   weights and sum order as `bilinear_wrap_gather_multi`.
// The thread loops over the M fields, reusing the four weights and indices.
//
// What bounds it on the H100: device-memory bytes. Each call reads the
// [M,H,W] stack and the two index maps and writes [M,H,W]; at 181x360 that
// is under 2 MB, which L2 holds, so in practice the launch latency dominates.

#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ long long floor_mod(long long a, int n) {
  long long r = a % n;
  return r < 0 ? r + n : r;
}

template <typename T>
__global__ void advect_bilinear_kernel(const T* __restrict__ f,
                                       const T* __restrict__ dep_j,
                                       const T* __restrict__ dep_i,
                                       T* __restrict__ out, int M, int H, int W) {
  const long long HW = (long long)H * W;
  const long long p = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= HW) return;
  const T dj = dep_j[p], di = dep_i[p];
  const T j0f = floor(dj), i0f = floor(di);
  const T fj = dj - j0f, fi = di - i0f;
  const long long j0 = floor_mod((long long)j0f, H), i0 = floor_mod((long long)i0f, W);
  const long long j1 = (j0 + 1) % H, i1 = (i0 + 1) % W;
  const T w00 = (T(1) - fj) * (T(1) - fi);
  const T w01 = (T(1) - fj) * fi;
  const T w10 = fj * (T(1) - fi);
  const T w11 = fj * fi;
  const long long c00 = j0 * W + i0, c01 = j0 * W + i1;
  const long long c10 = j1 * W + i0, c11 = j1 * W + i1;
  for (int m = 0; m < M; ++m) {
    const T* fm = f + m * HW;
    out[m * HW + p] = fm[c00] * w00 + fm[c01] * w01 + fm[c10] * w10 + fm[c11] * w11;
  }
}

template <typename T>
int launch(const void* f, const void* dep_j, const void* dep_i, void* out,
           int M, int H, int W, void* stream) {
  const int threads = 256;
  const long long HW = (long long)H * W;
  const unsigned int blocks = (unsigned int)((HW + threads - 1) / threads);
  advect_bilinear_kernel<T><<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (const T*)f, (const T*)dep_j, (const T*)dep_i, (T*)out, M, H, W);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int qd_advect_bilinear_f32(const void* f, const void* dep_j, const void* dep_i,
                                      void* out, int M, int H, int W, void* stream) {
  return launch<float>(f, dep_j, dep_i, out, M, H, W, stream);
}

extern "C" int qd_advect_bilinear_f64(const void* f, const void* dep_j, const void* dep_i,
                                      void* out, int M, int H, int W, void* stream) {
  return launch<double>(f, dep_j, dep_i, out, M, H, W, stream);
}
