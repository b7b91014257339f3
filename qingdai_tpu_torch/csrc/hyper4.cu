// K3: explicit fourth-order hyperdiffusion of a field stack,
//   n substeps of  F <- F - k4 * lap(lap(F)) * dt/n.
//
// Replaces the TPU kernel `hyperdiffuse_pallas` / `_hyper4_kernel`
// (qingdai_tpu/ops/pallas_stencil.py), which keeps the whole chain resident
// in VMEM. The spherical Laplacian is that of `_lap_batched` there; its
// device code (stencil.cuh) is shared with kernel K4 (ocean_substeps.cu).
//
// Each Laplacian is two launches over every (m, j, i):
//   grad_cos:   G = cos * dX/dphi
//   lap_finish: L = (dG/dphi / cos + d2X/dlambda2 / cos^2) / a^2, and on the
//               second Laplacian of a substep F_out = F - k4 * L * dt/n.
// G is stored whole before its latitude derivative is taken, so the
// one-sided formula at rows 0 and H-1 is applied to G itself, as
// np.gradient does, and not to F. The update reads F only at its own cell,
// so later substeps update the output in place.
//
// What bounds it on the H100: device-memory bytes and launch latency. Each
// substep makes four passes over the [M,H,W] stack (at 181x360 with M=5,
// 2.6 MB a pass in float, which L2 holds); the arithmetic is a few dozen
// flops per cell.

#include <cuda_runtime.h>

#include "stencil.cuh"

namespace {

constexpr int kThreads = 256;

template <typename T>
__global__ void grad_cos_kernel(const T* __restrict__ X, const T* __restrict__ cosm,
                                T* __restrict__ G, int M, int H, int W,
                                T dlat, T two_dlat) {
  const long long HW = (long long)H * W;
  const long long p = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= M * HW) return;
  const long long m = p / HW, r = p - m * HW, j = r / W, i = r - j * W;
  G[p] = cosm[r] * qd::grad_lat(X + m * HW, j, i, H, W, dlat, two_dlat);
}

template <typename T>
__global__ void lap_finish_kernel(const T* __restrict__ X, const T* __restrict__ G,
                                  const T* __restrict__ cosm, const T* __restrict__ k4,
                                  const T* Fsrc, T* out, int M, int H, int W,
                                  T dlat, T two_dlat, T dlon2, T a2, T sub_dt,
                                  int update) {
  const long long HW = (long long)H * W;
  const long long p = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= M * HW) return;
  const long long m = p / HW, r = p - m * HW, j = r / W, i = r - j * W;
  const T L = qd::lap_value(X + m * HW, G + m * HW, cosm[r], j, i, H, W, dlat, two_dlat,
                            dlon2, a2);
  out[p] = update ? Fsrc[p] - k4[p] * L * sub_dt : L;
}

template <typename T>
int run(const void* F, const void* k4, const void* cosm, void* out, void* G, void* L,
        int M, int H, int W, int n_sub, double dlat, double dlon, double a,
        double sub_dt, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const long long total = (long long)M * H * W;
  const unsigned int blocks = (unsigned int)((total + kThreads - 1) / kThreads);
  const T tdlat = T(dlat), ttwo = T(2.0 * dlat), tdlon2 = T(dlon * dlon), ta2 = T(a * a);
  const T tsub = T(sub_dt);
  const T* cur = (const T*)F;
  for (int n = 0; n < n_sub; ++n) {
    grad_cos_kernel<T><<<blocks, kThreads, 0, s>>>(cur, (const T*)cosm, (T*)G, M, H, W,
                                                   tdlat, ttwo);
    lap_finish_kernel<T><<<blocks, kThreads, 0, s>>>(cur, (const T*)G, (const T*)cosm,
                                                     (const T*)k4, nullptr, (T*)L, M, H, W,
                                                     tdlat, ttwo, tdlon2, ta2, tsub, 0);
    grad_cos_kernel<T><<<blocks, kThreads, 0, s>>>((const T*)L, (const T*)cosm, (T*)G,
                                                   M, H, W, tdlat, ttwo);
    lap_finish_kernel<T><<<blocks, kThreads, 0, s>>>((const T*)L, (const T*)G,
                                                     (const T*)cosm, (const T*)k4, cur,
                                                     (T*)out, M, H, W, tdlat, ttwo, tdlon2,
                                                     ta2, tsub, 1);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    cur = (const T*)out;
  }
  return 0;
}

}  // namespace

extern "C" int qd_hyper4_f32(const void* F, const void* k4, const void* cosm, void* out,
                             void* G, void* L, int M, int H, int W, int n_sub, double dlat,
                             double dlon, double a, double sub_dt, void* stream) {
  return run<float>(F, k4, cosm, out, G, L, M, H, W, n_sub, dlat, dlon, a, sub_dt, stream);
}

extern "C" int qd_hyper4_f64(const void* F, const void* k4, const void* cosm, void* out,
                             void* G, void* L, int M, int H, int W, int n_sub, double dlat,
                             double dlon, double a, double sub_dt, void* stream) {
  return run<double>(F, k4, cosm, out, G, L, M, H, W, n_sub, dlat, dlon, a, sub_dt, stream);
}
