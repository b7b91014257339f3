// Device code of the spherical Laplacian shared by kernels K3 (hyper4.cu)
// and K4 (ocean_substeps.cu): the operator of `_lap_batched`
// (qingdai_tpu/ops/pallas_stencil.py) and of `laplacian_sphere`
// (qingdai_tpu_torch/ops/stencil.py),
//   lap(X) = ( d/dphi(cos * dX/dphi) / cos + d2X/dlambda2 / cos^2 ) / a^2,
// with np.gradient's formula in latitude (central inside, one-sided at rows
// 0 and H-1), periodic second differences in longitude and the caller's
// capped cos map. A Laplacian is two passes: G = cos * dX/dphi is stored
// whole, then lap_value differentiates G itself, so the one-sided rows are
// applied to G as np.gradient does. The operations follow the plain
// version's order, so with --fmad=false each rounds the same way.
#pragma once

#include <cuda_runtime.h>

namespace qd {

// dX/dphi at (j, i) of one [H, W] plane
template <typename T>
__device__ __forceinline__ T grad_lat(const T* X, long long j, long long i, int H, int W,
                                      T dlat, T two_dlat) {
  if (j == 0) return (X[W + i] - X[i]) / dlat;
  if (j == H - 1) return (X[j * W + i] - X[(j - 1) * W + i]) / dlat;
  return (X[(j + 1) * W + i] - X[(j - 1) * W + i]) / two_dlat;
}

// lap(X) at (j, i) of one plane, given G = cos * dX/dphi of that plane
template <typename T>
__device__ __forceinline__ T lap_value(const T* X, const T* G, T c, long long j, long long i,
                                       int H, int W, T dlat, T two_dlat, T dlon2, T a2) {
  const T term_phi = grad_lat(G, j, i, H, W, dlat, two_dlat) / c;
  const long long ip = (i + 1 == W) ? 0 : i + 1, im = (i == 0) ? W - 1 : i - 1;
  const T d2 = (X[j * W + ip] - T(2) * X[j * W + i] + X[j * W + im]) / dlon2;
  return (term_phi + d2 / (c * c)) / a2;
}

}  // namespace qd
