// Device code of the spherical Laplacian on a tile in shared memory, shared
// by kernels K3 (hyper4.cu) and K4 (ocean_substeps.cu; K5, phyto_transport.cu,
// takes its reciprocals, `Inv`): the operator of
// `_lap_batched` (qingdai_tpu/ops/pallas_stencil.py) and of
// `laplacian_sphere` (qingdai_tpu_torch/ops/stencil.py),
//   lap(X) = ( d/dphi(cos * dX/dphi) / cos + d2X/dlambda2 / cos^2 ) / a^2,
// with np.gradient's formula in latitude (central inside, one-sided at rows
// 0 and H-1), periodic second differences in longitude and the caller's
// capped cos map. G = cos * dX/dphi is stored whole and then differentiated
// itself, so the one-sided rows are applied to G as np.gradient does. The
// operations follow the plain version's order on the card, so with
// --fmad=false each rounds the same way: PyTorch divides a CUDA tensor by a
// Python number as a product with the reciprocal taken in T (see
// advect_bilinear.cu), so the divisions by dlat, 2 dlat, dlon^2 and a^2 are
// products with `Inv`'s reciprocals, and those by cos and cos^2 divisions.
//
// A tile holds rows r0 .. r0+nr-1 of the [H, W] grid (clipped to the grid:
// latitude does not wrap) and nc consecutive columns (longitude wraps: the
// caller maps local columns to global ones); each plane has pitch nc. The
// block is 2-D: thread (x, y) takes local column x and local rows y,
// y + blockDim.y, ..., so blockDim.x >= nc and no index is divided. One
// Laplacian reads its input 2 rows and 1 column around each output cell,
// so a del^4 substep reads 4 rows and 2 columns around it: the halo.
#pragma once

#include <cuda_runtime.h>

namespace qd {

struct Tile {
  int H;           // rows of the grid
  int r0, nr, nc;  // first global row, local rows, local columns (the pitch)
};

// the reciprocals of the Laplacian's scalars, each taken in double and
// rounded to T, as PyTorch takes the reciprocal of a Python number it
// divides a CUDA tensor by
template <typename T>
struct Inv {
  T dlat, two_dlat, dlon2, a2;
};

template <typename T>
__host__ __device__ __forceinline__ Inv<T> inverses(double dlat, double dlon, double a) {
  return Inv<T>{T(1.0 / dlat), T(1.0 / (2.0 * dlat)), T(1.0 / (dlon * dlon)), T(1.0 / (a * a))};
}

// local cells [ra, rb) x [ca, cb) of a tile
struct Rect {
  int ra, rb, ca, cb;
};

// `r` grown by dr rows and dc columns, its rows clipped to the tile's (the
// tile holds every row it needs except beyond rows 0 and H-1)
__device__ __forceinline__ Rect grow(Rect r, int dr, int dc, int nr) {
  return Rect{max(0, r.ra - dr), min(nr, r.rb + dr), r.ca - dc, r.cb + dc};
}

// f(lr, lc) for this thread's cells of `r`
template <typename F>
__device__ __forceinline__ void for_rect(Rect r, F f) {
  const int lc = threadIdx.x;
  if (lc < r.ca || lc >= r.cb) return;
  for (int lr = r.ra + (int)threadIdx.y; lr < r.rb; lr += blockDim.y) f(lr, lc);
}

// dX/dphi at local cell p (global row j) of one plane
template <typename T>
__device__ __forceinline__ T dphi(const T* X, int p, int j, const Tile& t, const Inv<T>& v) {
  if (j == 0) return (X[p + t.nc] - X[p]) * v.dlat;
  if (j == t.H - 1) return (X[p] - X[p - t.nc]) * v.dlat;
  return (X[p + t.nc] - X[p - t.nc]) * v.two_dlat;
}

// lap(X) at local cell p (global row j, capped cos c), given G = cos * dX/dphi
template <typename T>
__device__ __forceinline__ T lap_at(const T* X, const T* G, T c, int p, int j, const Tile& t,
                                    const Inv<T>& v) {
  const T term_phi = dphi(G, p, j, t, v) / c;
  const T d2 = (X[p + 1] - T(2) * X[p] + X[p - 1]) * v.dlon2;
  return (term_phi + d2 / (c * c)) * v.a2;
}

// One del^4 substep of NF planes (plane stride ps) in shared memory,
//   X <- X - k4(m, lr) * lap(lap(X)) * dt   on the cells of `out`,
// where X is valid on `out` grown by (4, 2); G and L are NF scratch planes,
// C the tile's cos plane, k4(m, lr) the coefficient of plane m at local row
// lr in this thread's column. Ends with a block barrier.
template <int NF, typename T, typename K4>
__device__ __forceinline__ void tile_del4(T* X, T* G, T* L, int ps, const T* C, const Tile& t,
                                          Rect out, K4 k4, T dt, const Inv<T>& v) {
  for_rect(grow(out, 3, 1, t.nr), [&](int lr, int lc) {
    const int p = lr * t.nc + lc;
#pragma unroll
    for (int m = 0; m < NF; ++m) G[m * ps + p] = C[p] * dphi(X + m * ps, p, t.r0 + lr, t, v);
  });
  __syncthreads();
  for_rect(grow(out, 2, 1, t.nr), [&](int lr, int lc) {
    const int p = lr * t.nc + lc;
#pragma unroll
    for (int m = 0; m < NF; ++m)
      L[m * ps + p] = lap_at(X + m * ps, G + m * ps, C[p], p, t.r0 + lr, t, v);
  });
  __syncthreads();
  for_rect(grow(out, 1, 0, t.nr), [&](int lr, int lc) {
    const int p = lr * t.nc + lc;
#pragma unroll
    for (int m = 0; m < NF; ++m) G[m * ps + p] = C[p] * dphi(L + m * ps, p, t.r0 + lr, t, v);
  });
  __syncthreads();
  for_rect(out, [&](int lr, int lc) {
    const int p = lr * t.nc + lc;
#pragma unroll
    for (int m = 0; m < NF; ++m) {
      const T L2 = lap_at(L + m * ps, G + m * ps, C[p], p, t.r0 + lr, t, v);
      X[m * ps + p] = X[m * ps + p] - k4(m, lr) * L2 * dt;
    }
  });
  __syncthreads();
}

}  // namespace qd
