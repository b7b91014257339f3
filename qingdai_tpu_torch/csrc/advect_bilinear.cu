// K2: semi-Lagrangian advection of a field stack in one launch, from the
// winds to the advected stack: departure points and bilinear interpolation,
// periodic in both axes.
//
// Replaces the TPU kernel `advect_windowed_pallas` / `_window_kernel`
// (qingdai_tpu/ops/pallas_advect.py), which forms the interpolation as a
// masked sum of shifted copies over a bounded (m, k) window, and with it the
// exact-row gather and the polar band pass of `_advect_windowed`
// (qingdai_tpu/ops/advect.py). A gather costs the H100 nothing special, so
// one thread per output cell (j, i) reads its four corners directly, on
// every row, the polar rows included. It also computes the departure point
// itself, which in plain PyTorch (`departure_indices`) is ~13 launches.
//
// Departure points, bit-equal to `ops.advect.departure_indices` on the card.
// The scalars are cast to T first, as PyTorch casts a Python number to the
// tensor's type. PyTorch divides a CUDA tensor by a Python number as a
// product with the number's reciprocal, taken in double and rounded to T
// (1/dlon rounded from float differs from it by an ulp at 361x720), so the
// launcher passes 1/a, 1/dlat and 1/dlon so rounded, and
//   dlam = (u*dt) / (a*cos)     (IEEE division of two tensors)
//   dx = dlam * (1/dlon),  dy = ((v*dt) * (1/a)) * (1/dlat)
//   dep_j = (T)j - dy,  dep_i = (T)i - dx.
// `--fmad=false` (build.py) keeps every product rounded on its own.
//
// Interpolation, as `bilinear_wrap_gather_multi`: j0 = floor(dep_j) mod H,
// i0 = floor(dep_i) mod W (floor mod, as jnp.mod), corners (j0,i0),
// (j0,i0+1), (j0+1,i0), (j0+1,i0+1) wrapped, weights and sum order
// w00, w01, w10, w11 as there. The index math is 32-bit: a conditional add
// or subtract when the offset is within one period, a 32-bit % beyond that
// (the pole rows' departures reach ~5.4e5 cells at 200 m/s under the 1e-6
// cos cap), and an exact floating-point remainder when |floor(dep)| >= 2^30,
// so that no conversion is undefined.
//
// What bounds it on the H100: the launch. Each call reads the [M,H,W] stack
// and u, v, cos and writes [M,H,W]; at 181x360 and M = 2 that is 1.8 MB,
// which L2 holds, and the dependent chain per thread is one round of loads,
// the departure arithmetic (one IEEE division) and one round of 4M gathers.
// The design keeps that chain short: no 64-bit division, all 4M gathers of
// the specialised M = 1 and M = 2 paths issued before the sums, loads
// through the read-only path, and 32 x 8 blocks so that a warp's corners
// share cache lines under smooth winds.

#include <cuda_runtime.h>

namespace {

constexpr int kBX = 32;
constexpr int kBY = 8;

// floor(dep) mod n for an integral-valued f; any finite or non-finite f
// gives an index in [0, n) (NaN and inf give 0: their weights are NaN).
template <typename T>
__device__ __forceinline__ int wrap_index(T f, int n) {
  if (fabs(f) < T(1 << 30)) {
    int k = (int)f;
    if (k >= n) {
      k -= n;
      if (k >= n) k %= n;
    } else if (k < 0) {
      k += n;
      if (k < 0) {
        k %= n;
        if (k < 0) k += n;
      }
    }
    return k;
  }
  T r = fmod(f, T(n));  // exact
  if (r < T(0)) r += T(n);
  return (r >= T(0) && r < T(n)) ? (int)r : 0;
}

template <typename T>
__device__ __forceinline__ T ld(const T* p) { return __ldg(p); }

// MS = 1 or 2: the stack height, specialised; MS = 0: any M (a loop).
// kMembers false: one member, with none of the member offsets (a single
// call's chain stays as short as it was).
template <typename T, int MS, bool kMembers>
__global__ void __launch_bounds__(kBX * kBY)
advect_bilinear_kernel(const T* __restrict__ f, const T* __restrict__ u,
                       const T* __restrict__ v, const T* __restrict__ cosl,
                       T* __restrict__ out, T* __restrict__ dep_out, int M, int H, int W,
                       long long f_bs, long long u_bs, long long v_bs, long long c_bs, T dt,
                       T a, T inv_a, T inv_dlat, T inv_dlon) {
  const int i = blockIdx.x * kBX + threadIdx.x;
  const int j = blockIdx.y * kBY + threadIdx.y;
  if (i >= W || j >= H) return;
  const int HW = H * W;
  if (kMembers) {
    const long long b = blockIdx.z;
    f += b * f_bs;
    u += b * u_bs;
    v += b * v_bs;
    cosl += b * c_bs;
    out += b * M * (long long)HW;
    if (dep_out != nullptr) dep_out += b * 2 * (long long)HW;
  }
  const int p = j * W + i;
  const T dlam = (ld(u + p) * dt) / (a * ld(cosl + p));
  const T dphi = (ld(v + p) * dt) * inv_a;
  const T dx = dlam * inv_dlon;
  const T dy = dphi * inv_dlat;
  const T dj = T(j) - dy, di = T(i) - dx;
  if (dep_out != nullptr) {
    dep_out[p] = dj;
    dep_out[HW + p] = di;
  }
  const T j0f = floor(dj), i0f = floor(di);
  const T fj = dj - j0f, fi = di - i0f;
  const int j0 = wrap_index(j0f, H), i0 = wrap_index(i0f, W);
  const int j1 = (j0 + 1 == H) ? 0 : j0 + 1;
  const int i1 = (i0 + 1 == W) ? 0 : i0 + 1;
  const T w00 = (T(1) - fj) * (T(1) - fi);
  const T w01 = (T(1) - fj) * fi;
  const T w10 = fj * (T(1) - fi);
  const T w11 = fj * fi;
  const int c00 = j0 * W + i0, c01 = j0 * W + i1;
  const int c10 = j1 * W + i0, c11 = j1 * W + i1;
  if (MS == 1) {
    const T a00 = ld(f + c00), a01 = ld(f + c01), a10 = ld(f + c10), a11 = ld(f + c11);
    out[p] = a00 * w00 + a01 * w01 + a10 * w10 + a11 * w11;
  } else if (MS == 2) {
    const T* g = f + HW;
    const T a00 = ld(f + c00), a01 = ld(f + c01), a10 = ld(f + c10), a11 = ld(f + c11);
    const T b00 = ld(g + c00), b01 = ld(g + c01), b10 = ld(g + c10), b11 = ld(g + c11);
    out[p] = a00 * w00 + a01 * w01 + a10 * w10 + a11 * w11;
    out[HW + p] = b00 * w00 + b01 * w01 + b10 * w10 + b11 * w11;
  } else {
#pragma unroll 2
    for (int m = 0; m < M; ++m) {
      const T* fm = f + (size_t)m * HW;
      out[(size_t)m * HW + p] = ld(fm + c00) * w00 + ld(fm + c01) * w01 +
                                ld(fm + c10) * w10 + ld(fm + c11) * w11;
    }
  }
}

// one launch of the instantiation for M and kMembers
template <typename T, bool kMembers>
void launch_kernel(dim3 grid, cudaStream_t s, const T* f, const T* u, const T* v, const T* c,
                   T* out, T* dep, int M, int H, int W, long long f_bs, long long u_bs,
                   long long v_bs, long long c_bs, T dt, T a, T inv_a, T inv_dlat,
                   T inv_dlon) {
  const dim3 block(kBX, kBY);
  if (M == 1)
    advect_bilinear_kernel<T, 1, kMembers><<<grid, block, 0, s>>>(
        f, u, v, c, out, dep, M, H, W, f_bs, u_bs, v_bs, c_bs, dt, a, inv_a, inv_dlat, inv_dlon);
  else if (M == 2)
    advect_bilinear_kernel<T, 2, kMembers><<<grid, block, 0, s>>>(
        f, u, v, c, out, dep, M, H, W, f_bs, u_bs, v_bs, c_bs, dt, a, inv_a, inv_dlat, inv_dlon);
  else
    advect_bilinear_kernel<T, 0, kMembers><<<grid, block, 0, s>>>(
        f, u, v, c, out, dep, M, H, W, f_bs, u_bs, v_bs, c_bs, dt, a, inv_a, inv_dlat, inv_dlon);
}

template <typename T>
int launch(const void* f, const void* u, const void* v, const void* cosl, void* out,
           void* dep_out, int n_members, long long f_bs, long long u_bs, long long v_bs,
           long long c_bs, int M, int H, int W, double dt, double a, double dlat, double dlon,
           void* stream) {
  if (n_members < 1 || n_members > 65535) return (int)cudaErrorInvalidValue;
  // the scalars in T, and the reciprocals PyTorch multiplies by: taken in
  // double, rounded to T
  const T dt_t = (T)dt, a_t = (T)a;
  const T inv_a = T(1.0 / a), inv_dlat = T(1.0 / dlat), inv_dlon = T(1.0 / dlon);
  const dim3 grid((W + kBX - 1) / kBX, (H + kBY - 1) / kBY, n_members);
  auto run = n_members > 1 ? launch_kernel<T, true> : launch_kernel<T, false>;
  run(grid, (cudaStream_t)stream, (const T*)f, (const T*)u, (const T*)v, (const T*)cosl,
      (T*)out, (T*)dep_out, M, H, W, f_bs, u_bs, v_bs, c_bs, dt_t, a_t, inv_a, inv_dlat, inv_dlon);
  return (int)cudaGetLastError();
}

}  // namespace

// n_members members: member b's stack at f + b * f_bs, winds at u + b * u_bs
// and v + b * v_bs, cos map at cosl + b * c_bs; out is [n_members, M, H, W]
// and dep_out [n_members, 2, H, W]
#define QD_ADVECT_LAUNCHER(NAME, T)                                                          \
  extern "C" int NAME(const void* f, const void* u, const void* v, const void* cosl,        \
                      void* out, void* dep_out, int n_members, long long f_bs,             \
                      long long u_bs, long long v_bs, long long c_bs, int M, int H, int W, \
                      double dt, double a, double dlat, double dlon, void* stream) {       \
    return launch<T>(f, u, v, cosl, out, dep_out, n_members, f_bs, u_bs, v_bs, c_bs, M, H,  \
                     W, dt, a, dlat, dlon, stream);                                         \
  }

QD_ADVECT_LAUNCHER(qd_advect_bilinear_f32, float)
QD_ADVECT_LAUNCHER(qd_advect_bilinear_f64, double)
