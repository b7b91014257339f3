// K3: explicit fourth-order hyperdiffusion of a field stack,
//   n substeps of  F <- F - k4 * lap(lap(F)) * dt/n.
//
// Replaces the TPU kernel `hyperdiffuse_pallas` / `_hyper4_kernel`
// (qingdai_tpu/ops/pallas_stencil.py), which keeps the whole chain resident
// in VMEM. The spherical Laplacian is that of `_lap_batched` there; its tiled
// device code (stencil.cuh) is shared with kernel K4 (ocean_substeps.cu).
//
// One launch per substep. A block owns a 32 x 32 tile of one plane (grid z
// = the plane), loads it and the cos map with a 4-row, 2-column halo into
// shared memory (rows clip at 0 and H-1, columns wrap), computes G, L, G
// and the update there (stencil.cuh: tile_del4), and writes only its own
// cells; its 36 x 10 threads each take one column of the 40 x 36 cells. At
// 5 x 181 x 360 that is 360 blocks, all resident at once on 132 SMs. A
// substep reads the last one's every cell, so substeps are separate launches
// ping-ponging between `out` and `tmp`; the main path has one. 32-bit
// indices: the wrapper refuses stacks of 2^31 cells or more.
//
// What bounds it on the H100: device-memory bytes (F and k4 read, out
// written: 12 B a cell in float) and, at the main path's 5 x 181 x 360
// (1.3 MB), the latency of one launch whose blocks each load a tile, pass
// four block barriers and store. The halo reads 1440 cells for 1024 owned.
//
// The batched form (an ensemble's members, one launch a substep): grid z runs
// over the B x M planes of all members, plane z being field z % M of member
// z / M, which reads its F, k4 and cos map at the member's multiple of their
// member strides (a stride of 0: one tensor shared by every member, such as
// the static k4 maps, read without a copy). A plane's arithmetic is the
// single launch's, so each member's result is the same bits.

#include <cuda_runtime.h>

#include "stencil.cuh"

namespace {

constexpr int kTH = 32, kTW = 32;
constexpr int kHaloR = 4, kHaloC = 2;  // one del^4 substep; held by tests/test_torch_halo.py
constexpr int kNR = kTH + 2 * kHaloR, kNC = kTW + 2 * kHaloC, kPlane = kNR * kNC;
constexpr int kBY = 10;  // block (kNC, kBY): a thread takes one column and every kBY-th row

// kMembers false: one member, with none of the member arithmetic (a single
// call's blocks start as they did)
template <typename T, bool kMembers>
__global__ void __launch_bounds__(kNC * kBY)
hyper4_tile_kernel(const T* __restrict__ F, const T* __restrict__ k4, const T* __restrict__ cosm,
                   T* __restrict__ out, int M, int H, int W, long long F_bs, long long k4_bs,
                   long long c_bs, qd::Inv<T> inv, T sub_dt) {
  __shared__ T sX[kPlane], sG[kPlane], sL[kPlane], sC[kPlane];
  // plane z: field m of member b; `plane` offsets F, k4 and out to it
  const int b = kMembers ? (int)blockIdx.z / M : 0;
  const int plane = ((int)blockIdx.z - b * M) * H * W;
  if (kMembers) {
    F += b * F_bs;
    k4 += b * k4_bs;
    cosm += b * c_bs;
    out += b * M * (long long)(H * W);
  }
  const int j0 = blockIdx.y * kTH, i0 = blockIdx.x * kTW;
  const int oh = min(kTH, H - j0), ow = min(kTW, W - i0);
  const int r0 = max(0, j0 - kHaloR), nr = min(H, j0 + oh + kHaloR) - r0, nc = ow + 2 * kHaloC;
  const qd::Tile t{H, r0, nr, nc};
  const qd::Rect own{j0 - r0, j0 - r0 + oh, kHaloC, kHaloC + ow};
  // this thread's global column
  int gi = i0 - kHaloC + (int)threadIdx.x;
  gi = gi < 0 ? gi + W : (gi >= W ? gi - W : gi);

  qd::for_rect(qd::Rect{0, nr, 0, nc}, [&](int lr, int lc) {
    const int g = (r0 + lr) * W + gi, p = lr * nc + lc;
    sX[p] = F[plane + g];
    sC[p] = cosm[g];
  });
  __syncthreads();
  qd::tile_del4<1>(sX, sG, sL, kPlane, sC, t, own,
                   [&](int, int lr) { return k4[plane + (r0 + lr) * W + gi]; }, sub_dt, inv);
  qd::for_rect(own, [&](int lr, int lc) { out[plane + (r0 + lr) * W + gi] = sX[lr * nc + lc]; });
}

template <typename T>
int run(const void* F, const void* k4, const void* cosm, void* out, void* tmp, int n_members,
        long long F_bs, long long k4_bs, long long c_bs, int M, int H, int W, int n_sub,
        double dlat, double dlon, double a, double sub_dt, void* stream) {
  if (n_sub > 1 && tmp == nullptr) return (int)cudaErrorInvalidValue;
  if (n_members < 1 || (long long)n_members * M > 65535) return (int)cudaErrorInvalidValue;
  const dim3 grid((W + kTW - 1) / kTW, (H + kTH - 1) / kTH, n_members * M);
  const qd::Inv<T> inv = qd::inverses<T>(dlat, dlon, a);
  const T tsub = T(sub_dt);
  const T* src = (const T*)F;
  long long src_bs = F_bs;
  for (int n = 0; n < n_sub; ++n) {
    // the last substep lands in out
    T* dst = ((n_sub - 1 - n) % 2 == 0) ? (T*)out : (T*)tmp;
    auto kernel = n_members > 1 ? hyper4_tile_kernel<T, true> : hyper4_tile_kernel<T, false>;
    kernel<<<grid, dim3(kNC, kBY), 0, (cudaStream_t)stream>>>(
        src, (const T*)k4, (const T*)cosm, dst, M, H, W, src_bs, k4_bs, c_bs, inv, tsub);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    src = dst;
    src_bs = (long long)M * H * W;  // out and tmp hold every member's stack
  }
  return 0;
}

}  // namespace

extern "C" int qd_hyper4_halo(int* rows, int* cols) {
  *rows = kHaloR;
  *cols = kHaloC;
  return 0;
}

// n_members members: member b's stack at F + b * F_bs, its k4 maps at
// k4 + b * k4_bs and its cos map at cosm + b * c_bs; out and tmp are
// [n_members, M, H, W]
#define QD_HYPER4_LAUNCHER(NAME, T)                                                          \
  extern "C" int NAME(const void* F, const void* k4, const void* cosm, void* out, void* tmp, \
                      int n_members, long long F_bs, long long k4_bs, long long c_bs, int M, \
                      int H, int W, int n_sub, double dlat, double dlon, double a,           \
                      double sub_dt, void* stream) {                                         \
    return run<T>(F, k4, cosm, out, tmp, n_members, F_bs, k4_bs, c_bs, M, H, W, n_sub, dlat,  \
                  dlon, a, sub_dt, stream);                                                  \
  }

QD_HYPER4_LAUNCHER(qd_hyper4_f32, float)
QD_HYPER4_LAUNCHER(qd_hyper4_f64, double)
