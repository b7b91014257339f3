// K4: the slab ocean's whole substep loop in one cooperative launch.
//
// Replaces the TPU kernel `ocean_substeps_pallas` / `_ocean_kernel`
// (qingdai_tpu/ops/pallas_ocean.py), which holds every operand in VMEM and
// runs the n_sub substeps on one core. Its plain PyTorch version is
// `ocean_substeps_plain` (qingdai_tpu_torch/ocean.py), whose operation order
// this kernel follows. Inputs: mom = [uo, vo, eta], st = [SST] + tracers,
// forc = [tau_x/(rho H), tau_y/(rho H), Q/(rho c_p H)], geo = the 12 static
// planes in the order of the GEO_* indices of ocean.py.
//
// On the H100 the loop becomes stages over the 181x360 cells, one thread per
// cell (grid-stride), with a grid-wide barrier (cooperative groups) wherever
// a stage reads neighbours written by the stage before:
//   1  pressure gradient (latitude rolls wrap across the poles), Coriolis,
//      wind stress, bottom drag, land zero, polar sponge      -> U, V
//   2  del^4 of (U, V, E), k4_nsub times; each Laplacian is two passes
//      through stencil.cuh (shared with K3)                    4 barriers
//   4  continuity (the divergence's latitude term is zero on rows 0 and
//      H-1), land zero, and each block's partial sums of E*w and w
//   6  removal of the ocean-area mean of E (every block adds the partial
//      sums in the same fixed order, so the mean is deterministic), the
//      departure point with the ocean's cos cap, one bilinear wrap gather of
//      every plane of st from the pre-substep stack, the adv_alpha blend of
//      SST only (tracers take the advected value), NaN scrub of U, V
//   7a cos * dSST/dphi for the K_h Laplacian (only when K_h > 0)
//   7b K_h diffusion and Q_net heating of SST (reduced under ice), SST NaN
//      scrub; mean4 outlier repair from the scrubbed neighbours (wrapping in
//      both axes) and the speed cap into a second U, V buffer; E scrub and
//      clamp
// The last substep's U, V are copied back into mom_out. The polar fills and
// the final SST clamp stay outside, in ocean_step.
//
// What bounds it on the H100: barrier latency and bytes. One substep reads
// and writes each of the 3 + n_st state planes a few times (with 11 planes at
// 181x360 in float, ~6 MB a substep, which L2 holds) and does a few hundred
// flops per cell; its 9 to 10 grid-wide barriers cost a few microseconds
// each. The design keeps every stage in one launch so that nothing returns to
// the host between stages; shared-memory tiles with halos are later work.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "stencil.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;

// geometry-stack planes (the GEO_* indices of ocean.py)
enum {
  kF = 0, kCos05, kCos, kCosTiny, kRExtra, kLand, kOpen, kUnder, kWOcean, kK4U, kK4V, kK4Eta
};

template <typename T>
struct Args {
  const T* mom_in;   // [3, H, W]
  const T* st_in;    // [n_st, H, W]
  const T* forc;     // [3, H, W]
  const T* geo;      // [12, H, W]
  T* mom_out;        // [3, H, W]: U, V, E during the loop
  T* st_out;         // [n_st, H, W]
  T* uv2;            // [2, H, W]: mean4 output, the next substep's U, V source
  T* st2;            // [n_st, H, W]: the other half of the st ping-pong
  T* G;              // [3, H, W] Laplacian scratch
  T* L;              // [3, H, W] Laplacian scratch
  T* sst_tmp;        // [H, W] blended SST before K_h and heating
  T* partials;       // [2 * cap]: per-block sums of E*w, then of w
  int partial_cap, n_st, H, W, n_sub, k4_nsub, use_qnet, mean4;
  double sub_dt, H_m, r_bot, g, a, dlat, dlon, K_h, adv_alpha, ice_qfac, cap, eta_cap;
};

template <typename T>
__device__ __forceinline__ T n2n(T x) {
  // jnp.nan_to_num: NaN -> 0, +-inf -> +-max
  const T big = sizeof(T) == 4 ? T(3.4028234663852886e38) : T(1.7976931348623157e308);
  if (isnan(x)) return T(0);
  return x > big ? big : (x < -big ? -big : x);
}

__device__ __forceinline__ long long floor_mod(long long a, int n) {
  long long r = a % n;
  return r < 0 ? r + n : r;
}

// fixed-order tree sum of one value per thread; every thread gets the sum
template <typename T>
__device__ T block_sum(T v, T* sh) {
  sh[threadIdx.x] = v;
  __syncthreads();
  for (int s = kThreads / 2; s > 0; s >>= 1) {
    if (threadIdx.x < s) sh[threadIdx.x] += sh[threadIdx.x + s];
    __syncthreads();
  }
  const T out = sh[0];
  __syncthreads();
  return out;
}

template <typename T>
__global__ void __launch_bounds__(kThreads) ocean_substeps_kernel(Args<T> A) {
  cg::grid_group grid = cg::this_grid();
  __shared__ T sh[kThreads];

  const int H = A.H, W = A.W;
  const long long HW = (long long)H * W;
  const long long p0 = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long stride = (long long)gridDim.x * blockDim.x;
  const T* geo = A.geo;
  const T* ax = A.forc;
  const T* ay = A.forc + HW;
  const T* heat = A.forc + 2 * HW;
  T* U = A.mom_out;
  T* V = A.mom_out + HW;
  T* E = A.mom_out + 2 * HW;
  T* U2 = A.uv2;
  T* V2 = A.uv2 + HW;

  const T a = T(A.a), dlat = T(A.dlat), two_dlat = T(2.0 * A.dlat);
  const T two_dlon = T(2.0 * A.dlon), dlon = T(A.dlon), dlon2 = T(A.dlon * A.dlon);
  const T a2 = T(A.a * A.a), g = T(A.g), r_bot = T(A.r_bot), sub_dt = T(A.sub_dt);
  const T k4_dt = T(A.sub_dt / A.k4_nsub), dt_H = T(A.sub_dt * A.H_m);
  const T one_m_alpha = T(1.0 - A.adv_alpha), alpha = T(A.adv_alpha);
  const T dt_Kh = T(A.sub_dt * A.K_h), dt_qfac = T(A.sub_dt * A.ice_qfac);
  const T cap = T(A.cap), eta_cap = T(A.eta_cap);

  for (int s = 0; s < A.n_sub; ++s) {
    const T* usrc = s == 0 ? A.mom_in : U2;
    const T* vsrc = s == 0 ? A.mom_in + HW : V2;
    const T* esrc = s == 0 ? A.mom_in + 2 * HW : E;
    const T* cur = s == 0 ? A.st_in : (((A.n_sub - s) % 2 == 0) ? A.st_out : A.st2);
    T* nxt = ((A.n_sub - 1 - s) % 2 == 0) ? A.st_out : A.st2;

    // ---- 1: momentum ----
    for (long long p = p0; p < HW; p += stride) {
      const long long j = p / W, i = p - j * W;
      const long long jp = (j + 1 == H) ? 0 : j + 1, jm = (j == 0) ? H - 1 : j - 1;
      const long long ip = (i + 1 == W) ? 0 : i + 1, im = (i == 0) ? W - 1 : i - 1;
      const T deta_dlam = (esrc[j * W + ip] - esrc[j * W + im]) / two_dlon;
      const T deta_dphi = (esrc[jp * W + i] - esrc[jm * W + i]) / two_dlat;
      const T gx = deta_dlam / (a * geo[kCos05 * HW + p]);
      const T gy = deta_dphi / a;
      const T f = geo[kF * HW + p];
      T uo = usrc[p], vo = vsrc[p];
      const T du = f * vo - g * gx + ax[p] - r_bot * uo;
      const T dv = -f * uo - g * gy + ay[p] - r_bot * vo;
      const bool land = geo[kLand * HW + p] > T(0.5);
      uo = land ? T(0) : uo + sub_dt * du;
      vo = land ? T(0) : vo + sub_dt * dv;
      const T sponge = sub_dt * geo[kRExtra * HW + p];
      U[p] = uo - sponge * uo;
      V[p] = vo - sponge * vo;
      if (s == 0) E[p] = esrc[p];
    }
    grid.sync();

    // ---- 2: del^4 of (U, V, E) ----
    for (int n = 0; n < A.k4_nsub; ++n) {
      for (long long p = p0; p < HW; p += stride) {
        const long long j = p / W, i = p - j * W;
        const T c = geo[kCos05 * HW + p];
        for (int m = 0; m < 3; ++m)
          A.G[m * HW + p] = c * qd::grad_lat(A.mom_out + m * HW, j, i, H, W, dlat, two_dlat);
      }
      grid.sync();
      for (long long p = p0; p < HW; p += stride) {
        const long long j = p / W, i = p - j * W;
        const T c = geo[kCos05 * HW + p];
        for (int m = 0; m < 3; ++m)
          A.L[m * HW + p] = qd::lap_value(A.mom_out + m * HW, A.G + m * HW, c, j, i, H, W,
                                          dlat, two_dlat, dlon2, a2);
      }
      grid.sync();
      for (long long p = p0; p < HW; p += stride) {
        const long long j = p / W, i = p - j * W;
        const T c = geo[kCos05 * HW + p];
        for (int m = 0; m < 3; ++m)
          A.G[m * HW + p] = c * qd::grad_lat(A.L + m * HW, j, i, H, W, dlat, two_dlat);
      }
      grid.sync();
      for (long long p = p0; p < HW; p += stride) {
        const long long j = p / W, i = p - j * W;
        const T c = geo[kCos05 * HW + p];
        for (int m = 0; m < 3; ++m) {
          const T L2 = qd::lap_value(A.L + m * HW, A.G + m * HW, c, j, i, H, W, dlat, two_dlat,
                                     dlon2, a2);
          A.mom_out[m * HW + p] = A.mom_out[m * HW + p] - geo[(kK4U + m) * HW + p] * L2 * k4_dt;
        }
      }
      grid.sync();
    }

    // ---- 4: continuity and the partial sums of the eta mean ----
    T sum_ew = T(0), sum_w = T(0);
    for (long long p = p0; p < HW; p += stride) {
      const long long j = p / W, i = p - j * W;
      const long long ip = (i + 1 == W) ? 0 : i + 1, im = (i == 0) ? W - 1 : i - 1;
      const T du_dlon = (U[j * W + ip] - U[j * W + im]) / two_dlon;
      T dv_dlat = T(0);
      if (j > 0 && j < H - 1)
        dv_dlat = (V[(j + 1) * W + i] * geo[kCos * HW + (j + 1) * W + i]
                   - V[(j - 1) * W + i] * geo[kCos * HW + (j - 1) * W + i]) / two_dlat;
      const T div = (du_dlon + dv_dlat) / (a * geo[kCosTiny * HW + p]);
      T e = E[p] - dt_H * div;
      if (geo[kLand * HW + p] > T(0.5)) e = T(0);
      E[p] = e;
      const T w = geo[kWOcean * HW + p];
      sum_ew += e * w;
      sum_w += w;
    }
    sum_ew = block_sum(sum_ew, sh);
    sum_w = block_sum(sum_w, sh);
    if (threadIdx.x == 0) {
      A.partials[blockIdx.x] = sum_ew;
      A.partials[A.partial_cap + blockIdx.x] = sum_w;
    }
    grid.sync();

    // ---- 6: eta mean removal, departure points, shared gather ----
    T tot_ew = T(0), tot_w = T(0);
    for (int b = threadIdx.x; b < (int)gridDim.x; b += kThreads) {
      tot_ew += A.partials[b];
      tot_w += A.partials[A.partial_cap + b];
    }
    tot_ew = block_sum(tot_ew, sh);
    tot_w = block_sum(tot_w, sh);
    const T eta_mean = tot_ew / (tot_w + T(1e-15));
    for (long long p = p0; p < HW; p += stride) {
      const long long j = p / W, i = p - j * W;
      E[p] = E[p] - eta_mean;
      const T uo = U[p], vo = V[p];
      const T dep_j = T(j) - (vo * sub_dt / a) / dlat;
      const T dep_i = T(i) - (uo * sub_dt / (a * geo[kCos05 * HW + p])) / dlon;
      const T j0f = floor(dep_j), i0f = floor(dep_i);
      const T fj = dep_j - j0f, fi = dep_i - i0f;
      const long long j0 = floor_mod((long long)j0f, H), i0 = floor_mod((long long)i0f, W);
      const long long j1 = (j0 + 1) % H, i1 = (i0 + 1) % W;
      const T w00 = (T(1) - fj) * (T(1) - fi);
      const T w01 = (T(1) - fj) * fi;
      const T w10 = fj * (T(1) - fi);
      const T w11 = fj * fi;
      const long long c00 = j0 * W + i0, c01 = j0 * W + i1, c10 = j1 * W + i0, c11 = j1 * W + i1;
      for (int m = 0; m < A.n_st; ++m) {
        const T* fm = cur + m * HW;
        const T adv = fm[c00] * w00 + fm[c01] * w01 + fm[c10] * w10 + fm[c11] * w11;
        if (m == 0)
          A.sst_tmp[p] = one_m_alpha * fm[p] + alpha * adv;
        else
          nxt[m * HW + p] = adv;
      }
      U[p] = n2n(uo);
      V[p] = n2n(vo);
    }
    grid.sync();

    // ---- 7a: cos * dSST/dphi for the K_h Laplacian ----
    if (A.K_h > 0.0) {
      for (long long p = p0; p < HW; p += stride) {
        const long long j = p / W, i = p - j * W;
        A.G[p] = geo[kCos05 * HW + p] * qd::grad_lat(A.sst_tmp, j, i, H, W, dlat, two_dlat);
      }
      grid.sync();
    }

    // ---- 7b: SST diffusion and heating; outlier repair; eta clamp ----
    for (long long p = p0; p < HW; p += stride) {
      const long long j = p / W, i = p - j * W;
      T sst = A.sst_tmp[p];
      if (A.K_h > 0.0)
        sst = sst + dt_Kh * qd::lap_value(A.sst_tmp, A.G, geo[kCos05 * HW + p], j, i, H, W,
                                          dlat, two_dlat, dlon2, a2);
      if (A.use_qnet) {
        if (geo[kOpen * HW + p] > T(0.5)) sst = sst + sub_dt * heat[p];
        if (A.ice_qfac > 0.0 && geo[kUnder * HW + p] > T(0.5)) sst = sst + dt_qfac * heat[p];
      }
      nxt[p] = n2n(sst);

      T uo = U[p], vo = V[p];
      const T speed = sqrt(uo * uo + vo * vo);
      T scl;
      if (A.mean4) {
        if (speed > cap) {
          const long long jp = (j + 1 == H) ? 0 : j + 1, jm = (j == 0) ? H - 1 : j - 1;
          const long long ip = (i + 1 == W) ? 0 : i + 1, im = (i == 0) ? W - 1 : i - 1;
          uo = T(0.25) * (U[jp * W + i] + U[jm * W + i] + U[j * W + ip] + U[j * W + im]);
          vo = T(0.25) * (V[jp * W + i] + V[jm * W + i] + V[j * W + ip] + V[j * W + im]);
        }
        const T speed2 = sqrt(uo * uo + vo * vo);
        scl = speed2 > cap ? cap / (speed2 + T(1e-12)) : T(1);
      } else {
        scl = speed > cap ? cap / (speed + T(1e-12)) : T(1);
      }
      U2[p] = uo * scl;
      V2[p] = vo * scl;
      const T e = n2n(E[p]);
      E[p] = e < -eta_cap ? -eta_cap : (e > eta_cap ? eta_cap : e);
    }
    grid.sync();
  }

  for (long long p = p0; p < HW; p += stride) {
    U[p] = U2[p];
    V[p] = V2[p];
  }
}

template <typename T>
int launch(const Args<T>& args, void* stream) {
  int dev = 0, sms = 0, coop = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, ocean_substeps_kernel<T>,
                                                      kThreads, 0);
  if (e != cudaSuccess) return (int)e;
  if (!coop || per_sm < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
  const long long HW = (long long)args.H * args.W;
  long long blocks = (HW + kThreads - 1) / kThreads;
  if (blocks > (long long)per_sm * sms) blocks = (long long)per_sm * sms;
  if (blocks > args.partial_cap) blocks = args.partial_cap;
  Args<T> a = args;
  void* params[] = {&a};
  e = cudaLaunchCooperativeKernel((const void*)ocean_substeps_kernel<T>, dim3((unsigned)blocks),
                                  dim3(kThreads), params, 0, (cudaStream_t)stream);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

template <typename T>
int run(const void* mom_in, const void* st_in, const void* forc, const void* geo, void* mom_out,
        void* st_out, void* uv2, void* st2, void* G, void* L, void* sst_tmp, void* partials,
        int partial_cap, int n_st, int H, int W, int n_sub, int k4_nsub, double sub_dt,
        double H_m, double r_bot, double g, double a, double dlat, double dlon, double K_h,
        double adv_alpha, int use_qnet, double ice_qfac, double cap, int mean4, double eta_cap,
        void* stream) {
  Args<T> args{(const T*)mom_in, (const T*)st_in, (const T*)forc, (const T*)geo, (T*)mom_out,
               (T*)st_out, (T*)uv2, (T*)st2, (T*)G, (T*)L, (T*)sst_tmp, (T*)partials,
               partial_cap, n_st, H, W, n_sub, k4_nsub, use_qnet, mean4,
               sub_dt, H_m, r_bot, g, a, dlat, dlon, K_h, adv_alpha, ice_qfac, cap, eta_cap};
  return launch<T>(args, stream);
}

}  // namespace

#define QD_OCEAN_LAUNCHER(NAME, T)                                                          \
  extern "C" int NAME(const void* mom_in, const void* st_in, const void* forc,             \
                      const void* geo, void* mom_out, void* st_out, void* uv2, void* st2,  \
                      void* G, void* L, void* sst_tmp, void* partials, int partial_cap,    \
                      int n_st, int H, int W, int n_sub, int k4_nsub, double sub_dt,       \
                      double H_m, double r_bot, double g, double a, double dlat,           \
                      double dlon, double K_h, double adv_alpha, int use_qnet,             \
                      double ice_qfac, double cap, int mean4, double eta_cap,              \
                      void* stream) {                                                       \
    return run<T>(mom_in, st_in, forc, geo, mom_out, st_out, uv2, st2, G, L, sst_tmp,      \
                  partials, partial_cap, n_st, H, W, n_sub, k4_nsub, sub_dt, H_m, r_bot,   \
                  g, a, dlat, dlon, K_h, adv_alpha, use_qnet, ice_qfac, cap, mean4,         \
                  eta_cap, stream);                                                         \
  }

QD_OCEAN_LAUNCHER(qd_ocean_substeps_f32, float)
QD_OCEAN_LAUNCHER(qd_ocean_substeps_f64, double)
