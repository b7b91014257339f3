// K4: the slab ocean's whole substep loop on halo tiles.
//
// Replaces the TPU kernel `ocean_substeps_pallas` / `_ocean_kernel`
// (qingdai_tpu/ops/pallas_ocean.py), which holds every operand in VMEM and
// runs the n_sub substeps on one core. Its plain PyTorch version is
// `ocean_substeps_plain` (qingdai_tpu_torch/ocean.py), whose operation order
// this kernel follows. Inputs: mom = [uo, vo, eta], st = [SST] + tracers,
// forc = [tau_x/(rho H), tau_y/(rho H), Q/(rho c_p H)], geo = the 12 static
// planes in the order of the GEO_* indices of ocean.py.
//
// The ocean-area mean of eta is the only dependency of a substep that spans
// the grid; every other stage reads a fixed neighbourhood. So a substep is
// two phases with one grid-wide dependency between them:
//
// tile pass: a block owns a tile of 30 columns and th rows (17 at 181 x 360:
//   11 x 12 = 132 tiles, one block on each SM; see launch) and recomputes in
//   shared memory whatever of its neighbourhood the owned outputs read (rows
//   clip at 0 and H-1, columns wrap); its (30 + 2 + 4k) x th threads each
//   take one column of the neighbourhood (stencil.cuh):
//   1  momentum (pressure gradient with latitude rolls that wrap across the
//      poles, read from the pre-substep eta in device memory; Coriolis, wind
//      stress, bottom drag, land zero, polar sponge) on the owned cells grown
//      by (2 + 4k, 1 + 2k), k = k4_nsub;
//   2  del^4 of (U, V, E), k times, each growing inward by (4, 2)
//      (stencil.cuh: tile_del4, shared with K3);
//   6  departure points from (U, V) with the ocean's cos cap and the bilinear
//      wrap gather of the SST from the pre-substep stack in device memory,
//      blended by adv_alpha, on the owned cells grown by (2, 1); the tracers
//      are gathered on the owned cells only, all planes' loads at once;
//   7  K_h diffusion of the blended SST and Q_net heating (reduced under ice),
//      NaN scrub -> st; continuity (the divergence's latitude term is zero on
//      rows 0 and H-1), land zero -> E before the mean removal; NaN-scrubbed
//      U, V -> the uvs scratch; the tile's sums of E*w and w -> partials.
// grid-wide dependency: the eta mean, the partial sums added by every block
//   in one fixed order over the tiles (bit-identical from run to run).
// finish: per cell, E - mean, NaN scrub and clamp; the mean4 outlier repair
//   from the scrubbed U, V neighbours (wrapping in both axes) and the speed
//   cap -> mom. Deferring mean4 past the dependency keeps the tile pass free
//   of the latitude wrap, whose neighbours lie on the other side of the grid.
// Substeps ping-pong mom and st between the outputs and a second buffer, so
// the last lands in the outputs; a substep after the first reads its
// neighbours' finished cells, so there is one more grid-wide dependency
// between substeps. The polar fills and the final SST clamp stay outside,
// in ocean_step. A call is one cooperative launch with a grid barrier at
// each dependency (the CUDA graph of a call replays it to the same bits); a
// card without cooperative launches is refused.
//
// Arithmetic: the plain version's order on the card, with --fmad=false.
// PyTorch divides a CUDA tensor by a Python number as a product with the
// reciprocal taken in T (advect_bilinear.cu), so those divisions are
// products here too. With one substep every output but eta then equals the
// plain version's bit for bit; eta differs by the mean's order of summation
// (and through eta, a later substep's U and V).
//
// What bounds it on the H100: latency. A substep moves the 3 + n_st state
// planes in and out once plus the 3 forcing and 12 geometry planes (at
// 181 x 360 with 11 planes in float, 11.2 MB, 3.3 us at 3.35 TB/s) and does a
// few hundred flops a cell. Each block's critical path is the chain of the
// tile pass's dependent stencils over its neighbourhood, about twice the
// owned cells (ten block barriers, the del^4 the longest stage, then the
// gather's round trips to L2), then the one grid-wide dependency and the
// finish: scripts/k4_anatomy.py times each stage.
//
// The batched form (an ensemble's members, one launch). A cooperative launch
// holds at most one grid of co-resident blocks (132 on the H100 at this tile
// size), so B members cannot each have their own 132 blocks. The launch
// keeps its blocks and gives each one work item after another: item
// b * n_tiles + t is tile t of member b, so at 181 x 360 block t runs tile t
// of every member in turn. Member b reads mom, st, forc and geo at b times
// their member strides (a stride of 0: one tensor shared by every member,
// such as geo where no member differs) and writes its own outputs, scratch
// and per-tile partial sums. The grid-wide dependency stays one barrier a
// substep for all members; after it every block takes each member's eta
// mean from that member's partial sums, added in the single launch's fixed
// order, and finishes the member's cells as the single launch would. Every
// cell's arithmetic is the single launch's, so each member's result is the
// same bits; a member costs the tile pass's work again, the barrier is
// shared.
//
// The sharded form (a rank of the longitude mesh, parallel/mesh.py). No grid
// barrier spans processes, so a substep splits at its one grid-wide
// dependency into two launches with a host all-reduce between them:
// launch A (ocean_tiles_sharded_kernel) runs the tile pass on the rank's
// tiles and writes their partial sums of E*w and w; the host adds them in
// float64 and across ranks; launch B (ocean_finish_sharded_kernel) removes
// the mean and finishes the rank's cells. Its inputs: mom, forc and geo are
// the rank's columns [.., H, Wo] padded by `pad` >= the halo of
// qd_ocean_substeps_halo with the neighbours' columns, so the tile pass reads
// column pad + c for owned column c with no wrap; st is gathered whole
// [n_st, H, Wg], because the departure gather reads any column, and owned
// column c is global column lon0 + c there. The outputs are the rank's
// columns; uvs holds the scrubbed U, V on the owned columns and one more on
// each side [2, H, Wo + 2], which the edge tiles compute from their padded
// neighbourhood, so mean4 in launch B reads no other rank. Every cell's
// arithmetic is the whole-grid launch's; only the eta mean's order of
// summation differs.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "stencil.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kTW = 30;         // columns of a tile (12 tiles across 360)
constexpr int kMaxBlock = 768;  // threads of a tile block at most (up to 85 registers each)
constexpr int kMaxDevices = 64;
constexpr int kGroup = 10;      // tracer planes gathered together
constexpr int kRed = 2 * 1024 + 32;  // block_sum2's shared values
// trace slots: tile entry, after momentum, after del^4, after the gather,
// after the K_h gradient, after the owned outputs and partial sums, after the
// grid-wide dependency (the finish's entry), after the finish
constexpr int kSlots = 8;

// geometry-stack planes (the GEO_* indices of ocean.py)
enum {
  kF = 0, kCos05, kCos, kCosTiny, kRExtra, kLand, kOpen, kUnder, kWOcean, kK4U, kK4V, kK4Eta
};

// rows and columns around the owned cells on which the tile pass computes
// U, V, E with k del^4 substeps still to come: (2, 1) for the SST's
// departure points and K_h Laplacian, (4, 2) for each del^4 substep. The
// momentum reads eta one cell further, so the halo of mom and forc that a
// substep reads (qd_ocean_substeps_halo, held against the plain version by
// tests/test_torch_halo.py) is this neighbourhood + 1.
__host__ __device__ constexpr int nbhd_rows(int k) { return 2 + 4 * k; }
__host__ __device__ constexpr int nbhd_cols(int k) { return 1 + 2 * k; }

// every array has a leading member axis of n_members; the inputs' member
// strides are *_bs elements (0: shared by every member), the outputs' and
// scratch's are their whole per-member size
template <typename T>
struct Args {
  const T* mom_in;   // [3, H, W]
  const T* st_in;    // [n_st, H, W]
  const T* forc;     // [3, H, W]
  const T* geo;      // [12, H, W]
  T* mom_out;        // [3, H, W]
  T* st_out;         // [n_st, H, W]
  T* mom2;           // [3, H, W]: the other half of the mom ping-pong (n_sub > 1)
  T* st2;            // [n_st, H, W]: the other half of the st ping-pong (n_sub > 1)
  T* uvs;            // [2, H, W]: NaN-scrubbed U, V before mean4
  T* partials;       // [2 * n_tiles]: per-tile sums of E*w, then of w
  unsigned long long* trace;  // [2, kSlots] or null
  long long mom_bs, st_bs, forc_bs, geo_bs;
  int n_members, n_st, H, W, n_sub, k4_nsub, use_qnet, mean4;
  // the sharded form: the row pitch of mom, forc and geo (padded) and of st
  // (gathered), the owned column 0's column in the padded inputs and in st
  int Wp, Wg, pad, lon0;
  int th, tiles_x, n_tiles, plane;  // tile rows, tiles, shared plane size
  double sub_dt, H_m, r_bot, g, a, dlat, dlon, K_h, adv_alpha, ice_qfac, cap, eta_cap;
};

template <typename T>
__device__ __forceinline__ T n2n(T x) {
  // jnp.nan_to_num: NaN -> 0, +-inf -> +-max
  const T big = sizeof(T) == 4 ? T(3.4028234663852886e38) : T(1.7976931348623157e308);
  if (isnan(x)) return T(0);
  return x > big ? big : (x < -big ? -big : x);
}

// a mod n in [0, n): an add or subtract within one period of [0, n), a
// 64-bit remainder beyond
__device__ __forceinline__ int floor_mod(long long a, int n) {
  if (a >= -n && a < 2 * (long long)n) return (int)(a < 0 ? a + n : (a >= n ? a - n : a));
  const long long r = a % n;
  return (int)(r < 0 ? r + n : r);
}

// the four corners of the bilinear wrap gather at a departure point and
// their weights, in the order of `bilinear_wrap_gather_multi`
template <typename T>
struct Corners {
  int c00, c01, c10, c11;
  T w00, w01, w10, w11;
};

template <typename T>
__device__ __forceinline__ Corners<T> corners(T dep_j, T dep_i, int H, int W) {
  const T j0f = floor(dep_j), i0f = floor(dep_i);
  const T fj = dep_j - j0f, fi = dep_i - i0f;
  const int jj = floor_mod((long long)j0f, H), ii = floor_mod((long long)i0f, W);
  const int j1 = (jj + 1 == H) ? 0 : jj + 1, i1 = (ii + 1 == W) ? 0 : ii + 1;
  return Corners<T>{jj * W + ii, jj * W + i1, j1 * W + ii, j1 * W + i1,
                    (T(1) - fj) * (T(1) - fi), (T(1) - fj) * fi, fj * (T(1) - fi), fj * fi};
}

// (plain loads: with n_sub > 1 the stack gathered from was written earlier
// in the same cooperative launch, which the read-only path does not see)
template <typename T>
__device__ __forceinline__ T gather(const T* f, const Corners<T>& k) {
  return f[k.c00] * k.w00 + f[k.c01] * k.w01 + f[k.c10] * k.w10 + f[k.c11] * k.w11;
}

__device__ __forceinline__ int thread_rank() { return threadIdx.y * blockDim.x + threadIdx.x; }
__device__ __forceinline__ int block_threads() { return blockDim.x * blockDim.y; }

// fixed-order sums of a and b over the block's threads, every thread
// getting both: the values go to shared memory (sh: kRed), the first warp
// adds them, lane l every 32nd from l, and a shuffle tree adds the lanes
template <typename T>
__device__ void block_sum2(T& a, T& b, T* sh) {
  const int tid = thread_rank(), n = block_threads();
  sh[tid] = a;
  sh[1024 + tid] = b;
  __syncthreads();
  if (tid < 32) {
    T x = T(0), y = T(0);
    for (int k = tid; k < n; k += 32) {
      x += sh[k];
      y += sh[1024 + k];
    }
    for (int off = 16; off > 0; off >>= 1) {
      x += __shfl_down_sync(0xffffffffu, x, off);
      y += __shfl_down_sync(0xffffffffu, y, off);
    }
    if (tid == 0) {
      sh[2048] = x;
      sh[2049] = y;
    }
  }
  __syncthreads();
  a = sh[2048];
  b = sh[2049];
  __syncthreads();
}

__device__ __forceinline__ void stamp(unsigned long long* trace, int s) {
  unsigned long long ns;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(ns));
  trace[s] = ns;
  trace[kSlots + s] = clock64();
}

// member b's stacks of substep s: its source and destination, its forcing
// and geometry, its scratch and its partial sums
template <typename T>
struct Sub {
  const T* src;  // mom before the substep
  T* dst;        // mom after it
  const T* cur;  // st before
  T* nxt;        // st after
  const T* forc;
  const T* geo;
  T* uvs;
  T* partials;
};

template <typename T>
__device__ __forceinline__ Sub<T> substep(const Args<T>& A, int s, int b) {
  const long long HW = (long long)A.H * A.W, mo = 3 * HW * b, so = A.n_st * HW * b;
  // the last substep lands in the outputs
  auto dst_m = [&](int q) { return ((A.n_sub - 1 - q) % 2 == 0) ? A.mom_out : A.mom2; };
  auto dst_s = [&](int q) { return ((A.n_sub - 1 - q) % 2 == 0) ? A.st_out : A.st2; };
  return Sub<T>{s == 0 ? A.mom_in + b * A.mom_bs : dst_m(s - 1) + mo,
                dst_m(s) + mo,
                s == 0 ? A.st_in + b * A.st_bs : dst_s(s - 1) + so,
                dst_s(s) + so,
                A.forc + b * A.forc_bs,
                A.geo + b * A.geo_bs,
                A.uvs + 2 * HW * b,
                A.partials + 2LL * A.n_tiles * b};
}

// shared memory of a tile pass: X = (U, V, E), G and L for three planes
// each, the cos plane C, then kRed values for block_sum2
template <typename T>
struct Smem {
  T *X, *G, *L, *C, *red;
};

template <typename T>
__device__ __forceinline__ Smem<T> carve(unsigned char* smem, int plane) {
  T* base = reinterpret_cast<T*>(smem);
  return Smem<T>{base, base + 3 * plane, base + 6 * plane, base + 9 * plane,
                 base + 10 * plane};
}

// The tile pass of substep s for one tile: everything but the eta mean.
// kSh: the sharded form's tile (padded inputs, gathered st, owned outputs).
template <typename T, bool kSh>
__device__ __forceinline__ void tile_pass(const Args<T>& A, const Sub<T>& S, int tile,
                                          const Smem<T>& sm, bool tracing) {
  const int H = A.H, W = A.W, k = A.k4_nsub;
  // row pitches: of mom, forc and geo (Wi), of st (Wg), of the outputs (W)
  // and of uvs (Wu); the whole grid's are all W
  const int Wi = kSh ? A.Wp : W, Wg = kSh ? A.Wg : W, Wu = kSh ? W + 2 : W;
  const int HWi = H * Wi, HWg = H * Wg, HW = H * W, HWu = H * Wu;
  const T* __restrict__ geo = S.geo;
  const T* __restrict__ ax = S.forc;
  const T* __restrict__ ay = S.forc + HWi;
  const T* __restrict__ heat = S.forc + 2 * HWi;
  // written by the substep before, in the same launch: not read-only
  const T* usrc = S.src;
  const T* vsrc = S.src + HWi;
  const T* esrc = S.src + 2 * HWi;
  const T* __restrict__ cos05 = geo + kCos05 * HWi;
  T* X = sm.X;
  T* G = sm.G;
  T* L = sm.L;
  T* C = sm.C;

  // the scalars in T; PyTorch divides by a Python number as a product with
  // its reciprocal (taken in double, rounded to T), so those divisions are
  // products here too
  const qd::Inv<T> inv = qd::inverses<T>(A.dlat, A.dlon, A.a);
  const T a = T(A.a), inv_a = T(1.0 / A.a), inv_dlon = T(1.0 / A.dlon);
  const T inv_two_dlon = T(1.0 / (2.0 * A.dlon)), inv_two_dlat = inv.two_dlat;
  const T g = T(A.g), r_bot = T(A.r_bot), sub_dt = T(A.sub_dt);
  const T k4_dt = T(A.sub_dt / A.k4_nsub), dt_H = T(A.sub_dt * A.H_m);
  const T one_m_alpha = T(1.0 - A.adv_alpha), alpha = T(A.adv_alpha);
  const T dt_Kh = T(A.sub_dt * A.K_h), dt_qfac = T(A.sub_dt * A.ice_qfac);

  // the tile, and the neighbourhood the momentum stage fills
  const int ty = tile / A.tiles_x, tx = tile - ty * A.tiles_x;
  const int j0 = ty * A.th, i0 = tx * kTW;
  const int oh = min(A.th, H - j0), ow = min(kTW, W - i0);
  const int hr = nbhd_rows(k), hc = nbhd_cols(k);
  const int r0 = max(0, j0 - hr), nr = min(H, j0 + oh + hr) - r0, nc = ow + 2 * hc;
  const qd::Tile t{H, r0, nr, nc};
  const qd::Rect own{j0 - r0, j0 - r0 + oh, hc, hc + ow};
  // this thread's column: c among the owned ones; i and its neighbours in
  // the inputs (wrapped on the whole grid, padded on a shard), ig in st
  // (the global column), io in the outputs
  const int c = i0 - hc + (int)threadIdx.x;
  int i, ip, im, ig;
  if (kSh) {
    i = A.pad + c;
    ip = i + 1;
    im = i - 1;
    ig = floor_mod((long long)A.lon0 + c, Wg);
  } else {
    i = floor_mod((long long)c, W);
    ip = (i + 1 == W) ? 0 : i + 1;
    im = (i == 0) ? W - 1 : i - 1;
    ig = i;
  }
  const int io = kSh ? c : i;

  // ---- 1: momentum on the whole neighbourhood; the cos cap into C ----
  qd::for_rect(qd::Rect{0, nr, 0, nc}, [&](int lr, int lc) {
    const int j = r0 + lr, p = j * Wi + i, q = lr * nc + lc;
    const int jp = (j + 1 == H) ? 0 : j + 1, jm = (j == 0) ? H - 1 : j - 1;
    const T cs = cos05[p];
    const T deta_dlam = (esrc[j * Wi + ip] - esrc[j * Wi + im]) * inv_two_dlon;
    const T deta_dphi = (esrc[jp * Wi + i] - esrc[jm * Wi + i]) * inv_two_dlat;
    const T gx = deta_dlam / (a * cs);
    const T gy = deta_dphi * inv_a;
    const T f = geo[kF * HWi + p];
    T uo = usrc[p], vo = vsrc[p];
    const T du = f * vo - g * gx + ax[p] - r_bot * uo;
    const T dv = -f * uo - g * gy + ay[p] - r_bot * vo;
    const bool land = geo[kLand * HWi + p] > T(0.5);
    uo = land ? T(0) : uo + sub_dt * du;
    vo = land ? T(0) : vo + sub_dt * dv;
    const T sponge = sub_dt * geo[kRExtra * HWi + p];
    X[q] = uo - sponge * uo;
    X[A.plane + q] = vo - sponge * vo;
    X[2 * A.plane + q] = esrc[p];
    C[q] = cs;
  });
  __syncthreads();
  if (tracing) stamp(A.trace, 1);

  // ---- 2: del^4 of (U, V, E), k times ----
  for (int n = 0; n < k; ++n) {
    const int left = k - 1 - n;  // del^4 substeps still to come
    qd::tile_del4<3>(X, G, L, A.plane, C, t, qd::grow(own, nbhd_rows(left), nbhd_cols(left), nr),
                     [&](int m, int lr) { return geo[(kK4U + m) * HWi + (r0 + lr) * Wi + i]; },
                     k4_dt, inv);
  }
  if (tracing) stamp(A.trace, 2);

  // ---- 6: departure points; the blended SST on own + nbhd(0) into L[0],
  //      then the tracers on own, each in one group of loads ----
  T* sst_tmp = L;
  const T* cur = S.cur;
  auto departure = [&](int lr, int q) {
    const T uo = X[q], vo = X[A.plane + q];
    const T dep_j = T(r0 + lr) - ((vo * sub_dt) * inv_a) * inv.dlat;
    const T dep_i = T(ig) - ((uo * sub_dt) / (a * C[q])) * inv_dlon;
    return corners(dep_j, dep_i, H, Wg);
  };
  qd::for_rect(qd::grow(own, nbhd_rows(0), nbhd_cols(0), nr), [&](int lr, int lc) {
    const int q = lr * nc + lc;
    const T blend = one_m_alpha * cur[(r0 + lr) * Wg + ig];
    sst_tmp[q] = blend + alpha * gather(cur, departure(lr, q));
  });
  qd::for_rect(own, [&](int lr, int lc) {
    const int q = lr * nc + lc, p = (r0 + lr) * W + io;
    const Corners<T> k = departure(lr, q);
    // every load of a group before its stores
    for (int m0 = 1; m0 < A.n_st; m0 += kGroup) {
      T v[kGroup];
#pragma unroll
      for (int u = 0; u < kGroup; ++u)
        v[u] = m0 + u < A.n_st ? gather(cur + (m0 + u) * HWg, k) : T(0);
#pragma unroll
      for (int u = 0; u < kGroup; ++u)
        if (m0 + u < A.n_st) S.nxt[(m0 + u) * HW + p] = v[u];
    }
  });
  __syncthreads();
  if (tracing) stamp(A.trace, 3);

  // ---- 7a: cos * dSST/dphi for the K_h Laplacian, into G[0] ----
  if (A.K_h > 0.0) {
    qd::for_rect(qd::grow(own, 1, 0, nr), [&](int lr, int lc) {
      const int q = lr * nc + lc;
      G[q] = C[q] * qd::dphi(sst_tmp, q, r0 + lr, t, inv);
    });
    __syncthreads();
  }
  if (tracing) stamp(A.trace, 4);

  // ---- 7: SST, continuity, the scrubbed U, V and the partial sums ----
  T sum_ew = T(0), sum_w = T(0);
  qd::for_rect(own, [&](int lr, int lc) {
    const int j = r0 + lr, p = j * Wi + i, po = j * W + io, q = lr * nc + lc;
    // every read of device memory first, then the arithmetic and the writes
    const bool interior = j > 0 && j < H - 1;
    const T open = geo[kOpen * HWi + p], under = geo[kUnder * HWi + p], hq = heat[p];
    const T cos_n = interior ? geo[kCos * HWi + p + Wi] : T(0);
    const T cos_s = interior ? geo[kCos * HWi + p - Wi] : T(0);
    const T cos_tiny = geo[kCosTiny * HWi + p], land = geo[kLand * HWi + p];
    const T w = geo[kWOcean * HWi + p];

    T sst = sst_tmp[q];
    if (A.K_h > 0.0)
      sst = sst + dt_Kh * qd::lap_at(sst_tmp, G, C[q], q, j, t, inv);
    if (A.use_qnet) {
      if (open > T(0.5)) sst = sst + sub_dt * hq;
      if (A.ice_qfac > 0.0 && under > T(0.5)) sst = sst + dt_qfac * hq;
    }
    S.nxt[po] = n2n(sst);

    const T* U = X;
    const T* V = X + A.plane;
    const T du_dlon = (U[q + 1] - U[q - 1]) * inv_two_dlon;
    T dv_dlat = T(0);
    if (interior) dv_dlat = (V[q + nc] * cos_n - V[q - nc] * cos_s) * inv_two_dlat;
    const T div = (du_dlon + dv_dlat) / (a * cos_tiny);
    T e = X[2 * A.plane + q] - dt_H * div;
    if (land > T(0.5)) e = T(0);
    S.dst[2 * HW + po] = e;
    sum_ew += e * w;
    sum_w += w;
    const int pu = kSh ? j * Wu + io + 1 : po;
    S.uvs[pu] = n2n(U[q]);
    S.uvs[HWu + pu] = n2n(V[q]);
  });
  if (kSh) {
    // the scrubbed U, V one column beyond each edge of the shard, for mean4
    qd::for_rect(qd::grow(own, 0, 1, nr), [&](int lr, int lc) {
      if (c != -1 && c != W) return;
      const int q = lr * nc + lc, pu = (r0 + lr) * Wu + c + 1;
      S.uvs[pu] = n2n(X[q]);
      S.uvs[HWu + pu] = n2n(X[A.plane + q]);
    });
  }
  block_sum2(sum_ew, sum_w, sm.red);
  if (threadIdx.x == 0 && threadIdx.y == 0) {
    S.partials[tile] = sum_ew;
    S.partials[A.n_tiles + tile] = sum_w;
  }
  if (tracing) stamp(A.trace, 5);
}

// the eta mean from the per-tile partial sums, in one fixed order
template <typename T>
__device__ __forceinline__ T eta_mean(const Args<T>& A, const Sub<T>& S, T* red) {
  T ew = T(0), w = T(0);
  for (int b = thread_rank(); b < A.n_tiles; b += block_threads()) {
    ew += S.partials[b];
    w += S.partials[A.n_tiles + b];
  }
  block_sum2(ew, w, red);
  return ew / (w + T(1e-15));
}

// the finish of one cell: eta mean removal, scrub and clamp; mean4 and the
// speed cap from the scrubbed U, V (cap / x as PyTorch takes it: 1/x, times
// cap). kSh: uvs has one more column on each side of the rank's (pitch W + 2)
template <typename T, bool kSh>
__device__ __forceinline__ void finish_cell(const Args<T>& A, const Sub<T>& S, int p, T mean) {
  const int H = A.H, W = A.W, HW = H * W, Wu = kSh ? W + 2 : W;
  const T cap = T(A.cap), eta_cap = T(A.eta_cap);
  const T* U = S.uvs;
  const T* V = S.uvs + H * Wu;
  const T e = n2n(S.dst[2 * HW + p] - mean);
  S.dst[2 * HW + p] = e < -eta_cap ? -eta_cap : (e > eta_cap ? eta_cap : e);

  const int pu = kSh ? p + 2 * (p / W) + 1 : p;
  T uo = U[pu], vo = V[pu];
  const T speed = sqrt(uo * uo + vo * vo);
  T scl;
  if (A.mean4) {
    if (speed > cap) {
      const int j = p / W, i = p - j * W;
      const int jp = (j + 1 == H) ? 0 : j + 1, jm = (j == 0) ? H - 1 : j - 1;
      int ic = i, ip, im;
      if (kSh) {
        ic = i + 1;
        ip = ic + 1;
        im = ic - 1;
      } else {
        ip = (i + 1 == W) ? 0 : i + 1;
        im = (i == 0) ? W - 1 : i - 1;
      }
      uo = T(0.25) * (U[jp * Wu + ic] + U[jm * Wu + ic] + U[j * Wu + ip] + U[j * Wu + im]);
      vo = T(0.25) * (V[jp * Wu + ic] + V[jm * Wu + ic] + V[j * Wu + ip] + V[j * Wu + im]);
    }
    const T speed2 = sqrt(uo * uo + vo * vo);
    scl = speed2 > cap ? (T(1) / (speed2 + T(1e-12))) * cap : T(1);
  } else {
    scl = speed > cap ? (T(1) / (speed + T(1e-12))) * cap : T(1);
  }
  S.dst[p] = uo * scl;
  S.dst[HW + p] = vo * scl;
}

// the tile whose block stamps a traced launch: the middle one, whose
// neighbourhood is whole on the main path's grid
template <typename T>
__device__ __forceinline__ int traced_tile(const Args<T>& A) {
  return A.n_tiles / 2;
}

// every substep in one cooperative launch, one grid barrier for the eta
// mean and one between substeps; member 0 of a batched launch is traced.
// kMembers false: one member, whose operands the compiler addresses from
// the kernel's parameters as the single form always did (a member index
// held in registers would cost the tile pass registers it spills)
template <typename T, bool kMembers>
__global__ void __launch_bounds__(kMaxBlock) ocean_coop_kernel(Args<T> A) {
  extern __shared__ __align__(16) unsigned char smem[];
  cg::grid_group grid = cg::this_grid();
  const Smem<T> sm = carve<T>(smem, A.plane);
  const int HW = A.H * A.W, nt = block_threads();
  const int n_members = kMembers ? A.n_members : 1;
  const int items = n_members * A.n_tiles;
  const bool tracer = A.trace != nullptr && thread_rank() == 0;
  for (int s = 0; s < A.n_sub; ++s) {
    for (int item = blockIdx.x; item < items; item += gridDim.x) {
      const int b = kMembers ? item / A.n_tiles : 0, tile = item - b * A.n_tiles;
      const bool tracing = tracer && item == traced_tile(A);
      if (tracing) stamp(A.trace, 0);
      tile_pass<T, false>(A, substep(A, s, b), tile, sm, tracing);
      __syncthreads();
    }
    grid.sync();
    // the traced tile's block stamps the dependency and the finish
    const bool tracing = tracer && (int)blockIdx.x == traced_tile(A) % (int)gridDim.x;
    if (tracing) stamp(A.trace, 6);
    for (int b = 0; b < n_members; ++b) {
      const Sub<T> S = substep(A, s, b);
      const T mean = eta_mean(A, S, sm.red);
      for (int p = blockIdx.x * nt + thread_rank(); p < HW; p += gridDim.x * nt)
        finish_cell<T, false>(A, S, p, mean);
    }
    if (A.trace != nullptr) {
      __syncthreads();
      if (tracing) stamp(A.trace, 7);
    }
    if (s + 1 < A.n_sub) grid.sync();
  }
}

// the sharded form's launch A: the tile pass of one substep on the rank's
// tiles, one tile a block, with their partial sums
template <typename T>
__global__ void __launch_bounds__(kMaxBlock) ocean_tiles_sharded_kernel(Args<T> A) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Smem<T> sm = carve<T>(smem, A.plane);
  for (int tile = blockIdx.x; tile < A.n_tiles; tile += gridDim.x) {
    tile_pass<T, true>(A, substep(A, 0, 0), tile, sm, false);
    __syncthreads();
  }
}

// the sharded form's launch B: the finish of the rank's cells with the eta
// mean from the sums over every rank, sums = [sum of E*w, sum of w] in
// float64, each rounded to T as the whole grid's sums are in T
template <typename T>
__global__ void ocean_finish_sharded_kernel(Args<T> A, const double* __restrict__ sums) {
  const T ew = T(sums[0]), w = T(sums[1]);
  const T mean = ew / (w + T(1e-15));
  const Sub<T> S = substep(A, 0, 0);
  const int HW = A.H * A.W;
  for (int p = blockIdx.x * blockDim.x + threadIdx.x; p < HW; p += gridDim.x * blockDim.x)
    finish_cell<T, true>(A, S, p, mean);
}

// per-device properties, read once
struct DeviceProps {
  bool known;
  int sms, coop, smem_optin;
};
DeviceProps g_props[kMaxDevices];
// [float, double] x [one member, members][device]
size_t g_smem_set[4][kMaxDevices];     // opt-in bytes set
int g_per_sm[4][kMaxDevices];          // co-resident blocks ...
size_t g_per_sm_smem[4][kMaxDevices];  // ... at this many bytes of shared memory

// the current device and its properties
cudaError_t device_props(int* dev, DeviceProps** out) {
  cudaError_t e = cudaGetDevice(dev);
  if (e != cudaSuccess) return e;
  if (*dev >= kMaxDevices) return cudaErrorInvalidDevice;
  DeviceProps& P = g_props[*dev];
  if (!P.known) {
    e = cudaDeviceGetAttribute(&P.sms, cudaDevAttrMultiProcessorCount, *dev);
    if (e == cudaSuccess) e = cudaDeviceGetAttribute(&P.coop, cudaDevAttrCooperativeLaunch, *dev);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&P.smem_optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, *dev);
    if (e != cudaSuccess) return e;
    P.known = true;
  }
  *out = &P;
  return cudaSuccess;
}

template <typename T>
size_t smem_bytes(int th, int k, int* plane) {
  *plane = (th + 2 * nbhd_rows(k)) * (kTW + 2 * nbhd_cols(k));
  return (10 * (size_t)*plane + kRed) * sizeof(T);
}

// A launch's shape. Tiles of kTW columns and as many rows as let every tile
// of the grid run at once, one block on each SM (17 at 181 x 360: 11 x 12 =
// 132 tiles), 8 to 24 rows; 16 where the grid needs more tiles than SMs
// anyway. A shape whose shared memory does not fit halves its rows. Rows of
// threads: the tile's rows (one owned row each) or half the neighbourhood's,
// whichever is more, so a thread takes two rows a stage.
struct Plan {
  int th, tiles_x, n_tiles, plane;
  size_t bytes;
  dim3 block;
};

template <typename T>
cudaError_t plan(int H, int W, int k, const DeviceProps& P, Plan* out) {
  Plan L;
  L.tiles_x = (W + kTW - 1) / kTW;
  const int rows = max(1, P.sms / L.tiles_x);
  L.th = min(24, max(8, (H + rows - 1) / rows));
  if (((H + L.th - 1) / L.th) * L.tiles_x > P.sms) L.th = 16;
  L.bytes = smem_bytes<T>(L.th, k, &L.plane);
  while (L.bytes > (size_t)P.smem_optin && L.th > 1) {
    L.th /= 2;
    L.bytes = smem_bytes<T>(L.th, k, &L.plane);
  }
  const int bx = kTW + 2 * nbhd_cols(k);
  if (L.bytes > (size_t)P.smem_optin || bx > kMaxBlock) return cudaErrorInvalidValue;
  L.n_tiles = ((H + L.th - 1) / L.th) * L.tiles_x;
  L.block = dim3(bx, min(kMaxBlock / bx, max(L.th, (L.th + 2 * nbhd_rows(k) + 1) / 2)));
  *out = L;
  return cudaSuccess;
}

template <typename T>
int tiles(int H, int W, int k4_nsub, int* n_tiles) {
  int dev = 0;
  DeviceProps* P = nullptr;
  cudaError_t e = device_props(&dev, &P);
  Plan L;
  if (e == cudaSuccess) e = plan<T>(H, W, k4_nsub, *P, &L);
  if (e != cudaSuccess) return (int)e;
  *n_tiles = L.n_tiles;
  return 0;
}

template <typename T>
int launch(Args<T> A, int partial_cap, void* stream) {
  const bool members = A.n_members > 1;
  const int ti = (sizeof(T) == 4 ? 0 : 2) + (members ? 1 : 0);
  int dev = 0;
  DeviceProps* P = nullptr;
  cudaError_t e = device_props(&dev, &P);
  if (e != cudaSuccess) return (int)e;
  if (!P->coop) return (int)cudaErrorNotSupported;
  Plan L;
  e = plan<T>(A.H, A.W, A.k4_nsub, *P, &L);
  if (e != cudaSuccess) return (int)e;
  if (L.n_tiles > partial_cap) return (int)cudaErrorInvalidValue;
  A.th = L.th;
  A.tiles_x = L.tiles_x;
  A.n_tiles = L.n_tiles;
  A.plane = L.plane;
  const void* fn = members ? (const void*)ocean_coop_kernel<T, true>
                           : (const void*)ocean_coop_kernel<T, false>;
  if (L.bytes > 48 * 1024 && g_smem_set[ti][dev] < L.bytes) {
    e = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)L.bytes);
    if (e != cudaSuccess) return (int)e;
    g_smem_set[ti][dev] = L.bytes;
  }
  if (g_per_sm_smem[ti][dev] != L.bytes) {
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&g_per_sm[ti][dev], fn,
                                                      (int)(L.block.x * L.block.y), L.bytes);
    if (e != cudaSuccess) return (int)e;
    g_per_sm_smem[ti][dev] = L.bytes;
  }
  const int per_sm = g_per_sm[ti][dev];
  if (per_sm < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
  const long long items = (long long)A.n_members * L.n_tiles;
  if (items >= (1LL << 31)) return (int)cudaErrorInvalidValue;
  const int blocks = (int)min(items, (long long)per_sm * P->sms);
  void* params[] = {&A};
  e = cudaLaunchCooperativeKernel(fn, dim3(blocks), L.block, params, L.bytes,
                                  (cudaStream_t)stream);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

template <typename T>
int run(const void* mom_in, const void* st_in, const void* forc, const void* geo, void* mom_out,
        void* st_out, void* mom2, void* st2, void* uvs, void* partials, int partial_cap,
        int n_members, long long mom_bs, long long st_bs, long long forc_bs, long long geo_bs,
        int n_st, int H, int W, int n_sub, int k4_nsub, double sub_dt, double H_m,
        double r_bot, double g, double a, double dlat, double dlon, double K_h,
        double adv_alpha, int use_qnet, double ice_qfac, double cap, int mean4, double eta_cap,
        void* trace, void* stream) {
  if (n_sub > 1 && (mom2 == nullptr || st2 == nullptr)) return (int)cudaErrorInvalidValue;
  if (n_members < 1) return (int)cudaErrorInvalidValue;
  Args<T> A{(const T*)mom_in, (const T*)st_in, (const T*)forc, (const T*)geo, (T*)mom_out,
            (T*)st_out, (T*)mom2, (T*)st2, (T*)uvs, (T*)partials,
            (unsigned long long*)trace, mom_bs, st_bs, forc_bs, geo_bs,
            n_members, n_st, H, W, n_sub, k4_nsub, use_qnet, mean4, W, W, 0, 0,
            0, 0, 0, 0,
            sub_dt, H_m, r_bot, g, a, dlat, dlon, K_h, adv_alpha, ice_qfac, cap, eta_cap};
  return launch<T>(A, partial_cap, stream);
}

// [float, double][device]: the sharded tile kernel's opt-in shared memory set
size_t g_smem_set_sh[2][kMaxDevices];

template <typename T>
int launch_tiles_sharded(Args<T> A, int partial_cap, void* stream) {
  int dev = 0;
  DeviceProps* P = nullptr;
  cudaError_t e = device_props(&dev, &P);
  if (e != cudaSuccess) return (int)e;
  Plan L;
  e = plan<T>(A.H, A.W, A.k4_nsub, *P, &L);
  if (e != cudaSuccess) return (int)e;
  if (L.n_tiles > partial_cap) return (int)cudaErrorInvalidValue;
  A.th = L.th;
  A.tiles_x = L.tiles_x;
  A.n_tiles = L.n_tiles;
  A.plane = L.plane;
  const void* fn = (const void*)ocean_tiles_sharded_kernel<T>;
  const int ti = sizeof(T) == 4 ? 0 : 1;
  if (L.bytes > 48 * 1024 && g_smem_set_sh[ti][dev] < L.bytes) {
    e = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)L.bytes);
    if (e != cudaSuccess) return (int)e;
    g_smem_set_sh[ti][dev] = L.bytes;
  }
  ocean_tiles_sharded_kernel<T><<<L.n_tiles, L.block, L.bytes, (cudaStream_t)stream>>>(A);
  return (int)cudaGetLastError();
}

template <typename T>
int tiles_sharded(const void* mom_p, const void* st_g, const void* forc_p, const void* geo_p,
                  void* mom_out, void* st_out, void* uvs, void* partials, int partial_cap,
                  int n_st, int H, int W, int Wp, int Wg, int pad, int lon0, int k4_nsub,
                  double sub_dt, double H_m, double r_bot, double g, double a, double dlat,
                  double dlon, double K_h, double adv_alpha, int use_qnet, double ice_qfac,
                  void* stream) {
  if (pad < nbhd_cols(k4_nsub) + 1 || Wp != W + 2 * pad || lon0 < 0 || lon0 + W > Wg)
    return (int)cudaErrorInvalidValue;
  Args<T> A{(const T*)mom_p, (const T*)st_g, (const T*)forc_p, (const T*)geo_p, (T*)mom_out,
            (T*)st_out, nullptr, nullptr, (T*)uvs, (T*)partials, nullptr, 0, 0, 0, 0,
            1, n_st, H, W, 1, k4_nsub, use_qnet, 0, Wp, Wg, pad, lon0,
            0, 0, 0, 0,
            sub_dt, H_m, r_bot, g, a, dlat, dlon, K_h, adv_alpha, ice_qfac, 0.0, 0.0};
  return launch_tiles_sharded<T>(A, partial_cap, stream);
}

template <typename T>
int finish_sharded(void* mom_out, void* uvs, const void* sums, int H, int W, double cap,
                   int mean4, double eta_cap, void* stream) {
  Args<T> A{nullptr, nullptr, nullptr, nullptr, (T*)mom_out, nullptr, nullptr, nullptr,
            (T*)uvs, nullptr, nullptr, 0, 0, 0, 0,
            1, 1, H, W, 1, 1, 0, mean4, W, W, 0, 0,
            0, 0, 0, 0,
            0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, cap, eta_cap};
  const int threads = 256, blocks = (H * W + threads - 1) / threads;
  ocean_finish_sharded_kernel<T><<<blocks, threads, 0, (cudaStream_t)stream>>>(
      A, (const double*)sums);
  return (int)cudaGetLastError();
}

}  // namespace

// the sharded form's two launches of one substep (see the header comment):
// mom_p, forc_p [3, H, Wp] and geo_p [12, H, Wp] padded by `pad` columns
// (Wp = W + 2 pad), st_g [n_st, H, Wg] whole; mom_out [3, H, W], st_out
// [n_st, H, W], uvs [2, H, W + 2], partials [2 * n_tiles], n_tiles <=
// partial_cap (qd_ocean_substeps_tiles of H, W), sums [2] float64
#define QD_OCEAN_SHARDED_LAUNCHERS(SUFFIX, T)                                                   \
  extern "C" int qd_ocean_tiles_sharded##SUFFIX(                                               \
      const void* mom_p, const void* st_g, const void* forc_p, const void* geo_p,              \
      void* mom_out, void* st_out, void* uvs, void* partials, int partial_cap, int n_st,       \
      int H, int W, int Wp, int Wg, int pad, int lon0, int k4_nsub, double sub_dt, double H_m, \
      double r_bot, double g, double a, double dlat, double dlon, double K_h,                  \
      double adv_alpha, int use_qnet, double ice_qfac, void* stream) {                         \
    return tiles_sharded<T>(mom_p, st_g, forc_p, geo_p, mom_out, st_out, uvs, partials,        \
                            partial_cap, n_st, H, W, Wp, Wg, pad, lon0, k4_nsub, sub_dt, H_m,  \
                            r_bot, g, a, dlat, dlon, K_h, adv_alpha, use_qnet, ice_qfac,       \
                            stream);                                                           \
  }                                                                                            \
  extern "C" int qd_ocean_finish_sharded##SUFFIX(void* mom_out, void* uvs, const void* sums,   \
                                                 int H, int W, double cap, int mean4,          \
                                                 double eta_cap, void* stream) {               \
    return finish_sharded<T>(mom_out, uvs, sums, H, W, cap, mean4, eta_cap, stream);           \
  }

QD_OCEAN_SHARDED_LAUNCHERS(_f32, float)
QD_OCEAN_SHARDED_LAUNCHERS(_f64, double)

extern "C" int qd_ocean_substeps_halo(int k4_nsub, int* rows, int* cols) {
  *rows = nbhd_rows(k4_nsub) + 1;
  *cols = nbhd_cols(k4_nsub) + 1;
  return 0;
}

extern "C" int qd_ocean_substeps_tiles_f32(int H, int W, int k4_nsub, int* n_tiles) {
  return tiles<float>(H, W, k4_nsub, n_tiles);
}

extern "C" int qd_ocean_substeps_tiles_f64(int H, int W, int k4_nsub, int* n_tiles) {
  return tiles<double>(H, W, k4_nsub, n_tiles);
}

// n_members members: member b's inputs at mom_in + b * mom_bs, st_in + b *
// st_bs, forc + b * forc_bs and geo + b * geo_bs; the outputs, mom2, st2 and
// uvs hold [n_members, ...] and partials [n_members, 2 * n_tiles], n_tiles <= partial_cap
#define QD_OCEAN_LAUNCHER(NAME, T)                                                          \
  extern "C" int NAME(const void* mom_in, const void* st_in, const void* forc,             \
                      const void* geo, void* mom_out, void* st_out, void* mom2, void* st2, \
                      void* uvs, void* partials, int partial_cap, int n_members,           \
                      long long mom_bs, long long st_bs, long long forc_bs,                \
                      long long geo_bs, int n_st, int H, int W, int n_sub, int k4_nsub,    \
                      double sub_dt, double H_m, double r_bot, double g, double a,         \
                      double dlat, double dlon, double K_h, double adv_alpha,              \
                      int use_qnet, double ice_qfac, double cap, int mean4,                \
                      double eta_cap, void* trace, void* stream) {                         \
    return run<T>(mom_in, st_in, forc, geo, mom_out, st_out, mom2, st2, uvs, partials,     \
                  partial_cap, n_members, mom_bs, st_bs, forc_bs, geo_bs, n_st, H, W,      \
                  n_sub, k4_nsub, sub_dt, H_m, r_bot, g, a, dlat, dlon, K_h, adv_alpha,    \
                  use_qnet, ice_qfac, cap, mean4, eta_cap, trace, stream);                  \
  }

QD_OCEAN_LAUNCHER(qd_ocean_substeps_f32, float)
QD_OCEAN_LAUNCHER(qd_ocean_substeps_f64, double)
