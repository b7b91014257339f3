// K5: the chlorophyll transport after the gather, for every plane (member b,
// species s) of a stack [B, S, H, W]:
//   X   = (1 - alpha) * C_phyto + alpha * C_adv
//   X   = nan_to_num(X);  X = X + (dt * K_h) * lap(X)        (only if K_h > 0)
//   C   = ocean ? clamp(X, min = 0) : 0
// then the polar ring means of rows 0 and H-1: the ocean cells of the
// updated row summed in `sum_fixed`'s pairwise order (halves added, an odd
// last entry carried up), divided by max(n, 1), written where ocean and
// n > 0. The plain version is `phyto_transport_plain`
// (qingdai_tpu_torch/ecology/phyto.py), whose op chain this repeats.
//
// Replaces no TPU kernel: the JAX package leaves this chain
// (`phyto_apply_transport`, qingdai_tpu/ecology/phyto.py) to XLA's fusion
// under jit. The port ran it eagerly, some 75 launches and 61 passes over the
// stack a step; this kernel is its fusion for the card.
//
// What bounds it on the H100: device-memory bytes. The work needs C_phyto and
// C_adv read once and C written once, 12 B a cell in float; the cos map and
// the ocean mask are shared by every member and stay in L2.
//
// Design. A block owns whole rows of one plane: thread t takes V consecutive
// columns (16-byte accesses where W is a multiple of 4 and the pointers are
// aligned), so the longitude wrap and the ring sums stay inside the block.
// The block walks down a run of rows [j0, j1). X and G = cos * dX/dphi of
// the last three rows sit in 3-row rings in shared memory: dX/dphi and G's
// own derivative are vertical, in the thread's own columns, and only X's
// east and west neighbours cross threads (one barrier a row). Keeping them
// out of registers holds the kernel to 64 registers, two blocks of 360
// threads an SM at 1440 columns: with one, it read 49% of the HBM bound,
// with two 70%. On the 16-byte path the rows of C_phyto, C_adv, the cos map
// and the mask stream in through cp.async, three rows ahead of their use
// (two in double) in a ring of stages in shared memory, so that no load
// waits inside a row's step (with the cos map's and the mask's rows loaded
// where used, each step waited on two L2 round trips). A run reads rows
// j0-2 .. j1+1 (4 rows of halo, from L2 when the neighbouring run of the
// plane is resident); the launcher cuts a plane into runs only as far as it
// takes to give the card 32 blocks an SM. A block that owns row 0 or H-1
// reduces it in shared memory after its walk, in the fixed tree order, and
// writes it again: no second pass over the stack.
//
// Rounding: the plain version's op order on the card, with --fmad=false.
// Python numbers become T where PyTorch makes them T: 1 - alpha, alpha and
// dt * K_h are formed in double and rounded; a division by a Python number is
// a product with its reciprocal taken in double and rounded to T (stencil.cuh's
// `Inv`); the divisions by the cos map, by cos^2 and by the ocean count are
// true divisions. nan_to_num and clamp are PyTorch's: NaN -> 0 and +-inf to
// the largest finite value; clamp passes NaN through. So every cell, the ring
// means included, equals the plain version's bits.
//
// The batched form: grid runs over B x S planes, plane (b, s) reading C_phyto,
// C_adv, the mask and the cos map at member b's multiple of their member
// strides (0: one tensor shared by every member, read without a copy).

#include <cuda_runtime.h>

#include <cfloat>

#include "stencil.cuh"

namespace {

constexpr int kMaxThreads = 512;
// rows staged in shared memory on the 16-byte path (kStages - 1 in flight):
// 4 in float, 3 in double; where they do not fit beside the rings (double
// beyond ~1880 columns) the walk loads each row where it uses it
template <typename T>
constexpr int kStages = sizeof(T) == 4 ? 4 : 3;
constexpr int kMinRows = 16;        // the shortest run of rows a block walks
constexpr int kBlocksPerSM = 32;    // blocks short enough that the last wave is brief

template <typename T>
__device__ __forceinline__ T largest();
template <>
__device__ __forceinline__ float largest<float>() { return FLT_MAX; }
template <>
__device__ __forceinline__ double largest<double>() { return DBL_MAX; }

// torch.nan_to_num with its defaults
template <typename T>
__device__ __forceinline__ T nan_to_num(T v) {
  const T big = largest<T>();
  return isnan(v) ? T(0) : (isinf(v) ? (v > T(0) ? big : -big) : v);
}

// torch.clamp(v, min=0): NaN passes through
template <typename T>
__device__ __forceinline__ T clamp_min0(T v) {
  return isnan(v) ? v : ::max(v, T(0));
}

// n / d, IEEE-rounded. A zero n over a positive finite d is n itself; the
// branch keeps such cells (the land's, a quarter of the planet) off the
// division's slow path, which a zero dividend takes: without it the kernel
// took 2.12 ms on an H100 for a step of 400 members of the flagship planet,
// 1.45 ms on random stacks of the same size
template <typename T>
__device__ __forceinline__ T divide(T n, T d) {
  if (n == T(0) && d > T(0) && isfinite(d)) return n;
  return n / d;
}

// V consecutive values, loaded and stored as one access when aligned
template <typename T, int V>
struct alignas(sizeof(T) * V < 16 ? sizeof(T) * V : 16) Pack {
  T a[V];
};

// the thread's V columns from i of row `p`: one vector access (kVec), else
// one access a column inside the row, 0 beyond it
template <typename T, int V, bool kVec>
__device__ __forceinline__ Pack<T, V> load(const T* __restrict__ p, int i, int W) {
  if constexpr (kVec) {
    return *reinterpret_cast<const Pack<T, V>*>(p + i);
  } else {
    Pack<T, V> r;
#pragma unroll
    for (int k = 0; k < V; ++k) r.a[k] = i + k < W ? p[i + k] : T(0);
    return r;
  }
}

template <typename T, int V, bool kVec>
__device__ __forceinline__ void store(T* __restrict__ p, int i, int W, const Pack<T, V>& v) {
  if constexpr (kVec) {
    *reinterpret_cast<Pack<T, V>*>(p + i) = v;
  } else {
#pragma unroll
    for (int k = 0; k < V; ++k)
      if (i + k < W) p[i + k] = v.a[k];
  }
}

// the mask bytes of the thread's V (<= 4) columns from i, byte k of the
// result for column i+k (0 beyond the row)
template <int V, bool kVec>
__device__ __forceinline__ unsigned load_mask(const unsigned char* p, int i, int W) {
  if constexpr (kVec) {
    static_assert(V == 4, "the 16-byte path takes 4 columns a thread");
    return *reinterpret_cast<const unsigned*>(p + i);
  } else {
    unsigned m = 0;
#pragma unroll
    for (int k = 0; k < V; ++k)
      if (i + k < W) m |= (unsigned)p[i + k] << (8 * k);
    return m;
  }
}

// cp.async: a copy from global to shared memory that the thread waits for
// later (16 bytes through L2 only, or 4 bytes)
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem) : "memory");
}

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(gmem) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// the thread's V columns from i of a row, global to shared, without waiting
// (the 16-byte path)
template <typename T, int V>
__device__ __forceinline__ void copy_async(T* dst, const T* src, int i) {
  constexpr int kPer = 16 / (int)sizeof(T);
#pragma unroll
  for (int c = 0; c < V; c += kPer) cp_async16(dst + i + c, src + i + c);
}

// in float, at most 64 registers a thread: two blocks an SM (the design note)
template <typename T, int V, bool kVec, bool kDiffuse>
__global__ void __launch_bounds__(kMaxThreads, sizeof(T) == 4 ? 2 : 1)
phyto_transport_kernel(const T* __restrict__ Cp, const T* __restrict__ Ca,
                       const unsigned char* __restrict__ ocean, const T* __restrict__ cosm,
                       T* __restrict__ out, int S, int H, int W, int n_chunks, int run_rows,
                       long long cp_bs, long long ca_bs, long long oc_bs, long long c_bs,
                       T w_old, T w_adv, T kdt, qd::Inv<T> inv) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sX = reinterpret_cast<T*>(smem_raw);  // the walk's rings; after it, the ring sums
  __shared__ int s_count;

  const long long plane = blockIdx.x / n_chunks;
  const int chunk = (int)(blockIdx.x - plane * n_chunks);
  const int b = (int)(plane / S), s = (int)(plane - (long long)b * S);
  const long long HW = (long long)H * W;
  Cp += b * cp_bs + s * HW;
  Ca += b * ca_bs + s * HW;
  ocean += b * oc_bs;
  cosm += b * c_bs;
  out += plane * HW;
  const int j0 = chunk * run_rows, j1 = min(H, j0 + run_rows);
  const int i0 = (int)threadIdx.x * V;

  using P = Pack<T, V>;
  // X of row j: the blend, and nan_to_num where the stencil follows
  auto blend = [&](const P& p, const P& a) {
    P x;
#pragma unroll
    for (int k = 0; k < V; ++k) {
      const T v = w_old * p.a[k] + w_adv * a.a[k];
      x.a[k] = kDiffuse ? nan_to_num(v) : v;
    }
    return x;
  };
  auto load_x = [&](int j) {
    return blend(load<T, V, kVec>(Cp + j * W, i0, W),
                 load<T, V, kVec>(Ca + j * W, i0, W));
  };
  auto load_c = [&](int j) { return load<T, V, kVec>(cosm + j * W, i0, W); };
  auto load_m = [&](int j) { return load_mask<V, kVec>(ocean + j * W, i0, W); };
  // the updated cells of row j: where(ocean, clamp(y, min=0), 0)
  auto finish = [&](int j, const P& y, unsigned m) {
    P o;
#pragma unroll
    for (int k = 0; k < V; ++k) o.a[k] = (m >> (8 * k)) & 0xff ? clamp_min0(y.a[k]) : T(0);
    store<T, V, kVec>(out + j * W, i0, W, o);
  };

  if constexpr (!kDiffuse) {
    for (int j = j0; j < j1; ++j) finish(j, load_x(j), load_m(j));
  } else {
    // G at row k from X at rows k-1, k, k+1 (np.gradient's one-sided edges)
    // and the cos map's row k
    auto g_row = [&](int k, const P& xm, const P& x0, const P& xp, const P& c) {
      P g;
#pragma unroll
      for (int q = 0; q < V; ++q) {
        const T d = k == 0       ? (xp.a[q] - x0.a[q]) * inv.dlat
                    : k == H - 1 ? (x0.a[q] - xm.a[q]) * inv.dlat
                                 : (xp.a[q] - xm.a[q]) * inv.two_dlat;
        g.a[q] = c.a[q] * d;
      }
      return g;
    };
    // rows of X (read across threads: the east and west neighbours) and of
    // G (each thread its own columns) in 3-row rings in shared memory
    T* ring_x = sX;
    T* ring_g = sX + 3 * W;
    auto put = [&](T* ring, int j, const P& x) {
      T* r = ring + (j % 3) * W;
      if constexpr (kVec) {
        store<T, V, true>(r, i0, W, x);
      } else {
#pragma unroll
        for (int k = 0; k < V; ++k)
          if (i0 + k < W) r[i0 + k] = x.a[k];
      }
    };
    auto own = [&](const T* ring, int j) { return load<T, V, kVec>(ring + (j % 3) * W, i0, W); };
    // Rows in flight (the 16-byte path): row r of C_phyto, C_adv, the cos
    // map and the mask in stage r % kStages, each thread copying and later
    // reading only its own columns; the other paths load a row when used.
    constexpr int D = kStages<T>;
    T* st_p = sX + 6 * W;
    T* st_a = st_p + D * W;
    T* st_c = st_a + D * W;
    unsigned char* st_m = reinterpret_cast<unsigned char*>(st_c + D * W);
    const int last = min(j1 + 1, H - 1);  // the last row this run reads
    auto fetch = [&](int r) {
      if constexpr (kVec) {
        if (r <= last) {
          const int o = (r % D) * W;
          const int g = r * W;
          copy_async<T, V>(st_p + o, Cp + g, i0);
          copy_async<T, V>(st_a + o, Ca + g, i0);
          copy_async<T, V>(st_c + o, cosm + g, i0);
          cp_async4(st_m + o + i0, ocean + g + i0);
        }
        cp_async_commit();
      }
    };
    struct Row {
      P x, c;
      unsigned m;
    };
    auto row_at = [&](int r) {
      if constexpr (kVec) {
        const int o = (r % D) * W;
        return Row{blend(load<T, V, true>(st_p + o, i0, W), load<T, V, true>(st_a + o, i0, W)),
                   load<T, V, true>(st_c + o, i0, W), load_mask<V, true>(st_m + o, i0, W)};
      } else {
        return Row{load_x(r), load_c(r), load_m(r)};
      }
    };

    // rows j0+2 .. j0+D on their way while the first rows load
    for (int q = 0; q < D - 1; ++q) fetch(j0 + 2 + q);
    // rows j0-1, j0, j0+1: X, G at j0-1 and j0, the cos map's rows j0 and
    // j0+1 and the mask's (rows beyond the grid unused)
    {
      P xa{}, xc{};
      const P xb = load_x(j0);
      if (j0 + 1 < H) xc = load_x(j0 + 1);
      if (j0 >= 1) {
        xa = load_x(j0 - 1);
        const P xz = j0 >= 2 ? load_x(j0 - 2) : P{};
        put(ring_g, j0 - 1, g_row(j0 - 1, xz, xa, xb, load_c(j0 - 1)));
      }
      put(ring_g, j0, g_row(j0, xa, xb, xc, load_c(j0)));
      put(ring_x, j0, xb);
      if (j0 + 1 < H) put(ring_x, j0 + 1, xc);
    }
    P cb = load_c(j0), cc{};
    unsigned mb = load_m(j0), mc = 0;
    if (j0 + 1 < H) {
      cc = load_c(j0 + 1);
      mc = load_m(j0 + 1);
    }

    for (int j = j0; j < j1; ++j) {
      if constexpr (kVec) cp_async_wait<D - 2>();  // row j+2's copies have landed
      Row nd{};
      if (j + 2 < H) nd = row_at(j + 2);
      // the ring slot of row j+2 last held row j-1, and the stage of row
      // j+D+1 row j+1, both read in the last iteration
      __syncthreads();
      fetch(j + D + 1);
      if (j + 2 < H) put(ring_x, j + 2, nd.x);
      const P xb = own(ring_x, j);
      // G at row j+1, its rows picked by index (one-sided at row H-1), so
      // that no cell selects among the three formulas
      if (j + 1 < H) {
        const bool edge = j + 1 == H - 1;
        const P xp = own(ring_x, edge ? j + 1 : j + 2);
        const T s = edge ? inv.dlat : inv.two_dlat;
        P gc;
#pragma unroll
        for (int k = 0; k < V; ++k) gc.a[k] = cc.a[k] * ((xp.a[k] - xb.a[k]) * s);
        put(ring_g, j + 1, gc);
      }
      // dG/dphi at row j from G at rows hi and lo
      const bool top = j == 0, bottom = j == H - 1;
      const P g_hi = own(ring_g, bottom ? j : j + 1), g_lo = own(ring_g, top ? j : j - 1);
      const T s_g = top || bottom ? inv.dlat : inv.two_dlat;
      const T* r = ring_x + (j % 3) * W;
      P y;
#pragma unroll
      for (int k = 0; k < V; ++k) {
        const int i = i0 + k;
        T east, west;
        if constexpr (kVec) {  // every column of the thread lies inside the row
          east = k + 1 < V ? xb.a[k + 1] : (i + 1 < W ? r[i + 1] : r[0]);
          west = k > 0 ? xb.a[k - 1] : (i > 0 ? r[i - 1] : r[W - 1]);
        } else {
          if (i >= W) {  // the ragged last thread of a row
            y.a[k] = T(0);
            continue;
          }
          east = i + 1 < W ? (k + 1 < V ? xb.a[k + 1] : r[i + 1]) : r[0];
          west = i > 0 ? (k > 0 ? xb.a[k - 1] : r[i - 1]) : r[W - 1];
        }
        const T dg = (g_hi.a[k] - g_lo.a[k]) * s_g;
        const T term_phi = divide(dg, cb.a[k]);
        const T d2 = (east - T(2) * xb.a[k] + west) * inv.dlon2;
        const T lap = (term_phi + divide(d2, cb.a[k] * cb.a[k])) * inv.a2;
        y.a[k] = xb.a[k] + kdt * lap;
      }
      finish(j, y, mb);
      cb = cc;
      cc = nd.c;
      mb = mc;
      mc = nd.m;
    }
    if constexpr (kVec) cp_async_wait<0>();
  }

  // the polar ring means of the rows this block owns
  for (int pole = 0; pole < 2; ++pole) {
    const int j = pole == 0 ? 0 : H - 1;
    if (j < j0 || j >= j1) continue;
    if (threadIdx.x == 0) s_count = 0;
    __syncthreads();  // the walk's ring reads, and the last row's stores, are done
    const T* row = out + j * W;
    const unsigned char* mrow = ocean + j * W;
    int n_own = 0;
    for (int i = threadIdx.x; i < W; i += blockDim.x) {
      sX[i] = mrow[i] ? row[i] : T(0);  // the walk's stores, made visible by the barrier
      n_own += mrow[i] ? 1 : 0;
    }
    atomicAdd(&s_count, n_own);
    __syncthreads();
    T* a = sX;
    T* c = sX + W;
    for (int n = W; n > 1;) {
      const int h = n >> 1;
      for (int i = threadIdx.x; i < h; i += blockDim.x) c[i] = a[i] + a[i + h];
      if ((n & 1) && threadIdx.x == 0) c[h] = a[2 * h];
      __syncthreads();
      T* t = a;
      a = c;
      c = t;
      n = h + (n & 1);
    }
    const int count = s_count;
    const T mean = a[0] / T(count > 1 ? count : 1);
    if (count > 0)
      for (int i = threadIdx.x; i < W; i += blockDim.x)
        if (mrow[i]) out[j * W + i] = mean;
    __syncthreads();  // every thread has read a[0] before the next pole reuses sX
  }
}

template <typename T, int V, bool kVec>
int launch_v(bool diffuse, dim3 grid, int threads, size_t smem, cudaStream_t stream,
             const T* Cp, const T* Ca, const unsigned char* ocean, const T* cosm, T* out, int S,
             int H, int W, int n_chunks, int run_rows, long long cp_bs, long long ca_bs,
             long long oc_bs, long long c_bs, T w_old, T w_adv, T kdt, qd::Inv<T> inv) {
  auto kernel = diffuse ? phyto_transport_kernel<T, V, kVec, true>
                        : phyto_transport_kernel<T, V, kVec, false>;
  if (smem > 48 * 1024) {
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  kernel<<<grid, threads, smem, stream>>>(Cp, Ca, ocean, cosm, out, S, H, W, n_chunks, run_rows,
                                          cp_bs, ca_bs, oc_bs, c_bs, w_old, w_adv, kdt, inv);
  return (int)cudaGetLastError();
}

bool aligned(const void* p, size_t bytes) { return ((size_t)p % bytes) == 0; }

template <typename T>
int run(const void* Cp, const void* Ca, const void* ocean, const void* cosm, void* out,
        int n_members, long long cp_bs, long long ca_bs, long long oc_bs, long long c_bs, int S,
        int H, int W, int diffuse, double w_old, double w_adv, double kdt, double dlat,
        double dlon, double a, void* stream) {
  // offsets inside a plane are 32-bit
  if (n_members < 1 || S < 1 || H < 3 || W < 3 || (long long)H * W >= 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  // the vector path: 4 columns a thread, every row and member 16-byte aligned
  bool vec = W % 4 == 0 && W / 4 <= kMaxThreads && aligned(Cp, 16) && aligned(Ca, 16) &&
             aligned(cosm, 16) && aligned(out, 16) && aligned(ocean, 4) && cp_bs % 4 == 0 &&
             ca_bs % 4 == 0 && oc_bs % 4 == 0 && c_bs % 4 == 0;
  int dev = 0, sms = 0, smem_max = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaDeviceGetAttribute(&smem_max, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  // the rings of X and G (X alone without diffusion; the ring sums use 2
  // rows), and on the 16-byte path the stages of C_phyto, C_adv, the cos map
  // and the mask, where they fit
  const size_t rings = (diffuse ? 6 : 3) * (size_t)W * sizeof(T);
  const size_t staged = diffuse ? kStages<T> * (size_t)W * (3 * sizeof(T) + 1) : 0;
  vec = vec && rings + staged <= (size_t)smem_max;
  const size_t smem = rings + (vec ? staged : 0);
  const int V = vec || W > kMaxThreads ? 4 : 1;
  const int threads = (W + V - 1) / V;
  if (threads > kMaxThreads || smem > (size_t)smem_max) return (int)cudaErrorInvalidValue;
  // runs of rows: a whole plane a block where the planes alone fill the
  // card, else cut until they do, no run shorter than kMinRows
  const long long planes = (long long)n_members * S;
  const long long want = (long long)sms * kBlocksPerSM;
  const int max_chunks = (H + kMinRows - 1) / kMinRows;
  long long n = (want + planes - 1) / planes;
  n = n < 1 ? 1 : (n > max_chunks ? max_chunks : n);
  const int run_rows = (int)((H + n - 1) / n);
  const int n_chunks = (H + run_rows - 1) / run_rows;
  if (planes * n_chunks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)(planes * n_chunks));
  const qd::Inv<T> inv = qd::inverses<T>(dlat, dlon, a);
  const cudaStream_t st = (cudaStream_t)stream;
  const auto* oc = (const unsigned char*)ocean;
#define QD_K5_ARGS                                                                              \
  diffuse != 0, grid, threads, smem, st, (const T*)Cp, (const T*)Ca, oc, (const T*)cosm, (T*)out, \
      S, H, W, n_chunks, run_rows, cp_bs, ca_bs, oc_bs, c_bs, T(w_old), T(w_adv), T(kdt), inv
  if (vec) return launch_v<T, 4, true>(QD_K5_ARGS);
  if (V == 1) return launch_v<T, 1, false>(QD_K5_ARGS);
  return launch_v<T, 4, false>(QD_K5_ARGS);
#undef QD_K5_ARGS
}

}  // namespace

// n_members members: member b's C_phyto at Cp + b * cp_bs, C_adv at
// Ca + b * ca_bs, its ocean mask (bytes) at ocean + b * oc_bs and its cos map
// at cosm + b * c_bs (strides in elements, 0 for a shared input); out is
// [n_members, S, H, W]; w_old = 1 - alpha, w_adv = alpha, kdt = dt * K_h,
// diffuse = (K_h > 0)
#define QD_PHYTO_LAUNCHER(NAME, T)                                                             \
  extern "C" int NAME(const void* Cp, const void* Ca, const void* ocean, const void* cosm,     \
                      void* out, int n_members, long long cp_bs, long long ca_bs,              \
                      long long oc_bs, long long c_bs, int S, int H, int W, int diffuse,       \
                      double w_old, double w_adv, double kdt, double dlat, double dlon,        \
                      double a, void* stream) {                                                \
    return run<T>(Cp, Ca, ocean, cosm, out, n_members, cp_bs, ca_bs, oc_bs, c_bs, S, H, W,     \
                  diffuse, w_old, w_adv, kdt, dlat, dlon, a, stream);                          \
  }

QD_PHYTO_LAUNCHER(qd_phyto_transport_f32, float)
QD_PHYTO_LAUNCHER(qd_phyto_transport_f64, double)
