// K6: the separable Gaussian filter of `gaussian_filter_plain`
// (qingdai_tpu_torch/ops/smooth.py) for every plane of a stack [B, H, W]:
// the latitude pass, then the longitude pass, each
//   out[i] = sum_t w[t] * F[src(i - r + t)],   t = 0 .. 2r,
// with src the pad mode's map of an index beyond the axis back onto it, as
// `_pad1d` builds the padded field (reflect: -1-i and 2n-1-i, the edge value
// repeated; wrap: i+n and i-n; nearest: 0 and n-1).
//
// Replaces no TPU kernel: the JAX package leaves the filter
// (qingdai_tpu/ops/smooth.py) to XLA's fusion under jit. The port ran each
// call eagerly, a pad, a zero fill and a multiply and an add for every tap
// on each axis (44 launches and ~96 passes over the stack a call at sigma =
// 1); the step makes five calls.
//
// What bounds it on the H100: device-memory bytes. The work needs the stack
// read once and the result written once, 2S for a stack of S bytes; the
// taps' products and sums (2 (2r+1) a cell an axis, each rounded on its own)
// come second, at about half of that time for r = 4 at the cells' shapes.
//
// Design. A block owns whole rows of one plane and walks down a run of rows
// [j0, j1). Thread t takes the V consecutive columns from V t (16 bytes).
// The input rows j0-r .. j1-1+r stream in through cp.async, kStages rows
// ahead of their use, into a ring of stages in shared memory; each thread
// copies and reads only its own columns, so it waits on its own copies and
// nothing else. Each row is read once from the stage into a window of the
// last 2r+1 rows held in the thread's registers, so the latitude pass takes
// its taps from registers. Its result, held in T, goes to one of two row
// buffers in shared memory (one barrier a row); the longitude pass reads the
// thread's columns and r either side from there as 16-byte words (through
// the mode's seam map for the first and last threads of the row) and writes
// its V results as one 16-byte store. So each byte of the stack is read from
// device memory once, but for the 2r rows around each run that the runs on
// either side read too, at about the same time, so that L2 often holds
// them. The launcher cuts the planes into runs so that the card's resident
// blocks run in few, full waves (`chunks`).
//
// The fast path takes the radii of the step's calls, r = 4 (sigma = 1) and
// r = 1 (sigma = 0.2). Where the radius is another or the row is wider than
// kMaxThreads words, a general path takes any radius up to kMaxRadius and
// any width, in the same order of operations: each thread loops over the
// row's columns, the latitude taps read from device memory (L1 and L2 hold
// the 2r+1 rows) and the longitude taps from the row buffer.
//
// Rounding: the plain version's op order on the card. Each pass starts from
// +0.0 and adds w[t] * x tap by tap in `_taps`' order, each product and
// each sum rounded on its own (__fmul_rn / __fadd_rn and the double forms,
// which nvcc never contracts into an FMA); the weights are the plain
// version's Python numbers rounded to T, as PyTorch rounds a scalar it
// multiplies a tensor by; the latitude pass's result is held in T. So every
// cell, NaN and inf included, equals the plain version's bits.
//
// The batched form: the grid runs over B planes, plane b read at b times the
// input's member stride (0: one plane shared by every member, read without a
// copy) and written to the contiguous output [B, H, W].

#include <cuda_runtime.h>

namespace {

enum Mode { kReflect = 0, kWrap = 1, kNearest = 2 };

constexpr int kMaxRadius = 64;
constexpr int kMaxTaps = 2 * kMaxRadius + 1;
constexpr int kMaxThreads = 512;  // 128 registers a thread
// rows of input in flight a block: 4 read 2-4% faster than 6 or 8 on an
// H100 at the cells' shapes (more blocks fit an SM)
constexpr int kStages = 4;
constexpr int kMinRows = 16;      // the shortest run of rows a block walks

// the taps by value, rounded to T on the host
template <typename T>
struct Taps {
  T w[kMaxTaps];
};

__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }

// the index of the axis (length n) that padded index i reads: i inside the
// axis, else the mode's map (for |overhang| <= n; clamped into the axis
// beyond, where only values that no output uses are read)
__device__ __forceinline__ int source(int i, int n, int mode) {
  if (i < 0) i = mode == kWrap ? i + n : (mode == kReflect ? -1 - i : 0);
  else if (i >= n) i = mode == kWrap ? i - n : (mode == kReflect ? 2 * n - 1 - i : n - 1);
  return min(max(i, 0), n - 1);
}

template <typename T, int V>
struct alignas(sizeof(T) * V) Pack {
  T a[V];
};

// cp.async: a copy from global to shared memory that the thread waits for
// later (16 bytes through L2 only, or one element)
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem) : "memory");
}

template <int kBytes>
__device__ __forceinline__ void cp_async_elem(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(s), "l"(gmem), "n"(kBytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// the plane and the run of rows [j0, j1) of this block
struct Run {
  long long plane;
  int j0, j1;
};

__device__ __forceinline__ Run block_run(int H, int n_chunks, int run_rows) {
  const long long plane = blockIdx.x / n_chunks;
  const int j0 = (int)(blockIdx.x - plane * n_chunks) * run_rows;
  return Run{plane, j0, min(H, j0 + run_rows)};
}

// The fast path: radius R, V = 16 / sizeof(T) columns a thread, one thread
// for every V columns of the row (kVec: 16-byte accesses to device memory;
// otherwise one access a column, for a row whose width or member stride is
// no multiple of V or whose pointers are not aligned). `pitch` is W rounded
// up to V: the stages' and the row buffers' row length.
template <typename T, int R, bool kVec>
__global__ void __launch_bounds__(kMaxThreads)
gauss_rows_kernel(const T* __restrict__ in, T* __restrict__ out, int H, int W, int pitch,
                  long long in_bs, int n_chunks, int run_rows, int mode_lat, int mode_lon,
                  Taps<T> taps) {
  constexpr int V = 16 / (int)sizeof(T);
  constexpr int K = 2 * R + 1;
  constexpr int kHalo = (R + V - 1) / V * V;  // the longitude window's columns either side
  constexpr int kWin = V + 2 * kHalo;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* stage = reinterpret_cast<T*>(smem_raw);  // kStages rows
  T* lat = stage + kStages * pitch;            // two rows: the latitude pass's results

  const Run run = block_run(H, n_chunks, run_rows);
  in += run.plane * in_bs;
  out += run.plane * H * (long long)W;
  const int n_in = run.j1 - run.j0 + 2 * R;  // the rows this run streams
  const int i0 = (int)threadIdx.x * V;
  using P = Pack<T, V>;

  // streamed row q (padded row j0 - R + q) into stage q % kStages
  auto fetch = [&](int q) {
    if (q < n_in) {
      const T* src = in + (long long)source(run.j0 - R + q, H, mode_lat) * W + i0;
      T* dst = stage + (q % kStages) * pitch + i0;
      if constexpr (kVec) {
        cp_async16(dst, src);
      } else {
#pragma unroll
        for (int k = 0; k < V; ++k)
          if (i0 + k < W) cp_async_elem<sizeof(T)>(dst + k, src + k);
      }
    }
    cp_async_commit();
  };

  // the longitude pass of a row buffer into the output row `dst`
  auto lon_row = [&](const T* buf, T* dst) {
    T win[kWin];  // columns i0 - kHalo .. i0 + V + kHalo - 1 of the row
#pragma unroll
    for (int m = 0; m < kWin; m += V) {
      const int c = i0 - kHalo + m;
      if (c >= 0 && c + V <= W) {
        const P p = *reinterpret_cast<const P*>(buf + c);
#pragma unroll
        for (int k = 0; k < V; ++k) win[m + k] = p.a[k];
      } else {  // across the seam: the first and last threads of the row
#pragma unroll
        for (int k = 0; k < V; ++k) win[m + k] = buf[source(c + k, W, mode_lon)];
      }
    }
    P y;
#pragma unroll
    for (int k = 0; k < V; ++k) {
      T acc = T(0);
#pragma unroll
      for (int t = 0; t < K; ++t) acc = add_rn(acc, mul_rn(taps.w[t], win[kHalo - R + k + t]));
      y.a[k] = acc;
    }
    if constexpr (kVec) {
      *reinterpret_cast<P*>(dst + i0) = y;
    } else {
#pragma unroll
      for (int k = 0; k < V; ++k)
        if (i0 + k < W) dst[i0 + k] = y.a[k];
    }
  };

  for (int q = 0; q < kStages; ++q) fetch(q);
  // the window: x[K-1] the newest row (unrolling the walk by K to keep
  // the rows in place instead took twice the registers, and longer)
  T x[K][V] = {};
  for (int q = 0; q < n_in; ++q) {
    cp_async_wait<kStages - 1>();  // row q's copies have landed
    const P row = *reinterpret_cast<const P*>(stage + (q % kStages) * pitch + i0);
#pragma unroll
    for (int t = 0; t + 1 < K; ++t)
#pragma unroll
      for (int k = 0; k < V; ++k) x[t][k] = x[t + 1][k];
#pragma unroll
    for (int k = 0; k < V; ++k) x[K - 1][k] = row.a[k];
    const bool emit = q >= 2 * R;  // the window holds rows j-R .. j+R of row j
    T* buf = lat + (q & 1) * pitch;
    if (emit) {
      P y;
#pragma unroll
      for (int k = 0; k < V; ++k) {
        T acc = T(0);
#pragma unroll
        for (int t = 0; t < K; ++t) acc = add_rn(acc, mul_rn(taps.w[t], x[t][k]));
        y.a[k] = acc;
      }
      *reinterpret_cast<P*>(buf + i0) = y;
    }
    // every stage read of this row and every buffer write are done; the
    // stage just read takes row q + kStages, and the buffer written two rows
    // ago has been read by every thread
    __syncthreads();
    fetch(q + kStages);
    if (emit) lon_row(buf, out + (long long)(run.j0 + q - 2 * R) * W);
  }
  cp_async_wait<0>();
}

// The general path: any radius r <= kMaxRadius and any width; each thread
// loops over the row's columns.
template <typename T>
__global__ void __launch_bounds__(kMaxThreads)
gauss_general_kernel(const T* __restrict__ in, T* __restrict__ out, int H, int W,
                     long long in_bs, int n_chunks, int run_rows, int r, int mode_lat,
                     int mode_lon, Taps<T> taps) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* lat = reinterpret_cast<T*>(smem_raw);  // two rows
  const Run run = block_run(H, n_chunks, run_rows);
  in += run.plane * in_bs;
  out += run.plane * H * (long long)W;
  for (int j = run.j0; j < run.j1; ++j) {
    T* buf = lat + (j & 1) * W;
    for (int i = threadIdx.x; i < W; i += blockDim.x) {
      T acc = T(0);
      for (int t = 0; t <= 2 * r; ++t)
        acc = add_rn(acc, mul_rn(taps.w[t], in[(long long)source(j - r + t, H, mode_lat) * W + i]));
      buf[i] = acc;
    }
    // this row's buffer is written; the one written two rows ago was read
    // by every thread before the last barrier
    __syncthreads();
    for (int i = threadIdx.x; i < W; i += blockDim.x) {
      T acc = T(0);
      for (int t = 0; t <= 2 * r; ++t)
        acc = add_rn(acc, mul_rn(taps.w[t], buf[source(i - r + t, W, mode_lon)]));
      out[(long long)j * W + i] = acc;
    }
  }
}

bool aligned(const void* p) { return ((size_t)p % 16) == 0; }

// Runs of rows a plane. The card holds `slots` blocks at once, so the
// blocks run in ceil(blocks / slots) waves, and a block takes about its
// rows of output plus half its 2r rows of halo (which load and shift but do
// not filter); take the number of runs, each at least kMinRows, whose waves take
// the least time, the fewest runs of those. On an H100 this model's choice
// read 63.9% / 68.2% of the bound at the cells' stacks with r = 4 where runs
// of 16, 32 or 64 rows read 52.7-64.0%.
int chunks(long long planes, int H, int r, long long slots) {
  const int max_chunks = (H + kMinRows - 1) / kMinRows;
  int best = 1;
  long long best_cost = -1;
  for (int n = 1; n <= max_chunks; ++n) {
    const long long waves = (planes * n + slots - 1) / slots;
    const long long cost = waves * ((H + n - 1) / n + r);
    if (best_cost < 0 || cost < best_cost) best = n, best_cost = cost;
  }
  return best;
}

template <typename Kernel>
int set_smem(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)smem);
}

template <typename T, int R, bool kVec>
int launch_rows(const T* in, T* out, int n_members, long long in_bs, int H, int W, int mode_lat,
                int mode_lon, const Taps<T>& taps, int sms, size_t smem_max, cudaStream_t st) {
  constexpr int V = 16 / (int)sizeof(T);
  const int pitch = (W + V - 1) / V * V;
  const int threads = pitch / V;
  const size_t smem = (size_t)(kStages + 2) * pitch * sizeof(T);
  if (smem > smem_max) return (int)cudaErrorInvalidValue;
  auto kernel = gauss_rows_kernel<T, R, kVec>;
  if (const int e = set_smem(kernel, smem)) return e;
  int per_sm = 0;
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem);
  const int n_chunks = chunks(n_members, H, R, (long long)sms * (per_sm > 0 ? per_sm : 1));
  const int run_rows = (H + n_chunks - 1) / n_chunks;
  const int n = (H + run_rows - 1) / run_rows;
  kernel<<<(unsigned)((long long)n_members * n), threads, smem, st>>>(
      in, out, H, W, pitch, in_bs, n, run_rows, mode_lat, mode_lon, taps);
  return (int)cudaGetLastError();
}

template <typename T>
int run(const void* in_, void* out_, int n_members, long long in_bs, int H, int W, int r,
        const double* w, int mode_lat, int mode_lon, void* stream) {
  if (n_members < 1 || H < 1 || W < 1 || r < 1 || r > kMaxRadius || mode_lat < 0 ||
      mode_lat > kNearest || mode_lon < 0 || mode_lon > kNearest ||
      (mode_lat != kNearest && r > H) || (mode_lon != kNearest && r > W) ||
      (long long)n_members * H >= 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  Taps<T> taps{};
  for (int t = 0; t <= 2 * r; ++t) taps.w[t] = T(w[t]);
  int dev = 0, sms = 0, smem_max = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaDeviceGetAttribute(&smem_max, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  const T* in = (const T*)in_;
  T* out = (T*)out_;
  const cudaStream_t st = (cudaStream_t)stream;
  constexpr int V = 16 / (int)sizeof(T);
  const int threads = (W + V - 1) / V;
  if (threads <= kMaxThreads && (r == 1 || r == 4)) {
    const bool vec = W % V == 0 && in_bs % V == 0 && aligned(in) && aligned(out);
#define QD_K6_ROWS(R)                                                                     \
  return vec ? launch_rows<T, R, true>(in, out, n_members, in_bs, H, W, mode_lat,          \
                                       mode_lon, taps, sms, smem_max, st)                  \
             : launch_rows<T, R, false>(in, out, n_members, in_bs, H, W, mode_lat,         \
                                        mode_lon, taps, sms, smem_max, st)
    if (r == 1) QD_K6_ROWS(1);
    QD_K6_ROWS(4);
#undef QD_K6_ROWS
  }
  const size_t smem = 2 * (size_t)W * sizeof(T);
  if (smem > (size_t)smem_max) return (int)cudaErrorInvalidValue;
  auto kernel = gauss_general_kernel<T>;
  if (const int e = set_smem(kernel, smem)) return e;
  const int gthreads = threads < 128 ? 128 : (threads > kMaxThreads ? kMaxThreads : threads);
  int per_sm = 0;
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, gthreads, smem);
  const int n_chunks = chunks(n_members, H, r, (long long)sms * (per_sm > 0 ? per_sm : 1));
  const int run_rows = (H + n_chunks - 1) / n_chunks;
  const int n = (H + run_rows - 1) / run_rows;
  kernel<<<(unsigned)((long long)n_members * n), gthreads, smem, st>>>(
      in, out, H, W, in_bs, n, run_rows, r, mode_lat, mode_lon, taps);
  return (int)cudaGetLastError();
}

}  // namespace

// n_members planes [H, W]: plane b at in + b * in_bs (elements; 0 for one
// plane shared by every member), out [n_members, H, W]; w the 2r+1 taps in
// double, each rounded to T; mode_lat and mode_lon 0 reflect, 1 wrap,
// 2 nearest. Returns cudaErrorInvalidValue for what the plain version
// refuses (a radius beyond a reflect or wrap axis) and for shapes the kernel
// does not take (a radius above kMaxRadius, a row whose buffers exceed the
// card's shared memory).
#define QD_GAUSS_LAUNCHER(NAME, T)                                                           \
  extern "C" int NAME(const void* in, void* out, int n_members, long long in_bs, int H,      \
                      int W, int r, const double* w, int mode_lat, int mode_lon,             \
                      void* stream) {                                                        \
    return run<T>(in, out, n_members, in_bs, H, W, r, w, mode_lat, mode_lon, stream);        \
  }

QD_GAUSS_LAUNCHER(qd_gauss_sep_f32, float)
QD_GAUSS_LAUNCHER(qd_gauss_sep_f64, double)
