// K1: exact median of the strictly positive entries of a field, as one
// launch of a thread-block cluster.
//
// Replaces the TPU kernel `_median_pos_pallas` / `_median_pos_pallas_kernel`
// (qingdai_tpu/ops/reductions.py), which brackets the two middle order
// statistics by two 34-step value bisections over a VMEM-resident block.
//
// A positive IEEE float (+inf included) orders like its bit pattern read as
// an unsigned integer, so the k-th smallest positive is found digit by
// digit, most significant first: a radix select. Both middle order
// statistics, k0 = (n-1)/2 and k1 = n/2, are selected in the same passes.
// The result is written to a 0-d device tensor, so nothing returns to the
// host:  out = n > 0 ? 0.5 * (s0 + s1) : fallback.
// `v > 0` is false for NaN and for -0.0 and true for +inf and denormals (no
// flush to zero), as in the sort version; the result is bit-equal to
// `masked_median_of_positive_ref`.
//
// What bounds it on the H100: latency, not bytes. The 181x360 float field is
// 260 KB (0.08 us at the HBM rate); one launch alone costs ~2 us, and every
// radix pass is a round of histogram, cross-block merge and digit search
// that depends on the one before. The design cuts each of those:
// - One cluster of 8 CTAs (`__cluster_dims__`, the portable size) on 8 SMs
//   instead of one CTA. Each CTA reads its contiguous 1/8 of the field from
//   device memory once, all of a thread's loads in flight together, and
//   keeps only the positives' bit patterns, compacted, in dynamic shared
//   memory (at most 32.6 KB in float32 and 65.2 KB in float64 at 181x360,
//   above 48 KB by `cudaFuncAttributeMaxDynamicSharedMemorySize`). Later
//   passes read shared memory, not L2.
// - The count needs no pass of its own: n is the total of the merged first
//   histogram, and k0, k1 follow from it.
// - Histograms without same-bin serialization: a warp groups its lanes by
//   digit (`__match_any_sync`) and one lane per group adds the group's size,
//   so a field whose positives share a binade (precipitation) costs one
//   shared atomic per warp and digit, not one per element. One histogram per
//   target only while the two targets' prefixes differ.
// - The merge reads the 8 CTAs' histograms through distributed shared
//   memory (`cluster.map_shared_rank`), one `cluster.sync()` per pass; the
//   histograms alternate between two buffers so that no second barrier is
//   needed before a CTA clears its own. Every CTA sums the same integers and
//   searches the same digit, so all reach the same prefix.
// - The digit search is a warp scan (shuffles over 8 bins a lane) and a
//   ballot, not a 256-step loop.
// - Each pass after the first compacts the candidates in place to those that
//   match a target's prefix, so later passes touch only them.
// Digits are 8 bits (4 passes in float32, 8 in float64): after the first
// compaction a pass costs little per element, and its fixed part (merging
// 8 remote histograms and scanning them) grows with the number of bins, so
// 256 bins with one more pass beats 2048 bins with one fewer.
// A field whose 1/8 exceeds the shared-memory stage (above ~1.6M float32
// cells) is not staged: every pass then re-reads the CTA's slice from device
// memory, with the same results.
//
// The batched form (an ensemble's members, one launch): B clusters, cluster
// b selecting in member b's field (x + b * x_stride; a stride of 0 gives
// every member one shared field) and writing out[b]. The clusters share
// nothing, so each member's result is the single launch's bit for bit.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kCluster = 8;
constexpr int kThreads = 1024;
constexpr int kPer = 8;                 // elements a thread loads per round
constexpr int kDigit = 8;
constexpr int kBins = 1 << kDigit;
constexpr unsigned kNone = 0xFFFFFFFFu;  // "no bin": the lane's element is not counted
constexpr int kMaxStage = 200 * 1024;   // dynamic shared memory for the stage, bytes
constexpr unsigned kFull = 0xFFFFFFFFu;

template <typename T> struct BitsOf;
template <> struct BitsOf<float> {
  using U = unsigned int;
  static constexpr int kBits = 32;
  __device__ static U get(float v) { return __float_as_uint(v); }
  __device__ static float put(U b) { return __uint_as_float(b); }
};
template <> struct BitsOf<double> {
  using U = unsigned long long;
  static constexpr int kBits = 64;
  __device__ static U get(double v) { return (U)__double_as_longlong(v); }
  __device__ static double put(U b) { return __longlong_as_double((long long)b); }
};

// Warp-aggregated histogram increment: lanes with equal keys add once.
__device__ __forceinline__ void warp_count(unsigned* h, unsigned key) {
  const unsigned peers = __match_any_sync(kFull, key);
  if (key != kNone && (threadIdx.x & 31) == __ffs(peers) - 1) atomicAdd(h + key, __popc(peers));
}

// Append the lanes' kept values to buf at a shared write pointer.
template <typename U>
__device__ __forceinline__ void warp_append(U* buf, unsigned* wptr, bool keep, U bits) {
  const unsigned lane = threadIdx.x & 31;
  const unsigned ball = __ballot_sync(kFull, keep);
  unsigned base = 0;
  if (lane == 0 && ball) base = atomicAdd(wptr, __popc(ball));
  base = __shfl_sync(kFull, base, 0);
  if (keep) buf[base + __popc(ball & ((1u << lane) - 1u))] = bits;
}

// One warp: the histogram's total, and for each of `nk` ranks the bin that
// holds it and the rank within that bin.
__device__ __forceinline__ void warp_select(const unsigned* h, int nk, const unsigned* k,
                                            unsigned* digit, unsigned* k_rem,
                                            unsigned* total) {
  const unsigned lane = threadIdx.x & 31;
  constexpr int kPerLane = kBins / 32;
  unsigned c[kPerLane], s = 0;
#pragma unroll
  for (int b = 0; b < kPerLane; ++b) {
    c[b] = h[lane * kPerLane + b];
    s += c[b];
  }
  unsigned incl = s;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const unsigned y = __shfl_up_sync(kFull, incl, off);
    if (lane >= (unsigned)off) incl += y;
  }
  *total = __shfl_sync(kFull, incl, 31);
  for (int t = 0; t < nk; ++t) {
    const unsigned kt = k[t];
    const unsigned ball = __ballot_sync(kFull, incl > kt);
    const int L = __ffs(ball) - 1;  // k < total, so some lane holds it
    unsigned d = 0, r = 0;
    if ((int)lane == L) {
      unsigned cum = incl - s;
#pragma unroll
      for (int b = 0; b < kPerLane; ++b) {
        if (kt < cum + c[b]) {
          d = lane * kPerLane + b;
          r = kt - cum;
          break;
        }
        cum += c[b];
      }
    }
    digit[t] = __shfl_sync(kFull, d, L);
    k_rem[t] = __shfl_sync(kFull, r, L);
  }
}

// Stage boundaries of a traced launch: the device's global timer (ns) in
// trace[s] and the SM's cycle counter in trace[kSlots + s].
template <int kSlots>
__device__ __forceinline__ void stamp(unsigned long long* trace, int s) {
  unsigned long long ns;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(ns));
  trace[s] = ns;
  trace[kSlots + s] = clock64();
}

template <typename T>
__global__ void __cluster_dims__(kCluster, 1, 1) __launch_bounds__(kThreads)
median_pos_kernel(const T* __restrict__ x, long long x_stride, int n_elem, int chunk,
                  int staged, T fallback, T* __restrict__ out,
                  unsigned long long* __restrict__ trace) {
  using B = BitsOf<T>;
  using U = typename B::U;
  constexpr int kPasses = B::kBits / kDigit;
  constexpr int kSlots = 2 + 2 * kPasses;
  __shared__ unsigned hist[2][2][kBins];  // [pass parity][target][bin]: this CTA's counts
  __shared__ unsigned merged[2][kBins];   // [target][bin]: the cluster's counts
  __shared__ U s_prefix[2];
  __shared__ unsigned s_k[2], s_n, s_cnt, s_wptr;
  extern __shared__ __align__(16) unsigned char stage_raw[];
  U* buf = reinterpret_cast<U*>(stage_raw);

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int member = (int)blockIdx.x / kCluster;  // the cluster's member of a batched launch
  x += member * x_stride;
  out += member;
  const int tid = threadIdx.x, warp = tid >> 5;
  const int warp0 = tid & ~31;  // the warp's first thread: rounds past the end skip whole warps
  const bool tracing = trace != nullptr && member == 0 && rank == 0 && tid == 0;
  if (tracing) stamp<kSlots>(trace, 0);
  const int begin = rank * chunk;
  const int len = max(0, min(chunk, n_elem - begin));
  const T* xs = x + begin;

  for (int b = tid; b < 4 * kBins; b += kThreads) (&hist[0][0][0])[b] = 0u;
  if (tid == 0) s_wptr = 0u;
  __syncthreads();

  // pass 0: load the slice (all of a thread's loads in flight together),
  // count the positives' leading digit, stage the positives' bit patterns
  int shift = B::kBits - kDigit;
  for (int base = 0; base < len; base += kThreads * kPer) {
    T vals[kPer];
#pragma unroll
    for (int r = 0; r < kPer; ++r) {
      const int i = base + r * kThreads + tid;
      vals[r] = i < len ? xs[i] : T(0);
    }
#pragma unroll
    for (int r = 0; r < kPer; ++r) {
      if (base + r * kThreads + warp0 >= len) break;
      const bool pos = vals[r] > T(0);
      const U bits = B::get(vals[r]);
      warp_count(&hist[0][0][0], pos ? (unsigned)(bits >> shift) : kNone);
      if (staged) warp_append(buf, &s_wptr, pos, bits);
    }
  }
  __syncthreads();
  if (tid == 0) s_cnt = s_wptr;

  for (int pass = 0; pass < kPasses; ++pass, shift -= kDigit) {
    const int par = pass & 1;
    const bool same = pass == 0 || s_prefix[0] == s_prefix[1];
    if (pass > 0) {
      // count the candidates that match a target's prefix, and compact the
      // stage to them unless this is the last pass
      const bool compact = staged && pass + 1 < kPasses;
      const U hi = (~U(0)) << (shift + kDigit);
      const U p0 = s_prefix[0], p1 = s_prefix[1];
      const int cnt = staged ? (int)s_cnt : len;
      for (int b = tid; b < 2 * kBins; b += kThreads) (&hist[par][0][0])[b] = 0u;
      if (tid == 0) s_wptr = 0u;
      __syncthreads();
      for (int base = 0; base < cnt; base += kThreads * kPer) {
        U bits[kPer];
        bool pos[kPer];
#pragma unroll
        for (int r = 0; r < kPer; ++r) {
          const int i = base + r * kThreads + tid;
          if (staged) {
            pos[r] = i < cnt;
            bits[r] = pos[r] ? buf[i] : U(0);
          } else {
            const T val = i < cnt ? xs[i] : T(0);
            pos[r] = val > T(0);
            bits[r] = B::get(val);
          }
        }
        bool keep[kPer];
        const int live = min(kPer, (cnt - base - warp0 + kThreads - 1) / kThreads);
#pragma unroll
        for (int r = 0; r < kPer; ++r) {
          keep[r] = false;
          if (r >= live) continue;
          const unsigned d = (unsigned)(bits[r] >> shift) & (kBins - 1);
          const bool m0 = pos[r] && (bits[r] & hi) == p0;
          const bool m1 = !same && pos[r] && (bits[r] & hi) == p1;
          keep[r] = m0 || m1;
          warp_count(&hist[par][0][0], m0 ? d : (m1 ? kBins + d : kNone));
        }
        if (compact) {
          // every read of this round is done before any write: the writes
          // land below the elements read so far, and above none not yet read
          __syncthreads();
#pragma unroll
          for (int r = 0; r < live; ++r) warp_append(buf, &s_wptr, keep[r], bits[r]);
        }
      }
      __syncthreads();
      if (tid == 0 && compact) s_cnt = s_wptr;
    }
    if (tracing) stamp<kSlots>(trace, 1 + 2 * pass);

    // merge the cluster's histograms: every CTA sums the same counts
    cluster.sync();
    const int nt = same ? 1 : 2;
    for (int b = tid; b < nt * kBins; b += kThreads) {
      unsigned sum = 0;
#pragma unroll
      for (int r = 0; r < kCluster; ++r)
        sum += cluster.map_shared_rank(&hist[par][0][0], r)[b];
      (&merged[0][0])[b] = sum;
    }
    __syncthreads();
    if (pass == 0) {
      if (warp == 0) {
        unsigned total, digit[2], k_rem[2], k[2] = {0u, 0u};
        // the first call only totals (nk = 0); the targets follow from n
        warp_select(merged[0], 0, k, digit, k_rem, &total);
        k[0] = total > 0 ? (total - 1u) / 2u : 0u;
        k[1] = total / 2u;
        if (total > 0) warp_select(merged[0], 2, k, digit, k_rem, &total);
        if ((tid & 31) == 0) {
          s_n = total;
          for (int t = 0; t < 2; ++t) {
            s_prefix[t] = total > 0 ? U(digit[t]) << shift : U(0);
            s_k[t] = k_rem[t];
          }
        }
      }
    } else if (warp < 2) {
      unsigned total, digit[1], k_rem[1], k[1] = {s_k[warp]};
      warp_select(merged[same ? 0 : warp], 1, k, digit, k_rem, &total);
      if ((tid & 31) == 0) {
        s_prefix[warp] |= U(digit[0]) << shift;
        s_k[warp] = k_rem[0];
      }
    }
    __syncthreads();
    if (tracing) stamp<kSlots>(trace, 2 + 2 * pass);
    if (s_n == 0u) break;
  }
  if (rank == 0 && tid == 0)
    out[0] = s_n > 0u ? T(0.5) * (B::put(s_prefix[0]) + B::put(s_prefix[1])) : fallback;
  // no CTA leaves while another may still read its histograms
  cluster.sync();
  if (tracing) stamp<kSlots>(trace, kSlots - 1);
}

template <typename T>
int launch(const void* x, long long x_stride, int n_members, long long n, double fallback,
           void* out, void* trace, void* stream) {
  using U = typename BitsOf<T>::U;
  // the opt-in above 48 KB of dynamic shared memory, once per device
  static unsigned long long opted_in = 0ull;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev >= 64) return (int)cudaErrorInvalidDevice;
  if (!(opted_in >> dev & 1ull)) {
    e = cudaFuncSetAttribute(median_pos_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kMaxStage);
    if (e != cudaSuccess) return (int)e;
    opted_in |= 1ull << dev;
  }
  const int chunk = (int)((n + kCluster - 1) / kCluster);
  const size_t stage_bytes = (size_t)chunk * sizeof(U);
  const int staged = stage_bytes <= (size_t)kMaxStage;
  if (n_members < 1) return (int)cudaErrorInvalidValue;
  median_pos_kernel<T><<<kCluster * n_members, kThreads, staged ? stage_bytes : 0,
                         (cudaStream_t)stream>>>(
      (const T*)x, x_stride, (int)n, chunk, staged, (T)fallback, (T*)out,
      (unsigned long long*)trace);
  return (int)cudaGetLastError();
}

}  // namespace

// n_members fields of n entries each, member b's at x + b * x_stride; out
// takes n_members results
extern "C" int qd_median_pos_f32(const void* x, long long x_stride, int n_members, long long n,
                                 double fallback, void* out, void* trace, void* stream) {
  return launch<float>(x, x_stride, n_members, n, fallback, out, trace, stream);
}

extern "C" int qd_median_pos_f64(const void* x, long long x_stride, int n_members, long long n,
                                 double fallback, void* out, void* trace, void* stream) {
  return launch<double>(x, x_stride, n_members, n, fallback, out, trace, stream);
}
