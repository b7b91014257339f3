"""Where the time of kernel K1 (exact median of positives) goes, stage by
stage, on one NVIDIA card.

    python3 scripts/k1_anatomy.py [--reps 50]

Two designs on the same fields (181×360 float32, the main path's shape):
  - the one-block radix select that the cluster kernel replaced, rebuilt here
    from its algorithm with stage stamps: one block of 1024 threads, a count
    pass, then four 8-bit passes of (clear, shared-memory atomic histogram,
    256-step serial scan on one thread per target), each over the whole
    field in L2;
  - the cluster kernel of ``qingdai_tpu_torch/csrc/median_pos.cu`` through
    its ``trace`` argument.
Both write, at each stage boundary of their first block, the device's global
timer (ns) and the SM's cycle counter; the script reports the mean per stage
over ``--reps`` launches, and each kernel's device time per call from
``torch.profiler``. Fields: "precip" (60% zeros, positives |N(0,1)|·1e-5,
which share a few binades, so the leading digit lands in one or two bins)
and "spread" (every entry positive, exponents spread over 230 binades), which
isolates what same-bin atomics cost. Prints one line per stage and design
and a JSON record with the card's name and power limit. Imports no JAX.
"""

import argparse
import ctypes
import json
import os
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402
from qingdai_tpu_torch.kernels import build  # noqa: E402
from qingdai_tpu_torch.kernels.median_pos import median_pos_cuda, trace_slots  # noqa: E402
from qingdai_tpu_torch.ops import reductions  # noqa: E402

H, W = 181, 360

# the one-block design, float32, with a stamp after every block-wide barrier
ONE_BLOCK_SRC = r"""
#include <cuda_runtime.h>
constexpr int kThreads = 1024;
constexpr int kBins = 256;
constexpr int kSlots = 2 + 3 * 4;

__device__ __forceinline__ void stamp(unsigned long long* t, int s) {
  if (threadIdx.x != 0 || t == nullptr) return;
  unsigned long long ns;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(ns));
  t[s] = ns;
  t[kSlots + s] = clock64();
}

__global__ void __launch_bounds__(kThreads)
one_block(const float* __restrict__ x, long long n_elem, float fallback, float* out,
          unsigned long long* trace) {
  __shared__ unsigned int hist[2][kBins];
  __shared__ unsigned long long s_n, s_k[2];
  __shared__ unsigned int s_prefix[2];
  const int tid = threadIdx.x;
  stamp(trace, 0);
  if (tid == 0) s_n = 0ull;
  __syncthreads();
  unsigned long long local = 0ull;
  for (long long i = tid; i < n_elem; i += kThreads) local += (x[i] > 0.f) ? 1ull : 0ull;
  if (local) atomicAdd(&s_n, local);
  __syncthreads();
  stamp(trace, 1);
  const unsigned long long n = s_n;
  if (n == 0ull) {
    if (tid == 0) out[0] = fallback;
    return;
  }
  if (tid < 2) {
    s_k[tid] = (tid == 0) ? (n - 1ull) / 2ull : n / 2ull;
    s_prefix[tid] = 0u;
  }
  int slot = 2;
  for (int shift = 24; shift >= 0; shift -= 8) {
    const unsigned int mask = (shift + 8 == 32) ? 0u : (~0u) << (shift + 8);
    for (int b = tid; b < 2 * kBins; b += kThreads) hist[b / kBins][b % kBins] = 0u;
    __syncthreads();
    stamp(trace, slot++);
    const unsigned int p0 = s_prefix[0], p1 = s_prefix[1];
    for (long long i = tid; i < n_elem; i += kThreads) {
      const float v = x[i];
      if (v > 0.f) {
        const unsigned int bits = __float_as_uint(v);
        const unsigned int d = (bits >> shift) & 0xFFu;
        if ((bits & mask) == p0) atomicAdd(&hist[0][d], 1u);
        if ((bits & mask) == p1) atomicAdd(&hist[1][d], 1u);
      }
    }
    __syncthreads();
    stamp(trace, slot++);
    if (tid == 0 || tid == 32) {
      const int t = tid / 32;
      unsigned long long k = s_k[t], cum = 0ull;
      for (int d = 0; d < kBins; ++d) {
        const unsigned long long c = hist[t][d];
        if (k < cum + c) {
          s_prefix[t] |= (unsigned int)d << shift;
          s_k[t] = k - cum;
          break;
        }
        cum += c;
      }
    }
    __syncthreads();
    stamp(trace, slot++);
  }
  if (tid == 0) out[0] = 0.5f * (__uint_as_float(s_prefix[0]) + __uint_as_float(s_prefix[1]));
}

extern "C" int one_block_f32(const void* x, long long n, double fallback, void* out,
                             void* trace, void* stream) {
  one_block<<<1, kThreads, 0, (cudaStream_t)stream>>>((const float*)x, n, (float)fallback,
                                                      (float*)out,
                                                      (unsigned long long*)trace);
  return (int)cudaGetLastError();
}
"""
ONE_BLOCK_SLOTS = 2 + 3 * 4
ONE_BLOCK_STAGES = (["count pass"]
                    + [f"pass {p} {part}" for p in range(1, 5)
                       for part in ("clear", "histogram (shared atomics)", "serial scan")])


def build_one_block(out_dir: Path) -> ctypes.CDLL:
    out_dir.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=out_dir) as tmp:
        src = Path(tmp) / "one_block.cu"
        src.write_text(ONE_BLOCK_SRC)
        lib = out_dir / "libk1_one_block.so"
        cmd = [build.nvcc_path(), *build.NVCC_FLAGS, "-Xptxas", "-v", "-shared", "-o",
               str(lib), str(src)]
        res = subprocess.run(cmd, capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc failed:\n{res.stdout}\n{res.stderr}")
        print("one-block design, ptxas: " + " ".join(
            ln.strip() for ln in res.stderr.splitlines() if "registers" in ln))
    so = ctypes.CDLL(str(lib))
    so.one_block_f32.argtypes = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_double,
                                 ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
    so.one_block_f32.restype = ctypes.c_int
    return so


def fields(dev):
    r = np.random.default_rng(0)
    base = r.standard_normal((H, W))
    return {"precip": chip_smoke.on(dev, np.where(r.random((H, W)) < 0.6, 0.0,
                                                  np.abs(base) * 1e-5), torch.float32),
            "spread": chip_smoke.on(dev, np.exp(r.uniform(-80.0, 80.0, (H, W))),
                                    torch.float32)}


def stages(run, slots, reps, dev):
    """Mean µs and cycles between consecutive stamps over ``reps`` launches."""
    traces = torch.zeros((reps, 2, slots), dtype=torch.int64, device=dev)
    for k in range(reps):
        run(traces[k])
    t = traces.double().cpu().numpy()
    return np.diff(t[:, 0], axis=1).mean(axis=0) / 1e3, np.diff(t[:, 1], axis=1).mean(axis=0)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=50)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("k1_anatomy: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    label = chip_smoke.card_label()
    so = build_one_block(build.BUILD_DIR / "k1_anatomy")
    build.load_library()
    stream = torch.cuda.current_stream(dev).cuda_stream
    record = {"card": label, "reps": args.reps, "designs": {}}
    slots_cluster = trace_slots(torch.float32)

    for fname, x in fields(dev).items():
        ref = reductions.masked_median_of_positive_ref(x, 1e-6)

        def one_block(trace=None, x=x):
            out = torch.empty((), dtype=torch.float32, device=dev)
            rc = so.one_block_f32(x.data_ptr(), x.numel(), 1e-6, out.data_ptr(),
                                  None if trace is None else trace.data_ptr(), stream)
            if rc != 0:
                raise RuntimeError(f"one-block launch: CUDA error {rc}")
            return out

        def cluster(trace=None, x=x):
            return median_pos_cuda(x, 1e-6, trace=trace)

        for design, fn, slots, names in (
                ("one-block", one_block, ONE_BLOCK_SLOTS, ONE_BLOCK_STAGES),
                ("cluster", cluster, slots_cluster, chip_smoke.k1_stage_names(slots_cluster))):
            if not torch.equal(fn(), ref):
                raise AssertionError(f"{design} {fname}: differs from the sort")
            ms = chip_smoke.device_ms(fn)
            us, cyc = stages(fn, slots, args.reps, dev)
            parts = dict(zip(names, us.tolist()))
            inside = float(us.sum())
            record["designs"][f"{design}/{fname}"] = {"device_ms": ms, "inside_us": inside,
                                                      "stages_us": parts}
            print(f"K1 {design} design, {fname} field: device {ms * 1e3:.3f} us per call, "
                  f"{inside:.3f} us between the first block's first and last stamps, the "
                  f"rest launch and teardown; SM clock {cyc.sum() / (us.sum() * 1e3):.3f} GHz "
                  f"[{label}]")
            for nm, u_, c_ in zip(names, us, cyc):
                print(f"  {nm}: {u_:.3f} us ({c_:.0f} cycles)")
    print(json.dumps(record))
    return 0


if __name__ == "__main__":
    sys.exit(main())
