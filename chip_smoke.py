"""Drive the PyTorch / CUDA port's main path once on one NVIDIA card.

    python3 chip_smoke.py

Phases, each of which raises on failure (exit code non-zero):
  1. the card (nvidia-smi name and power limit), torch and CUDA versions, and
     whether nvcc and triton are present; the card's device-to-device copy
     rate (clone of a 1 GiB tensor);
  2. build the four CUDA kernels from ``qingdai_tpu_torch/csrc`` (one nvcc per
     source, in parallel) and print ptxas' register report;
  3. each kernel against its plain PyTorch version on the card, float32 and
     float64, at the main path's shapes, with the kernel's, the plain
     version's and (where one exists) one PyTorch call's times, in the order
     plain, kernel, kernel, plain: device time per call (the card's kernel
     times under torch.profiler over 20 calls), which the JSON line
     reports, and CUDA-event time of one call (median of 50), which
     includes the host's launch while the card waits;
  4. the main path, the default planet with river routing off (181×360,
     float32, ecology, the individual pool and phytoplankton on), built with
     no device argument: one planetary day of 240 steps, then a second,
     timed one, both with host syncs turned into errors; state and diags
     must be finite and physical, the launch counters must grow by exactly
     3, 3, 1 and 1 per step, and the daily blocks must run once a day. Then
     the path without ecology and phytoplankton (the slice of the first
     bring-up) the same way, with its own launch counts;
  5. one float64 step of the main path on the card against the same step on
     the CPU from the same warm state.
The line before the last is the kernels' JSON record; the last line is
``{"ok": true, "device": {...}}``.
"""

import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

MAIN = {"QD_HYDRO_ENABLE": "0"}
SLICE = {"QD_ECO_ENABLE": "0", "QD_PHYTO_ENABLE": "0", "QD_HYDRO_ENABLE": "0"}
H, W = 181, 360
STEPS_PER_DAY = 240
N_SPECIES = 10          # PhytoConfig.n_species: K4's stack is SST + 10 tracers
# (kernel, CUDA source, TPU kernel it replaces, launches per step on each path)
KERNELS = [
    ("median_pos", "qingdai_tpu_torch/csrc/median_pos.cu", "qingdai_tpu/ops/reductions.py:268", 3),
    ("advect_bilinear", "qingdai_tpu_torch/csrc/advect_bilinear.cu",
     "qingdai_tpu/ops/pallas_advect.py:65", 3),
    ("hyper4", "qingdai_tpu_torch/csrc/hyper4.cu", "qingdai_tpu/ops/pallas_stencil.py:56", 1),
    ("ocean_substeps", "qingdai_tpu_torch/csrc/ocean_substeps.cu",
     "qingdai_tpu/ops/pallas_ocean.py:200", 1),
]
# published H100 SXM peaks: HBM bytes/s and
# float32 operations/s outside the tensor cores
PEAK_BYTES = 3.35e12
PEAK_F32 = 67e12


def card_label() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, reps=50):
    """Median device time of one call, from CUDA events around each call."""
    for _ in range(3):
        fn()
    times = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def device_ms(fn, reps=20):
    """Device time of one call: the card's kernel (and memset/copy) times
    under torch.profiler over ``reps`` calls, per call."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us = sum(e.time_range.elapsed_us() for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA)
    if us <= 0.0:
        raise AssertionError("the profiler saw no device time")
    return us / reps / 1e3


def copy_rate(dev) -> float:
    """Device-to-device copy rate in bytes/s: clone of a 1 GiB tensor reads
    and writes 1 GiB each."""
    x = torch.empty(1 << 28, dtype=torch.float32, device=dev)
    ms = time_ms(lambda: x.clone(), reps=10)
    del x
    return 2.0 * (1 << 30) / (ms * 1e-3)


def on(dev, x, dtype):
    return torch.as_tensor(np.asarray(x)).to(device=dev, dtype=dtype)


def k4_operands(dev, dtype, n_tracers, n_sub, k4_nsub, K_h, seed=4):
    """K4's operands at 181×360 from a seeded state: 30% land, 15% ice, a
    fifth of the ocean with currents near the 3 m/s cap (some above it, so
    the mean4 repair runs)."""
    from qingdai_tpu_torch import ocean
    from qingdai_tpu_torch.config import OceanConfig
    from qingdai_tpu_torch.grid import make_grid
    from qingdai_tpu_torch.state import OceanState

    r = np.random.default_rng(seed)
    shape = (H, W)
    speed = np.where(r.random(shape) < 0.2, r.uniform(2.6, 3.4, shape),
                     np.abs(r.normal(0.0, 0.6, shape)))
    theta = r.uniform(0.0, 2.0 * np.pi, shape)
    g = make_grid(H, W, device=dev, dtype=dtype)
    ocn = OceanState(uo=on(dev, speed * np.cos(theta), dtype),
                     vo=on(dev, speed * np.sin(theta), dtype),
                     eta=on(dev, r.normal(0.0, 0.3, shape), dtype),
                     sst=on(dev, r.normal(288.0, 8.0, shape), dtype))
    land = on(dev, r.random(shape) < 0.3, torch.int32)
    tracers = (on(dev, r.uniform(0.0, 1.0, (n_tracers,) + shape), dtype)
               if n_tracers else None)
    cfg = OceanConfig(n_substeps=n_sub, k4_nsub=k4_nsub, K_h=K_h)
    return ocean.substep_operands(
        g, cfg, land, ocn, on(dev, r.normal(0.0, 8.0, shape), dtype),
        on(dev, r.normal(0.0, 4.0, shape), dtype), on(dev, r.normal(0.0, 150.0, shape), dtype),
        on(dev, r.random(shape) < 0.15, torch.bool), 300.0, n_sub, tracers)


def phase3_kernels(dev, label, rate):
    from qingdai_tpu_torch import constants as const
    from qingdai_tpu_torch import ocean
    from qingdai_tpu_torch.grid import make_grid
    from qingdai_tpu_torch.ops import advect, reductions, stencil

    A = const.PLANET_RADIUS
    r = np.random.default_rng(0)
    rec = {name: {"max_abs_err": 0.0} for name, *_ in KERNELS}

    for dtype in (torch.float32, torch.float64):
        g = make_grid(H, W, device=dev, dtype=dtype)
        # K1: bit-equal to the sort-based median
        base = r.standard_normal((H, W))
        cases = {
            "random": base,
            "precip": np.where(r.random((H, W)) < 0.6, 0.0, np.abs(base) * 1e-5),
            "odd": np.where(np.arange(H * W).reshape(H, W) == 0, 0.0, np.abs(base) + 0.1),
            "even": np.abs(base) + 0.1,
            "ties": r.integers(-3, 5, (H, W)).astype(np.float64),
            "fallback": -np.abs(base),
        }
        for case, x in cases.items():
            xt = on(dev, x, dtype)
            got = reductions.masked_median_of_positive(xt, 1e-6)
            ref = reductions.masked_median_of_positive_ref(xt, 1e-6)
            if not torch.equal(got, ref):
                raise AssertionError(f"K1 {case} {dtype}: {float(got)!r} != {float(ref)!r}")
        print(f"K1 median_pos {dtype}: bit-equal on {sorted(cases)}")

        # K2: winds capped at 200 m/s; polar rows wrap across the poles
        tol = 1e-6 if dtype == torch.float32 else 1e-12
        for M in (1, 2):
            F = on(dev, 280.0 + 20.0 * r.standard_normal((M, H, W)), dtype)
            u = on(dev, np.clip(120.0 * r.standard_normal((H, W)), -200, 200), dtype)
            v = on(dev, np.clip(120.0 * r.standard_normal((H, W)), -200, 200), dtype)
            dj, di = advect.departure_indices((H, W), u, v, 300.0, A, g.dlat_rad, g.dlon_rad,
                                              g.coslat_cap_tiny, dtype)
            got = advect.advect_semilag_multi(F, u, v, 300.0, A, g.dlat_rad, g.dlon_rad,
                                              g.coslat_cap_tiny)
            ref = advect.bilinear_wrap_gather_multi(F, dj, di)
            err = float((got - ref).abs().max())
            torch.testing.assert_close(got, ref, rtol=tol, atol=tol * float(F.abs().max()))
            if dtype == torch.float32:
                rec["advect_bilinear"]["max_abs_err"] = max(rec["advect_bilinear"]["max_abs_err"],
                                                            err)
            print(f"K2 advect_bilinear {dtype} M={M}: max|err| {err:.3e} "
                  f"(max|F| {float(F.abs().max()):.1f}, dep_j min {float(dj.min()):.2f})")

        # K3: the real k4 maps and cos caps of the atmosphere and the ocean
        tol = 1e-5 if dtype == torch.float32 else 1e-11
        for M, cap, k4_unit in ((5, 0.2, 0.02 * g.k4_map_unit / 300.0),
                                (3, 0.5, 0.02 * torch.clamp(A * g.dlon_rad * g.coslat_cap_05,
                                                            max=A * g.dlat_rad) ** 4 / 300.0)):
            cos = torch.clamp(g.coslat, min=cap)
            mult = on(dev, np.array([1.0, 1.0, 0.5, 0.5, 0.25][:M]).reshape(M, 1, 1), dtype)
            k4 = (k4_unit[None] * mult).contiguous()
            for n in (1, 2):
                F = on(dev, 30.0 * r.standard_normal((M, H, W)), dtype)
                got = stencil.hyperdiffuse_multi(F, k4, 300.0, n, g.dlat_rad, g.dlon_rad, cos, A)
                ref = stencil.hyperdiffuse_multi_ref(F, k4, 300.0, n, g.dlat_rad, g.dlon_rad,
                                                     cos, A)
                err = float((got - ref).abs().max())
                dF = float((ref - F).abs().max())
                if not err <= tol * dF:
                    raise AssertionError(f"K3 {dtype} M={M} n={n}: {err} > {tol} * {dF}")
                if dtype == torch.float32:
                    rec["hyper4"]["max_abs_err"] = max(rec["hyper4"]["max_abs_err"], err)
                print(f"K3 hyper4 {dtype} M={M} n={n} cap={cap}: max|err| {err:.3e} "
                      f"(max|dF| {dF:.3e})")

        # K4: each output plane within tol · max|plane|. In f32 a departure
        # coordinate near W = 360 has an ulp of 3e-5 cells, so one ulp of u
        # moves an interpolated tracer by up to 3e-5 of its largest neighbour
        # difference (~1 for the random tracers in [0, 1]); 1e-4 allows a few.
        tol = 1e-4 if dtype == torch.float32 else 1e-12
        for n_tr, n_sub, k4n, K_h in ((N_SPECIES, 1, 1, 5.0e3), (N_SPECIES, 1, 2, 0.0),
                                      (0, 1, 2, 5.0e3), (0, 2, 1, 0.0), (0, 2, 2, 5.0e3)):
            mom, st, forc, geo, params = k4_operands(dev, dtype, n_tr, n_sub, k4n, K_h)
            got = ocean.ocean_substeps(mom, st, forc, geo, **params)
            ref = ocean.ocean_substeps_plain(mom, st, forc, geo, **params)
            errs = []
            for name, g_, r_, x_ in (("mom", got[0], ref[0], mom), ("st", got[1], ref[1], st)):
                for k in range(r_.shape[0]):
                    err = float((g_[k] - r_[k]).abs().max())
                    scale = float(r_[k].abs().max())
                    delta = float((r_[k] - x_[k]).abs().max())
                    if not err <= tol * scale:
                        raise AssertionError(f"K4 {dtype} T={n_tr} n_sub={n_sub} k4={k4n} "
                                             f"K_h={K_h} {name}[{k}]: {err} > {tol} * {scale}")
                    errs.append((err, delta, f"{name}[{k}]"))
                    if dtype == torch.float32:
                        rec["ocean_substeps"]["max_abs_err"] = max(
                            rec["ocean_substeps"]["max_abs_err"], err)
            shown = ", ".join(f"{nm} {e:.2e}/{d:.2e}" for e, d, nm in errs[:6])
            print(f"K4 ocean_substeps {dtype} T={n_tr} n_sub={n_sub} k4_nsub={k4n} K_h={K_h}: "
                  f"max|err|/max|Δ| {shown}{' ...' if len(errs) > 6 else ''}; "
                  f"worst {max(errs)[0]:.3e}")

    # times at the main path's shapes, float32
    g = make_grid(H, W, device=dev, dtype=torch.float32)
    x = on(dev, np.where(r.random((H, W)) < 0.6, 0.0, np.abs(r.standard_normal((H, W))) * 1e-5),
           torch.float32)
    F2 = on(dev, 280.0 + 20.0 * r.standard_normal((2, H, W)), torch.float32)
    u = on(dev, np.clip(60.0 * r.standard_normal((H, W)), -200, 200), torch.float32)
    v = on(dev, np.clip(30.0 * r.standard_normal((H, W)), -200, 200), torch.float32)
    dj, di = advect.departure_indices((H, W), u, v, 300.0, A, g.dlat_rad, g.dlon_rad,
                                      g.coslat_cap_tiny, torch.float32)
    F5 = on(dev, 30.0 * r.standard_normal((5, H, W)), torch.float32)
    k4 = (0.02 * g.k4_map_unit / 300.0)[None].expand(5, H, W).contiguous()
    mom, st, forc, geo, params = k4_operands(dev, torch.float32, N_SPECIES, 1, 1, 5.0e3)
    from qingdai_tpu_torch.kernels.advect_bilinear import advect_bilinear_cuda
    from qingdai_tpu_torch.kernels.hyper4 import hyperdiffuse_cuda
    from qingdai_tpu_torch.kernels.median_pos import median_pos_cuda
    from qingdai_tpu_torch.kernels.ocean_substeps import ocean_substeps_cuda
    pairs = {
        "median_pos": (lambda: median_pos_cuda(x, 1e-6),
                       lambda: reductions.masked_median_of_positive_ref(x, 1e-6)),
        "advect_bilinear": (lambda: advect_bilinear_cuda(F2, dj, di),
                            lambda: advect.bilinear_wrap_gather_multi(F2, dj, di)),
        "hyper4": (lambda: hyperdiffuse_cuda(F5, k4, 300.0, 1, g.dlat_rad, g.dlon_rad,
                                             g.coslat_cap_02, A),
                   lambda: stencil.hyperdiffuse_multi_ref(F5, k4, 300.0, 1, g.dlat_rad,
                                                          g.dlon_rad, g.coslat_cap_02, A)),
        "ocean_substeps": (lambda: ocean_substeps_cuda(mom, st, forc, geo, **params),
                           lambda: ocean.ocean_substeps_plain(mom, st, forc, geo, **params)),
    }
    HW, f4 = H * W, 4
    n_st = st.shape[0]
    # bytes each function must move (inputs read once, outputs written once)
    # and the float operations it does, at these shapes
    work = {
        "median_pos": (HW * f4 + f4, 2 * HW),
        "advect_bilinear": ((2 * 2 + 2) * HW * f4, (2 * 7 + 10) * HW),
        "hyper4": ((5 * 2 + 1 + 5) * HW * f4, 5 * 70 * HW),
        "ocean_substeps": ((3 + n_st + 3 + 12 + 3 + n_st) * HW * f4,
                           (60 + 3 * 70 + 7 * n_st + 60) * HW),
    }
    # one PyTorch call computing the same function, where there is one
    library = {"advect_bilinear": grid_sample_call(F2, dj, di)}
    for name, (kern, plain) in pairs.items():
        # plain, kernel, kernel, plain: compare within one call, in turns
        p1, k1, k2, p2 = device_ms(plain), device_ms(kern), device_ms(kern), device_ms(plain)
        e1, f1, f2, e2 = time_ms(plain), time_ms(kern), time_ms(kern), time_ms(plain)
        nbytes, nops = work[name]
        t_bytes, t_ops = nbytes / PEAK_BYTES * 1e3, nops / PEAK_F32 * 1e3
        rec[name].update(ms=statistics.median([k1, k2]), plain_ms=statistics.median([p1, p2]),
                         bound_ms=max(t_bytes, t_ops),
                         bound_by="bytes" if t_bytes >= t_ops else "operations",
                         bound_copy_ms=nbytes / rate * 1e3, library_ms=None)
        lib = ""
        if name in library:
            rec[name]["library_ms"] = device_ms(library[name])
            lib = (f", one PyTorch call {rec[name]['library_ms']:.5f} ms "
                   f"(events {time_ms(library[name]):.4f})")
        print(f"time {name} (main-path shape, float32), device ms per call: kernel "
              f"{k1:.5f}/{k2:.5f}, plain {p1:.5f}/{p2:.5f}{lib}; events: kernel "
              f"{f1:.4f}/{f2:.4f}, plain {e1:.4f}/{e2:.4f}; bound {rec[name]['bound_ms']:.5f} ms "
              f"({rec[name]['bound_by']}: {nbytes} B, {nops} flop), "
              f"{rec[name]['bound_copy_ms']:.5f} ms at the measured copy rate [{label}]")
    return rec


def grid_sample_call(F, dep_j, dep_i):
    """F.grid_sample on a wrap-padded field: the same bilinear periodic
    interpolation as K2 for departure points folded into [0, H) × [0, W).
    Returns the timed call after checking it against the plain version."""
    import torch.nn.functional as Fn
    from qingdai_tpu_torch.ops import advect

    M, h, w = F.shape
    padded = torch.cat([F, F[:, :1]], dim=1)
    padded = torch.cat([padded, padded[:, :, :1]], dim=2)[None]      # [1, M, h+1, w+1]
    jj = torch.remainder(dep_j, h)
    ii = torch.remainder(dep_i, w)
    grid = torch.stack([2.0 * ii / w - 1.0, 2.0 * jj / h - 1.0], dim=-1)[None]

    def call():
        return Fn.grid_sample(padded, grid, mode="bilinear", padding_mode="border",
                              align_corners=True)

    diff = float((call()[0] - advect.bilinear_wrap_gather_multi(F, dep_j, dep_i)).abs().max())
    print(f"grid_sample against the plain K2: max|diff| {diff:.3e} (max|F| "
          f"{float(F.abs().max()):.1f})")
    return call


def finite(t: torch.Tensor) -> bool:
    return bool(torch.isfinite(t).all()) if t.is_floating_point() else True


class DailyCounts:
    """Counts the calls of the port's daily blocks while the path runs."""

    def __init__(self):
        from qingdai_tpu_torch.ecology import individuals, phyto, population
        self.targets = [(population, "eco_step_daily"), (individuals, "indiv_step_daily"),
                        (phyto, "phyto_step_daily")]
        self.counts = {name: 0 for _, name in self.targets}
        self.saved = [(mod, name, getattr(mod, name)) for mod, name in self.targets]
        for mod, name, fn in self.saved:
            setattr(mod, name, self._counting(name, fn))

    def _counting(self, name, fn):
        def wrapped(*args, **kwargs):
            self.counts[name] += 1
            return fn(*args, **kwargs)
        return wrapped

    def take(self) -> dict:
        out, self.counts = self.counts, {k: 0 for k in self.counts}
        return out

    def restore(self):
        for mod, name, fn in self.saved:
            setattr(mod, name, fn)


def run_path(env, steps, days, label, tag):
    """Build the path with no device argument, run ``days`` chunks of
    ``steps`` steps under sync-debug "error", time the last chunk; return
    (model, state, diags, per-chunk launch counts, per-chunk daily calls,
    ms/step)."""
    from qingdai_tpu_torch import entry, kernels
    from qingdai_tpu_torch import model as M

    t0 = time.perf_counter()
    mdl, st = entry.build_world(H, W, extra_env=env)
    if mdl.device.type != "cuda":
        raise AssertionError(f"build_world ran on {mdl.device}, not the card")
    chunk = M.make_chunk_fn(mdl, steps)
    torch.cuda.synchronize()
    print(f"{tag} built in {time.perf_counter() - t0:.2f} s: {H}x{W} float32, "
          f"{mdl.n_ocean_substeps} ocean substep(s), dt {mdl.dt:.0f} s, "
          f"eco {mdl.eco_static is not None}, phyto {mdl.phyto_static is not None}")
    counts, daily = [], []
    watch = DailyCounts()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for _ in range(days):
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            kernels.reset_launch_counts()
            a.record()
            st, diags = chunk(st)
            b.record()
            counts.append(kernels.launch_counts())
            daily.append(watch.take())
    finally:
        torch.cuda.set_sync_debug_mode("default")
        watch.restore()
    b.synchronize()
    return mdl, st, diags, counts, daily, a.elapsed_time(b) / steps


def check_run(st, diags, steps, eco):
    from qingdai_tpu_torch.convert import world_to_numpy

    state = world_to_numpy(st)
    bad = [k for k, v in state.items() if not isinstance(v, (int, float))
           and "alpha" not in k and v.dtype.kind == "f" and not np.isfinite(v).all()]
    bad += [k for k, v in diags.items() if not finite(v)]
    if bad:
        raise AssertionError(f"non-finite leaves: {bad}")
    for k, v in diags.items():
        if v.shape != (steps,):
            raise AssertionError(f"diag {k} has shape {tuple(v.shape)}")
    ts = diags["Ts_mean"].cpu().numpy()
    umax = float(diags["u_max"].max())
    if not (150.0 <= ts.min() and ts.max() <= 400.0 and umax <= 200.0):
        raise AssertionError(f"unphysical: Ts_mean in [{ts.min()}, {ts.max()}], u_max {umax}")
    if eco:
        for k in ("chl_mean", "lai_mean", "lai_max"):
            if float(diags[k].min()) < 0.0:
                raise AssertionError(f"diag {k} is negative")
    return ts, umax


def phase4_paths(label):
    from qingdai_tpu_torch.physics.orbital import T_PLANET

    # the main path: two planetary days, the second timed
    mdl, st, diags, counts, daily, ms_step = run_path(MAIN, STEPS_PER_DAY, 2, label, "main path")
    for day, c in enumerate(counts, 1):
        want = {name: per_step * STEPS_PER_DAY for name, _, _, per_step in KERNELS}
        if c != want:
            raise AssertionError(f"main path day {day}: launch counts {c} != {want}")
    # a fresh run's phytoplankton accumulator fires on step 1 and at the end
    # of each day; the ecology and individual-pool blocks at the end of each day
    want_daily = [{"eco_step_daily": 1, "indiv_step_daily": 1, "phyto_step_daily": 2},
                  {"eco_step_daily": 1, "indiv_step_daily": 1, "phyto_step_daily": 1}]
    if daily != want_daily:
        raise AssertionError(f"daily blocks ran {daily}, expected {want_daily}")
    print(f"main path launch counts per day: {counts[-1]} (3, 3, 1, 1 per step); "
          f"daily blocks per day: {daily}")
    ts, umax = check_run(st, diags, STEPS_PER_DAY, eco=True)
    syh = 3600.0 / (ms_step / 1000.0) * mdl.dt / T_PLANET
    print(f"day 2: Ts_mean {ts[-1]:.3f} K, TOA_net {float(diags['TOA_net'][-1]):.3f} W/m2, "
          f"u_max {umax:.2f} m/s, chl_mean {float(diags['chl_mean'][-1]):.5f}, "
          f"lai_mean {float(diags['lai_mean'][-1]):.4f}; all leaves and diags finite")
    print(f"main path 181x360 f32: {ms_step:.4f} ms/step, {syh:.3f} sim-years/hour [{label}]")

    # the path without ecology and phytoplankton: two days, the second timed
    _, st2, diags2, counts2, _, ms2 = run_path(SLICE, STEPS_PER_DAY, 2, label, "slice")
    want = {name: per_step * STEPS_PER_DAY for name, _, _, per_step in KERNELS}
    if any(c != want for c in counts2):
        raise AssertionError(f"slice: launch counts {counts2} != {want} a day")
    check_run(st2, diags2, STEPS_PER_DAY, eco=False)
    syh2 = 3600.0 / (ms2 / 1000.0) * mdl.dt / T_PLANET
    print(f"slice launch counts per day: {counts2[-1]}; "
          f"slice 181x360 f32: {ms2:.4f} ms/step, {syh2:.3f} sim-years/hour [{label}]")
    return st, counts[-1]


def _step_diffs(st, dtype, dev):
    """max|card − CPU| / max|CPU| per leaf and diag after one step of the main
    path from ``st`` converted to ``dtype``: over every row, and without the
    two pole rows."""
    from qingdai_tpu_torch import entry
    from qingdai_tpu_torch import model as M
    from qingdai_tpu_torch.convert import world_from_numpy, world_to_numpy

    def one_step(where):
        mdl, _ = entry.build_world(H, W, extra_env=MAIN, device=where, dtype=dtype)
        s1, d1 = M.make_step_fn(mdl)(world_from_numpy(st, where, dtype))
        flat = world_to_numpy(s1)
        flat.update({f"diag.{k}": v.cpu().numpy() for k, v in d1.items()})
        return flat

    G, C = one_step(dev), one_step("cpu")
    if G.pop("clock.step_idx") != C.pop("clock.step_idx"):
        raise AssertionError("step_idx differs")
    full, inner = {}, {}
    for k in C:
        c, g = np.asarray(C[k], np.float64), np.asarray(G[k], np.float64)
        fin = np.isfinite(c)
        if not np.array_equal(fin, np.isfinite(g)):
            raise AssertionError(f"{k}: finiteness differs between card and CPU")
        scale = max(float(np.max(np.abs(c[fin]), initial=0.0)), 1e-30)
        d = np.where(fin, np.abs(c - g), 0.0) / scale
        full[k] = float(d.max(initial=0.0))
        inner[k] = float(d[1:-1].max(initial=0.0)) if d.ndim == 2 else full[k]
    return full, inner


def phase5_cpu_reference(st, dev):
    """One step on the card and the same step on the CPU from one warm state.

    In float32 the pole rows are chaotic by construction: their cos cap of
    1e-6 puts the departure point ~5e5 cells upwind at 200 m/s, so one ulp of
    u moves it by cells. Those differences are printed; the bound of 1e-4 is
    held on the float64 step from the same state, which runs the float64
    instantiation of every kernel inside the step."""
    for dtype in (torch.float32, torch.float64):
        full, inner = _step_diffs(st, dtype, dev)
        top = sorted(full, key=lambda k: -full[k])[:8]
        print(f"card vs CPU, one {dtype} step, max|diff|/max|value| (all rows; without "
              "the pole rows): " + ", ".join(f"{k} {full[k]:.2e}; {inner[k]:.2e}" for k in top))
    worst = max(full.values())
    if worst > 1e-4:
        raise AssertionError(f"card and CPU float64 steps differ by {worst}")
    return worst


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    import qingdai_tpu_torch  # noqa: F401  (fails outside a checkout of the repo)
    from qingdai_tpu_torch.kernels import build

    dev = torch.device("cuda")
    label = card_label()
    print(f"card: {label}")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, python {sys.version.split()[0]}")
    try:
        import triton
        triton_version = triton.__version__
    except ImportError:
        triton_version = None
    try:
        nvcc = build.nvcc_path()
    except RuntimeError:
        nvcc = None
    print(f"nvcc: {nvcc}; triton: {triton_version}")
    rate = copy_rate(dev)
    print(f"device-to-device copy rate (clone of 1 GiB): {rate / 1e9:.1f} GB/s [{label}]")

    t0 = time.perf_counter()
    lib = build.build(verbose=True)
    build.load_library()
    print(f"kernels built in {time.perf_counter() - t0:.2f} s: {lib.name}")

    rec = phase3_kernels(dev, label, rate)
    st, counts = phase4_paths(label)
    worst = phase5_cpu_reference(st, dev)
    print(f"phase 5: card and CPU float64 steps agree to {worst:.2e} relative")

    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    kernels_line = [{"name": name, "route": "cuda", "source": src, "replaces": rep,
                     "launches": counts[name], **{k: rec[name][k] for k in keys}}
                    for name, src, rep, _ in KERNELS]
    print(f"card: {label}")
    print(json.dumps({"kernels": kernels_line}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
