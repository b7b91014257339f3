"""Drive the PyTorch / CUDA port's main path once on one NVIDIA card.

    python3 chip_smoke.py

Phases, each of which raises on failure (exit code non-zero):
  1. the card (nvidia-smi name and power limit), torch and CUDA versions, and
     whether nvcc and triton are present; the card's device-to-device copy
     rate (clone of a 1 GiB tensor);
  2. build the four CUDA kernels from ``qingdai_tpu_torch/csrc`` (one nvcc per
     source, in parallel) and print ptxas' register report;
  3. each kernel against its plain PyTorch version on the card, float32 and
     float64, at the main path's shapes (K1 bit-equal on the fields of
     ``k1_cases`` and a 721×1440 field; K2's departure points bit-equal to
     ``departure_indices`` and its stack within tolerance, ``k2_check``),
     with the kernel's, the plain version's and (where one exists) one
     PyTorch call's times, in the order plain, kernel, kernel, plain: device
     time per call (the card's kernel times under torch.profiler over 20
     calls), which the JSON line reports, and CUDA-event time of one call
     (median of 50), which includes the host's launch while the card waits;
     each kernel's time before its redesign beside, and its device
     launches a call; then K1's and K4's stages from their own stamps
     (``k1_anatomy``, ``k4_anatomy``), and one call of K3 and of K4
     captured in a CUDA graph, whose replay and a second eager call must
     equal the first eager call bit for bit (``graph_replay``); then the
     four batched forms (one launch for an ensemble's members) at B = 8:
     each member bit-equal to its single call (float32 and float64, each
     member's own inputs and shared ones), each within ``BATCHED_TOL`` of
     its batched plain version, and timed beside the plain version, eight
     single calls and one PyTorch call where one exists (``phase3_batched``);
  4. the main path, the flagship planet of ``__graft_entry__.entry()`` (the
     default configuration: 181×360, float32, ecology, the individual pool,
     phytoplankton and river routing on), built with no device argument: one
     planetary day of 240 steps, then a second, timed one, both with host
     syncs turned into errors; state and diags must be finite and physical,
     the launch counters must grow by exactly 3, 3, 1 and 1 per step, the
     daily blocks must run once a day and the routing event exactly 3 times
     a day, with its six diags finite and its closure identity holding; two
     routing events from one buffer must give the same bits. Then the
     planet without routing (the main path before routing was ported) and
     the path without ecology and phytoplankton (the slice of the first
     bring-up), two shorter chunks each, with their own launch counts;
 4b. the ensemble path (``qingdai_tpu_torch.ensemble``): the flagship planet
     with 1, 2, 4 and 8 members, each a warm chunk and a timed day under
     sync-debug "error" with functorch's per-member fallback an error; the
     batched forms must launch 3, 3, 1 and 1 times a step and the single
     forms never, every member must be finite and physical; ms/step, per
     member, member·sim-years/hour, device launches and device ms a step
     (a profiled routing period); member 0 of B = 8 against the single
     planet over the same steps, within ``ENSEMBLE_F32_REL``;
  5. one float64 step of the main path on the card against the same step on
     the CPU from the same warm state, with the routing clock one step
     before an event, so the compared step routes;
  6. the world driver, ``QingdaiWorld``, in a temporary working directory on
     the flagship planet (mutation on): 210 steps through ``run()``, an
     autosave, 36 more; a fresh world resumes from the sidecar and runs the
     36 (across the routing event at step 216 and the day's end at 240,
     where mutation draws from the restored generator), and its state must
     equal the uninterrupted run's bit for bit. The card's machine has no
     NetCDF library (h5py, netCDF4), so the autosave writes the sidecar and
     the JSON files and skips the NetCDF set, and the resume reads the
     sidecar alone.
The line before the last is the kernels' JSON record, the four single forms
(launches from phase 4's main path) and the four batched forms (launches
from phase 4b's day at B = 8); the last line is
``{"ok": true, "device": {...}}``.
"""

import functools
import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

MAIN = {}                                   # the flagship planet: every default on
PLANET = {"QD_HYDRO_ENABLE": "0"}
SLICE = {"QD_ECO_ENABLE": "0", "QD_PHYTO_ENABLE": "0", "QD_HYDRO_ENABLE": "0"}
H, W = 181, 360
STEPS_PER_DAY = 240
EVENTS_PER_DAY = 3                          # QD_HYDRO_DT_HOURS 6 h at dt 300 s
SHORT_STEPS = 120                           # a chunk of the two other paths
ENSEMBLE_B = 8                              # the batched forms' members in phase 3
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
# device ms per call of each kernel before its redesign (K1 one-block radix
# select; K2 departure points from separate PyTorch launches; K3 four
# global-memory launches a substep; K4 one thread per cell with nine grid
# barriers a substep), this script's phase 3 on an NVIDIA H100 80GB HBM3 at 700 W
BEFORE_REDESIGN = {"median_pos": 0.09444, "advect_bilinear": 0.00264, "hyper4": 0.01442,
                   "ocean_substeps": 0.03322}
BEFORE_REDESIGN_CARD = "NVIDIA H100 80GB HBM3, 700.00 W"


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


# torch.profiler loses the device events of kernels launched within the
# first few milliseconds after it starts: a profile may come back short or
# empty (PERF.md §7, scripts/profiler_check.py). So a profile idles this
# long before its first call. A profile that still holds no device event is
# printed, with what it did hold, and taken again; a function with
# PROFILE_TRIES empty profiles in a row raises.
PROFILE_WAIT_S = 0.05
PROFILE_TRIES = 3
# profiles taken, and (what, host events, launch calls) of each empty one
PROFILE_LOG = {"taken": 0, "empty": []}


def take_profile(fn, reps=20, pads=(PROFILE_WAIT_S, 0.0)):
    """One torch.profiler profile of ``reps`` calls of ``fn``, with ``pads``
    seconds of idle time inside it before the first call and after the card
    has finished the last: (device events, host events)."""
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        time.sleep(pads[0])
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        time.sleep(pads[1])
    PROFILE_LOG["taken"] += 1
    events = prof.events()
    return ([e for e in events if e.device_type == torch.autograd.DeviceType.CUDA],
            [e for e in events if e.device_type == torch.autograd.DeviceType.CPU])


def device_profile(fn, reps=20, what="a function"):
    """(device ms, device launches) of one call: the card's kernel (and
    memset/copy) times and count under torch.profiler over ``reps`` calls,
    per call."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    for attempt in range(1, PROFILE_TRIES + 1):
        events, host = take_profile(fn, reps)
        us = sum(e.time_range.elapsed_us() for e in events)
        if us > 0.0:
            return us / reps / 1e3, len(events) / reps
        launch_calls = sum("Launch" in e.name for e in host)
        PROFILE_LOG["empty"].append((what, len(host), launch_calls))
        print(f"torch.profiler: no device event in profile {attempt} of {PROFILE_TRIES} of "
              f"{what} ({len(host)} host events, {launch_calls} of them launch calls)",
              flush=True)
    raise AssertionError(f"the profiler saw no device time in {PROFILE_TRIES} profiles of {what}")


def device_ms(fn, reps=20, what="a function"):
    """Device time of one call (``device_profile``)."""
    return device_profile(fn, reps, what)[0]


def copy_rate(dev) -> float:
    """Device-to-device copy rate in bytes/s: clone of a 1 GiB tensor reads
    and writes 1 GiB each."""
    x = torch.empty(1 << 28, dtype=torch.float32, device=dev)
    ms = time_ms(lambda: x.clone(), reps=10)
    del x
    return 2.0 * (1 << 30) / (ms * 1e-3)


def on(dev, x, dtype):
    return torch.as_tensor(np.asarray(x)).to(device=dev, dtype=dtype)


def k4_operands(dev, dtype, n_tracers, n_sub, k4_nsub, K_h, seed=4, shape=(H, W)):
    """K4's operands on a grid of ``shape`` (181×360 unless given) from a
    seeded state: 30% land, 15% ice, a fifth of the ocean with currents near
    the 3 m/s cap (some above it, so the mean4 repair runs)."""
    from qingdai_tpu_torch import ocean
    from qingdai_tpu_torch.config import OceanConfig
    from qingdai_tpu_torch.grid import make_grid
    from qingdai_tpu_torch.state import OceanState

    r = np.random.default_rng(seed)
    speed = np.where(r.random(shape) < 0.2, r.uniform(2.6, 3.4, shape),
                     np.abs(r.normal(0.0, 0.6, shape)))
    theta = r.uniform(0.0, 2.0 * np.pi, shape)
    g = make_grid(*shape, device=dev, dtype=dtype)
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


def k1_cases(r, dtype, shape=(H, W)):
    """K1's fields: the main path's kinds and the edges of ``x > 0`` (−0.0,
    denormals, NaN, ±inf, one or two positives, one binade, all positive)."""
    base = r.standard_normal(shape)
    n = base.size
    tiny = 2.0 ** (-149 if dtype == torch.float32 else -1074)     # least denormal
    neg = -np.abs(base)
    one, two, special, inf_most = neg.copy(), neg.copy(), base.copy(), base.copy()
    one.flat[r.integers(n)] = 3.5
    two.flat[r.choice(n, 2, replace=False)] = [2.25, 7.5]
    special.flat[r.choice(n, 600, replace=False)] = np.repeat([np.inf, -np.inf, np.nan], 200)
    inf_most[r.random(shape) < 0.5] = np.inf                        # the median is +inf
    kind = r.random(shape)
    return {
        "random": base,
        "precip": np.where(r.random(shape) < 0.6, 0.0, np.abs(base) * 1e-5),
        "odd": np.where(np.arange(n).reshape(shape) == 0, 0.0, np.abs(base) + 0.1),
        "even": np.abs(base) + 0.1,
        "ties": r.integers(-3, 5, shape).astype(np.float64),
        "fallback": neg,
        "neg_zero": np.where(r.random(shape) < 0.5, -0.0, np.abs(base)),
        "denormal": np.where(kind < 0.3, 0.0, np.where(kind < 0.4, np.abs(base),
                                                       r.integers(1, 1 << 20, shape) * tiny)),
        "one_pos": one,
        "two_pos": two,
        "inf_nan": special,
        "inf_median": inf_most,
        "one_binade": np.where(r.random(shape) < 0.6, 0.0, 2.0 ** -17 * (1.0 + r.random(shape))),
        "all_pos": np.exp(r.uniform(-80.0, 80.0, shape)),
    }


def k2_check(dev, dtype, M, case, r, tol):
    """One K2 case on the card: the kernel's departure points bit-equal to
    ``departure_indices``, the stack within tol · max|F| of the plain version,
    and ``advect_semilag_multi`` launching the kernel. Cases: "winds", random
    winds capped at 200 m/s; "poles", the pole rows at 150–200 m/s, whose
    departures lie ~4e5–5.4e5 cells away under the 1e-6 cos cap; "far", a cos
    cap of 1e-12, departures beyond 2^30 cells. Returns (max|err|, dep_j)."""
    from qingdai_tpu_torch import constants as const
    from qingdai_tpu_torch.grid import make_grid
    from qingdai_tpu_torch.kernels.advect_bilinear import advect_bilinear_cuda
    from qingdai_tpu_torch.ops import advect

    g = make_grid(H, W, device=dev, dtype=dtype)
    F = on(dev, 280.0 + 20.0 * r.standard_normal((M, H, W)), dtype)
    u = np.clip(120.0 * r.standard_normal((H, W)), -200, 200)
    v = np.clip(120.0 * r.standard_normal((H, W)), -200, 200)
    cos = g.coslat_cap_tiny
    if case == "poles":
        u[[0, -1]] = r.choice([-1.0, 1.0], (2, W)) * r.uniform(150.0, 200.0, (2, W))
    elif case == "far":
        cos = torch.clamp(g.coslat, min=1e-12)
    u, v = on(dev, u, dtype), on(dev, v, dtype)
    args = (300.0, const.PLANET_RADIUS, g.dlat_rad, g.dlon_rad, cos)
    got, dj, di = advect_bilinear_cuda(F, u, v, *args, departures=True)
    rj, ri = advect.departure_indices((H, W), u, v, *args, dtype)
    for name, a_, b_ in (("dep_j", dj, rj), ("dep_i", di, ri)):
        if not torch.equal(a_, b_):
            bad = int((a_ != b_).sum())
            raise AssertionError(f"K2 {dtype} M={M} {case}: {name} differs from "
                                 f"departure_indices in {bad} cells")
    reach = float((ri - torch.arange(W, device=dev, dtype=dtype)).abs().max())
    want = {"poles": 2.0 ** 16, "far": 2.0 ** 30}.get(case, 0.0)
    if not reach > want:
        raise AssertionError(f"K2 {case}: departures reach only {reach} cells")
    ref = advect.bilinear_wrap_gather_multi(F, rj, ri)
    err = float((got - ref).abs().max())
    if not err <= tol * float(F.abs().max()):
        raise AssertionError(f"K2 {dtype} M={M} {case}: max|err| {err} > {tol} * max|F|")
    before = advect_bilinear_cuda.launches
    if not torch.equal(advect.advect_semilag_multi(F, u, v, *args), got):
        raise AssertionError(f"K2 {dtype} M={M} {case}: advect_semilag_multi differs")
    if advect_bilinear_cuda.launches != before + 1:
        raise AssertionError("advect_semilag_multi did not launch K2")
    return err, dj


# the kernels whose one input a member may share (K1's field, K2's stack,
# K3's k4 maps, K4's geometry); the ensemble path shares K3's k4 maps alone
SHAREABLE = ("median_pos", "advect_bilinear", "hyper4", "ocean_substeps")
ENSEMBLE_SHARES = ("hyper4",)


def batched_pairs(dev, dtype, B, shared=(), n_sub=2, seed=7):
    """The four batched forms at the main path's shapes for ``B`` members,
    each beside its B single calls and its batched plain version (the plain
    version under ``torch.func.vmap``, as the CPU runs it):
    {name: (batched call, [single calls], batched plain call)}.
    Every member has its own inputs (K1's last member has nothing positive,
    so it takes the fallback), except the one input of each kernel named in
    ``shared`` (``SHAREABLE``), which is given once without the member axis,
    as ``torch.func.vmap`` leaves an unbatched input. K3 and K4 run ``n_sub``
    substeps (two: the ping-pong buffers hold every member)."""
    from qingdai_tpu_torch import constants as const
    from qingdai_tpu_torch import ocean
    from qingdai_tpu_torch.grid import make_grid
    from qingdai_tpu_torch.kernels.advect_bilinear import (advect_bilinear_batched_cuda,
                                                           advect_bilinear_cuda)
    from qingdai_tpu_torch.kernels.hyper4 import hyperdiffuse_batched_cuda, hyperdiffuse_cuda
    from qingdai_tpu_torch.kernels.median_pos import median_pos_batched_cuda, median_pos_cuda
    from qingdai_tpu_torch.kernels.ocean_substeps import (ocean_substeps_batched_cuda,
                                                          ocean_substeps_cuda)
    from qingdai_tpu_torch.ops import advect, reductions, stencil

    def plain_vmap(fn, in_dims, *args):
        return torch.func.vmap(fn, in_dims=in_dims, randomness="error")(*args)

    r = np.random.default_rng(seed)
    A = const.PLANET_RADIUS
    g = make_grid(H, W, device=dev, dtype=dtype)
    sc = (300.0, A, g.dlat_rad, g.dlon_rad)
    sh = {name: name in shared for name in SHAREABLE}

    def one(t, name):
        """t's member 0 alone where ``name`` shares it."""
        return t[0].contiguous() if sh[name] else t

    def at(t, name, b):
        return t if sh[name] else t[b]

    def dim(name):
        return None if sh[name] else 0

    x = on(dev, np.where(r.random((B, H, W)) < 0.6, 0.0,
                         np.abs(r.standard_normal((B, H, W))) * 1e-5), dtype)
    x[-1] = -x[-1] - 1.0
    x = one(x, "median_pos")
    F2 = one(on(dev, 280.0 + 20.0 * r.standard_normal((B, 2, H, W)), dtype), "advect_bilinear")
    u = on(dev, np.clip(60.0 * r.standard_normal((B, H, W)), -200, 200), dtype)
    v = on(dev, np.clip(30.0 * r.standard_normal((B, H, W)), -200, 200), dtype)
    cos = g.coslat_cap_tiny
    F5 = on(dev, 30.0 * r.standard_normal((B, 5, H, W)), dtype)
    k4 = one(((0.02 * g.k4_map_unit / 300.0)[None]
              * on(dev, r.uniform(0.25, 1.0, (B, 5, 1, 1)), dtype)).contiguous(), "hyper4")
    ops = [k4_operands(dev, dtype, N_SPECIES, n_sub, 1, 5.0e3, seed=seed + b) for b in range(B)]
    params = ops[0][4]
    mom, st, forc, geo = (torch.stack([o[i] for o in ops]) for i in range(4))
    geo = one(geo, "ocean_substeps")
    k3 = (300.0, n_sub, g.dlat_rad, g.dlon_rad, g.coslat_cap_02, A)

    singles = {
        "median_pos": lambda b: median_pos_cuda(at(x, "median_pos", b), 1e-6),
        "advect_bilinear": lambda b: advect_bilinear_cuda(at(F2, "advect_bilinear", b), u[b],
                                                          v[b], *sc, cos),
        "hyper4": lambda b: hyperdiffuse_cuda(F5[b], at(k4, "hyper4", b), *k3),
        "ocean_substeps": lambda b: ocean_substeps_cuda(mom[b], st[b], forc[b],
                                                        at(geo, "ocean_substeps", b), **params),
    }
    batched = {
        "median_pos": lambda: median_pos_batched_cuda(x, B, 1e-6),
        "advect_bilinear": lambda: advect_bilinear_batched_cuda(F2, u, v, *sc, cos, B),
        "hyper4": lambda: hyperdiffuse_batched_cuda(F5, k4, *k3, B),
        "ocean_substeps": lambda: ocean_substeps_batched_cuda(mom, st, forc, geo, B, **params),
    }
    plain = {
        "median_pos": lambda: plain_vmap(reductions.masked_median_of_positive_ref,
                                         (dim("median_pos"), None), x, 1e-6),
        "advect_bilinear": lambda: plain_vmap(advect.advect_semilag_multi_ref,
                                              (dim("advect_bilinear"), 0, 0) + (None,) * 5,
                                              F2, u, v, *sc, cos),
        "hyper4": lambda: plain_vmap(stencil.hyperdiffuse_multi_ref,
                                     (0, dim("hyper4")) + (None,) * 6, F5, k4, *k3),
        "ocean_substeps": lambda: plain_vmap(
            lambda m_, s_, f_, g_: ocean.ocean_substeps_plain(m_, s_, f_, g_, **params),
            (0, 0, 0, dim("ocean_substeps")), mom, st, forc, geo),
    }
    def k2_library():
        dj, di = advect.departure_indices((H, W), u, v, *sc, cos, dtype)
        return grid_sample_call(F2 if F2.dim() == 4 else F2.expand(B, 2, H, W), dj, di)

    return {name: (batched[name], [functools.partial(singles[name], b) for b in range(B)],
                   plain[name], k2_library if name == "advect_bilinear" else None)
            for name in SHAREABLE}


def batched_equal(pairs, label=""):
    """Each batched form against its single calls, bit for bit."""
    for name, (batched, singles, _, _) in pairs.items():
        got = batched()
        for b, single in enumerate(singles):
            ref = single()
            same = (all(torch.equal(x[b], y) for x, y in zip(got, ref)) if isinstance(ref, tuple)
                    else torch.equal(got[b], ref))
            if not same:
                raise AssertionError(f"{name} batched {label}: member {b} differs from its "
                                     "single call")


def kernel_work(name, n_members=1, shared=()):
    """(bytes, float operations) of one call at the main path's shapes in
    float32 for ``n_members`` members: each input read once, each output
    written once, an input the members share (K2's and K3's cos maps, and
    the kernels named in ``shared``: K3's k4 maps) once for all."""
    HW, f4, B = H * W, 4, n_members
    n_st = 1 + N_SPECIES
    if name == "median_pos":
        return B * (HW + 1) * f4, B * 2 * HW
    if name == "advect_bilinear":               # M = 2: stack in and out, u, v; cos
        return (B * (2 * 2 + 2) + 1) * HW * f4, B * (19 + 2 * 7) * HW
    if name == "hyper4":                        # M = 5: F in and out, k4; cos
        k4 = 5 * (1 if name in shared else B)
        return (B * 5 * 2 + k4 + 1) * HW * f4, B * 5 * 70 * HW
    return (B * (3 + n_st + 3 + 12 + 3 + n_st) * HW * f4,
            B * (60 + 3 * 70 + 7 * n_st + 60) * HW)


def bound(nbytes, nops, rate) -> dict:
    """The least time of a call at the published peaks, which of the two
    bounds it, and the bytes' time at the measured copy rate."""
    t_bytes, t_ops = nbytes / PEAK_BYTES * 1e3, nops / PEAK_F32 * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bound_copy_ms": nbytes / rate * 1e3}


def k1_stage_names(slots):
    """Names of the stages between K1's ``slots`` trace stamps."""
    passes = (slots - 2) // 2
    names = []
    for p in range(1, passes + 1):
        hist = "load + histogram" if p == 1 else f"pass {p} histogram"
        if 1 < p < passes:
            hist += " + compaction"
        names += [hist, f"pass {p} cluster merge + digit search"]
    return names + ["result + exit barrier"]


def k1_anatomy(x, kernel_ms, label, reps=50):
    """Where K1's time goes: the first block's stage boundaries over ``reps``
    traced launches (global timer in ns, SM cycles), as mean µs per stage;
    the rest of the device time per call is launch and teardown."""
    from qingdai_tpu_torch.kernels.median_pos import median_pos_cuda, trace_slots

    slots = trace_slots(x.dtype)
    traces = torch.zeros((reps, 2, slots), dtype=torch.int64, device=x.device)
    for k in range(reps):
        median_pos_cuda(x, 1e-6, trace=traces[k])
    t = traces.double().cpu().numpy()
    d_ns = np.diff(t[:, 0], axis=1).mean(axis=0)
    d_cyc = np.diff(t[:, 1], axis=1).mean(axis=0)
    names = k1_stage_names(slots)
    inside = float(d_ns.sum()) / 1e3
    parts = ", ".join(f"{nm} {ns / 1e3:.3f} us ({cyc:.0f} cycles)"
                      for nm, ns, cyc in zip(names, d_ns, d_cyc))
    print(f"K1 anatomy ({x.dtype}, {tuple(x.shape)}, mean of {reps} traced launches): {parts}; "
          f"inside the kernel {inside:.3f} us of {kernel_ms * 1e3:.3f} us device time, "
          f"the rest launch and teardown; SM clock {d_cyc.sum() / d_ns.sum():.3f} GHz [{label}]")


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
        cases = k1_cases(r, dtype)
        # a field whose eighth exceeds K1's shared-memory stage
        big = (721, 1440)
        cases["precip_721x1440"] = np.where(r.random(big) < 0.6, 0.0,
                                            np.abs(r.standard_normal(big)) * 1e-5)
        for case, x in cases.items():
            xt = on(dev, x, dtype)
            got = reductions.masked_median_of_positive(xt, 1e-6)
            ref = reductions.masked_median_of_positive_ref(xt, 1e-6)
            if not torch.equal(got, ref):
                raise AssertionError(f"K1 {case} {dtype}: {float(got)!r} != {float(ref)!r}")
        print(f"K1 median_pos {dtype}: bit-equal on {sorted(cases)}")

        # K2: the kernel's departure points bit-equal to departure_indices,
        # the advected stack within tol · max|F| of the plain version
        tol = 1e-6 if dtype == torch.float32 else 1e-12
        for M, case in ((1, "winds"), (2, "winds"), (11, "winds"), (2, "poles"), (1, "far")):
            err, dj = k2_check(dev, dtype, M, case, r, tol)
            if dtype == torch.float32:
                rec["advect_bilinear"]["max_abs_err"] = max(rec["advect_bilinear"]["max_abs_err"],
                                                            err)
            print(f"K2 advect_bilinear {dtype} M={M} {case}: departure points bit-equal, "
                  f"max|err| {err:.3e}, dep_j min {float(dj.min()):.2f}")

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
    cos = g.coslat_cap_tiny
    dj, di = advect.departure_indices((H, W), u, v, 300.0, A, g.dlat_rad, g.dlon_rad, cos,
                                      torch.float32)
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
        "advect_bilinear": (lambda: advect_bilinear_cuda(F2, u, v, 300.0, A, g.dlat_rad,
                                                         g.dlon_rad, cos),
                            lambda: advect.bilinear_wrap_gather_multi(F2, *advect.departure_indices(
                                (H, W), u, v, 300.0, A, g.dlat_rad, g.dlon_rad, cos,
                                torch.float32))),
        "hyper4": (lambda: hyperdiffuse_cuda(F5, k4, 300.0, 1, g.dlat_rad, g.dlon_rad,
                                             g.coslat_cap_02, A),
                   lambda: stencil.hyperdiffuse_multi_ref(F5, k4, 300.0, 1, g.dlat_rad,
                                                          g.dlon_rad, g.coslat_cap_02, A)),
        "ocean_substeps": (lambda: ocean_substeps_cuda(mom, st, forc, geo, **params),
                           lambda: ocean.ocean_substeps_plain(mom, st, forc, geo, **params)),
    }
    # one PyTorch call computing the same function, where there is one
    library = {"advect_bilinear": grid_sample_call(F2, dj, di)}
    for name, (kern, plain) in pairs.items():
        # plain, kernel, kernel, plain: compare within one call, in turns
        p1, (k1, n_dev), k2, p2 = (device_ms(plain, what=f"{name}'s plain version"),
                                   device_profile(kern, what=f"kernel {name}"),
                                   device_ms(kern, what=f"kernel {name}"),
                                   device_ms(plain, what=f"{name}'s plain version"))
        e1, f1, f2, e2 = time_ms(plain), time_ms(kern), time_ms(kern), time_ms(plain)
        nbytes, nops = kernel_work(name)
        rec[name].update(ms=statistics.median([k1, k2]), plain_ms=statistics.median([p1, p2]),
                         **bound(nbytes, nops, rate), library_ms=None)
        lib = ""
        if name in library:
            rec[name]["library_ms"] = device_ms(library[name],
                                                    what=f"{name}'s PyTorch call")
            lib = (f", one PyTorch call {rec[name]['library_ms']:.5f} ms "
                   f"(events {time_ms(library[name]):.4f})")
        if name in BEFORE_REDESIGN:
            lib += (f", before the redesign {BEFORE_REDESIGN[name]:.5f} ms "
                    f"[{BEFORE_REDESIGN_CARD}]")
        print(f"time {name} (main-path shape, float32), device ms per call: kernel "
              f"{k1:.5f}/{k2:.5f} ({n_dev:g} device launches a call), plain "
              f"{p1:.5f}/{p2:.5f}{lib}; events: kernel "
              f"{f1:.4f}/{f2:.4f}, plain {e1:.4f}/{e2:.4f}; bound {rec[name]['bound_ms']:.5f} ms "
              f"({rec[name]['bound_by']}: {nbytes} B, {nops} flop), "
              f"{rec[name]['bound_copy_ms']:.5f} ms at the measured copy rate [{label}]")
    phase3_batched(dev, label, rate, rec)
    k1_anatomy(x, rec["median_pos"]["ms"], label)
    k4_anatomy(mom, st, forc, geo, params, rec["ocean_substeps"]["ms"], label)
    graph_replay(pairs["hyper4"][0], pairs["ocean_substeps"][0])
    print(f"torch.profiler: {len(PROFILE_LOG['empty'])} of {PROFILE_LOG['taken']} profiles held "
          f"no device event and were taken again: {PROFILE_LOG['empty']}")
    return rec


# the batched forms against their batched plain versions (float32), each
# output's max|err| within this share of the plain output's max|value|
# (K4 per plane): the single forms' stated tolerances, on that scale
BATCHED_TOL = {"median_pos": 0.0, "advect_bilinear": 1e-6, "hyper4": 1e-5,
               "ocean_substeps": 1e-4}


def phase3_batched(dev, label, rate, rec):
    """The batched forms at B = ``ENSEMBLE_B``: bit-equal to B single calls
    in float32 and float64, with each member's own inputs and with the
    shareable ones shared; then on the ensemble path's shapes in float32
    (K3's k4 maps shared, one substep) against the batched plain version,
    and timed: device ms a call (plain, kernel, B single calls, kernel,
    plain), a member, and one PyTorch call where one exists."""
    for dtype in (torch.float32, torch.float64):
        for shared in ((), SHAREABLE):
            batched_equal(batched_pairs(dev, dtype, ENSEMBLE_B, shared),
                          f"{dtype} B={ENSEMBLE_B} shared={shared}")
    print(f"batched forms at B={ENSEMBLE_B}: each member bit-equal to its single call, float32 "
          "and float64, own and shared inputs, K3 and K4 two substeps")
    for name, (batched, singles, plain, library) in batched_pairs(
            dev, torch.float32, ENSEMBLE_B, ENSEMBLE_SHARES, n_sub=1).items():
        bname = name + "_batched"
        got, ref = batched(), plain()
        pairs = zip(got, ref) if isinstance(ref, tuple) else [(got, ref)]
        err = 0.0
        for g_, r_ in pairs:
            for b in range(ENSEMBLE_B):
                planes = [(g_[b], r_[b])] if r_.dim() <= 3 else list(zip(g_[b], r_[b]))
                for gp, rp in planes:
                    e = float((gp - rp).abs().max())
                    if not e <= BATCHED_TOL[name] * float(rp.abs().max()):
                        raise AssertionError(f"{bname}: member {b} max|err| {e} against the "
                                             "batched plain version")
                    err = max(err, e)

        def all_singles(singles=singles):
            return [f() for f in singles]

        p1, (k1, n_dev), s1, k2, p2 = (
            device_ms(plain, what=f"{bname}'s plain version"),
            device_profile(batched, what=f"kernel {bname}"),
            device_ms(all_singles, what=f"{ENSEMBLE_B} single calls of {name}"),
            device_ms(batched, what=f"kernel {bname}"),
            device_ms(plain, what=f"{bname}'s plain version"))
        ms = statistics.median([k1, k2])
        nbytes, nops = kernel_work(name, ENSEMBLE_B, ENSEMBLE_SHARES)
        rec[bname] = {"max_abs_err": err, "ms": ms, "plain_ms": statistics.median([p1, p2]),
                      **bound(nbytes, nops, rate), "library_ms": None, "singles_ms": s1}
        lib = ""
        if library is not None:
            rec[bname]["library_ms"] = device_ms(library(), what=f"{bname}'s PyTorch call")
            lib = f", one PyTorch call {rec[bname]['library_ms']:.5f} ms"
        print(f"time {bname} (B={ENSEMBLE_B}, the ensemble path's shapes, float32), device ms "
              f"per call: kernel {k1:.5f}/{k2:.5f} ({n_dev:g} device launches a call), "
              f"{ms / ENSEMBLE_B:.5f} a member; {ENSEMBLE_B} single calls {s1:.5f} "
              f"({s1 / ms:.2f}x the batched call); plain (vmapped) {p1:.5f}/{p2:.5f}{lib}; "
              f"max|err| against it {err:.3e}; bound {rec[bname]['bound_ms']:.5f} ms "
              f"({rec[bname]['bound_by']}: {nbytes} B, {nops} flop) [{label}]")


def k4_anatomy(mom, st, forc, geo, params, kernel_ms, label, reps=50):
    """Where K4's time goes: the middle tile's block over ``reps`` traced
    launches, per stage (SM cycles at the clock measured over the tile
    pass), and the grid-wide dependency and finish by the global timer (the
    finish may run on another SM). One grid-wide dependency a substep."""
    from qingdai_tpu_torch.kernels.ocean_substeps import (TRACE_SLOTS, TRACE_STAGES,
                                                          ocean_substeps_cuda)

    traces = torch.zeros((reps, 2, TRACE_SLOTS), dtype=torch.int64, device=mom.device)
    for k in range(reps):
        ocean_substeps_cuda(mom, st, forc, geo, **params, trace=traces[k])
    t = traces.double().cpu().numpy()
    d_ns = np.diff(t[:, 0], axis=1).mean(axis=0)
    d_cyc = np.diff(t[:, 1], axis=1).mean(axis=0)
    tile = len(TRACE_STAGES) - 2                   # the tile pass's stages
    ghz = d_cyc[:tile].sum() / d_ns[:tile].sum()
    parts = [f"{nm} {cyc / ghz / 1e3:.3f} us ({cyc:.0f} cycles)"
             for nm, cyc in zip(TRACE_STAGES[:tile], d_cyc[:tile])]
    parts += [f"{nm} {ns / 1e3:.3f} us (global timer)"
              for nm, ns in zip(TRACE_STAGES[tile:], d_ns[tile:])]
    inside = float(d_ns.sum()) / 1e3
    print(f"K4 anatomy (float32, {tuple(st.shape)}, mean of {reps} traced launches, one "
          f"grid-wide dependency a substep): {', '.join(parts)}; stamped span {inside:.3f} us "
          f"of {kernel_ms * 1e3:.3f} us device time; SM clock {ghz:.3f} GHz [{label}]")


def graph_replay(*calls):
    """Capture one call of each kernel in a CUDA graph, replay it, and require
    the replay to equal an eager call bit for bit."""
    for call in calls:
        eager, again = call(), call()
        torch.cuda.synchronize()
        if not all(torch.equal(a, b) for a, b in zip(eager, again)):
            raise AssertionError("two eager calls differ")
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            captured = call()
        graph.replay()
        torch.cuda.synchronize()
        if not all(torch.equal(a, b) for a, b in zip(eager, captured)):
            raise AssertionError("a CUDA graph replay differs from the eager call")
    print(f"CUDA graph: {len(calls)} kernels (K3, K4) captured; replays bit-equal to eager "
          "calls, two eager calls bit-equal")


def grid_sample_call(F, dep_j, dep_i):
    """F.grid_sample on a wrap-padded field: the same bilinear periodic
    interpolation as K2 for departure points folded into [0, H) × [0, W).
    F [M, H, W] with points [H, W], or a batch of members, F [B, M, H, W]
    with points [B, H, W] (one call for all). Returns the timed call after
    checking it against the plain version."""
    import torch.nn.functional as Fn
    from qingdai_tpu_torch.ops import advect

    if F.dim() == 3:
        F, dep_j, dep_i = F[None], dep_j[None], dep_i[None]
    h, w = F.shape[-2:]
    padded = torch.cat([F, F[:, :, :1]], dim=2)
    padded = torch.cat([padded, padded[:, :, :, :1]], dim=3)          # [B, M, h+1, w+1]
    jj = torch.remainder(dep_j, h)
    ii = torch.remainder(dep_i, w)
    grid = torch.stack([2.0 * ii / w - 1.0, 2.0 * jj / h - 1.0], dim=-1)

    def call():
        return Fn.grid_sample(padded, grid, mode="bilinear", padding_mode="border",
                              align_corners=True)

    got = call()
    diff = max(float((got[b] - advect.bilinear_wrap_gather_multi(F[b], dep_j[b], dep_i[b]))
                     .abs().max()) for b in range(F.shape[0]))
    print(f"grid_sample against the plain K2 ({F.shape[0]} member(s)): max|diff| {diff:.3e} "
          f"(max|F| {float(F.abs().max()):.1f})")
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
    per-chunk routing events, ms/step)."""
    from qingdai_tpu_torch import entry, kernels, routing
    from qingdai_tpu_torch import model as M

    t0 = time.perf_counter()
    mdl, st = entry.build_world(H, W, extra_env=env)
    if mdl.device.type != "cuda":
        raise AssertionError(f"build_world ran on {mdl.device}, not the card")
    chunk = M.make_chunk_fn(mdl, steps)
    torch.cuda.synchronize()
    rs = mdl.routing_static
    print(f"{tag} built in {time.perf_counter() - t0:.2f} s: {H}x{W} float32, "
          f"{mdl.n_ocean_substeps} ocean substep(s), dt {mdl.dt:.0f} s, "
          f"eco {mdl.eco_static is not None}, phyto {mdl.phyto_static is not None}, "
          + (f"routing on ({int(rs.land_flat.sum())} land cells, {rs.n_lakes} lakes, "
             f"{rs.n_levels} levels, {len(rs.rounds)} rounds)" if rs is not None
             else "routing off"))
    counts, daily, events = [], [], []
    watch = DailyCounts()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for _ in range(days):
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            kernels.reset_launch_counts()
            routing.route_event.events = 0
            a.record()
            st, diags = chunk(st)
            b.record()
            counts.append(kernels.launch_counts())
            daily.append(watch.take())
            events.append(routing.route_event.events)
    finally:
        torch.cuda.set_sync_debug_mode("default")
        watch.restore()
    b.synchronize()
    return mdl, st, diags, counts, daily, events, a.elapsed_time(b) / steps


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


ROUTING_DIAGS = ("routing_ocean_inflow_kgps", "routing_mass_error_kg", "routing_stranded_kg",
                 "routing_routed_mass_kg", "routing_store_out_kg", "routing_lake_delta_kg")


def check_routing(diags):
    """The six routing diags of the last step: finite, mass routed, and
    mass_error − (store_out − lake_delta) within 1e-6 of the routed mass."""
    d = {k: float(diags[k][-1]) for k in ROUTING_DIAGS}
    if not all(np.isfinite(v) for v in d.values()):
        raise AssertionError(f"routing diags not finite: {d}")
    if not d["routing_routed_mass_kg"] > 0.0:
        raise AssertionError(f"no routed mass: {d}")
    gap = d["routing_mass_error_kg"] - (d["routing_store_out_kg"] - d["routing_lake_delta_kg"])
    if not abs(gap) <= 1e-6 * d["routing_routed_mass_kg"]:
        raise AssertionError(f"routing closure: mass_error − (store_out − lake_delta) = {gap} "
                             f"> 1e-6 · routed mass ({d})")
    return d, gap


def routing_event_check(mdl, st, label):
    """Two routing events from one buffer (the state's, scaled up to a
    day's runoff) must give the same bits; then the event's device time and
    launches a call."""
    from qingdai_tpu_torch import routing

    rs = mdl.routing_static
    acc = (st.routing.buffer_kg * 4.0).reshape(-1)
    vol = st.routing.lake_volume_kg
    a, b = routing.route_event(rs, acc, vol), routing.route_event(rs, acc, vol)
    torch.cuda.synchronize()
    same = (torch.equal(a[0], b[0]) and torch.equal(a[2], b[2])
            and all(torch.equal(x, y) for x, y in zip(a[1], b[1])))
    routed = float(a[1][0])
    if not same:
        raise AssertionError("two routing events from one buffer differ")
    if not routed > 0.0:
        raise AssertionError("the routing event's buffer is empty")
    ms, n_dev = device_profile(lambda: routing.route_event(rs, acc, vol), what="route_event")
    print(f"routing: two events from one buffer bit-equal (flow_accum, ocean/store sums, lake "
          f"volumes; routed {routed:.6e} kg); one event {ms:.5f} device ms, {n_dev:g} device "
          f"launches ({rs.n_levels} levels, {len(rs.rounds)} rounds) [{label}]")


def path_counts(steps, form=""):
    """Each wrapper's launches over ``steps`` steps of a path: the main
    path's 3, 3, 1 and 1 a step of the forms named ``form`` ("" the single
    forms, "_batched" the batched ones), none of the others."""
    other = "_batched" if form == "" else ""
    want = {name + form: per_step * steps for name, _, _, per_step in KERNELS}
    return {**want, **{name + other: 0 for name, *_ in KERNELS}}


def phase4_paths(label):
    from qingdai_tpu_torch.physics.orbital import T_PLANET

    want_day = path_counts(STEPS_PER_DAY)
    # the main path: two planetary days, the second timed
    mdl, st, diags, counts, daily, events, ms_step = run_path(MAIN, STEPS_PER_DAY, 2, label,
                                                              "main path")
    for day, c in enumerate(counts, 1):
        if c != want_day:
            raise AssertionError(f"main path day {day}: launch counts {c} != {want_day}")
    # a fresh run's phytoplankton accumulator fires on step 1 and at the end
    # of each day; the ecology and individual-pool blocks at the end of each day
    want_daily = [{"eco_step_daily": 1, "indiv_step_daily": 1, "phyto_step_daily": 2},
                  {"eco_step_daily": 1, "indiv_step_daily": 1, "phyto_step_daily": 1}]
    if daily != want_daily:
        raise AssertionError(f"daily blocks ran {daily}, expected {want_daily}")
    if events != [EVENTS_PER_DAY] * 2:
        raise AssertionError(f"routing events per day {events}, expected {EVENTS_PER_DAY}")
    print(f"main path launch counts per day: {counts[-1]} (3, 3, 1, 1 per step); "
          f"daily blocks per day: {daily}; routing events per day: {events}")
    ts, umax = check_run(st, diags, STEPS_PER_DAY, eco=True)
    rd, gap = check_routing(diags)
    syh = 3600.0 / (ms_step / 1000.0) * mdl.dt / T_PLANET
    print(f"day 2: Ts_mean {ts[-1]:.3f} K, TOA_net {float(diags['TOA_net'][-1]):.3f} W/m2, "
          f"u_max {umax:.2f} m/s, chl_mean {float(diags['chl_mean'][-1]):.5f}, "
          f"lai_mean {float(diags['lai_mean'][-1]):.4f}; all leaves and diags finite")
    print("routing diags, last event of day 2: " + ", ".join(f"{k[8:]} {v:.6e}"
                                                              for k, v in rd.items())
          + f"; mass_error − (store_out − lake_delta) = {gap:.3e}")
    print(f"main path 181x360 f32: {ms_step:.4f} ms/step, {syh:.3f} sim-years/hour [{label}]")
    routing_event_check(mdl, st, label)
    del mdl, diags
    flagship, main_counts = st, counts[-1]

    # the planet without routing and the slice: two shorter chunks each,
    # the second timed
    want = path_counts(SHORT_STEPS)
    for env, tag in ((PLANET, "planet without routing"), (SLICE, "slice")):
        mdl, st, diags, counts, _, events, ms = run_path(env, SHORT_STEPS, 2, label, tag)
        if any(c != want for c in counts) or any(events):
            raise AssertionError(f"{tag}: launch counts {counts} != {want} a chunk, or "
                                 f"routing events {events}")
        check_run(st, diags, SHORT_STEPS, eco=env is PLANET)
        syh = 3600.0 / (ms / 1000.0) * mdl.dt / T_PLANET
        print(f"{tag} launch counts per {SHORT_STEPS} steps: {counts[-1]}; {tag} 181x360 f32: "
              f"{ms:.4f} ms/step, {syh:.3f} sim-years/hour [{label}]")
        del mdl, st, diags
    return flagship, main_counts


ENSEMBLE_MEMBERS = (1, 2, 4, 8)
ENSEMBLE_WARM = 24                          # steps of the warm chunk
ENSEMBLE_WINDOW = 72                        # profiled steps: one routing period
FALLBACK = "There is a performance drop because we have not yet implemented the batching rule"


def profile_steps(fn, steps, what):
    """(device ms, device launches) per step of ``fn()``, which runs
    ``steps`` steps, under torch.profiler (device activity only), after the
    profiler's start-up wait; an empty profile is taken again."""
    for attempt in range(1, PROFILE_TRIES + 1):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            time.sleep(PROFILE_WAIT_S)
            fn()
            torch.cuda.synchronize()
        PROFILE_LOG["taken"] += 1
        dev = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
        us = sum(e.time_range.elapsed_us() for e in dev)
        if us > 0.0:
            return us / steps / 1e3, len(dev) / steps
        PROFILE_LOG["empty"].append((what, 0, 0))
        print(f"torch.profiler: no device event in profile {attempt} of {what}", flush=True)
    raise AssertionError(f"the profiler saw no device time in {PROFILE_TRIES} profiles of {what}")


def phase4b_ensemble(label):
    """The ensemble path: the flagship planet at 181×360 float32 with B = 1,
    2, 4 and 8 members (``ensemble.init_ensemble``, perturb_k 0.01 K, as
    ``run_ensemble`` starts them), each one warm chunk and a timed day (every
    daily block, three routing events) under sync-debug "error" with
    functorch's per-member fallback an error; the launch counts, the daily
    blocks and the routing events of the day; every member finite and within
    the physical gates; then a profiled window of one routing period. Member
    0 of B = 8 against the single planet over the same steps, within
    ``ENSEMBLE_F32_REL``, and as its control members 1..7, each of which
    must lie beyond that bound. Returns (the timed day's launch counts at B = 8, a
    row of numbers per B)."""
    import warnings

    from qingdai_tpu_torch import ensemble as E
    from qingdai_tpu_torch import entry, kernels, routing
    from qingdai_tpu_torch import model as M
    from qingdai_tpu_torch.physics.orbital import T_PLANET

    t0 = time.perf_counter()
    mdl, _ = entry.build_world(H, W, extra_env=MAIN)
    print(f"ensemble path built in {time.perf_counter() - t0:.2f} s: the flagship planet "
          f"{H}x{W} float32 on {mdl.device}")
    want = path_counts(STEPS_PER_DAY, "_batched")
    rows, counts8, members8 = {}, None, None
    warm, day = (E.make_ensemble_chunk_fn(mdl, n) for n in (ENSEMBLE_WARM, STEPS_PER_DAY))
    window = E.make_ensemble_chunk_fn(mdl, ENSEMBLE_WINDOW)
    with warnings.catch_warnings():
        warnings.filterwarnings("error", message=FALLBACK)
        for B in ENSEMBLE_MEMBERS:
            ens, gens = E.init_ensemble(mdl, B)
            watch = DailyCounts()
            try:
                torch.cuda.set_sync_debug_mode("error")
                try:
                    ens, _ = warm(ens, gens)
                finally:
                    torch.cuda.set_sync_debug_mode("default")
                torch.cuda.synchronize()
                watch.take()
                kernels.reset_launch_counts()
                routing.route_event.events = 0
                a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                torch.cuda.set_sync_debug_mode("error")
                try:
                    a.record()
                    ens, diags = day(ens, gens)
                    b.record()
                finally:
                    torch.cuda.set_sync_debug_mode("default")
                counts, daily, events = (kernels.launch_counts(), watch.take(),
                                         routing.route_event.events)
            finally:
                watch.restore()
            b.synchronize()
            ms = a.elapsed_time(b) / STEPS_PER_DAY
            if counts != want:
                raise AssertionError(f"ensemble B={B}: launch counts of the day {counts} != "
                                     f"{want}")
            if daily != {"eco_step_daily": 1, "indiv_step_daily": 1, "phyto_step_daily": 1}:
                raise AssertionError(f"ensemble B={B}: daily blocks {daily}")
            if events != EVENTS_PER_DAY:
                raise AssertionError(f"ensemble B={B}: {events} routing events in the day")
            for m in range(B):
                d = {k: v[m] for k, v in diags.items()}
                check_run(E.member_state(ens, m), d, STEPS_PER_DAY, eco=True)
                check_routing(d)
            if B == ENSEMBLE_MEMBERS[-1]:
                counts8, members8 = counts, [E.member_state(ens, m) for m in range(B)]
                spread = E.spread_diagnostics(diags)
            dev_ms, n_dev = profile_steps(lambda: window(ens, gens), ENSEMBLE_WINDOW,
                                          f"the ensemble at B={B}")
            syh = 3600.0 / (ms / 1000.0) * mdl.dt / T_PLANET
            rows[B] = {"ms_step": ms, "ms_member_step": ms / B, "member_sim_years_per_hour":
                       B * syh, "launches_step": n_dev, "device_ms_step": dev_ms,
                       "idle": 1.0 - dev_ms / ms}
            print(f"ensemble B={B} 181x360 f32: {ms:.4f} ms/step, {ms / B:.4f} ms a member-step, "
                  f"{B * syh:.3f} member-sim-years/hour; {n_dev:.1f} device launches and "
                  f"{dev_ms:.4f} device ms a step ({ENSEMBLE_WINDOW}-step window with one "
                  f"routing event), idle {1.0 - dev_ms / ms:.3f}; day: launches {counts}, "
                  f"daily blocks {daily}, {events} routing events; every member finite and "
                  f"physical (Ts_mean {float(diags['Ts_mean'][:, -1].min()):.3f}.."
                  f"{float(diags['Ts_mean'][:, -1].max()):.3f} K) [{label}]", flush=True)
            del ens, diags
    print("ensemble B=8 spread at the day's last step: " + ", ".join(
        f"{k} {spread[k + '_spread']:.4e}" for k in ("Ts_mean", "TOA_net", "P_mean", "u_max")))

    # member 0 against the single planet over the same steps
    st = M.init_world(mdl)
    for n in (ENSEMBLE_WARM, STEPS_PER_DAY):
        st, _ = M.make_chunk_fn(mdl, n)(st)
    worst = []
    for m in members8:
        errs = member_errors(st, m)
        worst.append(max(errs, key=errs.get))
        worst[-1] = (worst[-1], errs[worst[-1]])
    same = same_state(st, members8[0])
    print(f"ensemble B=8 members against the single planet over the same "
          f"{ENSEMBLE_WARM + STEPS_PER_DAY} steps, max relative difference without the pole "
          f"rows: member 0 {worst[0][1]:.3e} ({worst[0][0]}; bit-equal: {same}); the control, "
          f"members 1..{len(worst) - 1}: " + ", ".join(f"{e:.3e} ({k})" for k, e in worst[1:])
          + f"; bound {ENSEMBLE_F32_REL}")
    if not worst[0][1] <= ENSEMBLE_F32_REL:
        raise AssertionError(f"ensemble member 0 differs from the single planet: "
                             f"{worst[0][0]} {worst[0][1]} > {ENSEMBLE_F32_REL}")
    if not min(e for _, e in worst[1:]) > ENSEMBLE_F32_REL:
        raise AssertionError("a perturbed member lies within ENSEMBLE_F32_REL of the single "
                             "planet: the bound cannot tell member 0 from another member")
    return counts8, rows


def same_state(a, b) -> bool:
    """Every leaf of two single-planet states equal bit for bit."""
    from qingdai_tpu_torch.convert import world_to_numpy

    fa, fb = world_to_numpy(a), world_to_numpy(b)
    return set(fa) == set(fb) and all(same_bits(fa[k], fb[k]) for k in fa)


def _step_diffs(st, dtype, dev):
    """max|card − CPU| / max|CPU| per leaf and diag after one step of the main
    path from ``st`` converted to ``dtype``: over every row, and without the
    two pole rows. Both steps must route."""
    from qingdai_tpu_torch import entry
    from qingdai_tpu_torch import model as M
    from qingdai_tpu_torch.convert import world_from_numpy, world_to_numpy

    def one_step(where):
        mdl, _ = entry.build_world(H, W, extra_env=MAIN, device=where, dtype=dtype)
        s1, d1 = M.make_step_fn(mdl)(world_from_numpy(st, where, dtype))
        if s1.routing.t_accum != 0.0:
            raise AssertionError("phase 5's step did not route")
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
    """One step on the card and the same step on the CPU from one warm state
    of the main path, its routing clock one step before an event.

    In float32 the pole rows are chaotic by construction: their cos cap of
    1e-6 puts the departure point ~5e5 cells upwind at 200 m/s, so one ulp of
    u moves it by cells. Those differences are printed; the bound of 1e-4 is
    held on the float64 step from the same state, which runs the float64
    instantiation of every kernel inside the step."""
    import dataclasses

    t_event = 6 * 3600.0 - 300.0
    st = dataclasses.replace(st, routing=dataclasses.replace(st.routing, t_accum=t_event))
    for dtype in (torch.float32, torch.float64):
        full, inner = _step_diffs(st, dtype, dev)
        top = sorted(full, key=lambda k: -full[k])[:8]
        print(f"card vs CPU, one {dtype} step through a routing event, max|diff|/max|value| "
              "(all rows; without the pole rows): "
              + ", ".join(f"{k} {full[k]:.2e}; {inner[k]:.2e}" for k in top))
    worst = max(full.values())
    if worst > 1e-4:
        raise AssertionError(f"card and CPU float64 steps differ by {worst}")
    routing_worst = max(v for k, v in full.items() if "routing" in k)
    print(f"phase 5: float64 routing leaves and diags, card vs CPU: {routing_worst:.2e}")
    return worst


# member 0 of an ensemble against the single planet in float32 over the same
# steps: each leaf within this share of its largest |value|, the pole rows
# left out (phase 5). Batched reductions may add in another order than the
# single planet's, an ulp apart, and the step's dynamics grow that. Every
# perturbed member (0.01 K) must lie beyond it, so that the check tells
# member 0 from its neighbours; the CPU tests hold the same bound
# (tests/test_torch_ensemble.py).
ENSEMBLE_F32_REL = 1e-5


def member_errors(ref, got) -> dict:
    """max|ref − got| / max|ref| per leaf of two single-planet states, over
    the finite entries (which must sit in the same places) and without the
    pole rows; the routing leaves that are differences of routed sums
    relative to the routed mass."""
    from qingdai_tpu_torch.convert import world_to_numpy

    grid = tuple(ref.atmos.T_s.shape)
    a, b = world_to_numpy(ref), world_to_numpy(got)
    routed = (float(np.max(np.abs(a["routing.routed_mass_kg"])))
              if "routing.routed_mass_kg" in a else 0.0)
    errs = {}
    for k in a:
        r, g = np.asarray(a[k], np.float64), np.asarray(b[k], np.float64)
        if r.shape[-2:] == grid:
            r, g = r[..., 1:-1, :], g[..., 1:-1, :]
        fin = np.isfinite(r)
        if not np.array_equal(fin, np.isfinite(g)):
            errs[k] = float("inf")
            continue
        scale = max(float(np.max(np.abs(r[fin]), initial=0.0)), 1e-30)
        if "stranded" in k or "mass_error" in k:
            scale = max(scale, routed)
        errs[k] = float(np.max(np.abs(r[fin] - g[fin]), initial=0.0)) / scale
    return errs


def same_bits(a, b) -> bool:
    """Equal dtype, shape and bytes (NaN sentinels included)."""
    a, b = np.asarray(a), np.asarray(b)
    return a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == b.tobytes()


PHASE6_ENV = {"QD_ECO_MUT_RATE": "1.0", "QD_AUTOSAVE_ENABLE": "0", "QD_CHUNK_STEPS": "240"}


def phase6_world(label):
    """The world driver on the card, resumed from its sidecar (module
    docstring, phase 6). Returns run()'s ms/step."""
    import os
    import tempfile

    from qingdai_tpu_torch import routing
    from qingdai_tpu_torch import world as world_mod
    from qingdai_tpu_torch.convert import world_to_numpy
    from qingdai_tpu_torch.physics.orbital import T_PLANET

    old_env = {k: v for k, v in os.environ.items() if k.startswith("QD_")}
    old_cwd = os.getcwd()
    with tempfile.TemporaryDirectory(prefix="qd_phase6_") as tmp:
        os.chdir(tmp)
        for k in old_env:
            del os.environ[k]
        os.environ.update(PHASE6_ENV)
        try:
            t0 = time.perf_counter()
            wa = world_mod.QingdaiWorld(verbose=False)
            if wa.device.type != "cuda" or wa.model.routing_static is None:
                raise AssertionError(f"the world runs on {wa.device}, routing "
                                     f"{wa.model.routing_static is not None}")
            built = time.perf_counter() - t0
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            wa.run(duration_seconds=210 * wa.model.dt)
            torch.cuda.synchronize()
            ms_run = (time.perf_counter() - t0) * 1e3 / 210
            wa.autosave()
            written = sorted(os.listdir("data"))
            wa.step_chunk(36)
            wb = world_mod.QingdaiWorld(verbose=False)
            if wb.restore_source != "sidecar" or wb.state.clock.step_idx != 210:
                raise AssertionError(f"resume from {wb.restore_source} at step "
                                     f"{wb.state.clock.step_idx}")
            watch = DailyCounts()
            routing.route_event.events = 0
            try:
                wb.step_chunk(36)
            finally:
                watch.restore()
            ran = (routing.route_event.events, watch.take()["eco_step_daily"])
            if ran != (1, 1):
                raise AssertionError(f"the resumed 36 steps ran {ran[0]} routing events and "
                                     f"{ran[1]} daily blocks, expected 1 and 1")
            fa, fb = world_to_numpy(wa.state), world_to_numpy(wb.state)
            bad = [k for k in fa if not same_bits(fa[k], fb.get(k))]
            if set(fa) != set(fb) or bad:
                raise AssertionError(f"the resumed run differs from the uninterrupted one: "
                                     f"{bad[:8]}")
            if not torch.equal(wa.model.generator.get_state(), wb.model.generator.get_state()):
                raise AssertionError("the generators differ after the resume")
            n_act = int(wb.state.eco.n_active)
        finally:
            os.chdir(old_cwd)
            for k in [k for k in os.environ if k.startswith("QD_")]:
                del os.environ[k]
            os.environ.update(old_env)
    syh = 3600.0 / (ms_run / 1000.0) * 300.0 / T_PLANET
    print(f"phase 6: world built in {built:.2f} s; autosave wrote {written}; resumed from the "
          f"sidecar at step 210, 36 steps (1 routing event, 1 daily block, {n_act} species "
          f"active) equal the uninterrupted run's bit for bit in all {len(fa)} leaves and the "
          f"generator state")
    print(f"phase 6: world run() 210 steps of the flagship planet 181x360 f32: "
          f"{ms_run:.4f} ms/step, {syh:.3f} sim-years/hour [{label}]")
    return ms_run


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
    ens_counts, _ = phase4b_ensemble(label)
    counts.update({k: v for k, v in ens_counts.items() if k.endswith("_batched")})
    worst = phase5_cpu_reference(st, dev)
    print(f"phase 5: card and CPU float64 steps agree to {worst:.2e} relative")
    del st
    phase6_world(label)

    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    kernels_line = [{"name": name + form, "route": "cuda", "source": src, "replaces": rep,
                     "launches": counts[name + form], **{k: rec[name + form][k] for k in keys}}
                    for form in ("", "_batched") for name, src, rep, _ in KERNELS]
    print(f"card: {label}")
    print(json.dumps({"kernels": kernels_line}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
