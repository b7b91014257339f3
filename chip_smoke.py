"""Drive the PyTorch / CUDA port's main path once on one NVIDIA card.

    python3 chip_smoke.py

Phases, each of which raises on failure (exit code non-zero):
  1. the card (nvidia-smi name and power limit), torch and CUDA versions, and
     whether nvcc and triton are present; the card's device-to-device copy
     rate (clone of a 1 GiB tensor);
  2. build the six CUDA kernels from ``qingdai_tpu_torch/csrc`` (one nvcc per
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
     then K5 (the chlorophyll transport) against its plain version at one
     planet [10, 181, 360] and the benchmark cells' stacks [400, 10, 181,
     360] and [31, 10, 721, 1440], timed beside it and its bound
     (``phase3_phyto``), and captured in the CUDA graph with K3 and K4;
     then K6 (the separable Gaussian filter) bit-equal to its plain version
     at one planet [181, 360] and the cells' stacks [400, 181, 360] and
     [31, 721, 1440], σ 1 reflect and σ 0.2 wrap, timed beside the plain
     chain and its bound (``phase3_gauss``), and in the CUDA graph too;
  4. the main path, the flagship planet of ``__graft_entry__.entry()`` (the
     default configuration: 181×360, float32, ecology, the individual pool,
     phytoplankton and river routing on), built with no device argument: one
     planetary day of 240 steps, then a second, timed one, both with host
     syncs turned into errors; state and diags must be finite and physical,
     the launch counters of K1–K6 must grow by exactly 3, 3, 1, 1, 1 and 5
     per step, the
     daily blocks must run once a day and the routing event exactly 3 times
     a day, with its six diags finite and its closure identity holding; two
     routing events from one buffer must give the same bits. Then the
     planet without routing (the main path before routing was ported) and
     the path without ecology and phytoplankton (the slice of the first
     bring-up), two shorter chunks each, with their own launch counts (the
     slice has no phytoplankton, so no K5; K6's five calls a step run on
     every path but a rank of the longitude mesh);
 4b. the ensemble path (``qingdai_tpu_torch.ensemble``): the flagship planet
     with 1, 2, 4 and 8 members, each a warm chunk and a timed day under
     sync-debug "error" with functorch's per-member fallback an error; the
     batched forms must launch 3, 3, 1 and 1 times a step and the single
     forms never, every member must be finite and physical; ms/step, per
     member, member·sim-years/hour, device launches and device ms a step
     (a profiled routing period); member 0 of B = 8 against the single
     planet over the same steps: bit for bit (members 1..7, perturbed, must
     each lie beyond ``ENSEMBLE_F32_REL``);
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
  7. the adjoint on the card (``qingdai_tpu_torch.adjoint``). 7.1: each
     kernel's backward (its plain version's VJP): ``gradcheck`` in float64
     on a 19×36 grid (every input, relative perturbations, K4 two
     substeps; two backwards of one cotangent must repeat to the bit,
     ``nondet_tol`` 0), and at the main path's shapes the Function's VJP against
     the plain version's (float32 within 1e-5, float64 1e-12 of the largest
     |grad|), with each backward's device ms a call beside the kernel's
     forward and its bound. 7.2: the flagship planet warmed one planetary
     day, ``make_value_and_grad`` over 24 steps (segment 4) of gh_factor,
     the friction map and the initial T_s map in float32: J, dJ/d gh_factor
     > 0 and the maps finite, K1–K4 launched 2 × (3, 3, 1, 1) times a step
     (forward and the checkpoint's recompute); ms per window-step of the
     value and of the gradient, their ratio, peak device memory, device ms
     and launches a window-step and the top kernels by device time; the
     two timed gradient calls must equal the first bit for bit. 7.3:
     the same window in float64, printed with the pole rows' share of the
     initial-T_s map, and dJ/d gh_factor in float32 against float64 on 12
     steps within 2e-2. 7.4: a 6-step float64 window against its central
     difference (1e-4) and against the same gradient on the CPU (1e-8).
  8. data assimilation (``qingdai_tpu_torch.assim``, ``assimilate``). 8.1:
     one LETKF analysis of 8 members of the flagship planet (1 K of T_s/SST
     and 20 m of height noise, 48 steps on) with the CLI's six fields and
     500 T_s observations of a truth (σ 0.5 K, 2000 km, inflation 1.04,
     RTPS 0.6): the card's float64 analysis against the CPU's within 1e-10
     of each field's largest |value|, the analysis mean unchanged by RTPS
     (the deviations are zero-mean), float32 Newton–Schulz against float32
     eigh within 1e-5; device ms, launches, wall ms and peak device memory
     of one analysis with each solver; the host cost of building the step
     with an injected parameter. 8.2: ``python -m
     qingdai_tpu_torch.assimilate`` in this process at its defaults (chaos
     truth) with no warm-up, 1 burn-in cycle and 3 cycles of 48 steps:
     every analysis fits the observations (the ensemble-mean T_s at their
     cells) closer than its background; every forecast chunk (burn-in,
     forecast, free control) launches the batched forms 3, 3, 1 and 1 times
     a step and no single form; no analysis launches a kernel, changes the
     SST over land or leaves q or T_s out of range; the last analysis's
     members finite and physical; ms a cycle by part (truth, forecast, free
     control, analysis) and the forecast's member·sim-years/hour. The
     area-weighted RMSE to the truth is printed, not held: from a cold
     start the members' white T_s noise gives spurious covariances, and
     the analysis lands above its background (PERF.md §4). 8.3: the same
     with ``--est-param gh_factor`` for 2 cycles without burn-in: θ finite
     with spread, each member's forecast with its own gh_factor in the same
     batched launches.
  9. the spin-up SOP and the restart regrid (``qingdai_tpu_torch.spinup``,
     ``regrid_restart``), each CLI's ``main(argv)`` in this process, in a
     temporary directory with the SOP's environment (the energy path,
     banded initial T_s, the Q_net-coupled ocean, the energy audit) and
     mutation on, chunks of one day. 9.1: the two-phase SOP at 181×360, 2
     days at MLD 5 from a cold start (the seeded orography in memory where
     no NetCDF library is installed), then 4 days at MLD 50 from the
     sidecar: K1–K4 launched 3, 3, 1 and 1 times a step, every chunk's means
     finite, the record with the JAX tool's keys and the acceptance that
     ``build_criteria`` gives on its series. 9.2: from a copy of ``data/``
     as phase 1 left it, the same phase 2 as two 2-day segments
     (``--skip-phase1``, then ``--prepend-series``) must equal 9.1's
     uninterrupted phase 2 bit for bit: every leaf of the final sidecar, the
     generator state and the merged series. 9.3: the staged chain, 9.1's
     phase-2 restart regridded to 361×720 and a 2-day ``--restart-in``
     segment there, that segment's restart regridded to 721×1440 and
     another: at each grid K1–K4 at 3, 3, 1 and 1 a step, no flux-cache
     bootstrap and no transient chunk, the state finite and physical, and
     each kernel called on its last step's own inputs against its plain
     version (K1 bit-equal, K2–K4 within phase 3's tolerances) with its
     device ms a call and its bound; ms/step, sim-years/hour, peak device
     memory and the host build times. 9.4: ``world.run()`` for a day with
     ``QD_PLOT_EVERY_DAYS=1`` and ``QD_ECO_DIVERSITY_ENABLE=1`` writes the
     panels and the diversity snapshot (without matplotlib: the snapshot
     and one printed line), and whether matplotlib is installed.
     ``python3 chip_smoke.py --phase 9`` builds the kernels and runs phase 9
     alone, without the record lines.
 10. multi-GPU (``qingdai_tpu_torch.parallel``) on the one card: 2 and 4
     ranks, each a process of its own, over gloo, which stages the card's
     tensors through host memory (NCCL refuses two ranks on one device).
     The collectives sync with the host, so phase 10 does not run under
     sync-debug "error"; its times are of N ranks sharing one card, not a
     scaling number. One spawn of 2 ranks and one of 4. A rank launches K1,
     K2 and K4 on their operands gathered whole and K3 on the padded block,
     and runs the plain versions of K5 and K6. 10.1: at 181×360 in float32
     and float64 each sharded op on the ranks' own columns
     (``par_sharded_ops``) against the whole grid's call on the card: the
     pads, the Gaussian filters (reflect and wrap seams), the gradients
     (one-sided seams), divergence, vorticity, ∇², Shapiro, the zonal FFT
     filter, K1, K2 and K4 on the gathered operands and K3 on the padded
     block (its static operands exchanged, and cut from the shard grid's
     padded maps) bit-equal, and K3's static maps in the padded maps equal
     to the exchanged ones; the ocean step within phase 3's tolerances (the
     polar ring means' order of summation), the area means within 1e-5
     (float32) / 1e-12 (float64). 10.2: the flagship planet (181×360
     float32, every default on) sharded 2 and 4 ways, 12 warm steps then a
     timed day of 240 with the diags every 24 steps (QD_DIAG_EVERY: a
     rank-step's collectives are ~52 without the diags, ~118 with them):
     K1, K2, K3 and K4 launched 3, 3, 1 and 1 times a rank-step on every
     rank and no other kernel; the gathered state
     and the diags finite and physical, a routing event's closure; ms/step,
     and collectives, halo bytes, gathered bytes and all-reduced bytes a
     rank-step. 10.3 (4 ranks): the dry run (``parallel.dryrun``) at
     181×360, 3 resynced half-day segments, each under its bound. 10.4 (2
     ranks): the member mesh, 8 flagship members over 2 ranks for 24 steps
     against the unsharded B = 8 run (bit-equal, or the largest difference
     and its leaf), and one LETKF analysis of the gathered ensemble against
     the unsharded one. ``python3 chip_smoke.py --phase 10`` builds the
     kernels and runs phase 10 alone, without the record lines.
 11. the offline tools that compute on tensors, on the card. 11.1:
     ``verify_calculation`` (its three checks must pass) and ``total_flux``
     over 4096 times of a year in float64 against the CPU (1e-13 relative).
     11.2: ``insolation_components`` at 181×360, float32 and float64, at
     t = 0 and 1.234e7 s, against the CPU in float64 (1e-5 and 1e-12 of the
     largest value). 11.3: ``diag_isr`` (its ``[ISR]`` line; no panels
     without matplotlib) and its numbers against the CPU's. 11.4:
     ``validate_hydro_routing`` at 181×360, float32 (closure, inflow, the
     network's host build seconds) and float64 against the CPU (1e-12).
     11.5: the plant pool (``ecology.plant``) of 1e6 plants, two days of two
     substeps, float64 against the CPU (states, ages and seeds equal, floats
     within 1e-12), and device ms a daily step and a substep in float32 and
     float64. Each number beside the card's name and power limit. ``python3
     chip_smoke.py --phase 11`` builds the kernels and runs phase 11 alone,
     without the record lines.
``python3 chip_smoke.py --phase 3`` and ``--phase 4`` build the kernels and
run that phase alone, without the record lines.
The line before the last is the kernels' JSON record, the six single forms
(launches from phase 4's main path) and the six batched forms (launches
from phase 4b's day at B = 8); the last line is
``{"ok": true, "device": {...}}``.
"""

import dataclasses
import functools
import json
import os
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
# K5, the chlorophyll transport: replaces no TPU kernel (the JAX package
# leaves the chain to XLA's fusion); once a step where the phytoplankton's
# transport runs (not the slice, not a rank of the longitude mesh)
PHYTO_KERNEL = ("phyto_transport", "qingdai_tpu_torch/csrc/phyto_transport.cu", None, 1)
# K6, the separable Gaussian filter: replaces no TPU kernel (the JAX package
# leaves the filter to XLA's fusion); five calls a step on every path (the
# hybrid precipitation, its convergence fallback, the cloud from it, the
# cloud source and the advected cloud), none on a rank of the longitude mesh
GAUSS_KERNEL = ("gauss_sep", "qingdai_tpu_torch/csrc/gauss_sep.cu", None, 5)
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
# PROFILE_TRIES empty profiles in a row is timed with CUDA events instead
# (``device_profile``): late in a long process the profiler has returned
# only empty profiles for minutes (PERF.md §6).
PROFILE_WAIT_S = 0.05
PROFILE_TRIES = 3
# profiles taken, (what, host events, launch calls) of each empty one, and
# what was timed with CUDA events instead
PROFILE_LOG = {"taken": 0, "empty": [], "events": []}


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
    per call. After PROFILE_TRIES empty profiles, CUDA events around the
    ``reps`` calls in a row (an upper bound: gaps between launches count)
    and the host's launch calls, printed as such."""
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
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    b.synchronize()
    ms = a.elapsed_time(b) / reps
    PROFILE_LOG["events"].append(what)
    print(f"torch.profiler: {what} timed with CUDA events instead: {ms:.5f} ms a call over "
          f"{reps} calls in a row (gaps between launches included), {launch_calls / reps:g} "
          "host launch calls a call", flush=True)
    return ms, launch_calls / reps


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


def k5_operands(dev, dtype, shape=(H, W), B=0, seed=5, plant=False, dry_pole=False,
                shared_adv=False, K_h=5.0e3, land_zero=False):
    """K5's operands on a grid of ``shape`` (181×360 unless given), drawn on
    the card from ``seed``: C_phyto in [-0.05, 0.5) (some cells for the
    clamp) and C_adv in [0, 0.5), [B, 10, h, w] (B = 0: [10, h, w]; C_adv
    without the member axis if ``shared_adv``), 70% ocean, the capped cos
    map, and (α, K_h, dt, dlat, dlon, a) as the flagship's. ``plant`` puts
    NaN, +inf and −inf into C_phyto (one of them on pole row 0) and NaN into
    C_adv's last column; ``dry_pole`` leaves row h−1 without ocean;
    ``land_zero`` zeroes both stacks off the ocean, as the model's are (the
    ∇²'s terms are then exact zeros over land)."""
    from qingdai_tpu_torch import constants as const
    from qingdai_tpu_torch.grid import make_grid

    h, w = shape
    g = make_grid(h, w, device=dev, dtype=dtype)
    gen = torch.Generator(device=dev).manual_seed(seed)
    stack = ((B,) if B else ()) + (N_SPECIES, h, w)

    def draw(size, lo, hi):
        x = torch.rand(size, generator=gen, device=dev, dtype=torch.float64)
        return (lo + (hi - lo) * x).to(dtype)

    Cp = draw(stack, -0.05, 0.5)
    Ca = draw((N_SPECIES, h, w) if shared_adv else stack, 0.0, 0.5)
    ocean = torch.rand((h, w), generator=gen, device=dev) < 0.7
    if plant:                          # the planted cells are ocean
        ocean[h // 3, 7] = ocean[0, 3] = ocean[h - 2, 1] = ocean[1, w - 1] = True
        Cp[..., 0, h // 3, 7] = float("nan")
        Cp[..., 1, 0, 3] = float("inf")
        Cp[..., 2, h - 2, 1] = -float("inf")
        Ca[..., 3, 1, w - 1] = float("nan")
    if dry_pole:
        ocean[-1] = False
    if land_zero:
        Cp, Ca = torch.where(ocean, Cp, 0.0), torch.where(ocean, Ca, 0.0)
    return ((Cp, Ca, ocean, g.coslat_cap_05),
            (0.7, K_h, 300.0, g.dlat_rad, g.dlon_rad, const.PLANET_RADIUS))


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


def k2_check(dev, dtype, M, case, r, tol, shape=(H, W)):
    """One K2 case on the card, on a grid of ``shape`` (181×360 unless
    given): the kernel's departure points bit-equal to
    ``departure_indices``, the stack within tol · max|F| of the plain version,
    and ``advect_semilag_multi`` launching the kernel. Cases: "winds", random
    winds capped at 200 m/s; "poles", the pole rows at 150–200 m/s, whose
    departures lie ~4e5–5.4e5 cells away under the 1e-6 cos cap; "far", a cos
    cap of 1e-12, departures beyond 2^30 cells. Returns (max|err|, dep_j)."""
    from qingdai_tpu_torch import constants as const
    from qingdai_tpu_torch.grid import make_grid
    from qingdai_tpu_torch.kernels.advect_bilinear import advect_bilinear_cuda
    from qingdai_tpu_torch.ops import advect

    H, W = shape
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
    k5_call = phase3_phyto(dev, label, rate, rec)
    k6_call = phase3_gauss(dev, label, rate, rec)
    k1_anatomy(x, rec["median_pos"]["ms"], label)
    k4_anatomy(mom, st, forc, geo, params, rec["ocean_substeps"]["ms"], label)
    graph_replay(pairs["hyper4"][0], pairs["ocean_substeps"][0], k5_call, k6_call)
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


# K5 at the main path's shapes: one planet, and the member stacks of the
# benchmark's two cells (400 members at 181x360, 31 at 721x1440)
K5_SHAPES = ((0, (H, W)), (400, (H, W)), (31, (721, 1440)))


def k5_bytes(B, shape, itemsize=4):
    """K5's bytes at its bound: C_phyto and C_adv read once and C written
    once (``B`` members, 1 for one planet, of 10 species), the mask and the
    cos map read once."""
    h, w = shape
    return 3 * max(B, 1) * N_SPECIES * h * w * itemsize + h * w * (itemsize + 1)


def phase3_phyto(dev, label, rate, rec):
    """K5 against its plain version (under ``torch.func.vmap`` for the
    batched form) at ``K5_SHAPES`` in float32, both stacks zero over land as
    the model's are: max|err| (0: bit-equal) and
    device ms a call in the order plain, kernel, kernel, plain, beside the
    bound. No one PyTorch call computes the chain: the ∇² takes the capped
    cos map's latitude-dependent coefficients, and the ring means a masked
    sum in a fixed order. Returns a call of the single form for the CUDA
    graph's replay."""
    from qingdai_tpu_torch.ecology import phyto
    from qingdai_tpu_torch.kernels.phyto_transport import (phyto_transport_batched_cuda,
                                                           phyto_transport_cuda)

    for B, shape in K5_SHAPES:
        ops, sc = k5_operands(dev, torch.float32, shape, B=B, land_zero=True)
        if B:
            def kernel(ops=ops, sc=sc, B=B):
                return phyto_transport_batched_cuda(*ops, *sc, B)

            def plain(ops=ops, sc=sc):
                return torch.func.vmap(phyto.phyto_transport_plain,
                                       in_dims=(0, 0) + (None,) * 8)(*ops, *sc)
        else:
            def kernel(ops=ops, sc=sc):
                return phyto_transport_cuda(*ops, *sc)

            def plain(ops=ops, sc=sc):
                return phyto.phyto_transport_plain(*ops, *sc)
        got, ref = kernel(), plain()
        err = float((got - ref).abs().max())
        exact = same_bits(got.cpu(), ref.cpu())
        scale = float(ref.abs().max())
        del got, ref
        if not err <= 1e-6 * scale:
            raise AssertionError(f"K5 {B} x {shape}: max|err| {err} against the plain version")
        name = "phyto_transport" + ("_batched" if B else "")
        p1, (k1, n_dev), k2, p2 = (device_ms(plain, what=f"{name}'s plain version"),
                                   device_profile(kernel, what=f"kernel {name}"),
                                   device_ms(kernel, what=f"kernel {name}"),
                                   device_ms(plain, what=f"{name}'s plain version"))
        nbytes = k5_bytes(B, shape)
        entry = {"max_abs_err": err, "ms": statistics.median([k1, k2]),
                 "plain_ms": statistics.median([p1, p2]), **bound(nbytes, 0, rate),
                 "library_ms": None}
        if name not in rec:            # the record line: one planet, and 400 members
            rec[name] = entry
        stack = f"{B} x " if B else ""
        print(f"time {name} ({stack}{N_SPECIES} x {shape[0]}x{shape[1]}, float32), device ms "
              f"per call: kernel {k1:.5f}/{k2:.5f} ({n_dev:g} device launches a call), plain "
              f"{p1:.5f}/{p2:.5f}; max|err| against plain {err:.3e} "
              f"({'bit-equal' if exact else 'not bit-equal'}); bound {entry['bound_ms']:.5f} ms "
              f"(bytes: {nbytes} B at 3.35 TB/s; {entry['bound_copy_ms']:.5f} ms at the measured "
              f"copy rate), kernel at {100 * entry['bound_ms'] / entry['ms']:.1f}% of it "
              f"[{label}]", flush=True)
        del ops
        torch.cuda.empty_cache()
    ops, sc = k5_operands(dev, torch.float32)
    return lambda: (phyto_transport_cuda(*ops, *sc),)


def gauss_field(dev, dtype, shape=(H, W), B=0, seed=13, plant=False):
    """K6's input on a grid of ``shape`` (181×360 unless given), drawn on the
    card from ``seed``: uniform in [-1, 1), [h, w] (B = 0) or [B, h, w].
    ``plant`` puts NaN next to the seam on the row after pole row 0, +inf
    on pole row h−1 next to the seam and −inf on the seam mid-field."""
    h, w = shape
    gen = torch.Generator(device=dev).manual_seed(seed)
    x = torch.rand(((B,) if B else ()) + (h, w), generator=gen, device=dev, dtype=torch.float64)
    F = (2.0 * x - 1.0).to(dtype)
    if plant:
        F[..., min(1, h - 1), 0] = float("nan")
        F[..., h - 1, w - 2] = float("inf")
        F[..., h // 2, w - 1] = -float("inf")
    return F


# K6 at the main path's shapes: one planet, and the member stacks of the
# benchmark's two cells; the step's two calls, σ 1 reflect and σ 0.2 wrap
GAUSS_SHAPES = ((0, (H, W)), (400, (H, W)), (31, (721, 1440)))
GAUSS_CALLS = ((1.0, "reflect"), (0.2, "wrap"))


def phase3_gauss(dev, label, rate, rec):
    """K6 against its plain version (under ``torch.func.vmap`` for the
    batched form, as the ensemble runs it) at ``GAUSS_SHAPES`` and
    ``GAUSS_CALLS`` in float32: bit-equal, and device ms a call in the order
    plain, kernel, kernel, plain, beside the bound (the field read once and
    the result written once, 2S). No one PyTorch call computes it:
    ``F.pad``'s reflect leaves out the edge value that scipy's repeats.
    Returns a call of the single and the batched form for the CUDA graph's
    replay."""
    from qingdai_tpu_torch.kernels.gauss_sep import (gaussian_filter_batched_cuda,
                                                     gaussian_filter_cuda)
    from qingdai_tpu_torch.ops import smooth

    for B, shape in GAUSS_SHAPES:
        F = gauss_field(dev, torch.float32, shape, B=B)
        for sigma, mode in GAUSS_CALLS:
            taps = smooth._gauss_kernel(sigma)
            if B:
                def kernel(F=F, taps=taps, mode=mode, B=B):
                    return gaussian_filter_batched_cuda(F, taps, mode, mode, B)

                def plain(F=F, sigma=sigma, mode=mode):
                    return torch.func.vmap(smooth.gaussian_filter_plain,
                                           in_dims=(0, None, None, None))(F, sigma, mode, mode)
            else:
                def kernel(F=F, taps=taps, mode=mode):
                    return gaussian_filter_cuda(F, taps, mode, mode)

                def plain(F=F, sigma=sigma, mode=mode):
                    return smooth.gaussian_filter_plain(F, sigma, mode, mode)
            got, ref = kernel(), plain()
            exact = torch.equal(got.view(torch.int32), ref.view(torch.int32))
            err = float((got - ref).abs().max())
            del got, ref
            name = "gauss_sep" + ("_batched" if B else "")
            if not exact:
                raise AssertionError(f"K6 {B} x {shape} σ {sigma} {mode}: not bit-equal to the "
                                     f"plain version (max|err| {err})")
            p1, (k1, n_dev), k2, p2 = (device_ms(plain, what=f"{name}'s plain version"),
                                       device_profile(kernel, what=f"kernel {name}"),
                                       device_ms(kernel, what=f"kernel {name}"),
                                       device_ms(plain, what=f"{name}'s plain version"))
            nbytes = 2 * F.numel() * F.element_size()
            entry = {"max_abs_err": err, "ms": statistics.median([k1, k2]),
                     "plain_ms": statistics.median([p1, p2]), **bound(nbytes, 0, rate),
                     "library_ms": None}
            if name not in rec:        # the record line: one planet, and 400 members, σ 1
                rec[name] = entry
            stack = f"{B} x " if B else ""
            print(f"time {name} ({stack}{shape[0]}x{shape[1]}, σ {sigma} {mode}, float32), "
                  f"device ms per call: kernel {k1:.5f}/{k2:.5f} ({n_dev:g} device launches a "
                  f"call), plain {p1:.5f}/{p2:.5f}; bit-equal to plain; bound "
                  f"{entry['bound_ms']:.5f} ms (bytes: {nbytes} B at 3.35 TB/s; "
                  f"{entry['bound_copy_ms']:.5f} ms at the measured copy rate), kernel at "
                  f"{100 * entry['bound_ms'] / entry['ms']:.1f}% of it [{label}]", flush=True)
        del F
        torch.cuda.empty_cache()
    F, Fb = gauss_field(dev, torch.float32), gauss_field(dev, torch.float32, B=3, seed=14)
    return lambda: (gaussian_filter_cuda(F, smooth._gauss_kernel(1.0)),
                    gaussian_filter_batched_cuda(Fb, smooth._gauss_kernel(0.2), "wrap", "wrap", 3))


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
    print(f"CUDA graph: {len(calls)} calls (K3, K4, K5, K6 single and batched) captured; replays "
          "bit-equal to eager calls, two eager calls bit-equal")


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


def path_counts(steps, form="", phyto=True):
    """Each wrapper's launches over ``steps`` steps of a path: the main
    path's 3, 3, 1, 1, 1 and 5 a step (K1–K6) of the forms named ``form``
    ("" the single forms, "_batched" the batched ones, "mesh" a rank of the
    longitude mesh, which launches the single forms of K1–K4 only and runs
    the plain versions of K5 and K6), none of the others. ``phyto`` False:
    a path without the phytoplankton, no K5."""
    from qingdai_tpu_torch import kernels

    want = {}
    for name, _, _, per_step in KERNELS + ([PHYTO_KERNEL] if phyto else []) + [GAUSS_KERNEL]:
        if form != "mesh":
            want[name + form] = per_step * steps
        elif name in MESH_KERNELS:
            want[name] = per_step * steps
    return {k: want.get(k, 0) for k in kernels.wrappers()}


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
    print(f"main path launch counts per day: {counts[-1]} (3, 3, 1, 1, 1, 5 per step); "
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

    # the planet without routing and the slice (no phytoplankton, so no
    # K5): two shorter chunks each, the second timed
    for env, tag in ((PLANET, "planet without routing"), (SLICE, "slice")):
        want = path_counts(SHORT_STEPS, phyto=env is PLANET)
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
    must lie beyond that bound; member 0 must equal the single planet bit
    for bit (each of the step's reductions adds in one order whatever the
    member count: ``ops.reductions.sum_fixed``). Returns (the timed day's launch counts at B = 8, a
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
    if not same:
        raise AssertionError(f"ensemble member 0 is not bit-equal to the single planet: "
                             f"{worst[0][0]} {worst[0][1]} (bound {ENSEMBLE_F32_REL})")
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
# steps: on the card bit for bit; this share of each leaf's largest |value|
# (the pole rows left out, phase 5) is what every perturbed member (0.01 K)
# must lie beyond, so that the check tells member 0 from its neighbours. The
# CPU tests hold member 0 within it (tests/test_torch_ensemble.py): on the
# CPU a transcendental's vectorised and scalar loops round apart, and which
# elements take which loop depends on the tensor's size
# (scripts/bisect_member0_torch.py).
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


# ------------------------------------------------------------- phase 7

ADJ_STEPS = 24          # the flagship window of phase 7.2-7.3
ADJ_SEGMENT = 4
ADJ_CMP_STEPS = 12      # the window whose float32 and float64 gradients are held
ADJ_FD_STEPS = 6        # the float64 window held against FD and the CPU
ADJ_FD_EPS = 1e-6
GRAD_TOL = {torch.float64: 1e-12, torch.float32: 1e-5}
GRADCHECK_SHAPE = (19, 36)
# two backwards of one cotangent must repeat to the bit: the plain gather's
# backward adds in a fixed order (ops.scatter.gather_fixed), not with atomics
GRADCHECK_NONDET = 0.0


def grad_cases(dev, dtype, shape=None):
    """Each kernel's (dispatcher, plain version, inputs, which inputs the
    adjoint's main path differentiates) on the card: the main path's
    shapes (K1 one precipitation-like field, K2 M = 2, K3 M = 5 one substep,
    K4 SST + 10 tracers one substep), or a small grid (K4 two substeps
    without tracers), where every input is x0·m with m = 1 the variable, so
    that finite differences are relative (K3's and K4's k4 maps are ~1e20),
    and each output row is projected on seeded weights along longitude."""
    from qingdai_tpu_torch import constants as const
    from qingdai_tpu_torch import ocean
    from qingdai_tpu_torch.grid import make_grid
    from qingdai_tpu_torch.ops import advect, reductions, stencil

    r = np.random.default_rng(70)
    small = shape is not None
    shape = shape or (H, W)
    g = make_grid(*shape, device=dev, dtype=dtype)
    sc = (300.0, const.PLANET_RADIUS, g.dlat_rad, g.dlon_rad)
    if small:       # no entry at 0, where the set of positives jumps
        x = np.where(r.random(shape) < 0.5, -1.0, 1.0) * (np.abs(r.standard_normal(shape)) + 0.01)
    else:
        x = np.where(r.random(shape) < 0.6, 0.0, np.abs(r.standard_normal(shape)) * 1e-5)
    k4 = (0.02 * g.k4_map_unit / 300.0)[None] * on(dev, [[[1.0]], [[1.0]], [[0.5]], [[0.5]],
                                                         [[0.25]]], dtype)
    hsc = (300.0, 1, g.dlat_rad, g.dlon_rad, g.coslat_cap_02, const.PLANET_RADIUS)
    k4_ops = (k4_operands(dev, dtype, 0, 2, 1, 5.0e3, shape=shape) if small
              else k4_operands(dev, dtype, N_SPECIES, 1, 1, 5.0e3, shape=shape))
    *ops, params = k4_ops
    cases = {
        "median_pos": (lambda x: reductions.masked_median_of_positive(x, 1e-6),
                       lambda x: reductions.masked_median_of_positive_ref(x, 1e-6),
                       [on(dev, x, dtype)], [True]),
        "advect_bilinear": (
            lambda F, u, v: advect.advect_semilag_multi(F, u, v, *sc, g.coslat_cap_tiny),
            lambda F, u, v: advect.advect_semilag_multi_ref(F, u, v, *sc, g.coslat_cap_tiny),
            [on(dev, 280.0 + 20.0 * r.standard_normal((2,) + shape), dtype),
             on(dev, np.clip(60.0 * r.standard_normal(shape), -200, 200), dtype),
             on(dev, np.clip(30.0 * r.standard_normal(shape), -200, 200), dtype)],
            [True, True, True]),
        "hyper4": (lambda F, k: stencil.hyperdiffuse_multi(F, k, *hsc),
                   lambda F, k: stencil.hyperdiffuse_multi_ref(F, k, *hsc),
                   [on(dev, 30.0 * r.standard_normal((5,) + shape), dtype),
                    k4.expand((5,) + shape).contiguous()], [True, False]),
        "ocean_substeps": (lambda *o: ocean.ocean_substeps(*o, **params),
                           lambda *o: ocean.ocean_substeps_plain(*o, **params),
                           list(ops), [True, True, True, False]),
    }
    if small:
        w = on(dev, r.standard_normal(shape[1:]), dtype)

        def relative(fn, xs):
            def call(*m):
                out = _tuple(fn(*(x * mm for x, mm in zip(xs, m))))
                # each output row projected on seeded weights along longitude:
                # the analytical Jacobian takes one backward per output
                return tuple(o if o.dim() == 0 else o @ w for o in out)
            return call
        cases = {name: (relative(fn, xs), None, [torch.ones_like(x) for x in xs], need)
                 for name, (fn, _, xs, need) in cases.items()}
    return cases


def _tuple(out):
    return out if isinstance(out, tuple) else (out,)


def backward_work(name, xs, need, outs):
    """Bytes of one backward: the saved inputs and the output cotangents
    read once, the input cotangents the main path asks for written once."""
    read = sum(x.numel() * x.element_size() for x in xs)
    read += sum(o.numel() * o.element_size() for o in outs)
    return read + sum(x.numel() * x.element_size() for x, n in zip(xs, need) if n)


def phase7_backwards(dev, label, rec):
    """7.1: each kernel's backward on the card: gradcheck in float64 on a
    19×36 grid; the Function's VJP against the plain version's at the main
    path's shapes (float32 and float64); device ms of a backward a call
    beside the forward's."""
    from qingdai_tpu_torch import kernels

    for name, (fn, _, ms, _) in grad_cases(dev, torch.float64, GRADCHECK_SHAPE).items():
        t0 = time.perf_counter()
        ok = torch.autograd.gradcheck(fn, [m.requires_grad_(True) for m in ms],
                                      nondet_tol=GRADCHECK_NONDET)
        if not ok:
            raise AssertionError(f"gradcheck of {name} failed")
        print(f"phase 7: gradcheck {name} float64 {GRADCHECK_SHAPE[0]}x{GRADCHECK_SHAPE[1]} "
              "(every input, relative perturbations, output rows projected along longitude, "
              f"K4 two substeps): passed in {time.perf_counter() - t0:.2f} s")
    for dtype in (torch.float32, torch.float64):
        for name, (fn, plain, xs, need) in grad_cases(dev, dtype).items():
            r = np.random.default_rng(71)
            ins = [x.clone().requires_grad_(True) for x in xs]
            kernels.reset_launch_counts()
            outs = _tuple(fn(*ins))
            if kernels.launch_counts()[name] != 1:
                raise AssertionError(f"{name}: the forward did not launch the kernel")
            cts = [on(dev, r.standard_normal(tuple(o.shape)), dtype) for o in outs]
            got = torch.autograd.grad(outs, ins, cts)
            ref = torch.autograd.grad(_tuple(plain(*ins)), ins, cts)
            worst = 0.0
            for g_, r_ in zip(got, ref):
                scale = float(r_.abs().max())
                err = float((g_ - r_).abs().max()) / max(scale, 1e-300)
                worst = max(worst, err)
            if not worst <= GRAD_TOL[dtype]:
                raise AssertionError(f"{name} {dtype}: the Function's VJP differs from the "
                                     f"plain version's by {worst} > {GRAD_TOL[dtype]}")
            line = (f"phase 7: {name} {dtype} main-path shape: Function VJP against the plain "
                    f"VJP, every input, max|diff|/max|grad| {worst:.2e} (bound "
                    f"{GRAD_TOL[dtype]:g})")
            if dtype == torch.float32:
                ins = [x.clone().requires_grad_(n) for x, n in zip(xs, need)]
                outs = _tuple(fn(*ins))
                wrt = [x for x in ins if x.requires_grad]

                def backward(outs=outs, wrt=wrt, cts=cts):
                    torch.autograd.grad(outs, wrt, cts, retain_graph=True)
                b_ms, b_n = device_profile(backward, what=f"{name}'s backward")
                nbytes = backward_work(name, xs, need, outs)
                rec[name].update(bwd_ms=b_ms, bwd_launches=b_n,
                                 bwd_bound_ms=nbytes / PEAK_BYTES * 1e3)
                line += (f"; backward (the plain version recomputed and its VJP, the inputs "
                         f"the adjoint differentiates) {b_ms:.5f} device ms a call, "
                         f"{b_n:g} device launches, against the kernel's forward "
                         f"{rec[name]['ms']:.5f}; backward bound {nbytes} B "
                         f"{rec[name]['bwd_bound_ms']:.5f} ms [{label}]")
            print(line, flush=True)


def pole_rows(gmap):
    """(max |g| on the two pole rows, max |g| on the other rows) of a map."""
    a = gmap.abs()
    return float(torch.maximum(a[0].max(), a[-1].max())), float(a[1:-1].max())


def phase7_adjoint(dev, label, rec):
    """7.2-7.4: the flagship planet's gradient on the card (module
    docstring, phase 7)."""
    from qingdai_tpu_torch import adjoint as A
    from qingdai_tpu_torch import entry, kernels
    from qingdai_tpu_torch import model as M
    from qingdai_tpu_torch.convert import world_from_numpy

    # 7.2: float32, 24 steps, segment 4, from one warm planetary day: a
    # scalar and two maps
    mdl, flagship = entry.build_world(H, W, extra_env=MAIN)
    with torch.no_grad():
        flagship, _ = M.make_chunk_fn(mdl, STEPS_PER_DAY)(flagship)
    params = {"gh_factor": mdl.cfg.energy.gh_factor, "friction": mdl.static.friction,
              "state.atmos.T_s": flagship.atmos.T_s}
    vg = A.make_value_and_grad(mdl, ADJ_STEPS, segment=ADJ_SEGMENT)
    val = A.make_value(mdl, ADJ_STEPS, segment=ADJ_SEGMENT)
    val(params, flagship)
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    (J, (_, series)), g = vg(params, flagship)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    counts = kernels.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    want = {name: 2 * per_step * ADJ_STEPS for name, _, _, per_step in KERNELS}
    if {k: counts[k] for k in want} != want:
        raise AssertionError(f"phase 7: kernel launches in value_and_grad {counts} != {want} "
                             "(forward and the checkpoint's recompute)")
    dJ = float(g["gh_factor"])
    fmap = g["friction"]
    if not (np.isfinite(float(J)) and np.isfinite(dJ) and dJ > 0.0 and finite(fmap)
            and finite(g["state.atmos.T_s"])):
        raise AssertionError(f"phase 7: J {float(J)}, dJ/d gh_factor {dJ}, maps finite "
                             f"{finite(fmap)}, {finite(g['state.atmos.T_s'])}")
    ts = series["Ts_mean"].cpu().numpy()
    if not (series["Ts_mean"].shape == (ADJ_STEPS,) and 150.0 <= ts.min() <= ts.max() <= 400.0):
        raise AssertionError(f"phase 7: Ts_mean series {ts}")
    poles32 = pole_rows(g["state.atmos.T_s"])

    def timed(fn):
        torch.cuda.synchronize()
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t) * 1e3 / ADJ_STEPS

    # the timed calls repeat the first: each gradient must equal its bits
    times, again = {"value": [], "value_and_grad": []}, []
    for _ in range(2):
        times["value"].append(timed(lambda: val(params, flagship)))
        times["value_and_grad"].append(timed(lambda: again.append(vg(params, flagship)[1])))
    repeat = {k: max(float((h[k] - g[k]).abs().max()) for h in again) for k in g}
    print(f"phase 7: two more identical gradient calls against the first, largest "
          f"|difference|: " + ", ".join(f"{k} {v:.3e}" for k, v in repeat.items())
          + f" [{label}]")
    if any(v != 0.0 for v in repeat.values()):
        raise AssertionError(f"phase 7: identical gradient calls differ: {repeat}")
    del again
    v_ms, vg_ms = (statistics.median(times[k]) for k in ("value", "value_and_grad"))
    prof = {k: profile_steps(fn, ADJ_STEPS, f"the adjoint's {k}")
            for k, fn in (("value", lambda: val(params, flagship)),
                          ("value_and_grad", lambda: vg(params, flagship)))}
    top = adjoint_top_ops(lambda: vg(params, flagship))
    print(f"phase 7: flagship planet 181x360 f32, {ADJ_STEPS}-step window (segment "
          f"{ADJ_SEGMENT}) from one warm planetary day: J = Ts_mean {float(J):.6f} K, "
          f"dJ/d gh_factor {dJ:.6e} K, friction map finite (max|dJ/dfriction| "
          f"{float(fmap.abs().max()):.6e}); kernel launches in value_and_grad {counts} "
          f"(forward + the checkpoint's recompute); first call {first_s:.2f} s [{label}]")
    print(f"phase 7: adjoint ms per window-step: value {v_ms:.4f} ({times['value']}), "
          f"value_and_grad {vg_ms:.4f} ({times['value_and_grad']}), ratio "
          f"{vg_ms / v_ms:.3f}; peak device memory in value_and_grad {peak / 2**30:.3f} GiB; "
          f"device a window-step: value {prof['value'][0]:.4f} ms in {prof['value'][1]:.1f} "
          f"launches (idle {1 - prof['value'][0] / v_ms:.3f}), value_and_grad "
          f"{prof['value_and_grad'][0]:.4f} ms in {prof['value_and_grad'][1]:.1f} launches "
          f"(idle {1 - prof['value_and_grad'][0] / vg_ms:.3f}) [{label}]")
    print("phase 7: value_and_grad's device time by op, ms a window-step: "
          + "; ".join(f"{n} {ms / ADJ_STEPS:.4f} ({c / ADJ_STEPS:.1f} calls)"
                      for n, ms, c in top) + f" [{label}]")
    bwd = {name: per_step * rec[name]["bwd_ms"] for name, _, _, per_step in KERNELS}
    print("phase 7: the kernels' backwards at their calls a step (phase 7.1's device ms a "
          "call × 3, 3, 1, 1): " + ", ".join(f"{k} {v:.4f}" for k, v in bwd.items())
          + f", together {sum(bwd.values()):.4f} ms a window-step of the gradient's "
          f"{prof['value_and_grad'][0]:.4f} [{label}]", flush=True)
    del vg, val, g, fmap, series

    # 7.3: float32 against float64. Over the 24 steps the adjoint grows from
    # the pole rows (their cos cap of 1e-6 puts ~2700 cells of departure
    # per m/s of wind), faster in float64; it is printed there, and the bound
    # is held on the 12-step window
    m64, _ = entry.build_world(H, W, extra_env=MAIN, dtype=torch.float64)
    s64 = world_from_numpy(flagship, dev, torch.float64)
    g0 = m64.cfg.energy.gh_factor
    (_, _), g64 = A.make_value_and_grad(m64, ADJ_STEPS, segment=ADJ_SEGMENT)(
        {"gh_factor": g0, "state.atmos.T_s": s64.atmos.T_s}, s64)
    dJ64 = float(g64["gh_factor"])
    poles64 = pole_rows(g64["state.atmos.T_s"])
    print(f"phase 7: {ADJ_STEPS} steps, dJ/d gh_factor float32 {dJ:.9e}, float64 "
          f"{dJ64:.12e} (not held); max|dJ/dT_s0| on the pole rows against the other rows: "
          f"float32 {poles32[0]:.3e} / {poles32[1]:.3e}, float64 {poles64[0]:.3e} / "
          f"{poles64[1]:.3e}")
    del g64
    dJs = {}
    for dtype, (mm, ss) in ((torch.float32, (mdl, flagship)), (torch.float64, (m64, s64))):
        (_, _), gc = A.make_value_and_grad(mm, ADJ_CMP_STEPS, segment=ADJ_SEGMENT)(
            {"gh_factor": g0}, ss)
        dJs[dtype] = float(gc["gh_factor"])
    rel32 = abs(dJs[torch.float32] - dJs[torch.float64]) / abs(dJs[torch.float64])
    print(f"phase 7: {ADJ_CMP_STEPS} steps, dJ/d gh_factor float32 "
          f"{dJs[torch.float32]:.9e} against float64 {dJs[torch.float64]:.12e}: relative "
          f"{rel32:.3e} (bound 2e-2)")
    if not rel32 <= 2e-2:
        raise AssertionError(f"phase 7: float32 and float64 gradients differ by {rel32}")

    # 7.4: a 6-step float64 window against its central difference and the CPU
    vg6 = A.make_value_and_grad(m64, ADJ_FD_STEPS, segment=3)
    (_, _), g6 = vg6({"gh_factor": g0}, s64)
    val6 = A.make_value(m64, ADJ_FD_STEPS, segment=3)
    Jp, _ = val6({"gh_factor": g0 + ADJ_FD_EPS}, s64)
    Jm, _ = val6({"gh_factor": g0 - ADJ_FD_EPS}, s64)
    fd = (float(Jp) - float(Jm)) / (2 * ADJ_FD_EPS)
    card = float(g6["gh_factor"])
    t0 = time.perf_counter()
    mcpu, _ = entry.build_world(H, W, extra_env=MAIN, device="cpu", dtype=torch.float64)
    (_, _), gc = A.make_value_and_grad(mcpu, ADJ_FD_STEPS, segment=3)(
        {"gh_factor": g0}, world_from_numpy(flagship, "cpu", torch.float64))
    cpu = float(gc["gh_factor"])
    rel_fd, rel_cpu = abs(card - fd) / abs(fd), abs(card - cpu) / abs(cpu)
    print(f"phase 7: {ADJ_FD_STEPS}-step float64 window: dJ/d gh_factor on the card "
          f"{card:.12e}, central difference (eps {ADJ_FD_EPS:g}) {fd:.12e}: relative "
          f"{rel_fd:.3e} (bound 1e-4); on the CPU {cpu:.12e} "
          f"({time.perf_counter() - t0:.1f} s): relative {rel_cpu:.3e} (bound 1e-8) [{label}]")
    if not rel_fd <= 1e-4:
        raise AssertionError(f"phase 7: card gradient and central difference differ by {rel_fd}")
    if not rel_cpu <= 1e-8:
        raise AssertionError(f"phase 7: card and CPU float64 gradients differ by {rel_cpu}")
    return {"value_ms": v_ms, "value_and_grad_ms": vg_ms, "peak_bytes": peak}


def adjoint_top_ops(fn, n=8):
    """PyTorch's ops in one ``fn()`` by their kernels' device time, most
    first: (op name, device ms, calls)."""
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        time.sleep(PROFILE_WAIT_S)
        fn()
        torch.cuda.synchronize()
    rows = [(e.key, e.self_device_time_total / 1e3, e.count) for e in prof.key_averages()
            if e.self_device_time_total > 0]
    return sorted(rows, key=lambda t: -t[1])[:n]


# ------------------------------------------------------------- phase 8

ASSIM_MEMBERS = 8
ASSIM_OBS = 500
ASSIM_FIELDS = ("T_s", "sst", "h", "q", "u", "v")        # the CLI's default --fields
ASSIM_SPIN = 48         # steps that give 8.1's members spread in every field
# 8.2: the CLI's defaults (chaos truth, 500 T_s observations, σ 0.5 K,
# 2000 km, inflation 1.04, RTPS 0.6) with the day of 240 steps, the 5
# burn-in cycles and the 8 cycles cut to keep the phase near 90 s
ASSIM_CYCLE = ["--members", str(ASSIM_MEMBERS), "--warmup-days", "0", "--burnin-cycles", "1",
               "--cycles", "3", "--cycle-steps", "48", "--json"]
ASSIM_AUGMENTED = ["--members", str(ASSIM_MEMBERS), "--warmup-days", "0", "--burnin-cycles",
                   "0", "--cycles", "2", "--cycle-steps", "48", "--est-param", "gh_factor",
                   "--json"]
# 8.1: the card's float64 analysis against the CPU's, and float32
# Newton–Schulz against float32 eigh, each field within this share of the
# field's largest |value|
ASSIM_F64_TOL = 1e-10
ASSIM_F32_TOL = 1e-5


def field_errors(a, b, X):
    """max|a − b| of each field [k, F, C] over the field's max|X|."""
    return [float((a[:, f] - b[:, f]).abs().max() / X[:, f].abs().max())
            for f in range(X.shape[1])]


def phase8_analysis(label):
    """8.1: one LETKF analysis of a 181×360 ensemble of 8 members (module
    docstring, phase 8). Returns (device ms, launches, wall ms and peak
    memory of one analysis by solver, host ms of one step build)."""
    from qingdai_tpu_torch import assim as A
    from qingdai_tpu_torch import constants as const
    from qingdai_tpu_torch import ensemble as E
    from qingdai_tpu_torch import entry
    from qingdai_tpu_torch import model as M
    from qingdai_tpu_torch.adjoint import PARAM_ALIASES, inject_path

    dev = torch.device("cuda")
    mdl, base = entry.build_world(H, W, extra_env=MAIN)
    land = mdl.static.land_mask
    gens = [torch.Generator(device=dev).manual_seed(E.member_seed(1, i))
            for i in range(ASSIM_MEMBERS + 1)]
    members = [E.perturb_member(base, g, 1.0, land, 20.0) for g in gens]
    ens, _ = E.make_ensemble_chunk_fn(mdl, ASSIM_SPIN)(E.stack_members(members[1:]))
    truth, _ = M.make_chunk_fn(mdl, ASSIM_SPIN)(members[0])
    g_obs = torch.Generator(device=dev).manual_seed(0)
    cells = A.draw_obs_network(g_obs, mdl, ASSIM_OBS)
    y = A.synthetic_obs(g_obs, truth, cells, "T_s", 0.5)
    k, C = ASSIM_MEMBERS, H * W
    X = A.gather_fields(ens, ASSIM_FIELDS).reshape(k, len(ASSIM_FIELDS), C)
    fidx = torch.zeros(ASSIM_OBS, dtype=torch.long, device=dev)
    lat, lon = mdl.grid.lat_mesh.reshape(-1), mdl.grid.lon_mesh.reshape(-1)
    kw = dict(obs_err=0.5, loc_radius_km=2000.0, inflation=1.04,
              planet_radius_m=const.PLANET_RADIUS)

    def letkf(X, y, cells, fidx, lat, lon, **extra):
        return A.letkf_analysis(X, y, cells, fidx, lat, lon, **kw, **{"rtps": 0.6, **extra})

    # float64: the card against the CPU, and the deviations zero-mean (RTPS,
    # which rescales the deviations alone, leaves the analysis mean as it is)
    args64 = [t.double() for t in (X, y)] + [cells, fidx] + [t.double() for t in (lat, lon)]
    t0 = time.perf_counter()
    card64 = letkf(*args64)
    cpu64 = letkf(*(t.cpu() for t in args64))
    cpu_s = time.perf_counter() - t0
    err64 = field_errors(card64.cpu(), cpu64, args64[0].cpu())
    mean_shift = field_errors(card64.mean(0, keepdim=True),
                              letkf(*args64, rtps=0.0).mean(0, keepdim=True), args64[0])
    # float32: Newton–Schulz against eigh, each against float64
    ns32, eigh32 = (letkf(X, y, cells, fidx, lat, lon, solver=s) for s in ("ns", "eigh"))
    err32 = field_errors(ns32, eigh32, X)
    to64 = [field_errors(a.double(), card64, args64[0]) for a in (ns32, eigh32)]
    moved = float((card64 - args64[0]).abs().max())
    print(f"phase 8: LETKF analysis {H}x{W}, {k} members, fields "
          f"{','.join(ASSIM_FIELDS)}, {ASSIM_OBS} T_s observations (sigma 0.5 K, 2000 km, "
          f"inflation 1.04, RTPS 0.6); float32 matmul precision "
          f"{torch.get_float32_matmul_precision()!r}, TF32 "
          f"{torch.backends.cuda.matmul.allow_tf32}; max increment {moved:.4e}")
    print("phase 8: float64 card against CPU by field (of max|X|): "
          + ", ".join(f"{f} {e:.3e}" for f, e in zip(ASSIM_FIELDS, err64))
          + f" (bound {ASSIM_F64_TOL:g}; the CPU's analysis with the copies {cpu_s:.2f} s); "
          "analysis mean with RTPS 0.6 against RTPS 0: "
          + ", ".join(f"{e:.3e}" for e in mean_shift))
    print("phase 8: float32 Newton-Schulz (25 iterations) against float32 eigh by field: "
          + ", ".join(f"{f} {e:.3e}" for f, e in zip(ASSIM_FIELDS, err32))
          + f" (bound {ASSIM_F32_TOL:g}); against float64: ns "
          + ", ".join(f"{e:.2e}" for e in to64[0]) + "; eigh "
          + ", ".join(f"{e:.2e}" for e in to64[1]))
    if not moved > 0.0:
        raise AssertionError("phase 8: the analysis did not move the ensemble")
    if not max(err64) <= ASSIM_F64_TOL or not max(mean_shift) <= ASSIM_F64_TOL:
        raise AssertionError(f"phase 8: float64 analysis card/CPU {err64}, mean shift "
                             f"{mean_shift}")
    if not max(err32) <= ASSIM_F32_TOL:
        raise AssertionError(f"phase 8: float32 Newton-Schulz against eigh {err32}")
    del card64, cpu64, args64, ns32, eigh32

    # the per-member-parameter forecast builds the step inside each
    # member-step (8.3): its host cost
    g = torch.full((), mdl.cfg.energy.gh_factor, dtype=mdl.dtype, device=dev)
    builds = []
    for _ in range(20):
        t0 = time.perf_counter()
        M.make_step_fn(inject_path(mdl, PARAM_ALIASES["gh_factor"], g))
        builds.append((time.perf_counter() - t0) * 1e3)

    # one analysis through make_analysis_fn, each solver: device ms and
    # launches, wall ms, peak device memory
    rows = {}
    for solver in ("ns", "eigh"):
        cfg = A.AssimConfig(fields=ASSIM_FIELDS, obs_err=0.5, loc_radius_km=2000.0,
                            inflation=1.04, rtps=0.6, solver=solver)
        analysis = A.make_analysis_fn(mdl, cfg, ASSIM_OBS)
        dev_ms, n_dev = device_profile(lambda: analysis(ens, y, cells), reps=5,
                                       what=f"the analysis ({solver})")
        walls = []
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            analysis(ens, y, cells)
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
        base_bytes = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        analysis(ens, y, cells)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() - base_bytes
        rows[solver] = {"device_ms": dev_ms, "launches": n_dev,
                        "wall_ms": statistics.median(walls), "peak_bytes": peak}
        print(f"phase 8: one analysis ({solver}): {dev_ms:.4f} device ms in {n_dev:.1f} "
              f"launches, wall {statistics.median(walls):.4f} ms (median of 5: "
              + ", ".join(f"{w:.3f}" for w in walls) + f"), peak device memory above what "
              f"was allocated before the call {peak / 2**30:.3f} GiB [{label}]", flush=True)
    return rows, statistics.median(builds)


class AssimWatch:
    """While the OSSE CLI runs: each forecast chunk's kernel launches and
    diags, and each analysis's launches, input and output states (the
    analysis writes nothing in place, so the background stays valid beside
    its output)."""

    def __init__(self):
        from qingdai_tpu_torch import assim as A
        from qingdai_tpu_torch import ensemble as E
        self.land = None
        self.forecasts, self.analyses = [], []
        self.saved = [(mod, name, getattr(mod, name)) for mod, name in (
            (E, "make_ensemble_chunk_fn"), (A, "make_param_ensemble_chunk_fn"),
            (A, "make_analysis_fn"), (A, "make_multivar_analysis_fn"),
            (A, "make_augmented_analysis_fn"))]
        for mod, name, make in self.saved:
            setattr(mod, name, self._watching(name, make))

    def _watching(self, name, make):
        from qingdai_tpu_torch import kernels

        def made(mdl, *args, **kw):
            self.land = mdl.static.land_mask == 1
            fn = make(mdl, *args, **kw)

            def call(*a, **k):
                before = kernels.launch_counts()
                out = fn(*a, **k)
                launches = {n: c - before[n] for n, c in kernels.launch_counts().items()}
                if name.endswith("chunk_fn"):
                    self.forecasts.append((launches, out[1]))
                else:
                    after = out[0] if isinstance(out, tuple) else out
                    self.analyses.append((launches, a[0], after, a[-2], a[-1]))
                return out
            return call
        return made

    def restore(self):
        for mod, name, make in self.saved:
            setattr(mod, name, make)


def obs_misfit(ens, y, cells):
    """RMS of the ensemble-mean T_s against the observations at their cells."""
    mean = ens.atmos.T_s.mean(0).reshape(-1)
    return float(torch.sqrt(torch.mean((mean[cells] - y) ** 2)))


def check_osse(watch, steps, tag):
    """Phase 8.2's checks of one OSSE run (module docstring, phase 8):
    every forecast chunk launches the batched forms 3, 3, 1 and 1 times a
    step and no single form, its diags finite; every analysis fits the
    observations closer than its background, launches no kernel, leaves the
    SST over land as it was and q and T_s in range; the last analysis's
    members finite and physical. Returns (the launches a forecast chunk
    must make, the (background, analysis) misfits)."""
    from qingdai_tpu_torch import ensemble as E

    want = path_counts(steps, "_batched")
    for launches, diags in watch.forecasts:
        if launches != want:
            raise AssertionError(f"{tag}: a forecast chunk launched {launches} != {want}")
        bad = [k for k, v in diags.items() if not finite(v)]
        if bad:
            raise AssertionError(f"{tag}: forecast diags not finite: {bad}")
    misfits = []
    for launches, before, after, y, cells in watch.analyses:
        misfits.append((obs_misfit(before, y, cells), obs_misfit(after, y, cells)))
        if not misfits[-1][1] < misfits[-1][0]:
            raise AssertionError(f"{tag}: the analysis fits the observations no closer than "
                                 f"its background: {misfits[-1]}")
        if any(launches.values()):
            raise AssertionError(f"{tag}: the analysis launched kernels {launches}")
        if not torch.equal(after.ocean.sst[:, watch.land], before.ocean.sst[:, watch.land]):
            raise AssertionError(f"{tag}: the analysis changed the SST over land")
        if not (float(after.atmos.q.min()) >= 0.0 and 150.0 <= float(after.atmos.T_s.min())
                and float(after.atmos.T_s.max()) <= 400.0):
            raise AssertionError(f"{tag}: the analysis left q or T_s outside their ranges")
    final = watch.analyses[-1][2]
    for m in range(E.n_members(final)):
        check_run(E.member_state(final, m), {k: v[m] for k, v in watch.forecasts[-1][1].items()},
                  steps, eco=True)
    return want, misfits


def phase8_osse(label, build_ms):
    """8.2 and 8.3: the OSSE CLI in this process (module docstring, phase
    8), functorch's per-member fallback an error."""
    import os
    import warnings

    from qingdai_tpu_torch import assimilate

    from qingdai_tpu_torch import kernels

    rows = {}
    # the CLI reads the QD_* environment: run it on the defaults
    old_env = {k: v for k, v in os.environ.items() if k.startswith("QD_")}
    for tag, argv in (("8.2 OSSE", ASSIM_CYCLE), ("8.3 augmented", ASSIM_AUGMENTED)):
        steps = int(argv[argv.index("--cycle-steps") + 1])
        watch = AssimWatch()
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        try:
            for k in old_env:
                del os.environ[k]
            with warnings.catch_warnings():
                warnings.filterwarnings("error", message=FALLBACK)
                summary = assimilate.main(argv)
        finally:
            os.environ.update(old_env)
            watch.restore()
        wall = time.perf_counter() - t0
        want, misfits = check_osse(watch, steps, tag)
        # the truth's steps launch the single forms, every forecast chunk's
        # the batched ones
        truth_steps = (summary["burnin_cycles"] + summary["cycles"]) * steps
        total = {**path_counts(truth_steps), **{
            k: v for k, v in path_counts(len(watch.forecasts) * steps, "_batched").items()
            if k.endswith("_batched")}}
        if kernels.launch_counts() != total:
            raise AssertionError(f"{tag}: the run launched {kernels.launch_counts()} != {total}")
        cms = summary["cycle_ms"]
        rows[tag] = {"cycle_ms": cms, "wall_s": wall, "series": summary["series"],
                     "member_sim_years_per_hour": summary["forecast_member_sim_years_per_hour"]}
        print(f"phase 8: {tag} {summary['grid']} f32, {summary['members']} members, "
              f"{summary['cycles']} cycles of {steps} steps after {summary['burnin_cycles']} "
              f"burn-in; observation misfit of the mean T_s, background/analysis K by cycle "
              + "; ".join(f"{b:.4f}/{a:.4f}" for b, a in misfits)
              + "; area-weighted RMSE to the truth (not held: from a cold start the members' "
              "white T_s noise leaves the analysis above its background, PERF.md §4), "
              "rmse_b/rmse_a/free K by cycle "
              + "; ".join(f"{r['rmse_b_K']}/{r['rmse_a_K']}/{r.get('rmse_free_K')}"
                          for r in summary["series"])
              + f"; {len(watch.forecasts)} forecast chunks each launching {want}, "
              f"{len(watch.analyses)} analyses launching none, the truth's {truth_steps} "
              f"steps the single forms: the run launched {total}; run {wall:.1f} s [{label}]")
        print(f"phase 8: {tag} ms a cycle: truth {cms['truth']:.1f}, forecast "
              f"{cms['forecast']:.1f} ({cms['forecast'] / steps:.4f} ms/step), free control "
              f"{cms['free']:.1f}, analysis {cms['analysis']:.2f}; forecast "
              f"{summary['forecast_member_sim_years_per_hour']:.3f} member-sim-years/hour "
              f"[{label}]", flush=True)
        if "--est-param" in argv:
            th = [(r["param_mean"], r["param_std"]) for r in summary["series"]]
            if not all(np.isfinite(m) and np.isfinite(s) and s > 0.0 for m, s in th):
                raise AssertionError(f"{tag}: theta mean and spread {th}")
            print(f"phase 8: {tag} gh_factor mean/std by cycle "
                  + "; ".join(f"{m:.6f}/{s:.6f}" for m, s in th)
                  + f" (truth {summary['param_truth']}, prior {summary['param_prior_mean']} ± "
                  f"{summary['param_prior_std']}); the step built inside each member-step "
                  f"{build_ms:.4f} host ms; forecast against 8.2's plain ensemble "
                  f"{cms['forecast'] / rows['8.2 OSSE']['cycle_ms']['forecast']:.3f}×")
    return rows


# ------------------------------------------------------------- phase 9


# the spin-up SOP's environment (scripts' docs/11.4 bundle: the energy path,
# banded initial T_s, the Q_net-coupled ocean, the energy audit), mutation on
SOP_ENV = {"QD_ENERGY_W": "1", "QD_INIT_BANDED": "1", "QD_OCEAN_USE_QNET": "1",
           "QD_ENERGY_AUDIT": "1", "QD_ECO_MUT_RATE": "1"}
SOP_DAYS = (2, 4)                   # 9.1: phase 1 at MLD 5, phase 2 at MLD 50
SEGMENT_DAYS = 2                    # 9.2's two segments; 9.3's segment at each grid
CHAIN_GRIDS = ((361, 720), (721, 1440))
# the stage's own K2-K4 calls against their plain versions: phase 3's
# tolerances, each output (K4: each plane) within this share of its max|value|
STAGE_TOL = {"advect_bilinear": 1e-6, "hyper4": 1e-5, "ocean_substeps": 1e-4}


class _Keeping:
    """A kernel wrapper that keeps its calls' arguments in ``sink``; every
    other attribute (``launches``, the wrapper's own flags) is the wrapped
    function's."""

    def __init__(self, fn, sink):
        object.__setattr__(self, "fn", fn)
        object.__setattr__(self, "sink", sink)

    def __call__(self, *args, **kwargs):
        self.sink.append((args, kwargs))
        return self.fn(*args, **kwargs)

    def __getattr__(self, name):
        return getattr(self.fn, name)

    def __setattr__(self, name, value):
        setattr(self.fn, name, value)


class KernelCalls:
    """Keeps each kernel wrapper's calls of the last step (the arguments the
    path gave it) while a path runs; the wrappers still launch and count.
    ``restore`` puts the wrappers back."""

    def __init__(self):
        import collections

        from qingdai_tpu_torch.kernels import (advect_bilinear, hyper4, median_pos,
                                               ocean_substeps)
        self.targets = {"median_pos": (median_pos, "median_pos_cuda"),
                        "advect_bilinear": (advect_bilinear, "advect_bilinear_cuda"),
                        "hyper4": (hyper4, "hyperdiffuse_cuda"),
                        "ocean_substeps": (ocean_substeps, "ocean_substeps_cuda")}
        self.orig = {k: getattr(mod, fn) for k, (mod, fn) in self.targets.items()}
        self.calls = {k: collections.deque(maxlen=per_step) for k, *_, per_step in KERNELS}
        for k, (mod, fn) in self.targets.items():
            setattr(mod, fn, _Keeping(self.orig[k], self.calls[k]))

    def restore(self):
        for k, (mod, fn) in self.targets.items():
            setattr(mod, fn, self.orig[k])


def _tensors(x):
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, (tuple, list)):
        return [t for y in x for t in _tensors(y)]
    return []


def stage_kernels(calls, label, tag):
    """Each kernel once on the stage's own inputs (its last step's calls)
    against its plain version: K1 bit-equal, K2-K4 within ``STAGE_TOL``;
    then its device ms a call and its bound (each input read once, each
    output written once, at the published HBM rate). Returns {kernel: (ms,
    bound_ms)} of its call with the largest first input."""
    from qingdai_tpu_torch import ocean
    from qingdai_tpu_torch.ops import advect, reductions, stencil

    def plain(name, args, kw):
        if name == "median_pos":
            return reductions.masked_median_of_positive_ref(*args, **kw)
        if name == "advect_bilinear":
            F, u, v, dt, a, dlat, dlon, cos = args
            return advect.bilinear_wrap_gather_multi(F, *advect.departure_indices(
                tuple(F.shape[1:]), u, v, dt, a, dlat, dlon, cos, F.dtype))
        if name == "hyper4":
            return stencil.hyperdiffuse_multi_ref(*args, **kw)
        return ocean.ocean_substeps_plain(*args, **kw)

    out, lines = {}, []
    for name, *_ in KERNELS:
        kernel = calls.orig[name]
        if not calls.calls[name]:
            raise AssertionError(f"{tag}: {name} was not called")
        # timed: the call with the largest first input (K2's [T_s, q] stack)
        timed = max(range(len(calls.calls[name])),
                    key=lambda i: calls.calls[name][i][0][0].numel())
        for i, (args, kw) in enumerate(calls.calls[name]):
            got, ref = _tensors(kernel(*args, **kw)), _tensors(plain(name, args, kw))
            if name == "median_pos":
                if not torch.equal(got[0], ref[0]):
                    raise AssertionError(f"{tag}: K1 call {i} {float(got[0])!r} != "
                                         f"{float(ref[0])!r}")
                worst = 0.0
            else:
                planes = [(g, r) for g_, r_ in zip(got, ref)
                          for g, r in (zip(g_, r_) if name == "ocean_substeps" else [(g_, r_)])]
                errs = [float((g - r).abs().max()) / max(float(r.abs().max()), 1e-30)
                        for g, r in planes]
                worst = max(errs)
                if not worst <= STAGE_TOL[name]:
                    raise AssertionError(f"{tag}: {name} call {i}: max|err|/max|value| "
                                         f"{worst:.3e} > {STAGE_TOL[name]}")
            if i == timed:
                nbytes = (sum(t.numel() * t.element_size() for t in _tensors(list(args))
                              + _tensors(list(kw.values())))
                          + sum(t.numel() * t.element_size() for t in got))
                ms = device_ms(lambda: kernel(*args, **kw), what=f"{tag} {name}")
                out[name] = (ms, nbytes / PEAK_BYTES * 1e3)
                shape = "x".join(str(s) for s in _tensors(list(args))[0].shape)
                lines.append(f"{name} [{shape}] {ms:.5f} ms (bound {out[name][1]:.5f}, "
                             f"{nbytes} B; {ms / out[name][1]:.1f}x), max|err|/max|value| "
                             f"{worst:.2e}")
    print(f"{tag}: the stage's kernels on its last step's inputs, against their plain "
          f"versions (K1 bit-equal, K2-K4 within {STAGE_TOL}), device ms a call: "
          + "; ".join(lines) + f" [{label}]")
    return out


class StageClock:
    """Wall time of the world's builds and of each chunk (the card
    synchronised before and after) while a path runs; ``restore`` puts the
    methods back. Also counts the flux-cache bootstraps."""

    def __init__(self):
        from qingdai_tpu_torch import hydro_network, spinup
        from qingdai_tpu_torch import world as world_mod
        self.builds, self.chunks, self.network, self.topo, self.bootstraps = [], [], [], [], 0
        cls = world_mod.QingdaiWorld
        bootstrap_caches = cls._bootstrap_flux_caches
        self.saved = [(cls, "__init__", cls.__init__), (cls, "step_chunk", cls.step_chunk),
                      (cls, "_bootstrap_flux_caches", bootstrap_caches),
                      (hydro_network, "build_network", hydro_network.build_network),
                      (spinup, "_ensure_topography", spinup._ensure_topography)]
        clock = self

        def timed(into, fn, sync=False):
            def wrapped(*args, **kwargs):
                if sync:
                    torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = fn(*args, **kwargs)
                if sync:
                    torch.cuda.synchronize()
                into.append(time.perf_counter() - t0)
                return out
            return wrapped

        def bootstrap(world):
            clock.bootstraps += 1
            return bootstrap_caches(world)

        cls.__init__ = timed(self.builds, cls.__init__)
        cls.step_chunk = timed(self.chunks, cls.step_chunk, sync=True)
        cls._bootstrap_flux_caches = bootstrap
        hydro_network.build_network = timed(self.network, hydro_network.build_network)
        spinup._ensure_topography = timed(self.topo, spinup._ensure_topography)

    def restore(self):
        for obj, name, fn in self.saved:
            setattr(obj, name, fn)


def load_sidecar(path):
    return torch.load(path, map_location="cpu", weights_only=True)


def sidecar_state_check(payload, tag):
    """The saved state's floating leaves finite (the albedo caches' NaN
    sentinels aside) and physical: T_s in [150, 450] K in every cell (150 K
    is the energy path's floor), |u| and |v| <= 200 m/s."""
    st = payload["state"]
    bad = [k for k, v in st.items() if isinstance(v, torch.Tensor) and v.is_floating_point()
           and "alpha" not in k and not bool(torch.isfinite(v).all())]
    ts, u, v = st["atmos.T_s"], st["atmos.u"].abs().max(), st["atmos.v"].abs().max()
    if bad or not (150.0 <= float(ts.min()) and float(ts.max()) <= 450.0
                   and float(u) <= 200.0 and float(v) <= 200.0):
        raise AssertionError(f"{tag}: non-finite leaves {bad[:8]} or unphysical state: T_s in "
                             f"[{float(ts.min())}, {float(ts.max())}] K, max|u| {float(u)}, "
                             f"max|v| {float(v)}")
    return float(ts.min()), float(ts.max()), float(max(u, v))


def series_check(s, tag):
    bad = [k for k in KEYS9 if not np.isfinite(s[k]).all()]
    if bad:
        raise AssertionError(f"{tag}: non-finite chunk means in {bad}")


# the chunk-mean keys every SOP run must give finite (scripts' KEYS, the
# routing and audit scalars of the flagship planet with the energy audit on)
KEYS9 = ("TOA_net", "SFC_net", "ATM_net", "Ts_mean", "E_mean", "P_mean", "R_mean", "LH_mean",
         "LH_release_mean", "total_reservoir_mean", "CWV_mean", "ICE_mean", "W_land_mean",
         "S_snow_mean", "routing_mass_error_kg", "routing_routed_mass_kg", "aud_part",
         "aud_qdamp")
RECORD_KEYS = ("protocol", "grid", "phase1", "phase2", "acceptance", "accepted", "wall_hours")


def sop_run(argv, watch_phases=None):
    """``spinup.main(argv)`` in this process, with the launch counts set to 0
    just before and read just after; each phase's series (and, for the
    phases named in ``watch_phases``, a copy of ``data/`` as the phase left
    it) kept. Returns (record, {phase: series}, launch counts, StageClock)."""
    import shutil

    from qingdai_tpu_torch import kernels, spinup

    series, orig = {}, spinup.run_phase

    def keeping(name, *args, **kwargs):
        out = orig(name, *args, **kwargs)
        series[name] = out
        if watch_phases and name in watch_phases:
            shutil.copytree("data", watch_phases[name])
        return out

    spinup.run_phase = keeping
    clock = StageClock()
    kernels.reset_launch_counts()
    try:
        spinup.main(argv)
        counts = kernels.launch_counts()
    finally:
        spinup.run_phase = orig
        clock.restore()
    name = argv[argv.index("--out") + 1] if "--out" in argv else spinup.DEFAULT_OUT
    with open(os.path.join("output", name)) as f:
        record = json.load(f)
    return record, series, counts, clock


def restart_of(directory):
    """The phase-2 restart a spin-up left in ``directory``/data: the NetCDF
    file, or the torch.save container where no NetCDF library is installed."""
    for ext in (".nc", ".pt"):
        path = os.path.join(directory, "data", "restart_phase2" + ext)
        if os.path.exists(path):
            return path
    raise AssertionError(f"no phase-2 restart in {directory}/data")


def chunk_rate(clock, steps_per_chunk, dt):
    """(ms/step, sim-years/hour) of the run's chunks after its first (the
    card synchronised around each chunk)."""
    from qingdai_tpu_torch.physics.orbital import T_PLANET

    steady = clock.chunks[1:] or clock.chunks
    ms = 1e3 * sum(steady) / (len(steady) * steps_per_chunk)
    return ms, 3600.0 / (ms / 1e3) * dt / T_PLANET


def phase9_spinup(label):
    """The spin-up SOP, the multi-day resume and the staged chain, and the
    world driver's plots (module docstring, phase 9). Returns its rows."""
    import os
    import shutil
    import tempfile

    from qingdai_tpu_torch import constants as const
    from qingdai_tpu_torch import kernels, regrid_restart, spinup
    from qingdai_tpu_torch import world as world_mod
    from qingdai_tpu_torch.config import SimConfig
    from qingdai_tpu_torch.physics.orbital import T_PLANET

    started = time.perf_counter()
    old_env = {k: v for k, v in os.environ.items() if k.startswith("QD_")}
    old_cwd = os.getcwd()
    rows = {}
    with tempfile.TemporaryDirectory(prefix="qd_phase9_") as tmp:
        for k in old_env:
            del os.environ[k]
        os.environ.update(SOP_ENV)
        try:
            dt = SimConfig.from_env().run.dt_seconds
            spd = int(round(const.DAY_SECONDS / dt))

            def years(days):
                return repr(days * const.DAY_SECONDS / T_PLANET)

            def grid(h, w):
                return ["--chunk-days", "1", "--nlat", str(h), "--nlon", str(w)]

            # 9.1: the two-phase SOP at 181x360
            sop = os.path.join(tmp, "sop")
            os.makedirs(sop)
            os.chdir(sop)
            p1, p2 = SOP_DAYS
            after1 = os.path.join(tmp, "data_after_phase1")
            record, series, counts, clock = sop_run(
                ["--phase1-years", years(p1), "--phase2-years", years(p2)] + grid(H, W),
                watch_phases={"phase1": after1})
            if counts != path_counts((p1 + p2) * spd):
                raise AssertionError(f"9.1: launch counts {counts} != "
                                     f"{path_counts((p1 + p2) * spd)}")
            for name, days in (("phase1", p1), ("phase2", p2)):
                series_check(series[name], f"9.1 {name}")
                if len(series[name]["t_years"]) != days:
                    raise AssertionError(f"9.1 {name}: {len(series[name]['t_years'])} chunks")
            missing = [k for k in RECORD_KEYS if k not in record]
            s2 = dict(np.load(os.path.join(
                "output", os.path.splitext(spinup.DEFAULT_OUT)[0] + "_series.npz")))
            m2 = spinup.acceptance_metrics(s2, record["phase2"]["metrics"]["eval_years"])
            crit = spinup.build_criteria(m2)
            if (missing or set(m2) != set(record["phase2"]["metrics"])
                    or crit != record["acceptance"]
                    or record["device"] != torch.cuda.get_device_name(0)):
                raise AssertionError(f"9.1: record keys missing {missing}, metrics keys "
                                     f"{sorted(set(m2) ^ set(record['phase2']['metrics']))}, "
                                     f"acceptance {record['acceptance']} against {crit}, "
                                     f"device {record.get('device')}")
            ms, syh = chunk_rate(clock, spd, dt)
            m = record["phase2"]["metrics"]
            print(f"9.1 SOP {H}x{W} f32: phase 1 {p1} d at MLD 5 from a cold start, phase 2 "
                  f"{p2} d at MLD 50 from the sidecar; launches {counts} "
                  f"(3, 3, 1, 1 a step); every chunk's means finite; phase 2: TOA_net "
                  f"{m['TOA_net_mean_Wm2']:.4f} W/m2, Ts {m['Ts_mean_K']:.4f} K, water "
                  f"residual net of q-damping {m['water_residual_minus_qdamping_rel']:.4e}, LH "
                  f"net of q-damping {m['LH_minus_qdamping_rel']:.4e}, TOA attribution "
                  f"residual {m['TOA_attribution_residual_Wm2']:.4f} W/m2, transient chunks "
                  f"{m['transient_chunks_total']}; acceptance (as build_criteria gives on the "
                  f"series) {record['acceptance']}; {ms:.4f} ms/step, {syh:.3f} "
                  f"sim-years/hour [{label}]", flush=True)
            rows["9.1"] = {"ms_step": ms, "syh": syh, "metrics": m}

            # 9.2: the same phase 2 as two segments from phase 1's data/
            seg = os.path.join(tmp, "resume")
            os.makedirs(seg)
            shutil.copytree(after1, os.path.join(seg, "data"))
            os.chdir(seg)
            if 2 * SEGMENT_DAYS != p2:
                raise AssertionError("9.2's two segments must make 9.1's phase 2")
            seg_args = ["--skip-phase1", "--phase2-years", years(SEGMENT_DAYS)] + grid(H, W)
            _, _, c_a, _ = sop_run(seg_args + ["--out", "seg_a.json"])
            _, _, c_b, _ = sop_run(seg_args + ["--out", "seg_b.json", "--prepend-series",
                                               os.path.join("output", "seg_a_series.npz")])
            want = path_counts(SEGMENT_DAYS * spd)
            if c_a != want or c_b != want:
                raise AssertionError(f"9.2: launch counts {c_a}, {c_b} != {want}")
            one = load_sidecar(os.path.join(sop, "data", "world_ckpt.pt"))
            two = load_sidecar(os.path.join(seg, "data", "world_ckpt.pt"))
            bad = [k for k in one["state"] if not same_bits(one["state"][k],
                                                            two["state"].get(k))]
            if set(one["state"]) != set(two["state"]) or bad:
                raise AssertionError(f"9.2: the resumed phase 2 differs from the uninterrupted "
                                     f"one in {bad[:8]}")
            if not torch.equal(one["generator"], two["generator"]):
                raise AssertionError("9.2: the generators differ")
            merged = dict(np.load(os.path.join("output", "seg_b_series.npz")))
            diff = [k for k in s2 if not same_bits(s2[k], merged.get(k))]
            if set(s2) != set(merged) or diff:
                raise AssertionError(f"9.2: the merged series differs from the uninterrupted "
                                     f"one in {diff}")
            print(f"9.2 resume {H}x{W} f32: phase 2 as {SEGMENT_DAYS} + {SEGMENT_DAYS} days "
                  f"(--skip-phase1, then --skip-phase1 --prepend-series; {SEGMENT_DAYS} daily "
                  f"mutation draws and {SEGMENT_DAYS * EVENTS_PER_DAY} routing events after "
                  f"the split, {int(two['state']['eco.n_active'])} species active) equals the "
                  f"uninterrupted phase 2 bit for bit in all {len(one['state'])} leaves, the "
                  f"generator state and the merged series ({len(merged)} keys) [{label}]",
                  flush=True)

            # 9.3: the staged chain, each stage a phase-2 segment from the
            # previous stage's regridded restart
            src = restart_of(sop)
            for h, w in CHAIN_GRIDS:
                d = os.path.join(tmp, f"chain{h}")
                os.makedirs(d)
                os.chdir(d)
                t0 = time.perf_counter()
                regrid_restart.main(["--in", src, "--out", f"regrid{h}.pt", "--nlat", str(h),
                                     "--nlon", str(w)])
                t_regrid = time.perf_counter() - t0
                tag = f"9.3 {h}x{w}"
                torch.cuda.reset_peak_memory_stats()
                calls = KernelCalls()
                try:
                    record, series, counts, clock = sop_run(
                        ["--restart-in", f"regrid{h}.pt", "--phase2-years",
                         years(SEGMENT_DAYS), "--out", f"chain{h}.json"] + grid(h, w))
                finally:
                    calls.restore()
                peak = torch.cuda.max_memory_allocated() / 2**30
                want = path_counts(SEGMENT_DAYS * spd)
                m = record["phase2"]["metrics"]
                if counts != want or m["transient_chunks_total"] != 0 or clock.bootstraps:
                    raise AssertionError(f"{tag}: launch counts {counts} != {want}, transient "
                                         f"chunks {m['transient_chunks_total']}, flux-cache "
                                         f"bootstraps {clock.bootstraps}")
                series_check(series["phase2"], tag)
                ts_lo, ts_hi, vmax = sidecar_state_check(
                    load_sidecar(os.path.join("data", "world_ckpt.pt")), tag)
                kern = stage_kernels(calls, label, tag)
                ms, syh = chunk_rate(clock, spd, dt)
                print(f"{tag} f32: regrid {t_regrid:.2f} s; host build: topography "
                      f"{sum(clock.topo):.2f} s, river network {sum(clock.network):.2f} s, "
                      f"world {sum(clock.builds):.2f} s (network included); "
                      f"{SEGMENT_DAYS} d from the regridded restart, launches {counts}; no "
                      f"flux-cache bootstrap, no transient chunk; T_s in [{ts_lo:.2f}, "
                      f"{ts_hi:.2f}] K, max|u|,|v| {vmax:.2f} m/s; TOA_net "
                      f"{m['TOA_net_mean_Wm2']:.4f} W/m2, Ts {m['Ts_mean_K']:.4f} K; "
                      f"{ms:.4f} ms/step, {syh:.3f} sim-years/hour; peak device memory "
                      f"{peak:.3f} GiB [{label}]", flush=True)
                rows[tag] = {"ms_step": ms, "syh": syh, "kernels": kern, "peak_gib": peak,
                             "build_s": sum(clock.builds), "regrid_s": t_regrid}
                src = restart_of(d)

            # 9.4: the world driver's plots and diversity diagnostics
            d = os.path.join(tmp, "world")
            os.makedirs(d)
            os.chdir(d)
            os.environ.update({"QD_PLOT_EVERY_DAYS": "1", "QD_ECO_DIVERSITY_ENABLE": "1",
                               "QD_AUTOSAVE_ENABLE": "0"})
            mpl = world_mod.have_matplotlib()
            wd = world_mod.QingdaiWorld(verbose=False)
            kernels.reset_launch_counts()
            t0 = time.perf_counter()
            wd.run(duration_seconds=spd * wd.model.dt)
            t_run = time.perf_counter() - t0
            counts = kernels.launch_counts()
            if counts != path_counts(spd):
                raise AssertionError(f"9.4: launch counts {counts} != {path_counts(spd)}")
            panels = sorted(os.listdir("output"))
            eco = sorted(os.listdir(os.path.join("output", "ecology")))
            want = ["community_day_", "diversity_summary_day_"] + (
                ["alpha_effective_day_", "beta_local_braycurtis_day_"] if mpl else [])
            want_panels = (["state_day_", "truecolor_day_", "ocean_day_", "ecology_day_",
                            "plankton_day_"] if mpl else [])
            lost = ([p for p in want if not any(f.startswith(p) for f in eco)]
                    + [p for p in want_panels if not any(f.startswith(p) for f in panels)])
            if lost or (not mpl and any(f.endswith(".png") for f in panels)):
                raise AssertionError(f"9.4: missing {lost}; output {panels}, ecology {eco}")
            print(f"9.4 world run() {spd} steps {H}x{W} f32 with QD_PLOT_EVERY_DAYS=1, "
                  f"QD_ECO_DIVERSITY_ENABLE=1: matplotlib installed: {mpl}; wrote {panels}, "
                  f"ecology/ {eco}; launches {counts}; run() {t_run:.2f} s, the IO worker's "
                  f"panels and snapshot included [{label}]",
                  flush=True)
            rows["9.4"] = {"matplotlib": mpl, "run_s": t_run}
        finally:
            os.chdir(old_cwd)
            for k in [k for k in os.environ if k.startswith("QD_")]:
                del os.environ[k]
            os.environ.update(old_env)
    print(f"phase 9: {time.perf_counter() - started:.1f} s")
    return rows


# ---------------------------------------------------------------------------
# phase 10: multi-GPU. Every rank is a process of its own on the one card
# (gloo, which stages the card's tensors through host memory: NCCL refuses
# two ranks on one device). The collectives sync with the host, so phase 10
# does not run under sync-debug "error". The times are of N ranks sharing
# one card, not a scaling number. One spawn of 2 ranks runs 10.1, 10.2 and
# 10.4, one of 4 ranks 10.1, 10.2 and 10.3.
# ---------------------------------------------------------------------------

PAR_RANKS = (2, 4)
PAR_WARM = 12                   # steps before 10.2's timed day
# 10.2's diag cadence (QD_DIAG_EVERY): a rank-step's collectives are ~52
# without the diags and ~118 with them (each diag is a sum over ranks)
PAR_DIAG_EVERY = 24
PAR_ENS_B, PAR_ENS_STEPS = 8, 24
PAR_DRYRUN_SEGS = 3
# the kernels a rank of the longitude mesh launches, in their single forms:
# K1, K2 and K4 on their operands gathered whole, K3 on the padded block
# (``ops.members``)
MESH_KERNELS = ("median_pos", "advect_bilinear", "hyper4", "ocean_substeps")
# 10.1: the results that equal the whole grid's bit for bit, and the
# tolerances of the others (of each result's max |value|): the ocean step's
# planes as K4's in phase 3 (the polar ring means' order of summation), the
# area means theirs
PAR_EXACT = ("pad_wrap", "pad_reflect", "pad_nearest", "gauss_reflect", "gauss_wrap",
             "grad_lon", "grad_lat", "div", "vort", "lap", "shapiro", "spectral", "hyper4",
             "hyper4_grid", "advect", "median", "k4_mom_1", "k4_st_1", "k4_mom_2", "k4_st_2")
# K3's substeps on the shard grid's padded maps (``hyper4_grid``): the
# padded maps of a config with this ``dynamics.k4_nsub``
PAR_GRID_NSUB = 2
PAR_TOL = {"float32": 1e-4, "float64": 1e-12}
PAR_MEAN_TOL = {"float32": 1e-5, "float64": 1e-12}


# The sharded ops of 10.1 (and of tests/test_torch_parallel.py) on one set of
# inputs: on a rank's columns (``par_sharded_ops``) and on the whole grid
# (``par_whole_ops``). Every result but the pads, the means and the ocean
# step's polar ring means is bit-equal to the whole grid's: a halo, a
# gather and a kernel move or compute the same values in the same order.
# The means and the ring means differ by their order of summation.
PAR_PAD = 3                     # the pads' columns
PAR_MODES = ("wrap", "reflect", "nearest")
PAR_TRACERS = 10                # chlorophyll planes riding K4's gather


def par_op_inputs(n_lat: int, n_lon: int, seed: int = 0) -> dict:
    """Whole-grid float64 inputs from ``seed``: a field F, winds u, v, a
    3-field stack with its ∇⁴ coefficient maps, a precipitation-like field
    for the median, and an ocean state with its forcing, land and ice."""
    from qingdai_tpu_torch.grid import make_grid
    from qingdai_tpu_torch.topography import create_land_sea_mask

    rng = np.random.default_rng(seed)
    lat = np.linspace(-90.0, 90.0, n_lat)
    lon = np.linspace(0.0, 360.0, n_lon)
    lon_m, lat_m = np.meshgrid(lon, lat)
    land, _ = create_land_sea_mask(lat_m, lon_m, seed=42)
    cos = np.cos(np.deg2rad(lat_m))
    smooth = lambda x: (x + np.roll(x, 1, 1) + np.roll(x, -1, 1)) / 3.0
    g = make_grid(n_lat, n_lon, device="cpu", dtype=torch.float64)
    shape = (n_lat, n_lon)
    return {
        "F": 280.0 + 30.0 * smooth(rng.standard_normal(shape)),
        "u": 15.0 * smooth(rng.standard_normal(shape)),
        "v": 10.0 * smooth(rng.standard_normal(shape)),
        "stack": rng.standard_normal((3,) + shape),
        "k4": (0.02 * g.k4_map_unit.numpy() / 300.0)[None] * np.array([1.0, 1.0, 0.5])[:, None,
                                                                                       None],
        "pos": np.maximum(rng.standard_normal(shape), 0.0) * 1e-4,
        "land": land.astype(np.int32),
        "uo": 0.2 * rng.standard_normal(shape) * (land == 0),
        "vo": 0.2 * rng.standard_normal(shape) * (land == 0),
        "eta": 0.1 * rng.standard_normal(shape) * (land == 0),
        "sst": 275.0 + 25.0 * cos + rng.standard_normal(shape),
        "tracers": np.abs(rng.standard_normal((PAR_TRACERS,) + shape)),
        "Q": 100.0 * rng.standard_normal(shape),
        "ice": (np.abs(lat_m) > 70.0) & (land == 0) & (rng.random(shape) < 0.5),
    }


def par_ops(grid, mesh, t: dict, cfg) -> dict:
    """The ops on tensors ``t`` (the rank's columns, or the whole grid with
    ``mesh`` None). On a rank also ``padded_operands``: how many ranks hold
    a static map of K3's (the ∇⁴ map or the cos map) in the shard grid's
    padded maps that differs from the exchanged one."""
    from qingdai_tpu_torch import constants as const
    from qingdai_tpu_torch.grid import divergence, grad_lonlat, vorticity
    from qingdai_tpu_torch.ocean import ocean_step, ocean_substeps, substep_operands
    from qingdai_tpu_torch.ops.advect import advect_semilag_multi
    from qingdai_tpu_torch.ops.reductions import (area_mean, area_mean_compensated,
                                                  masked_median_of_positive)
    from qingdai_tpu_torch.ops.smooth import gaussian_filter
    from qingdai_tpu_torch.ops.stencil import (hyperdiffuse_multi, laplacian_sphere,
                                               shapiro_filter, spectral_zonal_filter)
    from qingdai_tpu_torch.parallel.halo import all_reduce_sum, pad_lon, single
    from qingdai_tpu_torch.state import OceanState

    a, dlat, dlon = const.PLANET_RADIUS, grid.dlat_rad, grid.dlon_rad
    F, u, v, stack = t["F"], t["u"], t["v"], t["stack"]
    out = {f"pad_{m}": pad_lon(F, PAR_PAD, m, mesh) for m in PAR_MODES}
    out["gauss_reflect"] = gaussian_filter(F, 1.0, mesh=mesh)
    out["gauss_wrap"] = gaussian_filter(F, 1.0, "wrap", "wrap", mesh=mesh)
    out["grad_lon"], out["grad_lat"] = grad_lonlat(grid, F)
    out["div"] = divergence(grid, u, v)
    out["vort"] = vorticity(grid, u, v)
    out["lap"] = laplacian_sphere(F, dlat, dlon, grid.coslat_cap_02, a, mesh)
    out["shapiro"] = shapiro_filter(stack, 2, mesh)
    out["spectral"] = spectral_zonal_filter(stack[0], grid.n_lon, 0.75, 0.5, mesh)
    out["hyper4"] = hyperdiffuse_multi(stack, t["k4"], 300.0, 2, dlat, dlon, grid.coslat_cap_02,
                                       a, mesh)
    # K3's static operands from the grid's maps as the dynamics makes them:
    # on a rank the shard grid's padded maps, which need no exchange
    gs = grid.padded if grid.padded is not None else grid
    coef = torch.tensor([1.0, 1.0, 0.5], dtype=F.dtype, device=F.device)[:, None, None]
    out["hyper4_grid"] = hyperdiffuse_multi(stack, (0.02 * gs.k4_map_unit / 300.0)[None] * coef,
                                            300.0, PAR_GRID_NSUB, dlat, dlon,
                                            gs.coslat_cap_02, a, mesh)
    adv_args = (u, v, 300.0, a, dlat, dlon, grid.coslat_cap_tiny)
    out["advect"] = advect_semilag_multi(stack[:2].contiguous(), *adv_args, mesh)
    out["median"] = masked_median_of_positive(t["pos"], 1e-6, mesh)
    out["area_mean"] = area_mean(F, grid.area_w, mesh=mesh)
    out["area_mean_c"] = area_mean_compensated(F, grid.area_w, mesh=mesh)

    ocfg = cfg.ocean
    land = t["land"]
    ocn = OceanState(uo=t["uo"], vo=t["vo"], eta=t["eta"], sst=t["sst"])
    for n_sub, tracers in ((1, t["tracers"]), (2, None)):
        mom, st, forc, geo, params = substep_operands(grid, ocfg, land, ocn, u, v, t["Q"],
                                                      t["ice"], 300.0, n_sub, tracers)
        out[f"k4_mom_{n_sub}"], out[f"k4_st_{n_sub}"] = ocean_substeps(mom, st, forc, geo,
                                                                       mesh=mesh, **params)
    if not single(mesh):
        p = (grid.padded.width - grid.width) // 2
        differ = not all(torch.equal(getattr(grid.padded, k),
                                     pad_lon(getattr(grid, k), p, "wrap", mesh))
                         for k in ("k4_map_unit", "coslat_cap_02"))
        out["padded_operands"] = all_reduce_sum(
            torch.tensor(float(differ), dtype=torch.float64, device=F.device), mesh)
    ocn2, _ = ocean_step(grid, ocfg, land, ocn, u, v, t["Q"], t["ice"], 0, 300.0, 1)
    for f in ("uo", "vo", "eta", "sst"):
        out[f"ocean_{f}"] = getattr(ocn2, f)
    return out


def par_tensors(inputs: dict, device, dtype, cols=None) -> dict:
    dtypes = {"land": torch.int32, "ice": torch.bool}
    out = {}
    for k, x in inputs.items():
        x = np.asarray(x)
        if cols is not None:
            x = x[..., cols[0]:cols[0] + cols[1]]
        out[k] = torch.as_tensor(np.ascontiguousarray(x)).to(device=device,
                                                             dtype=dtypes.get(k, dtype))
    return out


def par_whole_ops(inputs: dict, device="cpu", dtype=torch.float64) -> dict:
    """The ops on the whole grid (numpy results)."""
    from qingdai_tpu_torch.config import SimConfig
    from qingdai_tpu_torch.grid import make_grid

    n_lat, n_lon = np.asarray(inputs["F"]).shape
    grid = make_grid(n_lat, n_lon, device=device, dtype=dtype)
    out = par_ops(grid, None, par_tensors(inputs, grid.lat.device, dtype), SimConfig.from_env())
    return {k: v.cpu().numpy() for k, v in out.items()}


def par_sharded_ops(mesh, inputs: dict, dtype_names=("float64",)):
    """The ops on this rank's columns of ``inputs`` in each dtype of
    ``dtype_names``, each result gathered whole (a pad: every rank's padded
    block side by side), on a shard grid with the padded maps of a config
    whose dynamics runs ``PAR_GRID_NSUB`` ∇⁴ substeps (``static_pad``);
    rank 0 returns {dtype name: {op: numpy}}, the others None."""
    from qingdai_tpu_torch.config import SimConfig
    from qingdai_tpu_torch.grid import make_grid
    from qingdai_tpu_torch.parallel.halo import all_gather_lon
    from qingdai_tpu_torch.parallel.mesh import shard_grid, static_pad

    n_lat, n_lon = np.asarray(inputs["F"]).shape
    cfg = SimConfig.from_env()
    pad = static_pad(dataclasses.replace(
        cfg, dynamics=dataclasses.replace(cfg.dynamics, k4_nsub=PAR_GRID_NSUB)))
    res = {}
    for name in dtype_names:
        dtype = getattr(torch, name)
        grid = shard_grid(make_grid(n_lat, n_lon, device=mesh.device, dtype=dtype), mesh, pad)
        t = par_tensors(inputs, mesh.device, dtype, cols=(grid.lon0, grid.width))
        out = par_ops(grid, mesh, t, cfg)
        res[name] = {k: (all_gather_lon(v, mesh) if v.dim() else v).cpu().numpy()
                     for k, v in out.items()}
    return res if mesh.rank == 0 else None


def par_rank(mesh, inputs, day_steps, ens_members, dryrun_segs):
    """One rank of phase 10: 10.1's ops in float32 and float64, 10.2's day,
    then 10.4's member mesh (``ens_members`` > 0) or 10.3's dry run
    (``dryrun_segs`` > 0). Rank 0 returns every result; the others their
    launch counts."""
    from qingdai_tpu_torch.parallel import dryrun

    out = {"ops": par_sharded_ops(mesh, inputs, ("float32", "float64")),
           "day": par_day(mesh, day_steps)}
    if ens_members:
        out["ens"] = par_ens(mesh, ens_members, PAR_ENS_STEPS)
    if dryrun_segs:
        t0 = time.perf_counter()
        out["dryrun"] = dryrun.dryrun_rank(mesh, H, W, dryrun_segs)
        out["dryrun"]["seconds"] = time.perf_counter() - t0
    return out


def par_day(mesh, steps):
    """10.2 on a rank: the flagship planet's shard, a warm chunk, then a
    timed chunk of ``steps`` steps (diags every ``PAR_DIAG_EVERY``) with the
    launch counters and the mesh's collective counters from 0; the gathered
    state's check on rank 0."""
    import torch.distributed as dist
    from qingdai_tpu_torch import entry, kernels
    from qingdai_tpu_torch import model as M
    from qingdai_tpu_torch.parallel.mesh import gather_state, shard_model_statics, shard_state

    t0 = time.perf_counter()
    mdl, st = entry.build_world(H, W, extra_env=MAIN, device=mesh.device)
    mdl = shard_model_statics(mdl, mesh)
    st = shard_state(st, mesh, W)
    build_s = time.perf_counter() - t0
    st, _ = M.make_chunk_fn(mdl, PAR_WARM)(st)
    chunk = M.make_chunk_fn(mdl, steps, diag_every=PAR_DIAG_EVERY)
    torch.cuda.synchronize()
    dist.barrier()
    kernels.reset_launch_counts()
    mesh.reset_stats()
    t0 = time.perf_counter()
    st, diags = chunk(st)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    out = {"counts": kernels.launch_counts(), "stats": dict(mesh.stats), "wall_s": wall,
           "build_s": build_s, "width": mdl.grid.width}
    whole = gather_state(st, mesh, W)
    if mesh.rank == 0:
        ts, umax = check_run(whole, diags, steps // PAR_DIAG_EVERY, eco=True)
        rd, _ = check_routing(diags)
        out.update(ts=float(ts[-1]), umax=umax, toa=float(diags["TOA_net"][-1]),
                   ts_field=(float(whole.atmos.T_s.min()), float(whole.atmos.T_s.max())),
                   routed=rd["routing_routed_mass_kg"])
    return out


def par_ens(mesh, B, steps):
    """10.4 on a rank: its B/n members of the flagship ensemble for
    ``steps`` steps, gathered; rank 0 returns the whole ensemble's leaves
    as numpy and its analysis fields, every rank its launch counts."""
    from qingdai_tpu_torch import assim as A
    from qingdai_tpu_torch import convert, entry, kernels
    from qingdai_tpu_torch import ensemble as E

    t0 = time.perf_counter()
    mdl, _ = entry.build_world(H, W, extra_env=MAIN, device=mesh.device)
    ens, gens = E.init_ensemble(mdl, B, h_amp=20.0)
    ens, gens = E.shard_ensemble(ens, mesh, gens)
    kernels.reset_launch_counts()
    ens, _ = E.make_ensemble_chunk_fn(mdl, steps)(ens, gens)
    counts = kernels.launch_counts()
    whole = E.gather_ensemble(ens, mesh)
    if mesh.rank:
        return {"counts": counts}
    return {"counts": counts, "state": convert.world_to_numpy(whole),
            "X": A.gather_fields(whole, ASSIM_FIELDS).cpu(), "seconds": time.perf_counter() - t0}


def phase10_ops(n, got, whole, label):
    """10.1: every sharded op of ``n`` ranks (``got``, by dtype) against the
    whole grid's kernel call (``whole``)."""
    w = W // n
    for name, ops in got.items():
        if ops["padded_operands"] != 0:
            raise AssertionError(f"10.1 {n} ranks {name}: {float(ops['padded_operands']):g} "
                                 "rank(s) made a static operand from the padded maps unlike "
                                 "the exchanged one")
        worst = {}
        for k, ref in whole[name].items():
            g = ops[k]
            if k.startswith("pad_"):
                p = PAR_PAD
                ref = np.concatenate([ref[:, i * w:i * w + w + 2 * p] for i in range(n)], 1)
            if k in PAR_EXACT:
                if not np.array_equal(ref, g, equal_nan=True):
                    raise AssertionError(f"10.1 {n} ranks {name}: {k} differs from the whole "
                                         f"grid's (max|diff| {np.abs(ref - g).max()})")
                continue
            tol = PAR_MEAN_TOL[name] if k.startswith("area_mean") else PAR_TOL[name]
            for i in range(ref.shape[0] if ref.ndim == 3 else 1):
                a, b = (ref[i], g[i]) if ref.ndim == 3 else (ref, g)
                e = float(np.abs(a - b).max()) / max(float(np.abs(a).max()), 1e-30)
                worst[k] = max(worst.get(k, 0.0), e)
                if not e <= tol:
                    raise AssertionError(f"10.1 {n} ranks {name}: {k} plane {i} differs by "
                                         f"{e:.3e} of its max (bound {tol:g})")
        print(f"10.1 {n} ranks {H}x{W} {name}: halo ops, K1, K2 and K4 on the gathered "
              f"operands, K3 (padded) and the Gaussian, Shapiro, spectral, gradient, divergence "
              f"and vorticity ops bit-equal to the whole grid's ({len(PAR_EXACT)} results); the "
              f"ocean step and the means (relative to each plane's max): "
              + ", ".join(f"{k} {e:.2e}" for k, e in worst.items()) + f" [{label}]", flush=True)


def phase10_day(n, res, label):
    """10.2's checks and lines of ``n`` ranks' results."""
    from qingdai_tpu_torch.physics.orbital import T_PLANET

    want = path_counts(STEPS_PER_DAY, "mesh")
    for rank, r_ in enumerate(res):
        if r_["day"]["counts"] != want:
            raise AssertionError(f"10.2 {n} ranks: rank {rank} launched {r_['day']['counts']} "
                                 f"!= {want}")
    r0 = res[0]["day"]
    ms = r0["wall_s"] / STEPS_PER_DAY * 1e3
    per = {k: v / STEPS_PER_DAY for k, v in r0["stats"].items()}
    syh = 3600.0 / (ms / 1000.0) * 300.0 / T_PLANET
    print(f"10.2 flagship {H}x{W} f32 sharded over {n} ranks ({r0['width']} columns a rank, "
          f"gloo on one card): a day of {STEPS_PER_DAY} steps after {PAR_WARM}, diags every "
          f"{PAR_DIAG_EVERY}; launches a rank-day {r0['counts']} (K1 3, K2 3, K3 1 and K4 1 a "
          f"rank-step, K5's and K6's plain versions); Ts_mean {r0['ts']:.3f} K, T_s in "
          f"[{r0['ts_field'][0]:.2f}, {r0['ts_field'][1]:.2f}] K, TOA_net {r0['toa']:.3f} "
          f"W/m2, u_max {r0['umax']:.2f} m/s, last event routed {r0['routed']:.4e} kg; all "
          f"leaves and diags finite", flush=True)
    print(f"10.2 {n} ranks sharing one card: {ms:.3f} ms/step ({syh:.3f} sim-years/hour, not "
          f"a scaling number); a rank-step: {per['collectives']:.2f} collectives, halo "
          f"{per['halo_bytes'] / 1e3:.1f} kB, gathered {per['gather_bytes'] / 1e3:.1f} kB, "
          f"all-reduced {per['reduce_bytes']:.0f} B received; build {r0['build_s']:.1f} s "
          f"[{label}]", flush=True)


def phase10_members(dev, ens, label):
    """10.4: the gathered member-sharded ensemble against the unsharded
    B = 8 run, and one LETKF analysis of each."""
    from qingdai_tpu_torch import assim as A
    from qingdai_tpu_torch import constants as const
    from qingdai_tpu_torch import convert, entry
    from qingdai_tpu_torch import ensemble as E

    want = path_counts(PAR_ENS_STEPS, "_batched")
    if any(r_["counts"] != want for r_ in ens):
        raise AssertionError(f"10.4: launches {[r_['counts'] for r_ in ens]} != {want}")
    mdl, _ = entry.build_world(H, W, extra_env=MAIN)
    ens_all, gens = E.init_ensemble(mdl, PAR_ENS_B, h_amp=20.0)
    ens_all, _ = E.make_ensemble_chunk_fn(mdl, PAR_ENS_STEPS)(ens_all, gens)
    ref, got = convert.world_to_numpy(ens_all), ens[0]["state"]
    diffs = {}
    for k in ref:
        a, b = np.asarray(ref[k]), np.asarray(got[k])
        if a.dtype.kind == "f":
            fin = np.isfinite(a)
            diffs[k] = float(np.abs(a[fin] - b[fin]).max(initial=0.0))
    worst = max(diffs, key=diffs.get)
    same = all(np.array_equal(np.asarray(ref[k]), np.asarray(got[k]), equal_nan=True)
               for k in ref)
    obs_g = torch.Generator(device=dev).manual_seed(0)
    cells = A.draw_obs_network(obs_g, mdl, ASSIM_OBS)
    y = A.synthetic_obs(obs_g, E.member_state(ens_all, 0), cells, "T_s", 0.5)
    lat, lon = mdl.grid.lat_mesh.reshape(-1), mdl.grid.lon_mesh.reshape(-1)
    fidx = torch.zeros(ASSIM_OBS, dtype=torch.long, device=dev)
    an = [A.letkf_analysis(X.to(dev).reshape(PAR_ENS_B, len(ASSIM_FIELDS), -1), y, cells,
                           fidx, lat, lon, obs_err=0.5, loc_radius_km=2000.0, inflation=1.04,
                           planet_radius_m=const.PLANET_RADIUS, rtps=0.6)
          for X in (A.gather_fields(ens_all, ASSIM_FIELDS), ens[0]["X"])]
    an_diff = float((an[0] - an[1]).abs().max())
    print(f"10.4 member mesh: B={PAR_ENS_B} flagship members {H}x{W} f32 over 2 ranks "
          f"({PAR_ENS_B // 2} a rank, launches {ens[0]['counts']}) against the unsharded "
          f"B={PAR_ENS_B} run, {PAR_ENS_STEPS} steps: "
          + ("bit-equal in every leaf" if same else f"max|diff| {diffs[worst]:.3e} at {worst}")
          + f"; one LETKF analysis of the gathered ensemble ({ASSIM_OBS} T_s obs) against the "
          f"unsharded one: max|diff| {an_diff:.3e}; the ranks' part {ens[0]['seconds']:.1f} s "
          f"[{label}]", flush=True)
    if same and an_diff != 0.0:
        raise AssertionError("10.4: equal ensembles gave different analyses")


def phase10_parallel(dev, label):
    """Phase 10 (module docstring): 10.1 the sharded ops, 10.2 the flagship
    planet sharded for a day, 10.3 the dry run, 10.4 the member mesh."""
    from qingdai_tpu_torch.parallel.mesh import spawn_ranks

    started = time.perf_counter()
    inputs = par_op_inputs(H, W, seed=10)
    whole = {name: par_whole_ops(inputs, "cuda", getattr(torch, name)) for name in PAR_TOL}
    for n in PAR_RANKS:
        t0 = time.perf_counter()
        ens_b, segs = (PAR_ENS_B, 0) if n == 2 else (0, PAR_DRYRUN_SEGS)
        res = spawn_ranks(par_rank, n, "gloo", "cuda", (inputs, STEPS_PER_DAY, ens_b, segs))
        print(f"phase 10: {n} ranks in {time.perf_counter() - t0:.1f} s (spawn included)")
        phase10_ops(n, res[0]["ops"], whole, label)
        phase10_day(n, res, label)
        if ens_b:
            phase10_members(dev, [r["ens"] for r in res], label)
        if segs:
            dr = res[0]["dryrun"]
            print(f"10.3 dry run {dr['grid']} f64 over {dr['n_ranks']} ranks (gloo, one card), "
                  f"{dr['n_segs']} resynced half-day segments of {dr['seg_len_steps']} steps "
                  f"at dt 7200 s: "
                  + ", ".join(f"seg{s['seg']} {s['diff']:.3e} at {s['worst']} (ctrl "
                              f"{s['ctrl']:.3e}, bound {s['bound']:.3e})"
                              for s in dr["segments"])
                  + f"; routed {dr['routed_mass_kg']:.4e} kg; Ts [{dr['ts_min_K']:.1f}, "
                  f"{dr['ts_max_K']:.1f}] K; {dr['seconds']:.1f} s [{label}]", flush=True)
    print(f"phase 10: {time.perf_counter() - started:.1f} s")


# ------------------------------------------------------------- phase 11
ASTRO_TIMES = 4096              # verify_calculation's year of times
PLANTS = 1_000_000              # the plant pool of 11.5
PLANT_BANDS, PLANT_DAYS, PLANT_SUBSTEPS = 8, 2, 2
INSOLATION_TOL = {torch.float32: 1e-5, torch.float64: 1e-12}


def rel_max(got: torch.Tensor, want: torch.Tensor) -> float:
    """max |got − want| over max |want|, in float64 on the CPU."""
    got, want = got.detach().cpu().double(), want.detach().cpu().double()
    return float((got - want).abs().max()) / max(float(want.abs().max()), 1e-300)


def plant_inputs(seed: int, n: int, dtype, device):
    """The pool's seeded start (every FSM state present) and each day's
    forcing, made on the CPU from a torch generator and moved to ``device``."""
    gen = torch.Generator().manual_seed(seed)

    def u(lo, hi, *shape):
        return (lo + (hi - lo) * torch.rand(*shape, generator=gen, dtype=torch.float64)).to(
            device=device, dtype=dtype)

    start = {"state": torch.randint(0, 5, (n,), generator=gen).to(device, torch.int8),
             "age_days": torch.randint(0, 12, (n,), generator=gen).to(device, torch.int32),
             "biomass_root": u(0, 2, n), "biomass_stem": u(0, 2, n),
             "biomass_leaf": u(0, 1, n), "energy_storage": u(0, 3, n),
             "gdd_accum": u(0, 30, n), "water_stress_days": u(0, 3, n),
             # leaf areas from 0.05: below that f_LAI = 1 − exp(−k·LA) keeps
             # only ~ulp/(k·LA) of relative precision, and one ulp between
             # the card's exp and the CPU's grows with the plant (ROADMAP.md
             # Queue 3, the differences to allow for)
             "leaf_area": u(0.05, 0.4, n), "E_day_buffer": u(0, 1, n),
             "leaf_area_per_energy": u(0.05, 0.5, n), "drought_tolerance": u(0.2, 0.6, n),
             "gdd_germinate": u(5, 40, n), "lifespan_days": u(4, 20, n)}
    days = [{"I": [u(0, 2, n, PLANT_BANDS) for _ in range(PLANT_SUBSTEPS)],
             "A": [u(-0.1, 1.2, n, PLANT_BANDS) for _ in range(PLANT_SUBSTEPS)],
             "swi_sub": [u(0.2, 1, n) for _ in range(PLANT_SUBSTEPS)],
             "dl": u(5, 20, PLANT_BANDS), "Ts": u(260, 300, n), "swi": u(0, 1, n)}
            for _ in range(PLANT_DAYS)]
    return start, days


def plant_run(device, dtype):
    """The pool of 11.5 from ``plant_inputs``: (the pool after each day, the
    seeds of each day, the first day's pool and forcing, the largest day's
    energy of a plant)."""
    import dataclasses

    from qingdai_tpu_torch.ecology import genes, plant
    start, days = plant_inputs(11, PLANTS, dtype, device)
    p = dataclasses.replace(plant.init_plant_pool(PLANTS, genes.Genes.from_env(), dtype=dtype,
                                                  device=device), **start)
    first = (p, days[0])
    pools, seeds, energy = [], [], 0.0
    for day in days:
        for k in range(PLANT_SUBSTEPS):
            p = plant.pool_substep_bands(p, day["I"][k], day["A"][k], 3600.0, day["dl"],
                                         day["swi_sub"][k])
        energy = max(energy, float(p.E_day_buffer.abs().max()))
        p, s = plant.pool_step_daily(p, day["Ts"], 12.0, day["swi"])
        pools.append(p)
        seeds.append(s)
    return pools, seeds, first, energy


def phase11_tools(dev, label):
    """11: the time-based astronomy, its CLIs, the routing validator and the
    plant pool on the card (module docstring, phase 11)."""
    import contextlib
    import dataclasses
    import io
    import tempfile

    from qingdai_tpu_torch import diag_isr, validate_hydro_routing, verify_calculation
    from qingdai_tpu_torch.ecology import plant
    from qingdai_tpu_torch.grid import make_grid
    from qingdai_tpu_torch.physics import forcing, orbital

    started = time.perf_counter()
    # 11.1: verify_calculation on the card, and the flux over a year against
    # the CPU's
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = verify_calculation.main(["--device", dev.type])
    lines = out.getvalue().splitlines()
    if rc != 0 or lines[-1] != "[Verify] PASS":
        raise AssertionError(f"phase 11: verify_calculation exited {rc}: {lines}")
    ts = np.linspace(0, orbital.T_PLANET, ASTRO_TIMES)
    S_card, S_cpu = orbital.total_flux(ts, dev), orbital.total_flux(ts, "cpu")
    err = rel_max(S_card, S_cpu)
    print(f"phase 11.1: verify_calculation on {dev}: " + " | ".join(lines)
          + f"; total_flux over {ASTRO_TIMES} times float64 card against CPU {err:.3e} "
          f"(bound 1e-13) [{label}]")
    if not err <= 1e-13:
        raise AssertionError(f"phase 11: total_flux on the card differs from the CPU by {err}")

    # 11.2: insolation at 181×360 on the card in float32 and float64 against
    # the CPU in float64, at t = 0 and at t ≈ 1e7 s
    g64 = make_grid(H, W, device="cpu", dtype=torch.float64)
    errs = {}
    for dtype in (torch.float32, torch.float64):
        g = make_grid(H, W, device=dev, dtype=dtype)
        for t in (0.0, 1.234e7):
            for c, (a, b) in enumerate(zip(forcing.insolation_components(g, t),
                                           forcing.insolation_components(g64, t))):
                if a.dtype != dtype:
                    raise AssertionError(f"phase 11: insolation in {a.dtype} on a {dtype} grid")
                errs[(str(dtype).split(".")[-1], t, "AB"[c])] = rel_max(a, b)
    worst = {d: max(e for k, e in errs.items() if k[0] == d) for d in ("float32", "float64")}
    print(f"phase 11.2: insolation_components {H}x{W} on the card against the CPU float64 "
          f"(t = 0 and 1.234e7 s, both stars), max|diff|/max: float32 {worst['float32']:.3e} "
          f"(bound 1e-5), float64 {worst['float64']:.3e} (bound 1e-12) [{label}]")
    if not (worst["float32"] <= INSOLATION_TOL[torch.float32]
            and worst["float64"] <= INSOLATION_TOL[torch.float64]):
        raise AssertionError(f"phase 11: insolation on the card against the CPU {errs}")

    # 11.3: diag_isr on the card (no matplotlib there: the [ISR] line and one more)
    with tempfile.TemporaryDirectory() as tmp:
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            rc = diag_isr.main(["--nlat", str(H), "--nlon", str(W), "--t-days", "100",
                                "--out", tmp, "--device", dev.type])
        lines = out.getvalue().splitlines()
    _, _, r_card = diag_isr.isr_report(make_grid(H, W, device=dev, dtype=torch.float64), 100.0)
    _, _, r_cpu = diag_isr.isr_report(g64, 100.0)
    if rc != 0 or not lines[0].startswith("[ISR] t=100.00 d") or not same_report(r_card, r_cpu):
        raise AssertionError(f"phase 11: diag_isr {rc} {lines}; card {r_card}, CPU {r_cpu}")
    print(f"phase 11.3: diag_isr on the card: " + " | ".join(lines)
          + f"; its float64 numbers against the CPU's: the same subsolar cells, maxima within "
          f"1e-12, separation {r_card['separation_deg']:.9f} against "
          f"{r_cpu['separation_deg']:.9f} degrees [{label}]")

    # 11.4: the routing validator at 181×360 on the card (float32, as its CLI
    # runs), and float64 against the CPU
    t0 = time.perf_counter()
    r32 = validate_hydro_routing.validate(H, W, device=dev, dtype=torch.float32)
    wall = time.perf_counter() - t0
    r64 = validate_hydro_routing.validate(H, W, device=dev, dtype=torch.float64)
    rc64 = validate_hydro_routing.validate(H, W, device="cpu", dtype=torch.float64)
    inflow_err = abs(r64["ocean_inflow_kgps"] - rc64["ocean_inflow_kgps"]) / rc64[
        "ocean_inflow_kgps"]
    print(f"phase 11.4: validate_hydro_routing {H}x{W} on the card float32: "
          f"{r32['violations']} ocean-sink violations, ocean inflow "
          f"{r32['ocean_inflow_kgps']:.6e} kg/s, closure relative error {r32['rel_err']:.3e}, "
          f"network build {r32['build_s']:.3f} s (host), the whole check {wall:.3f} s wall; "
          f"float64 inflow against the CPU's {inflow_err:.3e} (bound 1e-12), closure "
          f"{r64['rel_err']:.3e} [{label}]")
    if not (r32["ok"] and r64["ok"] and inflow_err <= 1e-12):
        raise AssertionError(f"phase 11: routing validator {r32} {r64} {rc64}")

    # 11.5: the plant pool of 1e6 plants on the card against the CPU in
    # float64 (two days of two substeps and a daily step), and device ms a
    # daily step and a substep in float32 and float64
    card, seeds_card, first, _ = plant_run(dev, torch.float64)
    cpu, seeds_cpu, _, energy = plant_run("cpu", torch.float64)
    errs = {}
    for a, b, sa, sb in zip(card, cpu, seeds_card, seeds_cpu):
        for f in dataclasses.fields(a):
            x, y = getattr(a, f.name), getattr(b, f.name)
            if x.dtype in (torch.int8, torch.int32):
                if not torch.equal(x.cpu(), y):
                    raise AssertionError(f"phase 11: plant pool {f.name} differs on the card")
                continue
            # the bank keeps the rounding of a day's energy, summed over the
            # bands in the card's order, once the seeds' whole units leave it
            scale = max(energy, float(y.abs().max())) if f.name == "energy_storage" else None
            err = (float((x.cpu() - y).abs().max()) / scale if scale else rel_max(x, y))
            errs[f.name] = max(errs.get(f.name, 0.0), err)
        if not torch.equal(sa.cpu(), sb):
            raise AssertionError("phase 11: the plant pool's seeds differ on the card")
    field = max(errs, key=errs.get)
    worst = errs[field]
    states = torch.bincount(card[-1].state.long(), minlength=5).tolist()
    times = {}
    for dtype in (torch.float32, torch.float64):
        p, day = first
        if dtype != torch.float64:
            p = dataclasses.replace(p, **{f.name: getattr(p, f.name).to(dtype)
                                          for f in dataclasses.fields(p)
                                          if getattr(p, f.name).is_floating_point()})
            day = {k: [x.to(dtype) for x in v] if isinstance(v, list) else v.to(dtype)
                   for k, v in day.items()}
        times[dtype] = (
            device_ms(lambda: plant.pool_step_daily(p, day["Ts"], 12.0, day["swi"]),
                      what=f"pool_step_daily {dtype}"),
            device_ms(lambda: plant.pool_substep_bands(p, day["I"][0], day["A"][0], 3600.0,
                                                       day["dl"], day["swi_sub"][0]),
                      what=f"pool_substep_bands {dtype}"))
    print(f"phase 11.5: plant pool of {PLANTS} plants, {PLANT_BANDS} bands, {PLANT_DAYS} days of "
          f"{PLANT_SUBSTEPS} substeps, float64 card against CPU: states, ages and seeds equal, "
          f"floats max|diff|/max {worst:.3e} ({field}; bound 1e-12); states at the end "
          f"{states}; device ms a daily step / a substep: float32 {times[torch.float32][0]:.5f} / "
          f"{times[torch.float32][1]:.5f}, float64 {times[torch.float64][0]:.5f} / "
          f"{times[torch.float64][1]:.5f} [{label}]")
    if not worst <= 1e-12:
        raise AssertionError(f"phase 11: the plant pool on the card differs by {worst}")
    print(f"phase 11: {time.perf_counter() - started:.1f} s", flush=True)


def same_report(a: dict, b: dict) -> bool:
    """diag_isr's numbers on two devices: the same subsolar cells, the maxima
    within 1e-12 relative, the separation within 1e-6 degrees (an arccos
    near 0 magnifies the last bits)."""
    return (set(a) == set(b)
            and all(a[k] == b[k] for k in ("lat_A", "lon_A", "lat_B", "lon_B"))
            and all(abs(a[k] - b[k]) <= 1e-12 * abs(b[k]) for k in ("max_A", "max_B"))
            and abs(a["separation_deg"] - b["separation_deg"]) <= 1e-6)


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    # ``--phase 3``, ``4``, ``9``, ``10`` or ``11``: the kernels' build and
    # that phase alone, no record line
    only = argv[1] if len(argv) == 2 and argv[0] == "--phase" else None
    if argv and only not in ("3", "4", "9", "10", "11"):
        print(f"chip_smoke: unknown arguments {argv} (none, --phase 3, 4, 9, 10 or 11)",
              file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    import qingdai_tpu_torch  # noqa: F401  (fails outside a checkout of the repo)
    from qingdai_tpu_torch.kernels import build

    started = time.perf_counter()
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
    if only in ("3", "4"):
        if only == "3":
            phase3_kernels(dev, label, rate)
        else:
            phase4_paths(label)
        print(f"chip_smoke: phase {only} alone in {time.perf_counter() - started:.1f} s; card: "
              f"{label}")
        return 0
    if only == "9":
        phase9_spinup(label)
        print(f"chip_smoke: phase 9 alone in {time.perf_counter() - started:.1f} s; card: {label}")
        return 0
    if only == "10":
        phase10_parallel(dev, label)
        print(f"chip_smoke: phase 10 alone in {time.perf_counter() - started:.1f} s; card: "
              f"{label}")
        return 0
    if only == "11":
        phase11_tools(dev, label)
        print(f"chip_smoke: phase 11 alone in {time.perf_counter() - started:.1f} s; card: "
              f"{label}")
        return 0

    rec = phase3_kernels(dev, label, rate)
    st, counts = phase4_paths(label)
    ens_counts, _ = phase4b_ensemble(label)
    counts.update({k: v for k, v in ens_counts.items() if k.endswith("_batched")})
    worst = phase5_cpu_reference(st, dev)
    print(f"phase 5: card and CPU float64 steps agree to {worst:.2e} relative")
    del st
    phase6_world(label)
    phase7_backwards(dev, label, rec)
    phase7_adjoint(dev, label, rec)
    _, build_ms = phase8_analysis(label)
    phase8_osse(label, build_ms)
    phase9_spinup(label)
    phase10_parallel(dev, label)
    phase11_tools(dev, label)

    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    kernels_line = [{"name": name + form, "route": "cuda", "source": src, "replaces": rep,
                     "launches": counts[name + form], **{k: rec[name + form][k] for k in keys}}
                    for form in ("", "_batched")
                    for name, src, rep, _ in KERNELS + [PHYTO_KERNEL, GAUSS_KERNEL]]
    print(f"torch.profiler: {len(PROFILE_LOG['empty'])} of {PROFILE_LOG['taken']} profiles held "
          f"no device event; timed with CUDA events instead: {PROFILE_LOG['events']}")
    print(f"chip_smoke: phases 1-11 in {time.perf_counter() - started:.1f} s")
    print(f"card: {label}")
    print(json.dumps({"kernels": kernels_line}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
