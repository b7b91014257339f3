"""One run of one cell: set-up, warm-up, the measured window, and the check.

The window drives the measured package's ``ensemble.make_ensemble_chunk_fn``
chunk of one step (its ``run_steps`` → one ``torch.func.vmap`` of
``model.make_step_fn``'s step over the members) in a closed loop: the next
call is issued as soon as the last returns, with no host synchronisation
between steps, a CUDA event recorded after each call, and one
synchronisation when the window closes.
"""

from __future__ import annotations

import contextlib
import dataclasses
import importlib
import sys
import time

import torch

from . import check, plan, states, trace, world

PACKAGE = "qingdai_tpu_torch"


def log(t_start: float, what: str) -> None:
    print(f"[qbench {time.perf_counter() - t_start:8.2f} s] {what}", file=sys.stderr, flush=True)


class Device:
    """Events and synchronisation on the card; on the CPU (the tests, which
    drive a run without a card) host clock stamps in their place."""

    def __init__(self, device: torch.device):
        self.device = device
        self.cuda = device.type == "cuda"

    def sync(self):
        if self.cuda:
            torch.cuda.synchronize(self.device)

    def event(self):
        if self.cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            return ev
        return time.perf_counter()

    def elapsed_ms(self, a, b) -> float:
        return a.elapsed_time(b) if self.cuda else (b - a) * 1e3

    def reset_peak(self):
        if self.cuda:
            torch.cuda.reset_peak_memory_stats(self.device)

    def peak_bytes(self) -> int:
        return torch.cuda.max_memory_allocated(self.device) if self.cuda else 0


@dataclasses.dataclass
class Run:
    """What the metrics' readers read."""
    cell: object
    n_members: int
    dt: float
    setup_s: float
    kernel_build_s: float = 0.0   # the kernel library's build, left out of setup_s
    steps: int = 0
    window_s: float = 0.0
    step_ms: list = dataclasses.field(default_factory=list)
    host_s: list = dataclasses.field(default_factory=list)
    peak_bytes: int = 0
    leaf_bytes: dict = dataclasses.field(default_factory=dict)   # the ensemble's, by leaf
    trace: object = None
    spans: object = None
    extra: dict = dataclasses.field(default_factory=dict)


def build_kernels(dev: Device) -> float:
    """Seconds spent building the measured package's kernel library: 0 on
    the CPU, and where a build of these sources is already in the checkout
    (every run of a checkout but its first)."""
    if not dev.cuda:
        return 0.0
    build = importlib.import_module(PACKAGE + ".kernels.build")
    if build.library_path().is_file():
        return 0.0
    t = time.perf_counter()
    build.build()
    return time.perf_counter() - t


def run(cell, seed: int, seconds: float, traced: bool, device, t_start: float,
        dtype_override=None, size_override=None):
    """(Run, check results). ``t_start``: the host clock when the process
    started. ``size_override`` ({"n_lat", "n_lon"}) and ``dtype_override``
    serve the tests, which drive a whole run on the CPU at a small size."""
    dev = Device(torch.device(device))
    config = dict(cell.config, **(size_override or {}))
    traffic = cell.traffic
    dtype = dtype_override or world.DTYPES[config["dtype"]]
    E = importlib.import_module(PACKAGE + ".ensemble")
    S = importlib.import_module(PACKAGE + ".state")
    B = int(traffic["members"])
    start_step = int(traffic["start_step"])

    # ---- the kernel library's build, once a checkout: timed apart ----
    build_s = build_kernels(dev)
    if build_s:
        log(t_start, f"kernel library built in {build_s:.2f} s (not counted in setup_s)")
    # ---- set-up: the inputs, the measured package's world and members ----
    dev.reset_peak()
    inputs = world.make_inputs(config)
    model = world.build(PACKAGE, inputs, dev.device, dtype)
    ens, gens = E.init_ensemble(model, B, seed=seed, perturb_k=float(traffic["perturb_k"]),
                                h_amp=float(traffic.get("h_amp", 0.0)))
    ens = plan.set_clock(ens, model, S, start_step)
    log(t_start, f"world built and {B} members initialised")
    n_warm = plan.warmup_steps(model, start_step)
    window_start = start_step + n_warm
    rec = check.Recorder(plan.check_plan(model, seed, B, window_start, traffic),
                         E.SHARED_LEAVES, ens)
    chunk = E.make_ensemble_chunk_fn(model, 1, int(traffic["diag_every"]))
    out = Run(cell=cell, n_members=B, dt=float(model.dt), setup_s=0.0, kernel_build_s=build_s,
              spans=trace.Spans())

    with contextlib.ExitStack() as stack:
        if traced:
            stack.enter_context(trace.install(PACKAGE, out.spans))
        # ---- warm-up: every kind of step once (through the first day end),
        # dispatched ahead as the window is ----
        for _ in range(n_warm):
            ens, _ = chunk(ens, gens)
        dev.sync()
        log(t_start, f"warm-up of {n_warm} steps done")
        rec.copy(ens, rec.window0)
        out.leaf_bytes = {k: v.numel() * v.element_size()
                          for k, v in states.leaves(ens).items() if isinstance(v, torch.Tensor)}
        clock = plan.clock_at(model, window_start)
        kinds = []
        n_trace = int(traffic["trace_steps"]) if traced else 0
        prof = trace.start_profile(dev.cuda) if traced else None
        out.spans.counting = traced
        retries = 1 if dev.cuda else 0

        # ---- the measured window ----
        dev.sync()
        t0 = time.perf_counter()
        out.setup_s = t0 - t_start - build_s
        ev0 = dev.event()
        events, k = [], 0
        while True:
            rec.before(k, ens)
            kinds.append(clock.advance())
            h0 = time.perf_counter()
            with torch.profiler.record_function(trace.STEP):
                ens, diags = chunk(ens, gens)
            out.host_s.append(time.perf_counter() - h0)
            events.append(dev.event())
            rec.after(k, ens, diags)
            k += 1
            if prof is not None and k == n_trace:
                dev.sync()
                out.spans.counting = False
                prof.__exit__(None, None, None)
                first = k - int(traffic["trace_steps"])
                out.trace = trace.read_profile(prof, k - first, kinds[first:],
                                               out.host_s[first:])
                prof = None
                if not out.trace.ops and retries:
                    # an empty profile: once more over the next steps
                    retries -= 1
                    out.spans = trace.Spans(counting=True)
                    prof, n_trace = trace.start_profile(dev.cuda), k + n_trace - first
            if time.perf_counter() - t0 >= seconds and prof is None:
                break
        dev.sync()
        out.window_s = time.perf_counter() - t0
        out.steps = k
        marks = [ev0] + events
        out.step_ms = [dev.elapsed_ms(a, b) for a, b in zip(marks, marks[1:])]
        log(t_start, f"window closed: {k} steps in {out.window_s:.3f} s")
        # answers due in the window that it did not reach come late, not wrong
        while not rec.done():
            rec.before(k, ens)
            ens, diags = chunk(ens, gens)
            rec.after(k, ens, diags)
            k += 1
        dev.sync()
        # through the window's first day end, whether the window reached it
        # or not, so that the peak does not hang on the window's length
        out.peak_bytes = dev.peak_bytes()
        rec.finish()
    if out.trace is not None:
        log(t_start, f"trace read: {len(out.trace.ops)} device operations")
    del ens, gens, chunk, model
    if dev.cuda:
        torch.cuda.empty_cache()
    out.extra.update(recorder=rec, inputs=inputs, n_warmup=n_warm)
    results = check.compare(rec, inputs, dev.device, dtype, seed, traffic, start_step, n_warm)
    log(t_start, "reference compared")
    return out, results
