"""Spans around the layers of the measured package, and the reading of a
``torch.profiler`` trace into device time by span.

The spans come from the benchmark's own files: in a traced run the harness
wraps, under ``torch.profiler.record_function``, the names through which the
callers reach each layer (``install``), and restores them afterwards. The
package itself is not changed. A device operation (kernel, copy or memset)
belongs to every span that encloses the host call that launched it (the
CUDA runtime call with the same correlation id), so a span's device time is
inclusive of the spans inside it.
"""

from __future__ import annotations

import bisect
import contextlib
import dataclasses
import functools
import importlib
import time

import torch

STEP = "qb.step"
# the harness's copies of what the check compares (``check.Recorder``)
RECORD = "qb.record"
# (module of the measured package, attribute, span name): the callers reach
# each layer through these names
SPANS = (
    ("model", "atmos_step", "dynamics.atmos_step"),
    ("model", "ocean_step", "ocean.ocean_step"),
    ("model", "routing_step", "routing.routing_step"),
    ("ecology.population", "eco_step_daily", "ecology.eco_step_daily"),
    ("ecology.population", "eco_step_subdaily", "ecology.eco_step_subdaily"),
    ("ecology.population", "surface_albedo_bands", "ecology.surface_albedo_bands"),
    ("ecology.individuals", "indiv_step_daily", "ecology.indiv_step_daily"),
    ("ecology.individuals", "indiv_try_substep", "ecology.indiv_try_substep"),
    ("ecology.phyto", "phyto_step_daily", "ecology.phyto_step_daily"),
    ("ecology.phyto", "phyto_apply_transport", "ecology.phyto_apply_transport"),
    ("ecology.phyto", "phyto_advect_diffuse", "ecology.phyto_advect_diffuse"),
    ("ocean", "ocean_substeps", "K4.ocean_substeps"),
    ("model", "masked_median_of_positive", "K1.model"),
    ("dynamics", "masked_median_of_positive", "K1.dynamics"),
    ("physics.clouds", "masked_median_of_positive", "K1.clouds"),
)


def _batch_size(t) -> int:
    """The member count a tensor inside ``torch.func.vmap`` stands for (1
    for a tensor the members share)."""
    F = torch._C._functorch
    n = 1
    while isinstance(t, torch.Tensor) and F.is_batchedtensor(t):
        inner = F.get_unwrapped(t)
        n *= inner.shape[F.maybe_get_bdim(t)]
        t = inner
    return n


def tensor_bytes(obj) -> int:
    """Bytes of every tensor in ``obj`` (tensors, tuples, lists, dicts), each
    counted once for every member it carries."""
    if isinstance(obj, torch.Tensor):
        return obj.numel() * obj.element_size() * _batch_size(obj)
    if isinstance(obj, (tuple, list)):
        return sum(tensor_bytes(x) for x in obj)
    if isinstance(obj, dict):
        return sum(tensor_bytes(x) for x in obj.values())
    return 0


@dataclasses.dataclass
class Spans:
    """Per span name: the bytes its calls read and wrote (inputs and
    outputs, each once), counted while ``counting`` is on."""
    bytes: dict = dataclasses.field(default_factory=dict)
    calls: dict = dataclasses.field(default_factory=dict)
    counting: bool = False

    def wrap(self, fn, name):
        @functools.wraps(fn)
        def wrapped(*args, **kwargs):
            with torch.profiler.record_function(name):
                out = fn(*args, **kwargs)
            if self.counting:
                self.bytes[name] = (self.bytes.get(name, 0) + tensor_bytes(args)
                                    + tensor_bytes(kwargs) + tensor_bytes(out))
                self.calls[name] = self.calls.get(name, 0) + 1
            return out
        return wrapped


@contextlib.contextmanager
def install(package: str, spans: Spans):
    """The SPANS wrappers in place while the block runs."""
    saved = []
    try:
        for mod, attr, name in SPANS:
            m = importlib.import_module(f"{package}.{mod}")
            fn = getattr(m, attr)
            saved.append((m, attr, fn))
            setattr(m, attr, spans.wrap(fn, name))
        yield spans
    finally:
        for m, attr, fn in reversed(saved):
            setattr(m, attr, fn)


@dataclasses.dataclass
class DeviceOp:
    name: str
    kind: str
    start: int        # ns, the profiler's clock
    end: int
    launch: int       # host ns of the launching runtime call (-1 if not found)


@dataclasses.dataclass
class Trace:
    """A traced window read from the profiler: the device operations, the
    host spans by name (sorted (start, end) pairs, ns), the window's bounds
    and the step calls' host times."""
    ops: list
    spans: dict
    t0: int
    t1: int
    n_steps: int
    step_kinds: list
    host_s: list

    @property
    def window_s(self) -> float:
        return (self.t1 - self.t0) * 1e-9

    def inside(self, names) -> list:
        """The device operations launched inside any span named in ``names``."""
        ivs = [self.spans[n] for n in names if n in self.spans]
        return [op for op in self.ops if any(_within(iv, op.launch) for iv in ivs)]

    def busy_ns(self, ops=None) -> int:
        """The union of the device operations' intervals within the window."""
        ivs = sorted((max(o.start, self.t0), min(o.end, self.t1)) for o in (ops or self.ops))
        total, cur_s, cur_e = 0, None, None
        for s, e in ivs:
            if e <= s:
                continue
            if cur_e is None or s > cur_e:
                if cur_e is not None:
                    total += cur_e - cur_s
                cur_s, cur_e = s, e
            else:
                cur_e = max(cur_e, e)
        if cur_e is not None:
            total += cur_e - cur_s
        return total


def _within(ivs, t) -> bool:
    """Whether host time ``t`` lies in one of the sorted, disjoint spans."""
    i = bisect.bisect_right(ivs, (t, float("inf"))) - 1
    return i >= 0 and ivs[i][0] <= t <= ivs[i][1]


def read_profile(prof, n_steps: int, step_kinds: list, host_s: list) -> Trace:
    """The Trace of a finished ``torch.profiler.profile``: its device events
    (kernels, copies, memsets; not the device copies of the spans), each
    placed at the host time of the CUDA runtime call that launched it (same
    correlation id) or else of the operator it is linked to, and the
    harness's spans."""
    names = {STEP, RECORD} | {name for _, _, name in SPANS}
    calls, ops_at, spans, dev = {}, {}, {}, []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == torch.autograd.DeviceType.CPU:
            if e.name().startswith("cuda"):
                # a runtime call: its correlation id is its device operation's
                calls[e.correlation_id()] = e.start_ns()
            else:
                ops_at[e.correlation_id()] = e.start_ns()
                if e.name() in names:
                    spans.setdefault(e.name(), []).append((e.start_ns(), e.end_ns()))
        elif e.name() not in names:
            dev.append((e.name(), e.start_ns(), e.end_ns(), e.correlation_id(),
                        e.linked_correlation_id()))
    ops = [DeviceOp(n, _kind(n), s, t, calls.get(c, ops_at.get(lc, -1)))
           for n, s, t, c, lc in dev]
    for v in spans.values():
        v.sort()
    steps = spans.get(STEP, [])
    if not steps:
        raise RuntimeError("the profile holds no step span")
    t0 = steps[0][0]
    t1 = max([steps[-1][1]] + [o.end for o in ops])
    return Trace(ops, spans, t0, t1, n_steps, step_kinds, host_s)


def _kind(name: str) -> str:
    low = name.lower()
    if low.startswith("memcpy"):
        return "gpu_memcpy"
    if low.startswith("memset"):
        return "gpu_memset"
    return "kernel"


def breakdown(tr: Trace, top: int = 10) -> dict:
    """The device operations that took most time, and the idle gaps summed
    by the innermost span that the next operation was launched in."""
    by_name = {}
    for o in tr.ops:
        by_name[o.name] = by_name.get(o.name, 0) + (o.end - o.start)
    device_ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    ivs = sorted(tr.ops, key=lambda o: o.start)
    gaps = {}
    cur = tr.t0
    for o in ivs:
        if o.start > cur:
            label = _innermost(tr, o.launch)
            gaps[label] = gaps.get(label, 0) + (o.start - cur)
        cur = max(cur, o.end)
    if tr.t1 > cur:
        gaps["window end"] = gaps.get("window end", 0) + (tr.t1 - cur)
    idle = sorted(gaps.items(), key=lambda kv: -kv[1])[:top]
    return {"device_ops": [[n, v * 1e-9] for n, v in device_ops],
            "idle_gaps": [[n, v * 1e-9] for n, v in idle]}


def _innermost(tr: Trace, t: int) -> str:
    best, best_start = "harness (outside the step)", None
    for name, ivs in tr.spans.items():
        i = bisect.bisect_right(ivs, (t, float("inf"))) - 1
        if i >= 0 and ivs[i][0] <= t <= ivs[i][1]:
            if best_start is None or ivs[i][0] >= best_start:
                best, best_start = name, ivs[i][0]
    return best


def idle(seconds: float, cuda: bool) -> None:
    """Leave the device idle for ``seconds``."""
    if cuda:
        torch.cuda.synchronize()
    time.sleep(seconds)


def start_profile(cuda: bool):
    """A running ``torch.profiler.profile`` of the host and, on a card, the
    device, with 50 ms of idle device on each side of its start (the
    profiler loses kernels launched in its first milliseconds)."""
    idle(0.05, cuda)
    acts = [torch.profiler.ProfilerActivity.CPU]
    if cuda:
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=acts)
    prof.__enter__()
    idle(0.05, cuda)
    return prof
