"""How ``correct`` is decided: the measured step's outputs against the frozen
plain reference (``qbench.ref``).

During a run the harness records, for the members of the check plan
(``plan.check_plan``), each member's initial state, its state when the
window starts, and the input, output and diagnostics of one ordinary step,
one routing-event step and one day-end step of the window (``Recorder``,
copies in host memory). After the window has closed and the measured
package's state is freed, the reference builds its own world from the same
inputs and

- ``start``: works out each member's initial state again (``ref.members``),
  clock included, and compares it with the measured one;
- ``warmup``: runs the warm-up's steps from its own initial state and
  compares the state the window starts from by the largest share of a
  leaf's entries that part (``states.worst_share``: by more than ``PART``
  of the leaf's largest value). A share and not a worst gap, because a few
  cells part over a run of steps that each side takes on its own: next to
  the poles the ocean's η swings between its ±5 m caps, and a last-bit
  difference of a step (the program's reductions add in another order)
  sends a cell to the other cap, which moves the currents, the fluxes and
  the air above it; a reference nudged by one ulp parts in the same cells
  (``control --witness``);
- ``ordinary``, ``routing``, ``dayend``: runs one step from the measured
  input state of that step (the reference cannot follow a chaotic float32
  trajectory over hundreds of steps, so it follows the program step by step
  there) and compares the state the step returned;
- ``diag``: the diagnostics of those three steps.

Each number but ``warmup`` is the largest ``states.leaf_gap`` over the
members and leaves (or diagnostics) it covers, and ``warmup`` the largest
share over the members and leaves; each is held to the limit of the cell's
limits file.
The control (``control``) is the same reference in bfloat16 put in the
program's place.
"""

from __future__ import annotations

import dataclasses
import importlib

import torch

from . import plan, states, trace, world

REF = "qbench.ref"
CHECKS = ("start", "warmup", "ordinary", "routing", "dayend", "diag")
PART = 1e-3
ETA = "ocean.eta"


class Recorder:
    """Copies of what the check compares, in host memory. The window's
    copies go into buffers allocated at set-up (pinned, on a card) without a
    synchronisation: each is queued on the stream after the step that made
    its state, and read once the window has closed. They are launched inside
    the ``trace.RECORD`` span, so that a trace can tell them from the
    program's work."""

    def __init__(self, check_plan: plan.CheckPlan, shared: frozenset, ens):
        self.plan, self.shared = check_plan, shared
        pin = any(isinstance(v, torch.Tensor) and v.is_cuda for v in states.leaves(ens).values())
        like = states.member_leaves(ens, 0, shared, copy=False)
        self.buffers = lambda: {m: {k: torch.empty(v.shape, dtype=v.dtype, pin_memory=pin)
                                    if isinstance(v, torch.Tensor) else None
                                    for k, v in like.items()} for m in check_plan.members}
        self.start = self.copy(ens, self.buffers())
        self.window0 = self.buffers()
        self._bufs = {k: (self.buffers(), self.buffers()) for k in check_plan.steps}
        self.steps = {}
        self._diags = {}

    def copy(self, ens, bufs) -> dict:
        """``bufs`` filled with the plan's members of ``ens``."""
        for key, v in states.leaves(ens).items():
            g, f = key.split(".")
            for m, b in bufs.items():
                if isinstance(v, torch.Tensor):
                    b[key].copy_(v if (g, f) in self.shared else v[m], non_blocking=True)
                else:
                    b[key] = v
        return bufs

    def before(self, k: int, ens) -> None:
        if k in self.plan.steps:
            with torch.profiler.record_function(trace.RECORD):
                self.copy(ens, self._bufs[k][0])

    def after(self, k: int, ens, diags) -> None:
        if k in self.plan.steps:
            with torch.profiler.record_function(trace.RECORD):
                self.copy(ens, self._bufs[k][1])
                self._diags[k] = {m: {key: v[m, -1].clone() for key, v in diags.items()}
                                  for m in self.plan.members}
            self.steps[k] = self._bufs[k]

    def done(self) -> bool:
        return len(self.steps) == len(self.plan.steps)

    def finish(self) -> None:
        """Once the device has synchronised: the diagnostics to the host."""
        self.steps = {k: (i, o, {m: {key: v.cpu() for key, v in d.items()}
                                 for m, d in self._diags[k].items()})
                      for k, (i, o) in self.steps.items()}


def cast_tree(obj, dtype, src=torch.float32):
    """``obj`` (a model or state of dataclasses, tuples and tensors) with
    every ``src`` tensor and dtype in ``dtype``."""
    if isinstance(obj, torch.Tensor):
        return obj.to(dtype) if obj.dtype == src else obj
    if isinstance(obj, torch.dtype):
        return dtype if obj == src else obj
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return dataclasses.replace(obj, **{f.name: cast_tree(getattr(obj, f.name), dtype, src)
                                           for f in dataclasses.fields(obj) if f.init})
    if isinstance(obj, tuple) and hasattr(obj, "_fields"):
        return type(obj)(*(cast_tree(x, dtype, src) for x in obj))
    if isinstance(obj, (list, tuple)):
        return type(obj)(cast_tree(x, dtype, src) for x in obj)
    if isinstance(obj, dict):
        return {k: cast_tree(v, dtype, src) for k, v in obj.items()}
    return obj


def _as_dtype(flat: dict, dtype) -> dict:
    return {k: v.to(dtype) if isinstance(v, torch.Tensor) and v.is_floating_point() else v
            for k, v in flat.items()}


class Reference:
    """The reference's model of the cell's configuration, and its step from
    a state in flat leaves. ``control`` puts the reference in bfloat16 (the
    precision below the configuration's float32): its model and every input
    state cast to it, its outputs cast back to compare."""

    def __init__(self, inputs: world.Inputs, device, dtype, control: bool = False):
        # float32 products in float32, not TF32 (the reference runs after
        # the measured window)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self.device, self.dtype, self.control = device, dtype, control
        self.model = world.build(REF, inputs, device, dtype)
        if control:
            self.model = cast_tree(self.model, torch.bfloat16, dtype)
        self.M = importlib.import_module(REF + ".model")
        self.members = importlib.import_module(REF + ".members")
        self.state_mod = importlib.import_module(REF + ".state")
        self._step = self.M.make_step_fn(self.model)

    def initial(self, m: int, seed: int, traffic: dict, start_step: int):
        """(member ``m``'s initial state with the run's clock, its generator)."""
        st, g = self.members.init_member(self.model, m, seed, float(traffic["perturb_k"]),
                                         float(traffic.get("h_amp", 0.0)))
        return plan.set_clock(st, self.model, self.state_mod, start_step), g

    def step(self, st, g=None):
        draws = (self.members.mutation_draws(self.model, st, g)
                 if g is not None and self.M.mutation_due(self.model, st.clock) else None)
        return self._step(st, draws)

    def state(self, flat: dict):
        return states.build_state(REF, flat, self.device,
                                  torch.bfloat16 if self.control else None)

    def out(self, flat: dict) -> dict:
        return _as_dtype(flat, self.dtype) if self.control else flat


def replay_generator(ref: Reference, g, st, n_steps: int):
    """Member generator ``g`` after the mutation draws of ``n_steps`` steps
    from ``st`` (the draws' shapes do not depend on the state's values)."""
    for due in ref.M.mutation_schedule(ref.model, st.clock, n_steps):
        if due:
            ref.members.mutation_draws(ref.model, st, g)
    return g


def warmup_detail(prod: dict, ref: dict, top: int = 4, cells: int = 6) -> dict:
    """What parts after the warm-up: the ``top`` leaves by gap and by the
    share of entries that part, and η's parted cells (how many, and the two
    sides' values at the first ``cells`` of them)."""
    gaps = sorted(((states.leaf_gap(prod[k], v), k) for k, v in ref.items()), reverse=True)
    shares = sorted(((states.parted_share(prod[k], v, PART), k) for k, v in ref.items()),
                    reverse=True)
    mask = states.parted(prod[ETA], ref[ETA], PART)
    p, r = torch.as_tensor(prod[ETA]).cpu(), ref[ETA].cpu()
    at = [tuple(int(i) for i in ix) for ix in mask.nonzero()[:cells]]
    return {"worst_leaves": [[k, g] for g, k in gaps[:top]],
            "most_parted": [[k, v] for v, k in shares[:top]], "eta_parted": int(mask.sum()),
            "eta_cells": int(mask.numel()),
            "eta_parted_at": [[list(ix), float(p[ix]), float(r[ix])] for ix in at]}


def compare(rec: Recorder, inputs: world.Inputs, device, dtype, seed: int, traffic: dict,
            start_step: int, n_warmup: int, control: bool = False,
            ref: Reference = None, low: Reference = None, detail: list = None) -> dict:
    """{check: (gap, where)} of the recorded run against the reference (or,
    with ``control``, of the bfloat16 reference against the float32 one).
    ``ref`` and ``low`` may be given built; ``detail``, a list, gets each
    member's ``warmup_detail``."""
    ref = ref or Reference(inputs, device, dtype)
    if control:
        low = low or Reference(inputs, device, dtype, control=True)
    out = {c: (0.0, None) for c in CHECKS}

    def note(check, gap, where):
        if gap >= out[check][0]:
            out[check] = (gap, where)

    n_steps = n_warmup + max(rec.plan.steps, default=-1) + 1
    for m in rec.plan.members:
        st, g = ref.initial(m, seed, traffic, start_step)
        mutation = any(ref.M.mutation_schedule(ref.model, st.clock, n_steps))
        flat0 = states.leaves(st)
        if control:
            note("start", *states.worst_gap(low.out(states.leaves(low.state(flat0))), flat0))
        else:
            note("start", *states.worst_gap(rec.start[m], flat0))
        run, run_low = st, low.state(rec.start[m]) if control else None
        for _ in range(n_warmup):
            run, _ = ref.step(run, g)
            if control:
                run_low, _ = low.step(run_low, None)
        prod = low.out(states.leaves(run_low)) if control else rec.window0[m]
        warm = states.leaves(run)
        note("warmup", *states.worst_share(prod, warm, PART))
        if detail is not None:
            detail.append(dict(member=m, **warmup_detail(prod, warm)))
        for k, kind in rec.plan.steps.items():
            cin, cout, cdiag = rec.steps[k]
            st_in = ref.state(cin[m])
            gk = None
            if mutation:
                _, gk = ref.initial(m, seed, traffic, start_step)
                gk = replay_generator(ref, gk, st, n_warmup + k)
            new, diag = ref.step(st_in, gk)
            ref_flat = states.leaves(new)
            if control:
                nl, dl = low.step(low.state(cin[m]), None)
                prod, prod_diag = low.out(states.leaves(nl)), low.out(dl)
            else:
                prod, prod_diag = cout[m], cdiag[m]
            note(kind, *states.worst_gap(prod, ref_flat))
            note("diag", *states.worst_gap(prod_diag, diag))
    return out
