"""The schedule of a run: where on the simulated day it starts, which kind
each step is, and which steps and members the check compares.

The step's cadences are host numbers that depend only on the step count
and dt (the day accumulator, the phytoplankton day and the routing event
clock, each rounded to the model dtype after every add), so the benchmark
walks them here with the step's own rules and knows before a run which
step is an ordinary step, a routing event or a day end. A run starts from
the members' initial states with the clock of ``start_step`` steps into the
first day (``clock_at``), as a restart at that time would hold it.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

ORDINARY, ROUTING, DAY_END = "ordinary", "routing", "dayend"


_NUMPY = {torch.float32: np.float32, torch.float64: np.float64}


def round_to(x: float, dtype: torch.dtype) -> float:
    """``x`` rounded to ``dtype``, as a host float (the step's ``round_to``)."""
    if dtype in _NUMPY:
        return float(_NUMPY[dtype](x))
    return float(torch.tensor(x, dtype=torch.float64).to(dtype))


@dataclasses.dataclass
class HostClock:
    """The step's host accumulators, advanced as the step advances them."""
    dt: float
    day: float
    dt_hydro: float
    dtype: torch.dtype
    step_idx: int = 0
    accum_t_day: float = 0.0
    phyto_accum: float = None
    t_route: float = 0.0

    def __post_init__(self):
        if self.phyto_accum is None:
            # the phytoplankton day fires on the first step
            self.phyto_accum = round_to(self.day, self.dtype)

    def advance(self) -> str:
        """Advance one step; return its kind (a day end wins over a
        routing event that falls on the same step)."""
        r = lambda x: round_to(x, self.dtype)
        dt_r, day_r = r(self.dt), r(self.day)
        accum = r(self.accum_t_day + dt_r)
        day_end = accum >= day_r
        self.accum_t_day = r(accum - day_r) if day_end else accum
        pa = r(self.phyto_accum + dt_r)
        self.phyto_accum = r(pa - day_r) if pa >= day_r else pa
        t = r(self.t_route + dt_r)
        routing = r(t + r(1e-9)) >= r(self.dt_hydro)
        self.t_route = 0.0 if routing else t
        self.step_idx += 1
        return DAY_END if day_end else ROUTING if routing else ORDINARY


def host_clock(model) -> HostClock:
    """The host clock of a model of either side, at the start of a run."""
    cfg = model.cfg
    return HostClock(dt=float(model.dt), day=float(model.day_seconds),
                     dt_hydro=float(cfg.hydrology.dt_hydro_hours) * 3600.0, dtype=model.dtype)


def clock_at(model, start_step: int) -> HostClock:
    clock = host_clock(model)
    for _ in range(start_step):
        clock.advance()
    return clock


def set_clock(state, model, state_mod, start_step: int):
    """``state`` (one planet or an ensemble) with the clock of
    ``start_step`` steps after t = 0: the time and phases of
    ``state_mod.init_clock`` at that time (``state_mod`` is the side's own
    ``state`` module), the host accumulators walked by ``HostClock``, the
    day's precipitation so far kept as it is."""
    hc = clock_at(model, start_step)
    fresh = state_mod.init_clock(model.grid, start_step * float(model.dt), model.dtype)
    clock = dataclasses.replace(
        state.clock, t_seconds=fresh.t_seconds, phase_rot=fresh.phase_rot,
        phase_binary=fresh.phase_binary, phase_planet=fresh.phase_planet,
        step_idx=hc.step_idx, accum_t_day=hc.accum_t_day, phyto_accum=hc.phyto_accum)
    routing = state.routing
    if routing is not None:
        routing = dataclasses.replace(routing, t_accum=hc.t_route)
    return dataclasses.replace(state, clock=clock, routing=routing)


def first_day(model, start_step: int) -> list:
    """The kinds of the steps from ``start_step`` through the first day end."""
    clock = clock_at(model, start_step)
    kinds = []
    while not kinds or kinds[-1] != DAY_END:
        kinds.append(clock.advance())
        if len(kinds) > 10 ** 6:
            raise ValueError("no day end in reach")
    return kinds


def warmup_steps(model, start_step: int) -> int:
    """Steps from ``start_step`` through the first day end: every kind of
    step the window runs, once at least."""
    kinds = first_day(model, start_step)
    missing = {ORDINARY, ROUTING, DAY_END} - set(kinds)
    if missing:
        raise ValueError(f"the warm-up from step {start_step} runs no {sorted(missing)} step: "
                         "choose another start_step")
    return len(kinds)


def rng(seed: int, salt: int) -> np.random.Generator:
    """The benchmark's own draws for ``seed`` (any whole number)."""
    return np.random.default_rng(np.random.SeedSequence([int(seed) % 2 ** 64, salt]))


@dataclasses.dataclass(frozen=True)
class CheckPlan:
    members: tuple        # the members compared (never only member 0)
    steps: dict           # window step → kind, one of each kind


def check_plan(model, seed: int, n_members: int, window_start: int, traffic: dict) -> CheckPlan:
    """The members and window steps that the check compares, drawn from
    ``seed``: one member from each half of the batch (so a half left out
    shows) and ``check_members`` in all; an ordinary step drawn among the
    window's ordinary steps before its first routing event, its first
    routing event and its first day end."""
    g = rng(seed, 1)
    k = min(int(traffic["check_members"]), n_members)
    half = n_members // 2
    if n_members == 1:
        members = [0]
    else:
        members = [int(g.integers(1, half)) if half > 1 else 0, int(g.integers(half, n_members))]
        rest = [m for m in range(1, n_members) if m not in members]
        members += [int(m) for m in g.choice(rest, size=min(k - 2, len(rest)), replace=False)]
    kinds = first_day(model, window_start)
    if ROUTING not in kinds:
        raise ValueError("the window's first day holds no routing event")
    first = {kind: kinds.index(kind) for kind in (ROUTING, DAY_END)}
    ordinary = [i for i in range(first[ROUTING]) if kinds[i] == ORDINARY]
    steps = {int(g.choice(ordinary)): ORDINARY, first[ROUTING]: ROUTING, first[DAY_END]: DAY_END}
    return CheckPlan(tuple(sorted(members)), steps)
