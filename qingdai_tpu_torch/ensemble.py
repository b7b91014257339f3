"""Ensembles: N perturbed planets advanced together by one member-batched
step (port of ``qingdai_tpu/ensemble.py``).

The state of an ensemble is a ``WorldState`` with a leading member axis on
every per-member leaf. The shared clock is not batched: the step counter and
the two day accumulators stay host numbers, the routing event clock a host
float, and ``t_seconds``, the three orbital phases and the individual pool's
substep clock unbatched 0-d tensors (``SHARED_LEAVES``, the JAX package's
``_SHARED_CLOCK_FIELDS`` and ``_shared_axes_spec``). Every member advances
the same dt on the same schedule, so these are identical across members,
and every cadence of the step (the daily blocks, the routing event, the
autotune, the filter cadences) stays the Python ``if`` it is in the single
planet. ``precip_acc_day`` and ``precip_day_last`` accumulate each member's
own precipitation and are per member.

``make_ensemble_chunk_fn`` runs the port's own ``model.make_step_fn`` step
under ``torch.func.vmap`` over the members, one vmapped step at a time in a
Python loop. The kernels K1–K4 are reached through ``torch.autograd.Function``s
whose ``vmap`` rule calls each kernel's batched form: one launch for every
member (``ops.members``). No random number is drawn inside the vmap
(``randomness="error"``): on a day's end with mutation on, each member's
mutation draws come from that member's ``torch.Generator``, drawn outside the
vmap in the single planet's order and passed in. Member 0 is the single
planet, on the model's own generator, so it replays the single-planet run,
its random stream included; the others have their own streams. The JAX
package's ``fold_in`` streams cannot be reproduced in torch, so the members'
numbers differ from the JAX package's.

The member mesh (``make_member_mesh``, ``shard_ensemble``,
``gather_ensemble``) splits the members over ``torch.distributed`` ranks:
each rank advances its B/n members with the batched kernels, members
exchange nothing inside a chunk, and ``gather_ensemble`` collects them, for
example for an analysis of the whole ensemble (``assim``). Each rank keeps
its members' generators, so a member draws the numbers it draws unsharded.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from . import model as M
from .ecology import population as eco_mod
from .parallel.halo import all_gather_members
from .parallel.mesh import Mesh, make_mesh
from .state import WorldState
from .telemetry import span

# the shared clock: (group, field) of every leaf that is the same for all
# members and so carries no member axis
SHARED_LEAVES = frozenset({
    ("clock", "t_seconds"), ("clock", "step_idx"), ("clock", "phase_rot"),
    ("clock", "phase_binary"), ("clock", "phase_planet"), ("clock", "accum_t_day"),
    ("clock", "phyto_accum"), ("routing", "t_accum"), ("indiv", "substep_accum"),
    ("indiv", "fire_idx"),
})


def _leaves(state: WorldState):
    """(group, field, value) of every leaf of ``state``, in field order."""
    for g in dataclasses.fields(state):
        group = getattr(state, g.name)
        if group is not None:
            for f in dataclasses.fields(group):
                yield g.name, f.name, getattr(group, f.name)


def _split(state: WorldState):
    """(the per-member leaves as a tuple, {(group, field): shared leaf})."""
    per_member = tuple(v for g, f, v in _leaves(state) if (g, f) not in SHARED_LEAVES)
    shared = {(g, f): v for g, f, v in _leaves(state) if (g, f) in SHARED_LEAVES}
    return per_member, shared


def _join(template: WorldState, per_member, shared: dict) -> WorldState:
    """``template`` with its leaves taken from ``per_member`` (in ``_split``'s
    order) and ``shared``."""
    it = iter(per_member)
    groups = {}
    for g in dataclasses.fields(template):
        group = getattr(template, g.name)
        if group is not None:
            group = dataclasses.replace(group, **{
                f.name: shared[(g.name, f.name)] if (g.name, f.name) in SHARED_LEAVES
                else next(it) for f in dataclasses.fields(group)})
        groups[g.name] = group
    return dataclasses.replace(template, **groups)


def n_members(ens: WorldState) -> int:
    return int(ens.atmos.T_s.shape[0])


def _correlated_noise(white: torch.Tensor, passes: int = 6) -> torch.Tensor:
    """Zero-mean noise of unit std with a few-cell correlation length: the
    white noise ``white`` [H, W] smoothed by ``passes`` 4-neighbour averages
    (periodic in longitude, clamped in latitude), then renormalised. Grid-
    scale white noise would not survive the ∇⁴ and Shapiro filters."""
    n = white
    for _ in range(passes):
        n = 0.2 * (n
                   + torch.roll(n, 1, -1) + torch.roll(n, -1, -1)
                   + torch.cat([n[:1], n[:-1]], dim=0)
                   + torch.cat([n[1:], n[-1:]], dim=0))
    # renormalise to unit std (population std, as jnp.std)
    return n / torch.clamp(torch.std(n, correction=0), min=1e-12)


def correlated_noise(generator: torch.Generator, shape, dtype, device,
                     passes: int = 6) -> torch.Tensor:
    """``_correlated_noise`` of white noise drawn from ``generator``."""
    white = torch.randn(tuple(shape), generator=generator, dtype=dtype, device=device)
    return _correlated_noise(white, passes)


def perturb_member(state: WorldState, generator_or_draws, amp, land_mask,
                   h_amp=0.0) -> WorldState:
    """One member's initial condition: T_s noise of ``amp`` K, the same noise
    on the SST over open ocean (so the surface fields stay consistent, as
    the banded init applies one field to both), and correlated height noise
    of ``h_amp`` m, which displaces the mass field the winds balance against
    and so seeds lasting flow differences.

    ``generator_or_draws`` is a ``torch.Generator``, from which the T_s noise
    and then the height's white noise are drawn (standard normal, [H, W]
    each), or those two tensors."""
    T_s = state.atmos.T_s
    if isinstance(generator_or_draws, torch.Generator):
        g = generator_or_draws
        noise = torch.randn(tuple(T_s.shape), generator=g, dtype=T_s.dtype, device=T_s.device)
        h_noise = correlated_noise(g, T_s.shape, T_s.dtype, T_s.device)
    else:
        noise, white_h = generator_or_draws
        h_noise = _correlated_noise(white_h)
    noise = amp * noise
    h_noise = h_amp * h_noise
    atmos = dataclasses.replace(state.atmos, T_s=T_s + noise, h=state.atmos.h + h_noise)
    sst = torch.where(land_mask == 0, state.ocean.sst + noise, state.ocean.sst)
    return dataclasses.replace(state, atmos=atmos,
                               ocean=dataclasses.replace(state.ocean, sst=sst))


def member_seed(seed: int, i: int) -> int:
    """The seed of member ``i``'s generator, from (seed, i)."""
    return int(np.random.SeedSequence([int(seed), int(i)]).generate_state(1, np.uint64)[0])


def stack_members(members) -> WorldState:
    """One ensemble state from single-planet states: their per-member leaves
    stacked on a new leading axis, the shared leaves from the first (which
    must equal every other's)."""
    splits = [_split(m) for m in members]
    shared = splits[0][1]
    for _, other in splits[1:]:
        for k, v in shared.items():
            same = torch.equal(v, other[k]) if isinstance(v, torch.Tensor) else v == other[k]
            if not same:
                raise ValueError(f"members differ in the shared leaf {k}")
    stacked = tuple(torch.stack(leaves) for leaves in zip(*(per for per, _ in splits)))
    return _join(members[0], stacked, shared)


def init_ensemble(model: M.Model, n_members: int, seed: int = 42, perturb_k: float = 0.01,
                  h_amp: float = 0.0):
    """(ensemble state, generators) of ``n_members`` members.

    Member 0 is ``init_world(model, seed=seed)`` exactly, and its generator
    is ``model.generator``, untouched: member 0 replays the single planet.
    Member i ≥ 1 has its own ``torch.Generator`` on the model's device,
    seeded from (seed, i) (``member_seed``); it draws the member's
    perturbation (``perturb_member`` with ``perturb_k`` K and ``h_amp`` m)
    and then its mutations."""
    if n_members < 1:
        raise ValueError(f"n_members must be >= 1, got {n_members}")
    base = M.init_world(model, seed=seed)
    generators = [model.generator] + [
        torch.Generator(device=model.device).manual_seed(member_seed(seed, i))
        for i in range(1, n_members)]
    members = [base] + [perturb_member(base, g, perturb_k, model.static.land_mask, h_amp)
                        for g in generators[1:]]
    return stack_members(members), generators


def member_state(ens: WorldState, i: int) -> WorldState:
    """Member ``i`` as a plain single-planet ``WorldState``."""
    per, shared = _split(ens)
    return _join(ens, tuple(v[i] for v in per), shared)


def mutation_draws(model: M.Model, ens: WorldState, generators) -> eco_mod.MutationDraws:
    """Each member's mutation draws from its own generator, stacked on the
    member axis."""
    if generators is None or len(generators) != n_members(ens):
        raise ValueError(f"mutation is on: give the ensemble's {n_members(ens)} generators")
    per = [eco_mod.mutation_draws(model.eco_static, ens.eco, g) for g in generators]
    return eco_mod.MutationDraws(*(torch.stack(x) for x in zip(*per)))


def _vmap_step(fn, ens: WorldState, draws, batched):
    """(ens, diags) of one step of every member: ``fn(state, draws,
    *batched)`` (a single-planet step) under one ``torch.func.vmap`` over
    the members. ``draws`` (``mutation_draws``, or None) and each tensor of
    ``batched`` carry the member axis first."""
    per, shared = _split(ens)
    # the shared tensors leave the vmap unbatched (out_dims None, which
    # vmap checks); the host numbers, which it cannot return, beside it
    tensor_keys = [k for k, v in shared.items() if isinstance(v, torch.Tensor)]
    host_out = {}

    def body(per_member, draws, *extra):
        new, diags = fn(_join(ens, per_member, shared), draws, *extra)
        new_per, new_shared = _split(new)
        host_out.update((k, v) for k, v in new_shared.items() if k not in tensor_keys)
        return new_per, tuple(new_shared[k] for k in tensor_keys), diags

    run = torch.func.vmap(body, in_dims=(0, None if draws is None else 0) + (0,) * len(batched),
                          out_dims=(0, None, 0), randomness="error")
    new_per, shared_out, diags = run(per, draws, *batched)
    return _join(ens, new_per, {**host_out, **dict(zip(tensor_keys, shared_out))}), diags


def run_steps(model: M.Model, ens: WorldState, n: int, diag_every: int, step, step_nd,
              generators=None, batched=()):
    """(ens, diags): ``n`` steps of every member, each one ``torch.func.vmap``
    of ``step(state, draws, *batched)`` (``step_nd`` on the steps that emit
    no diags: all but every ``diag_every``-th), in a Python loop. With
    mutation on, each member's draws come from its generator. Each step
    runs inside the span ``ensemble.step``; the diag rows are stacked inside
    the last one, so that every device operation of a chunk falls in a step."""
    rows = []
    for i in range(n):
        with span("ensemble.step"):
            draws = (mutation_draws(model, ens, generators) if M.mutation_due(model, ens.clock)
                     else None)
            if (i + 1) % diag_every == 0:
                ens, d = _vmap_step(step, ens, draws, batched)
                rows.append(d)
            else:
                ens, _ = _vmap_step(step_nd, ens, draws, batched)
            if i == n - 1:
                with span("diag.rows"):
                    diags = {k: torch.stack([r[k] for r in rows], dim=1) for k in rows[0]}
    return ens, diags


def make_ensemble_chunk_fn(model: M.Model, chunk_steps: Optional[int] = None,
                           diag_every: Optional[int] = None):
    """chunk(ens, generators=None) -> (ens, diags): ``chunk_steps`` steps of
    every member, each step one ``torch.func.vmap`` of the single-planet
    step over the members, in a Python loop.

    Diags are emitted on every Nth step, as ``model.make_chunk_fn`` does
    (N = ``diag_every``, default QD_DIAG_EVERY, falling back as
    ``model.diag_stride``); each diag leaf is [members, rows]. With mutation
    on, ``generators`` (``init_ensemble``'s) feed each member's draws."""
    n = chunk_steps or model.cfg.run.chunk_steps
    de = M.diag_stride(model, n, diag_every)
    step = M.make_step_fn(model)
    step_nd = M.make_step_fn(model, with_diags=False) if de > 1 else step

    def chunk(ens: WorldState, generators=None):
        return run_steps(model, ens, n, de, step, step_nd, generators)

    return chunk


def make_member_mesh(backend: str = "nccl", device="cuda", **kw) -> Mesh:
    """The member mesh: this process's rank of ``parallel.mesh.make_mesh``
    (same arguments), whose ranks each take B/n of an ensemble's members."""
    return make_mesh(backend, device, **kw)


def _members_of(mesh: Mesh, b: int) -> slice:
    if b % mesh.n:
        raise ValueError(f"{b} members do not divide over {mesh.n} ranks")
    k = b // mesh.n
    return slice(mesh.rank * k, (mesh.rank + 1) * k)


def shard_ensemble(ens: WorldState, mesh: Mesh, generators=None):
    """The rank's members of ``ens`` (B divisible by the rank count), the
    shared clock replicated; with ``generators`` also the rank's share of
    them: (ens, generators)."""
    sl = _members_of(mesh, n_members(ens))
    per, shared = _split(ens)
    out = _join(ens, tuple(v[sl] for v in per), shared)
    return out if generators is None else (out, list(generators)[sl])


def gather_ensemble(ens: WorldState, mesh: Mesh) -> WorldState:
    """Every member on every rank from the ranks' shards, in member order."""
    per, shared = _split(ens)
    return _join(ens, tuple(all_gather_members(v, mesh) for v in per), shared)


def spread_diagnostics(diags: dict) -> dict:
    """The across-member standard deviation (population std) of each scalar
    diag at the chunk's last row: {key + "_spread": float}."""
    return {k + "_spread": float(torch.std(v[:, -1].to(torch.float64), correction=0))
            for k, v in diags.items() if v.dim() == 2}
