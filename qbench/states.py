"""Planet states as flat dicts of leaves, one member of an ensemble, and the
gaps between two states.

A state of either side is a ``WorldState`` of dataclass groups (atmos,
ocean, land, energy, clock, albedo, eco, indiv, phyto, routing); the leaves
are keyed ``group.field``. An ensemble carries a leading member axis on
every leaf but the shared clock (the measured package's ``SHARED_LEAVES``).
"""

from __future__ import annotations

import dataclasses
import importlib
import math

import torch

# group → (module of the reference, class) of a planet's state
GROUPS = {
    "atmos": ("state", "AtmosState"), "ocean": ("state", "OceanState"),
    "land": ("state", "LandState"), "energy": ("state", "EnergyState"),
    "clock": ("state", "ClockState"), "albedo": ("state", "AlbedoCaches"),
    "eco": ("ecology.population", "EcoState"), "indiv": ("ecology.individuals", "IndivState"),
    "phyto": ("ecology.phyto", "PhytoState"), "routing": ("routing", "RoutingState"),
}


def leaves(state) -> dict:
    """{"group.field": value} of every leaf of ``state``, in field order."""
    out = {}
    for g in dataclasses.fields(state):
        group = getattr(state, g.name)
        if group is not None:
            for f in dataclasses.fields(group):
                out[f"{g.name}.{f.name}"] = getattr(group, f.name)
    return out


def member_leaves(ens, i: int, shared: frozenset, copy: bool = True) -> dict:
    """Member ``i``'s leaves of an ensemble state (``shared``: the (group,
    field) pairs that carry no member axis), copied to host memory unless
    ``copy`` is False."""
    out = {}
    for key, v in leaves(ens).items():
        g, f = key.split(".")
        if isinstance(v, torch.Tensor):
            v = v if (g, f) in shared else v[i]
            if copy:
                v = v.detach().to("cpu", copy=True)
        out[key] = v
    return out


def build_state(package: str, flat: dict, device, dtype=None):
    """A ``WorldState`` of ``package`` (the reference) from flat leaves,
    its floating tensors on ``device`` in ``dtype`` (their own if None)."""
    def conv(v):
        if not isinstance(v, torch.Tensor):
            return v
        if dtype is not None and v.is_floating_point():
            v = v.to(dtype)
        return v.to(device)

    groups = {}
    for g, (mod, cls) in GROUPS.items():
        fields = {k.split(".")[1]: conv(v) for k, v in flat.items() if k.split(".")[0] == g}
        if fields:
            groups[g] = getattr(importlib.import_module(f"{package}.{mod}"), cls)(**fields)
    return importlib.import_module(f"{package}.state").WorldState(**groups)


def leaf_gap(p, r) -> float:
    """The gap of leaf ``p`` against the reference's ``r``, at most 2: for
    floating leaves the largest |p − r| over the largest |p| or |r| (NaN on
    both sides counts as equal, on one side only as the gap 2); for integer
    and boolean leaves the share of entries that differ; for host numbers
    |p − r| over the larger of |p| and |r|."""
    if not isinstance(r, torch.Tensor):
        if isinstance(r, (bool, int)):
            return float(p != r)
        d = abs(float(p) - float(r))
        return d / max(abs(float(p)), abs(float(r))) if d > 0 else 0.0
    p = torch.as_tensor(p).detach().cpu()
    r = r.detach().cpu()
    if p.shape != r.shape:
        return 2.0
    if r.numel() == 0:
        return 0.0
    if not r.is_floating_point():
        return float((p != r).to(torch.float64).mean())
    p, r = p.to(torch.float64), r.to(torch.float64)
    pn, rn = torch.isnan(p), torch.isnan(r)
    if bool(torch.any(pn != rn)):
        return 2.0
    p, r = torch.where(pn, 0.0, p), torch.where(rn, 0.0, r)
    d = float((p - r).abs().max())
    if d == 0.0:
        return 0.0
    if not math.isfinite(d):
        return 2.0
    return d / max(float(p.abs().max()), float(r.abs().max()))


def worst_gap(prog: dict, ref: dict):
    """(the largest ``leaf_gap`` over the leaves of two flat dicts, its key)."""
    worst, at = -1.0, None
    for k in ref:
        g = leaf_gap(prog[k], ref[k])
        if g > worst:
            worst, at = g, k
    return max(worst, 0.0), at


def parted(p, r, tol: float) -> torch.Tensor:
    """Which entries of floating leaf ``p`` part from the reference's ``r``:
    |p − r| above ``tol`` times the larger of max|p| and max|r| (or NaN on
    one side only)."""
    p = torch.as_tensor(p).detach().cpu().to(torch.float64)
    r = r.detach().cpu().to(torch.float64)
    scale = max(float(torch.nan_to_num(p).abs().max()), float(torch.nan_to_num(r).abs().max()))
    d = (p - r).abs()
    return (d > tol * scale) | (torch.isnan(p) != torch.isnan(r))


def parted_share(p, r, tol: float) -> float:
    """The share of the entries of leaf ``p`` that part from the reference's
    ``r``: floating entries by ``parted``, integer and boolean entries where
    they differ; a host number parts where its ``leaf_gap`` passes ``tol``."""
    if not isinstance(r, torch.Tensor):
        return float(leaf_gap(p, r) > tol)
    p = torch.as_tensor(p)
    if p.shape != r.shape:
        return 1.0
    if r.numel() == 0:
        return 0.0
    if not r.is_floating_point():
        return float((p.cpu() != r.cpu()).to(torch.float64).mean())
    return float(parted(p, r, tol).to(torch.float64).mean())


def worst_share(prog: dict, ref: dict, tol: float):
    """(the largest ``parted_share`` over the leaves of two flat dicts, its
    key)."""
    worst, at = -1.0, None
    for k in ref:
        share = parted_share(prog[k], ref[k], tol)
        if share > worst:
            worst, at = share, k
    return max(worst, 0.0), at
