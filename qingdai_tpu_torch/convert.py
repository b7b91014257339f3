"""Carry state between the JAX package and the port.

Neither function imports jax: they read attributes by the port's field names
and take every array leaf through ``np.asarray``, so any object with those
attributes (a JAX pytree, NumPy arrays, or the port's own state) can be read.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from . import grid as grid_mod
from . import routing
from . import state as state_mod
from .ecology import individuals, phyto, population

_PORT_CLASSES = {cls.__name__: cls for cls in (
    state_mod.AtmosState, state_mod.OceanState, state_mod.LandState, state_mod.EnergyState,
    state_mod.ClockState, state_mod.AlbedoCaches, state_mod.WorldState,
    state_mod.StaticFields, grid_mod.Grid,
    population.EcoState, individuals.IndivState, phyto.PhytoState,
    routing.RoutingState)}
# host numbers of the port's clocks
_HOST_INT = ("step_idx",)
_HOST_FLOAT = ("accum_t_day", "phyto_accum", "t_accum")
# a port grid's shard fields (``parallel.mesh.shard_grid``)
_GRID_SHARD = ("lon0", "width", "mesh", "padded")


def _leaf(x, device, dtype):
    if isinstance(x, (bool, int, float)) and not isinstance(x, np.generic):
        return x
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
    a = np.array(x)  # a writable copy
    if a.dtype == np.bool_:
        return torch.as_tensor(a).to(device)
    if np.issubdtype(a.dtype, np.integer):
        return torch.as_tensor(a.astype(np.int32)).to(device)
    return torch.as_tensor(a.astype(np.float64)).to(device=device, dtype=dtype)


def world_from_numpy(jax_obj, device="cuda", dtype=torch.float64):
    """Convert a JAX ``WorldState``, ``StaticFields`` or ``Grid`` (or any of
    the state groups, the ecology, individual-pool and phytoplankton states
    included) into the port's class of the same name. A port object
    converts too, which moves it to another device or dtype.

    The clock's step counter becomes a Python int, and its two day
    accumulators and the routing group's ``t_accum`` Python floats; the JAX
    ``rng`` key is dropped (the port's random stream is
    ``Model.generator``)."""
    device = grid_mod.resolve_device(device)
    cls = _PORT_CLASSES.get(type(jax_obj).__name__)
    if cls is None:
        raise TypeError(f"no port counterpart for {type(jax_obj).__name__}")
    kw = {}
    for f in dataclasses.fields(cls):
        if cls is grid_mod.Grid and f.name in _GRID_SHARD:
            # a port grid keeps its shard; a JAX grid has no lon0, width or
            # padded maps, and its mesh is not the port's
            if isinstance(jax_obj, grid_mod.Grid):
                x = getattr(jax_obj, f.name)
                kw[f.name] = (world_from_numpy(x, device, dtype) if f.name == "padded"
                              and x is not None else x)
            continue
        x = getattr(jax_obj, f.name)
        if x is None or type(x).__name__ in _PORT_CLASSES:
            kw[f.name] = None if x is None else world_from_numpy(x, device, dtype)
        elif f.name in _HOST_INT:
            kw[f.name] = int(np.asarray(x))
        elif f.name in _HOST_FLOAT:
            kw[f.name] = float(np.asarray(x))
        else:
            kw[f.name] = _leaf(x, device, dtype)
    return cls(**kw)


def ensemble_from_numpy(jax_ens, device="cuda", dtype=torch.float64):
    """Convert a JAX ensemble state (a ``WorldState`` with a leading member
    axis on every leaf) into the port's (``ensemble.py``): every per-member
    leaf keeps its member axis; each shared clock leaf
    (``ensemble.SHARED_LEAVES``) must be equal across members and becomes
    member 0's, a host number where the port keeps one. The ``rng`` keys are
    dropped (each member's generator is the port's)."""
    from .ensemble import SHARED_LEAVES

    device = grid_mod.resolve_device(device)
    groups = {}
    for g in dataclasses.fields(state_mod.WorldState):
        group = getattr(jax_ens, g.name)
        if group is None:
            groups[g.name] = None
            continue
        cls = _PORT_CLASSES[type(group).__name__]
        kw = {}
        for f in dataclasses.fields(cls):
            a = np.asarray(getattr(group, f.name))
            if (g.name, f.name) not in SHARED_LEAVES:
                kw[f.name] = _leaf(a, device, dtype)
                continue
            if not np.array_equal(a, np.broadcast_to(a[:1], a.shape)):
                raise ValueError(f"the shared leaf {g.name}.{f.name} differs across members")
            if f.name in _HOST_INT:
                kw[f.name] = int(a[0])
            elif f.name in _HOST_FLOAT:
                kw[f.name] = float(a[0])
            else:
                kw[f.name] = _leaf(a[0], device, dtype)
        groups[g.name] = cls(**kw)
    return state_mod.WorldState(**groups)


def world_to_numpy(world) -> dict:
    """Flatten a port ``WorldState`` (or a JAX one, read by the port's field
    names) into {"group.field": ndarray or number}; absent groups are
    skipped."""
    out = {}
    for g in dataclasses.fields(state_mod.WorldState):
        group = getattr(world, g.name)
        if group is None:
            continue
        for f in dataclasses.fields(_PORT_CLASSES[type(group).__name__]):
            x = getattr(group, f.name)
            if f.name in _HOST_INT:
                out[f"{g.name}.{f.name}"] = int(np.asarray(x))
            elif isinstance(x, torch.Tensor):
                out[f"{g.name}.{f.name}"] = x.detach().cpu().numpy()
            else:
                out[f"{g.name}.{f.name}"] = np.asarray(x)
    return out
