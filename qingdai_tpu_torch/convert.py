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
from . import state as state_mod
from .ecology import individuals, phyto, population

_PORT_CLASSES = {cls.__name__: cls for cls in (
    state_mod.AtmosState, state_mod.OceanState, state_mod.LandState, state_mod.EnergyState,
    state_mod.ClockState, state_mod.AlbedoCaches, state_mod.WorldState,
    state_mod.StaticFields, grid_mod.Grid,
    population.EcoState, individuals.IndivState, phyto.PhytoState)}
# host numbers of the port's clock
_HOST_INT = ("step_idx",)
_HOST_FLOAT = ("accum_t_day", "phyto_accum")


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

    The clock's step counter becomes a Python int and its two day
    accumulators Python floats; the JAX ``rng`` key is dropped (the port's
    random stream is ``Model.generator``); a JAX world whose routing group
    is set cannot be carried over and raises ``ValueError``."""
    device = grid_mod.resolve_device(device)
    cls = _PORT_CLASSES.get(type(jax_obj).__name__)
    if cls is None:
        raise TypeError(f"no port counterpart for {type(jax_obj).__name__}")
    if cls is state_mod.WorldState and getattr(jax_obj, "routing", None) is not None:
        raise ValueError("the port does not carry the routing state group yet")
    kw = {}
    for f in dataclasses.fields(cls):
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
