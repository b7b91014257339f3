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

_PORT_CLASSES = {cls.__name__: cls for cls in (
    state_mod.AtmosState, state_mod.OceanState, state_mod.LandState, state_mod.EnergyState,
    state_mod.ClockState, state_mod.AlbedoCaches, state_mod.WorldState,
    state_mod.StaticFields, grid_mod.Grid)}
# subsystem groups of the JAX WorldState that the port does not carry yet
_UNPORTED = ("eco", "indiv", "phyto", "routing")


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


def world_from_numpy(jax_obj, device="cpu", dtype=torch.float64):
    """Convert a JAX ``WorldState``, ``StaticFields`` or ``Grid`` (or any of
    the state groups) into the port's class of the same name. A port object
    converts too, which moves it to another device or dtype.

    ``ClockState.step_idx`` becomes a Python int and the JAX ``rng`` key is
    dropped; a JAX world whose ecology, phytoplankton or routing group is
    set cannot be carried over and raises ``ValueError``."""
    cls = _PORT_CLASSES.get(type(jax_obj).__name__)
    if cls is None:
        raise TypeError(f"no port counterpart for {type(jax_obj).__name__}")
    if cls is state_mod.WorldState:
        present = [g for g in _UNPORTED if getattr(jax_obj, g, None) is not None]
        if present:
            raise ValueError(f"the port does not carry the {present} state groups yet")
    kw = {}
    for f in dataclasses.fields(cls):
        x = getattr(jax_obj, f.name)
        if type(x).__name__ in _PORT_CLASSES:
            kw[f.name] = world_from_numpy(x, device, dtype)
        elif f.name == "step_idx":
            kw[f.name] = int(np.asarray(x))
        else:
            kw[f.name] = _leaf(x, device, dtype)
    return cls(**kw)


def world_to_numpy(world) -> dict:
    """Flatten a port ``WorldState`` (or a JAX one, read by the port's field
    names) into {"group.field": ndarray or int}."""
    out = {}
    for g in dataclasses.fields(state_mod.WorldState):
        group = getattr(world, g.name)
        for f in dataclasses.fields(_PORT_CLASSES[type(group).__name__]):
            x = getattr(group, f.name)
            if f.name == "step_idx":
                out[f"{g.name}.{f.name}"] = int(np.asarray(x))
            elif isinstance(x, torch.Tensor):
                out[f"{g.name}.{f.name}"] = x.detach().cpu().numpy()
            else:
                out[f"{g.name}.{f.name}"] = np.asarray(x)
    return out
