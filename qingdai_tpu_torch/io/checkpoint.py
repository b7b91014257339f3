"""The full-state sidecar (the port's counterpart of
``qingdai_tpu/io/checkpoint.py``).

The NetCDF restart (``io/netcdf.py``) is the interchange format in the
reference's schema; it drops the day and routing accumulators, the
individual pool and the random stream, so a resume from it is approximate.
The sidecar holds the whole ``WorldState`` and ``Model.generator``'s state
(the port's mutation draws come from that generator), so a resume from it
continues bit for bit. It is a ``torch.save`` file of plain tensors and
numbers, written to a temporary name and renamed into place, with the exact
host epoch stamped beside it in float64. The port and the JAX package never
read each other's sidecar: their file names differ.
"""

from __future__ import annotations

import dataclasses
import json
import os

import torch

FORMAT = 1


def save_checkpoint_meta(path: str, t_seconds: float) -> None:
    """Stamp the exact host epoch next to the snapshot (atomic). The
    state's own clock is model-dtype bookkeeping that drifts at large
    epochs, so it cannot anchor the staleness check against
    atmosphere.nc's float64 ``t_seconds``; this stamp is written from the
    same host value the NetCDF set records."""
    meta = path + ".meta.json"
    tmp = meta + ".tmp"
    with open(tmp, "w") as f:
        json.dump({"t_seconds": float(t_seconds)}, f)
    os.replace(tmp, meta)


def load_checkpoint_meta(path: str):
    """The stamped host epoch (float), or None without a readable stamp."""
    try:
        with open(path + ".meta.json") as f:
            return float(json.load(f)["t_seconds"])
    except (OSError, ValueError, KeyError):
        return None


def _flatten(state) -> dict:
    """{"group.field": tensor on the CPU or host number} of every group that
    is set."""
    out = {}
    for g in dataclasses.fields(state):
        group = getattr(state, g.name)
        if group is None:
            continue
        for f in dataclasses.fields(group):
            x = getattr(group, f.name)
            out[f"{g.name}.{f.name}"] = x.detach().cpu() if isinstance(x, torch.Tensor) else x
    return out


def save_checkpoint(path: str, state, generator_state: torch.Tensor) -> None:
    """Write ``state`` and a generator's state (``Generator.get_state()``,
    taken at the same instant) to ``path`` through a temporary sibling
    renamed into place: a killed save leaves the previous snapshot or
    nothing, never a torn file."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    payload = {"format": FORMAT, "state": _flatten(state),
               "generator": generator_state}
    tmp = path + ".tmp"
    try:
        torch.save(payload, tmp)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def load_checkpoint(path: str, template, generator: torch.Generator):
    """Restore a snapshot into the structure of ``template`` (a state of the
    model it was written from: the same groups and shapes), each tensor on
    the template's device in its dtype, and set ``generator``'s state.
    Raises ``ValueError`` when the snapshot does not fit the template; the
    generator is set only once the state fits."""
    payload = torch.load(path, map_location="cpu", weights_only=True)
    if payload.get("format") != FORMAT:
        raise ValueError(f"{path}: sidecar format {payload.get('format')!r}, not {FORMAT}")
    flat = payload["state"]
    groups = {}
    for g in dataclasses.fields(template):
        group = getattr(template, g.name)
        if group is None:
            if any(k.startswith(g.name + ".") for k in flat):
                raise ValueError(f"{path}: holds group {g.name}, which this model does not run")
            groups[g.name] = None
            continue
        kw = {}
        for f in dataclasses.fields(group):
            key = f"{g.name}.{f.name}"
            if key not in flat:
                raise ValueError(f"{path}: no {key}")
            ref, x = getattr(group, f.name), flat[key]
            if isinstance(ref, torch.Tensor):
                if not isinstance(x, torch.Tensor) or tuple(x.shape) != tuple(ref.shape):
                    raise ValueError(f"{path}: {key} does not fit this model")
                x = x.to(device=ref.device, dtype=ref.dtype)
            elif type(x) is not type(ref):
                raise ValueError(f"{path}: {key} is {type(x).__name__}, "
                                 f"not {type(ref).__name__}")
            kw[f.name] = x
        groups[g.name] = dataclasses.replace(group, **kw)
    generator.set_state(payload["generator"])
    return dataclasses.replace(template, **groups)
