"""The planet of a configuration, built twice from the same inputs: once by
the measured package and once by the frozen reference (``qbench.ref``).

The benchmark makes the inputs (the grid, the topography arrays from the
configuration's topography seed, the ``QD_*`` settings) and hands the same
to both sides. Each side then derives the rest itself: its configuration
snapshot, its river network, its model's maps and its initial states.
"""

from __future__ import annotations

import contextlib
import dataclasses
import importlib
import os

import numpy as np
import torch

from .ref import topography as ref_topo

DTYPES = {"float32": torch.float32, "float64": torch.float64}


@dataclasses.dataclass(frozen=True)
class Inputs:
    """What the benchmark hands both sides."""
    env: dict             # every QD_* setting of the configuration snapshot
    lat: np.ndarray
    lon: np.ndarray
    land_mask: np.ndarray
    elevation: np.ndarray
    base_albedo: np.ndarray
    friction: np.ndarray


@contextlib.contextmanager
def hermetic_env(env: dict):
    """``os.environ`` holding exactly ``env`` among the ``QD_*`` variables
    while the block runs, restored afterwards."""
    scrub = [k for k in os.environ if k.startswith("QD_") and k not in env]
    old = {k: os.environ.get(k) for k in list(env) + scrub}
    os.environ.update(env)
    for k in scrub:
        del os.environ[k]
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def make_inputs(config: dict) -> Inputs:
    """The grid and topography of ``config`` (a configuration file's dict):
    the flagship's procedural planet, seeded by its ``topography_seed``."""
    n_lat, n_lon = int(config["n_lat"]), int(config["n_lon"])
    env = {"QD_N_LAT": str(n_lat), "QD_N_LON": str(n_lon),
           "QD_DT_SECONDS": str(float(config["dt_seconds"]))}
    env.update({k: str(v) for k, v in config.get("env", {}).items()})
    lat = np.linspace(-90, 90, n_lat)
    lon = np.linspace(0, 360, n_lon)
    lon_mesh, lat_mesh = np.meshgrid(lon, lat)
    mask, elev = ref_topo.create_land_sea_mask(lat_mesh, lon_mesh,
                                               seed=int(config["topography_seed"]))
    alb, fric = ref_topo.generate_base_properties(mask, elev, lat_mesh)
    return Inputs(env, lat, lon, mask, elev, alb, fric)


def build(package: str, inputs: Inputs, device, dtype: torch.dtype):
    """(model, package modules) of ``package`` (the measured package's name,
    or ``qbench.ref``) on ``device``: its own configuration snapshot of
    ``inputs.env``, its own river network and its own ``build_model``."""
    config = importlib.import_module(package + ".config")
    model = importlib.import_module(package + ".model")
    hn = importlib.import_module(package + ".hydro_network")
    with hermetic_env(inputs.env):
        cfg = config.SimConfig.from_env()
    net = (hn.build_network(inputs.lat, inputs.lon, inputs.elevation, inputs.land_mask)
           if cfg.hydrology.routing_enable else None)
    return model.build_model(cfg, inputs.land_mask, inputs.base_albedo, inputs.friction,
                             elevation=inputs.elevation, network=net, device=device,
                             dtype=dtype)
