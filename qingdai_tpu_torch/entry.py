"""Build a planet of the port from the ``QD_*`` environment (the port's copy
of ``__graft_entry__._build_world``)."""

from __future__ import annotations

import os

import numpy as np
import torch

from . import hydro_network as hn
from . import model as M
from . import topography as topo
from .config import SimConfig
from .grid import resolve_device


def build_world(n_lat: int, n_lon: int, dt_seconds: float = 300.0, extra_env=None,
                device="cuda", dtype=torch.float32, hermetic: bool = True):
    """Build (model, state) at an explicit grid and dt, on the card unless
    ``device`` says otherwise (without a card the default raises).

    ``extra_env`` adds ``QD_*`` settings for the configuration snapshot.
    ``hermetic=True`` removes every other ambient ``QD_*`` variable while the
    snapshot is taken, so the world depends only on the arguments; the
    environment is restored afterwards either way. The topography comes from
    the port's copy of the JAX package's ``topography`` with the same seed,
    and the river network (when routing is on) from its copy of
    ``hydro_network``, so the two packages build the same planet: with no
    ``extra_env`` at 181×360, the flagship planet of
    ``__graft_entry__.entry()``."""
    device = resolve_device(device)
    env = {"QD_N_LAT": str(n_lat), "QD_N_LON": str(n_lon), "QD_DT_SECONDS": str(dt_seconds)}
    env.update(extra_env or {})
    scrub = [k for k in os.environ if k.startswith("QD_") and k not in env] if hermetic else []
    old = {k: os.environ.get(k) for k in list(env) + scrub}
    os.environ.update(env)
    for k in scrub:
        del os.environ[k]
    try:
        cfg = SimConfig.from_env()
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    lat = np.linspace(-90, 90, n_lat)
    lon = np.linspace(0, 360, n_lon)
    lon_mesh, lat_mesh = np.meshgrid(lon, lat)
    mask, elev = topo.create_land_sea_mask(lat_mesh, lon_mesh, seed=cfg.run.seed)
    alb, fric = topo.generate_base_properties(mask, elev, lat_mesh)
    net = hn.build_network(lat, lon, elev, mask) if cfg.hydrology.routing_enable else None
    mdl = M.build_model(cfg, mask, alb, fric, elevation=elev, network=net, device=device,
                        dtype=dtype)
    return mdl, M.init_world(mdl)
