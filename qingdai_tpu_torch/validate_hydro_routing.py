"""Routing validation (the port's counterpart of
``scripts/validate_hydro_routing.py``): checks the network's ocean-sink
encoding, runs a constant runoff through ``routing`` for two half-hour steps
(one routing event at a 1-hour cadence), and reports the ocean inflow and
the mass-closure error. It reads ``QD_N_LAT``/``QD_N_LON`` (61×120) and
``QD_HYDRO_NETCDF`` (a network file; else the procedural planet's network,
seed 42). The routing runs on the card in float32; ``--device cpu`` and
``--dtype float64`` ask otherwise. Exits 1 if a check fails.

Usage:
  QD_N_LAT=181 QD_N_LON=360 python -m qingdai_tpu_torch.validate_hydro_routing
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch

from . import hydro_network as hn
from . import topography as topo
from .config import HydrologyConfig
from .grid import make_grid
from .routing import build_routing_static, init_routing_state, routing_step

DTYPES = {"float32": torch.float32, "float64": torch.float64}


def validate(n_lat: int, n_lon: int, path: str = "", device="cuda",
             dtype=torch.float32) -> dict:
    """The report's numbers: the network's source, the host seconds of its
    build (or load), the ocean-sink violations, the ocean inflow (kg/s), the
    runoff mass put in (kg) and the closure's relative error."""
    lat = np.linspace(-90, 90, n_lat)
    lon = np.linspace(0, 360, n_lon)
    t0 = time.perf_counter()
    if path and os.path.exists(path):
        net = hn.load_network_netcdf(path)
        land = net["land_mask"]
        n_lat, n_lon = land.shape
        lat = np.linspace(-90, 90, n_lat)
        lon = np.linspace(0, 360, n_lon)
        source = f"Loaded network '{path}'"
    else:
        lon_mesh, lat_mesh = np.meshgrid(lon, lat)
        land, elev = topo.create_land_sea_mask(lat_mesh, lon_mesh, seed=42)
        net = hn.build_network(lat, lon, elev, land)
        source = "Built procedural network"
    build_s = time.perf_counter() - t0

    # 1) ocean-sink encoding: flow_to of every land cell is -1 or a land cell
    flow_to = np.asarray(net["flow_to_index"]).reshape(land.shape)
    landb = land == 1
    dn = flow_to[landb]
    bad = int(((dn >= 0) & ~landb.ravel()[np.maximum(dn, 0)]).sum())

    # 2) synthetic constant runoff → positive ocean inflow, closure ≈ 0
    grid = make_grid(n_lat, n_lon, device=device, dtype=dtype)
    rs = build_routing_static(net, grid)
    cfg = HydrologyConfig(dt_hydro_hours=1.0)
    st = init_routing_state(rs)
    dev = grid.cell_area.device
    R = torch.where(torch.as_tensor(landb, device=dev),
                    torch.full(land.shape, 1e-5, dtype=dtype, device=dev), 0.0)
    zeros = torch.zeros(land.shape, dtype=dtype, device=dev)
    st = routing_step(rs, st, cfg, R, 1800.0, zeros, zeros)
    st = routing_step(rs, st, cfg, R, 1800.0, zeros, zeros)
    cell_area = grid.cell_area.cpu().numpy()
    mass_in = float((R.cpu().numpy() * cell_area * 3600.0).sum())
    inflow = float(st.ocean_inflow_kgps)
    rel_err = abs(float(st.mass_error_kg)) / max(mass_in, 1e-30)
    return {"source": source, "build_s": build_s, "violations": bad,
            "ocean_inflow_kgps": inflow, "mass_in_kg": mass_in, "rel_err": rel_err,
            "ok": bad == 0 and inflow > 0 and rel_err < 1e-4}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="torch device to route on (default: cuda)")
    ap.add_argument("--dtype", choices=sorted(DTYPES), default="float32")
    args = ap.parse_args(argv)
    n_lat, n_lon = int(os.getenv("QD_N_LAT", "61")), int(os.getenv("QD_N_LON", "120"))
    r = validate(n_lat, n_lon, os.getenv("QD_HYDRO_NETCDF", ""), args.device,
                 DTYPES[args.dtype])
    print(f"[Validate] {r['source']}")
    print(f"[Validate] ocean-sink encoding: {r['violations']} violations")
    print(f"[Validate] ocean_inflow={r['ocean_inflow_kgps']:.3e} kg/s "
          f"(must be > 0): {'OK' if r['ocean_inflow_kgps'] > 0 else 'FAIL'}")
    print(f"[Validate] mass closure relative error={r['rel_err']:.3e} "
          f"(must be ≈ 0): {'OK' if r['rel_err'] < 1e-4 else 'FAIL'}")
    print(f"[Validate] {'PASS' if r['ok'] else 'FAIL'}")
    return 0 if r["ok"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
