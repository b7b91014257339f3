"""Topography statistics (the port's counterpart of
``scripts/analyze_topography.py``): maximum elevation, minimum depth,
area-weighted land fraction and mean land slope, albedo and friction ranges
of a topography file (``--topo``, default ``QD_TOPO_NC``) or of the
procedural planet, written as JSON and printed. NumPy on the host.

Usage:
  python -m qingdai_tpu_torch.analyze_topography --topo data/topo.nc \\
      [--out output/topo_stats.json]
"""

import argparse
import json
import os

import numpy as np

from . import constants as const
from . import topography as topo


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--topo", type=str, required=False,
                    default=os.getenv("QD_TOPO_NC", ""))
    ap.add_argument("--nlat", type=int, default=181)
    ap.add_argument("--nlon", type=int, default=360)
    ap.add_argument("--out", type=str, default="output/topo_stats.json")
    args = ap.parse_args()

    lat = np.linspace(-90, 90, args.nlat)
    lon = np.linspace(0, 360, args.nlon)
    lon_mesh, lat_mesh = np.meshgrid(lon, lat)
    if args.topo and os.path.exists(args.topo):
        elev, mask, alb, fric = topo.load_topography_from_netcdf(args.topo, lat, lon)
    else:
        mask, elev = topo.create_land_sea_mask(lat_mesh, lon_mesh)
        alb, fric = topo.generate_base_properties(mask, elev, lat_mesh)

    a = const.PLANET_RADIUS
    dlat = np.deg2rad(lat[1] - lat[0])
    dlon = np.deg2rad(lon[1] - lon[0])
    cos = np.maximum(np.cos(np.deg2rad(lat_mesh)), 1e-6)
    dzdx = (np.roll(elev, -1, 1) - np.roll(elev, 1, 1)) / (2 * a * cos * dlon)
    dzdy = np.gradient(elev, a * dlat, axis=0)
    slope = np.hypot(dzdx, dzdy)
    w = np.maximum(np.cos(np.deg2rad(lat_mesh)), 0)
    land = mask == 1
    stats = {
        "max_elevation_m": float(np.max(elev)),
        "min_depth_m": float(np.min(elev)),
        "land_fraction_area_weighted": float((w * land).sum() / w.sum()),
        "mean_slope_land": float((slope * w * land).sum() / max((w * land).sum(), 1e-9)),
        "albedo_min_mean_max": [float(alb.min()), float(alb.mean()), float(alb.max())],
        "friction_min_mean_max": [float(fric.min()), float(fric.mean()), float(fric.max())],
    }
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(stats, f, indent=2)
    print(json.dumps(stats, indent=2))


if __name__ == "__main__":
    main()
