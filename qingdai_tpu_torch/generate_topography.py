"""Offline topography generator (the port's counterpart of
``scripts/generate_topography.py``): a seeded procedural elevation map, the
land-sea mask at a target land fraction, base albedo and friction, written
as a NetCDF file in the reference schema. NumPy on the host; the same seed
gives the JAX script's arrays bit for bit.

Defaults: 181×360 grid, seed ``QD_SEED`` (42), land fraction
``QD_TARGET_LAND_FRAC`` (0.29); the shape knobs ``QD_N_CONTINENTS``,
``QD_CONT_SIGMA_DEG``, ``QD_CONT_SHAPE_P``, ``QD_CONT_MIN_DIST_DEG``, ``QD_W_VLF``,
``QD_FBM_OCTAVES``, ``QD_HURST_H``, ``QD_W1``, ``QD_W3`` and ``QD_SCALE_M``. Writing
the file needs netCDF4 or h5py; without either it raises and names h5py.

Usage:
  python -m qingdai_tpu_torch.generate_topography --nlat 181 --nlon 360 \\
      [--seed 42] [--land-frac 0.29] [--out data/topo.nc]
"""

import argparse
import os
import time

import numpy as np

from . import topography as topo


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--nlat", type=int, default=181)
    ap.add_argument("--nlon", type=int, default=360)
    ap.add_argument("--seed", type=int, default=int(os.getenv("QD_SEED", "42")))
    ap.add_argument("--land-frac", type=float,
                    default=float(os.getenv("QD_TARGET_LAND_FRAC", "0.29")))
    ap.add_argument("--out", type=str, default=None)
    args = ap.parse_args()

    lat = np.linspace(-90, 90, args.nlat)
    lon = np.linspace(0, 360, args.nlon)
    lon_mesh, lat_mesh = np.meshgrid(lon, lat)

    params = {}
    for env, key, cast in [("QD_N_CONTINENTS", "N_CONTINENTS", int),
                           ("QD_CONT_SIGMA_DEG", "CONTINENT_SIGMA_DEG", float),
                           ("QD_CONT_SHAPE_P", "CONTINENT_SHAPE_P", float),
                           ("QD_CONT_MIN_DIST_DEG", "CONT_MIN_DIST_DEG", float),
                           ("QD_W_VLF", "W_VLF", float),
                           ("QD_FBM_OCTAVES", "FBM_OCTAVES", int),
                           ("QD_HURST_H", "HURST_H", float),
                           ("QD_W1", "W1", float), ("QD_W3", "W3", float),
                           ("QD_SCALE_M", "SCALE_M", float)]:
        v = os.getenv(env)
        if v:
            params[key] = cast(v)

    elev = topo.generate_elevation_map(lat_mesh, lon_mesh, seed=args.seed,
                                       params=params)
    mask, sea_level = topo.create_land_sea_mask_from_elevation(
        elev, lat_mesh, target_land_frac=args.land_frac)
    albedo, friction = topo.generate_base_properties(mask, elev, lat_mesh)

    area_w = np.maximum(np.cos(np.deg2rad(lat_mesh)), 0.0)
    achieved = float((area_w * (mask == 1)).sum() / (area_w.sum() + 1e-15))
    print(f"[Topography] Target land fraction={args.land_frac:.3f}, "
          f"achieved={achieved:.3f}, sea_level={sea_level:.1f} m")

    out = args.out or os.path.join(
        "data", f"topography_qingdai_{args.nlat}x{args.nlon}_"
        f"{time.strftime('%Y%m%dT%H%M%SZ', time.gmtime())}.nc")
    topo.export_topography_to_netcdf(lat, lon, elev, mask, albedo, friction,
                                     sea_level, out,
                                     target_land_frac=args.land_frac,
                                     seed=args.seed)
    print(f"[Topography] Wrote {out}")


if __name__ == "__main__":
    main()
