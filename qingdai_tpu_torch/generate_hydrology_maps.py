"""Offline D8 hydrology network generator (the port's counterpart of
``scripts/generate_hydrology_maps.py``): pit filling, steepest-descent
flow directions, topological order and levels, lakes and their outlets of a
topography file (``--topo``, default ``QD_TOPO_NC``) or of the procedural
planet, written as a NetCDF file in the reference schema (the file
``QD_HYDRO_NETCDF`` names for ``routing``). NumPy on the host. Writing the
file needs netCDF4 or h5py; without either it raises and names h5py.

Usage:
  python -m qingdai_tpu_torch.generate_hydrology_maps --topo data/topo.nc \\
      --nlat 181 --nlon 360 [--out data/hydrology_network.nc]
"""

import argparse
import os

import numpy as np

from . import hydro_network as hn
from . import topography as topo


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--topo", type=str, default=os.getenv("QD_TOPO_NC", ""))
    ap.add_argument("--out", type=str, default="data/hydrology_network.nc")
    ap.add_argument("--nlat", type=int, default=181)
    ap.add_argument("--nlon", type=int, default=360)
    ap.add_argument("--pit-eps", type=float, default=1e-3)
    ap.add_argument("--pit-iters", type=int, default=200)
    args = ap.parse_args()

    lat = np.linspace(-90, 90, args.nlat)
    lon = np.linspace(0, 360, args.nlon)
    lon_mesh, lat_mesh = np.meshgrid(lon, lat)

    if args.topo and os.path.exists(args.topo):
        elevation, land_mask, _a, _f = topo.load_topography_from_netcdf(
            args.topo, lat, lon)
        print(f"[HydroNet] Loaded topography from '{args.topo}'.")
    else:
        print("[HydroNet] No topography specified; procedural fallback.")
        land_mask, elevation = topo.create_land_sea_mask(lat_mesh, lon_mesh)

    net = hn.build_network(lat, lon, elevation, land_mask,
                           pit_iters=args.pit_iters, pit_eps=args.pit_eps)
    print(f"[HydroNet] land={int((land_mask == 1).sum())} cells, "
          f"n_lakes={net['n_lakes']}, n_levels={net['n_levels']}")
    hn.save_network_netcdf(args.out, net)
    print(f"[HydroNet] Wrote {args.out}")


if __name__ == "__main__":
    main()
