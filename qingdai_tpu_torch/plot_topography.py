"""Topography panels (the port's counterpart of
``scripts/plot_topography.py``): elevation, land mask, base albedo and
friction of a topography file (``--topo``, default ``QD_TOPO_NC``) or of the
procedural planet, in one PNG. NumPy and matplotlib on the host; without
matplotlib it raises and names it.

Usage:
  python -m qingdai_tpu_torch.plot_topography --topo data/topo.nc \\
      [--out output/topography.png]
"""

import argparse
import os

import numpy as np

from . import topography as topo


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--topo", type=str, default=os.getenv("QD_TOPO_NC", ""))
    ap.add_argument("--nlat", type=int, default=181)
    ap.add_argument("--nlon", type=int, default=360)
    ap.add_argument("--out", type=str, default="output/topography.png")
    args = ap.parse_args()

    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    lat = np.linspace(-90, 90, args.nlat)
    lon = np.linspace(0, 360, args.nlon)
    lon_mesh, lat_mesh = np.meshgrid(lon, lat)
    if args.topo and os.path.exists(args.topo):
        elev, mask, alb, fric = topo.load_topography_from_netcdf(args.topo, lat, lon)
    else:
        mask, elev = topo.create_land_sea_mask(lat_mesh, lon_mesh)
        alb, fric = topo.generate_base_properties(mask, elev, lat_mesh)

    fig, axes = plt.subplots(2, 2, figsize=(14, 8))
    for ax, data, title, cmap in [
            (axes[0, 0], elev, "elevation (m)", "terrain"),
            (axes[0, 1], mask, "land mask", "Greys"),
            (axes[1, 0], alb, "base albedo", "pink"),
            (axes[1, 1], fric, "friction (1/s)", "viridis")]:
        im = ax.imshow(np.asarray(data), origin="lower", aspect="auto",
                       extent=[0, 360, -90, 90], cmap=cmap)
        ax.set_title(title)
        plt.colorbar(im, ax=ax, fraction=0.035)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    fig.tight_layout()
    fig.savefig(args.out, dpi=120)
    print(f"[Topo] wrote {args.out}")


if __name__ == "__main__":
    main()
