"""Regrid a restart to a new lat-lon resolution (the port's counterpart of
``scripts/regrid_restart.py``).

Standard warm-start practice for resolution changes: bilinear-interpolate the
equilibrated prognostic fields onto the target grid and let a short phase-2
continuation re-equilibrate the resolution-dependent details, instead of
paying a full cold-start SOP at the expensive resolution.

Longitude is treated as periodic (cyclic wrap column, the scheme of the
reference's topography regrid); latitude endpoints (±90°) align between any
two linspace grids. The interpolation runs once, on the host in float64.

The restart is read and written by its suffix: a NetCDF file in the
reference schema (``atmosphere.nc``; needs h5py or netCDF4), or the port's
torch.save container (``.pt``), which needs neither.

Usage:
  python -m qingdai_tpu_torch.regrid_restart --in data/restart_phase2.pt \\
      --out data361/restart_361.pt --nlat 361 --nlon 720
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from .io import netcdf as ncio

# non-negative physical floors survive interpolation overshoot (the flux
# caches ride along so the regridded resume also skips the bootstrap)
FLOORED = ("q", "h_ice", "W_land", "S_snow", "C_snow", "cloud_cover",
           "P_cond_flux_last", "E_flux_last", "LH_last",
           "LH_release_last", "cloud_eff_last")
CAPPED = ("cloud_cover", "cloud_eff_last")


def regrid_bilinear(field, lat_src, lon_src, lat_dst, lon_dst):
    """Cyclic-in-lon bilinear regrid of one 2-D field (f64 host math)."""
    from scipy.interpolate import RegularGridInterpolator
    f = np.asarray(field, np.float64)
    # the reference grid is linspace(0,360,n_lon) — both seam endpoints are
    # already present (grid.py:20), so only extend when the last column
    # doesn't reach 360
    if lon_src[-1] < 360.0 - 1e-9:
        lon_src = np.concatenate([lon_src, [lon_src[0] + 360.0]])
        f = np.concatenate([f, f[:, :1]], axis=1)
    it = RegularGridInterpolator((lat_src, lon_src), f, method="linear",
                                 bounds_error=False, fill_value=None)
    Lo, La = np.meshgrid(np.mod(lon_dst, 360.0), lat_dst)
    return it(np.stack([La.ravel(), Lo.ravel()], axis=1)).reshape(
        len(lat_dst), len(lon_dst))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--in", dest="src", default="data/atmosphere.nc")
    ap.add_argument("--out", dest="dst", required=True)
    ap.add_argument("--nlat", type=int, required=True)
    ap.add_argument("--nlon", type=int, required=True)
    args = ap.parse_args(argv)

    rst = ncio.load_restart(args.src)
    t_seconds = float(rst.pop("t_seconds", 0.0) or 0.0)
    lat_src = rst.pop("lat", None)
    lon_src = rst.pop("lon", None)
    first2d = next(v for v in rst.values()
                   if v is not None and np.ndim(v) == 2)
    if lat_src is None:
        lat_src = np.linspace(-90, 90, first2d.shape[0])
    if lon_src is None:
        lon_src = np.linspace(0, 360, first2d.shape[1])
    lat_dst = np.linspace(-90, 90, args.nlat)
    lon_dst = np.linspace(0, 360, args.nlon)

    out = {}
    for k, v in rst.items():
        if v is None:
            continue
        v = np.asarray(v)
        if v.ndim != 2:
            continue
        rg = regrid_bilinear(v, np.asarray(lat_src),
                             np.asarray(lon_src), lat_dst, lon_dst)
        # the target run derives its own land/sea mask from topography at
        # the new resolution; the schema field is kept as a nearest-ish
        # threshold for completeness only
        out[k] = (rg > 0.5).astype(np.float32) if k == "land_mask" else rg
    for k in FLOORED:
        if k in out:
            out[k] = np.maximum(out[k], 0.0)
    for k in CAPPED:
        if k in out:
            out[k] = np.minimum(out[k], 1.0)

    os.makedirs(os.path.dirname(args.dst) or ".", exist_ok=True)
    ncio.save_restart_fields(args.dst, lat_dst, lon_dst, out, t_seconds=t_seconds)
    print(f"[Regrid] {args.src} ({len(lat_src)}x{len(lon_src)}) -> "
          f"{args.dst} ({args.nlat}x{args.nlon}), t={t_seconds:.0f}s "
          f"({t_seconds/72000.0:.1f} d)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
