"""Procedural topography (P004), offline NumPy tool: the port's copy of
``qingdai_tpu/topography.py``'s generator, its exporter
(``export_topography_to_netcdf``, which the spin-up writes
``data/topography.nc`` with) and its reader (``load_topography_from_netcdf``,
for ``QD_TOPO_NC``).

Reproduces the reference pipeline (pygcm/topography.py):
L1 generalized-Gaussian continents at area-uniform random centers blended with
very-low-frequency noise, L3 fBm octaves with Hurst decay, adaptive sea level
via area-weighted quantile, base albedo/friction maps. Runs on host once at
init, so plain NumPy/SciPy is the right tool; the same seed gives the same
arrays as the JAX package.
"""

from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np
from scipy.ndimage import gaussian_filter

from . import constants


def _great_circle_distance_rad(lat_deg, lon_deg, lat0_deg, lon0_deg):
    lat = np.deg2rad(lat_deg)
    lon = np.deg2rad(lon_deg)
    lat0 = np.deg2rad(lat0_deg)
    lon0 = np.deg2rad(lon0_deg)
    cos_d = np.sin(lat) * np.sin(lat0) + np.cos(lat) * np.cos(lat0) * np.cos(lon - lon0)
    return np.arccos(np.clip(cos_d, -1.0, 1.0))


def _weighted_quantile(values, weights, q):
    v = values.ravel()
    w = weights.ravel()
    m = np.isfinite(v) & np.isfinite(w)
    v, w = v[m], w[m]
    if v.size == 0:
        return np.nan
    order = np.argsort(v)
    v, w = v[order], w[order]
    cw = np.cumsum(w)
    if cw[-1] <= 0:
        return np.nan
    cw /= cw[-1]
    idx = np.clip(np.searchsorted(cw, q, side="left"), 0, v.size - 1)
    return float(v[idx])


def _generate_L1_continents(lat_mesh, lon_mesh, seed: int, params: Dict) -> np.ndarray:
    n_lat, n_lon = lat_mesh.shape
    rng = np.random.default_rng(seed)
    N_CONT = int(params.get("N_CONTINENTS", 3))
    SIGMA_DEG = float(params.get("CONTINENT_SIGMA_DEG", 30.0))
    SHAPE_P = float(params.get("CONTINENT_SHAPE_P", 2.0))
    A_MIN, A_MAX = params.get("CONTINENT_AMP_RANGE", (0.8, 1.2))
    MIN_DIST_DEG = float(params.get("CONT_MIN_DIST_DEG", 0.0))

    if MIN_DIST_DEG <= 0.0:
        cont_lats = np.rad2deg(np.arcsin(rng.uniform(-1.0, 1.0, size=N_CONT)))
        cont_lons = rng.uniform(0.0, 360.0, size=N_CONT)
    else:
        lats, lons = [], []
        tries = 0
        while len(lats) < N_CONT and tries < 10000:
            la = np.rad2deg(np.arcsin(rng.uniform(-1.0, 1.0)))
            lo = rng.uniform(0.0, 360.0)
            ok = all(np.rad2deg(_great_circle_distance_rad(
                np.array(la), np.array(lo), pa, po)) >= MIN_DIST_DEG
                for pa, po in zip(lats, lons))
            if ok:
                lats.append(la)
                lons.append(lo)
            tries += 1
        while len(lats) < N_CONT:
            lats.append(np.rad2deg(np.arcsin(rng.uniform(-1.0, 1.0))))
            lons.append(rng.uniform(0.0, 360.0))
        cont_lats, cont_lons = np.asarray(lats), np.asarray(lons)
    amps = rng.uniform(A_MIN, A_MAX, size=N_CONT)

    H = np.zeros_like(lat_mesh, float)
    sigma_rad = np.deg2rad(SIGMA_DEG)
    for la, lo, A in zip(cont_lats, cont_lons, amps):
        d = _great_circle_distance_rad(lat_mesh, lon_mesh, la, lo)
        H += A * np.exp(-(d / sigma_rad) ** SHAPE_P)
    H = (H - H.mean()) / (H.std() + 1e-8)

    vlf_slat = float(params.get("VLF_SIGMA_LAT", max(4, n_lat // 12)))
    vlf_slon = float(params.get("VLF_SIGMA_LON", max(8, n_lon // 12)))
    noise = rng.standard_normal((n_lat, n_lon))
    vlf = gaussian_filter(noise, sigma=(vlf_slat, vlf_slon), mode=("nearest", "wrap"))
    vlf = (vlf - vlf.mean()) / (vlf.std() + 1e-8)
    W_VLF = float(params.get("W_VLF", 0.35))
    H = (1 - W_VLF) * H + W_VLF * vlf
    return (H - H.mean()) / (H.std() + 1e-8)


def _generate_L3_fbm(shape, seed: int, params: Dict) -> np.ndarray:
    n_lat, n_lon = shape
    rng = np.random.default_rng(seed)
    OCT = int(params.get("FBM_OCTAVES", 5))
    HURST = float(params.get("HURST_H", 0.8))
    s_lat = float(params.get("FBM_BASE_SIGMA_LAT", max(1, n_lat // 20)))
    s_lon = float(params.get("FBM_BASE_SIGMA_LON", max(1, n_lon // 20)))
    fbm = np.zeros(shape)
    amp = 1.0
    for _ in range(OCT):
        noise = rng.standard_normal(shape)
        layer = gaussian_filter(noise, sigma=(s_lat, s_lon), mode=("nearest", "wrap"))
        layer = (layer - layer.mean()) / (layer.std() + 1e-8)
        fbm += amp * layer
        amp *= 2 ** (-HURST)
        s_lat = max(0.5, s_lat / 2.0)
        s_lon = max(0.5, s_lon / 2.0)
    return (fbm - fbm.mean()) / (fbm.std() + 1e-8)


def generate_elevation_map(lat_mesh, lon_mesh, seed: int = 42,
                           params: Optional[Dict] = None) -> np.ndarray:
    """L1 + L3 combined elevation in meters (topography.py:206-246)."""
    params = params or {}
    H1 = _generate_L1_continents(lat_mesh, lon_mesh, int(seed), params)
    H3 = _generate_L3_fbm(lat_mesh.shape, int(seed) + 1, params)
    combined = float(params.get("W1", 1.0)) * H1 + float(params.get("W3", 0.6)) * H3
    combined = (combined - combined.mean()) / (combined.std() + 1e-8)
    elev = combined * float(params.get("SCALE_M", 4500.0))
    return gaussian_filter(elev, sigma=(0.5, 0.5), mode=("nearest", "wrap"))


def create_land_sea_mask_from_elevation(elevation_m, lat_mesh,
                                        target_land_frac: float = 0.29):
    """Adaptive sea level by area-weighted quantile (topography.py:253-288)."""
    area_w = np.maximum(np.cos(np.deg2rad(lat_mesh)), 0.0)
    H_sea = _weighted_quantile(elevation_m, area_w, q=1.0 - float(target_land_frac))
    mask = (elevation_m >= H_sea).astype(np.uint8)
    return mask, float(H_sea)


def create_land_sea_mask(lat_mesh, lon_mesh, target_land_frac=0.29, seed=42,
                         params=None):
    elev = generate_elevation_map(lat_mesh, lon_mesh, seed=seed, params=params)
    mask, _ = create_land_sea_mask_from_elevation(elev, lat_mesh, target_land_frac)
    return mask, elev


def generate_base_properties(mask, elevation=None, lat_mesh=None):
    """Ice-free base albedo + friction maps (topography.py:295-346)."""
    mask = mask.astype(np.uint8)
    if elevation is None:
        elevation = np.zeros_like(mask, float)
    if lat_mesh is not None:
        lat_factor = (np.abs(lat_mesh) / 90.0) ** 2
    else:
        lat_factor = np.zeros_like(mask, float)
    elev_norm = np.clip(np.maximum(elevation, 0.0) / 4000.0, 0.0, 1.0)
    albedo = np.where(mask == 1, 0.28, 0.08)
    albedo = albedo + 0.08 * lat_factor + 0.05 * elev_norm * (mask == 1)
    albedo = np.clip(albedo, 0.05, 0.85)
    friction = np.where(mask == 1, 1.0e-5, 1.0e-6)
    friction = friction + 6.0e-6 * elev_norm * (mask == 1)
    friction = np.clip(friction, 5e-7, 3e-5)
    return albedo, friction


def export_topography_to_netcdf(lat, lon, elevation, land_mask, base_albedo,
                                friction, sea_level_m, out_path,
                                target_land_frac=0.29, seed=None):
    """Reference-compatible topography export (topography.py:353-423)."""
    from .io.ncdataset import Dataset
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    n_lat, n_lon = land_mask.shape
    with Dataset(out_path, "w") as ds:
        ds.createDimension("lat", n_lat)
        ds.createDimension("lon", n_lon)
        vlat = ds.createVariable("lat", "f4", ("lat",))
        vlon = ds.createVariable("lon", "f4", ("lon",))
        vlat.units = "degrees_north"
        vlon.units = "degrees_east"
        vlat[:] = lat
        vlon[:] = lon
        ev = ds.createVariable("elevation", "f4", ("lat", "lon"), zlib=True, complevel=4)
        mv = ds.createVariable("land_mask", "i1", ("lat", "lon"), zlib=True, complevel=4)
        av = ds.createVariable("base_albedo", "f4", ("lat", "lon"), zlib=True, complevel=4)
        fv = ds.createVariable("friction", "f4", ("lat", "lon"), zlib=True, complevel=4)
        ev.units = "m"
        ev[:, :] = elevation.astype(np.float32)
        mv[:, :] = land_mask.astype(np.int8)
        av[:, :] = base_albedo.astype(np.float32)
        fv[:, :] = friction.astype(np.float32)
        ds.title = "Qingdai Topography and Surface Properties"
        ds.sea_level_m = float(sea_level_m)
        ds.target_land_fraction = float(target_land_frac)
        if seed is not None:
            # extra (non-reference) attr: lets reusers detect that an
            # existing file was generated with a different QD_SEED
            ds.generation_seed = int(seed)
        ds.planet_radius_m = constants.PLANET_RADIUS
        ds.planet_omega_rad_s = constants.PLANET_OMEGA
        ds.planet_axial_tilt_deg = constants.PLANET_AXIAL_TILT


def load_topography_from_netcdf(path, lat_tgt, lon_tgt, regrid="auto"):
    """Load + optionally regrid topography to the model grid with cyclic
    longitude handling (topography.py:428-575). Returns
    (elevation, land_mask, base_albedo, friction)."""
    from .io.ncdataset import Dataset
    from scipy.interpolate import RegularGridInterpolator

    lat_tgt = np.asarray(lat_tgt)
    lon_tgt = np.asarray(lon_tgt)
    lon_mesh, lat_mesh = np.meshgrid(lon_tgt, lat_tgt)

    with Dataset(path, "r") as ds:
        src_lat = np.asarray(ds["lat"][:], float)
        src_lon = np.mod(np.asarray(ds["lon"][:], float), 360.0)
        lat_inc = np.all(np.diff(src_lat) > 0)
        lon_idx = np.argsort(src_lon)
        src_lon = src_lon[lon_idx]
        # grids in the reference convention store the seam twice
        # (lon = linspace(0, 360, n) has both 0 and 360); the mod-360 fold
        # above makes those equal — drop the duplicate column or the
        # interpolator rejects the non-strictly-ascending axis
        keep = np.concatenate([[True], np.diff(src_lon) > 1e-9])
        lon_idx = lon_idx[keep]
        src_lon = src_lon[keep]

        def read(name):
            arr = np.asarray(ds[name][:])
            if not lat_inc:
                arr = arr[::-1, :]
            return arr[:, lon_idx]

        if not lat_inc:
            src_lat = src_lat[::-1]
        elev = read("elevation")
        mask = read("land_mask")
        base = read("base_albedo")
        fric = read("friction")

    # identity fast path: this repo's own files (and the reference's) store
    # lon = linspace(0, 360, W) with the seam duplicated; the mod-360 fold +
    # dedup above removed the 360 column, so a seam-duplicated target that
    # matches the deduped source exactly needs no interpolation — re-append
    # the seam column and return. (Before this path existed, every same-grid
    # reload of data/topography.nc round-tripped all four fields through the
    # tripled-longitude scipy interpolator at startup.)
    seam_tgt = (lon_tgt.size >= 2 and np.isclose(
        np.mod(lon_tgt[-1], 360.0), np.mod(lon_tgt[0], 360.0), atol=1e-9))
    if (seam_tgt and elev.shape[0] == lat_tgt.size
            and src_lon.size == lon_tgt.size - 1
            and np.allclose(src_lat, lat_tgt, atol=1e-6)
            and np.allclose(src_lon, np.mod(lon_tgt[:-1], 360.0), atol=1e-6)):
        elev, mask, base, fric = (np.concatenate([a, a[:, :1]], axis=1)
                                  for a in (elev, mask, base, fric))
        return (elev.astype(float), mask.astype(np.uint8),
                base.astype(float), fric.astype(float))

    same = (elev.shape == lat_mesh.shape and
            np.allclose(src_lat, lat_tgt, atol=1e-6) and
            np.allclose(src_lon, lon_tgt[: src_lon.size], atol=1e-6) and
            src_lon.size == lon_tgt.size)
    if same or regrid == "never":
        if not same and regrid == "never":
            raise ValueError("Topography grid mismatch with regrid='never'")
        return (elev.astype(float), mask.astype(np.uint8),
                base.astype(float), fric.astype(float))

    def interp(field, is_mask=False):
        lon_ext = np.concatenate([src_lon - 360.0, src_lon, src_lon + 360.0])
        f_ext = np.concatenate([field] * 3, axis=1)
        it = RegularGridInterpolator((src_lat, lon_ext), f_ext, bounds_error=False,
                                     fill_value=None,
                                     method=("nearest" if is_mask else "linear"))
        pts_lat = np.clip(lat_mesh.ravel(), src_lat.min(), src_lat.max())
        vals = it(np.stack([pts_lat, lon_mesh.ravel()], -1)).reshape(lat_mesh.shape)
        if is_mask:
            return np.where(vals >= 0.5, 1, 0).astype(np.uint8)
        return vals

    return (interp(elev), interp(mask, is_mask=True), interp(base), interp(fric))
