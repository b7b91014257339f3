"""Offline D8 hydrology network builder (the port's copy of
``qingdai_tpu/hydro_network.py``, which imports no JAX; held equal to it by
``tests/test_torch_repairs.py``).

Produces the same artifact schema as the reference's
scripts/generate_hydrology_maps.py (pit-filled elevation, steepest-descent D8
with spherical distances, Kahn topological order, terminal-sink lakes with
outlets) with array-vectorized NumPy, and adds the *level map* (longest-path
depth in the D8 DAG) with which ``routing.py`` runs the reference's
sequential flow_order loop (routing.py:261-298) as L parallel scatter-adds.
"""

from __future__ import annotations

import numpy as np

from . import constants as const

# D8 neighbor offsets (dj, di); longitude wraps, latitude clamped.
_OFFSETS = [(-1, -1), (-1, 0), (-1, 1),
            (0, -1),           (0, 1),
            (1, -1),  (1, 0),  (1, 1)]


def _shift(arr, dj, di, fill):
    """Neighbor view: roll along lon (periodic), shift along lat with fill."""
    out = np.roll(arr, -di, axis=1)
    if dj == 0:
        return out
    res = np.full_like(out, fill)
    if dj > 0:
        res[:-dj, :] = out[dj:, :]
    else:
        res[-dj:, :] = out[:dj, :]
    return res


def pit_fill(elev: np.ndarray, land_mask: np.ndarray, max_iters: int = 200,
             eps: float = 1e-3) -> np.ndarray:
    """Iterative pit filling: raise land cells at/below their lowest D8
    neighbor to that minimum + eps (Jacobi sweep until fixed point)."""
    e = elev.astype(np.float64).copy()
    land = land_mask == 1
    for _ in range(max_iters):
        nmin = np.full_like(e, np.inf)
        for dj, di in _OFFSETS:
            nmin = np.minimum(nmin, _shift(e, dj, di, np.inf))
        fix = land & (e <= nmin) & np.isfinite(nmin)
        if not fix.any():
            break
        e = np.where(fix, nmin + eps, e)
    return e


def _offset_distance(lat_deg: np.ndarray, lon_deg: np.ndarray, dj: int,
                     di: int, dlat_deg: float) -> np.ndarray:
    """Equirectangular distance [n_lat, n_lon] for a given D8 offset
    (matches generate_hydrology_maps.spherical_distance, including the
    duplicated 0/360 meridian: the reference grid's lon spans the full
    circle inclusively, so the pure-lon seam step wraps to dlon = 0 exactly
    and is skipped by the dist > 0 guard — same as the reference's
    `if dist <= 0: continue`)."""
    R = const.PLANET_RADIUS
    lat1 = np.deg2rad(lat_deg)
    lat2 = np.deg2rad(np.clip(lat_deg + dj * dlat_deg, -90.0, 90.0))
    dlat = lat2 - lat1
    n_lon = lon_deg.size
    idx = np.arange(n_lon)
    dlon = np.deg2rad(lon_deg[(idx + di) % n_lon] - lon_deg[idx])
    dlon = np.where(dlon > np.pi, dlon - 2 * np.pi, dlon)
    dlon = np.where(dlon < -np.pi, dlon + 2 * np.pi, dlon)
    x = dlon[None, :] * np.cos(0.5 * (lat1 + lat2))[:, None]
    return R * np.sqrt(x * x + dlat[:, None] ** 2)


def compute_flow_to_index(lat: np.ndarray, lon: np.ndarray, elev: np.ndarray,
                          land_mask: np.ndarray) -> np.ndarray:
    """Steepest-descent D8 downstream linear indices; −1 = ocean/terminal sink."""
    n_lat, n_lon = elev.shape
    dlat_deg = float(lat[1] - lat[0]) if n_lat > 1 else 1.0
    land = land_mask == 1

    jj = np.arange(n_lat)[:, None] * np.ones((1, n_lon), int)
    ii = np.ones((n_lat, 1), int) * np.arange(n_lon)[None, :]

    best_slope = np.full(elev.shape, -np.inf)
    best_idx = np.full(elev.shape, -1, np.int64)
    best_is_land = np.zeros(elev.shape, bool)

    for dj, di in _OFFSETS:
        z_n = _shift(elev, dj, di, np.inf)          # inf → slope −inf at lat edges
        land_n = _shift(land.astype(np.int8), dj, di, -1)
        dist = _offset_distance(lat, lon, dj, di, dlat_deg)
        valid = np.isfinite(z_n) & (dist > 0) & (land_n >= 0)
        slope = np.where(valid, (elev - z_n) / np.where(dist > 0, dist, 1.0), -np.inf)
        nj = jj + dj
        ni = (ii + di) % n_lon
        nidx = np.clip(nj, 0, n_lat - 1) * n_lon + ni
        better = slope > best_slope
        best_slope = np.where(better, slope, best_slope)
        best_idx = np.where(better, nidx, best_idx)
        best_is_land = np.where(better, land_n == 1, best_is_land)

    flow_to = np.where(land & (best_slope > 0) & best_is_land, best_idx, -1)
    return flow_to.astype(np.int64)


def topo_levels(flow_to: np.ndarray, land_mask: np.ndarray,
                max_depth: int = 100000) -> tuple[np.ndarray, int]:
    """Longest-path level of each land cell in the D8 DAG (sources = level 0).

    level[dn] >= level[c] + 1 for every land→land edge, so processing cells
    level-by-level reproduces the effect of the reference's topological
    flow_order loop. Returns (level flat int32 [n_cells] (−1 for ocean),
    n_levels)."""
    n_cells = flow_to.size
    land_flat = land_mask.ravel() == 1
    dn = flow_to.ravel()
    src = np.nonzero(land_flat & (dn >= 0) & land_flat[np.clip(dn, 0, n_cells - 1)])[0]
    dst = dn[src]
    level = np.zeros(n_cells, np.int64)
    for _ in range(max_depth):
        prop = level[src] + 1
        newlev = level.copy()
        np.maximum.at(newlev, dst, prop)
        if np.array_equal(newlev, level):
            break
        level = newlev
    level = np.where(land_flat, level, -1)
    n_levels = int(level.max()) + 1 if land_flat.any() else 0
    return level.astype(np.int32), n_levels


def topo_sort_flow_order(flow_to: np.ndarray, land_mask: np.ndarray) -> np.ndarray:
    """Kahn topological order (for artifact parity with the reference schema);
    derived from the level map: stable sort of land cells by level."""
    level, _ = topo_levels(flow_to, land_mask)
    land_idx = np.nonzero(land_mask.ravel() == 1)[0]
    order = land_idx[np.argsort(level[land_idx], kind="stable")]
    return order.astype(np.int64)


def identify_lakes(flow_to: np.ndarray, land_mask: np.ndarray):
    """Label connected components of terminal sinks (D8 connectivity with
    longitude wrap). Returns (lake_mask uint8, lake_id int32, n_lakes)."""
    from scipy import ndimage
    term = (land_mask == 1) & (flow_to == -1)
    if not term.any():
        return (np.zeros_like(land_mask, np.uint8),
                np.zeros_like(land_mask, np.int32), 0)
    structure = np.ones((3, 3), int)
    lab, n = ndimage.label(term, structure=structure)
    # merge labels across the periodic longitude seam
    if n > 1:
        parent = np.arange(n + 1)

        def find(x):
            while parent[x] != x:
                parent[x] = parent[parent[x]]
                x = parent[x]
            return x

        left = lab[:, 0]
        right = lab[:, -1]
        n_lat = lab.shape[0]
        for j in range(n_lat):
            if left[j] == 0:
                continue
            for jj in (j - 1, j, j + 1):
                if 0 <= jj < n_lat and right[jj] > 0:
                    ra, rb = find(left[j]), find(right[jj])
                    if ra != rb:
                        parent[max(ra, rb)] = min(ra, rb)
        roots = np.array([find(x) for x in range(n + 1)])
        # compact ids
        uniq = np.unique(roots[1:])
        remap = np.zeros(n + 1, np.int32)
        remap[uniq] = np.arange(1, uniq.size + 1)
        lab = remap[roots[lab]]
        n = int(uniq.size)
    return (lab > 0).astype(np.uint8), lab.astype(np.int32), int(n)


def compute_lake_outlets(lat, lon, elev_filled, lake_mask, lake_id, land_mask):
    """Per-lake outlet: −1 if the lake touches ocean, else lowest non-lake
    land D8 neighbor (generate_hydrology_maps.py:227-273)."""
    n_lat, n_lon = lake_mask.shape
    n_lakes = int(lake_id.max())
    out = np.full((max(n_lakes, 0),), -1, np.int32)
    if n_lakes == 0:
        return out
    land = land_mask == 1
    lake = lake_mask == 1
    # neighbor pulls
    for k in range(1, n_lakes + 1):
        cells = np.argwhere(lake_id == k)
        best_idx, best_z, touches_ocean = -1, np.inf, False
        for j, i in cells:
            for dj, di in _OFFSETS:
                nj = j + dj
                if nj < 0 or nj >= n_lat:
                    continue
                ni = (i + di) % n_lon
                if lake[nj, ni]:
                    continue
                if not land[nj, ni]:
                    touches_ocean = True
                    break
                z = float(elev_filled[nj, ni])
                if z < best_z:
                    best_z = z
                    best_idx = nj * n_lon + ni
            if touches_ocean:
                break
        out[k - 1] = -1 if touches_ocean else (best_idx if best_idx >= 0 else -1)
    return out


def build_network(lat, lon, elevation, land_mask, pit_iters=200, pit_eps=1e-3):
    """Full pipeline → dict of arrays matching the reference NetCDF schema,
    plus 'flow_level'/'n_levels' for the device kernel."""
    elev_filled = pit_fill(elevation, land_mask, max_iters=pit_iters, eps=pit_eps)
    flow_to = compute_flow_to_index(lat, lon, elev_filled, land_mask)
    lake_mask, lake_id, n_lakes = identify_lakes(flow_to, land_mask)
    lake_outlets = compute_lake_outlets(lat, lon, elev_filled, lake_mask, lake_id, land_mask)
    flow_order = topo_sort_flow_order(flow_to, land_mask)
    level, n_levels = topo_levels(flow_to, land_mask)
    return {
        "lat": np.asarray(lat), "lon": np.asarray(lon),
        "land_mask": land_mask.astype(np.uint8),
        "elevation_filled": elev_filled.astype(np.float32),
        "flow_to_index": flow_to.astype(np.int32),
        "flow_order": flow_order.astype(np.int32),
        "lake_mask": lake_mask, "lake_id": lake_id,
        "lake_outlet_index": lake_outlets,
        "n_lakes": n_lakes,
        "flow_level": level, "n_levels": n_levels,
    }
