"""Restart and state files in the reference's on-disk schemas (port of
``qingdai_tpu/io/netcdf.py``).

The same variable names, dims, dtypes and attributes as the JAX package's
files, so a restart written by either package loads in the other, and a user
can move ``data/`` directories between the implementations:

- atmosphere.nc  — restart: u,v,h,T_s,cloud_cover,q,h_ice, ocean uo/vo/eta/Ts,
  W_land,S_snow,C_snow, land_mask, scalar t_seconds
  (reference scripts/run_simulation.py:63-124); a restart path ending in
  ``.pt`` takes a torch.save container of the same fields instead, which
  needs no NetCDF library
- ocean.nc       — uo,vo,eta,Ts (+day attr) (run_simulation.py:185-220)
- topography.nc  — land_mask,base_albedo,friction[,elevation] (run_simulation.py:126-159)
- ecology.nc     — LAI, species_weights, bands, R_species_nb, schema v1 with
  atomic replace + rolling backups (adapter.py:574-710)
- genes.json     — schema v3 genome table (adapter.py:284-355)
- plankton.json  — bio/optics (phyto.py:685-735); plankton.nc — distributions
  (phyto.py:737-802)

Writers take a port state on any device (each field is copied to the host);
``apply_restart_to_state``, ``load_ecology`` and ``load_plankton_nc`` return
tensors on the state's device. NetCDF goes through ``io.ncdataset``, which
needs h5py or netCDF4: where neither is installed, each NetCDF function
raises ``ImportError`` (``have_netcdf`` says so beforehand); the JSON files
need neither.
"""

from __future__ import annotations

import glob
import json
import os
import shutil
import time
from contextlib import contextmanager
from typing import Optional

import numpy as np
import torch


def Dataset(path, mode="r"):
    """``io.ncdataset.Dataset``, imported at the call: the JSON files and the
    rest of the port do not need a NetCDF library."""
    from .ncdataset import Dataset as _Dataset
    return _Dataset(path, mode)


def _np(x):
    """A host array of x (a tensor on any device, an array or a number)."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def have_netcdf() -> bool:
    """Whether a NetCDF library (h5py or netCDF4) can be imported."""
    try:
        from . import ncdataset  # noqa: F401
    except ImportError:
        return False
    return True


def _np_dtype(t: torch.Tensor) -> np.dtype:
    return torch.empty((), dtype=t.dtype).numpy().dtype


def _like(a: np.ndarray, ref: torch.Tensor) -> torch.Tensor:
    """``a`` as a tensor of ``ref``'s dtype on ``ref``'s device."""
    return torch.as_tensor(np.asarray(a)).to(device=ref.device, dtype=ref.dtype)


@contextmanager
def _atomic_nc(path):
    """Crash-safe NetCDF write: build the file as a hidden sibling tmp and
    os.replace it into place, so a SIGKILL/power-cut mid-write leaves the
    previous checkpoint intact instead of a torn file that makes every
    subsequent startup fail to load (the ecology autosave already wrote
    this way; restart/ocean/topography now do too)."""
    tmp = os.path.join(os.path.dirname(path) or ".",
                       "." + os.path.basename(path) + ".tmp")
    try:
        yield tmp
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            try:
                os.remove(tmp)
            except OSError:
                pass


# ---------------------------------------------------------------------------
# Restart (atmosphere.nc, or the torch.save container restart_*.pt)
# ---------------------------------------------------------------------------

# the restart's 2-D fields, in the order the file holds them: the reference
# schema, then the humidity/cloud flux caches as EXTRA variables (the
# reference's field-by-field tolerant loader ignores unknown names,
# run_simulation.py:161-183, so the schema stays interchangeable, while our
# own loader prefers them over the warm-cache bootstrap replay: a restart
# then carries the exact caches, and the first step after it cannot blend
# the legacy convergence-precip fallback at cold-start violence)
RESTART_VARS = ("u", "v", "h", "T_s", "cloud_cover", "q", "h_ice", "uo", "vo", "eta", "Ts",
                "W_land", "S_snow", "C_snow", "land_mask", "P_cond_flux_last", "E_flux_last",
                "LH_last", "LH_release_last", "cloud_eff_last")
PT_FORMAT = 1


def is_pt(path) -> bool:
    """Whether a restart path names the torch.save container (``.pt``)
    rather than a NetCDF file."""
    return str(path).endswith(".pt")


def restart_fields(state, land_mask) -> dict:
    """{name: float32 host array} of a state's restart fields (a state on
    any device): what both containers hold, so they cannot drift apart."""
    atmos, ocean, land = state.atmos, state.ocean, state.land
    src = {"u": atmos.u, "v": atmos.v, "h": atmos.h, "T_s": atmos.T_s,
           "cloud_cover": atmos.cloud_cover, "q": atmos.q, "h_ice": atmos.h_ice,
           "W_land": land.W_land, "S_snow": land.S_snow, "C_snow": land.C_snow,
           "land_mask": land_mask, "P_cond_flux_last": atmos.P_cond_flux_last,
           "E_flux_last": atmos.E_flux_last, "LH_last": atmos.LH_last,
           "LH_release_last": atmos.LH_release_last, "cloud_eff_last": atmos.cloud_eff_last}
    if ocean is not None:
        src.update(uo=ocean.uo, vo=ocean.vo, eta=ocean.eta, Ts=ocean.sst)
    return {k: _np(src[k]).astype(np.float32) for k in RESTART_VARS
            if src.get(k) is not None}


def save_restart(path, grid_lat, grid_lon, state, land_mask,
                 t_seconds: Optional[float] = None) -> None:
    """Write the minimal prognostic state (reference schema, f4 fields);
    a ``.pt`` path takes the torch.save container instead."""
    save_restart_fields(path, grid_lat, grid_lon, restart_fields(state, land_mask),
                        t_seconds=t_seconds)


def save_restart_fields(path, grid_lat, grid_lon, fields: dict,
                        t_seconds: Optional[float] = None) -> None:
    """save_restart over a plain {name: 2-D array} dict (the regrid tool's
    writer). A ``.pt`` path writes the torch.save container, which needs no
    NetCDF library: the same fields in float32, the grid and the epoch,
    renamed into place as the NetCDF file is."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    t = float(t_seconds) if t_seconds is not None else 0.0
    fields = {name: _np(data).astype(np.float32) for name, data in fields.items()
              if data is not None and np.ndim(data) == 2}
    if is_pt(path):
        payload = {"format": PT_FORMAT, "t_seconds": t,
                   "lat": torch.from_numpy(_np(grid_lat).astype(np.float32)),
                   "lon": torch.from_numpy(_np(grid_lon).astype(np.float32)),
                   "fields": {k: torch.from_numpy(v) for k, v in fields.items()}}
        tmp = os.path.join(os.path.dirname(path) or ".", "." + os.path.basename(path) + ".tmp")
        try:
            torch.save(payload, tmp)
            os.replace(tmp, path)
        finally:
            if os.path.exists(tmp):
                os.remove(tmp)
        return
    with _atomic_nc(path) as tmp, Dataset(tmp, "w") as ds:
        ds.createDimension("lat", len(grid_lat))
        ds.createDimension("lon", len(grid_lon))
        ds.createVariable("lat", "f4", ("lat",))[:] = _np(grid_lat)
        ds.createVariable("lon", "f4", ("lon",))[:] = _np(grid_lon)
        for name, data in fields.items():
            ds.createVariable(name, "f4", ("lat", "lon"))[:] = data
        vts = ds.createVariable("t_seconds", "f8", ())
        vts[...] = t
        ds.setncattr("title", "Qingdai GCM Restart")
        ds.setncattr("creator", "qingdai_tpu_torch")
        ds.setncattr("format", "v1")


def load_restart(path) -> dict:
    """Load a restart file → dict of arrays (None for missing variables),
    the NetCDF file or, by its ``.pt`` suffix, the torch.save container."""
    if is_pt(path):
        payload = torch.load(path, map_location="cpu", weights_only=True)
        if payload.get("format") != PT_FORMAT:
            raise ValueError(f"{path}: restart format {payload.get('format')!r}, "
                             f"not {PT_FORMAT}")
        fields = payload["fields"]
        out = {"lat": payload["lat"].numpy(), "lon": payload["lon"].numpy()}
        out.update({name: fields[name].numpy() if name in fields else None
                    for name in RESTART_VARS})
        out["t_seconds"] = float(payload["t_seconds"])
        return out
    out = {}
    with Dataset(path, "r") as ds:
        def r(name):
            try:
                return np.asarray(ds.variables[name][:])
            except KeyError:
                return None
        out["lat"] = r("lat")
        out["lon"] = r("lon")
        for name in RESTART_VARS:
            out[name] = r(name)
        try:
            out["t_seconds"] = float(np.asarray(ds.variables["t_seconds"][...]))
        except KeyError:
            out["t_seconds"] = None
    return out


def apply_restart_to_state(state, rst, has_ocean=True):
    """Field-wise tolerant application (run_simulation.py:1441-1463), on the
    state's device in its dtype."""
    import dataclasses
    atmos = state.atmos

    def use(name, cur, post=None):
        v = rst.get(name)
        if v is None:
            return cur
        v = _like(v, cur)
        return post(v) if post else v

    atmos = dataclasses.replace(
        atmos,
        u=use("u", atmos.u), v=use("v", atmos.v), h=use("h", atmos.h),
        T_s=use("T_s", atmos.T_s),
        cloud_cover=use("cloud_cover", atmos.cloud_cover,
                        lambda v: torch.clamp(v, 0.0, 1.0)),
        q=use("q", atmos.q),
        h_ice=use("h_ice", atmos.h_ice, lambda v: torch.clamp(v, min=0.0)),
        P_cond_flux_last=use("P_cond_flux_last", atmos.P_cond_flux_last,
                             lambda v: torch.clamp(v, min=0.0)),
        E_flux_last=use("E_flux_last", atmos.E_flux_last,
                        lambda v: torch.clamp(v, min=0.0)),
        LH_last=use("LH_last", atmos.LH_last),
        LH_release_last=use("LH_release_last", atmos.LH_release_last),
        cloud_eff_last=use("cloud_eff_last", atmos.cloud_eff_last,
                           lambda v: torch.clamp(v, 0.0, 1.0)),
    )
    ocean = state.ocean
    if has_ocean and ocean is not None:
        ocean = dataclasses.replace(
            ocean, uo=use("uo", ocean.uo), vo=use("vo", ocean.vo),
            eta=use("eta", ocean.eta), sst=use("Ts", ocean.sst))
    land = dataclasses.replace(
        state.land, W_land=use("W_land", state.land.W_land),
        S_snow=use("S_snow", state.land.S_snow),
        C_snow=use("C_snow", state.land.C_snow))
    return dataclasses.replace(state, atmos=atmos, ocean=ocean, land=land)


# ---------------------------------------------------------------------------
# Ocean / topography
# ---------------------------------------------------------------------------

def save_ocean(path, grid_lat, grid_lon, ocean, day_value=None) -> bool:
    try:
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with _atomic_nc(path) as tmp, Dataset(tmp, "w") as ds:
            ds.createDimension("lat", len(grid_lat))
            ds.createDimension("lon", len(grid_lon))
            ds.createVariable("lat", "f4", ("lat",))[:] = _np(grid_lat)
            ds.createVariable("lon", "f4", ("lon",))[:] = _np(grid_lon)
            for name, data in [("uo", ocean.uo), ("vo", ocean.vo),
                               ("eta", ocean.eta), ("Ts", ocean.sst)]:
                ds.createVariable(name, "f4", ("lat", "lon"))[:] = \
                    _np(data).astype(np.float32)
            ds.setncattr("title", "Qingdai Ocean State")
            ds.setncattr("source", "qingdai_tpu_torch")
            if day_value is not None:
                ds.setncattr("day", float(day_value))
        return True
    except OSError as e:
        print(f"[Ocean] Save failed: {e}")
        return False


def load_ocean(path) -> dict:
    out = {"uo": None, "vo": None, "eta": None, "Ts": None, "day": None}
    try:
        with Dataset(path, "r") as ds:
            for name in ("uo", "vo", "eta", "Ts"):
                try:
                    out[name] = np.asarray(ds.variables[name][:])
                except KeyError:
                    pass
            try:
                out["day"] = float(ds.getncattr("day"))
            except (KeyError, AttributeError):
                pass
    except OSError as e:
        print(f"[Ocean] Load failed '{path}': {e}")
    return out


def save_topography(path, grid_lat, grid_lon, land_mask, base_albedo,
                    friction, elevation=None, provenance=None) -> None:
    """Standardized topography.nc (run_simulation.py:126-159).

    ``provenance`` (dict of scalar attrs, e.g. ``generation_seed`` /
    ``target_land_fraction`` / ``sea_level_m``) is stamped onto the file so
    that re-exports keep the generation identity of the field they carry —
    scripts/spinup.py's reuse guard keys on these attrs, and the engine
    rewrites data/topography.nc on every build."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with _atomic_nc(path) as tmp, Dataset(tmp, "w") as ds:
        ds.createDimension("lat", len(grid_lat))
        ds.createDimension("lon", len(grid_lon))
        ds.createVariable("lat", "f4", ("lat",))[:] = _np(grid_lat)
        ds.createVariable("lon", "f4", ("lon",))[:] = _np(grid_lon)
        ds.createVariable("land_mask", "u1", ("lat", "lon"))[:] = \
            _np(land_mask).astype(np.uint8)
        ds.createVariable("base_albedo", "f4", ("lat", "lon"))[:] = \
            _np(base_albedo).astype(np.float32)
        ds.createVariable("friction", "f4", ("lat", "lon"))[:] = \
            _np(friction).astype(np.float32)
        if elevation is not None:
            ds.createVariable("elevation", "f4", ("lat", "lon"))[:] = \
                _np(elevation).astype(np.float32)
        ds.setncattr("title", "Qingdai Topography")
        ds.setncattr("source", "qingdai_tpu_torch")
        ds.setncattr("format", "v1")
        for k, v in (provenance or {}).items():
            if v is not None:
                ds.setncattr(k, v)


# ---------------------------------------------------------------------------
# Ecology state (ecology.nc, schema v1) + genes.json (schema v3)
# ---------------------------------------------------------------------------

def save_ecology(path, grid_lat, grid_lon, eco_state, bands, w_b,
                 day_value=None, keep: Optional[int] = None) -> bool:
    """Atomic-replace + rolling-backup ecology autosave (adapter.py:574-710).

    Writes total LAI, active species weights, band definitions and the
    per-species leaf reflectance table.
    """
    try:
        out_dir = os.path.dirname(path) or "."
        base = os.path.basename(path)
        name, ext = os.path.splitext(base)
        os.makedirs(out_dir, exist_ok=True)
        ts = time.strftime("%Y%m%dT%H%M%SZ", time.gmtime())
        backup_path = os.path.join(out_dir, f"{name}_{ts}{ext}")
        tmp_path = os.path.join(out_dir, f".{name}.tmp{ext}")

        LAI = _np(eco_state.LAI_SK).sum(axis=(0, 1))
        active = _np(eco_state.active)
        n_act = int(_np(eco_state.n_active))
        species_w = _np(eco_state.species_weights)[:n_act]
        R_species = _np(eco_state.R_leaf)[:n_act]

        with Dataset(tmp_path, "w") as ds:
            nlat, nlon = len(grid_lat), len(grid_lon)
            ds.createDimension("lat", nlat)
            ds.createDimension("lon", nlon)
            ds.createDimension("species", max(1, n_act))
            ds.createDimension("band", int(bands.nbands))
            ds.createVariable("lat", "f4", ("lat",))[:] = _np(grid_lat)
            ds.createVariable("lon", "f4", ("lon",))[:] = _np(grid_lon)
            ds.createVariable("LAI", "f4", ("lat", "lon"))[:] = \
                LAI.astype(np.float32)
            ds.createVariable("species_weights", "f4", ("species",))[:] = \
                species_w.astype(np.float32)
            ds.createVariable("bands_lambda_centers", "f4", ("band",))[:] = \
                _np(bands.lambda_centers).astype(np.float32)
            ds.createVariable("bands_delta_lambda", "f4", ("band",))[:] = \
                _np(bands.delta_lambda).astype(np.float32)
            ds.createVariable("w_b", "f4", ("band",))[:] = \
                _np(w_b).astype(np.float32)
            ds.createVariable("R_species_nb", "f4", ("species", "band"))[:] = \
                R_species.astype(np.float32)
            # extended (TPU) fields for exact resume — ignored by the reference
            ds.createVariable("seed_bank", "f4", ("lat", "lon"))[:] = \
                _np(eco_state.seed_bank).astype(np.float32)
            ds.createVariable("age_days", "f4", ("lat", "lon"))[:] = \
                _np(eco_state.age_days).astype(np.float32)
            if day_value is not None:
                v = ds.createVariable("day_value", "f4", ())
                v[...] = float(day_value)
            ds.setncattr("title", "Qingdai Ecology State")
            ds.setncattr("schema_version", 1)
            ds.setncattr("source", "qingdai_tpu_torch.io.save_ecology")
        os.replace(tmp_path, path)

        try:
            shutil.copy2(path, backup_path)
        except OSError:
            backup_path = None
        keep = keep if keep is not None else int(os.getenv("QD_ECO_AUTOSAVE_KEEP", "4"))
        files = sorted(glob.glob(os.path.join(out_dir, f"{name}_*{ext}")),
                       key=os.path.getmtime, reverse=True)
        for old in files[keep:]:
            try:
                os.remove(old)
            except OSError:
                pass
        return True
    except OSError as e:
        print(f"[Ecology] Autosave save failed: {e}")
        return False


def load_ecology(path, eco_state, es, cfg) -> tuple:
    """Restore LAI/species weights (+reflectance if bands match) into the
    static-S EcoState, mirroring adapter.load_autosave's split of LAI across
    species×layers (adapter.py:742-757). Returns (eco_state, ok), the
    state on its own device."""
    import dataclasses
    try:
        with Dataset(path, "r") as ds:
            LAI = np.asarray(ds.variables["LAI"][:]) if "LAI" in ds.variables else None
            w = (np.asarray(ds.variables["species_weights"][:])
                 if "species_weights" in ds.variables else None)
            centers = (np.asarray(ds.variables["bands_lambda_centers"][:])
                       if "bands_lambda_centers" in ds.variables else None)
            R = (np.asarray(ds.variables["R_species_nb"][:])
                 if "R_species_nb" in ds.variables else None)
            sb = (np.asarray(ds.variables["seed_bank"][:])
                  if "seed_bank" in ds.variables else None)
            age = (np.asarray(ds.variables["age_days"][:])
                   if "age_days" in ds.variables else None)
    except (OSError, KeyError) as e:
        print(f"[Ecology] Autosave load failed: {e}")
        return eco_state, False
    if LAI is None or LAI.ndim != 2 or w is None or w.ndim != 1:
        return eco_state, False

    S, K = es.S, es.K
    n_act = min(int(w.size), S)
    dtype = _np_dtype(eco_state.E_day)
    w = np.clip(w[:n_act], 0.0, None)
    ssum = w.sum()
    w = w / ssum if ssum > 0 else np.full(n_act, 1.0 / max(n_act, 1))
    LAI = np.clip(LAI, 0.0, cfg.lai_max)
    LAI_SK = np.zeros((S, K) + LAI.shape, dtype)
    for s in range(n_act):
        LAI_SK[s, :, :, :] = w[s] * (LAI / K)
    weights_full = np.zeros((S,), dtype)
    weights_full[:n_act] = w
    active = np.zeros((S,), bool)
    active[:n_act] = True

    new = dataclasses.replace(
        eco_state,
        LAI_SK=_like(LAI_SK, eco_state.LAI_SK),
        species_weights=_like(weights_full, eco_state.species_weights),
        active=_like(active, eco_state.active),
        n_active=_like(np.int32(n_act), eco_state.n_active),
    )
    if (centers is not None and centers.size == es.NB and R is not None
            and R.ndim == 2 and R.shape[1] == es.NB):
        R_full = _np(eco_state.R_leaf).copy()
        R_full[:min(n_act, R.shape[0])] = R[:min(n_act, R.shape[0])]
        new = dataclasses.replace(new, R_leaf=_like(R_full.astype(dtype), eco_state.R_leaf))
    if sb is not None:
        new = dataclasses.replace(new, seed_bank=_like(sb.astype(dtype), eco_state.seed_bank))
    if age is not None:
        new = dataclasses.replace(new, age_days=_like(age.astype(dtype), eco_state.age_days))
    return new, True


def save_genes_json(path, genes_list, bands, w_b, species_weights=None,
                    day_value=None) -> bool:
    """Schema-v3 genome table (adapter.py:284-355)."""
    try:
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        table = []
        for i, g in enumerate(genes_list):
            peaks_out = [{"center_nm": float(pk.center_nm),
                          "sigma_nm": float(pk.width_nm),
                          "variance_nm2": float(pk.width_nm) ** 2,
                          "height": float(pk.height)}
                         for pk in g.absorption_peaks]
            entry = {
                "index": i, "identity": g.identity, "provenance": g.provenance,
                "alloc_root": float(g.alloc_root),
                "alloc_stem": float(g.alloc_stem),
                "alloc_leaf": float(g.alloc_leaf),
                "leaf_area_per_energy": float(g.leaf_area_per_energy),
                "drought_tolerance": float(g.drought_tolerance),
                "gdd_germinate": float(g.gdd_germinate),
                "lifespan_days": int(g.lifespan_days),
                "peaks_model": "gaussian", "peaks": peaks_out,
            }
            if species_weights is not None and i < len(species_weights):
                entry["weight"] = float(species_weights[i])
            table.append(entry)
        doc = {
            "schema_version": 3,
            "source": "qingdai_tpu_torch.io.save_genes_json",
            "day": float(day_value) if day_value is not None else None,
            "bands": {"nbands": int(bands.nbands),
                      "band_weights": [float(x) for x in _np(w_b).tolist()]},
            "genes": table,
        }
        if species_weights is not None:
            doc["species_weights"] = [float(x) for x in species_weights]
        with open(path, "w", encoding="utf-8") as f:
            json.dump(doc, f, ensure_ascii=False, indent=2)
        return True
    except OSError as e:
        print(f"[Ecology] Genes save failed: {e}")
        return False


def load_genes_json(path) -> Optional[list]:
    """Parse a schema-v3 genes.json → list of Genes (adapter.py:357-426)."""
    from ..ecology.genes import Genes, Peak
    try:
        with open(path, "r", encoding="utf-8") as f:
            doc = json.load(f)
    except (OSError, json.JSONDecodeError) as e:
        print(f"[Ecology] Genes load failed: {e}")
        return None
    out = []
    for rec in doc.get("genes", []):
        peaks = []
        for pk in rec.get("peaks", []) or []:
            sigma = float(pk.get("sigma_nm", 0.0))
            if sigma <= 0 and "variance_nm2" in pk:
                sigma = float(np.sqrt(max(0.0, float(pk.get("variance_nm2", 0.0)))))
            peaks.append(Peak(float(pk.get("center_nm", 0.0)), sigma,
                              float(pk.get("height", 0.0))))
        g = Genes(
            identity=str(rec.get("identity", "sp")),
            alloc_root=float(rec.get("alloc_root", 0.3)),
            alloc_stem=float(rec.get("alloc_stem", 0.2)),
            alloc_leaf=float(rec.get("alloc_leaf", 0.5)),
            leaf_area_per_energy=float(rec.get("leaf_area_per_energy", 2.0e-3)),
            absorption_peaks=peaks,
            drought_tolerance=float(rec.get("drought_tolerance", 0.3)),
            gdd_germinate=float(rec.get("gdd_germinate", 80.0)),
            lifespan_days=int(rec.get("lifespan_days", 365)),
            provenance="autosave:genes_json",
        ).normalized()
        out.append(g)
    return out if out else None


# ---------------------------------------------------------------------------
# Plankton (plankton.json + plankton.nc)
# ---------------------------------------------------------------------------

def save_plankton_bio_json(path, ps, cfg, bands, day_value=None) -> bool:
    """Bio/optics JSON (phyto.py:685-735)."""
    try:
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        doc = {
            "schema_version": 1,
            "source": "qingdai_tpu_torch.io.save_plankton_bio_json",
            "day": float(day_value) if day_value is not None else None,
            "bands": {
                "nbands": int(bands.nbands),
                "lambda_centers_nm": [float(x) for x in _np(bands.lambda_centers)],
                "delta_lambda_nm": [float(x) for x in _np(bands.delta_lambda)],
            },
            "params": {
                "alpha_P": float(cfg.alpha_P), "Q10": float(cfg.Q10),
                "T_ref": float(cfg.T_ref),
                "lambda_sink_m_per_day": float(cfg.lambda_sink),
            },
            "species": {
                "mu_max_s": [float(x) for x in _np(ps.mu_max_s)],
                "m0_s": [float(x) for x in _np(ps.m0_s)],
                "c_reflect_s": [float(x) for x in _np(ps.c_reflect_s)],
                "p_reflect_s": [float(x) for x in _np(ps.p_reflect_s)],
                "shape_sb": _np(ps.shape_sb).tolist(),
            },
            "optics": {
                "Kd0_b": [float(x) for x in _np(ps.Kd0_b)],
                "kchl_b": [float(x) for x in _np(ps.kchl_b)],
                "Apure_b": [float(x) for x in _np(ps.Apure_b)],
            },
        }
        with open(path, "w", encoding="utf-8") as f:
            json.dump(doc, f, ensure_ascii=False, indent=2)
        return True
    except OSError as e:
        print(f"[Phyto] save bio json failed: {e}")
        return False


def save_plankton_nc(path, grid_lat, grid_lon, phyto_state, ps, bands,
                     day_value=None) -> bool:
    """Gridded distributions (phyto.py:737-802)."""
    try:
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with _atomic_nc(path) as tmp, Dataset(tmp, "w") as ds:
            NL, NM = len(grid_lat), len(grid_lon)
            ds.createDimension("lat", NL)
            ds.createDimension("lon", NM)
            ds.createDimension("species", int(ps.S))
            ds.createDimension("band", int(bands.nbands))
            ds.createVariable("lat", "f4", ("lat",))[:] = _np(grid_lat)
            ds.createVariable("lon", "f4", ("lon",))[:] = _np(grid_lon)
            ds.createVariable("C_phyto_s", "f4", ("species", "lat", "lon"))[:] = \
                _np(phyto_state.C_phyto).astype(np.float32)
            ds.createVariable("alpha_water_bands", "f4", ("band", "lat", "lon"))[:] = \
                _np(phyto_state.alpha_bands).astype(np.float32)
            ds.createVariable("alpha_water_scalar", "f4", ("lat", "lon"))[:] = \
                _np(phyto_state.alpha_scalar).astype(np.float32)
            ds.createVariable("Kd_490", "f4", ("lat", "lon"))[:] = \
                _np(phyto_state.Kd_490).astype(np.float32)
            ds.createVariable("N", "f4", ("lat", "lon"))[:] = \
                _np(phyto_state.N).astype(np.float32)
            ds.createVariable("bands_lambda_centers", "f4", ("band",))[:] = \
                _np(bands.lambda_centers).astype(np.float32)
            ds.setncattr("title", "Qingdai Phytoplankton Distributions")
            ds.setncattr("H_mld_m", float(ps.H_mld))
            ds.setncattr("S", int(ps.S))
            ds.setncattr("NB", int(bands.nbands))
            if day_value is not None:
                ds.setncattr("day", float(day_value))
        return True
    except OSError as e:
        print(f"[Phyto] save distribution failed: {e}")
        return False


def load_plankton_nc(path, phyto_state, ps) -> tuple:
    """Apply plankton.nc distributions if shapes match (phyto.py:942-1000).
    Returns (phyto_state, status) with status in {"ok", "read_error",
    "mismatch"} — the reference resets state only on a genuine dims
    mismatch (phyto.py:946-981) and keeps it on a read failure, so the
    caller must be able to tell the two apart. Tensors stay on the state's
    device."""
    import dataclasses
    try:
        with Dataset(path, "r") as ds:
            def r(name):
                try:
                    return np.asarray(ds.variables[name][:])
                except KeyError:
                    return None
            C = r("C_phyto_s")
            ab = r("alpha_water_bands")
            aS = r("alpha_water_scalar")
            kd = r("Kd_490")
            N = r("N")
    except OSError as e:
        print(f"[Phyto] load distribution failed: {e}")
        return phyto_state, "read_error"
    shape = tuple(phyto_state.N.shape)
    dtype = _np_dtype(phyto_state.N)
    if C is None or C.ndim != 3 or C.shape[1:] != shape or C.shape[0] != ps.S:
        return phyto_state, "mismatch"
    ocean = _np(ps.ocean)
    C = np.where(ocean[None], np.clip(C, 0.0, np.inf), 0.0).astype(dtype)
    ref = phyto_state.N
    new = dataclasses.replace(phyto_state, C_phyto=_like(C, ref))
    if ab is not None and ab.shape == tuple(phyto_state.alpha_bands.shape):
        new = dataclasses.replace(new, alpha_bands=_like(ab.astype(dtype), ref))
    if aS is not None and aS.shape == shape:
        new = dataclasses.replace(new, alpha_scalar=_like(aS.astype(dtype), ref))
    if kd is not None and kd.shape == shape:
        new = dataclasses.replace(new, Kd_490=_like(np.clip(kd, 0, np.inf).astype(dtype), ref))
    if N is not None and N.shape == shape:
        new = dataclasses.replace(new, N=_like(np.clip(N, 0, np.inf).astype(dtype), ref))
    return new, "ok"
