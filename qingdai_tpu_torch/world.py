"""QingdaiWorld: the host-side driver of the port (port of
``qingdai_tpu/world.py``).

The step runs in ``model.make_chunk_fn`` chunks on the model's device; this
class owns only host concerns: the topography and the river network (built
or loaded), restarts and autosaves in the reference's NetCDF schemas with
the full-state sidecar beside them, signal-safe checkpointing, the NaN check
and the reference's bracketed diagnostics. The diags of a chunk come to the
host in one transfer.

Where neither h5py nor netCDF4 is installed, the NetCDF files (the
topography re-export, the hydrology network, the autosave's NetCDF set) are
skipped with one printed line each, and a resume reads the sidecar alone.
A ``QD_RESTART_IN`` that is given still raises if it cannot be read; one
ending in ``.pt`` is the torch.save restart container, which needs no NetCDF
library. A ``QD_TOPO_NC`` that exists but cannot be read for want of a
library raises; the topography can instead be handed over in memory
(``topography=``, as the spin-up does there).

``run`` renders the reference's panels (``viz/``) at the start and every
``QD_PLOT_EVERY_DAYS`` days, and the diversity diagnostics every
``QD_ECO_DIVERSITY_EVERY_DAYS`` days when enabled, on the IO worker from a
snapshot taken at dispatch; without matplotlib it says so on one line and
writes no panel.
"""

from __future__ import annotations

import atexit
import dataclasses
import os
import signal
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from types import SimpleNamespace
from typing import Optional

import numpy as np
import torch

from . import constants as const
from . import hydro_network as hn
from . import model as M
from . import topography as topo
from .config import SimConfig
from .grid import resolve_device
from .io import checkpoint as ckpt
from .io import netcdf as ncio
from .physics.orbital import T_PLANET

DTYPES = {"float32": torch.float32, "float64": torch.float64}
# the sidecar's name differs from the JAX package's (data/world_ckpt[.npz])
SIDECAR = "world_ckpt.pt"
# groups of the NaN check (the albedo caches carry NaN sentinels by design)
NANCHECK_GROUPS = ("atmos", "ocean", "land", "energy", "clock", "eco", "indiv", "phyto",
                   "routing")
# what a topography handed over in memory holds (the arrays and attributes a
# topography file holds)
TOPO_ARRAYS = ("elevation", "land_mask", "base_albedo", "friction")
TOPO_PROVENANCE = ("generation_seed", "target_land_fraction", "sea_level_m")


def _to_host(state, numpy=False):
    """A copy of ``state`` with every tensor on the CPU, or as a NumPy array
    with ``numpy=True`` (the snapshot the plots read)."""
    def leaf(x):
        x = x.cpu()
        return x.numpy() if numpy else x

    def group(g):
        if g is None:
            return None
        return dataclasses.replace(g, **{f.name: leaf(getattr(g, f.name))
                                         for f in dataclasses.fields(g)
                                         if isinstance(getattr(g, f.name), torch.Tensor)})
    return dataclasses.replace(state, **{f.name: group(getattr(state, f.name))
                                         for f in dataclasses.fields(state)})


def have_matplotlib() -> bool:
    """Whether matplotlib can be imported (the panels need it)."""
    try:
        import matplotlib  # noqa: F401
    except ImportError:
        return False
    return True


class QingdaiWorld:
    """Owns (model, state) and runs the simulation loop, on the card unless
    ``device`` says otherwise. Files go under ``data/`` of the working
    directory at construction. ``topography``, a dict of ``TOPO_ARRAYS``
    (and optionally ``TOPO_PROVENANCE``) on the configured grid, takes the
    place of ``QD_TOPO_NC``'s file."""

    def __init__(self, cfg: Optional[SimConfig] = None, verbose: bool = True,
                 device="cuda", topography: Optional[dict] = None):
        self.cfg = cfg or SimConfig.from_env()
        self.verbose = verbose
        if (self.cfg.run.restart_out and not ncio.is_pt(self.cfg.run.restart_out)
                and not ncio.have_netcdf()):
            # refused now rather than after the whole run, which would end
            # with nothing written
            raise RuntimeError(
                f"QD_RESTART_OUT={self.cfg.run.restart_out!r} writes a NetCDF restart, and "
                "neither h5py nor netCDF4 can be imported here; name a .pt file instead, or "
                f"unset it and resume from the autosave's torch.save sidecar, data/{SIDECAR}")
        self.device = resolve_device(device)
        self.day_seconds = const.DAY_SECONDS
        self.data_dir = os.path.abspath("data")
        self.output_dir = os.path.abspath("output")
        self._build(topography)
        self._init_state()
        self._chunk_fns = {}
        self._hydro_prev = None  # (time_s, total_reservoir_mean)
        self._oceanE_prev = None  # (sst_mean, sst_polar_mean) at the last diag
        self._autosave_registered = False
        self._autosave_future = None
        self._last_autosave_wall = -1e18
        # one IO worker writes autosaves off the chunk loop
        self._io_pool = ThreadPoolExecutor(max_workers=1, thread_name_prefix="qd-io")
        self._io_futures = []

    # ------------------------------------------------------------------ build
    def _log(self, msg):
        if self.verbose:
            print(msg)

    def _warn(self, msg):
        """Restore decisions and IO failures print whatever the verbosity."""
        print(msg, flush=True)

    def _data(self, name):
        return os.path.join(self.data_dir, name)

    def _build(self, topography=None):
        cfg = self.cfg
        n_lat, n_lon = cfg.run.n_lat, cfg.run.n_lon
        self.lat = np.linspace(-90, 90, n_lat)
        self.lon = np.linspace(0, 360, n_lon)
        lon_mesh, lat_mesh = np.meshgrid(self.lon, self.lat)

        # Topography: in memory, external NetCDF or procedural
        # (run_simulation.py:1197-1226). The procedural planet keeps only the
        # mask (elevation None), as the reference driver does; full orography
        # needs QD_TOPO_NC or the arrays in memory.
        elevation = None
        topo_prov = {}
        loaded = False
        if topography is not None:
            elevation, land_mask, base_albedo, friction = (np.asarray(topography[k])
                                                           for k in TOPO_ARRAYS)
            if land_mask.shape != (n_lat, n_lon):
                raise ValueError(f"the topography in memory is {land_mask.shape}, the grid "
                                 f"{n_lat}x{n_lon}")
            topo_prov = {k: topography[k] for k in TOPO_PROVENANCE if k in topography}
            loaded = True
            self._log("[Topo] Taken from memory.")
        elif cfg.run.topo_nc and os.path.exists(cfg.run.topo_nc):
            if not ncio.have_netcdf():
                # the reference does not fall back here either: a planet
                # without its orography would run on, mislabelled
                raise RuntimeError(
                    f"QD_TOPO_NC={cfg.run.topo_nc!r} is a NetCDF file, and neither h5py nor "
                    "netCDF4 can be imported here; hand the topography over in memory "
                    "(QingdaiWorld(topography=...)) or unset QD_TOPO_NC")
            try:
                elevation, land_mask, base_albedo, friction = \
                    topo.load_topography_from_netcdf(cfg.run.topo_nc, self.lat, self.lon)
                from .io.ncdataset import Dataset
                with Dataset(cfg.run.topo_nc, "r") as ds:
                    for k in ("generation_seed", "target_land_fraction", "sea_level_m"):
                        v = getattr(ds, k, None)
                        if v is not None:
                            topo_prov[k] = float(v) if k != "generation_seed" else int(v)
                loaded = True
                self._log(f"[Topo] Loaded: {cfg.run.topo_nc}")
            except (OSError, ValueError, KeyError) as e:
                self._warn(f"[Topo] Failed to load '{cfg.run.topo_nc}': {e} — procedural "
                           "fallback.")
        if not loaded:
            land_mask, _elev_discarded = topo.create_land_sea_mask(
                lat_mesh, lon_mesh, cfg.run.target_land_frac, cfg.run.seed)
            elevation = None
            base_albedo, friction = topo.generate_base_properties(land_mask)
            topo_prov = {"generation_seed": int(cfg.run.seed),
                         "target_land_fraction": float(cfg.run.target_land_frac)}
            area_w = np.maximum(np.cos(np.deg2rad(lat_mesh)), 0)
            frac = float((area_w * (land_mask == 1)).sum() / (area_w.sum() + 1e-15))
            self._log(f"[Topo] Procedural topography. Land fraction: {frac:.3f}")
        try:
            ncio.save_topography(self._data("topography.nc"), self.lat, self.lon, land_mask,
                                 base_albedo, friction, elevation, provenance=topo_prov)
        except (OSError, ImportError) as e:
            self._log(f"[Topo] topography.nc write skipped: {e}")
        self.land_mask = land_mask
        self.elevation = elevation
        self.base_albedo = base_albedo
        self.friction = friction

        # Hydrology network: load or generate (run_simulation.py:1296-1321)
        network = None
        if cfg.hydrology.routing_enable:
            path = cfg.hydrology.network_path
            if path and os.path.exists(path):
                try:
                    network = hn.load_network_netcdf(path)
                    shp = np.asarray(network["land_mask"]).shape
                    if shp != np.asarray(land_mask).shape:
                        self._log(f"[HydroRouting] '{path}' is {shp}, grid is "
                                  f"{np.asarray(land_mask).shape}; regenerating.")
                        network = None
                    else:
                        self._log(f"[HydroRouting] Loaded network '{path}'.")
                except (OSError, KeyError, ImportError) as e:
                    self._log(f"[HydroRouting] Load failed ({e}); regenerating.")
            if network is None:
                network = hn.build_network(
                    self.lat, self.lon,
                    elevation if elevation is not None else np.zeros_like(land_mask, float),
                    land_mask)
                if path and not os.path.exists(path):
                    # never clobber an existing file (it may belong to another
                    # grid's run in this working directory)
                    try:
                        hn.save_network_netcdf(path, network)
                        self._log(f"[HydroRouting] Auto-generated network → '{path}'.")
                    except (OSError, ImportError) as e:
                        self._log(f"[HydroRouting] network file not written: {e}")
        self.network = network

        if cfg.run.dtype not in DTYPES:
            raise ValueError(f"QD_DTYPE={cfg.run.dtype!r}: the port runs {sorted(DTYPES)}")
        self.model = M.build_model(cfg, land_mask, base_albedo, friction, elevation=elevation,
                                   network=network, device=self.device,
                                   dtype=DTYPES[cfg.run.dtype])
        self._log(f"[Model] grid {n_lat}x{n_lon}, dt={cfg.run.dt_seconds}s, "
                  f"ocean_substeps={self.model.n_ocean_substeps}, device {self.device}")

    # ------------------------------------------------------------------ state
    def _init_state(self):
        cfg = self.cfg
        t0 = 0.0
        rst = None
        # Restart priority: QD_RESTART_IN > autosave > banded init
        # (run_simulation.py:1433-1590). The autosave is data/atmosphere.nc
        # with the sidecar beside it, or the sidecar alone where no NetCDF
        # library wrote atmosphere.nc.
        used_autosave = False
        sidecar_alone = False
        atmos_nc = self._data("atmosphere.nc")
        sidecar = self._data(SIDECAR)
        if cfg.run.restart_in and os.path.exists(cfg.run.restart_in):
            # an explicit QD_RESTART_IN that cannot be read stops the run:
            # resuming cold would discard the run the user asked to continue
            rst = ncio.load_restart(cfg.run.restart_in)
            self._log(f"[Restart] Loaded state from '{cfg.run.restart_in}'.")
        elif cfg.run.autosave_load and os.path.exists(atmos_nc):
            used_autosave = True
            try:
                rst = ncio.load_restart(atmos_nc)
                self._log("[Autosave] Loaded checkpoint from 'data/atmosphere.nc'.")
            except Exception as e:
                # writes are atomic, so a torn file means outside damage: the
                # sidecar below can still rescue the resume
                sidecar_alone = True
                self._warn(f"[Autosave] 'data/atmosphere.nc' unreadable ({e}); trying the "
                           "full-state sidecar.")
        elif cfg.run.autosave_load and os.path.exists(sidecar):
            used_autosave = sidecar_alone = True
        if rst is not None and not cfg.run.restart_warm_caches:
            # QD_RESTART_WARM_CACHES=0 emulates the reference restart exactly:
            # its loader ignores the extra flux-cache variables
            for k in ("P_cond_flux_last", "E_flux_last", "LH_last", "LH_release_last",
                      "cloud_eff_last"):
                rst[k] = None
        if rst is not None and rst.get("t_seconds") is not None:
            t0 = float(rst["t_seconds"])
        # a restart saved at exactly t = 0 takes the QD_ORBIT_EPOCH_* rebase
        # too, as in the reference (run_simulation.py:1630-1635)
        if t0 == 0.0:
            if cfg.run.orbit_epoch_seconds is not None:
                t0 = cfg.run.orbit_epoch_seconds
            elif cfg.run.orbit_epoch_days is not None:
                t0 = cfg.run.orbit_epoch_days * self.day_seconds

        self.t0_seconds = t0
        self.t_seconds = t0  # exact epoch, host float64
        self.state = M.init_world(self.model, t0_seconds=t0, seed=cfg.run.seed)
        if rst is not None:
            self.state = ncio.apply_restart_to_state(self.state, rst, has_ocean=cfg.ocean.enabled)
            if cfg.run.load_ocean and os.path.exists(self._data("ocean.nc")):
                o = ncio.load_ocean(self._data("ocean.nc"))
                self.state = ncio.apply_restart_to_state(
                    self.state, {k: o.get(k) for k in ("uo", "vo", "eta", "Ts")},
                    has_ocean=cfg.ocean.enabled)
                self._log("[Restart] Ocean state overridden from 'data/ocean.nc'.")
        self._load_eco_phyto_autosaves()

        # the sidecar: everything the NetCDF schema drops (day and routing
        # accumulators, humidity caches, the individual pool, the random
        # stream), so a resume continues bit for bit. Only on the autosave
        # path: an explicit QD_RESTART_IN may predate the sidecar.
        self.restore_source = "netcdf" if rst is not None else "cold"
        if used_autosave and os.path.exists(sidecar):
            self._restore_sidecar(sidecar, t0, sidecar_alone)
        if sidecar_alone and self.restore_source == "cold":
            self._warn("[Autosave] no usable checkpoint (atmosphere.nc unreadable or absent, "
                       "sidecar unusable) — cold start.")
        if rst is not None and self.restore_source == "netcdf":
            cache_vars = ("P_cond_flux_last", "E_flux_last", "LH_last", "LH_release_last",
                          "cloud_eff_last")
            if all(rst.get(k) is not None for k in cache_vars):
                self._warn("[Restart] humidity flux caches restored from the restart file "
                           "(exact resume; no bootstrap needed).")
            elif cfg.run.restart_warm_caches:
                self._bootstrap_flux_caches()
            else:
                self._warn("[Restart] NetCDF-only restore with QD_RESTART_WARM_CACHES=0: the "
                           "first step will blend the legacy convergence-precip fallback "
                           "(reference restart behavior).")

    def _restore_sidecar(self, path, t0, sidecar_alone):
        """Take the sidecar if it is from the instant of atmosphere.nc (its
        float64 epoch stamp within two steps of it), or if it is the only
        checkpoint; otherwise keep the NetCDF fields. The generator is put
        back if the sidecar is refused."""
        gen = self.model.generator
        gen0 = gen.get_state()
        try:
            restored = ckpt.load_checkpoint(path, self.state, gen)
            t_meta = ckpt.load_checkpoint_meta(path)
            t_ckpt = t_meta if t_meta is not None else float(restored.clock.t_seconds)
            tol = 2.0 * self.model.dt + 2.0 * abs(np.spacing(np.float32(max(abs(t0), 1.0))))
            if not (sidecar_alone or abs(t_ckpt - t0) <= tol):
                gen.set_state(gen0)
                self._warn(f"[Autosave] full-state sidecar is from a different instant "
                           f"(t={t_ckpt:.0f}s vs atmosphere.nc t={t0:.0f}s); ignoring it and "
                           "continuing from the NetCDF fields.")
                return
        except Exception as e:
            gen.set_state(gen0)
            self._warn(f"[Autosave] full-state restore failed ({e}); continuing from the "
                       "NetCDF fields.")
            return
        # the restored clock's bookkeeping scalar takes the exact epoch, so
        # its rounding does not compound across resume chains
        clock = restored.clock
        self.state = dataclasses.replace(restored, clock=dataclasses.replace(
            clock, t_seconds=torch.full((), t_ckpt, dtype=clock.t_seconds.dtype,
                                        device=clock.t_seconds.device)))
        self.t0_seconds = self.t_seconds = t_ckpt
        self.restore_source = "sidecar"
        self._warn("[Autosave] Full-state checkpoint restored (bit-exact resume).")

    def _load_eco_phyto_autosaves(self):
        """Ecology and plankton autosaves (run_simulation.py:1464-1488,
        1377-1401)."""
        cfg = self.cfg
        if cfg.run.autosave_load and self.state.eco is not None:
            gp = os.getenv("QD_ECO_GENES_JSON_PATH") or self._data("genes.json")
            if os.path.exists(gp):
                genes = ncio.load_genes_json(gp)
                if genes:
                    self._apply_genes(genes)
            ep = os.getenv("QD_ECO_AUTOSAVE_PATH") or self._data("ecology.nc")
            if os.path.exists(ep) and ncio.have_netcdf():
                eco_new, ok = ncio.load_ecology(ep, self.state.eco, self.model.eco_static,
                                                cfg.ecology)
                if ok:
                    self.state = dataclasses.replace(self.state, eco=eco_new)
                    self._log(f"[Ecology] autosave load OK from '{ep}'")
        pp = self._data("plankton.nc")
        if (cfg.run.load_plankton and self.state.phyto is not None and os.path.exists(pp)
                and ncio.have_netcdf()):
            ph_new, status = ncio.load_plankton_nc(pp, self.state.phyto, self.model.phyto_static)
            if status == "ok":
                self.state = dataclasses.replace(self.state, phyto=ph_new)
                self._log("[Phyto] plankton.nc load OK.")
            elif status == "read_error":
                # an unreadable file is not a dims mismatch: keep the state
                self._log("[Phyto] plankton.nc unreadable — keeping state.")
            elif cfg.phyto.dist_on_mismatch in ("reset", "random"):
                from .ecology import phyto as phyto_mod
                randomize = cfg.phyto.dist_on_mismatch == "random"
                _, ph0, _ = phyto_mod.build_phyto(
                    (cfg.run.n_lat, cfg.run.n_lon), self.land_mask,
                    dataclasses.replace(cfg.phyto, init_random=randomize), cfg.ecology,
                    cfg.ocean.H_m, self.device, self.model.dtype)
                self.state = dataclasses.replace(self.state, phyto=ph0)
                self._log("[Phyto] plankton.nc shape mismatch — state "
                          + ("randomized." if randomize else "reset to defaults."))
            else:
                self._log("[Phyto] plankton.nc load skipped/failed (keep).")

    def _bootstrap_flux_caches(self):
        """A NetCDF-only restore without the flux caches: recompute E_flux and
        P_cond from the restored fields with the humidity block the next step
        runs, so precipitation resumes at its spun-up size instead of the
        reference's one-step restart deluge."""
        from .physics import humidity as hum
        cfg = self.cfg
        a = self.state.atmos
        hcfg = cfg.humidity
        _, E_flux, _, P_cond, _ = hum.humidity_block(
            a.T_s, a.q, a.u, a.v, a.h, a.h_ice, self.model.static.land_mask,
            cfg.run.dt_seconds, hcfg, cfg.dynamics.g)
        dt = a.T_s.dtype
        self.state = dataclasses.replace(self.state, atmos=dataclasses.replace(
            a, E_flux_last=E_flux.to(dt), P_cond_flux_last=P_cond.to(dt),
            LH_last=(hcfg.L_v * E_flux).to(dt), LH_release_last=(hcfg.L_v * P_cond).to(dt)))
        self._warn("[Restart] humidity flux caches bootstrapped from the restored fields "
                   "(QD_RESTART_WARM_CACHES=1; avoids the reference's one-step restart "
                   "deluge).")

    def _apply_genes(self, genes_list):
        """Rebuild per-species reflectance rows from a loaded genome table."""
        from .ecology import genes as gmod
        from .ecology import spectral as smod
        es = self.model.eco_static
        bands = smod.make_bands(self.cfg.ecology)
        eco = self.state.eco
        R = eco.R_leaf.cpu().numpy().copy()
        for i in range(min(len(genes_list), es.S)):
            R[i] = gmod.reflectance_from_genes(bands.lambda_centers, genes_list[i])
        packed = gmod.pack_genes(genes_list, es.S)

        def t(x, ref):
            return torch.as_tensor(np.asarray(x)).to(device=ref.device, dtype=ref.dtype)

        eco = dataclasses.replace(
            eco, R_leaf=t(R, eco.R_leaf), peaks=t(packed["peaks"], eco.peaks),
            alloc=t(packed["alloc"], eco.alloc),
            leaf_area_per_energy=t(packed["leaf_area_per_energy"], eco.leaf_area_per_energy),
            drought_tolerance=t(packed["drought_tolerance"], eco.drought_tolerance),
            gdd_germinate=t(packed["gdd_germinate"], eco.gdd_germinate),
            lifespan_days=t(packed["lifespan_days"], eco.lifespan_days))
        self.state = dataclasses.replace(self.state, eco=eco)
        self.genes_list = genes_list
        self._log(f"[Ecology] Genes autosave loaded: Ns={len(genes_list)}")

    # --------------------------------------------------------------- autosave
    def _snapshot(self):
        """(host copy of the state, generator state, epoch), taken together."""
        return _to_host(self.state), self.model.generator.get_state(), self.t_seconds

    def autosave_async(self):
        """Copy the state to the host and write the autosave set on the IO
        worker. A tick is skipped while the previous write runs, and within
        QD_AUTOSAVE_MIN_WALL_S of the last one."""
        if self._autosave_future is not None and not self._autosave_future.done():
            return
        now = time.time()
        if now - self._last_autosave_wall < self.cfg.run.autosave_min_wall_s:
            return
        self._last_autosave_wall = now
        snap = self._snapshot()
        self._prune_io_futures()
        self._autosave_future = self._io_pool.submit(self._write_autosave, *snap)
        self._io_futures.append(self._autosave_future)

    def _prune_io_futures(self):
        """Drop finished IO futures, reporting any that failed."""
        still = []
        for f in self._io_futures:
            if f.done():
                try:
                    f.result()
                except Exception as e:
                    self._warn(f"[IO] async task failed: {e}")
            else:
                still.append(f)
        self._io_futures = still

    def flush_io(self):
        for f in list(self._io_futures):
            try:
                f.result()
            except Exception as e:
                print(f"[Autosave] async IO failed: {e}")
        self._io_futures = []

    def autosave(self):
        """Synchronous autosave (signal handlers, end of run, callers). Joins
        an in-flight async autosave first: both write the same files."""
        f = self._autosave_future
        if f is not None and not f.done():
            try:
                f.result(timeout=60.0)
            except Exception as e:  # incl. TimeoutError: write anyway, loudly
                self._warn(f"[Autosave] in-flight async save not joined: {e}")
        self._write_autosave(*self._snapshot())

    def _write_autosave(self, state, generator_state, t_seconds):
        """Write the autosave set from a host snapshot (run_simulation.py:
        1669-1687): atmosphere.nc, the sidecar and its epoch stamp, ocean.nc,
        the ecology and plankton files. Each artifact that fails is reported
        and the rest are still written."""
        cfg = self.cfg
        day_value = t_seconds / self.day_seconds
        netcdf = ncio.have_netcdf()
        if netcdf:
            try:
                ncio.save_restart(self._data("atmosphere.nc"), self.lat, self.lon, state,
                                  self.land_mask, t_seconds=t_seconds)
                self._log("[Autosave] Core state saved to 'data/atmosphere.nc'")
            except OSError as e:
                self._warn(f"[Autosave] NetCDF save failed: {e}")
        else:
            self._warn("[Autosave] NetCDF files skipped (neither h5py nor netCDF4 is "
                       "installed): atmosphere.nc, ocean.nc, ecology.nc, plankton.nc")
        try:
            ckpt.save_checkpoint(self._data(SIDECAR), state, generator_state)
            ckpt.save_checkpoint_meta(self._data(SIDECAR), t_seconds)
        except Exception as e:
            self._warn(f"[Autosave] full-state checkpoint skipped: {e}")
        if cfg.ocean.enabled and netcdf:
            try:
                ncio.save_ocean(self._data("ocean.nc"), self.lat, self.lon, state.ocean,
                                day_value)
            except Exception as e:
                self._warn(f"[Autosave] ocean.nc save failed: {e}")
        try:
            self._write_autosave_eco_phyto(state, day_value, netcdf)
        except Exception as e:
            self._warn(f"[Autosave] ecology/phyto autosave failed: {e}")

    def _write_autosave_eco_phyto(self, state, day_value, netcdf):
        cfg = self.cfg
        from .ecology import spectral as smod
        bands = smod.make_bands(cfg.ecology)
        if state.eco is not None:
            from .ecology import genes as gmod
            w_b = smod.band_weights(bands, cfg.ecology)
            eco = state.eco
            if netcdf:
                path = os.getenv("QD_ECO_AUTOSAVE_PATH") or self._data("ecology.nc")
                ncio.save_ecology(path, self.lat, self.lon, eco, bands, w_b,
                                  day_value=day_value)
            n_act = int(eco.n_active)
            # identities: founders from the loaded genes table (or the
            # mode-based default), mutants "<parent>_mut" through the parent
            # index (reference adapter.py:477)
            base_ids = [g.identity for g in getattr(self, "genes_list", None) or []]
            modes_seed = self.model.eco_static.modes_seed.cpu().numpy()
            pidx = eco.parent_idx.numpy()
            idents = []
            for i in range(n_act):
                if i < len(base_ids):
                    idents.append(base_ids[i])
                elif int(pidx[i]) >= 0:
                    p = int(pidx[i])
                    parent_id = (idents[p] if p < len(idents)
                                 else ("tree" if modes_seed[p] else "grass"))
                    idents.append(parent_id + "_mut")
                else:
                    idents.append(os.getenv(f"QD_ECO_SPECIES_{i}_IDENTITY")
                                  or ("tree" if modes_seed[i] else "grass"))
            genes_list = gmod.unpack_genes(
                {k: getattr(eco, k).numpy() for k in
                 ("peaks", "alloc", "leaf_area_per_energy", "drought_tolerance",
                  "gdd_germinate", "lifespan_days")}, n_act, identities=idents)
            ncio.save_genes_json(self._data("genes.json"), genes_list, bands, w_b,
                                 species_weights=eco.species_weights.numpy()[:n_act],
                                 day_value=day_value)
        if state.phyto is not None:
            ncio.save_plankton_bio_json(self._data("plankton.json"), self.model.phyto_static,
                                        cfg.phyto, bands, day_value)
            if netcdf:
                ncio.save_plankton_nc(self._data("plankton.nc"), self.lat, self.lon,
                                      state.phyto, self.model.phyto_static, bands, day_value)

    def _register_autosave_hooks(self):
        if self._autosave_registered or not self.cfg.run.autosave_enable:
            return
        self._autosave_registered = True
        atexit.register(self._safe_autosave)

        def handler(signum, frame):
            print(f"[Autosave] Caught signal {signum}, saving checkpoint...")
            self._safe_autosave()
            sys.exit(130 if signum == signal.SIGINT else 143)

        try:
            signal.signal(signal.SIGINT, handler)
            signal.signal(signal.SIGTERM, handler)
        except ValueError:
            pass  # not the main thread

    def _safe_autosave(self):
        try:
            self.autosave()
        except Exception as e:  # never crash shutdown on an autosave failure
            print(f"[Autosave] Save failed: {e}")

    # -------------------------------------------------------------------- run
    def step(self):
        """Advance one physics step; prefer step_chunk or run."""
        return self.step_chunk(1)

    def step_chunk(self, n_steps: Optional[int] = None):
        """Advance n_steps in one chunk; returns its diags (device tensors of
        one row per ``model.diag_stride`` steps)."""
        n = n_steps or self.cfg.run.chunk_steps
        if n not in self._chunk_fns:
            self._chunk_fns[n] = M.make_chunk_fn(self.model, n)
        self.state, diags = self._chunk_fns[n](self.state)
        self.t_seconds += n * self.model.dt
        if self.cfg.run.nancheck:
            self._nancheck()
        return diags

    def _nancheck(self):
        """QD_DEBUG_NANCHECK=1: name the state's non-finite leaves, with one
        device-to-host transfer."""
        names, flags = [], []
        for g in NANCHECK_GROUPS:
            group = getattr(self.state, g)
            if group is None:
                continue
            for f in dataclasses.fields(group):
                x = getattr(group, f.name)
                if isinstance(x, torch.Tensor) and x.is_floating_point():
                    names.append(f"{g}.{f.name}")
                    flags.append(~torch.isfinite(x).all())
        if not flags:
            return
        bad = [n for n, b in zip(names, torch.stack(flags).cpu().tolist()) if b]
        if bad:
            print(f"[NanCheck] t={self.t_seconds:.0f}s: non-finite values in {len(bad)} "
                  f"leaves: {', '.join(bad[:8])}")

    @staticmethod
    def diags_to_host(diags: dict) -> dict:
        """The chunk's diags as host arrays, in one device-to-host transfer."""
        keys = list(diags)
        host = torch.stack([diags[k] for k in keys]).cpu().numpy()
        return dict(zip(keys, host))

    def _print_diags_host(self, diags, step0: int, de: int):
        """Reference-tagged diagnostics from the per-row scalars of a chunk
        whose rows sample every ``de``-th step. Cadence: the reference's 200
        steps for the atmosphere and water tags (run_simulation.py:2150,
        2273, 2350), with QD_ENERGY_DIAG/QD_HUMIDITY_DIAG/QD_WATER_DIAG;
        QD_OCEAN_DIAG_EVERY for the ocean tags."""
        cfg = self.cfg
        ocean_every = max(1, int(cfg.ocean.diag_every))
        n = len(diags["Ts_mean"])
        for i in range(n):
            gstep = step0 + (i + 1) * de - 1
            main = gstep % 200 < de
            ocean_tick = gstep % ocean_every < de
            if not (main or ocean_tick):
                continue
            d = {k: float(v[i]) for k, v in diags.items()}
            if not main:
                self._print_ocean_diags(d)
                continue
            if cfg.energy.diag:
                print(f"[EnergyDiag] TOA_net={d['TOA_net']:.2f} W/m^2 | "
                      f"SFC_net={d['SFC_net']:.2f} | ATM_net={d['ATM_net']:.2f} | "
                      f"<Ts>={d['Ts_mean']:.2f} K")
            if cfg.humidity.diag:
                print(f"[HumidityDiag] ⟨E⟩={d['E_mean']:.3e} kg/m^2/s | "
                      f"⟨LH⟩={d['LH_mean']:.2f} W/m^2 | "
                      f"⟨LH_release⟩={d['LH_release_mean']:.2f} W/m^2")
            t_now = self.t0_seconds + (gstep + 1) * self.model.dt
            msg = (f"[WaterDiag] ⟨E⟩={d['E_mean']:.3e} kg/m^2/s | "
                   f"⟨P⟩={d['P_mean']:.3e} | ⟨R⟩={d['R_mean']:.3e} | "
                   f"⟨CWV⟩={d['CWV_mean']:.3e} kg/m^2 | ⟨ICE⟩={d['ICE_mean']:.3e} | "
                   f"⟨W_land⟩={d['W_land_mean']:.3e} | ⟨S_snow⟩={d['S_snow_mean']:.3e}")
            if self._hydro_prev is not None:
                t_prev, tot_prev = self._hydro_prev
                dts = t_now - t_prev
                if dts > 0:
                    ddt = (d["total_reservoir_mean"] - tot_prev) / dts
                    resid = ddt - (d["E_mean"] - d["P_mean"] - d["R_mean"])
                    msg += f" | d/dt Σ={ddt:.3e} vs (E−P−R) -> residual={resid:.3e}"
            self._hydro_prev = (t_now, d["total_reservoir_mean"])
            if cfg.hydrology.diag:
                print(msg)
            if "dyn_var_u_pre" in d:
                print(f"[DynDiag] hyper4 applied: "
                      f"Var(u) {d['dyn_var_u_pre']:.3e}->{d['dyn_var_u_post']:.3e}, "
                      f"Var(v) {d['dyn_var_v_pre']:.3e}->{d['dyn_var_v_post']:.3e}, "
                      f"Var(h) {d['dyn_var_h_pre']:.3e}->{d['dyn_var_h_post']:.3e}")
            if "seaice_area_frac" in d:
                print(f"[SeaIce] area={d['seaice_area_frac']:.3f}, "
                      f"mean_h={d['seaice_mean_h']:.2f} m")
            if "lai_mean" in d:
                print(f"[Ecology] LAI(mean/max)={d['lai_mean']:.2f}/{d['lai_max']:.2f}")
            if "chl_mean" in d:
                print(f"[PhytoDiag] ⟨Chl_tot⟩={d['chl_mean']:.3f} mg/m^3 | "
                      f"⟨Kd490⟩={d['kd490_mean']:.3f} m^-1 | "
                      f"⟨α_water⟩={d['alpha_water_mean']:.3f}")
            if ocean_tick:
                self._print_ocean_diags(d)
            if "routing_ocean_inflow_kgps" in d:
                print(f"[HydroRoutingDiag] ocean_inflow={d['routing_ocean_inflow_kgps']:.3e} "
                      f"kg/s | mass_error={d['routing_mass_error_kg']:.3e} kg")

    def _print_ocean_diags(self, d):
        """[OceanDiag]/[OceanE] at the QD_OCEAN_DIAG_EVERY cadence."""
        if "ocean_KE_mean" in d and self.cfg.ocean.diag:
            print(f"[OceanDiag] KE_mean={d['ocean_KE_mean']:.3e} m2/s2 | "
                  f"Umax={d['ocean_U_max']:.2f} m/s")
        if "oceanE_Q_mean" in d:
            # implied ρc_pH·dT/dt against the effective Q_net (ocean.py:446-516);
            # like the reference, dT spans the diag interval over one step's dt
            oc = self.cfg.ocean
            rhoCpH = oc.rho_w * oc.cp_w * oc.H_m
            if self._oceanE_prev is None:
                implied = resid = implied_p = resid_p = 0.0
            else:
                implied = rhoCpH * (d["oceanE_sst_mean"] - self._oceanE_prev[0]) / self.model.dt
                implied_p = (rhoCpH * (d["oceanE_sstp_mean"] - self._oceanE_prev[1])
                             / self.model.dt)
                resid = implied - d["oceanE_Q_mean"]
                resid_p = implied_p - d["oceanE_Qp_mean"]
            self._oceanE_prev = (d["oceanE_sst_mean"], d["oceanE_sstp_mean"])
            print(f"[OceanE] ⟨Q_net⟩={d['oceanE_Q_mean']:+.2f} W/m^2 | "
                  f"implied={implied:+.2f} | resid={resid:+.2f}  "
                  f"|| Polar(|lat|>={int(oc.polar_lat_diag)}°): "
                  f"⟨Q⟩={d['oceanE_Qp_mean']:+.2f}, implied={implied_p:+.2f}, "
                  f"resid={resid_p:+.2f}")

    def run(self, duration_seconds: Optional[float] = None):
        """Main loop: chunks, diagnostics, autosaves on their cadence
        (run_simulation.py:1592-2490). Duration: the argument, else
        QD_TOTAL_YEARS > QD_SIM_DAYS > 5 planetary years."""
        cfg = self.cfg
        if duration_seconds is None:
            if cfg.run.total_years is not None:
                duration_seconds = cfg.run.total_years * T_PLANET
            elif cfg.run.sim_days is not None:
                duration_seconds = cfg.run.sim_days * self.day_seconds
            else:
                duration_seconds = 5 * T_PLANET

        dt = self.model.dt
        total_steps = int(duration_seconds / dt)
        chunk = cfg.run.chunk_steps
        os.makedirs(self.output_dir, exist_ok=True)
        os.makedirs(self.data_dir, exist_ok=True)
        self._register_autosave_hooks()
        autosave_every_s = cfg.run.autosave_every_hours * (self.day_seconds / 24.0)
        next_autosave = self.t_seconds + autosave_every_s
        diversity_next_day = self.t_seconds / self.day_seconds
        # the reference's plot cadence counts 24-hour days
        plot_every_s = cfg.run.plot_every_days * 24 * 3600.0
        next_plot = self.t_seconds  # plot at start like the reference (i == 0)
        self._viz_ok = have_matplotlib()
        diversity = cfg.ecology.diversity_enable and self.state.eco is not None
        if not self._viz_ok:
            print("[Viz] matplotlib is not installed: no panels are written"
                  + (" (the diversity snapshots and summaries still are)" if diversity else ""))

        self._log("\n--- Starting Simulation ---")
        self._log(f"Grid: {cfg.run.n_lat} x {cfg.run.n_lon} | dt={dt}s | "
                  f"steps={total_steps} (chunks of {chunk}) | device {self.device}")
        self._log("[World] no compile cache to set up: the port compiles only its CUDA "
                  "kernels, once per source and flag set (kernels/build.py)")
        done = 0
        t_wall0 = time.time()
        while done < total_steps:
            n = min(chunk, total_steps - done)
            if self.t_seconds >= next_plot:
                if self._viz_ok:
                    self._plots()
                next_plot += plot_every_s
            diags = self.step_chunk(n)
            # one transfer a chunk; it waits for the chunk to finish
            self._print_diags_host(self.diags_to_host(diags), done,
                                   M.diag_stride(self.model, n))
            done += n
            if diversity and self.t_seconds / self.day_seconds >= diversity_next_day:
                self._diversity()
                diversity_next_day += cfg.ecology.diversity_every_days
            if cfg.run.autosave_enable and self.t_seconds >= next_autosave:
                try:
                    self.autosave_async()
                except Exception as e:
                    print(f"[Autosave] async dispatch failed: {e}")
                next_autosave += autosave_every_s
            if done % (chunk * 10) == 0 or done >= total_steps:
                elapsed = time.time() - t_wall0
                sy_h = (done * dt / T_PLANET) / max(elapsed / 3600.0, 1e-9)
                self._log(f"t={self.t_seconds / self.day_seconds:.1f}d | {done}/{total_steps} "
                          f"steps | {sy_h:.1f} sim-years/hour")
        self.flush_io()
        if cfg.run.restart_out:
            ncio.save_restart(cfg.run.restart_out, self.lat, self.lon, self.state,
                              self.land_mask, t_seconds=self.t_seconds)
            self._log(f"[Restart] Saved final state to '{cfg.run.restart_out}'.")

    def _plots(self):
        """Render the panels on the IO worker from a host snapshot taken now
        (the state's tensors are never written in place, so the reference
        taken here is frozen; the copy to the host runs on the worker)."""
        from .viz import plots as viz
        state_ref = self.state
        t_days = self.t_seconds / self.day_seconds

        def render():
            snap = SimpleNamespace(
                state=_to_host(state_ref, numpy=True), cfg=self.cfg, model=self.model,
                land_mask=self.land_mask, elevation=self.elevation, lat=self.lat,
                lon=self.lon)
            viz.plot_all(snap, t_days, self.output_dir)

        self._prune_io_futures()
        self._io_futures.append(self._io_pool.submit(render))

    def _diversity(self):
        """The diversity diagnostics of the ecology state as it is now, on
        the IO worker: the metrics on the state's device, the panels (where
        matplotlib is installed), the summary and the community snapshot
        on the host."""
        from .ecology import diversity as div
        lat_mesh = np.tile(self.lat[:, None], (1, len(self.lon)))
        self._prune_io_futures()
        self._io_futures.append(self._io_pool.submit(
            div.compute_and_plot, self.lat, self.lon, lat_mesh, self.state.eco,
            self.land_mask, self.t_seconds / self.day_seconds, self.output_dir,
            plot=self._viz_ok))

    # ---------------------------------------------------------------- factory
    @classmethod
    def create_default(cls, device="cuda") -> "QingdaiWorld":
        return cls(SimConfig.from_env(), device=device)
