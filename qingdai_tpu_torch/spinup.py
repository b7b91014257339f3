"""Spin-up SOP runner: two-phase equilibration + acceptance metrics, on the
card unless ``--device`` asks for the CPU (the port's counterpart of
``scripts/spinup.py``).

The reference spin-up protocol (docs/11-spinup-and-restarts.md) scaled to a
configurable year count:

  Phase 1 "rapid equilibration": shallow mixed layer (QD_MLD_M=5) from a fresh
    init, so the slab ocean's thermal e-folding time drops ~10x.
  Phase 2 "true equilibrium": restart from phase 1 with the physical mixed
    layer (default 50 m) and integrate to steady state.

Acceptance (docs/11.3 phase-2 criteria, evaluated as multi-year means over the
trailing --eval-years window of phase 2):
  |<TOA_net>| <= 0.2 W/m^2          (docs/11:49)
  |d<Ts>/dt|  <  0.02 K/decade      (decade = 10 Qingdai years; docs/11:50)
  <E> ~= <P> + <R>                  (water closure, docs/11:128-131)
  <LH> ~= <LH_release>              (latent-heat consistency, docs/11:132-134)
  routing mass-closure error ~= 0   (routing.py:320-331 semantics)
  d/dt total water reservoir ~= 0

Writes its record (the JAX tool's keys, plus the device) to
``output/<--out>`` (default ``output/spinup_torch.json``) with the phase-2
series beside it (``..._series.npz``), and phase restarts
``data/restart_phase{1,2}.nc``. Where neither h5py nor netCDF4 is installed
(the card's machine), each NetCDF file takes the port's torch.save
container or stays in memory, with one printed line each: the phase
restarts are ``data/restart_phase{1,2}.pt`` (the same fields), the seeded
topography is handed to each phase in memory instead of
``data/topography.nc``, and ``--skip-phase1`` resumes from the autosave's
sidecar ``data/world_ckpt.pt``.

Usage:
  python -m qingdai_tpu_torch.spinup --phase1-years 30 --phase2-years 30 --eval-years 15
  python -m qingdai_tpu_torch.spinup --device cpu --nlat 19 --nlon 36 \\
      --phase1-years 0.004 --phase2-years 0.004 --chunk-days 1      # a CPU smoke run
"""

from __future__ import annotations

import argparse
import json
import os
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from .io import netcdf as ncio

# diag scalars aggregated per chunk (means over the chunk's steps)
KEYS = ("TOA_net", "SFC_net", "ATM_net", "Ts_mean", "E_mean", "P_mean",
        "R_mean", "LH_mean", "LH_release_mean", "total_reservoir_mean",
        "CWV_mean", "ICE_mean", "W_land_mean", "S_snow_mean")
# optional: routing scalars + the QD_ENERGY_AUDIT attribution terms
# (model.AUDIT_KEYS; nan when the subsystem/flag is off)
OPT_KEYS = ("routing_mass_error_kg", "routing_ocean_inflow_kgps",
            "routing_stranded_kg", "routing_routed_mass_kg",
            "routing_store_out_kg", "routing_lake_delta_kg",
            "aud_part", "aud_uncoupled", "aud_hum_resid", "aud_sfc_resid",
            "aud_ts_blend", "aud_adv_ts", "aud_adv_q", "aud_nudge",
            "aud_filt", "aud_hdamp", "aud_qdamp", "aud_overwrite")
# internal reservoir injections: TOA_net ≈ aud_part + aud_uncoupled − Σ these
AUD_INTERNAL = ("aud_hum_resid", "aud_sfc_resid", "aud_ts_blend",
                "aud_adv_ts", "aud_adv_q", "aud_nudge", "aud_filt",
                "aud_hdamp", "aud_qdamp", "aud_overwrite")
DEFAULT_OUT = "spinup_torch.json"


def _as_reloaded(lat, lon, elevation, land_mask, base_albedo, friction):
    """The arrays ``topography.load_topography_from_netcdf`` returns for the
    file ``export_topography_to_netcdf`` writes from these on this grid:
    float32 fields and an int8 mask, with the seam column (lon 0 and 360)
    taken from the column the reader keeps. A planet handed over in memory
    is then the planet a file would have given."""
    src_lon = np.mod(np.asarray(lon, np.float32).astype(float), 360.0)
    order = np.argsort(src_lon)
    cols = order[np.concatenate([[True], np.diff(src_lon[order]) > 1e-9])]

    def stored(a, dtype):
        a = np.asarray(a).astype(dtype)[:, cols]
        return np.concatenate([a, a[:, :1]], axis=1)
    return {"elevation": stored(elevation, np.float32).astype(float),
            "land_mask": stored(land_mask, np.int8).astype(np.uint8),
            "base_albedo": stored(base_albedo, np.float32).astype(float),
            "friction": stored(friction, np.float32).astype(float)}


def _ensure_topography(nlat, nlon, path=os.path.join("data", "topography.nc")):
    """(path, None) of a topography NetCDF file for the SOP grid, or, where
    no NetCDF library is installed, (None, the arrays in memory).

    Prefers an existing grid-matching ``data/topography.nc`` — the engine
    exports the topography it actually ran with there, so a resume chain's
    later segments see the identical field — else generates the seeded
    procedural topography once (the reference SOP generates topography
    offline and points QD_TOPO_NC at it; docs/04 §9). In memory the seed
    makes the arrays identical in every segment of a chain."""
    from . import topography as topo

    seed = int(os.environ.get("QD_SEED", "42"))
    land_frac = float(os.environ.get("QD_TARGET_LAND_FRAC", "0.29"))
    netcdf = ncio.have_netcdf()
    if netcdf and os.path.exists(path):
        from .io.ncdataset import Dataset
        try:
            with Dataset(path, "r") as ds:
                ok = (len(ds["lat"][:]) == nlat and len(ds["lon"][:]) == nlon
                      and "elevation" in ds.variables)
                # a grid-matching file generated under a DIFFERENT seed or
                # land fraction must not be silently reused on a fresh SOP
                # (files written before the generation_seed attr existed are
                # reused as before — resume chains depend on that)
                f_seed = getattr(ds, "generation_seed", None)
                f_frac = getattr(ds, "target_land_fraction", None)
            if ok and f_seed is not None and int(f_seed) != seed:
                print(f"[Spinup] {path} was generated with seed {int(f_seed)}"
                      f" but QD_SEED={seed}; regenerating.", flush=True)
                ok = False
            if ok and f_frac is not None and abs(float(f_frac) - land_frac) > 1e-6:
                print(f"[Spinup] {path} targets land fraction {float(f_frac)}"
                      f" but QD_TARGET_LAND_FRAC={land_frac}; regenerating.",
                      flush=True)
                ok = False
            if ok:
                return path, None
        except (OSError, KeyError):
            pass

    lat = np.linspace(-90, 90, nlat)
    lon = np.linspace(0, 360, nlon)
    lon_mesh, lat_mesh = np.meshgrid(lon, lat)
    elev = topo.generate_elevation_map(lat_mesh, lon_mesh, seed=seed)
    mask, sea_level = topo.create_land_sea_mask_from_elevation(
        elev, lat_mesh, target_land_frac=land_frac)
    albedo, friction = topo.generate_base_properties(mask, elev, lat_mesh)
    if netcdf:
        topo.export_topography_to_netcdf(lat, lon, elev, mask, albedo, friction,
                                         sea_level, path,
                                         target_land_frac=land_frac, seed=seed)
        return path, None
    print(f"[Spinup] no NetCDF library (h5py, netCDF4): the seeded topography (seed {seed}, "
          f"land fraction {land_frac}) goes to each phase in memory, not to {path}",
          flush=True)
    arrays = _as_reloaded(lat, lon, elev, mask, albedo, friction)
    arrays.update(generation_seed=seed, target_land_fraction=land_frac,
                  sea_level_m=float(sea_level))
    return None, arrays


def _reduce_chunk(keys, means, ready, t_yr):
    """(t_yr, row) of one chunk: the chunk means copied to the host in one
    transfer (``ready`` marks its end on the card)."""
    if ready is not None:
        ready.synchronize()
    d = dict(zip(keys, means.tolist()))
    row = {k: d[k] for k in KEYS}
    row.update({k: d.get(k, float("nan")) for k in OPT_KEYS})
    return t_yr, row


def run_phase(name, years, env, chunk_days=10, verbose_every=50, device="cuda",
              topography=None):
    """Run one phase in a fresh world under `env` overrides; returns the
    per-chunk diagnostic time series (dict of np arrays + t_years axis).
    ``topography`` (``_ensure_topography``'s arrays) takes the place of
    QD_TOPO_NC's file."""
    from .config import SimConfig
    from .physics.orbital import T_PLANET
    from .world import QingdaiWorld

    old = {k: os.environ.get(k) for k in env}
    os.environ.update({k: str(v) for k, v in env.items()})
    try:
        cfg = SimConfig.from_env()
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v

    world = QingdaiWorld(cfg, verbose=False, device=device, topography=topography)
    spd = int(round(world.model.day_seconds / world.model.dt))
    chunk = spd * chunk_days
    total_steps = int(round(years * T_PLANET / world.model.dt))
    # nearest whole chunk, min 1: floor silently under-ran by up to a chunk,
    # and a sub-chunk smoke request should not silently run a full chunk
    # without saying so
    n_chunks = max(1, int(round(total_steps / chunk)))
    actual_years = n_chunks * chunk * world.model.dt / T_PLANET
    if abs(actual_years - years) / max(years, 1e-12) > 1e-6:
        print(f"[Spinup:{name}] requested {years} yr rounds to {n_chunks} "
              f"whole {chunk_days}-day chunks = {actual_years:.4f} yr",
              flush=True)

    print(f"[Spinup:{name}] {years} yr = {n_chunks} chunks x {chunk} steps "
          f"(grid {cfg.run.n_lat}x{cfg.run.n_lon}, MLD={cfg.ocean.H_m} m, "
          f"t0={world.t_seconds/world.day_seconds:.1f} d, device {world.device})", flush=True)

    series = {k: [] for k in KEYS + OPT_KEYS}
    t_years = []
    pool = ThreadPoolExecutor(max_workers=1, thread_name_prefix="spinup-io")
    futures = []
    cuda = world.device.type == "cuda"

    t_wall0 = time.time()
    next_autosave = time.time() + 900.0
    for c in range(n_chunks):
        diags = world.step_chunk(chunk)
        # the chunk means reduced on the device and copied to the host in one
        # transfer, which the IO worker waits for: the loop never waits
        keys = list(diags)
        means = torch.stack([diags[k] for k in keys]).mean(dim=1)
        ready = None
        if cuda:
            host = torch.empty(means.shape, dtype=means.dtype, pin_memory=True)
            host.copy_(means, non_blocking=True)
            ready = torch.cuda.Event()
            ready.record()
            means = host
        t_yr = (world.t_seconds - world.t0_seconds) / T_PLANET
        futures.append(pool.submit(_reduce_chunk, keys, means, ready, t_yr))
        # crash insurance on multi-hour phases: async autosave every ~15 wall
        # minutes (the host copy and the writes run on the world's IO
        # worker, off the chunk loop; a killed run resumes from data/ instead
        # of losing the whole phase)
        if time.time() >= next_autosave:
            try:
                world.autosave_async()
            except Exception as e:
                print(f"[Spinup:{name}] autosave dispatch failed: {e}",
                      flush=True)
            # the diag series so far rides along (data/<phase>_series_partial
            # .npz): a killed multi-hour segment keeps its per-chunk record,
            # not just its model state — a restarted segment can prepend it
            try:
                done_rows = [f.result() for f in futures if f.done()]
                if done_rows:
                    part = {k: np.asarray([r[1][k] for r in done_rows])
                            for k in KEYS + OPT_KEYS}
                    part["t_years"] = np.asarray([r[0] for r in done_rows])
                    part["_consts"] = np.asarray(
                        [cfg.dynamics.diff_factor, cfg.run.dt_seconds,
                         cfg.humidity.L_v])
                    np.savez(os.path.join(
                        "data", f"{name}_series_partial.npz"), **part)
            except Exception as e:
                print(f"[Spinup:{name}] partial-series dump failed: {e}",
                      flush=True)
            next_autosave = time.time() + 900.0
        if (c + 1) % verbose_every == 0 or c == n_chunks - 1:
            if cuda:
                torch.cuda.synchronize(world.device)
            el = time.time() - t_wall0
            done_yr = (c + 1) * chunk * world.model.dt / T_PLANET
            print(f"[Spinup:{name}] {done_yr:.1f}/{years} yr | "
                  f"{done_yr / max(el / 3600, 1e-9):.1f} sim-yr/h", flush=True)

    for f in futures:
        t_yr, row = f.result()
        t_years.append(t_yr)
        for k, v in row.items():
            series[k].append(v)
    pool.shutdown()

    # phase restart artifacts: the standard autosave set (phase hand-off) plus
    # a named snapshot for the record (docs/11 restart_phase{1,2}.nc)
    world.autosave()
    restart = os.path.join("data", f"restart_{name}.nc")
    if not ncio.have_netcdf():
        restart = os.path.splitext(restart)[0] + ".pt"
        print(f"[Spinup:{name}] no NetCDF library (h5py, netCDF4): the phase restart is "
              f"{restart}, the torch.save container of the same fields", flush=True)
    ncio.save_restart(restart, world.lat, world.lon, world.state, world.land_mask,
                      t_seconds=world.t_seconds)
    out = {k: np.asarray(v) for k, v in series.items()}
    out["t_years"] = np.asarray(t_years)
    # carry the phase's actual config constants so acceptance_metrics never
    # silently falls back to defaults when QD_DIFF_FACTOR/QD_DT_SECONDS/QD_LV
    # are overridden (every closure criterion hinges on the q-damping sink
    # computed from these)
    out["_consts"] = np.asarray([cfg.dynamics.diff_factor, cfg.run.dt_seconds,
                                 cfg.humidity.L_v])
    if not bool(torch.isfinite(world.state.atmos.T_s).all()):
        raise RuntimeError(f"phase {name} ended with non-finite T_s")
    return out


def acceptance_metrics(series, eval_years, diff_factor=None, dt=None, L_V=None):
    """Multi-year means + trends over the trailing eval window (docs/11.3).

    Water/LH closure caveat: the reference applies a global q *= diff_factor
    every step (dynamics.py:648-667), an artificial CWV sink of
    CWV·(1−df)/dt ≈ 3–7e-5 kg/m²/s — the same order as ⟨E⟩. In equilibrium
    ⟨E⟩ = ⟨P_cond⟩ + sink, so the documented ⟨E⟩≈⟨P⟩+⟨R⟩ and ⟨LH⟩≈⟨LH_release⟩
    criteria cannot hold as written for ANY faithful implementation (at
    0.25 sim-years/hour the reference could never have run a multi-year
    check). The honest closure is E − (P+R) − sink ≈ 0, reported as
    ``water_residual_minus_qdamping_rel``."""
    from .physics.orbital import T_PLANET
    # config constants from the phase's SimConfig (run_phase attaches them);
    # explicit kwargs override, bare defaults only for legacy series
    consts = np.asarray(series.get("_consts", [0.998, 300.0, 2.5e6]))
    diff_factor = consts[0] if diff_factor is None else diff_factor
    dt = consts[1] if dt is None else dt
    L_V = consts[2] if L_V is None else L_V
    t = series["t_years"]
    sel = t >= (t[-1] - eval_years)
    n_eval = int(sel.sum())
    w = {k: series[k][sel] for k in series
         if k not in ("t_years", "_consts")}
    te = t[sel]

    # fallback-precip transient detection: the legacy convergence precip
    # (reference physics.py:332-354; fires on cold starts AND on any
    # NetCDF-only restart, see BASELINE.md) conjures water at 100-1000× the
    # physical P — one such chunk in the window poisons every budget mean.
    # Flagged in the record so the eval window choice is auditable.
    p_all = series["P_mean"]
    p_med = float(np.median(p_all[np.isfinite(p_all)]))
    transients = t[np.isfinite(p_all) & (p_all > 10.0 * max(p_med, 1e-30))]
    transient_in_window = [round(float(x), 3) for x in transients
                           if x >= (t[-1] - eval_years)]

    # linear Ts trend in K per decade (10 Qingdai years)
    slope_per_year = float(np.polyfit(te, w["Ts_mean"], 1)[0])
    dTs_per_decade = slope_per_year * 10.0

    def _trend_with_se(y):
        """OLS slope (per decade) on ANNUAL means + its standard error.

        The per-chunk series carries the full seasonal cycle and ~1 W/m²
        interannual TOA variability; the slope of a short window is then
        dominated by noise (SE ≈ 0.6 W/m²/decade for a 15-yr window at
        361x720). Reporting the SE makes the trend criteria interpretable:
        an eval window is long enough when SE < the criterion threshold.

        Partial years (the window edges) are excluded: the seasonal TOA
        cycle spans ~50 W/m² peak-to-peak, so a year represented by a
        handful of chunks is a seasonally-biased "annual mean" that sits at
        the end of the OLS lever arm and fakes a trend (measured: one 2-chunk
        edge year flipped a +0.06 slope to −0.34 W/m²/decade)."""
        yr = np.floor(te).astype(int)
        years, counts = np.unique(yr, return_counts=True)
        years = years[counts >= 0.8 * counts.max()]
        if years.size < 4:
            return float("nan"), float("nan")
        am = np.asarray([np.mean(y[yr == yy]) for yy in years], float)
        tc = years + 0.5
        A = np.vstack([tc - tc.mean(), np.ones_like(tc)]).T
        coef, res, *_ = np.linalg.lstsq(A, am, rcond=None)
        slope = float(coef[0])
        dof = max(len(am) - 2, 1)
        s2 = float(res[0]) / dof if res.size else float(
            np.sum((am - A @ coef) ** 2)) / dof
        se = float(np.sqrt(s2 / np.sum((tc - tc.mean()) ** 2)))
        return slope * 10.0, se * 10.0

    e_mean = float(np.mean(w["E_mean"]))
    p_mean = float(np.mean(w["P_mean"]))
    r_mean = float(np.mean(w["R_mean"]))
    water_resid = e_mean - (p_mean + r_mean)
    # total-reservoir drift measured endpoint-to-endpoint (kg/m^2/s).
    # S_snow is reported separately: glacier cells accumulate SWE with no
    # sublimation and little melt (a one-way store the reference shares),
    # and the violent cold-start fallback precip deposits hundreds of m SWE
    # there in the first days — a multi-century transient, not a water-cycle
    # imbalance. The fluid reservoirs (CWV+ICE+W_land) must not drift.
    dt_span = (te[-1] - te[0]) * T_PLANET
    res_drift = float((w["total_reservoir_mean"][-1]
                       - w["total_reservoir_mean"][0]) / max(dt_span, 1.0))
    fluid = (w["CWV_mean"] + w["ICE_mean"] + w["W_land_mean"])
    fluid_drift = float((fluid[-1] - fluid[0]) / max(dt_span, 1.0))
    snow_drift = float((w["S_snow_mean"][-1] - w["S_snow_mean"][0])
                       / max(dt_span, 1.0))
    lh = float(np.mean(w["LH_mean"]))
    lh_rel = float(np.mean(w["LH_release_mean"]))

    rme = w["routing_mass_error_kg"]
    rme = rme[np.isfinite(rme)]
    # the reference's global q-damping sink (dynamics.py:648-667): in
    # equilibrium E = P_cond + sink, so (E−P−R) should equal the sink
    cwv = float(np.mean(w["CWV_mean"]))
    q_sink = cwv * (1.0 - diff_factor) / dt

    # ---- QD_ENERGY_AUDIT attribution closure ----
    # In equilibrium TOA_net = aud_part + aud_uncoupled − Σ(internal
    # injections) (see dynamics.py audit block); the residual of that
    # identity is the *unattributed* TOA remainder, replacing the former
    # self-chosen "< 30 W/m²" bound.
    def _aud(k):
        a = w.get(k)
        if a is None:
            return float("nan")
        a = a[np.isfinite(a)]
        return float(np.mean(a)) if a.size else float("nan")

    aud_means = {k: _aud(k) for k in
                 ("aud_part", "aud_uncoupled") + AUD_INTERNAL}
    toa_mean = float(np.mean(w["TOA_net"]))
    dTOA_ann, dTOA_ann_se = _trend_with_se(w["TOA_net"])
    dTs_ann, dTs_ann_se = _trend_with_se(w["Ts_mean"])
    internal_sum = sum(aud_means[k] for k in AUD_INTERNAL)
    toa_attributed = (aud_means["aud_part"] + aud_means["aud_uncoupled"]
                      - internal_sum)
    toa_attr_residual = toa_mean - toa_attributed
    return {
        "eval_years": eval_years,
        "n_eval_chunks": n_eval,
        # chunks whose P_mean exceeds 10× the series median = fallback-precip
        # transients (cold start / NetCDF-only restart); the steady-state
        # window must exclude them — an empty list certifies this one does
        "transient_chunks_in_window_t_years": transient_in_window,
        "transient_chunks_total": int(transients.size),
        "TOA_net_mean_Wm2": float(np.mean(w["TOA_net"])),
        # the q-damping sink destroys L_v·sink of latent energy that left the
        # surface as LH but never reaches the atmosphere: in equilibrium the
        # radiative TOA budget sits at ≈ −L_v·sink (measured −94 vs −121
        # predicted at 30 yr; the remainder is the height-relaxation nudge
        # and the other reference clamps). Adding it back isolates those.
        "TOA_net_plus_qdamping_Wm2":
            float(np.mean(w["TOA_net"])) + L_V * q_sink,
        "dTOA_dt_Wm2_per_decade":
            float(np.polyfit(te, w["TOA_net"], 1)[0]) * 10.0,
        # annual-mean trends with OLS standard errors (see _trend_with_se)
        "dTOA_dt_annual_Wm2_per_decade": dTOA_ann,
        "dTOA_dt_annual_se": dTOA_ann_se,
        "dTs_dt_annual_K_per_decade": dTs_ann,
        "dTs_dt_annual_se": dTs_ann_se,
        "SFC_net_mean_Wm2": float(np.mean(w["SFC_net"])),
        "ATM_net_mean_Wm2": float(np.mean(w["ATM_net"])),
        "Ts_mean_K": float(np.mean(w["Ts_mean"])),
        "dTs_dt_K_per_decade": dTs_per_decade,
        "E_mean_kgm2s": e_mean,
        "P_mean_kgm2s": p_mean,
        "R_mean_kgm2s": r_mean,
        "CWV_mean_kgm2": cwv,
        "q_damping_sink_kgm2s": q_sink,
        "water_residual_kgm2s": water_resid,
        "water_residual_rel": water_resid / max(abs(e_mean), 1e-30),
        "water_residual_minus_qdamping_rel":
            (water_resid - q_sink) / max(abs(e_mean), 1e-30),
        "reservoir_drift_kgm2s": res_drift,
        "fluid_reservoir_drift_kgm2s": fluid_drift,
        "glacier_swe_drift_kgm2s": snow_drift,
        "S_snow_mean_kgm2": float(np.mean(w["S_snow_mean"])),
        "LH_mean_Wm2": lh,
        "LH_release_mean_Wm2": lh_rel,
        "LH_consistency_rel": (lh - lh_rel) / max(abs(lh), 1e-30),
        "LH_minus_qdamping_rel":
            (lh - lh_rel - L_V * q_sink) / max(abs(lh), 1e-30),
        "routing_mass_error_kg_mean": float(np.mean(rme)) if rme.size else None,
        # decomposition of mass_error (reference routing.py:320-331
        # semantics): mass_error = stored-to-endorheic-lakes − lake P−E
        # exactly; 'stranded' is the reference's lake-outlet-ordering
        # artifact (mass parked on already-processed cells and dropped at
        # buffer reset — see routing.py RoutingState docstring), reported
        # relative to the routed mass
        "routing_store_out_kg_mean": _aud("routing_store_out_kg"),
        "routing_lake_delta_kg_mean": _aud("routing_lake_delta_kg"),
        "routing_stranded_kg_mean": _aud("routing_stranded_kg"),
        "routing_routed_mass_kg_mean": _aud("routing_routed_mass_kg"),
        "routing_stranded_rel":
            abs(_aud("routing_stranded_kg"))
            / max(abs(_aud("routing_routed_mass_kg")), 1e-30),
        "routing_mass_error_decomp_resid_rel":
            abs((float(np.mean(rme)) if rme.size else 0.0)
                - (_aud("routing_store_out_kg")
                   - _aud("routing_lake_delta_kg")))
            / max(abs(_aud("routing_routed_mass_kg")), 1e-30),
        # measured non-conservative attribution (W/m² each; QD_ENERGY_AUDIT)
        "audit_terms_Wm2": {k: round(v, 4) for k, v in aud_means.items()},
        "TOA_attributed_Wm2": toa_attributed,
        "TOA_attribution_residual_Wm2": toa_attr_residual,
    }


def _parser():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phase1-years", type=float, default=30.0)
    ap.add_argument("--phase2-years", type=float, default=30.0)
    ap.add_argument("--eval-years", type=float, default=15.0)
    ap.add_argument("--mld1", type=float, default=5.0)
    ap.add_argument("--mld2", type=float, default=50.0)
    ap.add_argument("--nlat", type=int, default=181)
    ap.add_argument("--nlon", type=int, default=360)
    ap.add_argument("--chunk-days", type=int, default=10)
    ap.add_argument("--out", default=DEFAULT_OUT,
                    help="the record's file name under output/ (the series goes beside it)")
    ap.add_argument("--skip-phase1", action="store_true",
                    help="resume: phase 2 only, from the existing autosave")
    ap.add_argument("--restart-in", default=None,
                    help="phase 2 only, warm-started from this restart file "
                         "(e.g. a regrid_restart output, .nc or .pt); implies "
                         "--skip-phase1, ecology/plankton cold-start")
    ap.add_argument("--prepend-series", default=None,
                    help="npz series of the immediately-preceding phase-2 "
                         "segment (same grid/config; this run must resume "
                         "bit-exactly from that segment's autosave). The "
                         "series are concatenated with a continuous time "
                         "axis before the trailing-window evaluation, so "
                         "trend criteria can use the full equilibrated span "
                         "instead of one segment's (the trend SE scales as "
                         "N^-3/2 in window years).")
    ap.add_argument("--device", default="cuda",
                    help="torch device to run on (default: cuda; cpu runs the plain versions "
                         "of the kernels)")
    ap.add_argument("--reeval", default=None, metavar="SERIES_NPZ",
                    help="no simulation: recompute the acceptance of the "
                         "existing --out record from this saved series over "
                         "the trailing --eval-years steady-state window")
    return ap


def main(argv=None) -> int:
    args = _parser().parse_args(argv)
    out_path = os.path.join("output", os.path.basename(args.out))

    if args.reeval:
        reeval(args, out_path)
        return 0

    from .grid import resolve_device
    device = resolve_device(args.device)
    os.makedirs("data", exist_ok=True)
    # The SOP runs WITH orography (docs/04 §9 generates topography first and
    # points QD_TOPO_NC at it); without it the engine — like the reference
    # driver (run_simulation.py:1199-1213) — would run elevation-free.
    # Prefer an existing grid-matching data/topography.nc (continuity with
    # earlier segments of a resume chain), else generate the seeded
    # procedural topography once (in memory where no NetCDF library is
    # installed).
    topo_file, topography = os.environ.get("QD_TOPO_NC"), None
    if not (topo_file and os.path.exists(topo_file)):
        topo_file, topography = _ensure_topography(args.nlat, args.nlon)
    print(f"[Spinup] topography: {topo_file or 'in memory'}", flush=True)
    base_env = {
        "QD_TOPO_NC": topo_file or "",
        "QD_N_LAT": args.nlat, "QD_N_LON": args.nlon,
        # the documented SOP bundle (docs/11.4): explicit energy path drives
        # T_s so the TOA acceptance criterion is meaningful, banded initial
        # Ts (spin-up.sh default per docs/04 §9), Q_net-coupled ocean
        "QD_ENERGY_W": os.environ.get("QD_ENERGY_W", "1"),
        "QD_INIT_BANDED": os.environ.get("QD_INIT_BANDED", "1"),
        "QD_OCEAN_USE_QNET": os.environ.get("QD_OCEAN_USE_QNET", "1"),
        # measure every non-conservative energy term so the acceptance can
        # attribute TOA_net instead of bounding it
        "QD_ENERGY_AUDIT": os.environ.get("QD_ENERGY_AUDIT", "1"),
        # keep the hot loop clean: no plots, no periodic autosave (phases save
        # once at their end), no diversity snapshots
        "QD_PLOT_EVERY_DAYS": 1e9,
        "QD_AUTOSAVE_ENABLE": 0,
        "QD_ECO_DIVERSITY_ENABLE": 0,
    }
    if args.restart_in:
        args.skip_phase1 = True
    t0 = time.time()
    result = {"protocol": "docs/11 two-phase SOP (scaled)",
              "grid": [args.nlat, args.nlon],
              "phase1": ({"skipped": True,
                          "note": (f"warm-started from '{args.restart_in}'"
                                   if args.restart_in else
                                   "resumed from the existing autosave")}
                         if args.skip_phase1 else
                         {"years": args.phase1_years, "mld_m": args.mld1}),
              "phase2": {"years": args.phase2_years, "mld_m": args.mld2}}

    if not args.skip_phase1:
        s1 = run_phase("phase1", args.phase1_years,
                       {**base_env, "QD_MLD_M": args.mld1,
                        # fresh start: ignore every stale autosave artifact
                        "QD_AUTOSAVE_LOAD": 0, "QD_LOAD_PLANKTON": 0},
                       chunk_days=args.chunk_days, device=device, topography=topography)
        m1 = acceptance_metrics(s1, min(args.eval_years, args.phase1_years / 2))
        result["phase1"]["metrics"] = m1
        print(f"[Spinup:phase1] metrics: {json.dumps(m1, indent=2)}")

    p2_env = {**base_env, "QD_MLD_M": args.mld2, "QD_AUTOSAVE_LOAD": 1}
    # validate the warm-start source NOW: the world's restart priority falls
    # through to a banded cold init when the file is missing, which would
    # silently burn hours on a cold 50 m-MLD phase 2 while the acceptance
    # record claims it was warm-started/resumed
    if args.restart_in and not os.path.exists(args.restart_in):
        raise SystemExit(f"--restart-in '{args.restart_in}' does not exist")
    # the autosave is data/atmosphere.nc with the sidecar beside it, or the
    # sidecar alone where no NetCDF library wrote atmosphere.nc
    if args.skip_phase1 and not args.restart_in and not any(
            os.path.exists(os.path.join("data", f)) for f in ("atmosphere.nc",
                                                              "world_ckpt.pt")):
        raise SystemExit("--skip-phase1 requires data/atmosphere.nc or data/world_ckpt.pt "
                         "(no autosave to resume from — this would cold-start "
                         "phase 2 and mislabel the record)")
    if args.restart_in:
        # warm start from an explicit (possibly regridded) restart file:
        # atmosphere/ocean/land from the file, ecology/plankton cold-start,
        # no stale same-directory autosave artifacts
        p2_env.update({"QD_RESTART_IN": args.restart_in,
                       "QD_AUTOSAVE_LOAD": 0, "QD_LOAD_OCEAN": 0,
                       "QD_LOAD_PLANKTON": 0})
    s2 = run_phase("phase2", args.phase2_years, p2_env,
                   chunk_days=args.chunk_days, device=device, topography=topography)
    eval_cap = args.phase2_years / 2
    if args.prepend_series:
        prev = dict(np.load(args.prepend_series))
        pc = prev.get("_consts")
        if pc is not None and not np.allclose(pc, s2["_consts"]):
            raise SystemExit(f"--prepend-series consts {pc} != this run's "
                             f"{s2['_consts']} — different config, refusing")
        prev_t = prev["t_years"]
        offset = float(prev_t[-1])
        merged = {}
        for k in s2:
            if k == "t_years":
                merged[k] = np.concatenate([prev_t, offset + s2[k]])
            elif k == "_consts":
                merged[k] = s2[k]
            else:
                pk = prev.get(k)
                if pk is None or len(pk) != len(prev_t):
                    pk = np.full_like(prev_t, np.nan)
                merged[k] = np.concatenate([pk, s2[k]])
        s2 = merged
        total_span = float(s2["t_years"][-1])
        # always leave the (restart-transient) head out of the eval window
        eval_cap = total_span - max(5.0, 0.1 * total_span)
        result["phase2"]["prepended_series"] = {
            "file": args.prepend_series, "years": offset,
            "note": "continuous run: this segment resumed from the prepended "
                    "segment's full-state autosave sidecar (bit-exact state; "
                    "static topography re-read from QD_TOPO_NC or regenerated "
                    "from the seed in memory, f32)",
        }
        result["phase2"]["years_total_evaluated_span"] = total_span
    # persist the full series BEFORE computing metrics, so a metrics failure
    # on a short/merged span cannot lose the run's diagnostic record
    os.makedirs("output", exist_ok=True)
    series_path = os.path.splitext(out_path)[0] + "_series.npz"
    np.savez(series_path, **s2)  # full per-chunk diagnostic record

    # a smoke-scale continuation can push the transient-exclusion cap to or
    # below zero; evaluate at least the trailing half-year rather than
    # handing acceptance_metrics an empty window (np.polyfit crashes on one)
    eval_cap = max(eval_cap, 0.5)
    m2 = acceptance_metrics(s2, min(args.eval_years, eval_cap))
    result["phase2"]["metrics"] = m2
    print(f"[Spinup:phase2] metrics: {json.dumps(m2, indent=2)}")

    result["phase2"]["series"] = {
        k: [round(float(x), 10) for x in s2[k]]
        for k in ("t_years", "TOA_net", "Ts_mean")}

    crit = build_criteria(m2)
    result["acceptance"] = crit
    result["accepted"] = all(crit.values())
    result["wall_hours"] = round((time.time() - t0) / 3600.0, 3)
    result["device"] = (torch.cuda.get_device_name(device) if device.type == "cuda"
                        else str(device))

    with open(out_path, "w") as f:
        json.dump(result, f, indent=2)
    print(f"[Spinup] {'ACCEPTED' if result['accepted'] else 'NOT ACCEPTED'} "
          f"-> {out_path} ({result['wall_hours']} h wall)")
    for k, v in crit.items():
        print(f"  {'PASS' if v else 'FAIL'}  {k}")
    return 0


def _pick_trend(annual, annual_se, per_chunk, threshold):
    if np.isfinite(annual) and np.isfinite(annual_se) \
            and annual_se <= 2.0 * threshold:
        return annual
    return per_chunk


def build_criteria(m2):
    # docs/11.3 phase-2 criteria; water/LH closures measured net of the
    # reference's global q-damping sink (see acceptance_metrics docstring)
    crit = {
        # the raw docs/11 level criterion cannot hold for ANY faithful
        # implementation (the q-damping destroys L_v·sink ≈ 120 W/m² of
        # latent energy, and the reference's LW_sfc sign quirk + gh-lock
        # partition inconsistency offset the equilibrium TOA by ~±100 W/m²).
        # The honest criterion: every non-conservative term is MEASURED
        # on-device (QD_ENERGY_AUDIT) and TOA_net must close against their
        # sum — nothing unattributed beyond 2 W/m².
        "TOA_attribution_residual_lt_2":
            abs(m2["TOA_attribution_residual_Wm2"]) < 2.0,
        # trend criteria evaluate the annual-mean OLS slope when the window
        # holds ≥4 whole years (the per-chunk series carries the full
        # seasonal cycle; see _trend_with_se) — else the per-chunk slope
        # Estimator selection (_trend_with_se docstring): the annual-mean
        # OLS slope is the unbiased estimator but its SE shrinks as
        # years^-3/2 — on a short window it is pure noise (measured SE 0.55
        # W/m²/decade on a 15-yr window, 5× the criterion). Use it only
        # when it is INFORMATIVE at the criterion scale (SE ≤ 2× threshold,
        # i.e. the estimate could possibly resolve a violation); otherwise
        # fall back to the per-chunk slope over the same window.
        "dTOA_dt_lt_0.1_Wm2_decade":
            abs(_pick_trend(m2["dTOA_dt_annual_Wm2_per_decade"],
                            m2["dTOA_dt_annual_se"],
                            m2["dTOA_dt_Wm2_per_decade"], 0.1)) < 0.1,
        "dTs_dt_abs_lt_0.02_K_decade":
            abs(_pick_trend(m2["dTs_dt_annual_K_per_decade"],
                            m2["dTs_dt_annual_se"],
                            m2["dTs_dt_K_per_decade"], 0.02)) < 0.02,
        "water_closure_net_of_qdamping_lt_5pct":
            abs(m2["water_residual_minus_qdamping_rel"]) < 0.05,
        "LH_consistency_net_of_qdamping_lt_5pct":
            abs(m2["LH_minus_qdamping_rel"]) < 0.05,
        "fluid_reservoir_drift_small": abs(m2["fluid_reservoir_drift_kgm2s"])
                                 < 0.02 * max(abs(m2["E_mean_kgm2s"]), 1e-30),
        # the recorded mass_error must decompose EXACTLY into
        # store_out − lake P−E (reference routing.py:320-331 semantics) —
        # no unexplained scalar in the record. The stranded share is
        # reported (reference-inherited lake-outlet-ordering artifact).
        "routing_mass_error_fully_decomposed":
            (not np.isfinite(m2["routing_mass_error_decomp_resid_rel"]))
            or m2["routing_mass_error_decomp_resid_rel"] < 1e-4,
        # the steady-state window must not contain a fallback-precip
        # transient chunk (docs/11.5 稳态; one poisons every budget mean)
        "eval_window_free_of_transients":
            len(m2["transient_chunks_in_window_t_years"]) == 0,
    }
    # numpy scalars (np.bool_/np.float64) are not JSON-serializable
    return {k: bool(v) for k, v in crit.items()}


def reeval(args, out_path):
    """--reeval: recompute the acceptance of an existing record from its
    saved per-chunk series (no simulation). Used to re-window the evaluation
    onto the steady-state span — the reference's phase-2 criteria are
    explicitly steady-state multi-year means (docs/11.5 稳态多年平均), and a
    trailing window that reaches into a restart transient (the one-chunk
    fallback-precip deluge every NetCDF-only restart shares with the
    reference, physics.py:343 getattr default) poisons budget closures that
    hold to <0.1% on the steady span."""
    series = dict(np.load(args.reeval))
    with open(out_path) as f:
        result = json.load(f)
    t = series["t_years"]
    span = float(t[-1] - t[0])
    eval_years = min(args.eval_years, span)
    m2 = acceptance_metrics(series, eval_years)
    crit = build_criteria(m2)
    result["phase2"]["metrics"] = m2
    result["acceptance"] = crit
    result["accepted"] = all(crit.values())
    result["phase2"]["reevaluated"] = {
        "series": args.reeval, "eval_years": eval_years,
        "note": "acceptance recomputed offline over the trailing "
                f"{eval_years:g}-yr steady-state window of the "
                f"{span:.1f}-yr series (docs/11.5 steady-state means; "
                "restart transients excluded)",
    }
    with open(out_path, "w") as f:
        json.dump(result, f, indent=2)
    print(f"[Spinup] {'ACCEPTED' if result['accepted'] else 'NOT ACCEPTED'} "
          f"(reeval, {eval_years:g}/{span:.1f} yr) -> {out_path}")
    for k, v in crit.items():
        print(f"  {'PASS' if v else 'FAIL'}  {k}")


if __name__ == "__main__":
    raise SystemExit(main())
