"""The coupled planet step (port of ``qingdai_tpu/model.py``): the flagship
planet with ecology, the individual pool, phytoplankton and river routing.

Per-step order as in the JAX package: hybrid precip → daily accumulators and
the day-boundary block (ecology daily, individual pool daily, banded albedo)
→ cloud blending and advection → insolation → lapse/snowpack/glacier →
individual-pool substep → phytoplankton daily → albedo synthesis (ecology,
bands, ocean color, snow) → Teq → atmosphere step → ocean step with SST
feedback and the chlorophyll transport → land bucket → D8 routing →
diagnostics.

The step never syncs with the host. Data-dependent choices are
``torch.where``. Cadences are Python ``if``s on host numbers: the step index,
the two day accumulators of the clock and the routing event clock, which
depend only on the step count and dt, so each daily block runs once a day
and each routing event once every ``QD_HYDRO_DT_HOURS``, not as a masked
computation every step.

The same step runs on a rank of the longitude mesh when the model's grid
carries one (``build_model(..., mesh=)``, ``parallel.mesh``): the state and
the statics are the rank's columns, the ops reach across ranks, and every
diag is a sum over every rank, so all ranks hold the same values. The
Python ``if``s read host numbers that every rank holds equal, and the
mutation draws the same numbers on every rank from ``model.generator``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch

from . import constants as const
from .config import SimConfig
from .dynamics import atmos_step
from .ecology import individuals as indiv_mod
from .ecology import phyto as phyto_mod
from .ecology import population as eco_mod
from .grid import Grid, make_grid, resolve_device
from .ocean import ocean_diagnostics, ocean_step, static_substeps
from .ops.advect import advect_semilag_multi
from .ops.reductions import area_mean, masked_median_of_positive
from .ops.smooth import gaussian_filter
from .parallel.halo import gmax, gsum
from .physics import clouds as ph
from .physics import energy as en
from .physics import forcing
from .physics import hydrology as hyd
from .physics import orbital
from .routing import RoutingStatic, build_routing_static, init_routing_state, routing_step
from .state import (AlbedoCaches, ClockState, EnergyState, LandState, StaticFields,
                    WorldState, init_albedo_caches, init_atmos, init_clock,
                    init_energy_state, init_land, init_ocean, round_to)
from .telemetry import span

# QD_ENERGY_AUDIT per-step attribution scalars (area-mean W/m²)
AUDIT_KEYS = (
    "aud_part", "aud_uncoupled", "aud_hum_resid", "aud_sfc_resid",
    "aud_ts_blend", "aud_adv_ts", "aud_adv_q", "aud_nudge", "aud_filt",
    "aud_hdamp", "aud_qdamp", "aud_overwrite",
)


@dataclasses.dataclass(frozen=True)
class Model:
    """Grid, static fields and configuration of one planet, with the
    subsystem statics and the initial subsystem states of the same build
    (None where a subsystem is off)."""
    grid: Grid
    cfg: SimConfig
    static: StaticFields
    n_ocean_substeps: int
    dt: float
    device: torch.device
    dtype: torch.dtype
    # the model's random stream: ecology mutation draws from it
    generator: torch.Generator
    eco_static: Optional[eco_mod.EcoStatic] = None
    indiv_static: Optional[indiv_mod.IndivStatic] = None
    phyto_static: Optional[phyto_mod.PhytoStatic] = None
    routing_static: Optional[RoutingStatic] = None
    eco_state0: Optional[eco_mod.EcoState] = None
    indiv_state0: Optional[indiv_mod.IndivState] = None
    phyto_state0: Optional[phyto_mod.PhytoState] = None
    day_seconds: float = const.DAY_SECONDS


def build_model(cfg: SimConfig, land_mask, base_albedo, friction, elevation=None,
                network: Optional[dict] = None, device="cuda",
                dtype=torch.float32, mesh=None) -> Model:
    """Assemble the static data from topography and network arrays (host
    side). Runs on the card unless ``device`` says otherwise. Routing is
    built when it is on and a ``network`` is given, as in the JAX package.
    With ``mesh`` (``parallel.mesh.make_mesh``) the model of the rank's
    shard, whose state is ``parallel.mesh.shard_state`` of the whole
    model's ``init_world``."""
    device = resolve_device(device)
    grid = make_grid(cfg.run.n_lat, cfg.run.n_lon, device=device, dtype=dtype)
    mask_np = np.asarray(land_mask)

    def as_t(x, dt_=dtype):
        return torch.as_tensor(np.asarray(x)).to(device=device, dtype=dt_)

    land_mask = as_t(land_mask, torch.int32)
    Cs_ocean = cfg.ocean.rho_w * cfg.ocean.cp_w * cfg.run.mld_m
    has_elev = elevation is not None
    static = StaticFields(
        land_mask=land_mask,
        elevation=as_t(elevation if has_elev else np.zeros(grid.shape)),
        base_albedo=as_t(base_albedo),
        friction=as_t(friction),
        C_s_map=torch.where(land_mask == 1, cfg.run.cs_land,
                            torch.full(grid.shape, Cs_ocean, dtype=dtype, device=device)),
        has_elevation=has_elev,
    )
    sub = {}
    if cfg.ecology.enabled:
        es, eco0, _, _ = eco_mod.build_eco(grid.shape, mask_np, cfg.ecology, device, dtype)
        sub.update(eco_static=es, eco_state0=eco0)
        if cfg.ecology.indiv_enable:
            sub["indiv_static"], sub["indiv_state0"] = indiv_mod.build_individuals(
                grid.shape, mask_np, es, eco0, cfg.ecology, device, dtype)
    if cfg.phyto.enabled:
        sub["phyto_static"], sub["phyto_state0"], _ = phyto_mod.build_phyto(
            grid.shape, mask_np, cfg.phyto, cfg.ecology, cfg.ocean.H_m, device, dtype)
    if cfg.hydrology.routing_enable and network is not None:
        sub["routing_static"] = build_routing_static(network, grid, dtype)
    model = Model(grid=grid, cfg=cfg, static=static,
                  n_ocean_substeps=static_substeps(grid, cfg.ocean, cfg.run.dt_seconds),
                  dt=float(cfg.run.dt_seconds), device=device, dtype=dtype,
                  generator=torch.Generator(device=device).manual_seed(cfg.run.seed), **sub)
    if mesh is None:
        return model
    from .parallel.mesh import shard_model_statics
    return shard_model_statics(model, mesh)


def init_world(model: Model, t0_seconds: float = 0.0, seed: int = 42) -> WorldState:
    """Fresh initial state in the model's dtype on the model's device. The
    subsystem states are those of the model's build (``seed`` draws only
    QD_PHYTO_INIT_RANDOM's noise, as in the JAX package)."""
    cfg, grid, dtype = model.cfg, model.grid, model.dtype
    phyto0 = model.phyto_state0
    if phyto0 is not None and cfg.phyto.init_random:
        _, phyto0, _ = phyto_mod.build_phyto(
            grid.shape, model.static.land_mask.cpu().numpy(), cfg.phyto, cfg.ecology,
            cfg.ocean.H_m, model.device, dtype, seed=seed)
    atmos = init_atmos(grid, cfg, dtype)
    ocean = init_ocean(grid, model.static.land_mask, Ts_init=atmos.T_s, dtype=dtype)
    if cfg.run.init_banded:
        Ts0 = (cfg.run.init_t_pole + (cfg.run.init_t_eq - cfg.run.init_t_pole)
               * torch.cos(grid.lat_rad) ** 2).to(dtype)
        atmos = dataclasses.replace(atmos, T_s=Ts0)
        ocean = dataclasses.replace(
            ocean, sst=torch.where(model.static.land_mask == 0, Ts0, ocean.sst))
    routing = (init_routing_state(model.routing_static, dtype)
               if model.routing_static is not None else None)
    return WorldState(atmos=atmos, ocean=ocean, land=init_land(grid, dtype),
                      energy=init_energy_state(cfg, grid, dtype),
                      clock=init_clock(grid, t0_seconds, dtype),
                      albedo=init_albedo_caches(grid, dtype),
                      eco=model.eco_state0, indiv=model.indiv_state0, phyto=phyto0,
                      routing=routing)


def _day_end(model: Model, clock: ClockState):
    """(the day accumulator after the next step from ``clock``, whether that
    step ends a day): host numbers, no sync."""
    dt_r, day_r = round_to(model.dt, model.dtype), round_to(model.day_seconds, model.dtype)
    accum_t = round_to(clock.accum_t_day + dt_r, model.dtype)
    return accum_t, accum_t >= day_r


def mutation_due(model: Model, clock: ClockState) -> bool:
    """Whether the next step from ``clock`` draws the daily mutation's
    random numbers: ecology on, QD_ECO_MUT_RATE > 0, and the step ends a
    day (``_day_end``, the step's own test)."""
    ecfg = model.cfg.ecology
    if model.eco_static is None or not ecfg.enabled or ecfg.mut_rate <= 0.0:
        return False
    return _day_end(model, clock)[1]


def mutation_schedule(model: Model, clock: ClockState, n_steps: int) -> list:
    """``mutation_due`` for each of the next ``n_steps`` steps from
    ``clock``, the day accumulator walked on the host as the step walks it."""
    day_r = round_to(model.day_seconds, model.dtype)
    due = []
    for _ in range(n_steps):
        due.append(mutation_due(model, clock))
        accum_t, is_daily = _day_end(model, clock)
        clock = dataclasses.replace(
            clock, accum_t_day=round_to(accum_t - day_r, model.dtype) if is_daily else accum_t)
    return due


def make_step_fn(model: Model, with_diags: bool = True):
    """Returns step(state, draws=None) -> (state, diag dict of 0-d tensors).

    ``with_diags=False`` returns ``(state, {})`` and skips the diag-only
    reductions; the state trajectory is the same. On a step where
    ``mutation_due``, the mutation takes ``draws``
    (``ecology.population.MutationDraws``) or, without them, draws from
    ``model.generator``. Each stage of the step runs inside a
    ``telemetry.span`` named ``<layer>.<stage>``, under the root ``step``."""
    grid, cfg, static, dt = model.grid, model.cfg, model.static, model.dt
    mesh = grid.mesh
    day_s = model.day_seconds
    pcfg, hcfg, ecfg = cfg.physics, cfg.hydrology, cfg.ecology
    a = const.PLANET_RADIUS
    land_mask = static.land_mask
    land = land_mask == 1
    ocean_mask = ~land
    landf = land.to(static.base_albedo.dtype)
    ocean_on = cfg.ocean.enabled
    es, ist, ps = model.eco_static, model.indiv_static, model.phyto_static
    eco_on = es is not None and ecfg.enabled
    indiv_on = eco_on and ist is not None and ecfg.indiv_enable
    phyto_on = ps is not None and cfg.phyto.enabled
    routing_on = model.routing_static is not None and hcfg.routing_enable
    # the clock's host accumulators take the values of the model dtype
    dt_r, day_r = round_to(dt, model.dtype), round_to(day_s, model.dtype)
    true_ = torch.ones((), dtype=torch.bool, device=model.device)

    def _step(state: WorldState, draws: Optional[eco_mod.MutationDraws]):
        atmos, clock, alb, lstate = state.atmos, state.clock, state.albedo, state.land
        eco_state, indiv_state, phyto_state = state.eco, state.indiv, state.phyto
        step_idx = clock.step_idx

        # ---- orographic factor + hybrid precip ----
        with span("physics.precip"):
            orog_factor = None
            if pcfg.orog_enable and static.has_elevation:
                orog_factor = ph.compute_orographic_factor(grid, static.elevation, atmos.u,
                                                           atmos.v, k_orog=pcfg.k_orog)
            precip = ph.diagnose_precipitation_hybrid(grid, atmos.u, atmos.v, atmos.cloud_cover,
                                                      atmos.P_cond_flux_last, pcfg,
                                                      orog_factor=orog_factor, smooth_sigma=1.0)

            # ---- daily accumulation and the day-boundary block ----
            precip_acc = clock.precip_acc_day + torch.nan_to_num(precip) * dt
            accum_t, is_daily = _day_end(model, clock)
            alpha_banded_daily, has_banded = alb.alpha_banded_daily, alb.has_alpha_banded
            if eco_on:
                soil_idx = torch.clamp(lstate.W_land / max(1e-6, ecfg.soil_water_cap), 0.0, 1.0)
                soil_idx = soil_idx * (~lstate.glacier_mask)
            if eco_on and is_daily:
                with span("ecology.daily"):
                    eco_state = eco_mod.eco_step_daily(es, eco_state, ecfg, soil_idx,
                                                       model.generator, draws, mesh)
                    # glacier cells: zero LAI
                    eco_state = dataclasses.replace(eco_state, LAI_SK=torch.where(
                        lstate.glacier_mask[None, None], 0.0, eco_state.LAI_SK))
                    if indiv_on:
                        indiv_state, eco_state = indiv_mod.indiv_step_daily(
                            ist, indiv_state, es, eco_state, ecfg, soil_idx)
                    if ecfg.bands_couple:
                        A = eco_mod.surface_albedo_bands(es, eco_state, ecfg)
                        alpha_banded_daily = torch.clamp(
                            torch.nansum(A * es.w_b[:, None, None], dim=0), 0.0, 1.0)
                        has_banded = true_
            if is_daily:
                precip_day_last = precip_acc
                precip_acc = torch.zeros_like(precip_acc)
                accum_t = round_to(accum_t - day_r, model.dtype)
            else:
                precip_day_last = clock.precip_day_last

        # ---- cloud blending ----
        with span("physics.clouds"):
            if pcfg.p_ref is not None:
                P_ref = torch.full((), pcfg.p_ref, dtype=precip.dtype, device=precip.device)
            else:
                P_ref = masked_median_of_positive(precip, fallback=1e-6, mesh=mesh)
            C_from_P = ph.cloud_from_precip(precip, C_max=pcfg.c_max, P_ref=P_ref, smooth_sigma=1.0,
                                            mesh=mesh)
            cloud_source = ph.parameterize_cloud_cover(grid, atmos.T_s, atmos.u, atmos.v)
            tendency = cloud_source * (dt / (6 * 3600.0))
            w_sum = pcfg.w_mem + pcfg.w_p + pcfg.w_src
            if w_sum <= 0:
                w_mem, w_p, w_src = 0.5, 0.4, 0.1
            else:
                w_mem, w_p, w_src = pcfg.w_mem / w_sum, pcfg.w_p / w_sum, pcfg.w_src / w_sum
            cloud = (w_mem * atmos.cloud_cover + w_p * C_from_P
                     + w_src * torch.clamp(atmos.cloud_cover + tendency, 0.0, 1.0))
            if pcfg.cloud_floor > 0.0:
                cloud = torch.maximum(cloud, torch.clamp(pcfg.cloud_floor * C_from_P, 0.0, 1.0))
            cloud = torch.clamp(cloud, 0.0, 1.0)

            if pcfg.cloud_advect:
                cloud_adv = advect_semilag_multi(cloud[None], atmos.u, atmos.v, dt, a,
                                                 grid.dlat_rad, grid.dlon_rad,
                                                 grid.coslat_cap_tiny, mesh)[0]
                if pcfg.cloud_smooth_sigma > 0.0:
                    cloud_adv = gaussian_filter(cloud_adv, pcfg.cloud_smooth_sigma,
                                                mode_lat="wrap", mode_lon="wrap", mesh=mesh)
                cloud = torch.clamp((1.0 - pcfg.cloud_adv_alpha) * cloud
                                    + pcfg.cloud_adv_alpha * cloud_adv, 0.0, 1.0)
            atmos = dataclasses.replace(atmos, cloud_cover=cloud)

        # ---- insolation from the carried phases ----
        with span("physics.insolation"):
            insA, insB = forcing.insolation_components_from_phases(
                grid, clock.phase_rot, clock.phase_binary, clock.phase_planet)
            isr = insA + insB

        # ---- lapse rate, snowpack, glacier ----
        with span("physics.snow"):
            T_a_proxy = 288.0 + (9.81 / 1004.0) * atmos.h
            h_snow_geom = torch.where(land, torch.clamp(lstate.S_snow, min=0.0)
                                      / max(hcfg.rho_snow, 1e-6), 0.0)
            polar = torch.abs(grid.lat_mesh) >= hcfg.polar_lat_thresh
            h_ice_eff = torch.where(polar, torch.clamp(h_snow_geom, max=hcfg.polar_ice_thick_max_m),
                                    h_snow_geom)
            H_eff = torch.clamp(static.elevation + h_ice_eff, max=hcfg.land_elev_max_m)
            if hcfg.lapse_enable:
                T_hat_a = T_a_proxy - hcfg.gamma_kpm * (H_eff / 1000.0)
            else:
                T_hat_a = T_a_proxy
            P_rain, P_snow, _ = hyd.partition_precip_phase_smooth(
                precip, T_hat_a, T_thresh=hcfg.snow_thresh_K, dT_half_K=hcfg.snow_t_band_K)

            if hcfg.swe_enable:
                S_snow_next, melt_flux_land, C_snow_map, alpha_snow_map = hyd.snowpack_step(
                    lstate.S_snow, P_snow * landf, T_hat_a, hcfg, dt)
                glacier = land & ((C_snow_map >= hcfg.glacier_frac)
                                  | (S_snow_next >= hcfg.glacier_swe_mm))
                # rain on glacier deposits into SWE
                S_snow_next = S_snow_next + P_rain * landf * glacier * dt
            else:
                C_snow_map = torch.zeros_like(atmos.T_s)
                alpha_snow_map = torch.full_like(atmos.T_s, hcfg.snow_albedo_fresh)
                S_snow_next = lstate.S_snow
                melt_flux_land = torch.zeros_like(atmos.T_s)
                glacier = land & (C_snow_map >= hcfg.glacier_frac)

        # ---- individual-pool substep ----
        if indiv_on:
            with span("ecology.indiv_substep"):
                indiv_state = indiv_mod.indiv_try_substep(ist, indiv_state, es, ecfg, insA, insB,
                                                          soil_idx, dt, day_s, glacier_mask=glacier)

        # ---- phytoplankton daily ----
        alpha_water, has_water = alb.alpha_water_scalar, alb.has_alpha_water
        phyto_accum = round_to(clock.phyto_accum + dt_r, model.dtype)
        if phyto_on and phyto_accum >= day_r:
            with span("ecology.phyto_daily"):
                T_w = state.ocean.sst if ocean_on else atmos.T_s
                phyto_state = phyto_mod.phyto_step_daily(ps, phyto_state, cfg.phyto, insA, insB,
                                                         T_w)
            alpha_water, has_water = phyto_state.alpha_scalar, true_
            phyto_accum = round_to(phyto_accum - day_r, model.dtype)

        # ---- albedo synthesis ----
        with span("physics.albedo"):
            ice_frac = 1.0 - torch.exp(-torch.clamp(atmos.h_ice, min=0.0)
                                       / max(1e-6, pcfg.h_ice_ref))
            if pcfg.use_topo_albedo:
                base_input = static.base_albedo
            else:
                base_input = torch.full_like(atmos.T_s, pcfg.alpha_water)

            alpha_eco_last = alb.alpha_ecology_last
            if eco_on and ecfg.subdaily_enable and ecfg.albedo_couple:
                # the energy accumulates every step; the albedo map refreshes
                # every QD_ECO_SUBSTEP_EVERY_NPHYS steps and is kept between
                with span("ecology.subdaily"):
                    eco_state, alpha_fresh = eco_mod.eco_step_subdaily(es, eco_state, ecfg, isr,
                                                                       dt, mesh)
                n_every = max(1, int(ecfg.substep_every_nphys))
                alpha_map = alpha_fresh if (step_idx + 1) % n_every == 0 else alpha_eco_last
                W_LAI = ecfg.lai_albedo_weight
                m = land & (~glacier) & torch.isfinite(alpha_map)
                base_input = torch.where(m, (1.0 - W_LAI) * base_input
                                         + W_LAI * torch.nan_to_num(alpha_map), base_input)
                alpha_eco_last = alpha_map
            if eco_on and ecfg.bands_couple:
                m2 = land & torch.isfinite(alpha_banded_daily) & has_banded
                base_input = torch.where(m2, torch.clamp(torch.nan_to_num(alpha_banded_daily),
                                                         0.0, 1.0), base_input)
            if phyto_on and cfg.phyto.albedo_couple:
                m_o = ocean_mask & torch.isfinite(alpha_water) & has_water
                base_input = torch.where(m_o, torch.clamp(alpha_water, 0.0, 1.0), base_input)
            if hcfg.swe_enable:
                blend = torch.clamp((1.0 - C_snow_map) * base_input + C_snow_map * alpha_snow_map,
                                    0.0, 1.0)
                base_input = torch.where(land, blend, base_input)
            albedo = ph.calculate_dynamic_albedo(atmos.cloud_eff_last, atmos.T_s, base_input,
                                                 pcfg.alpha_ice, pcfg.alpha_cloud,
                                                 land_mask=land_mask, ice_frac=ice_frac)
            Teq = forcing.equilibrium_temp(isr, albedo)

        # ---- atmosphere ----
        with span("dynamics"):
            atmos, aux = atmos_step(grid, cfg, static, atmos, state.energy, Teq, albedo, isr,
                                    step_idx, dt)
        ediag = None
        if with_diags:
            with span("diag.energy"):
                ediag = en.energy_diagnostics(grid.area_w, isr, aux["R"], aux["OLR"],
                                              aux["SW_sfc"], aux["LW_sfc"], aux["SH"], aux["LH"],
                                              mesh)

        # ---- ocean + SST feedback ----
        ocn, estate = state.ocean, state.energy
        if ocean_on:
            with span("physics.surface_fluxes"):
                ice_mask = atmos.h_ice > 0.0
                cloud_eff = atmos.cloud_eff_last
                _, SW_sfc, R_ = en.shortwave_radiation(isr, albedo, cloud_eff, cfg.energy)
                T_a2 = 288.0 + (9.81 / 1004.0) * atmos.h
                ice_frac2 = 1.0 - torch.exp(-torch.clamp(atmos.h_ice, min=0.0)
                                            / max(1e-6, pcfg.h_ice_ref))
                if cfg.energy.lw_v2:
                    eps_sfc = en.surface_emissivity_map(land_mask, ice_frac2, cfg.energy)
                    _, LW_sfc, OLR_, _, _ = en.longwave_radiation_v2(
                        atmos.T_s, T_a2, cloud_eff, eps_sfc, cfg.energy, eps0=estate.lw_eps0)
                else:
                    _, LW_sfc, OLR_, _, _ = en.longwave_radiation(
                        atmos.T_s, T_a2, cloud_eff, cfg.energy, eps0=estate.lw_eps0,
                        kc=estate.lw_kc)
                SH, _ = en.boundary_layer_fluxes(atmos.T_s, T_a2, atmos.u, atmos.v, land_mask,
                                                 cfg.energy, rho=cfg.humidity.rho_a)
                Q_net = SW_sfc - LW_sfc - SH - atmos.LH_last

                # greenhouse autotune
                if cfg.energy.autotune and step_idx % max(1, cfg.energy.tune_every) == 0:
                    diag_toa = area_mean(isr - R_ - OLR_, grid.area_w, mesh=mesh)
                    e0, kc = en.autotune_greenhouse(estate.lw_eps0, estate.lw_kc, diag_toa,
                                                    cfg.energy)
                    estate = EnergyState(lw_eps0=e0, lw_kc=kc)

                # with one substep the chlorophyll stack rides the SST gather
                share_gather = (phyto_on and cfg.phyto.advection
                                and model.n_ocean_substeps == 1)
            with span("ocean"):
                ocn, tracers_adv = ocean_step(
                    grid, cfg.ocean, land_mask, ocn, atmos.u, atmos.v, Q_net, ice_mask, step_idx,
                    dt, model.n_ocean_substeps,
                    tracers=phyto_state.C_phyto if share_gather else None)
            with span("physics.sst_feedback"):
                ocean_open = ocean_mask & (~ice_mask)
                if cfg.energy.audit:
                    Cs_ocn = cfg.ocean.rho_w * cfg.ocean.cp_w * cfg.run.mld_m
                    aux["aud_overwrite"] = area_mean(
                        torch.where(ocean_open, Cs_ocn * (ocn.sst - atmos.T_s) / dt, 0.0),
                        grid.area_w, mesh=mesh)
                atmos = dataclasses.replace(atmos, T_s=torch.where(ocean_open, ocn.sst, atmos.T_s))
            if phyto_on and cfg.phyto.advection:
                with span("ecology.phyto_transport"):
                    if share_gather:
                        phyto_state = phyto_mod.phyto_apply_transport(ps, phyto_state, cfg.phyto,
                                                                      grid, tracers_adv, dt)
                    else:
                        phyto_state = phyto_mod.phyto_advect_diffuse(ps, phyto_state, cfg.phyto,
                                                                     grid, ocn.uo, ocn.vo, dt)
        else:
            with span("physics.surface_fluxes"):
                Q_net = torch.zeros_like(atmos.T_s)

        # ---- land bucket ----
        with span("physics.land_bucket"):
            E_flux = atmos.E_flux_last
            non_glacier = land & (~glacier)
            P_in = (P_rain * landf + melt_flux_land) * non_glacier
            E_in = E_flux * landf * non_glacier
            W_land, R_bucket = hyd.update_land_bucket(lstate.W_land, P_in, E_in, hcfg, dt)
            R_total = R_bucket + melt_flux_land * glacier
        routing_state = state.routing
        if routing_on:
            with span("routing"):
                routing_state = routing_step(model.routing_static, routing_state, hcfg, R_total,
                                             dt, precip, E_flux, mesh)
        with span("clock"):
            lstate = LandState(W_land=W_land, S_snow=S_snow_next, C_snow=C_snow_map,
                               glacier_mask=glacier)

            # ---- clock: phases advance mod 2π ----
            two_pi = 2.0 * math.pi
            clock = ClockState(
                t_seconds=clock.t_seconds + dt,
                step_idx=step_idx + 1,
                phase_rot=torch.remainder(clock.phase_rot + const.PLANET_OMEGA * dt, two_pi),
                phase_binary=torch.remainder(clock.phase_binary + orbital.OMEGA_BINARY * dt,
                                             two_pi),
                phase_planet=torch.remainder(clock.phase_planet + orbital.OMEGA_PLANET * dt,
                                             two_pi),
                precip_acc_day=precip_acc,
                accum_t_day=accum_t,
                precip_day_last=precip_day_last,
                phyto_accum=phyto_accum,
            )
            alb = AlbedoCaches(alpha_ecology_last=alpha_eco_last,
                               alpha_banded_daily=alpha_banded_daily, has_alpha_banded=has_banded,
                               alpha_water_scalar=alpha_water, has_alpha_water=has_water)
            new_state = WorldState(atmos=atmos, ocean=ocn, land=lstate, energy=estate,
                                   clock=clock, albedo=alb, eco=eco_state, indiv=indiv_state,
                                   phyto=phyto_state, routing=routing_state)
        if not with_diags:
            return new_state, {}

        with span("diag.water"):
            wdiag = hyd.water_closure_means(grid.area_w, atmos.q, cfg.humidity.rho_a,
                                            cfg.humidity.h_mbl, atmos.h_ice, cfg.dynamics.rho_ice,
                                            W_land, S_snow_next, E_flux, precip, R_total, mesh)
            wmean = lambda x, mask=None: area_mean(x, grid.area_w, mask=mask, mesh=mesh)
            diag = {
                "TOA_net": ediag["TOA_net"], "SFC_net": ediag["SFC_net"],
                "ATM_net": ediag["ATM_net"], "OLR_mean": ediag["OLR_mean"],
                "Ts_mean": wmean(atmos.T_s),
                "E_mean": wdiag["E_mean"], "P_mean": wdiag["P_mean"], "R_mean": wdiag["R_mean"],
                "total_reservoir_mean": wdiag["total_reservoir_mean"],
                "CWV_mean": wdiag["CWV_mean"], "ICE_mean": wdiag["ICE_mean"],
                "W_land_mean": wdiag["W_land_mean"], "S_snow_mean": wdiag["S_snow_mean"],
                "LH_mean": wmean(atmos.LH_last),
                "LH_release_mean": wmean(atmos.LH_release_last),
                "u_max": gmax(torch.abs(atmos.u), mesh),
                "v_max": gmax(torch.abs(atmos.v), mesh),
                "Qnet_mean": wmean(Q_net, ocean_mask),
            }
            if cfg.energy.audit:
                for k in AUDIT_KEYS:
                    diag[k] = aux.get(k, torch.zeros_like(diag["TOA_net"]))
            if cfg.dynamics.dyn_diag:
                for k in ("dyn_var_u_pre", "dyn_var_v_pre", "dyn_var_h_pre",
                          "dyn_var_u_post", "dyn_var_v_post", "dyn_var_h_post"):
                    diag[k] = aux[k]

            ice_mask_d = (atmos.h_ice > 0.0) & ocean_mask
            diag["seaice_area_frac"] = wmean(ice_mask_d.to(atmos.T_s.dtype))
            diag["seaice_mean_h"] = (gsum(torch.where(ice_mask_d, atmos.h_ice, 0.0), mesh)
                                     / torch.clamp(gsum(ice_mask_d, mesh), min=1))
            if eco_on:
                lai_tot = torch.sum(eco_state.LAI_SK, dim=(0, 1))
                land_cnt = torch.clamp(gsum(land, mesh), min=1)
                diag["lai_mean"] = gsum(torch.where(land, lai_tot, 0.0), mesh) / land_cnt
                diag["lai_max"] = gmax(torch.where(land, lai_tot, 0.0), mesh)
            if phyto_on:
                diag["chl_mean"] = wmean(torch.sum(phyto_state.C_phyto, dim=0))
                diag["kd490_mean"] = wmean(phyto_state.Kd_490)
                diag["alpha_water_mean"] = wmean(alpha_water)
            if ocean_on:
                od = ocean_diagnostics(grid, cfg.ocean, ocn)
                diag["ocean_KE_mean"] = od["KE_mean"]
                diag["ocean_U_max"] = od["U_max"]
                if cfg.ocean.energy_diag:
                    wa = grid.area_w
                    eff_Q = torch.where(ocean_mask & (~ice_mask), Q_net, 0.0)
                    if cfg.ocean.ice_qfac > 0.0:
                        eff_Q = eff_Q + cfg.ocean.ice_qfac * torch.where(ocean_mask & ice_mask,
                                                                         Q_net, 0.0)
                    polar_o = (torch.abs(grid.lat_mesh) >= cfg.ocean.polar_lat_diag) & ocean_mask
                    wsum_o = gsum(wa * ocean_mask, mesh) + 1e-15
                    wsum_p = gsum(wa * polar_o, mesh) + 1e-15
                    diag["oceanE_Q_mean"] = gsum(eff_Q * wa, mesh) / wsum_o
                    diag["oceanE_Qp_mean"] = gsum(torch.where(polar_o, eff_Q, 0.0) * wa,
                                                  mesh) / wsum_p
                    diag["oceanE_sst_mean"] = (gsum(torch.where(ocean_mask, ocn.sst, 0.0) * wa,
                                                    mesh) / wsum_o)
                    diag["oceanE_sstp_mean"] = (gsum(torch.where(polar_o, ocn.sst, 0.0) * wa, mesh)
                                                / wsum_p)
            if routing_on:
                # mass_error = store_out − lake_delta; stranded is the reference's
                # lake-outlet-ordering artifact (routing.RoutingState)
                diag.update({
                    "routing_ocean_inflow_kgps": routing_state.ocean_inflow_kgps,
                    "routing_mass_error_kg": routing_state.mass_error_kg,
                    "routing_stranded_kg": routing_state.stranded_kg,
                    "routing_routed_mass_kg": routing_state.routed_mass_kg,
                    "routing_store_out_kg": routing_state.store_out_kg,
                    "routing_lake_delta_kg": routing_state.lake_delta_kg,
                })
            return new_state, diag

    def step(state: WorldState, draws: Optional[eco_mod.MutationDraws] = None):
        with span("step"):
            return _step(state, draws)

    return step


def diag_stride(model: Model, chunk_steps: int, diag_every: Optional[int] = None) -> int:
    """The effective QD_DIAG_EVERY of a chunk: 1 unless it divides the chunk
    and, for a chunk of whole days, the day."""
    n = chunk_steps
    spd = int(round(model.day_seconds / model.dt))
    aligned = (abs(spd * model.dt - model.day_seconds) < 1e-9 and spd >= 2 and n % spd == 0)
    de = max(1, diag_every if diag_every is not None else model.cfg.run.diag_every)
    if n % de or (aligned and spd % de):
        de = 1
    return de


def make_chunk_fn(model: Model, chunk_steps: Optional[int] = None,
                  diag_every: Optional[int] = None):
    """chunk(state) -> (state, diags): ``chunk_steps`` steps in a Python loop.

    Diags are emitted on every Nth step only (N = ``diag_every``, default
    QD_DIAG_EVERY); the steps between skip the diag-only reductions. Each diag
    leaf is a device tensor of length n//N whose row i samples step
    (i+1)·N−1 of the chunk. N falls back to 1 as in :func:`diag_stride`."""
    n = chunk_steps or model.cfg.run.chunk_steps
    de = diag_stride(model, n, diag_every)
    step = make_step_fn(model)
    step_nd = make_step_fn(model, with_diags=False) if de > 1 else step

    def chunk(state: WorldState):
        rows = []
        for i in range(n):
            if (i + 1) % de == 0:
                state, d = step(state)
                rows.append(d)
            else:
                state, _ = step_nd(state)
        return state, {k: torch.stack([r[k] for r in rows]) for k in rows[0]}

    return chunk
