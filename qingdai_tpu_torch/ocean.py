"""Wind-driven barotropic slab ocean (port of ``qingdai_tpu/ocean.py``).

The substep count is the static conservative bound of the JAX package, and
the substeps run as a Python loop. Kernel K4 of the JAX package (the whole
substep loop in one Pallas kernel, off by default there) is not ported yet;
this is the port of its default plain-array path, which reaches kernels K2
(SST advection) and K3 (∇⁴ of uo, vo, η) through ``ops``.
"""

from __future__ import annotations

import math

import torch

from qingdai_tpu import constants as const
from qingdai_tpu.config import OceanConfig

from .grid import Grid, divergence
from .ops import safegrad
from .ops.advect import advect_semilag_multi
from .ops.reductions import area_mean
from .ops.stencil import hyperdiffuse_multi, laplacian_sphere, shapiro_filter_multi
from .physics.energy import pow4
from .state import OceanState


def static_substeps(grid: Grid, cfg: OceanConfig, dt: float) -> int:
    """Conservative static substep count from the gravity-wave speed and the
    wind and current caps (replaces the reference's per-call CFL loop)."""
    if cfg.n_substeps > 0:
        return int(cfg.n_substeps)
    a = const.PLANET_RADIUS
    dx_lat = a * grid.dlat_rad
    dx_lon_min = a * grid.dlon_rad * max(1e-3, 0.5)
    dx_min = min(dx_lat, dx_lon_min)
    c = math.sqrt(9.81 * cfg.H_m)
    u_bound = max(c, cfg.max_u_cap, cfg.vcap)
    target = max(1e-3, cfg.cfl_target)
    n = int(math.ceil(u_bound * (dt / max(1e-12, dx_min)) / target))
    return max(1, min(500, n))


# ---------------- polar ring corrections ----------------

def _pole_rows(F: torch.Tensor):
    rows = torch.arange(F.shape[0], device=F.device)[:, None]
    return rows == 0, rows == F.shape[0] - 1


def _polar_row_mean(F, ocean_mask, row):
    m = ocean_mask[row]
    mean = torch.sum(torch.where(m, F[row], 0.0)) / torch.clamp(torch.sum(m), min=1)
    return torch.where(m & torch.any(m), mean, F[row])


def polar_scalar_average_fill(F, ocean_mask):
    """Replace both pole rows by their ocean ring means."""
    top, bot = _pole_rows(F)
    return torch.where(top, _polar_row_mean(F, ocean_mask, 0)[None],
                       torch.where(bot, _polar_row_mean(F, ocean_mask, -1)[None], F))


def _polar_vector_fill(u, v, ocean_mask, lons_rad, row, north: bool):
    """Average ring vectors in the pole's tangent plane and refill ocean lons."""
    m = ocean_mask[row]
    cnt = torch.clamp(torch.sum(m), min=1)
    any_o = torch.any(m)
    sin_l, cos_l = torch.sin(lons_rad), torch.cos(lons_rad)
    # east basis (-sinλ, cosλ, 0); north basis at ±90°
    enx, eny = (-cos_l, -sin_l) if north else (cos_l, sin_l)
    u_r, v_r = u[row], v[row]
    v3x = (-sin_l) * u_r + enx * v_r
    v3y = cos_l * u_r + eny * v_r
    mx = torch.sum(torch.where(m, v3x, 0.0)) / cnt
    my = torch.sum(torch.where(m, v3y, 0.0)) / cnt
    u_fill = (-sin_l) * mx + cos_l * my
    v_fill = enx * mx + eny * my
    return torch.where(m & any_o, u_fill, u_r), torch.where(m & any_o, v_fill, v_r)


def polar_vector_average_fill(u, v, ocean_mask, lons_rad):
    """Both pole rows of (u, v) refilled from their ring-mean vectors."""
    top, bot = _pole_rows(u)
    u0, v0 = _polar_vector_fill(u, v, ocean_mask, lons_rad, 0, north=False)
    u1, v1 = _polar_vector_fill(u, v, ocean_mask, lons_rad, -1, north=True)
    u = torch.where(top, u0[None], torch.where(bot, u1[None], u))
    v = torch.where(top, v0[None], torch.where(bot, v1[None], v))
    return u, v


# ---------------- main step ----------------

def ocean_step(grid: Grid, cfg: OceanConfig, land_mask, ocn: OceanState, u_atm, v_atm,
               Q_net, ice_mask, step_idx: int, dt: float, n_sub: int) -> OceanState:
    """Advance the slab ocean one outer step with ``n_sub`` static substeps."""
    a = const.PLANET_RADIUS
    dlat, dlon = grid.dlat_rad, grid.dlon_rad
    coslat = grid.coslat_cap_05
    g = 9.81
    on_land = land_mask == 1
    ocean_mask = ~on_land

    # wind stress from the relative wind, constant within the substeps
    u_rel = u_atm - ocn.uo
    v_rel = v_atm - ocn.vo
    Va_eff = torch.clamp(safegrad.speed(u_rel, v_rel), max=cfg.vcap)
    tau_x = cfg.tau_scale * (cfg.rho_a * cfg.CD * Va_eff * u_rel)
    tau_y = cfg.tau_scale * (cfg.rho_a * cfg.CD * Va_eff * v_rel)

    sub_dt = dt / n_sub

    # polar sponge profile
    lat_deg = torch.abs(torch.rad2deg(grid.lat_rad))
    s = torch.clamp((lat_deg - cfg.polar_lat0) / max(1e-6, 90.0 - cfg.polar_lat0), 0.0, 1.0)
    r_extra = cfg.polar_gain * (s ** 2)

    # latitude-adaptive K4 maps (the reference divides by sub_dt)
    dx_min_map = torch.clamp(a * dlon * coslat, max=a * dlat)
    k4_map = cfg.sigma4 * pow4(dx_min_map) / max(1e-12, sub_dt)
    k4_u = k4_map if cfg.k4_u is None else torch.full_like(k4_map, cfg.k4_u)
    k4_v = k4_map if cfg.k4_v is None else torch.full_like(k4_map, cfg.k4_v)
    k4_eta = 0.5 * k4_map if cfg.k4_eta is None else torch.full_like(k4_map, cfg.k4_eta)
    k4s = torch.stack([k4_u, k4_v, k4_eta])

    # the reference increments its counter at the start of a step
    apply_diff = cfg.diff_every > 0 and (step_idx + 1) % max(1, cfg.diff_every) == 0
    apply_shap = (cfg.shapiro_n > 0 and cfg.shapiro_every > 0
                  and (step_idx + 1) % max(1, cfg.shapiro_every) == 0)

    uo, vo, eta, sst = ocn.uo, ocn.vo, ocn.eta, ocn.sst
    for _ in range(n_sub):
        # pressure gradient; the latitude roll wraps across the poles
        deta_dlam = (torch.roll(eta, -1, 1) - torch.roll(eta, 1, 1)) / (2.0 * dlon)
        deta_dphi = (torch.roll(eta, -1, 0) - torch.roll(eta, 1, 0)) / (2.0 * dlat)
        gx = deta_dlam / (a * coslat)
        gy = deta_dphi / a

        du = (grid.f * vo - g * gx + tau_x / (cfg.rho_w * cfg.H_m) - cfg.r_bot * uo)
        dv = (-grid.f * uo - g * gy + tau_y / (cfg.rho_w * cfg.H_m) - cfg.r_bot * vo)
        uo = torch.where(on_land, 0.0, uo + sub_dt * du)
        vo = torch.where(on_land, 0.0, vo + sub_dt * dv)
        # polar sponge
        uo = uo - sub_dt * r_extra * uo
        vo = vo - sub_dt * r_extra * vo

        if apply_diff:
            out = hyperdiffuse_multi(torch.stack([uo, vo, eta]), k4s, sub_dt, cfg.k4_nsub,
                                     dlat, dlon, coslat, a)
            uo, vo, eta = out[0], out[1], out[2]
        if apply_shap:
            out = shapiro_filter_multi(torch.stack([uo, vo, eta]), cfg.shapiro_n)
            uo, vo, eta = out[0], out[1], out[2]

        # continuity, then removal of the ocean-mean η
        eta = eta - sub_dt * cfg.H_m * divergence(grid, uo, vo)
        eta = torch.where(on_land, 0.0, eta)
        eta = eta - area_mean(eta, grid.area_w, mask=ocean_mask)

        # SST advection + lateral diffusion
        sst_adv = advect_semilag_multi(sst[None], uo, vo, sub_dt, a, dlat, dlon, coslat)[0]
        sst = (1.0 - cfg.adv_alpha) * sst + cfg.adv_alpha * sst_adv
        if cfg.K_h > 0.0:
            sst = sst + sub_dt * cfg.K_h * laplacian_sphere(sst, dlat, dlon, coslat, a)

        # Q_net heating, reduced under ice
        if cfg.use_qnet:
            heat = Q_net / (cfg.rho_w * cfg.cp_w * cfg.H_m)
            sst = torch.where(ocean_mask & (~ice_mask), sst + sub_dt * heat, sst)
            if cfg.ice_qfac > 0.0:
                sst = torch.where(ocean_mask & ice_mask, sst + sub_dt * cfg.ice_qfac * heat, sst)

        # outlier handling
        uo = torch.nan_to_num(uo)
        vo = torch.nan_to_num(vo)
        speed = safegrad.speed(uo, vo)
        cap = cfg.max_u_cap
        if cfg.outlier_method == "mean4":
            u_m4 = 0.25 * (torch.roll(uo, -1, 0) + torch.roll(uo, 1, 0)
                           + torch.roll(uo, -1, 1) + torch.roll(uo, 1, 1))
            v_m4 = 0.25 * (torch.roll(vo, -1, 0) + torch.roll(vo, 1, 0)
                           + torch.roll(vo, -1, 1) + torch.roll(vo, 1, 1))
            fast = speed > cap
            uo = torch.where(fast, u_m4, uo)
            vo = torch.where(fast, v_m4, vo)
            speed = safegrad.speed(uo, vo)
        scl = torch.where(speed > cap, cap / (speed + 1e-12), 1.0)
        uo = uo * scl
        vo = vo * scl

        eta = torch.clamp(torch.nan_to_num(eta), -cfg.eta_cap, cfg.eta_cap)
        sst = torch.nan_to_num(sst)

    if cfg.polar_fix:
        lons_rad = torch.deg2rad(grid.lon)
        sst = polar_scalar_average_fill(sst, ocean_mask)
        uo, vo = polar_vector_average_fill(uo, vo, ocean_mask, lons_rad)

    sst = torch.clamp(sst, cfg.ts_min, cfg.ts_max)
    return OceanState(uo=uo, vo=vo, eta=eta, sst=sst)


def ocean_diagnostics(grid: Grid, cfg: OceanConfig, ocn: OceanState):
    """KE, max |u|, η range and CFL scalars."""
    KE = 0.5 * (ocn.uo ** 2 + ocn.vo ** 2)
    speed = safegrad.speed(ocn.uo, ocn.vo)
    a = const.PLANET_RADIUS
    dx_min = min(a * grid.dlat_rad, a * grid.dlon_rad * 0.5)
    c = math.sqrt(9.81 * cfg.H_m)
    return {
        "KE_mean": area_mean(KE, grid.area_w),
        "U_max": torch.amax(speed),
        "eta_min": torch.amin(ocn.eta),
        "eta_max": torch.amax(ocn.eta),
        "cfl_per_s": torch.full((), c / max(1e-12, dx_min), dtype=KE.dtype, device=KE.device),
    }
