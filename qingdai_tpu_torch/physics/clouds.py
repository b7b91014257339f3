"""Cloud, precipitation and albedo parameterizations (port of
``qingdai_tpu/physics/clouds.py``)."""

from __future__ import annotations

import torch

from .. import constants as const
from ..config import PhysicsConfig
from ..grid import Grid, divergence, vorticity
from ..ops.reductions import area_mean, masked_median_of_positive
from ..ops.smooth import gaussian_filter


def diagnose_precipitation(grid: Grid, u, v, cloud_cover, D_crit, k_precip,
                           cloud_threshold=0.05, smooth_sigma=1.0):
    """Convergence-ramp precip with soft cloud gating."""
    div = divergence(grid, u, v)
    precip = k_precip * torch.clamp(-(div - D_crit), min=0.0)
    if cloud_threshold is not None and cloud_threshold > 0:
        cc = torch.clamp(cloud_cover, 0.0, 1.0)
        precip = precip * (1.0 / (1.0 + torch.exp(-10.0 * (cc - cloud_threshold))))
    if smooth_sigma and smooth_sigma > 0:
        precip = gaussian_filter(precip, smooth_sigma)
    return precip


def cloud_from_precip(precip, C_max=0.95, P_ref=2e-5, smooth_sigma=1.0):
    """C = C_max tanh(P/P_ref), smoothed and clipped; P_ref may be a 0-d tensor."""
    C = C_max * torch.tanh(precip / (P_ref + 1e-12))
    if smooth_sigma and smooth_sigma > 0:
        C = gaussian_filter(C, smooth_sigma)
    return torch.clamp(C, 0.0, 1.0)


def parameterize_cloud_cover(grid: Grid, T_s, u, v):
    """Thermodynamic + vorticity + frontal cloud source in [0, 1]."""
    evap_src = 0.5 * torch.clamp(torch.tanh((T_s - 285.0) / 12.0), 0.0, 1.0)
    rel_vort = vorticity(grid, u, v) / (grid.f + 1e-12)
    vsrc = 0.4 * torch.clamp(torch.tanh((rel_vort - 0.5) / 2.0), 0.0, 1.0)
    a = const.PLANET_RADIUS
    dx = grid.dlon_rad * a * grid.coslat_cap_tiny
    dy = grid.dlat_rad * a
    gTx = (torch.roll(T_s, -1, 1) - torch.roll(T_s, 1, 1)) / (2.0 * dx)
    gTy = (torch.roll(T_s, -1, 0) - torch.roll(T_s, 1, 0)) / (2.0 * dy)
    adv = -(u * gTx + v * gTy)
    fsrc = 0.3 * torch.clamp(torch.tanh(torch.abs(adv) / 2e-5), 0.0, 1.0)
    return torch.clamp(gaussian_filter(evap_src + vsrc + fsrc, 1.0), 0.0, 1.0)


def compute_orographic_factor(grid: Grid, elevation, u, v, k_orog=7e-4, cap=2.0,
                              smooth_sigma=1.0):
    """Upslope-wind precip enhancement factor ≥ 1."""
    a = const.PLANET_RADIUS
    dx = a * grid.coslat_cap_tiny * grid.dlon_rad
    dy = a * grid.dlat_rad
    dHdx = (torch.roll(elevation, -1, 1) - torch.roll(elevation, 1, 1)) / (2.0 * dx)
    dHdy = (torch.roll(elevation, -1, 0) - torch.roll(elevation, 1, 0)) / (2.0 * dy)
    dHdy = dHdy.clone()
    dHdy[0] = 0.0
    dHdy[-1] = 0.0
    gnorm = torch.sqrt(dHdx ** 2 + dHdy ** 2)
    eps = 1e-12
    n_x = torch.where(gnorm > eps, dHdx / (gnorm + eps), 0.0)
    n_y = torch.where(gnorm > eps, dHdy / (gnorm + eps), 0.0)
    uplift = torch.clamp(u * n_x + v * n_y, min=0.0)
    factor = torch.clamp(1.0 + k_orog * uplift, 1.0, cap)
    if smooth_sigma and smooth_sigma > 0:
        factor = gaussian_filter(factor, smooth_sigma)
    return factor


def calculate_dynamic_albedo(cloud_cover, T_s, base_albedo, alpha_ice, alpha_cloud,
                             land_mask=None, t_freeze=271.35, delta_T=5.0,
                             ice_only_over_ocean=True, ice_frac=None,
                             h_ice=None, H_ref=0.5, h0=0.05, gamma=1.0):
    """Dynamic albedo: base/ice mix, then cloud mix."""
    C = torch.clamp(cloud_cover, 0.0, 1.0)
    if ice_frac is not None:
        icf = torch.clamp(ice_frac, 0.0, 1.0)
    elif h_ice is not None:
        h = torch.clamp(h_ice - h0, min=0.0)
        icf = torch.clamp(1.0 - torch.exp(-h / max(1e-6, H_ref)), 0.0, 1.0) ** gamma
    else:
        icf = 0.5 * (1.0 + torch.tanh((t_freeze - T_s) / max(1e-6, delta_T)))
    if ice_only_over_ocean and land_mask is not None:
        icf = icf * (land_mask == 0)
    surface_albedo = base_albedo * (1.0 - icf) + alpha_ice * icf
    albedo = surface_albedo * (1.0 - C) + alpha_cloud * C
    return torch.clamp(albedo, 0.0, 1.0)


def diagnose_precipitation_hybrid(grid: Grid, u, v, cloud_cover, P_cond,
                                  cfg: PhysicsConfig, orog_factor=None, smooth_sigma=1.0):
    """Humidity-aware hybrid precip: P_cond redistributed by median-normalized
    convergence and orography, renormalized to conserve ⟨P⟩ = ⟨P_cond⟩,
    smoothed, and blended with the convergence scheme where moisture is weak.
    Every data-dependent choice is a ``torch.where``."""
    Pq = torch.clamp(P_cond, min=0.0)

    pos = torch.clamp(-(divergence(grid, u, v) - cfg.D_crit), min=0.0)
    scale = torch.clamp(masked_median_of_positive(pos, fallback=1e-12), min=1e-12)
    F_div = torch.where(torch.any(pos > 0), torch.clamp(pos / scale, 0.0, 5.0), 0.0)

    F_orog = 1.0 if orog_factor is None else torch.clamp(orog_factor, 1.0, 3.0)
    P_raw = Pq * ((1.0 + cfg.beta_div * F_div) * F_orog)

    # renormalize; the double where keeps the backward finite at all-zero P
    w = grid.area_w
    num = torch.sum(Pq * w)
    den = torch.sum(P_raw * w)
    has_p = den > 0
    P = P_raw * torch.where(has_p, num / torch.where(has_p, den, 1.0), 1.0)

    if smooth_sigma and smooth_sigma > 0:
        P = gaussian_filter(P, smooth_sigma)

    if cfg.p_hybrid_fallback:
        P_dyn = diagnose_precipitation(grid, u, v, cloud_cover, cfg.D_crit, cfg.k_precip,
                                       cloud_threshold=None, smooth_sigma=smooth_sigma)
        blended = (1.0 - cfg.p_blend) * P + cfg.p_blend * P_dyn
        P = torch.where(area_mean(Pq, w) < cfg.pq_min, blended, P)

    return torch.clamp(P, min=0.0)
