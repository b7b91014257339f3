"""Hydrology closure: rain/snow split, snowpack, land bucket, diagnostics
(port of ``qingdai_tpu/physics/hydrology.py``)."""

from __future__ import annotations

import torch

from ..config import HydrologyConfig
from ..ops.reductions import area_mean_compensated


def partition_precip_phase_smooth(P_flux, T_hat_a, T_thresh=273.15, dT_half_K=1.5):
    """Sigmoid split on lapse-adjusted T̂_a → (P_rain, P_snow, f_snow)."""
    f_snow = torch.sigmoid((T_thresh - T_hat_a) / max(1e-6, dT_half_K))
    return (1.0 - f_snow) * P_flux, f_snow * P_flux, f_snow


def snowpack_step(S_snow, P_snow_land, T_hat_a, cfg: HydrologyConfig, dt):
    """SWE update with degree-day or constant melt →
    (S_next, melt_flux, C_snow, alpha_snow_map)."""
    if cfg.snow_melt_mode == "degree_day":
        ddf = cfg.snow_ddf_mm_per_k_day / 86400.0
        melt_flux = ddf * torch.clamp(T_hat_a - cfg.snow_melt_tref_K, min=0.0)
    else:
        rate = cfg.snow_melt_rate_mm_day / 86400.0
        melt_flux = torch.where(T_hat_a >= cfg.snow_thresh_K, torch.full_like(T_hat_a, rate), 0.0)
    pot_melt = melt_flux * dt
    actual = torch.minimum(torch.clamp(S_snow, min=0.0), pot_melt)
    S_next = S_snow + P_snow_land * dt - actual
    if cfg.swe_max_mm is not None and cfg.swe_max_mm > 0:
        S_next = torch.clamp(S_next, max=cfg.swe_max_mm)
    S_next = torch.clamp(S_next, min=0.0)
    melt_out = actual / dt if dt > 0 else torch.zeros_like(actual)
    C_snow = torch.clamp(1.0 - torch.exp(-torch.clamp(S_next, min=0.0)
                                         / max(1e-6, cfg.swe_ref_mm)), 0.0, 1.0)
    alpha_snow = torch.full_like(S_next, cfg.snow_albedo_fresh)
    return S_next, melt_out, C_snow, alpha_snow


def update_land_bucket(W_land, P_in, E_land, cfg: HydrologyConfig, dt):
    """Linear-reservoir bucket with optional capacity overflow → (W_next, runoff)."""
    tau_s = max(1.0, cfg.runoff_tau_days * 86400.0)
    R_base = W_land / tau_s
    W_next = torch.clamp(W_land + (P_in - E_land - R_base) * dt, min=0.0)
    if cfg.wland_cap_mm is not None and cfg.wland_cap_mm > 0:
        overflow = torch.clamp(W_next - cfg.wland_cap_mm, min=0.0)
        W_next = W_next - overflow
        R_fast = overflow / dt if dt > 0 else torch.zeros_like(overflow)
    else:
        R_fast = 0.0
    return W_next, R_base + R_fast


def water_closure_means(area_w, q, rho_a, h_mbl, h_ice, rho_i, W_land, S_snow,
                        E_flux, P_flux, R_flux, mesh=None):
    """Area-weighted reservoir and flux means for the water-closure
    diagnostic, accumulated in float64."""
    wm = lambda x: area_mean_compensated(x, area_w, mesh=mesh)
    CWV_mean = wm(rho_a * h_mbl * q)
    ICE_mean = wm(rho_i * h_ice)
    W_mean = wm(W_land)
    S_mean = wm(S_snow)
    return {
        "CWV_mean": CWV_mean, "ICE_mean": ICE_mean,
        "W_land_mean": W_mean, "S_snow_mean": S_mean,
        "E_mean": wm(E_flux), "P_mean": wm(P_flux), "R_mean": wm(R_flux),
        "total_reservoir_mean": CWV_mean + ICE_mean + W_mean + S_mean,
    }
