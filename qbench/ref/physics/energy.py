"""Explicit energy budget: SW/LW partition, surface integrators, sea ice
(port of ``qingdai_tpu/physics/energy.py``)."""

from __future__ import annotations

import torch

from .. import constants as const
from ..config import EnergyConfig
from ..ops import safegrad
from ..ops.reductions import area_mean_compensated


def pow4(x):
    """x⁴ as (x·x)·(x·x), the evaluation order of jnp's integer power."""
    x2 = x * x
    return x2 * x2


def shortwave_radiation(I, albedo, cloud, cfg: EnergyConfig):
    """I → (SW_atm, SW_sfc, R)."""
    alpha = torch.clamp(albedo, 0.0, 1.0)
    I_c = torch.clamp(I, min=0.0)
    R = I_c * alpha
    A_sw = torch.clamp(cfg.sw_a0 + cfg.sw_kc * torch.clamp(cloud, 0.0, 1.0), 0.0, 0.95)
    SW_atm = I_c * A_sw
    SW_sfc = torch.clamp(I_c - R - SW_atm, min=0.0)
    return SW_atm, SW_sfc, R


def longwave_radiation(Ts, Ta, cloud, cfg: EnergyConfig, eps0=None, kc=None):
    """Gray one-layer LW v1; eps0/kc may be 0-d tensors (autotune state)."""
    sigma = const.SIGMA
    Ts4 = pow4(torch.clamp(Ts, min=0.0))
    Ta4 = pow4(torch.clamp(Ta, min=0.0))
    e0 = cfg.lw_eps0 if eps0 is None else eps0
    k = cfg.lw_kc if kc is None else kc
    eps = torch.clamp(e0 + k * torch.clamp(cloud, 0.0, 1.0), 0.0, 1.0)
    OLR = eps * sigma * Ta4 + (1.0 - eps) * sigma * Ts4
    DLR = eps * sigma * Ta4
    LW_sfc = DLR - sigma * Ts4
    LW_atm = eps * (sigma * Ts4 - 2.0 * sigma * Ta4)
    if cfg.gh_lock:
        g = cfg.gh_factor
        OLR = (1.0 - g) * sigma * Ts4
        DLR = g * sigma * Ts4
        LW_sfc = DLR - sigma * Ts4
    return LW_atm, LW_sfc, OLR, DLR, eps


def surface_emissivity_map(land_mask, ice_frac, cfg: EnergyConfig):
    """Per-grid ε_sfc by surface type, ocean blended toward ice."""
    icf = torch.clamp(ice_frac, 0.0, 1.0)
    eps_ocean_blend = (1.0 - icf) * cfg.eps_ocean + icf * cfg.eps_ice
    return torch.where(land_mask == 1, cfg.eps_land, eps_ocean_blend)


def longwave_radiation_v2(Ts, Ta, cloud_eff, eps_sfc, cfg: EnergyConfig, eps0=None):
    """Cloud-optical-aware LW with surface emissivity."""
    sigma = const.SIGMA
    Ts4 = pow4(torch.clamp(Ts, min=0.0))
    Ta4 = pow4(torch.clamp(Ta, min=0.0))
    e0 = cfg.lw_eps0 if eps0 is None else eps0
    eps_clear = (torch.clamp(e0, 0.0, 1.0) if isinstance(e0, torch.Tensor)
                 else min(max(e0, 0.0), 1.0))
    tau_cloud = cfg.lw_tau0 * torch.clamp(cloud_eff, 0.0, 1.0)
    eps_cloud = torch.clamp(1.0 - torch.exp(-cfg.lw_ktau * tau_cloud), 0.0, 1.0)
    eps_eff = 1.0 - (1.0 - eps_clear) * (1.0 - eps_cloud)
    eps_sfc_arr = torch.clamp(eps_sfc, 0.0, 1.0)
    OLR = eps_eff * sigma * Ta4 + (1.0 - eps_eff) * sigma * eps_sfc_arr * Ts4
    DLR = eps_eff * sigma * Ta4
    LW_sfc = DLR - sigma * eps_sfc_arr * Ts4
    LW_atm = eps_eff * (sigma * eps_sfc_arr * Ts4 - 2.0 * sigma * Ta4)
    if cfg.gh_lock:
        g = cfg.gh_factor
        OLR = (1.0 - g) * sigma * Ts4
        DLR = g * sigma * Ts4
        LW_sfc = DLR - sigma * eps_sfc_arr * Ts4
    return LW_atm, LW_sfc, OLR, DLR, eps_eff


def _safe_capacity(C):
    return torch.where(torch.isfinite(C) & (C > 1e3), C, 1e3)


def integrate_surface_energy_map(Ts, SW_sfc, LW_sfc, SH, LH, dt, C_s_map,
                                 t_floor=150.0, audit=False):
    """Per-grid heat-capacity explicit update; ``audit`` also returns the
    t_floor clamp's energy injection (W/m²)."""
    net = SW_sfc - LW_sfc - SH - LH
    C_s_safe = _safe_capacity(C_s_map)
    Ts_next = Ts + (net / C_s_safe) * dt
    Ts_out = torch.clamp(Ts_next, min=t_floor)
    if audit:
        return Ts_out, C_s_safe * (Ts_out - Ts_next) / dt
    return Ts_out


def integrate_surface_energy_with_seaice(Ts, SW_sfc, LW_sfc, SH, LH, dt, land_mask, h_ice,
                                         Cs_ocean, Cs_land, Cs_ice,
                                         t_freeze=271.35, rho_i=917.0, L_f=3.34e5,
                                         t_floor=150.0, polar_fix_s=True, polar_fix_n=True,
                                         audit=False):
    """Minimal sea-ice thermodynamics: melt, freeze, residual through an
    effective capacity, polar freeze fix at rows 0/−1, ice-top clamp.
    ``audit`` also returns the integrator's energy injection (W/m²)."""
    Q_net = SW_sfc - LW_sfc - SH - LH
    land = land_mask == 1
    ocean = ~land

    # melt
    melt_mask = (h_ice > 0.0) & ocean & (Q_net > 0.0)
    dh_melt = torch.where(melt_mask, Q_net * dt / (rho_i * L_f), 0.0)
    dh_cap = torch.minimum(dh_melt, torch.clamp(h_ice, min=0.0))
    h_ice1 = h_ice - dh_cap
    Q1 = Q_net - torch.where(melt_mask, dh_cap * rho_i * L_f / dt, 0.0)

    # freeze
    freeze_mask = ocean & (Q1 < 0.0) & (Ts <= (t_freeze + 0.5))
    dh_freeze = torch.where(freeze_mask, -Q1 * dt / (rho_i * L_f), 0.0)
    h_ice2 = h_ice1 + dh_freeze
    Q2 = torch.where(freeze_mask, 0.0, Q1)
    Ts1 = torch.where(freeze_mask, torch.clamp(Ts, max=t_freeze), Ts)

    # residual energy through the effective capacity
    def capacity(h):
        return _safe_capacity(torch.where(land, Cs_land,
                                          torch.where(h > 0.0, Cs_ice,
                                                      torch.full_like(Ts, Cs_ocean))))

    Cs_eff = capacity(h_ice2)
    Ts2 = Ts1 + (Q2 / Cs_eff) * dt

    # polar freeze fix: net-cooling polar-row ocean above freezing → t_freeze
    rows = torch.arange(Ts.shape[0], device=Ts.device)[:, None]
    polar_rows = torch.zeros_like(rows, dtype=torch.bool)
    if polar_fix_s:
        polar_rows = polar_rows | (rows == 0)
    if polar_fix_n:
        polar_rows = polar_rows | (rows == Ts.shape[0] - 1)
    pin = polar_rows & ocean & (Q2 < 0.0) & (Ts2 > t_freeze)
    Ts2 = torch.where(pin, t_freeze, Ts2)

    Ts3 = torch.where((h_ice2 > 0.0) & ocean, torch.clamp(Ts2, max=t_freeze), Ts2)
    Ts3 = torch.clamp(Ts3, min=t_floor)
    h_ice_out = torch.clamp(h_ice2, min=0.0)
    if audit:
        Cs_in = capacity(h_ice)
        dE_actual = (Cs_eff * (Ts3 - Ts) + (Cs_eff - Cs_in) * Ts
                     - rho_i * L_f * (h_ice_out - h_ice))
        return Ts3, h_ice_out, dE_actual / dt - Q_net
    return Ts3, h_ice_out


def boundary_layer_fluxes(Ts, Ta, u, v, land_mask, cfg: EnergyConfig, rho=1.2):
    """Bulk SH + Bowen-ratio LH."""
    V = safegrad.speed(u, v)
    SH = rho * cfg.cp_air * cfg.C_H * V * (Ts - Ta)
    B = torch.clamp(torch.where(land_mask == 1, cfg.bowen_land,
                                torch.full_like(Ts, cfg.bowen_ocean)), min=1e-3)
    return SH, SH / B


def integrate_atmos_energy_height(h, SW_atm, LW_atm, SH, LH_release, dt,
                                  rho_air, H_atm, g=9.81, weight=1.0):
    """dh/dt = F_atm / (ρ_a H_atm g), weighted."""
    F_atm = SW_atm + LW_atm + SH + LH_release
    denom = max(1e-6, float(rho_air)) * max(1.0, float(H_atm)) * float(g)
    return h + weight * (F_atm / denom) * dt


def energy_diagnostics(area_w, I, R, OLR, SW_sfc, LW_sfc, SH, LH, mesh=None):
    """Area-weighted TOA/SFC/ATM budget scalars with float64 accumulation
    (on a mesh, over the whole field)."""
    wm = lambda x: area_mean_compensated(x, area_w, mesh=mesh)
    toa = wm(I - R - OLR)
    sfc = wm(SW_sfc - LW_sfc - SH - LH)
    return {
        "TOA_net": toa, "SFC_net": sfc, "ATM_net": toa - sfc,
        "I_mean": wm(I), "R_mean": wm(R), "OLR_mean": wm(OLR),
        "SW_sfc_mean": wm(SW_sfc), "LW_sfc_mean": wm(LW_sfc),
        "SH_mean": wm(SH), "LH_mean": wm(LH),
    }


def autotune_greenhouse(eps0, kc, toa_net, cfg: EnergyConfig,
                        bounds_eps=(0.30, 0.98), bounds_kc=(0.0, 0.80)):
    """One greenhouse autotune controller step on 0-d tensors."""
    eps0n = torch.clamp(eps0 - cfg.tune_rate_eps * toa_net, bounds_eps[0], bounds_eps[1])
    kcn = torch.clamp(kc - cfg.tune_rate_kc * toa_net, bounds_kc[0], bounds_kc[1])
    return eps0n, kcn
