"""Single-layer specific humidity and E–P–LH coupling (port of
``qingdai_tpu/physics/humidity.py``)."""

from __future__ import annotations

import torch

from ..config import HumidityConfig
from ..ops import safegrad

EPSILON = 0.622  # Mw/Md


def q_sat(T, p=1.0e5):
    """Tetens saturation specific humidity over liquid water."""
    T_c = torch.clamp(T - 273.15, -80.0, 60.0)
    e_s = 610.94 * torch.exp(17.625 * T_c / (T_c + 243.04))
    denom = torch.clamp(p - (1.0 - EPSILON) * e_s, min=1.0)
    return torch.clamp(EPSILON * e_s / denom, 0.0, 0.5)


def q_init(Ts, RH0=0.5, p0=1.0e5):
    return min(max(RH0, 0.0), 1.0) * q_sat(Ts, p=p0)


def surface_evaporation_factor(land_mask, h_ice, cfg: HumidityConfig, ice_threshold=1e-6):
    """Per-grid evaporation factor: ocean / sea ice / land."""
    land = land_mask == 1
    ice = (h_ice > ice_threshold) & (~land)
    return torch.where(land, cfg.land_evap_scale,
                       torch.where(ice, cfg.ice_evap_scale,
                                   torch.full_like(h_ice, cfg.ocean_evap_scale)))


def evaporation_flux(Ts, q, u, v, surface_factor, cfg: HumidityConfig):
    """E = ρ_a C_E |V| (q_sat(Ts) − q)+ · S_type."""
    V = safegrad.speed(u, v)
    deficit = torch.clamp(q_sat(Ts, p=cfg.p0) - q, min=0.0)
    return cfg.rho_a * cfg.C_E * V * deficit * surface_factor


def condensation(q, T_a, dt, cfg: HumidityConfig):
    """Supersaturation relaxation → (P_cond_flux, q_next)."""
    qsat_air = q_sat(T_a, p=cfg.p0)
    excess = torch.clamp(q - qsat_air, min=0.0)
    M_col = max(1e-6, float(cfg.rho_a * cfg.h_mbl))
    # tau_cond may be an injected 0-d tensor (an adjoint parameter): clamp it
    # on the device, without a host sync
    tau = cfg.tau_cond
    tau = torch.clamp(tau, min=1e-6) if isinstance(tau, torch.Tensor) else max(1e-6, tau)
    P_cond = (excess / tau) * M_col
    q_next = torch.clamp(q - (P_cond / M_col) * dt, 0.0, 0.5)
    return P_cond, q_next


def humidity_block(T_s, q, u, v, h, h_ice, land_mask, dt, cfg: HumidityConfig, g: float):
    """T_a proxy from h, bulk evaporation, column uptake over M_col,
    supersaturation condensation. Returns (T_a, E_flux, M_col, P_cond, q_next)."""
    T_a = 288.0 + (g / 1004.0) * h
    surf_factor = surface_evaporation_factor(land_mask, h_ice, cfg)
    E_flux = evaporation_flux(T_s, q, u, v, surf_factor, cfg)
    M_col = max(1e-6, float(cfg.rho_a * cfg.h_mbl))
    q_evap = q + (E_flux / M_col) * dt
    P_cond, q_next = condensation(q_evap, T_a, dt, cfg)
    return T_a, E_flux, M_col, P_cond, q_next
