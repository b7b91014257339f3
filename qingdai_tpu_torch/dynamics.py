"""Atmosphere core: the stabilized shallow-water grid-point step (port of
``qingdai_tpu/dynamics.py``).

Humidity E/condensation, Newton/energy-blend surface temperature with sea
ice, semi-Lagrangian advection of T_s and q, height relaxation, geostrophic or
primitive momentum, and the filter stack (σ4 ∇⁴, Shapiro, zonal FFT). The
filter cadences depend only on the step index, a host int, so they are
Python ``if``s.
"""

from __future__ import annotations

import torch

from . import constants as const
from .config import SimConfig
from .grid import Grid, grad_lonlat
from .ops.advect import advect_semilag_multi
from .ops.reductions import masked_median_of_positive
from .ops.stencil import (hyperdiffuse_multi, shapiro_filter, shapiro_filter_multi,
                          spectral_zonal_filter)
from .physics import energy as en
from .physics import humidity as hum
from .state import AtmosState, EnergyState, StaticFields


def _every(step_idx: int, n: int) -> bool:
    """The reference's 'every n steps' filter cadence. Its counter is
    incremented before the check, so with a zero-based index the filter fires
    when (step_idx + 1) % n == 0."""
    return n > 0 and (step_idx + 1) % n == 0


def atmos_step(grid: Grid, cfg: SimConfig, static: StaticFields, atmos: AtmosState,
               estate: EnergyState, Teq, albedo, isr, step_idx: int, dt: float):
    """One atmosphere step → (AtmosState, aux flux dict)."""
    dcfg, ecfg, hcfg = cfg.dynamics, cfg.energy, cfg.humidity
    a = const.PLANET_RADIUS
    dlat, dlon = grid.dlat_rad, grid.dlon_rad

    u, v, h = atmos.u, atmos.v, atmos.h
    T_s, cloud, q, h_ice = atmos.T_s, atmos.cloud_cover, atmos.q, atmos.h_ice

    # QD_ENERGY_AUDIT: area-mean energy injected by each non-conservative move
    audit = ecfg.audit
    aud = {}
    wm = ((lambda x: torch.sum(x * grid.area_w) / (torch.sum(grid.area_w) + 1e-15))
          if audit else None)
    H_atm_a = dcfg.atm_h if dcfg.atm_h is not None else hcfg.h_mbl
    kappa = max(1e-6, float(hcfg.rho_a)) * max(1.0, float(H_atm_a)) * dcfg.g
    q_entry = q

    # 1) T_a proxy + humidity physics
    T_a, E_flux, M_col, P_cond, q_next = hum.humidity_block(
        T_s, q, u, v, h, h_ice, static.land_mask, dt, hcfg, dcfg.g)
    LH = hcfg.L_v * E_flux
    LH_release = hcfg.L_v * P_cond
    q = torch.clamp(q_next, 0.0, 0.5)
    if audit:
        aud["aud_hum_resid"] = wm(hcfg.L_v * (M_col * (q - q_entry) / dt - (E_flux - P_cond)))

    # 2) surface temperature: Newton path
    absorbed_old = const.SIGMA * en.pow4(Teq)
    olr_old = const.SIGMA * en.pow4(T_s)
    ilr_old = ecfg.gh_factor * const.SIGMA * en.pow4(T_a)
    net_old = absorbed_old + ilr_old - olr_old
    Ts_newton = T_s + (net_old / max(1e-12, ecfg.c_sfc)) * dt

    # energy path; cloud-optics coupling from RH and P_cond
    if dcfg.cloud_couple:
        qsat_air = hum.q_sat(T_a, p=hcfg.p0)
        RH = torch.clamp(q / torch.clamp(qsat_air, min=1e-12), 0.0, 1.5)
        rh_excess = torch.clamp(RH - dcfg.rh0, min=0.0)
        if dcfg.pcond_ref is not None:
            P_ref = torch.full((), dcfg.pcond_ref, dtype=T_s.dtype, device=T_s.device)
        else:
            P_ref = masked_median_of_positive(P_cond, fallback=1e-6)
        p_term = torch.tanh(torch.where(P_ref > 0, P_cond / P_ref, 0.0))
        cloud_eff = torch.clamp(cloud + dcfg.k_q * rh_excess + dcfg.k_p * p_term, 0.0, 1.0)
    else:
        cloud_eff = cloud

    SW_atm, SW_sfc, R = en.shortwave_radiation(isr, albedo, cloud_eff, ecfg)
    ice_frac = 1.0 - torch.exp(-torch.clamp(h_ice, min=0.0) / max(1e-6, cfg.physics.h_ice_ref))
    if ecfg.lw_v2:
        eps_sfc = en.surface_emissivity_map(static.land_mask, ice_frac, ecfg)
        LW_atm, LW_sfc, OLR, DLR, _ = en.longwave_radiation_v2(
            T_s, T_a, cloud_eff, eps_sfc, ecfg, eps0=estate.lw_eps0)
    else:
        LW_atm, LW_sfc, OLR, DLR, _ = en.longwave_radiation(
            T_s, T_a, cloud_eff, ecfg, eps0=estate.lw_eps0, kc=estate.lw_kc)
    SH, _ = en.boundary_layer_fluxes(T_s, T_a, u, v, static.land_mask, ecfg, rho=hcfg.rho_a)

    if dcfg.seaice_enabled:
        Cs_ocean = cfg.ocean.rho_w * cfg.ocean.cp_w * cfg.run.mld_m
        res = en.integrate_surface_energy_with_seaice(
            T_s, SW_sfc, LW_sfc, SH, LH, dt, static.land_mask, h_ice,
            Cs_ocean, cfg.run.cs_land, cfg.run.cs_ice,
            t_freeze=dcfg.t_freeze, rho_i=dcfg.rho_ice, L_f=dcfg.L_f, t_floor=ecfg.t_floor,
            polar_fix_s=dcfg.polar_freeze_fix_s, polar_fix_n=dcfg.polar_freeze_fix_n,
            audit=audit)
        Ts_energy, h_ice_next = res[0], res[1]
        if audit:
            aud["aud_sfc_resid"] = wm(res[2])
            Cs_eff_out = torch.where(static.land_mask == 1, cfg.run.cs_land,
                                     torch.where(h_ice_next > 0.0, cfg.run.cs_ice,
                                                 torch.full_like(T_s, Cs_ocean)))
    else:
        res = en.integrate_surface_energy_map(T_s, SW_sfc, LW_sfc, SH, LH, dt, static.C_s_map,
                                              t_floor=ecfg.t_floor, audit=audit)
        if audit:
            Ts_energy, sfc_resid = res
            aud["aud_sfc_resid"] = wm(sfc_resid)
            Cs_eff_out = en._safe_capacity(static.C_s_map)
        else:
            Ts_energy = res
        h_ice_next = h_ice

    # blend
    w = min(1.0, max(0.0, dcfg.energy_w))
    T_s = (1.0 - w) * Ts_newton + w * Ts_energy
    h_ice = h_ice_next
    if audit:
        aud["aud_ts_blend"] = wm(Cs_eff_out * (T_s - Ts_energy) / dt)

    # 2b) semi-Lagrangian advection of T_s and q with one shared gather
    adv_alpha = dcfg.adv_alpha
    cos_tiny = grid.coslat_cap_tiny
    Ts_preadv, q_preadv = T_s, q
    adv = advect_semilag_multi(torch.stack([T_s, q]), u, v, dt, a, dlat, dlon, cos_tiny)
    T_s = (1.0 - adv_alpha) * T_s + adv_alpha * adv[0]
    q = torch.clamp((1.0 - adv_alpha) * q + adv_alpha * adv[1], 0.0, 0.5)
    if audit:
        aud["aud_adv_ts"] = wm(Cs_eff_out * (T_s - Ts_preadv) / dt)
        aud["aud_adv_q"] = wm(hcfg.L_v * M_col * (q - q_preadv) / dt)

    # 3) height forcing toward h_eq
    h_eq = (287.0 / dcfg.g) * Teq
    if audit:
        aud["aud_nudge"] = wm(kappa * (h_eq - h) / dcfg.tau_rad)
    h = h + (h_eq - h) / dcfg.tau_rad * dt

    # atmospheric energy → height
    if dcfg.energy_w > 0.0:
        H_atm = dcfg.atm_h if dcfg.atm_h is not None else hcfg.h_mbl
        h = en.integrate_atmos_energy_height(h, SW_atm, LW_atm, SH, LH_release, dt,
                                             rho_air=hcfg.rho_a, H_atm=H_atm, g=dcfg.g,
                                             weight=dcfg.energy_w)
    if audit:
        F_atm = SW_atm + LW_atm + SH + LH_release
        w_cpl = dcfg.energy_w if dcfg.energy_w > 0.0 else 0.0
        aud["aud_uncoupled"] = wm((1.0 - w_cpl) * F_atm)
        aud["aud_part"] = wm((isr - R - OLR) - (SW_sfc - LW_sfc - SH - LH)
                             - F_atm - (LH - LH_release))

    # 4) momentum
    dh_dlon, dh_dlat = grad_lonlat(grid, h)
    f = grid.f
    if dcfg.mom_scheme == "primitive":
        PGF_x = -(dcfg.g / (a * cos_tiny)) * dh_dlon
        PGF_y = -(dcfg.g / a) * dh_dlat
        du = (PGF_x + f * v - static.friction * u) * dt
        dv = (PGF_y - f * u - static.friction * v) * dt
        u = torch.clamp(u + du, -dcfg.max_wind, dcfg.max_wind)
        v = torch.clamp(v + dv, -dcfg.max_wind, dcfg.max_wind)
    else:
        f_min = 2.0 * const.PLANET_OMEGA * torch.sin(
            torch.deg2rad(torch.full((), 5.0, dtype=f.dtype, device=f.device)))
        sign = torch.where(f >= 0.0, torch.ones_like(f), -1.0)
        f_safe = torch.where(torch.abs(f) < f_min, sign * f_min, f)
        u_g = torch.clamp(-(dcfg.g / (f_safe * a * cos_tiny)) * dh_dlat,
                          -dcfg.max_wind, dcfg.max_wind)
        v_g = torch.clamp((dcfg.g / (f_safe * a)) * dh_dlon, -dcfg.max_wind, dcfg.max_wind)
        u = u * 0.8 + u_g * 0.2
        v = v * 0.8 + v_g * 0.2
        u = u + (-static.friction * u) * dt
        v = v + (-static.friction * v) * dt

    # ---- filters, batched across fields ----
    if dcfg.dyn_diag:
        var_pre = (torch.var(u, correction=0), torch.var(v, correction=0),
                   torch.var(h, correction=0))
    if audit:
        h_prefilt, q_prefilt = h, q
    if (dcfg.diff_enable and dcfg.filter_type in ("hyper4", "combo")
            and _every(step_idx, max(1, dcfg.diff_every))):
        k4_base = dcfg.sigma4 * grid.k4_map_unit / max(1e-12, dt)
        # the σ4 maps are > 0, so only an explicit scalar 0 disables q/cloud
        apply_q = dcfg.diff_q or (dcfg.k4_q is None) or (dcfg.k4_q > 0.0)
        apply_c = dcfg.diff_cloud or (dcfg.k4_cloud is None) or (dcfg.k4_cloud > 0.0)

        def _k4_of(override, mult):
            return torch.full_like(k4_base, override) if override is not None else mult * k4_base

        rows = [("u", _k4_of(dcfg.k4_u, 1.0)), ("v", _k4_of(dcfg.k4_v, 1.0)),
                ("h", _k4_of(dcfg.k4_h, 0.5))]
        if apply_q:
            rows.append(("q", _k4_of(dcfg.k4_q, 0.5)))
        if apply_c:
            rows.append(("c", _k4_of(dcfg.k4_cloud, 0.25)))
        field_map = {"u": u, "v": v, "h": h, "q": q, "c": cloud}
        stack = torch.stack([field_map[name] for name, _ in rows])
        k4_stack = torch.stack([k for _, k in rows])
        cos02 = grid.coslat_cap_02
        # the reference substeps u/v/h k4_nsub times but q/cloud once
        if dcfg.k4_nsub <= 1:
            stack = hyperdiffuse_multi(stack, k4_stack, dt, 1, dlat, dlon, cos02, a)
        else:
            uvh = hyperdiffuse_multi(stack[:3], k4_stack[:3], dt, dcfg.k4_nsub,
                                     dlat, dlon, cos02, a)
            if stack.shape[0] > 3:
                qc = hyperdiffuse_multi(stack[3:].contiguous(), k4_stack[3:].contiguous(),
                                        dt, 1, dlat, dlon, cos02, a)
                uvh = torch.cat([uvh, qc])
            stack = uvh
        for i, (name, _) in enumerate(rows):
            field_map[name] = stack[i]
        u, v, h, q, cloud = (field_map[k] for k in ("u", "v", "h", "q", "c"))

    if (dcfg.filter_type in ("shapiro", "combo", "hyper4")
            and _every(step_idx, dcfg.shapiro_every)):
        uvh = shapiro_filter_multi(torch.stack([u, v, h]), n=dcfg.shapiro_n)
        u, v, h = uvh[0], uvh[1], uvh[2]
        if dcfg.diff_q:
            q = shapiro_filter(q, n=max(1, dcfg.shapiro_n - 1))
        if dcfg.diff_cloud:
            cloud = shapiro_filter(cloud, n=max(1, dcfg.shapiro_n - 1))

    if dcfg.filter_type in ("spectral", "combo") and _every(step_idx, dcfg.spec_every):
        u, v, h = (spectral_zonal_filter(x, grid.n_lon, dcfg.spec_cutoff, dcfg.spec_damp)
                   for x in (u, v, h))

    if audit:
        aud["aud_filt"] = wm((kappa * (h - h_prefilt) + hcfg.L_v * M_col * (q - q_prefilt)) / dt)

    # cloud advection + 2-day dissipation
    cloud = advect_semilag_multi(cloud[None], u, v, dt, a, dlat, dlon, cos_tiny)[0]
    cloud = cloud * (1.0 - dt / (2.0 * 24 * 3600))

    # global mild diffusion and NaN scrub
    df = dcfg.diff_factor
    if audit:
        aud["aud_hdamp"] = wm(-kappa * h * (1.0 - df) / dt)
        aud["aud_qdamp"] = wm(-hcfg.L_v * M_col * q * (1.0 - df) / dt)
    u = torch.nan_to_num(u * df)
    v = torch.nan_to_num(v * df)
    h = torch.nan_to_num(h * df)
    cloud = torch.nan_to_num(cloud * df)
    q = torch.nan_to_num(q * df)
    T_s = torch.nan_to_num(T_s)

    new_atmos = AtmosState(u=u, v=v, h=h, T_s=T_s, cloud_cover=cloud, q=q, h_ice=h_ice,
                           E_flux_last=E_flux, P_cond_flux_last=P_cond, LH_last=LH,
                           LH_release_last=LH_release, cloud_eff_last=cloud_eff, olr=OLR)
    aux = {"SW_atm": SW_atm, "SW_sfc": SW_sfc, "R": R, "LW_atm": LW_atm, "LW_sfc": LW_sfc,
           "OLR": OLR, "DLR": DLR, "SH": SH, "LH": LH, "T_a": T_a}
    aux.update(aud)
    if dcfg.dyn_diag:
        aux["dyn_var_u_pre"], aux["dyn_var_v_pre"], aux["dyn_var_h_pre"] = var_pre
        aux["dyn_var_u_post"] = torch.var(u, correction=0)
        aux["dyn_var_v_post"] = torch.var(v, correction=0)
        aux["dyn_var_h_post"] = torch.var(h, correction=0)
    return new_atmos, aux
