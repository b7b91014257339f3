"""Diagnostic imagery: state panels, TrueColor, ocean, ecology, plankton
(the port's counterpart of ``qingdai_tpu/viz/plots.py``).

Host-side rendering from a host snapshot, matching the reference's output
set (run_simulation.py:330-1061): multi-panel state plot, TrueColor composite
with sea-ice/snow/vegetation/ocean-color/cloud overlays, ocean panel,
ecology panel, plankton maps, per-star ISR components. ``world`` is a
namespace of ``state`` (the state's leaves as NumPy arrays), ``cfg``,
``model`` (the port's model, on its device), ``land_mask``, ``elevation``,
``lat`` and ``lon``; the insolation and the banded albedo come from the
port's torch functions on the model's device. The world driver renders on
its IO worker, off the chunk loop.
"""

from __future__ import annotations

import os
import sys

import matplotlib
matplotlib.use("Agg")
import matplotlib.pyplot as plt
import numpy as np
import torch


def _host(x):
    """A NumPy array of x (a tensor on any device, an array or a number)."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _insolation(world):
    """(insA, insB) host arrays of the per-star insolation at the
    snapshot's phases, from the port's forcing on the model's device."""
    from ..physics import forcing
    grid = world.model.grid
    clock = world.state.clock
    phases = (torch.as_tensor(np.asarray(getattr(clock, k)), device=grid.lat_rad.device)
              for k in ("phase_rot", "phase_binary", "phase_planet"))
    return tuple(_host(x) for x in forcing.insolation_components_from_phases(grid, *phases))


def _imshow(ax, data, title, cmap="viridis", vmin=None, vmax=None, land=None):
    im = ax.imshow(np.asarray(data), origin="lower", aspect="auto", cmap=cmap,
                   vmin=vmin, vmax=vmax, extent=[0, 360, -90, 90])
    ax.set_title(title, fontsize=8)
    ax.tick_params(labelsize=6)
    plt.colorbar(im, ax=ax, fraction=0.035, pad=0.02)
    if land is not None:
        ax.contour(np.asarray(land), levels=[0.5], colors="k",
                   linewidths=0.4, extent=[0, 360, -90, 90], origin="lower")


def plot_state(world, t_days: float, out_dir: str) -> str:
    """Multi-panel instantaneous state (run_simulation.py:330-537).

    The pressure panel follows QD_PLOT_PS_MODE (run_simulation.py:369-380):
    "anom" = ρ_a·g·h/100 hPa anomaly, "abs" = (p0 + ρ_a·g·h)/100 hPa. (The
    reference's separate T_a panel is an affine map of the same h field,
    T_a = 288 + (g/cp)·h — one of the pair carries all the information.)
    """
    st = world.state
    land = np.asarray(world.land_mask)
    atmos = st.atmos
    viz = world.cfg.viz
    fig, axes = plt.subplots(4, 4, figsize=(20, 12))
    ax = axes.ravel()
    _imshow(ax[0], atmos.T_s, "T_s (K)", "RdBu_r", land=land)
    spd = np.hypot(np.asarray(atmos.u), np.asarray(atmos.v))
    _imshow(ax[1], spd, "|V| wind (m/s)", "magma", land=land)
    rho_a = world.cfg.humidity.rho_a
    p0 = world.cfg.humidity.p0
    if viz.ps_mode == "abs":
        ps = (p0 + rho_a * 9.81 * np.asarray(atmos.h)) * 1e-2
        _imshow(ax[2], ps, "Ps (hPa, diag)", "viridis", land=land)
    else:
        ps = rho_a * 9.81 * np.asarray(atmos.h) * 1e-2
        _imshow(ax[2], ps, "Ps anomaly (hPa)", "RdBu_r", land=land)
    _imshow(ax[3], atmos.cloud_cover, "cloud cover", "Greys_r", 0, 1, land=land)
    _imshow(ax[4], np.asarray(st.clock.precip_day_last), "precip (last day, mm)",
            "Blues", land=land)
    _imshow(ax[5], atmos.q * 1000, "q (g/kg)", "BuGn", land=land)
    _imshow(ax[6], atmos.h_ice, "h_ice (m)", "cool", land=land)
    _imshow(ax[7], atmos.olr, "OLR (W/m²)", "inferno", land=land)
    ocn = st.ocean
    _imshow(ax[8], ocn.sst, "SST (K)", "RdBu_r", land=land)
    ospd = np.hypot(np.asarray(ocn.uo), np.asarray(ocn.vo))
    _imshow(ax[9], ospd, "|V| ocean (m/s)", "magma", land=land)
    _imshow(ax[10], ocn.eta, "η (m)", "RdBu", land=land)
    _imshow(ax[11], st.land.W_land, "W_land (mm)", "YlGnBu", land=land)
    _imshow(ax[12], st.land.S_snow, "SWE (mm)", "PuBu", land=land)
    if st.eco is not None:
        lai = np.asarray(st.eco.LAI_SK).sum(axis=(0, 1))
        _imshow(ax[13], np.where(land == 1, lai, np.nan), "LAI", "YlGn", land=land)
    else:
        ax[13].axis("off")
    if st.routing is not None:
        fa = np.asarray(st.routing.flow_accum_kgps).reshape(land.shape)
        _imshow(ax[14], np.log10(np.maximum(fa, 1.0)),
                "log10 river flow (kg/s)", "Blues", land=land)
    else:
        ax[14].axis("off")
    if st.phyto is not None:
        chl = np.asarray(st.phyto.C_phyto).sum(axis=0)
        _imshow(ax[15], np.where(land == 0, chl, np.nan), "Chl (mg/m³)",
                "viridis", land=land)
    else:
        ax[15].axis("off")
    fig.suptitle(f"Qingdai state — day {t_days:.1f}", fontsize=12)
    fig.tight_layout()
    path = os.path.join(out_dir, f"state_day_{t_days:07.1f}.png")
    fig.savefig(path, dpi=90)
    plt.close(fig)
    return path


def plot_true_color(world, t_days: float, out_dir: str) -> str:
    """TrueColor composite with ice/snow/vegetation/ocean-color/cloud/river
    overlays, driven by the QD_TRUECOLOR_* / QD_OC_* / QD_PLOT_* knob surface
    (run_simulation.py:539-778; defaults in config.VizConfig)."""
    st = world.state
    viz = world.cfg.viz
    land = np.asarray(world.land_mask) == 1
    H, W = land.shape
    rgb = np.zeros((H, W, 3))

    # base colors (run_simulation.py:549-556)
    ocean_color = np.array([0.10, 0.20, 0.50])
    land_color = np.array([0.40, 0.30, 0.20])
    ice_color = np.array([0.90, 0.90, 0.95])
    rgb[~land] = ocean_color
    elev = np.asarray(world.elevation) if world.elevation is not None else np.zeros((H, W))
    e = np.clip(np.maximum(elev, 0) / 4000.0, 0, 1)
    land_col = land_color[None, None, :] * (1.0 + 0.35 * e[..., None])
    rgb[land] = np.clip(land_col, 0, 1)[land]

    # spectral color machinery (run_simulation.py:600-720): per-band surface
    # reflectance → RGB via Gaussian color-matching weights, modulated by the
    # irradiance-relative band weights of the two suns at this instant —
    # vegetation color literally follows the evolved genes' reflectance
    es = getattr(world.model, "eco_static", None)
    w_rel = None
    if es is not None:
        from ..ecology.spectral import dual_star_insolation_to_bands
        insA, insB = _insolation(world)
        dev = es.specA.device
        I_b = _host(dual_star_insolation_to_bands(
            torch.as_tensor(insA, device=dev), torch.as_tensor(insB, device=dev),
            es.specA, es.specB, es.T_ray))      # [NB,H,W]
        I_tot = np.maximum(np.asarray(insA) + np.asarray(insB), 0.0)
        # night side keeps zero weights → reflected color goes dark, which is
        # what draws the terminator (run_simulation.py:616-621)
        w_rel = np.where(I_tot[None] > 1e-12, I_b / (I_tot[None] + 1e-12), 0.0)
        lam = _host(es.lambda_centers)

        def _cw(mu, sig):
            w = np.exp(-((lam - mu) ** 2) / (2.0 * sig ** 2))
            return w / (w.sum() + 1e-12)
        wr, wg, wb = _cw(610.0, 50.0), _cw(550.0, 40.0), _cw(460.0, 40.0)

        def _bands_to_rgb(A, gamma, sat=1.0):
            chans = [np.nansum(A * (w[:, None, None] * w_rel), axis=0)
                     for w in (wr, wg, wb)]
            out = np.clip(np.stack(chans, -1), 0.0, 1.0)
            if gamma > 0:
                out = out ** (1.0 / gamma)
            if sat != 1.0:  # saturation shaping (run_simulation.py:639-646)
                m = np.mean(out, axis=-1, keepdims=True)
                out = np.clip(m + sat * (out - m), 0.0, 1.0)
            return out

    # sea-ice from thickness → optical ice fraction, rendered as solid ice
    # where coverage exceeds QD_TRUECOLOR_ICE_FRAC (run_simulation.py:558-564)
    h_ice_ref = world.cfg.physics.h_ice_ref
    ice_frac = 1.0 - np.exp(-np.maximum(np.asarray(st.atmos.h_ice), 0)
                            / max(1e-6, h_ice_ref))
    sea_ice_mask = (~land) & (ice_frac >= viz.truecolor_ice_frac)

    # vegetation: banded surface albedo where ecology is active
    # (QD_ECO_TRUECOLOR_VEG, run_simulation.py:581-651)
    k_canopy = world.cfg.ecology.k_canopy
    if viz.eco_truecolor_veg and st.eco is not None:
        lai = np.asarray(st.eco.LAI_SK).sum(axis=(0, 1))
        f = 1.0 - np.exp(-k_canopy * np.maximum(lai, 0))
        if es is not None:
            from types import SimpleNamespace
            from ..ecology import population as pop_mod
            eco_t = SimpleNamespace(**{k: torch.as_tensor(np.asarray(getattr(st.eco, k)),
                                                          device=es.land.device)
                                       for k in ("LAI_SK", "active", "species_weights",
                                                 "R_leaf")})
            A_veg = _host(pop_mod.surface_albedo_bands(es, eco_t, world.cfg.ecology))
            veg = _bands_to_rgb(np.nan_to_num(A_veg), viz.eco_truecolor_gamma,
                                viz.eco_truecolor_sat)
        else:
            veg = np.stack([0.10 + 0 * f, 0.35 + 0.25 * f, 0.10 + 0 * f], -1)
        a = np.clip(f, 0.0, 1.0)[..., None]
        rgb = np.where(land[..., None], (1 - a) * rgb + a * veg, rgb)

    # ocean color overlay from phyto banded reflectance on OPEN ocean only
    # (QD_PLOT_OCEANCOLOR / QD_OC_GAMMA / QD_OC_BLEND, run_simulation.py:655-721)
    if viz.plot_oceancolor and st.phyto is not None:
        if es is not None:
            water = _bands_to_rgb(np.asarray(st.phyto.alpha_bands), viz.oc_gamma)
        else:
            chl = np.asarray(st.phyto.C_phyto).sum(axis=0)
            g = np.clip(chl / 2.0, 0, 1)
            water = np.stack([0.05 + 0.05 * g, 0.15 + 0.45 * g, 0.35 - 0.1 * g], -1)
        m = (~land) & (~sea_ice_mask)
        blend = viz.oc_blend
        rgb[m] = ((1 - blend) * rgb + blend * water)[m]

    # solid sea-ice tiles (after ocean color, run_simulation.py:564)
    rgb = np.where(sea_ice_mask[..., None], ice_color, rgb)

    # land snow from optical cover C_snow (QD_TRUECOLOR_SNOW_BY_SWE,
    # QD_SNOW_COVER_FRAC, QD_SNOW_VIS_ALPHA; run_simulation.py:566-579)
    C_snow = np.nan_to_num(np.asarray(st.land.C_snow))
    if viz.truecolor_snow_by_swe:
        m = land & (C_snow >= viz.snow_cover_frac)
        a = (viz.snow_vis_alpha * np.clip(C_snow, 0.0, 1.0))[..., None]
        rgb = np.where(m[..., None], (1 - a) * rgb + a * ice_color, rgb)
    if viz.truecolor_snow_by_ts:  # legacy Ts-threshold whitening (:723-727)
        m = land & (np.asarray(st.atmos.T_s)
                    <= world.cfg.hydrology.snow_thresh_K)
        rgb = np.where(m[..., None], 0.97 * ice_color, rgb)

    # rivers and lakes (QD_PLOT_RIVERS / QD_RIVER_* / QD_LAKE_ALPHA,
    # run_simulation.py:735-754)
    if st.routing is not None and viz.plot_rivers:
        fa = np.asarray(st.routing.flow_accum_kgps).reshape(H, W)
        rm = (land & (fa >= viz.river_min_kgps)).astype(float)[..., None]
        river_color = np.array([0.05, 0.35, 0.90])
        rgb = rgb * (1.0 - viz.river_alpha * rm) + river_color * (viz.river_alpha * rm)
    rs = getattr(world.model, "routing_static", None)
    if rs is not None:
        lake = _host(rs.lake_mask_flat).reshape(H, W)
        lm = (lake & land).astype(float)[..., None]
        lake_color = np.array([0.15, 0.55, 0.95])
        rgb = rgb * (1.0 - viz.lake_alpha * lm) + lake_color * (viz.lake_alpha * lm)

    # clouds (QD_TRUECOLOR_CLOUD_ALPHA/WHITE, run_simulation.py:729-733)
    cloud = np.clip(np.asarray(st.atmos.cloud_cover), 0, 1)
    a = (viz.truecolor_cloud_alpha * cloud)[..., None]
    rgb = (1 - a) * rgb + a * viz.truecolor_cloud_white

    # day/night from current insolation phase (approximate: use isr proxy via Ts? skip shading)
    fig, axp = plt.subplots(figsize=(12, 6))
    axp.imshow(np.clip(rgb, 0, 1), origin="lower", aspect="auto",
               extent=[0, 360, -90, 90])
    axp.set_title(f"Qingdai TrueColor — day {t_days:.1f}")
    path = os.path.join(out_dir, f"truecolor_day_{t_days:07.1f}.png")
    fig.savefig(path, dpi=110, bbox_inches="tight")
    plt.close(fig)

    # console echo consistent with the [SeaIce] logs (run_simulation.py:771-777)
    w = np.maximum(np.cos(np.deg2rad(_host(world.model.grid.lat_mesh))), 0.0)
    h_ice = np.asarray(st.atmos.h_ice)
    area = float((w * sea_ice_mask).sum() / (w.sum() + 1e-15))
    mean_h = float(h_ice[sea_ice_mask].mean()) if sea_ice_mask.any() else 0.0
    print(f"[TrueColor] sea_ice_area≈{area:.3f}, mean_h_ice={mean_h:.3f} m "
          f"(thr={viz.truecolor_ice_frac}, alpha={viz.truecolor_cloud_alpha})")
    return path


def plot_isr_components(world, t_days: float, out_dir: str) -> str:
    """Per-star shortwave components (diag_isr / run_simulation.py:1012-1061)."""
    insA, insB = _insolation(world)
    fig, axes = plt.subplots(1, 3, figsize=(16, 4))
    _imshow(axes[0], insA, "ISR star A (W/m²)", "inferno")
    _imshow(axes[1], insB, "ISR star B (W/m²)", "inferno")
    _imshow(axes[2], np.asarray(insA) + np.asarray(insB), "ISR total", "inferno")
    path = os.path.join(out_dir, f"isr_day_{t_days:07.1f}.png")
    fig.savefig(path, dpi=90, bbox_inches="tight")
    plt.close(fig)
    return path


def plot_ocean(world, t_days: float, out_dir: str) -> str:
    """Ocean panel: SST (°C) contours + sub-sampled current quiver over the
    speed field (run_simulation.py:780-826 — defined but never dispatched by
    the reference driver; here gated by QD_PLOT_OCEAN)."""
    st = world.state
    lat, lon = np.asarray(world.lat), np.asarray(world.lon)
    land = np.asarray(world.land_mask)
    ocn = st.ocean
    fig, (ax1, ax2) = plt.subplots(1, 2, figsize=(18, 6),
                                   constrained_layout=True)
    sst_c = np.nan_to_num(np.asarray(ocn.sst) - 273.15)
    cs = ax1.contourf(lon, lat, sst_c, levels=20, cmap="coolwarm")
    ax1.contour(lon, lat, land, levels=[0.5], colors="black", linewidths=0.7)
    ax1.set_title(f"SST (°C) at Day {t_days:.2f}")
    ax1.set_xlabel("Longitude"); ax1.set_ylabel("Latitude")
    fig.colorbar(cs, ax=ax1, label="°C")

    uo, vo = np.nan_to_num(np.asarray(ocn.uo)), np.nan_to_num(np.asarray(ocn.vo))
    speed = np.hypot(uo, vo)
    sp = ax2.contourf(lon, lat, speed, levels=20, cmap="viridis")
    s_lat = max(1, len(lat) // 30)
    s_lon = max(1, len(lon) // 30)
    lon_m, lat_m = np.meshgrid(lon, lat)
    ax2.quiver(lon_m[::s_lat, ::s_lon], lat_m[::s_lat, ::s_lon],
               uo[::s_lat, ::s_lon], vo[::s_lat, ::s_lon],
               color="white", scale=400, width=0.002)
    ax2.contour(lon, lat, land, levels=[0.5], colors="black", linewidths=0.7)
    ax2.set_title(f"Ocean Currents (m/s) at Day {t_days:.2f}")
    ax2.set_xlabel("Longitude"); ax2.set_ylabel("Latitude")
    fig.colorbar(sp, ax=ax2, label="m/s")
    path = os.path.join(out_dir, f"ocean_day_{t_days:07.1f}.png")
    fig.savefig(path, dpi=90)
    plt.close(fig)
    return path


def plot_ecology(world, t_days: float, out_dir: str) -> str:
    """Ecology panel: LAI, ecological albedo, species dominance, seed bank
    (run_simulation.py:2437-2477)."""
    st = world.state
    if st.eco is None:
        return ""
    land = np.asarray(world.land_mask) == 1
    eco = st.eco
    LAI_SK = np.asarray(eco.LAI_SK)                  # [S,K,H,W]
    lai_s = LAI_SK.sum(axis=1)                       # [S,H,W]
    lai = lai_s.sum(axis=0)
    dom = np.argmax(lai_s, axis=0).astype(float)
    dom[~land] = np.nan
    # canopy height proxy: H = scale · Σ_k h_k·LAI_k / Σ_k LAI_k with
    # h_k = (k+1)/K (ploter.py:57-74 / pop.canopy_height_map)
    K = LAI_SK.shape[1]
    hk = (np.arange(K) + 1.0) / K
    LAI_k = np.maximum(LAI_SK, 0.0).sum(axis=0)      # [K,H,W]
    canopy_h = (world.cfg.viz.eco_height_scale_m
                * np.tensordot(hk, LAI_k, axes=(0, 0))
                / (LAI_k.sum(axis=0) + 1e-12))
    fig, axes = plt.subplots(2, 3, figsize=(19, 8))
    _imshow(axes[0, 0], np.where(land, lai, np.nan), "total LAI", "YlGn")
    _imshow(axes[0, 1], np.asarray(st.albedo.alpha_ecology_last),
            "ecology albedo", "pink")
    _imshow(axes[0, 2], np.where(land, canopy_h, np.nan),
            "canopy height (m)", "copper")
    _imshow(axes[1, 0], dom, "dominant species id", "tab20")
    _imshow(axes[1, 1], np.where(land, np.asarray(eco.seed_bank), np.nan),
            "seed bank", "YlOrBr")
    ab = np.asarray(st.albedo.alpha_banded_daily)
    if ab.ndim == 3:  # [NB,H,W] daily banded cache → scalar reduce for panel
        ab = np.nanmean(ab, axis=0)
    _imshow(axes[1, 2], ab, "banded albedo (band mean)", "bone")
    fig.suptitle(f"Ecology — day {t_days:.1f}")
    path = os.path.join(out_dir, f"ecology_day_{t_days:07.1f}.png")
    fig.savefig(path, dpi=90, bbox_inches="tight")
    plt.close(fig)
    return path


def plot_plankton(world, t_days: float, out_dir: str) -> str:
    """Plankton overview panel + raw per-species density maps.

    The overview mirrors our state-panel style; the per-species maps follow
    plot_plankton_species (run_simulation.py:828-906): raw C_phyto_s in
    mg Chl/m³, land masked to NaN, vmin=0, vmax from QD_PHYTO_VMAX or the
    99th percentile of ocean values, written to <out_dir>/plankton/."""
    st = world.state
    if st.phyto is None:
        return ""
    viz = world.cfg.viz
    land = np.asarray(world.land_mask) == 1
    C = np.asarray(st.phyto.C_phyto)
    fig, axes = plt.subplots(2, 2, figsize=(14, 8))
    _imshow(axes[0, 0], np.where(~land, C.sum(0), np.nan), "total Chl (mg/m³)", "viridis")
    _imshow(axes[0, 1], np.where(~land, C[0], np.nan), "species 0 Chl", "viridis")
    _imshow(axes[1, 0], np.where(~land, np.asarray(st.phyto.Kd_490), np.nan),
            "Kd(490) (1/m)", "plasma")
    _imshow(axes[1, 1], np.where(~land, np.asarray(st.phyto.alpha_scalar), np.nan),
            "ocean-color albedo", "cividis")
    fig.suptitle(f"Plankton — day {t_days:.1f}")
    path = os.path.join(out_dir, f"plankton_day_{t_days:07.1f}.png")
    fig.savefig(path, dpi=90, bbox_inches="tight")
    plt.close(fig)

    # per-species raw density maps (run_simulation.py:846-906 writes species
    # 0/1; we write every active species)
    sp_dir = os.path.join(out_dir, "plankton")
    os.makedirs(sp_dir, exist_ok=True)
    for s in range(C.shape[0]):
        field = C[s].astype(float).copy()
        field[land] = np.nan
        if viz.phyto_vmax is not None:
            vmax = viz.phyto_vmax
        else:
            with np.errstate(all="ignore"):
                vmax = float(np.nanpercentile(field, 99.0))
        if not np.isfinite(vmax) or vmax <= 0.0:
            vmax = 1.0e-3
        figs, axs = plt.subplots(figsize=(10, 5), constrained_layout=True)
        im = axs.contourf(np.asarray(world.lon), np.asarray(world.lat), field,
                          levels=np.linspace(0.0, vmax, 21), cmap="viridis",
                          extend="max")
        axs.contour(np.asarray(world.lon), np.asarray(world.lat),
                    np.asarray(world.land_mask), levels=[0.5], colors="black",
                    linewidths=0.5)
        axs.set_title(f"Plankton species {s} (mg Chl/m³) at Day {t_days:.2f}")
        figs.colorbar(im, ax=axs, label="mg Chl/m³")
        figs.savefig(os.path.join(
            sp_dir, f"plankton_s{s}_day_{t_days:07.1f}.png"), dpi=90)
        plt.close(figs)
    return path


def plot_all(world, t_days: float, out_dir: str):
    os.makedirs(out_dir, exist_ok=True)
    cfg = world.cfg
    plot_state(world, t_days, out_dir)
    plot_true_color(world, t_days, out_dir)
    if cfg.viz.plot_ocean and cfg.ocean.enabled:
        plot_ocean(world, t_days, out_dir)
    if cfg.run.eco_plot and world.state.eco is not None:
        path = plot_ecology(world, t_days, out_dir)
        # macOS-only convenience: auto-open the first ecology panel
        # (QD_ECO_OPEN, run_simulation.py:2478-2484)
        if cfg.viz.eco_open and sys.platform == "darwin" and path:
            os.system(f"open '{path}'")
    if cfg.run.plot_phyto and world.state.phyto is not None:
        plot_plankton(world, t_days, out_dir)
    if cfg.run.plot_isr:
        plot_isr_components(world, t_days, out_dir)
