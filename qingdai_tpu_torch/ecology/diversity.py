"""α/β biodiversity diagnostics (per-pixel effective species number,
Whittaker β, local Bray-Curtis) with plots and community snapshots (the
port's counterpart of ``qingdai_tpu/ecology/diversity.py``).

The three metrics are torch functions on the device of the abundances they
are given (the card's eco state, or host tensors); the panels, the summary
and the community snapshot are written on the host.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ..parallel.halo import all_gather_lon, single


def _as_tensor(x, like=None):
    """x as a tensor (on ``like``'s device where x is not a tensor yet)."""
    if isinstance(x, torch.Tensor):
        return x
    return torch.as_tensor(np.asarray(x), device=None if like is None else like.device)


def compute_alpha_eff_map(L_s, land_mask):
    """Per-pixel α_eff = exp(Shannon H) over species abundances
    (diversity.py:34-58). NaN over ocean / empty cells."""
    L_s = torch.clamp(_as_tensor(L_s), min=0.0)
    L_tot = torch.sum(L_s, dim=0)
    land = _as_tensor(land_mask, L_s) == 1
    p = L_s / (L_tot[None] + 1e-15)
    H = -torch.sum(p * torch.log(p + 1e-15), dim=0)
    alpha = torch.exp(H)
    return torch.where(land & (L_tot > 0), alpha, torch.nan)


def compute_whittaker_beta(L_s, land_mask, lat_mesh):
    """β = γ_eff / ᾱ with cos(lat) area weights (diversity.py:61-88)."""
    L_s = torch.clamp(_as_tensor(L_s), min=0.0)
    land = _as_tensor(land_mask, L_s) == 1
    lat = _as_tensor(lat_mesh, L_s).to(L_s.dtype)
    w = torch.clamp(torch.cos(torch.deg2rad(lat)), min=0.0)
    w_land = torch.where(land, w, 0.0)
    w_norm = w_land / (torch.sum(w_land) + 1e-15)

    alpha_map = compute_alpha_eff_map(L_s, land_mask)
    alpha_mean = torch.nansum(torch.where(land, alpha_map * w_norm, 0.0))

    T_s = torch.sum(L_s * w_norm[None], dim=(1, 2))
    p_g = T_s / (torch.sum(T_s) + 1e-15)
    gamma_eff = torch.exp(-torch.sum(p_g * torch.log(p_g + 1e-15)))
    beta = gamma_eff / torch.clamp(alpha_mean, min=1e-12)
    return {"alpha_mean": alpha_mean, "gamma_eff": gamma_eff,
            "beta_whittaker": beta, "alpha_map": alpha_map}


def compute_local_bray_curtis(L_s, land_mask):
    """Mean Bray-Curtis dissimilarity to 4-neighbors (diversity.py:91-135),
    vectorized over the four shifts with clipped lat / periodic lon."""
    L_s = torch.clamp(_as_tensor(L_s), min=0.0)
    land = _as_tensor(land_mask, L_s) == 1
    S, H, W = L_s.shape
    sum_a = torch.sum(L_s, dim=0)
    bc_accum = torch.zeros((H, W), dtype=L_s.dtype, device=L_s.device)
    count = torch.zeros((H, W), dtype=L_s.dtype, device=L_s.device)

    def shifted(arr, dj, di):
        out = torch.roll(arr, -di, dims=arr.ndim - 1)
        if dj != 0:
            j = torch.clamp(torch.arange(H, device=arr.device) + dj, 0, H - 1)
            out = torch.index_select(out, arr.ndim - 2, j)
        return out

    for dj, di in [(-1, 0), (1, 0), (0, -1), (0, 1)]:
        L_n = shifted(L_s, dj, di)
        sum_b = torch.sum(L_n, dim=0)
        min_sum = torch.sum(torch.minimum(L_s, L_n), dim=0)
        bc = 1.0 - 2.0 * min_sum / (sum_a + sum_b + 1e-15)
        nbr_land = shifted(land.to(torch.float32), dj, di) > 0.5
        valid = land & nbr_land
        bc_accum = bc_accum + torch.where(valid, bc, 0.0)
        count = count + valid
    bc_mean = torch.where(count > 0, bc_accum / torch.clamp(count, min=1), torch.nan)
    return torch.where(land, bc_mean, torch.nan)


def save_community_npz(L_s, land_mask, t_days, outdir):
    os.makedirs(outdir, exist_ok=True)
    np.savez(os.path.join(outdir, f"community_day_{t_days:05.1f}.npz"),
             L_s=np.asarray(L_s, np.float32),
             land_mask=np.asarray(land_mask, np.int8))


def compute_and_plot(lat, lon, lat_mesh, eco_state, land_mask, t_days,
                     base_output_dir, plot=True, mesh=None) -> dict:
    """Entry point mirroring diversity.compute_and_plot (diversity.py:188-216):
    the metrics on ``eco_state``'s device, then the panels (``plot=False``
    where matplotlib is not installed), the summary and the community
    snapshot under ``<base_output_dir>/ecology``. On a rank of the longitude
    mesh (``mesh``, the rank's columns in) the abundances, the mask and the
    latitudes are gathered whole first, every rank gets the whole planet's
    metrics, and rank 0 writes the files."""
    L_s_dev = torch.sum(torch.clamp(_as_tensor(eco_state.LAI_SK), min=0.0), dim=1)
    if not single(mesh):
        land_mask = all_gather_lon(_as_tensor(land_mask, L_s_dev), mesh).cpu().numpy()
        lat_mesh = all_gather_lon(_as_tensor(lat_mesh, L_s_dev), mesh)
        L_s_dev = all_gather_lon(L_s_dev, mesh)
    wh_dev = compute_whittaker_beta(L_s_dev, land_mask, lat_mesh)
    bc_dev = compute_local_bray_curtis(L_s_dev, land_mask)
    # one transfer: the abundances, the two maps and the three scalars
    scalars = torch.stack([wh_dev[k] for k in ("alpha_mean", "gamma_eff", "beta_whittaker")])
    L_s, alpha_map, bc, sc = (x.cpu().numpy() for x in
                              (L_s_dev, wh_dev["alpha_map"], bc_dev, scalars))
    wh = {"alpha_mean": float(sc[0]), "gamma_eff": float(sc[1]),
          "beta_whittaker": float(sc[2]), "alpha_map": alpha_map}
    if not single(mesh) and mesh.rank != 0:
        return wh
    outdir = os.path.join(base_output_dir, "ecology")
    os.makedirs(outdir, exist_ok=True)

    if plot:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
        for data, name, cmap, label in [
                (alpha_map, "alpha_effective", "viridis", "Effective species number"),
                (bc, "beta_local_braycurtis", "magma", "Bray–Curtis (0..1)")]:
            fig, ax = plt.subplots(figsize=(10, 4.5), constrained_layout=True)
            cs = ax.imshow(data, origin="lower", aspect="auto",
                           extent=[0, 360, -90, 90], cmap=cmap)
            ax.contour(np.asarray(land_mask), levels=[0.5], colors="black",
                       linewidths=0.6, extent=[0, 360, -90, 90], origin="lower")
            ax.set_title(f"{label} — Day {t_days:.2f}")
            fig.colorbar(cs, ax=ax, label=label)
            fig.savefig(os.path.join(outdir, f"{name}_day_{t_days:05.1f}.png"), dpi=140)
            plt.close(fig)

    with open(os.path.join(outdir, f"diversity_summary_day_{t_days:05.1f}.txt"),
              "w", encoding="utf-8") as f:
        f.write(f"Day: {t_days:.2f}\n")
        f.write(f"Whittaker beta (β = γ/ᾱ): {wh['beta_whittaker']:.4f}\n")
        f.write(f"  alpha_mean (ᾱ): {wh['alpha_mean']:.4f}\n")
        f.write(f"  gamma_eff  (γ ): {wh['gamma_eff']:.4f}\n")
    save_community_npz(L_s, land_mask, t_days, outdir)
    return wh
