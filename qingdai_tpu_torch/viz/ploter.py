"""Point-level ecology plotting: per-cell species composition and the
individual-pool distributions; the port's copy of
``qingdai_tpu/viz/ploter.py`` (the reference's ``pygcm/ploter.py``), NumPy
only: pass host arrays (a snapshot's eco and individual states, the
individual pool's statics moved to the CPU).

The full reference panel (ploter.py:124-260) is a 3x4 grid over the top-3
species at the queried cell: canopy-height distribution in a neighborhood,
per-individual leaf-area-increment distribution, per-individual root-energy
proxy distribution, and the species lifespan marker.
"""

from __future__ import annotations

import os

import matplotlib
matplotlib.use("Agg")
import matplotlib.pyplot as plt
import numpy as np


def species_height_map(eco_state, s: int, H_scale: float = 10.0):
    """Species-resolved canopy height proxy (ploter.py:57-74):
    H_s = H_scale · Σ_k h_k·LAI_s,k / Σ_k LAI_s,k with h_k = (k+1)/K."""
    LAI_SK = np.asarray(eco_state.LAI_SK)  # [S,K,H,W]
    S, K = LAI_SK.shape[:2]
    s = int(np.clip(s, 0, S - 1))
    L = np.maximum(LAI_SK[s], 0.0)         # [K,H,W]
    hk = (np.arange(K, dtype=float) + 1.0) / K
    num = np.tensordot(hk, L, axes=(0, 0))
    den = L.sum(axis=0) + 1e-12
    return float(H_scale) * (num / den)


def nearest_sampled_cell(indiv_static, j, i):
    """Index of the sampled individual-pool cell closest to (j, i) — L1
    distance in index space like the reference (ploter.py:115-121)."""
    jj = np.asarray(indiv_static.sample_j)
    ii = np.asarray(indiv_static.sample_i)
    d = np.abs(jj - j) + np.abs(ii - i)
    return int(np.argmin(d))


def plot_top3_species_distributions(eco_state, indiv_static, indiv_state,
                                    land_mask, lat_deg, lon_deg, lat, lon,
                                    out_dir, t_days=0.0, nbins=24,
                                    neigh_radius=1, height_scale_m=None):
    """3x4 panel for the top-3 species (by Σ_k LAI at the target cell)
    (ploter.py:124-260): per species row —
      col 1: canopy-height distribution over a (2r+1)² neighborhood
      col 2: per-individual leaf-area increment ΔA = E_day·leaf_area_per_E
      col 3: per-individual root proxy alloc_root·E_day
      col 4: lifespan (days) as a vertical marker with ±20% context window
    """
    if height_scale_m is None:
        height_scale_m = float(os.getenv("QD_ECO_HEIGHT_SCALE_M", "10.0"))
    lat_arr, lon_arr = np.asarray(lat), np.asarray(lon)
    j = int(np.argmin(np.abs(lat_arr - lat_deg)))
    # periodic longitude normalization (ploter.py:20-37)
    x = float(lon_deg) % 360.0
    i = int(np.argmin(np.minimum(np.abs(lon_arr - x),
                                 360.0 - np.abs(lon_arr - x))))
    H, W = np.asarray(land_mask).shape

    L_s = np.maximum(np.asarray(eco_state.LAI_SK), 0.0).sum(axis=1)  # [S,H,W]
    col = L_s[:, j, i]
    order = np.argsort(col)[::-1]
    top3 = np.concatenate([order, np.repeat(order[-1:], 3)])[:3]

    # neighborhood index block for the height histograms (ploter.py:169-172)
    jj = np.clip(np.arange(j - neigh_radius, j + neigh_radius + 1), 0, H - 1)
    ii = np.clip(np.arange(i - neigh_radius, i + neigh_radius + 1), 0, W - 1)
    JJ, II = np.meshgrid(jj, ii, indexing="ij")

    # per-species gene vectors from the packed device arrays
    alloc_root = np.asarray(eco_state.alloc)[:, 0]
    leaf_per_E = np.asarray(eco_state.leaf_area_per_energy)
    lifespan = np.asarray(eco_state.lifespan_days)

    has_samples = indiv_static is not None and indiv_state is not None
    if has_samples:
        ci = nearest_sampled_cell(indiv_static, j, i)
        cell_mask = np.asarray(indiv_static.cell_index) == ci
        sp_id = np.asarray(indiv_static.species_id)
        E_day = np.asarray(indiv_state.E_day)

    fig, axes = plt.subplots(3, 4, figsize=(16, 10), constrained_layout=True)
    for row, s in enumerate(top3):
        s = int(s)
        # 1) canopy height distribution in the neighborhood
        Hs = species_height_map(eco_state, s, height_scale_m)
        vals = Hs[JJ, II].ravel()
        ax = axes[row, 0]
        vals = vals[np.isfinite(vals)]
        if vals.size:
            ax.hist(vals, bins=nbins, color="#6699cc")
        ax.set_title(f"Species {s}: Height (m)")
        ax.set_xlabel("m"); ax.set_ylabel("count")

        if has_samples:
            sel = cell_mask & (sp_id == s)
            E_s = E_day[sel]
            dA = E_s * float(leaf_per_E[s])
            root_proxy = float(alloc_root[s]) * E_s
        else:
            dA = root_proxy = np.array([], float)

        # 2) leaf-area increment distribution
        ax = axes[row, 1]
        if dA.size:
            ax.hist(dA, bins=nbins, color="#55aa55")
        ax.set_title(f"Species {s}: ΔLeaf area (m²/day, indiv)")
        ax.set_xlabel("m²/day"); ax.set_ylabel("count")

        # 3) root development proxy distribution
        ax = axes[row, 2]
        if root_proxy.size:
            ax.hist(root_proxy, bins=nbins, color="#cc8866")
        ax.set_title(f"Species {s}: Root proxy (alloc_root·E)")
        ax.set_xlabel("J-equiv"); ax.set_ylabel("count")

        # 4) lifespan marker
        ax = axes[row, 3]
        val = float(lifespan[s]) if s < lifespan.size else 365.0
        val = val if val > 0 else 365.0
        ax.axvline(val, color="k", lw=2)
        ax.set_xlim(val * 0.8, val * 1.2)
        ax.set_title(f"Species {s}: Lifespan (days)")
        ax.set_xlabel("days"); ax.set_yticks([])

    fig.suptitle(f"Top-3 species distributions at "
                 f"({lat_deg:.2f}°, {lon_deg:.2f}°) — day {t_days:.1f}",
                 fontsize=14)
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir,
                        f"point_ecology_{lat_deg:+05.1f}_{lon_deg:06.1f}"
                        f"_day_{t_days:05.1f}.png")
    fig.savefig(path, dpi=120)
    plt.close(fig)
    return path
