"""Spectral band machinery (port of ``qingdai_tpu/ecology/spectral.py``).

Band definitions and per-star blackbody weights are host-side NumPy
constants computed once at build time, exactly as in the JAX package; the
per-pixel and per-point dual-star band synthesis and the absorbance of
mutated genes are torch functions used inside the step.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .. import constants as const
from ..config import EcologyConfig

_T_SUN = 5778.0
_H = 6.62607015e-34
_C = 2.99792458e8
_KB = 1.380649e-23


@dataclasses.dataclass(frozen=True)
class SpectralBands:
    """Equally spaced bands in [lam0, lam1] nm (spectral.py:8-55)."""
    nbands: int
    lambda_edges: np.ndarray
    lambda_centers: np.ndarray
    delta_lambda: np.ndarray


def make_bands(cfg: EcologyConfig) -> SpectralBands:
    nb = max(1, int(cfg.nbands))
    edges = np.linspace(cfg.lam0_nm, cfg.lam1_nm, nb + 1)
    centers = 0.5 * (edges[:-1] + edges[1:])
    return SpectralBands(nb, edges, centers, edges[1:] - edges[:-1])


def rayleigh_weight(centers_nm, t0, lref_nm, eta) -> np.ndarray:
    lam = np.maximum(1e-6, centers_nm)
    return np.clip(t0 * (lam / max(1e-6, lref_nm)) ** float(eta), 0.0, None)


def band_weights(bands: SpectralBands, cfg: EcologyConfig) -> np.ndarray:
    """Normalized band weights for scalar reduction (spectral.py:137-161)."""
    if cfg.toa_mode == "rayleigh":
        w = rayleigh_weight(bands.lambda_centers, cfg.rayleigh_t0,
                            cfg.rayleigh_lref_nm, cfg.rayleigh_eta)
    else:
        w = np.ones_like(bands.lambda_centers)
    return w / (w.sum() + 1e-12)


def rayleigh_band_factor(bands: SpectralBands, cfg: EcologyConfig) -> np.ndarray:
    if cfg.toa_mode != "rayleigh":
        return np.ones(bands.nbands)
    return rayleigh_weight(bands.lambda_centers, cfg.rayleigh_t0,
                           cfg.rayleigh_lref_nm, cfg.rayleigh_eta)


def default_leaf_reflectance(bands: SpectralBands) -> np.ndarray:
    """Green-ish template: 0.25 base + green bump (spectral.py:72-84)."""
    c = bands.lambda_centers
    return np.clip(0.25 + 0.15 * np.exp(-((c - 550.0) ** 2) / (2 * 60.0 ** 2)), 0.0, 1.0)


def estimate_teff_from_LM(L_ratio, M_ratio, j=0.8, T_sun=_T_SUN) -> float:
    """T = T_sun (L/L☉)^¼ (M/M☉)^(−j/2) (spectral.py:238-246)."""
    return float(T_sun * (max(L_ratio, 1e-12) ** 0.25)
                 * (max(M_ratio, 1e-12) ** (-0.5 * j)))


def _planck_lambda_nm(T, lambda_nm):
    lam_m = np.maximum(np.asarray(lambda_nm, float) * 1e-9, 1e-20)
    x = np.clip((_H * _C) / (lam_m * _KB * max(1e-12, float(T))), 1e-8, 1e3)
    return np.clip((1.0 / lam_m ** 5) / (np.expm1(x) + 1e-30), 0.0, np.inf)


def blackbody_band_weights(T_eff, bands: SpectralBands) -> np.ndarray:
    w = _planck_lambda_nm(T_eff, bands.lambda_centers) * bands.delta_lambda
    return w / (w.sum() + 1e-30)


def star_band_spectra(bands: SpectralBands, cfg: EcologyConfig):
    """(specA, specB, T_ray): per-star normalized band spectra and the
    Rayleigh factor, the static inputs of the band synthesis below."""
    T_A = cfg.star_a_teff or estimate_teff_from_LM(
        const.L_A / const.L_SUN, const.M_A / const.M_SUN, j=cfg.star_a_j)
    T_B = cfg.star_b_teff or estimate_teff_from_LM(
        const.L_B / const.L_SUN, const.M_B / const.M_SUN, j=cfg.star_b_j)
    specA = blackbody_band_weights(T_A, bands)
    specB = blackbody_band_weights(T_B, bands)
    T_ray = rayleigh_band_factor(bands, cfg)
    return specA, specB, T_ray


def _normalize_to_total(S_b: torch.Tensor, I_tot: torch.Tensor, band_dim: int):
    S_sum = torch.sum(S_b, dim=band_dim)
    eps = 1e-12
    ok = (S_sum > eps) & (I_tot > eps)
    scale = torch.where(ok, I_tot / torch.where(S_sum > eps, S_sum, 1.0), 0.0)
    return S_b * scale.unsqueeze(band_dim)


def dual_star_insolation_to_bands(insA, insB, specA, specB, T_ray):
    """Per-pixel band intensities [NB, H, W] normalized to insA + insB
    (spectral.py:304-426); the spectra are [NB] tensors."""
    S_b = (specA[:, None, None] * insA[None] + specB[:, None, None] * insB[None]) \
        * T_ray[:, None, None]
    return _normalize_to_total(S_b, insA + insB, 0)


def dual_star_insolation_to_bands_points(insA_c, insB_c, specA, specB, T_ray):
    """Per-point band intensities [C, NB]: the same synthesis at C gathered
    cells (the sampled individual pool's cells)."""
    S_b = (specA[None, :] * insA_c[:, None] + specB[None, :] * insB_c[:, None]) \
        * T_ray[None, :]
    return _normalize_to_total(S_b, insA_c + insB_c, 1)


def absorbance_from_peaks(lambda_centers: torch.Tensor, peaks: torch.Tensor) -> torch.Tensor:
    """Band absorbance from Gaussian peaks [P, 3] = (center, width, height)
    (genes.py:95-111), for mutated genes."""
    c = peaks[:, 0][:, None]
    w = torch.clamp(peaks[:, 1], min=1e-3)[:, None]
    h = torch.clamp(peaks[:, 2], 0.0, 1.0)[:, None]
    A = torch.sum(h * torch.exp(-((lambda_centers[None, :] - c) ** 2) / (2.0 * w ** 2)), dim=0)
    return torch.clamp(A, 0.0, 1.0)
