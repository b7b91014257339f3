"""Separable Gaussian smoothing matching scipy.ndimage.gaussian_filter
(port of ``qingdai_tpu/ops/smooth.py``).

Each axis is a pad followed by a sum of shifted slices, taken in the tap order
of the JAX package. No convolution operator is used, so cuDNN's default TF32
convolution never enters the step.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch


@lru_cache(maxsize=32)
def _gauss_kernel(sigma: float, truncate: float = 4.0) -> tuple:
    """scipy-compatible discrete Gaussian kernel."""
    radius = int(truncate * float(sigma) + 0.5)
    x = np.arange(-radius, radius + 1)
    k = np.exp(-0.5 * (x / float(sigma)) ** 2)
    k /= k.sum()
    return tuple(k.tolist())


def _pad1d(F: torch.Tensor, r: int, dim: int, mode: str) -> torch.Tensor:
    n = F.shape[dim]
    if mode == "wrap":
        lo, hi = F.narrow(dim, n - r, r), F.narrow(dim, 0, r)
    elif mode == "nearest":
        lo = F.narrow(dim, 0, 1).repeat_interleave(r, dim=dim)
        hi = F.narrow(dim, n - 1, 1).repeat_interleave(r, dim=dim)
    elif mode == "reflect":  # scipy 'reflect' == symmetric (edge value repeated)
        lo = torch.flip(F.narrow(dim, 0, r), (dim,))
        hi = torch.flip(F.narrow(dim, n - r, r), (dim,))
    else:
        raise ValueError(f"unknown pad mode {mode}")
    return torch.cat([lo, F, hi], dim=dim)


def _conv1d(F: torch.Tensor, kernel: tuple, dim: int, mode: str) -> torch.Tensor:
    r = (len(kernel) - 1) // 2
    if r == 0:
        return F
    Fp = _pad1d(F, r, dim, mode)
    n = F.shape[dim]
    out = torch.zeros_like(F)
    for t, w in enumerate(kernel):
        out = out + w * Fp.narrow(dim, t, n)
    return out


def gaussian_filter(F: torch.Tensor, sigma: float, mode_lat: str = "reflect",
                    mode_lon: str = "reflect", truncate: float = 4.0) -> torch.Tensor:
    """Separable Gaussian blur of a [H, W] field; sigma <= 0 returns F."""
    if sigma is None or sigma <= 0.0:
        return F
    k = _gauss_kernel(float(sigma), truncate)
    out = _conv1d(F, k, 0, mode_lat)
    return _conv1d(out, k, 1, mode_lon)
