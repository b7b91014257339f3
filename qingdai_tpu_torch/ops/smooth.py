"""Separable Gaussian smoothing matching scipy.ndimage.gaussian_filter
(port of ``qingdai_tpu/ops/smooth.py``).

Each axis is a pad followed by a sum of shifted slices, taken in the tap order
of the JAX package. No convolution operator is used, so cuDNN's default TF32
convolution never enters the step.

On a rank of the longitude mesh the lon pass pads the rank's columns with
``int(truncate·σ + 0.5)`` columns of its neighbours (``parallel.halo``;
the lon mode applies only at the global seam) and takes the same taps, so
the rank's columns are the whole grid's bit for bit.

``gaussian_filter`` picks by what it observes: a CUDA tensor on one rank goes
to kernel K6 (``kernels/gauss_sep.py``, both axes in one launch, bit-equal to
the plain version on the card) through ``GaussianFilter``; a CPU tensor or a
rank of the mesh goes to ``gaussian_filter_plain``.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from ..kernels import use_kernel
from ..parallel.halo import pad_lon, single
from .members import members_first, plain_vjp, refuse_grad


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


def _taps(Fp: torch.Tensor, kernel: tuple, dim: int, n: int) -> torch.Tensor:
    """Σ_t kernel[t]·Fp[t : t + n] along ``dim`` of the padded field."""
    out = torch.zeros_like(Fp.narrow(dim, 0, n))
    for t, w in enumerate(kernel):
        out = out + w * Fp.narrow(dim, t, n)
    return out


def _conv1d(F: torch.Tensor, kernel: tuple, dim: int, mode: str) -> torch.Tensor:
    r = (len(kernel) - 1) // 2
    if r == 0:
        return F
    return _taps(_pad1d(F, r, dim, mode), kernel, dim, F.shape[dim])


def gaussian_filter_plain(F: torch.Tensor, sigma: float, mode_lat: str = "reflect",
                          mode_lon: str = "reflect", truncate: float = 4.0,
                          mesh=None) -> torch.Tensor:
    """Plain version of kernel K6: separable Gaussian blur of a [H, W] field;
    sigma <= 0 returns F. On a rank of ``mesh``, the rank's columns of the
    whole field's blur."""
    if sigma is None or sigma <= 0.0:
        return F
    k = _gauss_kernel(float(sigma), truncate)
    out = _conv1d(F, k, 0, mode_lat)
    r = (len(k) - 1) // 2
    if single(mesh) or r == 0:
        return _conv1d(out, k, 1, mode_lon)
    return _taps(pad_lon(out, r, mode_lon, mesh), k, 1, out.shape[1])


class GaussianFilter(torch.autograd.Function):
    """K6 on a CUDA tensor; its gradient the plain version's VJP; under
    ``torch.func.vmap`` the batched form, one launch for every member
    (``ops.members``)."""

    @staticmethod
    def forward(F, sigma, mode_lat, mode_lon, truncate):
        from ..kernels.gauss_sep import gaussian_filter_cuda
        return gaussian_filter_cuda(F.contiguous(), _gauss_kernel(float(sigma), truncate),
                                    mode_lat, mode_lon)

    @staticmethod
    def setup_context(ctx, inputs, output):
        F, *args = inputs
        ctx.save_for_backward(F)
        ctx.args = args

    @staticmethod
    def backward(ctx, g):
        return plain_vjp(gaussian_filter_plain, (*ctx.saved_tensors, *ctx.args), (g,),
                         ctx.needs_input_grad)

    @staticmethod
    def vmap(info, in_dims, F, sigma, mode_lat, mode_lon, truncate):
        from ..kernels.gauss_sep import gaussian_filter_batched_cuda
        refuse_grad("gaussian_filter", F)
        return gaussian_filter_batched_cuda(members_first(F, in_dims[0]),
                                            _gauss_kernel(float(sigma), truncate), mode_lat,
                                            mode_lon, info.batch_size), 0


def gaussian_filter(F: torch.Tensor, sigma: float, mode_lat: str = "reflect",
                    mode_lon: str = "reflect", truncate: float = 4.0,
                    mesh=None) -> torch.Tensor:
    """Separable Gaussian blur of a [H, W] field; sigma <= 0, or a radius
    ``int(truncate·σ + 0.5)`` of 0, returns F. K6 on a CUDA tensor on one
    rank, the plain version on a CPU tensor or a rank of ``mesh``."""
    if sigma is None or sigma <= 0.0 or len(_gauss_kernel(float(sigma), truncate)) == 1:
        return F
    if single(mesh) and use_kernel(F):
        return GaussianFilter.apply(F, float(sigma), mode_lat, mode_lon, truncate)
    return gaussian_filter_plain(F, sigma, mode_lat, mode_lon, truncate, mesh)
