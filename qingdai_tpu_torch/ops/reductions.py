"""Area-weighted reductions and the median of positives
(port of ``qingdai_tpu/ops/reductions.py``).

``masked_median_of_positive`` runs kernel K1 (``kernels/median_pos.py``) on a
CUDA tensor, through ``MedianPos`` (an ensemble's members in one launch), and
the sort-based ``masked_median_of_positive_ref`` on a CPU tensor. Both
compute the exact ``np.median(x[x > 0])``.
"""

from __future__ import annotations

import torch

from ..kernels import use_kernel
from .members import refuse_grad, to_front


def area_mean(x: torch.Tensor, w: torch.Tensor, mask: torch.Tensor | None = None) -> torch.Tensor:
    """Σ x·w / (Σ w + 1e-15); an optional boolean mask folds into the weights."""
    if mask is not None:
        w = w * mask
    return torch.sum(x * w) / (torch.sum(w) + 1e-15)


def area_mean_compensated(x: torch.Tensor, w: torch.Tensor,
                          mask: torch.Tensor | None = None) -> torch.Tensor:
    """area_mean with the sums accumulated in float64, cast back to the
    working dtype.

    The JAX package carries float-float (TwoSum) trees so that f32 budget
    sums keep ~48 bits; a float64 accumulator gives the same accuracy
    directly. The per-element products still round once in the working
    dtype, as in the JAX form."""
    dtype = torch.promote_types(x.dtype, w.dtype)
    x, w = x.to(dtype), w.to(dtype)
    if mask is not None:
        w = w * mask
    num = torch.sum((x * w).to(torch.float64))
    den = torch.sum(w.to(torch.float64))
    return (num / (den + 1e-15)).to(dtype)


def masked_median_of_positive_ref(x: torch.Tensor, fallback: float = 1e-6) -> torch.Tensor:
    """Plain version of kernel K1: sort-based median over the strictly
    positive entries of x, ``fallback`` if there are none. The exact
    counterpart of ``masked_median_of_positive_sort``; NaN is not positive
    and +inf is."""
    flat = x.reshape(-1)
    pos = flat > 0.0
    n = torch.sum(pos)
    s = torch.sort(torch.where(pos, flat, torch.inf)).values
    lo = s.index_select(0, torch.clamp((n - 1) // 2, min=0).reshape(1))[0]
    hi = s.index_select(0, torch.clamp(n // 2, min=0).reshape(1))[0]
    med = 0.5 * (lo + hi)
    return torch.where(n > 0, med, torch.full((), fallback, dtype=x.dtype, device=x.device))


class MedianPos(torch.autograd.Function):
    """K1 on a CUDA tensor; under ``torch.func.vmap`` the batched form, one
    launch for every member (``ops.members``)."""

    @staticmethod
    def forward(x, fallback):
        from ..kernels.median_pos import median_pos_cuda
        return median_pos_cuda(x, fallback)

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def vmap(info, in_dims, x, fallback):
        from ..kernels.median_pos import median_pos_batched_cuda
        return median_pos_batched_cuda(to_front(x, in_dims[0]), info.batch_size, fallback), 0


def masked_median_of_positive(x: torch.Tensor, fallback: float = 1e-6) -> torch.Tensor:
    """Median over strictly positive entries of x as a 0-d tensor on x's
    device; ``fallback`` if none is positive. Never syncs with the host."""
    if not use_kernel(x):
        return masked_median_of_positive_ref(x, fallback)
    refuse_grad("median_pos", x)
    return MedianPos.apply(x, fallback)
