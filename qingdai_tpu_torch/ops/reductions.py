"""Area-weighted reductions and the median of positives
(port of ``qingdai_tpu/ops/reductions.py``).

``masked_median_of_positive`` runs kernel K1 (``kernels/median_pos.py``) on a
CUDA tensor, through ``MedianPos`` (an ensemble's members in one launch), and
the sort-based ``masked_median_of_positive_ref`` on a CPU tensor. Both
compute the exact ``np.median(x[x > 0])``.

On a rank of the longitude mesh (``mesh``) the means take the rank's sums
and add them across ranks (``parallel.halo``), and the median runs K1
unchanged on the field gathered whole, on every rank: an order statistic of
the same values, so it is the unsharded median bit for bit. (The JAX
package's mesh form reduces bisection counts instead.)
"""

from __future__ import annotations

import torch

from ..kernels import use_kernel
from ..parallel.halo import all_gather_lon, all_reduce_sum, gsum
from .members import plain_vjp, refuse_grad, to_front


def area_mean(x: torch.Tensor, w: torch.Tensor, mask: torch.Tensor | None = None,
              mesh=None) -> torch.Tensor:
    """Σ x·w / (Σ w + 1e-15); an optional boolean mask folds into the weights."""
    if mask is not None:
        w = w * mask
    return gsum(x * w, mesh) / (gsum(w, mesh) + 1e-15)


def area_mean_compensated(x: torch.Tensor, w: torch.Tensor,
                          mask: torch.Tensor | None = None, mesh=None) -> torch.Tensor:
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
    num = all_reduce_sum(torch.sum((x * w).to(torch.float64)), mesh)
    den = all_reduce_sum(torch.sum(w.to(torch.float64)), mesh)
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
    """K1 on a CUDA tensor; its gradient the plain version's VJP, which is
    the JAX package's custom JVP rule at generic points: ½(dx[i₁] + dx[i₂])
    at the two middle order statistics, zero when nothing is positive; under
    ``torch.func.vmap`` the batched form, one launch for every member
    (``ops.members``)."""

    @staticmethod
    def forward(x, fallback):
        from ..kernels.median_pos import median_pos_cuda
        return median_pos_cuda(x, fallback)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_backward(inputs[0])
        ctx.fallback = inputs[1]

    @staticmethod
    def backward(ctx, g):
        return plain_vjp(masked_median_of_positive_ref, (*ctx.saved_tensors, ctx.fallback), (g,),
                         ctx.needs_input_grad)

    @staticmethod
    def vmap(info, in_dims, x, fallback):
        from ..kernels.median_pos import median_pos_batched_cuda
        refuse_grad("median_pos", x)
        return median_pos_batched_cuda(to_front(x, in_dims[0]), info.batch_size, fallback), 0


def masked_median_of_positive(x: torch.Tensor, fallback: float = 1e-6,
                              mesh=None) -> torch.Tensor:
    """Median over strictly positive entries of x as a 0-d tensor on x's
    device; ``fallback`` if none is positive. Never syncs with the host
    (on a mesh, the gather does)."""
    x = all_gather_lon(x, mesh)
    if not use_kernel(x):
        return masked_median_of_positive_ref(x, fallback)
    return MedianPos.apply(x, fallback)
