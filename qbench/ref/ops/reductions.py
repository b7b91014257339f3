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

from ..parallel.halo import all_gather_lon, all_reduce_sum, gsum


def sum_fixed(x: torch.Tensor, dim: int) -> torch.Tensor:
    """``torch.sum(x, dim)`` in one order of additions, whatever ``x``'s other
    dimensions: a pairwise tree of elementwise adds along ``dim`` (halves
    added, an odd last entry carried up a level). A reduction kernel picks
    its order of additions by the whole tensor's shape, so under
    ``torch.func.vmap`` a member's sum could round differently from the
    single planet's; elementwise adds cannot."""
    x = x.movedim(dim, -1)
    while x.shape[-1] > 1:
        n, h = x.shape[-1], x.shape[-1] // 2
        pairs = x[..., :h] + x[..., h:2 * h]
        x = torch.cat([pairs, x[..., 2 * h:]], dim=-1) if n % 2 else pairs
    return x[..., 0]


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




def masked_median_of_positive(x: torch.Tensor, fallback: float = 1e-6,
                              mesh=None) -> torch.Tensor:
    """Median over strictly positive entries of x as a 0-d tensor on x's
    device; ``fallback`` if none is positive. Never syncs with the host
    (on a mesh, the gather does)."""
    return masked_median_of_positive_ref(all_gather_lon(x, mesh), fallback)
