"""Semi-Lagrangian advection: bilinear interpolation at departure points
(port of ``qingdai_tpu/ops/advect.py``).

Departure indices wrap periodically on both axes with period H and W (floor
mod, as ``jnp.mod``). The JAX package's ``AdvectPlan`` machinery (roll window,
exact polar rows, polar band pass, band merge, polar matmul) only works around
the TPU's gather cost: one gather over every row computes the same
interpolation, so the port has none of it. ``advect_semilag_multi`` runs
kernel K2 (``kernels/advect_bilinear.py``), which computes the departure
points itself, on a CUDA tensor, through ``AdvectBilinear`` (an ensemble's
members in one launch), and the plain ``departure_indices`` and
``bilinear_wrap_gather_multi`` on a CPU tensor. The plain gather's
backward (the VJP that K2's and K4's ``autograd.Function``s take) adds each
cell's contributions in one order (``ops.scatter.gather_fixed``), so a
gradient repeats to the bit on the card.

On a rank of the longitude mesh (``mesh``) the stack is gathered whole and
K2's sharded form writes the rank's columns: a departure point may lie any
number of columns away (on the pole rows the 1e-6 cos cap moves it ~2700
cells per m/s of wind), so no halo would do. The departure points come from
the rank's own winds and cos map and the global column index, the same
arithmetic per cell as the whole grid's call, so the columns are bit-equal
to it.
"""

from __future__ import annotations

import torch

from ..parallel.halo import all_gather_lon, single
from .scatter import gather_fixed


def bilinear_wrap_gather_multi(fields: torch.Tensor, dep_j: torch.Tensor,
                               dep_i: torch.Tensor) -> torch.Tensor:
    """Plain version of kernel K2: bilinear wrap interpolation of stacked
    ``fields`` [M, H, W] at shared fractional indices (dep_j, dep_i) [H', W']."""
    M, H, W = fields.shape
    j0f = torch.floor(dep_j)
    i0f = torch.floor(dep_i)
    fj = (dep_j - j0f).to(fields.dtype)
    fi = (dep_i - i0f).to(fields.dtype)
    j0 = torch.remainder(j0f.to(torch.int64), H)
    i0 = torch.remainder(i0f.to(torch.int64), W)
    j1 = torch.remainder(j0 + 1, H)
    i1 = torch.remainder(i0 + 1, W)
    flat = fields.reshape(M, H * W)

    # a gradient sums the corners' contributions in a fixed order
    # (``ops.scatter.gather_fixed``): autograd's own adds with atomics on a card
    gather = gather_fixed if flat.requires_grad else torch.Tensor.index_select

    def corner(j, i):
        return gather(flat, 1, (j * W + i).reshape(-1)).reshape((M,) + dep_j.shape)

    w00 = (1.0 - fj) * (1.0 - fi)
    w01 = (1.0 - fj) * fi
    w10 = fj * (1.0 - fi)
    w11 = fj * fi
    return (corner(j0, i0) * w00 + corner(j0, i1) * w01
            + corner(j1, i0) * w10 + corner(j1, i1) * w11)


def departure_indices(shape, u, v, dt, a, dlat, dlon, coslat, dtype, lon0: int = 0):
    """Upstream departure-point fractional indices (dep_j, dep_i) of the
    [H, W] cells whose column i is global column ``lon0 + i``."""
    H, W = shape
    dlam = u * dt / (a * coslat)
    dphi = v * dt / a
    dx = dlam / dlon
    dy = dphi / dlat
    jj = torch.arange(H, device=u.device, dtype=torch.int32).to(dtype)[:, None]
    ii = torch.arange(lon0, lon0 + W, device=u.device, dtype=torch.int32).to(dtype)[None, :]
    return jj - dy, ii - dx


def advect_semilag_multi_ref(fields: torch.Tensor, u: torch.Tensor, v: torch.Tensor,
                             dt: float, a: float, dlat: float, dlon: float,
                             coslat: torch.Tensor, lon0: int = 0) -> torch.Tensor:
    """Plain version of kernel K2 from the winds: ``departure_indices`` and
    ``bilinear_wrap_gather_multi``. Winds narrower than the stack are a
    rank's columns from global column ``lon0`` (K2's sharded form)."""
    dep_j, dep_i = departure_indices(u.shape, u, v, dt, a, dlat, dlon, coslat,
                                     fields.dtype, lon0)
    return bilinear_wrap_gather_multi(fields, dep_j, dep_i)




def advect_semilag_multi(fields: torch.Tensor, u: torch.Tensor, v: torch.Tensor,
                         dt: float, a: float, dlat: float, dlon: float,
                         coslat: torch.Tensor, mesh=None) -> torch.Tensor:
    """Advect stacked fields [M, H, W] by the same wind over dt; on a rank
    of ``mesh``, the rank's columns of the whole stack's advection."""
    single(mesh)
    return advect_semilag_multi_ref(fields, u, v, dt, a, dlat, dlon, coslat)
