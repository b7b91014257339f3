"""Semi-Lagrangian advection: bilinear interpolation at departure points
(port of ``qingdai_tpu/ops/advect.py``).

Departure indices wrap periodically on both axes with period H and W (floor
mod, as ``jnp.mod``). The JAX package's ``AdvectPlan`` machinery (roll window,
exact polar rows, polar band pass, band merge, polar matmul) only works around
the TPU's gather cost: one gather over every row computes the same
interpolation, so the port has none of it. ``advect_semilag_multi`` runs
kernel K2 (``kernels/advect_bilinear.py``) on a CUDA tensor and the plain
``bilinear_wrap_gather_multi`` on a CPU tensor.
"""

from __future__ import annotations

import torch

from ..kernels import use_kernel


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

    def corner(j, i):
        return flat.index_select(1, (j * W + i).reshape(-1)).reshape((M,) + dep_j.shape)

    w00 = (1.0 - fj) * (1.0 - fi)
    w01 = (1.0 - fj) * fi
    w10 = fj * (1.0 - fi)
    w11 = fj * fi
    return (corner(j0, i0) * w00 + corner(j0, i1) * w01
            + corner(j1, i0) * w10 + corner(j1, i1) * w11)


def departure_indices(shape, u, v, dt, a, dlat, dlon, coslat, dtype):
    """Upstream departure-point fractional indices (dep_j, dep_i)."""
    H, W = shape
    dlam = u * dt / (a * coslat)
    dphi = v * dt / a
    dx = dlam / dlon
    dy = dphi / dlat
    jj = torch.arange(H, device=u.device, dtype=torch.int32).to(dtype)[:, None]
    ii = torch.arange(W, device=u.device, dtype=torch.int32).to(dtype)[None, :]
    return jj - dy, ii - dx


def advect_semilag_multi(fields: torch.Tensor, u: torch.Tensor, v: torch.Tensor,
                         dt: float, a: float, dlat: float, dlon: float,
                         coslat: torch.Tensor) -> torch.Tensor:
    """Advect stacked fields [M, H, W] by the same wind over dt."""
    dep_j, dep_i = departure_indices(fields.shape[1:], u, v, dt, a, dlat, dlon,
                                     coslat, fields.dtype)
    if use_kernel(fields):
        from ..kernels.advect_bilinear import advect_bilinear_cuda
        return advect_bilinear_cuda(fields, dep_j, dep_i)
    return bilinear_wrap_gather_multi(fields, dep_j, dep_i)

