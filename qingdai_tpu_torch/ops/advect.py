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
``bilinear_wrap_gather_multi`` on a CPU tensor.
"""

from __future__ import annotations

import torch

from ..kernels import use_kernel
from .members import refuse_grad, to_front


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


def advect_semilag_multi_ref(fields: torch.Tensor, u: torch.Tensor, v: torch.Tensor,
                             dt: float, a: float, dlat: float, dlon: float,
                             coslat: torch.Tensor) -> torch.Tensor:
    """Plain version of kernel K2 from the winds: ``departure_indices`` and
    ``bilinear_wrap_gather_multi``."""
    dep_j, dep_i = departure_indices(fields.shape[1:], u, v, dt, a, dlat, dlon,
                                     coslat, fields.dtype)
    return bilinear_wrap_gather_multi(fields, dep_j, dep_i)


class AdvectBilinear(torch.autograd.Function):
    """K2 on a CUDA tensor; under ``torch.func.vmap`` the batched form, one
    launch for every member (``ops.members``)."""

    @staticmethod
    def forward(fields, u, v, dt, a, dlat, dlon, coslat):
        from ..kernels.advect_bilinear import advect_bilinear_cuda
        return advect_bilinear_cuda(fields, u, v, dt, a, dlat, dlon, coslat)

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def vmap(info, in_dims, fields, u, v, dt, a, dlat, dlon, coslat):
        from ..kernels.advect_bilinear import advect_bilinear_batched_cuda
        f, uu, vv, c = (to_front(t, d) for t, d in zip((fields, u, v, coslat),
                                                     in_dims[:3] + in_dims[7:]))
        return advect_bilinear_batched_cuda(f, uu, vv, dt, a, dlat, dlon, c,
                                            info.batch_size), 0


def advect_semilag_multi(fields: torch.Tensor, u: torch.Tensor, v: torch.Tensor,
                         dt: float, a: float, dlat: float, dlon: float,
                         coslat: torch.Tensor) -> torch.Tensor:
    """Advect stacked fields [M, H, W] by the same wind over dt."""
    if not use_kernel(fields):
        return advect_semilag_multi_ref(fields, u, v, dt, a, dlat, dlon, coslat)
    refuse_grad("advect_bilinear", fields, u, v, coslat)
    return AdvectBilinear.apply(fields, u, v, dt, a, dlat, dlon, coslat)
