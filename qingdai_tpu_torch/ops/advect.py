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

On a rank of the longitude mesh (``mesh``) the stack, the winds and the
cos map are gathered whole in one collective, the whole grid's call runs
on them (K2 on a card) and the rank keeps its columns: a departure point
may lie any number of columns away (on the pole rows the 1e-6 cos cap moves
it ~2700 cells per m/s of wind), so no halo would do. The columns are the
whole grid's call bit for bit.
"""

from __future__ import annotations

import torch

from ..kernels import use_kernel
from ..parallel.halo import all_gather_lon, single
from .members import plain_vjp, refuse_grad, to_front
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


def departure_indices(shape, u, v, dt, a, dlat, dlon, coslat, dtype):
    """Upstream departure-point fractional indices (dep_j, dep_i) of the
    [H, W] cells."""
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
    dep_j, dep_i = departure_indices(u.shape, u, v, dt, a, dlat, dlon, coslat, fields.dtype)
    return bilinear_wrap_gather_multi(fields, dep_j, dep_i)


class AdvectBilinear(torch.autograd.Function):
    """K2 on a CUDA tensor; its gradient with respect to the fields, the
    winds and the cos map the plain version's VJP (the winds' reaches them
    through the fractional parts of the departure points, ``floor`` passes
    none, as under ``jax.grad``); under ``torch.func.vmap`` the batched
    form, one launch for every member (``ops.members``)."""

    @staticmethod
    def forward(fields, u, v, dt, a, dlat, dlon, coslat):
        from ..kernels.advect_bilinear import advect_bilinear_cuda
        return advect_bilinear_cuda(fields, u, v, dt, a, dlat, dlon, coslat)

    @staticmethod
    def setup_context(ctx, inputs, output):
        fields, u, v, dt, a, dlat, dlon, coslat = inputs
        ctx.save_for_backward(fields, u, v, coslat)
        ctx.scalars = (dt, a, dlat, dlon)

    @staticmethod
    def backward(ctx, g):
        fields, u, v, coslat = ctx.saved_tensors
        return plain_vjp(advect_semilag_multi_ref, (fields, u, v, *ctx.scalars, coslat), (g,),
                         ctx.needs_input_grad)

    @staticmethod
    def vmap(info, in_dims, fields, u, v, dt, a, dlat, dlon, coslat):
        from ..kernels.advect_bilinear import advect_bilinear_batched_cuda
        refuse_grad("advect_bilinear", fields, u, v, coslat)
        f, uu, vv, c = (to_front(t, d) for t, d in zip((fields, u, v, coslat),
                                                     in_dims[:3] + in_dims[7:]))
        return advect_bilinear_batched_cuda(f, uu, vv, dt, a, dlat, dlon, c,
                                            info.batch_size), 0


def advect_semilag_multi(fields: torch.Tensor, u: torch.Tensor, v: torch.Tensor,
                         dt: float, a: float, dlat: float, dlon: float,
                         coslat: torch.Tensor, mesh=None) -> torch.Tensor:
    """Advect stacked fields [M, H, W] by the same wind over dt; on a rank
    of ``mesh``, the rank's columns of the whole stack's advection."""
    if not single(mesh):
        M, w = fields.shape[0], fields.shape[-1]
        whole = all_gather_lon(torch.cat([fields, torch.stack([u, v, coslat])]), mesh)
        lon0 = mesh.rank * w
        return advect_semilag_multi(whole[:M], whole[M], whole[M + 1], dt, a, dlat, dlon,
                                    whole[M + 2])[..., lon0:lon0 + w].contiguous()
    if not use_kernel(fields):
        return advect_semilag_multi_ref(fields, u, v, dt, a, dlat, dlon, coslat)
    return AdvectBilinear.apply(fields, u, v, dt, a, dlat, dlon, coslat)
