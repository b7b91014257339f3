"""Spherical stencils: ∇², ∇⁴ hyperdiffusion, Shapiro, zonal FFT filter
(port of ``qingdai_tpu/ops/stencil.py``).

Longitude is periodic (roll), latitude uses np.gradient's one-sided edges, and
the cosφ metric is capped below by the caller's cap map (atmosphere 0.2,
ocean 0.5). ``hyperdiffuse_multi`` runs kernel K3 (``kernels/hyper4.py``) on a
CUDA tensor, through ``Hyper4`` (an ensemble's members in the same launches),
and ``hyperdiffuse_multi_ref`` on a CPU tensor.

On a rank of the longitude mesh (``mesh``) each stencil pads the rank's
columns with as many of its neighbours' as the chain reaches, computes, and
crops: one column for ∇², n for n Shapiro passes, 2 a substep for ∇⁴ (K3
runs unchanged on the padded block, and its own wrap touches only halo
columns). The owned columns are the whole grid's bit for bit. The zonal FFT
filter gathers the field, filters and crops, as GSPMD does.
"""

from __future__ import annotations

import torch

from ..grid import gradient_np
from ..kernels import use_kernel
from ..parallel.halo import all_gather_lon, lon_neighbours, pad_lon, single
from .members import plain_vjp, refuse_grad, to_front


def laplacian_sphere(F: torch.Tensor, dlat: float, dlon: float,
                     coslat: torch.Tensor, a: float, mesh=None) -> torch.Tensor:
    """(1/cos) ∂/∂φ (cos ∂F/∂φ) + (1/cos²) ∂²F/∂λ², all divided by a².

    Works on [H, W] or on a leading batch axis ([M, H, W] with coslat
    broadcasting against it)."""
    lat = F.dim() - 2
    dF_dphi = gradient_np(F, dlat, lat)
    term_phi = gradient_np(coslat * dF_dphi, dlat, lat) / coslat
    east, west = lon_neighbours(F, mesh)
    d2 = (east - 2.0 * F + west) / (dlon * dlon)
    return (term_phi + d2 / (coslat * coslat)) / (a * a)


def hyperdiffuse(F: torch.Tensor, k4, dt: float, n_substeps: int, dlat: float,
                 dlon: float, coslat: torch.Tensor, a: float) -> torch.Tensor:
    """Explicit dF/dt = −k4 ∇⁴F via two Laplacians, n substeps of dt/n."""
    n = max(1, int(n_substeps))
    sub_dt = dt / n
    out = F
    for _ in range(n):
        L = laplacian_sphere(out, dlat, dlon, coslat, a)
        L2 = laplacian_sphere(L, dlat, dlon, coslat, a)
        out = out - k4 * L2 * sub_dt
    return out


def hyperdiffuse_multi_ref(F: torch.Tensor, k4_stack: torch.Tensor, dt: float,
                           n_substeps: int, dlat: float, dlon: float,
                           coslat: torch.Tensor, a: float, mesh=None) -> torch.Tensor:
    """Plain version of kernel K3: hyperdiffusion of stacked fields [M, H, W];
    ``k4_stack`` broadcasts against [M, H, W], ``coslat`` is [H, W]. On a
    rank of ``mesh``, on the padded block as ``hyperdiffuse_multi``."""
    if not single(mesh):
        return _on_padded(hyperdiffuse_multi_ref, F, k4_stack, dt, n_substeps, dlat, dlon,
                          coslat, a, mesh)
    return hyperdiffuse(F, k4_stack, dt, n_substeps, dlat, dlon, coslat[None], a)


def _static_block(x, w, h, mesh):
    """A static operand of the padded block of ``h`` columns: ``x`` as it
    broadcasts (a trailing axis of 1), cropped if it holds more columns than
    the rank's (``Grid.padded``'s maps: no exchange), else exchanged."""
    n = x.shape[-1]
    if n == 1:
        return x
    if n == w:
        return pad_lon(x, h, "wrap", mesh)
    p = (n - w) // 2
    if n != w + 2 * p or p < h:
        raise ValueError(f"a static operand of {n} columns is neither the rank's {w} nor "
                         f"padded by at least {h}")
    return x[..., p - h:p + w + h].contiguous()


def _on_padded(fn, F, k4_stack, dt, n_substeps, dlat, dlon, coslat, a, mesh):
    """``fn`` (K3 or its plain version) on the rank's columns padded by 2 a
    substep, the owned columns cropped: the ∇⁴ chain reaches 2 columns a
    substep, so the pad's local wrap touches only halo columns. ``k4_stack``
    and ``coslat`` hold the rank's columns or more (``_static_block``)."""
    w, h = F.shape[-1], 2 * max(1, int(n_substeps))
    if k4_stack.shape[-1] == w:
        k4_stack = torch.broadcast_to(k4_stack, F.shape).contiguous()
    out = fn(pad_lon(F, h, "wrap", mesh), _static_block(k4_stack, w, h, mesh), dt, n_substeps,
             dlat, dlon, _static_block(coslat, w, h, mesh), a)
    return out[..., h:h + w].contiguous()


class Hyper4(torch.autograd.Function):
    """K3 on a CUDA tensor; its gradient with respect to F, the k4 stack
    and the cos map the plain version's VJP; under ``torch.func.vmap`` the
    batched form, one launch a substep for every member
    (``ops.members``)."""

    @staticmethod
    def forward(F, k4_stack, dt, n_substeps, dlat, dlon, coslat, a):
        from ..kernels.hyper4 import hyperdiffuse_cuda
        k4 = torch.broadcast_to(k4_stack, F.shape).contiguous()
        return hyperdiffuse_cuda(F, k4, dt, n_substeps, dlat, dlon, coslat, a)

    @staticmethod
    def setup_context(ctx, inputs, output):
        F, k4_stack, dt, n_substeps, dlat, dlon, coslat, a = inputs
        ctx.save_for_backward(F, k4_stack, coslat)
        ctx.scalars = (dt, n_substeps, dlat, dlon)
        ctx.a = a

    @staticmethod
    def backward(ctx, g):
        F, k4_stack, coslat = ctx.saved_tensors
        return plain_vjp(hyperdiffuse_multi_ref, (F, k4_stack, *ctx.scalars, coslat, ctx.a),
                         (g,), ctx.needs_input_grad)

    @staticmethod
    def vmap(info, in_dims, F, k4_stack, dt, n_substeps, dlat, dlon, coslat, a):
        from ..kernels.hyper4 import hyperdiffuse_batched_cuda
        refuse_grad("hyper4", F, k4_stack, coslat)
        f_dim, k4_dim, c_dim = in_dims[0], in_dims[1], in_dims[6]
        fields = (F if f_dim is None else F.movedim(f_dim, 0)).shape[-3:]
        k4 = to_front(k4_stack, k4_dim)
        # a shared k4 stays one [M, H, W] stack for every member
        k4 = torch.broadcast_to(k4, (() if k4_dim is None else k4.shape[:1]) + fields)
        return hyperdiffuse_batched_cuda(to_front(F, f_dim), k4.contiguous(), dt, n_substeps,
                                         dlat, dlon, to_front(coslat, c_dim), a,
                                         info.batch_size), 0


def hyperdiffuse_multi(F: torch.Tensor, k4_stack: torch.Tensor, dt: float,
                       n_substeps: int, dlat: float, dlon: float,
                       coslat: torch.Tensor, a: float, mesh=None) -> torch.Tensor:
    """Hyperdiffusion of stacked fields [M, H, W] in one pass. On a rank of
    ``mesh``, the rank's columns padded by 2 a substep (``kernels/hyper4.HALO``
    columns), K3 or its plain version unchanged on the padded block, and
    the owned columns cropped."""
    if not single(mesh):
        return _on_padded(hyperdiffuse_multi, F, k4_stack, dt, n_substeps, dlat, dlon, coslat,
                          a, mesh)
    if not use_kernel(F):
        return hyperdiffuse_multi_ref(F, k4_stack, dt, n_substeps, dlat, dlon, coslat, a)
    return Hyper4.apply(F, k4_stack, dt, n_substeps, dlat, dlon, coslat, a)


def shapiro_filter(F: torch.Tensor, n: int = 2, mesh=None) -> torch.Tensor:
    """Separable 1-2-1 smoothing applied n times over the last two axes of
    a [H, W] field or an [M, H, W] stack: longitude wrapped, latitude
    nearest."""
    lat, lon = F.dim() - 2, F.dim() - 1
    n = max(1, int(n))
    if not single(mesh):
        w = F.shape[-1]
        return shapiro_filter(pad_lon(F, n, "wrap", mesh), n)[..., n:n + w].contiguous()
    out = F
    for _ in range(n):
        out = 0.25 * torch.roll(out, 1, lon) + 0.5 * out + 0.25 * torch.roll(out, -1, lon)
        H = out.shape[lat]
        up = torch.cat([out.narrow(lat, 0, 1), out.narrow(lat, 0, H - 1)], lat)
        dn = torch.cat([out.narrow(lat, 1, H - 1), out.narrow(lat, H - 1, 1)], lat)
        out = 0.25 * up + 0.5 * out + 0.25 * dn
    return out


# the JAX package's name for the stacked form
shapiro_filter_multi = shapiro_filter


def spectral_zonal_filter(F: torch.Tensor, n_lon: int, cutoff: float = 0.75,
                          damp: float = 0.5, mesh=None) -> torch.Tensor:
    """Zonal-FFT damping: wavenumbers k ≥ cutoff·k_Nyquist scaled by (1 − damp)."""
    if damp <= 0.0 or cutoff <= 0.0:
        return F
    if not single(mesh):
        w = F.shape[-1]
        lon0 = mesh.rank * w
        return spectral_zonal_filter(all_gather_lon(F, mesh), n_lon, cutoff,
                                     damp)[..., lon0:lon0 + w].contiguous()
    fft = torch.fft.rfft(F, dim=1)
    bins = fft.shape[1]
    if bins <= 1:
        return F
    kN = bins - 1
    kcut = int(max(1, min(kN, int(cutoff * kN))))
    factor = torch.ones(bins, dtype=F.dtype, device=F.device)
    factor[kcut:] = max(0.0, 1.0 - min(1.0, damp))
    return torch.fft.irfft(fft * factor[None, :], n=n_lon, dim=1).to(F.dtype)
