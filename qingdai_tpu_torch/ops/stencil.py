"""Spherical stencils: ∇², ∇⁴ hyperdiffusion, Shapiro, zonal FFT filter
(port of ``qingdai_tpu/ops/stencil.py``).

Longitude is periodic (roll), latitude uses np.gradient's one-sided edges, and
the cosφ metric is capped below by the caller's cap map (atmosphere 0.2,
ocean 0.5). ``hyperdiffuse_multi`` runs kernel K3 (``kernels/hyper4.py``) on a
CUDA tensor and ``hyperdiffuse_multi_ref`` on a CPU tensor.
"""

from __future__ import annotations

import torch

from ..grid import gradient_np
from ..kernels import use_kernel


def laplacian_sphere(F: torch.Tensor, dlat: float, dlon: float,
                     coslat: torch.Tensor, a: float) -> torch.Tensor:
    """(1/cos) ∂/∂φ (cos ∂F/∂φ) + (1/cos²) ∂²F/∂λ², all divided by a².

    Works on [H, W] or on a leading batch axis ([M, H, W] with coslat
    broadcasting against it)."""
    lat, lon = F.dim() - 2, F.dim() - 1
    dF_dphi = gradient_np(F, dlat, lat)
    term_phi = gradient_np(coslat * dF_dphi, dlat, lat) / coslat
    d2 = (torch.roll(F, -1, lon) - 2.0 * F + torch.roll(F, 1, lon)) / (dlon * dlon)
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
                           coslat: torch.Tensor, a: float) -> torch.Tensor:
    """Plain version of kernel K3: hyperdiffusion of stacked fields [M, H, W];
    ``k4_stack`` broadcasts against [M, H, W], ``coslat`` is [H, W]."""
    return hyperdiffuse(F, k4_stack, dt, n_substeps, dlat, dlon, coslat[None], a)


def hyperdiffuse_multi(F: torch.Tensor, k4_stack: torch.Tensor, dt: float,
                       n_substeps: int, dlat: float, dlon: float,
                       coslat: torch.Tensor, a: float) -> torch.Tensor:
    """Hyperdiffusion of stacked fields [M, H, W] in one pass."""
    if use_kernel(F):
        from ..kernels.hyper4 import hyperdiffuse_cuda
        k4 = torch.broadcast_to(k4_stack, F.shape).contiguous()
        return hyperdiffuse_cuda(F, k4, dt, n_substeps, dlat, dlon, coslat, a)
    return hyperdiffuse_multi_ref(F, k4_stack, dt, n_substeps, dlat, dlon, coslat, a)


def shapiro_filter(F: torch.Tensor, n: int = 2) -> torch.Tensor:
    """Separable 1-2-1 smoothing applied n times over the last two axes of
    a [H, W] field or an [M, H, W] stack: longitude wrapped, latitude
    nearest."""
    lat, lon = F.dim() - 2, F.dim() - 1
    out = F
    for _ in range(max(1, int(n))):
        out = 0.25 * torch.roll(out, 1, lon) + 0.5 * out + 0.25 * torch.roll(out, -1, lon)
        H = out.shape[lat]
        up = torch.cat([out.narrow(lat, 0, 1), out.narrow(lat, 0, H - 1)], lat)
        dn = torch.cat([out.narrow(lat, 1, H - 1), out.narrow(lat, H - 1, 1)], lat)
        out = 0.25 * up + 0.5 * out + 0.25 * dn
    return out


# the JAX package's name for the stacked form
shapiro_filter_multi = shapiro_filter


def spectral_zonal_filter(F: torch.Tensor, n_lon: int, cutoff: float = 0.75,
                          damp: float = 0.5) -> torch.Tensor:
    """Zonal-FFT damping: wavenumbers k ≥ cutoff·k_Nyquist scaled by (1 − damp)."""
    if damp <= 0.0 or cutoff <= 0.0:
        return F
    fft = torch.fft.rfft(F, dim=1)
    bins = fft.shape[1]
    if bins <= 1:
        return F
    kN = bins - 1
    kcut = int(max(1, min(kN, int(cutoff * kN))))
    factor = torch.ones(bins, dtype=F.dtype, device=F.device)
    factor[kcut:] = max(0.0, 1.0 - min(1.0, damp))
    return torch.fft.irfft(fft * factor[None, :], n=n_lon, dim=1).to(F.dtype)
