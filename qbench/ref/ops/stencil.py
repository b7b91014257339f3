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
from ..parallel.halo import all_gather_lon, lon_neighbours, pad_lon, single


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
    single(mesh)
    return hyperdiffuse(F, k4_stack, dt, n_substeps, dlat, dlon, coslat[None], a)


def hyperdiffuse_multi(F: torch.Tensor, k4_stack: torch.Tensor, dt: float,
                       n_substeps: int, dlat: float, dlon: float,
                       coslat: torch.Tensor, a: float, mesh=None) -> torch.Tensor:
    """Hyperdiffusion of stacked fields [M, H, W] in one pass. On a rank of
    ``mesh``, the rank's columns padded by 2 a substep (``kernels/hyper4.HALO``
    columns), K3 or its plain version unchanged on the padded block, and
    the owned columns cropped."""
    single(mesh)
    return hyperdiffuse_multi_ref(F, k4_stack, dt, n_substeps, dlat, dlon, coslat, a)


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
