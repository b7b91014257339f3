"""Spherical grid metrics as device tensors (port of ``qingdai_tpu/grid.py``).

All latitude-dependent metric maps are computed once in float64 NumPy, exactly
as the JAX package does, and cast to the model dtype on the model device.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from . import constants as const


@dataclasses.dataclass(frozen=True)
class Grid:
    """Static grid metrics. All 2-D fields are (n_lat, n_lon)."""
    n_lat: int
    n_lon: int
    dlat_rad: float
    dlon_rad: float
    lat: torch.Tensor            # (n_lat,) degrees
    lon: torch.Tensor            # (n_lon,) degrees
    lat_mesh: torch.Tensor       # (n_lat, n_lon) degrees
    lon_mesh: torch.Tensor
    lat_rad: torch.Tensor
    coslat: torch.Tensor         # raw cos(lat)
    coslat_cap_tiny: torch.Tensor  # max(cos, 1e-6): divergence cap
    coslat_cap_02: torch.Tensor    # max(cos, 0.2): atmosphere Laplacian cap
    coslat_cap_05: torch.Tensor    # max(cos, 0.5): ocean metric cap
    coslat_cap_1em3: torch.Tensor  # max(cos, 1e-3): sigma4 metric cap
    f: torch.Tensor              # Coriolis 2Ω sinφ
    area_w: torch.Tensor         # max(cosφ, 0) area weights
    cell_area: torch.Tensor      # spherical cell areas (m^2)
    k4_map_unit: torch.Tensor    # min(a·dlat, a·dlon·max(cos,1e-3))^4

    @property
    def shape(self):
        return (self.n_lat, self.n_lon)


def resolve_device(device) -> torch.device:
    """The device the caller asked for. Every entry point defaults to
    ``"cuda"``; without a card that raises instead of running on the CPU,
    which the caller must ask for with ``device="cpu"``."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("qingdai_tpu_torch runs on a CUDA card by default and this "
                           "process sees none; pass device='cpu' to run the plain "
                           "PyTorch versions on the CPU")
    return device


def make_grid(n_lat: int, n_lon: int, device="cuda", dtype=torch.float32) -> Grid:
    """Build grid metrics. lat ∈ linspace(-90, 90), lon ∈ linspace(0, 360)."""
    device = resolve_device(device)
    lat = np.linspace(-90.0, 90.0, n_lat)
    lon = np.linspace(0.0, 360.0, n_lon)
    lon_mesh, lat_mesh = np.meshgrid(lon, lat)
    lat_rad = np.deg2rad(lat_mesh)
    cos = np.cos(lat_rad)
    dlat_rad = float(np.deg2rad(lat[1] - lat[0])) if n_lat > 1 else 1.0
    dlon_rad = float(np.deg2rad(lon[1] - lon[0])) if n_lon > 1 else 1.0

    R = const.PLANET_RADIUS
    phi_c = np.deg2rad(lat)
    phi_p = np.clip(phi_c + 0.5 * dlat_rad, -0.5 * np.pi, 0.5 * np.pi)
    phi_m = np.clip(phi_c - 0.5 * dlat_rad, -0.5 * np.pi, 0.5 * np.pi)
    band = np.sin(phi_p) - np.sin(phi_m)
    cell_area = np.repeat(((R * R) * dlon_rad * band)[:, None], n_lon, axis=1)

    dx_lat = R * dlat_rad
    dx_lon = R * dlon_rad * np.maximum(cos, 1e-3)
    k4_map_unit = np.minimum(dx_lat, dx_lon) ** 4

    def as_t(x):
        return torch.as_tensor(np.asarray(x, np.float64)).to(device=device, dtype=dtype)

    return Grid(
        n_lat=n_lat, n_lon=n_lon, dlat_rad=dlat_rad, dlon_rad=dlon_rad,
        lat=as_t(lat), lon=as_t(lon), lat_mesh=as_t(lat_mesh), lon_mesh=as_t(lon_mesh),
        lat_rad=as_t(lat_rad), coslat=as_t(cos),
        coslat_cap_tiny=as_t(np.maximum(cos, 1e-6)),
        coslat_cap_02=as_t(np.maximum(cos, 0.2)),
        coslat_cap_05=as_t(np.maximum(cos, 0.5)),
        coslat_cap_1em3=as_t(np.maximum(cos, 1e-3)),
        f=as_t(2.0 * const.PLANET_OMEGA * np.sin(lat_rad)),
        area_w=as_t(np.maximum(cos, 0.0)),
        cell_area=as_t(cell_area),
        k4_map_unit=as_t(k4_map_unit),
    )


# ---------------------------------------------------------------------------
# Differential operators: periodic in longitude; the latitude rolls wrap
# across the poles and the pole rows of the φ-term are zeroed afterwards.
# ---------------------------------------------------------------------------

def _zero_pole_rows(x: torch.Tensor) -> torch.Tensor:
    x = x.clone()
    x[0] = 0.0
    x[-1] = 0.0
    return x


def divergence(grid: Grid, u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """(1/(a cosφ)) [∂u/∂λ + ∂(v cosφ)/∂φ] with pole rows of the φ-term zeroed."""
    a = const.PLANET_RADIUS
    du_dlon = (torch.roll(u, -1, 1) - torch.roll(u, 1, 1)) / (2.0 * grid.dlon_rad)
    v_cos = v * grid.coslat
    dv_dlat = (torch.roll(v_cos, -1, 0) - torch.roll(v_cos, 1, 0)) / (2.0 * grid.dlat_rad)
    return (du_dlon + _zero_pole_rows(dv_dlat)) / (a * grid.coslat_cap_tiny)


def vorticity(grid: Grid, u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """(1/(a cosφ)) [∂v/∂λ − ∂(u cosφ)/∂φ] with pole rows of the φ-term zeroed."""
    a = const.PLANET_RADIUS
    dv_dlon = (torch.roll(v, -1, 1) - torch.roll(v, 1, 1)) / (2.0 * grid.dlon_rad)
    u_cos = u * grid.coslat
    du_dlat = (torch.roll(u_cos, -1, 0) - torch.roll(u_cos, 1, 0)) / (2.0 * grid.dlat_rad)
    return (dv_dlon - _zero_pole_rows(du_dlat)) / (a * grid.coslat_cap_tiny)


def grad_lonlat(grid: Grid, F: torch.Tensor):
    """np.gradient-equivalent (∂F/∂λ, ∂F/∂φ): central differences, one-sided
    at both edges of each axis, including the longitude seam."""
    return gradient_np(F, grid.dlon_rad, 1), gradient_np(F, grid.dlat_rad, 0)


def gradient_np(F: torch.Tensor, d: float, dim: int) -> torch.Tensor:
    """np.gradient along ``dim``: central interior, one-sided edges."""
    n = F.shape[dim]
    sl = lambda s, e: F.narrow(dim, s, e - s)
    interior = (sl(2, n) - sl(0, n - 2)) / (2.0 * d)
    first = (sl(1, 2) - sl(0, 1)) / d
    last = (sl(n - 1, n) - sl(n - 2, n - 1)) / d
    return torch.cat([first, interior, last], dim=dim)
