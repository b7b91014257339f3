"""Orbital mechanics of the Harmony binary and Qingdai (port of
``qingdai_tpu/physics/orbital.py``): circular coplanar orbits about the
barycenter, as functions of the carried orbital phases or of the time."""

from __future__ import annotations

import math

import numpy as np
import torch

from .. import constants as const
from ..grid import resolve_device

T_BINARY = 2.0 * math.pi * math.sqrt(const.A_BINARY ** 3 / (const.G * const.M_TOTAL_STARS))
T_PLANET = 2.0 * math.pi * math.sqrt(const.A_PLANET ** 3 / (const.G * const.M_TOTAL_STARS))
OMEGA_BINARY = 2.0 * math.pi / T_BINARY
OMEGA_PLANET = 2.0 * math.pi / T_PLANET
R_A = const.A_BINARY * (const.M_B / const.M_TOTAL_STARS)
R_B = const.A_BINARY * (const.M_A / const.M_TOTAL_STARS)


def stellar_positions_from_phase(phase_binary: torch.Tensor):
    """(x_A, y_A, x_B, y_B) from the binary orbital phase ω_b·t mod 2π."""
    c = torch.cos(phase_binary)
    s = torch.sin(phase_binary)
    return R_A * c, R_A * s, -R_B * c, -R_B * s


def planet_position_from_phase(phase_planet: torch.Tensor):
    return const.A_PLANET * torch.cos(phase_planet), const.A_PLANET * torch.sin(phase_planet)


def as_time(t, device="cuda") -> torch.Tensor:
    """``t`` (s) as a tensor: a tensor stays as it is, in its dtype and on its
    device; a Python number or a NumPy array becomes a float64 tensor on
    ``device``, which defaults to the card (``grid.resolve_device``)."""
    if isinstance(t, torch.Tensor):
        return t
    return torch.as_tensor(np.asarray(t, np.float64), device=resolve_device(device))


def stellar_positions(t, device="cuda"):
    """(x_A, y_A, x_B, y_B) barycentric coordinates at time t (s)."""
    return stellar_positions_from_phase(OMEGA_BINARY * as_time(t, device))


def planet_position(t, device="cuda"):
    return planet_position_from_phase(OMEGA_PLANET * as_time(t, device))


def total_flux(t, device="cuda"):
    """Total stellar flux S_A + S_B at the planet (W/m²)."""
    t = as_time(t, device)
    x_A, y_A, x_B, y_B = stellar_positions(t)
    x_p, y_p = planet_position(t)
    d_A2 = (x_p - x_A) ** 2 + (y_p - y_A) ** 2
    d_B2 = (x_p - x_B) ** 2 + (y_p - y_B) ** 2
    S_A = const.L_A / (4.0 * math.pi * d_A2)
    S_B = const.L_B / (4.0 * math.pi * d_B2)
    return S_A + S_B
