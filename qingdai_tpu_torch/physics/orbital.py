"""Orbital mechanics of the Harmony binary and Qingdai (port of
``qingdai_tpu/physics/orbital.py``): circular coplanar orbits about the
barycenter, as functions of the carried orbital phases."""

from __future__ import annotations

import math

import torch

from .. import constants as const

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
