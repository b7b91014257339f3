"""Dual-star insolation and radiative-equilibrium temperature (port of
``qingdai_tpu/physics/forcing.py``)."""

from __future__ import annotations

import math

import numpy as np
import torch

from .. import constants as const
from ..grid import Grid
from ..ops import safegrad
from . import orbital

# planet-fixed equatorial frame, as plain Python floats
_tilt = math.radians(const.PLANET_AXIAL_TILT)
_n_hat = np.array([math.sin(_tilt), 0.0, math.cos(_tilt)])
_x_in = np.array([1.0, 0.0, 0.0])
_x_eq = _x_in - np.dot(_x_in, _n_hat) * _n_hat
_x_eq = _x_eq / np.linalg.norm(_x_eq)
_y_eq = np.cross(_n_hat, _x_eq)
N_HAT = tuple(float(v) for v in _n_hat)
X_EQ = tuple(float(v) for v in _x_eq)
Y_EQ = tuple(float(v) for v in _y_eq)


def _single_star_insolation(grid: Grid, theta, flux, sx, sy):
    """Insolation of one star from its planet→star vector (sx, sy, 0) and the
    rotation phase theta."""
    norm = torch.sqrt(sx * sx + sy * sy) + 1e-15
    shx, shy = sx / norm, sy / norm
    dot_n = shx * N_HAT[0] + shy * N_HAT[1]
    delta = torch.asin(torch.clamp(dot_n, -1.0, 1.0))
    alpha = torch.atan2(shx * Y_EQ[0] + shy * Y_EQ[1], shx * X_EQ[0] + shy * X_EQ[1])
    h = theta + torch.deg2rad(grid.lon_mesh) - alpha
    cos_z = (torch.sin(grid.lat_rad) * torch.sin(delta)
             + torch.cos(grid.lat_rad) * torch.cos(delta) * torch.cos(h))
    return flux * torch.clamp(cos_z, min=0.0)


def insolation_components_from_phases(grid: Grid, phase_rot, phase_binary, phase_planet):
    """(insA, insB) per-star surface insolation (W/m²) from the carried phases."""
    x_A, y_A, x_B, y_B = orbital.stellar_positions_from_phase(phase_binary)
    x_p, y_p = orbital.planet_position_from_phase(phase_planet)
    vAx, vAy = x_A - x_p, y_A - y_p
    vBx, vBy = x_B - x_p, y_B - y_p
    flux_A = const.L_A / (4.0 * math.pi * (vAx * vAx + vAy * vAy))
    flux_B = const.L_B / (4.0 * math.pi * (vBx * vBx + vBy * vBy))
    return (_single_star_insolation(grid, phase_rot, flux_A, vAx, vAy),
            _single_star_insolation(grid, phase_rot, flux_B, vBx, vBy))


def equilibrium_temp(isr, albedo):
    """T_eq = (I(1−α)/σ)^¼ with night-side zeros."""
    numerator = torch.clamp(isr * (1.0 - albedo), min=0.0)
    return safegrad.quartic_root(numerator / const.SIGMA)
