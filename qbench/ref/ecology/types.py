"""Weather sample dataclasses for ecology consumers
(counterpart of pygcm/ecology/types.py:7-31)."""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np


@dataclasses.dataclass
class WeatherInstant:
    """Instantaneous weather sample at a cell (or field)."""
    Ts: np.ndarray | float
    Ta: np.ndarray | float
    wind: np.ndarray | float
    soil_water_index: np.ndarray | float
    I_bands: Optional[np.ndarray] = None  # [NB] or [NB,H,W]


@dataclasses.dataclass
class WeatherDaily:
    """Daily aggregate weather sample."""
    Ts_mean: np.ndarray | float
    Ta_mean: np.ndarray | float
    wind_mean: np.ndarray | float
    soil_water_index: np.ndarray | float
    day_length_hours: float = 24.0
    I_bands_daily: Optional[np.ndarray] = None
