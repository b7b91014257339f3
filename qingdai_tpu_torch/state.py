"""World state and static fields (port of ``qingdai_tpu/state.py``).

Each state group is a frozen dataclass of tensors, replaced whole by
``dataclasses.replace`` as the step advances. The clock's step counter and
its two day accumulators are host Python numbers, known from the step count
and dt, and so is the routing group's event clock: every cadence in the
step, the daily ecology and phytoplankton blocks and the routing event
included, is a Python ``if`` on them, with no host sync.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch

from . import constants as const
from .config import SimConfig
from .grid import Grid
from .physics import humidity as hum
from .physics import orbital


@dataclasses.dataclass(frozen=True)
class AtmosState:
    """Atmosphere prognostics and the humidity flux caches."""
    u: torch.Tensor
    v: torch.Tensor
    h: torch.Tensor
    T_s: torch.Tensor
    cloud_cover: torch.Tensor
    q: torch.Tensor
    h_ice: torch.Tensor
    E_flux_last: torch.Tensor
    P_cond_flux_last: torch.Tensor
    LH_last: torch.Tensor
    LH_release_last: torch.Tensor
    cloud_eff_last: torch.Tensor
    olr: torch.Tensor


@dataclasses.dataclass(frozen=True)
class OceanState:
    uo: torch.Tensor
    vo: torch.Tensor
    eta: torch.Tensor
    sst: torch.Tensor


@dataclasses.dataclass(frozen=True)
class LandState:
    """Hydrology reservoirs and snow/glacier caches."""
    W_land: torch.Tensor
    S_snow: torch.Tensor
    C_snow: torch.Tensor
    glacier_mask: torch.Tensor   # bool


@dataclasses.dataclass(frozen=True)
class EnergyState:
    """Autotunable greenhouse scalars (0-d tensors)."""
    lw_eps0: torch.Tensor
    lw_kc: torch.Tensor


@dataclasses.dataclass(frozen=True)
class ClockState:
    """Simulation clock. The three astronomical phases are carried and
    advanced mod 2π each step; t_seconds is approximate bookkeeping.
    ``accum_t_day`` and ``phyto_accum`` are host floats rounded to the
    model's dtype after every update, so they take the values the JAX
    package's device scalars take."""
    t_seconds: torch.Tensor
    step_idx: int                # host-side global step counter
    phase_rot: torch.Tensor
    phase_binary: torch.Tensor
    phase_planet: torch.Tensor
    precip_acc_day: torch.Tensor
    accum_t_day: float           # seconds since the last day boundary
    precip_day_last: torch.Tensor
    phyto_accum: float           # seconds since the last phytoplankton day


@dataclasses.dataclass(frozen=True)
class AlbedoCaches:
    """Per-step albedo coupling caches."""
    alpha_ecology_last: torch.Tensor
    alpha_banded_daily: torch.Tensor
    has_alpha_banded: torch.Tensor   # bool 0-d
    alpha_water_scalar: torch.Tensor
    has_alpha_water: torch.Tensor    # bool 0-d


@dataclasses.dataclass(frozen=True)
class WorldState:
    """The planet's state. ``eco``, ``indiv``, ``phyto`` and ``routing`` are
    ``ecology.population.EcoState``, ``ecology.individuals.IndivState``,
    ``ecology.phyto.PhytoState`` and ``routing.RoutingState``, or None where
    the subsystem is off."""
    atmos: AtmosState
    ocean: OceanState
    land: LandState
    energy: EnergyState
    clock: ClockState
    albedo: AlbedoCaches
    eco: Optional[object] = None
    indiv: Optional[object] = None
    phyto: Optional[object] = None
    routing: Optional[object] = None


@dataclasses.dataclass(frozen=True)
class StaticFields:
    """Time-invariant planet data."""
    land_mask: torch.Tensor     # int32 (1 = land, 0 = ocean)
    elevation: torch.Tensor     # m
    base_albedo: torch.Tensor
    friction: torch.Tensor
    C_s_map: torch.Tensor       # surface heat capacity (J m^-2 K^-1)
    has_elevation: bool = False


def round_to(x: float, dtype: torch.dtype) -> float:
    """x rounded to ``dtype``, as a host float."""
    return float(torch.tensor(x, dtype=torch.float64).to(dtype))


def _scalar(x, grid: Grid, dtype) -> torch.Tensor:
    return torch.full((), x, dtype=dtype, device=grid.lat.device)


def init_atmos(grid: Grid, cfg: SimConfig, dtype=torch.float32) -> AtmosState:
    """Initial atmosphere: rest, h = H + 300 sin²φ, T_s = 288 K, q at RH0."""
    z = torch.zeros(grid.shape, dtype=dtype, device=grid.lat.device)
    h0 = cfg.dynamics.H + 300.0 * torch.sin(grid.lat_rad) ** 2
    Ts0 = torch.full_like(z, 288.0)
    q0 = hum.q_init(Ts0, RH0=cfg.humidity.q_init_rh, p0=cfg.humidity.p0)
    return AtmosState(u=z, v=z, h=h0.to(dtype), T_s=Ts0, cloud_cover=z, q=q0.to(dtype),
                      h_ice=z, E_flux_last=z, P_cond_flux_last=z, LH_last=z,
                      LH_release_last=z, cloud_eff_last=z, olr=z)


def init_ocean(grid: Grid, land_mask, Ts_init=None, dtype=torch.float32) -> OceanState:
    z = torch.zeros(grid.shape, dtype=dtype, device=grid.lat.device)
    if Ts_init is None:
        sst = torch.full_like(z, 288.0)
    else:
        sst = torch.where(land_mask == 0, Ts_init, 288.0).to(dtype)
    return OceanState(uo=z, vo=z, eta=z, sst=sst)


def init_land(grid: Grid, dtype=torch.float32) -> LandState:
    z = torch.zeros(grid.shape, dtype=dtype, device=grid.lat.device)
    return LandState(W_land=z, S_snow=z, C_snow=z, glacier_mask=torch.zeros_like(z, dtype=torch.bool))


def init_clock(grid: Grid, t0_seconds: float = 0.0, dtype=torch.float32) -> ClockState:
    two_pi = 2.0 * math.pi
    z = torch.zeros(grid.shape, dtype=dtype, device=grid.lat.device)
    return ClockState(
        t_seconds=_scalar(t0_seconds, grid, dtype),
        step_idx=0,
        phase_rot=_scalar(math.fmod(const.PLANET_OMEGA * t0_seconds, two_pi), grid, dtype),
        phase_binary=_scalar(math.fmod(orbital.OMEGA_BINARY * t0_seconds, two_pi), grid, dtype),
        phase_planet=_scalar(math.fmod(orbital.OMEGA_PLANET * t0_seconds, two_pi), grid, dtype),
        precip_acc_day=z,
        accum_t_day=0.0,
        precip_day_last=z,
        # fires on the first step, like the reference's phyto_next_time = 0
        phyto_accum=round_to(const.DAY_SECONDS, dtype),
    )


def init_albedo_caches(grid: Grid, dtype=torch.float32) -> AlbedoCaches:
    nan = torch.full(grid.shape, math.nan, dtype=dtype, device=grid.lat.device)
    false = torch.zeros((), dtype=torch.bool, device=grid.lat.device)
    return AlbedoCaches(alpha_ecology_last=nan, alpha_banded_daily=nan, has_alpha_banded=false,
                        alpha_water_scalar=torch.zeros_like(nan), has_alpha_water=false)


def init_energy_state(cfg: SimConfig, grid: Grid, dtype=torch.float32) -> EnergyState:
    return EnergyState(lw_eps0=_scalar(cfg.energy.lw_eps0, grid, dtype),
                       lw_kc=_scalar(cfg.energy.lw_kc, grid, dtype))
