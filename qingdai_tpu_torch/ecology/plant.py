"""Individual plant model: FSM, banded energy and allocation (port of
``qingdai_tpu/ecology/plant.py``).

- ``Plant``: the host-side scalar plant with the reference's API
  (update_substep / update_substep_bands / update_one_day → PlantReport),
  NumPy only and equal to the JAX package's source
  (``tests/test_torch_repairs.py``).
- ``PlantPoolState`` and its functions: every per-plant field is a tensor
  over N plants, and the SEED→GROWING→MATURE→SENESCENT→DEAD state machine is
  select logic, so a whole population advances in a few elementwise
  launches. ``state`` stays int8 and ``age_days`` int32.
"""

from __future__ import annotations

import dataclasses
import os
from enum import IntEnum
from typing import Dict, Optional

import numpy as np
import torch

from ..grid import resolve_device
from .genes import Genes


class PlantState(IntEnum):
    SEED = 0
    GROWING = 1
    MATURE = 2
    SENESCENT = 3
    DEAD = 4


@dataclasses.dataclass
class PlantReport:
    energy_gain: float
    leaf_area: float
    state: PlantState
    transitioned_to: Optional[PlantState] = None
    seed_count: int = 0
    reflectance_bands: Optional[np.ndarray] = None


MATURE_LEAF_AREA = 0.2  # m^2, maturity threshold (plant.py:156)


def _stress_days_env() -> float:
    try:
        return float(os.getenv("QD_ECO_STRESS_WATER_DAYS", "7"))
    except ValueError:
        return 7.0


@dataclasses.dataclass
class Plant:
    """Host-side scalar plant with the reference semantics."""
    genes: Genes
    state: PlantState = PlantState.SEED
    age_days: int = 0
    biomass: Dict[str, float] = dataclasses.field(
        default_factory=lambda: {"root": 0.0, "stem": 0.0, "leaf": 0.0})
    energy_storage: float = 0.0
    gdd_accum: float = 0.0
    water_stress_days: float = 0.0
    height: float = 0.0
    leaf_area: float = 0.0
    _E_day_buffer: float = 0.0
    height_exponent: float = 0.8
    repro_fraction: float = 0.2

    def effective_leaf_area(self) -> float:
        return max(0.0, float(self.leaf_area))

    def is_alive(self) -> bool:
        return self.state != PlantState.DEAD

    def update_substep(self, I_eff_scalar, dt_seconds, soil_water_index=None):
        """Sub-daily energy accumulation (plant.py:65-79)."""
        if not self.is_alive():
            return
        self._E_day_buffer += max(0.0, float(I_eff_scalar)) * float(dt_seconds)
        if soil_water_index is not None and \
                float(soil_water_index) < self.genes.drought_tolerance:
            self.water_stress_days += float(dt_seconds) / 86400.0

    def update_substep_bands(self, I_bands, A_b_genotype, dt_seconds,
                             delta_lambda=None, light_availability=1.0,
                             soil_water_index=None):
        """Banded sub-daily energy: dE = Σ_b I_b·A_eff·Δλ·lv·dt with
        Beer-Lambert self-shading f_LAI (plant.py:81-128)."""
        if not self.is_alive():
            return
        I_b = np.asarray(I_bands, float).ravel()
        A_b = np.clip(np.asarray(A_b_genotype, float).ravel(), 0.0, 1.0)
        dl = (np.ones_like(I_b) if delta_lambda is None
              else np.asarray(delta_lambda, float).ravel())
        if dl.shape[0] != I_b.shape[0]:
            dl = np.ones_like(I_b)
        k_ext = float(os.getenv("QD_ECO_LAI_K_EXT", "0.4"))
        f_LAI = 1.0 - np.exp(-k_ext * max(0.0, self.leaf_area))
        A_eff = np.clip(A_b * f_LAI, 0.0, 1.0)
        dE = float(np.sum(I_b * A_eff * dl)) * max(0.0, light_availability) \
            * float(dt_seconds)
        if dE > 0.0:
            self._E_day_buffer += dE
        if soil_water_index is not None and \
                float(soil_water_index) < self.genes.drought_tolerance:
            self.water_stress_days += float(dt_seconds) / 86400.0

    def _maybe_transition(self, Ts_day, day_length_hours):
        """FSM (plant.py:130-173)."""
        transitioned = None
        gdd_today = max(0.0, float(Ts_day) - 273.15) * max(0.0, day_length_hours) / 24.0
        self.gdd_accum += gdd_today
        if self.age_days >= int(self.genes.lifespan_days):
            self.state = PlantState.DEAD
            return PlantState.DEAD
        stress_lim = _stress_days_env()
        if self.state == PlantState.SEED:
            if self.gdd_accum >= self.genes.gdd_germinate and self.water_stress_days < 1.0:
                self.state = transitioned = PlantState.GROWING
        elif self.state == PlantState.GROWING:
            if self.leaf_area >= MATURE_LEAF_AREA:
                self.state = transitioned = PlantState.MATURE
        elif self.state == PlantState.MATURE:
            if (self.water_stress_days >= stress_lim
                    or self.age_days >= int(0.9 * self.genes.lifespan_days)):
                self.state = transitioned = PlantState.SENESCENT
        elif self.state == PlantState.SENESCENT:
            if self.water_stress_days >= stress_lim + 5:
                self.state = transitioned = PlantState.DEAD
        return transitioned

    def _apply_allocation(self, E_gain_day):
        """Energy → root/stem/leaf biomass; height ∝ stem^0.8 (plant.py:175-195)."""
        if E_gain_day <= 0.0 or not self.is_alive():
            return
        g = self.genes
        E_repro = (self.repro_fraction * E_gain_day
                   if self.state == PlantState.MATURE else 0.0)
        E_work = max(0.0, E_gain_day - E_repro)
        self.biomass["root"] += g.alloc_root * E_work
        self.biomass["stem"] += g.alloc_stem * E_work
        self.biomass["leaf"] += g.alloc_leaf * E_work
        self.height = max(0.0, self.biomass["stem"] ** self.height_exponent)
        self.leaf_area = max(0.0, self.biomass["leaf"] * g.leaf_area_per_energy)
        self.energy_storage += E_repro

    def update_one_day(self, Ts_day, day_length_hours, soil_water_index,
                       I_bands_weighted_scalar=None, *, I_bands=None,
                       A_b_genotype=None, delta_lambda=None,
                       light_availability=1.0) -> PlantReport:
        """Daily slow path (plant.py:197-305)."""
        if not self.is_alive():
            return PlantReport(0.0, self.effective_leaf_area(), self.state)
        transitioned = self._maybe_transition(Ts_day, day_length_hours)

        E_banded, R_b = 0.0, None
        if I_bands is not None and A_b_genotype is not None:
            I_b = np.asarray(I_bands, float).ravel()
            A_b = np.clip(np.asarray(A_b_genotype, float).ravel(), 0.0, 1.0)
            dl = (np.ones_like(I_b) if delta_lambda is None
                  else np.asarray(delta_lambda, float).ravel())
            if dl.shape[0] != I_b.shape[0]:
                dl = np.ones_like(I_b)
            k_ext = float(os.getenv("QD_ECO_LAI_K_EXT", "0.4"))
            fmin = float(os.getenv("QD_ECO_LAI_FMIN", "0.05"))
            f_LAI = max(fmin, 1.0 - np.exp(-k_ext * max(0.0, self.leaf_area)))
            A_eff = np.clip(A_b * f_LAI, 0.0, 1.0)
            E_banded = float(np.sum(I_b * A_eff * dl)) * max(0.0, light_availability)
            R_b = np.clip(1.0 - A_eff, 0.0, 1.0)

        E_gain = E_banded + max(0.0, self._E_day_buffer) + \
            (max(0.0, float(I_bands_weighted_scalar))
             if I_bands_weighted_scalar is not None else 0.0)
        self._E_day_buffer = 0.0
        self._apply_allocation(E_gain)
        if soil_water_index >= self.genes.drought_tolerance:
            self.water_stress_days = 0.0
        seed_count = 0
        if self.state == PlantState.MATURE and self.energy_storage > 0.0:
            seed_count = int(self.energy_storage)
            self.energy_storage -= seed_count
        self.age_days += 1
        return PlantReport(E_gain, self.effective_leaf_area(), self.state,
                           transitioned, seed_count, R_b)


# ---------------------------------------------------------------------------
# Vectorized pool
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class PlantPoolState:
    """N plants as tensors (the pool form of the Plant dataclass)."""
    state: torch.Tensor            # int8 PlantState
    age_days: torch.Tensor         # int32
    biomass_root: torch.Tensor
    biomass_stem: torch.Tensor
    biomass_leaf: torch.Tensor
    energy_storage: torch.Tensor
    gdd_accum: torch.Tensor
    water_stress_days: torch.Tensor
    leaf_area: torch.Tensor
    E_day_buffer: torch.Tensor
    # per-plant genome columns
    alloc: torch.Tensor            # [N,3]
    leaf_area_per_energy: torch.Tensor
    drought_tolerance: torch.Tensor
    gdd_germinate: torch.Tensor
    lifespan_days: torch.Tensor


def init_plant_pool(n: int, genes: Genes, dtype=torch.float32,
                    device="cuda") -> PlantPoolState:
    device = resolve_device(device)
    z = torch.zeros((n,), dtype=dtype, device=device)

    def full(v):
        return torch.full((n,), v, dtype=dtype, device=device)

    return PlantPoolState(
        state=torch.zeros((n,), dtype=torch.int8, device=device),
        age_days=torch.zeros((n,), dtype=torch.int32, device=device),
        biomass_root=z, biomass_stem=z, biomass_leaf=z,
        energy_storage=z, gdd_accum=z, water_stress_days=z,
        leaf_area=z, E_day_buffer=z,
        alloc=torch.tensor([genes.alloc_root, genes.alloc_stem, genes.alloc_leaf],
                           dtype=dtype, device=device).repeat(n, 1),
        leaf_area_per_energy=full(genes.leaf_area_per_energy),
        drought_tolerance=full(genes.drought_tolerance),
        gdd_germinate=full(genes.gdd_germinate),
        lifespan_days=full(float(genes.lifespan_days)),
    )


def _scalar(x, like: torch.Tensor) -> torch.Tensor:
    """A Python number as a 0-d float64 tensor on ``like``'s device (the JAX
    package's weakly typed scalar: its arithmetic stays in float64 until it
    meets the pool's fields); a tensor as it is."""
    return x if isinstance(x, torch.Tensor) else torch.tensor(
        x, dtype=torch.float64, device=like.device)


def pool_substep_bands(p: PlantPoolState, I_bands, A_b, dt_seconds,
                       delta_lambda, soil_water_index,
                       k_ext: float = 0.4) -> PlantPoolState:
    """Vectorized update_substep_bands: I_bands [N,NB], A_b [N,NB]."""
    alive = p.state != int(PlantState.DEAD)
    f_LAI = 1.0 - torch.exp(-k_ext * torch.clamp(p.leaf_area, min=0.0))
    A_eff = torch.clamp(A_b * f_LAI[:, None], 0.0, 1.0)
    dE = torch.sum(I_bands * A_eff * delta_lambda[None, :], dim=1) * dt_seconds
    E = p.E_day_buffer + torch.where(alive, torch.clamp(dE, min=0.0), 0.0)
    stressed = alive & (soil_water_index < p.drought_tolerance)
    # the mask times the increment: a where of two Python numbers would round
    # the increment to the default dtype
    wsd = p.water_stress_days + stressed.to(p.water_stress_days.dtype) * (dt_seconds / 86400.0)
    return dataclasses.replace(p, E_day_buffer=E, water_stress_days=wsd)


def pool_step_daily(p: PlantPoolState, Ts_day, day_length_hours,
                    soil_water_index, stress_days_limit: float = 7.0
                    ) -> tuple[PlantPoolState, torch.Tensor]:
    """Vectorized update_one_day. Returns (pool', seed_count [N])."""
    S = p.state
    dtype = p.gdd_accum.dtype
    alive = S != int(PlantState.DEAD)
    gdd_today = torch.clamp(_scalar(Ts_day, S) - 273.15, min=0.0) * day_length_hours / 24.0
    gdd = p.gdd_accum + torch.where(alive, gdd_today, 0.0).to(dtype)

    # transitions (priority identical to the scalar FSM); a where of an int8
    # tensor and a Python int stays int8
    dead_by_age = alive & (p.age_days >= p.lifespan_days.to(torch.int32))
    S = torch.where(dead_by_age, int(PlantState.DEAD), S)
    germ = (S == int(PlantState.SEED)) & (gdd >= p.gdd_germinate) \
        & (p.water_stress_days < 1.0)
    S = torch.where(germ, int(PlantState.GROWING), S)
    mature = (S == int(PlantState.GROWING)) & (p.leaf_area >= MATURE_LEAF_AREA)
    S = torch.where(mature, int(PlantState.MATURE), S)
    # ``.to(torch.int32)`` truncates, as ``astype(int32)`` does
    senesce = (S == int(PlantState.MATURE)) & (
        (p.water_stress_days >= stress_days_limit)
        | (p.age_days >= (0.9 * p.lifespan_days).to(torch.int32)))
    S = torch.where(senesce, int(PlantState.SENESCENT), S)
    die = (S == int(PlantState.SENESCENT)) & \
        (p.water_stress_days >= stress_days_limit + 5)
    S = torch.where(die, int(PlantState.DEAD), S).to(torch.int8)

    alive2 = S != int(PlantState.DEAD)
    E_gain = torch.where(alive2, torch.clamp(p.E_day_buffer, min=0.0), 0.0)
    is_mature = S == int(PlantState.MATURE)
    E_repro = torch.where(is_mature, 0.2 * E_gain, 0.0)
    E_work = torch.clamp(E_gain - E_repro, min=0.0)
    root = p.biomass_root + p.alloc[:, 0] * E_work
    stem = p.biomass_stem + p.alloc[:, 1] * E_work
    leaf = p.biomass_leaf + p.alloc[:, 2] * E_work
    leaf_area = torch.clamp(leaf * p.leaf_area_per_energy, min=0.0)
    storage = p.energy_storage + E_repro
    seed_count = torch.where(is_mature, torch.floor(storage), 0.0)
    storage = storage - seed_count

    wsd = torch.where(soil_water_index >= p.drought_tolerance, 0.0,
                      p.water_stress_days)
    return dataclasses.replace(
        p, state=S, age_days=p.age_days + 1, gdd_accum=gdd,
        biomass_root=root, biomass_stem=stem, biomass_leaf=leaf,
        leaf_area=leaf_area, energy_storage=storage,
        water_stress_days=wsd,
        E_day_buffer=torch.zeros_like(p.E_day_buffer)), seed_count
