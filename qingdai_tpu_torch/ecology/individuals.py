"""Vectorized sampled-individual pool (port of
``qingdai_tpu/ecology/individuals.py``).

Sampled cells and per-individual species ids are drawn once at build time
with NumPy's ``default_rng(42)``, as in the JAX package, so they are static
index tensors. The substep fires on a device condition and is selected with
``torch.where``; the day's per-individual energy and stress are materialized
from per-cell buffers once a day. Scatter-adds are ``index_add``: on a card
their order is not fixed, so the last bits of a sum may differ between runs.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..config import EcologyConfig
from . import population as pop_mod
from .population import EcoState, EcoStatic
from .spectral import dual_star_insolation_to_bands_points


@dataclasses.dataclass(frozen=True)
class IndivStatic:
    n_cells: int
    per_cell: int
    ns: int
    fires_per_day: int
    sample_j: torch.Tensor      # [C] int64
    sample_i: torch.Tensor      # [C] int64
    cell_index: torch.Tensor    # [N] int64 individual → cell
    species_id: torch.Tensor    # [N] int64


@dataclasses.dataclass(frozen=True)
class IndivState:
    """Sampled-individual prognostics. The substep (``fires_per_day`` times a
    day) touches only per-cell buffers: the banded irradiance-time integral
    ``J_cells`` and a soil ring buffer; ``E_day`` holds the last completed
    day's per-individual energy."""
    E_day: torch.Tensor         # [N]
    water_stress_days: torch.Tensor  # [N]
    Ab: torch.Tensor            # [N, NB] per-individual band weights
    tol: torch.Tensor           # [N] drought tolerance
    substep_accum: torch.Tensor  # 0-d seconds
    J_cells: torch.Tensor       # [C, NB] Σ I_b·Δt since the last daily step
    soil_buf: torch.Tensor      # [F, C] per-fire soil index ring buffer
    fire_idx: torch.Tensor      # int32 0-d, fires since the last daily step


def build_individuals(grid_shape, land_mask, es: EcoStatic, eco: EcoState,
                      cfg: EcologyConfig, device, dtype=torch.float32):
    """(IndivStatic, IndivState) with the JAX package's draws."""
    H, W = grid_shape
    land = np.asarray(land_mask) == 1
    land_idx = np.flatnonzero(land.ravel())
    n_land = land_idx.size
    n_cells = max(1, int(cfg.indiv_sample_frac * n_land))
    rng = np.random.default_rng(seed=42)  # individuals.py:79
    sampled = land_idx if n_cells >= n_land else rng.choice(land_idx, n_cells, replace=False)
    jj = sampled // W
    ii = sampled % W
    C = int(jj.size)
    per_cell = int(cfg.indiv_per_cell)
    N = C * per_cell
    cell_index = np.repeat(np.arange(C), per_cell)

    sp_w = eco.species_weights.cpu().numpy()
    active = eco.active.cpu().numpy()
    w = np.where(active, np.maximum(sp_w, 0.0), 0.0)
    w = w / w.sum() if w.sum() > 0 else np.where(active, 1.0, 0.0) / max(active.sum(), 1)
    species_id = rng.choice(np.arange(es.S, dtype=np.int32), size=N, p=w)

    species_R = eco.R_leaf.cpu().numpy()
    Ab = species_R[species_id, :] + rng.normal(0.0, 0.02, size=(N, es.NB))
    Ab = np.clip(Ab, 0.0, 1.0)
    tol = np.clip(eco.drought_tolerance.cpu().numpy()[species_id], 0.0, 1.0)

    F = max(1, int(cfg.indiv_substeps_per_day))

    def t(x, dt_=dtype):
        return torch.as_tensor(np.asarray(x)).to(device=device, dtype=dt_)

    static = IndivStatic(
        n_cells=C, per_cell=per_cell, ns=es.S, fires_per_day=F,
        sample_j=t(jj, torch.int64), sample_i=t(ii, torch.int64),
        cell_index=t(cell_index, torch.int64), species_id=t(species_id, torch.int64),
    )
    state = IndivState(
        E_day=torch.zeros((N,), dtype=dtype, device=device),
        water_stress_days=torch.zeros((N,), dtype=dtype, device=device),
        Ab=t(Ab), tol=t(tol), substep_accum=t(0.0),
        J_cells=torch.zeros((C, es.NB), dtype=dtype, device=device),
        soil_buf=torch.zeros((F, C), dtype=dtype, device=device),
        fire_idx=t(0, torch.int32),
    )
    return static, state


def _at_cells(ist: IndivStatic, field: torch.Tensor) -> torch.Tensor:
    return field[ist.sample_j, ist.sample_i]


def indiv_try_substep(ist: IndivStatic, st: IndivState, es: EcoStatic,
                      cfg: EcologyConfig, isr_A, isr_B, soil_idx,
                      dt: float, day_length_seconds: float,
                      glacier_mask=None) -> IndivState:
    """Accumulate banded energy and water stress at the substep cadence
    (individuals.py:142-191). The fire is a device condition: the cheap fire
    branch is computed every step and selected. ``glacier_mask`` excludes
    glaciated sampled cells."""
    period = float(day_length_seconds) / float(cfg.indiv_substeps_per_day)
    accum = st.substep_accum + dt
    fire = accum >= period

    I_b_cells = dual_star_insolation_to_bands_points(
        _at_cells(ist, isr_A), _at_cells(ist, isr_B), es.specA, es.specB, es.T_ray)  # [C, NB]
    if glacier_mask is not None:
        I_b_cells = torch.where(_at_cells(ist, glacier_mask)[:, None], 0.0, I_b_cells)
    soil_cells = _at_cells(ist, soil_idx).to(st.soil_buf.dtype)
    slot = torch.remainder(st.fire_idx, ist.fires_per_day).to(torch.int64).reshape(1)
    soil_buf = st.soil_buf.index_copy(0, slot, soil_cells[None])
    return dataclasses.replace(
        st,
        J_cells=torch.where(fire, st.J_cells + I_b_cells * period, st.J_cells),
        soil_buf=torch.where(fire, soil_buf, st.soil_buf),
        fire_idx=st.fire_idx + fire.to(st.fire_idx.dtype),
        substep_accum=torch.where(fire, accum - period, accum))


def materialize_day(ist: IndivStatic, st: IndivState):
    """Per-individual (E_day, added stress days) from the per-cell buffers,
    equal to the reference's per-substep accumulation by linearity
    (individuals.py:168-191)."""
    cell = ist.cell_index
    E_day = torch.sum(st.Ab * st.J_cells.index_select(0, cell), dim=1)   # [N]
    F = ist.fires_per_day
    valid = (torch.arange(F, device=cell.device) < st.fire_idx)[:, None]  # [F,1]
    soil_pi = st.soil_buf.index_select(1, cell)                          # [F,N]
    stressed = valid & (soil_pi < st.tol[None, :])
    add_wsd = torch.sum(stressed, dim=0).to(E_day.dtype) / float(F)
    return E_day, add_wsd


def _median_midpoint(x: torch.Tensor) -> torch.Tensor:
    """jnp.median of a 1-d tensor: the mean of the two middle order
    statistics ('midpoint'), not torch.median's lower one."""
    s = torch.sort(x).values
    n = x.shape[0]
    return (s[(n - 1) // 2] + s[n // 2]) * 0.5


def indiv_step_daily(ist: IndivStatic, st: IndivState, es: EcoStatic,
                     eco: EcoState, cfg: EcologyConfig, soil_idx):
    """End of day: species-energy weights per sampled cell rewrite the LAI_SK
    split; LAI growth/decay with a 4-neighbour recruit spill; seed-bank
    coupling; stress decay (individuals.py:193-361). Returns
    (IndivState, EcoState)."""
    S, C = ist.ns, ist.n_cells
    sp, cell = ist.species_id, ist.cell_index
    dtype = st.E_day.dtype

    E_day, add_wsd = materialize_day(ist, st)
    wsd_now = st.water_stress_days + add_wsd

    flat_idx = sp * C + cell
    E_s_c = torch.zeros((S * C,), dtype=dtype, device=sp.device).index_add(
        0, flat_idx, E_day).reshape(S, C)
    denom = torch.sum(E_s_c, dim=0) + 1e-12
    W_s_c = E_s_c / denom[None, :]

    mean_stress = torch.zeros((S, C), dtype=dtype, device=sp.device)
    if cfg.indiv_stress_penalty > 0.0:
        zeros = torch.zeros((S * C,), dtype=dtype, device=sp.device)
        stress_s_c = zeros.index_add(0, flat_idx, wsd_now).reshape(S, C)
        cnt_s_c = zeros.index_add(0, flat_idx, torch.ones_like(wsd_now)).reshape(S, C)
        mean_stress = torch.where(cnt_s_c > 0, stress_s_c / torch.clamp(cnt_s_c, min=1.0), 0.0)
        pen = 1.0 / (1.0 + cfg.indiv_stress_penalty * mean_stress)
        W_s_c = W_s_c * pen
        W_s_c = W_s_c / (torch.sum(W_s_c, dim=0) + 1e-12)[None, :]

    # sampled-cell LAI columns [S, K, C]
    LAI_SK = torch.clamp(eco.LAI_SK, min=0.0)
    S_, K, H, W_ = LAI_SK.shape
    flat_cells = ist.sample_j * W_ + ist.sample_i
    LAI_flat = LAI_SK.reshape(S_, K, H * W_)
    cols = LAI_flat.index_select(2, flat_cells)                # [S,K,C]
    total_k = torch.sum(cols, dim=0)                           # [K,C]
    total_old = torch.sum(total_k, dim=0)                      # [C]

    medE = torch.clamp(_median_midpoint(denom), min=1e-12)
    e_scaled = denom / medE
    mean_stress_cell = torch.sum(mean_stress * W_s_c, dim=0)
    dLAI = (cfg.lai_growth_rate * (e_scaled - 1.0)
            - cfg.lai_decay_rate * mean_stress_cell)
    dLAI = dLAI * torch.clamp(total_old, min=1.0)
    new_total = torch.clamp(total_old + dLAI, 0.0, cfg.lai_max)
    scale = torch.where(total_old > 0.0, new_total / (total_old + 1e-12),
                        new_total / max(cfg.lai_max, 1.0))

    new_k = total_k * scale[None, :]                           # [K,C]
    new_cols = W_s_c[:, None, :] * new_k[None, :, :]           # [S,K,C]
    # the sampled cells are distinct, so this is a plain write
    LAI_flat = LAI_flat.index_copy(2, flat_cells, new_cols)

    # recruit spill to 4 neighbours (individuals.py:292-306); neighbours of
    # two sampled cells may coincide, so the adds accumulate
    recruit = torch.clamp(new_total - total_old, min=0.0) * cfg.lai_recruit_frac
    share = recruit / 4.0
    add_each = ((share / max(K, 1))[None, None, :] * W_s_c[:, None, :]).expand(S, K, C)
    jn = [torch.clamp(ist.sample_j - 1, min=0), torch.clamp(ist.sample_j + 1, max=H - 1),
          ist.sample_j, ist.sample_j]
    in_ = [(ist.sample_i - 1) % W_, (ist.sample_i + 1) % W_, ist.sample_i, ist.sample_i]
    for jj, ii in zip(jn, in_):
        LAI_flat = LAI_flat.index_add(2, jj * W_ + ii, add_each)

    LAI_SK = torch.clamp(LAI_flat.reshape(S_, K, H, W_), 0.0, cfg.lai_max)
    eco = dataclasses.replace(eco, LAI_SK=LAI_SK)
    eco = pop_mod.recompute_weights_from_LAI(eco, es)

    # seed-bank coupling (individuals.py:314-337); the reference's soil gate
    # there never runs, QD_ECO_INDIV_SEED_SOIL_GATE opts into it
    soil_cells = _at_cells(ist, soil_idx)
    if cfg.indiv_seed_couple:
        seeds_cells = (max(0.0, cfg.repro_fraction) * torch.clamp(denom, min=0.0)
                       / max(cfg.seed_energy, 1e-12))
        if cfg.indiv_seed_soil_gate:
            seeds_cells = seeds_cells * torch.clamp(soil_cells, 0.0, 1.0)
        seeds_cells = cfg.seed_bank_retain * seeds_cells
        sb = eco.seed_bank.reshape(-1).index_add(0, flat_cells, seeds_cells).reshape(H, W_)
        eco = dataclasses.replace(eco, seed_bank=torch.clamp(sb, 0.0, cfg.seed_bank_max))

    # reset the buffers and decay the stress (individuals.py:339-356)
    ok = soil_cells.index_select(0, ist.cell_index) >= st.tol
    wsd = torch.where(ok, wsd_now * cfg.indiv_stress_decay,
                      torch.clamp(wsd_now + 1.0, max=365.0))
    st = dataclasses.replace(st, E_day=E_day, water_stress_days=wsd,
                             J_cells=torch.zeros_like(st.J_cells),
                             fire_idx=torch.zeros_like(st.fire_idx))
    return st, eco
