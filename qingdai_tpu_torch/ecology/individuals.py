"""Vectorized sampled-individual pool (port of
``qingdai_tpu/ecology/individuals.py``).

Sampled cells and per-individual species ids are drawn once at build time
with NumPy's ``default_rng(42)``, as in the JAX package, so they are static
index tensors. The substep fires on a device condition and is selected with
``torch.where``; the day's per-individual energy and stress are materialized
from per-cell buffers once a day. Every sum has a fixed order of additions,
so a run on the card replays bit for bit: the per-species sums of a cell's
individuals are sums over a static one-hot of their species, and the recruit
spill adds through ``ops.scatter`` plans.

On a rank of the longitude mesh the pool stays replicated
(``shard_indiv_static``): a sampled cell's values come from its owner
through one ``all_reduce_sum`` of a [C] vector (the owner's value among
zeros, exact), and each rank writes back only the cells and spill targets
in its own columns, each target's additions in the whole grid's order.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..config import EcologyConfig
from ..ops.scatter import index_add_fixed, scatter_plan
from ..parallel.halo import all_reduce_sum, single
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
    # [C, per_cell, S]: 1 where the cell's individual is of the species
    # (individual n is the (n mod per_cell)-th of cell n // per_cell)
    species_onehot: torch.Tensor
    spill: tuple                # ScatterPlan of each recruit-spill direction


@dataclasses.dataclass(frozen=True)
class IndivShard(IndivStatic):
    """The pool's statics on a rank of the longitude mesh
    (``shard_indiv_static``): the mesh, which sampled cells the rank owns
    ([C] bool, and their indices), every cell's flat index in the rank's
    columns (clamped where not owned), and each spill direction's (plan of
    its owned targets, their source rows)."""
    mesh: object = None
    own: Optional[torch.Tensor] = None
    own_idx: Optional[torch.Tensor] = None
    local_flat: Optional[torch.Tensor] = None
    spill_own: tuple = ()


def _mesh(ist: IndivStatic):
    return ist.mesh if isinstance(ist, IndivShard) else None


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
    onehot = species_id.reshape(C, per_cell)[:, :, None] == np.arange(es.S)[None, None, :]
    spill = tuple(scatter_plan(a * W + b, device) for a, b in zip(*_spill_targets(jj, ii, H, W)))

    def t(x, dt_=dtype):
        return torch.as_tensor(np.asarray(x)).to(device=device, dtype=dt_)

    static = IndivStatic(
        n_cells=C, per_cell=per_cell, ns=es.S, fires_per_day=F,
        sample_j=t(jj, torch.int64), sample_i=t(ii, torch.int64),
        cell_index=t(cell_index, torch.int64), species_id=t(species_id, torch.int64),
        species_onehot=t(onehot), spill=spill,
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


def _spill_targets(jj, ii, H: int, W: int):
    """The recruit spill's target rows and columns, one [C] array a
    direction (individuals.py:292-306, as the JAX package pairs them);
    targets of one direction coincide at a clamped pole row."""
    return ([np.maximum(jj - 1, 0), np.minimum(jj + 1, H - 1), jj, jj],
            [(ii - 1) % W, (ii + 1) % W, ii, ii])


def shard_indiv_static(ist: IndivStatic, mesh, n_lat: int, n_lon: int) -> IndivShard:
    """The pool's statics on a rank of ``mesh``: the pool whole, with the
    rank's sampled cells, their flat indices in its columns and its share
    of each spill direction."""
    lon0, w = mesh.cols(n_lon)
    jj, ii = ist.sample_j.cpu().numpy(), ist.sample_i.cpu().numpy()
    own = (ii >= lon0) & (ii < lon0 + w)
    dev = ist.sample_j.device
    spill_own = []
    for tj, ti in zip(*_spill_targets(jj, ii, n_lat, n_lon)):
        sel = np.flatnonzero((ti >= lon0) & (ti < lon0 + w))
        spill_own.append((scatter_plan(tj[sel] * w + ti[sel] - lon0, dev),
                          torch.as_tensor(sel, dtype=torch.int64).to(dev)))
    as_idx = lambda x: torch.as_tensor(np.asarray(x, np.int64)).to(dev)
    return IndivShard(
        **{f.name: getattr(ist, f.name) for f in dataclasses.fields(IndivStatic)}, mesh=mesh,
        own=torch.as_tensor(own).to(dev), own_idx=as_idx(np.flatnonzero(own)),
        local_flat=as_idx(jj * w + np.clip(ii - lon0, 0, w - 1)), spill_own=tuple(spill_own))


def _at_cells(ist: IndivStatic, field: torch.Tensor) -> torch.Tensor:
    """The field's value at each sampled cell [C]; on a mesh from the
    cell's owner (the others add zeros)."""
    return _at_cells_many(ist, field)[0]


def _at_cells_many(ist: IndivStatic, *fields) -> tuple:
    """``_at_cells`` of each field; on a mesh with one collective."""
    if single(_mesh(ist)):
        return tuple(f[ist.sample_j, ist.sample_i] for f in fields)
    got = _from_owners(ist, torch.stack([f.reshape(-1).to(torch.float64) for f in fields]), 1)
    return tuple(g > 0.5 if f.dtype == torch.bool else g.to(f.dtype)
                 for f, g in zip(fields, got))


def _from_owners(ist: IndivStatic, flat: torch.Tensor, dim: int) -> torch.Tensor:
    """``flat``'s entries along ``dim`` at the sampled cells, summed over
    ranks with zeros where a rank does not own the cell."""
    vals = flat.index_select(dim, ist.local_flat)
    own = ist.own.reshape((-1,) + (1,) * (vals.dim() - dim - 1))
    if vals.dtype == torch.bool:
        return all_reduce_sum((vals & own).to(torch.int32), ist.mesh) > 0
    return all_reduce_sum(torch.where(own, vals, torch.zeros_like(vals)), ist.mesh)


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

    glacier = () if glacier_mask is None else (glacier_mask,)
    at = _at_cells_many(ist, isr_A, isr_B, soil_idx, *glacier)
    I_b_cells = dual_star_insolation_to_bands_points(
        at[0], at[1], es.specA, es.specB, es.T_ray)  # [C, NB]
    if glacier_mask is not None:
        I_b_cells = torch.where(at[3][:, None], 0.0, I_b_cells)
    soil_cells = at[2].to(st.soil_buf.dtype)
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
    S, C, P = ist.ns, ist.n_cells, ist.per_cell
    dtype = st.E_day.dtype
    onehot = ist.species_onehot

    def per_species(x):
        """[S, C] sums over each cell's individuals of each species."""
        return torch.sum(onehot * x.reshape(C, P, 1), dim=1).T

    E_day, add_wsd = materialize_day(ist, st)
    wsd_now = st.water_stress_days + add_wsd

    E_s_c = per_species(E_day)
    denom = torch.sum(E_s_c, dim=0) + 1e-12
    W_s_c = E_s_c / denom[None, :]

    mean_stress = torch.zeros((S, C), dtype=dtype, device=E_day.device)
    if cfg.indiv_stress_penalty > 0.0:
        stress_s_c = per_species(wsd_now)
        cnt_s_c = torch.sum(onehot, dim=1).T
        mean_stress = torch.where(cnt_s_c > 0, stress_s_c / torch.clamp(cnt_s_c, min=1.0), 0.0)
        pen = 1.0 / (1.0 + cfg.indiv_stress_penalty * mean_stress)
        W_s_c = W_s_c * pen
        W_s_c = W_s_c / (torch.sum(W_s_c, dim=0) + 1e-12)[None, :]

    # sampled-cell LAI columns [S, K, C]
    LAI_SK = torch.clamp(eco.LAI_SK, min=0.0)
    S_, K, H, W_ = LAI_SK.shape
    flat_cells = ist.sample_j * W_ + ist.sample_i
    LAI_flat = LAI_SK.reshape(S_, K, H * W_)
    sharded = not single(_mesh(ist))
    cols = (_from_owners(ist, LAI_flat, 2) if sharded
            else LAI_flat.index_select(2, flat_cells))        # [S,K,C]
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
    if sharded:
        LAI_flat = LAI_flat.index_copy(2, ist.local_flat.index_select(0, ist.own_idx),
                                       new_cols.index_select(2, ist.own_idx))
    else:
        LAI_flat = LAI_flat.index_copy(2, flat_cells, new_cols)

    # recruit spill to 4 neighbours (individuals.py:292-306); neighbours of
    # two sampled cells may coincide, so the adds accumulate, in a fixed order
    recruit = torch.clamp(new_total - total_old, min=0.0) * cfg.lai_recruit_frac
    share = recruit / 4.0
    add_each = ((share / max(K, 1))[None, None, :] * W_s_c[:, None, :]).expand(S, K, C)
    if sharded:
        for plan, rows in ist.spill_own:
            LAI_flat = index_add_fixed(LAI_flat, 2, plan, add_each.index_select(2, rows))
    else:
        for plan in ist.spill:
            LAI_flat = index_add_fixed(LAI_flat, 2, plan, add_each)

    LAI_SK = torch.clamp(LAI_flat.reshape(S_, K, H, W_), 0.0, cfg.lai_max)
    eco = dataclasses.replace(eco, LAI_SK=LAI_SK)
    eco = pop_mod.recompute_weights_from_LAI(eco, es, _mesh(ist))

    # seed-bank coupling (individuals.py:314-337); the reference's soil gate
    # there never runs, QD_ECO_INDIV_SEED_SOIL_GATE opts into it
    soil_cells = _at_cells(ist, soil_idx)
    if cfg.indiv_seed_couple:
        seeds_cells = (max(0.0, cfg.repro_fraction) * torch.clamp(denom, min=0.0)
                       / max(cfg.seed_energy, 1e-12))
        if cfg.indiv_seed_soil_gate:
            seeds_cells = seeds_cells * torch.clamp(soil_cells, 0.0, 1.0)
        seeds_cells = cfg.seed_bank_retain * seeds_cells
        if sharded:
            sb = eco.seed_bank.reshape(-1).index_add(
                0, ist.local_flat.index_select(0, ist.own_idx),
                seeds_cells.index_select(0, ist.own_idx)).reshape(H, W_)
        else:
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
