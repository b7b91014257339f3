"""Grid-scale population manager: prognostic layered LAI [S, K, H, W]
(port of ``qingdai_tpu/ecology/population.py``).

As in the JAX package, the species axis is static at ``S_slots =
max(QD_ECO_NS, QD_ECO_SPECIES_MAX)`` with an ``active`` mask, spread is
vectorized over species and selected by a per-species mode mask, and
mutation activates a slot. Every data-dependent choice is a ``torch.where``
on device values (the sub-daily canopy refresh, the mutation's fire), so
the step never waits on the card. Mutation draws from the model's
``torch.Generator``; its numbers differ from the JAX package's threefry
stream, so parity holds with mutation off and the mutation itself is
checked for its invariants.

Reference quirk kept, as in the JAX package: with the default K=1 the daily
growth/senescence term does not reach the SK tensor (QD_ECO_FIX_K1_GROWTH=1
applies it).
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch

from ..config import EcologyConfig
from . import genes as genes_mod
from . import spectral as spec


@dataclasses.dataclass(frozen=True)
class EcoStatic:
    """Build-time ecology constants."""
    S: int                        # species slots
    K: int                        # cohort layers
    NB: int
    fix_k1_growth: bool
    land: torch.Tensor            # bool [H,W]
    lambda_centers: torch.Tensor  # [NB]
    w_b: torch.Tensor             # [NB] normalized band weights
    alpha_leaf_scalar: torch.Tensor  # 0-d: Σ_b R_template[b]·w_b
    modes_seed: torch.Tensor      # bool [S]: True = 'seed' (tree), False = 'diffusion'
    specA: torch.Tensor           # [NB] star A band spectrum
    specB: torch.Tensor
    T_ray: torch.Tensor


@dataclasses.dataclass(frozen=True)
class EcoState:
    LAI_SK: torch.Tensor          # [S,K,H,W]
    E_day: torch.Tensor           # [H,W]
    seed_bank: torch.Tensor       # [H,W]
    age_days: torch.Tensor        # [H,W]
    species_weights: torch.Tensor  # [S]
    active: torch.Tensor          # bool [S]
    n_active: torch.Tensor        # int32 0-d
    R_leaf: torch.Tensor          # [S,NB]
    peaks: torch.Tensor           # [S,P,3]
    alloc: torch.Tensor           # [S,3]
    leaf_area_per_energy: torch.Tensor  # [S]
    drought_tolerance: torch.Tensor     # [S]
    gdd_germinate: torch.Tensor         # [S]
    lifespan_days: torch.Tensor         # [S]
    parent_idx: torch.Tensor      # [S] int32; -1 = founder, else mutation parent
    canopy_f: torch.Tensor        # [H,W]
    hours_accum: torch.Tensor     # 0-d
    lai_snapshot: torch.Tensor    # [H,W]
    next_recompute_hours: torch.Tensor  # 0-d
    spread_gate: torch.Tensor     # [H,W]


def build_eco(grid_shape, land_mask, cfg: EcologyConfig, device, dtype=torch.float32):
    """(EcoStatic, EcoState, bands, genes_list) from the config, the
    ``QD_ECO_*`` genome variables and the land mask, with the same NumPy
    draws as the JAX package's ``build_eco``."""
    H, W = grid_shape
    bands = spec.make_bands(cfg)
    NB = bands.nbands
    w_b = spec.band_weights(bands, cfg)
    R_template = spec.default_leaf_reflectance(bands)
    alpha_leaf_scalar = float(np.sum(R_template * w_b))

    # species weights (population.py:80-110)
    if cfg.species_weights is not None:
        w = np.clip(np.asarray(cfg.species_weights, float), 0.0, None)
        weights_from_env = True
    else:
        w = np.full((cfg.ns,), 1.0 / cfg.ns)
        weights_from_env = False
    s = w.sum()
    w = w / s if s > 0 else np.full_like(w, 1.0 / w.size)
    Ns = int(w.size)
    S = max(Ns, cfg.species_max)
    K = cfg.cohort_K

    rng = np.random.default_rng(cfg.rand_seed if cfg.rand_seed is not None else None)

    # per-species modes (population.py:177-229)
    modes = [""] * S
    for i in range(S):
        m = (os.getenv(f"QD_ECO_SPECIES_{i}_MODE", "") or "").strip().lower()
        if m in ("seed", "diffusion"):
            modes[i] = m
    unspec = [i for i in range(Ns) if not modes[i]]
    if unspec:
        if weights_from_env:
            chosen = int(rng.choice(np.arange(Ns), p=w))
            for i in unspec:
                modes[i] = "seed" if i == chosen else "diffusion"
        else:
            for i in unspec:
                modes[i] = "seed" if rng.random() < 0.5 else "diffusion"
    for i in range(Ns, S):
        if not modes[i]:
            modes[i] = "seed" if i == 1 else "diffusion"
    modes_seed = np.array([m == "seed" for m in modes])

    # genomes (adapter.py:86-138): per-species env override, else template gene
    genes_list = []
    R_rows = np.zeros((S, NB), np.float32)
    for i in range(S):
        if i < Ns:
            prefix = f"QD_ECO_SPECIES_{i}_"
            has_override = any(k.startswith(prefix) for k in os.environ)
            g = genes_mod.Genes.from_env(prefix=prefix if has_override else "QD_ECO_GENE_")
        else:
            g = genes_mod.Genes.from_env(prefix="QD_ECO_GENE_")
        if not os.getenv(f"QD_ECO_SPECIES_{i}_IDENTITY"):
            g.identity = "tree" if modes_seed[i] else "grass"
        genes_list.append(g)
        R_rows[i] = genes_mod.reflectance_from_genes(bands.lambda_centers, g)
    packed = genes_mod.pack_genes(genes_list, S)

    land = np.asarray(land_mask) == 1
    LAI0 = np.where(land, cfg.lai_init, 0.0).astype(np.float32)
    LAI_SK = np.zeros((S, K, H, W), np.float32)
    for i in range(Ns):
        LAI_SK[i, :, :, :] = w[i] * (LAI0 / K)

    weights_full = np.zeros((S,), np.float32)
    weights_full[:Ns] = w
    active = np.zeros((S,), bool)
    active[:Ns] = True

    specA, specB, T_ray = spec.star_band_spectra(bands, cfg)
    fix_k1 = os.getenv("QD_ECO_FIX_K1_GROWTH", "0") == "1"

    def t(x, dt_=dtype):
        return torch.as_tensor(np.asarray(x)).to(device=device, dtype=dt_)

    static = EcoStatic(
        S=S, K=K, NB=NB, fix_k1_growth=fix_k1,
        land=t(land, torch.bool), lambda_centers=t(bands.lambda_centers), w_b=t(w_b),
        alpha_leaf_scalar=t(alpha_leaf_scalar), modes_seed=t(modes_seed, torch.bool),
        specA=t(specA), specB=t(specB), T_ray=t(T_ray),
    )
    k = cfg.k_canopy
    total0 = LAI_SK.sum(axis=(0, 1))
    zeros = torch.zeros((H, W), dtype=dtype, device=device)
    state = EcoState(
        LAI_SK=t(LAI_SK), E_day=zeros, seed_bank=zeros, age_days=zeros,
        species_weights=t(weights_full), active=t(active, torch.bool),
        n_active=t(Ns, torch.int32), R_leaf=t(R_rows),
        peaks=t(packed["peaks"]), alloc=t(packed["alloc"]),
        leaf_area_per_energy=t(packed["leaf_area_per_energy"]),
        drought_tolerance=t(packed["drought_tolerance"]),
        gdd_germinate=t(packed["gdd_germinate"]),
        lifespan_days=t(packed["lifespan_days"]),
        parent_idx=t(np.full((S,), -1), torch.int32),
        canopy_f=t(1.0 - np.exp(-k * np.maximum(total0, 0.0))),
        hours_accum=t(0.0), lai_snapshot=t(total0),
        next_recompute_hours=t(cfg.light_update_every_hours),
        spread_gate=t(land.astype(np.float32)),
    )
    return static, state, bands, genes_list


def total_LAI(state: EcoState) -> torch.Tensor:
    return torch.sum(state.LAI_SK, dim=(0, 1))


def eco_step_subdaily(es: EcoStatic, state: EcoState, cfg: EcologyConfig,
                      isr_total, dt: float):
    """Accumulate the day's energy, refresh the canopy cache by policy, and
    return the land-only scalar ecology albedo (adapter.py:140-186)."""
    E_day = state.E_day + torch.nan_to_num(isr_total) * dt
    hours = state.hours_accum + dt / 3600.0

    lai_now = total_LAI(state)
    delta = torch.nanmean(torch.abs(lai_now - state.lai_snapshot))
    base = torch.nanmean(torch.clamp(state.lai_snapshot, min=1e-6))
    ratio = torch.where(base > 0, delta / base, delta)
    need = (hours >= state.next_recompute_hours) | (ratio >= cfg.lai_recompute_delta)
    # both branches are cheap: select on the device instead of branching
    canopy_f = torch.where(need, 1.0 - torch.exp(-cfg.k_canopy * torch.clamp(lai_now, min=0.0)),
                           state.canopy_f)
    snapshot = torch.where(need, lai_now, state.lai_snapshot)
    next_rc = torch.where(need, hours + cfg.light_update_every_hours,
                          state.next_recompute_hours)

    alpha_land = torch.clamp(es.alpha_leaf_scalar * canopy_f
                             + (1.0 - canopy_f) * cfg.soil_reflect, 0.0, 1.0)
    alpha_map = torch.where(es.land, alpha_land, torch.nan)

    new_state = dataclasses.replace(
        state, E_day=E_day, hours_accum=hours, canopy_f=canopy_f,
        lai_snapshot=snapshot, next_recompute_hours=next_rc)
    return new_state, alpha_map


def _neighbor_offsets(cfg: EcologyConfig):
    if cfg.spread_neighbors in ("moore", "8", "8n"):
        return [(-1, -1), (-1, 0), (-1, 1), (0, -1), (0, 1), (1, -1), (1, 0), (1, 1)]
    return [(-1, 0), (0, -1), (0, 1), (1, 0)]


def _roll2(x, dy, dx):
    """jnp.roll(x, shift=(dy, dx), axis=(-2, -1))."""
    return torch.roll(x, shifts=(dy, dx), dims=(-2, -1))


def eco_step_daily(es: EcoStatic, state: EcoState, cfg: EcologyConfig,
                   soil_water_index, generator: torch.Generator | None = None) -> EcoState:
    """Daily LAI update, spread, germination and mutation
    (population.py:389-596, adapter.py:429-515). ``generator`` feeds the
    mutation draws; it is needed only when QD_ECO_MUT_RATE > 0."""
    S, K = es.S, es.K
    land = es.land
    landf = land.to(state.E_day.dtype)
    P = cfg

    soil = torch.clamp(soil_water_index, 0.0, 1.0)

    repro_frac = float(np.clip(cfg.repro_fraction, 0.0, 0.95))
    growth = P.growth_per_j * (1.0 - repro_frac) * torch.nan_to_num(state.E_day)
    growth = torch.where(land, growth, 0.0)
    stress = torch.clamp(P.stress_thresh - soil, min=0.0)
    sen = torch.where(land, P.senesce_per_day * P.stress_strength * stress, 0.0)

    # spread gate from soil (population.py:423-431)
    if cfg.spread_gate_soil:
        gate = torch.where(land, torch.clamp(soil, 0.0, 1.0) ** cfg.spread_soil_exp, 0.0)
    else:
        gate = landf
    LAI_SK = torch.clamp(state.LAI_SK, min=0.0)

    if K > 1:
        # layered Beer-Lambert growth allocation (population.py:433-498)
        I_in = torch.nan_to_num(state.E_day)
        LAI_k_tot = torch.sum(LAI_SK, dim=0)  # [K,H,W]
        caps = []
        for k in range(K):
            T_k = torch.exp(-P.k_canopy * LAI_k_tot[k])
            caps.append(I_in * (1.0 - T_k))
            I_in = I_in * T_k
        cap_k = torch.stack(caps, dim=0)
        cap_sum = torch.sum(cap_k, dim=0)
        LAI_by_k = torch.sum(LAI_SK, dim=0)
        w_s_k = torch.where(LAI_by_k[None] > 0.0, LAI_SK / (LAI_by_k[None] + 1e-12), 1.0 / S)
        wcap_k = cap_k / (cap_sum[None] + 1e-12)
        has_cap = cap_sum > 0.0
        growth_SK = torch.where(has_cap[None, None], w_s_k * wcap_k[None] * growth[None, None],
                                growth[None, None] / (K * S))
        LAI_tot_prev = torch.sum(LAI_SK, dim=(0, 1))
        wsen = torch.where(LAI_tot_prev[None, None] > 0.0,
                           LAI_SK / (LAI_tot_prev[None, None] + 1e-12), 1.0 / (S * K))
        LAI_SK = torch.clamp(LAI_SK + growth_SK - wsen * sen[None, None], 0.0, P.lai_max)
        # upward layer transfer (population.py:484-494)
        if cfg.layer_upfrac > 0.0:
            for k in range(K - 1, 0, -1):
                excess = torch.clamp(LAI_SK[:, k] - LAI_SK[:, k - 1], min=0.0)
                delta = cfg.layer_upfrac * excess
                LAI_SK = LAI_SK.clone()
                LAI_SK[:, k] -= delta
                LAI_SK[:, k - 1] += delta
    elif es.fix_k1_growth:
        # opt-in deviation: apply growth/senescence to the SK tensor
        LAI_tot_prev = torch.sum(LAI_SK, dim=(0, 1))
        share = torch.where(LAI_tot_prev[None, None] > 0.0,
                            LAI_SK / (LAI_tot_prev[None, None] + 1e-12), 1.0 / (S * K))
        LAI_SK = torch.clamp(LAI_SK + share * (growth - sen)[None, None], 0.0, P.lai_max)
    # else: reference K=1 behavior, the growth term has no effect on the SK tensor

    # ---- per-species spatial spread (population.py:504-533, 604-829) ----
    seed_bank = state.seed_bank
    if cfg.spread_enable and cfg.spread_rate > 0.0:
        offsets = _neighbor_offsets(cfg)
        rate = float(max(0.0, min(0.5, cfg.spread_rate)))
        num_valid = torch.zeros_like(landf)
        for dy, dx in offsets:
            num_valid = num_valid + _roll2(landf, -dy, -dx)

        LAI_s = torch.sum(LAI_SK, dim=1)  # [S,H,W]

        # diffusion branch (population.py:604-700), vectorized over S
        outflow = rate * LAI_s * gate[None]
        share = torch.where(num_valid[None] > 0.0, outflow / (num_valid[None] + 1e-12), 0.0)
        inflow = torch.zeros_like(share)
        for dy, dx in offsets:
            inflow = inflow + _roll2(share, dy, dx)
        raw = LAI_s - outflow + inflow
        inc = raw - LAI_s
        inc_pos = torch.clamp(torch.clamp(inc, min=0.0), max=cfg.spread_dlai_max)
        dec = torch.clamp(inc, max=0.0)
        LAI_s_diff = torch.clamp(torch.where(land[None], LAI_s + inc_pos + dec, 0.0),
                                 0.0, P.lai_max)
        factor_diff = torch.where(LAI_s > 0.0, LAI_s_diff / (LAI_s + 1e-12), 0.0)

        # seed branch (population.py:708-829), vectorized over S
        E_map = torch.nan_to_num(state.E_day)
        LAI_tot = torch.sum(LAI_s, dim=0)
        share_s = torch.where(LAI_tot[None] > 0.0, LAI_s / (LAI_tot[None] + 1e-12), 0.0)
        E_repro_s = repro_frac * E_map[None] * share_s
        Seeds_s = torch.clamp(E_repro_s / max(1e-12, cfg.seed_energy), min=0.0) * landf[None]
        r_eff = rate * (1.0 - torch.exp(-Seeds_s / max(1e-12, cfg.seed_scale))) * gate[None]
        seed_mode = es.modes_seed[:, None, None] & state.active[:, None, None]
        retained = cfg.seed_bank_retain * torch.sum(torch.where(seed_mode, Seeds_s, 0.0), dim=0)
        seed_bank = torch.clamp(seed_bank + retained, 0.0, cfg.seed_bank_max)
        seeds_share = torch.where(num_valid[None] > 0.0,
                                  r_eff * Seeds_s / (num_valid[None] + 1e-12), 0.0)
        add = torch.zeros_like(seeds_share)
        for dy, dx in offsets:
            add = add + cfg.seedling_lai * _roll2(seeds_share, dy, dx)
        add = torch.clamp(add, max=cfg.seed_dlai_max) * landf[None]

        # combine per species by mode
        active_s = state.active[:, None, None]
        factor = torch.where(seed_mode, 1.0, torch.where(active_s, factor_diff, 1.0))
        LAI_SK = torch.clamp(LAI_SK * factor[:, None], 0.0, P.lai_max)
        LAI_SK = LAI_SK.clone()
        LAI_SK[:, 0] += torch.where(seed_mode, add, 0.0)
        LAI_SK = torch.clamp(LAI_SK, 0.0, P.lai_max)

    # age update (population.py:535-545)
    has_lai = (torch.sum(LAI_SK, dim=(0, 1)) > 0.0) & land
    age_days = torch.where(has_lai, state.age_days + 1.0, state.age_days)

    # germination and seed-bank decay (population.py:547-593)
    seeds_to_germ = max(0.0, cfg.seed_germinate_frac) * seed_bank * gate
    w_norm = state.species_weights / (torch.sum(state.species_weights) + 1e-12)
    add_total = cfg.seedling_lai * seeds_to_germ
    add_s0 = (w_norm[:, None, None] * add_total[None] * landf[None]).to(LAI_SK.dtype)
    LAI_SK = LAI_SK.clone()
    LAI_SK[:, 0] = torch.clamp(LAI_SK[:, 0] + add_s0, 0.0, P.lai_max)
    seed_bank = (torch.clamp(seed_bank - seeds_to_germ, min=0.0)
                 * max(0.0, 1.0 - cfg.seed_bank_decay))

    new_state = dataclasses.replace(
        state, LAI_SK=LAI_SK, seed_bank=seed_bank, age_days=age_days,
        E_day=torch.zeros_like(state.E_day), spread_gate=gate)

    # ---- mutation (adapter.py:438-466, _mutate_genes :471-515) ----
    if cfg.mut_rate > 0.0:
        if generator is None:
            raise ValueError("QD_ECO_MUT_RATE > 0 needs the model's torch.Generator")
        u = torch.rand((), generator=generator, device=LAI_SK.device, dtype=LAI_SK.dtype)
        fire = (u < cfg.mut_rate) & (new_state.n_active < cfg.species_max)
        # the mutated state is computed and selected on the device: no host sync
        mutated = _mutate(es, new_state, cfg, generator)
        new_state = EcoState(**{f.name: torch.where(fire, getattr(mutated, f.name),
                                                    getattr(new_state, f.name))
                                for f in dataclasses.fields(EcoState)})
    return new_state


def _mutate(es: EcoStatic, state: EcoState, cfg: EcologyConfig,
            generator: torch.Generator) -> EcoState:
    """Split a fraction of a weighted-random parent's LAI into the next free
    slot and jitter its genome (population.py:361-387, adapter.py:471-515)."""
    S = es.S
    dev, dtype = state.LAI_SK.device, state.LAI_SK.dtype

    def normal(*shape):
        return torch.randn(shape, generator=generator, device=dev, dtype=dtype)

    w = torch.where(state.active, torch.clamp(state.species_weights, min=0.0), 0.0)
    w = w / (torch.sum(w) + 1e-12)
    # categorical draw by the Gumbel-max trick, as jax.random.categorical
    gumbel = -torch.log(-torch.log(torch.rand((S,), generator=generator, device=dev,
                                              dtype=dtype)))
    parent = torch.argmax(torch.log(w + 1e-12) + gumbel).reshape(1)
    idx_new = torch.clamp(state.n_active, 0, S - 1).to(torch.int64).reshape(1)
    frac = float(np.clip(cfg.mut_eps, 0.0, 0.5))

    def row(x):
        return x.index_select(0, parent)[0]

    def put(x, value):
        return x.index_copy(0, idx_new, value.to(x.dtype)[None])

    transfer = frac * row(state.LAI_SK)
    LAI_SK = state.LAI_SK.index_add(0, parent, -transfer[None])
    LAI_SK = torch.clamp(put(LAI_SK, transfer), 0.0, cfg.lai_max)

    # allocation jitter, then renormalize
    jit = torch.rand((3,), generator=generator, device=dev, dtype=dtype) * 0.1 - 0.05
    alloc_n = torch.clamp(row(state.alloc) + jit, 0.05, 0.90)
    alloc_n = alloc_n / torch.sum(alloc_n)
    # peaks jitter plus spectral drift toward the weighted band center
    pk = row(state.peaks)
    P_ = pk.shape[0]
    c = torch.clamp(pk[:, 0] + 8.0 * normal(P_), 380.0, 780.0)
    wdt = torch.clamp(pk[:, 1] + 5.0 * normal(P_), 10.0, 120.0)
    h = torch.clamp(pk[:, 2] + 0.05 * normal(P_), 0.05, 0.98)
    # keep padding rows dead (height stays 0 for unused peak slots)
    h = torch.where(pk[:, 2] > 0.0, h, 0.0)
    lam_w = torch.sum(es.lambda_centers * es.w_b) / (torch.sum(es.w_b) + 1e-12)
    c = torch.clamp(c + cfg.mut_lambda_drift * (lam_w - c), 380.0, 780.0)
    peaks_n = torch.stack([c, wdt, h], dim=-1)

    tol_n = torch.clamp(row(state.drought_tolerance) + 0.03 * normal(), 0.05, 0.95)
    gdd_n = torch.clamp(row(state.gdd_germinate) + 5.0 * normal(), 10.0, 500.0)
    life_n = torch.clamp(row(state.lifespan_days) + 30.0 * normal(), 30.0, 365.0 * 5)
    lape_n = torch.clamp(row(state.leaf_area_per_energy) * (1.0 + 0.1 * normal()), 1e-5, 5e-2)

    R_new = 1.0 - spec.absorbance_from_peaks(es.lambda_centers, peaks_n)

    st = dataclasses.replace(
        state,
        LAI_SK=LAI_SK,
        active=state.active.index_fill(0, idx_new, True),
        n_active=state.n_active + 1,
        R_leaf=put(state.R_leaf, torch.clamp(R_new, 0.0, 1.0)),
        peaks=put(state.peaks, peaks_n),
        alloc=put(state.alloc, alloc_n),
        leaf_area_per_energy=put(state.leaf_area_per_energy, lape_n),
        drought_tolerance=put(state.drought_tolerance, tol_n),
        gdd_germinate=put(state.gdd_germinate, gdd_n),
        lifespan_days=put(state.lifespan_days, life_n),
        parent_idx=put(state.parent_idx, parent[0]),
    )
    return recompute_weights_from_LAI(st, es)


def recompute_weights_from_LAI(state: EcoState, es: EcoStatic) -> EcoState:
    """species_weights ← normalized area-summed per-species LAI
    (population.py:343-359)."""
    L_s = torch.sum(torch.clamp(state.LAI_SK, min=0.0), dim=1)  # [S,H,W]
    totals = torch.sum(torch.where(es.land[None], L_s, 0.0), dim=(1, 2))
    totals = torch.where(state.active, totals, 0.0)
    ssum = torch.sum(totals)
    nact = torch.clamp(state.n_active, min=1).to(state.species_weights.dtype)
    uniform = torch.where(state.active, 1.0 / nact, 0.0)
    w = torch.where(ssum > 0, torch.clamp(totals / (ssum + 1e-12), 0.0, 1.0), uniform)
    return dataclasses.replace(state, species_weights=w)


def effective_leaf_reflectance(state: EcoState) -> torch.Tensor:
    """R_eff[b] = Σ_s w_s R_s[b] over active species (population.py:856-873)."""
    w = torch.where(state.active, state.species_weights, 0.0)
    w = w / (torch.sum(w) + 1e-12)
    return torch.clamp(torch.tensordot(w, state.R_leaf, dims=([0], [0])), 0.0, 1.0)


def surface_albedo_bands(es: EcoStatic, state: EcoState, cfg: EcologyConfig):
    """A_b(x,y) = R_eff[b]·f(LAI) + (1−f)·soil_ref, land-only, NaN elsewhere
    (population.py:875-892)."""
    f = 1.0 - torch.exp(-cfg.k_canopy * torch.clamp(total_LAI(state), min=0.0))
    R_eff = effective_leaf_reflectance(state)
    A = R_eff[:, None, None] * f[None] + (1.0 - f)[None] * cfg.soil_reflect
    return torch.where(es.land[None], torch.clamp(A, 0.0, 1.0), torch.nan)
