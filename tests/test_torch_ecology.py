"""The port's ecology, individual pool and phytoplankton against the JAX
package, function by function, on the CPU at 19×36 in float64.

Both sides build from equal configurations (the dataclass defaults, with the
species-mode seed fixed) and the same land mask. Where a function needs a
state, one is drawn with NumPy from a seed, made into a JAX state and
carried into the port with ``convert``. Every comparison is relative to the
largest |value| of the field: 1e-12 for the functions, equality for the
build-time statics and states. Mutation draws from different random
streams in the two packages (ROADMAP Queue 3), so the daily step is compared
with mutation off and the mutation is checked for its invariants.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qingdai_tpu import config as JC
from qingdai_tpu.ecology import individuals as jind
from qingdai_tpu.ecology import phyto as jphy
from qingdai_tpu.ecology import population as jpop
from qingdai_tpu.ecology import spectral as jspec
from qingdai_tpu.grid import make_grid as j_make_grid
from qingdai_tpu_torch import config as TC
from qingdai_tpu_torch import convert, topography
from qingdai_tpu_torch.ecology import individuals as tind
from qingdai_tpu_torch.ecology import phyto as tphy
from qingdai_tpu_torch.ecology import population as tpop
from qingdai_tpu_torch.ecology import spectral as tspec
from qingdai_tpu_torch.grid import make_grid as t_make_grid

torch.set_num_threads(1)

H, W = 19, 36
F64 = torch.float64
REL = 1e-12


def _mask():
    lat, lon = np.linspace(-90, 90, H), np.linspace(0, 360, W)
    lon_mesh, lat_mesh = np.meshgrid(lon, lat)
    return topography.create_land_sea_mask(lat_mesh, lon_mesh, seed=42)[0]


MASK = _mask()
LAND = MASK == 1


def _eco_cfgs(**kw):
    kw.setdefault("rand_seed", 7)
    return (dataclasses.replace(JC.EcologyConfig(), **kw),
            dataclasses.replace(TC.EcologyConfig(), **kw))


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _close(jx, tx, rel=REL, what=""):
    r, g = np.asarray(_np(jx), np.float64), np.asarray(_np(tx), np.float64)
    assert r.shape == g.shape, what
    np.testing.assert_array_equal(np.isfinite(r), np.isfinite(g), err_msg=what)
    fin = np.isfinite(r)
    scale = max(float(np.max(np.abs(r[fin]), initial=0.0)), 1e-300)
    err = float(np.max(np.abs(r[fin] - g[fin]), initial=0.0))
    assert err <= rel * scale, (what, err / scale)


def _close_fields(jobj, tobj, rel=REL):
    for f in dataclasses.fields(tobj):
        jv, tv = getattr(jobj, f.name), getattr(tobj, f.name)
        if isinstance(tv, (bool, int, float)):
            assert jv == tv, f.name
        else:
            _close(jv, tv, rel, f.name)


def _to_port(jstate):
    return convert.world_from_numpy(jstate, "cpu", F64)


def _t(x, dtype=F64):
    return torch.as_tensor(np.asarray(x)).to(dtype)


# ---------------------------------------------------------------- spectral

def test_spectral_tables_and_synthesis():
    jcfg, tcfg = _eco_cfgs()
    jb, tb = jspec.make_bands(jcfg), tspec.make_bands(tcfg)
    for f in ("lambda_edges", "lambda_centers", "delta_lambda"):
        np.testing.assert_array_equal(getattr(jb, f), getattr(tb, f))
    np.testing.assert_array_equal(jspec.band_weights(jb, jcfg), tspec.band_weights(tb, tcfg))
    jsp, tsp = jspec.star_band_spectra(jb, jcfg), tspec.star_band_spectra(tb, tcfg)
    for a, b in zip(jsp, tsp):
        np.testing.assert_array_equal(a, b)
    r = np.random.default_rng(1)
    insA = np.maximum(0.0, 900.0 * r.standard_normal((H, W)))    # night cells at 0
    insB = np.maximum(0.0, 400.0 * r.standard_normal((H, W)))
    _close(jspec.dual_star_insolation_to_bands(jnp.asarray(insA), jnp.asarray(insB), *jsp),
           tspec.dual_star_insolation_to_bands(_t(insA), _t(insB), *map(_t, tsp)))
    _close(jspec.dual_star_insolation_to_bands_points(jnp.asarray(insA[0]),
                                                      jnp.asarray(insB[0]), *jsp),
           tspec.dual_star_insolation_to_bands_points(_t(insA[0]), _t(insB[0]),
                                                      *map(_t, tsp)))
    peaks = np.stack([r.uniform(380, 780, 4), r.uniform(-5, 120, 4), r.uniform(-0.2, 1.2, 4)], -1)
    _close(jspec.absorbance_from_peaks(jb.lambda_centers, jnp.asarray(peaks)),
           tspec.absorbance_from_peaks(_t(tb.lambda_centers), _t(peaks)))


# ------------------------------------------------------------------ builds

@pytest.fixture(scope="module")
def built():
    """Both packages' ecology, individual and phytoplankton builds."""
    jcfg, tcfg = _eco_cfgs()
    jes, jeco, _, _ = jpop.build_eco((H, W), MASK, jcfg, jnp.float64)
    tes, teco, _, _ = tpop.build_eco((H, W), MASK, tcfg, "cpu", F64)
    jist, jind0 = jind.build_individuals((H, W), MASK, jes, jeco, jcfg, jnp.float64)
    tist, tind0 = tind.build_individuals((H, W), MASK, tes, teco, tcfg, "cpu", F64)
    jpc, tpc = JC.PhytoConfig(), TC.PhytoConfig()
    jps, jph, _ = jphy.build_phyto((H, W), MASK, jpc, jcfg, 50.0, jnp.float64)
    tps, tph, _ = tphy.build_phyto((H, W), MASK, tpc, tcfg, 50.0, "cpu", F64)
    return dict(jcfg=jcfg, tcfg=tcfg, jes=jes, tes=tes, jeco=jeco, teco=teco, jist=jist,
                tist=tist, jind=jind0, tind=tind0, jpc=jpc, tpc=tpc, jps=jps, tps=tps,
                jph=jph, tph=tph)


@pytest.mark.parametrize("group", ["eco", "indiv", "phyto"])
def test_builds_equal_jax(built, group):
    """Statics and initial states equal the JAX package's: the same NumPy
    draws (species modes, sampled cells, species ids, band jitter)."""
    b = built
    static = {"eco": ("jes", "tes"), "indiv": ("jist", "tist"), "phyto": ("jps", "tps")}[group]
    state = {"eco": ("jeco", "teco"), "indiv": ("jind", "tind"), "phyto": ("jph", "tph")}[group]
    _close_fields(b[static[0]], b[static[1]], 0.0)
    _close_fields(b[state[0]], b[state[1]], 0.0)


# ------------------------------------------------------- population (eco)

def _random_eco(jes, jeco, seed, **extra):
    r = np.random.default_rng(seed)
    S, K = jes.S, jes.K
    active = np.asarray(jeco.active)
    lai = r.uniform(0.0, 2.0, (S, K, H, W)) * LAND * active[:, None, None, None]
    w = r.uniform(0.1, 1.0, S) * active
    return dataclasses.replace(
        jeco, LAI_SK=jnp.asarray(lai), E_day=jnp.asarray(r.uniform(0, 2e7, (H, W))),
        seed_bank=jnp.asarray(r.uniform(0, 2.0, (H, W)) * LAND),
        age_days=jnp.asarray(r.uniform(0, 50, (H, W))),
        species_weights=jnp.asarray(w / w.sum()),
        lai_snapshot=jnp.asarray(r.uniform(0.0, 3.0, (H, W))),
        hours_accum=jnp.asarray(r.uniform(0, 12.0)), **extra)


@pytest.mark.parametrize("hours", [1.0, 30.0])
def test_eco_step_subdaily_matches_jax(built, hours):
    """Both branches of the canopy refresh (``hours`` before or past it)."""
    b = built
    jeco = _random_eco(b["jes"], b["jeco"], 2, next_recompute_hours=jnp.asarray(hours))
    isr = np.maximum(0.0, 1000.0 * np.random.default_rng(3).standard_normal((H, W)))
    js, ja = jpop.eco_step_subdaily(b["jes"], jeco, b["jcfg"], jnp.asarray(isr), 300.0)
    ts, ta = tpop.eco_step_subdaily(b["tes"], _to_port(jeco), b["tcfg"], _t(isr), 300.0)
    _close(ja, ta)
    _close_fields(js, ts)


@pytest.mark.parametrize("variant", ["default", "layered_spread"])
def test_eco_step_daily_matches_jax(variant):
    """The default K = 1 step, and K = 2 with Moore-neighbour spread and the
    upward layer transfer; mutation off."""
    kw = {} if variant == "default" else dict(cohort_K=2, spread_enable=True, spread_rate=0.2,
                                               spread_neighbors="moore", layer_upfrac=0.1)
    jcfg, tcfg = _eco_cfgs(**kw)
    jes, jeco0, _, _ = jpop.build_eco((H, W), MASK, jcfg, jnp.float64)
    tes, _, _, _ = tpop.build_eco((H, W), MASK, tcfg, "cpu", F64)
    jeco = _random_eco(jes, jeco0, 4)
    soil = np.random.default_rng(5).uniform(0.0, 1.0, (H, W))
    js, _ = jpop.eco_step_daily(jes, jeco, jcfg, jnp.asarray(soil), None)
    ts = tpop.eco_step_daily(tes, _to_port(jeco), tcfg, _t(soil))
    _close_fields(js, ts)
    # the weights and banded albedo read from the new state
    _close_fields(jpop.recompute_weights_from_LAI(js, jes),
                  tpop.recompute_weights_from_LAI(ts, tes))
    _close(jpop.surface_albedo_bands(jes, js, jcfg), tpop.surface_albedo_bands(tes, ts, tcfg))
    _close(jpop.total_LAI(js), tpop.total_LAI(ts))


def _mutating(mut_rate):
    jcfg, tcfg = _eco_cfgs(ns=4, species_max=8, mut_rate=mut_rate)
    tes, teco, _, _ = tpop.build_eco((H, W), MASK, tcfg, "cpu", F64)
    jes, jeco0, _, _ = jpop.build_eco((H, W), MASK, jcfg, jnp.float64)
    return tes, _to_port(_random_eco(jes, jeco0, 6)), tcfg


def test_mutation_invariants():
    """QD_ECO_MUT_RATE = 1 fires: one new active slot takes a fraction of
    its parent's LAI (total LAI conserved) and a jittered genome in bounds."""
    tes, teco, tcfg = _mutating(1.0)
    soil = _t(np.random.default_rng(7).uniform(0.0, 1.0, (H, W)))
    plain = tpop.eco_step_daily(tes, teco, dataclasses.replace(tcfg, mut_rate=0.0), soil)
    mut = tpop.eco_step_daily(tes, teco, tcfg, soil, torch.Generator().manual_seed(0))
    assert int(mut.n_active) == int(plain.n_active) + 1 == 5
    assert mut.active.tolist() == [True] * 5 + [False] * 3
    new, parent = 4, int(mut.parent_idx[4])
    assert 0 <= parent < 4 and mut.parent_idx[:4].tolist() == [-1] * 4
    torch.testing.assert_close(torch.sum(mut.LAI_SK), torch.sum(plain.LAI_SK), rtol=1e-12, atol=0)
    torch.testing.assert_close(mut.LAI_SK[new] + mut.LAI_SK[parent],
                               plain.LAI_SK[parent], rtol=1e-12, atol=0)
    pk = mut.peaks[new]
    live = plain.peaks[parent][:, 2] > 0
    assert torch.all((pk[:, 0] >= 380) & (pk[:, 0] <= 780))
    assert torch.all((pk[:, 1] >= 10) & (pk[:, 1] <= 120))
    assert torch.all(torch.where(live, (pk[:, 2] >= 0.05) & (pk[:, 2] <= 0.98), pk[:, 2] == 0))
    assert abs(float(mut.alloc[new].sum()) - 1.0) < 1e-12 and torch.all(mut.alloc[new] > 0)
    for f, lo, hi in (("drought_tolerance", 0.05, 0.95), ("gdd_germinate", 10.0, 500.0),
                      ("lifespan_days", 30.0, 1825.0), ("leaf_area_per_energy", 1e-5, 5e-2)):
        assert lo <= float(getattr(mut, f)[new]) <= hi, f
    assert torch.all((mut.R_leaf[new] >= 0) & (mut.R_leaf[new] <= 1))
    assert abs(float(mut.species_weights.sum()) - 1.0) < 1e-12
    # the slots the mutation did not touch are those of the plain step
    for f in ("R_leaf", "peaks", "alloc", "drought_tolerance"):
        torch.testing.assert_close(getattr(mut, f)[:4], getattr(plain, f)[:4], rtol=0, atol=0)


def test_mutation_not_fired_is_the_plain_step():
    """A fire that the device draw refuses selects the unmutated state."""
    tes, teco, tcfg = _mutating(1e-30)
    soil = _t(np.random.default_rng(8).uniform(0.0, 1.0, (H, W)))
    plain = tpop.eco_step_daily(tes, teco, dataclasses.replace(tcfg, mut_rate=0.0), soil)
    got = tpop.eco_step_daily(tes, teco, tcfg, soil, torch.Generator().manual_seed(1))
    for f in dataclasses.fields(got):
        assert torch.equal(getattr(got, f.name), getattr(plain, f.name)), f.name


# ------------------------------------------------------------- individuals

def _random_indiv(b, seed):
    r = np.random.default_rng(seed)
    jist, jst = b["jist"], b["jind"]
    C, F, N = jist.n_cells, jist.fires_per_day, np.asarray(jst.E_day).shape[0]
    return dataclasses.replace(
        jst, J_cells=jnp.asarray(r.uniform(0, 5e6, (C, b["jes"].NB))),
        soil_buf=jnp.asarray(r.uniform(0, 1, (F, C))), fire_idx=jnp.asarray(F - 3, jnp.int32),
        water_stress_days=jnp.asarray(r.uniform(0, 10, N)))


@pytest.mark.parametrize("accum", [7000.0, 100.0])
def test_indiv_try_substep_matches_jax(built, accum):
    """A substep that fires (accumulator past the 7200 s period) and one
    that waits."""
    b = built
    r = np.random.default_rng(9)
    jst = dataclasses.replace(_random_indiv(b, 10), substep_accum=jnp.asarray(accum))
    insA, insB = r.uniform(0, 900, (H, W)), r.uniform(0, 400, (H, W))
    soil, glacier = r.uniform(0, 1, (H, W)), r.random((H, W)) < 0.2
    got = tind.indiv_try_substep(b["tist"], _to_port(jst), b["tes"], b["tcfg"], _t(insA),
                                 _t(insB), _t(soil), 300.0, 72000.0, glacier_mask=_t(glacier,
                                                                                    torch.bool))
    ref = jind.indiv_try_substep(b["jist"], jst, b["jes"], b["jcfg"], jnp.asarray(insA),
                                 jnp.asarray(insB), jnp.asarray(soil), 300.0, 72000.0,
                                 glacier_mask=jnp.asarray(glacier))
    _close_fields(ref, got)


def test_indiv_step_daily_matches_jax(built):
    b = built
    jst = _random_indiv(b, 11)
    jeco = _random_eco(b["jes"], b["jeco"], 12)
    soil = np.random.default_rng(13).uniform(0, 1, (H, W))
    js, je = jind.indiv_step_daily(b["jist"], jst, b["jes"], jeco, b["jcfg"], jnp.asarray(soil))
    ts, te = tind.indiv_step_daily(b["tist"], _to_port(jst), b["tes"], _to_port(jeco),
                                   b["tcfg"], _t(soil))
    _close_fields(js, ts)
    _close_fields(je, te)


# ----------------------------------------------------------- phytoplankton

def _random_phyto(b, seed):
    r = np.random.default_rng(seed)
    ocean = ~LAND
    return dataclasses.replace(
        b["jph"], C_phyto=jnp.asarray(r.uniform(0, 0.5, (b["jps"].S, H, W)) * ocean),
        N=jnp.asarray(r.uniform(0, 2.0, (H, W)) * ocean))


def test_phyto_step_daily_matches_jax(built):
    b = built
    r = np.random.default_rng(14)
    jst = _random_phyto(b, 15)
    insA = np.maximum(0.0, 900.0 * r.standard_normal((H, W)))
    insB = np.maximum(0.0, 400.0 * r.standard_normal((H, W)))
    T_w = r.uniform(270.0, 305.0, (H, W))
    ref = jphy.phyto_step_daily(b["jps"], jst, b["jpc"], jnp.asarray(insA), jnp.asarray(insB),
                                jnp.asarray(T_w))
    got = tphy.phyto_step_daily(b["tps"], _to_port(jst), b["tpc"], _t(insA), _t(insB), _t(T_w))
    _close_fields(ref, got)


@pytest.mark.parametrize("path", ["apply_transport", "advect_diffuse"])
def test_phyto_transport_matches_jax(built, path):
    """The transport given the gathered stack (as after K4), and with its own
    gather (the path for more than one ocean substep)."""
    b = built
    r = np.random.default_rng(16)
    jst = _random_phyto(b, 17)
    jg, tg = j_make_grid(H, W, dtype=jnp.float64), t_make_grid(H, W, device="cpu", dtype=F64)
    if path == "apply_transport":
        C_adv = r.uniform(0, 0.5, (b["jps"].S, H, W))
        ref = jphy.phyto_apply_transport(b["jps"], jst, b["jpc"], jg, jnp.asarray(C_adv), 300.0)
        got = tphy.phyto_apply_transport(b["tps"], _to_port(jst), b["tpc"], tg, _t(C_adv), 300.0)
    else:
        uo, vo = r.normal(0, 0.8, (H, W)), r.normal(0, 0.8, (H, W))
        ref = jphy.phyto_advect_diffuse(b["jps"], jst, b["jpc"], jg, jnp.asarray(uo),
                                        jnp.asarray(vo), 300.0)
        got = tphy.phyto_advect_diffuse(b["tps"], _to_port(jst), b["tpc"], tg, _t(uo), _t(vo),
                                        300.0)
    _close_fields(ref, got)
