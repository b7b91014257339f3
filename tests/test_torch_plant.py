"""The port's plant pool and the legacy hydrology functions against the JAX
package's, float64 on the CPU: the pool over ten days of substeps and daily
steps from seeded inputs (integer fields equal, floats within 1e-12 of each
field's largest |value|), the plant state machine of tests/test_ecology.py on
the port, and ``partition_precip_phase`` / ``snow_step``."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qingdai_tpu.config import HydrologyConfig as JHydCfg
from qingdai_tpu.ecology import genes as jgenes
from qingdai_tpu.ecology import plant as jplant
from qingdai_tpu.physics import hydrology as jhy
from qingdai_tpu_torch.config import HydrologyConfig as THydCfg
from qingdai_tpu_torch.ecology import genes as tgenes
from qingdai_tpu_torch.ecology import plant as tplant
from qingdai_tpu_torch.physics import hydrology as thy

torch.set_num_threads(1)

N, NB, DAYS, SUBSTEPS = 512, 8, 10, 4
REL = 1e-12
INT_FIELDS = {"state": torch.int8, "age_days": torch.int32}


def _start(seed):
    """Seeded per-plant columns and a mid-life start (every FSM state, leaf
    area and stress present), as NumPy float64 / int arrays."""
    r = np.random.default_rng(seed)
    return {
        "state": r.integers(0, 5, N).astype(np.int8),
        "age_days": r.integers(0, 12, N).astype(np.int32),
        "biomass_root": r.uniform(0, 2, N), "biomass_stem": r.uniform(0, 2, N),
        "biomass_leaf": r.uniform(0, 1, N), "energy_storage": r.uniform(0, 3, N),
        "gdd_accum": r.uniform(0, 30, N),
        "water_stress_days": r.uniform(0, 14, N) * (r.random(N) < 0.5),
        "leaf_area": r.uniform(0, 0.4, N), "E_day_buffer": r.uniform(-0.1, 1, N),
        "alloc": r.dirichlet([1.0, 1.0, 1.0], N),
        "leaf_area_per_energy": r.uniform(0.05, 0.5, N),
        "drought_tolerance": r.uniform(0.2, 0.6, N),
        "gdd_germinate": r.uniform(5, 40, N),
        "lifespan_days": r.uniform(4, 20, N),     # fractions: the casts truncate
    }


def _days(seed):
    r = np.random.default_rng(seed + 1)
    return [{"I": r.uniform(0, 50, (SUBSTEPS, N, NB)), "A": r.uniform(-0.1, 1.2, (SUBSTEPS, N, NB)),
             "dl": r.uniform(5, 20, NB), "swi_sub": r.uniform(0.2, 1, (SUBSTEPS, N)),
             "Ts": r.uniform(260, 300, N), "daylen": float(r.uniform(0, 24)),
             "swi": r.uniform(0, 1, N)} for _ in range(DAYS)]


def _pools(seed):
    cols = _start(seed)
    jp = dataclasses.replace(
        jplant.init_plant_pool(N, jgenes.Genes.from_env(), dtype=jnp.float64),
        **{k: jnp.asarray(v) for k, v in cols.items()})
    tp = dataclasses.replace(
        tplant.init_plant_pool(N, tgenes.Genes.from_env(), dtype=torch.float64, device="cpu"),
        **{k: torch.from_numpy(v) for k, v in cols.items()})
    return jp, tp


def _same(jp, tp, tag, scale_of=None):
    """Integer fields equal; each float field within REL of its largest |value|,
    or of ``scale_of[name]`` where given."""
    for f in dataclasses.fields(tp):
        got, want = getattr(tp, f.name), np.asarray(getattr(jp, f.name))
        if f.name in INT_FIELDS:
            assert got.dtype == INT_FIELDS[f.name], (tag, f.name)
            np.testing.assert_array_equal(got.numpy(), want, err_msg=f"{tag} {f.name}")
        else:
            assert got.dtype == torch.float64, (tag, f.name)
            scale = max(np.abs(want).max(), (scale_of or {}).get(f.name, 0.0), 1e-300)
            assert np.abs(got.numpy() - want).max() <= REL * scale, (tag, f.name)


def test_init_plant_pool_matches_jax():
    g = jgenes.Genes.from_env()
    jp = jplant.init_plant_pool(7, g, dtype=jnp.float64)
    tp = tplant.init_plant_pool(7, tgenes.Genes.from_env(), dtype=torch.float64, device="cpu")
    _same(jp, tp, "init")


@pytest.mark.parametrize("seed", [0, 1])
def test_pool_matches_jax_over_ten_days(seed):
    """Substeps with banded light and daily steps for ten days: the states, ages
    and every float field agree each day; the seeds too; every transition of
    the state machine happens."""
    jp, tp = _pools(seed)
    seen = set()
    # the day's energy (summed over bands in another order by XLA) is banked,
    # and the seeds' whole units leave the bank: the bank keeps the rounding
    # of the largest day's energy
    bank = {"energy_storage": 0.0}
    for d, day in enumerate(_days(seed)):
        for k in range(SUBSTEPS):
            args = (day["I"][k], day["A"][k], 21600.0, day["dl"], day["swi_sub"][k])
            jp = jplant.pool_substep_bands(jp, *map(_j, args), k_ext=0.4)
            tp = tplant.pool_substep_bands(tp, *map(_t, args), k_ext=0.4)
            _same(jp, tp, f"day {d} substep {k}", bank)
        before = tp.state.clone()
        bank["energy_storage"] = max(bank["energy_storage"],
                                     float(np.abs(np.asarray(jp.E_day_buffer)).max()))
        jp, jseeds = jplant.pool_step_daily(jp, _j(day["Ts"]), day["daylen"], _j(day["swi"]))
        tp, tseeds = tplant.pool_step_daily(tp, _t(day["Ts"]), day["daylen"], _t(day["swi"]))
        _same(jp, tp, f"day {d}", bank)
        np.testing.assert_array_equal(tseeds.numpy(), np.asarray(jseeds))
        seen |= set(zip(before.tolist(), tp.state.tolist()))
    assert {(0, 1), (1, 2), (2, 3), (3, 4), (0, 4), (1, 4), (2, 4)} <= seen


def test_pool_takes_python_scalars_and_float32():
    """Python numbers for the day's forcing, as tests/test_ecology.py passes
    them; in float32 the int8 state and int32 age keep their dtypes."""
    jp, tp = _pools(3)
    jp, js = jplant.pool_step_daily(jp, 293.15, 24.0, 0.9)
    tp, ts = tplant.pool_step_daily(tp, 293.15, 24.0, 0.9)
    _same(jp, tp, "scalars")
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    p32 = tplant.init_plant_pool(16, tgenes.Genes.from_env(), device="cpu")
    for _ in range(3):
        p32 = tplant.pool_substep_bands(p32, torch.ones(16, NB), torch.ones(16, NB), 3600.0,
                                        torch.ones(NB), 0.1)
        p32, s32 = tplant.pool_step_daily(p32, 293.15, 24.0, 0.9)
    assert (p32.state.dtype, p32.age_days.dtype, s32.dtype) == (torch.int8, torch.int32,
                                                                torch.float32)
    assert all(getattr(p32, f.name).dtype == torch.float32 for f in dataclasses.fields(p32)
               if f.name not in INT_FIELDS)


def test_pool_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tplant.init_plant_pool(4, tgenes.Genes.from_env())


def test_plant_fsm():
    """tests/test_ecology.py::test_plant_fsm on the port's Plant and pool."""
    g = tgenes.Genes.from_env()
    g.gdd_germinate = 10.0
    p = tplant.Plant(genes=g)
    assert p.state == tplant.PlantState.SEED
    for _ in range(3):
        p.update_substep(500.0, 7200.0, soil_water_index=0.9)
        p.update_one_day(Ts_day=293.15, day_length_hours=24.0, soil_water_index=0.9)
    assert p.state in (tplant.PlantState.GROWING, tplant.PlantState.MATURE)
    assert p.leaf_area > 0
    pool = tplant.init_plant_pool(8, g, device="cpu")
    for _ in range(3):
        pool, seeds = tplant.pool_step_daily(pool, 293.15, 24.0, 0.9)
    assert int((pool.state >= int(tplant.PlantState.GROWING)).sum()) == 8


def test_plant_matches_jax_plant(monkeypatch):
    """The scalar Plant of both packages through the banded path and the
    stress knobs: the same reports and the same end state."""
    monkeypatch.setenv("QD_ECO_LAI_K_EXT", "0.5")
    monkeypatch.setenv("QD_ECO_LAI_FMIN", "0.1")
    monkeypatch.setenv("QD_ECO_STRESS_WATER_DAYS", "2")
    r = np.random.default_rng(5)
    plants = []
    for mod, gmod in ((jplant, jgenes), (tplant, tgenes)):
        g = gmod.Genes.from_env()
        g.gdd_germinate, g.lifespan_days = 5.0, 30
        plants.append(mod.Plant(genes=g, leaf_area=0.05))
    for day in range(20):
        I, A, swi = r.uniform(0, 80, NB), r.uniform(0, 1, NB), float(r.uniform(0, 1))
        reports = []
        for p in plants:
            p.update_substep_bands(I, A, 3600.0, soil_water_index=swi)
            reports.append(p.update_one_day(285.0 + day, 12.0, swi, I_bands=I, A_b_genotype=A))
        a, b = reports
        assert (a.energy_gain, a.leaf_area, int(a.state), a.seed_count) == \
            (b.energy_gain, b.leaf_area, int(b.state), b.seed_count)
        np.testing.assert_array_equal(a.reflectance_bands, b.reflectance_bands)
    assert plants[0].biomass == plants[1].biomass


def _legacy_inputs(seed):
    r = np.random.default_rng(seed)
    return {"P": np.where(r.random((19, 36)) < 0.4, 0.0, 1e-4 * r.random((19, 36))),
            "T": 255.0 + 35.0 * r.random((19, 36)),
            "S": np.where(r.random((19, 36)) < 0.5, 0.0, 80.0 * r.random((19, 36)))}


@pytest.mark.parametrize("seed", [0, 1])
def test_partition_precip_phase_matches_jax(seed):
    x = _legacy_inputs(seed)
    for thresh in (273.15, 268.0):
        got = thy.partition_precip_phase(_t(x["P"]), _t(x["T"]), thresh)
        want = jhy.partition_precip_phase(_j(x["P"]), _j(x["T"]), thresh)
        for g, w in zip(got, want):
            assert g.dtype == torch.float64
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("dt", [300.0, 3600.0, 0.0])
def test_snow_step_matches_jax(dt):
    x = _legacy_inputs(2)
    P_snow = np.where(x["T"] < 273.15, x["P"], 0.0)
    got = thy.snow_step(_t(x["S"]), _t(P_snow), _t(x["T"]), THydCfg(), dt)
    want = jhy.snow_step(_j(x["S"]), _j(P_snow), _j(x["T"]), JHydCfg(), dt)
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert g.dtype == torch.float64 and g.shape == w.shape
        assert np.abs(g.numpy() - w).max() <= REL * max(np.abs(w).max(), 1e-300)


def _j(x):
    return jnp.asarray(x, jnp.float64)


def _t(x):
    return torch.as_tensor(np.asarray(x, np.float64))
