"""The port's coupled step against the JAX package's, on the CPU at 19×36.

Both packages build three configurations from one hermetic environment: the
slice (ecology, phytoplankton and routing off), the planet (routing off:
ecology, the individual pool and phytoplankton on) and the flagship planet
(every default on, river routing included). Each JAX step is jitted once per
module and warmed 24 steps, past the cold-start precipitation fallback and
the median knife edge, then its state is carried into the port with
``convert``. Tolerances are relative to each leaf's largest |value|:
1e-10 after one float64 step, 1e-8 after a 12-step chunk.
"""

import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as graft
from qingdai_tpu import dynamics as jdyn
from qingdai_tpu import model as JM
from qingdai_tpu import ocean as jocean
from qingdai_tpu_torch import convert, entry
from qingdai_tpu_torch import dynamics as tdyn
from qingdai_tpu_torch import model as TM
from qingdai_tpu_torch import ocean as tocean

torch.set_num_threads(1)

N_LAT, N_LON = 19, 36
SLICE = {"QD_ECO_ENABLE": "0", "QD_PHYTO_ENABLE": "0", "QD_HYDRO_ENABLE": "0"}
# the default planet without routing; the seed fixes the species-mode draw
PLANET = {"QD_HYDRO_ENABLE": "0", "QD_ECO_RAND_SEED": "7"}
FLAGSHIP = {"QD_ECO_RAND_SEED": "7"}
REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def warm():
    """(JAX model, jitted JAX step, warm JAX state, port model)."""
    jm, js = graft._build_world(N_LAT, N_LON, with_network=False, extra_env=SLICE,
                                dtype=jnp.float64, hermetic=True)
    jstep = jax.jit(JM.make_step_fn(jm))
    for _ in range(24):
        js, _ = jstep(js)
    tm, _ = entry.build_world(N_LAT, N_LON, extra_env=SLICE, device="cpu", dtype=torch.float64)
    return jm, jstep, js, tm


@pytest.fixture(scope="module")
def warm_planet():
    """The planet as ``warm``, with both day accumulators six steps before
    the boundary, so a 12-step chunk runs every daily block once."""
    import dataclasses
    jm, js = graft._build_world(N_LAT, N_LON, with_network=False, extra_env=PLANET,
                                dtype=jnp.float64, hermetic=True)
    jstep = jax.jit(JM.make_step_fn(jm))
    for _ in range(24):
        js, _ = jstep(js)
    # the accumulators' own dtype, so the jitted step is not traced again
    near = jnp.asarray(jm.day_seconds - 6 * jm.dt, js.clock.accum_t_day.dtype)
    js = dataclasses.replace(js, clock=dataclasses.replace(js.clock, accum_t_day=near,
                                                           phyto_accum=near))
    tm, _ = entry.build_world(N_LAT, N_LON, extra_env=PLANET, device="cpu",
                              dtype=torch.float64)
    return jm, jstep, js, tm


@pytest.fixture(scope="module")
def warm_flagship():
    """The flagship planet as ``warm_planet``, with the routing clock one
    step before an event, so the next step routes, and both day
    accumulators six steps before the boundary."""
    import dataclasses
    jm, js = graft._build_world(N_LAT, N_LON, extra_env=FLAGSHIP, dtype=jnp.float64,
                                hermetic=True)
    assert jm.routing_static is not None
    jstep = jax.jit(JM.make_step_fn(jm))
    for _ in range(24):
        js, _ = jstep(js)
    near = jnp.asarray(jm.day_seconds - 6 * jm.dt, js.clock.accum_t_day.dtype)
    t_ev = jnp.asarray(jm.cfg.hydrology.dt_hydro_hours * 3600.0 - jm.dt,
                       js.routing.t_accum.dtype)
    js = dataclasses.replace(js, clock=dataclasses.replace(js.clock, accum_t_day=near,
                                                           phyto_accum=near),
                             routing=dataclasses.replace(js.routing, t_accum=t_ev))
    tm, _ = entry.build_world(N_LAT, N_LON, extra_env=FLAGSHIP, device="cpu",
                              dtype=torch.float64)
    return jm, jstep, js, tm


# routing leaves that are differences of routed sums and can cancel to
# rounding noise: held relative to the routed mass (test_torch_routing.py)
CANCELLING = ("routing.stranded_kg", "routing.mass_error_kg", "routing_stranded_kg",
              "routing_mass_error_kg")


def _rel_errs(ref: dict, got: dict):
    errs = {}
    routed = {k: float(np.max(np.abs(np.asarray(ref[k], np.float64))))
              for k in ("routing.routed_mass_kg", "routing_routed_mass_kg") if k in ref}
    for k, r in ref.items():
        r = np.asarray(r, np.float64)
        g = np.asarray(got[k].numpy() if isinstance(got[k], torch.Tensor) else got[k],
                       np.float64)
        assert r.shape == g.shape, k
        np.testing.assert_array_equal(np.isfinite(r), np.isfinite(g), err_msg=k)
        fin = np.isfinite(r)
        scale = max(float(np.max(np.abs(r[fin]), initial=0.0)), 1e-300)
        if k in CANCELLING:
            scale = max([scale] + list(routed.values()))
        errs[k] = float(np.max(np.abs(r[fin] - g[fin]), initial=0.0)) / scale
    return errs


def _assert_world_close(jworld, tworld, rel):
    ref, got = convert.world_to_numpy(jworld), convert.world_to_numpy(tworld)
    assert set(ref) == set(got)
    assert ref.pop("clock.step_idx") == got.pop("clock.step_idx")
    errs = _rel_errs(ref, got)
    worst = max(errs, key=errs.get)
    assert errs[worst] <= rel, (worst, errs[worst])


def _assert_diags_close(jd, td, rel):
    assert set(jd) == set(td)
    errs = _rel_errs({k: np.asarray(v) for k, v in jd.items()}, td)
    worst = max(errs, key=errs.get)
    assert errs[worst] <= rel, (worst, errs[worst])


def test_statics_and_conversion(warm):
    jm, _, js, tm = warm
    for f in ("land_mask", "elevation", "base_albedo", "friction", "C_s_map"):
        np.testing.assert_array_equal(getattr(tm.static, f).numpy(),
                                      np.asarray(getattr(jm.static, f)))
    assert tm.n_ocean_substeps == jm.n_ocean_substeps == 1
    ts = convert.world_from_numpy(js, "cpu", torch.float64)
    assert ts.clock.step_idx == 24 and isinstance(ts.clock.step_idx, int)
    _assert_world_close(js, ts, 0.0)
    tstatic = convert.world_from_numpy(jm.static, "cpu", torch.float64)
    assert tstatic.land_mask.dtype == torch.int32 and tstatic.has_elevation


def test_slice_one_step_matches_jax(warm):
    _, jstep, js, tm = warm
    js1, jd = jstep(js)
    ts1, td = TM.make_step_fn(tm)(convert.world_from_numpy(js, "cpu", torch.float64))
    _assert_world_close(js1, ts1, 1e-10)
    _assert_diags_close(jd, td, 1e-10)


@pytest.mark.parametrize("diag_every", [1, 3])
def test_slice_chunk_matches_jax(warm, diag_every):
    _, jstep, js, tm = warm
    ts = convert.world_from_numpy(js, "cpu", torch.float64)
    rows = []
    for i in range(12):
        js, d = jstep(js)
        if (i + 1) % diag_every == 0:
            rows.append(d)
    jd = {k: np.stack([np.asarray(r[k]) for r in rows]) for k in rows[0]}
    ts, td = TM.make_chunk_fn(tm, 12, diag_every=diag_every)(ts)
    assert all(v.shape == (12 // diag_every,) for v in td.values())
    _assert_world_close(js, ts, 1e-8)
    _assert_diags_close(jd, td, 1e-8)


def test_audit_and_dyn_diag_step_matches_jax(warm):
    """The QD_ENERGY_AUDIT and QD_DYN_DIAG branches, one step from the warm
    state: the same state leaves plus the audit and filter-variance diags."""
    import dataclasses
    jm, _, js, tm = warm
    cfg = dataclasses.replace(
        jm.cfg, energy=dataclasses.replace(jm.cfg.energy, audit=True),
        dynamics=dataclasses.replace(jm.cfg.dynamics, dyn_diag=True))
    js1, jd = jax.jit(JM.make_step_fn(dataclasses.replace(jm, cfg=cfg)))(js)
    ts1, td = TM.make_step_fn(dataclasses.replace(tm, cfg=cfg))(
        convert.world_from_numpy(js, "cpu", torch.float64))
    assert set(TM.AUDIT_KEYS) <= set(td) and "dyn_var_u_post" in td
    _assert_world_close(js1, ts1, 1e-10)
    # the audit terms are residuals of budget identities between ~100 W/m²
    # fields, some of them pure rounding noise (~1e-14 W/m²): hold them to
    # an absolute 1e-8 W/m², the rest of the diags to 1e-10 relative
    for k in TM.AUDIT_KEYS:
        assert abs(float(jd.pop(k)) - float(td.pop(k))) <= 1e-8, k
    _assert_diags_close(jd, td, 1e-10)


def test_diag_stride_falls_back_to_one(warm):
    tm = warm[3]
    assert TM.diag_stride(tm, 12, 3) == 3
    assert TM.diag_stride(tm, 12, 5) == 1          # does not divide the chunk
    assert TM.diag_stride(tm, 480, 160) == 1       # divides the chunk, not the day
    assert TM.diag_stride(tm, 480, 24) == 24


def _physical_inputs(js, seed):
    r = np.random.default_rng(seed)
    shape = (N_LAT, N_LON)
    return {"Teq": 200.0 + 100.0 * r.random(shape), "albedo": 0.1 + 0.5 * r.random(shape),
            "isr": np.maximum(0.0, 1000.0 * r.standard_normal(shape)),
            "Q_net": 200.0 * r.standard_normal(shape),
            "ice": r.random(shape) < 0.2}


@pytest.mark.parametrize("step_idx", [24, 29])
def test_atmos_step_matches_jax(warm, step_idx):
    """Alone, from the warm state; step 29 also runs the Shapiro filter."""
    jm, _, js, tm = warm
    x = _physical_inputs(js, step_idx)
    ts = convert.world_from_numpy(js, "cpu", torch.float64)
    ja, jaux = jdyn.atmos_step(jm.grid, jm.cfg, jm.static, js.atmos, js.energy,
                               *(jnp.asarray(x[k]) for k in ("Teq", "albedo", "isr")),
                               jnp.asarray(step_idx), jm.dt, adv_plan=jm.adv_plan_atmos)
    ta, taux = tdyn.atmos_step(tm.grid, tm.cfg, tm.static, ts.atmos, ts.energy,
                               *(torch.as_tensor(x[k]) for k in ("Teq", "albedo", "isr")),
                               step_idx, tm.dt)
    for f in ja.__dataclass_fields__:
        assert _rel_errs({f: getattr(ja, f)}, {f: getattr(ta, f)})[f] <= 1e-12, f
    _assert_diags_close(jaux, taux, 1e-12)


def test_ocean_step_matches_jax(warm):
    jm, _, js, tm = warm
    x = _physical_inputs(js, 1)
    ts = convert.world_from_numpy(js, "cpu", torch.float64)
    jo, _ = jocean.ocean_step(jm.grid, jm.cfg.ocean, jm.static.land_mask, js.ocean,
                              js.atmos.u, js.atmos.v, jnp.asarray(x["Q_net"]),
                              jnp.asarray(x["ice"]), jnp.asarray(24), jm.dt, 1,
                              adv_plan=jm.adv_plan_ocean)
    to, trc = tocean.ocean_step(tm.grid, tm.cfg.ocean, tm.static.land_mask, ts.ocean,
                                ts.atmos.u, ts.atmos.v, torch.as_tensor(x["Q_net"]),
                                torch.as_tensor(x["ice"]), 24, tm.dt, 1)
    assert trc is None
    for f in ("uo", "vo", "eta", "sst"):
        assert _rel_errs({f: getattr(jo, f)}, {f: getattr(to, f)})[f] <= 1e-12, f
    jd = jocean.ocean_diagnostics(jm.grid, jm.cfg.ocean, jo)
    _assert_diags_close(jd, tocean.ocean_diagnostics(tm.grid, tm.cfg.ocean, to), 1e-12)


def test_float32_build_keeps_float32():
    tm, ts = entry.build_world(N_LAT, N_LON, extra_env=PLANET, device="cpu",
                               dtype=torch.float32)
    ts, td = TM.make_step_fn(tm)(ts)
    for k, v in convert.world_to_numpy(ts).items():
        if k in ("clock.step_idx", "clock.accum_t_day", "clock.phyto_accum"):
            continue   # host numbers
        assert v.dtype in (np.float32, np.bool_, np.int32), (k, v.dtype)
    assert all(v.dtype == torch.float32 for v in td.values())
    assert all(np.isfinite(v).all() for k, v in convert.world_to_numpy(ts).items()
               if k != "clock.step_idx" and "alpha" not in k)


def test_port_never_imports_jax():
    """A build and a step of the flagship planet (ecology, phytoplankton and
    routing on) load no JAX and no module of the JAX package."""
    code = ("import sys, torch\n"
            "from qingdai_tpu_torch import entry, model as M\n"
            "m, s = entry.build_world(19, 36, device='cpu')\n"
            "assert m.eco_static is not None and m.phyto_static is not None\n"
            "assert m.routing_static is not None and s.routing is not None\n"
            "s, d = M.make_step_fn(m)(s)\n"
            "assert bool(torch.isfinite(d['Ts_mean'])) and bool(torch.isfinite(d['chl_mean']))\n"
            "assert bool(torch.isfinite(d['routing_mass_error_kg']))\n"
            "print(sorted(k for k in sys.modules if k == 'jax' or k.startswith('jax.')\n"
            "             or k == '__graft_entry__' or k == 'qingdai_tpu'\n"
            "             or k.startswith('qingdai_tpu.')))\n")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_planet_one_step_matches_jax(warm_planet):
    _, jstep, js, tm = warm_planet
    assert tm.eco_static is not None and tm.indiv_static is not None
    js1, jd = jstep(js)
    ts1, td = TM.make_step_fn(tm)(convert.world_from_numpy(js, "cpu", torch.float64))
    assert {"lai_mean", "chl_mean", "kd490_mean"} <= set(td)
    _assert_world_close(js1, ts1, 1e-10)
    _assert_diags_close(jd, td, 1e-10)


def test_planet_chunk_crosses_day_boundary(warm_planet):
    """12 steps from six before the day boundary: the ecology, individual
    and phytoplankton daily blocks run once, at step 6."""
    _, jstep, js, tm = warm_planet
    ts = convert.world_from_numpy(js, "cpu", torch.float64)
    assert ts.clock.accum_t_day == ts.clock.phyto_accum == tm.day_seconds - 6 * tm.dt
    rows = []
    for _ in range(12):
        js, d = jstep(js)
        rows.append(d)
    jd = {k: np.stack([np.asarray(r[k]) for r in rows]) for k in rows[0]}
    ts, td = TM.make_chunk_fn(tm, 12)(ts)
    assert ts.clock.accum_t_day == 6 * tm.dt
    assert int(ts.indiv.fire_idx) == 0          # the individual pool's day ended
    _assert_world_close(js, ts, 1e-8)
    _assert_diags_close(jd, td, 1e-8)


def test_flagship_one_step_matches_jax(warm_flagship):
    """One step that fires the routing event, diags included."""
    from qingdai_tpu_torch import routing
    _, jstep, js, tm = warm_flagship
    js1, jd = jstep(js)
    before = routing.route_event.events
    ts1, td = TM.make_step_fn(tm)(convert.world_from_numpy(js, "cpu", torch.float64))
    assert routing.route_event.events == before + 1 and ts1.routing.t_accum == 0.0
    assert float(js1.routing.t_accum) == 0.0
    assert {"routing_mass_error_kg", "routing_routed_mass_kg"} <= set(td)
    assert float(td["routing_routed_mass_kg"]) > 0.0
    _assert_world_close(js1, ts1, 1e-10)
    _assert_diags_close(jd, td, 1e-10)


def test_flagship_chunk_crosses_event_and_day(warm_flagship):
    """12 steps: the routing event at step 1, the daily blocks at step 6."""
    _, jstep, js, tm = warm_flagship
    ts = convert.world_from_numpy(js, "cpu", torch.float64)
    rows = []
    for _ in range(12):
        js, d = jstep(js)
        rows.append(d)
    jd = {k: np.stack([np.asarray(r[k]) for r in rows]) for k in rows[0]}
    ts, td = TM.make_chunk_fn(tm, 12)(ts)
    assert ts.clock.accum_t_day == 6 * tm.dt and ts.routing.t_accum == 11 * tm.dt
    _assert_world_close(js, ts, 1e-8)
    _assert_diags_close(jd, td, 1e-8)
