"""The port's adjoint (``qingdai_tpu_torch.adjoint``) against the JAX
package's, on the CPU in float64 unless stated.

The world is the flagship planet at 19×36 with dt 7200 s (10 steps a
planetary day), built by both packages from one hermetic environment; the
JAX state is carried into the port with ``convert``. The 12-step window
crosses one daily boundary (ecology, the individual pool, phytoplankton)
and four routing events.

- (a) J and the gradients of one window over three kinds of parameter
  (a scalar, a static map, an initial-state map) against
  ``qingdai_tpu.adjoint.make_value_and_grad``. The JAX reference is taken
  once, in a subprocess started when the module's first test runs, so its
  trace and compile (most of this file's time) overlap the port's tests.
- (b) each kernel's plain version: its VJP against ``jax.vjp`` of the JAX
  package's plain form; and the card branch of each ``Function.backward``
  (the kernel wrapper faked by the plain version), which must give the
  plain version's gradient; a batched input that requires grad raises.
- (c) the gradient against the port's own central difference.
- (d) the segment length does not change J.
- (e) the float32 sweep is finite and within 2e-2 of float64.
- (f) with mutation on, the window is a pure function: two calls, and a
  call without checkpointing, give the same bits.
- (g) Newton calibration hits its target; joint calibration ends closer
  to the truth than its priors on every parameter.
- (h) both CLIs on the CPU.
"""

import json
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
from qingdai_tpu import constants as jconst
from qingdai_tpu import flags
from qingdai_tpu import grid as jgrid
from qingdai_tpu import ocean as jocean
from qingdai_tpu.config import OceanConfig as JOceanConfig
from qingdai_tpu.ops import advect as jadv
from qingdai_tpu.ops import reductions as jred
from qingdai_tpu.ops import stencil as jst
from qingdai_tpu.state import OceanState as JOceanState
from qingdai_tpu_torch import adjoint as A
from qingdai_tpu_torch import calibrate_joint, convert, entry, sensitivity
from qingdai_tpu_torch import grid as tgrid
from qingdai_tpu_torch import model as TM
from qingdai_tpu_torch import ocean as tocean
from qingdai_tpu_torch.config import OceanConfig as TOceanConfig
from qingdai_tpu_torch.ops import advect, reductions, stencil
from qingdai_tpu_torch.state import OceanState as TOceanState

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
N_LAT, N_LON, DT = 19, 36, 7200.0
N_STEPS, SEG = 12, 3
G0 = 0.40
MUTATING = {"QD_ECO_NS": "3", "QD_ECO_MUT_RATE": "1.0"}
# the JAX reference: one value_and_grad over the three kinds of parameter.
# XLA's backend optimisation is off in the subprocess: it halves the compile
# and moves J and the gradients by ~1e-14 relative.
JAX_REFERENCE = f"""
import sys, time
import jax
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)
import jax.numpy as jnp, numpy as np
import __graft_entry__ as graft
from qingdai_tpu import adjoint as A
t0 = time.time()
mdl, st = graft._build_world({N_LAT}, {N_LON}, dt_seconds={DT}, dtype=jnp.float64, hermetic=True)
vg = A.make_value_and_grad(mdl, {N_STEPS}, segment={SEG})
params = {{"gh_factor": jnp.asarray({G0}, jnp.float64), "friction": mdl.static.friction,
          "state.ocean.sst": st.ocean.sst}}
(J, (_, series)), g = vg(params, st)
np.savez(sys.argv[1], J=np.asarray(J), gh_factor=np.asarray(g["gh_factor"]),
         friction=np.asarray(g["friction"]), sst=np.asarray(g["state.ocean.sst"]),
         Ts_mean=np.asarray(series["Ts_mean"]), seconds=time.time() - t0)
"""


@pytest.fixture(scope="module", autouse=True)
def jax_reference(tmp_path_factory):
    """Start the JAX reference when the module's first test runs; yields a
    function that waits for it and returns its arrays."""
    out = tmp_path_factory.mktemp("jax_adjoint") / "ref.npz"
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=str(REPO),
               XLA_FLAGS="--xla_backend_optimization_level=0 "
                         "--xla_llvm_disable_expensive_passes=true")
    proc = subprocess.Popen([sys.executable, "-c", JAX_REFERENCE, str(out)], cwd=REPO, env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)

    def result():
        log, _ = proc.communicate(timeout=600)
        assert proc.returncode == 0, log[-4000:]
        return dict(np.load(out))

    try:
        yield result
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()


def _port_world(dtype=torch.float64, extra_env=None, dt=DT):
    return entry.build_world(N_LAT, N_LON, dt_seconds=dt, extra_env=extra_env, device="cpu",
                             dtype=dtype)


@pytest.fixture(scope="module")
def world():
    """(port model, port state carried over from the JAX package's state)."""
    _, js = graft._build_world(N_LAT, N_LON, dt_seconds=DT, dtype=jnp.float64, hermetic=True)
    tm, _ = _port_world()
    return tm, convert.world_from_numpy(js, "cpu", torch.float64)


def _rel(got, ref):
    ref = np.asarray(ref, np.float64)
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got, np.float64)
    assert got.shape == ref.shape
    return float(np.max(np.abs(got - ref))) / max(float(np.max(np.abs(ref))), 1e-300)


# ----------------------------------------------------------------- (b) kernels

def _t(x, dtype=torch.float64):
    return torch.as_tensor(np.asarray(x)).to(dtype)


def _kernel_case(kernel, r):
    """(port function of the plain version, JAX plain form, inputs as
    numpy arrays): the function maps the differentiated inputs to one output
    array (K4: the ocean step around its substeps, all outputs stacked)."""
    H, W = N_LAT, N_LON
    A_ = jconst.PLANET_RADIUS
    jg = jgrid.make_grid(H, W, dtype=jnp.float64)
    tg = tgrid.make_grid(H, W, device="cpu", dtype=torch.float64)
    if kernel == "median_pos":
        x = np.where(r.random((H, W)) < 0.6, 0.0, np.abs(r.standard_normal((H, W))) * 1e-5)
        return (lambda x: reductions.masked_median_of_positive_ref(x, 1e-6),
                lambda x: jred.masked_median_of_positive(x, 1e-6), [x])
    if kernel == "advect_bilinear":
        F = 280.0 + 20.0 * r.standard_normal((2, H, W))
        u, v = 60.0 * r.standard_normal((H, W)), 30.0 * r.standard_normal((H, W))

        def port(F, u, v):
            return advect.advect_semilag_multi_ref(F, u, v, 300.0, A_, tg.dlat_rad, tg.dlon_rad,
                                                   tg.coslat_cap_tiny)

        def jax_(F, u, v):
            dj, di = jadv.departure_indices((H, W), u, v, 300.0, A_, jg.dlat_rad, jg.dlon_rad,
                                            jg.coslat_cap_tiny, jnp.float64)
            return jadv.bilinear_wrap_gather_multi(F, dj, di)
        return port, jax_, [F, u, v]
    if kernel == "hyper4":
        F = 30.0 * r.standard_normal((5, H, W))
        k4 = r.uniform(0.5, 1.0, (5, 1, 1)) * 0.02 * np.asarray(jg.k4_map_unit)[None] / 300.0

        def port(F, k4):
            return stencil.hyperdiffuse_multi_ref(F, k4, 300.0, 2, tg.dlat_rad, tg.dlon_rad,
                                                  tg.coslat_cap_02, A_)

        def jax_(F, k4):
            return jst.hyperdiffuse_multi(F, k4, 300.0, 2, jg.dlat_rad, jg.dlon_rad,
                                          jg.coslat_cap_02, A_)
        return port, jax_, [F, k4]
    # K4 in the ocean step (one substep, SST + 3 tracers), the JAX package's
    # plain substep scan against the port's ocean_substeps_plain
    land = (r.random((H, W)) < 0.3).astype(np.int32)
    ice = r.random((H, W)) < 0.1
    xs = [r.normal(0, 0.5, (H, W)), r.normal(0, 0.5, (H, W)), r.normal(0, 0.2, (H, W)),
          r.normal(288, 8, (H, W)), r.normal(0, 8, (H, W)), r.normal(0, 4, (H, W)),
          r.normal(0, 40, (H, W)), r.uniform(0, 1, (3, H, W))]
    plan = jadv.make_advect_plan(H, jg.dlat_rad, jg.dlon_rad, 300.0, A_,
                                 np.asarray(jg.coslat_cap_05)[:, 0],
                                 vmax=JOceanConfig().max_u_cap + 2.0)

    def port(uo, vo, eta, sst, ua, va, q, trc):
        ocn, trc = tocean.ocean_step(tg, TOceanConfig(n_substeps=1), _t(land, torch.int32),
                                     TOceanState(uo, vo, eta, sst), ua, va, q,
                                     _t(ice, torch.bool), 0, 300.0, 1, tracers=trc)
        return torch.cat([torch.stack([ocn.uo, ocn.vo, ocn.eta, ocn.sst]), trc])

    def jax_(uo, vo, eta, sst, ua, va, q, trc):
        ocn, trc = jocean.ocean_step(jg, JOceanConfig(n_substeps=1), jnp.asarray(land),
                                     JOceanState(uo, vo, eta, sst), ua, va, q, jnp.asarray(ice),
                                     jnp.asarray(0), 300.0, 1, tracers=trc, adv_plan=plan)
        return jnp.concatenate([jnp.stack([ocn.uo, ocn.vo, ocn.eta, ocn.sst]), trc])
    return port, jax_, xs


KERNELS = ["median_pos", "advect_bilinear", "hyper4", "ocean_substeps"]


@pytest.mark.parametrize("kernel", KERNELS)
def test_plain_vjp_matches_jax(kernel):
    """(b) The VJP of each kernel's plain version against ``jax.vjp`` of the
    JAX package's plain form (the median's through its custom JVP), with a
    seeded cotangent: each input's gradient within 1e-10 of its largest
    |value|."""
    r = np.random.default_rng(21)
    port, jax_, xs = _kernel_case(kernel, r)
    with flags.overridden({"QD_PALLAS_OCEAN": "0"}):
        out, pull = jax.vjp(jax_, *(jnp.asarray(x) for x in xs))
    ct = r.standard_normal(np.shape(out))
    ref = pull(jnp.asarray(ct))
    ts = [_t(x).requires_grad_(True) for x in xs]
    got = torch.autograd.grad(port(*ts), ts, _t(ct))
    assert _rel(port(*(_t(x) for x in xs)), out) <= 1e-12
    for g, rg in zip(got, ref):
        assert np.any(np.asarray(rg) != 0.0)
        assert _rel(g, rg) <= 1e-10


@pytest.fixture
def fake_card(monkeypatch):
    """The card's branch of the four dispatchers on CPU tensors: each
    dispatch says "kernel", each kernel wrapper is its plain version; the
    calls are counted by kernel."""
    from qingdai_tpu_torch.kernels import advect_bilinear as k2
    from qingdai_tpu_torch.kernels import hyper4 as k3
    from qingdai_tpu_torch.kernels import median_pos as k1
    from qingdai_tpu_torch.kernels import ocean_substeps as k4
    calls = dict.fromkeys(KERNELS, 0)

    def counted(name, fn):
        def wrapped(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        return wrapped

    for mod in (reductions, advect, stencil, tocean):
        monkeypatch.setattr(mod, "use_kernel", lambda t: True)
    for mod, name, fn in (
            (k1, "median_pos", reductions.masked_median_of_positive_ref),
            (k2, "advect_bilinear", advect.advect_semilag_multi_ref),
            (k3, "hyper4", stencil.hyperdiffuse_multi_ref),
            (k4, "ocean_substeps", tocean.ocean_substeps_plain)):
        wrapper = {"median_pos": "median_pos_cuda", "advect_bilinear": "advect_bilinear_cuda",
                   "hyper4": "hyperdiffuse_cuda", "ocean_substeps": "ocean_substeps_cuda"}[name]
        monkeypatch.setattr(mod, wrapper, counted(name, fn))
    return calls


def _card_case(kernel, r, shape=(N_LAT, N_LON)):
    """(dispatcher, plain version, inputs as tensors) of one kernel on CPU
    tensors: the dispatcher reaches the kernel's Function under
    ``fake_card``."""
    from chip_smoke import k4_operands
    H, W = shape
    tg = tgrid.make_grid(H, W, device="cpu", dtype=torch.float64)
    sc = (300.0, jconst.PLANET_RADIUS, tg.dlat_rad, tg.dlon_rad)
    if kernel == "median_pos":
        # no entry at 0, where the set of positives (and the median) jumps
        x = np.where(r.random((H, W)) < 0.5, -1.0, 1.0) * (np.abs(r.standard_normal((H, W)))
                                                           + 0.01)
        return (lambda x: reductions.masked_median_of_positive(x, 1e-6),
                lambda x: reductions.masked_median_of_positive_ref(x, 1e-6), [_t(x)])
    if kernel == "advect_bilinear":
        xs = [280.0 + 20.0 * r.standard_normal((2, H, W)), 60.0 * r.standard_normal((H, W)),
              30.0 * r.standard_normal((H, W))]
        return (lambda F, u, v: advect.advect_semilag_multi(F, u, v, *sc, tg.coslat_cap_tiny),
                lambda F, u, v: advect.advect_semilag_multi_ref(F, u, v, *sc,
                                                                tg.coslat_cap_tiny),
                [_t(x) for x in xs])
    if kernel == "hyper4":
        k4 = np.asarray(tg.k4_map_unit)[None] * r.uniform(0.5, 1.0, (5, 1, 1)) * 0.02 / 300.0
        xs = [30.0 * r.standard_normal((5, H, W)), k4]
        hsc = (300.0, 2, tg.dlat_rad, tg.dlon_rad, tg.coslat_cap_02, jconst.PLANET_RADIUS)
        return (lambda F, k: stencil.hyperdiffuse_multi(F, k, *hsc),
                lambda F, k: stencil.hyperdiffuse_multi_ref(F, k, *hsc), [_t(x) for x in xs])
    *ops, params = k4_operands("cpu", torch.float64, 3, 2, 1, 5.0e3, seed=4, shape=shape)
    return (lambda *o: tocean.ocean_substeps(*o, **params),
            lambda *o: tocean.ocean_substeps_plain(*o, **params), list(ops))


def _outputs(out):
    return out if isinstance(out, tuple) else (out,)


@pytest.mark.parametrize("kernel", KERNELS)
def test_function_backward_on_the_card_branch(fake_card, kernel):
    """(b) Each Function's backward reached as on the card: with respect to
    every input at once, the gradient through the Function equals the plain
    version's bit for bit; ``gradcheck`` (fast mode, on a small grid; K4
    two substeps) holds it against finite differences of the forward."""
    r = np.random.default_rng(22)
    fn, plain, xs = _card_case(kernel, r)
    ts = [x.clone().requires_grad_(True) for x in xs]
    outs = _outputs(fn(*ts))
    assert fake_card[kernel] == 1 and all(o.grad_fn is not None for o in outs)
    cts = [_t(r.standard_normal(tuple(o.shape))) for o in outs]
    got = torch.autograd.grad(outs, ts, cts)
    ref = torch.autograd.grad(_outputs(plain(*ts)), ts, cts)
    assert all(torch.equal(g, rg) for g, rg in zip(got, ref))
    fn, _, xs = _card_case(kernel, r, shape=(7, 12))
    assert torch.autograd.gradcheck(fn, [x.requires_grad_(True) for x in xs], fast_mode=True)


@pytest.mark.parametrize("kernel", KERNELS)
def test_batched_input_requiring_grad_raises(fake_card, kernel):
    """(b) The batched forms have no backward: under ``torch.func.vmap`` a
    card-branch input that requires grad raises instead of giving a wrong
    gradient."""
    r = np.random.default_rng(23)
    fn, _, xs = _card_case(kernel, r)
    batched = [torch.stack([x, x]) for x in xs]
    batched[0].requires_grad_(True)
    with pytest.raises(RuntimeError, match="batched kernel has no backward"):
        torch.func.vmap(fn, randomness="error")(*batched)


def test_window_launches_each_kernel_twice_a_step(fake_card, world):
    """The gradient's forward launches K1–K4 3, 3, 1 and 1 times a step,
    and the checkpoint's recompute as many again; the backwards launch
    none. (The count ``chip_smoke.py`` phase 7 holds on the card.)"""
    tm, ts = world
    (J, _), g = A.make_value_and_grad(tm, 4, segment=2)({"gh_factor": G0}, ts)
    assert fake_card == {"median_pos": 24, "advect_bilinear": 24, "hyper4": 8,
                         "ocean_substeps": 8}
    assert torch.isfinite(g["gh_factor"]) and float(g["gh_factor"]) > 0.0


# ---------------------------------------------------------- the window

def test_segment_choice_does_not_change_forward_value(world):
    """(d)"""
    tm, ts = world
    J3, _ = A.make_value(tm, N_STEPS, segment=3)({"gh_factor": G0}, ts)
    J6, (_, series) = A.make_value(tm, N_STEPS, segment=6)({"gh_factor": G0}, ts)
    np.testing.assert_allclose(float(J3), float(J6), rtol=1e-13)
    assert series["Ts_mean"].shape == (N_STEPS,)
    assert A.default_segment(240) == 15 and A.default_segment(12) == 3
    with pytest.raises(ValueError, match="must divide"):
        A.make_window_fn(tm, N_STEPS, segment=5)


def test_gh_factor_grad_matches_fd(world):
    """(c) dJ/d gh_factor against the port's own central difference."""
    tm, ts = world
    (J, _), g = A.make_value_and_grad(tm, N_STEPS, segment=SEG)({"gh_factor": G0}, ts)
    val = A.make_value(tm, N_STEPS, segment=SEG)
    eps = 1e-6
    fd = (float(val({"gh_factor": G0 + eps}, ts)[0])
          - float(val({"gh_factor": G0 - eps}, ts)[0])) / (2 * eps)
    assert float(g["gh_factor"]) > 0.0 and fd != 0.0
    np.testing.assert_allclose(float(g["gh_factor"]), fd, rtol=5e-5)


def test_f32_backward_sweep_is_finite():
    """(e) The float32 sweep (19×36, dt 300 s, 4 steps, segment 2) is finite
    and within 2e-2 of float64."""
    got = {}
    for dtype in (torch.float32, torch.float64):
        tm, ts = _port_world(dtype, dt=300.0)
        (J, _), g = A.make_value_and_grad(tm, 4, segment=2)({"gh_factor": G0}, ts)
        assert g["gh_factor"].dtype == dtype
        got[dtype] = float(g["gh_factor"])
        assert np.isfinite(float(J)) and np.isfinite(got[dtype]) and got[dtype] > 0.0
    np.testing.assert_allclose(got[torch.float32], got[torch.float64], rtol=2e-2)


def test_mutation_window_is_pure(monkeypatch):
    """(f) With QD_ECO_MUT_RATE=1 (and 3 species, below the cap of 8, so the
    mutation fires) the 12 steps cross a daily boundary whose mutation draws
    random numbers. Two calls, and a call whose segments are
    not checkpointed (so nothing is recomputed), give the same J and
    gradient bit for bit; the model's generator is not advanced; the
    mutation changes the window's outcome."""
    tm, ts = _port_world(extra_env=MUTATING)
    assert True in TM.mutation_schedule(tm, ts.clock, N_STEPS)
    gen0 = tm.generator.get_state()
    vg = A.make_value_and_grad(tm, N_STEPS, segment=SEG)
    params = {"gh_factor": G0, "friction": tm.static.friction}
    runs = [vg(params, ts) for _ in range(2)]
    monkeypatch.setattr(A, "checkpoint", lambda fn, *args, **kw: fn(*args))
    runs.append(vg(params, ts))
    assert torch.equal(tm.generator.get_state(), gen0)
    (J0, (st0, _)), g0 = runs[0]
    for (J, (st, _)), g in runs[1:]:
        assert torch.equal(J, J0) and torch.equal(st.eco.peaks, st0.eco.peaks)
        assert all(torch.equal(g[k], g0[k]) for k in params)
    tm1, ts1 = _port_world(extra_env={"QD_ECO_NS": MUTATING["QD_ECO_NS"]})
    _, (st1, _) = A.make_value(tm1, N_STEPS, segment=SEG)({"gh_factor": G0}, ts1)
    assert not torch.equal(st1.eco.peaks, st0.eco.peaks)


# ---------------------------------------------------------- calibration

def test_calibrate_newton_hits_target(world):
    """(g) Newton on gh_factor reaches a window 0.05 K warmer."""
    tm, ts = world
    val = A.make_value(tm, N_STEPS, segment=SEG)
    target = float(val({"gh_factor": G0}, ts)[0]) + 0.05
    x, hist = A.calibrate(tm, ts, "gh_factor", G0, n_steps=N_STEPS, target=target, iters=6,
                          tol=1e-4, verbose=False)
    assert abs(float(val({"gh_factor": x}, ts)[0]) - target) < 1e-4
    assert len(hist) <= 4


def test_joint_multiparam_calibration_recovers_truth():
    """(g) calibrate_joint pulls gh_factor and C_E from biased priors toward
    a withheld truth (20 steps from a warmed state, 12 Adam iterations):
    every parameter ends closer than its prior, the joint error at least
    halves, and the objective descends."""
    tm, ts = _port_world()
    chunk = TM.make_chunk_fn(tm, N_STEPS)
    with torch.no_grad():
        for _ in range(2):
            ts, _ = chunk(ts)
    priors = {"gh_factor": 0.40, "c_e": 1.3e-3}
    truth = {"gh_factor": 0.44, "c_e": 1.7e-3}
    recovered, history = A.calibrate_joint(tm, ts, priors, truth, n_steps=20,
                                           obs_keys=("Ts_mean", "OLR_mean", "E_mean"),
                                           iters=12, lr=0.14, verbose=False)
    rel = {k: abs(recovered[k] - truth[k]) / truth[k] for k in priors}
    rel0 = {k: abs(priors[k] - truth[k]) / truth[k] for k in priors}
    for k in priors:
        assert rel[k] < rel0[k], (k, recovered[k], history[-3:])
    assert sum(rel.values()) < 0.5 * sum(rel0.values()), (recovered, rel)
    assert history[-1][2] < history[0][2]


def test_adam_step_is_optax_adam():
    """``torch.optim.Adam`` as ``calibrate_joint`` sets it up takes
    ``optax.adam``'s steps on a log-space variable."""
    import optax
    z = torch.zeros((), dtype=torch.float64, requires_grad=True)
    opt = torch.optim.Adam([z], lr=0.14, betas=(0.9, 0.999), eps=1e-8)
    oz, tx = jnp.zeros(()), optax.adam(0.14)
    ostate = tx.init(oz)
    for g in (0.3, -1.2, 2e-3, 0.7):
        z.grad = torch.tensor(g, dtype=torch.float64)
        opt.step()
        upd, ostate = tx.update(jnp.asarray(g), ostate)
        oz = optax.apply_updates(oz, upd)
        np.testing.assert_allclose(float(z.detach()), float(oz), rtol=1e-12)


# ---------------------------------------------------------- the CLIs

@pytest.fixture
def tiny_env(monkeypatch, tmp_path):
    for k in [k for k in os.environ if k.startswith("QD_")]:
        monkeypatch.delenv(k)
    for k, v in {"QD_N_LAT": str(N_LAT), "QD_N_LON": str(N_LON), "QD_DT_SECONDS": str(DT),
                 "QD_DTYPE": "float64"}.items():
        monkeypatch.setenv(k, v)
    monkeypatch.chdir(tmp_path)
    return tmp_path


def test_sensitivity_cli_on_the_cpu(tiny_env, capsys):
    """(h) ``python -m qingdai_tpu_torch.sensitivity`` in its scalar mode
    with a central-difference check, and its map mode, on the CPU."""
    assert sensitivity.main(["--param", "gh_factor", "--steps", "4", "--segment", "2",
                             "--fd", "1e-6", "--json", "--device", "cpu"]) == 0
    res = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert res["mode"] == "scalar" and res["steps"] == 4 and res["dJ_dx"] > 0.0
    np.testing.assert_allclose(res["dJ_dx"], res["fd"], rtol=5e-5)
    out = tiny_env / "sens.npz"
    assert sensitivity.main(["--map", "friction", "--steps", "4", "--json", "--device", "cpu",
                             "--out", str(out)]) == 0
    res = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    npz = np.load(out)
    assert res["mode"] == "map" and npz["grad"].shape == (N_LAT, N_LON)
    assert np.all(np.isfinite(npz["grad"])) and np.any(npz["grad"] != 0.0)


def test_calibrate_joint_cli_on_the_cpu(tiny_env, capsys):
    """(h) ``python -m qingdai_tpu_torch.calibrate_joint`` on the CPU writes
    its CALIB-style record to output/calib_torch.json by default."""
    summary = calibrate_joint.main(["--nlat", str(N_LAT), "--nlon", str(N_LON), "--steps", "4",
                                    "--warmup-days", "0", "--iters", "2", "--x64", "--json",
                                    "--device", "cpu"])
    printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    written = json.loads((tiny_env / "output" / "calib_torch.json").read_text())
    assert printed == written == json.loads(json.dumps(summary))
    calib = json.loads((REPO / "CALIB.json").read_text())
    assert set(calib) <= set(written) and written["device"] == "cpu"
    assert len(written["J_trajectory"]) == 2 and written["window_steps"] == 4


# ---------------------------------------------------------- (a), last: the JAX
# reference has run beside every test above

def test_port_matches_jax_adjoint(world, jax_reference):
    """(a) J, dJ/d gh_factor and the friction and initial-SST sensitivity
    maps of one 12-step window (segment 3) against the JAX package's:
    J to 1e-10, dJ/d gh_factor to 1e-8 relative, each map to 1e-8 of its
    largest |value|."""
    tm, ts = world
    ref = jax_reference()
    params = {"gh_factor": G0, "friction": tm.static.friction, "state.ocean.sst": ts.ocean.sst}
    (J, (_, series)), g = A.make_value_and_grad(tm, N_STEPS, segment=SEG)(params, ts)
    assert _rel(series["Ts_mean"], ref["Ts_mean"]) <= 1e-10
    np.testing.assert_allclose(float(J), float(ref["J"]), rtol=1e-10)
    np.testing.assert_allclose(float(g["gh_factor"]), float(ref["gh_factor"]), rtol=1e-8)
    for k, rk in (("friction", "friction"), ("state.ocean.sst", "sst")):
        assert np.all(np.isfinite(g[k].numpy())) and np.any(ref[rk] != 0.0)
        assert _rel(g[k], ref[rk]) <= 1e-8, k
