"""The port's data assimilation (``qingdai_tpu_torch.assim`` and the OSSE
driver ``qingdai_tpu_torch.assimilate``) against the JAX package's, on the
CPU in float64 unless stated.

The world is the flagship planet at 19×36 with dt 7200 s, built by both
packages from one hermetic environment; the JAX state is carried into the
port with ``convert``. Ensembles are that state with given numpy draws added
to T_s (and the SST over open ocean), h, q, u and v (``_jax_ensemble``), so
no JAX chunk is compiled in this process. Random numbers of the port (the
observing network, the observation noise) cannot reproduce ``jax.random``,
so the two packages are compared on given draws.

- (a) the building blocks: Gaspari–Cohn, the great-circle distance, both
  inverse square roots;
- (b) ``letkf_analysis`` with localization, inflation, RTPS, several
  observed fields and per-observation errors, both solvers; the global ETKF
  against the exact Kalman update;
- (c) ``letkf_param_analysis``;
- (d) the three analysis entry points on a 19×36 ensemble, their guards,
  the land SST and the input ensemble left as it was;
- (e) one augmented cycle, the slice as a whole: the per-member-parameter
  forecast (6 steps, k = 4) and the augmented analysis. The JAX side runs
  once, in a subprocess started when the module's first test runs, with
  XLA's backend optimisation off, so its compile overlaps the port's tests;
- (f) each scalar parameter alias under the ensemble's vmap: member i of the
  per-parameter chunk equals the single planet with θ[i] injected;
- (g) the augmented OSSE pulls gh_factor from a biased prior toward the
  truth;
- (h) the CLI in-process on the CPU: plain, ``--obs-mix`` and
  ``--est-param``;
- (i) the observing networks: distinct cells, an SST block on ocean cells.
"""

import dataclasses
import hashlib
import inspect
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
from qingdai_tpu import assim as JA
from qingdai_tpu_torch import assim as A
from qingdai_tpu_torch import assimilate, convert, entry
from qingdai_tpu_torch import ensemble as TE
from qingdai_tpu_torch import model as TM
from qingdai_tpu_torch.adjoint import PARAM_ALIASES, inject_path

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
N_LAT, N_LON, DT = 19, 36, 7200.0
FIELDS = ("T_s", "sst", "h", "q", "u", "v")
CYCLE_K, CYCLE_STEPS, CYCLE_OBS, CYCLE_SEED = 4, 6, 60, 5
CYCLE_THETA = np.array([[0.36], [0.40], [0.43], [0.47]])
CYCLE_CFG = dict(fields=FIELDS, obs_field="T_s", obs_err=0.5, loc_radius_km=3000.0,
                 inflation=1.04, rtps=0.6)


def _jax_ensemble(js, land, k, seed):
    """``k`` members of the JAX state ``js``: given numpy draws (from
    ``seed``) added to T_s and the same to the SST over open ocean, to h, u
    and v, and a relative one to q. Runs here and in the JAX subprocess."""
    import dataclasses

    import jax
    import jax.numpy as jnp
    import numpy as np
    r = np.random.default_rng(seed)
    shape = (k,) + tuple(np.shape(js.atmos.T_s))
    ens = jax.tree.map(lambda x: jnp.stack([x] * k), js)
    dT = 0.5 * r.standard_normal(shape)
    a = ens.atmos
    atmos = dataclasses.replace(
        a, T_s=a.T_s + dT, h=a.h + 5.0 * r.standard_normal(shape),
        q=a.q * (1.0 + 0.05 * r.standard_normal(shape)),
        u=a.u + r.standard_normal(shape), v=a.v + r.standard_normal(shape))
    sst = jnp.where(jnp.asarray(land)[None] == 0, ens.ocean.sst + dT, ens.ocean.sst)
    return dataclasses.replace(ens, atmos=atmos, ocean=dataclasses.replace(ens.ocean, sst=sst))


def _cycle_obs(n_cells):
    """The cycle's given observations: (cells, unit noise) from a seed."""
    r = np.random.default_rng(CYCLE_SEED + 1)
    return r.choice(n_cells, CYCLE_OBS, replace=False), r.standard_normal(CYCLE_OBS)


# the JAX reference of (e): the per-member-parameter chunk and the augmented
# analysis. XLA's backend optimisation is off in the subprocess: it shortens
# the compile and moves the state by ~1e-14 relative.
JAX_CYCLE = f"""
import sys
import jax
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)
import jax.numpy as jnp, numpy as np
import __graft_entry__ as graft
from qingdai_tpu import assim as A
from qingdai_tpu import ensemble as E
{inspect.getsource(_jax_ensemble)}
{inspect.getsource(_cycle_obs)}
CYCLE_OBS, CYCLE_SEED = {CYCLE_OBS}, {CYCLE_SEED}
mdl, st = graft._build_world({N_LAT}, {N_LON}, dt_seconds={DT}, dtype=jnp.float64, hermetic=True)
ens = _jax_ensemble(st, mdl.static.land_mask, {CYCLE_K}, {CYCLE_SEED})
theta = jnp.asarray(np.array({CYCLE_THETA.tolist()}))
ens, diags = jax.jit(A.make_param_ensemble_chunk_fn(mdl, ("gh_factor",), {CYCLE_STEPS}))(
    ens, theta)
cells, noise = _cycle_obs({N_LAT * N_LON})
y = st.atmos.T_s.reshape(-1)[cells] + 0.5 * noise
cfg = A.AssimConfig(**{CYCLE_CFG!r})
ens_a, th_a = A.make_augmented_analysis_fn(mdl, cfg, {CYCLE_OBS}, param_rtps=0.5)(
    ens, theta, y, jnp.asarray(cells))
out = {{"theta_a": np.asarray(th_a), "Ts_mean": np.asarray(diags["Ts_mean"])}}
for tag, s in (("f", ens), ("a", ens_a)):
    for g in ("atmos", "ocean", "land", "eco", "phyto"):
        grp = getattr(s, g)
        for f in grp.__dataclass_fields__:
            out[tag + "." + g + "." + f] = np.asarray(getattr(grp, f))
np.savez(sys.argv[1], **out)
"""


@pytest.fixture(scope="module", autouse=True)
def jax_cycle(tmp_path_factory):
    """Start the JAX reference of (e) when the module's first test runs;
    yields a function that waits for it and returns its arrays."""
    out = tmp_path_factory.mktemp("jax_assim") / "ref.npz"
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=str(REPO),
               XLA_FLAGS="--xla_backend_optimization_level=0 "
                         "--xla_llvm_disable_expensive_passes=true")
    proc = subprocess.Popen([sys.executable, "-c", JAX_CYCLE, str(out)], cwd=REPO, env=env,
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


@pytest.fixture(scope="module")
def world():
    """(JAX model, JAX state, port model) of the 19×36 planet."""
    jm, js = graft._build_world(N_LAT, N_LON, dt_seconds=DT, dtype=jnp.float64, hermetic=True)
    tm, _ = entry.build_world(N_LAT, N_LON, dt_seconds=DT, device="cpu", dtype=torch.float64)
    return jm, js, tm


def _t(x, dtype=torch.float64):
    return torch.as_tensor(np.array(x)).to(dtype)


def _rel(got, ref):
    """max|got − ref| / max|ref|."""
    ref = np.asarray(ref, np.float64)
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got, np.float64)
    assert got.shape == ref.shape
    return float(np.max(np.abs(got - ref))) / max(float(np.max(np.abs(ref))), 1e-300)


# ---------------------------------------------------------------- (a) blocks

def _rand_spd(rng, batch, k, cond=100.0):
    q, _ = np.linalg.qr(rng.normal(size=(batch, k, k)))
    lam = np.exp(rng.uniform(0, np.log(cond), size=(batch, k)))
    return np.einsum("bij,bj,bkj->bik", q, lam, q)


def test_gaspari_cohn_and_distance_match_jax():
    """(a) Gaspari–Cohn on [0, 3] (the knots 1 and 2 included) and the
    great-circle distance between random points, within 1e-12 relative."""
    r = np.random.default_rng(0)
    x = np.concatenate([r.uniform(0.0, 3.0, 500), [0.0, 1.0, 2.0, 1.0 - 1e-9, 2.0 - 1e-9]])
    g = A.gaspari_cohn(_t(x))
    assert _rel(g, JA.gaspari_cohn(jnp.asarray(x))) <= 1e-12
    assert float(g[-5]) == 1.0 and float(g[-3]) == 0.0 and torch.all(g[x >= 2.0] == 0.0)
    lat1, lat2 = r.uniform(-90, 90, (2, 300))
    lon1, lon2 = r.uniform(0, 360, (2, 300))
    d = A.great_circle_km(_t(lat1), _t(lon1), _t(lat2), _t(lon2), 6.371e6)
    assert _rel(d, JA.great_circle_km(lat1, lon1, lat2, lon2, 6.371e6)) <= 1e-12


@pytest.mark.parametrize("solver", ["ns", "eigh"])
def test_inverse_square_roots_match_jax(solver):
    """(a) (A^{-1}, A^{-1/2}) of 16 SPD 12×12 matrices of condition 1e4, the
    Newton–Schulz iteration (40 iterations) and the eigh path, each within
    1e-10 relative of the JAX package's and of the exact inverse."""
    Amat = _rand_spd(np.random.default_rng(1), 16, 12, cond=1e4)
    if solver == "ns":
        got = A.inv_and_inv_sqrt_psd(_t(Amat), iters=40)
        ref = JA.inv_and_inv_sqrt_psd(jnp.asarray(Amat), iters=40)
    else:
        got = A._inv_and_inv_sqrt_eigh(_t(Amat))
        ref = JA._inv_and_inv_sqrt_eigh(jnp.asarray(Amat))
    for g, rf in zip(got, ref):
        assert _rel(g, rf) <= 1e-10
    assert _rel(got[0], np.linalg.inv(Amat)) <= 1e-10
    assert _rel(got[1] @ got[1], np.linalg.inv(Amat)) <= 1e-10


# ---------------------------------------------------------------- (b) LETKF

def _flat_case(r, k=6, F=3, H=N_LAT, W=N_LON, p=40):
    """A flat ensemble [k, F, H·W] on the 19×36 grid's cells, observations
    of all three fields with per-observation errors."""
    C = H * W
    lat = np.repeat(np.linspace(-90, 90, H), W)
    lon = np.tile(np.linspace(0, 360, W), H)
    X = 10.0 + r.normal(0.0, 2.0, (k, F, C)) * np.linspace(0.5, 2.0, F)[None, :, None]
    cell = r.choice(C, p, replace=False)
    fidx = r.integers(0, F, p)
    y = X.mean(0)[fidx, cell] + r.normal(0.0, 1.5, p)
    err = r.uniform(0.3, 1.2, p)
    return X, y, cell, fidx, lat, lon, err


@pytest.mark.parametrize("solver", ["ns", "eigh"])
def test_letkf_analysis_matches_jax(solver):
    """(b) [k=6, F=3, C=684] with a 3000 km radius, inflation 1.08, RTPS
    0.6, observations of all three fields and per-observation errors:
    within 1e-10 of max|X|; the analysis deviations sum to zero."""
    X, y, cell, fidx, lat, lon, err = _flat_case(np.random.default_rng(2))
    kw = dict(loc_radius_km=3000.0, inflation=1.08, rtps=0.6, solver=solver)
    got = A.letkf_analysis(_t(X), _t(y), torch.as_tensor(cell), torch.as_tensor(fidx), _t(lat),
                           _t(lon), obs_err=_t(err), **kw)
    ref = JA.letkf_analysis(jnp.asarray(X), jnp.asarray(y), jnp.asarray(cell),
                            jnp.asarray(fidx), jnp.asarray(lat), jnp.asarray(lon),
                            obs_err=jnp.asarray(err), **kw)
    scale = np.abs(X).max()
    assert float((got - _t(np.asarray(ref))).abs().max()) <= 1e-10 * scale
    assert float((got - _t(X)).abs().max()) > 0.1
    dev = got - got.mean(0)
    assert float(dev.sum(0).abs().max()) <= 1e-10 * scale


@pytest.mark.parametrize("solver", ["eigh", "ns"])
def test_global_etkf_matches_kalman(solver):
    """(b) No localization: the ETKF mean is x̄ + K(y − Hx̄) and its
    covariance (I − KH)Pb with Pb the sample covariance (the JAX package's
    ``test_global_etkf_matches_kalman`` on the port)."""
    rng = np.random.default_rng(1)
    k, F, C, p, r = 24, 2, 9, 5, 0.8
    X = rng.normal(10.0, 2.0, size=(k, F, C))
    lat, lon = np.linspace(-60, 60, C), np.linspace(0, 320, C)
    cell = rng.choice(C, p, replace=False)
    fidx = rng.integers(0, F, p)
    y = rng.normal(10.0, 2.0, size=p)
    Xa = A.letkf_analysis(_t(X), _t(y), torch.as_tensor(cell), torch.as_tensor(fidx), _t(lat),
                          _t(lon), obs_err=r, loc_radius_km=0.0, inflation=1.0, solver=solver,
                          ns_iters=60)
    Xf = X.reshape(k, F * C)
    xbar = Xf.mean(0)
    Xp = Xf - xbar
    Pb = Xp.T @ Xp / (k - 1)
    H = np.zeros((p, F * C))
    H[np.arange(p), fidx * C + cell] = 1.0
    K = Pb @ H.T @ np.linalg.inv(H @ Pb @ H.T + np.eye(p) * r ** 2)
    Xa_f = Xa.numpy().reshape(k, F * C)
    np.testing.assert_allclose(Xa_f.mean(0), xbar + K @ (y - H @ xbar), rtol=1e-9, atol=1e-9)
    Xap = Xa_f - Xa_f.mean(0)
    np.testing.assert_allclose(Xap.T @ Xap / (k - 1), (np.eye(F * C) - K @ H) @ Pb,
                               rtol=1e-7, atol=1e-9)


# ---------------------------------------------------------------- (c) θ

@pytest.mark.parametrize("shape,solver", [((12,), "eigh"), ((12, 3), "ns")])
def test_param_analysis_matches_jax(shape, solver):
    """(c) The global parameter update, [k] and [k, n], RTPS 0.5, inflation
    1.04, per-observation errors: within 1e-10 relative of the JAX
    package's; the mean moves and the spread shrinks."""
    r = np.random.default_rng(3)
    theta = r.normal(0.4, 0.05, size=shape)
    Yp = r.normal(0.0, 1.3, size=(12, 30))
    Yp -= Yp.mean(0, keepdims=True)
    d = r.normal(0.0, 1.0, 30)
    err = r.uniform(0.5, 1.0, 30)
    kw = dict(inflation=1.04, rtps=0.5, solver=solver)
    got = A.letkf_param_analysis(_t(theta), _t(Yp), _t(d), _t(err), **kw)
    ref = JA.letkf_param_analysis(jnp.asarray(theta), jnp.asarray(Yp), jnp.asarray(d),
                                  jnp.asarray(err), **kw)
    assert got.shape == theta.shape and _rel(got, ref) <= 1e-10
    assert float(got.std(0, correction=0).max()) < float(theta.std(0).max())


# ------------------------------------------------------ (d) entry points

@pytest.fixture(scope="module")
def ensembles(world):
    """(JAX ensemble, port ensemble) of 6 members, the same numbers."""
    jm, js, _ = world
    jens = _jax_ensemble(js, jm.static.land_mask, 6, 11)
    return jens, convert.ensemble_from_numpy(jens, "cpu", torch.float64)


def _obs(r, n, ocean_only=None):
    cells = np.arange(N_LAT * N_LON) if ocean_only is None else np.flatnonzero(ocean_only == 0)
    return r.choice(cells, n, replace=False)


def _entry_cases(world, ensembles):
    """(name, port analysis, JAX analysis, port args, JAX args) of the
    three entry points on given observations."""
    jm, js, tm = world
    jens, tens = ensembles
    r = np.random.default_rng(12)
    land = np.asarray(jm.static.land_mask).reshape(-1)
    Ts = np.asarray(js.atmos.T_s).reshape(-1)
    cfg = dict(fields=FIELDS, obs_field="T_s", obs_err=0.5, loc_radius_km=3000.0,
               inflation=1.04, rtps=0.6)
    cell = _obs(r, 50)
    y = Ts[cell] + 1.0 + 0.5 * r.standard_normal(50)
    theta = r.normal(0.4, 0.03, (6, 1))
    spec = (("T_s", 30, 0.5), ("sst", 20, 0.3), ("q", 10, 5e-4))
    mcell = np.concatenate([_obs(r, 30), _obs(r, 20, land), _obs(r, 10)])
    q = np.asarray(js.atmos.q).reshape(-1)
    my = np.concatenate([Ts[mcell[:30]] + 1.0, np.asarray(js.ocean.sst).reshape(-1)[mcell[30:50]]
                         - 0.5, q[mcell[50:]] * 0.9])
    tcfg, jcfg = A.AssimConfig(**cfg), JA.AssimConfig(**cfg)
    return [
        ("state", A.make_analysis_fn(tm, tcfg, 50), JA.make_analysis_fn(jm, jcfg, 50),
         (tens, _t(y), torch.as_tensor(cell)), (jens, jnp.asarray(y), jnp.asarray(cell))),
        ("multivar", A.make_multivar_analysis_fn(tm, tcfg, spec),
         JA.make_multivar_analysis_fn(jm, jcfg, spec),
         (tens, _t(my), torch.as_tensor(mcell)), (jens, jnp.asarray(my), jnp.asarray(mcell))),
        ("augmented", A.make_augmented_analysis_fn(tm, tcfg, 50, param_rtps=0.5),
         JA.make_augmented_analysis_fn(jm, jcfg, 50, param_rtps=0.5),
         (tens, _t(theta), _t(y), torch.as_tensor(cell)),
         (jens, jnp.asarray(theta), jnp.asarray(y), jnp.asarray(cell))),
    ]


def test_analysis_entry_points_match_jax(world, ensembles):
    """(d) ``make_analysis_fn``, ``make_multivar_analysis_fn`` (T_s, SST and
    q blocks) and ``make_augmented_analysis_fn`` on a 6-member 19×36
    ensemble: every assimilated field within 1e-10 of its largest |value|,
    θ within 1e-10; the guards hold (q ≥ 0, T_s within [150, 400]), the
    land SST is the background's, the other leaves are the input's tensors,
    and the input ensemble is unchanged (no write in place)."""
    jm, _, tm = world
    _, tens = ensembles
    before = {k: np.copy(v) for k, v in convert.world_to_numpy(tens).items()}
    land = tm.static.land_mask == 1
    for name, tfn, jfn, targs, jargs in _entry_cases(world, ensembles):
        got, ref = tfn(*targs), jax.jit(jfn)(*jargs)
        if name == "augmented":
            (got, th), (ref, jth) = got, ref
            assert _rel(th, jth) <= 1e-10 and not torch.equal(th, targs[1])
        for f in FIELDS:
            g, rf = A._FIELDS[f][0](got), np.asarray(JA._FIELDS[f][0](ref))
            assert _rel(g, rf) <= 1e-10, (name, f, _rel(g, rf))
        assert float(got.atmos.q.min()) >= 0.0
        assert 150.0 <= float(got.atmos.T_s.min()) <= float(got.atmos.T_s.max()) <= 400.0
        assert torch.equal(got.ocean.sst[:, land], tens.ocean.sst[:, land])
        assert not torch.equal(got.ocean.sst, tens.ocean.sst)
        assert got.land is tens.land and got.atmos.cloud_cover is tens.atmos.cloud_cover
    after = convert.world_to_numpy(tens)
    assert all(np.array_equal(v, after[k], equal_nan=True) for k, v in before.items())


def test_analysis_guards_and_refusals(world, ensembles):
    """(d) An observation far below the ensemble pulls q below zero and
    T_s below 150 K before the guards: the guards clamp them; an observed
    field outside the assimilated ones, an unknown field or solver raise."""
    jm, js, tm = world
    _, tens = ensembles
    cell = np.arange(0, N_LAT * N_LON, 7)[:60]
    cfg = A.AssimConfig(fields=("T_s", "q"), obs_field="q", obs_err=1e-6, loc_radius_km=0.0,
                        inflation=2.0, rtps=0.0)
    out = A.make_analysis_fn(tm, cfg, 60)(tens, torch.full((60,), -1.0, dtype=torch.float64),
                                          torch.as_tensor(cell))
    assert float(out.atmos.q.min()) == 0.0
    cfg = dataclasses.replace(cfg, obs_field="T_s")
    out = A.make_analysis_fn(tm, cfg, 60)(tens, torch.full((60,), -500.0, dtype=torch.float64),
                                          torch.as_tensor(cell))
    assert float(out.atmos.T_s.min()) == 150.0
    with pytest.raises(ValueError, match="not in assimilated"):
        A.make_multivar_analysis_fn(tm, cfg, (("sst", 5, 0.3),))
    with pytest.raises(ValueError, match="not in assimilated"):
        A.make_analysis_fn(tm, dataclasses.replace(cfg, obs_field="h"), 5)
    with pytest.raises(ValueError, match="assimilated field"):
        A.make_analysis_fn(tm, dataclasses.replace(cfg, fields=("T_s", "zeta")), 5)
    with pytest.raises(ValueError, match="solver"):
        A.make_analysis_fn(tm, dataclasses.replace(cfg, solver="qr"), 60)(
            tens, torch.zeros(60, dtype=torch.float64), torch.as_tensor(cell))


# ------------------------------------------------------ (f) the aliases

@pytest.mark.parametrize("alias", ["gh_factor", "lw_eps0", "lw_kc", "c_e", "tau_cond"])
def test_member_runs_its_own_parameter(world, alias):
    """(f) Under the ensemble's vmap each member's step is built with its
    own injected parameter (a batched 0-d tensor where the model holds a
    float): over 3 steps member i equals the single planet with θ[i]
    injected, bit for bit. gh_factor, c_e and tau_cond move the members
    apart; lw_eps0 and lw_kc reach only the initial energy state, which the
    step reads instead (the JAX package alike), so they do not."""
    _, _, tm = world
    base = TM.init_world(tm)
    # wind, and air supersaturated in the north and dry in the south, so
    # that condensation (tau_cond) and evaporation (c_e) act
    q = torch.where(tm.grid.lat_mesh > 0, 0.2, 0.005).to(base.atmos.q.dtype)
    base = dataclasses.replace(base, atmos=dataclasses.replace(
        base.atmos, q=q, u=torch.full_like(q, 3.0), v=torch.full_like(q, 3.0)))
    ens = TE.stack_members([base] * 3)
    value = getattr(tm.cfg.energy if alias in ("gh_factor", "lw_eps0", "lw_kc")
                    else tm.cfg.humidity, PARAM_ALIASES[alias].rsplit(".", 1)[1])
    theta = torch.tensor([[0.8 * value], [value], [1.25 * value]], dtype=torch.float64)
    out, diags = A.make_param_ensemble_chunk_fn(tm, (alias,), 3)(ens, theta)
    assert diags["Ts_mean"].shape == (3, 3)
    finals = []
    for i in range(3):
        mdl = inject_path(tm, PARAM_ALIASES[alias], theta[i, 0])
        st, _ = TM.make_chunk_fn(mdl, 3)(base)
        member = TE.member_state(out, i)
        a, b = convert.world_to_numpy(st), convert.world_to_numpy(member)
        assert all(np.asarray(a[k]).tobytes() == np.asarray(b[k]).tobytes() for k in a), \
            (alias, i)
        finals.append(b)
    moved = any(not np.array_equal(finals[0][k], finals[2][k], equal_nan=True)
                for k in finals[0] if isinstance(finals[0][k], np.ndarray)
                and finals[0][k].dtype.kind == "f")
    assert moved == (alias not in ("lw_eps0", "lw_kc")), alias
    with pytest.raises(ValueError, match="theta"):
        A.make_param_ensemble_chunk_fn(tm, (alias,), 3)(ens, theta[:2])


# ------------------------------------------------------ (g) recovery

def test_param_estimation_recovers_gh_factor():
    """(g) The JAX package's ``test_param_estimation_recovers_gh_factor`` on
    the port's CPU path (float32, dt 300 s): the truth runs with gh_factor
    0.46, twelve members start from N(0.34, 0.04²) with 0.01 K of state
    noise, and four 12-step cycles of the per-member forecast and the
    augmented analysis (80 T_s observations, σ 0.05 K) move the mean more
    than half way to the truth, through the θ ↔ T_s cross-covariances
    alone."""
    tm, _ = entry.build_world(N_LAT, N_LON, device="cpu")
    g_true, g_prior = 0.46, 0.34
    k, n_obs, cyc = 12, 80, 12
    mdl_truth = inject_path(tm, PARAM_ALIASES["gh_factor"], torch.tensor(g_true))
    truth = TM.init_world(mdl_truth)
    tchunk = TM.make_chunk_fn(mdl_truth, cyc)
    ens, gens = TE.init_ensemble(tm, k, perturb_k=0.01)
    gen = torch.Generator().manual_seed(2)
    theta = g_prior + 0.04 * torch.randn((k, 1), generator=gen)
    cfg = A.AssimConfig(fields=("T_s", "sst", "h", "q"), obs_field="T_s", obs_err=0.05,
                        loc_radius_km=4000.0, inflation=1.02, rtps=0.6)
    echunk = A.make_param_ensemble_chunk_fn(tm, ("gh_factor",), cyc)
    analysis = A.make_augmented_analysis_fn(tm, cfg, n_obs, param_rtps=0.5)
    err0 = abs(float(theta.mean()) - g_true)
    for _ in range(4):
        truth, _ = tchunk(truth)
        ens, _ = echunk(ens, theta, gens)
        cell = A.draw_obs_network(gen, tm, n_obs)
        y = A.synthetic_obs(gen, truth, cell, "T_s", cfg.obs_err)
        ens, theta = analysis(ens, theta, y, cell)
    err, spread = abs(float(theta.mean()) - g_true), float(theta.std())
    assert np.isfinite(err) and spread > 0.0
    assert err < 0.5 * err0, (err, err0, spread)


# ------------------------------------------------------ (h) the CLI

CLI = ["--device", "cpu", "--nlat", str(N_LAT), "--nlon", str(N_LON), "--cycle-steps", "6",
       "--members", "4", "--cycles", "2", "--burnin-cycles", "1", "--json"]


@pytest.mark.parametrize("extra", [[], ["--obs-mix", "T_s:40,sst:20"],
                                   ["--est-param", "gh_factor", "--out", "osse.json"]],
                         ids=["plain", "obs-mix", "est-param"])
def test_cli_on_the_cpu(monkeypatch, tmp_path, capsys, extra):
    """(h) ``python -m qingdai_tpu_torch.assimilate`` in-process on the CPU:
    the summary is finite, every assimilated field has its RMSE, the
    parameter its mean and spread; ``--out`` writes under ``output/`` and
    ``ASSIM.json`` is untouched."""
    for key in [k for k in os.environ if k.startswith("QD_")]:
        monkeypatch.delenv(key)
    monkeypatch.chdir(tmp_path)
    record = (REPO / "ASSIM.json").read_bytes()
    summary = assimilate.main(CLI + extra)
    printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert printed == json.loads(json.dumps(summary))
    assert summary["grid"] == "19x36" and summary["device"] == "cpu"
    assert len(summary["series"]) == 2 and summary["burnin_cycles"] == 1
    numbers = [v for row in summary["series"] for v in row.values()]
    numbers += list(summary["final_rmse_by_field"].values()) + list(summary["cycle_ms"].values())
    assert all(np.isfinite(v) for v in numbers)
    assert set(summary["final_rmse_by_field"]) == {f + s for f in FIELDS for s in ("", "_free")}
    assert set(summary["cycle_ms"]) == {"truth", "forecast", "free", "analysis"}
    if "--est-param" in extra:
        assert summary["param_final_std"] > 0.0 and "param_mean" in summary["series"][-1]
        assert json.loads((tmp_path / "output" / "osse.json").read_text()) == printed
    assert hashlib.sha256((REPO / "ASSIM.json").read_bytes()).digest() == \
        hashlib.sha256(record).digest()


def test_cli_refuses_obs_mix_with_a_parameter_update(monkeypatch, tmp_path):
    """(h) As the JAX CLI: a multivariate network with a parameter update
    is refused."""
    monkeypatch.chdir(tmp_path)
    with pytest.raises(SystemExit, match="not supported"):
        assimilate.main(CLI + ["--obs-mix", "T_s:40", "--est-param", "gh_factor"])


# ------------------------------------------------------ (i) the networks

def test_observing_networks(world):
    """(i) ``draw_obs_network`` gives n distinct cells; ``draw_multivar_obs``
    gives each block its size, an SST block only on ocean cells, and
    observations near the truth at the drawn cells."""
    _, js, tm = world
    truth = convert.world_from_numpy(js, "cpu", torch.float64)
    gen = torch.Generator().manual_seed(0)
    cell = A.draw_obs_network(gen, tm, 300)
    assert cell.shape == (300,) and len(set(cell.tolist())) == 300
    spec = (("T_s", 40, 0.5), ("sst", 200, 0.3), ("q", 10, 5e-4))
    y, cells = A.draw_multivar_obs(gen, tm, truth, spec)
    assert y.shape == cells.shape == (250,)
    land = tm.static.land_mask.reshape(-1)
    sst_cells = cells[40:240]
    assert len(set(sst_cells.tolist())) == 200 and bool(torch.all(land[sst_cells] == 0))
    assert bool(torch.any(land[cells[:40]] == 1))
    resid = y[40:240] - truth.ocean.sst.reshape(-1)[sst_cells]
    assert 0.1 < float(resid.std()) < 0.6


# ---------------------------------------------------------- (e), last: the JAX
# reference has run beside every test above

def test_augmented_cycle_matches_jax(world, jax_cycle):
    """(e) One augmented cycle: the per-member-parameter forecast (6 steps,
    k = 4, θ given; the phytoplankton's daily block, which fires on a fresh
    state's first step, and two routing events inside) and the
    augmented analysis on given observation cells and noise, against the
    JAX package: every forecast and analysis leaf within 1e-8 of its largest
    |value|, the diags within 1e-8, θ within 1e-10."""
    jm, js, tm = world
    ens = convert.ensemble_from_numpy(_jax_ensemble(js, jm.static.land_mask, CYCLE_K,
                                                    CYCLE_SEED), "cpu", torch.float64)
    theta = _t(CYCLE_THETA)
    ens, diags = A.make_param_ensemble_chunk_fn(tm, ("gh_factor",), CYCLE_STEPS)(ens, theta)
    cells, noise = _cycle_obs(N_LAT * N_LON)
    y = _t(np.asarray(js.atmos.T_s).reshape(-1)[cells] + 0.5 * noise)
    analysis = A.make_augmented_analysis_fn(tm, A.AssimConfig(**CYCLE_CFG), CYCLE_OBS,
                                            param_rtps=0.5)
    ens_a, th_a = analysis(ens, theta, y, torch.as_tensor(cells))
    ref = jax_cycle()
    assert _rel(th_a, ref["theta_a"]) <= 1e-10 and not torch.equal(th_a, theta)
    assert _rel(diags["Ts_mean"], ref["Ts_mean"]) <= 1e-8
    checked = 0
    for tag, s in (("f", ens), ("a", ens_a)):
        got = convert.world_to_numpy(s)
        for key, r in ref.items():
            if not key.startswith(tag + "."):
                continue
            g = got[key[2:]]
            fin = np.isfinite(r)
            np.testing.assert_array_equal(fin, np.isfinite(g), err_msg=key)
            if r.dtype.kind != "f":
                np.testing.assert_array_equal(g, r, err_msg=key)
            elif fin.any():
                err = np.max(np.abs(g[fin] - r[fin])) / max(np.max(np.abs(r[fin])), 1e-300)
                assert err <= 1e-8, (key, err)
            checked += 1
    assert checked > 40
