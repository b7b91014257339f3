"""The port's fused ocean substeps (K4's plain version) and ``ocean_step``
with a tracer stack, against the JAX package's ``ocean_step`` run through
its Pallas kernel in interpret mode, on the CPU at 19×36 in float64.

The JAX kernel sums only the shifts of its advection plan's window; the
port gathers all four corners wherever they are. The two agree while the
pre-cap currents stay inside the window (the ocean plan's max_u_cap + 2 =
5 m/s), which holds for these inputs: currents of N(0, 0.5) m/s under
winds of N(0, 8) m/s. Tolerance: 1e-12 of each field's largest |value|.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qingdai_tpu import flags
from qingdai_tpu.config import OceanConfig as JOceanConfig
from qingdai_tpu.grid import make_grid as j_make_grid
from qingdai_tpu.ocean import ocean_step as j_ocean_step
from qingdai_tpu.ops.advect import make_advect_plan, plan_shifts
from qingdai_tpu.ops.pallas_ocean import ocean_substeps_pallas
from qingdai_tpu.state import OceanState as JOceanState
from qingdai_tpu_torch import ocean as tocean
from qingdai_tpu_torch.config import OceanConfig as TOceanConfig
from qingdai_tpu_torch.grid import make_grid as t_make_grid
from qingdai_tpu_torch.state import OceanState as TOceanState

torch.set_num_threads(1)

H, W = 19, 36
A = 6.371e6
REL = 1e-12
F64 = torch.float64


@pytest.fixture
def pallas_interpret(monkeypatch):
    """The JAX ocean step through its Pallas kernel in interpret mode; the
    gate reads flags' frozen snapshot, restored on teardown."""
    monkeypatch.setenv("QD_PALLAS_OCEAN", "interpret")
    flags.refresh()
    yield
    monkeypatch.delenv("QD_PALLAS_OCEAN")
    flags.refresh()


def _inputs(seed, n_tracers):
    r = np.random.default_rng(seed)
    x = dict(land=(r.random((H, W)) < 0.3).astype(np.int32),
             uo=r.normal(0, 0.5, (H, W)), vo=r.normal(0, 0.5, (H, W)),
             eta=r.normal(0, 0.2, (H, W)), sst=r.normal(288, 8, (H, W)),
             u_atm=r.normal(0, 8, (H, W)), v_atm=r.normal(0, 4, (H, W)),
             Q_net=r.normal(0, 40, (H, W)), ice=r.random((H, W)) < 0.1)
    x["tracers"] = r.uniform(0, 1, (n_tracers, H, W)) if n_tracers else None
    return x


def _jax_step(x, cfg, n_sub, step_idx=0):
    grid = j_make_grid(H, W, dtype=jnp.float64)
    plan = make_advect_plan(H, grid.dlat_rad, grid.dlon_rad, 300.0 / n_sub, A,
                            np.asarray(grid.coslat_cap_05)[:, 0], vmax=cfg.max_u_cap + 2.0)
    assert plan.exact_rows == ()
    ocn = JOceanState(*(jnp.asarray(x[k]) for k in ("uo", "vo", "eta", "sst")))
    trc = None if x["tracers"] is None else jnp.asarray(x["tracers"])
    return j_ocean_step(grid, cfg, jnp.asarray(x["land"]), ocn, jnp.asarray(x["u_atm"]),
                        jnp.asarray(x["v_atm"]), jnp.asarray(x["Q_net"]), jnp.asarray(x["ice"]),
                        jnp.asarray(step_idx), 300.0, n_sub, tracers=trc, adv_plan=plan)


def _t(x, dtype=F64):
    return None if x is None else torch.as_tensor(np.asarray(x)).to(dtype)


def _port_step(x, cfg, n_sub, step_idx=0):
    grid = t_make_grid(H, W, device="cpu", dtype=F64)
    ocn = TOceanState(*(_t(x[k]) for k in ("uo", "vo", "eta", "sst")))
    return tocean.ocean_step(grid, cfg, _t(x["land"], torch.int32), ocn, _t(x["u_atm"]),
                             _t(x["v_atm"]), _t(x["Q_net"]), _t(x["ice"], torch.bool),
                             step_idx, 300.0, n_sub, tracers=_t(x["tracers"]))


def _close(ref, got, what):
    r, g = np.asarray(ref, np.float64), got.numpy()
    scale = max(float(np.max(np.abs(r))), 1e-300)
    assert float(np.max(np.abs(r - g))) <= REL * scale, (what, np.max(np.abs(r - g)) / scale)


def _assert_steps_close(jout, tout):
    (jo, jtrc), (to, ttrc) = jout, tout
    for f in ("uo", "vo", "eta", "sst"):
        _close(getattr(jo, f), getattr(to, f), f)
    assert (jtrc is None) == (ttrc is None)
    if jtrc is not None:
        _close(jtrc, ttrc, "tracers")


@pytest.mark.parametrize("n_tracers,n_sub", [(0, 1), (3, 1), (0, 2)])
def test_ocean_step_matches_jax_kernel(pallas_interpret, monkeypatch, n_tracers, n_sub):
    """ocean_step with the SST + tracer stack (one substep) and without
    tracers (one and two substeps) against the JAX Pallas kernel path."""
    from qingdai_tpu.ops import pallas_ocean
    calls = []
    real = pallas_ocean.ocean_substeps_pallas
    monkeypatch.setattr(pallas_ocean, "ocean_substeps_pallas",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    x = _inputs(11, n_tracers)
    ref = _jax_step(x, JOceanConfig(n_substeps=n_sub), n_sub)
    assert calls == [1]       # the JAX step went through its kernel
    _assert_steps_close(ref, _port_step(x, TOceanConfig(n_substeps=n_sub), n_sub))


@pytest.mark.parametrize("k4_nsub,K_h,outlier", [(2, 5.0e3, "mean4"), (1, 0.0, "clamp")])
def test_ocean_substeps_plain_matches_pallas_kernel(k4_nsub, K_h, outlier):
    """K4's plain version against ``ocean_substeps_pallas`` (interpret) on
    the same stacks: ∇⁴ substeps, K_h on and off, both outlier methods."""
    x = _inputs(12, 3)
    cfg = TOceanConfig(n_substeps=1, k4_nsub=k4_nsub, K_h=K_h, outlier_method=outlier)
    grid = t_make_grid(H, W, device="cpu", dtype=F64)
    ocn = TOceanState(*(_t(x[k]) for k in ("uo", "vo", "eta", "sst")))
    mom, st, forc, geo, p = tocean.substep_operands(
        grid, cfg, _t(x["land"], torch.int32), ocn, _t(x["u_atm"]), _t(x["v_atm"]),
        _t(x["Q_net"]), _t(x["ice"], torch.bool), 300.0, 1, _t(x["tracers"]))
    assert geo.shape[0] == tocean.N_GEO
    got = tocean.ocean_substeps_plain(mom, st, forc, geo, **p)
    jgrid = j_make_grid(H, W, dtype=jnp.float64)
    plan = make_advect_plan(H, jgrid.dlat_rad, jgrid.dlon_rad, 300.0, A,
                            np.asarray(jgrid.coslat_cap_05)[:, 0], vmax=cfg.max_u_cap + 2.0)
    ms, ks = plan_shifts(plan)
    ref = ocean_substeps_pallas(*(jnp.asarray(t.numpy()) for t in (mom, st, forc, geo)),
                                ms=ms, ks=ks, **p, interpret=True)
    for name, r_, g_ in (("mom", ref[0], got[0]), ("st", ref[1], got[1])):
        for k in range(g_.shape[0]):
            _close(r_[k], g_[k], f"{name}[{k}]")


@pytest.mark.parametrize("variant,step_idx,fused", [
    ("default", 0, True), ("shapiro", 7, False), ("diff_every", 3, False),
    ("diff_every", 4, False)])
def test_dispatch_by_structure(monkeypatch, variant, step_idx, fused):
    """Shapiro on, or ∇⁴ on another cadence, keeps the unfused substeps (the
    JAX gate refuses its kernel there); both still match the JAX step."""
    kw = {"default": {}, "shapiro": dict(shapiro_n=2, shapiro_every=8),
          "diff_every": dict(diff_every=4)}[variant]
    tcfg = TOceanConfig(n_substeps=1, **kw)
    assert tocean.fused_structure(tcfg) is fused
    calls = []
    real = tocean.ocean_substeps
    monkeypatch.setattr(tocean, "ocean_substeps", lambda *a, **k: calls.append(1) or real(*a, **k))
    x = _inputs(13, 2)
    got = _port_step(x, tcfg, 1, step_idx)
    assert len(calls) == int(fused)
    _assert_steps_close(_jax_step(x, dataclasses.replace(JOceanConfig(n_substeps=1), **kw), 1,
                                  step_idx), got)


def test_tracers_need_one_substep():
    x = _inputs(14, 2)
    with pytest.raises(ValueError, match="n_sub == 1"):
        _port_step(x, TOceanConfig(n_substeps=2), 2)
