"""The port's ensemble against the JAX package's, on the CPU at 19×36 in f64.

Both packages build the flagship planet (every default on, routing
included) from one hermetic environment. The JAX ensemble's 12-step chunk
is jitted once and warms three copies of the cold state 24 steps, past the
cold start and the median knife edge; member 0 is the warm state. Both day
accumulators are put six steps before the day's end and the routing clock
one step before an event, so a 12-step window routes at its first step and
runs the daily blocks at its sixth. Tolerances are relative to each leaf's
largest |value|.

Under the ensemble's ``torch.func.vmap`` no op may fall back to functorch's
per-member loop: its warning is an error in every test of this file. No
random number may be drawn inside the vmap: it runs with
``randomness="error"``, and a test counts where the mutation's draws are
taken.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as graft
from qingdai_tpu import ensemble as JE
from qingdai_tpu_torch import convert, entry
from qingdai_tpu_torch import ensemble as TE
from qingdai_tpu_torch import model as TM
from qingdai_tpu_torch import ocean as tocean
from qingdai_tpu_torch.ops import advect, reductions, stencil

torch.set_num_threads(1)

N_LAT, N_LON = 19, 36
FLAGSHIP = {"QD_ECO_RAND_SEED": "7"}
# mutation on, with free species slots so that it fires
MUTATING = {"QD_ECO_RAND_SEED": "7", "QD_ECO_NS": "3", "QD_ECO_MUT_RATE": "1.0"}
FALLBACK = "There is a performance drop because we have not yet implemented the batching rule"
pytestmark = pytest.mark.filterwarnings(f"error:{FALLBACK}")


def _near_events(model, clock, routing):
    """The clock and routing groups with both day accumulators six steps
    before the day's end and the routing clock one step before an event."""
    near = model.day_seconds - 6 * model.dt
    t_ev = model.cfg.hydrology.dt_hydro_hours * 3600.0 - model.dt
    return (dataclasses.replace(clock, accum_t_day=near, phyto_accum=near),
            dataclasses.replace(routing, t_accum=t_ev))


@pytest.fixture(scope="module")
def warm():
    """(JAX model, warm JAX state near the events, port model, the JAX
    ensemble's jitted 12-step chunk). The warm-up runs through that chunk,
    on three copies of the cold state, so the file compiles one JAX chunk."""
    jm, js = graft._build_world(N_LAT, N_LON, extra_env=FLAGSHIP, dtype=jnp.float64,
                                hermetic=True)
    jchunk = jax.jit(JE.make_ensemble_chunk_fn(jm, 12))
    jens = jax.tree.map(lambda x: jnp.stack([x] * 3), js)
    for _ in range(2):
        jens, _ = jchunk(jens)
    js = JE.member_state(jens, 0)
    clock, routing = _near_events(jm, js.clock, js.routing)
    js = dataclasses.replace(
        js, clock=dataclasses.replace(clock, accum_t_day=jnp.asarray(
            clock.accum_t_day, js.clock.accum_t_day.dtype), phyto_accum=jnp.asarray(
            clock.phyto_accum, js.clock.phyto_accum.dtype)),
        routing=dataclasses.replace(routing, t_accum=jnp.asarray(
            routing.t_accum, js.routing.t_accum.dtype)))
    tm, _ = entry.build_world(N_LAT, N_LON, extra_env=FLAGSHIP, device="cpu",
                              dtype=torch.float64)
    return jm, js, tm, jchunk


def _rel_errs(ref: dict, got: dict, routed: float = 0.0):
    """max|ref − got| / max|ref| per key (finite entries, which must agree);
    the routing leaves that are differences of routed sums, relative to the
    routed mass."""
    errs = {}
    for k, r in ref.items():
        r = np.asarray(r, np.float64)
        g = np.asarray(got[k].numpy() if isinstance(got[k], torch.Tensor) else got[k],
                       np.float64)
        assert r.shape == g.shape, k
        np.testing.assert_array_equal(np.isfinite(r), np.isfinite(g), err_msg=k)
        fin = np.isfinite(r)
        scale = max(float(np.max(np.abs(r[fin]), initial=0.0)), 1e-300)
        if "stranded" in k or "mass_error" in k:
            scale = max(scale, routed)
        errs[k] = float(np.max(np.abs(r[fin] - g[fin]), initial=0.0)) / scale
    return errs


def _worst(ref_state, got_state):
    ref, got = convert.world_to_numpy(ref_state), convert.world_to_numpy(got_state)
    assert set(ref) == set(got)
    assert ref.pop("clock.step_idx") == got.pop("clock.step_idx")
    errs = _rel_errs(ref, got, float(np.max(np.abs(ref["routing.routed_mass_kg"]))))
    worst = max(errs, key=errs.get)
    return worst, errs[worst]


def _bit_equal(a, b):
    fa, fb = convert.world_to_numpy(a), convert.world_to_numpy(b)
    return set(fa) == set(fb) and all(
        np.asarray(fa[k]).tobytes() == np.asarray(fb[k]).tobytes() for k in fa)


def test_ensemble_matches_jax(warm):
    """(a) A JAX ensemble of three members, made by the JAX package's own
    functions from the warm state (member 0 unperturbed), carried into the
    port; 12 steps through both ensemble chunks, across a routing event and
    the daily blocks: every member and every leaf within 1e-8."""
    jm, js, tm, jchunk = warm
    keys = jax.random.split(jax.random.PRNGKey(11), 3)
    amps, h_amps = jnp.asarray([0.0, 0.05, 0.05]), jnp.asarray([0.0, 1.0, 1.0])
    jens = jax.vmap(JE.perturb_member, in_axes=(None, 0, 0, None, 0))(
        js, keys, amps, jm.static.land_mask, h_amps)
    jens = jax.tree.map(lambda e, b: e.at[0].set(b), jens, js)
    tens = convert.ensemble_from_numpy(jens, "cpu", torch.float64)
    assert TE.n_members(tens) == 3 and tens.clock.step_idx == 24
    assert isinstance(tens.routing.t_accum, float) and tens.clock.t_seconds.dim() == 0

    jens, jd = jchunk(jens)
    tens, td = TE.make_ensemble_chunk_fn(tm, 12)(tens)
    assert tens.routing.t_accum == 11 * tm.dt and tens.clock.accum_t_day == 6 * tm.dt
    for i in range(3):
        k, err = _worst(JE.member_state(jens, i), TE.member_state(tens, i))
        assert err <= 1e-8, (i, k, err)
    assert set(jd) == set(td) and all(v.shape == (3, 12) for v in td.values())
    errs = _rel_errs({k: np.asarray(v) for k, v in jd.items()}, td,
                     float(np.max(np.abs(np.asarray(jd["routing_routed_mass_kg"])))))
    worst = max(errs, key=errs.get)
    assert errs[worst] <= 1e-8, (worst, errs[worst])
    spread = TE.spread_diagnostics(td)
    assert spread["Ts_mean_spread"] > 0.0
    jspread = JE.spread_diagnostics(jd)
    assert abs(spread["Ts_mean_spread"] - jspread["Ts_mean_spread"]) <= 1e-8 * abs(
        jspread["Ts_mean_spread"])


@pytest.mark.parametrize("n", [1, 3])
def test_member0_replays_the_single_planet(warm, n):
    """(b) Member 0 against the port's single-planet chunk over the window:
    bit-equal at one member, within 1e-12 at three."""
    _, js, tm, _ = warm
    ts = convert.world_from_numpy(js, "cpu", torch.float64)
    single, sd = TM.make_chunk_fn(tm, 12)(ts)
    gens = [torch.Generator().manual_seed(TE.member_seed(5, i)) for i in range(1, n)]
    ens = TE.stack_members([ts] + [TE.perturb_member(ts, g, 0.05, tm.static.land_mask, 1.0)
                                   for g in gens])
    ens, d = TE.make_ensemble_chunk_fn(tm, 12)(ens)
    m0 = TE.member_state(ens, 0)
    if n == 1:
        assert _bit_equal(single, m0)
        assert all(torch.equal(sd[k], d[k][0]) for k in sd)
    else:
        k, err = _worst(single, m0)
        assert err <= 1e-12, (k, err)
        assert not torch.equal(d["Ts_mean"][1], d["Ts_mean"][0])


def _mutating_warm():
    mdl, st = entry.build_world(N_LAT, N_LON, extra_env=MUTATING, device="cpu",
                                dtype=torch.float64)
    st, _ = TM.make_chunk_fn(mdl, 24)(st)
    clock, routing = _near_events(mdl, st.clock, st.routing)
    return mdl, dataclasses.replace(st, clock=clock, routing=routing)


def test_mutation_member0_replays_and_members_differ():
    """(c) QD_ECO_MUT_RATE = 1: member 0 of an ensemble on a fresh build of
    the same planet replays the single planet's window bit for bit, its
    generator's state after the chunk included; members 1 and 2, the same
    state on their own streams, mutate differently."""
    mdl, st = _mutating_warm()
    g0 = mdl.generator.get_state()
    single, _ = TM.make_chunk_fn(mdl, 12)(st)
    mdl2, _ = entry.build_world(N_LAT, N_LON, extra_env=MUTATING, device="cpu",
                                dtype=torch.float64)
    mdl2.generator.set_state(g0)
    gens = [mdl2.generator] + [torch.Generator().manual_seed(TE.member_seed(42, i))
                               for i in (1, 2)]
    ens, _ = TE.make_ensemble_chunk_fn(mdl2, 12)(TE.stack_members([st] * 3), gens)
    assert _bit_equal(single, TE.member_state(ens, 0))
    assert torch.equal(mdl.generator.get_state(), mdl2.generator.get_state())
    n0 = int(st.eco.n_active)
    assert ens.eco.n_active.tolist() == [n0 + 1] * 3          # each member mutated once
    peaks = ens.eco.peaks[:, n0]
    assert not torch.equal(peaks[0], peaks[1]) and not torch.equal(peaks[1], peaks[2])
    with pytest.raises(ValueError, match="generators"):
        TE.make_ensemble_chunk_fn(mdl2, 12)(TE.stack_members([st] * 3))


def test_correlated_noise_and_perturbation_match_jax(warm):
    """(d) ``_correlated_noise`` fed the JAX function's own white noise, and
    ``perturb_member`` fed the JAX member's draws, equal the JAX package's."""
    jm, js, _, _ = warm
    key = jax.random.PRNGKey(3)
    shape = (N_LAT, N_LON)
    ref = np.asarray(JE._correlated_noise(key, shape, jnp.float64))
    got = TE._correlated_noise(torch.as_tensor(np.array(
        jax.random.normal(key, shape, jnp.float64))))
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-12 * np.abs(ref).max())
    assert abs(float(got.std(correction=0)) - 1.0) < 1e-12

    jp = JE.perturb_member(js, key, 0.05, jm.static.land_mask, 1.0)
    k_noise, k_h, _ = jax.random.split(key, 3)
    draws = tuple(torch.as_tensor(np.array(jax.random.normal(k, shape, jnp.float64)))
                  for k in (k_noise, k_h))
    ts = convert.world_from_numpy(js, "cpu", torch.float64)
    tp = TE.perturb_member(ts, draws, 0.05, ts.ocean.sst.new_tensor(
        np.asarray(jm.static.land_mask)), 1.0)
    for got, ref in ((tp.atmos.T_s, jp.atmos.T_s), (tp.atmos.h, jp.atmos.h),
                     (tp.ocean.sst, jp.ocean.sst)):
        ref = np.asarray(ref)
        np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-12 * np.abs(ref).max())


def test_no_draw_inside_the_vmap(monkeypatch):
    """(e) With mutation on, every random number of the window is drawn
    outside functorch's transforms (each member's mutation from its own
    generator), and a fallback to the per-member loop would raise: the
    file's warning filter turns functorch's warning into an error."""
    mdl, st = _mutating_warm()
    inside, outside = [], []

    def recording(fn):
        def wrapped(*args, **kwargs):
            level = torch._C._functorch.peek_interpreter_stack()
            (outside if level is None else inside).append(fn.__name__)
            return fn(*args, **kwargs)
        return wrapped

    for name in ("rand", "randn"):
        monkeypatch.setattr(torch, name, recording(getattr(torch, name)))
    gens = [mdl.generator] + [torch.Generator().manual_seed(i) for i in (1, 2)]
    TE.make_ensemble_chunk_fn(mdl, 12)(TE.stack_members([st] * 3), gens)
    monkeypatch.undo()
    assert inside == []
    assert sorted(outside) == sorted(["rand"] * 9 + ["randn"] * 21)   # 3 members × (3 + 7)

    idx = torch.tensor([1, 0])
    with pytest.raises(UserWarning, match=FALLBACK):
        torch.func.vmap(lambda x: torch.zeros_like(x).index_copy_(0, idx, x))(torch.ones(3, 2))


def _members_of(t, dim, b):
    return t if dim is None else t.select(dim, b)


@pytest.mark.parametrize("kernel", ["median_pos", "advect_bilinear", "hyper4",
                                    "ocean_substeps"])
def test_function_vmap_rules_on_the_cpu(warm, kernel):
    """(f) Each kernel's dispatcher on CPU tensors under ``torch.func.vmap``
    with mixed ``in_dims`` (members first, members inside, unbatched) equals
    B single calls of its plain version, bit for bit."""
    tm = warm[2]
    g = tm.grid
    r = np.random.default_rng(9)
    B, H, W = 3, N_LAT, N_LON

    def t(*shape):
        return torch.as_tensor(r.standard_normal(shape))

    if kernel == "median_pos":
        fn, plain = reductions.masked_median_of_positive, reductions.masked_median_of_positive_ref
        args, dims = (t(H, B, W),), (1,)
    elif kernel == "advect_bilinear":
        fn, plain = advect.advect_semilag_multi, advect.advect_semilag_multi_ref
        sc = (300.0, 6.4e6, g.dlat_rad, g.dlon_rad)
        args = (t(B, 2, H, W), 40.0 * t(H, W, B), 40.0 * t(H, W), *sc, g.coslat_cap_tiny)
        dims = (0, 2, None, None, None, None, None, None)
    elif kernel == "hyper4":
        fn, plain = stencil.hyperdiffuse_multi, stencil.hyperdiffuse_multi_ref
        k4 = torch.stack([g.k4_map_unit * 0.02 / 300.0] * 3)
        args = (t(3, B, H, W), k4[:, None].expand(3, B, H, W) * (1 + 0.1 * t(3, B, 1, 1)), 300.0,
                2, g.dlat_rad, g.dlon_rad, g.coslat_cap_02, 6.4e6)
        dims = (1, 1, None, None, None, None, None, None)
    else:
        from chip_smoke import k4_operands
        mom, st, forc, geo, params = k4_operands("cpu", torch.float64, 2, 1, 1, 5.0e3, seed=4,
                                                 shape=(H, W))
        fn = plain = None
        noisy = [x[None] + 0.01 * torch.as_tensor(r.standard_normal((B,) + tuple(x.shape)))
                 for x in (mom, st)]
        args = (noisy[0], noisy[1].movedim(0, 1), forc, torch.stack([geo] * B, 1))
        dims = (0, 1, None, 1)
        got = torch.func.vmap(lambda *a: tocean.ocean_substeps(*a, **params), in_dims=dims,
                              randomness="error")(*args)
        for b in range(B):
            ref = tocean.ocean_substeps_plain(*(_members_of(a, d, b) for a, d in zip(args, dims)),
                                              **params)
            assert all(torch.equal(x[b], y) for x, y in zip(got, ref)), b
        return
    got = torch.func.vmap(fn, in_dims=dims, randomness="error")(*args)
    for b in range(B):
        assert torch.equal(got[b], plain(*(_members_of(a, d, b) for a, d in zip(args, dims)))), b


@pytest.mark.parametrize("kernel", ["median_pos", "advect_bilinear", "hyper4",
                                    "ocean_substeps"])
def test_function_vmap_rules_reach_one_batched_launch(warm, monkeypatch, kernel):
    """(f) The card's branch of each rule, on the CPU: with the dispatch made
    to say "kernel" and the batched form replaced by plain calls on each
    member's slice (an input without the member axis is shared), one vmapped
    call makes one batched call with contiguous operands, whose members
    equal the single plain calls."""
    from qingdai_tpu_torch.kernels import advect_bilinear as k2
    from qingdai_tpu_torch.kernels import hyper4 as k3
    from qingdai_tpu_torch.kernels import median_pos as k1
    from qingdai_tpu_torch.kernels import ocean_substeps as k4

    g = warm[2].grid
    r = np.random.default_rng(10)
    B, H, W = 3, N_LAT, N_LON
    calls = []

    def member(x, b, ndim):
        """Member b's operand of a batched call: [B, ...] or shared [...]."""
        assert x.is_contiguous() and x.dim() in (ndim, ndim + 1)
        return x[b] if x.dim() == ndim + 1 else x

    def stacked(n, outs):
        calls.append(n)
        return (torch.stack(outs) if isinstance(outs[0], torch.Tensor)
                else tuple(torch.stack(o) for o in zip(*outs)))

    def fake_k1(x, n, fallback):
        return stacked(n, [reductions.masked_median_of_positive_ref(member(x, b, 2), fallback)
                           for b in range(n)])

    def fake_k2(f, u, v, dt, a, dlat, dlon, c, n):
        return stacked(n, [advect.advect_semilag_multi_ref(
            member(f, b, 3), member(u, b, 2), member(v, b, 2), dt, a, dlat, dlon,
            member(c, b, 2)) for b in range(n)])

    def fake_k3(F, k4_, dt, nsub, dlat, dlon, c, a, n):
        return stacked(n, [stencil.hyperdiffuse_multi_ref(
            member(F, b, 3), member(k4_, b, 3), dt, nsub, dlat, dlon, member(c, b, 2), a)
            for b in range(n)])

    def fake_k4(mom, st, forc, geo, n, **params):
        return stacked(n, [tocean.ocean_substeps_plain(*(member(x, b, 3) for x in (
            mom, st, forc, geo)), **params) for b in range(n)])

    for mod in (reductions, advect, stencil, tocean):
        monkeypatch.setattr(mod, "use_kernel", lambda t: True)
    for mod, name, f in ((k1, "median_pos_batched_cuda", fake_k1),
                         (k2, "advect_bilinear_batched_cuda", fake_k2),
                         (k3, "hyperdiffuse_batched_cuda", fake_k3),
                         (k4, "ocean_substeps_batched_cuda", fake_k4)):
        monkeypatch.setattr(mod, name, f)

    def t(*shape):
        return torch.as_tensor(r.standard_normal(shape))

    params = {}
    if kernel == "median_pos":
        fn, plain = reductions.masked_median_of_positive, reductions.masked_median_of_positive_ref
        args, dims = (t(H, W, B),), (2,)
    elif kernel == "advect_bilinear":
        fn, plain = advect.advect_semilag_multi, advect.advect_semilag_multi_ref
        args = (t(2, H, W), 40.0 * t(B, H, W), 40.0 * t(H, B, W), 300.0, 6.4e6, g.dlat_rad,
                g.dlon_rad, g.coslat_cap_tiny)
        dims = (None, 0, 1, None, None, None, None, None)
    elif kernel == "hyper4":
        fn, plain = stencil.hyperdiffuse_multi, stencil.hyperdiffuse_multi_ref
        k4 = (g.k4_map_unit * 0.02 / 300.0)[None] * torch.tensor([1.0, 0.5, 0.25])[:, None, None]
        args = (t(B, 3, H, W), k4, 300.0, 1, g.dlat_rad, g.dlon_rad, g.coslat_cap_02, 6.4e6)
        dims = (0, None, None, None, None, None, None, None)
    else:
        from chip_smoke import k4_operands
        mom, st, forc, geo, params = k4_operands("cpu", torch.float64, 2, 1, 1, 5.0e3, seed=4,
                                                 shape=(H, W))
        fn, plain = tocean.ocean_substeps, tocean.ocean_substeps_plain
        args = (mom, st[None] + 0.01 * torch.as_tensor(r.standard_normal((B,) + tuple(st.shape))),
                forc, geo)
        dims = (None, 0, None, None)
    got = torch.func.vmap(lambda *a: fn(*a, **params), in_dims=dims, randomness="error")(*args)
    assert calls == [B]
    for b in range(B):
        ref = plain(*(_members_of(a, d, b) for a, d in zip(args, dims)), **params)
        pairs = zip(got, ref) if isinstance(ref, tuple) else [(got, ref)]
        assert all(torch.equal(x[b], y) for x, y in pairs), b


def test_float32_member0_bound(warm):
    """Member 0 of a float32 ensemble of three against the float32 single
    planet over the window, without the pole rows: within
    ``ENSEMBLE_F32_REL`` of each leaf's largest |value|, the bound
    ``chip_smoke.py`` holds member 0 on the card to. Inside a batched
    reduction the sums may run in another order than the single planet's,
    an ulp apart, which the step's dynamics grow over the window. The
    control: members 1 and 2, perturbed by 0.01 K as ``run_ensemble``
    perturbs them, lie beyond the bound."""
    from chip_smoke import ENSEMBLE_F32_REL, member_errors

    _, js, _, _ = warm
    tm, _ = entry.build_world(N_LAT, N_LON, extra_env=FLAGSHIP, device="cpu",
                              dtype=torch.float32)
    ts = convert.world_from_numpy(js, "cpu", torch.float32)
    single, _ = TM.make_chunk_fn(tm, 12)(ts)
    gens = [torch.Generator().manual_seed(i) for i in (1, 2)]
    ens = TE.stack_members([ts] + [TE.perturb_member(ts, g, 0.01, tm.static.land_mask)
                                   for g in gens])
    ens, _ = TE.make_ensemble_chunk_fn(tm, 12)(ens)
    worst = [max(member_errors(single, TE.member_state(ens, m)).items(), key=lambda kv: kv[1])
             for m in range(3)]
    assert worst[0][1] <= ENSEMBLE_F32_REL, worst[0]
    assert all(e > ENSEMBLE_F32_REL for _, e in worst[1:]), worst
