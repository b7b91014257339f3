"""The five CUDA kernels against their plain PyTorch versions on the card,
and their batched forms (an ensemble's members in one launch) against single
calls, and each kernel's backward (the plain version's VJP) through its
``autograd.Function``. K1's fields, K2's cases, K4's operands, the batched
forms' inputs and the gradients' cases are those ``chip_smoke.py`` holds
them to.

Marked ``gpu``: without a CUDA device every test skips. The file imports no
JAX, so on a machine with a card and without JAX it runs alone with
``python -m pytest --noconftest tests/test_torch_kernels.py``.
"""

import math
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from chip_smoke import (GRAD_TOL, GRADCHECK_NONDET, GRADCHECK_SHAPE, SHAREABLE, wrap_cols,
                        batched_equal, batched_pairs, grad_cases, k1_cases, k2_check,
                        k4_operands, k5_operands)
from qingdai_tpu_torch import constants as const
from qingdai_tpu_torch import kernels, ocean
from qingdai_tpu_torch.ecology import phyto
from qingdai_tpu_torch.grid import make_grid
from qingdai_tpu_torch.kernels import (advect_bilinear, hyper4, median_pos, ocean_substeps,
                                       phyto_transport)
from qingdai_tpu_torch.ops import advect, reductions, stencil

pytestmark = pytest.mark.gpu

H, W = 181, 360
A = const.PLANET_RADIUS
DTYPES = [torch.float32, torch.float64]


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _on(dev, x, dtype):
    return torch.as_tensor(np.asarray(x)).to(device=dev, dtype=dtype)


K1_CASES = ["random", "precip", "odd", "even", "ties", "fallback", "neg_zero", "denormal",
            "one_pos", "two_pos", "inf_nan", "inf_median", "one_binade", "all_pos"]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("case", K1_CASES)
def test_median_kernel_bit_equal(dev, dtype, case):
    x = k1_cases(np.random.default_rng(1), dtype)[case]
    xt = _on(dev, x, dtype)
    before = kernels.launch_counts()["median_pos"]
    got = reductions.masked_median_of_positive(xt, 1e-6)
    assert kernels.launch_counts()["median_pos"] == before + 1
    ref = reductions.masked_median_of_positive_ref(xt, 1e-6)
    assert got.shape == () and got.device.type == "cuda"
    assert torch.equal(got, ref), (float(got), float(ref))


@pytest.mark.parametrize("dtype", DTYPES)
def test_median_kernel_unstaged_field(dev, dtype):
    """721×1440: an eighth of the field exceeds K1's shared-memory stage, so
    every pass re-reads it from device memory."""
    r = np.random.default_rng(4)
    x = np.where(r.random((721, 1440)) < 0.6, 0.0, np.abs(r.standard_normal((721, 1440))) * 1e-5)
    xt = _on(dev, x, dtype)
    got = median_pos.median_pos_cuda(xt, 1e-6)
    assert torch.equal(got, reductions.masked_median_of_positive_ref(xt, 1e-6))


def test_median_kernel_trace(dev):
    """A traced launch stamps every stage boundary in order."""
    r = np.random.default_rng(5)
    xt = _on(dev, np.where(r.random((H, W)) < 0.6, 0.0, np.abs(r.standard_normal((H, W)))),
             torch.float32)
    trace = torch.zeros((2, median_pos.trace_slots(torch.float32)), dtype=torch.int64,
                        device=dev)
    got = median_pos.median_pos_cuda(xt, 1e-6, trace=trace)
    assert torch.equal(got, reductions.masked_median_of_positive_ref(xt, 1e-6))
    t = trace.cpu().numpy()
    assert (t > 0).all() and (np.diff(t, axis=1) >= 0).all()


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("M,case", [(1, "winds"), (2, "winds"), (11, "winds"), (2, "poles"),
                                    (1, "far")])
def test_advect_kernel_matches_plain(dev, dtype, M, case):
    """K2's departure points bit-equal to departure_indices and the stack
    within f32 1e-6 / f64 1e-12 of max|F| of the plain version (k2_check)."""
    tol = 1e-6 if dtype == torch.float32 else 1e-12
    _, dj = k2_check(dev, dtype, M, case, np.random.default_rng(2), tol)
    if case == "winds":
        assert float(dj.min()) < 0.0                  # wraps across the south pole


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("case", ["winds", "poles"])
@pytest.mark.parametrize("shape", [(361, 720), (721, 1440)])
def test_advect_kernel_grids(dev, dtype, case, shape):
    """K2's departure points bit-equal to departure_indices on the staged
    chain's grids too: at 361×720 the float32 reciprocal of dlon rounded
    from float differs by an ulp from PyTorch's (taken in double), which
    moved pole-row departures by a cell."""
    tol = 1e-6 if dtype == torch.float32 else 1e-12
    k2_check(dev, dtype, 2, case, np.random.default_rng(3), tol, shape=shape)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("M,nsub,cap", [(5, 1, 0.2), (3, 1, 0.5), (3, 2, 0.5)])
def test_hyper4_kernel_matches_plain(dev, dtype, M, nsub, cap):
    r = np.random.default_rng(3)
    g = make_grid(H, W, device=dev, dtype=dtype)
    F = _on(dev, 50.0 * r.standard_normal((M, H, W)), dtype)
    k4 = (0.02 * g.k4_map_unit / 300.0)[None] * _on(dev, r.uniform(0.25, 1.0, (M, 1, 1)), dtype)
    cos = torch.clamp(g.coslat, min=cap)
    got = stencil.hyperdiffuse_multi(F, k4, 300.0, nsub, g.dlat_rad, g.dlon_rad, cos, A)
    ref = stencil.hyperdiffuse_multi_ref(F, k4, 300.0, nsub, g.dlat_rad, g.dlon_rad, cos, A)
    dF = float((ref - F).abs().max())
    tol = 1e-5 if dtype == torch.float32 else 1e-11
    assert float((got - ref).abs().max()) <= tol * dF


# grids that do not divide into the kernels' tiles (K3 32×32; K4 30 columns
# and 16 or 17 rows), and one whose H is smaller than a tile
GRIDS = [(19, 36), (181, 360), (721, 1440), (11, 40)]


def edge_loud(x, factor):
    """x with rows 0, 1, H−2, H−1 and the columns at the seam scaled by
    ``factor``: the tiles' clipped rows and wrapped columns."""
    x = x.clone()
    h, w = x.shape[-2:]
    for j in (0, 1, h - 2, h - 1):
        x[..., j, :] *= factor
    for i in (0, 1, w - 2, w - 1):
        x[..., :, i] *= factor
    return x


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("nsub", [1, 2])
@pytest.mark.parametrize("shape", GRIDS)
def test_hyper4_kernel_grids(dev, dtype, nsub, shape):
    """K3 within f32 1e-5 / f64 1e-11 of max|ΔF| on grids that are not whole
    tiles, with large values on the edge rows and the seam columns."""
    h, w = shape
    r = np.random.default_rng(6)
    g = make_grid(h, w, device=dev, dtype=dtype)
    F = edge_loud(_on(dev, 50.0 * r.standard_normal((3, h, w)), dtype), 40.0)
    k4 = ((0.02 * g.k4_map_unit / 300.0)[None]
          * _on(dev, r.uniform(0.25, 1.0, (3, 1, 1)), dtype)).contiguous()
    cos = torch.clamp(g.coslat, min=0.5)
    before = kernels.launch_counts()["hyper4"]
    got = stencil.hyperdiffuse_multi(F, k4, 300.0, nsub, g.dlat_rad, g.dlon_rad, cos, A)
    assert kernels.launch_counts()["hyper4"] == before + 1
    ref = stencil.hyperdiffuse_multi_ref(F, k4, 300.0, nsub, g.dlat_rad, g.dlon_rad, cos, A)
    dF = float((ref - F).abs().max())
    tol = 1e-5 if dtype == torch.float32 else 1e-11
    assert float((got - ref).abs().max()) <= tol * dF


def test_wrappers_refuse_bad_input(dev):
    x = torch.ones((H, W), device=dev)
    with pytest.raises(ValueError):
        median_pos.median_pos_cuda(x.cpu())
    with pytest.raises(TypeError):
        median_pos.median_pos_cuda(x.half())
    with pytest.raises(ValueError):
        advect_bilinear.advect_bilinear_cuda(x[None], x[:, :-1].contiguous(), x, 300.0, A,
                                             0.1, 0.1, x)
    with pytest.raises(TypeError):
        advect_bilinear.advect_bilinear_cuda(x[None], x, x, torch.tensor(300.0), A, 0.1, 0.1, x)
    with pytest.raises(ValueError):
        hyper4.hyperdiffuse_cuda(x[None], x[None][:, :, ::2], 300.0, 1, 0.1, 0.1,
                                         x, 1.0)
    assert math.isfinite(float(reductions.masked_median_of_positive(x)))
    with pytest.raises(ValueError):
        mom, st, forc, geo, params = k4_operands(dev, torch.float32, 0, 1, 1, 0.0)
        ocean.ocean_substeps(mom, st, forc, geo[:11], **params)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n_tracers,n_sub,k4_nsub,K_h", [
    (10, 1, 1, 5.0e3), (0, 1, 2, 5.0e3), (0, 2, 1, 0.0), (10, 1, 2, 0.0)])
def test_ocean_substeps_kernel_matches_plain(dev, dtype, n_tracers, n_sub, k4_nsub, K_h):
    """Each output plane within tol · max|plane|: f32 1e-4, f64 1e-12.

    The departure coordinates are numbers up to W = 360 whose f32 ulp is
    3e-5 of a cell, so one ulp of difference in a departure point (from one
    ulp of u) moves an interpolated value by up to 3e-5 of the largest
    neighbour difference, which for the random tracers in [0, 1] is ~1;
    1e-4 allows a few ulps. The kernel's η mean also adds its block sums in
    another order than torch.sum."""
    mom, st, forc, geo, params = k4_operands(dev, dtype, n_tracers, n_sub, k4_nsub, K_h)
    before = kernels.launch_counts()["ocean_substeps"]
    got = ocean.ocean_substeps(mom, st, forc, geo, **params)
    assert kernels.launch_counts()["ocean_substeps"] == before + 1
    ref = ocean.ocean_substeps_plain(mom, st, forc, geo, **params)
    tol = 1e-4 if dtype == torch.float32 else 1e-12
    for g_, r_ in zip(got, ref):
        assert g_.shape == r_.shape
        for k in range(r_.shape[0]):
            scale = float(r_[k].abs().max())
            assert float((g_[k] - r_[k]).abs().max()) <= tol * scale, k


def k4_check(got, ref, dtype):
    """Each output plane within f32 1e-4 / f64 1e-12 of max|plane|."""
    tol = 1e-4 if dtype == torch.float32 else 1e-12
    for g_, r_ in zip(got, ref):
        assert g_.shape == r_.shape
        for k in range(r_.shape[0]):
            scale = float(r_[k].abs().max())
            assert float((g_[k] - r_[k]).abs().max()) <= tol * scale, k


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n_sub,k4_nsub", [(1, 1), (2, 2)])
@pytest.mark.parametrize("shape", GRIDS)
def test_ocean_substeps_kernel_grids(dev, dtype, n_sub, k4_nsub, shape):
    """K4 on grids that are not whole tiles, n_sub and k4_nsub 1 and 2 (the
    halo grows with both), with large η, SST and tracer values on the edge
    rows and the seam columns; the tolerances of the main-path test."""
    mom, st, forc, geo, params = k4_operands(dev, dtype, 3, n_sub, k4_nsub, 5.0e3, shape=shape)
    mom = torch.cat([mom[:2], edge_loud(mom[2:], 6.0)])
    st = edge_loud(st - 280.0, 4.0) + 280.0
    got = ocean.ocean_substeps(mom, st, forc, geo, **params)
    k4_check(got, ocean.ocean_substeps_plain(mom, st, forc, geo, **params), dtype)


def test_ocean_substeps_kernel_deterministic(dev):
    """Two runs give the same bits: the η mean adds the per-tile partial sums
    in one fixed order."""
    for n_sub in (1, 2):
        mom, st, forc, geo, params = k4_operands(dev, torch.float32, 10, n_sub, 1, 5.0e3)
        a_ = ocean.ocean_substeps(mom, st, forc, geo, **params)
        b_ = ocean.ocean_substeps(mom, st, forc, geo, **params)
        assert all(torch.equal(x, y) for x, y in zip(a_, b_))


def test_ocean_substeps_kernel_trace(dev):
    """A traced launch stamps every stage boundary in order and computes the
    same bits."""
    mom, st, forc, geo, params = k4_operands(dev, torch.float32, 10, 1, 1, 5.0e3)
    trace = torch.zeros((2, ocean_substeps.TRACE_SLOTS), dtype=torch.int64, device=dev)
    got = ocean_substeps.ocean_substeps_cuda(mom, st, forc, geo, **params, trace=trace)
    ref = ocean_substeps.ocean_substeps_cuda(mom, st, forc, geo, **params)
    assert all(torch.equal(x, y) for x, y in zip(got, ref))
    t = trace.cpu().numpy()
    assert (t > 0).all() and (np.diff(t[0]) >= 0).all()


def test_kernels_replay_in_a_cuda_graph(dev):
    """One call of K3, of K4 and of K5 (single and batched) captured in a
    CUDA graph replays to the bits of an eager call."""
    mom, st, forc, geo, params = k4_operands(dev, torch.float32, 10, 1, 1, 5.0e3)
    g = make_grid(H, W, device=dev, dtype=torch.float32)
    F = _on(dev, 30.0 * np.random.default_rng(3).standard_normal((5, H, W)), torch.float32)
    k4 = (0.02 * g.k4_map_unit / 300.0)[None].expand(5, H, W).contiguous()
    k5, k5_sc = k5_operands(dev, torch.float32)
    k5b, _ = k5_operands(dev, torch.float32, B=3, seed=6)

    def calls():
        return (hyper4.hyperdiffuse_cuda(F, k4, 300.0, 1, g.dlat_rad, g.dlon_rad,
                                         g.coslat_cap_02, A),
                *ocean_substeps.ocean_substeps_cuda(mom, st, forc, geo, **params),
                phyto_transport.phyto_transport_cuda(*k5, *k5_sc),
                phyto_transport.phyto_transport_batched_cuda(*k5b, *k5_sc, 3))

    eager = calls()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = calls()
    graph.replay()
    torch.cuda.synchronize()
    assert all(torch.equal(x, y) for x, y in zip(captured, eager))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("B", [1, 3, 8])
@pytest.mark.parametrize("shared", [(), SHAREABLE], ids=["own", "shared"])
def test_batched_forms_equal_single_calls(dev, dtype, B, shared):
    """Each batched form at the main path's shapes equals B single calls bit
    for bit, in one launch of its own (K3 and K4 two substeps); with
    ``shared`` the inputs a member may share are given once, unbatched."""
    pairs = batched_pairs(dev, dtype, B, shared)
    before = kernels.launch_counts()
    batched_equal(pairs, f"{dtype} B={B}")
    after = kernels.launch_counts()
    for name in pairs:
        assert after[name + "_batched"] == before[name + "_batched"] + 1, name
        assert after[name] == before[name] + B, name


def test_vmap_reaches_the_batched_forms(dev):
    """Under torch.func.vmap each op launches its kernel's batched form once
    for all members, and no single form."""
    r = np.random.default_rng(8)
    g = make_grid(H, W, device=dev, dtype=torch.float32)
    x = _on(dev, np.abs(r.standard_normal((4, H, W))), torch.float32)
    F = _on(dev, r.standard_normal((4, 5, H, W)), torch.float32)
    k4 = (0.02 * g.k4_map_unit / 300.0)[None].expand(5, H, W)
    calls = {
        "median_pos": lambda: torch.func.vmap(reductions.masked_median_of_positive)(x),
        "advect_bilinear": lambda: torch.func.vmap(
            lambda f, u: advect.advect_semilag_multi(f, u, u, 300.0, A, g.dlat_rad, g.dlon_rad,
                                                     g.coslat_cap_tiny))(F[:, :2], 50.0 * x),
        "hyper4": lambda: torch.func.vmap(
            lambda f: stencil.hyperdiffuse_multi(f, k4, 300.0, 1, g.dlat_rad, g.dlon_rad,
                                                 g.coslat_cap_02, A))(F),
    }
    for name, call in calls.items():
        before = kernels.launch_counts()
        call()
        after = kernels.launch_counts()
        assert {k: after[k] - before[k] for k in after if after[k] != before[k]} == {
            name + "_batched": 1}, name


def test_batched_wrappers_refuse_bad_input(dev):
    x = torch.ones((3, H, W), device=dev)
    with pytest.raises(ValueError):
        median_pos.median_pos_batched_cuda(x, 4)                 # 3 members, not 4
    with pytest.raises(ValueError):
        median_pos.median_pos_batched_cuda(x, 0)
    with pytest.raises(ValueError):
        advect_bilinear.advect_bilinear_batched_cuda(x[:, None], x[:, :, :-1].contiguous(), x,
                                                     300.0, A, 0.1, 0.1, x[0], 3)
    with pytest.raises(ValueError):
        hyper4.hyperdiffuse_batched_cuda(x[:, None], x[:, None, ::2], 300.0, 1, 0.1, 0.1,
                                         x[0], 1.0, 3)
    # a single call differentiates (its backward is the plain version's VJP);
    # a batched one has no backward and refuses an input that requires grad
    with pytest.raises(RuntimeError, match="no backward"):
        torch.func.vmap(reductions.masked_median_of_positive)(x.clone().requires_grad_())


KERNEL_NAMES = ["median_pos", "advect_bilinear", "hyper4", "ocean_substeps"]


@pytest.mark.parametrize("name", KERNEL_NAMES)
def test_backward_gradcheck(dev, name):
    """Each Function's gradient against finite differences of the kernel's
    forward (float64, 19×36, every input, relative perturbations; K4 two
    substeps)."""
    fn, _, ms, _ = grad_cases(dev, torch.float64, GRADCHECK_SHAPE)[name]
    assert torch.autograd.gradcheck(fn, [m.requires_grad_(True) for m in ms],
                                    nondet_tol=GRADCHECK_NONDET)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("name", KERNEL_NAMES)
def test_backward_equals_plain_vjp(dev, dtype, name):
    """At the main path's shapes the forward launches the kernel once and
    the Function's VJP equals the plain version's, every input, within
    ``GRAD_TOL`` of each gradient's largest |value|."""
    fn, plain, xs, _ = grad_cases(dev, dtype)[name]
    ins = [x.clone().requires_grad_(True) for x in xs]
    before = kernels.launch_counts()[name]
    outs = fn(*ins)
    outs = outs if isinstance(outs, tuple) else (outs,)
    assert kernels.launch_counts()[name] == before + 1
    r = np.random.default_rng(71)
    cts = [_on(dev, r.standard_normal(tuple(o.shape)), dtype) for o in outs]
    got = torch.autograd.grad(outs, ins, cts)
    ref = plain(*ins)
    ref = torch.autograd.grad(ref if isinstance(ref, tuple) else (ref,), ins, cts)
    assert kernels.launch_counts()[name] == before + 1      # the backward launched none
    for g, rg in zip(got, ref):
        assert float((g - rg).abs().max()) <= GRAD_TOL[dtype] * float(rg.abs().max())


@pytest.mark.parametrize("name", KERNEL_NAMES)
def test_batched_form_refuses_grad(dev, name):
    """The batched forms have no backward: a vmapped input that requires
    grad raises."""
    fn, _, xs, _ = grad_cases(dev, torch.float32, GRADCHECK_SHAPE)[name]
    batched = [torch.stack([x, x]) for x in xs]
    batched[0].requires_grad_(True)
    with pytest.raises(RuntimeError, match="batched kernel has no backward"):
        torch.func.vmap(fn, randomness="error")(*batched)


# ---- the sharded forms of K2 and K4 (a rank of the longitude mesh), each
# rank's inputs made here in one process as the halo exchange and the
# gather make them ----

@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("case", ["winds", "poles"])
def test_advect_sharded_form_matches_whole_grid(dev, dtype, n, case):
    """Every rank's columns of K2's sharded form bit-equal to the whole
    grid's K2 and to its plain version with the column offset."""
    M = 2
    r = np.random.default_rng(11)
    g = make_grid(H, W, device=dev, dtype=dtype)
    F = _on(dev, 280.0 + 20.0 * r.standard_normal((M, H, W)), dtype)
    u = np.clip(40.0 * r.standard_normal((H, W)), -200, 200)
    if case == "poles":
        u[[0, -1]] = r.choice([-1.0, 1.0], (2, W)) * r.uniform(150.0, 200.0, (2, W))
    u, v = _on(dev, u, dtype), _on(dev, np.clip(30.0 * r.standard_normal((H, W)), -200, 200),
                                   dtype)
    sc = (300.0, A, g.dlat_rad, g.dlon_rad)
    whole = advect_bilinear.advect_bilinear_cuda(F, u, v, *sc, g.coslat_cap_tiny)
    w = W // n
    for rank in range(n):
        lon0 = rank * w
        us, vs, cs = (x[:, lon0:lon0 + w].contiguous() for x in (u, v, g.coslat_cap_tiny))
        before = kernels.launch_counts()["advect_bilinear_sharded"]
        got = advect_bilinear.advect_bilinear_sharded_cuda(F, us, vs, *sc, cs, lon0)
        assert kernels.launch_counts()["advect_bilinear_sharded"] == before + 1
        assert torch.equal(got, whole[..., lon0:lon0 + w])
        assert torch.equal(got, advect.advect_semilag_multi_ref(F, us, vs, *sc, cs, lon0))


def _k4_sharded(mom, st, forc, geo, params, n):
    """Every rank's call of K4's sharded form, their η sums added across
    the ranks as ``all_reduce_sum`` adds them: a first pass records each
    rank's sums, the second finishes with their total."""
    hc = ocean_substeps.halo(params["k4_nsub"])[1]
    w = W // n
    sums = []

    def calls(reduce):
        outs = []
        for rank in range(n):
            lon0 = rank * w
            mp, fp, gp = (wrap_cols(x, lon0, w, hc) for x in (mom, forc, geo))
            outs.append(ocean_substeps.ocean_substep_sharded_cuda(
                mp, st, fp, gp, pad=hc, lon0=lon0, reduce_sums=reduce, **params))
        return outs

    calls(lambda s: sums.append(s) or s)
    total = torch.stack(sums).sum(0)
    outs = calls(lambda s: total)
    return tuple(torch.cat([o[i] for o in outs], dim=-1) for i in range(2))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("n_tracers,k4_nsub,K_h", [(10, 1, 5.0e3), (0, 2, 0.0)])
def test_ocean_substep_sharded_form_matches_whole_grid(dev, dtype, n, n_tracers, k4_nsub, K_h):
    """The ranks' columns of K4's sharded form, one substep, against the
    whole grid's K4 and its plain version: each plane within the main-path
    test's tolerances (the η mean's order of summation); the SST and the
    tracers bit-equal to the whole grid's K4."""
    mom, st, forc, geo, params = k4_operands(dev, dtype, n_tracers, 1, k4_nsub, K_h)
    before = kernels.launch_counts()["ocean_substeps_sharded"]
    got = _k4_sharded(mom, st, forc, geo, params, n)
    # two passes over the n ranks, each call the tile pass and the finish
    assert kernels.launch_counts()["ocean_substeps_sharded"] == before + 2 * n * 2
    whole = ocean.ocean_substeps(mom, st, forc, geo, **params)
    k4_check(got, whole, dtype)
    k4_check(got, ocean.ocean_substeps_plain(mom, st, forc, geo, **params), dtype)
    assert torch.equal(got[1], whole[1])
    assert torch.equal(got[0][:2], whole[0][:2])


def test_sharded_wrappers_refuse_bad_input(dev):
    mom, st, forc, geo, params = k4_operands(dev, torch.float32, 0, 1, 1, 0.0)
    hc = ocean_substeps.halo(1)[1]
    mp, fp, gp = (wrap_cols(x, 0, W // 2, hc - 1) for x in (mom, forc, geo))
    with pytest.raises(ValueError):   # a halo narrower than the kernel reads
        ocean_substeps.ocean_substep_sharded_cuda(mp, st, fp, gp, pad=hc - 1, lon0=0,
                                                  reduce_sums=lambda s: s, **params)
    with pytest.raises(ValueError):   # one substep a call
        ocean_substeps.ocean_substep_sharded_cuda(mp, st, fp, gp, pad=hc - 1, lon0=0,
                                                  reduce_sums=lambda s: s,
                                                  **dict(params, n_sub=2))
    g = make_grid(H, W, device=dev, dtype=torch.float32)
    F = torch.zeros((2, H, W), device=dev)
    u = torch.zeros((H, W // 2), device=dev)
    with pytest.raises(ValueError):   # columns beyond the stack
        advect_bilinear.advect_bilinear_sharded_cuda(F, u, u, 300.0, A, g.dlat_rad, g.dlon_rad,
                                                     u, W // 2 + 1)


# ---- K5, the chlorophyll transport (replaces no TPU kernel) ----

def bit_equal(a, b) -> bool:
    """The same dtype, shape and bits, NaNs included."""
    ints = {torch.float32: torch.int32, torch.float64: torch.int64}
    return (a.dtype == b.dtype and a.shape == b.shape
            and torch.equal(a.view(ints[a.dtype]), b.view(ints[b.dtype])))


def k5_plain_vmap(ops, sc, shared_adv=False):
    """The plain version under torch.func.vmap, as the CPU runs the ensemble."""
    return torch.func.vmap(phyto.phyto_transport_plain,
                           in_dims=(0, None if shared_adv else 0) + (None,) * 8)(*ops, *sc)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("K_h", [5.0e3, 0.0])
@pytest.mark.parametrize("shape,case", [((181, 360), "land"), ((181, 360), "planted"),
                                        ((19, 37), "planted"), ((20, 1030), "planted"),
                                        ((721, 1440), "land")],
                         ids=["181x360-land", "181x360-planted", "19x37-planted",
                              "20x1030-planted", "721x1440-land"])
def test_phyto_transport_kernel_bit_equal(dev, dtype, K_h, shape, case):
    """K5 through its Function, one launch, equals the plain version on the
    card bit for bit: the 16-byte path (W a multiple of 4) and the per-column
    paths (odd W; W above 512), NaN and ±inf planted, or both stacks zero
    over land as the model's are (the ∇²'s zero terms skip the division),
    the north pole row without ocean (its ring mean left out), with and
    without diffusion."""
    plant = case == "planted"
    ops, sc = k5_operands(dev, dtype, shape, plant=plant, dry_pole=True, K_h=K_h,
                          land_zero=case == "land")
    before = kernels.launch_counts()["phyto_transport"]
    got = phyto.PhytoTransport.apply(*ops, *sc)
    assert kernels.launch_counts()["phyto_transport"] == before + 1
    ref = phyto.phyto_transport_plain(*ops, *sc)
    assert bit_equal(got, ref)
    if plant:
        assert not torch.isfinite(ref).all()      # the planted values reach the output
    assert torch.equal(got[:, -1], torch.where(ops[2][-1], got[:, -1], 0.0))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("adv", ["own", "shared", "sliced"])
@pytest.mark.parametrize("shape", [(181, 360), (19, 37)])
def test_phyto_transport_batched_equals_single_calls(dev, dtype, adv, shape):
    """The batched form for 3 members in one launch: each member equals its
    single call and the plain version under vmap bit for bit; C_adv is each
    member's own, one stack for every member (stride 0), or the tracer
    planes of a larger [B, 11, H, W] stack, read in place at its member
    stride, as K4's output is."""
    B = 3
    shared_adv = adv == "shared"
    ops, sc = k5_operands(dev, dtype, shape, B=B, seed=9, plant=True, shared_adv=shared_adv)
    if adv == "sliced":
        big = torch.cat([torch.zeros_like(ops[1][:, :1]), ops[1]], dim=1)
        ops = (ops[0], big[:, 1:], *ops[2:])
        assert not ops[1].is_contiguous() and ops[1][0].is_contiguous()
    before = kernels.launch_counts()
    got = phyto_transport.phyto_transport_batched_cuda(*ops, *sc, B)
    after = kernels.launch_counts()
    assert after["phyto_transport_batched"] == before["phyto_transport_batched"] + 1
    assert bit_equal(got, k5_plain_vmap(ops, sc, shared_adv))
    Cp, Ca, ocean_, cos = ops
    for b in range(B):
        one = phyto_transport.phyto_transport_cuda(Cp[b], Ca if shared_adv else Ca[b], ocean_,
                                                   cos, *sc)
        assert bit_equal(got[b], one), b


def test_phyto_transport_vmap_reaches_the_batched_form(dev):
    """``phyto_apply_transport`` under torch.func.vmap launches the batched
    form once for every member and no single form, and copies no stack (C_adv
    a slice, as K4 gives it); the members equal the plain version's under
    vmap."""
    (Cp, Ca, ocean_, _), sc = k5_operands(dev, torch.float32, B=4, seed=10)
    Ca = torch.cat([Ca[:, :1], Ca], dim=1)[:, 1:]        # K4's tracer planes: a slice
    g = make_grid(H, W, device=dev, dtype=torch.float32)
    ps, cfg = SimpleNamespace(ocean=ocean_), SimpleNamespace(adv_alpha=sc[0], K_h=sc[1])

    def step(C_phyto, C_adv):
        st = phyto.PhytoState(C_phyto=C_phyto, N=C_phyto[0], alpha_bands=C_phyto[:1],
                              alpha_scalar=C_phyto[0], Kd_490=C_phyto[0])
        return phyto.phyto_apply_transport(ps, st, cfg, g, C_adv, sc[2]).C_phyto

    before = kernels.launch_counts()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        got = torch.func.vmap(step)(Cp, Ca)
    after = kernels.launch_counts()
    assert {k: after[k] - before[k] for k in after if after[k] != before[k]} == {
        "phyto_transport_batched": 1}
    assert not [e.name for e in prof.events() if e.name in ("aten::copy_", "aten::clone")]
    assert bit_equal(got, k5_plain_vmap((Cp, Ca, ocean_, g.coslat_cap_05), sc))


@pytest.mark.parametrize("dtype", DTYPES)
def test_phyto_transport_backward_equals_plain_vjp(dev, dtype):
    """The Function's VJP is the plain version's (``plain_vjp``): with
    respect to C_phyto, C_adv and the cos map, the same numbers, and the
    backward launches nothing; the batched form refuses an input that
    requires grad."""
    ops, sc = k5_operands(dev, dtype, seed=11)
    ins = [t.clone().requires_grad_(True) if t.is_floating_point() else t for t in ops]
    before = kernels.launch_counts()["phyto_transport"]
    out = phyto.PhytoTransport.apply(*ins, *sc)
    ct = torch.randn(out.shape, generator=torch.Generator(device=dev).manual_seed(12),
                     device=dev, dtype=torch.float64).to(dtype)
    wrt = [ins[0], ins[1], ins[3]]
    got = torch.autograd.grad(out, wrt, ct)
    ref = torch.autograd.grad(phyto.phyto_transport_plain(*ins, *sc), wrt, ct)
    assert kernels.launch_counts()["phyto_transport"] == before + 1
    for x, y in zip(got, ref):
        assert torch.equal(x, y)
    batched = [torch.stack([t, t]) for t in ops]
    batched[0].requires_grad_(True)
    with pytest.raises(RuntimeError, match="batched kernel has no backward"):
        torch.func.vmap(lambda *t: phyto.PhytoTransport.apply(*t, *sc))(*batched)


def test_phyto_transport_wrappers_refuse_bad_input(dev):
    (Cp, Ca, ocean_, cos), sc = k5_operands(dev, torch.float32, (19, 37), B=2)
    with pytest.raises(ValueError):
        phyto_transport.phyto_transport_batched_cuda(Cp, Ca, ocean_, cos, *sc, 3)  # 2, not 3
    with pytest.raises(ValueError):
        phyto_transport.phyto_transport_cuda(Cp[0], Ca[0][:, :, ::2], ocean_, cos, *sc)
    with pytest.raises(TypeError):
        phyto_transport.phyto_transport_cuda(Cp[0], Ca[0], ocean_.float(), cos, *sc)
    with pytest.raises(ValueError):
        phyto_transport.phyto_transport_cuda(Cp[0, :, :2], Ca[0, :, :2], ocean_[:2], cos[:2],
                                             *sc)
