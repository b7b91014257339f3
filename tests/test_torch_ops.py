"""Parity of the PyTorch port's operators with the JAX package, on the CPU.

Inputs are made from a seed with NumPy and fed to both packages; float64
unless a case says otherwise. The plain versions of the three CUDA kernels
(K1 median of positives, K2 bilinear advection, K3 ∇⁴ chain) are held against
the JAX functions, including the Pallas kernels in interpret mode.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qingdai_tpu import constants as const
from qingdai_tpu import grid as jgrid
from qingdai_tpu.ops import advect as jadv
from qingdai_tpu.ops import reductions as jred
from qingdai_tpu.ops import smooth as jsmooth
from qingdai_tpu.ops import stencil as jst
from qingdai_tpu.ops.pallas_advect import advect_windowed_pallas
from qingdai_tpu.ops.pallas_stencil import hyperdiffuse_pallas
from chip_smoke import k1_cases
from qingdai_tpu_torch import grid as tgrid
from qingdai_tpu_torch.ops import advect as tadv
from qingdai_tpu_torch.ops import reductions as tred
from qingdai_tpu_torch.ops import smooth as tsmooth
from qingdai_tpu_torch.ops import stencil as tst

torch.set_num_threads(1)

A = const.PLANET_RADIUS
H, W = 19, 36


def t64(x):
    return torch.as_tensor(np.array(x, np.float64))


def close(got, ref, rel):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    ref = np.asarray(ref)
    scale = max(float(np.max(np.abs(ref))), 1e-300)
    assert got.shape == ref.shape
    assert np.max(np.abs(got - ref)) <= rel * scale, np.max(np.abs(got - ref)) / scale


@pytest.fixture(scope="module")
def grids():
    return (jgrid.make_grid(H, W, dtype=jnp.float64),
            tgrid.make_grid(H, W, device="cpu", dtype=torch.float64))


def _winds(rng, shape, scale=80.0):
    u = np.clip(scale * rng.standard_normal(shape), -200, 200)
    v = np.clip(scale * rng.standard_normal(shape), -200, 200)
    return u, v


# ---------------------------------------------------------------- K1 median

def _median_case(name, rng):
    x = rng.standard_normal((H, W))
    if name == "fallback":
        x = -np.abs(x)
        x[0, :3] = 0.0
    elif name == "odd":
        x = np.abs(x) + 0.1
        x[0, 0] = -1.0                       # H·W − 1 positives
    elif name == "even":
        x = np.abs(x) + 0.1
    elif name == "ties":
        x = rng.integers(-2, 4, (H, W)).astype(np.float64)
    elif name == "precip":                   # more than half zeros
        x = np.where(rng.random((H, W)) < 0.6, 0.0, np.abs(x) * 1e-5)
    return x


@pytest.mark.parametrize("case", ["fallback", "odd", "even", "ties", "precip"])
def test_median_ref_matches_jax(case, rng):
    x = _median_case(case, rng)
    got = tred.masked_median_of_positive_ref(t64(x), fallback=1e-6)
    sort = jred.masked_median_of_positive_sort(jnp.asarray(x), fallback=1e-6)
    bisect = jred.masked_median_of_positive(jnp.asarray(x), 1e-6)
    assert float(got) == float(sort)                        # exact
    np.testing.assert_allclose(float(got), float(bisect), rtol=1e-12)
    pos = x[x > 0]
    assert float(got) == (float(np.median(pos)) if pos.size else 1e-6)
    # on a CPU tensor the dispatching function is the plain version
    assert float(tred.masked_median_of_positive(t64(x), 1e-6)) == float(got)


def test_median_ref_nan_and_inf():
    x = np.array([[np.nan, 1.0, 2.0], [np.inf, -np.inf, 0.0]])
    got = tred.masked_median_of_positive_ref(t64(x))
    assert float(got) == float(jred.masked_median_of_positive_sort(jnp.asarray(x))) == 2.0


# ------------------------------------------------------------ K2 advection

def test_bilinear_ref_matches_jax_gather(rng, grids):
    jg, tg = grids
    F = rng.standard_normal((2, H, W))
    u, v = _winds(rng, (H, W))
    dj, di = jadv.departure_indices((H, W), jnp.asarray(u), jnp.asarray(v), 300.0, A,
                                    jg.dlat_rad, jg.dlon_rad, jg.coslat_cap_tiny, jnp.float64)
    ref = jadv.bilinear_wrap_gather_multi(jnp.asarray(F), dj, di)
    got = tadv.bilinear_wrap_gather_multi(t64(F), t64(dj), t64(di))
    close(got, ref, 1e-12)


@pytest.mark.parametrize("M", [1, 2])
def test_advect_semilag_matches_jax_plan(M, rng, grids):
    """The port's all-row gather against the JAX windowed plan with its exact
    polar rows, as the JAX model runs it."""
    jg, tg = grids
    F = 280.0 + 20.0 * rng.standard_normal((M, H, W))
    u, v = _winds(rng, (H, W), 120.0)
    plan = jadv.make_advect_plan(H, jg.dlat_rad, jg.dlon_rad, 300.0, A,
                                 np.asarray(jg.coslat_cap_tiny)[:, 0], vmax=200.0)
    assert plan.exact_rows and 0 in plan.exact_rows and H - 1 in plan.exact_rows
    ref = jadv.advect_semilag_multi(jnp.asarray(F), jnp.asarray(u), jnp.asarray(v), 300.0, A,
                                    jg.dlat_rad, jg.dlon_rad, jg.coslat_cap_tiny, plan=plan)
    got = tadv.advect_semilag_multi(t64(F), t64(u), t64(v), 300.0, A, tg.dlat_rad,
                                    tg.dlon_rad, tg.coslat_cap_tiny)
    close(got, ref, 1e-12)


def test_bilinear_ref_matches_pallas_window_f32():
    rng = np.random.default_rng(7)
    M = 3
    fields = rng.normal(280, 20, (M, H, W)).astype(np.float32)
    u = rng.normal(0, 60, (H, W)).astype(np.float32)
    v = rng.normal(0, 30, (H, W)).astype(np.float32)
    dlat, dlon, dt = math.pi / (H - 1), 2 * math.pi / W, 300.0
    cos = (np.maximum(np.cos(np.linspace(-math.pi / 2, math.pi / 2, H)), 1e-6)[:, None]
           * np.ones((H, W))).astype(np.float32)
    dj, di = tadv.departure_indices((H, W), torch.as_tensor(u), torch.as_tensor(v), dt,
                                    6.371e6, dlat, dlon, torch.as_tensor(cos), torch.float32)
    # interior rows, where the offsets fit the Pallas window
    rows = slice(2, H - 2)
    ms, ks = list(range(-2, 3)), list(range(-4, 6))
    ref = advect_windowed_pallas(jnp.asarray(fields), jnp.asarray(dj.numpy()),
                                 jnp.asarray(di.numpy()), ms, ks, interpret=True)
    got = tadv.bilinear_wrap_gather_multi(torch.as_tensor(fields), dj, di)
    np.testing.assert_allclose(got.numpy()[:, rows], np.asarray(ref)[:, rows],
                               rtol=1e-5, atol=1e-4)


def test_departure_indices_match_jax(rng, grids):
    jg, tg = grids
    u, v = _winds(rng, (H, W))
    ref = jadv.departure_indices((H, W), jnp.asarray(u), jnp.asarray(v), 300.0, A,
                                 jg.dlat_rad, jg.dlon_rad, jg.coslat_cap_tiny, jnp.float64)
    got = tadv.departure_indices((H, W), t64(u), t64(v), 300.0, A, tg.dlat_rad,
                                 tg.dlon_rad, tg.coslat_cap_tiny, torch.float64)
    for g, r in zip(got, ref):
        close(g, r, 1e-14)


# ------------------------------------------------------------- K3 ∇⁴ chain

@pytest.mark.parametrize("nsub", [1, 2])
def test_hyperdiffuse_ref_matches_jax(nsub, rng, grids):
    jg, tg = grids
    M = 5
    F = 50.0 * rng.standard_normal((M, H, W))
    k4 = rng.uniform(0.5, 1.0, (M, 1, 1)) * 0.02 * np.asarray(jg.k4_map_unit)[None] / 300.0
    ref = jst.hyperdiffuse_multi(jnp.asarray(F), jnp.asarray(k4), 300.0, nsub, jg.dlat_rad,
                                 jg.dlon_rad, jg.coslat_cap_02, A)
    got = tst.hyperdiffuse_multi_ref(t64(F), t64(k4), 300.0, nsub, tg.dlat_rad, tg.dlon_rad,
                                     tg.coslat_cap_02, A)
    close(got, ref, 1e-12)
    assert torch.equal(tst.hyperdiffuse_multi(t64(F), t64(k4), 300.0, nsub, tg.dlat_rad,
                                              tg.dlon_rad, tg.coslat_cap_02, A), got)


@pytest.mark.parametrize("nsub", [1, 2])
def test_hyperdiffuse_ref_matches_pallas_f32(nsub):
    rng = np.random.default_rng(3)
    M = 4
    F = rng.normal(0, 50, (M, H, W)).astype(np.float32)
    cos = (np.maximum(np.cos(np.linspace(-math.pi / 2, math.pi / 2, H)), 0.2)[:, None]
           * np.ones((H, W))).astype(np.float32)
    k4 = rng.uniform(1e13, 5e13, (M, 1, 1)).astype(np.float32)
    dlat, dlon, a, dt = math.pi / (H - 1), 2 * math.pi / W, 6.371e6, 300.0
    ref = hyperdiffuse_pallas(jnp.asarray(F), jnp.asarray(k4), dt, nsub, dlat, dlon,
                              jnp.asarray(cos), a, interpret=True)
    got = tst.hyperdiffuse_multi_ref(torch.as_tensor(F), torch.as_tensor(k4), dt, nsub,
                                     dlat, dlon, torch.as_tensor(cos), a)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-4)


# --------------------------------------------------- plain-array operators

def test_grid_metrics_match_jax(grids):
    jg, tg = grids
    for name in ("lat_mesh", "lon_mesh", "coslat", "coslat_cap_tiny", "coslat_cap_02",
                 "coslat_cap_05", "f", "area_w", "cell_area", "k4_map_unit"):
        np.testing.assert_array_equal(getattr(tg, name).numpy(), np.asarray(getattr(jg, name)))
    assert (tg.dlat_rad, tg.dlon_rad) == (jg.dlat_rad, jg.dlon_rad)


@pytest.mark.parametrize("op", ["divergence", "vorticity", "grad_lonlat", "laplacian",
                                "shapiro", "shapiro_multi", "zonal_fft"])
def test_operator_matches_jax(op, rng, grids):
    jg, tg = grids
    X = rng.standard_normal((2, H, W)) * 30.0
    J, T = jnp.asarray(X), t64(X)
    if op == "divergence":
        pairs = [(jgrid.divergence(jg, J[0], J[1]), tgrid.divergence(tg, T[0], T[1]))]
    elif op == "vorticity":
        pairs = [(jgrid.vorticity(jg, J[0], J[1]), tgrid.vorticity(tg, T[0], T[1]))]
    elif op == "grad_lonlat":
        pairs = list(zip(jgrid.grad_lonlat(jg, J[0]), tgrid.grad_lonlat(tg, T[0])))
    elif op == "laplacian":
        pairs = [(jst.laplacian_sphere(J[0], jg.dlat_rad, jg.dlon_rad, jg.coslat_cap_05, A),
                  tst.laplacian_sphere(T[0], tg.dlat_rad, tg.dlon_rad, tg.coslat_cap_05, A))]
    elif op == "shapiro":
        pairs = [(jst.shapiro_filter(J[0], n=n), tst.shapiro_filter(T[0], n=n)) for n in (1, 2)]
    elif op == "shapiro_multi":
        pairs = [(jst.shapiro_filter_multi(J, n=2), tst.shapiro_filter_multi(T, n=2))]
    else:
        pairs = [(jst.spectral_zonal_filter(J[0], W, 0.75, 0.5),
                  tst.spectral_zonal_filter(T[0], W, 0.75, 0.5))]
    for ref, got in pairs:
        close(got, ref, 1e-13)


@pytest.mark.parametrize("mode", ["reflect", "nearest", "wrap"])
def test_gaussian_filter_matches_jax(mode, rng):
    X = rng.standard_normal((H, W))
    for sigma in (0.2, 1.0):
        ref = jsmooth.gaussian_filter(jnp.asarray(X), sigma, mode_lat=mode, mode_lon=mode)
        got = tsmooth.gaussian_filter(t64(X), sigma, mode_lat=mode, mode_lon=mode)
        close(got, ref, 1e-14)


class _Rank:
    """A rank of a longitude mesh of two, as far as the dispatch looks."""
    n, rank = 2, 0


@pytest.mark.parametrize("device,mesh", [("cpu", None), ("cpu", _Rank()), ("card", None),
                                         ("card", _Rank())],
                         ids=["cpu", "cpu-mesh", "card", "card-mesh"])
def test_gaussian_filter_dispatch(monkeypatch, rng, device, mesh):
    """A CPU tensor and a mesh rank (whose lon pass pads with its
    neighbours' columns) take the plain version with the mesh; a card's
    tensor on one rank takes K6's Function (``use_kernel`` stubbed: no card
    here). σ ≤ 0 and a radius of 0 take neither and return the field. On
    the CPU the result is the plain version's."""
    F = t64(rng.standard_normal((H, W)))
    taken = []

    def plain(F, sigma, mode_lat, mode_lon, truncate, mesh):
        taken.append(("plain", (sigma, mode_lat, mode_lon, truncate), mesh))
        return F

    monkeypatch.setattr(tsmooth, "gaussian_filter_plain", plain)
    monkeypatch.setattr(tsmooth.GaussianFilter, "apply",
                        lambda F, *args: taken.append(("kernel", args, None)) or F)
    if device == "card":
        monkeypatch.setattr(tsmooth, "use_kernel", lambda t: True)
    for sigma in (0.0, -1.0, 0.1, None):
        assert tsmooth.gaussian_filter(F, sigma, mesh=mesh) is F
    assert taken == []
    tsmooth.gaussian_filter(F, 0.2, "wrap", "nearest", mesh=mesh)
    path = "kernel" if device == "card" and mesh is None else "plain"
    assert taken == [(path, (0.2, "wrap", "nearest", 4.0), mesh)]
    if device == "cpu" and mesh is None:
        monkeypatch.undo()
        got = tsmooth.gaussian_filter(F, 1.0, "reflect", "wrap")
        assert torch.equal(got, tsmooth.gaussian_filter_plain(F, 1.0, "reflect", "wrap"))
        close(got, jsmooth.gaussian_filter(jnp.asarray(F.numpy()), 1.0, mode_lat="reflect",
                                           mode_lon="wrap"), 1e-14)


def test_area_means_match_oracle(rng, grids):
    """The float64 accumulator meets the bar the JAX float-float sums are
    held to (tests/test_ops.py::test_area_mean_compensated)."""
    jg, tg = grids
    w32 = np.array(jgrid.make_grid(H, W).area_w)            # f32 weights
    x = rng.standard_normal((H, W))

    def oracle(xv, wv, mv=None):
        xl, wl = np.asarray(xv, np.longdouble), np.asarray(wv, np.longdouble)
        if mv is not None:
            wl = wl * mv
        return float((xl * wl).sum() / wl.sum())

    scale = float(np.sum(np.abs(x * w32)) / np.sum(w32))
    got = float(tred.area_mean_compensated(t64(x), torch.as_tensor(w32)))
    assert abs(got - oracle(x, w32)) < 1e-12 * scale
    mask = rng.random((H, W)) > 0.5
    got_m = float(tred.area_mean_compensated(t64(x), torch.as_tensor(w32),
                                             mask=torch.as_tensor(mask)))
    assert abs(got_m - oracle(x, w32, mask)) < 1e-11 * scale
    xf = (1e5 + rng.standard_normal((H, W))).astype(np.float32)
    ref = float((xf.astype(np.float64) * w32).sum() / w32.astype(np.float64).sum())
    got32 = tred.area_mean_compensated(torch.as_tensor(xf), torch.as_tensor(w32))
    assert got32.dtype == torch.float32 and abs(float(got32) - ref) / ref < 1e-6
    close(tred.area_mean(t64(x), tg.area_w, t64(mask)),
          jred.area_mean(jnp.asarray(x), jg.area_w, jnp.asarray(mask)), 1e-14)


def test_dispatch_by_device():
    """CPU tensors take the plain versions; a device with neither a kernel
    nor a plain version raises instead of falling back."""
    from qingdai_tpu_torch.kernels import use_kernel
    assert use_kernel(torch.zeros(1)) is False
    with pytest.raises(ValueError):
        use_kernel(torch.zeros(1, device="meta"))
    with pytest.raises(ValueError):
        tred.masked_median_of_positive(torch.zeros((3, 3), device="meta"))


# ------------------------------------------- K1 and K2 edge cases (CPU)

K1_EDGES = ["neg_zero", "denormal", "one_pos", "two_pos", "inf_nan", "inf_median",
            "one_binade", "all_pos"]


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("case", K1_EDGES)
def test_median_ref_edge_cases_match_jax(case, dtype):
    """The plain median against np.median and JAX's sort on the fields that
    chip_smoke.py holds K1 to. XLA on the CPU flushes denormals to zero, so
    JAX counts a positive denormal as not positive; PyTorch does not (nor
    does K1 on the card, nor np.median): on the denormal case the JAX sort
    is held to the median of the normal positives."""
    npdt = np.dtype(dtype)
    x = k1_cases(np.random.default_rng(11), getattr(torch, dtype), (H, W))[case].astype(npdt)
    got = tred.masked_median_of_positive_ref(torch.as_tensor(x), 1e-6)
    assert got.dtype == getattr(torch, dtype)

    def median(vals):
        return float(np.median(vals)) if vals.size else float(npdt.type(1e-6))

    assert float(got) == median(x[x > 0])
    sort = float(jred.masked_median_of_positive_sort(jnp.asarray(x), fallback=1e-6))
    if case == "denormal":
        assert (x[x > 0] < np.finfo(npdt).tiny).any()
        assert sort == median(x[x >= np.finfo(npdt).tiny])
    else:
        assert sort == float(got)


@pytest.mark.parametrize("M", [1, 2])
def test_advect_semilag_far_pole_departures_match_jax(M, grids):
    """Pole rows at 150–200 m/s over dt = 900 s: under the 1e-6 cos cap the
    departures lie beyond 2^16 cells upwind. The port's CPU path against the
    JAX windowed plan with its exact polar rows."""
    jg, tg = grids
    rng = np.random.default_rng(13)
    dt = 900.0
    F = 280.0 + 20.0 * rng.standard_normal((M, H, W))
    u, v = _winds(rng, (H, W), 120.0)
    u[[0, -1]] = rng.choice([-1.0, 1.0], (2, W)) * rng.uniform(150.0, 200.0, (2, W))
    plan = jadv.make_advect_plan(H, jg.dlat_rad, jg.dlon_rad, dt, A,
                                 np.asarray(jg.coslat_cap_tiny)[:, 0], vmax=200.0)
    ref = jadv.advect_semilag_multi(jnp.asarray(F), jnp.asarray(u), jnp.asarray(v), dt, A,
                                    jg.dlat_rad, jg.dlon_rad, jg.coslat_cap_tiny, plan=plan)
    _, di = tadv.departure_indices((H, W), t64(u), t64(v), dt, A, tg.dlat_rad, tg.dlon_rad,
                                   tg.coslat_cap_tiny, torch.float64)
    reach = (di - torch.arange(W, dtype=torch.float64)).abs()
    assert float(reach[[0, -1]].min()) > 2 ** 16
    got = tadv.advect_semilag_multi(t64(F), t64(u), t64(v), dt, A, tg.dlat_rad,
                                    tg.dlon_rad, tg.coslat_cap_tiny)
    close(got, ref, 1e-12)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("dim", [0, 1])
def test_gather_fixed_backward_is_autograds(dtype, dim):
    """``ops.scatter.gather_fixed``'s gradient equals autograd's
    ``index_select`` backward bit for bit on the CPU (which adds in the
    index's order), with many repeated targets and targets never gathered."""
    from qingdai_tpu_torch.ops.scatter import gather_fixed, index_add_ordered
    g = torch.Generator().manual_seed(5)
    x = torch.randn(40, 30, dtype=dtype, generator=g).requires_grad_(True)
    idx = torch.randint(0, x.shape[dim] - 3, (500,), generator=g)
    shape = list(x.shape)
    shape[dim] = idx.numel()
    ct = torch.randn(shape, dtype=dtype, generator=g)
    want, = torch.autograd.grad(x.index_select(dim, idx), x, ct)
    got, = torch.autograd.grad(gather_fixed(x, dim, idx), x, ct)
    assert torch.equal(gather_fixed(x, dim, idx), x.index_select(dim, idx))
    assert torch.equal(got, want)
    assert int(torch.bincount(idx).max()) > 1
    assert torch.equal(index_add_ordered(x.shape[dim], dim, idx, ct),
                       torch.zeros_like(x).index_add(dim, idx, ct))


def test_k2_plain_gradient_is_autograds():
    """The plain K2's gradient (its corners through ``gather_fixed``) equals
    the gradient of the same interpolation through ``index_select``."""
    r = np.random.default_rng(9)
    F = t64(280.0 + 20.0 * r.standard_normal((2, H, W))).requires_grad_(True)
    dep_j = t64(r.uniform(-5, H + 5, (H, W)))
    dep_i = t64(r.uniform(-5, W + 5, (H, W)))
    ct = t64(r.standard_normal((2, H, W)))
    got, = torch.autograd.grad(tadv.bilinear_wrap_gather_multi(F, dep_j, dep_i), F, ct)

    def by_index_select(f):
        j0 = torch.remainder(torch.floor(dep_j).long(), H)
        i0 = torch.remainder(torch.floor(dep_i).long(), W)
        fj, fi = dep_j - torch.floor(dep_j), dep_i - torch.floor(dep_i)
        flat = f.reshape(2, H * W)

        def corner(j, i):
            return flat.index_select(1, (j * W + i).reshape(-1)).reshape(2, H, W)
        return (corner(j0, i0) * ((1.0 - fj) * (1.0 - fi))
                + corner(j0, (i0 + 1) % W) * ((1.0 - fj) * fi)
                + corner((j0 + 1) % H, i0) * (fj * (1.0 - fi))
                + corner((j0 + 1) % H, (i0 + 1) % W) * (fj * fi))

    want, = torch.autograd.grad(by_index_select(F), F, ct)
    assert torch.equal(by_index_select(F.detach()),
                       tadv.bilinear_wrap_gather_multi(F.detach(), dep_j, dep_i))
    assert torch.equal(got, want)


@pytest.mark.parametrize("n", [1, 2, 7, 36, 45, 360])
def test_sum_fixed_is_one_order(n):
    """``ops.reductions.sum_fixed`` is a sum (to float64 rounding of the
    float32 one) whose bits do not depend on the tensor's other dimensions:
    a member of a batch, vmapped or not, sums as the lone tensor does."""
    from qingdai_tpu_torch.ops.reductions import sum_fixed
    g = torch.Generator().manual_seed(n)
    x = torch.randn(10, n, generator=g)
    got = sum_fixed(x, 1)
    assert got.shape == (10,)
    torch.testing.assert_close(got.double(), x.double().sum(1), rtol=1e-6, atol=1e-6)
    batch = torch.cat([x[None], torch.randn(7, 10, n, generator=g)])
    assert torch.equal(sum_fixed(batch, 2)[0], got)
    assert torch.equal(torch.func.vmap(lambda y: sum_fixed(y, 1))(batch)[0], got)
    assert torch.equal(sum_fixed(x.t(), 0), got)
