"""The four CUDA kernels against their plain PyTorch versions on the card.
K4's operands are those ``chip_smoke.py`` holds it to.

Marked ``gpu``: without a CUDA device every test skips. The file imports no
JAX, so on a machine with a card and without JAX it runs alone with
``python -m pytest --noconftest tests/test_torch_kernels.py``.
"""

import math

import numpy as np
import pytest
import torch

from chip_smoke import k4_operands
from qingdai_tpu_torch import constants as const
from qingdai_tpu_torch import kernels, ocean
from qingdai_tpu_torch.grid import make_grid
from qingdai_tpu_torch.kernels import advect_bilinear, hyper4, median_pos
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


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("case", ["random", "precip", "odd", "ties", "fallback"])
def test_median_kernel_bit_equal(dev, dtype, case):
    r = np.random.default_rng(1)
    x = r.standard_normal((H, W))
    if case == "precip":
        x = np.where(r.random((H, W)) < 0.6, 0.0, np.abs(x) * 1e-5)
    elif case == "odd":
        x = np.abs(x) + 0.1
        x[0, 0] = 0.0
    elif case == "ties":
        x = r.integers(-3, 5, (H, W)).astype(np.float64)
    elif case == "fallback":
        x = -np.abs(x)
    xt = _on(dev, x, dtype)
    before = kernels.launch_counts()["median_pos"]
    got = reductions.masked_median_of_positive(xt, 1e-6)
    assert kernels.launch_counts()["median_pos"] == before + 1
    ref = reductions.masked_median_of_positive_ref(xt, 1e-6)
    assert got.shape == () and got.device.type == "cuda"
    assert torch.equal(got, ref), (float(got), float(ref))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("M", [1, 2])
def test_advect_kernel_matches_plain(dev, dtype, M):
    r = np.random.default_rng(2)
    g = make_grid(H, W, device=dev, dtype=dtype)
    F = _on(dev, 280.0 + 20.0 * r.standard_normal((M, H, W)), dtype)
    u = _on(dev, np.clip(120.0 * r.standard_normal((H, W)), -200, 200), dtype)
    v = _on(dev, np.clip(120.0 * r.standard_normal((H, W)), -200, 200), dtype)
    dj, di = advect.departure_indices((H, W), u, v, 300.0, A, g.dlat_rad, g.dlon_rad,
                                      g.coslat_cap_tiny, dtype)
    assert float(dj.min()) < 0.0                      # wraps across the south pole
    got = advect.advect_semilag_multi(F, u, v, 300.0, A, g.dlat_rad, g.dlon_rad,
                                      g.coslat_cap_tiny)
    ref = advect.bilinear_wrap_gather_multi(F, dj, di)
    tol = 1e-6 if dtype == torch.float32 else 1e-12
    torch.testing.assert_close(got, ref, rtol=tol, atol=tol * float(F.abs().max()))


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


def test_wrappers_refuse_bad_input(dev):
    x = torch.ones((H, W), device=dev)
    with pytest.raises(ValueError):
        median_pos.median_pos_cuda(x.cpu())
    with pytest.raises(TypeError):
        median_pos.median_pos_cuda(x.half())
    with pytest.raises(ValueError):
        advect_bilinear.advect_bilinear_cuda(x[None], x.t().contiguous(), x)
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
