"""The halo depths that the tiled kernels K3 and K4 rest on, held against
their plain versions on the CPU.

A block of K3 (``csrc/hyper4.cu``) or K4 (``csrc/ocean_substeps.cu``) owns a
tile and reads its inputs only within a halo around it: K3 ``hyper4.HALO``
per ∇⁴ substep, K4 ``ocean_substeps.halo(k4_nsub)`` of ``mom`` and ``forc``.
For windows against rows 0 and H−1, at the longitude seam and inside, every
input cell outside the window grown by that halo is perturbed, and the plain
version's outputs on the window must stay the same bit for bit; a cell just
inside the halo is perturbed too, and they must change, so the halo is no
larger than needed. K3's rows clip at the poles (np.gradient's one-sided
rows); K4's wrap across them (the momentum's and mean4's rolls). K4's
``st`` is gathered from device memory at the departure points and needs no
halo, and its η couples every cell through the mean, so neither is checked.
Float64 at 19×36 (41×72 where a halo of 11 rows needs more than 19);
imports no JAX.
"""

import numpy as np
import pytest
import torch

from chip_smoke import k4_operands
from qingdai_tpu_torch import constants as const
from qingdai_tpu_torch.grid import make_grid
from qingdai_tpu_torch.kernels import hyper4, ocean_substeps
from qingdai_tpu_torch.ocean import ocean_substeps_plain
from qingdai_tpu_torch.ops.stencil import hyperdiffuse_multi_ref

torch.set_num_threads(1)
CPU = torch.device("cpu")
A = const.PLANET_RADIUS
H, W = 19, 36
# owned windows: (first row, rows, first column, columns); the column range
# wraps, so (.., 33, 6) straddles the seam
WINDOWS = [(0, 3, 0, 5), (16, 3, 33, 6), (8, 2, 14, 4), (5, 4, 30, 6)]


def grown(shape, window, halo, wrap_rows):
    """Mask of the window grown by ``halo``: columns wrap, rows wrap or clip."""
    h, w = shape
    j0, nj, i0, ni = window
    hr, hc = halo
    rows = np.arange(j0 - hr, j0 + nj + hr)
    rows = rows % h if wrap_rows else rows[(rows >= 0) & (rows < h)]
    cols = np.arange(i0 - hc, i0 + ni + hc) % w
    mask = np.zeros(shape, dtype=bool)
    mask[np.ix_(rows, cols)] = True
    return mask


def owned(shape, window):
    return grown(shape, window, (0, 0), True)


def perturb_outside(x, keep, scale, r):
    """x with noise of ``scale`` added on every cell outside ``keep``."""
    noise = torch.as_tensor(scale * r.standard_normal(x.shape), dtype=x.dtype)
    return torch.where(torch.as_tensor(keep), x, x + noise)


def k3_call(F, k4, cos, n):
    g = make_grid(H, W, device=CPU, dtype=torch.float64)
    return hyperdiffuse_multi_ref(F, k4, 300.0, n, g.dlat_rad, g.dlon_rad, cos, A)


def k3_operands(r):
    g = make_grid(H, W, device=CPU, dtype=torch.float64)
    F = torch.as_tensor(30.0 * r.standard_normal((2, H, W)))
    k4 = (0.02 * g.k4_map_unit / 300.0)[None] * torch.as_tensor(r.uniform(0.5, 1.0, (2, H, W)))
    cos = torch.clamp(g.coslat, min=0.2)
    return F, k4, cos


@pytest.mark.parametrize("n", [1, 2])
@pytest.mark.parametrize("window", WINDOWS)
def test_k3_halo_holds_every_dependency(window, n):
    """F, k4 and cos outside the window grown by n × HALO leave the window's
    output unchanged."""
    r = np.random.default_rng(7)
    F, k4, cos = k3_operands(r)
    ref = k3_call(F, k4, cos, n)
    halo = (n * hyper4.HALO[0], n * hyper4.HALO[1])
    keep = grown((H, W), window, halo, wrap_rows=False)
    got = k3_call(perturb_outside(F, keep, 50.0, r),
                  perturb_outside(k4, keep, 0.5 * float(k4.abs().max()), r),
                  torch.where(torch.as_tensor(keep), cos,
                              torch.as_tensor(r.uniform(0.2, 1.0, (H, W)))), n)
    own = torch.as_tensor(owned((H, W), window))
    assert torch.equal(got[:, own], ref[:, own])
    assert not torch.equal(got, ref)          # the perturbation reached other cells


def test_k3_halo_is_needed():
    """One cell of F at the halo's edge, 4 rows above or 2 columns beside the
    window, changes the window's output."""
    r = np.random.default_rng(8)
    F, k4, cos = k3_operands(r)
    ref = k3_call(F, k4, cos, 1)
    j0, nj, i0, ni = 8, 2, 14, 4
    own = torch.as_tensor(owned((H, W), (j0, nj, i0, ni)))
    hr, hc = hyper4.HALO
    for j, i in ((j0 - hr, i0 + 1), (j0 + nj - 1 + hr, i0), (j0, i0 - hc),
                 (j0 + 1, i0 + ni - 1 + hc)):
        F2 = F.clone()
        F2[:, j, i] += 50.0
        assert not torch.equal(k3_call(F2, k4, cos, 1)[:, own], ref[:, own]), (j, i)


def k4_case(shape, k4_nsub, seed=4):
    mom, st, forc, geo, params = k4_operands(CPU, torch.float64, 3, 1, k4_nsub, 5.0e3,
                                             seed=seed, shape=shape)
    return mom, st, forc, geo, params


def k4_outputs(mom, st, forc, geo, params):
    """U, V and st' of one call of the plain version (η is left out)."""
    m, s = ocean_substeps_plain(mom, st, forc, geo, **params)
    return torch.cat([m[:2], s])


@pytest.mark.parametrize("k4_nsub,shape", [(1, (H, W)), (2, (H, W)), (2, (41, 72))])
@pytest.mark.parametrize("window", WINDOWS)
def test_k4_halo_holds_every_dependency(window, k4_nsub, shape):
    """mom and forc outside the window grown by halo(k4_nsub), rows wrapping
    across the poles, leave U, V, SST and the tracers on the window unchanged."""
    r = np.random.default_rng(9)
    mom, st, forc, geo, params = k4_case(shape, k4_nsub)
    ref = k4_outputs(mom, st, forc, geo, params)
    keep = grown(shape, window, ocean_substeps.halo(k4_nsub), wrap_rows=True)
    scale = torch.tensor([1.0, 1.0, 0.3])[:, None, None].expand(3, *shape).numpy()
    mom2 = perturb_outside(mom, keep, scale, r)
    forc2 = perturb_outside(forc, keep, forc.abs().amax(dim=(1, 2), keepdim=True).numpy(), r)
    got = k4_outputs(mom2, st, forc2, geo, params)
    own = torch.as_tensor(owned(shape, window))
    assert torch.equal(got[:, own], ref[:, own])
    if not keep.all():
        assert not torch.equal(got, ref)      # the perturbation reached other cells


# cells of η at the halo's edge, relative to the window's first row and
# column: for k4_nsub 1 all four sides; for 2 the side below and both
# sides beside (above, this window's chain rounds below one ulp of the SST)
EDGE_CELLS = {1: lambda hr, hc, nj, ni: [(-hr, 1), (nj - 1 + hr, 2), (0, -hc),
                                         (1, ni - 1 + hc)],
              2: lambda hr, hc, nj, ni: [(nj - 1 + hr, 0), (0, -hc), (1, ni - 1 + hc)]}


@pytest.mark.parametrize("k4_nsub,shape", [(1, (H, W)), (2, (41, 72))])
def test_k4_halo_is_needed(k4_nsub, shape):
    """One cell of η at the halo's edge, halo rows above or below or halo
    columns beside the window, changes the window's SST. The chain from
    there (pressure gradient, ∇⁴, departure point, K_h Laplacian) scales a
    change by ~1e-16 of the SST, so the cell moves by 1e3 m."""
    mom, st, forc, geo, params = k4_case(shape, k4_nsub)
    ref = k4_outputs(mom, st, forc, geo, params)
    h, w = shape
    j0, nj, i0, ni = h // 2 - 1, 2, w // 2, 4
    own = torch.as_tensor(owned(shape, (j0, nj, i0, ni)))
    hr, hc = ocean_substeps.halo(k4_nsub)
    for dj, di in EDGE_CELLS[k4_nsub](hr, hc, nj, ni):
        mom2 = mom.clone()
        mom2[2, (j0 + dj) % h, (i0 + di) % w] += 1.0e3
        got = k4_outputs(mom2, st, forc, geo, params)
        assert not torch.equal(got[2][own], ref[2][own]), (dj, di)
