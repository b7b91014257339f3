"""Wrapper of kernel K4 (``csrc/ocean_substeps.cu``): the slab ocean's whole
substep loop in one cooperative launch.

Replaces ``ocean_substeps_pallas`` (``qingdai_tpu/ops/pallas_ocean.py``);
plain version ``ocean.ocean_substeps_plain``.
"""

from __future__ import annotations

import torch

from . import check_tensor, launch

# room for one partial sum per block; the launcher sizes the grid to
# co-residency (132 SMs × a few blocks on an H100), far below this
PARTIAL_CAP = 4096


def ocean_substeps_cuda(mom: torch.Tensor, st: torch.Tensor, forc: torch.Tensor,
                        geo: torch.Tensor, *, n_sub: int, k4_nsub: int, sub_dt: float,
                        H_m: float, r_bot: float, g: float, a: float, dlat: float, dlon: float,
                        K_h: float, adv_alpha: float, use_qnet: bool, ice_qfac: float,
                        cap: float, mean4: bool, eta_cap: float):
    """``n_sub`` substeps of mom = [uo, vo, η] and st = [SST] + tracers
    [n_st, H, W] under forc [3, H, W] and the static planes geo [12, H, W].
    Returns (mom', st')."""
    check_tensor(st, "st", st.dtype)
    if st.dim() != 3 or st.shape[0] == 0 or st.shape[1] < 3 or st.shape[2] < 3:
        raise ValueError(f"st: expected [n_st, H, W] with H, W >= 3, got {tuple(st.shape)}")
    n_st, H, W = st.shape
    check_tensor(mom, "mom", st.dtype, (3, H, W))
    check_tensor(forc, "forc", st.dtype, (3, H, W))
    check_tensor(geo, "geo", st.dtype, (12, H, W))
    if len({t.device for t in (mom, st, forc, geo)}) != 1:
        raise ValueError("mom, st, forc and geo must be on one device")
    if n_sub < 1 or k4_nsub < 1:
        raise ValueError(f"n_sub and k4_nsub must be >= 1, got {n_sub}, {k4_nsub}")
    mom_out = torch.empty_like(mom)
    st_out = torch.empty_like(st)
    uv2 = torch.empty((2, H, W), dtype=st.dtype, device=st.device)
    st2 = torch.empty_like(st)
    G = torch.empty_like(mom)
    L = torch.empty_like(mom)
    sst_tmp = torch.empty((H, W), dtype=st.dtype, device=st.device)
    partials = torch.empty((2 * PARTIAL_CAP,), dtype=st.dtype, device=st.device)
    launch("qd_ocean_substeps", st.dtype, st.device, mom.data_ptr(), st.data_ptr(),
           forc.data_ptr(), geo.data_ptr(), mom_out.data_ptr(), st_out.data_ptr(),
           uv2.data_ptr(), st2.data_ptr(), G.data_ptr(), L.data_ptr(), sst_tmp.data_ptr(),
           partials.data_ptr(), PARTIAL_CAP, n_st, H, W, int(n_sub), int(k4_nsub),
           float(sub_dt), float(H_m), float(r_bot), float(g), float(a), float(dlat),
           float(dlon), float(K_h), float(adv_alpha), int(bool(use_qnet)), float(ice_qfac),
           float(cap), int(bool(mean4)), float(eta_cap))
    ocean_substeps_cuda.launches += 1
    return mom_out, st_out


ocean_substeps_cuda.launches = 0
