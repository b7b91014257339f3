"""Wrappers of kernel K4 (``csrc/ocean_substeps.cu``): the slab ocean's whole
substep loop on halo tiles, one grid-wide dependency (the η mean) a substep;
the batched form runs every member of an ensemble in the same launch.

Replaces ``ocean_substeps_pallas`` (``qingdai_tpu/ops/pallas_ocean.py``);
plain version ``ocean.ocean_substeps_plain``. The sharded form (a rank of
the longitude mesh) runs one substep as two launches around the cross-rank
sum of the η mean's partial sums; its plain version is the same plain
substep on the rank's columns (``ocean._substeps`` with the mesh).
"""

from __future__ import annotations

import ctypes

import torch

from . import FLOAT_TYPES, check_tensor, launch, member_stride
from .build import load_library

# slots of a traced launch: tile entry, after the momentum, after ∇⁴, after
# the gather, after the K_h gradient, after the owned outputs and partial
# sums, after the grid-wide dependency, after the finish
TRACE_SLOTS = 8
TRACE_STAGES = ("momentum", "del4", "departure points + gather", "K_h gradient",
                "SST + continuity + partial sums", "grid-wide dependency", "finish")


def halo(k4_nsub: int) -> tuple[int, int]:
    """Rows and columns of ``mom`` and ``forc`` around an owned cell that one
    substep reads: U, V after ∇⁴ at (2, 1) for the SST's departure points
    and K_h Laplacian, k4_nsub ∇⁴ substeps of (4, 2) each, and η one more for
    the momentum's pressure gradient. Rows wrap across the poles (the
    momentum's and mean4's rolls)."""
    return 3 + 4 * k4_nsub, 2 + 2 * k4_nsub


def check_halo(k4_nsub: int) -> None:
    """Raise unless the built kernel's halo for ``k4_nsub`` is ``halo``'s."""
    rows, cols = ctypes.c_int(), ctypes.c_int()
    load_library().qd_ocean_substeps_halo(int(k4_nsub), ctypes.byref(rows), ctypes.byref(cols))
    if (rows.value, cols.value) != halo(k4_nsub):
        raise RuntimeError(f"ocean_substeps.cu's halo {(rows.value, cols.value)} for k4_nsub "
                           f"{k4_nsub} is not {halo(k4_nsub)}")


def n_tiles(dtype: torch.dtype, device: torch.device, H: int, W: int, k4_nsub: int) -> int:
    """The number of tiles the launcher cuts an [H, W] grid into on
    ``device``: one partial sum of E·w and one of w each."""
    key = (dtype, device, H, W, k4_nsub)
    if key not in n_tiles.cache:
        n = ctypes.c_int()
        query = getattr(load_library(), "qd_ocean_substeps_tiles" + FLOAT_TYPES[dtype])
        with torch.cuda.device(device):
            rc = query(H, W, int(k4_nsub), ctypes.byref(n))
        if rc != 0:
            raise RuntimeError(f"qd_ocean_substeps_tiles: CUDA error {rc}")
        n_tiles.cache[key] = n.value
    return n_tiles.cache[key]


n_tiles.cache = {}


def ocean_substeps_cuda(mom: torch.Tensor, st: torch.Tensor, forc: torch.Tensor,
                        geo: torch.Tensor, *, n_sub: int, k4_nsub: int, sub_dt: float,
                        H_m: float, r_bot: float, g: float, a: float, dlat: float, dlon: float,
                        K_h: float, adv_alpha: float, use_qnet: bool, ice_qfac: float,
                        cap: float, mean4: bool, eta_cap: float,
                        trace: torch.Tensor | None = None):
    """``n_sub`` substeps of mom = [uo, vo, η] and st = [SST] + tracers
    [n_st, H, W] under forc [3, H, W] and the static planes geo [12, H, W].
    Returns (mom', st'). One cooperative launch, a grid barrier at each
    grid-wide dependency; a card without cooperative launches raises.
    ``trace``, an int64 CUDA tensor of shape ``(2, TRACE_SLOTS)``, takes at
    each stage boundary of the middle tile's block (of the last substep) the
    device's global timer in ns (row 0) and the SM's cycle counter (row 1)."""
    if not isinstance(st, torch.Tensor) or st.dim() != 3:
        raise ValueError("st: expected an [n_st, H, W] CUDA tensor")
    if trace is not None:
        check_tensor(trace, "trace", torch.int64, (2, TRACE_SLOTS))
    mom_out, st_out = _run(mom, st, forc, geo, 1, n_sub=n_sub, k4_nsub=k4_nsub, sub_dt=sub_dt,
                           H_m=H_m, r_bot=r_bot, g=g, a=a, dlat=dlat, dlon=dlon, K_h=K_h,
                           adv_alpha=adv_alpha, use_qnet=use_qnet, ice_qfac=ice_qfac, cap=cap,
                           mean4=mean4, eta_cap=eta_cap, trace=trace)
    ocean_substeps_cuda.launches += 1
    return mom_out[0], st_out[0]


ocean_substeps_cuda.launches = 0
ocean_substeps_cuda.halo_checked = set()


def ocean_substeps_batched_cuda(mom: torch.Tensor, st: torch.Tensor, forc: torch.Tensor,
                                geo: torch.Tensor, n_members: int, **params):
    """``ocean_substeps_cuda`` for ``n_members`` members in one cooperative
    launch: mom, forc [n_members, 3, H, W], st [n_members, n_st, H, W] and
    geo [n_members, 12, H, W]; any of them may instead be one tensor without
    the member axis, shared by every member. The same blocks take every
    member's tiles in turn, with one grid barrier a substep for all members
    (``csrc/ocean_substeps.cu``). Returns (mom' [n_members, 3, H, W], st'
    [n_members, n_st, H, W]); member b's result is ``ocean_substeps_cuda``
    of member b's inputs bit for bit."""
    if not isinstance(st, torch.Tensor) or st.dim() not in (3, 4):
        raise ValueError("st: expected an [n_members, n_st, H, W] or [n_st, H, W] CUDA tensor")
    out = _run(mom, st, forc, geo, int(n_members), **params)
    ocean_substeps_batched_cuda.launches += 1
    return out


ocean_substeps_batched_cuda.launches = 0


def ocean_substep_sharded_cuda(mom_p: torch.Tensor, st_g: torch.Tensor, forc_p: torch.Tensor,
                               geo_p: torch.Tensor, *, pad: int, lon0: int, reduce_sums,
                               k4_nsub: int, sub_dt: float, H_m: float, r_bot: float, g: float,
                               a: float, dlat: float, dlon: float, K_h: float,
                               adv_alpha: float, use_qnet: bool, ice_qfac: float, cap: float,
                               mean4: bool, eta_cap: float, n_sub: int = 1):
    """K4's sharded form, one substep of a rank: launch A (the tile pass on
    the rank's tiles, their partial sums of E·w and w), ``reduce_sums`` of
    the rank's float64 [2] sums (the sum over every rank, on the card), then
    launch B (the η mean removed and the rank's cells finished). ``mom_p``,
    ``forc_p`` [3, H, W + 2·pad] and ``geo_p`` [12, H, W + 2·pad] are the
    rank's columns padded by ``pad`` >= ``halo(k4_nsub)[1]`` neighbour
    columns, ``st_g`` [n_st, H, Wf] the whole stack, whose column lon0 + c is
    owned column c. Returns (mom' [3, H, W], st' [n_st, H, W]). ``n_sub``
    must be 1: the caller exchanges the halo and gathers st between
    substeps."""
    if n_sub != 1:
        raise ValueError("the sharded form runs one substep a call")
    n_st, H, Wf = st_g.shape
    Wp = mom_p.shape[-1]
    W = Wp - 2 * pad
    if pad < halo(k4_nsub)[1] or W < 1 or not 0 <= lon0 <= Wf - W:
        raise ValueError(f"pad {pad}, padded width {Wp} and lon0 {lon0} do not fit the halo "
                         f"{halo(k4_nsub)[1]} and the whole width {Wf}")
    for t, name, shape in ((mom_p, "mom_p", (3, H, Wp)), (st_g, "st_g", (n_st, H, Wf)),
                           (forc_p, "forc_p", (3, H, Wp)), (geo_p, "geo_p", (12, H, Wp))):
        check_tensor(t, name, st_g.dtype, shape)
    if k4_nsub not in ocean_substeps_cuda.halo_checked:
        check_halo(k4_nsub)
        ocean_substeps_cuda.halo_checked.add(k4_nsub)
    dev, dtype = st_g.device, st_g.dtype
    mom_out = torch.empty((3, H, W), dtype=dtype, device=dev)
    st_out = torch.empty((n_st, H, W), dtype=dtype, device=dev)
    uvs = torch.empty((2, H, W + 2), dtype=dtype, device=dev)
    tiles = n_tiles(dtype, dev, H, W, k4_nsub)
    partials = torch.empty((2, tiles), dtype=dtype, device=dev)
    launch("qd_ocean_tiles_sharded", dtype, dev, mom_p.data_ptr(), st_g.data_ptr(),
           forc_p.data_ptr(), geo_p.data_ptr(), mom_out.data_ptr(), st_out.data_ptr(),
           uvs.data_ptr(), partials.data_ptr(), tiles, n_st, H, W, Wp, Wf, int(pad),
           int(lon0), int(k4_nsub), float(sub_dt), float(H_m), float(r_bot), float(g),
           float(a), float(dlat), float(dlon), float(K_h), float(adv_alpha),
           int(bool(use_qnet)), float(ice_qfac))
    ocean_substep_sharded_cuda.launches += 1
    sums = reduce_sums(torch.sum(partials.to(torch.float64), dim=1)).contiguous()
    check_tensor(sums, "sums", torch.float64, (2,))
    launch("qd_ocean_finish_sharded", dtype, dev, mom_out.data_ptr(), uvs.data_ptr(),
           sums.data_ptr(), H, W, float(cap), int(bool(mean4)), float(eta_cap))
    ocean_substep_sharded_cuda.launches += 1
    return mom_out, st_out


ocean_substep_sharded_cuda.launches = 0


def _run(mom, st, forc, geo, n_members, *, n_sub, k4_nsub, sub_dt, H_m, r_bot, g, a, dlat,
         dlon, K_h, adv_alpha, use_qnet, ice_qfac, cap, mean4, eta_cap, trace=None):
    """One launch for ``n_members`` members (each input with or without the
    member axis): (mom' [n_members, 3, H, W], st' [n_members, n_st, H, W])."""
    n_st, H, W = st.shape[-3:]
    if n_st == 0 or H < 3 or W < 3:
        raise ValueError(f"st: expected n_st >= 1 and H, W >= 3, got {tuple(st.shape)}")
    if n_members * max(n_st, 3) * H * W >= 2 ** 31:
        raise ValueError(f"st: {n_members} member(s) of {n_st}x{H}x{W} cells exceed the "
                         "kernel's 32-bit indices")
    strides = [member_stride(t, name, st.dtype, shape, n_members)
               for t, name, shape in ((mom, "mom", (3, H, W)), (st, "st", (n_st, H, W)),
                                      (forc, "forc", (3, H, W)), (geo, "geo", (12, H, W)))]
    if len({t.device for t in (mom, st, forc, geo)}) != 1:
        raise ValueError("mom, st, forc and geo must be on one device")
    if n_sub < 1 or k4_nsub < 1:
        raise ValueError(f"n_sub and k4_nsub must be >= 1, got {n_sub}, {k4_nsub}")
    if k4_nsub not in ocean_substeps_cuda.halo_checked:
        check_halo(k4_nsub)
        ocean_substeps_cuda.halo_checked.add(k4_nsub)
    dev, dtype = st.device, st.dtype
    mom_out = torch.empty((n_members, 3, H, W), dtype=dtype, device=dev)
    st_out = torch.empty((n_members, n_st, H, W), dtype=dtype, device=dev)
    mom2 = torch.empty_like(mom_out) if n_sub > 1 else None
    st2 = torch.empty_like(st_out) if n_sub > 1 else None
    uvs = torch.empty((n_members, 2, H, W), dtype=dtype, device=dev)
    tiles = n_tiles(dtype, dev, H, W, k4_nsub)
    partials = torch.empty((n_members, 2 * tiles), dtype=dtype, device=dev)
    ptr = (lambda t: None if t is None else t.data_ptr())
    launch("qd_ocean_substeps", dtype, dev, mom.data_ptr(), st.data_ptr(), forc.data_ptr(),
           geo.data_ptr(), mom_out.data_ptr(), st_out.data_ptr(), ptr(mom2), ptr(st2),
           uvs.data_ptr(), partials.data_ptr(), tiles, n_members, *strides, n_st, H, W,
           int(n_sub), int(k4_nsub), float(sub_dt), float(H_m), float(r_bot), float(g),
           float(a), float(dlat), float(dlon), float(K_h), float(adv_alpha),
           int(bool(use_qnet)), float(ice_qfac), float(cap), int(bool(mean4)), float(eta_cap),
           ptr(trace))
    return mom_out, st_out
