"""Wrapper of kernel K4 (``csrc/ocean_substeps.cu``): the slab ocean's whole
substep loop on halo tiles, one grid-wide dependency (the η mean) a substep.

Replaces ``ocean_substeps_pallas`` (``qingdai_tpu/ops/pallas_ocean.py``);
plain version ``ocean.ocean_substeps_plain``.
"""

from __future__ import annotations

import ctypes

import torch

from . import FLOAT_TYPES, check_tensor, launch
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
    check_tensor(st, "st", st.dtype)
    if st.dim() != 3 or st.shape[0] == 0 or st.shape[1] < 3 or st.shape[2] < 3:
        raise ValueError(f"st: expected [n_st, H, W] with H, W >= 3, got {tuple(st.shape)}")
    n_st, H, W = st.shape
    if st.numel() >= 2 ** 31:
        raise ValueError(f"st: {st.numel()} cells exceed the kernel's 32-bit indices")
    check_tensor(mom, "mom", st.dtype, (3, H, W))
    check_tensor(forc, "forc", st.dtype, (3, H, W))
    check_tensor(geo, "geo", st.dtype, (12, H, W))
    if len({t.device for t in (mom, st, forc, geo)}) != 1:
        raise ValueError("mom, st, forc and geo must be on one device")
    if n_sub < 1 or k4_nsub < 1:
        raise ValueError(f"n_sub and k4_nsub must be >= 1, got {n_sub}, {k4_nsub}")
    if trace is not None:
        check_tensor(trace, "trace", torch.int64, (2, TRACE_SLOTS))
    if k4_nsub not in ocean_substeps_cuda.halo_checked:
        check_halo(k4_nsub)
        ocean_substeps_cuda.halo_checked.add(k4_nsub)
    mom_out = torch.empty_like(mom)
    st_out = torch.empty_like(st)
    mom2 = torch.empty_like(mom) if n_sub > 1 else None
    st2 = torch.empty_like(st) if n_sub > 1 else None
    uvs = torch.empty((2, H, W), dtype=st.dtype, device=st.device)
    tiles = n_tiles(st.dtype, st.device, H, W, k4_nsub)
    partials = torch.empty((2 * tiles,), dtype=st.dtype, device=st.device)
    ptr = (lambda t: None if t is None else t.data_ptr())
    launch("qd_ocean_substeps", st.dtype, st.device, mom.data_ptr(), st.data_ptr(),
           forc.data_ptr(), geo.data_ptr(), mom_out.data_ptr(), st_out.data_ptr(), ptr(mom2),
           ptr(st2), uvs.data_ptr(), partials.data_ptr(), tiles, n_st, H, W, int(n_sub),
           int(k4_nsub), float(sub_dt), float(H_m), float(r_bot), float(g), float(a),
           float(dlat), float(dlon), float(K_h), float(adv_alpha), int(bool(use_qnet)),
           float(ice_qfac), float(cap), int(bool(mean4)), float(eta_cap), ptr(trace))
    ocean_substeps_cuda.launches += 1
    return mom_out, st_out


ocean_substeps_cuda.launches = 0
ocean_substeps_cuda.halo_checked = set()
