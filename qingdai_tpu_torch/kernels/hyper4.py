"""Wrappers of kernel K3 (``csrc/hyper4.cu``): the ∇⁴ hyperdiffusion chain,
one shared-memory launch per substep; the batched form takes every member of
an ensemble in the same launches.

Replaces ``hyperdiffuse_pallas`` (``qingdai_tpu/ops/pallas_stencil.py``);
plain version ``ops.stencil.hyperdiffuse_multi_ref``.
"""

from __future__ import annotations

import ctypes

import torch

from . import launch, member_stride
from .build import load_library

# rows and columns of input around an owned cell that one substep reads
# (∇²∇²: 2 + 2 rows, 1 + 1 columns); the kernel's tile carries this halo
HALO = (4, 2)


def check_halo() -> None:
    """Raise unless the built kernel's halo is ``HALO``."""
    rows, cols = ctypes.c_int(), ctypes.c_int()
    load_library().qd_hyper4_halo(ctypes.byref(rows), ctypes.byref(cols))
    if (rows.value, cols.value) != HALO:
        raise RuntimeError(f"hyper4.cu's halo {(rows.value, cols.value)} is not {HALO}")


def hyperdiffuse_cuda(F: torch.Tensor, k4: torch.Tensor, dt: float, n_substeps: int,
                      dlat: float, dlon: float, coslat: torch.Tensor,
                      a: float) -> torch.Tensor:
    """n substeps of F ← F − k4·∇²(∇²F)·dt/n for F, k4 [M, H, W] and the
    capped cos map [H, W]."""
    if not isinstance(F, torch.Tensor) or F.dim() != 3:
        raise ValueError("F: expected an [M, H, W] CUDA tensor")
    out = _run(F, k4, dt, n_substeps, dlat, dlon, coslat, a, 1)[0]
    hyperdiffuse_cuda.launches += 1
    return out


hyperdiffuse_cuda.launches = 0


def hyperdiffuse_batched_cuda(F: torch.Tensor, k4: torch.Tensor, dt: float, n_substeps: int,
                              dlat: float, dlon: float, coslat: torch.Tensor, a: float,
                              n_members: int) -> torch.Tensor:
    """``hyperdiffuse_cuda`` for ``n_members`` members, one launch a
    substep: F and k4 [n_members, M, H, W], the capped cos map [H, W]; any
    of them may instead be one tensor without the member axis, shared by
    every member (the static k4 maps are, and are read without a copy).
    Returns [n_members, M, H, W]; member b's result is ``hyperdiffuse_cuda``
    of member b's inputs bit for bit."""
    if not isinstance(F, torch.Tensor) or F.dim() not in (3, 4):
        raise ValueError("F: expected an [n_members, M, H, W] or [M, H, W] CUDA tensor")
    out = _run(F, k4, dt, n_substeps, dlat, dlon, coslat, a, int(n_members))
    hyperdiffuse_batched_cuda.launches += 1
    return out


hyperdiffuse_batched_cuda.launches = 0
hyperdiffuse_cuda.halo_checked = False


def _run(F, k4, dt, n_substeps, dlat, dlon, coslat, a, n_members):
    """The launches for ``n_members`` members (each input with or without
    the member axis): [n_members, M, H, W]."""
    M, H, W = F.shape[-3:]
    if M == 0 or H < 3 or W < 3:
        raise ValueError(f"F: expected M >= 1 and H, W >= 3, got {tuple(F.shape)}")
    if n_members * M * H * W >= 2 ** 31 or n_members * M > 65535:
        raise ValueError(f"F: {n_members} member(s) of {M}x{H}x{W} exceed the kernel's indices")
    strides = [member_stride(t, name, F.dtype, shape, n_members)
               for t, name, shape in ((F, "F", (M, H, W)), (k4, "k4", (M, H, W)),
                                      (coslat, "coslat", (H, W)))]
    if k4.device != F.device or coslat.device != F.device:
        raise ValueError("F, k4 and coslat must be on one device")
    if not hyperdiffuse_cuda.halo_checked:
        check_halo()
        hyperdiffuse_cuda.halo_checked = True
    n = max(1, int(n_substeps))
    out = torch.empty((n_members, M, H, W), dtype=F.dtype, device=F.device)
    tmp = torch.empty_like(out) if n > 1 else None
    launch("qd_hyper4", F.dtype, F.device, F.data_ptr(), k4.data_ptr(), coslat.data_ptr(),
           out.data_ptr(), None if tmp is None else tmp.data_ptr(), n_members, *strides,
           M, H, W, n, float(dlat), float(dlon), float(a), float(dt) / n)
    return out
