"""Wrapper of kernel K3 (``csrc/hyper4.cu``): the ∇⁴ hyperdiffusion chain.

Replaces ``hyperdiffuse_pallas`` (``qingdai_tpu/ops/pallas_stencil.py``);
plain version ``ops.stencil.hyperdiffuse_multi_ref``.
"""

from __future__ import annotations

import torch

from . import check_tensor, launch


def hyperdiffuse_cuda(F: torch.Tensor, k4: torch.Tensor, dt: float, n_substeps: int,
                      dlat: float, dlon: float, coslat: torch.Tensor,
                      a: float) -> torch.Tensor:
    """n substeps of F ← F − k4·∇²(∇²F)·dt/n for F, k4 [M, H, W] and the
    capped cos map [H, W]."""
    check_tensor(F, "F", F.dtype)
    if F.dim() != 3 or F.shape[0] == 0 or F.shape[1] < 3 or F.shape[2] < 3:
        raise ValueError(f"F: expected [M, H, W] with H, W >= 3, got {tuple(F.shape)}")
    M, H, W = F.shape
    check_tensor(k4, "k4", F.dtype, F.shape)
    check_tensor(coslat, "coslat", F.dtype, (H, W))
    if k4.device != F.device or coslat.device != F.device:
        raise ValueError("F, k4 and coslat must be on one device")
    n = max(1, int(n_substeps))
    out = torch.empty_like(F)
    G = torch.empty_like(F)
    L = torch.empty_like(F)
    launch("qd_hyper4", F.dtype, F.device, F.data_ptr(), k4.data_ptr(), coslat.data_ptr(),
           out.data_ptr(), G.data_ptr(), L.data_ptr(), M, H, W, n, float(dlat), float(dlon),
           float(a), float(dt) / n)
    hyperdiffuse_cuda.launches += 1
    return out


hyperdiffuse_cuda.launches = 0
