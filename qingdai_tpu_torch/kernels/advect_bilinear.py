"""Wrapper of kernel K2 (``csrc/advect_bilinear.cu``): bilinear periodic
interpolation of a field stack at departure points.

Replaces ``advect_windowed_pallas`` (``qingdai_tpu/ops/pallas_advect.py``)
together with the exact-row gather and the polar band pass; plain version
``ops.advect.bilinear_wrap_gather_multi``.
"""

from __future__ import annotations

import torch

from . import check_tensor, launch


def advect_bilinear_cuda(fields: torch.Tensor, dep_j: torch.Tensor,
                         dep_i: torch.Tensor) -> torch.Tensor:
    """Interpolate ``fields`` [M, H, W] at (dep_j, dep_i) [H, W]."""
    check_tensor(fields, "fields", fields.dtype)
    if fields.dim() != 3 or 0 in fields.shape:
        raise ValueError(f"fields: expected a non-empty [M, H, W] stack, got {tuple(fields.shape)}")
    M, H, W = fields.shape
    check_tensor(dep_j, "dep_j", fields.dtype, (H, W))
    check_tensor(dep_i, "dep_i", fields.dtype, (H, W))
    if dep_j.device != fields.device or dep_i.device != fields.device:
        raise ValueError("fields, dep_j and dep_i must be on one device")
    out = torch.empty_like(fields)
    launch("qd_advect_bilinear", fields.dtype, fields.device, fields.data_ptr(),
           dep_j.data_ptr(), dep_i.data_ptr(), out.data_ptr(), M, H, W)
    advect_bilinear_cuda.launches += 1
    return out


advect_bilinear_cuda.launches = 0
