"""Wrapper of kernel K2 (``csrc/advect_bilinear.cu``): semi-Lagrangian
advection of a field stack in one launch, departure points included.

Replaces ``advect_windowed_pallas`` (``qingdai_tpu/ops/pallas_advect.py``)
together with the exact-row gather and the polar band pass; plain version
``ops.advect.bilinear_wrap_gather_multi`` at ``ops.advect.departure_indices``.
"""

from __future__ import annotations

import numbers

import torch

from . import check_tensor, launch


def advect_bilinear_cuda(fields: torch.Tensor, u: torch.Tensor, v: torch.Tensor,
                         dt: float, a: float, dlat: float, dlon: float,
                         coslat: torch.Tensor, departures: bool = False):
    """Advect ``fields`` [M, H, W] by the wind (u, v) [H, W] over ``dt``, as
    ``ops.advect.advect_semilag_multi``. With ``departures`` also return the
    departure points (dep_j, dep_i) the kernel computed, for checking them
    against ``departure_indices``."""
    check_tensor(fields, "fields", fields.dtype)
    if fields.dim() != 3 or 0 in fields.shape:
        raise ValueError(f"fields: expected a non-empty [M, H, W] stack, got {tuple(fields.shape)}")
    M, H, W = fields.shape
    if H * W >= 2 ** 31:
        raise ValueError(f"fields: {H}x{W} cells exceed the kernel's 32-bit indices")
    for name, t in (("u", u), ("v", v), ("coslat", coslat)):
        check_tensor(t, name, fields.dtype, (H, W))
        if t.device != fields.device:
            raise ValueError("fields, u, v and coslat must be on one device")
    scalars = (dt, a, dlat, dlon)
    if not all(isinstance(s, numbers.Real) for s in scalars):
        raise TypeError("dt, a, dlat and dlon must be Python numbers")
    out = torch.empty_like(fields)
    dep = torch.empty((2, H, W), dtype=fields.dtype, device=fields.device) if departures else None
    launch("qd_advect_bilinear", fields.dtype, fields.device, fields.data_ptr(), u.data_ptr(),
           v.data_ptr(), coslat.data_ptr(), out.data_ptr(),
           dep.data_ptr() if departures else None, M, H, W, *map(float, scalars))
    advect_bilinear_cuda.launches += 1
    return (out, dep[0], dep[1]) if departures else out


advect_bilinear_cuda.launches = 0
