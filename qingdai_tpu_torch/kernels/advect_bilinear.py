"""Wrappers of kernel K2 (``csrc/advect_bilinear.cu``): semi-Lagrangian
advection of a field stack in one launch, departure points included; the
batched form advects every member of an ensemble in one launch.

Replaces ``advect_windowed_pallas`` (``qingdai_tpu/ops/pallas_advect.py``)
together with the exact-row gather and the polar band pass; plain version
``ops.advect.bilinear_wrap_gather_multi`` at ``ops.advect.departure_indices``.
The sharded form (a rank of the longitude mesh) reads the whole stack and
writes the rank's columns, at a column offset.
"""

from __future__ import annotations

import numbers

import torch

from . import launch, member_stride


def advect_bilinear_cuda(fields: torch.Tensor, u: torch.Tensor, v: torch.Tensor,
                         dt: float, a: float, dlat: float, dlon: float,
                         coslat: torch.Tensor, departures: bool = False):
    """Advect ``fields`` [M, H, W] by the wind (u, v) [H, W] over ``dt``, as
    ``ops.advect.advect_semilag_multi``. With ``departures`` also return the
    departure points (dep_j, dep_i) the kernel computed, for checking them
    against ``departure_indices``."""
    if not isinstance(fields, torch.Tensor) or fields.dim() != 3:
        raise ValueError("fields: expected a non-empty [M, H, W] CUDA tensor")
    out = _run(fields, u, v, (dt, a, dlat, dlon), coslat, 1, departures)
    advect_bilinear_cuda.launches += 1
    return tuple(t[0] for t in out) if departures else out[0]


advect_bilinear_cuda.launches = 0


def advect_bilinear_batched_cuda(fields: torch.Tensor, u: torch.Tensor, v: torch.Tensor,
                                 dt: float, a: float, dlat: float, dlon: float,
                                 coslat: torch.Tensor, n_members: int,
                                 departures: bool = False):
    """``advect_bilinear_cuda`` for ``n_members`` members in one launch:
    ``fields`` [n_members, M, H, W], the winds [n_members, H, W] and
    ``coslat`` [H, W]; any of them may instead be one tensor without the
    member axis, shared by every member. Returns [n_members, M, H, W] (and
    with ``departures`` the points [n_members, H, W] twice); member b's
    result is ``advect_bilinear_cuda`` of member b's inputs bit for bit."""
    if not isinstance(fields, torch.Tensor) or fields.dim() not in (3, 4):
        raise ValueError("fields: expected an [n_members, M, H, W] or [M, H, W] CUDA tensor")
    out = _run(fields, u, v, (dt, a, dlat, dlon), coslat, int(n_members), departures)
    advect_bilinear_batched_cuda.launches += 1
    return out


advect_bilinear_batched_cuda.launches = 0


def advect_bilinear_sharded_cuda(fields: torch.Tensor, u: torch.Tensor, v: torch.Tensor,
                                 dt: float, a: float, dlat: float, dlon: float,
                                 coslat: torch.Tensor, lon0: int, departures: bool = False):
    """K2's sharded form: advect the whole stack ``fields`` [M, H, Wf] by a
    rank's winds (u, v) and cos map [H, W] and return the rank's columns
    [M, H, W], whose column i is global column ``lon0 + i``: bit for bit
    the columns ``[lon0, lon0 + W)`` of ``advect_bilinear_cuda`` on the whole
    grid's winds. With ``departures`` also the departure points."""
    if not isinstance(fields, torch.Tensor) or fields.dim() != 3:
        raise ValueError("fields: expected a non-empty [M, H, Wf] CUDA tensor")
    out = _run(fields, u, v, (dt, a, dlat, dlon), coslat, 1, departures, lon0=int(lon0))
    advect_bilinear_sharded_cuda.launches += 1
    return tuple(t[0] for t in out) if departures else out[0]


advect_bilinear_sharded_cuda.launches = 0


def _run(fields, u, v, scalars, coslat, n_members, departures, lon0=None):
    """One launch for ``n_members`` members (each input with or without the
    member axis): the stacks [n_members, M, H, W], and with ``departures``
    the points [n_members, H, W] twice. With ``lon0`` the sharded form:
    ``fields`` is the whole stack [.., M, H, Wf] and W is the winds'."""
    M, H, Wf = fields.shape[-3:]
    W = Wf if lon0 is None else u.shape[-1]
    lon0 = 0 if lon0 is None else lon0
    if 0 in (M, H, W):
        raise ValueError(f"fields: expected a non-empty stack, got {tuple(fields.shape)}")
    if not 0 <= lon0 <= Wf - W:
        raise ValueError(f"columns [{lon0}, {lon0 + W}) lie outside the stack's {Wf}")
    if M * H * Wf >= 2 ** 31:
        raise ValueError(f"fields: {M}x{H}x{Wf} cells a member exceed the kernel's 32-bit indices")
    dtype = fields.dtype
    strides = [member_stride(t, name, dtype, shape, n_members)
               for t, name, shape in ((fields, "fields", (M, H, Wf)), (u, "u", (H, W)),
                                      (v, "v", (H, W)), (coslat, "coslat", (H, W)))]
    if len({t.device for t in (fields, u, v, coslat)}) != 1:
        raise ValueError("fields, u, v and coslat must be on one device")
    if not all(isinstance(s, numbers.Real) for s in scalars):
        raise TypeError("dt, a, dlat and dlon must be Python numbers")
    out = torch.empty((n_members, M, H, W), dtype=dtype, device=fields.device)
    dep = (torch.empty((n_members, 2, H, W), dtype=dtype, device=fields.device)
           if departures else None)
    launch("qd_advect_bilinear", dtype, fields.device, fields.data_ptr(), u.data_ptr(),
           v.data_ptr(), coslat.data_ptr(), out.data_ptr(),
           dep.data_ptr() if departures else None, n_members, *strides, M, H, W, Wf, lon0,
           *map(float, scalars))
    return (out, dep[:, 0], dep[:, 1]) if departures else out
