"""Wrappers of kernel K6 (``csrc/gauss_sep.cu``): the separable Gaussian
filter, both axes in one launch; the batched form takes every member of an
ensemble in the same launch.

Replaces no TPU kernel: the JAX package leaves the filter to XLA's fusion.
Plain version ``ops.smooth.gaussian_filter_plain``.
"""

from __future__ import annotations

import ctypes

import torch

from . import launch, member_stride

MODES = {"reflect": 0, "wrap": 1, "nearest": 2}
MAX_RADIUS = 64          # the kernel's taps: 2 · 64 + 1


def gaussian_filter_cuda(F: torch.Tensor, taps: tuple, mode_lat: str = "reflect",
                         mode_lon: str = "reflect") -> torch.Tensor:
    """The filter of an [H, W] field with the 2r + 1 ``taps`` (Python
    numbers, ``ops.smooth._gauss_kernel``), latitude then longitude, each
    axis padded by its mode ("reflect", "wrap" or "nearest")."""
    if not isinstance(F, torch.Tensor) or F.dim() != 2:
        raise ValueError("F: expected an [H, W] CUDA tensor")
    out = _run(F, taps, mode_lat, mode_lon, 1)[0]
    gaussian_filter_cuda.launches += 1
    return out


gaussian_filter_cuda.launches = 0


def gaussian_filter_batched_cuda(F: torch.Tensor, taps: tuple, mode_lat: str, mode_lon: str,
                                 n_members: int) -> torch.Tensor:
    """``gaussian_filter_cuda`` for ``n_members`` members in one launch: F
    [n_members, H, W], each member's plane contiguous at any member stride,
    or one [H, W] field shared by every member (read without a copy).
    Returns [n_members, H, W]; member b's result is ``gaussian_filter_cuda``
    of member b's field bit for bit."""
    if not isinstance(F, torch.Tensor) or F.dim() not in (2, 3):
        raise ValueError("F: expected an [n_members, H, W] or [H, W] CUDA tensor")
    out = _run(F, taps, mode_lat, mode_lon, int(n_members))
    gaussian_filter_batched_cuda.launches += 1
    return out


gaussian_filter_batched_cuda.launches = 0


def _run(F, taps, mode_lat, mode_lon, n_members):
    """The launch for ``n_members`` members: [n_members, H, W]. Raises where
    the plain version fails (a radius beyond a reflect or wrap axis, an
    unknown mode, an empty axis) and beyond the kernel's radius."""
    H, W = F.shape[-2:]
    r = (len(taps) - 1) // 2
    if len(taps) != 2 * r + 1 or not 1 <= r <= MAX_RADIUS:
        raise ValueError(f"taps: expected 2r + 1 of them, 1 <= r <= {MAX_RADIUS}, "
                         f"got {len(taps)}")
    for mode, n, axis in ((mode_lat, H, "latitude"), (mode_lon, W, "longitude")):
        if mode not in MODES:
            raise ValueError(f"unknown pad mode {mode}")
        if n < 1 or (mode != "nearest" and r > n):
            raise ValueError(f"F: radius {r} beyond the {n} points of the {axis} axis "
                             f"({mode})")
    T = F.dtype
    stride = member_stride(F, "F", T, (H, W), n_members)
    out = torch.empty((n_members, H, W), dtype=T, device=F.device)
    launch("qd_gauss_sep", T, F.device, F.data_ptr(), out.data_ptr(), n_members, stride, H, W,
           r, (ctypes.c_double * len(taps))(*map(float, taps)), MODES[mode_lat],
           MODES[mode_lon])
    return out
