"""Wrappers of kernel K1 (``csrc/median_pos.cu``): exact median of positives,
one launch of a cluster of 8 blocks; the batched form, one cluster a member.

Replaces ``_median_pos_pallas`` (``qingdai_tpu/ops/reductions.py``); plain
version ``ops.reductions.masked_median_of_positive_ref``.
"""

from __future__ import annotations

import torch

from . import check_tensor, launch, member_stride


def trace_slots(dtype: torch.dtype) -> int:
    """Stamps a traced launch writes: entry, the end of each radix pass's
    local histogram and of its digit search (4 passes in float32, 8 in
    float64), and the exit."""
    return 2 + 2 * (4 if dtype == torch.float32 else 8)


def median_pos_cuda(x: torch.Tensor, fallback: float = 1e-6,
                    trace: torch.Tensor | None = None) -> torch.Tensor:
    """Median of the strictly positive entries of a 2-D CUDA tensor as a 0-d
    tensor on the same device, ``fallback`` if none is positive.

    ``trace``, an int64 CUDA tensor of shape ``(2, trace_slots(x.dtype))``
    and zeros, takes at each stage boundary of the first block the device's
    global timer in ns (row 0) and the SM's cycle counter (row 1); a pass
    that does not run (nothing positive) leaves its slots at 0."""
    if not isinstance(x, torch.Tensor) or x.dim() != 2:
        raise ValueError("x: expected a non-empty 2-D CUDA tensor")
    if trace is not None:
        check_tensor(trace, "trace", torch.int64, (2, trace_slots(x.dtype)))
    out = _run(x, 1, fallback, trace)[0]
    median_pos_cuda.launches += 1
    return out


median_pos_cuda.launches = 0


def median_pos_batched_cuda(x: torch.Tensor, n_members: int,
                            fallback: float = 1e-6) -> torch.Tensor:
    """``median_pos_cuda`` of each member's field in one launch of
    ``n_members`` clusters: x is [n_members, H, W] (or one [H, W] field
    shared by every member); returns [n_members], ``fallback`` for a member
    with nothing positive. Member b's result is ``median_pos_cuda(x[b])``
    bit for bit."""
    if not isinstance(x, torch.Tensor) or x.dim() not in (2, 3):
        raise ValueError("x: expected an [n_members, H, W] or [H, W] CUDA tensor")
    out = _run(x, int(n_members), fallback, None)
    median_pos_batched_cuda.launches += 1
    return out


median_pos_batched_cuda.launches = 0


def _run(x, n_members, fallback, trace):
    """One launch for ``n_members`` members' [H, W] fields (x with or
    without the member axis): [n_members] results."""
    field = tuple(x.shape[-2:])
    stride = member_stride(x, "x", x.dtype, field, n_members)
    n = field[0] * field[1]
    if n == 0 or n >= 2 ** 31:
        raise ValueError(f"x: {n} entries a field; the kernel takes 1 to 2^31 - 1")
    out = torch.empty((n_members,), dtype=x.dtype, device=x.device)
    launch("qd_median_pos", x.dtype, x.device, x.data_ptr(), stride, n_members, n,
           float(fallback), out.data_ptr(), None if trace is None else trace.data_ptr())
    return out
