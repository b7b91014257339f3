"""Wrapper of kernel K1 (``csrc/median_pos.cu``): exact median of positives,
one launch of a cluster of 8 blocks.

Replaces ``_median_pos_pallas`` (``qingdai_tpu/ops/reductions.py``); plain
version ``ops.reductions.masked_median_of_positive_ref``.
"""

from __future__ import annotations

import torch

from . import check_tensor, launch


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
    check_tensor(x, "x", x.dtype)
    if x.dim() != 2 or x.numel() == 0:
        raise ValueError(f"x: expected a non-empty 2-D field, got shape {tuple(x.shape)}")
    if x.numel() >= 2 ** 31:
        raise ValueError(f"x: {x.numel()} entries exceed the kernel's 32-bit counts")
    if trace is not None:
        check_tensor(trace, "trace", torch.int64, (2, trace_slots(x.dtype)))
    out = torch.empty((), dtype=x.dtype, device=x.device)
    launch("qd_median_pos", x.dtype, x.device, x.data_ptr(), x.numel(), float(fallback),
           out.data_ptr(), None if trace is None else trace.data_ptr())
    median_pos_cuda.launches += 1
    return out


median_pos_cuda.launches = 0
