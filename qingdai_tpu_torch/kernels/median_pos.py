"""Wrapper of kernel K1 (``csrc/median_pos.cu``): exact median of positives.

Replaces ``_median_pos_pallas`` (``qingdai_tpu/ops/reductions.py``); plain
version ``ops.reductions.masked_median_of_positive_ref``.
"""

from __future__ import annotations

import torch

from . import check_tensor, launch


def median_pos_cuda(x: torch.Tensor, fallback: float = 1e-6) -> torch.Tensor:
    """Median of the strictly positive entries of a 2-D CUDA tensor as a 0-d
    tensor on the same device, ``fallback`` if none is positive."""
    check_tensor(x, "x", x.dtype)
    if x.dim() != 2 or x.numel() == 0:
        raise ValueError(f"x: expected a non-empty 2-D field, got shape {tuple(x.shape)}")
    out = torch.empty((), dtype=x.dtype, device=x.device)
    launch("qd_median_pos", x.dtype, x.device, x.data_ptr(), x.numel(), float(fallback),
           out.data_ptr())
    median_pos_cuda.launches += 1
    return out


median_pos_cuda.launches = 0
