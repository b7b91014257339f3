"""What the kernels' ``torch.autograd.Function``s share: the dispatch rules
around a kernel and its member axis under ``torch.func.vmap``.

Each of K1–K4 is dispatched by device: a CPU tensor goes to the plain
version directly (``torch.func.vmap`` batches its ops, and autograd runs
through them), a CUDA tensor to one Function whose ``forward`` launches the
kernel and whose ``vmap`` staticmethod receives an ensemble's batched
tensors with their ``in_dims`` and calls the kernel's batched form, one
launch for every member. None has a backward yet, so a CUDA input that
requires grad raises.
"""

from __future__ import annotations

import torch


def refuse_grad(name: str, *tensors) -> None:
    """Raise for a CUDA input that requires grad: the kernel has no backward."""
    if any(isinstance(t, torch.Tensor) and t.requires_grad for t in tensors):
        raise RuntimeError(f"{name}: the kernel has no backward; run the gradient on CPU "
                           "tensors, where the plain version is differentiable")


def to_front(t: torch.Tensor, dim) -> torch.Tensor:
    """A batched input with its member axis first, contiguous; an unbatched
    one (``dim`` None) as it is, contiguous, for every member to share."""
    return (t if dim is None else t.movedim(dim, 0)).contiguous()
