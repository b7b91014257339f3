"""Scatter-adds in a fixed order of additions.

``index_add`` on a CUDA tensor adds with atomics: contributions to one
target land in any order, so the last bits of the sum vary from run to run
and a resumed run cannot equal an uninterrupted one. A ``ScatterPlan``,
built once on the host from the static targets, splits the additions into
rounds whose targets are unique (round k holds the k-th occurrence of each
target, in the index's order). One ``index_add`` per round then gives every
target its contributions in the index's order, which is also the order of
the JAX package's sequential scatter on the CPU, on any device.

Where the targets are known only on the device (the departure points of a
gather, whose backward is a scatter-add), ``index_add_ordered`` sorts them
stably and sums each target's run in order, with no host sync;
``gather_fixed`` is an ``index_select`` whose backward does that.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch


def unique_rounds(targets: np.ndarray):
    """A stable permutation of ``targets`` into rounds whose targets are
    unique: round k holds the k-th occurrence of each target. Returns
    (permutation, [(first, last) of each round])."""
    targets = np.asarray(targets).ravel()
    if targets.size == 0:
        return np.zeros(0, np.int64), []
    occ = np.zeros(targets.size, np.int64)
    seen = {}
    for i, t in enumerate(targets.tolist()):
        occ[i] = seen.get(t, 0)
        seen[t] = occ[i] + 1
    perm = np.argsort(occ, kind="stable")
    counts = np.bincount(occ)
    ends = np.cumsum(counts)
    return perm, [(int(e - c), int(e)) for c, e in zip(counts, ends)]


@dataclasses.dataclass(frozen=True)
class ScatterPlan:
    """The targets of a scatter-add in round order, with the permutation of
    the source that puts it in that order (None where the targets are
    already unique)."""
    index: torch.Tensor
    perm: Optional[torch.Tensor]
    rounds: tuple


def scatter_plan(targets: np.ndarray, device) -> ScatterPlan:
    targets = np.asarray(targets, np.int64).ravel()
    perm, rounds = unique_rounds(targets)
    index = torch.as_tensor(targets[perm]).to(device)
    if len(rounds) <= 1:
        return ScatterPlan(index=index, perm=None, rounds=tuple(rounds))
    return ScatterPlan(index=index, perm=torch.as_tensor(perm).to(device), rounds=tuple(rounds))


def index_add_fixed(x: torch.Tensor, dim: int, plan: ScatterPlan,
                    source: torch.Tensor) -> torch.Tensor:
    """``x.index_add(dim, targets, source)`` with the additions in the
    targets' order (module docstring); out of place."""
    if plan.perm is not None:
        source = source.index_select(dim, plan.perm)
    for a, b in plan.rounds:
        x = x.index_add(dim, plan.index[a:b], source.narrow(dim, a, b - a))
    return x


def index_add_ordered(size: int, dim: int, index: torch.Tensor,
                      source: torch.Tensor) -> torch.Tensor:
    """A zero tensor of ``size`` along ``dim`` (``source``'s shape elsewhere)
    ``.index_add(dim, index, source)``, each target's contributions summed in
    the index's order, with targets known only on the device (a gather at
    data-dependent points): a stable sort of the index and a segmented sum,
    one thread a target adding its run in order. No host sync."""
    order = torch.sort(index, stable=True).indices
    counts = torch.bincount(index, minlength=size)
    src = source.index_select(dim, order).movedim(dim, 0)
    rest = src.shape[1:]
    out = torch.segment_reduce(src.reshape(src.shape[0], -1).contiguous(), "sum",
                               lengths=counts, axis=0, unsafe=True, initial=0)
    return out.reshape((size,) + rest).movedim(0, dim)


class _GatherFixed(torch.autograd.Function):
    """``index_select`` whose backward adds in the index's order."""
    generate_vmap_rule = True

    @staticmethod
    def forward(x, dim, index):
        return x.index_select(dim, index)

    @staticmethod
    def setup_context(ctx, inputs, output):
        x, dim, index = inputs
        ctx.dim, ctx.size = dim, x.shape[dim]
        ctx.save_for_backward(index)

    @staticmethod
    def backward(ctx, grad):
        index, = ctx.saved_tensors
        return index_add_ordered(ctx.size, ctx.dim, index, grad), None, None


def gather_fixed(x: torch.Tensor, dim: int, index: torch.Tensor) -> torch.Tensor:
    """``x.index_select(dim, index)`` whose gradient sums each target's
    contributions in the index's order (``index_add_ordered``). Autograd's
    own backward is an ``index_add``, which adds with atomics on a CUDA
    tensor, so two identical gradient calls could differ in their last
    bits; on the CPU it adds in the index's order, and this gives its bits."""
    return _GatherFixed.apply(x, dim, index)
