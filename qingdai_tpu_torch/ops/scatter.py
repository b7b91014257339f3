"""Scatter-adds in a fixed order of additions.

``index_add`` on a CUDA tensor adds with atomics: contributions to one
target land in any order, so the last bits of the sum vary from run to run
and a resumed run cannot equal an uninterrupted one. A ``ScatterPlan``,
built once on the host from the static targets, splits the additions into
rounds whose targets are unique (round k holds the k-th occurrence of each
target, in the index's order). One ``index_add`` per round then gives every
target its contributions in the index's order, which is also the order of
the JAX package's sequential scatter on the CPU, on any device.
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
