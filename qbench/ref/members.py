"""Each member's initial state, worked out again (the reference's copy of
the measured package's ``init_ensemble`` per member): member 0 is
``init_world`` exactly, member i ≥ 1 ``init_world`` perturbed by draws from
its own ``torch.Generator`` seeded from (seed, i)."""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from . import model as M
from .ecology import population as eco_mod


def _correlated_noise(white: torch.Tensor, passes: int = 6) -> torch.Tensor:
    """Zero-mean noise of unit std with a few-cell correlation length: the
    white noise ``white`` [H, W] smoothed by ``passes`` 4-neighbour averages
    (periodic in longitude, clamped in latitude), then renormalised. Grid-
    scale white noise would not survive the ∇⁴ and Shapiro filters."""
    n = white
    for _ in range(passes):
        n = 0.2 * (n
                   + torch.roll(n, 1, -1) + torch.roll(n, -1, -1)
                   + torch.cat([n[:1], n[:-1]], dim=0)
                   + torch.cat([n[1:], n[-1:]], dim=0))
    # renormalise to unit std (population std, as jnp.std)
    return n / torch.clamp(torch.std(n, correction=0), min=1e-12)


def correlated_noise(generator: torch.Generator, shape, dtype, device,
                     passes: int = 6) -> torch.Tensor:
    """``_correlated_noise`` of white noise drawn from ``generator``."""
    white = torch.randn(tuple(shape), generator=generator, dtype=dtype, device=device)
    return _correlated_noise(white, passes)


def perturb_member(state: WorldState, generator_or_draws, amp, land_mask,
                   h_amp=0.0) -> WorldState:
    """One member's initial condition: T_s noise of ``amp`` K, the same noise
    on the SST over open ocean (so the surface fields stay consistent, as
    the banded init applies one field to both), and correlated height noise
    of ``h_amp`` m, which displaces the mass field the winds balance against
    and so seeds lasting flow differences.

    ``generator_or_draws`` is a ``torch.Generator``, from which the T_s noise
    and then the height's white noise are drawn (standard normal, [H, W]
    each), or those two tensors."""
    T_s = state.atmos.T_s
    if isinstance(generator_or_draws, torch.Generator):
        g = generator_or_draws
        noise = torch.randn(tuple(T_s.shape), generator=g, dtype=T_s.dtype, device=T_s.device)
        h_noise = correlated_noise(g, T_s.shape, T_s.dtype, T_s.device)
    else:
        noise, white_h = generator_or_draws
        h_noise = _correlated_noise(white_h)
    noise = amp * noise
    h_noise = h_amp * h_noise
    atmos = dataclasses.replace(state.atmos, T_s=T_s + noise, h=state.atmos.h + h_noise)
    sst = torch.where(land_mask == 0, state.ocean.sst + noise, state.ocean.sst)
    return dataclasses.replace(state, atmos=atmos,
                               ocean=dataclasses.replace(state.ocean, sst=sst))


def member_seed(seed: int, i: int) -> int:
    """The seed of member ``i``'s generator, from (seed, i)."""
    return int(np.random.SeedSequence([int(seed), int(i)]).generate_state(1, np.uint64)[0])


def member_generator(model: M.Model, seed: int, i: int) -> torch.Generator:
    """Member ``i``'s generator as it stands when its perturbation is drawn:
    member 0 the model's own stream, seeded with the configuration's seed."""
    if i == 0:
        return torch.Generator(device=model.device).manual_seed(model.cfg.run.seed)
    return torch.Generator(device=model.device).manual_seed(member_seed(seed, i))


def init_member(model: M.Model, i: int, seed: int, perturb_k: float, h_amp: float = 0.0):
    """(member ``i``'s initial state, its generator after the perturbation's
    draws)."""
    base = M.init_world(model, seed=seed)
    g = member_generator(model, seed, i)
    if i == 0:
        return base, g
    return perturb_member(base, g, perturb_k, model.static.land_mask, h_amp), g


def mutation_draws(model: M.Model, state, generator: torch.Generator):
    """One daily mutation's draws from a member's generator."""
    return eco_mod.mutation_draws(model.eco_static, state.eco, generator)
