"""Adjoint sensitivities and gradient-based calibration through the full
coupled model (port of ``qingdai_tpu/adjoint.py``).

Reverse-mode autograd differentiates a whole multi-step window of the
coupled physics (atmosphere, ocean, sea ice, hydrology, routing events,
ecology dailies, phytoplankton) in one backward sweep, with two-level
checkpointing keeping ~(n/seg + seg) world-states instead of n: each
segment of ``seg`` steps runs under ``torch.utils.checkpoint`` and is
recomputed in the backward sweep.

On the card the forward launches kernels K1–K4 as the production step does;
each kernel's ``autograd.Function`` takes its backward as the VJP of its
plain version (``ops.members.plain_vjp``), the gradient the JAX package
takes with its Pallas kernels off. On the CPU the plain versions run under
autograd directly. The model's device decides where the window runs.

What can be differentiated, by alias (``PARAM_ALIASES``) or dotted path:

- **Scalar physics parameters** (``gh_factor`` -> ``cfg.energy.gh_factor``),
  injected into the frozen configuration with ``dataclasses.replace``, so
  the float becomes a 0-d tensor flowing through the same formulas.
- **Static fields** (``base_albedo``, ``friction``, ``C_s_map``): the
  gradient is a sensitivity map, dJ/d(field[y, x]) for every cell from one
  backward sweep.
- **Initial-state leaves** via ``state.``-prefixed paths
  (``state.ocean.sst``).

The window is a pure function of ``(params, state)``: the ecology's daily
mutation draws its random numbers from a copy of ``model.generator`` taken
when the window is built, all of them before the first step, so every call
and every recomputed segment sees the same draws.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, Optional, Union

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from . import model as M
from .ecology import population as eco_mod

# Friendly names -> dotted paths. Only paths read inside the step are valid
# injection targets (a path used on the host while the model is built would
# not reach the window); these are the audited set, but any dotted path is
# accepted for callers who know their target.
PARAM_ALIASES = {
    # greenhouse lock factor g: OLR=(1-g)sigma Ts^4 (physics/energy.py)
    "gh_factor": "cfg.energy.gh_factor",
    # LW v2 clear-sky emissivity / cloud optical coupling — these two also
    # live in state.energy when autotune evolves them; the cfg path is the
    # fixed-parameter sensitivity
    "lw_eps0": "cfg.energy.lw_eps0",
    "lw_kc": "cfg.energy.lw_kc",
    # bulk exchange / hydrology scalars
    "c_e": "cfg.humidity.C_E",
    "tau_cond": "cfg.humidity.tau_cond",
    # static fields (sensitivity maps)
    "base_albedo": "static.base_albedo",
    "friction": "static.friction",
    "C_s_map": "static.C_s_map",
}


def inject_path(obj, path: str, value):
    """Return a copy of (possibly nested, frozen) dataclass ``obj`` with the
    dotted ``path`` leaf replaced by ``value``."""
    head, _, rest = path.partition(".")
    if not hasattr(obj, head):
        raise AttributeError(f"{type(obj).__name__} has no field {head!r} "
                             f"(while injecting {path!r})")
    if not rest:
        return dataclasses.replace(obj, **{head: value})
    return dataclasses.replace(
        obj, **{head: inject_path(getattr(obj, head), rest, value)})


def _resolve(params: Dict[str, torch.Tensor], model: M.Model, state):
    """Split a params dict into model/state injections and apply them."""
    for name, value in params.items():
        path = PARAM_ALIASES.get(name, name)
        if path.startswith("state."):
            state = inject_path(state, path[len("state."):], value)
        else:
            model = inject_path(model, path, value)
    return model, state


def default_segment(n_steps: int) -> int:
    """Largest divisor of n_steps <= sqrt(n_steps): balances the two-level
    checkpoint memory (n/seg boundary states + seg inner carries)."""
    s = max(1, int(n_steps ** 0.5))
    while n_steps % s:
        s -= 1
    return s


def _map_tensors(fn, obj):
    """``obj`` (a state: nested dataclasses, tuples, host numbers) with
    ``fn`` applied to every tensor."""
    if isinstance(obj, torch.Tensor):
        return fn(obj)
    if dataclasses.is_dataclass(obj):
        return dataclasses.replace(obj, **{f.name: _map_tensors(fn, getattr(obj, f.name))
                                           for f in dataclasses.fields(obj)})
    if isinstance(obj, tuple):
        items = [_map_tensors(fn, x) for x in obj]
        return type(obj)(*items) if hasattr(obj, "_fields") else tuple(items)
    return obj


def _as_param(model: M.Model, value) -> torch.Tensor:
    """A parameter value as a tensor on the model's device; host numbers
    and arrays take the model's dtype."""
    if isinstance(value, torch.Tensor):
        return value.to(device=model.device)
    return torch.as_tensor(np.asarray(value), dtype=model.dtype, device=model.device)


def make_window_fn(model: M.Model, n_steps: int, *,
                   objective: Union[str, Callable] = "Ts_mean",
                   trailing_steps: Optional[int] = None,
                   segment: Optional[int] = None):
    """Build ``window(params, state) -> (J, (final_state, series))``.

    ``params`` maps alias/dotted-path -> value (see PARAM_ALIASES); the
    window injects them, rebuilds the step closure, runs ``n_steps`` steps
    with two-level checkpointing (when grad is enabled), and reduces the
    per-step diagnostic series (each key an ``[n_steps]`` tensor) to the
    scalar objective J.

    ``objective``: a diag key (J = mean of that scalar over the window, or
    over the last ``trailing_steps`` steps), or a callable
    ``series_dict -> scalar``.
    """
    seg = segment or default_segment(n_steps)
    if n_steps % seg:
        raise ValueError(f"segment {seg} must divide n_steps {n_steps}")
    n_seg = n_steps // seg
    # the mutation's random stream as it stands now: every call replays it
    generator_state = model.generator.get_state()

    if callable(objective):
        reduce_fn = objective
    else:
        key = objective

        def reduce_fn(series):
            x = series[key]
            if trailing_steps is not None:
                x = x[-trailing_steps:]
            return torch.mean(x)

    def window(params: Dict[str, torch.Tensor], state):
        mdl, st = _resolve(params, model, state)
        step = M.make_step_fn(mdl)
        gen = torch.Generator(device=mdl.device)
        gen.set_state(generator_state)
        draws = [eco_mod.mutation_draws(mdl.eco_static, st.eco, gen) if due else None
                 for due in M.mutation_schedule(mdl, st.clock, n_steps)]

        def seg_fn(s, seg_draws):
            rows = []
            for d in seg_draws:
                s, diag = step(s, d)
                rows.append(diag)
            return s, {k: torch.stack([r[k] for r in rows]) for k in rows[0]}

        parts = []
        for i in range(n_seg):
            seg_draws = draws[i * seg:(i + 1) * seg]
            if torch.is_grad_enabled():
                # the step draws nothing from the default generators: the
                # mutation's draws are passed in
                st, rows = checkpoint(seg_fn, st, seg_draws, use_reentrant=False,
                                      preserve_rng_state=False)
            else:
                st, rows = seg_fn(st, seg_draws)
            parts.append(rows)
        series = {k: torch.cat([p[k] for p in parts]) for k in parts[0]}
        return reduce_fn(series), (st, series)

    return window


def make_value_and_grad(model: M.Model, n_steps: int, **window_kw):
    """``(params, state) -> ((J, (final_state, series)), grads)``: one
    forward and one backward sweep; ``grads`` maps each param name to a
    tensor of its value's shape (zero where J does not depend on it)."""
    win = make_window_fn(model, n_steps, **window_kw)

    def call(params, state):
        leaves = {k: _as_param(model, v).detach().requires_grad_(True)
                  for k, v in params.items()}
        with torch.enable_grad():
            J, (st, series) = win(leaves, state)
            got = (torch.autograd.grad(J, list(leaves.values()), allow_unused=True)
                   if J.requires_grad else [None] * len(leaves))
        grads = {k: torch.zeros_like(x) if g is None else g
                 for (k, x), g in zip(leaves.items(), got)}
        aux = (_map_tensors(torch.Tensor.detach, st),
               {k: v.detach() for k, v in series.items()})
        return (J.detach(), aux), grads

    return call


def make_value(model: M.Model, n_steps: int, **window_kw):
    """Forward-only window: the same steps as the gradient's forward, with
    autograd off."""
    win = make_window_fn(model, n_steps, **window_kw)

    def call(params, state):
        with torch.no_grad():
            return win({k: _as_param(model, v) for k, v in params.items()}, state)

    return call


def calibrate(model: M.Model, state, param: str, x0: float, *,
              n_steps: int, target: float, objective: str = "Ts_mean",
              trailing_steps: Optional[int] = None, iters: int = 8,
              tol: float = 1e-3, verbose: bool = True):
    """Newton-calibrate one scalar parameter so the window objective hits
    ``target``: x_{k+1} = x_k - (J(x_k) - target) / (dJ/dx).

    One forward+backward sweep per iteration. Returns (x, history list of
    (x, J, dJdx))."""
    vg = make_value_and_grad(model, n_steps, objective=objective,
                             trailing_steps=trailing_steps)
    x = float(x0)
    history = []
    for k in range(iters):
        (J, _), g = vg({param: x}, state)
        J = float(J)
        dJdx = float(g[param])
        history.append((x, J, dJdx))
        if verbose:
            print(f"[calibrate] iter {k}: {param}={x:.6f} "
                  f"J={J:.6f} dJ/dx={dJdx:.6f}")
        if abs(J - target) < tol:
            break
        if dJdx == 0.0:
            raise RuntimeError(f"zero gradient at {param}={x}")
        x = x - (J - target) / dJdx
    return x, history


def calibrate_joint(model: M.Model, state, priors: Dict[str, float],
                    truth: Dict[str, float], *, n_steps: int,
                    obs_keys=("Ts_mean", "OLR_mean", "E_mean"),
                    iters: int = 40, lr: float = 0.05,
                    segment: Optional[int] = None, verbose: bool = True):
    """Recover several scalar physics parameters at once by Adam descent on
    a trajectory-mismatch objective through the coupled model.

    A synthetic truth runs the same window with the (withheld) ``truth``
    parameter values; the objective is the normalized squared mismatch of
    several diagnostic series — each parameter imprints on a different
    combination of series (gh_factor on OLR/Ts, C_E on E, tau_cond on the
    precip/CWV balance), which makes the joint problem identifiable where a
    single Ts_mean target is not.

    Parameters are optimized in log-space (p = prior·exp(z)) by
    ``torch.optim.Adam``, whose update is ``optax.adam``'s (b1 0.9, b2
    0.999, eps 1e-8 outside the square root, bias-corrected). One
    forward+backward sweep per iteration.

    Returns ``(recovered: dict, history)`` where history rows are
    ``(iter, {param: value}, J)``: the best-so-far parameters, and the
    descent stops at a non-finite gradient.
    """
    keys = tuple(priors)
    probe = make_value(model, n_steps, objective=(lambda s: torch.zeros(())),
                       segment=segment)
    _, (_, truth_series) = probe(dict(truth), state)
    truth_series = {k: truth_series[k].cpu().numpy() for k in obs_keys}
    # per-series normalization: mismatch in units of the truth's own
    # variability (floored at 1e-3 of its mean magnitude so a flat series
    # cannot blow the objective up)
    norm = {k: float(max(np.std(truth_series[k]),
                         1e-3 * max(1e-30, np.abs(truth_series[k]).mean())))
            for k in obs_keys}
    truth_t = {k: torch.as_tensor(v, device=model.device) for k, v in truth_series.items()}

    def objective(series):
        J = torch.zeros((), dtype=model.dtype, device=model.device)
        for k in obs_keys:
            d = (series[k] - truth_t[k]) / norm[k]
            J = J + torch.mean(d * d)
        return J / len(obs_keys)

    vg = make_value_and_grad(model, n_steps, objective=objective,
                             segment=segment)
    z = {k: torch.zeros((), dtype=model.dtype, device=model.device, requires_grad=True)
         for k in keys}
    opt = torch.optim.Adam(list(z.values()), lr=lr, betas=(0.9, 0.999), eps=1e-8)
    history = []
    best = (math.inf, dict(priors))
    for it in range(iters):
        params = {k: priors[k] * torch.exp(z[k].detach()) for k in keys}
        (J, _), g = vg(params, state)
        J = float(J)
        vals = {k: float(params[k]) for k in keys}
        history.append((it, vals, J))
        if J < best[0]:
            best = (J, vals)
        if verbose:
            print(f"[calibrate_joint] iter {it}: J={J:.6f} " +
                  " ".join(f"{k}={vals[k]:.6g}" for k in keys), flush=True)
        # chain rule to log-space: dJ/dz = dJ/dp · p
        gz = {k: g[k] * params[k] for k in keys}
        if not all(math.isfinite(float(gz[k])) for k in keys):
            if verbose:
                print("[calibrate_joint] non-finite gradient; stopping at "
                      "best-so-far", flush=True)
            break
        for k in keys:
            z[k].grad = gz[k].to(z[k].dtype)
        opt.step()
    return best[1], history
