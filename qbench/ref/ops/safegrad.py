"""Singular-point-safe gradients (port of ``qingdai_tpu/ops/safegrad.py``).

Each function's forward value is the plain expression; only the derivative
changes: at the singular point it is the zero subgradient instead of inf or
NaN, or (``tanh_abs_ramp``) the JAX package's subgradient where the plain
expression's autograd takes another. The JAX package writes the first
three as custom JVPs; here every rule is the backward pass of a
``torch.autograd.Function``. Their forward passes are
plain expressions, so ``torch.func.vmap`` batches them by its generated rule
(an ensemble's step runs them over the members).
"""

from __future__ import annotations

import torch


def _tiny(x: torch.Tensor) -> float:
    return torch.finfo(x.dtype).tiny


class _QuarticRoot(torch.autograd.Function):
    generate_vmap_rule = True

    @staticmethod
    def forward(x):
        return x ** 0.25

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_backward(inputs[0], output)

    @staticmethod
    def backward(ctx, g):
        x, y = ctx.saved_tensors
        # min-normal gate: bounds y/x by tiny^-0.75
        pos = x >= _tiny(x)
        dydx = torch.where(pos, 0.25 * y / torch.where(pos, x, 1.0), 0.0)
        return g * dydx


class _Speed(torch.autograd.Function):
    generate_vmap_rule = True

    @staticmethod
    def forward(u, v):
        return torch.sqrt(u * u + v * v)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_backward(*inputs, output)

    @staticmethod
    def backward(ctx, g):
        u, v, s = ctx.saved_tensors
        pos = s > 0.0
        ss = torch.where(pos, s, 1.0)
        # direction cosines are bounded by 1, so this cannot overflow
        return (g * torch.where(pos, u / ss, 0.0),
                g * torch.where(pos, v / ss, 0.0))


class _PowSafe(torch.autograd.Function):
    generate_vmap_rule = True

    @staticmethod
    def forward(x, p):
        return torch.pow(x, p)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_backward(*inputs, output)

    @staticmethod
    def backward(ctx, g):
        x, p, y = ctx.saved_tensors
        # gate on the min normal, not 0: x**(p-1) of a denormal overflows
        pos = x >= _tiny(x)
        xs = torch.where(pos, x, 1.0)
        dx = g * torch.where(pos, p * y / xs, 0.0)
        dp = g * torch.where(pos, y * torch.log(xs), 0.0)
        if dp.shape != p.shape:
            dp = dp.sum_to_size(p.shape)
        return dx, dp


class _TanhAbsRamp(torch.autograd.Function):
    generate_vmap_rule = True

    @staticmethod
    def forward(x, scale):
        return torch.clamp(torch.tanh(torch.abs(x) / scale), 0.0, 1.0)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_backward(inputs[0], output)
        ctx.scale = inputs[1]

    @staticmethod
    def backward(ctx, g):
        x, y = ctx.saved_tensors
        # jnp.abs' is +1 at 0 and jnp.clip' is ½ at a bound (here y == 0 at
        # x == 0, or y == 1 where tanh saturates)
        sign = torch.where(x >= 0.0, 1.0, -1.0)
        tie = torch.where((y <= 0.0) | (y >= 1.0), 0.5, 1.0)
        return g * tie * (1.0 - y * y) / ctx.scale * sign, None


def quartic_root(x: torch.Tensor) -> torch.Tensor:
    """x**0.25 with a zero subgradient at x == 0 (instead of +inf)."""
    return _QuarticRoot.apply(x)


def speed(u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """sqrt(u² + v²) with a zero subgradient at u == v == 0 (not 0/0)."""
    return _Speed.apply(u, v)


def tanh_abs_ramp(x: torch.Tensor, scale: float) -> torch.Tensor:
    """clip(tanh(|x| / scale), 0, 1) with the JAX package's derivative at
    x == 0, where the plain expression's autograd gives 0: |x|' = +1 and
    the clip's ½ at its bound."""
    return _TanhAbsRamp.apply(x, scale)


def pow_safe(x: torch.Tensor, p) -> torch.Tensor:
    """x**p (x ≥ 0) with zero subgradients at x == 0 for both x and p."""
    # a fill, not a copy from the host: the step never waits on the card
    p = (p.to(dtype=x.dtype, device=x.device) if isinstance(p, torch.Tensor)
         else torch.full((), p, dtype=x.dtype, device=x.device))
    return _PowSafe.apply(x, p)
