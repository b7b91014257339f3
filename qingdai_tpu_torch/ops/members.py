"""What the kernels' ``torch.autograd.Function``s share: the dispatch rules
around a kernel, its gradient and its member axis under ``torch.func.vmap``.

Each of K1–K4 is dispatched by device: a CPU tensor goes to the plain
version directly (``torch.func.vmap`` batches its ops, and autograd runs
through them), a CUDA tensor to one Function whose ``forward`` launches the
kernel. Its ``backward`` is ``plain_vjp``: the plain version recomputed from
the saved inputs, and its vector-Jacobian product, which is the gradient
the JAX package takes (its Pallas kernels have no VJP, so its adjoint
differentiates the plain forms). The Function's ``vmap`` staticmethod
receives an ensemble's batched tensors with their ``in_dims`` and calls the
kernel's batched form, one launch for every member; the batched forms have
no backward, so a batched input that requires grad raises
(``refuse_grad``).
"""

from __future__ import annotations

import torch


def refuse_grad(name: str, *tensors) -> None:
    """Raise for a batched input that requires grad: the kernel's batched
    form has no backward."""
    if any(isinstance(t, torch.Tensor) and t.requires_grad for t in tensors):
        raise RuntimeError(f"{name}: the batched kernel has no backward; differentiate the "
                           "single planet, or run the ensemble on CPU tensors")


def plain_vjp(plain_fn, inputs, grad_outputs, needs_input_grad):
    """The gradients of ``plain_fn(*inputs)`` against ``grad_outputs``, one
    entry per input: a tensor where ``needs_input_grad`` asks, else None.

    ``plain_fn`` runs again on detached copies of the saved ``inputs``
    under ``torch.enable_grad()``, so a kernel's backward takes the VJP of
    its plain version at the same point."""
    with torch.enable_grad():
        xs = [x.detach().requires_grad_(need) if isinstance(x, torch.Tensor) else x
              for x, need in zip(inputs, needs_input_grad)]
        out = plain_fn(*xs)
        outs = out if isinstance(out, tuple) else (out,)
        pairs = [(o, g) for o, g in zip(outs, grad_outputs)
                 if o.requires_grad and g is not None]
        wrt = [i for i, (x, need) in enumerate(zip(xs, needs_input_grad))
               if need and isinstance(x, torch.Tensor)]
        grads = [None] * len(xs)
        if not pairs or not wrt:
            return tuple(grads)
        got = torch.autograd.grad([o for o, _ in pairs], [xs[i] for i in wrt],
                                  [g for _, g in pairs], allow_unused=True)
    for i, g in zip(wrt, got):
        grads[i] = torch.zeros_like(xs[i]) if g is None else g
    return tuple(grads)


def to_front(t: torch.Tensor, dim) -> torch.Tensor:
    """A batched input with its member axis first, contiguous; an unbatched
    one (``dim`` None) as it is, contiguous, for every member to share."""
    return (t if dim is None else t.movedim(dim, 0)).contiguous()


def members_first(t: torch.Tensor, dim) -> torch.Tensor:
    """``to_front`` without its copy where each member's block is already
    contiguous, as in a slice of a larger stack (the chlorophyll planes of
    K4's [SST + tracers] output, 1 GB a step at 400 members): a batched
    form reads members at any member stride (``kernels.member_stride``)."""
    if dim is None:
        return t.contiguous()
    t = t.movedim(dim, 0)
    return t if t[0].is_contiguous() else t.contiguous()
