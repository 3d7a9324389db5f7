"""Gradients for the hand kernels: recompute through the plain version.

Each kernel wrapper that training differentiates (``flash_attention``,
``conv3x3``, ``conv3x3_gn_silu``, ``group_norm``, ``layer_norm``) goes
through a ``torch.autograd.Function`` made here when grad mode is on and an
input requires a gradient; otherwise it calls its kernel directly, so
inference pays nothing for it. The forward is the wrapper's own (the hand
kernel on a CUDA tensor, counted as always; the plain version on a CPU
tensor). The backward re-runs the plain PyTorch version on the saved
inputs under ``torch.enable_grad()`` and hands ``grad_output`` to
``torch.autograd.grad``: the JAX package trains on the XLA form of each op
and lets XLA differentiate it (it has no ``custom_vjp``), so there is no
TPU backward kernel to port. Only the inputs are saved; the plain
attention's (B, N, Sq, Skv) scores exist only inside one call's backward.
A backward launches no hand kernel.
"""

from __future__ import annotations

from typing import Callable

import torch


def needs_grad(*tensors) -> bool:
    """Whether autograd would record a call on ``tensors``."""
    return torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in tensors)


def recompute_function(name: str, kernel: Callable,
                       plain: Callable) -> type:
    """A ``torch.autograd.Function`` named ``name``, called as
    ``Fn.apply(kwargs, *inputs)`` (``inputs`` tensors or None, ``kwargs``
    not differentiated): its forward is ``kernel(*inputs, **kwargs)``, its
    backward autograd of ``plain(*inputs, **kwargs)`` recomputed."""

    def forward(ctx, kwargs, *inputs):
        ctx.kwargs = kwargs
        ctx.save_for_backward(*inputs)
        return kernel(*inputs, **kwargs)

    def backward(ctx, grad_output):
        wanted = ctx.needs_input_grad[1:]
        with torch.enable_grad():
            leaves = [t.detach().requires_grad_(w) if t is not None else None
                      for t, w in zip(ctx.saved_tensors, wanted)]
            out = plain(*leaves, **ctx.kwargs)
        wrt = [t for t, w in zip(leaves, wanted) if t is not None and w]
        grads = iter(torch.autograd.grad(out, wrt, grad_output))
        return (None,) + tuple(next(grads) if t is not None and w else None
                               for t, w in zip(leaves, wanted))

    return type(name, (torch.autograd.Function,), {
        "forward": staticmethod(forward), "backward": staticmethod(backward),
        "__doc__": f"``{kernel.__name__}`` forward; the gradient by autograd "
                   f"of ``{plain.__name__}``, recomputed."})
