"""Kernel-region scoping that survives autodiff: the port of
``repro/common/scopes.py``.

A region is marked with ``torch.profiler.record_function(name)``, which a
``make_fx`` trace records as ``profiler._record_function_enter_new`` /
``_record_function_exit`` nodes around the region's ops
(``launch/graph_analysis.py`` reads them). Autograd runs a backward outside
any such mark, so :func:`scoped_kernel_vjp` wraps a region in a
``torch.autograd.Function`` whose backward recomputes the region under
``scope + "_bwd"`` and returns autograd's gradient through it: a forward
kernel plus a recompute-based backward kernel, as a fused attention or SSD
backward does. Nothing is kept between the passes but the inputs.

The marks are entered only while a trace (:func:`tracing`) records;
otherwise :func:`scope` is a no-op. The profiler does not enter them: it
reports a mark as a device range of its own, which would count each marked
kernel twice in a profile's busy time and launch count.
"""

from __future__ import annotations

import contextlib
import functools
from typing import Callable

import torch

_TRACING = 0


@contextlib.contextmanager
def tracing():
    """Enter the kernel marks while the body runs (a ``make_fx`` trace)."""
    global _TRACING
    _TRACING += 1
    try:
        yield
    finally:
        _TRACING -= 1


def is_tracing() -> bool:
    """Whether a :func:`tracing` body is running."""
    return _TRACING > 0


def scope(name: str):
    """``record_function(name)`` while a trace records."""
    if _TRACING:
        return torch.profiler.record_function(name)
    return contextlib.nullcontext()


def kernel_region(name: str) -> Callable:
    """Decorator: the function runs under :func:`scope` ``name``."""
    def deco(fn):
        @functools.wraps(fn)
        def wrapped(*args, **kwargs):
            with scope(name):
                return fn(*args, **kwargs)
        return wrapped
    return deco


def _as_tuple(out):
    return out if isinstance(out, tuple) else (out,)


class _Scoped(torch.autograd.Function):

    @staticmethod
    def forward(ctx, name: str, fn: Callable, *args):
        ctx.name, ctx.fn = name, fn
        ctx.save_for_backward(*args)
        with scope(name):
            out = fn(*args)
        ctx.mark_non_differentiable(*(o for o in _as_tuple(out) if not o.is_floating_point()))
        return out

    @staticmethod
    def backward(ctx, *grads):
        needs = ctx.needs_input_grad[2:]
        with torch.enable_grad(), scope(ctx.name + "_bwd"):
            inputs = [a.detach().requires_grad_(n) for a, n in zip(ctx.saved_tensors, needs)]
            outs = _as_tuple(ctx.fn(*inputs))
            pairs = [(o, g) for o, g in zip(outs, grads) if o.requires_grad and g is not None]
            wrt = [i for i in inputs if i.requires_grad]
            got = iter(torch.autograd.grad([o for o, _ in pairs], wrt, [g for _, g in pairs],
                                           allow_unused=True) if pairs and wrt else ())
        return (None, None) + tuple(next(got, None) if n else None for n in needs)


def scoped_kernel_vjp(name: str, fn: Callable) -> Callable:
    """Wrap ``fn(*tensors) -> tensor or tuple of tensors`` so both passes
    carry ``name``; the backward recomputes the forward (checkpoint
    semantics)."""
    return lambda *args: _Scoped.apply(name, fn, *args)
