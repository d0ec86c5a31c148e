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

The program's spans and counters live here too, and are live exactly while
``torch.profiler`` records (``torch.autograd.profiler._is_profiler_enabled``,
true between a profile's ``start()`` and ``stop()``); nothing else turns
them on. A span (:func:`span`) is a ``record_function`` range at a layer
boundary, so it lies in the profiler's trace on the clock of the device's
kernels and copies, and a kernel belongs to the innermost span around its
launch. Span names are fixed strings (the chrome trace drops a range's
arguments): ``engine.*`` (``serving/engine.py``), ``model.*``
(``models/model_zoo.py``, ``models/layers.py``), ``moe.*``
(``models/moe.py``) and ``head.*``
(``core/predictor.py``, ``kernels/ops.py``). When the profiler is off, a
span is one flag read and the shared no-op context. Counters
(:func:`count`, :func:`count_equal`) add host integers, or keep a tensor the
layer already computed and count its elements when :func:`counters` is
read, after recording: counting launches no kernel and waits for no device
work while the profiler records. The kept tensors are bounded: past
``_HELD_MAX`` bytes, and at the first :func:`count_equal` after recording
ends, they are folded into one count on the device a counter (a few small
kernels, still no wait for the device) and let go.
"""

from __future__ import annotations

import contextlib
import functools
from typing import Callable, Dict, List, Tuple

import torch

_TRACING = 0
_PROFILER = torch.autograd.profiler      # its flag is read at each call
_NULL = contextlib.nullcontext()
_HELD_MAX = 64 << 20        # bytes of kept tensors past which they are folded
_COUNTS: Dict[str, int] = {}
_FOLDED: Dict[str, torch.Tensor] = {}
_PENDING: List[Tuple[str, torch.Tensor, int]] = []
_held = 0


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


def span(name: str):
    """``record_function(name)`` while the profiler records; otherwise one
    shared no-op context (no allocation, no call into the profiler)."""
    if _PROFILER._is_profiler_enabled:
        return torch.profiler.record_function(name)
    return _NULL


def recording() -> bool:
    """Whether the profiler records (when spans and counters are live): a
    counter whose input costs a kernel to make is made only then."""
    return bool(_PROFILER._is_profiler_enabled)


def count(name: str, n: int = 1) -> None:
    """Add the host integer ``n`` to counter ``name`` while the profiler records."""
    if _PROFILER._is_profiler_enabled:
        _COUNTS[name] = _COUNTS.get(name, 0) + n


def count_equal(name: str, t: torch.Tensor, value: int) -> None:
    """While the profiler records, keep ``t``: counter ``name`` gains how many
    of its elements equal ``value``, counted when :func:`counters` is read, or
    on the device once the kept tensors pass ``_HELD_MAX`` bytes, or at the
    first call after recording ends."""
    global _held
    if _PROFILER._is_profiler_enabled:
        _PENDING.append((name, t, value))
        _held += t.numel() * t.element_size()
        if _held > _HELD_MAX:
            _fold()
    elif _PENDING:
        _fold()


def _fold() -> None:
    """Count the kept tensors on the device, one count a counter, and let go."""
    global _held
    for name, t, value in _PENDING:
        n = (t == value).sum()
        _FOLDED[name] = _FOLDED[name] + n if name in _FOLDED else n
    _PENDING.clear()
    _held = 0


def counters() -> Dict[str, int]:
    """Every counter since :func:`reset_counters`, the kept tensors counted
    now. Read it after recording: the counting runs ops and waits for them."""
    _fold()
    for name, n in _FOLDED.items():
        _COUNTS[name] = _COUNTS.get(name, 0) + int(n)
    _FOLDED.clear()
    return dict(_COUNTS)


def reset_counters() -> None:
    global _held
    _COUNTS.clear()
    _FOLDED.clear()
    _PENDING.clear()
    _held = 0


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
