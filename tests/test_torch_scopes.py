"""scoped_kernel_vjp (common/scopes.py): its gradient is plain autograd's,
its backward recomputes under ``scope + "_bwd"`` in a traced graph, and the
kernel marks are entered only while a trace records (the profiler alone
enters none)."""

import pytest

torch = pytest.importorskip("torch")

from repro_torch.common import scopes  # noqa: E402
from repro_torch.launch import graph_analysis as G  # noqa: E402


def _region(x, w, ids):
    return torch.tanh(x @ w) * 2.0, ids + 1


def test_gradient_equals_plain_autograds():
    g = torch.Generator().manual_seed(0)
    x = torch.randn(5, 7, generator=g, dtype=torch.float64, requires_grad=True)
    w = torch.randn(7, 3, generator=g, dtype=torch.float64, requires_grad=True)
    ids = torch.arange(4)
    y, out_ids = scopes.scoped_kernel_vjp("fusedkernel_x", _region)(x, w, ids)
    assert torch.equal(out_ids, ids + 1) and not out_ids.requires_grad
    got = torch.autograd.grad((y * y).sum(), [x, w])
    want = torch.autograd.grad((_region(x, w, ids)[0] ** 2).sum(), [x, w])
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_backward_carries_the_bwd_scope_in_a_trace():
    def step(x, w):
        y, _ = scopes.scoped_kernel_vjp("fusedkernel_x", _region)(x, w, torch.arange(2))
        return torch.autograd.grad(y.sum(), [w])[0]

    gm = G.trace(step, torch.zeros(4, 6), torch.zeros(6, 3, requires_grad=True))
    names = [n.args[0] for n in gm.graph.nodes
             if getattr(n.target, "__name__", "").startswith("_record_function_enter")]
    assert names == ["fusedkernel_x", "fusedkernel_x_bwd"]


def test_marks_only_while_tracing_or_profiling():
    assert isinstance(scopes.scope("fusedkernel_x"), type(scopes.contextlib.nullcontext()))
    with scopes.tracing():
        assert isinstance(scopes.scope("fusedkernel_x"), torch.profiler.record_function)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        assert isinstance(scopes.scope("fusedkernel_x"), type(scopes.contextlib.nullcontext()))
