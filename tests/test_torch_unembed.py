"""The unembed (models/layers.py::unembed): fp32 logits from the head as
stored, untied (``head``, (d, V)) or tied (``embed.T``, a (V, d) table seen
transposed).

On the CPU, for fp32 weights and under autograd, the logits (and the
gradients) are bit-identical to ``x.float() @ w.float()``; the dry-run's
analyzer sees the unembed under its kernel mark, reading the head as stored;
and the kernel's wrapper (kernels/unembed.py) raises on CPU tensors and on
layouts TMA cannot read. The cases marked ``gpu`` hold the bf16 path on the card (the kernel:
bf16 products on the tensor cores, summed in fp32) at the widths of
Qwen2.5-7B and Qwen3-MoE-235B-A22B, against an fp64 product of the same bf16
values:

    PYTHONPATH=src python -m pytest -q -s --noconftest -m gpu tests/test_torch_unembed.py
"""

import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import unembed as ue  # noqa: E402
from repro_torch.kernels.ref import unembed_ref  # noqa: E402
from repro_torch.models.layers import unembed  # noqa: E402

DTYPES = {"bf16": torch.bfloat16, "fp32": torch.float32}


def _weights(d, vocab, tied, dtype, device, gen):
    """(embed, head, w): the tied case has no head and unembeds by embed.T."""
    embed = (torch.randn(vocab, d, generator=gen, device=device) * 0.02).to(dtype)
    if tied:
        return embed, None, embed.T
    head = (torch.randn(d, vocab, generator=gen, device=device) * d ** -0.5).to(dtype)
    return embed, head, head


@pytest.mark.parametrize("shape", [(5,), (3, 4)], ids=["rows", "batch-seq"])
@pytest.mark.parametrize("tied", [False, True], ids=["untied", "tied"])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_cpu_logits_are_the_fp32_product(dtype, tied, shape):
    gen = torch.Generator().manual_seed(11)
    embed, head, w = _weights(48, 301, tied, DTYPES[dtype], "cpu", gen)
    x = torch.randn(*shape, 48, generator=gen).to(DTYPES[dtype])
    with torch.no_grad():
        got = unembed(x, embed, head)
    assert got.dtype == torch.float32 and got.shape == (*shape, 301)
    assert torch.equal(got, unembed_ref(x, w))


@pytest.mark.parametrize("tied", [False, True], ids=["untied", "tied"])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_autograd_logits_and_gradients_unchanged(dtype, tied):
    """Under autograd the unembed is today's fp32 product: the same logits,
    and the same gradients into x and the weights, in their own dtypes."""
    gen = torch.Generator().manual_seed(12)
    embed, head, _ = _weights(40, 257, tied, DTYPES[dtype], "cpu", gen)
    x = torch.randn(6, 40, generator=gen).to(DTYPES[dtype])
    cot = torch.randn(6, 257, generator=gen)

    def run(fn):
        xx, ee = (t.detach().clone().requires_grad_() for t in (x, embed))
        hh = None if tied else head.detach().clone().requires_grad_()
        logits = fn(xx, ee, hh)
        logits.backward(cot)
        return logits.detach(), [xx.grad, ee.grad if tied else hh.grad]

    got, got_grads = run(unembed)
    want, want_grads = run(lambda xx, ee, hh: unembed_ref(xx, ee.T if hh is None else hh))
    assert torch.equal(got, want)
    for g, r in zip(got_grads, want_grads):
        assert g.dtype == DTYPES[dtype] and torch.equal(g, r)


@pytest.mark.parametrize("case,want", [
    ("untied", 0), ("tied", 1), ("untied-N-odd", -1), ("tied-K-odd", -1),
    ("column-slice", -1)])
def test_kernel_layouts(case, want):
    """An N-contiguous head and a K-contiguous transposed table, each with
    16-byte aligned rows; the kernel refuses anything else."""
    w = {"untied": torch.zeros(64, 96), "tied": torch.zeros(96, 64).T,
         "untied-N-odd": torch.zeros(64, 97), "tied-K-odd": torch.zeros(97, 60).T,
         "column-slice": torch.zeros(64, 192)[:, ::2]}[case]
    assert ue._w_kmajor(w) == want


def test_kernel_wrapper_refuses_cpu_tensors():
    x, w = torch.zeros(4, 64, dtype=torch.bfloat16), torch.zeros(64, 96, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="CUDA"):
        ue.unembed_cuda(x, w)


@pytest.mark.parametrize("shape", [(5,), (3, 4)], ids=["rows", "batch-seq"])
@pytest.mark.parametrize("tied", [False, True], ids=["untied", "tied"])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_analyzer_reads_the_head_as_stored(dtype, tied, shape):
    """Traced on fake tensors, the unembed runs under ``fusedkernel_unembed``
    (kernels/ops.py): the analyzer counts its FLOPs and, as bytes, x and the
    head in their own dtype, and no fp32 copy of the head."""
    from repro_torch.launch import graph_analysis as G

    d, vocab = 48, 304
    gen = torch.Generator().manual_seed(13)
    embed, head, _ = _weights(d, vocab, tied, DTYPES[dtype], "cpu", gen)
    x = torch.randn(*shape, d, generator=gen).to(DTYPES[dtype])
    if tied:
        gm = G.trace(lambda xx, ee: unembed(xx, ee, None), x, embed)
    else:
        gm = G.trace(lambda xx, ee, hh: unembed(xx, ee, hh), x, embed, head)
    assert any(n.op == "call_function" and n.args[:1] == ("fusedkernel_unembed",)
               for n in gm.graph.nodes)
    st = G.analyze(gm)
    rows, size = x.numel() // d, DTYPES[dtype].itemsize
    assert st.flops == 2 * rows * d * vocab
    assert st.hbm_bytes == size * (rows * d + d * vocab)


@pytest.mark.parametrize("tied", [False, True], ids=["untied", "tied"])
def test_ops_unembed_on_the_cpu_is_the_fp32_product(tied):
    """kernels/ops.py's entry point, as the CPU and an fp32 head take it."""
    gen = torch.Generator().manual_seed(14)
    for dtype in DTYPES.values():
        _, _, w = _weights(32, 72, tied, dtype, "cpu", gen)
        x = torch.randn(2, 3, 32, generator=gen).to(dtype)
        assert torch.equal(ops.unembed(x, w), unembed_ref(x, w))


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

WIDTHS = {"qwen25-7b": (3584, 152064), "qwen3-moe": (4096, 151936)}


def _cuda():
    """The CUDA device, or skip: decided inside the test, never at import."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run with -m gpu on the GPU)")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("tied", [False, True], ids=["untied", "tied"])
@pytest.mark.parametrize("widths", list(WIDTHS))
@pytest.mark.parametrize("m", [8, 128, 512])
def test_bf16_unembed_on_the_card(m, widths, tied):
    """The bf16 path (the kernel) against an fp64 product of the same bf16
    values: its largest error at most twice the fp32 path's, a second call
    bit-identical, and no fp32 copy of the head allocated."""
    dev = _cuda()
    d, vocab = WIDTHS[widths]
    gen = torch.Generator(device=dev).manual_seed(1000 * m + d + tied)
    embed, head, w = _weights(d, vocab, tied, torch.bfloat16, dev, gen)
    x = torch.randn(m, d, generator=gen, device=dev).to(torch.bfloat16)
    launches = ue.unembed_cuda.launches
    with torch.no_grad():
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        got = unembed(x, embed, head)
        torch.cuda.synchronize()
        extra = torch.cuda.max_memory_allocated() - base
        again = unembed(x, embed, head)
        old = unembed_ref(x, w)
        exact = x.double() @ w.double()
    err_new = (got.double() - exact).abs().max().item()
    err_old = (old.double() - exact).abs().max().item()
    print(f"unembed M={m} d={d} V={vocab} {'tied' if tied else 'untied'}: "
          f"max|err| bf16 path {err_new:.3e}, fp32 path {err_old:.3e}, "
          f"peak extra {extra / 2**20:.1f} MiB")
    assert ue.unembed_cuda.launches == launches + 2
    assert got.dtype == torch.float32 and got.shape == (m, vocab)
    assert err_new <= 2 * err_old
    assert torch.equal(got, again)
    assert extra < w.numel() * 4


@pytest.mark.gpu
@pytest.mark.parametrize("m,d,vocab,tied", [
    (1, 64, 128, False), (65, 200, 1000, False), (130, 136, 1001, True), (300, 520, 776, True)],
    ids=["one-row", "ragged-untied", "odd-vocab-tied", "ragged-tied"])
def test_unembed_kernel_edge_shapes(m, d, vocab, tied):
    """Rows past M, columns past N and K past its last 64 (zeros from TMA,
    masked stores), and an odd vocabulary: the kernel against the fp32
    product, within fp32 rounding of sums of at most 520 terms."""
    dev = _cuda()
    gen = torch.Generator(device=dev).manual_seed(m + d + vocab)
    embed, head, w = _weights(d, vocab, tied, torch.bfloat16, dev, gen)
    x = torch.randn(m, d, generator=gen, device=dev).to(torch.bfloat16)
    got = ue.unembed_cuda(x, w)
    torch.testing.assert_close(got, unembed_ref(x, w), rtol=1e-5, atol=1e-5)


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["odd-vocab-untied", "fp16"])
def test_bf16_unembed_raises_where_the_kernel_refuses(case):
    """A head on the card that the kernel does not take raises: an untied
    head whose rows TMA cannot read (N % 8 != 0), and a dtype that is neither
    bf16 nor the fp32 of an fp32 configuration. Nothing falls back to the
    fp32 product."""
    dev = _cuda()
    gen = torch.Generator(device=dev).manual_seed(15)
    vocab, dtype = {"odd-vocab-untied": (1001, torch.bfloat16),
                    "fp16": (1000, torch.float16)}[case]
    embed, head, _ = _weights(64, vocab, False, dtype, dev, gen)
    x = torch.randn(4, 64, generator=gen, device=dev).to(dtype)
    launches = ue.unembed_cuda.launches
    with torch.no_grad(), pytest.raises(ValueError, match="unembed"):
        unembed(x, embed, head)
    assert ue.unembed_cuda.launches == launches


@pytest.mark.gpu
def test_bf16_unembed_takes_strided_rows_and_autograd_on_the_card():
    """A non-contiguous x (a strided slice of rows) goes to the kernel as
    contiguous rows; under autograd the unembed is the fp32 product, with
    its gradients, and launches no kernel."""
    dev = _cuda()
    gen = torch.Generator(device=dev).manual_seed(16)
    embed, head, w = _weights(256, 1024, False, torch.bfloat16, dev, gen)
    h = torch.randn(6, 2, 256, generator=gen, device=dev).to(torch.bfloat16)
    x = h[:, 1]                                        # (6, 256), row stride 512
    assert not x.is_contiguous()
    launches = ue.unembed_cuda.launches
    with torch.no_grad():
        got = unembed(x, embed, head)
    assert ue.unembed_cuda.launches == launches + 1
    assert torch.equal(got, ue.unembed_cuda(x.contiguous(), w))
    torch.testing.assert_close(got, unembed_ref(x, w), rtol=1e-5, atol=1e-5)

    xx = x.detach().clone().requires_grad_()
    hh = head.detach().clone().requires_grad_()
    logits = unembed(xx, embed, hh)
    assert ue.unembed_cuda.launches == launches + 2
    assert torch.equal(logits, unembed_ref(x, w))
    cot = torch.randn(logits.shape, generator=gen, device=dev)
    logits.backward(cot)
    xr, hr = x.detach().clone().requires_grad_(), head.detach().clone().requires_grad_()
    unembed_ref(xr, hr).backward(cot)
    assert torch.equal(xx.grad, xr.grad) and torch.equal(hh.grad, hr.grad)
