"""RMSNorm and RoPE (models/layers.py::rms_norm, models/rope.py::apply_rope),
each one pass on the card through kernels/ops.py.

On the CPU both are the formulas the models have always written, bit for
bit, for bf16 and fp32 x, contiguous and strided (the MLA's ``q[..., n:]``,
``kv[..., :R]`` and ``kv[..., None, R:]``); under autograd they are those
formulas, with their gradients; the kernels' wrappers refuse CPU tensors;
and the dry-run's analyzer sees each under its kernel mark. The cases
marked ``gpu`` hold the kernels on the card at the served widths against the
plain versions there and against an fp64 computation from the same inputs:

    PYTHONPATH=src python -m pytest -q --noconftest -m gpu tests/test_torch_norm_rope.py
"""

import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import _build, ops, ref  # noqa: E402
from repro_torch.kernels import rms_norm as rn  # noqa: E402
from repro_torch.kernels import rope as rp  # noqa: E402
from repro_torch.models.layers import rms_norm  # noqa: E402
from repro_torch.models.rope import apply_rope, rope_angles  # noqa: E402

DTYPES = {"bf16": torch.bfloat16, "fp32": torch.float32}
EPS = 1e-6


def _norm_formula(x, scale, eps):
    """The models' RMSNorm as written before the kernel."""
    x32 = x.to(torch.float32)
    var = torch.mean(torch.square(x32), dim=-1, keepdim=True)
    out = x32 * torch.rsqrt(var + eps) * (1.0 + scale.to(torch.float32))
    return out.to(x.dtype)


def _rope_formula(x, angles):
    """The models' RoPE as written before the kernel."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half].to(torch.float32), x[..., half:].to(torch.float32)
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(x.dtype)


# views the models normalise: a residual (B, S, d), q_norm's heads, the MLA's
# latents (kv[..., :R] has row stride R + r)
def _norm_input(view, dtype, gen, device="cpu"):
    base = {"residual": (2, 5, 48), "heads": (2, 5, 3, 16), "kv-latent": (2, 5, 40)}[view]
    t = (torch.randn(base, generator=gen, device=device) * 3).to(dtype)
    return t[..., :32] if view == "kv-latent" else t


# views the models rotate: q (B, S, H, hd), the MLA's q[..., n:] and
# kv[..., None, R:]
def _rope_input(view, dtype, gen, device="cpu"):
    if view == "q":
        return torch.randn(2, 5, 3, 16, generator=gen, device=device).to(dtype)
    if view == "q-pe":
        return torch.randn(2, 5, 3, 24, generator=gen, device=device).to(dtype)[..., 8:]
    return torch.randn(2, 5, 40, generator=gen, device=device).to(dtype)[..., None, 24:]


def _angles(x, theta=1e6, offset=0):
    B, S, _, hd = x.shape
    pos = (torch.arange(S, device=x.device) + offset)[None].expand(B, S)
    return rope_angles(pos, hd, theta)


@pytest.mark.parametrize("view", ["residual", "heads", "kv-latent"])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_cpu_rms_norm_is_the_formula(dtype, view):
    gen = torch.Generator().manual_seed(1)
    x = _norm_input(view, DTYPES[dtype], gen)
    scale = (torch.randn(x.shape[-1], generator=gen) * 0.1).to(DTYPES[dtype])
    want = _norm_formula(x, scale, EPS)
    for got in (rms_norm(x, scale, EPS), ops.rms_norm(x, scale, EPS),
                ref.rms_norm_ref(x, scale, EPS)):
        assert got.dtype == x.dtype and torch.equal(got, want)


def test_cpu_rms_norm_of_fp32_x_over_a_bf16_scale_is_the_formula():
    """fp32 activations normed by a bf16 scale (a witness over bf16 weights)
    keep the formula's mixed dtypes: the result is fp32."""
    gen = torch.Generator().manual_seed(4)
    x = torch.randn(2, 5, 48, generator=gen)
    scale = (torch.randn(48, generator=gen) * 0.1).to(torch.bfloat16)
    got = rms_norm(x, scale, EPS)
    assert got.dtype == torch.float32 and torch.equal(got, _norm_formula(x, scale, EPS))


@pytest.mark.parametrize("view", ["q", "q-pe", "k-pe"])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_cpu_rope_is_the_formula(dtype, view):
    gen = torch.Generator().manual_seed(2)
    x = _rope_input(view, DTYPES[dtype], gen)
    angles = _angles(x, offset=2000)
    want = _rope_formula(x, angles)
    for got in (apply_rope(x, angles), ops.rope(x, angles), ref.rope_ref(x, angles)):
        assert got.dtype == x.dtype and torch.equal(got, want)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_autograd_takes_the_formulas_with_their_gradients(dtype):
    """Under autograd the norm and the rotation are the formulas, and the
    gradients into x and the scale are theirs."""
    gen = torch.Generator().manual_seed(3)
    x = torch.randn(2, 5, 3, 16, generator=gen).to(DTYPES[dtype])
    scale = (torch.randn(16, generator=gen) * 0.1).to(DTYPES[dtype])
    angles = _angles(x)
    cot = torch.randn(x.shape, generator=gen).to(DTYPES[dtype])

    def run(norm, rot):
        xx, ss = (t.detach().clone().requires_grad_() for t in (x, scale))
        y = rot(norm(xx, ss, EPS), angles)
        y.backward(cot)
        return y.detach(), xx.grad, ss.grad

    got = run(rms_norm, apply_rope)
    want = run(_norm_formula, _rope_formula)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)


def test_kernel_wrappers_refuse_cpu_tensors():
    x = torch.zeros(2, 5, 3, 16, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="CUDA"):
        rn.rms_norm_cuda(x, torch.zeros(16, dtype=torch.bfloat16), EPS)
    with pytest.raises(ValueError, match="CUDA"):
        rp.rope_cuda(x, torch.zeros(2, 5, 8))


@pytest.mark.parametrize("shape,strides,want", [
    ((6, 48), (48, 1), 48), ((48,), (1,), 48), ((2, 5, 32), (200, 40, 1), 40),
    ((2, 5, 3, 16), (240, 48, 16, 1), 16), ((1, 5, 32), (999, 40, 1), 40),
    ((2, 5, 32), (400, 64, 1), -1), ((5, 2, 32), (32, 160, 1), -1)],
    ids=["rows", "one-row", "kv-latent", "heads", "unit-batch", "gapped", "transposed"])
def test_norm_rows_flatten_to_one_stride(shape, strides, want):
    """The norm kernel takes rows at one stride: leading dimensions of size
    1 are ignored, the others must flatten."""
    assert rn.row_stride(shape, strides) == want


def test_kernel_sources_are_built_by_the_harness():
    assert {"rms_norm", "rope"} <= set(_build.KERNEL_SOURCES)
    for name in ("rms_norm", "rope"):
        assert (_build.CSRC / f"{name}.cu").exists()


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_analyzer_reads_each_pass_under_its_mark(dtype):
    """Traced on fake tensors, the norm and the rotation run under
    ``fusedkernel_rms_norm`` and ``fusedkernel_rope``: the analyzer counts
    the tensors that cross into each region and none of the fp32
    temporaries inside. A tensor crosses once for each op inside that reads
    it: into the norm the scale once and x once where the cast reads it
    (bf16; fp32 x has no cast, so the square and the product read it);
    into the rotation x twice (the two halves' slices, as many bytes as the
    kernel's one read and one write) and the angles twice (cos and sin)."""
    from repro_torch.launch import graph_analysis as G

    dt = DTYPES[dtype]
    x = torch.randn(2, 5, 3, 16).to(dt)
    scale = torch.zeros(16, dtype=dt)
    angles = _angles(x)
    size = dt.itemsize
    for fn, args, mark, want in (
            (lambda a, s: rms_norm(a, s, EPS), (x, scale), "fusedkernel_rms_norm",
             size * ((1 if dt == torch.bfloat16 else 2) * x.numel() + 16)),
            (apply_rope, (x, angles), "fusedkernel_rope",
             2 * size * x.numel() + 2 * 4 * angles.numel())):
        gm = G.trace(fn, *args)
        assert any(n.op == "call_function" and n.args[:1] == (mark,) for n in gm.graph.nodes)
        st = G.analyze(gm)
        assert st.flops == 0 and st.hbm_bytes == want


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

def _cuda():
    """The CUDA device, or skip: decided inside the test, never at import."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run with -m gpu on the GPU)")
    return torch.device("cuda")


def _ordered(t):
    """Integers in the order of t's values (bf16 or fp32), one apart for
    neighbouring representable values."""
    if t.dtype == torch.bfloat16:
        i = t.view(torch.int16).to(torch.int64)
        return torch.where(i >= 0, i, -32768 - i)
    i = t.view(torch.int32).to(torch.int64)
    return torch.where(i >= 0, i, -(2 ** 31) - i)


def _hold(name, got, again, plain, exact, launched):
    """The card's precision criteria: every element within one rounding
    step of x's dtype of the plain path on the card, at least 99% of them
    bit-identical, the largest error against fp64 at most 1.5x the plain
    path's, a second call bit-identical, one launch a call."""
    steps = (_ordered(got) - _ordered(plain)).abs()
    same = (steps == 0).double().mean().item()
    err = (got.double() - exact).abs().max().item()
    err_plain = (plain.double() - exact).abs().max().item()
    print(f"{name}: bit-identical {100 * same:.4f}%, max steps {steps.max().item()}, "
          f"max|err| vs fp64 kernel {err:.3e} plain {err_plain:.3e}")
    assert launched == 2
    assert torch.equal(got, again)
    assert steps.max().item() <= 1
    assert same >= 0.99
    assert err <= 1.5 * err_plain


# RMSNorm at the served widths: (label, leading shape after the rows,
# row width, stored width): residuals of Qwen2.5 / Qwen3-MoE / Kimi-K2, q
# and k norms over hd 128, Kimi's q latent and its kv latent (kv[..., :512]
# of rows of 576)
NORM_WIDTHS = {"d3584": ((), 3584, 3584), "d4096": ((), 4096, 4096), "d7168": ((), 7168, 7168),
               "hd128x4": ((4,), 128, 128), "hd128x28": ((28,), 128, 128),
               "hd128x64": ((64,), 128, 128), "q-latent1536": ((), 1536, 1536),
               "kv-latent512": ((), 512, 576)}


@pytest.mark.gpu
@pytest.mark.parametrize("m", [8, 512, 16384])
@pytest.mark.parametrize("width", list(NORM_WIDTHS))
def test_rms_norm_on_the_card(width, m):
    dev = _cuda()
    lead, d, stored = NORM_WIDTHS[width]
    gen = torch.Generator(device=dev).manual_seed(m + d + len(lead))
    base = (torch.randn(m, *lead, stored, generator=gen, device=dev) * 2).to(torch.bfloat16)
    x = base[..., :d]
    scale = (torch.randn(d, generator=gen, device=dev) * 0.1).to(torch.bfloat16)
    n0 = rn.rms_norm_cuda.launches
    with torch.no_grad():
        got = rms_norm(x, scale, EPS)
        again = rms_norm(x, scale, EPS)
        plain = ref.rms_norm_ref(x, scale, EPS)
    x64 = x.double()
    exact = x64 * torch.rsqrt((x64 * x64).mean(-1, keepdim=True) + EPS) * (1 + scale.double())
    assert got.shape == x.shape and got.dtype == x.dtype and got.is_contiguous()
    _hold(f"rms_norm {width} M={m}", got, again, plain, exact, rn.rms_norm_cuda.launches - n0)


# RoPE at the served widths: (B, S, H, stored hd, rotated columns from,
# rope theta): Qwen2.5's q and k, Qwen3-MoE's q, Kimi's q_pe (q[..., 128:]
# of heads of 192) and k_pe (kv[..., None, 512:] of rows of 576), Gemma3's
# hd 168, a decode step's 512 rows of Qwen2.5's q, and one narrow head (a
# half of one or two vectors: a block of 64 tokens, CUDA's most in z)
ROPE_WIDTHS = {"qwen25-q": (8, 2048, 28, 128, 0, 1e6), "qwen25-k": (8, 2048, 4, 128, 0, 1e6),
               "qwen3-q": (8, 2048, 64, 128, 0, 1e6), "kimi-q-pe": (8, 2048, 64, 192, 128, 5e4),
               "kimi-k-pe": (8, 2048, None, 576, 512, 5e4),
               "gemma3-hd168": (8, 1024, 32, 168, 0, 1e6),
               "qwen25-q-decode": (512, 1, 28, 128, 0, 1e6),
               "one-head-hd32": (8, 256, 1, 32, 0, 1e4), "one-head-hd8": (4, 300, 1, 8, 0, 1e4)}


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("width", list(ROPE_WIDTHS))
def test_rope_on_the_card(width, dtype):
    dev = _cuda()
    B, S, H, stored, lo, theta = ROPE_WIDTHS[width]
    gen = torch.Generator(device=dev).manual_seed(B + S + stored)
    if H is None:       # kv[..., None, R:]
        x = torch.randn(B, S, stored, generator=gen, device=dev).to(DTYPES[dtype])[..., None, lo:]
    else:
        x = torch.randn(B, S, H, stored, generator=gen, device=dev).to(DTYPES[dtype])[..., lo:]
    # positions up to ~2,300 (the decode rows sit at 300 in a prompt)
    angles = _angles(x, theta, offset=300 if S == 1 else 250)
    n0 = rp.rope_cuda.launches
    with torch.no_grad():
        got = apply_rope(x, angles)
        again = apply_rope(x, angles)
        plain = ref.rope_ref(x, angles)
    half = x.shape[-1] // 2
    x64, a64 = x.double(), angles.double()[:, :, None, :]
    c, s = torch.cos(a64), torch.sin(a64)
    x1, x2 = x64[..., :half], x64[..., half:]
    exact = torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)
    assert got.shape == x.shape and got.dtype == x.dtype and got.is_contiguous()
    _hold(f"rope {width} {dtype}", got, again, plain, exact, rp.rope_cuda.launches - n0)


@pytest.mark.gpu
@pytest.mark.parametrize("scale_dtype", list(DTYPES))
@pytest.mark.parametrize("width", ["d3584", "hd128x28", "kv-latent512"])
def test_fp32_rms_norm_on_the_card(width, scale_dtype):
    """fp32 x (the port serves fp32 configurations too), with an fp32 scale
    or a bf16 one (fp32 activations over bf16 weights): within the fp64
    criterion of the bf16 cases and bit-identical on a second call; the
    kernel's sum of squares runs in another order than the plain path's
    reduction, so in fp32 a row's rsqrt may differ in its last bits."""
    dev = _cuda()
    lead, d, stored = NORM_WIDTHS[width]
    gen = torch.Generator(device=dev).manual_seed(d + 7)
    x = (torch.randn(512, *lead, stored, generator=gen, device=dev) * 2)[..., :d]
    scale = (torch.randn(d, generator=gen, device=dev) * 0.1).to(DTYPES[scale_dtype])
    n0 = rn.rms_norm_cuda.launches
    with torch.no_grad():
        got = rms_norm(x, scale, EPS)
        again = rms_norm(x, scale, EPS)
        plain = ref.rms_norm_ref(x, scale, EPS)
    x64 = x.double()
    exact = x64 * torch.rsqrt((x64 * x64).mean(-1, keepdim=True) + EPS) * (1 + scale.double())
    steps = (_ordered(got) - _ordered(plain)).abs()
    err = (got.double() - exact).abs().max().item()
    err_plain = (plain.double() - exact).abs().max().item()
    print(f"rms_norm fp32 {width}, {scale_dtype} scale: bit-identical {100 * (steps == 0).double().mean().item():.4f}%, "
          f"max steps {steps.max().item()}, max|err| kernel {err:.3e} plain {err_plain:.3e}")
    assert rn.rms_norm_cuda.launches - n0 == 2
    assert torch.equal(got, again)
    assert err <= 1.5 * err_plain


@pytest.mark.gpu
def test_autograd_on_the_card_launches_no_kernel():
    """Under autograd on the card both are the plain versions, with their
    gradients, and neither kernel launches."""
    dev = _cuda()
    gen = torch.Generator(device=dev).manual_seed(5)
    x = torch.randn(2, 64, 4, 128, generator=gen, device=dev)
    scale = torch.randn(128, generator=gen, device=dev) * 0.1
    angles = _angles(x)
    cot = torch.randn(x.shape, generator=gen, device=dev)
    n0 = (rn.rms_norm_cuda.launches, rp.rope_cuda.launches)

    def run(norm, rot):
        xx, ss = (t.detach().clone().requires_grad_() for t in (x, scale))
        y = rot(norm(xx, ss, EPS), angles)
        y.backward(cot)
        return y.detach(), xx.grad, ss.grad

    got = run(rms_norm, apply_rope)
    want = run(ref.rms_norm_ref, ref.rope_ref)
    assert (rn.rms_norm_cuda.launches, rp.rope_cuda.launches) == n0
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["fp16", "columns-strided", "angles-shape"])
def test_kernels_raise_where_they_refuse(case):
    """Inputs the kernels do not take raise on the card; nothing falls back
    to the plain versions."""
    dev = _cuda()
    x = torch.zeros(2, 5, 3, 16, device=dev, dtype=torch.bfloat16)
    angles = torch.zeros(2, 5, 8, device=dev)
    scale = torch.zeros(16, device=dev, dtype=torch.bfloat16)
    if case == "fp16":
        x, scale = x.half(), scale.half()
    elif case == "columns-strided":
        x = torch.zeros(2, 5, 3, 32, device=dev, dtype=torch.bfloat16)[..., ::2]
    else:
        angles = angles[:1]
    n0 = (rn.rms_norm_cuda.launches, rp.rope_cuda.launches)
    with torch.no_grad():
        if case != "angles-shape":
            with pytest.raises(ValueError, match="rms_norm"):
                rms_norm(x, scale, EPS)
        with pytest.raises(ValueError, match="rope"):
            apply_rope(x, angles)
    assert (rn.rms_norm_cuda.launches, rp.rope_cuda.launches) == n0
