"""The one description of a kernel row (``launch/bench_kernels.py``'s
``Case``, its constructors and ``hold``) on the CPU, where each call is the
plain version: ``hold`` passes each constructor's row and raises for planted
faults, each constructor's bytes and operations against arithmetic by hand,
and ``chip_smoke.py``'s kernel lists against ``_build.KERNEL_SOURCES``."""

import ast
import dataclasses
import importlib.util
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import _build  # noqa: E402
from repro_torch.launch import bench_kernels as bk  # noqa: E402
from repro_torch.models.rope import rope_angles  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
BF = torch.bfloat16


def _g(seed=0):
    return torch.Generator().manual_seed(seed)


def _head(Q=3, B=5, d=16, hidden=32, K=8):
    g = _g()
    phi = torch.randn(B, d, generator=g)
    w1 = torch.randn(d, hidden, generator=g) / d ** 0.5
    b1 = torch.randn(hidden, generator=g) * 0.01
    w2 = torch.randn(hidden, K, generator=g) / hidden ** 0.5
    levels = torch.tensor([0.5, 0.9, 0.99][:Q])
    return bk.prod_head(phi, w1, b1, w2, torch.zeros(K), torch.linspace(0, 600, K + 1), levels)


def _flash(dtype=torch.float32, window=0, lens=(24, 9)):
    g = _g(1)
    q = torch.randn(2, 24, 4, 32, generator=g).to(dtype)
    k, v = (torch.randn(2, 24, 2, 32, generator=g).to(dtype) for _ in range(2))
    return bk.flash_attention(q, k, v, window=window,
                              kv_lengths=torch.tensor(lens, dtype=torch.int32))


def _decode(dtype=torch.float32):
    g = _g(2)
    q = torch.randn(3, 4, 64, generator=g).to(dtype)
    k, v = (torch.randn(3, 40, 2, 64, generator=g).to(dtype) for _ in range(2))
    return bk.decode_attention(q, k, v, torch.tensor([40, 7, 1], dtype=torch.int32))


def _scan():
    g = _g(3)
    dt = torch.nn.functional.softplus(torch.randn(2, 20, 2, generator=g))
    return bk.ssd_scan(torch.randn(2, 20, 2, 8, generator=g), dt, -dt,
                       torch.randn(2, 20, 4, generator=g), torch.randn(2, 20, 4, generator=g))


def _unembed(tied=False):
    g = _g(4)
    w = (torch.randn(50, 16, generator=g).to(BF).T if tied
         else torch.randn(16, 50, generator=g).to(BF))
    # cuBLAS's bf16 GEMM with an fp32 output (mm's out_dtype) is a CUDA call
    return dataclasses.replace(bk.unembed(torch.randn(3, 16, generator=g).to(BF), w,
                                          label="tiny"), library=None)


def _norm():
    g = _g(5)
    x = (torch.randn(6, 40, generator=g) * 2).to(BF)[:, :32]
    return bk.rms_norm(x, (torch.randn(32, generator=g) * 0.1).to(BF), 1e-6,
                       shape="6 rows of 32 (stride 40)")


def _rope():
    x = torch.randn(2, 5, 3, 48, generator=_g(6)).to(BF)[..., 16:]
    pos = torch.arange(5)[None].expand(2, 5)
    return bk.rope(x, rope_angles(pos, 32, 1e4), label="tiny")


ROWS = {"prod_head": _head, "flash_attention": _flash, "decode_attention": _decode,
        "ssd_scan": _scan, "unembed": _unembed, "rms_norm": _norm, "rope": _rope}


@pytest.mark.parametrize("name", ROWS)
def test_hold_passes_each_constructor_on_the_cpu(name):
    c = ROWS[name]()
    assert c.kernel == name
    got, want = bk.hold(c)
    assert all(torch.equal(g, w) for g, w in zip(got, want))


def test_hold_compares_the_library_only_where_it_computes_the_function():
    """A 5-key row with a 4-key window leaves query rows with no valid key,
    where the plain version gives the reference's value and SDPA does not."""
    c = _flash(window=4, lens=(24, 5))
    assert c.valid is not None and not bool(c.valid.all())
    bk.hold(c)
    with pytest.raises(RuntimeError, match="library yardstick disagrees"):
        bk.hold(dataclasses.replace(c, valid=None))


def test_hold_raises_for_an_output_off_its_plain_version():
    c = _flash()
    off = lambda: c.plain() + 1e-3
    with pytest.raises(RuntimeError, match="output 0 off its plain version"):
        bk.hold(dataclasses.replace(c, call=off))
    h = _head()
    quants_off = lambda: (h.plain()[0], h.plain()[1] + 0.5)
    with pytest.raises(RuntimeError, match="output 1 off its plain version"):
        bk.hold(dataclasses.replace(h, call=quants_off))


def test_hold_raises_when_a_second_call_differs():
    c = _decode()
    calls = []

    def drifting():
        calls.append(1)
        return c.plain() + 1e-7 * len(calls)      # within the tolerance, not equal

    with pytest.raises(RuntimeError, match="two calls differ"):
        bk.hold(dataclasses.replace(c, call=drifting))


def test_hold_raises_when_the_library_yardstick_disagrees():
    c = _head()
    with pytest.raises(RuntimeError, match="library yardstick disagrees"):
        bk.hold(dataclasses.replace(c, library=lambda: c.library() * 1.01))


def test_hold_raises_for_a_wrong_shape_or_dtype():
    c = _decode()
    with pytest.raises(RuntimeError, match="output 0 is"):
        bk.hold(dataclasses.replace(c, call=lambda: c.plain()[:, :2]))
    with pytest.raises(RuntimeError, match="output 0 is"):
        bk.hold(dataclasses.replace(c, call=lambda: c.plain().double()))


@pytest.mark.parametrize("name", ["rms_norm", "rope"])
def test_hold_raises_where_the_one_bf16_step_criterion_fails(name):
    c = ROWS[name]()

    def two_steps():
        out = c.plain().clone()
        bits = out.view(torch.int16).reshape(-1)
        bits[0] += 2                                  # two bf16 steps at one element
        return out

    def one_step_everywhere():
        out = c.plain().clone()
        out.view(torch.int16).add_(1)                 # within a step, but none identical
        return out

    for bad in (two_steps, one_step_everywhere):
        with pytest.raises(RuntimeError, match="bit-identical"):
            bk.hold(dataclasses.replace(c, call=bad))
    # a tolerance alone would have passed both
    assert torch.allclose(two_steps().float(), c.plain().float(), rtol=2e-2, atol=2e-2)


def test_hold_raises_where_the_unembed_criterion_fails():
    c = _unembed()
    scale = float(c.plain().abs().max())
    off = lambda: c.plain() + 2e-5 * scale
    with pytest.raises(RuntimeError, match="at max.logit"):
        bk.hold(dataclasses.replace(c, call=off))
    bk.hold(dataclasses.replace(c, call=lambda: c.plain() + 5e-6 * scale))


def test_the_head_bound_matches_arithmetic_by_hand_at_three_levels():
    c = _head(Q=3)                                     # B=5, d=16, hidden 32, K=8
    reads = 5 * 16 + 16 * 32 + 32 + 32 * 8 + 8 + 9 + 3  # phi, w1, b1, w2, b2, edges, levels
    assert c.nbytes == 4 * (reads + 5 * 8 + 5 * 3)       # + probs and quantiles
    assert c.flops == 2 * 5 * 16 * 32 + 2 * 5 * 32 * 8
    assert c.peak == bk.FP32_FLOPS and c.shape == "B=5 d=16 hidden=32 K=8 Q=3 fp32"
    # the reference's row is the case Q = 1
    head = {r.row: r for r in bk.cases("cpu")}["prod_head_128x1024"]
    assert head.nbytes == 4 * (128 * 1024 + 1024 * 512 + 512 + 512 * 64 + 64 + 65 + 1
                               + 128 * 64 + 128)


def test_the_unembed_bound_matches_arithmetic_by_hand():
    c = _unembed()                                     # M=3, d=16, V=50
    assert c.nbytes == 2 * (3 * 16 + 16 * 50) + 4 * 3 * 50
    assert c.flops == 2 * 3 * 16 * 50 and c.peak == bk.BF16_FLOPS
    assert c.shape == "M=3 d=16 V=50 untied (tiny)"
    assert _unembed(tied=True).shape == "M=3 d=16 V=50 tied (tiny)"


def test_the_norm_and_rope_bounds_match_arithmetic_by_hand():
    n = _norm()                                        # 6 rows of 32, read and written
    assert (n.nbytes, n.flops) == (2 * (2 * 6 * 32 + 32), 0)
    r = _rope()                                        # 2 x 5 x 3 heads of 32, angles fp32
    assert (r.nbytes, r.flops) == (2 * 2 * (2 * 5 * 3 * 32) + 4 * 2 * 5 * 16, 0)
    assert r.shape == "B=2 S=5 H=3 hd=32 of 48 (tiny)"
    assert bk.bound(n.nbytes, n.flops, n.peak) == (n.nbytes / 3.35e12 * 1e3, "bytes")


def test_the_attention_bounds_match_arithmetic_by_hand():
    # bf16 flash over ragged keys (24 and 9 of 24): q and o 2 x 24 x 4 x 32,
    # k and v of the valid keys x 2 heads x 32, the lengths; the causal pairs
    f = _flash(BF)
    pairs = 24 * 25 // 2 + (9 * 10 // 2 + (24 - 9) * 9)
    assert f.nbytes == 2 * (2 * 24 * 4 * 64 + (24 + 9) * 2 * 64) + 4 * 2
    assert f.flops == 2 * 64 * 4 * pairs and f.peak == bk.BF16_FLOPS
    assert f.shape == "B=2 S=24 H=4 KV=2 hd=32 bf16 causal ragged" and f.tols == ((2e-2, 2e-2),)
    d = _decode(BF)                                    # 48 valid keys of 3 x 40
    assert d.nbytes == 2 * (2 * 3 * 4 * 64 + 2 * 48 * 2 * 64) + 4 * 3
    assert d.flops == 4 * 64 * 4 * 48 and d.cold and not _decode().cold


def test_the_scan_bound_matches_arithmetic_by_hand():
    c = _scan()                                        # B=2, S=20, H=2, P=8, N=4, fp32
    assert c.nbytes == 4 * (2 * 2 * 20 * 2 * 8 + 2 * 2 * 20 * 2 + 2 * 2 * 20 * 4 + 2 * 2 * 8 * 4)
    assert c.flops == bk.ssd_scan_flops(2, 20, 2, 8, 4) and c.library is None
    assert c.tols == ((2e-4, 2e-4), (2e-4, 2e-4))


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_the_kernels_are_listed_once():
    """The wrappers, the report's sources and what each kernel replaces all
    follow _build.KERNEL_SOURCES; the reference's bench has rows of the
    kernels that replace a TPU kernel, and of no other."""
    cs = _chip_smoke()
    assert list(bk.kernel_wrappers()) == list(_build.KERNEL_SOURCES)
    assert all(w.__name__ == f"{n}_cuda" for n, w in bk.kernel_wrappers().items())
    assert list(cs.REPLACES) == list(_build.KERNEL_SOURCES)
    assert all((REPO / f"src/repro_torch/kernels/csrc/{n}.cu").exists()
               for n in _build.KERNEL_SOURCES)
    tpu = {n for n in _build.KERNEL_SOURCES if cs.ports_tpu_kernel(n)}
    assert tpu == {c.kernel for c in bk.cases("cpu")}
    for n in _build.KERNEL_SOURCES:
        path, _, lines = cs.REPLACES[n].partition(":")
        assert (REPO / path).exists() and lines


def test_no_chip_smoke_function_takes_torch_or_ref():
    tree = ast.parse((REPO / "chip_smoke.py").read_text())
    takes = [f.name for f in ast.walk(tree) if isinstance(f, ast.FunctionDef)
             for a in f.args.args if a.arg in ("torch", "ref")]
    assert not takes


def test_the_reference_rows_keep_their_shapes():
    assert [(c.row, c.kernel, c.shape) for c in bk.cases("cpu")] == [
        ("flash_attention_512", "flash_attention", "B=2 S=512 H=8 KV=2 hd=64 fp32 causal"),
        ("decode_attention_4k", "decode_attention", "B=8 Sc=4096 H=8 KV=2 hd=64 fp32 full cache"),
        ("ssd_scan_512", "ssd_scan", "B=2 S=512 H=8 P=32 N=32 fp32 a=-0.5dt"),
        ("prod_head_128x1024", "prod_head", "B=128 d=1024 hidden=512 K=64 median fp32")]
