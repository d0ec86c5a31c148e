"""The port's CUDA kernels against their plain PyTorch versions, on the GPU
(marked ``gpu``; each test skips without CUDA). Tolerances as in
tests/test_kernels.py: fp32 2e-5, bf16 2e-2 (both sides compute in fp32 and
round the output once), prod_head probs 1e-5/1e-6 and quantiles 1e-4/1e-3
(the kernel sums in another order), ssd_scan's fp32 state (and fp32 y) at
the reference's SSD tolerance 2e-4 (chunked against sequential decays).

Imports neither JAX nor the JAX package, so it also runs where JAX is not
installed:

    PYTHONPATH=src python -m pytest -q --noconftest -m gpu tests/test_torch_kernels_gpu.py
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import decode_attention as da  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402

F32, BF16 = "float32", "bfloat16"
TDT = {F32: torch.float32, BF16: torch.bfloat16}
QS = [0.1, 0.5, 0.9, 0.99]


def cuda_device():
    """The CUDA device, or skip: decided inside the test, never at import."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run with -m gpu on the GPU)")
    return torch.device("cuda")


def close(got, want, dtype):
    tol = dict(rtol=2e-2, atol=2e-2) if dtype == BF16 else dict(rtol=2e-5, atol=2e-5)
    torch.testing.assert_close(got.float(), want.float(), **tol)


def _qkv(seed, qshape, kvshape, dtype, dev):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal(s).astype(np.float32)).to(dev, TDT[dtype])
            for s in (qshape, kvshape, kvshape)]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [F32, BF16])
@pytest.mark.parametrize("hd", [32, 64, 128])
@pytest.mark.parametrize("causal,window", [(True, 0), (True, 17), (False, 0)])
def test_flash_attention_kernel_vs_plain(dtype, hd, causal, window):
    dev = cuda_device()
    B, S, H, KV = 3, 150, 8, 2
    q, k, v = _qkv(4, (B, S, H, hd), (B, S, KV, hd), dtype, dev)
    # ragged key lengths, except with a window: a padded query row past
    # len + window sees no key, where the kernel gives 0 and the plain
    # version the mean of V (the serving path has no such row)
    lens = (None if window else
            torch.tensor([150, 97, 64], dtype=torch.int32, device=dev))
    got = ops.flash_attention(q, k, v, causal=causal, window=window, kv_lengths=lens)
    want = ref.flash_attention_ref(q, k, v, causal=causal, window=window, kv_lengths=lens)
    close(got, want, dtype)


# bf16 cases of the wgmma kernel: (B, S, H, KV, hd, causal, window, key lengths)
FLASH_BF16_CASES = {
    # the serving shapes (Llama: 64-key tiles; Zamba2: 128-key tiles) with
    # ragged lengths: 1, below one tile, and one past a tile boundary
    "llama-len1": (2, 512, 32, 8, 128, True, 0, [512, 1]),
    "llama-len37-65": (2, 512, 32, 8, 128, True, 0, [37, 65]),
    "zamba2-len1": (2, 512, 32, 32, 64, True, 8192, [512, 1]),
    "zamba2-len100-129": (2, 512, 32, 32, 64, True, 8192, [100, 129]),
    # ragged query tiles (128 rows a block)
    "S77": (2, 77, 8, 2, 128, True, 0, None),
    "S509": (2, 509, 8, 2, 64, True, 0, [509, 300]),
    # a window inside one tile and across tiles
    "window17": (2, 300, 8, 2, 128, True, 17, None),
    "window200": (2, 509, 8, 2, 64, True, 200, None),
    "non-causal": (2, 300, 8, 2, 128, False, 0, [300, 65]),
    # GQA group sizes
    "G1": (2, 256, 8, 8, 64, True, 0, [256, 129]),
    "G4": (2, 256, 8, 2, 128, True, 0, [256, 129]),
    "G8": (2, 256, 8, 1, 32, True, 0, [256, 129]),
}


@pytest.mark.gpu
@pytest.mark.parametrize("case", list(FLASH_BF16_CASES))
def test_flash_attention_bf16_kernel_vs_plain(case):
    """Every query row here sees at least one key, so the kernel's 0 for a
    row with none never enters the comparison."""
    dev = cuda_device()
    B, S, H, KV, hd, causal, window, lens = FLASH_BF16_CASES[case]
    q, k, v = _qkv(8, (B, S, H, hd), (B, S, KV, hd), BF16, dev)
    lens = None if lens is None else torch.tensor(lens, dtype=torch.int32, device=dev)
    got = ops.flash_attention(q, k, v, causal=causal, window=window, kv_lengths=lens)
    want = ref.flash_attention_ref(q, k, v, causal=causal, window=window, kv_lengths=lens)
    close(got, want, BF16)


def _check_decode(q, k, v, lens, dtype):
    """The kernel against its plain version, and a second call bit-identical
    (the splits are combined in a fixed order)."""
    got = ops.decode_attention(q, k, v, lens)
    close(got, ref.decode_attention_ref(q, k, v, lens), dtype)
    assert torch.equal(got, ops.decode_attention(q, k, v, lens))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [F32, BF16])
@pytest.mark.parametrize("B,Sc,H,KV,hd", [(2, 100, 8, 2, 64), (3, 300, 32, 8, 128),
                                          (1, 40, 4, 4, 32)])
def test_decode_attention_kernel_vs_plain(dtype, B, Sc, H, KV, hd):
    dev = cuda_device()
    q, k, v = _qkv(5, (B, H, hd), (B, Sc, KV, hd), dtype, dev)
    lens = torch.from_numpy(np.random.default_rng(1).integers(1, Sc + 1, B).astype(np.int32))
    _check_decode(q, k, v, lens.to(dev), dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [F32, BF16])
@pytest.mark.parametrize("hd", [32, 64, 128])
@pytest.mark.parametrize("G", [1, 4, 8, 16])
def test_decode_attention_group_sizes(dtype, hd, G):
    """Query heads per KV head 1 (one head a block), 4 and 8 (one head tile)
    and 16 (two tiles); lengths of one key, of the whole cache and between;
    Sc = 301 is a multiple of no key pass."""
    dev = cuda_device()
    B, KV, Sc = 3, 2, 301
    q, k, v = _qkv(9, (B, G * KV, hd), (B, Sc, KV, hd), dtype, dev)
    _check_decode(q, k, v, torch.tensor([Sc, 1, 157], dtype=torch.int32, device=dev), dtype)


SERVE_LENS = [576, 301, 258, 540, 400, 575, 267, 449]   # chip_smoke.py's decode lengths
# bf16 cases: (B, Sc, H, KV, hd, lengths)
DECODE_CASES = {
    "llama-serve": (8, 576, 32, 8, 128, SERVE_LENS),       # the two decode shapes served
    "zamba2-serve": (8, 576, 32, 32, 64, SERVE_LENS),
    "Sc77": (3, 77, 8, 2, 64, [77, 1, 40]),                # below one pass of keys
    "G3": (2, 100, 6, 2, 64, [100, 33]),                   # a head tile of 4 holding 3
    "long-G16": (2, 8192, 16, 1, 128, [8192, 5000]),       # many splits a row
    "long-G4": (1, 8192, 32, 8, 128, [7777]),
    "long-G1": (2, 8192, 8, 8, 64, [8192, 1]),
}


@pytest.mark.gpu
@pytest.mark.parametrize("case", list(DECODE_CASES))
def test_decode_attention_bf16_cases(case):
    dev = cuda_device()
    B, Sc, H, KV, hd, lens = DECODE_CASES[case]
    q, k, v = _qkv(10, (B, H, hd), (B, Sc, KV, hd), BF16, dev)
    _check_decode(q, k, v, torch.tensor(lens, dtype=torch.int32, device=dev), BF16)


@pytest.mark.gpu
def test_decode_attention_row_without_keys_is_zero():
    dev = cuda_device()
    q, k, v = _qkv(11, (2, 8, 64), (2, 100, 2, 64), BF16, dev)
    out = ops.decode_attention(q, k, v, torch.tensor([0, 100], dtype=torch.int32, device=dev))
    assert not out[0].any()
    close(out[1:], ref.decode_attention_ref(q[1:], k[1:], v[1:], torch.tensor(
        [100], dtype=torch.int32, device=dev)), BF16)


@pytest.mark.gpu
def test_decode_attention_in_cuda_graph():
    """A call captured into a CUDA graph (with a workspace of its own) and
    replayed on new contents of its inputs gives what an eager call gives."""
    dev = cuda_device()
    q, k, v = _qkv(12, (8, 32, 128), (8, 576, 8, 128), BF16, dev)
    lens = torch.tensor(SERVE_LENS, dtype=torch.int32, device=dev)
    ops.decode_attention(q, k, v, lens)        # build, and the eager workspace
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = ops.decode_attention(q, k, v, lens)
    for seed in (13, 14):
        q2, k2, v2 = _qkv(seed, (8, 32, 128), (8, 576, 8, 128), BF16, dev)
        q.copy_(q2)
        k.copy_(k2)
        v.copy_(v2)
        lens.copy_(torch.flip(lens, (0,)))
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, ops.decode_attention(q, k, v, lens))
        close(out, ref.decode_attention_ref(q, k, v, lens), BF16)


# (B, Sc, H, KV, hd, dtype) of the plan cases
PLAN_CASES = [
    (8, 576, 32, 8, 128, BF16), (8, 576, 32, 32, 64, BF16),     # the served decode shapes
    (1, 8192, 16, 1, 128, BF16), (1, 8192, 32, 8, 128, BF16), (2, 8192, 8, 8, 64, BF16),
    (3, 301, 8, 2, 128, F32), (3, 301, 24, 2, 128, F32), (1, 40, 4, 4, 32, F32),
    (2, 100, 6, 2, 64, BF16),
    (64, 1, 32, 8, 128, BF16), (1, 1_000_000, 1, 1, 32, BF16),
]


@pytest.mark.gpu
@pytest.mark.parametrize("B,Sc,H,KV,hd,dtype", PLAN_CASES)
def test_decode_attention_plan_covers_the_cache(B, Sc, H, KV, hd, dtype):
    """The library's split, from the shapes and this card's SM count alone:
    a head tile of G rounded up to a power of two (at most 8), splits that
    cover every key once (at most 128), and a block on every SM unless the
    splits are already one pass of keys or the 128-split cap makes them
    longer."""
    dev = cuda_device()
    n_sms = torch.cuda.get_device_properties(dev).multi_processor_count
    G = H // KV
    gt, n, chunk = da.plan(dev, B, Sc, H, KV, hd, TDT[dtype])
    assert gt == min(8, 1 << (G - 1).bit_length())
    assert 1 <= n <= 128 and (n - 1) * chunk < Sc <= n * chunk
    step = 128 // (hd // 8) * (4 if dtype == BF16 else 2)   # key rows a block's pass
    assert chunk % step == 0
    assert n * B * KV * -(-G // gt) >= n_sms or chunk == step or -(-Sc // 128) > step


@pytest.mark.gpu
def test_decode_attention_plan_at_the_served_shapes():
    """On the H100 (132 SMs): Llama-3-8B (G=4, hd=128) 6 splits of 96 keys,
    384 blocks; Zamba2 (G=1, hd=64) 3 splits of 192 keys, 768 blocks."""
    dev = cuda_device()
    if torch.cuda.get_device_properties(dev).multi_processor_count != 132:
        pytest.skip("the planned splits follow the SM count; these are the H100's")
    assert da.plan(dev, 8, 576, 32, 8, 128, torch.bfloat16) == (4, 6, 96)
    assert da.plan(dev, 8, 576, 32, 32, 64, torch.bfloat16) == (1, 3, 192)


@pytest.mark.gpu
@pytest.mark.parametrize("plan", [(1, 1, 576), (1, 2, 320), (1, 3, 192), (1, 5, 128),
                                  (1, 9, 64), (2, 5, 128), (8, 4, 192)])
def test_decode_attention_other_plans_round_correctly(plan):
    """Zamba2's decode shape under other splits than the library's: each
    output is the exact attention (fp64, from the same bf16 inputs) rounded
    to bf16, give or take the fp32 arithmetic: within one bf16 step (2e-6
    for a value near 0, where the step is smaller than fp32's error on terms
    of order 1). So a plan's output may differ from another's or from the
    plain version's by one rounding step (2^-9 for a value in [0.25, 0.5)),
    but no more. A head tile larger than G (2 and 8 here, G = 1) leaves its
    spare heads out."""
    dev = cuda_device()
    B, Sc, H, KV, hd = 8, 576, 32, 32, 64
    q, k, v = _qkv(15, (B, H, hd), (B, Sc, KV, hd), BF16, dev)
    lens = torch.tensor(SERVE_LENS, dtype=torch.int32, device=dev)
    got = da.decode_attention_cuda(q, k, v, lens, with_plan=plan)
    s = torch.einsum("bhd,bshd->bhs", q.double(), k.double()) / hd ** 0.5
    s = s.masked_fill(torch.arange(Sc, device=dev)[None, None] >= lens[:, None, None],
                      float("-inf"))
    exact = torch.einsum("bhs,bshd->bhd", torch.softmax(s, -1), v.double())
    step = torch.exp2(torch.floor(torch.log2(exact.abs().clamp_min(2.0 ** -126))) - 7)
    assert bool(((got.double() - exact).abs() <= step + 2e-6).all())
    assert torch.equal(got, da.decode_attention_cuda(q, k, v, lens, with_plan=plan))


def _head_args(B, d, hid, K, dev):
    """Head inputs at the head's init scales (core/heads.py: 1/sqrt(fan_in)),
    so the logits stay O(1) at d=4096 as they do in serving."""
    rng = np.random.default_rng(3)
    arrs = [rng.standard_normal((B, d)), rng.standard_normal((d, hid)) / d ** 0.5,
            rng.standard_normal(hid) * 0.01, rng.standard_normal((hid, K)) / hid ** 0.5,
            np.zeros(K), np.linspace(0.0, 512.0, K + 1)]
    return [torch.from_numpy(a.astype(np.float32)).to(dev) for a in arrs]


@pytest.mark.gpu
@pytest.mark.parametrize("B,d,hid,K", [(7, 32, 32, 8), (33, 96, 64, 32), (40, 4096, 512, 64)]
                         + [(B, d, 512, 64) for B in (1, 8, 17, 512, 513)
                            for d in (768, 2048, 4096)]
                         + [(8, 4100, 512, 64), (513, 4100, 512, 64), (8, 96, 512, 64)]
                         + [(B, 64, 512, 64) for B in (200, 350, 700, 1319)])
@pytest.mark.parametrize("qs", [None, QS], ids=["median", "qs"])
def test_prod_head_kernel_vs_plain(B, d, hid, K, qs):
    """Small heads, then the served d (Mamba2, Zamba2, Llama) at batches on
    both sides of the 8-row and 128-row tiles of the hidden stage, d that
    is not a multiple of its d-slice, and the Track-A head (d=64) at the
    batches of ``--mode sim`` (200) and Table 1 (350 and 700 fast, 1319
    with ``--full``). The d-splits are summed in a fixed
    order, so a second call agrees with the first bit for bit."""
    args = _head_args(B, d, hid, K, cuda_device())
    p_got, q_got = ops.prod_head(*args, qs=qs)
    p_want, q_want = ref.prod_head_ref(*args, qs=qs)
    torch.testing.assert_close(p_got, p_want, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(q_got, q_want, rtol=1e-4, atol=1e-3)
    p_again, q_again = ops.prod_head(*args, qs=qs)
    assert torch.equal(p_got, p_again) and torch.equal(q_got, q_again)


@pytest.mark.gpu
@pytest.mark.parametrize("c", [4.0, 8.0, 12.8])
def test_prod_head_kernel_large_logits_vs_fp64(c):
    """At d=4096 with weights of std c/sqrt(fan_in) (c=12.8 is std 0.2, the
    scale of tests/test_kernels.py) the logits reach std 10-110, and any two
    fp32 summation orders differ by more than the probs tolerance above. Here
    both fp32 versions are held against the fp64 head instead: the kernel's
    probs error is at most twice that of the plain version."""
    dev = cuda_device()
    B, d, hid, K = 40, 4096, 512, 64
    rng = np.random.default_rng(3)
    arrs = [rng.standard_normal((B, d)), rng.standard_normal((d, hid)) * c / d ** 0.5,
            rng.standard_normal(hid) * 0.01, rng.standard_normal((hid, K)) * c / hid ** 0.5,
            np.zeros(K), np.linspace(0.0, 512.0, K + 1)]
    args = [torch.from_numpy(a.astype(np.float32)).to(dev) for a in arrs]
    phi, w1, b1, w2, b2, _ = (a.double() for a in args)
    exact = torch.softmax(torch.relu(phi @ w1 + b1) @ w2 + b2, dim=-1)
    kernel_err = (ops.prod_head(*args)[0].double() - exact).abs().max()
    plain_err = (ref.prod_head_ref(*args)[0].double() - exact).abs().max()
    assert kernel_err <= 2 * plain_err, (float(kernel_err), float(plain_err))


def _ssd_args(dtype, B, S, H, P, N, decay, dev, seed=7):
    rng = np.random.default_rng(seed)
    dt = np.log1p(np.exp(rng.standard_normal((B, S, H))))
    a = -decay * dt * np.exp(0.3 * rng.standard_normal(H))
    f32 = lambda v: torch.from_numpy(v.astype(np.float32)).to(dev)
    io = lambda shape: f32(rng.standard_normal(shape)).to(TDT[dtype])
    return (io((B, S, H, P)), f32(dt), f32(a), io((B, S, N)), io((B, S, N)))


def _check_ssd(args, dtype):
    """y and h against the plain version, and a second call bit-identical;
    returns the plain h."""
    y, h = ops.ssd_scan(*args)
    y_want, h_want = ref.ssd_scan_ref(*args)
    assert y.dtype == TDT[dtype] and h.dtype == torch.float32
    y_tol = dict(rtol=2e-2, atol=2e-2) if dtype == BF16 else dict(rtol=2e-4, atol=2e-4)
    torch.testing.assert_close(y.float(), y_want.float(), **y_tol)
    torch.testing.assert_close(h, h_want, rtol=2e-4, atol=2e-4)
    y2, h2 = ops.ssd_scan(*args)
    assert torch.equal(y, y2) and torch.equal(h, h2)
    return h_want


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [F32, BF16])
@pytest.mark.parametrize("B,S,H,P,N", [
    (2, 1, 4, 64, 64),        # one step
    (2, 509, 64, 64, 64),     # Zamba2's widths, ragged last chunk
    (1, 128, 24, 64, 128),    # Mamba2-130M's widths, S a multiple of the chunk
    (2, 300, 24, 64, 128),    # Mamba2-130M's widths, ragged last chunk
    (3, 77, 8, 64, 128),
    (2, 65, 64, 64, 64),      # one step past a chunk
    (2, 65, 24, 64, 128),
])
@pytest.mark.parametrize("decay", [1.0, 0.01], ids=["fast-decay", "slow-decay"])
def test_ssd_scan_kernel_vs_plain(dtype, B, S, H, P, N, decay):
    """``decay`` scales a = -dt. At 1 the decay over a chunk of 64 steps is
    about e^-50, so exp(cum_i) hides the carried state after a few rows of
    each chunk; at 0.01 it is about e^-0.5 and the state is most of y."""
    _check_ssd(_ssd_args(dtype, B, S, H, P, N, decay, cuda_device()), dtype)


def _ssd_fp64(x, dt, a, Bm, Cm):
    """The recurrence of ``ref.ssd_scan_ref`` in fp64: the exact answer both
    fp32 versions approximate."""
    x, dt, a, Bm, Cm = (t.double() for t in (x, dt, a, Bm, Cm))
    h = torch.zeros(x.shape[0], x.shape[2], x.shape[3], Bm.shape[-1], dtype=torch.float64,
                    device=x.device)
    ys = []
    for t in range(x.shape[1]):
        h = torch.exp(a[:, t])[:, :, None, None] * h + torch.einsum(
            "bh,bhp,bn->bhpn", dt[:, t], x[:, t], Bm[:, t])
        ys.append(torch.einsum("bhpn,bn->bhp", h, Cm[:, t]))
    return torch.stack(ys, dim=1), h


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [F32, BF16])
@pytest.mark.parametrize("B,S,H,P,N", [
    (2, 509, 64, 64, 64), (2, 300, 24, 64, 128), (2, 65, 64, 64, 64), (2, 65, 24, 64, 128)])
def test_ssd_scan_no_decay(dtype, B, S, H, P, N):
    """a = 0: nothing decays, the state grows over the whole sequence (|h| up
    to ~60, |y| up to ~900). bf16 and the fp32 state h as in the test above.
    fp32 y: at |y| ~ 900 two fp32 summation orders differ by more than 2e-4
    (the plain version is 5.1e-4 off the fp64 recurrence at S=509), so y is
    held against the fp64 recurrence, at the same tolerance. At S=65 the
    kernel's error against fp64 is also at most 1.5x the plain version's:
    its sums run in blocks of 16 terms (ssd_scan.cu), where one chain over a
    chunk left it 2.7x."""
    args = _ssd_args(dtype, B, S, H, P, N, 0.0, cuda_device())
    if dtype == BF16:
        _check_ssd(args, dtype)
        return
    y, h = ops.ssd_scan(*args)
    y_plain, h_plain = ref.ssd_scan_ref(*args)
    exact = _ssd_fp64(*args)[0]
    torch.testing.assert_close(h, h_plain, rtol=2e-4, atol=2e-4)
    torch.testing.assert_close(y.double(), exact, rtol=2e-4, atol=2e-4)
    if S == 65:
        kernel_err = float((y.double() - exact).abs().max())
        plain_err = float((y_plain.double() - exact).abs().max())
        assert kernel_err <= 1.5 * plain_err, (kernel_err, plain_err)
    y2, h2 = ops.ssd_scan(*args)
    assert torch.equal(y, y2) and torch.equal(h, h2)


@pytest.mark.gpu
@pytest.mark.parametrize("P,N", [(64, 128), (64, 64)], ids=["mamba2", "zamba2"])
def test_ssd_scan_bf16_large_state(P, N):
    """No decay over 128 steps at the served widths: |h| reaches ~45, where
    one bf16 rounding of the fp32 operands would miss h's 2e-4 tolerance;
    the hi/lo split holds it."""
    h = _check_ssd(_ssd_args(BF16, 1, 128, 8, P, N, 0.0, cuda_device()), BF16)
    assert float(h.abs().max()) > 35


@pytest.mark.gpu
def test_ssd_scan_kernel_rejects_what_it_does_not_take():
    dev = cuda_device()
    x = torch.zeros(1, 8, 2, 64, device=dev)
    dt = torch.zeros(1, 8, 2, device=dev)
    Bm = torch.zeros(1, 8, 64, device=dev)
    with pytest.raises(ValueError, match="contiguous"):
        ops.ssd_scan(x.transpose(1, 2).contiguous().transpose(1, 2), dt, dt, Bm, Bm)
    with pytest.raises(RuntimeError, match="P=48, N=64"):
        ops.ssd_scan(x[..., :48].contiguous(), dt, dt, Bm, Bm)
    with pytest.raises(TypeError):
        ops.ssd_scan(x, dt, dt, Bm.bfloat16(), Bm.bfloat16())


@pytest.mark.gpu
def test_kernels_count_their_launches():
    from repro_torch.kernels.decode_attention import decode_attention_cuda

    dev = cuda_device()
    q, k, v = _qkv(6, (2, 8, 64), (2, 40, 2, 64), F32, dev)
    before = decode_attention_cuda.launches
    ops.decode_attention(q, k, v, torch.tensor([40, 3], dtype=torch.int32, device=dev))
    assert decode_attention_cuda.launches == before + 1

    from repro_torch.kernels.ssd_scan import ssd_scan_cuda

    x = torch.zeros(1, 3, 2, 64, device=dev)
    dt = torch.zeros(1, 3, 2, device=dev)
    Bm = torch.zeros(1, 3, 64, device=dev)
    before = ssd_scan_cuda.launches
    ops.ssd_scan(x, dt, dt, Bm, Bm)
    assert ssd_scan_cuda.launches == before + 1
