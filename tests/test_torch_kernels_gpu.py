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
@pytest.mark.parametrize("hd", [32, 64, 112, 128, 168])
@pytest.mark.parametrize("causal,window", [(True, 0), (True, 17), (False, 0)])
def test_flash_attention_kernel_vs_plain(dtype, hd, causal, window):
    dev = cuda_device()
    B, S, H, KV = 3, 150, 8, 2
    q, k, v = _qkv(4, (B, S, H, hd), (B, S, KV, hd), dtype, dev)
    # ragged key lengths; with the window of 17, the padded query rows past
    # len + 17 of rows 1 and 2 see no key and take the empty-row value
    lens = torch.tensor([150, 97, 64], dtype=torch.int32, device=dev)
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
    # the dense configs' groups: G=7 (Qwen2.5-7B 28/4, Yi-34B 56/8), G=48
    # (Granite-20B, one KV head) and MiniCPM-2B's 36 heads of MHA
    "qwen-G7-hd128": (2, 256, 28, 4, 128, True, 0, [256, 129]),
    "qwen-G7-hd64": (2, 256, 28, 4, 64, True, 0, [256, 37]),
    "yi-G7-hd128": (2, 300, 56, 8, 128, True, 0, [300, 100]),
    "yi-G7-hd64": (2, 300, 56, 8, 64, True, 0, [1, 300]),
    "granite-G48-hd128": (2, 256, 48, 1, 128, True, 0, [256, 65]),
    "granite-G48-hd64": (2, 256, 48, 1, 64, True, 0, [200, 256]),
    "minicpm-H36-hd64": (2, 300, 36, 36, 64, True, 0, [300, 129]),
    "minicpm-H36-hd128": (2, 300, 36, 36, 128, True, 0, [37, 300]),
    # a window with ragged lengths: padded query rows past len + window see
    # no key and take the reference's empty-row value (sum V / Skv_pad; 600
    # keys pad to 1024, 1100 to 1536), at both tile widths and in a batch
    # whose empty rows fill whole query tiles
    "window-empty-rows-hd64": (3, 600, 8, 2, 64, True, 64, [600, 5, 300]),
    "window-empty-rows-hd128": (2, 700, 8, 1, 128, True, 100, [700, 3]),
    "window-empty-rows-hd32": (2, 333, 4, 4, 32, True, 40, [2, 333]),
    "zamba2-window-short-row": (2, 1100, 32, 32, 64, True, 512, [1100, 20]),
    # Gemma3-27B's heads (32 on 16 KV heads, hd=168: tiles of 192 columns,
    # the last 24 read as zeros): the serve shape, its 1,024-key window with
    # a short row whose padded queries past len + window see no key, a
    # ragged query tile, a window inside one key tile, and G=1 and G=8
    "gemma3-serve": (2, 512, 32, 16, 168, True, 0, [512, 1]),
    "gemma3-serve-len37-65": (2, 512, 32, 16, 168, True, 0, [37, 65]),
    "gemma3-window1024": (2, 1100, 32, 16, 168, True, 1024, [1100, 20]),
    "gemma3-window1024-full": (1, 1100, 32, 16, 168, True, 1024, None),
    "gemma3-S77": (2, 77, 4, 2, 168, True, 0, None),
    "gemma3-window17-empty-rows": (3, 300, 4, 2, 168, True, 17, [300, 5, 100]),
    "gemma3-non-causal": (2, 300, 4, 2, 168, False, 0, [300, 65]),
    "gemma3-G1": (2, 256, 4, 4, 168, True, 0, [256, 129]),
    "gemma3-G8": (2, 256, 8, 1, 168, True, 0, [256, 129]),
    # Kimi-K2's heads (64 on 8 KV heads, hd=112: tiles of 128 columns, the
    # last 16 read as zeros) and Qwen3-MoE's (64 on 4, hd=64: G=16)
    "kimi-serve": (2, 512, 64, 8, 112, True, 0, [512, 1]),
    "kimi-serve-len37-65": (2, 512, 64, 8, 112, True, 0, [37, 65]),
    "kimi-S77": (2, 77, 8, 1, 112, True, 0, None),
    "kimi-window17-empty-rows": (3, 300, 8, 1, 112, True, 17, [300, 5, 100]),
    "kimi-non-causal": (2, 300, 8, 2, 112, False, 0, [300, 65]),
    "qwen3moe-serve-G16": (2, 512, 64, 4, 64, True, 0, [512, 1]),
    "qwen3moe-len37-65": (2, 512, 64, 4, 64, True, 0, [37, 65]),
}


@pytest.mark.gpu
@pytest.mark.parametrize("case", list(FLASH_BF16_CASES))
def test_flash_attention_bf16_kernel_vs_plain(case):
    """The kernel against the plain version, rows with no valid key
    included (both give them the reference's empty-row value)."""
    dev = cuda_device()
    B, S, H, KV, hd, causal, window, lens = FLASH_BF16_CASES[case]
    q, k, v = _qkv(8, (B, S, H, hd), (B, S, KV, hd), BF16, dev)
    lens = None if lens is None else torch.tensor(lens, dtype=torch.int32, device=dev)
    got = ops.flash_attention(q, k, v, causal=causal, window=window, kv_lengths=lens)
    want = ref.flash_attention_ref(q, k, v, causal=causal, window=window, kv_lengths=lens)
    close(got, want, BF16)


# Whisper-large-v3 (20 heads of 64, MHA) and Qwen2-VL-2B (12 on 2 of 128,
# G=6): (B, Sq, Skv, H, KV, hd, causal, key lengths, dtype)
FLASH_ENCDEC_VLM_CASES = {
    # cross-attention: 224 prompt rows (the last query tile holds 96) against
    # the 1,500 encoder keys (the last key tile holds 92), every key valid
    "whisper-cross": (2, 224, 1500, 20, 20, 64, False, None, BF16),
    # the encoder: bidirectional over its 1,500 frames
    "whisper-encoder": (2, 1500, 1500, 20, 20, 64, False, None, BF16),
    # cross shapes the kernel's edges meet: one query row, a query tile and
    # one row, ragged key lengths, and the SIMT kernel (fp32)
    "cross-Sq1": (2, 1, 1500, 20, 20, 64, False, None, BF16),
    "cross-Sq129-ragged": (2, 129, 700, 8, 2, 128, False, [700, 93], BF16),
    "cross-fp32": (2, 77, 300, 4, 4, 64, False, [300, 33], F32),
    "qwen2vl-serve-G6": (2, 512, 512, 12, 2, 128, True, [512, 1], BF16),
    "qwen2vl-G6-ragged": (2, 512, 512, 12, 2, 128, True, [300, 257], BF16),
}


@pytest.mark.gpu
@pytest.mark.parametrize("case", list(FLASH_ENCDEC_VLM_CASES))
def test_flash_attention_encdec_and_vlm_shapes(case):
    """Non-causal flash over a key set of another length (Whisper's
    cross-attention and encoder) and Qwen2-VL's G=6, against the plain
    version; a second call bit-identical."""
    dev = cuda_device()
    B, Sq, Skv, H, KV, hd, causal, lens, dtype = FLASH_ENCDEC_VLM_CASES[case]
    q, k, v = _qkv(11, (B, Sq, H, hd), (B, Skv, KV, hd), dtype, dev)
    lens = None if lens is None else torch.tensor(lens, dtype=torch.int32, device=dev)
    got = ops.flash_attention(q, k, v, causal=causal, kv_lengths=lens)
    close(got, ref.flash_attention_ref(q, k, v, causal=causal, kv_lengths=lens), dtype)
    assert torch.equal(got, ops.flash_attention(q, k, v, causal=causal, kv_lengths=lens))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [F32, BF16])
@pytest.mark.parametrize("window,lens", [(0, [300, 1]), (17, [300, 5]), (1024, [300, 200])],
                         ids=["causal", "window17", "window1024"])
def test_flash_attention_hd168(dtype, window, lens):
    """Gemma3's head width in both kernels (wgmma in bf16, SIMT in fp32):
    ragged lengths, rows with no valid key (window 17 on a 5-key row), a
    window longer than the sequence; a second call gives the same bits."""
    dev = cuda_device()
    B, S, H, KV, hd = 2, 300, 8, 4, 168
    q, k, v = _qkv(16, (B, S, H, hd), (B, S, KV, hd), dtype, dev)
    lens = torch.tensor(lens, dtype=torch.int32, device=dev)
    got = ops.flash_attention(q, k, v, causal=True, window=window, kv_lengths=lens)
    close(got, ref.flash_attention_ref(q, k, v, causal=True, window=window, kv_lengths=lens),
          dtype)
    assert torch.equal(got, ops.flash_attention(q, k, v, causal=True, window=window,
                                                kv_lengths=lens))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [F32, BF16])
@pytest.mark.parametrize("window,lens", [(0, [300, 1]), (17, [300, 5]), (1024, [300, 200])],
                         ids=["causal", "window17", "window1024"])
def test_flash_attention_hd112(dtype, window, lens):
    """Kimi-K2's head width in both kernels (wgmma in bf16 on 128-column
    tiles, SIMT in fp32 with 7 strides of 16): ragged lengths, rows with no
    valid key, a window longer than the sequence; a second call gives the
    same bits."""
    dev = cuda_device()
    B, S, H, KV, hd = 2, 300, 16, 2, 112
    q, k, v = _qkv(18, (B, S, H, hd), (B, S, KV, hd), dtype, dev)
    lens = torch.tensor(lens, dtype=torch.int32, device=dev)
    got = ops.flash_attention(q, k, v, causal=True, window=window, kv_lengths=lens)
    close(got, ref.flash_attention_ref(q, k, v, causal=True, window=window, kv_lengths=lens),
          dtype)
    assert torch.equal(got, ops.flash_attention(q, k, v, causal=True, window=window,
                                                kv_lengths=lens))


def _check_decode(q, k, v, lens, dtype):
    """The kernel against its plain version, and a second call bit-identical
    (the splits are combined in a fixed order)."""
    got = ops.decode_attention(q, k, v, lens)
    close(got, ref.decode_attention_ref(q, k, v, lens), dtype)
    assert torch.equal(got, ops.decode_attention(q, k, v, lens))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [F32, BF16])
@pytest.mark.parametrize("B,Sc,H,KV,hd", [(2, 100, 8, 2, 64), (3, 300, 32, 8, 128),
                                          (1, 40, 4, 4, 32), (48, 86, 4, 2, 32)])
def test_decode_attention_kernel_vs_plain(dtype, B, Sc, H, KV, hd):
    dev = cuda_device()
    q, k, v = _qkv(5, (B, H, hd), (B, Sc, KV, hd), dtype, dev)
    lens = torch.from_numpy(np.random.default_rng(1).integers(1, Sc + 1, B).astype(np.int32))
    _check_decode(q, k, v, lens.to(dev), dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [F32, BF16])
@pytest.mark.parametrize("hd", [32, 64, 112, 128, 168])
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
    # the dense configs' decode shapes (Sp=512 + 64 new), G=7 and G=48, and
    # MiniCPM-2B's MHA
    "qwen-serve-G7": (8, 576, 28, 4, 128, SERVE_LENS),
    "yi-serve-G7": (8, 576, 56, 8, 128, SERVE_LENS),
    "granite-serve-G48": (8, 576, 48, 1, 128, SERVE_LENS),
    "minicpm-serve-H36": (8, 576, 36, 36, 64, SERVE_LENS),
    # Zamba2's shared block on its 8,192-slot rings: lengths min(len, W)
    "zamba2-ring": (4, 8192, 32, 32, 64, [8192, 8192, 8192, 577]),
    # Gemma3-27B (G=2, hd=168): the serve shape, its 1,024-slot rings, a
    # cache below one pass of keys and a row of one key
    "gemma3-serve": (8, 576, 32, 16, 168, SERVE_LENS),
    "gemma3-ring": (4, 1024, 32, 16, 168, [1024, 1024, 1024, 577]),
    "gemma3-Sc20": (3, 20, 4, 2, 168, [20, 1, 13]),
    # Kimi-K2 (G=8 in 2 head tiles of 4, hd=112) and Qwen3-MoE (G=16 in 2
    # tiles of 8, hd=64) at the serve shape; Kimi below one pass of keys
    "kimi-serve": (8, 576, 64, 8, 112, SERVE_LENS),
    "kimi-Sc20": (3, 20, 8, 1, 112, [20, 1, 13]),
    "qwen3moe-serve-G16": (8, 576, 64, 4, 64, SERVE_LENS),
    # Whisper-large-v3: its static cross cache of 1,500 frames, every key
    # valid, and its self cache (Sp=224 + 64); Qwen2-VL-2B's G=6 (a head
    # tile of 8 holding 6)
    "whisper-cross": (8, 1500, 20, 20, 64, [1500] * 8),
    "whisper-self": (8, 288, 20, 20, 64, [288, 97, 245, 161, 276, 128, 214, 193]),
    "qwen2vl-serve-G6": (8, 576, 12, 2, 128, SERVE_LENS),
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
    (8, 576, 32, 16, 168, BF16), (4, 1024, 32, 16, 168, BF16),   # Gemma3's (hd=168)
    (3, 301, 32, 2, 168, F32), (1, 8192, 8, 1, 168, BF16),
    (8, 576, 64, 8, 112, BF16), (3, 301, 16, 2, 112, F32),      # Kimi-K2's (hd=112)
    (8, 576, 64, 4, 64, BF16),                                   # Qwen3-MoE's (G=16)
]


@pytest.mark.gpu
@pytest.mark.parametrize("B,Sc,H,KV,hd,dtype", PLAN_CASES)
def test_decode_attention_plan_covers_the_cache(B, Sc, H, KV, hd, dtype):
    """The library's split, from the shapes and this card's SM count alone:
    a head tile of G rounded up to a power of two (at most 8; 4 at hd=112,
    2 at hd=168),
    splits that cover every key once (at most 128), and a block on every SM
    unless the splits are already one pass of keys or the 128-split cap
    makes them longer."""
    dev = cuda_device()
    n_sms = torch.cuda.get_device_properties(dev).multi_processor_count
    G = H // KV
    gt, n, chunk = da.plan(dev, B, Sc, H, KV, hd, TDT[dtype])
    assert gt == min({112: 4, 168: 2}.get(hd, 8), 1 << (G - 1).bit_length())
    assert 1 <= n <= 128 and (n - 1) * chunk < Sc <= n * chunk
    # key rows a block's pass: hd/8 lanes a row, 4 (bf16) or 2 (fp32) rows a
    # thread; at hd=112 and 168 8 lanes a row and 2 or 1 rows a thread
    step = (16 * (2 if dtype == BF16 else 1) if hd in (112, 168)
            else 128 // (hd // 8) * (4 if dtype == BF16 else 2))
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


@pytest.mark.gpu
@pytest.mark.parametrize("plan", [(2, 1, 576), (2, 2, 320), (2, 3, 192), (2, 5, 128),
                                  (2, 9, 64), (2, 18, 32), (1, 6, 96)])
def test_decode_attention_hd168_plans_round_correctly(plan):
    """Gemma3's decode shape (G=2, hd=168) under other splits than the
    library's, each within one bf16 step of the exact attention (as above),
    and a second call bit-identical; a head tile of 4 or 8, which hd=168
    does not instantiate, is refused."""
    dev = cuda_device()
    B, Sc, H, KV, hd = 8, 576, 32, 16, 168
    q, k, v = _qkv(17, (B, H, hd), (B, Sc, KV, hd), BF16, dev)
    lens = torch.tensor(SERVE_LENS, dtype=torch.int32, device=dev)
    got = da.decode_attention_cuda(q, k, v, lens, with_plan=plan)
    qg = q.double().reshape(B, KV, 2, hd)
    s = torch.einsum("bkgd,bskd->bkgs", qg, k.double()) / hd ** 0.5
    s = s.masked_fill(torch.arange(Sc, device=dev)[None, None, None]
                      >= lens[:, None, None, None], float("-inf"))
    exact = torch.einsum("bkgs,bskd->bkgd", torch.softmax(s, -1), v.double()).reshape(B, H, hd)
    step = torch.exp2(torch.floor(torch.log2(exact.abs().clamp_min(2.0 ** -126))) - 7)
    assert bool(((got.double() - exact).abs() <= step + 2e-6).all())
    assert torch.equal(got, da.decode_attention_cuda(q, k, v, lens, with_plan=plan))
    with pytest.raises(RuntimeError):
        da.decode_attention_cuda(q, k, v, lens, with_plan=(4, 6, 96))


@pytest.mark.gpu
@pytest.mark.parametrize("plan", [(4, 1, 576), (4, 3, 192), (4, 6, 96), (4, 18, 32),
                                  (2, 6, 96), (1, 6, 96)])
def test_decode_attention_hd112_plans_round_correctly(plan):
    """Kimi-K2's decode shape (G=8, hd=112) under other splits than the
    library's, each within one bf16 step of the exact attention (as above),
    and a second call bit-identical; a head tile of 8, which hd=112 does not
    instantiate, is refused."""
    dev = cuda_device()
    B, Sc, H, KV, hd = 8, 576, 64, 8, 112
    q, k, v = _qkv(19, (B, H, hd), (B, Sc, KV, hd), BF16, dev)
    lens = torch.tensor(SERVE_LENS, dtype=torch.int32, device=dev)
    got = da.decode_attention_cuda(q, k, v, lens, with_plan=plan)
    qg = q.double().reshape(B, KV, 8, hd)
    s = torch.einsum("bkgd,bskd->bkgs", qg, k.double()) / hd ** 0.5
    s = s.masked_fill(torch.arange(Sc, device=dev)[None, None, None]
                      >= lens[:, None, None, None], float("-inf"))
    exact = torch.einsum("bkgs,bskd->bkgd", torch.softmax(s, -1), v.double()).reshape(B, H, hd)
    step = torch.exp2(torch.floor(torch.log2(exact.abs().clamp_min(2.0 ** -126))) - 7)
    assert bool(((got.double() - exact).abs() <= step + 2e-6).all())
    assert torch.equal(got, da.decode_attention_cuda(q, k, v, lens, with_plan=plan))
    with pytest.raises(RuntimeError):
        da.decode_attention_cuda(q, k, v, lens, with_plan=(8, 6, 96))


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
                         + [(B, 64, 512, 64) for B in (200, 350, 700, 1319)]
                         + [(B, 128, 512, 24) for B in (48, 240, 512)]
                         + [(512, 4096, 512, 24)]
                         + [(B, d, 512, 64) for B in (8, 512) for d in (2304, 3584, 6144, 7168)])
@pytest.mark.parametrize("qs", [None, QS], ids=["median", "qs"])
def test_prod_head_kernel_vs_plain(B, d, hid, K, qs):
    """Small heads, then the served d (Mamba2, Zamba2, Llama) at batches on
    both sides of the 8-row and 128-row tiles of the hidden stage, d that
    is not a multiple of its d-slice, the Track-A head (d=64) at the
    batches of ``--mode sim`` (200) and Table 1 (350 and 700 fast, 1319
    with ``--full``), and the online heads of ``launch/bench_online.py``
    (tiny-lm's d=128, K=24: the static head on 48 prompts, the online head
    on a few hundred decode states) and of the Llama online phase (d=4096,
    K=24, 512 states), then the dense configs' widths (MiniCPM-2B 2304,
    Qwen2.5-7B 3584, Granite-20B 6144, Yi-34B 7168). The d-splits are summed in a fixed
    order, so a second call agrees with the first bit for bit."""
    args = _head_args(B, d, hid, K, cuda_device())
    p_got, q_got = ops.prod_head(*args, qs=qs)
    p_want, q_want = ref.prod_head_ref(*args, qs=qs)
    torch.testing.assert_close(p_got, p_want, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(q_got, q_want, rtol=1e-4, atol=1e-3)
    p_again, q_again = ops.prod_head(*args, qs=qs)
    assert torch.equal(p_got, p_again) and torch.equal(q_got, q_again)


@pytest.mark.gpu
@pytest.mark.parametrize("B,hid", [(1, 128), (8, 128), (33, 128), (512, 128),
                                   (8, 64), (64, 64), (24, 32)])
@pytest.mark.parametrize("qs", [None, QS], ids=["median", "qs"])
def test_prod_head_trace_features_log_edges(B, hid, qs):
    """The cluster's heads: d=4 trace features (noise-corrupted length-law
    latents, ``serving/arrivals.py``), K=32 log-spaced bins up to 4096
    (``bins.make_edges(32, 4096, "log")``). Hidden 128 is the dispatch
    head (``fit_trace_head``'s default) at its padded buckets 8 and 512, one
    row and a batch past the one-launch limit of 32; hidden 64 the refine
    table's head; hidden 32 the hazard head on its grid. d=4 is below the
    kernel's 32-row d-slice, so 28 of its rows are masked."""
    from repro_torch.core.bins import make_edges
    from repro_torch.serving.arrivals import TraceConfig, make_trace

    dev = cuda_device()
    phi = np.stack([r.phi for r in make_trace(TraceConfig(n_requests=B, seed=B))])
    rng = np.random.default_rng(4)
    arrs = [phi, rng.standard_normal((4, hid)) / 2.0, rng.standard_normal(hid) * 0.01,
            rng.standard_normal((hid, 32)) / hid ** 0.5, np.zeros(32)]
    args = [torch.from_numpy(a.astype(np.float32)).to(dev) for a in arrs]
    args.append(make_edges(32, 4096.0, "log", device=dev))
    p_got, q_got = ops.prod_head(*args, qs=qs)
    p_want, q_want = ref.prod_head_ref(*args, qs=qs)
    torch.testing.assert_close(p_got, p_want, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(q_got, q_want, rtol=1e-4, atol=1e-3)
    p_again, q_again = ops.prod_head(*args, qs=qs)
    assert torch.equal(p_got, p_again) and torch.equal(q_got, q_again)


@pytest.mark.gpu
@pytest.mark.parametrize("K", [16, 128])
@pytest.mark.parametrize("spacing", ["linear", "log"])
@pytest.mark.parametrize("qs", [None, QS], ids=["median", "qs"])
def test_prod_head_bins_ablation_grids(K, spacing, qs):
    """The bins ablation's heads (``launch/bench_bins_ablation.py``): the
    Track-A width d=64, hidden 512, on the 400 test prompts of qwen/chat at
    the fast profile, K = 16 and 128 bins (128 is the kernel's largest K)
    with linear and log edges up to the scenario's bin_max, weights at the
    head's init scales."""
    from repro_torch.core.bins import make_edges
    from repro_torch.data import make_scenario
    from repro_torch.launch.table1 import scenario_pcfg

    dev = cuda_device()
    data = make_scenario("qwen", "chat", n_train=800, n_test=400, seed=0)
    bin_max = scenario_pcfg(data, n_bins=K).bin_max
    hid = 512
    rng = np.random.default_rng(K)
    arrs = [data.phi_test["last"], rng.standard_normal((64, hid)) / 8.0,
            rng.standard_normal(hid) * 0.01, rng.standard_normal((hid, K)) / hid ** 0.5,
            np.zeros(K)]
    args = [torch.from_numpy(np.asarray(a, np.float32)).to(dev) for a in arrs]
    args.append(make_edges(K, bin_max, spacing, device=dev))
    assert args[0].shape == (400, 64)
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


@pytest.mark.gpu
@pytest.mark.parametrize("B", [8, 48])
def test_flash_attention_tiny_lm_prompts(B):
    """bench_online's prefill: tiny-lm (H=4, KV=2, hd=32, fp32) on prompts
    of 6 tokens."""
    dev = cuda_device()
    q, k, v = _qkv(7, (B, 6, 4, 32), (B, 6, 2, 32), F32, dev)
    lens = torch.full((B,), 6, dtype=torch.int32, device=dev)
    got = ops.flash_attention(q, k, v, causal=True, kv_lengths=lens)
    close(got, ref.flash_attention_ref(q, k, v, causal=True, kv_lengths=lens), F32)


def _tempered_tiny_lm():
    """tiny-lm's seeded fp32 weights with every layer's wq and wk scaled by
    0.1: at the init scales layer 0's softmax is near one-hot and one ulp
    moves the gradients by ~4e-4 of their norm (tests/test_torch_training.py),
    so devices could not be compared tightly there."""
    from repro_torch.configs import get_config
    from repro_torch.models.model_zoo import build_model

    m = build_model(get_config("tiny-lm").with_overrides(dtype="float32"))
    params = m.init(seed=0, device="cpu")
    for lp in params["layers"]:
        lp["attn"]["wq"] *= 0.1
        lp["attn"]["wk"] *= 0.1
    return m, params


@pytest.mark.gpu
def test_model_loss_and_grads_on_the_card_match_the_cpu():
    """The trainer's objective (blocked attention, plain PyTorch under
    autograd) on the card against the CPU: the loss rtol 1e-5 and every
    gradient within 1e-5 of the global norm; remat gives the card's own."""
    from repro_torch.common.pytree import tree_flatten, tree_map
    from repro_torch.data.pipeline import batch_iterator, make_lm_dataset

    dev = cuda_device()
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        m, params = _tempered_tiny_lm()
        batch = next(batch_iterator(make_lm_dataset(16, 48), 8, device="cpu"))
        out = {}
        for where, remat in (("cpu", "none"), ("cuda", "none"), ("cuda", "full")):
            p = tree_map(lambda t: t.to(where).requires_grad_(True), params)
            flat = tree_flatten(p)
            loss, _ = m.loss(p, {k: v.to(where) for k, v in batch.items()}, remat=remat)
            grads = torch.autograd.grad(loss, list(flat.values()))
            out[where, remat] = (loss.detach().cpu(), [g.cpu() for g in grads])
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    (l_cpu, g_cpu), (l_gpu, g_gpu) = out["cpu", "none"], out["cuda", "none"]
    torch.testing.assert_close(l_gpu, l_cpu, rtol=1e-5, atol=0)
    norm = float(torch.sqrt(sum((g.double() ** 2).sum() for g in g_cpu)))
    assert max(float((a - b).abs().max()) for a, b in zip(g_gpu, g_cpu)) <= 1e-5 * norm
    l_remat, g_remat = out["cuda", "full"]
    torch.testing.assert_close(l_remat, l_gpu, rtol=1e-6, atol=0)
    for a, b in zip(g_remat, g_gpu):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-7)


@pytest.mark.gpu
@pytest.mark.parametrize("S", [37, 600])
def test_blocked_attention_grads_on_the_card_match_the_cpu(S):
    """One block of keys (S=37) and two, the second ragged (S=600)."""
    from repro_torch.models.attention import blocked_attention

    dev = cuda_device()
    rng = np.random.default_rng(9)
    arrs = [rng.standard_normal(s).astype(np.float32)
            for s in ((2, S, 4, 32), (2, S, 2, 32), (2, S, 2, 32), (2, S, 4, 32))]
    res = []
    for where in ("cpu", dev):
        q, k, v = (torch.from_numpy(a).to(where).requires_grad_(True) for a in arrs[:3])
        o = blocked_attention(q, k, v)
        grads = torch.autograd.grad((o * torch.from_numpy(arrs[3]).to(where)).sum(), (q, k, v))
        res.append([o.detach().cpu()] + [g.cpu() for g in grads])
    for a, b in zip(res[1], res[0]):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-5)


@pytest.mark.gpu
@pytest.mark.parametrize("cf", [1.25, 0.3])
@pytest.mark.parametrize("dtype", [F32, BF16])
def test_moe_apply_on_the_card_matches_the_cpu(dtype, cf):
    """models/moe.py on the card (16 experts top-4 of width 256, a shared
    expert, d=512, 8 x 64 positions, the last rows right-padded) against
    the same on the CPU. The experts, routed on the CPU and given the same
    ids and combine weights on both devices: the dispatch equal, the output
    within 1e-4 (fp32, no TF32) or 2e-2 (bf16) of its scale. In fp32 the
    whole ``moe_apply``, each device routing from its own fp32 logits, agrees
    at the same tolerance and its aux at 1e-6 (in bf16 a token's k-th and
    (k+1)-th logits can fall within the two devices' fp32 rounding of each
    other, and then it routes elsewhere). A second call on the card gives the
    same bits (the combine sums each token's rows in a fixed order, no
    atomics)."""
    from repro_torch.common.config import ModelConfig
    from repro_torch.common.pytree import tree_map
    from repro_torch.models import moe

    dev = cuda_device()
    cfg = ModelConfig(name="moe-gpu", family="moe", n_layers=1, d_model=512, n_heads=8,
                      n_kv_heads=2, d_ff=256, vocab_size=64, n_experts=16,
                      n_experts_per_token=4, n_shared_experts=1, moe_d_ff=256, dtype=dtype)
    rng = np.random.default_rng(20)

    def draw(s):
        if isinstance(s, dict):
            return {k: draw(v) for k, v in s.items()}
        scale = 20 * s.scale if s.scale else 1 / np.sqrt(s.shape[-2])
        return torch.from_numpy((rng.standard_normal(s.shape) * scale).astype(np.float32))

    p_cpu = tree_map(lambda t: t.to(TDT[dtype]), draw(moe.moe_spec(cfg)))
    p_dev = tree_map(lambda t: t.to(dev), p_cpu)
    x = torch.from_numpy(rng.standard_normal((8, 64, 512)).astype(np.float32))
    x[6:, 40:] = x[6, 40]                                  # pads: one vector
    x = x.to(TDT[dtype])
    xf = x.reshape(-1, 512)
    ids, comb, _ = moe._router(xf.float() @ p_cpu["router"].float(), 4)
    cap = moe._capacity(512, 4, 16, cf)
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        for a, b in zip(moe._dispatch(ids.to(dev), comb.to(dev), 16, cap),
                        moe._dispatch(ids, comb, 16, cap)):
            assert torch.equal(a.cpu(), b)
        experts = lambda p, where: moe._expert_ffn_local(
            xf.to(where), ids.to(where), comb.to(where), p["w_gate"], p["w_up"], p["w_down"],
            cap)
        want, got = experts(p_cpu, "cpu"), experts(p_dev, dev)
        assert torch.equal(got, experts(p_dev, dev))
        tol = 1e-4 if dtype == F32 else 2e-2
        scale = float(want.float().abs().max())
        torch.testing.assert_close(got.float().cpu(), want.float(), rtol=tol, atol=tol * scale)
        out, aux = moe.moe_apply(p_dev, x.to(dev), cfg, capacity_factor=cf)
        again = moe.moe_apply(p_dev, x.to(dev), cfg, capacity_factor=cf)
        assert torch.equal(out, again[0]) and torch.equal(aux, again[1])
        if dtype == F32:
            out_cpu, aux_cpu = moe.moe_apply(p_cpu, x, cfg, capacity_factor=cf)
            scale = float(out_cpu.abs().max())
            torch.testing.assert_close(out.cpu(), out_cpu, rtol=tol, atol=tol * scale)
            torch.testing.assert_close(aux.cpu(), aux_cpu, rtol=1e-6, atol=1e-6)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def _reduced_ssm(name):
    """The reduced SSM / hybrid config in fp32 (state 16, 4 scan heads of
    32, chunk 16; Zamba2's shared block on a 16-slot window) and its seeded
    weights on the CPU, the shared block's wq and wk scaled by 0.1 as in
    :func:`_tempered_tiny_lm`."""
    from repro_torch.configs import get_config
    from repro_torch.models.model_zoo import build_model

    m = build_model(get_config(name).reduced().with_overrides(dtype="float32"))
    params = m.init(seed=0, device="cpu")
    if "shared" in params:
        params["shared"]["attn"]["wq"] *= 0.1
        params["shared"]["attn"]["wk"] *= 0.1
    return m, params


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["mamba2-130m", "zamba2-1.2b"])
def test_ssm_train_step_on_the_card_matches_the_cpu(name):
    """One train_step (AdamW, clipping; the chunked scan under autograd and
    checkpoint, S=48 in 3 chunks of 16) on the card against the CPU: the
    loss and gradient norm at rtol 1e-5, AdamW's m and sqrt(v) (0.1 g and
    ~0.03 |g| after one step) within 1e-5 of their global norm, as
    tests/test_torch_ssm_train.py holds them against the reference; dt_bias,
    which the loss never reads, keeps zero moments on both."""
    from repro_torch.common.config import TrainConfig
    from repro_torch.common.pytree import tree_map
    from repro_torch.data.pipeline import batch_iterator, make_lm_dataset
    from repro_torch.training import trainer

    dev = cuda_device()
    m, params = _reduced_ssm(name)
    ds = make_lm_dataset(16, 48)
    ds.tokens = np.minimum(ds.tokens, m.cfg.vocab_size - 1)
    batch = next(batch_iterator(ds, 4, device="cpu"))
    tcfg = TrainConfig(lr=3e-3, warmup_steps=3, decay_steps=10, remat="full")
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    out = {}
    try:
        for where in ("cpu", dev):
            state = trainer.init_state(m, 0, tcfg, device=where,
                                       params=tree_map(lambda t: t.clone().to(where), params))
            state, met = trainer.make_train_step(m, tcfg)(
                state, {k: v.to(where) for k, v in batch.items()})
            out[str(where)] = (met, tree_map(lambda t: t.cpu(), state.opt_state))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    (met_cpu, opt_cpu), (met_gpu, opt_gpu) = out["cpu"], out[str(dev)]
    for k in ("loss", "grad_norm"):
        torch.testing.assert_close(met_gpu[k].cpu(), met_cpu[k], rtol=1e-5, atol=0)
    for name_, f in (("m", lambda t: t), ("v", torch.sqrt)):
        norm = float(torch.sqrt(sum((f(t).double() ** 2).sum() for t in opt_cpu[name_].values())))
        gap = max(float((f(opt_gpu[name_][k]) - f(opt_cpu[name_][k])).abs().max())
                  for k in opt_cpu[name_])
        assert gap <= 1e-5 * norm, (name_, gap, norm)
    dt_bias = [k for k in opt_gpu["m"] if k.endswith("/ssm/dt_bias")]
    assert len(dt_bias) == m.cfg.n_layers
    assert not any(opt_gpu["m"][k].any() for k in dt_bias)


@pytest.mark.gpu
@pytest.mark.parametrize("name,dtype", [("zamba2-1.2b", F32), ("yi-34b", BF16)])
def test_int8_decode_on_the_card_matches_the_cpu(name, dtype):
    """Decode on the int8 KV cache (``init_cache(kv_quant=True)``): the
    decode kernel on the dequantized K/V, against the CPU's plain version.
    Reduced Zamba2 in fp32, its shared block's 16-slot ring fed 20 tokens
    (it wraps), and reduced Yi-34B in bf16 on a full cache. Each step starts
    both devices from the CPU's cache (an int8 code one off at a rounding
    tie would move the logits by ~7e-4 of their scale,
    tests/test_torch_kv_quant.py); the logits are held within 1e-4 (fp32)
    or 2e-2 (bf16) of their scale, the kernel launched once per attention
    layer and step."""
    from repro_torch.common.pytree import tree_map
    from repro_torch.configs import get_config
    from repro_torch.kernels.decode_attention import decode_attention_cuda
    from repro_torch.models.model_zoo import build_model
    from repro_torch.models.transformer import layer_kinds

    dev = cuda_device()
    m = build_model(get_config(name).reduced().with_overrides(dtype=dtype))
    params = m.init(seed=0, device="cpu")
    p_dev = tree_map(lambda t: t.to(dev), params)
    n_attn = sum(k != "ssm" for k in layer_kinds(m.cfg))
    B, T = 3, 20
    assert T > (m.cfg.attn_window or 0)
    cache = m.init_cache(B, 24, device="cpu", kv_quant=True)
    forced = torch.from_numpy(np.random.default_rng(3).integers(3, m.cfg.vocab_size, (T, B)))
    tol = 1e-4 if dtype == F32 else 2e-2
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        for t in range(T):
            pos = torch.full((B,), t, dtype=torch.int32)
            c_dev = tree_map(lambda x: x.to(dev), cache)
            before = decode_attention_cuda.launches
            got, _ = m.decode_step(p_dev, forced[t].to(dev), c_dev, pos.to(dev), pos.to(dev) + 1)
            assert decode_attention_cuda.launches == before + n_attn
            want, _ = m.decode_step(params, forced[t], cache, pos, pos + 1)
            scale = float(want.float().abs().max())
            torch.testing.assert_close(got.float().cpu(), want.float(), rtol=tol,
                                       atol=tol * scale)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


@pytest.mark.gpu
@pytest.mark.parametrize("S,decay", [(512, 0.5), (509, 0.01), (65, 1.0)])
def test_ssd_scan_p32_n32_fp32(S, decay):
    """(P, N) = (32, 32), the reference's kernel bench widths, in fp32: the
    CUDA-core kernel, held against the plain version at 2e-4 and
    bit-identical on a second call (``_check_ssd``)."""
    _check_ssd(_ssd_args(F32, 2, S, 8, 32, 32, decay, cuda_device()), F32)


@pytest.mark.gpu
def test_ssd_scan_p32_n32_bf16_is_refused():
    """The tensor-core kernel takes P = 64 alone: bf16 at (32, 32) is refused
    by the launch, and the wrapper raises, counting no launch."""
    from repro_torch.kernels.ssd_scan import ssd_scan_cuda

    args = _ssd_args(BF16, 1, 64, 2, 32, 32, 1.0, cuda_device())
    before = ssd_scan_cuda.launches
    with pytest.raises(RuntimeError, match="P=32, N=32"):
        ops.ssd_scan(*args)
    assert ssd_scan_cuda.launches == before


@pytest.mark.gpu
def test_bench_kernels_measure_on_the_card():
    """The kernel bench's four rows at the reference's shapes: each kernel
    within its tolerance of its plain version and bit-identical on a second
    call (``measure`` raises otherwise), timed, with its bound."""
    from repro_torch.launch import bench_kernels

    dev = cuda_device()
    rows = bench_kernels.measure(dev, iters=3)
    assert [r["row"] for r in rows] == ["flash_attention_512", "decode_attention_4k",
                                        "ssd_scan_512", "prod_head_128x1024"]
    for r in rows:
        assert r["ms"] > 0 and r["device_ms"] > 0 and r["bound_ms"] > 0
        assert (r["library_ms"] is None) == (r["name"] == "ssd_scan")
