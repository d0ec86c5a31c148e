"""Port kernels: the plain PyTorch versions against the JAX oracles (and the
Pallas kernel in interpret mode for prod_head) on the shape sweeps of
tests/test_kernels.py, at that file's tolerances. The CUDA kernels against
their plain versions: tests/test_torch_kernels_gpu.py."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_parity import close, jnp  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.models.attention import blocked_attention  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402

F32, BF16 = "float32", "bfloat16"
JDT = {F32: jnp.float32, BF16: jnp.bfloat16}
TDT = {F32: torch.float32, BF16: torch.bfloat16}


def _tol(dtype):
    return dict(rtol=2e-2, atol=2e-2) if dtype == BF16 else dict(rtol=2e-5, atol=2e-5)


def _both(a, dtype):
    """One numpy array as a jnp and a torch tensor of the same dtype (both
    round fp32 -> bf16 to nearest-even, so the inputs are identical)."""
    return jnp.asarray(a, JDT[dtype]), torch.from_numpy(a).to(TDT[dtype])


def _qkv(seed, qshape, kvshape, dtype):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal(qshape).astype(np.float32)
    k = rng.standard_normal(kvshape).astype(np.float32)
    v = rng.standard_normal(kvshape).astype(np.float32)
    return [_both(x, dtype) for x in (q, k, v)]


@pytest.mark.parametrize("B,S,H,KV,hd", [
    (1, 33, 4, 4, 32),    # MHA, ragged seq
    (2, 64, 8, 2, 64),    # GQA
    (1, 96, 4, 1, 16),    # MQA
])
@pytest.mark.parametrize("dtype", [F32, BF16])
@pytest.mark.parametrize("causal,window", [(True, 0), (True, 17), (False, 0)])
def test_flash_attention_plain_vs_jax(B, S, H, KV, hd, dtype, causal, window):
    (jq, tq), (jk, tk), (jv, tv) = _qkv(0, (B, S, H, hd), (B, S, KV, hd), dtype)
    want = jref.flash_attention_ref(jq, jk, jv, causal=causal, window=window)
    got = ops.flash_attention(tq, tk, tv, causal=causal, window=window)
    assert got.dtype == TDT[dtype]
    close(got, want, **_tol(dtype))


@pytest.mark.parametrize("dtype", [F32, BF16])
def test_flash_attention_ragged_kv_lengths_vs_jax_model(dtype):
    """Per-row key lengths reproduce the reference model's right-padding mask
    (``kv_valid`` in repro.models.attention.blocked_attention)."""
    B, S, H, KV, hd = 3, 40, 4, 2, 32
    (jq, tq), (jk, tk), (jv, tv) = _qkv(1, (B, S, H, hd), (B, S, KV, hd), dtype)
    lens = np.array([40, 23, 5], np.int32)
    valid = np.arange(S)[None, :] < lens[:, None]
    want = blocked_attention(jq, jk, jv, causal=True, kv_valid=jnp.asarray(valid),
                             block_q=16, block_kv=16)
    got = ops.flash_attention(tq, tk, tv, causal=True,
                              kv_lengths=torch.from_numpy(lens))
    close(got, want, **_tol(dtype))


def test_flash_attention_ref_q_offset_vs_jax():
    (jq, tq), (jk, tk), (jv, tv) = _qkv(2, (2, 8, 4, 16), (2, 24, 2, 16), F32)
    close(ref.flash_attention_ref(tq, tk, tv, q_offset=16),
          jref.flash_attention_ref(jq, jk, jv, q_offset=16), rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("B,Sc,H,KV,hd", [(2, 100, 8, 2, 64), (1, 40, 4, 4, 32)])
@pytest.mark.parametrize("dtype", [F32, BF16])
def test_decode_attention_plain_vs_jax(B, Sc, H, KV, hd, dtype):
    (jq, tq), (jk, tk), (jv, tv) = _qkv(3, (B, H, hd), (B, Sc, KV, hd), dtype)
    lens = np.random.default_rng(0).integers(1, Sc + 1, B).astype(np.int32)
    want = jref.decode_attention_ref(jq, jk, jv, jnp.asarray(lens))
    got = ops.decode_attention(tq, tk, tv, torch.from_numpy(lens))
    close(got, want, **_tol(dtype))


def _head_inputs(B, d, hid, K, seed=3):
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal((B, d)).astype(np.float32),
            (rng.standard_normal((d, hid)) * 0.2).astype(np.float32),
            (rng.standard_normal(hid) * 0.01).astype(np.float32),
            (rng.standard_normal((hid, K)) * 0.2).astype(np.float32),
            np.zeros(K, np.float32),
            np.linspace(0.0, 512.0, K + 1).astype(np.float32)]
    return [jnp.asarray(a) for a in arrs], [torch.from_numpy(a) for a in arrs]


QS = [0.1, 0.5, 0.9, 0.99]


@pytest.mark.parametrize("B,d,hid,K", [(7, 32, 16, 8), (33, 96, 64, 32)])
@pytest.mark.parametrize("qs", [None, QS], ids=["median", "qs"])
@pytest.mark.parametrize("oracle", ["xla", "interpret"])
def test_prod_head_plain_vs_jax(B, d, hid, K, qs, oracle):
    jargs, targs = _head_inputs(B, d, hid, K)
    jqs = None if qs is None else jnp.asarray(qs, jnp.float32)
    p_want, q_want = jops.prod_head(*jargs, qs=jqs, block_b=8, impl=oracle)
    p_got, q_got = ops.prod_head(*targs, qs=qs)
    close(p_got, p_want, rtol=1e-5, atol=1e-6)
    close(q_got, q_want, rtol=1e-4, atol=1e-3)
    assert tuple(q_got.shape) == ((B,) if qs is None else (B, len(qs)))
