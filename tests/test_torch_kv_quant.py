"""The int8 KV cache in the port against the JAX package, in fp32 on the CPU.

- ``_quantize_kv`` against the reference's on fp32 and bf16 K/V rows (a
  zero row among them): the codes equal but for at most 1e-3 of them, which
  may differ by one at a rounding tie (t / scale one ulp apart); the scales
  at rtol 1e-6.
- The reference's own two gates (``tests/test_perf_variants.py:17, :46``)
  on the port: Yi-34B reduced, 12 teacher-forced steps into a plain and an
  int8 cache, the median |logit gap| below 0.1 max|logit| + 0.05; the int8
  cache under 0.65x the plain one's bytes at (4, 64), and both byte counts
  equal to the reference's ``cache_shapes``.
- Teacher-forced decode from an empty int8 cache against the reference's
  ``decode_step`` on its ``init_cache(kv_quant=True)``, the reference's
  weights carried across: reduced Yi-34B (full layers), Gemma3-27B (a local
  layer on a 16-slot ring, fed 20 tokens: past its window) and Zamba2-1.2B
  (the shared block's ring, fed past it too). Each step starts from the
  reference's cache: logits at 1e-4 of their scale (test_torch_models.py's
  tolerance), the new codes equal but for 1e-3 of them (off by one: each
  package quantizes K/V computed in its own order), the new scales (max|K|
  / 127) at rtol 1e-4, the models' own tolerance; the port's own cache, carried through all steps, within the
  reference's gate.
- An encoder-decoder's cache is the same with ``kv_quant``, as the
  reference's.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_parity import CPU, close, jax, jnp, np_tree, port_config  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.models import transformer as jtransformer  # noqa: E402
from repro.models.model_zoo import Runtime  # noqa: E402
from repro.models.model_zoo import build_model as jbuild_model  # noqa: E402
from repro.models.transformer import layer_plan as jlayer_plan  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import transformer  # noqa: E402
from repro_torch.models.convert import from_jax_params  # noqa: E402
from repro_torch.models.model_zoo import build_model  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def near(got, want):
    want = np.asarray(want, np.float32)
    close(got, want, rtol=1e-4, atol=1e-4 * max(float(np.abs(want).max()), 1.0))


def codes_match(got, want, share=1e-3):
    """int8 codes equal but for at most ``share`` of them, off by one."""
    got, want = np.asarray(got, np.int32), np.asarray(want, np.int32)
    diff = np.abs(got - want)
    assert diff.max() <= 1, diff.max()
    assert diff.mean() <= share, diff.mean()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_kv_matches_the_reference(dtype):
    rng = np.random.default_rng(0)
    t = rng.standard_normal((16, 8, 128)) * np.exp(rng.standard_normal((16, 8, 1)))
    t[3, 2] = 0.0                                     # scale 0: codes 0
    jt = jnp.asarray(t.astype(np.float32)).astype(dtype)
    jq, js = jtransformer._quantize_kv(jt)
    q, s = transformer._quantize_kv(torch.from_numpy(np.array(jt.astype(jnp.float32)))
                                    .to(getattr(torch, dtype)))
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    codes_match(q.numpy(), jq)
    close(s, js, rtol=1e-6, atol=0)
    assert not q[3, 2].any() and float(s[3, 2]) == 0.0


def test_int8_kv_single_step_error_small():
    """The reference's gate (tests/test_perf_variants.py:17) on the port: both
    caches fed the same 12 tokens, the median gap below 0.1 scale + 0.05."""
    cfg = get_config("yi-34b").reduced().with_overrides(dtype="float32")
    m = build_model(cfg)
    params = m.init(seed=0, device=CPU)
    B, S = 2, 12
    toks = torch.from_numpy(np.random.default_rng(1).integers(1, cfg.vocab_size, (B, S + 1)))
    cache_fp = m.init_cache(B, S + 2, device=CPU)
    cache_q = m.init_cache(B, S + 2, device=CPU, kv_quant=True)
    assert all(len(e) == 4 and e[0].dtype == torch.int8 for e in cache_q)
    for t in range(S):
        pos = torch.full((B,), t, dtype=torch.int32)
        lf, _ = m.decode_step(params, toks[:, t], cache_fp, pos, pos + 1)
        lq, _ = m.decode_step(params, toks[:, t], cache_q, pos, pos + 1)
    scale = float(lf.abs().max())
    err = float((lf - lq).abs().median())
    assert 0 < err < 0.1 * scale + 0.05, (err, scale)


def test_int8_cache_memory_is_half():
    """The reference's gate (tests/test_perf_variants.py:46) on the port's
    byte count, which is the reference's ``cache_shapes``' sizes."""
    jm = jbuild_model(jget_config("yi-34b").reduced())
    m = build_model(get_config("yi-34b").reduced())
    size = lambda tree: sum(int(np.prod(s.shape)) * jnp.dtype(s.dtype).itemsize
                            for s in jax.tree_util.tree_leaves(tree))
    fp, q8 = m.cache_bytes(4, 64), m.cache_bytes(4, 64, kv_quant=True)
    assert fp == size(jm.cache_shapes(4, 64))
    assert q8 == size(jm.cache_shapes(4, 64, kv_quant=True))
    assert q8 < 0.65 * fp


def _reference_entries(jcfg, jcache):
    for seg, seg_cache in zip(jlayer_plan(jcfg), jcache):
        for i in range(seg.n_blocks):
            for j in range(len(seg.kinds)):
                yield jax.tree_util.tree_map(lambda a: a[i], seg_cache[f"layer_{j}"])


def _as_port_cache(jcfg, jcache):
    """The reference's cache pytree as the port's per-layer list."""
    out = []
    for e in _reference_entries(jcfg, jcache):
        t = {k: torch.from_numpy(np.array(v)) for k, v in e.items()}
        out.append(t if "h" in t else (t["k"], t["v"], t["k_s"], t["v_s"]))
    return out


@pytest.mark.parametrize("arch", ["yi-34b", "gemma3-27b", "zamba2-1.2b"])
def test_int8_decode_matches_the_reference(arch):
    """Each step starts both packages from the reference's cache (an int8
    code one off at a tie moves the logits by ~7e-4 of their scale, so
    caches run apart would test the ties, not the step); the step's logits
    and hidden state are then held at 1e-4, its new codes off by one at a
    share of 1e-3 at most (measured: 4 of 61,440 on Yi-34B), its new scales
    at rtol 1e-4. A separate run from an empty cache carries the port's own
    cache through all the steps and holds the logits to the reference's
    within the quantization's gate (tests/test_perf_variants.py:17)."""
    jcfg = jget_config(arch).reduced().with_overrides(dtype="float32")
    jm = jbuild_model(jcfg)
    jparams = jm.init(jax.random.PRNGKey(0))
    cfg = port_config(jcfg)
    m = build_model(cfg)
    params = from_jax_params(np_tree(jparams), cfg, device=CPU)
    B, T, cache_len = 3, 20, 24
    rings = [k for k in transformer.layer_kinds(cfg) if transformer._window(cfg, k)]
    assert (arch == "yi-34b") == (not rings)
    assert not rings or T > cfg.attn_window            # a ring wraps
    forced = np.random.default_rng(1).integers(3, cfg.vocab_size, (T, B)).astype(np.int32)
    rt = Runtime.local()
    step = jax.jit(lambda p, b, c: jm.decode_step(p, b, c, rt))
    jcache = jm.init_cache(B, cache_len, kv_quant=True)
    own = m.init_cache(B, cache_len, device=CPU, kv_quant=True)
    codes = off = 0
    for t in range(T):
        cache = _as_port_cache(jcfg, jcache)
        jpos = jnp.full((B,), t, jnp.int32)
        jlogits, jhid, jcache = step(jparams, {"tokens": jnp.asarray(forced[t]), "pos": jpos,
                                               "lengths": jpos + 1}, jcache)
        pos = torch.full((B,), t, dtype=torch.int32)
        tok = torch.from_numpy(forced[t]).long()
        logits, hid = m.decode_step(params, tok, cache, pos, pos + 1)
        near(logits, jlogits)
        near(hid, jhid)
        for entry, jentry in zip(cache, _as_port_cache(jcfg, jcache)):
            if isinstance(entry, dict):
                continue
            for c, jc in zip(entry[:2], jentry[:2]):
                diff = (c.to(torch.int32) - jc.to(torch.int32)).abs()
                assert int(diff.max()) <= 1
                codes, off = codes + B * c.shape[2] * c.shape[3], off + int(diff.sum())
            close(entry[2], jentry[2], rtol=1e-4, atol=1e-7)
            close(entry[3], jentry[3], rtol=1e-4, atol=1e-7)
        own_logits, _ = m.decode_step(params, tok, own, pos, pos + 1)
        gap = float((own_logits - torch.from_numpy(np.array(jlogits))).abs().median())
        assert gap < 0.1 * float(np.abs(np.asarray(jlogits)).max()) + 0.05
    assert off <= 1e-3 * codes, (off, codes)


def test_encdec_cache_is_unchanged_by_kv_quant():
    jm = jbuild_model(jget_config("whisper-large-v3").reduced())
    m = build_model(get_config("whisper-large-v3").reduced())
    shapes = lambda cache: [{n: (tuple(t.shape), t.dtype) for n, t in e.items()} for e in cache]
    assert shapes(m.init_cache(2, 16, device=CPU, kv_quant=True)) == \
        shapes(m.init_cache(2, 16, device=CPU))
    assert m.cache_bytes(2, 16, kv_quant=True) == m.cache_bytes(2, 16)
    same = jax.tree_util.tree_map(lambda a, b: a == b, jm.cache_shapes(2, 16, kv_quant=True),
                                  jm.cache_shapes(2, 16))
    assert all(jax.tree_util.tree_leaves(same))
