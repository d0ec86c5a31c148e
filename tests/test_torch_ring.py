"""Ring KV caches of the port against the JAX package, in fp32 on the CPU.

- The value of a prefill query row with no valid key: the port's plain
  flash version against the reference model's blocked attention
  (``repro/models/attention.py:72-171``) at key lengths that are not a
  multiple of its 512-key blocks, where the row is sum(v) / Skv_pad.
- Whole models whose windowed layers decode on rings, with the reference's
  weights carried across: reduced Zamba2-1.2B (the shared block, window 16)
  and tiny-lm with ``attn_window=16`` (every layer ``local``, its own rope
  base). The prompts are right-padded to S=20 > W, so the prefill's ring
  holds its last 16 padded positions (the reference's
  ``_ring_from_prefill``); one row (3 tokens) is shorter than S - W, so its
  padded queries near the end have no valid key, and its decode attends to
  pad K/V, as in the reference. Then teacher-forced decode steps that cross
  the window on the rows between W and S, against the reference's
  ``decode_step`` on its ring.

Tolerance as in test_torch_models.py: 1e-4 relative to each tensor's
largest magnitude. S stays apart from W, the batch and the SSM head count,
so the reference engine's ``_grow_cache`` grows only full caches. The
windowed tiny-lm runs twice. Once with the reference's weights with wq and
wk scaled by 0.1, as test_torch_training.py does for its well-conditioned
case, held at that tolerance. And once at the reference's own init, where a
16-key window leaves layer 0's softmax near one-hot: there one ulp more on
every weight moves the reference's own prefill logits by 1.2e-4 (scaled,
7e-7), more than 1e-4 of their scale, so each tensor is held within three
times the reference's own one-ulp spread on that tensor, or 1e-4 of its
scale where that is larger, as test_torch_training.py holds train_loop at
the reference's init (measured: the port is at most 2.7e-4 of a tensor's
scale off, 1.6 times the spread, on the prefill logits).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_parity import close, jax, jnp, np_tree, port_config  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.models import attention as jattention  # noqa: E402
from repro.models.model_zoo import Runtime  # noqa: E402
from repro.models.model_zoo import build_model as jbuild_model  # noqa: E402
from repro.models.transformer import layer_plan as jlayer_plan  # noqa: E402
from repro.serving.engine import RealEngine as JRealEngine  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.models import attention  # noqa: E402
from repro_torch.models.convert import from_jax_params  # noqa: E402
from repro_torch.models.model_zoo import build_model  # noqa: E402
from repro_torch.models.transformer import layer_kinds  # noqa: E402

LENS = np.array([20, 13, 3], np.int32)
S, T, W = 20, 7, 16


def near(got, want):
    want = np.asarray(want, np.float32)
    close(got, want, rtol=1e-4, atol=1e-4 * max(float(np.abs(want).max()), 1.0))


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# --------------------------------------------------------------------------
# a query row with no valid key
# --------------------------------------------------------------------------


@pytest.mark.parametrize("Skv,window,lens", [
    (600, 64, (600, 5)),        # padded to 1024: rows 68.. of row 1 are empty
    (1030, 100, (2, 1030)),     # three blocks of 512, the last ragged
    (700, 0, (0, 700)),         # a row with no key at all, no window
])
def test_empty_row_value_matches_the_reference(Skv, window, lens):
    rng = np.random.default_rng(4)
    q, k, v = (rng.standard_normal((2, Skv, h, 8)).astype(np.float32) for h in (2, 1, 1))
    valid = np.arange(Skv)[None, :] < np.array(lens)[:, None]
    want = jattention.blocked_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                        causal=True, window=window,
                                        kv_valid=jnp.asarray(valid))
    got = ops.flash_attention(*(torch.from_numpy(a) for a in (q, k, v)), causal=True,
                              window=window, kv_lengths=torch.tensor(lens, dtype=torch.int32))
    near(got, want)
    qpos, ln = np.arange(Skv)[None, :], np.array(lens)[:, None]
    empty = (ln == 0) | ((qpos >= ln + window - 1) if window else False)
    assert empty.any()
    # the empty rows are sum(v) / Skv_pad, which the old softmax (a mean over
    # Skv) would not give here
    pad = -(-Skv // 512) * 512
    b, s = np.argwhere(empty)[0]
    np.testing.assert_allclose(np.asarray(want)[b, s, 0], v[b].sum(0)[0] / pad, rtol=1e-5,
                               atol=1e-6)
    assert not np.allclose(v[b].sum(0)[0] / pad, v[b].mean(0)[0], rtol=1e-3)
    close(ref.empty_row_value(torch.from_numpy(v))[b, 0], v[b].sum(0)[0] / pad, 1e-5, 1e-6)


def test_ring_helpers():
    lengths = torch.tensor([3, 16, 17, 40], dtype=torch.int32)
    assert attention.ring_cache_valid(lengths, 16).tolist() == [3, 16, 16, 16]
    want = np.asarray(jattention.ring_cache_valid(jnp.asarray(lengths.numpy()), 16))
    np.testing.assert_array_equal(np.arange(16)[None, :] <
                                  attention.ring_cache_valid(lengths, 16).numpy()[:, None], want)


# --------------------------------------------------------------------------
# whole models on rings
# --------------------------------------------------------------------------


def _zamba():
    return jget_config("zamba2-1.2b").reduced().with_overrides(dtype="float32")


def _windowed_tiny():
    return jget_config("tiny-lm").with_overrides(dtype="float32", attn_window=W,
                                                 rope_theta_local=500.0)


# name -> (config, wq/wk scale)
CONFIGS = {"zamba2-reduced": (_zamba, 1.0), "tiny-lm-window16": (_windowed_tiny, 0.1),
           "tiny-lm-window16-init": (_windowed_tiny, 1.0)}


@pytest.fixture(scope="module", params=list(CONFIGS))
def models(request):
    make, scale = CONFIGS[request.param]
    jcfg = make()
    assert jcfg.attn_window == W
    jm = jbuild_model(jcfg)
    jparams = jm.init(jax.random.PRNGKey(0))
    if scale != 1.0:
        for seg in jparams["segments"]:
            for layer in seg.values():
                layer["attn"]["wq"] = layer["attn"]["wq"] * scale
                layer["attn"]["wk"] = layer["attn"]["wk"] * scale
    cfg = port_config(jcfg)
    return (jm, jparams, build_model(cfg), from_jax_params(np_tree(jparams), cfg, device="cpu"),
            request.param.endswith("-init"))


def _prompts(vocab):
    rng = np.random.default_rng(0)
    toks = rng.integers(3, vocab, (len(LENS), S)).astype(np.int32)
    valid = np.arange(S)[None, :] < LENS[:, None]
    return np.where(valid, toks, 0), valid


def _reference_entries(jcfg, jcache):
    for seg, seg_cache in zip(jlayer_plan(jcfg), jcache):
        for i in range(seg.n_blocks):
            for j in range(len(seg.kinds)):
                yield jax.tree_util.tree_map(lambda a: a[i], seg_cache[f"layer_{j}"])


def test_windowed_layers_follow_the_plan(models):
    jm, _, m, _, _ = models
    kinds = [k for seg in jlayer_plan(jm.cfg) for _ in range(seg.n_blocks) for k in seg.kinds]
    assert layer_kinds(m.cfg) == kinds
    assert {"local", "shared_attn"} & set(kinds)
    cache = m.init_cache(len(LENS), S + T, device="cpu")
    for kind, entry in zip(kinds, cache):
        if kind != "ssm":
            assert entry[0].shape[1] == W          # min(window, cache_len)
    cache = m.init_cache(len(LENS), 9, device="cpu")
    assert all(e[0].shape[1] == 9 for k, e in zip(kinds, cache) if k != "ssm")


def _forced(vocab):
    return np.random.default_rng(1).integers(3, vocab, (T, len(LENS))).astype(np.int32)


def _reference_run(jm, jparams, toks, valid):
    """The reference's prefill, its decode cache (the ring from the last W
    padded positions) and T teacher-forced decode steps across the window:
    every tensor in order, as NumPy."""
    rt = Runtime.local()
    out = []
    jlogits, jhidden, jcache, _ = jm.prefill(
        jparams, {"tokens": jnp.asarray(toks), "attn_valid": jnp.asarray(valid)}, rt)
    jcache = JRealEngine._grow_cache(None, jcache, S + T, S)
    out += [jlogits, jhidden]
    for e in _reference_entries(jm.cfg, jcache):
        out += [e["h"]] if "h" in e else [e["k"], e["v"]]
    jlen = jnp.asarray(LENS)
    for tok in _forced(jm.cfg.vocab_size):
        jlogits, jhid, jcache = jm.decode_step(
            jparams, {"tokens": jnp.asarray(tok), "pos": jlen, "lengths": jlen + 1}, jcache, rt)
        out += [jlogits, jhid]
        jlen = jlen + 1
    out += [e["k"] for e in _reference_entries(jm.cfg, jcache) if "k" in e]
    return [np.asarray(a, np.float32) for a in out]


def _port_run(m, params, toks, valid):
    """The port's counterpart of :func:`_reference_run`, in the same order."""
    out = []
    logits, hidden, cache = m.prefill(params, torch.from_numpy(toks).long(),
                                      attn_valid=torch.from_numpy(valid))
    cache = m.decode_cache(cache, S + T)
    out += [logits, hidden]
    for e in cache:
        if isinstance(e, dict):
            out.append(e["h"])
        else:                 # the ring from the last W padded positions
            assert e[0].shape[1] == W
            out += [t.clone() for t in e]      # decode_step writes in place
    tlen = torch.from_numpy(LENS)
    for tok in _forced(m.cfg.vocab_size):
        out += list(m.decode_step(params, torch.from_numpy(tok).long(), cache, tlen, tlen + 1))
        tlen = tlen + 1
    assert int(tlen[1]) > W and int(tlen[0]) > S      # crossed and wrapped
    out += [e[0] for e in cache if not isinstance(e, dict)]
    return [t.detach().numpy() for t in out]


def one_ulp_up(tree):
    return jax.tree_util.tree_map(
        lambda a: jnp.asarray(np.nextafter(np.asarray(a), np.float32(np.inf))), tree)


def test_ring_decode_past_the_window_matches_the_reference(models):
    jm, jparams, m, params, at_init = models
    toks, valid = _prompts(m.cfg.vocab_size)
    want = _reference_run(jm, jparams, toks, valid)
    got = _port_run(m, params, toks, valid)
    assert len(got) == len(want)
    if not at_init:
        for g, w in zip(got, want):     # padded rows with no valid key included
            near(g, w)
        return
    moved = _reference_run(jm, one_ulp_up(jparams), toks, valid)
    spread = [float(np.abs(a - w).max()) for a, w in zip(moved, want)]
    scale = [max(float(np.abs(w).max()), 1.0) for w in want]
    assert spread[0] > 1e-4 * scale[0]          # the prefill logits: ill-conditioned
    for i, (g, w) in enumerate(zip(got, want)):
        err = float(np.abs(g - w).max())
        assert err <= max(3 * spread[i], 1e-4 * scale[i]), (i, err, spread[i], scale[i])


def test_engine_generates_past_the_window(models):
    from repro_torch.serving.engine import RealEngine

    _, _, m, params, _ = models
    toks, _ = _prompts(m.cfg.vocab_size)
    out = RealEngine(m, params, max_new=T, eos_id=-1).generate(
        toks, LENS, torch.Generator().manual_seed(0), collect_per_step=True)
    assert (out["lengths"] == T).all()
    assert out["step_hidden"].shape == (len(LENS), T, m.cfg.d_model)
    assert np.isfinite(out["step_hidden"]).all()
