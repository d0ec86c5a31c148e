"""Gemma3-27B in the port against the JAX package, in fp32 on the CPU, with
the reference's weights carried across (``models/convert.py``).

Three models, each built on both sides:

- the reference's ``gemma3-27b.reduced()``: one ``local`` layer (window 16,
  its own rope base) and one ``full`` one, ``qk_norm``, the tanh-GELU gated
  MLP, tied embeddings, hd 64;
- the same at Gemma3's head width, hd=168 (2 query heads on 1 KV head);
- an 8-layer 5:1 plan: one block of 5 ``local`` + 1 ``full`` and the
  2-layer ``local`` remainder segment, as the 62-layer config has.

On each: prefill logits, hidden states and K/V on ragged right-padded
prompts longer than the window (S=20 > W=16; the 3-token row's padded
queries near the end have no valid key), the decode cache (the ``local``
layers' rings from the last 16 padded positions), then teacher-forced
decode steps past the window. Tolerance as in test_torch_dense_configs.py:
1e-4 relative to each tensor's largest magnitude. Beside the models: the
plan and parameter counts of the full config, ``qk_norm`` and the gate,
the plain attention versions at hd=168 against the reference's kernels
(Pallas in interpret mode, as tests/test_kernels.py runs them) and its
blocked attention at 2e-5, windowed ``blocked_attention`` at S > 512, and
``train_loop`` on the reduced model against the reference's losses.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_parity import close, jax, jnp, np_tree, port_config  # noqa: E402

from repro.common.config import TrainConfig as JTrainConfig  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.data import pipeline as jpipeline  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.models import attention as jattention  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro.models.model_zoo import Runtime  # noqa: E402
from repro.models.model_zoo import build_model as jbuild_model  # noqa: E402
from repro.models.transformer import layer_plan as jlayer_plan  # noqa: E402
from repro.models.transformer import model_spec as jmodel_spec  # noqa: E402
from repro.serving.engine import RealEngine as JRealEngine  # noqa: E402
from repro.training import trainer as jtrainer  # noqa: E402
from repro_torch.common.config import TrainConfig  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.data import pipeline  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.models import attention, layers  # noqa: E402
from repro_torch.models.convert import from_jax_params  # noqa: E402
from repro_torch.models.model_zoo import build_model  # noqa: E402
from repro_torch.models.transformer import layer_kinds, layer_plan  # noqa: E402
from repro_torch.training import trainer  # noqa: E402

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


def _reduced(**over):
    return jget_config("gemma3-27b").reduced().with_overrides(dtype="float32", **over)


CONFIGS = {"reduced": {}, "hd168": dict(n_heads=2, n_kv_heads=1, head_dim=168),
           "plan8": dict(n_layers=8, local_global_ratio=5)}


# --------------------------------------------------------------------------
# the config
# --------------------------------------------------------------------------


def _leaf_count(spec):
    if isinstance(spec, dict):
        return sum(_leaf_count(v) for v in spec.values())
    if isinstance(spec, list):
        return sum(_leaf_count(v) for v in spec)
    return int(np.prod(spec.shape))


def test_config_plan_and_parameter_counts():
    """A copy of the reference's config: 10 blocks of 5 local + 1 full and a
    remainder of 2 local layers, hd = 5376 / 32 = 168. ``param_count()``
    keeps the reference's count of a gelu_gated MLP as two matrices (21.12
    B); the leaves hold three (28.29 B)."""
    mine, theirs = get_config("gemma3-27b"), jget_config("gemma3-27b")
    assert mine == port_config(theirs)
    assert mine.head_dim == 168 and mine.q_per_kv == 2
    plan = [(s.kinds, s.n_blocks) for s in layer_plan(mine)]
    assert plan == [(s.kinds, s.n_blocks) for s in jlayer_plan(theirs)]
    assert plan == [(("local",) * 5 + ("full",), 10), (("local",) * 2, 1)]
    kinds = layer_kinds(mine)
    assert len(kinds) == 62 and kinds.count("local") == 52
    assert mine.param_count() == theirs.param_count() == 21_120_024_576
    leaves = _leaf_count(build_model(mine).spec())
    assert leaves == _leaf_count(jmodel_spec(theirs)) and round(leaves / 1e9, 2) == 28.29
    for over in CONFIGS.values():
        assert port_config(_reduced(**over)) == get_config("gemma3-27b").reduced().with_overrides(
            dtype="float32", **over)


# --------------------------------------------------------------------------
# qk_norm and the gate
# --------------------------------------------------------------------------


def test_qk_norm_matches_the_reference():
    """q and k RMS-normalised over hd (scales (1 + w), w drawn here so the
    norm's weights count) before RoPE, at hd=168."""
    jcfg = _reduced(**CONFIGS["hd168"])
    cfg = port_config(jcfg)
    rng = np.random.default_rng(0)
    p = {k: rng.standard_normal(s.shape).astype(np.float32) * (0.3 if "norm" in k else 0.06)
         for k, s in attention.attn_spec(cfg).items()}
    assert set(p) == set(jattention.attn_spec(jcfg)) >= {"q_norm", "k_norm"}
    x = rng.standard_normal((2, 5, cfg.d_model)).astype(np.float32)
    ang = (np.arange(5)[None, :, None] * rng.random(cfg.head_dim // 2)).astype(np.float32)
    ang = np.broadcast_to(ang, (2, 5, cfg.head_dim // 2)).copy()
    want = jattention.qkv_project({k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x),
                                  jcfg, jnp.asarray(ang))
    got = attention.qkv_project({k: torch.from_numpy(v) for k, v in p.items()},
                                torch.from_numpy(x), cfg, torch.from_numpy(ang))
    for g, w in zip(got, want):
        close(g, w, rtol=1e-5, atol=1e-5)


def test_gelu_gate_is_the_tanh_form():
    """gelu_gated is jax.nn.gelu, whose default is the tanh approximation.
    The erf form is another function: on the reduced model's MLP (d 256,
    d_ff 512, weights at the init scales, unit-RMS input, as after the
    norm) it misses the model tolerance, 1e-4 of the output's scale. SiLU
    stays SiLU, and the plain two-matrix MLP (act="gelu", Whisper's) takes
    the same tanh form, as the reference's, with no gate matrix."""
    x = np.linspace(-6, 6, 1001, dtype=np.float32)
    got = layers.ACTS["gelu_gated"](torch.from_numpy(x))
    close(got, jax.nn.gelu(jnp.asarray(x)), rtol=1e-6, atol=1e-6)
    rng = np.random.default_rng(0)
    p = {k: (rng.standard_normal(s) / np.sqrt(s[0])).astype(np.float32)
         for k, s in (("w_gate", (256, 512)), ("w_up", (256, 512)), ("w_down", (512, 256)))}
    h = rng.standard_normal((3, 7, 256)).astype(np.float32)
    tp, th = {k: torch.from_numpy(v) for k, v in p.items()}, torch.from_numpy(h)
    for act in ("gelu_gated", "silu"):
        near(layers.mlp_apply(tp, th, act),
             jlayers.mlp_apply({k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(h), act))
    want = np.asarray(jlayers.mlp_apply({k: jnp.asarray(v) for k, v in p.items()},
                                        jnp.asarray(h), "gelu_gated"))
    erf = (torch.nn.functional.gelu(th @ tp["w_gate"]) * (th @ tp["w_up"])) @ tp["w_down"]
    assert float(np.abs(erf.numpy() - want).max()) > 1e-4 * float(np.abs(want).max())
    plain = {k: p[k] for k in ("w_up", "w_down")}
    near(layers.mlp_apply({k: torch.from_numpy(v) for k, v in plain.items()}, th, "gelu"),
         jlayers.mlp_apply({k: jnp.asarray(v) for k, v in plain.items()}, jnp.asarray(h),
                           "gelu"))
    assert "w_gate" not in build_model(get_config("tiny-lm").with_overrides(act="gelu")).spec()[
        "layers"][0]["mlp"]


# --------------------------------------------------------------------------
# the plain attention versions at hd=168
# --------------------------------------------------------------------------


@pytest.mark.parametrize("causal,window", [(True, 0), (True, 17), (False, 0)])
def test_flash_plain_version_at_hd168(causal, window):
    """Against the reference's Pallas kernel (interpret mode) at 2e-5."""
    rng = np.random.default_rng(2)
    q, k, v = (rng.standard_normal((1, 40, h, 168)).astype(np.float32) for h in (2, 1, 1))
    want = jops.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
                                window=window, block_q=32, block_kv=32, impl="interpret")
    got = ref.flash_attention_ref(*(torch.from_numpy(a) for a in (q, k, v)), causal=causal,
                                  window=window)
    close(got, want, rtol=2e-5, atol=2e-5)


def test_flash_plain_version_at_hd168_ragged_and_empty_rows():
    """Ragged key lengths and rows with no valid key (the 4-key row's queries
    past 4 + 17 under the window), against the reference model's blocked
    prefill with its key mask, whose value those rows take, at 2e-5."""
    rng = np.random.default_rng(3)
    Skv, lens, window = 600, (600, 4), 17
    q, k, v = (rng.standard_normal((2, Skv, h, 168)).astype(np.float32) for h in (2, 1, 1))
    valid = np.arange(Skv)[None, :] < np.array(lens)[:, None]
    want = jattention.blocked_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                        causal=True, window=window,
                                        kv_valid=jnp.asarray(valid))
    got = ref.flash_attention_ref(*(torch.from_numpy(a) for a in (q, k, v)), causal=True,
                                  window=window, kv_lengths=torch.tensor(lens, dtype=torch.int32))
    close(got, want, rtol=2e-5, atol=2e-5)


def test_decode_plain_version_at_hd168():
    rng = np.random.default_rng(4)
    q = rng.standard_normal((3, 4, 168)).astype(np.float32)
    k, v = (rng.standard_normal((3, 50, 2, 168)).astype(np.float32) for _ in range(2))
    lens = np.array([50, 1, 33], np.int32)
    want = jops.decode_attention(*(jnp.asarray(a) for a in (q, k, v, lens)), block_kv=32,
                                 impl="interpret")
    got = ref.decode_attention_ref(*(torch.from_numpy(a) for a in (q, k, v, lens)))
    close(got, want, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("Sq,window", [(1100, 100), (1100, 600), (700, 1024)], ids=str)
def test_windowed_blocked_attention(Sq, window):
    """The trainer's windowed attention against the reference's at S > 512:
    at window 100 the third query block skips key blocks 0 (before the band)
    and none past the diagonal, at 600 it reads all; a window longer than S
    is the causal attention. Gradients against the plain flash version's."""
    rng = np.random.default_rng(5)
    q, k, v = (rng.standard_normal((1, Sq, h, 8)).astype(np.float32) for h in (2, 1, 1))
    want = jattention.blocked_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                        causal=True, window=window)
    tq, tk, tv = (torch.from_numpy(a).requires_grad_(True) for a in (q, k, v))
    got = attention.blocked_attention(tq, tk, tv, window=window)
    close(got, want, rtol=1e-5, atol=1e-5)
    w = torch.from_numpy(rng.standard_normal(q.shape).astype(np.float32))
    rq, rk, rv = (torch.from_numpy(a).requires_grad_(True) for a in (q, k, v))
    plain = ref.flash_attention_ref(rq, rk, rv, causal=True, window=window)
    for a, b in zip(torch.autograd.grad((got * w).sum(), (tq, tk, tv)),
                    torch.autograd.grad((plain * w).sum(), (rq, rk, rv))):
        close(a, b, rtol=1e-4, atol=1e-5)


# --------------------------------------------------------------------------
# whole models: prefill, rings, decode past the window
# --------------------------------------------------------------------------


@pytest.fixture(scope="module", params=list(CONFIGS))
def models(request):
    jcfg = _reduced(**CONFIGS[request.param])
    assert jcfg.attn_window == W and jcfg.qk_norm and jcfg.act == "gelu_gated"
    jm = jbuild_model(jcfg)
    jparams = jm.init(jax.random.PRNGKey(0))
    cfg = port_config(jcfg)
    return jm, jparams, build_model(cfg), from_jax_params(np_tree(jparams), cfg, device="cpu")


def _prompts(vocab):
    rng = np.random.default_rng(0)
    toks = rng.integers(3, vocab, (len(LENS), S)).astype(np.int32)
    valid = np.arange(S)[None, :] < LENS[:, None]
    return np.where(valid, toks, 0), valid


def _forced(vocab):
    return np.random.default_rng(1).integers(3, vocab, (T, len(LENS))).astype(np.int32)


def _reference_entries(jcfg, jcache):
    for seg, seg_cache in zip(jlayer_plan(jcfg), jcache):
        for i in range(seg.n_blocks):
            for j in range(len(seg.kinds)):
                yield jax.tree_util.tree_map(lambda a: a[i], seg_cache[f"layer_{j}"])


def test_plan_and_cache_slots(models):
    jm, _, m, params = models
    kinds = [k for seg in jlayer_plan(jm.cfg) for _ in range(seg.n_blocks) for k in seg.kinds]
    assert layer_kinds(m.cfg) == kinds and len(params["layers"]) == len(kinds)
    assert "head" not in params and {"q_norm", "k_norm"} <= set(params["layers"][0]["attn"])
    cache = m.init_cache(len(LENS), S + T, device="cpu")
    assert [e[0].shape[1] for e in cache] == [W if k == "local" else S + T for k in kinds]


def test_prefill_and_decode_past_the_window_match_the_reference(models):
    jm, jparams, m, params = models
    toks, valid = _prompts(m.cfg.vocab_size)
    rt = Runtime.local()
    jlogits, jhidden, jcache, _ = jm.prefill(
        jparams, {"tokens": jnp.asarray(toks), "attn_valid": jnp.asarray(valid)}, rt)
    logits, hidden, cache = m.prefill(params, torch.from_numpy(toks).long(),
                                      attn_valid=torch.from_numpy(valid))
    near(logits, jlogits)
    near(hidden, jhidden)
    jcache = JRealEngine._grow_cache(None, jcache, S + T, S)
    cache = m.decode_cache(cache, S + T)
    entries = list(_reference_entries(jm.cfg, jcache))
    assert len(entries) == len(cache)
    for (k, v), e in zip(cache, entries):       # rings from the last W padded positions
        near(k, e["k"])
        near(v, e["v"])
    jlen, tlen = jnp.asarray(LENS), torch.from_numpy(LENS)
    for tok in _forced(m.cfg.vocab_size):
        jlogits, jhid, jcache = jm.decode_step(
            jparams, {"tokens": jnp.asarray(tok), "pos": jlen, "lengths": jlen + 1}, jcache, rt)
        logits, hid = m.decode_step(params, torch.from_numpy(tok).long(), cache, tlen, tlen + 1)
        near(logits, jlogits)
        near(hid, jhid)
        jlen, tlen = jlen + 1, tlen + 1
    assert int(tlen[1]) > W and int(tlen[0]) > S          # crossed and wrapped
    for (k, _), e in zip(cache, _reference_entries(jm.cfg, jcache)):
        near(k, e["k"])


# --------------------------------------------------------------------------
# training
# --------------------------------------------------------------------------

KW = dict(lr=3e-3, warmup_steps=3, decay_steps=10, seed=0)


def test_train_loop_matches_the_reference():
    """5 steps of train_loop on the reduced Gemma3 (a windowed local layer on
    a 32-token sequence, each layer its own rope base) from carried params,
    against the reference's jitted train step on the same batches: losses at
    rtol 1e-4, as test_torch_training.py holds tiny-lm."""
    jcfg = _reduced()
    jm = jbuild_model(jcfg)
    jparams = jm.init(jax.random.PRNGKey(0))
    cfg = port_config(jcfg)
    ds = jpipeline.make_lm_dataset(64, 32, seed=0)
    ds.tokens = np.minimum(ds.tokens, cfg.vocab_size - 1)
    tds = pipeline.make_lm_dataset(64, 32, seed=0)
    tds.tokens = np.minimum(tds.tokens, cfg.vocab_size - 1)
    step = jax.jit(jtrainer.make_train_step(jm, JTrainConfig(**KW), Runtime.local()))
    state = {"params": jparams,
             "opt_state": jtrainer.make_optimizer(JTrainConfig(**KW)).init(jparams),
             "step": jnp.zeros((), jnp.float32)}
    it = jpipeline.batch_iterator(ds, 8, seed=0)
    want = []
    for _ in range(5):
        state, met = step(state, next(it))
        want.append(float(met["loss"]))
    m = build_model(cfg)
    got = trainer.train_loop(m, TrainConfig(**KW), pipeline.batch_iterator(tds, 8, seed=0,
                                                                           device="cpu"),
                             5, verbose=False, device="cpu",
                             params=from_jax_params(np_tree(jparams), cfg, device="cpu"))
    assert got.step == 5
    np.testing.assert_allclose([float(h["loss"]) for h in got.history], want, rtol=1e-4, atol=0)
    assert want[-1] < want[0]
