"""Whisper-large-v3 (the encoder-decoder family) in the port against the JAX
package, in fp32 on the CPU, with the reference's weights carried across
(``models/convert.py``): the reference's ``reduced()`` config (2 encoder + 2
decoder layers, d=256, 4 heads of 64, 32 frames).

Pieces: ``sinusoid_at``, ``layer_norm`` and the plain GELU MLP; the encoder;
the decoder's prefill (logits, hidden states, the self and cross K/V) on
ragged right-padded prompts; prefill S + one decode step against the
forward at S + 1 (the reference's ``test_decode_matches_forward``) and
teacher-forced decode steps against the reference's; ``whisper_loss`` and
its gradients against ``jax.grad``. Then the counts (``param_count()``
counts the one embedding table twice, as the reference's does), the memory
guard's walk of the spec, and the engine's refusal. Tolerance as in
tests/test_torch_models.py: 1e-4 relative to each tensor's largest
magnitude; the frame and prompt inputs are made with numpy and given to
both packages.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_parity import CPU, close, jax, jnp, np_tree, port_config  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.models import encdec as jencdec  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro.models.model_zoo import Runtime  # noqa: E402
from repro.models.model_zoo import build_model as jbuild_model  # noqa: E402
from repro_torch.common import pytree  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import encdec, layers  # noqa: E402
from repro_torch.models.convert import from_jax_params  # noqa: E402
from repro_torch.models.model_zoo import build_model  # noqa: E402
from repro_torch.serving.engine import RealEngine  # noqa: E402

ARCH = "whisper-large-v3"
LENS = np.array([12, 7, 3], np.int32)
S, T = 12, 4


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def near(got, want):
    want = np.asarray(want, np.float32)
    close(got, want, rtol=1e-4, atol=1e-4 * max(float(np.abs(want).max()), 1.0))


@pytest.fixture(scope="module")
def models():
    jcfg = jget_config(ARCH).reduced().with_overrides(dtype="float32")
    jm = jbuild_model(jcfg)
    jparams = jm.init(jax.random.PRNGKey(0))
    cfg = port_config(jcfg)
    return jm, jparams, build_model(cfg), from_jax_params(np_tree(jparams), cfg, device=CPU)


def _frames(cfg, B=len(LENS), seed=5):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, cfg.encoder_seq, cfg.d_model)) * 0.02).astype(np.float32)


def _prompts(vocab, S=S, lens=LENS, seed=0):
    rng = np.random.default_rng(seed)
    toks = rng.integers(3, vocab, (len(lens), S)).astype(np.int32)
    valid = np.arange(S)[None, :] < lens[:, None]
    return np.where(valid, toks, 0), valid


@pytest.mark.parametrize("reduced", [False, True], ids=["full", "reduced"])
def test_config_is_a_copy_of_the_reference(reduced):
    mine, theirs = get_config(ARCH), jget_config(ARCH)
    if reduced:
        mine, theirs = mine.reduced(), theirs.reduced()
    for f in dataclasses.fields(mine):      # a field the reference lacks holds its default
        assert getattr(mine, f.name) == getattr(theirs, f.name, f.default), f.name
    if reduced:
        assert (mine.n_layers, mine.n_encoder_layers, mine.d_model, mine.n_heads,
                mine.head_dim, mine.encoder_seq) == (2, 2, 256, 4, 64, 32)


def test_counts_and_the_memory_guard():
    """param_count() counts the embedding twice (tie_embeddings is False,
    though the unembed reuses it): 1,600,783,360 against 1,534,809,600 in
    the leaves, which the memory guard walks (bf16, plus the fp32 draw of
    the embedding, the largest leaf)."""
    cfg = get_config(ARCH)
    assert cfg.param_count() == cfg.active_param_count() == 1_600_783_360
    # the second count of the table, less the LayerNorms that neither counts
    n_ln = 2 * cfg.n_encoder_layers + 3 * cfg.n_layers + 2
    assert cfg.param_count() - 1_534_809_600 == (cfg.vocab_size - 2 * n_ln) * cfg.d_model
    specs = [s for _, s in pytree.tree_items(build_model(cfg).spec())]
    assert sum(int(np.prod(s.shape)) for s in specs) == 1_534_809_600
    assert serve.init_bytes(cfg) == (2 * 1_534_809_600, 4 * cfg.vocab_size * cfg.d_model)
    jleaves = jax.tree_util.tree_leaves(jbuild_model(jget_config(ARCH)).param_shapes())
    assert sum(int(np.prod(x.shape)) for x in jleaves) == 1_534_809_600


def test_init_shapes_and_scales(models):
    _, _, m, carried = models
    mine = m.init(seed=0, device=CPU)
    shapes = lambda t: {k: tuple(v.shape) for k, v in pytree.tree_flatten(t).items()}
    assert shapes(mine) == shapes(carried)
    assert float(mine["decoder"][0]["ln1"]["scale"].min()) == 1.0
    assert float(mine["encoder"][1]["ln2"]["bias"].abs().max()) == 0.0
    assert abs(float(mine["embed"].std()) - 0.02) < 2e-3
    assert "w_gate" not in mine["decoder"][0]["mlp"]


def test_sinusoid_layer_norm_and_gelu_mlp():
    """The sinusoid within two fp32 steps of 1 times the largest position:
    XLA's fp32 exp is not correctly rounded, so some frequencies differ from
    PyTorch's by one step, and the angle by the position times it."""
    rng = np.random.default_rng(1)
    for pos in (np.arange(64), rng.integers(64, 1500, 20)):
        pos = pos.astype(np.int32)
        for d in (256, 1280):
            close(encdec.sinusoid_at(torch.from_numpy(pos), d),
                  jencdec.sinusoid_at(jnp.asarray(pos), d), rtol=0,
                  atol=2 * 2.0 ** -23 * float(pos.max()))
    x = (rng.standard_normal((3, 7, 256)) * 3 + 1).astype(np.float32)
    sc, b = rng.standard_normal(256).astype(np.float32), rng.standard_normal(256).astype(np.float32)
    close(layers.layer_norm(*map(torch.from_numpy, (x, sc, b)), 1e-5),
          jlayers.layer_norm(*map(jnp.asarray, (x, sc, b)), 1e-5), rtol=1e-5, atol=1e-5)
    p = {k: (rng.standard_normal(s) / np.sqrt(s[0])).astype(np.float32)
         for k, s in (("w_up", (256, 512)), ("w_down", (512, 256)))}
    h = rng.standard_normal((3, 7, 256)).astype(np.float32)
    assert set(layers.mlp_spec(256, 512, "gelu")) == set(jlayers.mlp_spec(256, 512, "gelu"))
    near(layers.mlp_apply({k: torch.from_numpy(v) for k, v in p.items()}, torch.from_numpy(h),
                          "gelu"),
         jlayers.mlp_apply({k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(h), "gelu"))


def test_encode_matches_the_reference(models):
    _, jparams, m, params = models
    frames = _frames(m.cfg)
    near(encdec.encode(params, m.cfg, torch.from_numpy(frames)),
         jencdec.encode(jparams, m.cfg, jnp.asarray(frames)))


def test_prefill_logits_hidden_and_caches(models):
    jm, jparams, m, params = models
    toks, valid = _prompts(m.cfg.vocab_size)
    frames = _frames(m.cfg)
    jlogits, jhidden, jcache, _ = jm.prefill(
        jparams, {"tokens": jnp.asarray(toks), "attn_valid": jnp.asarray(valid),
                  "enc_embeds": jnp.asarray(frames)}, Runtime.local())
    logits, hidden, cache = m.prefill(params, torch.from_numpy(toks).long(),
                                      attn_valid=torch.from_numpy(valid),
                                      enc_embeds=torch.from_numpy(frames))
    near(logits, jlogits)
    near(hidden, jhidden)
    assert len(cache) == m.cfg.n_layers
    for i, entry in enumerate(cache):
        assert entry["ck"].shape == (len(LENS), m.cfg.encoder_seq, 4, 64)
        for name in ("k", "v", "ck", "cv"):
            near(entry[name], np.asarray(jcache[name])[i])
    none, hidden2, _ = m.prefill(params, torch.from_numpy(toks).long(),
                                 attn_valid=torch.from_numpy(valid),
                                 enc_embeds=torch.from_numpy(frames), logits_mode="none")
    assert none is None and torch.equal(hidden, hidden2)


def test_decode_matches_forward(models):
    """prefill(S) + decode_step(token S) == the forward at S + 1, position
    S, with the cross K/V static in the decode cache."""
    _, _, m, params = models
    B = 2
    toks = torch.from_numpy(np.random.default_rng(2).integers(1, m.cfg.vocab_size,
                                                               (B, S + 1))).long()
    frames = torch.from_numpy(_frames(m.cfg, B=B, seed=6))
    full, _, _ = m.prefill(params, toks, enc_embeds=frames)
    _, _, cache = m.prefill(params, toks[:, :S], enc_embeds=frames)
    cache = m.decode_cache(cache, S + 8)
    shapes = lambda c: [{k: tuple(t.shape) for k, t in e.items()} for e in c]
    assert shapes(cache) == shapes(m.init_cache(B, S + 8, device=CPU))
    assert cache[0]["k"].shape[1] == S + 8 and cache[0]["ck"].shape[1] == m.cfg.encoder_seq
    pos = torch.full((B,), S, dtype=torch.int32)
    logits, _ = m.decode_step(params, toks[:, S], cache, pos, pos + 1)
    near(logits, full[:, S].numpy())


def test_decode_steps_teacher_forced(models):
    """T decode steps after a ragged prefill, the same tokens fed to both
    packages; the reference's cache grown as its engine grows it (no leaf of
    its cache has S = encoder_seq positions, so the cross K/V stay as they
    are)."""
    jm, jparams, m, params = models
    toks, valid = _prompts(m.cfg.vocab_size)
    frames = _frames(m.cfg)
    rt = Runtime.local()
    _, _, jcache, _ = jm.prefill(jparams, {"tokens": jnp.asarray(toks),
                                           "attn_valid": jnp.asarray(valid),
                                           "enc_embeds": jnp.asarray(frames)}, rt)
    jcache = jax.tree_util.tree_map(
        lambda x: jnp.pad(x, [(0, 0), (0, 0), (0, T), (0, 0), (0, 0)])
        if x.shape[2] == S else x, jcache)
    _, _, cache = m.prefill(params, torch.from_numpy(toks).long(),
                            attn_valid=torch.from_numpy(valid),
                            enc_embeds=torch.from_numpy(frames))
    cache = m.decode_cache(cache, S + T)
    forced = np.random.default_rng(1).integers(3, m.cfg.vocab_size, (T, len(LENS)))
    jlen, tlen = jnp.asarray(LENS), torch.from_numpy(LENS)
    for tok in forced.astype(np.int32):
        jlogits, jhid, jcache = jm.decode_step(
            jparams, {"tokens": jnp.asarray(tok), "pos": jlen, "lengths": jlen + 1}, jcache, rt)
        logits, hid = m.decode_step(params, torch.from_numpy(tok).long(), cache, tlen, tlen + 1)
        near(logits, jlogits)
        near(hid, jhid)
        jlen, tlen = jlen + 1, tlen + 1


def _tempered(jparams, c):
    """The reference's params with every attention's wq and wk scaled by c:
    at the init scales (wq's std 1/sqrt(4)) the softmaxes are near one-hot
    and one ulp moves the gradients by more than the tolerance."""
    out = jax.tree_util.tree_map(lambda a: a, jparams)
    for stack, names in (("encoder", ("attn",)), ("decoder", ("self_attn", "cross_attn"))):
        for n in names:
            a = out[stack][n]
            a["wq"], a["wk"] = a["wq"] * c, a["wk"] * c
    return out


@pytest.mark.parametrize("masked", [False, True], ids=["mean", "loss_mask"])
def test_whisper_loss_and_grads_match_the_reference(models, masked):
    jm, jparams, m, _ = models
    jparams = _tempered(jparams, 0.1)
    rng = np.random.default_rng(3)
    toks = rng.integers(1, m.cfg.vocab_size, (2, 16)).astype(np.int32)
    batch = {"tokens": toks, "enc_embeds": _frames(m.cfg, B=2, seed=7)}
    if masked:
        batch["loss_mask"] = (np.arange(16)[None, :] < np.array([[16], [9]])).astype(np.float32)
    (jloss, _), jgrads = jax.jit(jax.value_and_grad(
        lambda p: jm.loss(p, {k: jnp.asarray(v) for k, v in batch.items()}, Runtime.local()),
        has_aux=True))(jparams)
    params = from_jax_params(np_tree(jparams), m.cfg, device=CPU)
    flat = pytree.tree_flatten(params)
    for p in flat.values():
        p.requires_grad_(True)
    loss, met = m.loss(params, {k: torch.from_numpy(v) for k, v in batch.items()})
    close(loss, jloss, rtol=1e-5, atol=0)
    assert met["loss"] is loss
    grads = dict(zip(flat, torch.autograd.grad(loss, list(flat.values()))))
    want = pytree.tree_flatten(from_jax_params(np_tree(jgrads), m.cfg, device=CPU))
    assert set(want) == set(grads)
    norm = float(torch.sqrt(sum((v.double() ** 2).sum() for v in want.values())))
    gap = max(float((grads[k] - want[k]).abs().max()) for k in want)
    assert gap <= 1e-5 * norm, (gap, norm)


def test_engine_and_serve_refuse_an_encoder_decoder(models):
    """The reference's engine feeds tokens only and fails on an encdec model
    with a KeyError; the port's says what is missing, and ``serve --mode
    real`` exits before allocating."""
    _, _, m, params = models
    with pytest.raises(ValueError, match="enc_embeds"):
        RealEngine(m, params)
    with pytest.raises(SystemExit, match="enc_embeds"):
        serve.main(["--mode", "real", "--device", "cpu", "--model", ARCH])


def test_decode_on_a_ring_of_the_window(models):
    """With ``attn_window`` (the dry-run's long_500k gives Whisper 8,192) the
    self cache is a ring of ``min(window, cache_len)`` slots, as the
    reference's ``decoder_cache_spec``: 12 teacher-forced steps from zeroed
    caches on a ring of 8, wrapping it, against the reference's steps."""
    jm, jparams, m, params = models
    W, steps, B = 8, 12, 2
    jmw = jbuild_model(jm.cfg.with_overrides(attn_window=W))
    mw = build_model(m.cfg.with_overrides(attn_window=W))
    jcache = jmw.init_cache(B, 64)
    cache = mw.init_cache(B, 64, device=CPU)
    assert [tuple(e["k"].shape) for e in cache] == [tuple(jcache["k"].shape[1:])] * 2
    assert tuple(cache[0]["k"].shape)[1] == W
    forced = np.random.default_rng(2).integers(3, m.cfg.vocab_size, (steps, B)).astype(np.int32)
    rt = Runtime.local()
    for t, tok in enumerate(forced):
        pos = np.full((B,), t, np.int32)
        jlogits, _, jcache = jmw.decode_step(
            jparams, {"tokens": jnp.asarray(tok), "pos": jnp.asarray(pos),
                      "lengths": jnp.asarray(pos + 1)}, jcache, rt)
        logits, _ = mw.decode_step(params, torch.from_numpy(tok).long(), cache,
                                   torch.from_numpy(pos), torch.from_numpy(pos + 1))
        near(logits, jlogits)
