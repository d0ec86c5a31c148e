"""Qwen2-VL-2B (the VLM family: M-RoPE and the embeds path) in the port
against the JAX package, in fp32 on the CPU, with the reference's weights
carried across (``models/convert.py``): the reference's ``reduced()`` config
(2 layers, d=256, 4 query heads on 2 KV heads of 64, M-RoPE sections
(8, 12, 12)).

Pieces: ``mrope_section``; ``rope_angles`` on ``vlm_embeds``' position
streams (patches on a grid, then text) with and without M-RoPE; the streams
themselves, equal to the reference's exactly (the embeddings are drawn from
another generator, so the reference's draws are carried across as numpy).
Then the model: prefill on ``embeds=`` / ``positions=``, teacher-forced
decode steps after it (each step's position given to all three streams, so
the first one jumps from the text's next id to S, as in the reference), the
text-only path of ``RealEngine.generate`` (φ; its samplers draw differently),
and ``lm_loss`` with embeds and its gradients against ``jax.grad``; the
counts. Tolerance as in tests/test_torch_models.py: 1e-4 relative to each
tensor's largest magnitude.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_parity import CPU, close, jax, jnp, np_tree, port_config  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.models import frontend as jfrontend  # noqa: E402
from repro.models import rope as jrope  # noqa: E402
from repro.models.model_zoo import Runtime  # noqa: E402
from repro.models.model_zoo import build_model as jbuild_model  # noqa: E402
from repro.serving.engine import RealEngine as JRealEngine  # noqa: E402
from repro_torch.common import pytree  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import frontend, rope  # noqa: E402
from repro_torch.models.convert import from_jax_params  # noqa: E402
from repro_torch.models.model_zoo import build_model  # noqa: E402
from repro_torch.serving.engine import RealEngine  # noqa: E402

ARCH = "qwen2-vl-2b"
B, S, T, N_PATCHES = 3, 24, 4, 9


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


def _embeds(cfg, n_patches=N_PATCHES, seed=4):
    """The reference's stub embeddings and M-RoPE ids, as numpy."""
    emb, pos = jfrontend.vlm_embeds(jax.random.PRNGKey(seed), cfg, B, S, n_patches=n_patches)
    return np.array(emb, np.float32), np.array(pos)


@pytest.mark.parametrize("reduced", [False, True], ids=["full", "reduced"])
def test_config_is_a_copy_of_the_reference(reduced):
    mine, theirs = get_config(ARCH), jget_config(ARCH)
    if reduced:
        mine, theirs = mine.reduced(), theirs.reduced()
    for f in dataclasses.fields(mine):      # a field the reference lacks holds its default
        assert getattr(mine, f.name) == getattr(theirs, f.name, f.default), f.name


def test_counts_and_the_memory_guard():
    """param_count() 1,543,569,408 (no norms), 1,543,656,960 in the leaves
    (the tied embedding once), which the memory guard walks."""
    cfg = get_config(ARCH)
    assert cfg.param_count() == cfg.active_param_count() == 1_543_569_408
    specs = [s for _, s in pytree.tree_items(build_model(cfg).spec())]
    assert sum(int(np.prod(s.shape)) for s in specs) == 1_543_656_960
    assert serve.init_bytes(cfg) == (2 * 1_543_656_960, 4 * cfg.vocab_size * cfg.d_model)
    jleaves = jax.tree_util.tree_leaves(jbuild_model(jget_config(ARCH)).param_shapes())
    assert sum(int(np.prod(x.shape)) for x in jleaves) == 1_543_656_960


@pytest.mark.parametrize("hd", [128, 64, 32])
def test_mrope_section(hd):
    assert rope.mrope_section(hd) == jrope.mrope_section(hd)
    assert sum(rope.mrope_section(hd)) == hd // 2
    if hd == 128:
        assert rope.mrope_section(hd) == (16, 24, 24)


@pytest.mark.parametrize("seq,n_patches", [(24, 9), (24, 0), (40, 10), (512, 256)])
def test_vlm_positions_equal_the_reference(seq, n_patches):
    """Exactly the reference's streams: patches on a grid of side
    floor(sqrt(n)) (10 patches: a side of 3, rows 0-3), then text from 1;
    n_patches=0 takes the default min(seq // 4, 256)."""
    cfg = get_config(ARCH).reduced()
    _, want = jfrontend.vlm_embeds(jax.random.PRNGKey(0), cfg, 2, seq, n_patches=n_patches)
    gen = torch.Generator().manual_seed(0)
    emb, pos = frontend.vlm_embeds(gen, cfg, 2, seq, n_patches=n_patches)
    assert emb.shape == (2, seq, cfg.d_model) and emb.dtype == torch.bfloat16
    assert pos.dtype == torch.int32
    np.testing.assert_array_equal(pos.numpy(), np.asarray(want))


@pytest.mark.parametrize("use_mrope", [True, False], ids=["mrope", "stream0"])
def test_rope_angles_on_patch_positions(use_mrope):
    _, pos = _embeds(get_config(ARCH).reduced())
    for hd, theta in ((64, 1e6), (128, 1e6)):
        near(rope.rope_angles(torch.from_numpy(pos), hd, theta, use_mrope=use_mrope),
             jrope.rope_angles(jnp.asarray(pos), hd, theta, use_mrope=use_mrope))
    text = rope.text_mrope_positions(B, S)
    np.testing.assert_array_equal(text.numpy(), np.asarray(jrope.text_mrope_positions(B, S)))
    # on text the three streams are equal and M-RoPE is RoPE
    torch.testing.assert_close(rope.rope_angles(text, 64, 1e6, use_mrope=True),
                               rope.rope_angles(text[0], 64, 1e6), rtol=0, atol=0)
    with pytest.raises(ValueError, match="3, B, S"):
        rope.rope_angles(text[0], 64, 1e6, use_mrope=True)


def test_prefill_on_embeds_and_decode_after_it(models):
    jm, jparams, m, params = models
    emb, pos = _embeds(m.cfg)
    rt = Runtime.local()
    jlogits, jhidden, jcache, _ = jm.prefill(
        jparams, {"embeds": jnp.asarray(emb), "positions": jnp.asarray(pos)}, rt)
    logits, hidden, cache = m.prefill(params, embeds=torch.from_numpy(emb),
                                      positions=torch.from_numpy(pos))
    near(logits, jlogits)
    near(hidden, jhidden)
    for i, (k, v) in enumerate(cache):
        near(k, np.asarray(jcache[0]["layer_0"]["k"])[i])
        near(v, np.asarray(jcache[0]["layer_0"]["v"])[i])
    jcache = JRealEngine._grow_cache(None, jcache, S + T, S)
    cache = m.decode_cache(cache, S + T)
    forced = np.random.default_rng(1).integers(3, m.cfg.vocab_size, (T, B)).astype(np.int32)
    jlen = jnp.full((B,), S, jnp.int32)
    tlen = torch.full((B,), S, dtype=torch.int32)
    for tok in forced:
        jlogits, jhid, jcache = jm.decode_step(
            jparams, {"tokens": jnp.asarray(tok), "pos": jlen, "lengths": jlen + 1}, jcache, rt)
        logits, hid = m.decode_step(params, torch.from_numpy(tok).long(), cache, tlen, tlen + 1)
        near(logits, jlogits)
        near(hid, jhid)
        jlen, tlen = jlen + 1, tlen + 1


def test_decode_step_takes_embeds(models):
    """A step fed the token's embedding row is the step fed the token."""
    _, _, m, params = models
    toks = torch.from_numpy(np.random.default_rng(2).integers(1, m.cfg.vocab_size,
                                                               (B, S + 1))).long()
    _, _, c1 = m.prefill(params, toks[:, :S])
    _, _, c2 = m.prefill(params, toks[:, :S])
    c1, c2 = m.decode_cache(c1, S + 2), m.decode_cache(c2, S + 2)
    pos = torch.full((B,), S, dtype=torch.int32)
    a, _ = m.decode_step(params, toks[:, S], c1, pos, pos + 1)
    b, _ = m.decode_step(params, None, c2, pos, pos + 1, embeds=params["embed"][toks[:, S]])
    torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_text_path_of_the_engine(models):
    """``RealEngine.generate`` on text tokens: the prefill's φ and the first
    logits equal the reference's, and the text-only prefill equals the one
    given the text M-RoPE positions; lengths are not compared (the samplers
    draw from different generators)."""
    jm, jparams, m, params = models
    lens = np.array([S, 13, 5])
    rng = np.random.default_rng(0)
    toks = rng.integers(3, m.cfg.vocab_size, (B, S)).astype(np.int32)
    toks = np.where(np.arange(S)[None, :] < lens[:, None], toks, 0)
    jout = JRealEngine(jm, jparams, Runtime.local(), max_new=3).generate(
        toks, lens, jax.random.PRNGKey(0))
    out = RealEngine(m, params, max_new=3).generate(toks, lens, torch.Generator().manual_seed(0))
    near(out["phi"], jout["phi"])
    assert out["lengths"].shape == (B,) and out["tokens"].shape == (B, 3)
    t = torch.from_numpy(toks).long()
    _, h1, _ = m.prefill(params, t)
    _, h2, _ = m.prefill(params, t, positions=rope.text_mrope_positions(B, S))
    torch.testing.assert_close(h1, h2, rtol=0, atol=0)


def _tempered(jparams, c):
    """The reference's params with every layer's wq and wk scaled by c: at
    the init scales (wq's std 1/sqrt(4)) the softmaxes are near one-hot and
    one ulp moves the gradients by more than the tolerance, as
    tests/test_torch_moe.py finds."""
    out = jax.tree_util.tree_map(lambda a: a, jparams)
    att = out["segments"][0]["layer_0"]["attn"]
    att["wq"], att["wk"] = att["wq"] * c, att["wk"] * c
    return out


def test_lm_loss_with_embeds_and_grads(models):
    jm, jparams, m, _ = models
    jparams = _tempered(jparams, 0.1)
    emb, pos = _embeds(m.cfg, seed=8)
    toks = np.random.default_rng(3).integers(1, m.cfg.vocab_size, (B, S)).astype(np.int32)
    batch = {"tokens": toks, "embeds": emb, "positions": pos}
    (jloss, jmet), jgrads = jax.jit(jax.value_and_grad(
        lambda p: jm.loss(p, {k: jnp.asarray(v) for k, v in batch.items()}, Runtime.local()),
        has_aux=True))(jparams)
    params = from_jax_params(np_tree(jparams), m.cfg, device=CPU)
    flat = pytree.tree_flatten(params)
    for p in flat.values():
        p.requires_grad_(True)
    loss, met = m.loss(params, {k: torch.from_numpy(v) for k, v in batch.items()})
    close(loss, jloss, rtol=1e-5, atol=0)
    close(met["loss"], jmet["loss"], rtol=1e-5, atol=0)
    grads = dict(zip(flat, torch.autograd.grad(loss, list(flat.values()))))
    want = pytree.tree_flatten(from_jax_params(np_tree(jgrads), m.cfg, device=CPU))
    assert set(want) == set(grads)
    norm = float(torch.sqrt(sum((v.double() ** 2).sum() for v in want.values())))
    gap = max(float((grads[k] - want[k]).abs().max()) for k in want)
    assert gap <= 1e-5 * norm, (gap, norm)
