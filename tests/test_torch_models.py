"""Port model (dense family) against the JAX package on tiny-lm in fp32,
with the reference's weights carried across: prefill logits, hidden states,
K/V and φ on ragged right-padded prompts, then decode-step logits along a
teacher-forced token sequence (the two frameworks' samplers draw different
numbers from one seed, so both are fed the same tokens).

Tolerance 1e-4 relative to each tensor's largest magnitude: the
reference's prefill attention is blocked with an online softmax while the
port's plain version takes one full softmax, and the matrix products sum in
another order; both are fp32, and the differences grow through the layers
with the activations (K reaches |16| at the reference's init scales)."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_parity import close, jax, jnp, np_tree  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.models.model_zoo import Runtime  # noqa: E402
from repro.models.model_zoo import build_model as jbuild_model  # noqa: E402
from repro.models.model_zoo import last_token_hidden as jlast_token_hidden  # noqa: E402
from repro.serving.engine import RealEngine as JRealEngine  # noqa: E402
from repro_torch.common.config import ModelConfig  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models.convert import from_jax_params  # noqa: E402
from repro_torch.models.model_zoo import build_model, last_token_hidden  # noqa: E402

LENS = np.array([12, 7, 4], np.int32)
S, T = 12, 5


def near(got, want):
    want = np.asarray(want, np.float32)
    close(got, want, rtol=1e-4, atol=1e-4 * max(float(np.abs(want).max()), 1.0))


@pytest.fixture(scope="module")
def models():
    jcfg = jget_config("tiny-lm").with_overrides(dtype="float32")
    jm = jbuild_model(jcfg)
    jparams = jm.init(jax.random.PRNGKey(0))
    cfg = get_config("tiny-lm").with_overrides(dtype="float32")
    m = build_model(cfg)
    return jm, jparams, m, from_jax_params(np_tree(jparams), cfg, device="cpu")


def _prompts():
    rng = np.random.default_rng(0)
    toks = rng.integers(3, 512, (len(LENS), S)).astype(np.int32)
    valid = np.arange(S)[None, :] < LENS[:, None]
    return np.where(valid, toks, 0), valid


@pytest.mark.parametrize("name", ["tiny-lm", "llama3-8b", "mamba2-130m", "zamba2-1.2b"])
def test_configs_are_copies_of_the_reference(name):
    mine, theirs = get_config(name), jget_config(name)
    for f in dataclasses.fields(mine):
        assert getattr(mine, f.name) == getattr(theirs, f.name), f.name


def test_init_matches_reference_shapes_and_scales(models):
    jm, jparams, m, carried = models
    mine = m.init(seed=0, device="cpu")
    flat = lambda t: jax.tree_util.tree_leaves(t)
    assert [tuple(x.shape) for x in flat(mine)] == [tuple(x.shape) for x in flat(carried)]
    # std 1/sqrt(shape[-2]) (wq: 1/sqrt(n_heads)), embeddings 0.02, norms 0
    for key in ("wq", "wo"):
        a, b = mine["layers"][0]["attn"][key], carried["layers"][0]["attn"][key]
        assert abs(float(a.std()) / float(b.std()) - 1) < 0.1
    assert abs(float(mine["embed"].std()) - 0.02) < 2e-3
    assert float(mine["layers"][0]["ln1"].abs().max()) == 0.0


def test_prefill_logits_hidden_kv_and_phi(models):
    jm, jparams, m, params = models
    toks, valid = _prompts()
    jlogits, jhidden, jcache, _ = jm.prefill(
        jparams, {"tokens": jnp.asarray(toks), "attn_valid": jnp.asarray(valid)},
        Runtime.local())
    logits, hidden, kv = m.prefill(params, torch.from_numpy(toks).long(),
                                   attn_valid=torch.from_numpy(valid))
    near(logits, jlogits)
    near(hidden, jhidden)
    for i, (k, v) in enumerate(kv):
        near(k, jcache[0]["layer_0"]["k"][i])
        near(v, jcache[0]["layer_0"]["v"][i])
    near(last_token_hidden(hidden, torch.from_numpy(LENS)),
         jlast_token_hidden(jhidden, jnp.asarray(LENS)))


def test_prefill_rejects_a_mask_that_is_not_a_prefix(models):
    _, _, m, params = models
    toks, valid = _prompts()
    valid[1, 0] = False
    with pytest.raises(ValueError, match="prefix"):
        m.prefill(params, torch.from_numpy(toks).long(), attn_valid=torch.from_numpy(valid))


def test_decode_steps_teacher_forced(models):
    jm, jparams, m, params = models
    toks, valid = _prompts()
    B = len(LENS)
    rt = Runtime.local()
    _, _, jcache, _ = jm.prefill(
        jparams, {"tokens": jnp.asarray(toks), "attn_valid": jnp.asarray(valid)}, rt)
    jcache = JRealEngine._grow_cache(None, jcache, S + T, S)
    _, _, kv = m.prefill(params, torch.from_numpy(toks).long(),
                         attn_valid=torch.from_numpy(valid))
    cache = m.init_cache(B, S + T, device="cpu")
    for (kc, vc), (k, v) in zip(cache, kv):
        kc[:, :S], vc[:, :S] = k, v
    forced = np.random.default_rng(1).integers(3, 512, (T, B)).astype(np.int32)
    jlen = jnp.asarray(LENS)
    tlen = torch.from_numpy(LENS)
    for t in range(T):
        jlogits, jhid, jcache = jm.decode_step(
            jparams, {"tokens": jnp.asarray(forced[t]), "pos": jlen, "lengths": jlen + 1},
            jcache, rt)
        logits, hid = m.decode_step(params, torch.from_numpy(forced[t]).long(), cache,
                                    tlen, tlen + 1)
        near(logits, jlogits)
        near(hid, jhid)
        jlen, tlen = jlen + 1, tlen + 1


@pytest.mark.parametrize("override", [dict(family="moe"), dict(attn_window=16),
                                      dict(qk_norm=True)])
def test_unported_model_features_raise(override):
    cfg = get_config("tiny-lm").with_overrides(**override)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        build_model(cfg)


def test_model_config_rejects_bad_head_split():
    with pytest.raises(ValueError):
        ModelConfig(name="x", family="dense", n_layers=1, d_model=8, n_heads=3,
                    n_kv_heads=2, d_ff=8, vocab_size=8)
