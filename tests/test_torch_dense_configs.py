"""The four plain dense configs of this slice (Qwen2.5-7B, Granite-20B,
MiniCPM-2B, Yi-34B) against the JAX package, in fp32 on the CPU, with the
reference's weights carried across: prefill logits, hidden states and K/V
on ragged right-padded prompts, then teacher-forced decode-step logits.

Each runs at the reference's ``reduced()`` dims (2 layers, d_model 256,
G <= 4), and at the GQA groups the served models have, which ``reduced()``
caps: G=7 (Qwen2.5-7B and Yi-34B: 28/4 and 56/8) and G=48 (Granite-20B's
one KV head), each as a ``with_overrides`` case on both sides. Tolerance as
in test_torch_models.py: 1e-4 relative to each tensor's largest magnitude.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_parity import close, jax, jnp, np_tree, port_config  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.models.model_zoo import Runtime  # noqa: E402
from repro.models.model_zoo import build_model as jbuild_model  # noqa: E402
from repro.serving.engine import RealEngine as JRealEngine  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models.convert import from_jax_params  # noqa: E402
from repro_torch.models.model_zoo import build_model  # noqa: E402

LENS = np.array([13, 7, 4], np.int32)
S, T = 13, 4
NAMES = ["qwen2.5-7b", "granite-20b", "minicpm-2b", "yi-34b"]
GROUPS = {"qwen2.5-7b-G7": ("qwen2.5-7b", dict(n_heads=14, n_kv_heads=2, head_dim=32)),
          "granite-20b-G48": ("granite-20b", dict(n_heads=48, n_kv_heads=1, head_dim=16))}


def near(got, want):
    want = np.asarray(want, np.float32)
    close(got, want, rtol=1e-4, atol=1e-4 * max(float(np.abs(want).max()), 1.0))


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _reference_config(case):
    name, over = GROUPS.get(case, (case, {}))
    return jget_config(name).reduced().with_overrides(dtype="float32", **over)


@pytest.mark.parametrize("name", NAMES)
def test_config_is_a_copy_with_its_parameter_count(name):
    mine, theirs = get_config(name), jget_config(name)
    assert mine == port_config(theirs)
    assert mine.param_count() == theirs.param_count()
    assert mine.reduced().param_count() == theirs.reduced().param_count()


@pytest.mark.parametrize("case", NAMES + list(GROUPS))
def test_prefill_and_decode_match_the_reference(case):
    jcfg = _reference_config(case)
    if case in GROUPS:
        assert jcfg.q_per_kv in (7, 48)
    jm = jbuild_model(jcfg)
    jparams = jm.init(jax.random.PRNGKey(0))
    cfg = port_config(jcfg)
    m = build_model(cfg)
    params = from_jax_params(np_tree(jparams), cfg, device="cpu")
    assert ("head" in params) != cfg.tie_embeddings

    rng = np.random.default_rng(0)
    valid = np.arange(S)[None, :] < LENS[:, None]
    toks = np.where(valid, rng.integers(3, cfg.vocab_size, (len(LENS), S)), 0).astype(np.int32)
    rt = Runtime.local()
    jlogits, jhidden, jcache, _ = jm.prefill(
        jparams, {"tokens": jnp.asarray(toks), "attn_valid": jnp.asarray(valid)}, rt)
    logits, hidden, cache = m.prefill(params, torch.from_numpy(toks).long(),
                                      attn_valid=torch.from_numpy(valid))
    near(logits, jlogits)
    near(hidden, jhidden)
    for i, (k, v) in enumerate(cache):
        near(k, jcache[0]["layer_0"]["k"][i])
        near(v, jcache[0]["layer_0"]["v"][i])

    jcache = JRealEngine._grow_cache(None, jcache, S + T, S)
    cache = m.decode_cache(cache, S + T)
    forced = rng.integers(3, cfg.vocab_size, (T, len(LENS))).astype(np.int32)
    jlen, tlen = jnp.asarray(LENS), torch.from_numpy(LENS)
    for t in range(T):
        jlogits, jhid, jcache = jm.decode_step(
            jparams, {"tokens": jnp.asarray(forced[t]), "pos": jlen, "lengths": jlen + 1},
            jcache, rt)
        logits, hid = m.decode_step(params, torch.from_numpy(forced[t]).long(), cache,
                                    tlen, tlen + 1)
        near(logits, jlogits)
        near(hid, jhid)
        jlen, tlen = jlen + 1, tlen + 1
