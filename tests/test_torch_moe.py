"""The MoE family in the port against the JAX package, in fp32 on the CPU.

- The two configs: ``param_count`` / ``active_param_count`` and
  ``reduced()`` field by field against the reference's.
- ``moe_apply`` against ``repro.models.moe.moe_apply`` (``mesh=None``) on
  numpy inputs from a seed: reduced Qwen3-MoE (4 experts, top-2), reduced
  Kimi-K2 (a shared expert) and 16 experts top-4, each at capacity factors
  0 (no drop), 1.25 and 0.3 (drops), on a right-padded batch whose pads
  route before a later row's real tokens. The router's ids and the
  dispatch's ``gather_tok`` / ``valid`` / ``weight`` equal the reference's
  exactly, which a sort that is not stable would break; outputs at 1e-5,
  aux at 1e-6.
- Whole models at reduced dims with the reference's weights carried across
  (``models/convert.py``): prefill logits and hidden states, then
  teacher-forced decode steps, at 1e-4 of each tensor's scale; prefill +
  ``decode_step`` against the forward at S+1. Configs: the two reduced
  ones, one at G=2 and one at Kimi's head width of 112; the plain attention
  versions at hd=112 against the reference's kernels in interpret mode.
- Training: ``lm_loss`` (CE + 0.01·aux) and its gradients against the
  reference's ``loss`` and ``jax.grad``, and 5 ``train_loop`` steps at rtol
  1e-4, with layer 0's attention scaled by 0.1 (test_torch_training.py's
  well-conditioned init).
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_parity import CPU, close, jax, jnp, np_tree, port_config  # noqa: E402

from repro.common.config import TrainConfig as JTrainConfig  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.data import pipeline as jpipeline  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.models.model_zoo import Runtime  # noqa: E402
from repro.models.model_zoo import build_model as jbuild_model  # noqa: E402
from repro.models.transformer import layer_plan as jlayer_plan  # noqa: E402
from repro.serving.engine import RealEngine as JRealEngine  # noqa: E402
from repro.training import trainer as jtrainer  # noqa: E402
from repro_torch.common import pytree  # noqa: E402
from repro_torch.common.config import TrainConfig  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.data import pipeline  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.launch.serve import init_bytes, refuse_if_too_large  # noqa: E402
from repro_torch.models import moe  # noqa: E402
from repro_torch.models.convert import from_jax_params  # noqa: E402
from repro_torch.models.model_zoo import build_model  # noqa: E402
from repro_torch.models.transformer import layer_kinds  # noqa: E402
from repro_torch.training import trainer  # noqa: E402

QWEN, KIMI = "qwen3-moe-235b-a22b", "kimi-k2-1t-a32b"


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def near(got, want):
    want = np.asarray(want, np.float32)
    close(got, want, rtol=1e-4, atol=1e-4 * max(float(np.abs(want).max()), 1.0))


def _reduced(arch, **over):
    return jget_config(arch).reduced().with_overrides(dtype="float32", **over)


# --------------------------------------------------------------------------
# the configs
# --------------------------------------------------------------------------


@pytest.mark.parametrize("arch,total,active,hd", [(QWEN, 231.74, 18.84, 64),
                                                  (KIMI, 1043.85, 33.75, 112)])
def test_config_counts_and_reduced(arch, total, active, hd):
    mine, theirs = get_config(arch), jget_config(arch)
    assert mine == port_config(theirs) and mine.head_dim == hd
    assert mine.param_count() == theirs.param_count()
    assert round(mine.param_count() / 1e9, 2) == total
    assert mine.active_param_count() == theirs.active_param_count()
    assert round(mine.active_param_count() / 1e9, 2) == active
    r, jr = mine.reduced(), theirs.reduced()
    for f in dataclasses.fields(r):
        assert getattr(r, f.name) == getattr(jr, f.name), f.name
    assert (r.n_experts, r.n_experts_per_token, r.moe_d_ff) == (4, 2, 128)
    assert r.n_shared_experts == min(mine.n_shared_experts, 1)
    assert layer_kinds(mine) == ["moe"] * mine.n_layers
    assert [(s.kinds, s.n_blocks) for s in jlayer_plan(theirs)] == [(("moe",), mine.n_layers)]


H100_BYTES = 80 * 2 ** 30                # an 80 GB card


@pytest.mark.parametrize("arch,layers,fits", [(QWEN, None, False), (KIMI, None, False),
                                              (QWEN, 12, True), (KIMI, 1, True),
                                              ("llama3-8b", None, True), (KIMI, 2, False),
                                              ("gemma3-27b", None, True)])
def test_serve_refuses_weights_the_card_cannot_hold(arch, layers, fits):
    """``serve --mode real`` at full depth: Qwen3-MoE's 463 GB and Kimi's
    2.09 TB of bf16 weights are refused before allocating; the depths
    chip_smoke.py serves (12 and 1 layers), Llama-3-8B and Gemma3-27B pass.
    Kimi-K2 at 2 layers is refused: its 73.0 GB of leaves would fit, but the
    init's 22.5 GB fp32 draw of its expert leaf on top of them does not."""
    cfg = get_config(arch)
    if layers:
        cfg = cfg.with_overrides(n_layers=layers)
    if fits:
        refuse_if_too_large(cfg, H100_BYTES)
    else:
        with pytest.raises(SystemExit, match="do not fit"):
            refuse_if_too_large(cfg, H100_BYTES)


@pytest.mark.parametrize("arch,layers,leaves_gb,draw_gb", [(QWEN, 12, 61.34, 3.22),
                                                           (KIMI, 1, 38.85, 22.55),
                                                           (KIMI, 2, 72.99, 22.55),
                                                           ("gemma3-27b", None, 56.58, 5.64)])
def test_serve_guard_counts_what_the_init_allocates(arch, layers, leaves_gb, draw_gb):
    """The guard sizes every leaf of the model's spec in bf16 (Gemma3-27B's
    third MLP matrix included: 28.29 B leaves against param_count()'s
    21.12 B) plus the largest leaf drawn in fp32, and names both sizes."""
    cfg = get_config(arch)
    if layers:
        cfg = cfg.with_overrides(n_layers=layers)
    leaves, draw = init_bytes(cfg)
    assert leaves / 1e9 == pytest.approx(leaves_gb, abs=0.01)
    assert draw / 1e9 == pytest.approx(draw_gb, abs=0.01)
    with pytest.raises(SystemExit, match=f"{leaves / 1e9:.1f} GB of bfloat16 leaves plus "
                                         f"the {draw / 1e9:.1f} GB fp32 draw"):
        refuse_if_too_large(cfg, 10 ** 9)


# --------------------------------------------------------------------------
# moe_apply
# --------------------------------------------------------------------------

MOE_CASES = {"qwen3": (QWEN, {}), "kimi": (KIMI, {}),
             "e16k4": (QWEN, dict(n_experts=16, n_experts_per_token=4))}
PAD_LENS = (12, 3, 7)           # row 1's 9 pads route before row 2's tokens
B, S = len(PAD_LENS), 12


def _moe_inputs(jcfg, seed):
    """The MoE params (numpy, the reference's shapes and init scales, the
    router at 20x its init scale so that routing is skewed) and a (B, S, d)
    input whose pad positions all hold one vector."""
    rng = np.random.default_rng(seed)

    def draw(s):
        if isinstance(s, dict):
            return {k: draw(v) for k, v in s.items()}
        scale = 20 * s.scale if s.scale else 1 / np.sqrt(s.shape[-2])
        return (rng.standard_normal(s.shape) * scale).astype(np.float32)

    p = draw(jmoe.moe_spec(jcfg))
    x = rng.standard_normal((B, S, jcfg.d_model)).astype(np.float32)
    pads = np.arange(S)[None, :] >= np.array(PAD_LENS)[:, None]
    x[pads] = rng.standard_normal(jcfg.d_model).astype(np.float32)
    return p, x, pads.reshape(-1)


@pytest.mark.parametrize("cf", [0.0, 1.25, 0.3], ids=["no-drop", "cf1.25", "cf0.3"])
@pytest.mark.parametrize("case", list(MOE_CASES))
def test_moe_apply_matches_the_reference(case, cf):
    arch, over = MOE_CASES[case]
    jcfg = _reduced(arch, **over)
    cfg = port_config(jcfg)
    p, x, pad = _moe_inputs(jcfg, seed=len(case))
    want, jaux = jax.jit(jmoe.moe_apply, static_argnums=2, static_argnames="capacity_factor")(
        jax.tree_util.tree_map(jnp.asarray, p), jnp.asarray(x), jcfg, capacity_factor=cf)
    got, aux = moe.moe_apply(jax.tree_util.tree_map(torch.from_numpy, p), torch.from_numpy(x),
                             cfg, capacity_factor=cf)
    close(got, want, rtol=1e-5, atol=1e-5)
    close(aux, jaux, rtol=1e-6, atol=1e-6)

    # the router and the dispatch bookkeeping, on the same logits and ids
    T, k, E = B * S, cfg.n_experts_per_token, cfg.n_experts
    logits = x.reshape(T, -1) @ p["router"]
    jids, jcomb, jaux = jmoe._router(jnp.asarray(logits), k)
    ids, comb, aux = moe._router(torch.from_numpy(logits), k)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(jids))
    close(comb, jcomb, rtol=1e-6, atol=1e-6)
    close(aux, jaux, rtol=1e-6, atol=1e-6)
    cap = moe._capacity(T, k, E, cf or float(E))
    assert cap == jmoe._capacity(T, k, E, cf or float(E))
    jg, jv, jw = jmoe._dispatch(jids, jcomb, E, cap)
    g, v, w, slot = moe._dispatch(torch.from_numpy(np.array(jids)).long(),
                                  torch.from_numpy(np.array(jcomb)), E, cap)
    np.testing.assert_array_equal(g.numpy(), np.asarray(jg))
    np.testing.assert_array_equal(v.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(w.numpy(), np.asarray(jw))
    # each kept (token, j) pair's slot holds that token, and the slots are
    # exactly the valid ones
    kept = slot.numpy() < E * cap
    flat_g = g.numpy().reshape(-1)
    assert (flat_g[slot.numpy()[kept]] == np.nonzero(kept)[0]).all()
    assert kept.sum() == v.numpy().sum()
    dropped = ~kept
    if cf == 0.0:
        assert not dropped.any()
    if cf == 0.3:
        # drops, and a real token of row 2 loses its slot to row 1's pads,
        # which come first in flat order
        assert dropped.any()
        row2 = np.arange(T) // S == 2
        lost = dropped & (row2 & ~pad)[:, None]
        held_by_pads = {int(e) for e in np.asarray(jids)[pad & (np.arange(T) // S == 1)]
                        [kept[pad & (np.arange(T) // S == 1)]]}
        assert any(int(e) in held_by_pads for e in np.asarray(jids)[lost])


# --------------------------------------------------------------------------
# the plain attention versions at hd=112
# --------------------------------------------------------------------------


@pytest.mark.parametrize("causal,window", [(True, 0), (True, 17), (False, 0)])
def test_flash_plain_version_at_hd112(causal, window):
    """Against the reference's Pallas kernel (interpret mode, as
    tests/test_kernels.py runs it) at 2e-5, G=8 as Kimi's 64 on 8 heads."""
    rng = np.random.default_rng(2)
    q, k, v = (rng.standard_normal((1, 40, h, 112)).astype(np.float32) for h in (8, 1, 1))
    want = jops.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
                                window=window, block_q=32, block_kv=32, impl="interpret")
    got = ref.flash_attention_ref(*(torch.from_numpy(a) for a in (q, k, v)), causal=causal,
                                  window=window)
    close(got, want, rtol=2e-5, atol=2e-5)


def test_decode_plain_version_at_hd112():
    rng = np.random.default_rng(4)
    q = rng.standard_normal((3, 16, 112)).astype(np.float32)
    k, v = (rng.standard_normal((3, 50, 2, 112)).astype(np.float32) for _ in range(2))
    lens = np.array([50, 1, 33], np.int32)
    want = jops.decode_attention(*(jnp.asarray(a) for a in (q, k, v, lens)), block_kv=32,
                                 impl="interpret")
    got = ref.decode_attention_ref(*(torch.from_numpy(a) for a in (q, k, v, lens)))
    close(got, want, rtol=2e-5, atol=2e-5)


# --------------------------------------------------------------------------
# whole models: prefill and decode
# --------------------------------------------------------------------------

MODEL_CASES = {"qwen3": (QWEN, {}), "kimi": (KIMI, {}), "kv2": (QWEN, dict(n_kv_heads=2)),
               "hd112": (KIMI, dict(d_model=448, n_heads=4, n_kv_heads=2, head_dim=112))}
LENS = np.array([12, 3, 7], np.int32)
T_DEC = 5


@pytest.fixture(scope="module", params=list(MODEL_CASES))
def models(request):
    arch, over = MODEL_CASES[request.param]
    jcfg = _reduced(arch, **over)
    jm = jbuild_model(jcfg)
    jparams = jax.jit(jm.init)(jax.random.PRNGKey(0))
    cfg = port_config(jcfg)
    return jm, jparams, build_model(cfg), from_jax_params(np_tree(jparams), cfg, device=CPU)


def test_params_carry_the_moe_subtree(models):
    jm, jparams, m, params = models
    jlayer = jparams["segments"][0]["layer_0"]
    assert len(params["layers"]) == m.cfg.n_layers
    for i, lp in enumerate(params["layers"]):
        assert set(lp) == {"ln1", "attn", "ln2", "moe"}
        assert set(lp["moe"]) == set(jlayer["moe"])
        assert ("shared" in lp["moe"]) == bool(m.cfg.n_shared_experts)
        for name in ("router", "w_gate", "w_up", "w_down"):
            np.testing.assert_array_equal(lp["moe"][name].numpy(),
                                          np.asarray(jlayer["moe"][name][i]))
        if "shared" in lp["moe"]:
            for name, w in lp["moe"]["shared"].items():
                np.testing.assert_array_equal(w.numpy(),
                                              np.asarray(jlayer["moe"]["shared"][name][i]))


def _prompts(vocab):
    rng = np.random.default_rng(0)
    toks = rng.integers(3, vocab, (len(LENS), S)).astype(np.int32)
    valid = np.arange(S)[None, :] < LENS[:, None]
    return np.where(valid, toks, 0), valid


def test_prefill_and_decode_match_the_reference(models):
    jm, jparams, m, params = models
    toks, valid = _prompts(m.cfg.vocab_size)
    rt = Runtime.local()
    jprefill = jax.jit(lambda p, b: jm.prefill(p, b, rt))
    jdecode = jax.jit(lambda p, b, c: jm.decode_step(p, b, c, rt))
    jlogits, jhidden, jcache, _ = jprefill(
        jparams, {"tokens": jnp.asarray(toks), "attn_valid": jnp.asarray(valid)})
    logits, hidden, cache = m.prefill(params, torch.from_numpy(toks).long(),
                                      attn_valid=torch.from_numpy(valid))
    near(logits, jlogits)
    near(hidden, jhidden)
    jcache = JRealEngine._grow_cache(None, jcache, S + T_DEC, S)
    cache = m.decode_cache(cache, S + T_DEC)
    jlen, tlen = jnp.asarray(LENS), torch.from_numpy(LENS)
    forced = np.random.default_rng(1).integers(3, m.cfg.vocab_size, (T_DEC, len(LENS)))
    for tok in forced.astype(np.int32):
        jlogits, jhid, jcache = jdecode(
            jparams, {"tokens": jnp.asarray(tok), "pos": jlen, "lengths": jlen + 1}, jcache)
        logits, hid = m.decode_step(params, torch.from_numpy(tok).long(), cache, tlen, tlen + 1)
        near(logits, jlogits)
        near(hid, jhid)
        jlen, tlen = jlen + 1, tlen + 1


def test_decode_matches_forward(models):
    """prefill(S) + decode_step(token S) == forward(S+1) at position S, with
    no drop (capacity factor 0): the prefill routes B·S tokens and the step
    B, so only a capacity that takes every pair makes the two the same
    function."""
    _, _, m, params = models
    m = build_model(m.cfg, capacity_factor=0.0)
    toks = torch.from_numpy(np.random.default_rng(2).integers(
        1, m.cfg.vocab_size, (2, S + 1))).long()
    full, _, _ = m.prefill(params, toks)
    _, _, cache = m.prefill(params, toks[:, :S])
    cache = m.decode_cache(cache, S + 8)
    pos = torch.full((2,), S, dtype=torch.int32)
    logits, _ = m.decode_step(params, toks[:, S], cache, pos, pos + 1)
    near(logits, full[:, S].numpy())


# --------------------------------------------------------------------------
# training
# --------------------------------------------------------------------------

KW = dict(lr=3e-3, warmup_steps=3, decay_steps=10, seed=0)


def tempered(jparams, c):
    """The reference's params with every layer's wq and wk scaled by ``c``."""
    out = jax.tree_util.tree_map(lambda a: a, jparams)
    att = out["segments"][0]["layer_0"]["attn"]
    att["wq"], att["wk"] = att["wq"] * c, att["wk"] * c
    return out


def _dataset(vocab):
    ds = jpipeline.make_lm_dataset(64, 32, seed=0)
    ds.tokens = np.minimum(ds.tokens, vocab - 1)
    tds = pipeline.make_lm_dataset(64, 32, seed=0)
    tds.tokens = np.minimum(tds.tokens, vocab - 1)
    return ds, tds


@pytest.mark.parametrize("arch", [QWEN, KIMI])
def test_lm_loss_and_grads_match_the_reference(arch):
    jcfg = _reduced(arch)
    jm = jbuild_model(jcfg)
    jparams = tempered(jm.init(jax.random.PRNGKey(0)), 0.1)
    cfg = port_config(jcfg)
    ds, _ = _dataset(cfg.vocab_size)
    batch = next(jpipeline.batch_iterator(ds, 8, seed=0))
    rt = Runtime.local()
    (jtotal, jmet), jgrads = jax.jit(jax.value_and_grad(lambda p: jm.loss(p, batch, rt),
                                                        has_aux=True))(jparams)
    m = build_model(cfg)
    params = from_jax_params(np_tree(jparams), cfg, device=CPU)
    flat = pytree.tree_flatten(params)
    for p in flat.values():
        p.requires_grad_(True)
    tb = {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}
    total, met = m.loss(params, tb)
    assert float(met["aux"].detach()) > 0
    close(total, jtotal, rtol=1e-5, atol=0)
    close(met["loss"], jmet["loss"], rtol=1e-5, atol=0)
    close(met["aux"], jmet["aux"], rtol=1e-6, atol=1e-6)
    close(total, met["loss"] + cfg.router_aux_coef * met["aux"], rtol=1e-7, atol=0)
    grads = dict(zip(flat, torch.autograd.grad(total, list(flat.values()))))
    want = pytree.tree_flatten(from_jax_params(np_tree(jgrads), cfg, device=CPU))
    norm = float(torch.sqrt(sum((v.double() ** 2).sum() for v in want.values())))
    assert set(want) == set(grads) and any("router" in k for k in want)
    gap = max(float((grads[k] - want[k]).abs().max()) for k in want)
    assert gap <= 1e-5 * norm, (gap, norm)


@pytest.mark.parametrize("arch", [QWEN, KIMI])
def test_train_loop_matches_the_reference(arch):
    """5 steps of train_loop from carried params against the reference's
    jitted train step on the same batches: the CE losses and the router's
    aux at rtol 1e-4."""
    jcfg = _reduced(arch)
    jm = jbuild_model(jcfg)
    jparams = tempered(jm.init(jax.random.PRNGKey(0)), 0.1)
    cfg = port_config(jcfg)
    ds, tds = _dataset(cfg.vocab_size)
    step = jax.jit(jtrainer.make_train_step(jm, JTrainConfig(**KW), Runtime.local()))
    state = {"params": jparams,
             "opt_state": jtrainer.make_optimizer(JTrainConfig(**KW)).init(jparams),
             "step": jnp.zeros((), jnp.float32)}
    it = jpipeline.batch_iterator(ds, 8, seed=0)
    want, want_aux = [], []
    for _ in range(5):
        state, met = step(state, next(it))
        want.append(float(met["loss"]))
        want_aux.append(float(met["aux"]))
    got = trainer.train_loop(build_model(cfg), TrainConfig(**KW),
                             pipeline.batch_iterator(tds, 8, seed=0, device=CPU), 5,
                             verbose=False, device=CPU,
                             params=from_jax_params(np_tree(jparams), cfg, device=CPU))
    assert got.step == 5
    np.testing.assert_allclose([float(h["loss"]) for h in got.history], want, rtol=1e-4, atol=0)
    np.testing.assert_allclose([float(h["aux"]) for h in got.history], want_aux, rtol=1e-4,
                               atol=0)
    assert want[-1] < want[0]
