"""The SSM slice of the port against the JAX package, in fp32 on the CPU:

- the plain SSD scan against the reference's sequential oracle and its
  Pallas kernel in interpret mode, on tests/test_kernels.py's sweep shapes at
  that file's SSD tolerance (rtol/atol 2e-4: the chunked form takes the
  decays as exp(cum_i - cum_j), the recurrence as a product of exp(a_t));
- one Mamba2 layer (``ssm_prefill``, then ``ssm_decode_step``s) on
  mamba2-130m's reduced config;
- whole models, reduced Zamba2-1.2B (shared attention + SSM) and Mamba2-130M,
  with the reference's weights carried across: prefill logits, hidden states,
  caches and φ on ragged right-padded prompts, then decode-step logits along
  a teacher-forced token sequence; and ``RealEngine`` on reduced Zamba2.

Model tolerance as in test_torch_models.py: 1e-4 relative to each tensor's
largest magnitude. The reference's prefill scans in chunks of 16, the port's
plain version step by step; both are fp32. S + T stays within the reduced
window (16), and S differs from the batch (3), the SSM head count (4) and the
window, so the reference engine's ``_grow_cache`` leaves every SSM state and
ring alone; one test decodes past the window on the shared block's ring
(tests/test_torch_ring.py holds rings from longer prefills).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_parity import close, jax, jnp, np_tree, port_config  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.models import ssm as jssm  # noqa: E402
from repro.models.layers import init_tree as jinit_tree  # noqa: E402
from repro.models.model_zoo import Runtime  # noqa: E402
from repro.models.model_zoo import build_model as jbuild_model  # noqa: E402
from repro.models.model_zoo import last_token_hidden as jlast_token_hidden  # noqa: E402
from repro.models.transformer import layer_plan as jlayer_plan  # noqa: E402
from repro.serving.engine import RealEngine as JRealEngine  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import ssm  # noqa: E402
from repro_torch.models.convert import from_jax_params  # noqa: E402
from repro_torch.models.model_zoo import build_model, last_token_hidden  # noqa: E402
from repro_torch.models.transformer import layer_kinds  # noqa: E402
from repro_torch.serving.engine import RealEngine  # noqa: E402

LENS = np.array([10, 6, 3], np.int32)
S, T = 10, 5


def near(got, want):
    want = np.asarray(want, np.float32)
    close(got, want, rtol=1e-4, atol=1e-4 * max(float(np.abs(want).max()), 1.0))


def _reduced(name):
    return jget_config(name).reduced().with_overrides(dtype="float32")


# --------------------------------------------------------------------------
# the scan
# --------------------------------------------------------------------------


def _ssd_inputs(B, S_, H, P, N, seed=2):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, S_, H, P))
    dt = np.log1p(np.exp(rng.standard_normal((B, S_, H))))
    a = -dt * np.exp(0.3 * rng.standard_normal(H))
    Bm = rng.standard_normal((B, S_, N))
    Cm = rng.standard_normal((B, S_, N))
    return [v.astype(np.float32) for v in (x, dt, a, Bm, Cm)]


@pytest.mark.parametrize("B,S_,H,P,N,chunk", [
    (2, 53, 3, 8, 16, 16),
    (1, 64, 2, 4, 8, 32),
    (1, 17, 4, 16, 32, 8),
])
@pytest.mark.parametrize("oracle", ["ref", "interpret"])
def test_ssd_scan_plain_vs_jax(B, S_, H, P, N, chunk, oracle):
    arrs = _ssd_inputs(B, S_, H, P, N)
    jargs = [jnp.asarray(v) for v in arrs]
    if oracle == "ref":
        y_want, h_want = jref.ssd_scan_ref(*jargs)
    else:
        y_want, h_want = jops.ssd_scan(*jargs, chunk=chunk, impl="interpret")
    y, h = ops.ssd_scan(*[torch.from_numpy(v) for v in arrs])
    assert y.dtype == torch.float32 and tuple(h.shape) == (B, H, P, N)
    close(y, y_want, rtol=2e-4, atol=2e-4)
    close(h, h_want, rtol=2e-4, atol=2e-4)


def test_ssd_scan_keeps_the_input_dtype():
    arrs = _ssd_inputs(1, 5, 2, 4, 8)
    x = torch.from_numpy(arrs[0]).bfloat16()
    Bm, Cm = (torch.from_numpy(v).bfloat16() for v in arrs[3:])
    y, h = ops.ssd_scan(x, torch.from_numpy(arrs[1]), torch.from_numpy(arrs[2]), Bm, Cm)
    assert y.dtype == torch.bfloat16 and h.dtype == torch.float32


def test_ssd_scan_kernel_wrapper_takes_no_cpu_tensor():
    """The CUDA wrapper raises on a CPU tensor; only ``ops`` sends CPU
    tensors to the plain version."""
    from repro_torch.kernels.ssd_scan import ssd_scan_cuda

    x, dt, a, Bm, Cm = (torch.from_numpy(v) for v in _ssd_inputs(1, 4, 2, 64, 64))
    before = ssd_scan_cuda.launches
    with pytest.raises(ValueError, match="CUDA"):
        ssd_scan_cuda(x, dt, a, Bm, Cm)
    assert ssd_scan_cuda.launches == before


# --------------------------------------------------------------------------
# one Mamba2 layer
# --------------------------------------------------------------------------


@pytest.fixture(scope="module")
def layer():
    jcfg = _reduced("mamba2-130m")
    jp = jinit_tree(jax.random.PRNGKey(0), jssm.ssm_spec(jcfg), jnp.float32)
    tp = {k: torch.from_numpy(np.array(v)) for k, v in np_tree(jp).items()}
    return jcfg, port_config(jcfg), jp, tp


@pytest.mark.parametrize("S_", [21, 2], ids=["ragged-chunk", "shorter-than-conv"])
def test_ssm_prefill_and_decode_steps_vs_jax(layer, S_):
    jcfg, cfg, jp, tp = layer
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, S_, cfg.d_model)).astype(np.float32)
    jy, jstate = jssm.ssm_prefill(jp, jnp.asarray(x), jcfg)
    y, state = ssm.ssm_prefill(tp, torch.from_numpy(x), cfg)
    near(y, jy)
    near(state["h"], jstate["h"])
    near(state["conv"], jstate["conv"])
    for t in range(3):
        xt = rng.standard_normal((2, 1, cfg.d_model)).astype(np.float32)
        jy, jstate = jssm.ssm_decode_step(jp, jnp.asarray(xt), jstate, jcfg)
        y, state = ssm.ssm_decode_step(tp, torch.from_numpy(xt), state, cfg)
        near(y, jy)
        near(state["h"], jstate["h"])
        near(state["conv"], jstate["conv"])


def test_ssm_spec_inits_the_skip_to_ones_and_the_conv_at_std_half(layer):
    _, cfg, _, _ = layer
    from repro_torch.models.layers import init_tree

    p = init_tree(ssm.ssm_spec(cfg), torch.Generator().manual_seed(0), torch.float32,
                  torch.device("cpu"))
    assert torch.equal(p["D"], torch.ones_like(p["D"]))
    assert abs(float(p["conv_w"].std()) - 0.5) < 0.05
    assert float(p["A_log"].abs().max()) == 0.0


# --------------------------------------------------------------------------
# whole models
# --------------------------------------------------------------------------


@pytest.fixture(scope="module", params=["zamba2-1.2b", "mamba2-130m"])
def models(request):
    jcfg = _reduced(request.param)
    jm = jbuild_model(jcfg)
    jparams = jm.init(jax.random.PRNGKey(0))
    cfg = port_config(jcfg)
    return jm, jparams, build_model(cfg), from_jax_params(np_tree(jparams), cfg, device="cpu")


def _prompts(vocab):
    rng = np.random.default_rng(0)
    toks = rng.integers(3, vocab, (len(LENS), S)).astype(np.int32)
    valid = np.arange(S)[None, :] < LENS[:, None]
    return np.where(valid, toks, 0), valid


def _reference_entries(jcfg, jcache):
    """The reference's stacked per-segment cache, one entry per layer in the
    port's execution order."""
    for seg, seg_cache in zip(jlayer_plan(jcfg), jcache):
        for i in range(seg.n_blocks):
            for j in range(len(seg.kinds)):
                yield jax.tree_util.tree_map(lambda a: a[i], seg_cache[f"layer_{j}"])


def test_plan_follows_the_reference(models):
    jm, _, m, params = models
    kinds = [k for seg in jlayer_plan(jm.cfg) for _ in range(seg.n_blocks) for k in seg.kinds]
    assert layer_kinds(m.cfg) == kinds
    assert len(params["layers"]) == len(kinds)
    assert ("shared" in params) == (m.cfg.family == "hybrid")


def test_prefill_logits_hidden_cache_and_phi(models):
    jm, jparams, m, params = models
    toks, valid = _prompts(m.cfg.vocab_size)
    jlogits, jhidden, jcache, _ = jm.prefill(
        jparams, {"tokens": jnp.asarray(toks), "attn_valid": jnp.asarray(valid)},
        Runtime.local())
    logits, hidden, cache = m.prefill(params, torch.from_numpy(toks).long(),
                                      attn_valid=torch.from_numpy(valid))
    near(logits, jlogits)
    near(hidden, jhidden)
    near(last_token_hidden(hidden, torch.from_numpy(LENS)),
         jlast_token_hidden(jhidden, jnp.asarray(LENS)))
    entries = list(_reference_entries(jm.cfg, jcache))
    assert len(entries) == len(cache)
    for mine, theirs in zip(cache, entries):
        if isinstance(mine, dict):
            near(mine["h"], theirs["h"])
            near(mine["conv"], theirs["conv"])
        else:       # the reference pads the shared block's K/V to its window
            near(mine[0], theirs["k"][:, :S])
            near(mine[1], theirs["v"][:, :S])


def test_decode_steps_teacher_forced(models):
    jm, jparams, m, params = models
    toks, valid = _prompts(m.cfg.vocab_size)
    B = len(LENS)
    rt = Runtime.local()
    _, _, jcache, _ = jm.prefill(
        jparams, {"tokens": jnp.asarray(toks), "attn_valid": jnp.asarray(valid)}, rt)
    jcache = JRealEngine._grow_cache(None, jcache, S + T, S)
    _, _, cache = m.prefill(params, torch.from_numpy(toks).long(),
                            attn_valid=torch.from_numpy(valid))
    cache = m.decode_cache(cache, S + T)
    forced = np.random.default_rng(1).integers(3, m.cfg.vocab_size, (T, B)).astype(np.int32)
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


@pytest.fixture(scope="module")
def zamba():
    jcfg = _reduced("zamba2-1.2b")
    jm = jbuild_model(jcfg)
    jparams = jm.init(jax.random.PRNGKey(0))
    cfg = port_config(jcfg)
    return build_model(cfg), from_jax_params(np_tree(jparams), cfg, device="cpu"), jm, jparams


def test_real_engine_generates_on_reduced_zamba2(zamba):
    m, params, _, _ = zamba
    toks, valid = _prompts(m.cfg.vocab_size)
    eng = RealEngine(m, params, max_new=T)
    out = eng.generate(toks, LENS, torch.Generator().manual_seed(0))
    assert out["lengths"].min() >= 1 and out["lengths"].max() <= T
    assert out["tokens"].shape == (len(LENS), T)
    _, hidden, _ = m.prefill(params, torch.from_numpy(toks).long(),
                             attn_valid=torch.from_numpy(valid), logits_mode="none")
    phi = last_token_hidden(hidden, torch.from_numpy(LENS)).numpy()
    np.testing.assert_array_equal(out["phi"], phi)


def test_decode_past_the_shared_window_raises(zamba):
    """Past the shared block's window the decode no longer raises: the
    block's cache is a ring of the window (16), and teacher-forced steps
    that cross it follow the reference's ring; the engine then generates
    past the window."""
    m, params, jm, jparams = zamba
    W = m.cfg.attn_window
    T2 = W - S + 3
    toks, valid = _prompts(m.cfg.vocab_size)
    B = len(LENS)
    rt = Runtime.local()
    _, _, jcache, _ = jm.prefill(
        jparams, {"tokens": jnp.asarray(toks), "attn_valid": jnp.asarray(valid)}, rt)
    jcache = JRealEngine._grow_cache(None, jcache, S + T2, S)
    _, _, cache = m.prefill(params, torch.from_numpy(toks).long(),
                            attn_valid=torch.from_numpy(valid))
    cache = m.decode_cache(cache, S + T2)
    assert [e[0].shape[1] for e in cache if not isinstance(e, dict)] == [W] * 2
    forced = np.random.default_rng(1).integers(3, m.cfg.vocab_size, (T2, B)).astype(np.int32)
    jlen = jnp.asarray(LENS)
    tlen = torch.from_numpy(LENS)
    for t in range(T2):
        jlogits, jhid, jcache = jm.decode_step(
            jparams, {"tokens": jnp.asarray(forced[t]), "pos": jlen, "lengths": jlen + 1},
            jcache, rt)
        logits, hid = m.decode_step(params, torch.from_numpy(forced[t]).long(), cache,
                                    tlen, tlen + 1)
        near(logits, jlogits)
        near(hid, jhid)
        jlen, tlen = jlen + 1, tlen + 1
    assert int(tlen.max()) > W
    eng = RealEngine(m, params, max_new=T2, eos_id=-1)
    out = eng.generate(toks, LENS, torch.Generator().manual_seed(0))
    assert (out["lengths"] == T2).all()
