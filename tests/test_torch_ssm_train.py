"""SSM and hybrid training in the port against the JAX package, in fp32 on
the CPU.

- ``ssd_chunked`` against the reference's at chunk 16 with S=24 (the pad
  branch), from zeros and from a given ``h0``: y and h at 2e-5 (the
  reference's fp32 kernel tolerance); the gradients of every input under one
  seeded cotangent against the reference's VJP at 1e-5 of each gradient's
  largest magnitude (the same chunked sums, in other orders).
- The masked exponent: at the full configs' chunk of 256, with dt = 0.7 and
  A = -1, the reference's gradient with respect to dt is not finite (its
  output is, and the port's equals it at tests/test_kernels.py's SSD
  tolerance, 2e-4: sums of 256 terms), while the port's gradient is finite and equals autograd through the
  plain sequential recurrence (``kernels/ref.py::ssd_scan_ref``) at 1e-4 of
  its largest magnitude (the chunked form takes the decays as exp(cum_i -
  cum_j), the recurrence as a product of exp(a_t)).
- ``lm_loss`` and the gradient of every leaf for the reduced Mamba2-130M
  and Zamba2-1.2B, the reference's weights carried across
  (``models/convert.py``), with ``remat`` off and on: the loss at rtol
  1e-5, each gradient within 1e-5 of the global gradient norm; ``dt_bias``,
  which the loss never reads (``_discretize``), gets zeros in both.
- One ``train_step`` (AdamW, clipping, the cosine schedule) against the
  reference's: loss and gradient norm at rtol 1e-5, AdamW's m and sqrt(v)
  within 1e-5 of their global norm (as the gradients), and the updated weights at that
  tolerance wherever the gradient is 0 or at least 1e-4 of its norm (the first
  update, lr * g / (|g| + 1e-8), may take any value in +-lr for a gradient
  within its own gap of zero: measured 4.5% of lr apart at most; 65% of
  Mamba2's weights and 46% of Zamba2's are held); ``dt_bias``
  (set off its zero init) moved by the weight decay alone in both, its
  moments still zero.

Zamba2's shared attention block gets wq and wk scaled by 0.1, the
well-conditioned init of test_torch_training.py (at the reference's init
scales its softmax is near one-hot, where fp32 orders differ most).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_parity import CPU, close, jax, jnp, np_tree, port_config  # noqa: E402

from repro.common.config import TrainConfig as JTrainConfig  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.data import pipeline as jpipeline  # noqa: E402
from repro.models import ssm as jssm  # noqa: E402
from repro.models.model_zoo import Runtime  # noqa: E402
from repro.models.model_zoo import build_model as jbuild_model  # noqa: E402
from repro.training import trainer as jtrainer  # noqa: E402
from repro_torch.common import pytree  # noqa: E402
from repro_torch.common.config import TrainConfig  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.models import ssm  # noqa: E402
from repro_torch.models.convert import from_jax_params  # noqa: E402
from repro_torch.models.model_zoo import build_model  # noqa: E402
from repro_torch.training import trainer  # noqa: E402

ARCHS = ["mamba2-130m", "zamba2-1.2b"]
KW = dict(lr=3e-3, warmup_steps=3, decay_steps=10, seed=0)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a, grad=False):
    return torch.from_numpy(np.asarray(a, np.float32)).requires_grad_(grad)


def _scaled_close(got, want, frac):
    want = np.asarray(want, np.float32)
    close(got, want, rtol=0, atol=frac * max(float(np.abs(want).max()), 1e-30))


# --------------------------------------------------------------------------
# the scan
# --------------------------------------------------------------------------


def _ssd_inputs(B, S, H, P, N, seed=3):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, S, H, P))
    dt = np.log1p(np.exp(rng.standard_normal((B, S, H))))
    a = -dt * np.exp(0.3 * rng.standard_normal(H))
    Bm = rng.standard_normal((B, S, N))
    Cm = rng.standard_normal((B, S, N))
    h0 = 0.5 * rng.standard_normal((B, H, P, N))
    return [v.astype(np.float32) for v in (x, dt, a, Bm, Cm, h0)]


@pytest.mark.parametrize("with_h0", [False, True], ids=["zeros", "h0"])
def test_ssd_chunked_matches_the_reference(with_h0):
    B, S, H, P, N, chunk = 2, 24, 3, 4, 8, 16           # 24 = 16 + 8: the pad branch
    *ins, h0 = _ssd_inputs(B, S, H, P, N)
    h0 = h0 if with_h0 else None
    rng = np.random.default_rng(4)
    gy = rng.standard_normal((B, S, H, P)).astype(np.float32)
    gh = rng.standard_normal((B, H, P, N)).astype(np.float32)

    args = [jnp.asarray(v) for v in ins] + ([jnp.asarray(h0)] if with_h0 else [])
    fn = lambda *a: jssm.ssd_chunked(*a[:5], chunk, *a[5:])
    (jy, jh), vjp = jax.vjp(fn, *args)
    jgrads = vjp((jnp.asarray(gy), jnp.asarray(gh)))

    targs = [_t(v, grad=True) for v in ins] + ([_t(h0, grad=True)] if with_h0 else [])
    y, h = ssm.ssd_chunked(*targs[:5], chunk, *targs[5:])
    close(y, jy, rtol=2e-5, atol=2e-5)
    close(h, jh, rtol=2e-5, atol=2e-5)
    grads = torch.autograd.grad((y * _t(gy)).sum() + (h * _t(gh)).sum(), targs)
    assert len(grads) == len(jgrads) == (6 if with_h0 else 5)
    for g, jg in zip(grads, jgrads):
        _scaled_close(g, jg, 1e-5)


def test_chunk_256_gradients_are_finite_where_the_reference_is_not():
    """B=1, S=256, H=2, P=4, N=8, dt = 0.7 everywhere and A = -1 (A_log's
    zero init): above the diagonal of the 256 x 256 tile the reference's
    exponent reaches 0.7 x 255 = 178.5, past fp32's exp range."""
    B, S, H, P, N = 1, 256, 2, 4, 8
    x, _, _, Bm, Cm, _ = _ssd_inputs(B, S, H, P, N, seed=5)
    dt = np.full((B, S, H), 0.7, np.float32)
    w = np.random.default_rng(6).standard_normal((B, S, H, P)).astype(np.float32)

    def jloss(dt_):
        y, _ = jssm.ssd_chunked(jnp.asarray(x), dt_, -dt_, jnp.asarray(Bm), jnp.asarray(Cm),
                                256)
        return jnp.sum(y * jnp.asarray(w))

    jy, _ = jssm.ssd_chunked(jnp.asarray(x), jnp.asarray(dt), -jnp.asarray(dt),
                             jnp.asarray(Bm), jnp.asarray(Cm), 256)
    jgrad = np.asarray(jax.grad(jloss)(jnp.asarray(dt)))
    assert np.isfinite(np.asarray(jy)).all()
    assert not np.isfinite(jgrad).all()

    tdt = _t(dt, grad=True)
    y, _ = ssm.ssd_chunked(_t(x), tdt, -tdt, _t(Bm), _t(Cm), 256)
    close(y, jy, rtol=2e-4, atol=2e-4)          # tests/test_kernels.py's SSD tolerance
    grad, = torch.autograd.grad((y * _t(w)).sum(), tdt)
    assert torch.isfinite(grad).all()
    pdt = _t(dt, grad=True)
    y_plain, _ = ref.ssd_scan_ref(_t(x), pdt, -pdt, _t(Bm), _t(Cm))
    want, = torch.autograd.grad((y_plain * _t(w)).sum(), pdt)
    _scaled_close(grad, want, 1e-4)


# --------------------------------------------------------------------------
# the models
# --------------------------------------------------------------------------


def _reference(arch):
    """(reduced fp32 config, the reference's model and its params with the
    shared block's wq and wk scaled by 0.1)."""
    jcfg = jget_config(arch).reduced().with_overrides(dtype="float32")
    jm = jbuild_model(jcfg)
    jparams = jm.init(jax.random.PRNGKey(0))
    # dt_bias off its zero init, so that the weight decay of a train step shows
    for seg in jparams["segments"]:
        for lp in seg.values():
            if "ssm" in lp:
                lp["ssm"] = {**lp["ssm"],
                             "dt_bias": 0.1 + 0.01 * jnp.arange(lp["ssm"]["dt_bias"].size,
                                                                dtype=jnp.float32).reshape(
                                                                    lp["ssm"]["dt_bias"].shape)}
    if "shared" in jparams:
        att = dict(jparams["shared"]["attn"])
        att["wq"], att["wk"] = att["wq"] * 0.1, att["wk"] * 0.1
        jparams = {**jparams, "shared": {**jparams["shared"], "attn": att}}
    return jcfg, jm, jparams


def _batch(vocab):
    ds = jpipeline.make_lm_dataset(64, 32, seed=0)
    ds.tokens = np.minimum(ds.tokens, vocab - 1)
    return next(jpipeline.batch_iterator(ds, 8, seed=0))


def _carried(jparams, cfg):
    params = from_jax_params(np_tree(jparams), cfg, device=CPU)
    for p in pytree.tree_flatten(params).values():
        p.requires_grad_(True)
    return params


@pytest.mark.parametrize("remat", ["none", "full"])
@pytest.mark.parametrize("arch", ARCHS)
def test_lm_loss_and_grads_match_the_reference(arch, remat):
    jcfg, jm, jparams = _reference(arch)
    cfg = port_config(jcfg)
    batch = _batch(cfg.vocab_size)
    (jtotal, jmet), jgrads = jax.jit(jax.value_and_grad(
        lambda p: jm.loss(p, batch, Runtime.local()), has_aux=True))(jparams)
    params = _carried(jparams, cfg)
    flat = pytree.tree_flatten(params)
    total, met = build_model(cfg).loss(
        params, {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}, remat=remat)
    close(total, jtotal, rtol=1e-5, atol=0)
    close(met["loss"], jmet["loss"], rtol=1e-5, atol=0)
    g = torch.autograd.grad(total, list(flat.values()), allow_unused=True,
                            materialize_grads=True)
    grads = dict(zip(flat, g))
    want = pytree.tree_flatten(from_jax_params(np_tree(jgrads), cfg, device=CPU))
    assert set(want) == set(grads)
    dt_bias = [k for k in want if k.endswith("/ssm/dt_bias")]
    assert len(dt_bias) == cfg.n_layers
    for k in dt_bias:
        assert not want[k].any() and not grads[k].any(), k
    norm = float(torch.sqrt(sum((v.double() ** 2).sum() for v in want.values())))
    gap = max(float((grads[k] - want[k]).abs().max()) for k in want)
    assert gap <= 1e-5 * norm, (gap, norm)


@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_matches_the_reference(arch):
    jcfg, jm, jparams = _reference(arch)
    cfg = port_config(jcfg)
    batch = _batch(cfg.vocab_size)
    tcfg = TrainConfig(**KW)
    jstate = {"params": jparams, "opt_state": jtrainer.make_optimizer(JTrainConfig(**KW))
              .init(jparams), "step": jnp.zeros((), jnp.float32)}
    jstate, jmet = jax.jit(jtrainer.make_train_step(jm, JTrainConfig(**KW), Runtime.local()))(
        jstate, batch)

    model = build_model(cfg)
    state = trainer.init_state(model, 0, tcfg, device=CPU,
                               params=from_jax_params(np_tree(jparams), cfg, device=CPU))
    before = {k: v.detach().clone() for k, v in pytree.tree_flatten(state.params).items()}
    state, met = trainer.make_train_step(model, tcfg)(
        state, {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()})
    close(met["loss"], jmet["loss"], rtol=1e-5, atol=0)
    close(met["grad_norm"], jmet["grad_norm"], rtol=1e-5, atol=0)
    as_port = lambda tree: pytree.tree_flatten(from_jax_params(np_tree(tree), cfg, device=CPU))
    got = pytree.tree_flatten(state.params)
    want = as_port(jstate["params"])
    assert set(got) == set(want)
    # AdamW's moments after one step are 0.1 g and 0.001 g^2 of the clipped
    # gradients: m and sqrt(v) are held as the gradients are, within 1e-5 of
    # their global norm
    for name, f in (("m", lambda t: t), ("v", torch.sqrt)):
        jmom = as_port(jstate["opt_state"][name])
        norm = float(torch.sqrt(sum((f(v).double() ** 2).sum() for v in jmom.values())))
        gap = max(float((f(state.opt_state[name][k]) - f(jmom[k])).abs().max()) for k in jmom)
        assert gap <= 1e-5 * norm, (name, gap, norm)
    # its first update is lr * g / (|g| + 1e-8), whose slope in g is
    # 1e-8 / g^2: where |g| >= 1e-4 of the norm, a gradient gap of 1e-5 of
    # the norm (held above) moves it by at most ~1e-5 lr, but an element whose
    # gradient is within that gap of 0 may move anywhere in +-lr. So the
    # weights are held where the reference's clipped gradient (10 m) is at
    # least 1e-4 of its norm, or 0 (a token the batch lacks: decay alone)
    lr = KW["lr"] / KW["warmup_steps"]
    jm_ = as_port(jstate["opt_state"]["m"])
    gnorm = 10 * float(torch.sqrt(sum((v.double() ** 2).sum() for v in jm_.values())))
    held = {k: (10 * v.abs() >= 1e-4 * gnorm) | (v == 0) for k, v in jm_.items()}
    for k in want:
        close(got[k].detach()[held[k]], want[k][held[k]], rtol=0,
              atol=1e-5 * float(want[k].abs().max()))
    # dt_bias had zero gradients: its moments stay 0 and only the decay moves
    # it (stacked over the layers it is a rank-2 leaf, which decays)
    for k in (k for k in want if k.endswith("/ssm/dt_bias")):
        assert not state.opt_state["m"][k].any() and not state.opt_state["v"][k].any()
        close(got[k], before[k] * (1 - lr * tcfg.weight_decay), rtol=1e-6, atol=0)
        close(want[k], before[k] * (1 - lr * tcfg.weight_decay), rtol=1e-6, atol=0)
