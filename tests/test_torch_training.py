"""The port's training path against the JAX package on tiny-lm (fp32), with
the reference's weights carried across: LR schedules, the optimizers on the
reference's stacked leaves, clipping, token-weighted microbatching, the data
pipeline, checkpoints, blocked attention and ``train_loop``.

Tolerances. Schedules rtol 1e-6 (both fp32). Optimizer steps on fed-in
heavy-tailed gradients: weights and moments rtol 1e-5 / atol 1e-6 (the
reference's jitted update fuses its multiply-adds, Adafactor's steps reach
~0.3 there and its means over a stacked leaf carry fp32 error of ~1e-6). Trainer: the reference's init
(``repro/models/layers.py``: fan_in = shape[-2], so wq's std is 1/sqrt(H))
drives layer 0's attention to a near one-hot softmax, where fp32 is
ill-conditioned: one ulp more on every weight moves the reference's own
step-1 gradients by ~4e-4 of their global norm and its 10-step losses by
~6e-3 (``test_reference_moves_more_under_one_ulp``). There the port is held
at that spread (grads 2e-3 of the norm, losses rtol 1e-2). With the
attention weights scaled by 0.1 (scores 100x smaller) the reference's
one-ulp spread is ~1.5e-7, and the port is held at the tight tolerances:
step-1 grads within 1e-5 of the global norm and per-step losses rtol 1e-4.
"""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_parity import close, jax, jnp, np_tree, port_config  # noqa: E402

from repro.common import pytree as jpytree  # noqa: E402
from repro.common.config import TrainConfig as JTrainConfig  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.data import pipeline as jpipeline  # noqa: E402
from repro.models import attention as jattention  # noqa: E402
from repro.models.model_zoo import Runtime  # noqa: E402
from repro.models.model_zoo import build_model as jbuild_model  # noqa: E402
from repro.training import checkpoint as jcheckpoint  # noqa: E402
from repro.training import optim as joptim  # noqa: E402
from repro.training import trainer as jtrainer  # noqa: E402
from repro_torch.common import pytree  # noqa: E402
from repro_torch.common.config import TrainConfig  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.data import pipeline  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.launch import train as train_launcher  # noqa: E402
from repro_torch.models import attention  # noqa: E402
from repro_torch.models.convert import from_jax_params  # noqa: E402
from repro_torch.models.model_zoo import build_model  # noqa: E402
from repro_torch.training import checkpoint, optim, trainer  # noqa: E402

CPU = "cpu"
KW = dict(lr=3e-3, warmup_steps=3, decay_steps=10, seed=0)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Small products on one thread: the suite runs in several worker
    processes at once, and threads beyond one per worker only contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def tiny():
    jcfg = jget_config("tiny-lm").with_overrides(dtype="float32")
    cfg = get_config("tiny-lm").with_overrides(dtype="float32")
    jm, m = jbuild_model(jcfg), build_model(cfg)
    return jm, jm.init(jax.random.PRNGKey(0)), m, cfg


@pytest.fixture(scope="module")
def data():
    return jpipeline.make_lm_dataset(64, 32, seed=0), pipeline.make_lm_dataset(64, 32, seed=0)


def carried(jparams, cfg):
    return from_jax_params(np_tree(jparams), cfg, device=CPU)


def tempered(jparams, c):
    """The reference's params with layer 0's wq and wk scaled by ``c``."""
    out = jax.tree_util.tree_map(lambda a: a, jparams)
    att = out["segments"][0]["layer_0"]["attn"]
    att["wq"], att["wk"] = att["wq"] * c, att["wk"] * c
    return out


def one_ulp_up(tree):
    return jax.tree_util.tree_map(
        lambda a: jnp.asarray(np.nextafter(np.asarray(a), np.float32(np.inf))), tree)


@pytest.fixture(scope="module")
def jfns(tiny):
    """The reference's loss gradient and train step (KW's config), jitted once."""
    jm = tiny[0]
    grads = jax.jit(jax.grad(lambda p, b: jm.loss(p, b, Runtime.local())[0]))
    step = jax.jit(jtrainer.make_train_step(jm, JTrainConfig(**KW), Runtime.local()))
    return grads, step


def jrun(step, jparams, ds, n):
    """n steps of the reference's train step: (losses, grad norms, params)."""
    state = {"params": jparams,
             "opt_state": jtrainer.make_optimizer(JTrainConfig(**KW)).init(jparams),
             "step": jnp.zeros((), jnp.float32)}
    it = jpipeline.batch_iterator(ds, 8, seed=0)
    losses, norms = [], []
    for _ in range(n):
        state, met = step(state, next(it))
        losses.append(float(met["loss"]))
        norms.append(float(met["grad_norm"]))
    return np.array(losses), np.array(norms), state["params"]


def tgrads(m, params, batch, remat="none"):
    flat = pytree.tree_flatten(params)
    for p in flat.values():
        p.requires_grad_(True)
    tb = {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}
    loss, _ = m.loss(params, tb, remat=remat)
    return loss.detach(), dict(zip(flat, torch.autograd.grad(loss, list(flat.values()))))


def grad_gap(jgrad, jparams, m, cfg, batch):
    """max |port grad - reference grad| over every leaf, and the reference's
    global norm."""
    jg = pytree.tree_flatten(carried(jgrad(jparams, batch), cfg))
    _, tg = tgrads(m, carried(jparams, cfg), batch)
    gap = max(float((tg[k] - jg[k]).abs().max()) for k in jg)
    return gap, float(torch.sqrt(sum((v.double() ** 2).sum() for v in jg.values())))


# ---------------------------------------------------------------------------
# configs, schedules, clipping
# ---------------------------------------------------------------------------


def test_train_config_is_a_copy_of_the_reference():
    import dataclasses
    mine, theirs = TrainConfig(), JTrainConfig()
    assert [f.name for f in dataclasses.fields(mine)] == [f.name for f in dataclasses.fields(theirs)]
    for f in dataclasses.fields(mine):
        assert getattr(mine, f.name) == getattr(theirs, f.name), f.name


def _same_fields(mine, theirs):
    import dataclasses
    for f in dataclasses.fields(mine):      # a field the reference lacks holds its default
        assert getattr(mine, f.name) == getattr(theirs, f.name, f.default), f.name


@pytest.mark.parametrize("name", ["tiny-lm", "llama3-8b", "qwen2.5-7b", "granite-20b",
                                  "minicpm-2b", "yi-34b"])
def test_reduced_config_is_the_reference_reduced(name):
    _same_fields(get_config(name).reduced(), jget_config(name).reduced())


@pytest.mark.parametrize("name", ["mamba2-130m", "zamba2-1.2b"])
def test_reduced_config_refuses_what_cannot_train(name):
    """reduced() is the reference's for SSM and hybrid configs (state 16, 4
    heads of 32, a chunk of 16, a window of 16), and the port's own reduced
    config trains: a finite loss with a gradient for every leaf (zeros for
    dt_bias, which the loss never reads). The name is kept from when
    training these raised; tests/test_torch_ssm_train.py holds the numbers
    against the reference's."""
    cfg = get_config(name).reduced().with_overrides(dtype="float32")
    _same_fields(cfg, jget_config(name).reduced().with_overrides(dtype="float32"))
    model = build_model(cfg)
    params = model.init(seed=0, device="cpu")
    leaves = list(pytree.tree_flatten(params).values())
    for p in leaves:
        p.requires_grad_(True)
    loss, _ = model.loss(params, {"tokens": torch.arange(1, 25).reshape(1, 24)})
    grads = torch.autograd.grad(loss, leaves, allow_unused=True, materialize_grads=True)
    assert torch.isfinite(loss) and all(torch.isfinite(g).all() for g in grads)


@pytest.mark.parametrize("cfg", [
    dict(schedule="cosine", warmup_steps=10, decay_steps=150),
    dict(schedule="cosine", warmup_steps=100, decay_steps=1000),
    dict(schedule="wsd", warmup_steps=10, stable_steps=40, decay_steps=150),
    dict(schedule="constant", warmup_steps=7, decay_steps=40)], ids=lambda c: c["schedule"])
def test_schedules_match(cfg):
    js = joptim.lr_schedule(JTrainConfig(lr=3e-3, **cfg))
    ts = optim.lr_schedule(TrainConfig(lr=3e-3, **cfg))
    steps = range(cfg["decay_steps"] + 5)
    want = np.array([float(js(jnp.asarray(s, jnp.float32))) for s in steps])
    got = np.array([ts(s) for s in steps])
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    assert got[0] == 0.0 and got.max() <= np.float32(3e-3)


def test_unknown_schedule_and_optimizer_raise():
    with pytest.raises(KeyError):
        optim.lr_schedule(TrainConfig(schedule="linear"))
    with pytest.raises(KeyError):
        optim.make_optimizer(TrainConfig(optimizer="lion"))


def _rand_like(tree, seed, heavy=False):
    """Normal draws, or heavy-tailed ones (Student t, 2 dof): with those,
    Adafactor's rank-1 second moment underestimates the spikes and its RMS
    clip engages, by another amount in every layer."""
    rng = np.random.default_rng(seed)
    draw = (lambda s: rng.standard_t(2.0, s)) if heavy else rng.standard_normal
    return jax.tree_util.tree_map(lambda a: jnp.asarray(draw(a.shape).astype(np.float32)),
                                  tree)


@pytest.mark.parametrize("max_norm", [0.5, 1e9])
def test_clipping_on_the_model_tree(tiny, max_norm):
    jm, jparams, m, cfg = tiny
    jg = _rand_like(jparams, 3)
    jclip, jn = joptim.clip_by_global_norm(jg, max_norm)
    tclip, tn = optim.clip_by_global_norm(pytree.tree_flatten(carried(jg, cfg)), max_norm)
    close(tn, jn, rtol=1e-6, atol=0)
    want = pytree.tree_flatten(carried(jclip, cfg))
    for k in want:
        close(tclip[k], want[k], rtol=1e-6, atol=1e-7)


# ---------------------------------------------------------------------------
# optimizers on the reference's stacked leaves
# ---------------------------------------------------------------------------


def _with_random_norms(jparams, seed=5):
    """Norm scales drawn away from their zero init, so decay shows on them."""
    rng = np.random.default_rng(seed)
    out = jax.tree_util.tree_map(lambda a: a, jparams)
    blk = out["segments"][0]["layer_0"]
    for k in ("ln1", "ln2"):
        blk[k] = jnp.asarray(rng.standard_normal(blk[k].shape).astype(np.float32))
    return out


@pytest.fixture(scope="module")
def opt_runs(tiny):
    """_optimizer_run's results, each computed once."""
    runs = {}

    def get(kind, groups=True):
        if (kind, groups) not in runs:
            runs[kind, groups] = _optimizer_run(tiny, kind, groups)
        return runs[kind, groups]

    return get


def _optimizer_run(tiny, kind, groups, n=5):
    """Five updates with fed-in gradients in both packages; returns the
    reference's params and state and the port's, flattened to port paths."""
    jm, jparams, m, cfg = tiny
    jparams = _with_random_norms(jparams)
    tcfg = dict(lr=1e-2, schedule="cosine", warmup_steps=2, decay_steps=8, weight_decay=0.1)
    if kind == "sgd":
        jopt, topt = joptim.sgd_simple(1e-2), optim.sgd_simple(1e-2)
    else:
        jopt = joptim.make_optimizer(JTrainConfig(optimizer=kind, **tcfg))
        names = pytree.tree_flatten(m.spec())
        topt = optim.make_optimizer(TrainConfig(optimizer=kind, **tcfg),
                                    trainer.param_groups(cfg, names) if groups else None)
    tparams = pytree.tree_flatten(carried(jparams, cfg))
    jstate, tstate = jopt.init(jparams), topt.init(tparams)
    jupdate = jax.jit(jopt.update)
    for i in range(n):
        jg = _rand_like(jparams, 10 + i, heavy=True)
        jparams, jstate = jupdate(jg, jstate, jparams, jnp.asarray(i, jnp.float32))
        topt.update(pytree.tree_flatten(carried(jg, cfg)), tstate, tparams, i)
    return pytree.tree_flatten(carried(jparams, cfg)), jstate, tparams, tstate


@pytest.mark.parametrize("kind", ["adamw", "adafactor", "sgd"])
def test_optimizers_match_on_the_stacked_tree(tiny, opt_runs, kind):
    want, jstate, got, tstate = opt_runs(kind)
    for k in want:
        close(got[k], want[k], rtol=1e-5, atol=1e-6)
    if kind == "adamw":
        _, _, _, cfg = tiny
        for mom in ("m", "v"):
            jm_ = pytree.tree_flatten(carried(jstate[mom], cfg))
            for k in jm_:
                close(tstate[mom][k], jm_[k], rtol=1e-5, atol=1e-6)
    if kind == "adafactor":
        # the norms' second moment is factored over (layers, d), as the reference's
        st = jstate["segments"][0]["layer_0"]["ln1"]
        mine = tstate["layers/0/ln1"]
        assert set(mine) == {"vr", "vc"} and mine["vr"].shape == (4,)
        close(mine["vr"], st["vr"], rtol=1e-5, atol=1e-6)
        close(mine["vc"], st["vc"], rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("kind,leaves", [
    ("adamw", ["layers/0/ln1", "layers/3/ln2"]),          # decay on (L, d) norms
    ("adafactor", ["layers/0/ln1", "layers/2/ln2"]),      # norms factored over (L, d)
    ("adafactor", ["layers/0/attn/wq", "layers/1/mlp/w_up"]),   # RMS clip over the stack
], ids=["adamw-decays-stacked-norms", "adafactor-factors-stacked-norms",
        "adafactor-clips-over-the-stack"])
def test_per_layer_leaves_would_break_the_reference_rule(opt_runs, kind, leaves):
    """Each of the reference's stacked-leaf rules: the port matches with the
    reference's grouping and misses without it (one leaf per layer)."""
    want, _, got, _ = opt_runs(kind)
    _, _, per_layer, _ = opt_runs(kind, groups=False)
    for k in leaves:
        close(got[k], want[k], rtol=1e-5, atol=1e-6)
        assert float((per_layer[k] - want[k]).abs().max()) > 1e-5, k


def test_groups_must_cover_the_params():
    p = {"a": torch.zeros(2), "b": torch.zeros(2)}
    with pytest.raises(ValueError):
        optim.adamw(TrainConfig(), [optim.Group(("a",))]).update(p, None, p, 0)


# ---------------------------------------------------------------------------
# data, forward, loss
# ---------------------------------------------------------------------------


def test_batch_iterator_is_bit_identical(data):
    jds, ds = data
    assert np.array_equal(jds.tokens, ds.tokens) and np.array_equal(jds.loss_mask, ds.loss_mask)
    jit, it = jpipeline.batch_iterator(jds, 24, seed=3), pipeline.batch_iterator(ds, 24, seed=3,
                                                                                  device=CPU)
    for _ in range(5):                # past two epoch boundaries (64 // 24 = 2 a pass)
        jb, tb = next(jit), next(it)
        for k in ("tokens", "loss_mask"):
            assert tb[k].dtype == torch.int32
            np.testing.assert_array_equal(tb[k].numpy(), np.asarray(jb[k]))


@pytest.mark.parametrize("S,H,KV", [(21, 4, 2), (21, 4, 4), (600, 4, 2), (1030, 4, 1)],
                         ids=str)
def test_blocked_attention_matches_reference_and_autograd(S, H, KV):
    """One block (S=21) and two or three blocks of 512 with a ragged last one,
    GQA groups of 2, 1 and 4."""
    rng = np.random.default_rng(0)
    B, hd = 2 if S < 1000 else 1, 32
    q, k, v = (rng.standard_normal(s).astype(np.float32)
               for s in ((B, S, H, hd), (B, S, KV, hd), (B, S, KV, hd)))
    want = jattention.blocked_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                        causal=True)
    tq, tk, tv = (torch.from_numpy(a).requires_grad_(True) for a in (q, k, v))
    got = attention.blocked_attention(tq, tk, tv)
    close(got, want, rtol=1e-5, atol=1e-5)
    # its gradient is the full softmax's (the plain flash version's)
    w = torch.from_numpy(rng.standard_normal((B, S, H, hd)).astype(np.float32))
    rq, rk, rv = (torch.from_numpy(a).requires_grad_(True) for a in (q, k, v))
    plain = ref.flash_attention_ref(rq, rk, rv, causal=True)
    for a, b in zip(torch.autograd.grad((got * w).sum(), (tq, tk, tv)),
                    torch.autograd.grad((plain * w).sum(), (rq, rk, rv))):
        close(a, b, rtol=1e-4, atol=1e-5)


def test_remat_gives_the_same_numbers(tiny, data):
    _, jparams, m, cfg = tiny
    batch = next(jpipeline.batch_iterator(data[0], 8, seed=0))
    l0, g0 = tgrads(m, carried(jparams, cfg), batch)
    l1, g1 = tgrads(m, carried(jparams, cfg), batch, remat="full")
    assert torch.equal(l0, l1)
    for k in g0:
        torch.testing.assert_close(g1[k], g0[k], rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("name", ["mamba2-130m", "zamba2-1.2b"])
def test_ssm_and_hybrid_training_is_queued(name):
    """Once queued, SSM and hybrid training now runs (the name is kept): two
    train_loop steps of the reduced config from seeded weights, remat on,
    give finite losses and finite weights, and dt_bias, which no loss reads,
    keeps zero AdamW moments."""
    cfg = port_config(jget_config(name).reduced().with_overrides(dtype="float32"))
    ds = pipeline.make_lm_dataset(16, 24, seed=0)
    ds.tokens = np.minimum(ds.tokens, cfg.vocab_size - 1)
    state = trainer.train_loop(build_model(cfg), TrainConfig(**KW, remat="full"),
                               pipeline.batch_iterator(ds, 4, seed=0, device=CPU), 2,
                               verbose=False, device=CPU)
    assert state.step == 2
    assert all(np.isfinite(float(h["loss"])) for h in state.history)
    flat = pytree.tree_flatten(state.params)
    assert all(torch.isfinite(p).all() for p in flat.values())
    dt_bias = [k for k in flat if k.endswith("/ssm/dt_bias")]
    assert len(dt_bias) == cfg.n_layers
    assert not any(state.opt_state["m"][k].any() for k in dt_bias)


# ---------------------------------------------------------------------------
# the train step and loop
# ---------------------------------------------------------------------------


def test_microbatches_are_token_weighted(tiny, data):
    """Four microbatches with unequal supervised-token counts give the full
    batch's loss and update, and the reference's microbatched step."""
    jm, jparams, m, cfg = tiny
    jparams = tempered(jparams, 0.1)
    batch = next(jpipeline.batch_iterator(data[0], 8, seed=0))
    counts = np.asarray(batch["loss_mask"])[:, 1:].reshape(4, -1).sum(axis=1)
    assert len(set(counts.tolist())) > 1
    tb = {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}
    out = {}
    for micro in (0, 4):
        tcfg = TrainConfig(microbatch=micro, **KW)
        state = trainer.init_state(m, 0, tcfg, params=carried(jparams, cfg))
        state, met = trainer.make_train_step(m, tcfg)(state, tb)
        out[micro] = (met, pytree.tree_flatten(state.params))
    jtcfg = JTrainConfig(microbatch=4, **KW)
    jstate = {"params": jparams, "opt_state": jtrainer.make_optimizer(jtcfg).init(jparams),
              "step": jnp.zeros((), jnp.float32)}
    jstate, jmet = jax.jit(jtrainer.make_train_step(jm, jtcfg, Runtime.local()))(jstate, batch)
    jflat = pytree.tree_flatten(carried(jstate["params"], cfg))
    close(out[4][0]["loss"], out[0][0]["loss"], rtol=1e-6, atol=0)
    close(out[4][0]["grad_norm"], out[0][0]["grad_norm"], rtol=1e-5, atol=0)
    close(out[4][0]["loss"], jmet["loss"], rtol=1e-6, atol=0)
    close(out[4][0]["grad_norm"], jmet["grad_norm"], rtol=1e-5, atol=0)
    # AdamW's first update is lr * g / (|g| + 1e-8) per element (lr 1e-3 at
    # step 1): for a gradient near 1e-8 fp32 noise moves it by a share of lr,
    # so the weights are held at 1% of that step
    for k in jflat:
        close(out[4][1][k], out[0][1][k], rtol=1e-5, atol=1e-5)
        close(out[4][1][k], jflat[k], rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("scale,grad_tol,loss_rtol", [(0.1, 1e-5, 1e-4), (1.0, 2e-3, 1e-2)],
                         ids=["well-conditioned", "reference-init"])
def test_train_loop_matches_reference(tiny, data, jfns, scale, grad_tol, loss_rtol):
    """10 steps of train_loop from carried params against the reference's
    jitted train step on the same batches (cosine schedule, AdamW, clipping);
    the step-1 gradients leaf by leaf."""
    jm, jparams, m, cfg = tiny
    jparams = tempered(jparams, scale)
    jds, ds = data
    gap, norm = grad_gap(jfns[0], jparams, m, cfg, next(jpipeline.batch_iterator(jds, 8, seed=0)))
    assert gap <= grad_tol * norm, (gap, norm)
    jl, jn, jfinal = jrun(jfns[1], jparams, jds, 10)
    state = trainer.train_loop(m, TrainConfig(**KW), pipeline.batch_iterator(ds, 8, seed=0,
                                                                             device=CPU),
                               10, verbose=False, device=CPU, params=carried(jparams, cfg))
    assert state.step == 10 and len(state.history) == 10
    tl = np.array([float(h["loss"]) for h in state.history])
    np.testing.assert_allclose(tl, jl, rtol=loss_rtol, atol=0)
    if scale < 1:
        close(tl[0], jl[0], rtol=1e-6, atol=0)
        tn = np.array([float(h["grad_norm"]) for h in state.history])
        np.testing.assert_allclose(tn, jn, rtol=1e-3, atol=0)
        want = pytree.tree_flatten(carried(jfinal, cfg))
        got = pytree.tree_flatten(state.params)
        for k in want:
            close(got[k], want[k], rtol=1e-4, atol=1e-5)


def test_reference_moves_more_under_one_ulp(tiny, data, jfns):
    """At the reference's own init, one ulp more on every weight moves the
    reference's step-1 grads by more than 1e-5 of the global norm and its
    10-step losses by more than rtol 1e-4: the tight tolerances cannot hold
    there for any fp32 implementation."""
    jm, jparams, m, cfg = tiny
    jds, _ = data
    batch = next(jpipeline.batch_iterator(jds, 8, seed=0))
    a = pytree.tree_flatten(carried(jfns[0](jparams, batch), cfg))
    b = pytree.tree_flatten(carried(jfns[0](one_ulp_up(jparams), batch), cfg))
    norm = float(torch.sqrt(sum((v.double() ** 2).sum() for v in a.values())))
    assert max(float((a[k] - b[k]).abs().max()) for k in a) > 1e-5 * norm
    la = jrun(jfns[1], jparams, jds, 10)[0]
    lb = jrun(jfns[1], one_ulp_up(jparams), jds, 10)[0]
    assert np.abs(lb / la - 1).max() > 1e-4


# ---------------------------------------------------------------------------
# checkpoints and launchers
# ---------------------------------------------------------------------------


def test_checkpoint_round_trip_and_mismatch(tiny, tmp_path):
    _, jparams, m, cfg = tiny
    tcfg = TrainConfig(**KW)
    state = trainer.init_state(m, 0, tcfg, params=carried(jparams, cfg))
    tree = state.tree()
    path = checkpoint.save_checkpoint(str(tmp_path), tree, step=7)
    assert checkpoint.latest_checkpoint(str(tmp_path)) == path
    assert checkpoint.latest_checkpoint(str(tmp_path / "none")) is None
    back = checkpoint.restore_checkpoint(path, tree)
    want, got = pytree.tree_flatten(tree), pytree.tree_flatten(back)
    assert list(want) == list(got)
    for k in want:
        assert got[k].dtype == want[k].dtype and torch.equal(got[k], want[k].detach()), k
    with pytest.raises(ValueError, match="mismatch"):
        checkpoint.restore_checkpoint(path, {"params": tree["params"]})
    bad = pytree.tree_map(lambda t: t, tree)
    bad["params"]["final_norm"] = torch.zeros(3)
    with pytest.raises(ValueError, match="shape mismatch"):
        checkpoint.restore_checkpoint(path, bad)
    bf = {"w": torch.randn(3, 5).to(torch.bfloat16)}
    p2 = checkpoint.save_checkpoint(str(tmp_path), bf, step=8, name="bf")
    assert torch.equal(checkpoint.restore_checkpoint(p2, bf)["w"], bf["w"])


def test_reference_checkpoint_serves_the_same_logits(tiny, tmp_path):
    jm, jparams, m, cfg = tiny
    path = jcheckpoint.save_checkpoint(str(tmp_path), {"params": jparams}, step=1)
    with np.load(path) as data:
        tree = pytree.tree_unflatten({k: data[k] for k in data.files})
    params = from_jax_params(tree["params"], cfg, device=CPU)
    toks = np.random.default_rng(0).integers(3, 512, (2, 9)).astype(np.int32)
    jlogits, _, _, _ = jm.prefill(jparams, {"tokens": jnp.asarray(toks)}, Runtime.local())
    logits, _, _ = m.prefill(params, torch.from_numpy(toks).long())
    close(logits, jlogits, rtol=1e-4, atol=1e-4 * float(np.abs(np.asarray(jlogits)).max()))


def test_pytree_helpers_match_reference(tiny):
    _, jparams, _, cfg = tiny
    params = carried(jparams, cfg)
    assert pytree.tree_size(params) == jpytree.tree_size(jparams)
    assert pytree.tree_bytes(params) == jpytree.tree_bytes(jparams)
    half = pytree.tree_cast(params, torch.bfloat16)
    assert pytree.tree_bytes(half) == jpytree.tree_bytes(jpytree.tree_cast(jparams, jnp.bfloat16))
    assert pytree.check_finite(params) and jpytree.check_finite(jparams)
    params["layers"][1]["ln1"][0] = float("nan")
    assert not pytree.check_finite(params)
    flat = pytree.tree_flatten(params)
    assert list(pytree.tree_flatten(pytree.tree_unflatten(flat))) == list(flat)


def test_train_launcher_checkpoints_and_serve_restores(tmp_path, capsys):
    state = train_launcher.main(["--device", "cpu", "--steps", "4", "--batch", "4",
                                 "--seq", "32", "--n-data", "32",
                                 "--ckpt-dir", str(tmp_path)])
    assert state.step == 4
    assert sorted(os.listdir(tmp_path)) == ["ckpt_00000002.json", "ckpt_00000002.npz",
                                            "ckpt_00000004.json", "ckpt_00000004.npz"]
    losses = [float(h["loss"]) for h in state.history]
    assert np.isfinite(losses).all()
    out = serve.main(["--mode", "real", "--device", "cpu", "--n-requests", "4", "--r", "2",
                      "--max-new", "4", "--ckpt", str(tmp_path / "ckpt_00000004.npz")])
    assert np.isfinite(out["median"]).all()
