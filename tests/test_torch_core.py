"""Port core (bins, targets, losses, metrics, head, AdamW, train_predictor)
against the JAX package on the same numpy inputs. Tolerances: fp32 ops
that both sides compute in the same order are held to 1e-6; sums taken in
another order (matrix products, softmax) to 1e-5; training trajectories,
where those differences compound over the steps, to 1e-4."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_parity import CPU, close, jax, jnp  # noqa: E402

from repro.common.config import PredictorConfig as JPredictorConfig  # noqa: E402
from repro.common.config import TrainConfig as JTrainConfig  # noqa: E402
from repro.core import bins as jbins  # noqa: E402
from repro.core import heads as jheads  # noqa: E402
from repro.core import losses as jlosses  # noqa: E402
from repro.core import metrics as jmetrics  # noqa: E402
from repro.core import predictor as jpredictor  # noqa: E402
from repro.core import targets as jtargets  # noqa: E402
from repro.training import optim as joptim  # noqa: E402
from repro_torch.common.config import PredictorConfig, TrainConfig  # noqa: E402
from repro_torch.core import bins, heads, losses, metrics, targets  # noqa: E402
from repro_torch.core.predictor import LengthPredictor, train_predictor  # noqa: E402
from repro_torch.models.convert import head_from_jax  # noqa: E402
from repro_torch.training import optim  # noqa: E402


def _t(a):
    return torch.from_numpy(np.array(a))


def _lengths(N, r, seed=0, hi=300):
    """Heavy-tailed integer lengths (N, r), some exactly on bin edges."""
    rng = np.random.default_rng(seed)
    L = np.rint(np.exp(rng.normal(3.5, 0.8, (N, r)))).clip(1, hi)
    L[0, :] = 0.0          # the first edge
    L[1, 0] = hi * 2       # overflow clamps to the last bin
    return L.astype(np.float32)


# -- bins -------------------------------------------------------------------


@pytest.mark.parametrize("spacing", ["linear", "log"])
@pytest.mark.parametrize("n_bins,bin_max", [(16, 64.0), (32, 72.0), (64, 8192.0)])
def test_make_edges(spacing, n_bins, bin_max):
    got = bins.make_edges(n_bins, bin_max, spacing, device="cpu")
    close(got, jbins.make_edges(n_bins, bin_max, spacing), rtol=1e-6, atol=0)
    assert float(got[0]) == 0.0


@pytest.mark.parametrize("spacing", ["linear", "log"])
def test_bin_index_exact_edges_and_overflow(spacing):
    # one edge array for both (exp may round log edges an ulp apart), with
    # every edge itself among the lengths: side="right" semantics exactly
    je = jbins.make_edges(32, 72.0, spacing)
    te = _t(je)
    L = np.concatenate([_lengths(40, 4).ravel(), np.asarray(je)]).astype(np.float32)
    np.testing.assert_array_equal(bins.bin_index(_t(L), te).numpy(),
                                  np.asarray(jbins.bin_index(jnp.asarray(L), je)))


@pytest.mark.parametrize("how", ["median", "mean", "argmax"])
def test_decoders(how):
    rng = np.random.default_rng(1)
    logits = rng.standard_normal((20, 12)).astype(np.float32) * 2
    probs = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    probs[0] = 0.0                      # CDF never reaches 0.5: bin 0 fallback
    edges = np.linspace(0, 120, 13).astype(np.float32)
    close(bins.decode(_t(probs), _t(edges), how),
          jbins.decode(jnp.asarray(probs), jnp.asarray(edges), how), rtol=1e-5, atol=1e-4)


# -- targets, losses, metrics ----------------------------------------------


@pytest.mark.parametrize("r", [4, 5], ids=["even_r", "odd_r"])
@pytest.mark.parametrize("kind", ["median", "dist", "single"])
def test_targets(kind, r):
    L = _lengths(50, r, seed=r)
    je = jbins.make_edges(32, 200.0)
    te = bins.make_edges(32, 200.0, device="cpu")
    close(targets.build_target(_t(L), te, kind, single_idx=1),
          jtargets.build_target(jnp.asarray(L), je, kind, single_idx=1), rtol=0, atol=1e-7)


def test_sample_median_even_r_averages_the_middle_pair():
    L = np.array([[1, 2, 10, 40], [3, 3, 4, 100]], np.float32)
    got = targets.sample_median(_t(L))
    np.testing.assert_array_equal(got.numpy(), [6.0, 3.5])
    close(got, jtargets.sample_median(jnp.asarray(L)), rtol=0, atol=0)


def test_soft_ce():
    rng = np.random.default_rng(2)
    logits = rng.standard_normal((30, 16)).astype(np.float32)
    tgt = rng.dirichlet(np.ones(16), 30).astype(np.float32)
    close(losses.soft_ce(_t(logits), _t(tgt)),
          jlosses.soft_ce(jnp.asarray(logits), jnp.asarray(tgt)), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("r", [4, 7])
def test_mae_and_noise_radius(r):
    L = _lengths(60, r, seed=3 + r)
    pred = L.mean(1) + 3.0
    assert abs(metrics.mae(_t(pred), _t(L[:, 0]))
               - jmetrics.mae(jnp.asarray(pred), jnp.asarray(L[:, 0]))) < 1e-4
    assert abs(metrics.noise_radius(_t(L)) - jmetrics.noise_radius(jnp.asarray(L))) < 1e-4


# -- the head, from weights carried across ---------------------------------


@pytest.fixture(scope="module")
def head():
    jp = jheads.head_init(jax.random.PRNGKey(7), 48, 32, 16)
    jp = {k: v + 0.01 * (i + 1) for i, (k, v) in enumerate(sorted(jp.items()))}
    phi = np.random.default_rng(4).standard_normal((24, 48)).astype(np.float32)
    edges = np.linspace(0, 160, 17).astype(np.float32)
    return jp, head_from_jax(jax.tree_util.tree_map(np.asarray, jp), device="cpu"), phi, edges


def test_head_logits_and_probs(head):
    jp, tp, phi, _ = head
    close(heads.head_logits(tp, _t(phi)), jheads.head_logits(jp, jnp.asarray(phi)),
          rtol=1e-5, atol=1e-5)
    close(heads.head_probs(tp, _t(phi)), jheads.head_probs(jp, jnp.asarray(phi)),
          rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("how", ["median", "mean", "argmax"])
def test_head_predict(head, how):
    jp, tp, phi, edges = head
    close(heads.head_predict(tp, _t(phi), _t(edges), how),
          jheads.head_predict(jp, jnp.asarray(phi), jnp.asarray(edges), how),
          rtol=1e-4, atol=1e-3)


def test_head_quantiles_and_right_edge_quantile(head):
    jp, tp, phi, edges = head
    qs = [0.25, 0.5, 0.9]
    p_got, q_got = heads.head_quantiles(tp, _t(phi), _t(edges), qs)
    p_want, q_want = jheads.head_quantiles(jp, jnp.asarray(phi), jnp.asarray(edges), qs)
    close(p_got, p_want, rtol=1e-5, atol=1e-6)
    close(q_got, q_want, rtol=1e-4, atol=1e-3)
    pc = PredictorConfig()
    tpred = LengthPredictor(tp, _t(edges), pc)
    jpred = jpredictor.LengthPredictor(jp, jnp.asarray(edges), JPredictorConfig())
    for q in (0.5, 0.9):
        close(tpred.quantile(_t(phi), q), jpred.quantile(jnp.asarray(phi), q), rtol=0, atol=1e-5)


# -- optimizer --------------------------------------------------------------


def _opt_inputs():
    rng = np.random.default_rng(5)
    p = {"w": rng.standard_normal((6, 4)).astype(np.float32),
         "b": rng.standard_normal(4).astype(np.float32)}
    g = {k: rng.standard_normal(v.shape).astype(np.float32) for k, v in p.items()}
    return p, g


@pytest.mark.parametrize("step", [0, 9])
def test_adamw_updates_match(step):
    p, g = _opt_inputs()
    kw = dict(lr=1e-2, schedule="constant", warmup_steps=1,
              weight_decay=0.1, beta1=0.9, beta2=0.999)
    jopt = joptim.adamw(JTrainConfig(optimizer="adamw", **kw))
    topt = optim.adamw(TrainConfig(**kw))
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    tp = {k: _t(v).clone() for k, v in p.items()}
    jstate, tstate = jopt.init(jp), topt.init(tp)
    for i in range(2):       # two updates: the moments carry over
        jp, jstate = jopt.update({k: jnp.asarray(v) for k, v in g.items()}, jstate, jp,
                                 jnp.asarray(step + i, jnp.float32))
        topt.update({k: _t(v) for k, v in g.items()}, tstate, tp, step + i)
    for k in p:
        close(tp[k], jp[k], rtol=1e-6, atol=1e-6)
        close(tstate["m"][k], jstate["m"][k], rtol=1e-6, atol=1e-7)
        close(tstate["v"][k], jstate["v"][k], rtol=1e-6, atol=1e-7)


def test_lr_schedule_and_clipping():
    cfg = dict(lr=3e-3, schedule="constant", warmup_steps=4)
    js, ts = joptim.lr_schedule(JTrainConfig(**cfg)), optim.lr_schedule(TrainConfig(**cfg))
    for s in (0, 1, 3, 4, 50):
        assert abs(ts(s) - float(js(jnp.asarray(s, jnp.float32)))) < 1e-9
    for sched in ("cosine", "wsd"):       # ported with the trainer
        js = joptim.lr_schedule(JTrainConfig(schedule=sched, stable_steps=20, decay_steps=60))
        ts = optim.lr_schedule(TrainConfig(schedule=sched, stable_steps=20, decay_steps=60))
        for s in (0, 1, 50, 99, 130):
            assert abs(ts(s) - float(js(jnp.asarray(s, jnp.float32)))) <= 1e-6 * 3e-4
    with pytest.raises(KeyError):
        optim.lr_schedule(TrainConfig(schedule="linear"))
    _, g = _opt_inputs()
    for max_norm in (0.5, 100.0):
        tg, tn = optim.clip_by_global_norm({k: _t(v) for k, v in g.items()}, max_norm)
        jg, jn = joptim.clip_by_global_norm({k: jnp.asarray(v) for k, v in g.items()}, max_norm)
        close(tn, jn, rtol=1e-6, atol=0)
        for k in g:
            close(tg[k], jg[k], rtol=1e-6, atol=1e-7)


# -- train_predictor --------------------------------------------------------


def test_train_predictor_trajectory_matches_reference():
    """Same init weights, same minibatch seed: the per-step soft-CE, the
    trained weights and the predictions follow the reference's."""
    N, d, K, r = 40, 24, 16, 4
    rng = np.random.default_rng(6)
    phi = rng.standard_normal((N, d)).astype(np.float32)
    L = _lengths(N, r, seed=6, hi=150)
    jpcfg = JPredictorConfig(n_bins=K, hidden=32, bin_max=160.0, epochs=6, batch_size=16,
                             weight_decay=0.01)
    tpcfg = PredictorConfig(n_bins=K, hidden=32, bin_max=160.0, epochs=6, batch_size=16,
                            weight_decay=0.01)
    je = jbins.make_edges(K, 160.0)
    te = bins.make_edges(K, 160.0, device="cpu")
    jtgt = jtargets.dist_target(jnp.asarray(L), je)
    key = jax.random.PRNGKey(11)
    init = jheads.head_init(key, d, 32, K)
    seed = int(jax.random.randint(key, (), 0, 2**31 - 1))    # predictor.py:120

    # the reference's own step, replayed to read its per-step loss
    opt, step = jpredictor._opt_and_step(JTrainConfig(
        optimizer="adamw", lr=jpcfg.lr, schedule="constant", warmup_steps=1,
        weight_decay=jpcfg.weight_decay, beta1=0.9, beta2=0.999))
    params, state, perm_rng, jl = init, opt.init(init), np.random.default_rng(seed), []
    for _ in range(jpcfg.epochs):
        perm = perm_rng.permutation(N)
        for s in range(N // 16):
            idx = perm[s * 16:(s + 1) * 16]
            params, state, loss = step(params, state, jnp.asarray(phi)[idx], jtgt[idx],
                                       jnp.asarray(len(jl), jnp.float32))
            jl.append(float(loss))
    jpred = jpredictor.train_predictor(key, jnp.asarray(phi), jtgt, jpcfg, je,
                                       init_params=init)

    tpred = train_predictor(seed, _t(phi), targets.dist_target(_t(L), te), tpcfg, te,
                            init_params=head_from_jax(jax.tree_util.tree_map(np.asarray, init),
                                                      device="cpu"),
                            device="cpu")
    assert tpred.losses.shape == (len(jl),) == (6 * (N // 16),)
    close(tpred.losses, np.asarray(jl), rtol=1e-4, atol=1e-5)
    for k in init:
        close(tpred.params[k], jpred.params[k], rtol=1e-4, atol=1e-4)
    close(tpred.predict(_t(phi)), jpred.predict(jnp.asarray(phi)), rtol=1e-4, atol=2e-3)
    _, tq = tpred.quantiles(_t(phi), [0.5, 0.9])
    _, jq = jpred.quantiles(jnp.asarray(phi), [0.5, 0.9])
    close(tq, jq, rtol=1e-4, atol=2e-3)


def test_train_predictor_cold_start_step_floor():
    phi = np.random.default_rng(8).standard_normal((12, 8)).astype(np.float32)
    tgt = np.eye(4, dtype=np.float32)[np.arange(12) % 4]
    pred = train_predictor(0, phi, tgt, PredictorConfig(n_bins=4, hidden=8, bin_max=40.0,
                                                        epochs=2), device=CPU)
    assert pred.losses.shape == (400,)                   # predictor.py:115
    assert float(pred.losses[-1]) < float(pred.losses[0])
