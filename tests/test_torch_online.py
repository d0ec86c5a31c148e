"""The port's ``core/online.py`` (online dataset, the online predictor, the
hazard table, ``PosteriorRefiner``, ``evaluate_by_progress``) against the
reference's, and the refiner in the port's cluster.

``build_online_dataset``, the hazard features, ``HazardTable`` and
``PosteriorRefiner`` are NumPy on both sides: bit-identical outputs. A
cluster replay with mid-flight refinement (truncate-renorm, and with a
hazard table) gives the reference's ``ClusterStats`` row bit for bit on both
decode paths.

The two fits (``fit_hazard_table``, ``train_online_predictor``) are fed the
reference's head init and minibatch seed (recorded from its run, injected
as ``test_torch_baselines.py`` does) and train ≥ 400 AdamW steps: they are
held within that file's 400-step spread, rtol 1e-2 (atol 1e-4 on
probabilities, 2e-3 on tokens). ``evaluate_by_progress`` with a head carried
across is held within the head's tolerance, rtol 1e-4 / atol 2e-3 tokens.
"""

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_parity import jax, np_tree  # noqa: E402

from repro.common.config import PredictorConfig as JPredictorConfig  # noqa: E402
from repro.core import online as jonline  # noqa: E402
from repro.core import predictor as jcore_predictor  # noqa: E402
from repro.serving import arrivals as jarrivals  # noqa: E402
from repro.serving import cluster as jcluster  # noqa: E402
from repro.serving import engine as jengine  # noqa: E402
from repro.serving import scheduler as jscheduler  # noqa: E402
from repro_torch.common.config import PredictorConfig  # noqa: E402
from repro_torch.core import online  # noqa: E402
from repro_torch.core import predictor as core_predictor  # noqa: E402
from repro_torch.core.bins import log_edges  # noqa: E402
from repro_torch.core.predictor import LengthPredictor  # noqa: E402
from repro_torch.models.convert import head_from_jax  # noqa: E402
from repro_torch.serving import arrivals, cluster, engine, scheduler  # noqa: E402

EDGES = log_edges(32, 1024.0, device="cpu").double().numpy()


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Small products on one thread: the suite runs in several worker
    processes at once, and threads beyond one per worker only contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _histograms(n, seed, edges=EDGES):
    """Unimodal log-normal-ish histograms with a heavy right shoulder."""
    rng = np.random.default_rng(seed)
    mid = np.log(np.maximum(0.5 * (edges[:-1] + edges[1:]), 1.0))
    centers = rng.uniform(2.0, 6.5, size=n)
    widths = rng.uniform(0.3, 1.2, size=n)
    p = np.exp(-0.5 * ((mid[None] - centers[:, None]) / widths[:, None]) ** 2) + 1e-4
    return p / p.sum(1, keepdims=True)


def _recording(inits, seeds):
    real = jcore_predictor.head_init

    def rec(key, d, hidden, K):
        seed = int(jax.random.randint(key, (), 0, 2 ** 31 - 1))
        inits[seed] = np_tree(real(key, d, hidden, K))
        seeds.append(seed)
        return real(key, d, hidden, K)

    return rec


@pytest.fixture
def inject(monkeypatch):
    """Record the reference's head inits; hand them to the port's fits."""
    inits, seeds = {}, []
    monkeypatch.setattr(jcore_predictor, "head_init", _recording(inits, seeds))
    monkeypatch.setattr(core_predictor, "head_init",
                        lambda seed, d, hidden, K, device=None:
                        head_from_jax(inits[seed], device=device))
    return seeds


def test_online_dataset_and_hazard_features_are_bit_identical():
    rng = np.random.default_rng(0)
    hidden = rng.standard_normal((5, 12, 6)).astype(np.float32)
    valid = rng.random((5, 12)) < 0.8
    lengths = np.array([12, 3, 7, 1, 10])
    for stride in (1, 3):
        got = online.build_online_dataset(hidden, valid, lengths, stride)
        want = jonline.build_online_dataset(hidden, valid, lengths, stride)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype and np.array_equal(g, w)
    ts = np.array([0, 1, 5, 64, 511, 2048])
    assert np.array_equal(online._hazard_features(ts, 1024.0),
                          jonline._hazard_features(ts, 1024.0))


def _tables(seed=3):
    """The same hazard table in both packages."""
    ts = np.array([0.0, 4.0, 16.0, 64.0, 256.0])
    probs = _histograms(len(ts), seed + 1)
    prior = _histograms(1, seed + 2)[0]
    clip = (0.3, 3.0)
    return (online.HazardTable(ts, probs, prior, clip),
            jonline.HazardTable(ts, probs, prior, clip))


@pytest.mark.parametrize("hazard", [False, True], ids=["renorm", "hazard"])
def test_posterior_refiner_is_bit_identical(hazard):
    hz, jhz = _tables() if hazard else (None, None)
    for kw in ({}, dict(work_quantile=0.8, cap=900.0)):
        rz = online.PosteriorRefiner(EDGES, hazard=hz, **kw)
        jrz = jonline.PosteriorRefiner(EDGES, hazard=jhz, **kw)
        assert rz.cap == jrz.cap
        for p in _histograms(12, 7):
            for t in (0.0, 1.0, 3.5, 30.0, 200.0, 1023.0, 1024.0, 5000.0):
                assert np.array_equal(rz.condition(p, t), jrz.condition(p, t))
                assert rz.survivor(p, t) == jrz.survivor(p, t)
                qs = (0.1, 0.5, 0.9, 0.999)
                assert np.array_equal(rz.quantiles(p, t, qs), jrz.quantiles(p, t, qs))
                assert rz.quantile(p, t, 0.7) == jrz.quantile(p, t, 0.7)
                assert rz.level_of(p, t + 17.0) == jrz.level_of(p, t + 17.0)
    if hazard:
        for t in (-1.0, 0.0, 5.0, 300.0):
            assert np.array_equal(hz.row(t), jhz.row(t))
    with pytest.raises(ValueError):
        online.PosteriorRefiner(np.array([4.0]))
    with pytest.raises(ValueError):
        online.PosteriorRefiner(EDGES, work_quantile=1.0)


def _annotated_trace(arr, refiner, n=250, seed=17):
    """A trace pre-annotated with dispatch histograms and their quantiles
    (predictor=None at the seam), in either package."""
    reqs = arr.make_trace(arr.TraceConfig(n_requests=n, pattern="bursty", rate=0.9,
                                          seed=seed, max_seq_len=1024,
                                          slo_factor=4.0, slo_floor=60.0))
    for r, p in zip(reqs, _histograms(len(reqs), seed)):
        med, q9 = refiner.quantiles(p, 0.0, (0.5, 0.9))
        r.pred_probs = p.astype(np.float32)
        r.predicted_len, r.pred_q, r.reserve_len = float(med), float(q9), float(q9)
    return reqs


@pytest.mark.parametrize("vectorized", [True, False], ids=["vectorized", "per_slot"])
@pytest.mark.parametrize("order", ["srtf_pred", "laxity"])
@pytest.mark.parametrize("hazard", [False, True], ids=["renorm", "hazard"])
def test_refined_cluster_rows_are_bit_identical(hazard, order, vectorized):
    hz, jhz = _tables() if hazard else (None, None)
    rows = []
    for arr, clu, eng, sched, mod, h in ((jarrivals, jcluster, jengine, jscheduler, jonline, jhz),
                                         (arrivals, cluster, engine, scheduler, online, hz)):
        rz = mod.PosteriorRefiner(EDGES, hazard=h)
        reqs = _annotated_trace(arr, rz)
        pol = sched.Policy(order, "quantile", quantile=0.9, max_seq_len=1024,
                           preempt=order == "srtf_pred", preempt_factor=1.5,
                           preempt_mode="keep", refine_every=16)
        specs = [eng.ReplicaSpec(max_slots=6, kv_budget=3072, page_size=16, speed=2,
                                 prefill_tokens_per_step=64)] * 3
        st = clu.Cluster(specs, pol, router="psq", refiner=rz,
                         vectorized=vectorized).run(reqs)
        rows.append(st.row())
    want, got = rows
    assert got.keys() == want.keys()
    for k, w in want.items():
        if isinstance(w, float) and math.isnan(w):
            assert math.isnan(got[k]), k
        else:
            assert got[k] == w and type(got[k]) is type(w), (k, got[k], w)
    assert got["refine_events"] > 0


def test_fit_hazard_table_follows_the_reference(inject):
    probs = _histograms(200, 5)
    lengths = np.random.default_rng(5).lognormal(4.0, 1.0, 200).clip(1, 1000).round()
    want = jonline.fit_hazard_table(jax.random.PRNGKey(3), probs, lengths, EDGES, epochs=4)
    got = online.fit_hazard_table(inject[0], probs, lengths, EDGES, epochs=4, device="cpu")
    assert np.array_equal(got.ts, want.ts) and np.array_equal(got.prior, want.prior)
    assert got.clip == want.clip and got.probs.dtype == np.float64
    assert got.probs.shape == want.probs.shape == (len(want.ts), 32)
    np.testing.assert_allclose(got.probs, want.probs, rtol=1e-2, atol=1e-4)


def test_online_predictor_and_progress_eval_follow_the_reference(inject):
    rng = np.random.default_rng(2)
    phi = rng.standard_normal((300, 8)).astype(np.float32)
    remaining = np.exp(3.0 + phi[:, 0] + 0.3 * rng.standard_normal(300)).astype(np.float32)
    kw = dict(n_bins=16, hidden=32, bin_max=300.0, epochs=2)
    jpred = jonline.train_online_predictor(jax.random.PRNGKey(1), phi, remaining,
                                           JPredictorConfig(**kw))
    pred = online.train_online_predictor(inject[0], phi, remaining, PredictorConfig(**kw),
                                         device="cpu")
    np.testing.assert_allclose(pred.predict(phi).numpy(), np.asarray(jpred.predict(phi)),
                               rtol=1e-2, atol=2e-3)
    ts = rng.integers(1, 200, 300)
    static = remaining + ts + rng.normal(0, 5, 300)
    carried = LengthPredictor(head_from_jax(np_tree(jpred.params), device="cpu"),
                              torch.from_numpy(np.array(jpred.edges)), PredictorConfig(**kw))
    got = online.evaluate_by_progress(carried, phi, remaining, ts, static, n_buckets=3)
    want = jonline.evaluate_by_progress(jpred, phi, remaining, ts, static, n_buckets=3)
    assert got["count"] == want["count"] and got.keys() == want.keys()
    for part in ("online", "static"):
        assert got[part].keys() == want[part].keys()
        for t in want[part]:
            assert got[part][t] == pytest.approx(want[part][t], rel=1e-4, abs=2e-3)
