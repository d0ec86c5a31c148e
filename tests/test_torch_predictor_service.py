"""The port's ``PredictorService``, ``PerfectOracle`` and ``fit_trace_head``
(``serving/predictor.py``) against the reference's.

With the reference's trained head carried across (``models/convert.py``),
the service batches exactly as the reference does, so its ``ServiceStats``
row (batches, padded, buckets, hits, refreshes) is equal, and each request's
``predicted_len``, ``pred_q`` and ``reserve_len`` agree within rtol 1e-4 /
atol 2e-3 tokens and ``pred_probs`` within the head's probs tolerance
(rtol 1e-5 / atol 1e-6): the two heads compute the same fp32 function in
another summation order (measured: 1.2e-4 tokens on the median, 9.8e-4 on
q0.9, 2.1e-7 on probs, here).

Cluster rows under that head are held within rtol 0.1 on every numeric
field, with requests conserved exactly. Reservations are rounded to whole
tokens and pages, so a quantile moved by 1e-3 tokens can move a request's
pages and, in an overloaded replay, its whole schedule after it. Measured on
the reference itself: moving each of its predictions by up to ±1e-3 tokens
(the port's disagreement) moved one of 18 replays (600 requests, 3 replicas,
55% timed out) by up to 7.9% (balance), 4.6% (steal pages) and 3.1% (p99);
the other 17 moved only ``frag_ratio``, by at most 1.7e-4.

``fit_trace_head`` is fed the reference's head init and minibatch seed
(recorded from its run and injected by monkeypatching, as
``test_torch_baselines.py`` does). Its training data are the reference's bit
for bit; after 402 AdamW steps the port's predictions are held within the
400-step spread of ``test_torch_baselines.py`` (rtol 1e-2, atol 2e-3).
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_parity import jax, np_tree  # noqa: E402

from repro.core import predictor as jcore_predictor  # noqa: E402
from repro.serving import arrivals as jarrivals  # noqa: E402
from repro.serving import cluster as jcluster  # noqa: E402
from repro.serving import engine as jengine  # noqa: E402
from repro.serving import predictor as jpredictor  # noqa: E402
from repro.serving import scheduler as jscheduler  # noqa: E402
from repro.serving import telemetry as jtelemetry  # noqa: E402
from repro_torch.common.config import PredictorConfig  # noqa: E402
from repro_torch.core import predictor as core_predictor  # noqa: E402
from repro_torch.core.predictor import LengthPredictor  # noqa: E402
from repro_torch.models.convert import head_from_jax  # noqa: E402
from repro_torch.serving import arrivals, cluster, engine, predictor, scheduler, telemetry  # noqa: E402

RTOL, ATOL = 1e-4, 2e-3                  # tokens
P_RTOL, P_ATOL = 1e-5, 1e-6              # probs
FIT = dict(n_train=800, r=8, seed=5)     # d=4, hidden 128, K=32 log bins to 4096
TRACE = dict(n_requests=600, pattern="bursty", rate=0.5, seed=11,
             slo_factor=6.0, slo_floor=100.0)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Small products on one thread: the suite runs in several worker
    processes at once, and threads beyond one per worker only contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def fitted():
    """The reference's ``fit_trace_head``, recording its head init and the
    minibatch seed its ``train_predictor`` derives from the key."""
    inits, seeds = {}, []
    real = jcore_predictor.head_init

    def recording(key, d, hidden, K):
        seed = int(jax.random.randint(key, (), 0, 2 ** 31 - 1))
        inits[seed] = np_tree(real(key, d, hidden, K))
        seeds.append(seed)
        return real(key, d, hidden, K)

    jcore_predictor.head_init = recording
    try:
        jhead = jpredictor.fit_trace_head(jarrivals.TraceConfig(), **FIT)
    finally:
        jcore_predictor.head_init = real
    return jhead, inits, seeds


def _carried(jhead):
    return LengthPredictor(head_from_jax(np_tree(jhead.params), device="cpu"),
                           torch.from_numpy(np.array(jhead.edges)),
                           PredictorConfig(n_bins=32, hidden=128, bin_spacing="log",
                                           bin_max=4096.0, epochs=25))


def _annotated(svc_kw, pol_kw, jhead, trace=TRACE, dup=0, tracer=False):
    """The same trace annotated by the reference's service and the port's."""
    out = []
    for arr, pred, sched, tel, head in (
            (jarrivals, jpredictor, jscheduler, jtelemetry, jhead),
            (arrivals, predictor, scheduler, telemetry, _carried(jhead))):
        reqs = arr.make_trace(arr.TraceConfig(**trace))
        for i in range(dup):               # retried prompts: same φ, later arrival
            r = reqs[i * 7]
            reqs.append(dataclasses.replace(r, rid=10_000 + i,
                                            arrival=r.arrival + 0.5 + 40.0 * i))
        tr = tel.Tracer() if tracer else None
        svc = pred.PredictorService(head, tracer=tr, **svc_kw)
        svc.annotate(reqs, sched.Policy(**pol_kw))
        out.append((reqs, svc, tr))
    return out


def _close_annotations(got, want):
    for field in ("predicted_len", "pred_q", "reserve_len"):
        g = np.array([getattr(r, field) for r in got])
        w = np.array([getattr(r, field) for r in want])
        np.testing.assert_allclose(g, w, rtol=RTOL, atol=ATOL, err_msg=field)
    gp = [r.pred_probs for r in got]
    wp = [r.pred_probs for r in want]
    if wp[0] is None:
        assert all(p is None for p in gp)
        return
    assert all(p.dtype == np.float32 and p.shape == (32,) for p in gp)
    np.testing.assert_allclose(np.stack(gp), np.stack(wp), rtol=P_RTOL, atol=P_ATOL)


POLICIES = {
    "laxity-q0.9": dict(order="laxity", reserve="quantile", quantile=0.9),
    "sjf-predicted": dict(order="sjf_pred", reserve="predicted", margin=1.3),
    "fcfs-max": dict(order="fcfs", reserve="max", max_seq_len=2048),
    "edf-oracle": dict(order="edf", reserve="oracle"),
    "srtf-q0.95": dict(order="srtf_pred", reserve="quantile", quantile=0.95),
}


@pytest.mark.parametrize("name", sorted(POLICIES))
def test_service_matches_the_reference_with_a_carried_head(name, fitted):
    svc_kw = dict(window=16.0, work_quantile=0.8 if name == "srtf-q0.95" else 0.9)
    (want, jsvc, _), (got, svc, _) = _annotated(svc_kw, POLICIES[name], fitted[0])
    assert svc.stats.row() == jsvc.stats.row()
    assert svc.stats.batches > 50 and svc.stats.row()["buckets"] == [8, 16, 32, 64]
    _close_annotations(got, want)


@pytest.mark.parametrize("svc_kw", [
    dict(window=64.0, max_batch=16, cache_size=64),
    dict(window=4.0, cache_size=0, attach_hist=False),
    dict(window=32.0, step_token_budget=256, prefill_chunk_tokens=16),
    dict(window=32.0, step_token_budget=48),
], ids=["chunked-lru", "no-cache-no-hist", "budget-16-lanes", "budget-atomic"])
def test_batching_cache_and_budget_match(svc_kw, fitted):
    """Chunking at ``max_batch``, LRU hits and in-window dedupe of repeated
    φ, no cache, and the lane cap of a per-step token budget."""
    pol = POLICIES["laxity-q0.9"]
    (want, jsvc, _), (got, svc, _) = _annotated(svc_kw, pol, fitted[0], dup=30)
    assert svc.stats.row() == jsvc.stats.row()
    assert svc.max_batch == jsvc.max_batch
    if svc_kw.get("cache_size", 8192):
        assert svc.stats.cache_hits > 0
    _close_annotations(got, want)


def test_tracer_events_match(fitted):
    (_, _, jtr), (_, _, tr) = _annotated(dict(window=16.0), POLICIES["laxity-q0.9"],
                                         fitted[0], dup=10, tracer=True)
    assert tr.counts["predict"] == jtr.counts["predict"] > 0
    assert [tuple(e) for e in tr.canonical()] == [tuple(e) for e in jtr.canonical()]


def test_predict_quantile_and_swap_weights(fitted):
    jhead = fitted[0]
    phi = np.stack([r.phi for r in arrivals.make_trace(arrivals.TraceConfig(
        n_requests=100, seed=3))])
    svc = predictor.PredictorService(_carried(jhead))
    jsvc = jpredictor.PredictorService(jhead)
    got, want = svc.predict(phi), jsvc.predict(phi)
    assert got.dtype == np.float64 and got.shape == (100,)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(svc.quantile(phi, 0.97), jsvc.quantile(phi, 0.97),
                               rtol=RTOL, atol=ATOL)
    assert svc.stats.row() == jsvc.stats.row()
    reqs = arrivals.make_trace(arrivals.TraceConfig(n_requests=40, seed=4))
    pol = scheduler.Policy("fcfs", "quantile")
    svc.annotate(reqs, pol)
    assert len(svc._cache) == 40
    svc.swap_weights(_carried(jhead))
    assert svc.stats.refreshes == 1 and not svc._cache
    svc.annotate([r.fresh_copy() for r in reqs], pol)
    assert svc.stats.cache_hits == 0
    with pytest.raises(ValueError, match="features"):
        svc.annotate([dataclasses.replace(reqs[0], phi=None)], pol)
    for bad in (dict(window=0.0), dict(max_batch=0), dict(step_token_budget=0)):
        with pytest.raises(ValueError):
            predictor.PredictorService(_carried(jhead), **bad)


@pytest.mark.parametrize("reserve", ["quantile", "max"])
def test_perfect_oracle_matches(reserve):
    out = []
    for arr, pred, sched in ((jarrivals, jpredictor, jscheduler),
                             (arrivals, predictor, scheduler)):
        reqs = arr.make_trace(arr.TraceConfig(n_requests=200, seed=6))
        pred.PerfectOracle().annotate(reqs, sched.Policy("fcfs", reserve, max_seq_len=2048))
        out.append([(r.predicted_len, r.pred_q, r.reserve_len) for r in reqs])
    assert out[0] == out[1]


def _same_within(got, want, rtol):
    assert got.keys() == want.keys()
    for k, w in want.items():
        g = got[k]
        if isinstance(w, (int, float)) and not isinstance(w, bool):
            if np.isnan(w):
                assert np.isnan(g), k
            else:
                assert abs(g - w) <= rtol * abs(w) + 1e-12, (k, g, w)
        else:
            assert g == w, (k, g, w)


@pytest.mark.parametrize("order", ["laxity", "srtf_pred"])
def test_cluster_rows_under_the_carried_head(order, fitted):
    jhead = fitted[0]
    pol = dict(order=order, reserve="quantile", quantile=0.9, max_seq_len=4096,
               preempt=order == "srtf_pred", preempt_mode="keep")
    spec = dict(max_slots=8, kv_budget=8 * (256 + 1024), page_size=16, speed=2,
                prefill_tokens_per_step=64)
    rows, stats = [], []
    for arr, clu, eng, pred, sched, head in (
            (jarrivals, jcluster, jengine, jpredictor, jscheduler, jhead),
            (arrivals, cluster, engine, predictor, scheduler, _carried(jhead))):
        reqs = arr.make_trace(arr.TraceConfig(**TRACE))
        svc = pred.PredictorService(head, window=16.0)
        st = clu.Cluster([eng.ReplicaSpec(**spec)] * 3, sched.Policy(**pol), router="psq",
                         predictor=svc, rebalance_every=50, steal="quantile").run(reqs)
        rows.append(st.row())
        stats.append(svc.stats.row())
    want, got = rows
    assert stats[1] == stats[0]
    assert got["completed"] + got["timed_out"] + got["dropped"] == TRACE["n_requests"]
    _same_within(got, want, rtol=0.1)


def test_fit_trace_head_follows_the_reference(fitted, monkeypatch):
    jhead, inits, seeds = fitted
    assert len(seeds) == 1
    monkeypatch.setattr(core_predictor, "head_init",
                        lambda seed, d, hidden, K, device=None:
                        head_from_jax(inits[seeds[0]], device=device))
    real = predictor.train_predictor
    monkeypatch.setattr(predictor, "train_predictor",
                        lambda seed, *a, **kw: real(seeds[0], *a, **kw))
    head = predictor.fit_trace_head(arrivals.TraceConfig(), device="cpu", **FIT)
    assert head.losses.shape[0] == 402           # 134 epochs of 3 steps: the 400-step floor
    assert head.edges.shape == (33,) and head.params["w1"].shape == (4, 128)
    np.testing.assert_allclose(head.edges.numpy(), np.asarray(jhead.edges), rtol=1e-6)
    phi = np.stack([r.phi for r in arrivals.make_trace(arrivals.TraceConfig(**TRACE))])
    _, got = head.quantiles(phi, (0.5, 0.9))
    _, want = jhead.quantiles(phi, (0.5, 0.9))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-2, atol=ATOL)
