"""The port's online adaptation (``serving/adaptation.py``: ``OnlineAdapter``,
``AdmissionController``, ``coverage_of``, ``refit_head``) against the
reference's.

Over a NumPy predictor (``LatentOracle``) the closed loop is NumPy on both
sides: the same drifting trace gives the same ``ClusterStats`` row bit for
bit (rejections included) and the same adapter row, on the vectorized and
the per-slot paths, and the same admission events.

``refit_head`` warm-starts from the reference's head carried across, with
the reference's minibatch seed (its ``jax.random.PRNGKey(seed)`` turned into
the integer its ``train_predictor`` draws); two epochs keep the weights
within rtol 1e-4 (the short-trajectory tolerance of ``test_torch_core.py``;
measured 7e-7 relative here).

Over the carried head the loop refits and hot-swaps while it runs. The
``ServiceStats`` row is equal (batching follows arrivals, not the schedule)
and so is the refresh count. Coverage may differ by two flipped
observations, and ``q_eff`` by two ACI steps (a request's covered bit flips
only where its reservation, which the port has within 1e-3 tokens, straddles
its true length); the cluster row within rtol 0.1, the tolerance of
``test_torch_predictor_service.py``, whose docstring gives its measurement.
Measured here: every one of them equal.
"""

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_parity import jax, np_tree  # noqa: E402

from repro.serving import adaptation as jadaptation  # noqa: E402
from repro.serving import arrivals as jarrivals  # noqa: E402
from repro.serving import cluster as jcluster  # noqa: E402
from repro.serving import engine as jengine  # noqa: E402
from repro.serving import predictor as jpredictor  # noqa: E402
from repro.serving import scheduler as jscheduler  # noqa: E402
from repro.serving import telemetry as jtelemetry  # noqa: E402
from repro_torch.common.config import PredictorConfig  # noqa: E402
from repro_torch.core.predictor import LengthPredictor  # noqa: E402
from repro_torch.models.convert import head_from_jax  # noqa: E402
from repro_torch.serving import (adaptation, arrivals, cluster, engine,  # noqa: E402
                                 predictor, scheduler, telemetry)

REF = (jadaptation, jarrivals, jcluster, jengine, jpredictor, jscheduler, jtelemetry)
PORT = (adaptation, arrivals, cluster, engine, predictor, scheduler, telemetry)
N, RATE = 300, 0.06
TRACE = dict(n_requests=N, pattern="bursty", rate=RATE, seed=21, slo_factor=8.0,
             slo_floor=200.0)
DRIFT = dict(switch_step=0.5 * N / RATE, scale_mult=1.5)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Small products on one thread: the suite runs in several worker
    processes at once, and threads beyond one per worker only contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jhead():
    return jpredictor.fit_trace_head(jarrivals.TraceConfig(), n_train=800, r=8, seed=5)


def _carried(jhead):
    return LengthPredictor(head_from_jax(np_tree(jhead.params), device="cpu"),
                           torch.from_numpy(np.array(jhead.edges)),
                           PredictorConfig(n_bins=32, hidden=128, bin_spacing="log",
                                           bin_max=4096.0, epochs=25))


def _jax_seed(seed: int) -> int:
    """The minibatch seed the reference's ``train_predictor`` draws from
    ``jax.random.PRNGKey(seed)``."""
    return int(jax.random.randint(jax.random.PRNGKey(seed), (), 0, 2 ** 31 - 1))


@pytest.fixture
def reference_seeds(monkeypatch):
    real = adaptation.train_predictor
    monkeypatch.setattr(adaptation, "train_predictor",
                        lambda seed, *a, **kw: real(_jax_seed(seed), *a, **kw))


def _same_row(got, want):
    assert got.keys() == want.keys()
    for k, w in want.items():
        g = got[k]
        if isinstance(w, float) and math.isnan(w):
            assert isinstance(g, float) and math.isnan(g), k
        else:
            assert g == w and type(g) is type(w), (k, g, w)


def test_config_and_coverage_match():
    import dataclasses

    assert dataclasses.asdict(adaptation.AdaptationConfig()) == \
        dataclasses.asdict(jadaptation.AdaptationConfig())
    for bad in (dict(target_coverage=1.0), dict(gamma=-0.1), dict(q_min=0.9, q_max=0.8),
                dict(window=0), dict(buffer_size=0)):
        with pytest.raises(ValueError):
            adaptation.AdaptationConfig(**bad)
    with pytest.raises(ValueError):
        adaptation.AdmissionController(slack=0.0)
    reqs = arrivals.make_trace(arrivals.TraceConfig(n_requests=80, seed=2))
    jreqs = jarrivals.make_trace(jarrivals.TraceConfig(n_requests=80, seed=2))
    rng = np.random.default_rng(0)
    for r, jr in zip(reqs, jreqs):
        r.cal_q = jr.cal_q = float(rng.uniform(0.5, 2.0) * r.true_len)
    reqs[3].cal_q = jreqs[3].cal_q = None
    assert adaptation.coverage_of(reqs) == jadaptation.coverage_of(jreqs)
    assert adaptation.coverage_of(reqs, since=40.0) == jadaptation.coverage_of(jreqs, since=40.0)
    assert math.isnan(adaptation.coverage_of([]))


def _closed_loop(mods, base, acfg_kw, drift=True, vectorized=True, slack=1.0):
    ad, arr, clu, eng, pred, sched, tel = mods
    cfg = arr.TraceConfig(**TRACE, drift=arr.DriftSpec(**DRIFT) if drift else None)
    reqs = arr.make_trace(cfg)
    adapter = ad.OnlineAdapter(base, ad.AdaptationConfig(**acfg_kw))
    tracer = tel.Tracer()
    cl = clu.Cluster([eng.ReplicaSpec(8, 8 * (256 + 2048), page_size=16)] * 3,
                     sched.Policy("fcfs", "quantile", quantile=0.9, max_seq_len=4096),
                     router="psq", predictor=adapter, vectorized=vectorized,
                     admission=ad.AdmissionController(slack=slack, tracer=tracer))
    st = cl.run(reqs)
    done = [r for e in cl.engines for r in e.done]
    return (st.row(), adapter.row(), ad.coverage_of(done),
            ad.coverage_of(done, since=DRIFT["switch_step"]), tracer, adapter)


@pytest.mark.parametrize("vectorized", [True, False], ids=["vectorized", "per_slot"])
@pytest.mark.parametrize("gamma,slack,drift", [(0.0, 1.0, True), (0.02, 2.0, True),
                                               (0.05, 1.0, False)],
                         ids=["static-drift", "aci-slack-drift", "aci-stationary"])
def test_closed_loop_over_the_latent_oracle_is_bit_identical(gamma, slack, drift,
                                                             vectorized):
    kw = dict(gamma=gamma, window=128, every=32, coverage_alarm=0.05)
    want = _closed_loop(REF, jarrivals.LatentOracle(), kw, drift, vectorized, slack)
    got = _closed_loop(PORT, arrivals.LatentOracle(), kw, drift, vectorized, slack)
    _same_row(got[0], want[0])
    _same_row(got[1], want[1])
    assert got[2:4] == want[2:4]
    assert [tuple(e) for e in got[4].canonical()] == [tuple(e) for e in want[4].canonical()]
    assert got[0]["rejected"] > 0 and got[1]["observed"] > 0
    assert got[5].refreshes == 0                  # a weight-less base never refits


def test_refit_head_follows_the_reference(jhead, reference_seeds):
    reqs = arrivals.make_trace(arrivals.TraceConfig(n_requests=700, seed=3))
    phi = np.stack([r.phi for r in reqs])
    lens = np.array([r.true_len for r in reqs], np.float64)
    want = jadaptation.refit_head(jhead, phi, lens, epochs=2, seed=4)
    head = _carried(jhead)
    got = adaptation.refit_head(head, phi, lens, epochs=2, seed=4)
    assert got.losses.shape[0] == 4                  # warm start: epochs at face value
    assert got.edges is head.edges and got.pcfg.epochs == 2
    for k, w in want.params.items():
        np.testing.assert_allclose(got.params[k].numpy(), np.asarray(w), rtol=1e-4, atol=1e-6)
        assert not torch.equal(got.params[k], head.params[k]) or k == "b2"
    again = adaptation.refit_head(head, phi, lens, epochs=2, seed=4)
    assert all(torch.equal(again.params[k], got.params[k]) for k in got.params)


def test_closed_loop_over_the_carried_head_refits_like_the_reference(jhead, reference_seeds):
    kw = dict(gamma=0.02, window=128, every=32, refresh_every=N / RATE / 6,
              refresh_min_samples=64, refresh_epochs=2, buffer_size=1024,
              refresh_seed=11)
    want = _closed_loop(REF, jpredictor.PredictorService(jhead, window=16.0), kw)
    base = predictor.PredictorService(_carried(jhead), window=16.0)
    got = _closed_loop(PORT, base, kw)
    assert base.stats.row() == want[5].base.stats.row()
    assert got[1]["refreshes"] == want[1]["refreshes"] >= 3
    assert base.stats.refreshes == got[1]["refreshes"]
    observed = want[1]["observed"]
    assert abs(got[1]["observed"] - observed) <= 2
    for cov in (1, 2, 3):
        g = got[1]["coverage"] if cov == 1 else got[cov]
        w = want[1]["coverage"] if cov == 1 else want[cov]
        assert abs(g - w) <= 2.0 / observed, (cov, g, w)
    assert abs(got[1]["q_eff"] - want[1]["q_eff"]) <= 2 * 0.9 * kw["gamma"] + 1e-12
    for k, w in want[0].items():
        g = got[0][k]
        if isinstance(w, float) and not math.isnan(w):
            assert abs(g - w) <= 0.1 * abs(w) + 1e-12, (k, g, w)
    # a later run starts from the pristine weights again (adapter.reset)
    assert got[5].base.predictor is not got[5]._base_predictor
    got[5].reset()
    assert got[5].base.predictor is got[5]._base_predictor
