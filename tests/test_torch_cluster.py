"""The port's arrival traces and multi-replica cluster (``serving/arrivals.py``,
``serving/cluster.py``) against the reference's.

Both are NumPy on both sides, so the same ``TraceConfig`` must give the same
trace bit for bit (every ``Request`` field, sessions and prefixes included),
and the same trace the same ``ClusterStats`` row bit for bit (NaN equal to
NaN), per-replica rows included, on the vectorized and the per-slot paths,
with every predictor that answers in NumPy: none (pre-annotated), a stub,
``LatentOracle`` and ``PerfectOracle``.
"""

import dataclasses
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_parity import jax  # noqa: E402,F401  (skips without JAX)

from repro.serving import arrivals as jarrivals  # noqa: E402
from repro.serving import cluster as jcluster  # noqa: E402
from repro.serving import engine as jengine  # noqa: E402
from repro.serving import predictor as jpredictor  # noqa: E402
from repro.serving import scheduler as jscheduler  # noqa: E402
from repro_torch.serving import arrivals, cluster, engine, predictor, scheduler  # noqa: E402

REF = (jarrivals, jcluster, jengine, jpredictor, jscheduler)
PORT = (arrivals, cluster, engine, predictor, scheduler)


def _fields(r):
    """Every dataclass field of a request, φ and histograms as bytes."""
    out = []
    for f in dataclasses.fields(r):
        v = getattr(r, f.name)
        out.append((f.name, v.tobytes() if isinstance(v, np.ndarray) else v))
    return out


def _same_row(got, want):
    assert got.keys() == want.keys()
    for k, w in want.items():
        g = got[k]
        if isinstance(w, float) and math.isnan(w):
            assert isinstance(g, float) and math.isnan(g), k
        else:
            assert g == w and type(g) is type(w), (k, g, w)


TRACES = {
    "poisson-mix": dict(n_requests=500, pattern="poisson", rate=1.3, seed=3),
    "bursty-slo": dict(n_requests=500, pattern="bursty", rate=0.9, seed=4,
                       slo_factor=4.0, slo_floor=80.0, burst_len_mean=50.0,
                       calm_len_mean=300.0),
    "diurnal": dict(n_requests=500, pattern="diurnal", rate=2.0, seed=5,
                    diurnal_period=200.0),
    "diurnal-amp2": dict(n_requests=400, pattern="diurnal", rate=2.0, seed=6,
                         diurnal_period=150.0, diurnal_amp=2.0),
    "qwen-mix": dict(n_requests=300, model="qwen", scenario="mix", seed=7,
                     view="mean", max_seq_len=1024),
    "mix-chat": dict(n_requests=300, model="mix", scenario="chat", seed=8,
                     view="entropy", prompt_min=4, prompt_max=9),
    "llama-math": dict(n_requests=300, model="llama", scenario="math", seed=9),
    "sessions": dict(n_requests=300, rate=0.5, seed=10, session_frac=0.2,
                     agentic_frac=0.15, system_prompt_len=64,
                     slo_factor=3.0, slo_floor=50.0),
    "drift": dict(n_requests=500, pattern="bursty", rate=1.0, seed=11,
                  drift=dict(switch_step=200.0, scale_mult=1.6)),
    "drift-mix-ramp": dict(n_requests=400, rate=1.0, seed=12,
                           drift=dict(switch_step=100.0, scale_mult=0.7,
                                      ramp_steps=150.0,
                                      mix_weights=(0, 0, 0, 5, 1, 1, 1, 2))),
}


def _cfg(mod, kw):
    kw = dict(kw)
    if "drift" in kw:
        kw["drift"] = mod.DriftSpec(**kw["drift"])
    return mod.TraceConfig(**kw)


@pytest.mark.parametrize("name", sorted(TRACES))
def test_make_trace_is_bit_identical(name):
    want = jarrivals.make_trace(_cfg(jarrivals, TRACES[name]))
    got = arrivals.make_trace(_cfg(arrivals, TRACES[name]))
    assert len(got) == len(want) >= TRACES[name]["n_requests"]
    assert [_fields(r) for r in got] == [_fields(r) for r in want]
    if name == "sessions":
        assert sum(r.prefix_id is not None and r.prefix_id.startswith("chat/")
                   for r in got) > 0
        assert len(got) > TRACES[name]["n_requests"]


def test_trace_config_and_rate_helpers_match():
    cfg, jcfg = arrivals.TraceConfig(), jarrivals.TraceConfig()
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert cfg.settings() == jcfg.settings()
    assert arrivals.TraceConfig(model="llama").settings() == \
        jarrivals.TraceConfig(model="llama").settings()
    for bad in (dict(diurnal_amp=-0.1), dict(session_frac=0.7, agentic_frac=0.5),
                dict(prompt_min=9, prompt_max=4), dict(system_prompt_len=-1)):
        with pytest.raises(ValueError):
            arrivals.TraceConfig(**bad)
    with pytest.raises(ValueError):
        arrivals.DriftSpec(switch_step=1.0, scale_mult=0.0)
    reqs = arrivals.make_trace(arrivals.TraceConfig(n_requests=200, seed=1))
    jreqs = jarrivals.make_trace(jarrivals.TraceConfig(n_requests=200, seed=1))
    assert arrivals.mean_true_length(reqs) == jarrivals.mean_true_length(jreqs)
    assert arrivals.stable_rate(4, 32, 300.0, 0.7) == jarrivals.stable_rate(4, 32, 300.0, 0.7)
    specs = [engine.ReplicaSpec(8, 9000, speed=2), engine.ReplicaSpec(4, 4000)]
    jspecs = [jengine.ReplicaSpec(8, 9000, speed=2), jengine.ReplicaSpec(4, 4000)]
    assert arrivals.stable_rate_specs(specs, 300.0) == jarrivals.stable_rate_specs(jspecs, 300.0)
    with pytest.raises(ValueError, match="mix_weights"):
        arrivals.make_trace(arrivals.TraceConfig(
            n_requests=20, drift=arrivals.DriftSpec(switch_step=1.0, mix_weights=(1.0,))))


def test_latent_oracle_and_corruption_match():
    reqs = arrivals.make_trace(arrivals.TraceConfig(n_requests=300, seed=2))
    phi = np.stack([r.phi for r in reqs])
    for q in (0.5, 0.9, 0.99):
        assert np.array_equal(arrivals.LatentOracle().quantile(phi, q),
                              jarrivals.LatentOracle().quantile(phi, q))
    assert np.array_equal(arrivals.LatentOracle().predict(phi),
                          jarrivals.LatentOracle().predict(phi))
    from repro.data.scenarios import get_spec as jget_spec
    from repro_torch.data.scenarios import get_spec
    lat = np.random.default_rng(0).standard_normal((50, 4))
    for view in ("last", "mean", "proxy", "entropy"):
        got = arrivals.corrupt_latents(np.random.default_rng(1), lat,
                                       get_spec("llama", "chat"), view)
        want = jarrivals.corrupt_latents(np.random.default_rng(1), lat,
                                         jget_spec("llama", "chat"), view)
        assert np.array_equal(got, want)


class _Stub:
    """A NumPy predictor at the seam: φ → a median, a quantile above it."""

    def predict(self, phi):
        return 20.0 + 60.0 * np.exp(np.asarray(phi)[:, 0]) ** 0.5

    def quantile(self, phi, q):
        return self.predict(phi) * (1.0 + 2.0 * q)


def _pre_annotate(reqs):
    rng = np.random.default_rng(9)
    for r in reqs:
        z = float(np.exp(0.4 * rng.standard_normal()))
        r.predicted_len = float(r.true_len * z)
        r.pred_q = 1.7 * r.predicted_len
        r.reserve_len = r.pred_q


BASE_TRACE = dict(n_requests=300, pattern="bursty", rate=1.2, seed=11,
                  max_seq_len=1024, slo_factor=4.0, slo_floor=60.0)


def _run(mods, trace_kw, specs, pol_kw, predictor_kind="latent", **cluster_kw):
    """One cluster replay in one package: (row, replica rows, done)."""
    arr, clu, eng, pred, sched = mods
    reqs = arr.make_trace(_cfg(arr, trace_kw))
    if predictor_kind == "none":
        _pre_annotate(reqs)
    p = {"none": None, "stub": _Stub(), "latent": arr.LatentOracle(),
         "perfect": pred.PerfectOracle()}[predictor_kind]
    cl = clu.Cluster([eng.ReplicaSpec(**s) for s in specs], sched.Policy(**pol_kw),
                     predictor=p, **cluster_kw)
    st = cl.run(reqs)
    done = sorted((r.rid, r.replica, r.t_start, r.t_finish, r.reserve_len)
                  for e in cl.engines for r in e.done)
    return st.row(), st.replica_rows, done


def _assert_same_run(*args, **kw):
    (got, got_rep, got_done), (want, want_rep, want_done) = (
        _run(PORT, *args, **kw), _run(REF, *args, **kw))
    _same_row(got, want)
    assert len(got_rep) == len(want_rep)
    for g, w in zip(got_rep, want_rep):
        _same_row(g, w)
    assert got_done == want_done
    return got


HOMO = [dict(max_slots=6, kv_budget=4 * (256 + 1024))] * 3
HETERO = [dict(max_slots=6, kv_budget=3 * (256 + 1024), speed=2, prefill_tokens_per_step=64),
          dict(max_slots=3, kv_budget=256 + 1024, speed=1, prefill_tokens_per_step=32),
          dict(max_slots=8, kv_budget=4 * (256 + 1024), speed=3)]
QPOL = dict(order="fcfs", reserve="quantile", quantile=0.9, max_seq_len=1024)


@pytest.mark.parametrize("vectorized", [True, False], ids=["vectorized", "per_slot"])
@pytest.mark.parametrize("kind", ["none", "stub", "latent", "perfect"])
def test_cluster_rows_are_bit_identical_per_predictor(kind, vectorized):
    row = _assert_same_run(BASE_TRACE, HOMO, QPOL, kind, router="psq",
                           vectorized=vectorized)
    assert row["completed"] > 0


@pytest.mark.parametrize("steal", ["tail", "quantile"])
@pytest.mark.parametrize("router", ["round_robin", "jsq", "least_kv", "psq",
                                    "prefix_affine"])
def test_cluster_rows_are_bit_identical_per_router_and_steal(router, steal):
    row = _assert_same_run(BASE_TRACE, HETERO, QPOL, "latent", router=router,
                           rebalance_every=25, steal=steal, steal_cost=2)
    assert row["stolen"] > 0 and row["timed_out"] > 0


@pytest.mark.parametrize("vectorized", [True, False], ids=["vectorized", "per_slot"])
@pytest.mark.parametrize("mode", ["keep", "recompute"])
def test_cluster_rows_are_bit_identical_under_preemption(mode, vectorized):
    pol = dict(order="srtf_pred", reserve="quantile", quantile=0.9, max_seq_len=1024,
               preempt=True, preempt_factor=1.5, preempt_mode=mode)
    specs = [dict(max_slots=4, kv_budget=2048, page_size=16, speed=2,
                  prefill_tokens_per_step=64)] * 3
    row = _assert_same_run(BASE_TRACE, specs, pol, "latent", router="psq",
                           rebalance_every=40, steal="quantile", vectorized=vectorized)
    assert row["preemptions"] > 0


@pytest.mark.parametrize("router", ["jsq", "prefix_affine"])
def test_cluster_rows_are_bit_identical_with_prefix_sharing(router):
    trace = dict(n_requests=200, rate=0.6, seed=13, max_seq_len=1024,
                 session_frac=0.3, agentic_frac=0.2, system_prompt_len=128)
    specs = [dict(max_slots=6, kv_budget=6144, page_size=16, share_prefixes=True,
                  prefill_tokens_per_step=128)] * 3
    row = _assert_same_run(trace, specs, QPOL, "latent", router=router)
    assert row["prefix_hits"] > 0


def test_cluster_rows_are_bit_identical_under_a_token_budget():
    specs = [dict(max_slots=6, kv_budget=4 * (256 + 1024), step_token_budget=96,
                  prefill_chunk_tokens=48)] * 2
    pol = dict(QPOL, order="laxity", chunk_order="prod")
    row = _assert_same_run(BASE_TRACE, specs, pol, "latent", router="psq")
    assert row["prefill_ticks"] > 0


def test_cluster_validation_and_uniform_match():
    for kw in (dict(router="nope"), dict(steal="nope"), dict(steal_cost=-1),
               dict(prefix_imbalance=-1.0)):
        with pytest.raises(ValueError):
            cluster.Cluster([engine.ReplicaSpec(2, 100)], scheduler.Policy(), **kw)
    with pytest.raises(ValueError):
        cluster.Cluster([], scheduler.Policy())
    assert cluster.ROUTERS == jcluster.ROUTERS
    assert cluster.STEAL_MODES == jcluster.STEAL_MODES
    reqs = arrivals.make_trace(arrivals.TraceConfig(n_requests=150, rate=0.8, seed=3))
    jreqs = jarrivals.make_trace(jarrivals.TraceConfig(n_requests=150, rate=0.8, seed=3))
    pol, jpol = scheduler.Policy(**QPOL), jscheduler.Policy(**QPOL)
    got = cluster.Cluster.uniform(2, 4, 4000, pol, page_size=8, router="jsq",
                                  predictor=arrivals.LatentOracle()).run(reqs)
    want = jcluster.Cluster.uniform(2, 4, 4000, jpol, page_size=8, router="jsq",
                                    predictor=jarrivals.LatentOracle()).run(jreqs)
    _same_row(got.row(), want.row())
