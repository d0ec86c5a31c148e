"""The port's serving simulator (``SimEngine`` and the NumPy modules it runs
on) against the reference's, and ``--mode sim`` end to end on the CPU.

The simulator is NumPy on both sides, so the same trace must give the same
``ServeStats`` row bit for bit (NaN equal to NaN), on the vectorized path
and on the per-slot reference path, and the same telemetry events. With
the reference's trained head carried across, the port's predictions at the
``predictor=`` seam agree within the ``train_predictor`` trajectory
tolerance (rtol 1e-4, atol 2e-3 tokens).
"""

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_parity import jax, jnp, np_tree  # noqa: E402

from repro.common.config import PredictorConfig as JPredictorConfig  # noqa: E402
from repro.core import bins as jbins  # noqa: E402
from repro.core import predictor as jpredictor  # noqa: E402
from repro.core import targets as jtargets  # noqa: E402
from repro.data import make_scenario as jmake_scenario  # noqa: E402
from repro.serving import engine as jengine  # noqa: E402
from repro.serving import request as jrequest  # noqa: E402
from repro.serving import scheduler as jscheduler  # noqa: E402
from repro.serving import telemetry as jtelemetry  # noqa: E402
from repro_torch.common.config import PredictorConfig  # noqa: E402
from repro_torch.core.predictor import LengthPredictor  # noqa: E402
from repro_torch.data import make_scenario  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models.convert import head_from_jax  # noqa: E402
from repro_torch.serving import engine, request, scheduler, telemetry  # noqa: E402

RTOL, ATOL = 1e-4, 2e-3


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Small products on one thread: the suite runs in several worker
    processes at once, and threads beyond one per worker only contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _trace(req_mod, scen_fn, n=120, annotate=False):
    """The same workload in either package: a qwen/coding test split,
    Poisson arrivals, deadlines on two requests in three, and (for
    ``predictor=None``) a pre-annotated noisy median and q0.9."""
    data = scen_fn("qwen", "coding", n_train=16, n_test=n, seed=2)
    reqs = req_mod.workload_from_scenario(data, n, seed=4, arrival_rate=1.5)
    rng = np.random.default_rng(9)
    noise = np.exp(0.3 * rng.standard_normal(len(reqs)))
    for r, z in zip(reqs, noise):
        if r.rid % 3:
            r.deadline = r.arrival + 6.0 * r.true_len + 50.0
        if annotate:
            r.predicted_len = float(r.true_len * z)
            r.pred_q = 1.6 * r.predicted_len
            r.reserve_len = r.pred_q
    return reqs


class _Stub:
    """A NumPy predictor at the seam: φ → a median, a quantile above it."""

    def predict(self, phi):
        return 40.0 + 400.0 * np.abs(phi[:, :4]).sum(axis=1)

    def quantile(self, phi, q):
        return self.predict(phi) * (1.0 + q)


POLICIES = [
    dict(order="fcfs", reserve="max", max_seq_len=2048),
    dict(order="fcfs", reserve="quantile"),
    dict(order="sjf_pred", reserve="predicted"),
    dict(order="srtf_pred", reserve="quantile", preempt=True, preempt_mode="recompute"),
    dict(order="srtf_pred", reserve="quantile", preempt=True, preempt_mode="keep"),
    dict(order="edf", reserve="quantile"),
    dict(order="laxity", reserve="quantile"),
    dict(order="sjf_oracle", reserve="oracle"),
]
SPEC = dict(max_slots=6, kv_budget=6000, speed=2, prefill_tokens_per_step=64, page_size=16)


def _same_row(got, want):
    assert got.keys() == want.keys()
    for k, w in want.items():
        g = got[k]
        if isinstance(w, float) and math.isnan(w):
            assert isinstance(g, float) and math.isnan(g), k
        else:
            assert g == w and type(g) is type(w), (k, g, w)


@pytest.mark.parametrize("vectorized", [True, False], ids=["vectorized", "per_slot"])
@pytest.mark.parametrize("with_predictor", [False, True], ids=["no_predictor", "stub"])
@pytest.mark.parametrize("pol", POLICIES, ids=lambda p: f"{p['order']}-{p['reserve']}"
                         + (f"-{p['preempt_mode']}" if p.get("preempt") else ""))
def test_sim_engine_rows_are_bit_identical(pol, with_predictor, vectorized):
    rows = []
    for eng_mod, sched_mod, req_mod, scen_fn in (
            (jengine, jscheduler, jrequest, jmake_scenario),
            (engine, scheduler, request, make_scenario)):
        reqs = _trace(req_mod, scen_fn, annotate=not with_predictor)
        eng = eng_mod.SimEngine(policy=sched_mod.Policy(**pol), spec=eng_mod.ReplicaSpec(**SPEC),
                                predictor=_Stub() if with_predictor else None,
                                vectorized=vectorized)
        st = eng.run(reqs)
        rows.append((st.row(), [(r.rid, r.t_start, r.t_finish, r.reserve_len, r.predicted_len)
                                for r in eng.done]))
    (got, got_done), (want, want_done) = rows[1], rows[0]
    _same_row(got, want)
    assert got_done == want_done
    assert got["completed"] + got["timed_out"] == 120


def test_sim_engine_token_budget_and_telemetry_are_bit_identical():
    """The chunked-prefill budget path with a tracer sampling gauges: same
    row, same canonical event stream, same gauge series."""
    out = []
    for eng_mod, sched_mod, req_mod, tel_mod, scen_fn in (
            (jengine, jscheduler, jrequest, jtelemetry, jmake_scenario),
            (engine, scheduler, request, telemetry, make_scenario)):
        reqs = _trace(req_mod, scen_fn, annotate=True)
        tracer = tel_mod.Tracer(sample_every=25)
        spec = eng_mod.ReplicaSpec(max_slots=6, kv_budget=6000, step_token_budget=96,
                                   prefill_chunk_tokens=48)
        st = eng_mod.SimEngine(policy=sched_mod.Policy("laxity", "quantile", chunk_order="prod"),
                               spec=spec, tracer=tracer).run(reqs)
        out.append((st.row(), [tuple(e) for e in tracer.canonical()], tracer.series))
    _same_row(out[1][0], out[0][0])
    assert out[1][1] == out[0][1] and len(out[0][1]) > 0
    assert out[1][2] == out[0][2]


def _reference_head(data):
    """A ProD-D head trained by the reference on the scenario's last-token φ."""
    bin_max = float(np.quantile(data.len_train, 0.999) * 1.3)
    jpcfg = JPredictorConfig(n_bins=32, hidden=64, bin_max=bin_max, epochs=1)
    edges = jbins.make_edges(32, bin_max)
    tgt = jtargets.dist_target(jnp.asarray(data.len_train, jnp.float32), edges)
    return jpredictor.train_predictor(jax.random.PRNGKey(3),
                                      jnp.asarray(data.phi_train["last"]), tgt, jpcfg, edges)


@pytest.mark.parametrize("reserve", ["quantile", "predicted"])
def test_annotate_predictions_with_the_reference_head(reserve):
    data = jmake_scenario("llama", "chat", n_train=64, n_test=64, seed=0)
    jpred = _reference_head(data)
    tpred = LengthPredictor(head_from_jax(np_tree(jpred.params), device="cpu"),
                            torch.from_numpy(np.array(jpred.edges)),
                            PredictorConfig(n_bins=32, hidden=64, bin_max=jpred.pcfg.bin_max))
    jreqs = jrequest.workload_from_scenario(data, 64, seed=1)
    treqs = request.workload_from_scenario(make_scenario("llama", "chat", n_train=64, n_test=64,
                                                         seed=0), 64, seed=1)
    jscheduler.annotate_predictions(jreqs, jpred, jscheduler.Policy("sjf_pred", reserve))
    scheduler.annotate_predictions(treqs, tpred, scheduler.Policy("sjf_pred", reserve))
    for field in ("predicted_len", "reserve_len"):
        got = np.array([getattr(r, field) for r in treqs])
        want = np.array([getattr(r, field) for r in jreqs])
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_run_sim_on_cpu_end_to_end():
    """``--mode sim`` (the default) at a small size: four policy rows, every
    request served, and the two rows whose schedule reads no prediction
    (FCFS with max reservation, the oracle) equal to the reference
    ``SimEngine``'s on the same workload with any predictor in the seam."""
    argv = ["--device", "cpu", "--n-requests", "60", "--n-train", "64", "--epochs", "1",
            "--slots", "8", "--kv-budget", "6000"]
    rows = serve.main(argv)
    assert [r["policy"] for r in rows] == ["fcfs+max", "fcfs+quantile", "sjf_pred+quantile",
                                           "sjf_oracle+oracle"]
    for r in rows:
        assert r["completed"] == 60 and np.isfinite(r["mean_latency"])
    data = jmake_scenario("qwen", "chat", n_train=64, n_test=200, seed=0)
    reqs = jrequest.workload_from_scenario(data, 60, seed=0, arrival_rate=2.0)
    for i, (order, reserve) in ((0, ("fcfs", "max")), (3, ("sjf_oracle", "oracle"))):
        policy = jscheduler.Policy(order, reserve, max_seq_len=4096)
        _same_row(rows[i], jengine.SimEngine(8, 6000, policy, predictor=_Stub()).run(reqs).row())
