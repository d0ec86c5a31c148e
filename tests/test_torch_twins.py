"""The port's twins of ``examples/train_lm.py`` and
``examples/serve_with_prod.py`` on the CPU, at reduced sizes.

- ``launch/serve_with_prod.py``: all 9 stages end to end at the reduced
  arguments the repo's own smoke uses (``--train-steps 25 --n-prompts 12
  --r 3 --max-new 40 --n-serve 24``), each stage's rows checked for their
  kind; then single stages driven again from the run's outputs give the
  same rows (every stage is a function of what the earlier ones made).
- The twin against ``examples/serve_with_prod.py`` itself: both ``main``s
  at those arguments with the LM stages carried across (``train_loop``
  skipped, ``RealEngine.repeated_sampling`` returning the same seeded
  lengths and φ on both sides) and the reference's trained ProD-D head
  carried into the port (``models/convert.py``). Stage 3's bin edges and
  targets equal the reference's (rtol 1e-6) and its MAE within rtol 1e-4;
  the prompts drawn from the run's generator are equal, so stages 4-9 see
  the same requests. Every row of stages 4-9 is held within rtol 0.1 on
  each numeric field (non-numeric fields and every ``ServiceStats`` row
  equal), the tolerance of test_torch_predictor_service.py, whose docstring
  gives its measurement; the refresh counts equal, the settled coverage
  within two observations and ``q_eff`` within two ACI steps, as in
  test_torch_adaptation.py. Measured here: every row, coverage and
  ``q_eff`` equal, and the MAE 3e-7 relative off.
- ``launch/train_lm.py``: a few steps on tiny-lm and on a reduced dense
  config, each equal to the port's ``train_loop`` called directly with the
  twin's settings, with the reference's analytic parameter count printed,
  and so on the reduced SSM and hybrid configs.
"""

import importlib.util
import types
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_parity import jax, np_tree  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.serving import engine as jengine  # noqa: E402
from repro_torch.common.config import TrainConfig  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.data.pipeline import batch_iterator, make_lm_dataset  # noqa: E402
from repro_torch.launch import serve_with_prod, train_lm  # noqa: E402
from repro_torch.core.predictor import LengthPredictor  # noqa: E402
from repro_torch.models.convert import head_from_jax  # noqa: E402
from repro_torch.models.model_zoo import build_model  # noqa: E402
from repro_torch.serving import adaptation  # noqa: E402
from repro_torch.serving import engine as tengine  # noqa: E402
from repro_torch.training.trainer import train_loop  # noqa: E402

SMOKE = ["--device", "cpu", "--train-steps", "25", "--n-prompts", "12", "--r", "3",
         "--max-new", "40", "--n-serve", "24"]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def run():
    return serve_with_prod.main(SMOKE)


def test_serve_with_prod_runs_all_nine_stages(run):
    args = serve_with_prod.parse_args(SMOKE)
    assert run["lengths"].shape == (12, 3)
    assert run["lengths"].min() >= 1 and run["lengths"].max() <= args.max_new
    assert run["phi"].shape == (12, get_config("tiny-lm").d_model)
    assert np.isfinite(run["head_mae"]) and run["noise_radius"] >= 0
    counts = {"serve": 2, "cluster": 2, "service": 3, "adaptation": 2, "paged": 2,
              "prefix": 2}
    for stage, n in counts.items():
        assert len(run[stage]) == n, stage
    assert all(r["completed"] + r["timed_out"] + r.get("rejected", 0) <= 3 * args.n_serve
               for r in run["cluster"] + run["service"] + run["adaptation"])
    assert all(r["service"]["batches"] > 0 for r in run["service"])
    assert run["adaptation"][1]["refreshes"] > 0 == run["adaptation"][0]["refreshes"]
    assert run["paged"][1]["recompute_ticks"] == 0
    off, on = run["prefix"]
    assert off["kv_amplification"] == 1.0 < on["kv_amplification"]
    assert on["prefill_saved_ticks"] > 0 == off["prefill_saved_ticks"]


def test_stages_driven_alone_give_the_same_rows(run):
    args = serve_with_prod.parse_args(SMOKE)
    pred, reqs = run["predictor"], run["requests"]
    assert serve_with_prod.paged_preemption(args, pred, reqs) == run["paged"]
    assert serve_with_prod.shared_prefix(args, pred, reqs) == run["prefix"]
    service = serve_with_prod.service_in_the_loop(args, pred, reqs)
    assert [r["p99_latency"] for r in service] == [r["p99_latency"] for r in run["service"]]


# ---------------------------------------------------------------------------
# the twin against examples/serve_with_prod.py
# ---------------------------------------------------------------------------

EXAMPLE = Path(__file__).resolve().parents[1] / "examples" / "serve_with_prod.py"
STAGES = ("serve", "cluster", "service", "adaptation", "paged", "prefix")


def _carried_generations(args):
    """Seeded stand-ins for stage 2's generations: heavy-tailed lengths
    (N, r) in [1, max_new] and φ (N, d) fp32 that carries each prompt's
    typical length, so the head has something to learn."""
    rng = np.random.default_rng(7)
    typical = 2.0 + 10.0 * rng.pareto(1.5, args.n_prompts)
    lens = np.clip(np.round(typical[:, None] * rng.lognormal(0.0, 0.5, (args.n_prompts, args.r))),
                   1, args.max_new).astype(np.int64)
    phi = rng.standard_normal((args.n_prompts, get_config("tiny-lm").d_model)).astype(np.float32)
    phi[:, 0] = np.log(typical)
    return lens, phi


def _jax_seed(seed: int) -> int:
    """The minibatch seed the reference's ``train_predictor`` draws from
    ``jax.random.PRNGKey(seed)``."""
    return int(jax.random.randint(jax.random.PRNGKey(seed), (), 0, 2 ** 31 - 1))


CONFIGS = ("ReplicaSpec", "Policy", "AdaptationConfig", "AdmissionController")


def _describe(x):
    """A constructor argument as comparable data: the serving configs field
    for field, sequences element-wise, numbers as they are, and any other
    object (a predictor, a service) by its type's name."""
    if type(x).__name__ in CONFIGS:
        return type(x).__name__, {k: _describe(v) for k, v in vars(x).items()}
    if isinstance(x, (list, tuple)):
        return tuple(_describe(v) for v in x)
    if x is None or isinstance(x, (bool, int, float, str)):
        return x
    return type(x).__name__


def _record(mp, ns, rec):
    """Wrap the serving classes a stage builds in module ``ns`` so that
    every construction's arguments, every run's requests (as they enter the
    run) and every run's row are recorded, in order, in ``rec``."""
    def recorded(base, key):
        class Recorded(base):
            def __init__(self, *a, **kw):
                super().__init__(*a, **kw)
                rec["built"].append((key, _describe(a), {k: _describe(v) for k, v in kw.items()}))
                rec.setdefault(key, []).append(self)

            def run(self, reqs):
                rec["requests"].append([
                    (r.rid, r.arrival, r.prompt_len, r.true_len, r.deadline, r.prefix_id,
                     r.prefix_len, np.asarray(r.phi).tobytes()) for r in reqs])
                st = super().run(reqs)
                rec["rows"].append(st.row())
                return st
        return Recorded

    rec.update(built=[], requests=[], rows=[], coverage=[], mae=[])
    for name in ("SimEngine", "Cluster", "PredictorService", "OnlineAdapter"):
        mp.setattr(ns, name, recorded(getattr(ns, name), name))
    for name, key in (("coverage_of", "coverage"), ("mae", "mae")):
        fn = getattr(ns, name)
        mp.setattr(ns, name, lambda *a, _fn=fn, _k=key, **kw:
                   rec[_k].append(_fn(*a, **kw)) or rec[_k][-1])


def _reference_example(mp, lens, phi):
    """``examples/serve_with_prod.py``'s ``main`` with the LM stages carried
    in; records what each stage made."""
    spec = importlib.util.spec_from_file_location("serve_with_prod_example", EXAMPLE)
    ex = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ex)
    rec = {"prompts": []}
    mp.setattr(ex, "train_loop", lambda *a, **kw: types.SimpleNamespace(params=None))

    def sampling(self, prompts, plens, r, seed=0):
        rec["prompts"].append(np.array(prompts))
        return lens.copy(), phi.copy()

    mp.setattr(jengine.RealEngine, "repeated_sampling", sampling)
    real_train = ex.train_predictor

    def train(key, phi_, tgt, pcfg, edges):
        rec.update(tgt=np.asarray(tgt), edges=np.asarray(edges), pcfg=pcfg)
        rec["head"] = real_train(key, phi_, tgt, pcfg, edges)
        return rec["head"]

    mp.setattr(ex, "train_predictor", train)
    _record(mp, ex, rec)
    mp.setattr("sys.argv", ["serve_with_prod.py"] + SMOKE[2:])
    ex.main()
    return rec


def _port_twin(mp, want, lens, phi):
    """The port's ``main`` with the same generations and the reference's
    trained head carried in; records as :func:`_reference_example` does."""
    rec = {"prompts": []}
    mp.setattr(serve_with_prod, "train_loop",
               lambda *a, **kw: types.SimpleNamespace(params={"embed": torch.zeros(1)}))

    def sampling(self, prompts, plens, r, seed=0):
        rec["prompts"].append(np.array(prompts))
        return lens.copy(), phi.copy()

    mp.setattr(tengine.RealEngine, "repeated_sampling", sampling)

    def train(seed, phi_, tgt, pcfg, edges, device=None):
        rec.update(tgt=tgt.numpy(), edges=edges.numpy(), pcfg=pcfg)
        return LengthPredictor(head_from_jax(np_tree(want["head"].params), device="cpu"),
                               edges, pcfg)

    mp.setattr(serve_with_prod, "train_predictor", train)
    real_refit = adaptation.train_predictor          # stage 7's refresh, the reference's seeds
    mp.setattr(adaptation, "train_predictor",
               lambda seed, *a, **kw: real_refit(_jax_seed(seed), *a, **kw))
    _record(mp, serve_with_prod, rec)
    rec["out"] = serve_with_prod.main(SMOKE)
    return rec


@pytest.fixture(scope="module")
def parity():
    lens, phi = _carried_generations(serve_with_prod.parse_args(SMOKE))
    with pytest.MonkeyPatch.context() as mp:
        want = _reference_example(mp, lens, phi)
    with pytest.MonkeyPatch.context() as mp:
        got = _port_twin(mp, want, lens, phi)
    return want, got


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


def test_stage_3_matches_the_reference(parity):
    want, got = parity
    assert len(got["prompts"]) == len(want["prompts"]) == 1
    np.testing.assert_array_equal(got["prompts"][0], want["prompts"][0])
    for f in ("n_bins", "bin_max", "epochs", "batch_size"):
        assert getattr(got["pcfg"], f) == getattr(want["pcfg"], f), f
    np.testing.assert_allclose(got["edges"], want["edges"], rtol=1e-6)
    np.testing.assert_allclose(got["tgt"], want["tgt"], rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(got["out"]["head_mae"], want["mae"][0], rtol=1e-4)


# stage -> the runs it makes, in order: (first, last) index into the rows
RUNS = {"serve": (0, 2), "cluster": (2, 4), "service": (4, 7), "adaptation": (7, 9),
        "paged": (9, 11), "prefix": (11, 13)}


@pytest.mark.parametrize("stage", STAGES)
def test_stage_rows_match_the_reference(parity, stage):
    want, got = parity
    assert len(want["rows"]) == len(got["rows"]) == 13
    # every engine, cluster, service and adapter built with the same
    # arguments, and every run fed the same requests
    assert got["built"] == want["built"]
    lo, hi = RUNS[stage]
    assert got["requests"][lo:hi] == want["requests"][lo:hi]
    out = got["out"][stage]
    assert len(out) == hi - lo
    for g, row, w in zip(out, got["rows"][lo:hi], want["rows"][lo:hi]):
        assert {k: g[k] for k in row} == row          # main returns each run's row
        _same_within(row, w, rtol=0.1)
    n = serve_with_prod.parse_args(SMOKE).n_serve
    if stage in ("cluster", "service"):
        assert all(r["completed"] + r["timed_out"] == n for r in got["rows"][lo:hi])
    if stage == "service":
        assert [s.stats.row() for s in got["PredictorService"][:3]] == \
            [s.stats.row() for s in want["PredictorService"][:3]]
    if stage == "adaptation":
        for g, ad, jad, cov in zip(out, got["OnlineAdapter"], want["OnlineAdapter"],
                                   want["coverage"]):
            w = jad.row()
            assert g["refreshes"] == ad.refreshes == w["refreshes"]
            assert abs(g["coverage"] - cov) <= 2.0 / w["observed"]
            assert abs(g["q_eff"] - w["q_eff"]) <= 2 * 0.9 * jad.cfg.gamma + 1e-12
        assert out[1]["refreshes"] > 0


def _losses(state):
    return [float(m["loss"]) for m in state.history]


@pytest.mark.parametrize("arch", ["tiny-lm", "qwen2.5-7b"])
def test_train_lm_twin_is_train_loop(arch, capsys):
    steps, batch, seq = 3, 4, 32
    state = train_lm.main(["--device", "cpu", "--arch", arch, "--steps", str(steps),
                           "--batch", str(batch), "--seq", str(seq)])
    printed = capsys.readouterr().out
    cfg = get_config(arch)
    jcfg = jget_config(arch)
    if arch != "tiny-lm":
        cfg, jcfg = cfg.reduced(), jcfg.reduced()
    assert f"params={jcfg.param_count():,} (analytic)" in printed
    assert f"finished at step {steps}" in printed
    cfg = cfg.with_overrides(dtype="float32")
    tcfg = TrainConfig(lr=3e-3, schedule="cosine", warmup_steps=2, decay_steps=steps, seed=0)
    ds = make_lm_dataset(4096, seq, seed=0)
    ds.tokens = np.minimum(ds.tokens, cfg.vocab_size - 1)
    want = train_loop(build_model(cfg), tcfg, batch_iterator(ds, batch, seed=0, device="cpu"),
                      steps, verbose=False, device="cpu")
    assert _losses(state) == _losses(want)
    assert all(np.isfinite(_losses(state)))


@pytest.mark.parametrize("arch", ["mamba2-130m", "zamba2-1.2b"])
def test_train_lm_twin_raises_for_ssm_and_hybrid(arch, capsys):
    """The twin trains SSM and hybrid configs now (the name is kept from when
    it raised): their reduced() config, the losses those of train_loop."""
    test_train_lm_twin_is_train_loop(arch, capsys)
