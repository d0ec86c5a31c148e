"""The serving benchmark's remaining tables on the port
(``launch/bench_serving.py``: the single-replica track, hetero, preemption,
prefix, chunked and obs) against the reference's
``benchmarks/bench_serving.py``, on the CPU at a small size.

The five cluster tables run the ``LatentOracle`` in the NumPy simulator and
touch no tensor, so their rows equal the reference's bit for bit (but the
wall-clock ``seconds``), and each ``validate_*`` gives the reference's dict.
Run alone, a table whose reference ``--<table>-only`` mode gates on its
acceptance booleans exits as the reference's does, with the same failures.
The single-replica track trains its head on the port; fed the reference's
trained head, its rows are the reference's.
"""

import dataclasses
import json
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_parity import jax, np_tree  # noqa: E402,F401  (skips without JAX)

from benchmarks import bench_serving as jbench  # noqa: E402
from repro.core import predictor as jpredictor  # noqa: E402
from repro_torch.core.predictor import LengthPredictor  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.launch import bench_serving as bench  # noqa: E402
from repro_torch.models.convert import head_from_jax  # noqa: E402

N = 200
ORACLE_TABLES = {"hetero": "run_cluster_hetero", "preemption": "run_cluster_preemption",
                 "prefix": "run_cluster_prefix", "chunked": "run_cluster_chunked",
                 "obs": "run_obs"}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Small products on one thread: the suite runs in several worker
    processes at once, and threads beyond one per worker only contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _same(got, want, skip=("seconds",)):
    """Rows equal in keys, values and types, NaN where NaN, but ``skip``."""
    assert got.keys() == want.keys()
    for k, w in want.items():
        if k in skip:
            continue
        g = got[k]
        if isinstance(w, float) and math.isnan(w):
            assert isinstance(g, float) and math.isnan(g), k
        else:
            assert g == w and type(g) is type(w), (k, g, w)


def test_matrices_and_specs_match_the_reference():
    as_dict = lambda x: dataclasses.asdict(x) if dataclasses.is_dataclass(x) else x
    assert [as_dict(p) for p in bench.POLICIES] == [as_dict(p) for p in jbench.POLICIES]
    assert [tuple(map(as_dict, r)) for r in bench.HETERO_MATRIX] == \
        [tuple(map(as_dict, r)) for r in jbench.HETERO_MATRIX]
    assert bench.PREEMPTION_MATRIX == jbench.PREEMPTION_MATRIX
    assert bench.PREFIX_MATRIX == jbench.PREFIX_MATRIX
    assert bench.CHUNKED_MATRIX == jbench.CHUNKED_MATRIX
    for slots in (32, 16):
        assert [as_dict(s) for s in bench.hetero_specs(slots)] == \
            [as_dict(s) for s in jbench.hetero_specs(slots)]
    assert list(bench.TABLES) == ["single", "cluster", "hetero", "predictors", "preemption",
                                  "adaptation", "prefix", "chunked", "refine", "obs"]
    assert "obs" not in bench.DEFAULT_TABLES


@pytest.mark.parametrize("name", ORACLE_TABLES)
def test_oracle_tables_are_bit_identical(name, tmp_path):
    rows, checks = bench.run_table(name, n_requests=N, verbose=False,
                                   out_dir=str(tmp_path / "port"))
    jkw = dict(out_dir=str(tmp_path / "ref")) if name == "obs" else {}
    want = getattr(jbench, ORACLE_TABLES[name])(n_requests=N, verbose=False, **jkw)
    assert len(rows) == len(want) > 0
    for g, w in zip(rows, want):
        _same(g, w)
    jvalidate = {"hetero": jbench.validate_cluster_hetero,
                 "preemption": jbench.validate_cluster_preemption,
                 "prefix": jbench.validate_cluster_prefix,
                 "chunked": jbench.validate_cluster_chunked}.get(name)
    want_checks = (jbench.validate_obs(want, n_requests=N) if name == "obs"
                   else jvalidate(want))
    for k in ("replay_under_60s", "replay_under_90s", "replay_under_120s"):
        checks.pop(k, None), want_checks.pop(k, None)       # wall clock
    assert checks == want_checks


def test_obs_writes_its_artifacts(tmp_path):
    rows, checks = bench.run_table("obs", n_requests=N, verbose=False, out_dir=str(tmp_path))
    want = jbench.run_obs(n_requests=N, verbose=False, out_dir=str(tmp_path / "ref"))
    assert rows[1]["_events_equal"] is True and want[1]["_events_equal"] is True
    assert rows[1]["_terminal"] == want[1]["_terminal"]
    assert sum(rows[1]["_terminal"].values()) == N
    for f in ("trace.json", "metrics.prom", "summary.json"):
        assert (tmp_path / f).stat().st_size > 0
        assert (tmp_path / f).read_text() == (tmp_path / "ref" / f).read_text()
    trace = json.loads((tmp_path / "trace.json").read_text())
    assert trace["traceEvents"]
    assert all(v is True for k, v in checks.items() if k != "replay_under_120s")


@pytest.mark.parametrize("name", ["preemption", "prefix", "chunked", "obs"])
def test_table_alone_gates_as_the_reference(name, tmp_path, capsys):
    """``--tables <name>`` alone against the reference's ``--<name>-only``:
    both pass, or both exit naming the same failed acceptance booleans (at
    200 requests the preemption and chunked gates fail in both)."""
    def outcome(fn):
        try:
            fn()
        except SystemExit as e:
            return str(e)
        return None

    got = outcome(lambda: bench.main(["--device", "cpu", "--n-requests", str(N), "--tables",
                                      name, "--obs-dir", str(tmp_path / "port")]))
    want = outcome(lambda: jbench.main(n_requests=N, obs_dir=str(tmp_path / "ref"),
                                       **{f"{name}_only": True}))
    assert got == want
    if name in ("preemption", "chunked"):
        assert got and got.startswith(f"{name} acceptance failed")


def test_single_replica_track_runs_on_the_port(monkeypatch):
    """At the reference's defaults (250 requests, whatever ``n_requests`` the
    other tables get): six policy rows, and each ``SimEngine`` run predicts
    its medians in one call of the head (the plain version here, the kernel
    on the card)."""
    calls = []
    plain = ref.prod_head_ref
    monkeypatch.setattr(ref, "prod_head_ref", lambda *a, **k: calls.append(1) or plain(*a, **k))
    rows, checks = bench.run_table("single", n_requests=8000, device="cpu", verbose=False)
    assert len(calls) == len(bench.POLICIES) == 6
    assert [r["policy"] for r in rows] == [
        "fcfs+max", "fcfs+predicted", "sjf_pred+predicted", "sjf_pred+quantile",
        "srtf_pred+quantile", "sjf_oracle+oracle"]
    assert all(r["completed"] == 250 for r in rows)
    assert checks == jbench.validate(rows)
    assert checks["prod_beats_naive_latency"] and checks["prod_reduces_waste"]


def test_single_replica_rows_with_the_reference_head(monkeypatch):
    """The reference's run, its trained head recorded; the port's run with
    that head in place of its own fit: every row equal."""
    heads = []
    jtrain = jpredictor.train_predictor

    def recording(*args, **kwargs):
        heads.append(jtrain(*args, **kwargs))
        return heads[-1]

    monkeypatch.setattr(jpredictor, "train_predictor", recording)
    want = jbench.run(n_requests=120, verbose=False)
    (jpred,) = heads

    def carried(seed, phi, tgt, pcfg, edges, device=None):
        return LengthPredictor(head_from_jax(np_tree(jpred.params), device=device),
                               torch.from_numpy(np.array(jpred.edges)), pcfg)

    monkeypatch.setattr(bench, "train_predictor", carried)
    got = bench.run(n_requests=120, verbose=False, device="cpu")
    assert len(got) == len(want) == len(bench.POLICIES)
    for g, w in zip(got, want):
        _same(g, w, skip=())
    assert bench.validate(got) == jbench.validate(want)
