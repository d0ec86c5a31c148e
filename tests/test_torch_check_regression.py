"""The port's regression gate (``launch/check_regression.py``) and stamp
writer (``launch/bench_serving.py``'s ``--stamp``) against the reference's
``benchmarks/check_regression.py`` and ``_write_stamp``, on the CPU.

The gate's cases of ``tests/test_telemetry.py`` run on the port's module;
the port's verdicts equal the reference's on the committed
``BENCH_serving.json`` and on copies of it with one number or name changed;
``main`` prints the reference's messages and exits with its codes. The
port's stamp of the chunked table equals the reference's stamp of its own
table at the same size and seed (the ``LatentOracle`` tables are the
reference's bit for bit), but the wall-clock ``seconds`` and ``git_sha``.
"""

import copy
import importlib.util
import json
import re
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_parity import jax  # noqa: E402,F401  (skips without JAX)

from repro_torch.launch import bench_serving as bench  # noqa: E402
from repro_torch.launch import check_regression as cr  # noqa: E402

REPO = Path(__file__).resolve().parents[1]


def _load_bench(name):
    spec = importlib.util.spec_from_file_location(
        f"reference_{name}", REPO / "benchmarks" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def jcr():
    return _load_bench("check_regression")


def _mini_stamp(p99=100.0, p99_ttft=50.0, gp=40.0, router="psq", meta=None):
    return {"meta": dict(meta or {"n_requests": 10, "seed": 0}),
            "tables": {"cluster": {"rows": [{
                "router": router, "policy": "fcfs+quantile",
                "p99_latency": p99, "p99_ttft": p99_ttft, "goodput": gp,
            }], "checks": {}}}}


# tests/test_telemetry.py's TestCheckRegression, each case on the port's module

def _committed_stamp_passes_against_itself(tmp_path):
    doc = cr.load_stamp(str(REPO / "BENCH_serving.json"))
    violations, skipped, compared = cr.compare(doc, doc, 0.10, 0.95)
    assert violations == [] and skipped == []
    assert len(compared) > 0


def _fails_on_injected_p99_regression(tmp_path):
    v, _, _ = cr.compare(_mini_stamp(), _mini_stamp(p99=150.0), 0.10, 0.95)
    assert len(v) == 1 and "p99_latency" in v[0]
    v, _, _ = cr.compare(_mini_stamp(), _mini_stamp(p99_ttft=80.0), 0.10, 0.95)
    assert len(v) == 1 and "p99_ttft" in v[0]
    # within tolerance passes
    v, _, _ = cr.compare(_mini_stamp(), _mini_stamp(p99=105.0), 0.10, 0.95)
    assert v == []


def _fails_on_goodput_drop(tmp_path):
    v, _, _ = cr.compare(_mini_stamp(), _mini_stamp(gp=20.0), 0.10, 0.95)
    assert len(v) == 1 and "goodput" in v[0]


def _meta_mismatch_is_a_failure_unless_ignored(tmp_path):
    other = _mini_stamp(meta={"n_requests": 99, "seed": 0})
    v, _, compared = cr.compare(_mini_stamp(), other, 0.10, 0.95)
    assert len(v) == 1 and "meta mismatch" in v[0] and compared == []
    v, _, compared = cr.compare(_mini_stamp(), other, 0.10, 0.95, ignore_meta=True)
    assert v == [] and compared


def _matrix_change_skips_not_fails(tmp_path):
    v, skipped, _ = cr.compare(_mini_stamp(), _mini_stamp(router="jsq", p99=500.0), 0.10, 0.95)
    assert v == [] and len(skipped) == 1


def _cli_exit_codes(tmp_path):
    base, cand = tmp_path / "b.json", tmp_path / "c.json"
    base.write_text(json.dumps(_mini_stamp()))
    cand.write_text(json.dumps(_mini_stamp(p99=500.0)))
    assert cr.main(["--baseline", str(base), "--candidate", str(base)]) == 0
    assert cr.main(["--baseline", str(base), "--candidate", str(cand)]) == 1


GATE_CASES = [_committed_stamp_passes_against_itself, _fails_on_injected_p99_regression,
              _fails_on_goodput_drop, _meta_mismatch_is_a_failure_unless_ignored,
              _matrix_change_skips_not_fails, _cli_exit_codes]


@pytest.mark.parametrize("case", GATE_CASES, ids=lambda f: f.__name__.strip("_"))
def test_the_reference_gate_cases_on_the_port(case, tmp_path):
    case(tmp_path)


def _committed():
    return json.loads((REPO / "BENCH_serving.json").read_text())


def _p99_up(doc):
    doc["tables"]["cluster_chunked"]["rows"][1]["p99_latency"] *= 1.2


def _goodput_down(doc):
    doc["tables"]["cluster"]["rows"][2]["goodput"] *= 0.9


def _router_renamed(doc):
    doc["tables"]["cluster_prefix"]["rows"][0]["router"] = "renamed"


def _meta_changed(doc):
    doc["meta"]["n_requests"] = 50_000


@pytest.mark.parametrize("change", [None, _p99_up, _goodput_down, _router_renamed,
                                    _meta_changed],
                         ids=["itself", "p99_up_20pct", "goodput_to_90pct", "router_renamed",
                              "meta_changed"])
@pytest.mark.parametrize("ignore_meta", [False, True])
def test_verdicts_equal_the_reference(change, ignore_meta, jcr):
    base = _committed()
    cand = copy.deepcopy(base)
    if change is not None:
        change(cand)
    got = cr.compare(base, cand, 0.10, 0.95, ignore_meta=ignore_meta)
    want = jcr.compare(base, cand, 0.10, 0.95, ignore_meta=ignore_meta)
    assert got == want
    if change is not None and not ignore_meta:
        assert got[0] or got[1]          # each change shows: a violation or a skip


@pytest.mark.parametrize("change,rc", [(None, 0), (_p99_up, 1), (_goodput_down, 1),
                                       (_router_renamed, 0), (_meta_changed, 1)])
def test_main_prints_and_exits_as_the_reference(change, rc, jcr, tmp_path, capsys):
    base, cand = tmp_path / "base.json", tmp_path / "cand.json"
    doc = _committed()
    base.write_text(json.dumps(doc))
    if change is not None:
        change(doc)
    cand.write_text(json.dumps(doc))
    argv = ["--baseline", str(base), "--candidate", str(cand), "--verbose"]
    assert cr.main(argv) == rc
    got = capsys.readouterr()
    assert jcr.main(argv) == rc
    want = capsys.readouterr()
    assert (got.out, got.err) == (want.out, want.err)


def test_load_stamp_refuses_what_is_not_a_stamp(tmp_path):
    path = tmp_path / "x.json"
    path.write_text(json.dumps({"rows": []}))
    with pytest.raises(SystemExit, match="not a bench stamp"):
        cr.load_stamp(str(path))


# the stamp

def test_stamp_meta_merges_non_destructively_and_scrubs(tmp_path):
    """tests/test_telemetry.py's TestStampProvenance case, on the port's writer."""
    path = str(tmp_path / "stamp.json")
    bench._write_stamp(path, {"a": {"rows": [], "checks": {}}},
                       timestamp="2026-08-08T00:00:00Z", n_requests=5)
    # a later partial refresh: new table, no timestamp supplied
    bench._write_stamp(path, {"b": {"rows": [{"x": np.float64(1.5)}],
                                    "checks": {"ok": np.bool_(True)}}},
                       n_requests=5, seed=3)
    doc = json.loads(Path(path).read_text())
    assert set(doc["tables"]) == {"a", "b"}
    assert doc["meta"]["timestamp"] == "2026-08-08T00:00:00Z"
    assert doc["meta"]["n_requests"] == 5 and doc["meta"]["seed"] == 3
    assert isinstance(doc["meta"]["git_sha"], str)
    # numpy scalars were scrubbed to JSON natives
    assert doc["tables"]["b"]["rows"][0]["x"] == 1.5
    assert doc["tables"]["b"]["checks"]["ok"] is True


def test_stamp_keys_are_the_references():
    """Every table has the key the reference's ``main`` stamps it under."""
    src = (REPO / "benchmarks" / "bench_serving.py").read_text()
    assert set(bench.STAMP_KEYS) == set(bench.TABLES)
    for key in bench.STAMP_KEYS.values():
        assert f'finish("{key}"' in src


def _without_wall_clock(doc):
    """The stamp as text, its rows' ``seconds`` and meta's ``git_sha`` left
    out (NaN compares equal as text)."""
    doc = copy.deepcopy(doc)
    doc["meta"].pop("git_sha")
    for table in doc["tables"].values():
        for row in table["rows"]:
            row.pop("seconds", None)
    return json.dumps(doc, sort_keys=True)


def test_chunked_stamp_equals_the_references(tmp_path):
    jbench = _load_bench("bench_serving")
    n = 400
    jrows = jbench.run_cluster_chunked(n_requests=n, n_replicas=4, seed=0)
    jchecks = jbench.validate_cluster_chunked(jrows)
    want = tmp_path / "reference.json"
    jbench._write_stamp(str(want), {"cluster_chunked": {"rows": jrows, "checks": jchecks}},
                        n_requests=n, n_replicas=4, max_slots=32, pattern="bursty", seed=0)
    got = tmp_path / "port.json"
    argv = ["--tables", "chunked", "--n-requests", str(n), "--stamp", str(got)]
    failed = [k for k in bench.HARD_CHECKS["chunked"] if not jchecks[k]]
    if failed:       # the reference's --chunked-only gate fails here too: stamped, then exit
        with pytest.raises(SystemExit, match=re.escape(str(failed))):
            bench.main(argv)
    else:
        bench.main(argv)
    assert _without_wall_clock(json.loads(got.read_text())) == \
        _without_wall_clock(json.loads(want.read_text()))
