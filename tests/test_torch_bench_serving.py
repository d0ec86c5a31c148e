"""The port's cluster tables (``launch/bench_serving.py``) end to end on the
CPU at a small size, against the reference's ``benchmarks/bench_serving.py``.

The router table runs the ``LatentOracle`` only, so its rows equal the
reference's bit for bit (but the wall-clock ``seconds``). The tables with
the head in the loop train their heads from the port's own seeds; they run
end to end and report what the reference reports: the same row keys, the
service rows, and the same ``validate_*`` functions (each is fed the same
rows in both packages and must give the same checks).
"""

import dataclasses
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_parity import jax  # noqa: E402,F401  (skips without JAX)

from benchmarks import bench_serving as jbench  # noqa: E402
from repro_torch.launch import bench_serving as bench  # noqa: E402

N = 200


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Small products on one thread: the suite runs in several worker
    processes at once, and threads beyond one per worker only contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def tables():
    return bench.main(["--device", "cpu", "--n-requests", str(N)])


def test_matrices_match_the_reference():
    as_dicts = lambda matrix: [(r, dataclasses.asdict(p)) for r, p in matrix]
    assert as_dicts(bench.CLUSTER_MATRIX) == as_dicts(jbench.CLUSTER_MATRIX)
    assert bench.ORDER_MATRIX == jbench.ORDER_MATRIX
    assert bench.REFINE_MODES == jbench.REFINE_MODES
    assert bench.REFINE_T_GRID == jbench.REFINE_T_GRID
    assert bench.ADAPT_MODES == jbench.ADAPT_MODES


def test_router_table_is_bit_identical(tables):
    rows, checks = tables["cluster"]
    want = jbench.run_cluster(n_requests=N, verbose=False)
    assert len(rows) == len(want) == len(bench.CLUSTER_MATRIX)
    for g, w in zip(rows, want):
        assert g.keys() == w.keys()
        for k in w:
            if k == "seconds":
                continue
            if isinstance(w[k], float) and math.isnan(w[k]):
                assert math.isnan(g[k]), k
            else:
                assert g[k] == w[k], (k, g[k], w[k])
    assert checks == jbench.validate_cluster(rows)


@pytest.mark.parametrize("name,n_rows", [("predictors", 9), ("refine", 6),
                                         ("adaptation", 6)])
def test_head_tables_run_end_to_end(tables, name, n_rows):
    rows, checks = tables[name]
    assert len(rows) == n_rows
    validate = {"predictors": jbench.validate_cluster_predictors,
                "refine": jbench.validate_cluster_refine,
                "adaptation": jbench.validate_cluster_adaptation}[name]
    assert checks == validate(rows)
    for r in rows:
        assert np.isfinite(r["p50_latency"]) and r["completed"] > 0
    services = [r["service"] for r in rows if "service" in r]
    assert services and all(s["batches"] > 0 and s["buckets"] for s in services)
    if name == "refine":
        anno = rows[0]["annotation_service"]
        assert anno["requests"] == 6000
        assert all(len(r["mae_by_t"]) > 0 for r in rows if r["mode"] != "prompt-only")
    if name == "adaptation":
        assert {r["trace"] for r in rows} == {"stationary", "drift"}
        assert all(0.0 <= r["coverage"] <= 1.0 for r in rows)


def test_unknown_table_is_refused():
    with pytest.raises(SystemExit):
        bench.main(["--device", "cpu", "--tables", "cluster,nope"])
