"""``harness/spans.py`` on a small synthetic chrome trace, and the readers of
the program's spans and counters on the tiny CPU cells through ``--trace 1``."""

import gzip
import json
from types import SimpleNamespace

import pytest

import conftest
import run as bench_run
from harness import common, spans


def _x(cat, name, ts, dur, tid=1, corr=None):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "pid": 0, "tid": tid}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


EVENTS = [
    _x("user_annotation", "perfbench.window", 0, 100),
    _x("user_annotation", "perfbench.decode_step", 5, 65),      # the benchmark's: left out
    _x("user_annotation", "model.decode_step", 10, 50),
    _x("user_annotation", "model.unembed", 40, 15),
    _x("gpu_user_annotation", "model.decode_step", 20, 40, tid=7),
    _x("cuda_runtime", "cudaLaunchKernel", 12, 2, corr=1),
    _x("kernel", "gemm", 20, 5, tid=7, corr=1),
    _x("cuda_driver", "cuLaunchKernelEx", 45, 2, corr=2),
    _x("kernel", "nvjet_tst", 50, 10, tid=7, corr=2),
    _x("cuda_runtime", "cudaLaunchKernel", 30, 2, tid=2, corr=3),   # another thread
    _x("kernel", "other_thread", 62, 3, tid=7, corr=3),
    _x("cuda_runtime", "cudaMemcpyAsync", 80, 2, corr=4),          # outside any span
    _x("gpu_memcpy", "Memcpy DtoH", 85, 2, tid=7, corr=4),
    _x("kernel", "no_launch_event", 90, 4, tid=7, corr=5),
]


@pytest.fixture
def synthetic(tmp_path):
    path = tmp_path / "trace.json.gz"
    with gzip.open(path, "wt") as f:
        json.dump({"traceEvents": EVENTS}, f)
    return SimpleNamespace(trace={"path": str(path)})


def test_kernels_go_to_the_innermost_span_of_their_launch(synthetic):
    tr = spans.load(synthetic)
    assert tr is spans.load(synthetic)                 # read once a run
    assert [s[2] for s in tr.spans] == ["model.decode_step", "model.unembed"]
    got = tr.device_s_by_span()
    assert got.keys() == {"model.decode_step", "model.unembed"}
    assert got["model.decode_step"] == pytest.approx(5e-6)        # runtime launch
    assert got["model.unembed"] == pytest.approx(10e-6)           # driver launch


def test_idle_and_self_time_inside_a_span(synthetic):
    tr = spans.load(synthetic)
    # [10, 60] less the device's [20, 25] and [50, 60]; the kernel of the
    # other thread's launch runs at [62, 65], outside
    assert tr.idle_inside("model.decode_step") == pytest.approx(35e-6)
    assert tr.idle_inside("model.unembed") == pytest.approx(10e-6)
    assert tr.intervals("model.unembed") == [(40, 55)]


@pytest.mark.parametrize("kind", ["admit", "collect"])
def test_drop_share_from_the_counters(monkeypatch, kind):
    from repro_torch.common import scopes
    run = SimpleNamespace(kind=kind, trace={"path": "t.json.gz"})
    monkeypatch.setattr(scopes, "counters", lambda: {"moe.pairs": 400, "moe.dropped": 30})
    assert spans.moe_drop_share(run, kind) == pytest.approx(0.075)
    assert spans.moe_drop_share(run, "admit" if kind == "collect" else "collect") is None
    assert spans.moe_drop_share(SimpleNamespace(kind=kind, trace=None), kind) is None
    monkeypatch.setattr(scopes, "counters", lambda: {})           # no MoE layer counted
    assert spans.moe_drop_share(run, kind) is None
    monkeypatch.delattr(scopes, "counters")                       # a program without counters
    assert spans.moe_drop_share(run, kind) is None


def test_no_trace_no_spans():
    assert spans.load(SimpleNamespace(trace=None)) is None
    assert spans.load(SimpleNamespace(trace={"path": "/nonexistent/t.json.gz"})) is None


NEW = ("unembed_ms.collect", "moe_ms.collect", "head_idle_ms.admit", "moe_drop_share.admit",
       "moe_drop_share.collect")
DEVICE_READ = {"unembed_ms.collect", "moe_ms.collect", "head_idle_ms.admit"}


@pytest.mark.parametrize("cell", ["tiny-moe.admit", "tiny-moe.collect", "tiny-dense.collect"])
def test_readers_on_the_tiny_cells(tiny_tree, cell):
    from repro_torch.common import scopes
    scopes.reset_counters()
    kind = cell.split(".")[1]
    args = bench_run.parse(["--workload", cell, "--seed", "3000000019", "--seconds", "0.2",
                            "--trace", "1"])
    res = bench_run.execute(args, "cpu")
    names = {m["name"] for m in common.metrics_for(cell, True)}
    assert {n for n in NEW if n.endswith("." + kind)} <= names
    assert not DEVICE_READ & set(res["metrics"])       # no kernels in a CPU trace
    drop = res["metrics"].get(f"moe_drop_share.{kind}")
    if cell.startswith("tiny-moe"):
        assert 0.0 <= drop["value"] <= 1.0 and drop["unit"] == "share"
    else:
        assert drop is None
    tr = spans.load(SimpleNamespace(trace={
        "path": str(common.BUILD / f"trace-{cell}.json.gz")}))
    held = {s[2] for s in tr.spans}
    if kind == "collect":
        mix = conftest.TINY_MIXES["tiny-collect"]["trace"]
        assert len(tr.intervals("model.decode_step")) == mix["steps"]
        assert {"engine.step", "engine.sample", "engine.finished_sync", "model.unembed"} <= held
    else:
        assert {"model.prefill", "model.unembed", "engine.sample", "head.quantiles"} <= held
    assert ("moe.dispatch" in held) == cell.startswith("tiny-moe")
    scopes.reset_counters()
