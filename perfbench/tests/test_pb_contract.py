"""BENCHMARK.json against the rules it is written to, and every name in it
resolved to the file the harness reads."""

import json
import re

import conftest
from harness import common

B = json.loads((conftest.ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}")
UNIT = re.compile(r"[A-Za-z0-9_/%.\-]{1,16}")


def test_keys_and_sizes():
    assert set(B) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                      "per_layer"}
    assert B["command"] == ["python3", "perfbench/run.py"] and B["paths"] == ["perfbench"]
    assert 1 <= B["run_seconds"] <= 51
    assert (2 + 14 * 24) * (B["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200
    assert len((conftest.ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_entries():
    keys = {"configs": {"name", "source", "file", "reduced", "why"},
            "workloads": {"name", "config", "traffic", "chips", "why"},
            "end_to_end": {"name", "unit", "better", "bound", "source"},
            "per_layer": {"name", "unit", "better", "source", "layer", "moves"}}
    for sec, want in keys.items():
        names = [e["name"] for e in B[sec]]
        assert len(names) == len(set(names))
        for e in B[sec]:
            assert set(e) - {"workloads"} == want, e
            assert NAME.fullmatch(e["name"])
            for k in ("why", "layer", "source"):
                if k in e:
                    assert 1 <= len(e[k]) <= 200 and "\n" not in e[k] and "\t" not in e[k]
            if "unit" in e:
                assert UNIT.fullmatch(e["unit"]) and e["better"] in ("lower", "higher")
    for m in B["end_to_end"]:
        assert 0 < m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    assert any(m["name"] == "setup_s" and "workloads" not in m for m in B["end_to_end"])


def test_every_name_resolves():
    cfgs = {c["name"] for c in B["configs"]}
    for c in B["configs"]:
        assert (conftest.ROOT / c["file"]).is_file() and c["file"].startswith("perfbench/")
        assert common.config(c["name"])["name"] == c["name"]
        assert "num_hidden_layers" in c["reduced"] or not c["reduced"]
    used = set()
    for w in B["workloads"]:
        assert w["config"] in cfgs and w["chips"] == 1
        used.add(w["config"])
        common.traffic(w["traffic"])
        assert common.limits(w["name"])
        assert NAME.fullmatch(w["traffic"])
    assert used == cfgs
    e2e = {m["name"] for m in B["end_to_end"]}
    for m in B["end_to_end"] + B["per_layer"]:
        assert callable(common.metric_reader(m["name"]))
    for m in B["per_layer"]:
        assert m["moves"] in e2e
        for w in m["workloads"]:        # each of its cells reports what it moves
            assert any(x["name"] == m["moves"] for x in common.metrics_for(w, False))


def test_every_cell_reports_enough():
    for w in B["workloads"]:
        e2e = [m["name"] for m in common.metrics_for(w["name"], False)]
        assert "setup_s" in e2e and len(e2e) >= 2
        assert common.metrics_for(w["name"], True)
