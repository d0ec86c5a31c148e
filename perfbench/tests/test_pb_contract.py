"""BENCHMARK.json against the rules it is written to, and every name in it
resolved to the file the harness reads."""

import json
import re

import pytest

import conftest
from harness import common, reference

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


# keys that name a width, which no configuration may cut: a hidden,
# intermediate, latent, state or projection size, a head size, an expansion
# factor, a key ending in _dim or _rank, the experts a token routes to
WIDTH = re.compile(r".*(_dim|_rank|hidden_size|intermediate_size|head_size|state_size|"
                   r"expand|latent.*|proj.*)|num_experts_per_tok")
# what every architecture module gives, and the counts the metrics call
SEAM = ("describe", "layout", "Reference", "flops")
COUNTS = ("prefill_flops", "step_flops", "step_bytes", "least_s", "flash_least_s",
          "decode_attn_bytes")


def test_every_name_resolves():
    cfgs = {c["name"] for c in B["configs"]}
    for c in B["configs"]:
        assert (conftest.ROOT / c["file"]).is_file() and c["file"].startswith("perfbench/")
        cfg = common.config(c["name"])
        assert cfg["name"] == c["name"]
        arch = common.arch_of(cfg)
        assert all(hasattr(arch, k) for k in SEAM), cfg["arch"]
        assert issubclass(arch.Reference, reference.Reference)
        assert all(callable(getattr(arch.flops, k)) for k in COUNTS), cfg["arch"]
        # each published key cut is explained in the file, as model-configs
        # section 4 asks (the depth, the experts held, the vocabulary slice)
        assert set(c["reduced"]) == set(cfg["reduced"]), c["name"]
        for k in c["reduced"]:
            assert NAME.fullmatch(k) and not WIDTH.fullmatch(k), (c["name"], k)
            cut = cfg["reduced"][k]
            assert set(cut) == {"published", "here", "why"} and cut["why"], (c["name"], k)
            assert cfg[k] == cut["here"] != cut["published"], (c["name"], k)
    used = set()
    for w in B["workloads"]:
        assert w["config"] in cfgs and w["chips"] in (1, 4)
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


@pytest.mark.parametrize("arch", [None, "no_such_arch"])
def test_a_configuration_without_its_arch_fails_by_name(arch):
    """No architecture is assumed: a configuration that names none, or one
    whose module is missing, fails at once and names the configuration."""
    cfg = dict(common.config("qwen25-7b"), name="cfg-under-test")
    if arch is None:
        del cfg["arch"]
    else:
        cfg["arch"] = arch
    with pytest.raises((KeyError, FileNotFoundError), match="cfg-under-test"):
        common.arch_of(cfg)
