"""CPU fixtures of the benchmark's tests: a copy of the benchmark in a
temporary directory, with tiny configurations and mixes beside the real ones,
so that a whole run (less the look for a card) goes through on the CPU."""

import copy
import json
import shutil
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
for p in (str(ROOT / "src"), str(BENCH)):
    if p not in sys.path:
        sys.path.insert(0, p)

TINY = {
    "tiny-dense": {"hidden_size": 64, "num_attention_heads": 4, "num_key_value_heads": 2,
                   "head_dim": 16, "num_hidden_layers": 2, "intermediate_size": 128,
                   "port": {"family": "dense", "qk_norm": False}},
    "tiny-moe": {"hidden_size": 64, "num_attention_heads": 4, "num_key_value_heads": 2,
                 "head_dim": 32, "num_hidden_layers": 2, "intermediate_size": 128,
                 "num_experts": 8, "num_experts_per_tok": 2, "moe_intermediate_size": 32,
                 "port": {"family": "moe", "qk_norm": True}},
}
TINY_MIXES = {
    "tiny-admit": {"kind": "admit", "batch": 3, "cycle_batches": 3, "grouping_seed": 0,
                   "prompt_len": {"law": "lognormal", "median": 12, "sigma": 0.6, "min": 4,
                                  "max": 30},
                   "pad_multiple": 8, "temperature": 0.8, "quantiles": [0.5, 0.9],
                   "check": {"units": 3}, "trace": {"batches": 2}},
    "tiny-collect": {"kind": "collect", "prompts": 3, "repeats": 2, "greedy_repeats": 1,
                     "prompt_len": {"law": "lognormal", "median": 8, "sigma": 0.5, "min": 3,
                                    "max": 12},
                     "pad_to": 12, "max_new": 7, "temperature": 0.8,
                     "greedy_temperature": 1e-06, "warmup_steps": 2,
                     "check": {"units": 1, "rows": 2}, "trace": {"skip_steps": 1, "steps": 3}},
}
TINY_CELLS = [(f"{c}.{k}", c, f"tiny-{k}") for c in TINY for k in ("admit", "collect")]
# each tiny configuration is judged by the numbers its full-size family's cells compare
FAMILY_CONFIG = {"tiny-dense": "qwen25-7b", "tiny-moe": "qwen3-moe-235b-a22b"}


def tiny_config(name: str, dtype: str = "float32") -> dict:
    cfg = json.loads((BENCH / "configs" / "qwen25-7b.json").read_text())
    for k in ("num_experts", "num_experts_per_tok", "moe_intermediate_size"):
        cfg.pop(k, None)
    cfg.update(copy.deepcopy(TINY[name]))
    cfg.update({"name": name, "vocab_size": 97, "torch_dtype": dtype, "reduced": {}})
    return cfg


def write_tree(root: Path, dtype: str = "float32", limits: float = 1e-3) -> Path:
    """A checkout with the benchmark, its tiny cells and the port's sources
    linked in; returns its root."""
    pb = root / "perfbench"
    shutil.copytree(BENCH, pb, ignore=shutil.ignore_patterns("tests", "__pycache__"))
    (root / "src").symlink_to(ROOT / "src")
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    for name in TINY:
        (pb / "configs" / f"{name}.json").write_text(json.dumps(tiny_config(name, dtype)))
        bench["configs"].append({"name": name, "source": "a test's tiny sizes",
                                 "file": f"perfbench/configs/{name}.json", "reduced": [],
                                 "why": "CPU tests"})
    for name, mix in TINY_MIXES.items():
        (pb / "traffic" / f"{name}.json").write_text(json.dumps(mix))
    for cell, cfg, mix in TINY_CELLS:
        bench["workloads"].append({"name": cell, "config": cfg, "traffic": mix, "chips": 1,
                                   "why": "CPU tests"})
        kind = mix.split("-")[1]
        keys = json.loads((BENCH / "limits" / f"{FAMILY_CONFIG[cfg]}.{kind}.json").read_text())
        (pb / "limits" / f"{cell}.json").write_text(json.dumps({"limits": {
            k: limits for k in keys["limits"]}}))
        for m in bench["end_to_end"] + bench["per_layer"]:
            if "workloads" in m and any(w.endswith("." + kind) for w in m["workloads"]):
                m["workloads"].append(cell)
    (root / "BENCHMARK.json").write_text(json.dumps(bench, indent=1))
    return root


@pytest.fixture
def tiny_tree(tmp_path, monkeypatch):
    """The harness pointed at a tiny checkout (float32, so that the port's
    CPU path and the reference agree to rounding)."""
    from harness import common
    root = write_tree(tmp_path)
    monkeypatch.setattr(common, "ROOT", root)
    monkeypatch.setattr(common, "BENCH_DIR", root / "perfbench")
    monkeypatch.setattr(common, "BUILD", root / "build" / "perfbench")
    return root
