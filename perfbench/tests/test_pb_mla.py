"""Kimi-K2-Instruct's architecture (``perfbench/arch/mla.py``) at tiny
widths on the CPU: a configuration that names it, with its cells' limits
and entries, runs its admit and collect cells ``correct: true`` with no file
that was there edited, and faults in the port's latent attention and in its
held experts come out ``correct: false``."""

import copy
import json

import pytest
import torch

from harness import common
from test_pb_run import FAULTS, _execute

CELLS = {"admit": "tiny-mla.admit", "collect": "tiny-mla.collect"}


def _add_mla(root):
    """Kimi-K2-Instruct's configuration at tiny widths (one rank of 4 holding
    4 of 16 experts), its cells' limits and entries: new files, and entries
    in BENCHMARK.json."""
    pb = root / "perfbench"
    cfg = copy.deepcopy(common.config("kimi-k2-instruct"))
    cfg.update({"name": "tiny-mla", "hidden_size": 64, "intermediate_size": 96,
                "moe_intermediate_size": 32, "num_attention_heads": 4, "num_key_value_heads": 4,
                "q_lora_rank": 48, "kv_lora_rank": 32, "qk_nope_head_dim": 16,
                "qk_rope_head_dim": 8, "v_head_dim": 16, "num_hidden_layers": 3,
                "n_routed_experts": 4, "expert_parallel": {"ranks": 4, "rank": 1},
                "num_experts_per_tok": 3, "vocab_size": 97, "torch_dtype": "float32",
                "reduced": {},
                "rope_scaling": dict(cfg["rope_scaling"], factor=4,
                                     original_max_position_embeddings=8)})
    cfg["init"] = dict(cfg["init"], router_bias_std=0.05)
    (pb / "configs" / "tiny-mla.json").write_text(json.dumps(cfg))
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "tiny-mla", "source": "a test",
                             "file": "perfbench/configs/tiny-mla.json", "reduced": [],
                             "why": "a test"})
    for kind, cell in CELLS.items():
        (pb / "limits" / f"{cell}.json").write_text(
            (pb / "limits" / f"tiny-moe.{kind}.json").read_text())
        bench["workloads"].append({"name": cell, "config": "tiny-mla",
                                   "traffic": f"tiny-{kind}", "chips": 1, "why": "a test"})
        for m in bench["end_to_end"] + bench["per_layer"]:
            if "workloads" in m and f"tiny-moe.{kind}" in m["workloads"]:
                m["workloads"].append(cell)
    (root / "BENCHMARK.json").write_text(json.dumps(bench))


def _no_k_rope(monkeypatch):
    """The latent cache's k_pe is left unrotated."""
    from repro_torch.models import mla
    orig = mla._entry

    def bad(p, x, cfg, angles):
        return orig(p, x, cfg, torch.zeros_like(angles))
    monkeypatch.setattr(mla, "_entry", bad)


def _every_expert_mine(monkeypatch):
    """The held block is taken as experts 0.. of the router, whatever the
    configuration's offset."""
    from repro_torch.models import moe
    orig = moe._held_ids
    monkeypatch.setattr(moe, "_held_ids", lambda ids, lo, n: orig(ids, 0, n))


@pytest.mark.parametrize("kind", list(CELLS))
def test_mla_cells_added_as_files(tiny_tree, kind):
    root = tiny_tree
    before = {p: p.read_bytes() for p in (root / "perfbench").rglob("*") if p.is_file()}
    _add_mla(root)
    res = _execute(CELLS[kind])
    assert res["correct"] is True
    assert {m["name"] for m in common.metrics_for(CELLS[kind], False)} == set(res["metrics"])
    assert {p: p.read_bytes() for p in before} == before


MLA_FAULTS = {"k_rope_left_out": _no_k_rope, "wrong_expert_block": _every_expert_mine,
              **FAULTS}


@pytest.mark.parametrize("cell,fault", [("tiny-mla.admit", "k_rope_left_out"),
                                        ("tiny-mla.collect", "k_rope_left_out"),
                                        ("tiny-mla.admit", "wrong_expert_block"),
                                        ("tiny-mla.admit", "half_batch"),
                                        ("tiny-mla.collect", "state_unchanged")])
def test_mla_fault_is_not_correct(tiny_tree, monkeypatch, cell, fault):
    _add_mla(tiny_tree)
    MLA_FAULTS[fault](monkeypatch)
    assert _execute(cell)["correct"] is False


def test_mla_traced_admit_reads_its_metrics(tiny_tree):
    """A traced run on the CPU reports the per-layer metrics that need no
    device (the MoE counters); ``mla_ms.admit`` and the device shares read
    nothing there."""
    _add_mla(tiny_tree)
    res = _execute("tiny-mla.admit", trace=1)
    assert res["correct"] is True
    assert "moe_drop_share.admit" in res["metrics"]
