"""A whole run less the look for a card, on the CPU at tiny sizes: the
result line, the output check, the faults it has to catch, the control, and
a cell, a mix, a configuration and a metric added as files."""

import json
import shutil
import subprocess
import sys

import pytest
import torch

import conftest
import run as bench_run
from harness import check, common

CELLS = [c for c, _, _ in conftest.TINY_CELLS]


def _execute(cell, seed=3_000_000_007, seconds=0.3, trace=0):
    args = bench_run.parse(["--workload", cell, "--seed", str(seed), "--seconds", str(seconds),
                            "--trace", str(trace)])
    return bench_run.execute(args, "cpu")


@pytest.mark.parametrize("cell", CELLS)
def test_result_line(tiny_tree, cell):
    res = _execute(cell)
    assert list(res) == ["correct", "attempted", "failed", "metrics", "device", "checks"]
    assert res["correct"] is True and res["failed"] == 0 and res["attempted"] > 0
    want = {m["name"] for m in common.metrics_for(cell, False)}
    assert set(res["metrics"]) == want and "setup_s" in want
    assert all(v["value"] > 0 for v in res["metrics"].values())
    assert all(c["value"] <= c["limit"] for c in res["checks"].values())
    json.dumps(res)


@pytest.mark.parametrize("cell", ["tiny-dense.admit", "tiny-moe.collect"])
def test_traced_result_line(tiny_tree, cell):
    res = _execute(cell, trace=1)
    assert list(res) == ["correct", "attempted", "failed", "metrics", "device", "breakdown",
                         "checks"]
    assert res["correct"] is True
    assert set(res["device"]) >= {"busy_s", "window_s"}
    assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}


def test_no_card_no_result():
    out = subprocess.run([sys.executable, "perfbench/run.py", "--workload", "qwen25-7b.admit",
                          "--seed", "1", "--seconds", "1", "--trace", "0"],
                         cwd=conftest.ROOT, capture_output=True, text=True, timeout=120)
    if torch.cuda.is_available():
        pytest.skip("a card is here")
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_only_the_benchmark_is_no_program(tmp_path):
    """In a directory with only BENCHMARK.json and the benchmark's files the
    run fails: the program is not there."""
    shutil.copytree(conftest.BENCH, tmp_path / "perfbench")
    shutil.copy(conftest.ROOT / "BENCHMARK.json", tmp_path)
    out = subprocess.run([sys.executable, "perfbench/run.py", "--workload", "qwen25-7b.admit",
                          "--seed", "1", "--seconds", "1", "--trace", "0"],
                         cwd=tmp_path, capture_output=True, text=True, timeout=120)
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_forbidden_modules_by_whole_name(monkeypatch):
    monkeypatch.setitem(sys.modules, "repro_torch.kernels", object())
    assert "repro" not in common.forbidden_loaded()
    monkeypatch.setitem(sys.modules, "repro.core", object())
    assert "repro" in common.forbidden_loaded()


# -- faults the check has to catch ------------------------------------------


def _alter_sampled_tokens(monkeypatch):
    from repro_torch.serving.engine import RealEngine
    orig = RealEngine._sample

    def bad(self, logits, gen):
        tok = orig(self, logits, gen)
        return (tok + 1) % logits.shape[-1]
    monkeypatch.setattr(RealEngine, "_sample", bad)


def _half_batch(monkeypatch):
    """The prefill runs on the first half of the rows; the rest get its
    first row's states."""
    from repro_torch.models.model_zoo import Model
    orig = Model.prefill

    def bad(self, params, tokens=None, attn_valid=None, **kw):
        h = max(tokens.shape[0] // 2, 1)
        logits, hidden, cache = orig(self, params, tokens[:h], attn_valid=attn_valid[:h], **kw)
        idx = torch.arange(tokens.shape[0]) % h
        cache = [tuple(t[idx] for t in e) for e in cache]
        return logits, hidden[idx], cache
    monkeypatch.setattr(Model, "prefill", bad)


def _phi_half(monkeypatch):
    """The last half of each batch's rows (rounded down) get the φ of rows
    of the first half, in the admission path and in the engine."""
    from repro_torch.models import model_zoo
    from repro_torch.serving import engine
    orig = model_zoo.last_token_hidden

    def bad(hidden, lens):
        phi = orig(hidden, lens)
        B = phi.shape[0]
        idx = torch.arange(B)
        idx[B - B // 2:] = torch.arange(B // 2)
        return phi[idx]
    monkeypatch.setattr(model_zoo, "last_token_hidden", bad)
    monkeypatch.setattr(engine, "last_token_hidden", bad)


def _stale_cache(monkeypatch):
    """A decode step that leaves the K/V cache as it was."""
    from repro_torch.models.model_zoo import Model
    orig = Model.decode_step

    def bad(self, params, tokens, cache, pos, lengths, embeds=None):
        saved = [tuple(t.clone() for t in e) for e in cache]
        out = orig(self, params, tokens, cache, pos, lengths, embeds=embeds)
        for e, s in zip(cache, saved):
            for t, u in zip(e, s):
                t.copy_(u)
        return out
    monkeypatch.setattr(Model, "decode_step", bad)


def _alter_quantiles(monkeypatch):
    from repro_torch.core.predictor import LengthPredictor
    orig = LengthPredictor.quantiles

    def bad(self, phi, qs):
        probs, q = orig(self, phi, qs)
        return probs, q + 1.0
    monkeypatch.setattr(LengthPredictor, "quantiles", bad)


FAULTS = {"token_altered": _alter_sampled_tokens, "half_batch": _half_batch,
          "phi_half": _phi_half, "state_unchanged": _stale_cache,
          "answer_altered": _alter_quantiles}
CASES = [("tiny-dense.collect", "token_altered"), ("tiny-moe.collect", "token_altered"),
         ("tiny-dense.collect", "half_batch"), ("tiny-moe.collect", "half_batch"),
         ("tiny-dense.admit", "half_batch"), ("tiny-moe.admit", "half_batch"),
         ("tiny-dense.admit", "phi_half"), ("tiny-moe.admit", "phi_half"),
         ("tiny-moe.collect", "phi_half"),
         ("tiny-dense.collect", "state_unchanged"), ("tiny-moe.collect", "state_unchanged"),
         ("tiny-dense.admit", "answer_altered"), ("tiny-moe.admit", "answer_altered")]


@pytest.mark.parametrize("cell,fault", CASES)
def test_fault_is_not_correct(tiny_tree, monkeypatch, cell, fault):
    FAULTS[fault](monkeypatch)
    assert _execute(cell)["correct"] is False


# -- the control ------------------------------------------------------------


@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(tiny_tree, cell):
    """The reference in float8 (the head in TF32) in the program's place
    fails the cell's limits, where the program passes them."""
    from harness.cells import Cell
    c = Cell(cell, 11, 0.0, False, "cpu")
    c.setup()
    c.min_units = c.mix["check"]["units"]
    units = getattr(c, f"window_{c.kind}")()
    r = getattr(check, f"check_{c.kind}")(c, units, control=True)
    lim = common.limits(cell)
    assert check.judge(r["program"], lim)[0] is True
    assert check.judge(r["control"], lim)[0] is False


# -- added as files -----------------------------------------------------------


def test_cell_mix_config_metric_added_as_files(tiny_tree):
    """A new configuration, traffic mix, metric and cell are new files and
    new entries: no file that was there is edited."""
    root = tiny_tree
    before = {p: p.read_bytes() for p in (root / "perfbench").rglob("*") if p.is_file()}
    pb = root / "perfbench"
    cfg = json.loads((pb / "configs" / "tiny-dense.json").read_text())
    cfg.update({"name": "tiny-dense-wide", "intermediate_size": 192})
    (pb / "configs" / "tiny-dense-wide.json").write_text(json.dumps(cfg))
    mix = json.loads((pb / "traffic" / "tiny-admit.json").read_text())
    mix.update({"batch": 2, "cycle_batches": 4})
    (pb / "traffic" / "tiny-admit-b2.json").write_text(json.dumps(mix))
    (pb / "metrics" / "padded_share.admit.py").write_text(
        "def read(run):\n"
        "    pad = sum(u['B'] * u['width'] for u in run.units)\n"
        "    return 100.0 * (1 - sum(sum(u['lens']) for u in run.units) / pad)\n")
    (pb / "limits" / "tiny-dense-wide.admit-b2.json").write_text(
        (pb / "limits" / "tiny-dense.admit.json").read_text())
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "tiny-dense-wide", "source": "a test",
                             "file": "perfbench/configs/tiny-dense-wide.json",
                             "reduced": [], "why": "a test"})
    bench["workloads"].append({"name": "tiny-dense-wide.admit-b2", "config": "tiny-dense-wide",
                               "traffic": "tiny-admit-b2", "chips": 1, "why": "a test"})
    for m in bench["end_to_end"]:
        if "ttft_ms.p95" == m["name"] or "prompt_tokens_per_s" == m["name"]:
            m["workloads"].append("tiny-dense-wide.admit-b2")
    bench["end_to_end"].append({"name": "padded_share.admit", "unit": "%", "better": "lower",
                                "bound": 0.01, "source": "host_clock",
                                "workloads": ["tiny-dense-wide.admit-b2"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    res = _execute("tiny-dense-wide.admit-b2")
    assert res["correct"] is True
    assert {"padded_share.admit", "ttft_ms.p95", "setup_s"} <= set(res["metrics"])
    after = {p: p.read_bytes() for p in before}
    assert after == before
