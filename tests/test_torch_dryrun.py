"""The port's dry-run (launch/dryrun.py) and roofline (launch/roofline.py) at
sizes that are not slow: run_one on reduced configs with a tiny InputShape on
the 16x16 pod mesh of a fake 256-rank group (the reference's slow
test_small_mesh_dryrun_lowering, here at every kind), argument_bytes against
an independent sum, the expert-parallel region's collectives on a (2, 2) mesh
in both FSDP modes, the roofline table and run.py's roofline rows."""

import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch.distributed as dist  # noqa: E402

from repro_torch.common.config import InputShape  # noqa: E402
from repro_torch.common.pytree import tree_items  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch import dryrun, roofline, run  # noqa: E402
from repro_torch.launch.mesh import make_test_mesh  # noqa: E402
from repro_torch.launch.workload import build_steps  # noqa: E402

SHAPES = {"train": InputShape("tiny_train", 32, 32, "train"),
          "prefill": InputShape("tiny_prefill", 32, 32, "prefill"),
          "decode": InputShape("tiny_decode", 64, 32, "decode")}


@pytest.fixture(autouse=True, scope="module")
def fake_group_closed_after():
    yield
    if dist.is_initialized():
        dist.destroy_process_group()
    dryrun._MESHES.clear()


def _reduced(arch):
    cfg = get_config(arch).reduced()
    # 16 experts, so that the pod mesh's model axis divides them (the
    # expert-parallel branch runs only then)
    return cfg.with_overrides(n_experts=16) if cfg.family == "moe" else cfg


@pytest.fixture(scope="module")
def results():
    out = {}
    for arch in ("yi-34b", "qwen3-moe-235b-a22b", "zamba2-1.2b"):
        for kind, shape in SHAPES.items():
            out[arch, kind] = dryrun.run_one(arch, shape.name, multi_pod=False,
                                             cfg=_reduced(arch), shape=shape)
    return out


def test_reduced_configs_trace_on_the_pod_mesh(results):
    for key, r in results.items():
        assert r["ok"], (key, r.get("traceback"))
        assert r["chips"] == 256 and r["mesh"] == "pod"
        rf = r["roofline"]
        assert rf["dominant"] in ("compute_s", "memory_s", "collective_s")
        assert r["flops_per_device"] > 0 and r["bytes_per_device"] > 0
        assert r["hbm_ok"] is True and r["memory"]["temp_bytes"] is None
    moe = results["qwen3-moe-235b-a22b", "prefill"]
    assert moe["expert_parallel"]["all-gather_count"] > 0 and moe["roofline"]["collective_s"] > 0
    assert results["yi-34b", "prefill"]["roofline"]["collective_s"] == 0


def test_argument_bytes_is_the_sum_of_the_shards():
    """An independent count: each leaf's bytes over the product of the mesh
    axes its spec names."""
    mesh = dryrun.production_mesh(False)
    for kind, shape in SHAPES.items():
        built = build_steps(_reduced("qwen3-moe-235b-a22b"), shape, mesh=mesh)
        want = 0
        for specs, pspecs in zip(built["arg_specs"], built["arg_pspecs"]):
            leaves = [t for _, t in tree_items(specs)]
            # the specs in the same order: every leaf of an axes tree is a tuple
            flat = _spec_leaves(pspecs)
            assert len(leaves) == len(flat)
            for t, spec in zip(leaves, flat):
                split = np.prod([16 for e in spec if e is not None
                                 for _ in (e if isinstance(e, tuple) else (e,))])
                want += t.numel() * t.dtype.itemsize // int(split)
        assert dryrun.argument_bytes(built, mesh) == want, kind


def _spec_leaves(tree):
    from repro_torch.common.sharding import PartitionSpec
    if isinstance(tree, PartitionSpec):
        return [tree]
    if isinstance(tree, dict):
        return [s for k in sorted(tree) for s in _spec_leaves(tree[k])]
    return [s for v in tree for s in _spec_leaves(v)]


@pytest.mark.parametrize("variant,gathers,reduces", [("baseline", 4, 1), ("moe_partial", 5, 3)])
def test_expert_parallel_collectives_per_mode(variant, gathers, reduces):
    """Per MoE layer of a prefill on (2, 2): "gather" all-gathers the three
    expert weights and the output's tokens and psums once; "partial"
    gathers tokens, ids, weights and the d-sliced output, then the tokens,
    and psums the two pre-activations and the output."""
    dryrun.open_fake_group(4)
    mesh = make_test_mesh(2, 2)
    cfg = get_config("qwen3-moe-235b-a22b").reduced()
    r = dryrun.run_one("qwen3-moe-235b-a22b", "tiny_prefill", False, variant=variant, cfg=cfg,
                       shape=SHAPES["prefill"], mesh=mesh)
    assert r["ok"], r.get("traceback")
    assert r["mesh"] == "2x2" and r["chips"] == 4
    ep = r["expert_parallel"]
    assert ep["all-gather_count"] == gathers * cfg.n_layers
    assert ep["all-reduce_count"] == reduces * cfg.n_layers
    assert ep["reduce-scatter_count"] == 0
    assert r["collectives"]["all-gather_count"] == ep["all-gather_count"]


def test_roofline_table_and_run_rows(results, tmp_path, capsys):
    for (arch, kind), r in results.items():
        (tmp_path / f"{arch}_{kind}_pod.json").write_text(json.dumps(r, default=float))
    failed = dict(results["yi-34b", "train"], ok=False, error="ValueError: x", arch="x")
    (tmp_path / "x_train_pod.json").write_text(json.dumps(failed, default=float))
    rows = roofline.load(str(tmp_path))
    assert len(rows) == 10
    text = roofline.table(rows)
    assert "FAILED: ValueError: x" in text and "qwen3-moe-235b-a22b" in text
    assert len(roofline.notes(rows)) == 9
    assert roofline.main(["--dir", str(tmp_path)]) == rows
    got = run.main(["--only", "roofline", "--device", "cpu", "--dryrun-dir", str(tmp_path)])
    assert got == [("roofline_pod_combos_ok", "9/10", "traced on 16x16"),
                   ("roofline_multipod_combos_ok", "0/0", "2x16x16")]


@pytest.mark.parametrize("arch,n_layers,kind", [
    ("yi-34b", 4, "train"), ("gemma3-27b", 11, "prefill"), ("zamba2-1.2b", 7, "prefill"),
    ("whisper-large-v3", 4, "prefill"), ("qwen3-moe-235b-a22b", 4, "prefill")])
def test_depth_by_trip_count_equals_the_full_trace(arch, n_layers, kind):
    """One and two repeated blocks, weighted to the model's depth, give the
    full-depth trace's totals."""
    cfg = _reduced(arch).with_overrides(n_layers=n_layers)
    if cfg.family == "encdec":
        cfg = cfg.with_overrides(n_encoder_layers=5)
    got, want = (dryrun.run_one(arch, SHAPES[kind].name, False, cfg=cfg, shape=SHAPES[kind],
                                full_depth=full) for full in (False, True))
    assert got["ok"] and want["ok"], (got.get("traceback"), want.get("traceback"))
    for key in ("flops_per_device", "bytes_per_device"):
        assert got[key] == pytest.approx(want[key], rel=1e-12), key
    assert got["collectives"] == pytest.approx(want["collectives"], rel=1e-12)
    assert got["memory"] == want["memory"]
