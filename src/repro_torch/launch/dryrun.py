"""Multi-device dry-run and roofline extraction: the port of
``repro/launch/dryrun.py``.

For every (architecture x input shape x mesh) this builds the real step
(train_step for train shapes, prefill / decode with the fused ProD head for
the others, ``launch/workload.py``) on the production mesh and traces rank
0's program with ``make_fx`` on fake tensors (no allocation,
``launch/graph_analysis.py``), then records:

* the per-device argument bytes, exact: the ``shard_shape`` bytes of every
  parameter, optimizer state, cache and batch leaf under its resolved spec
  (``temp_bytes`` is null: nothing is compiled, so there is no buffer
  assignment to read);
* per-device FLOPs and HBM bytes, and the expert-parallel region's
  collective bytes;

and derives the three roofline terms on the H100 (``launch/mesh.py``).

**Depth by trip count.** Python loops unroll into the traced graph, so a
full-depth train step is some 10^4 nodes a layer (minutes each at 60
layers). The layers of a segment's repeated block are identical, so the
step is traced at one and at two repeated blocks (each stack of an
encoder-decoder in turn) and the totals taken as ``t1 + (n - 1) (t2 -
t1)``: the counterpart of the reference's weighting of a layer scan's body
by its ``known_trip_count``. ``run_one(..., full_depth=True)`` traces the
whole model instead; the tests hold the two equal.

The mesh lives in a fake process group of its size (256 or 512 ranks,
``torch.testing._internal.distributed.fake_pg``), opened by this process
before anything else: the counterpart of the reference's
``--xla_force_host_platform_device_count=512``. Its collectives are
recorded, not run.

**An ideal split, not GSPMD's.** The port has no automatic partitioner, so
rank 0's program is the whole model except in the MoE's expert-parallel
region, the only part that is a real per-rank program (``models/moe.py``).
The dense layers are accounted as an ideal split over the chips: the traced
totals outside the ``expert_parallel`` scope divided by the chips, plus the
totals inside it, which are already one rank's. The reference's numbers
include GSPMD's replication and its tensor-parallel collectives; these do
not. Usage:

    PYTHONPATH=src python -m repro_torch.launch.dryrun [--arch llama3-8b]
        [--shape decode_32k] [--mesh pod|multipod|both] [--variant baseline]
        [--out-dir build/dryrun] [--force]
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import time
import traceback

import numpy as np

from repro_torch.common.config import INPUT_SHAPES, get_input_shape
from repro_torch.common.sharding import map_axes, shard_shape
from repro_torch.configs import ASSIGNED_ARCHS, get_config
from repro_torch.launch import graph_analysis
from repro_torch.launch.mesh import (HBM_BW, HBM_BYTES, NVLINK_BW, PEAK_FLOPS_BF16,
                                     make_production_mesh, n_chips)
from repro_torch.launch.workload import VARIANTS, build_steps
from repro_torch.models.transformer import layer_plan

_MESHES = {}


def open_fake_group(world: int) -> None:
    """Make the default process group a fake one of ``world`` ranks, this
    process rank 0 (replacing another fake group of another size)."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        if dist.get_backend() == "fake" and dist.get_world_size() == world:
            return
        if dist.get_backend() != "fake":
            raise RuntimeError("the dry-run needs a process of its own: a real "
                               f"{dist.get_backend()} group is open here")
        dist.destroy_process_group()
        _MESHES.clear()
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world)


def production_mesh(multi_pod: bool):
    """The production mesh over a fake group of its size."""
    open_fake_group(512 if multi_pod else 256)
    if multi_pod not in _MESHES:
        _MESHES[multi_pod] = make_production_mesh(multi_pod=multi_pod)
    return _MESHES[multi_pod]


def model_flops(cfg, shape) -> float:
    """Analytic MODEL_FLOPS: 6·N_active·D (train) or 2·N_active·D (inference);
    D = global tokens processed by the step."""
    n_active = cfg.active_param_count()
    if shape.kind == "train":
        return 6.0 * n_active * shape.global_batch * shape.seq_len
    if shape.kind == "prefill":
        return 2.0 * n_active * shape.global_batch * shape.seq_len
    return 2.0 * n_active * shape.global_batch  # decode: 1 token/request


def argument_bytes(built, mesh) -> int:
    """Per-device bytes of the step's arguments under their specs."""
    total = [0]

    def one(_axes, t, spec):
        total[0] += int(np.prod(shard_shape(t.shape, spec, mesh))) * t.dtype.itemsize

    for axes, specs, pspecs in zip(built["arg_axes"], built["arg_specs"], built["arg_pspecs"]):
        map_axes(one, axes, specs, pspecs)
    return total[0]


def _depth_traces(cfg):
    """[(coefficient, config)]: the configs to trace, the model's totals
    being the sum of their totals times the coefficients (module
    docstring). An encoder-decoder's stacks are the encoder's and the
    decoder's layers; another model's is its first segment's blocks, a
    block being ``unit`` layers (Gemma3's local:global group, the hybrid's
    SSM layers between shared blocks), the rest of its layers kept."""
    if cfg.family == "encdec":
        E, D = cfg.n_encoder_layers, cfg.n_layers
        at = lambda e, d: cfg.with_overrides(n_encoder_layers=e, n_layers=d)
        return [(1 - (E - 1) - (D - 1), at(1, 1)), (E - 1, at(2, 1)), (D - 1, at(1, 2))]
    n = layer_plan(cfg)[0].n_blocks
    unit = (cfg.local_global_ratio + 1 if cfg.local_global_ratio else
            max(cfg.attn_every, 1) if cfg.family == "hybrid" else 1)
    rest = cfg.n_layers - unit * n
    at = lambda b: cfg.with_overrides(n_layers=unit * b + rest)
    return [(2 - n, at(1)), (n - 1, at(2))]


def _traced_stats(base_cfg, shape, mesh, variant: str, full_depth: bool):
    """The step's totals (graph_analysis.GraphStats) and the traced nodes."""
    parts = [(1, base_cfg)] if full_depth else _depth_traces(base_cfg)
    total, nodes = graph_analysis.GraphStats(), 0
    total.expert_parallel = graph_analysis.GraphStats()
    for coef, cfg in parts:
        if not coef:
            continue
        built = build_steps(cfg, shape, mesh=mesh, variant=variant)
        gm = graph_analysis.trace(built["step"], *built["arg_specs"])
        nodes += len(gm.graph.nodes)
        st = graph_analysis.analyze(gm)
        del gm, built
        for dst, src in ((total, st), (total.expert_parallel, st.expert_parallel)):
            dst.flops += coef * src.flops
            dst.hbm_bytes += coef * src.hbm_bytes
            for k in dst.coll_bytes:
                dst.coll_bytes[k] += coef * src.coll_bytes[k]
                dst.coll_counts[k] += coef * src.coll_counts[k]
    return total, nodes


def run_one(arch: str, shape_name: str, multi_pod: bool, variant: str = "baseline",
            cfg=None, shape=None, mesh=None, full_depth: bool = False) -> dict:
    """One combination on the production mesh; ``cfg``, ``shape`` and
    ``mesh`` (a mesh over an open group) replace the registry's arch, shape
    and mesh where given (the tests' reduced cases)."""
    shape = shape or get_input_shape(shape_name)
    base_cfg = cfg or get_config(arch)
    mesh_name = "multipod" if multi_pod else "pod"
    if mesh is None:
        mesh = production_mesh(multi_pod)
    else:
        mesh_name = "x".join(str(mesh.shape[a]) for a in mesh.axis_names)
    chips = n_chips(mesh)
    t0 = time.time()
    result = dict(arch=arch, shape=shape.name, mesh=mesh_name, chips=chips, variant=variant,
                  ok=False)
    try:
        built = build_steps(base_cfg, shape, mesh=mesh, variant=variant)
        cfg = built["cfg"]
        stats, n_nodes = _traced_stats(base_cfg, shape, mesh, variant, full_depth)
        t_trace = time.time() - t0
        ep = stats.expert_parallel
        flops_dev = (stats.flops - ep.flops) / chips + ep.flops
        bytes_dev = (stats.hbm_bytes - ep.hbm_bytes) / chips + ep.hbm_bytes
        mem = {"argument_bytes": argument_bytes(built, mesh), "output_bytes": None,
               "temp_bytes": None, "peak_bytes": None}
        mf = model_flops(cfg, shape)
        terms = {"compute_s": flops_dev / PEAK_FLOPS_BF16, "memory_s": bytes_dev / HBM_BW,
                 "collective_s": ep.total_coll_bytes / NVLINK_BW}
        result.update(
            ok=True, lower_s=round(t_trace, 1), graph_nodes=n_nodes, full_depth=full_depth,
            flops_per_device=flops_dev, bytes_per_device=bytes_dev,
            collectives=stats.as_dict(), expert_parallel=ep.as_dict(), memory=mem,
            hbm_ok=bool(mem["argument_bytes"] <= HBM_BYTES),
            roofline={**terms, "dominant": max(terms, key=terms.get), "model_flops": mf,
                      "useful_flops_ratio": mf / max(flops_dev * chips, 1.0)},
            attn_variant=("window" if cfg.attn_window and not base_cfg.attn_window
                          else "native"),
            head_padding={
                "n_heads": [base_cfg.n_heads, cfg.n_heads],
                "n_kv_heads": [base_cfg.n_kv_heads, cfg.n_kv_heads],
                "ssm_heads": ([base_cfg.ssm_n_heads, cfg.ssm_n_heads]
                              if cfg.family in ("ssm", "hybrid") else None),
            },
        )
    except Exception as e:
        result["error"] = f"{type(e).__name__}: {e}"
        result["traceback"] = traceback.format_exc()[-2000:]
    result["total_s"] = round(time.time() - t0, 1)
    return result


def main(argv=None):
    ap = argparse.ArgumentParser(description="multi-device dry-run")
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None, choices=[s.name for s in INPUT_SHAPES] + [None])
    ap.add_argument("--mesh", default="pod", choices=["pod", "multipod", "both"])
    ap.add_argument("--out-dir", default="build/dryrun")
    ap.add_argument("--variant", default="baseline", choices=sorted(VARIANTS))
    ap.add_argument("--force", action="store_true")
    args = ap.parse_args(argv)

    archs = [args.arch] if args.arch else ASSIGNED_ARCHS
    shapes = [args.shape] if args.shape else [s.name for s in INPUT_SHAPES]
    meshes = [args.mesh] if args.mesh != "both" else ["pod", "multipod"]
    os.makedirs(args.out_dir, exist_ok=True)
    results = []
    for mesh_kind in meshes:
        for arch in archs:
            for shape in shapes:
                tag = f"{arch}_{shape}_{mesh_kind}".replace("/", "-")
                if args.variant != "baseline":
                    tag += f"_{args.variant}"
                path = os.path.join(args.out_dir, tag + ".json")
                if os.path.exists(path) and not args.force:
                    print(f"skip (exists): {tag}")
                    continue
                print(f"=== {tag} ===", flush=True)
                res = run_one(arch, shape, multi_pod=(mesh_kind == "multipod"),
                              variant=args.variant)
                with open(path, "w") as f:
                    json.dump(res, f, indent=1, default=float)
                status = "OK" if res["ok"] else f"FAIL: {res.get('error')}"
                rt = res.get("roofline", {})
                print(f"  -> {status}  trace={res.get('lower_s')}s "
                      f"dominant={rt.get('dominant')} "
                      f"terms={ {k: f'{v:.2e}' for k, v in rt.items() if k.endswith('_s')} }",
                      flush=True)
                results.append(res)
                gc.collect()
    return results


if __name__ == "__main__":
    main()
