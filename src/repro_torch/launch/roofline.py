"""Roofline report: the twin of the reference's ``benchmarks/roofline.py``,
over the port's dry-run JSON (``launch/dryrun.py``, ``build/dryrun/``): the
per-(arch x shape) three-term table on the H100 with its dominant term, the
MODEL_FLOPS ratio, whether the arguments fit in HBM, and a one-line note of
what would move the dominant term. The dense layers' terms are an ideal
split over the chips (``launch/dryrun.py``). Usage:

    PYTHONPATH=src python -m repro_torch.launch.roofline [--dir build/dryrun]
"""

from __future__ import annotations

import argparse
import glob
import json
import os
from typing import List

NOTES = {
    ("compute_s", "train"): "more chips / lower-precision matmuls / drop remat recompute",
    ("compute_s", "prefill"): "causal block-skip halves masked-out attention FLOPs",
    ("compute_s", "decode"): "batch more requests per step",
    ("memory_s", "train"): "fuse optimizer update; shard activations over seq",
    ("memory_s", "prefill"): "keep KV in bf16; larger flash tiles",
    ("memory_s", "decode"): "quantize KV cache (int8) halves the dominant cache reads",
    ("collective_s", "train"): "overlap the expert all-gathers with compute; "
                               "reduce-scatter + all-gather (seq-parallel)",
    ("collective_s", "prefill"): "same as train; shard seq dim for norm regions",
    ("collective_s", "decode"): "all-to-all token dispatch instead of expert-weight "
                                "gathering (MoE partial mode)",
}

DEFAULT_DIR = "build/dryrun"


def load(results_dir: str = DEFAULT_DIR, mesh: str = "pod", variant=None) -> List[dict]:
    rows = []
    for f in sorted(glob.glob(os.path.join(results_dir, f"*_{mesh}*.json"))):
        with open(f) as fh:
            r = json.load(fh)
        if r.get("mesh") != mesh:
            continue
        if variant is not None and r.get("variant", "baseline") != variant:
            continue
        rows.append(r)
    return rows


def kind_of(shape: str) -> str:
    return {"train_4k": "train", "prefill_32k": "prefill"}.get(shape, "decode")


def table(rows: List[dict]) -> str:
    hdr = (f"{'arch':22s} {'shape':12s} {'var':9s} {'compute_s':>10s} {'memory_s':>10s} "
           f"{'collect_s':>10s} {'dominant':>12s} {'useful':>7s} {'fits':>5s}")
    lines = [hdr, "-" * len(hdr)]
    for r in rows:
        if not r.get("ok"):
            lines.append(f"{r['arch']:22s} {r['shape']:12s} FAILED: {r.get('error', '')[:60]}")
            continue
        rf = r["roofline"]
        lines.append(
            f"{r['arch']:22s} {r['shape']:12s} {r.get('variant', 'base')[:9]:9s} "
            f"{rf['compute_s']:10.3e} {rf['memory_s']:10.3e} "
            f"{rf['collective_s']:10.3e} {rf['dominant']:>12s} "
            f"{rf['useful_flops_ratio']:7.3f} {str(r.get('hbm_ok'))[:5]:>5s}")
    return "\n".join(lines)


def notes(rows: List[dict]) -> List[str]:
    out = []
    for r in rows:
        if not r.get("ok"):
            continue
        rf = r["roofline"]
        key = (rf["dominant"], kind_of(r["shape"]))
        out.append(f"{r['arch']} × {r['shape']}: {rf['dominant'].replace('_s', '')}"
                   f"-bound — {NOTES.get(key, 'see PERF.md')}")
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description="roofline table of the dry-run's results")
    ap.add_argument("--dir", default=DEFAULT_DIR)
    args = ap.parse_args(argv)
    rows = load(args.dir)
    print(table(rows))
    ok = [r for r in rows if r.get("ok")]
    print(f"\n{len(ok)}/{len(rows)} combinations traced on the 16x16 pod mesh")
    if ok:
        worst = min(ok, key=lambda r: r["roofline"]["useful_flops_ratio"]
                    if r["shape"] == "train_4k" else 1e9)
        print(f"worst train useful-FLOPs ratio: {worst['arch']} "
              f"({worst['roofline']['useful_flops_ratio']:.3f})")
    return rows


if __name__ == "__main__":
    main()
