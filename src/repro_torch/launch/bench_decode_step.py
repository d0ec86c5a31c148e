"""Time the decode step of a served model on the card: the serve phases'
traffic (8 prompts of 256-512 tokens right-padded to 512, a cache of
512 + 64 positions, seeded random weights, bf16), then 5 blocks of 20
teacher-forced decode steps, each block timed between CUDA events, and the
kernels one step launches counted under ``torch.profiler``. Prints one JSON line with
the card's name and power limit beside the numbers.

    PYTHONPATH=src python src/repro_torch/launch/bench_decode_step.py --model llama3-8b

It calls only ``build_model``, ``Model.init``, ``prefill``, ``decode_cache``
and ``decode_step``, so it also times another checkout of the package: point
``PYTHONPATH`` at that checkout's ``src`` and run this file by its path.
Two versions compare only when run on one machine in one go, in the order
A, B, B, A.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys

import numpy as np
import torch

from repro_torch.common.device import resolve_device
from repro_torch.configs import get_config
from repro_torch.models.model_zoo import build_model


B, SP, MAX_NEW = 8, 512, 64
BLOCKS, STEPS = 5, 20


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--model", default="llama3-8b")
    ap.add_argument("--label", default="", help="printed beside the numbers")
    return ap.parse_args(argv)


def kernels_per_step(step) -> int:
    """CUDA kernels one call of ``step`` launches (torch.profiler)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        step()
        torch.cuda.synchronize()
    return sum(e.count for e in prof.key_averages() if e.device_type == DeviceType.CUDA)


def main(argv=None) -> dict:
    args = parse_args(argv)
    dev = resolve_device("cuda")
    cfg = get_config(args.model)
    model = build_model(cfg)
    params = model.init(seed=0, device=dev)
    rng = np.random.default_rng(0)
    plens = rng.integers(256, SP + 1, size=B)
    plens[0] = SP
    prompts = np.zeros((B, SP), np.int64)
    for i, n in enumerate(plens):
        prompts[i, :n] = rng.integers(3, cfg.vocab_size, size=n)
    tokens = torch.as_tensor(prompts, device=dev)
    lens = torch.as_tensor(plens, dtype=torch.int32, device=dev)
    valid = torch.arange(SP, device=dev)[None, :] < lens[:, None]
    nxt = torch.full((B,), 5, dtype=torch.long, device=dev)
    with torch.no_grad():
        _, _, pcache = model.prefill(params, tokens, attn_valid=valid, logits_mode="none")
        cache = model.decode_cache(pcache, SP + MAX_NEW)
        del pcache
        pos = [lens]
        for _ in range(MAX_NEW):
            pos.append(pos[-1] + 1)
        n = [0]

        def step():              # positions advance, and wrap inside the cache
            i = n[0] % MAX_NEW
            n[0] += 1
            model.decode_step(params, nxt, cache, pos[i], pos[i + 1])

        for _ in range(3):
            step()
        launches = kernels_per_step(step)
        block_ms = []
        for _ in range(BLOCKS):
            torch.cuda.synchronize()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(STEPS):
                step()
            end.record()
            end.synchronize()
            block_ms.append(start.elapsed_time(end) / STEPS)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    out = {"label": args.label, "model": args.model, "batch": B, "cache_len": SP + MAX_NEW,
           "step_ms_median": float(np.median(block_ms)), "step_ms_blocks": block_ms,
           "kernels_per_step": launches, "card": smi.splitlines()[0] if smi else None}
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main(sys.argv[1:])
