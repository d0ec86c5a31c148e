"""The benchmark of the port (``src/repro_torch``) on one or more CUDA cards.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

runs one cell of ``BENCHMARK.json`` from the root of a checkout and prints,
as the last line of standard output, one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics, or
with ``--trace 1`` its per-layer ones), ``device``, with ``--trace 1`` a
``breakdown``, and last ``checks``: each number of the output check beside
its limit, which are also the last lines of standard error. Earlier lines of
standard error give the set-up split, the card and its power limit, peak
memory, the MoE pairs dropped and the work completed.

It exits 2 without a result where the cell's cards are not there, 3 where a
JAX module was loaded, and 1 on any other failure.

``--limits-readings SEEDS`` (not a run of the benchmark): in one process, for
each seed, draws the weights and the inputs, runs the cell's load for as
many units as a run compares, and prints the output check's readings for the
program and, for the seeds also in ``--control SEEDS``, for the control.
"""

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent))
from harness import common  # noqa: E402

sys.path.insert(1, str(common.SRC))
common.use_checkout_caches()
from harness.common import log  # noqa: E402


def _seeds(text: str):
    return [int(s) for s in text.split(",") if s.strip()]


def parse(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--limits-readings", type=_seeds, default=None)
    ap.add_argument("--control", type=_seeds, default=())
    return ap.parse_args(argv)


def have_cards(chips: int) -> bool:
    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        log(f"perfbench: the cell needs {chips} CUDA card(s); "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} available")
        return False
    return True


def readings(cell, units, control=False):
    from harness import check
    return getattr(check, f"check_{cell.kind}")(cell, units, control=control)


def limits_readings(args) -> int:
    """Readings of the output check over many seeds in one process."""
    from harness.cells import Cell
    out_dir = common.ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    cell = Cell(args.workload, args.limits_readings[0], 0.0, False)
    cell.load_port()
    cell.min_units = cell.mix.get("check", {}).get("units", 1)
    for seed in args.limits_readings:
        cell.seed = seed
        cell.params = cell.head = cell.predictor = cell.engine = None
        gc.collect()
        cell.torch.cuda.empty_cache()
        cell.make_inputs()
        getattr(cell, f"_setup_{cell.kind}")()
        t = time.perf_counter()
        units = getattr(cell, f"window_{cell.kind}")()
        run_s = time.perf_counter() - t
        t = time.perf_counter()
        r = readings(cell, units, control=seed in args.control)
        line = {"workload": args.workload, "seed": seed, "units": len(units),
                "run_s": run_s, "check_s": time.perf_counter() - t, **r}
        print(json.dumps(line), flush=True)
        with open(out_dir / f"readings-{args.workload}.jsonl", "a") as f:
            f.write(json.dumps(line) + "\n")
        del units
    return 0


def execute(args, device: str = "cuda") -> dict:
    """Set-up, window, trace and check of one run; the result line's object."""
    import torch
    from harness import check, profile
    from harness.cells import Cell
    wl = common.workload(args.workload)
    cell = Cell(args.workload, args.seed, args.seconds, bool(args.trace), device)
    cell.setup()
    cell.setup_s = time.perf_counter() - T_PROCESS
    log("perfbench: set-up " + ", ".join(f"{k} {v:.3f}" for k, v in cell.split.items())
        + f"; setup_s {cell.setup_s:.3f}")
    run = cell.run()
    rows = sum(u.get("B", u.get("rows", 0)) for u in run.units)
    log(f"perfbench: peak memory {run.memory_peak_bytes} bytes; {len(run.units)} units, "
        f"{rows} rows")
    t = time.perf_counter()
    r = readings(cell, run.units)["program"]
    ok, checks = check.judge(r, common.limits(args.workload))
    log(f"perfbench: output check {time.perf_counter() - t:.3f} s; readings "
        + ", ".join(f"{k} {v!r}" for k, v in r.items()))
    metrics = {}
    for m in common.metrics_for(args.workload, bool(args.trace)):
        v = common.metric_reader(m["name"])(run)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    kind = torch.cuda.get_device_name(0) if cell.dev.type == "cuda" else "cpu"
    device = {"platform": "gpu" if cell.dev.type == "cuda" else "cpu", "kind": kind,
              "count": wl["chips"], "memory_peak_bytes": run.memory_peak_bytes}
    result = {"correct": bool(ok), "attempted": rows, "failed": 0, "metrics": metrics,
              "device": device}
    if run.trace:
        device.update({"busy_s": run.trace["busy_s"], "window_s": run.trace["window_s"]})
        result["breakdown"] = profile.breakdown(run.trace)
    result["checks"] = checks
    return result


def main(argv=None) -> int:
    args = parse(argv)
    wl = common.workload(args.workload)
    if not have_cards(wl["chips"]):
        return 2
    import torch
    torch.set_num_threads(2)
    log(f"perfbench: card {torch.cuda.get_device_name(0)}; {common.card_info()['nvidia_smi']}")
    if args.limits_readings:
        return limits_readings(args)
    result = execute(args)
    bad = common.forbidden_loaded()
    if bad:
        log(f"perfbench: modules that may not be loaded were loaded: {bad}")
        return 3
    for k, c in result["checks"].items():
        log(f"check {k}: {c['value']!r} limit {c['limit']!r}")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
