"""Paths, the registry of named pieces, the chip's peaks and the run's output.

Everything a cell needs is found by name: ``BENCHMARK.json`` at the root of
the checkout names each workload's configuration and traffic mix, and each
metric; the harness then reads

* ``perfbench/configs/<config>.json``  the configuration as it is run,
* ``perfbench/traffic/<traffic>.json`` the traffic mix's parameters,
* ``perfbench/metrics/<metric>.py``    the metric's reader, ``read(run)``,
* ``perfbench/limits/<workload>.json`` the limits of the output check.

A later change adds a configuration, a mix, a metric or a cell by adding
files and entries; no file of the harness names one.
"""

from __future__ import annotations

import importlib.util
import json
import os
import subprocess
import sys
from pathlib import Path
from typing import Any, Callable, Dict, Optional

BENCH_DIR = Path(__file__).resolve().parents[1]          # perfbench/
ROOT = BENCH_DIR.parent                                  # the checkout
SRC = ROOT / "src"
BUILD = ROOT / "build" / "perfbench"                     # git-ignored

# NVIDIA H100 SXM, data sheet, dense rates at the 700 W limit
PEAKS = {"bf16_flops": 989e12, "fp32_flops": 67e12, "hbm_bytes_per_s": 3.35e12}

# modules that may not be loaded in the process that prints a result,
# compared by whole top-level name: the JAX package of this repository is
# ``repro``, and its port ``repro_torch`` is a different name
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "repro")


def load_json(path: Path) -> Dict[str, Any]:
    with open(path) as f:
        return json.load(f)


def benchmark() -> Dict[str, Any]:
    return load_json(ROOT / "BENCHMARK.json")


def workload(name: str) -> Dict[str, Any]:
    for w in benchmark()["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def config(name: str) -> Dict[str, Any]:
    return load_json(BENCH_DIR / "configs" / f"{name}.json")


def traffic(name: str) -> Dict[str, Any]:
    return load_json(BENCH_DIR / "traffic" / f"{name}.json")


def limits(workload_name: str) -> Dict[str, float]:
    return load_json(BENCH_DIR / "limits" / f"{workload_name}.json")["limits"]


def metric_reader(name: str) -> Callable[[Any], Optional[float]]:
    """``read(run)`` of ``perfbench/metrics/<name>.py`` (the name may hold
    dots, so the file is loaded by its path)."""
    path = BENCH_DIR / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"perfbench_metric_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def metrics_for(workload_name: str, trace: bool):
    """The metric entries a run of this workload reports: its end-to-end
    metrics untraced, its per-layer metrics traced. An entry without a
    ``workloads`` key belongs to every workload."""
    b = benchmark()
    entries = b["per_layer"] if trace else b["end_to_end"]
    return [m for m in entries if workload_name in m.get("workloads", [workload_name])]


def use_checkout_caches() -> None:
    """Build and kernel caches inside the checkout, at fixed paths, so that
    only a checkout's first run builds. The port's kernels build into
    ``build/kernels`` by themselves (``kernels/_build.py``)."""
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"),
                     ("TORCHINDUCTOR_CACHE_DIR", "inductor")):
        os.environ[var] = str(ROOT / "build" / sub)
    os.environ.setdefault("USE_FLAX", "0")
    os.environ.setdefault("USE_JAX", "0")


def forbidden_loaded() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN_MODULES))


def card_info() -> Dict[str, str]:
    """The card's name and power limit as ``nvidia-smi`` reads them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
             "--format=csv,noheader"], capture_output=True, text=True, timeout=20)
        return {"nvidia_smi": out.stdout.strip() or out.stderr.strip()}
    except (OSError, subprocess.TimeoutExpired) as e:
        return {"nvidia_smi": f"not read ({e})"}


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)
