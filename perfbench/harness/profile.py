"""The traced sub-window: ``torch.profiler`` over a few steady units of work,
its chrome trace written under ``build/perfbench/`` and read back.

From the trace: the device's busy time (the union of kernel, copy and set
intervals inside the window), the window's length (the host clock between
its synchronised edges), each kernel's time and count, and the idle gaps
named by what the host was doing in them (the innermost host operation over
the gap, under the innermost span this benchmark recorded). Recording the
host's operations slows the host by some microseconds an operation, so in a
host-bound step the traced idle share is above the untraced one.
"""

from __future__ import annotations

import gzip
import json
import time
from collections import defaultdict
from contextlib import contextmanager, nullcontext
from pathlib import Path
from typing import Any, Dict, List, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation")
WINDOW = "perfbench.window"


def span(name: str, on: bool):
    """A named host span in the trace (nothing when not tracing)."""
    if not on:
        return nullcontext()
    import torch
    return torch.profiler.record_function(name)


class Tracer:
    def __init__(self, path: Path, cuda: bool = True):
        import torch
        from torch.profiler import ProfilerActivity, profile
        self.torch, self.path, self.cuda = torch, path, cuda
        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
        self.prof = profile(activities=acts)
        self.rf = None
        self.host_s = 0.0

    def sync(self):
        if self.cuda:
            self.torch.cuda.synchronize()

    def start(self):
        self.sync()
        self.prof.start()
        self.rf = self.torch.profiler.record_function(WINDOW)
        self.rf.__enter__()
        self.t0 = time.perf_counter()

    def stop(self):
        self.sync()
        self.host_s = time.perf_counter() - self.t0
        self.rf.__exit__(None, None, None)
        self.prof.stop()

    @contextmanager
    def window(self):
        self.start()
        try:
            yield self
        finally:
            self.stop()

    def read(self) -> Dict[str, Any]:
        self.path.parent.mkdir(parents=True, exist_ok=True)
        raw = self.path.with_suffix(".tmp.json")
        self.prof.export_chrome_trace(str(raw))
        with open(raw) as f:
            events = json.load(f)["traceEvents"]
        with gzip.open(self.path, "wt") as f:      # the kept trace, compressed
            json.dump({"traceEvents": events}, f)
        raw.unlink()
        return summarize(events, self.host_s)


def _union(iv: List[Tuple[float, float]]) -> Tuple[float, List[Tuple[float, float]]]:
    """Total covered length and the gaps between the merged intervals."""
    total, gaps, cur = 0.0, [], None
    for a, b in sorted(iv):
        if cur is None:
            cur = [a, b]
        elif a > cur[1]:
            total += cur[1] - cur[0]
            gaps.append((cur[1], a))
            cur = [a, b]
        else:
            cur[1] = max(cur[1], b)
    if cur is not None:
        total += cur[1] - cur[0]
    return total, gaps


def summarize(events: List[Dict[str, Any]], host_s: float) -> Dict[str, Any]:
    """Busy time, kernels and named idle gaps of one traced sub-window of
    ``host_s`` seconds; device intervals are clipped to the window's span."""
    win = [e for e in events if e.get("name") == WINDOW and e.get("cat") in HOST_CATS]
    if not win:
        return {}
    w0, w1 = win[0]["ts"], win[0]["ts"] + win[0]["dur"]
    dev, kernels = [], []
    for e in events:
        if e.get("cat") in DEVICE_CATS and e.get("ph") == "X":
            a, b = max(e["ts"], w0), min(e["ts"] + e["dur"], w1)
            if b > a:
                dev.append((a, b))
                if e["cat"] == "kernel":
                    kernels.append((e["name"], b - a))
    busy_us, gaps = _union(dev)
    by_name: Dict[str, List[float]] = defaultdict(lambda: [0.0, 0])
    for name, us in kernels:
        by_name[name][0] += us
        by_name[name][1] += 1
    if dev:             # the window's edges before the first and after the last
        first, last = min(a for a, _ in dev), max(b for _, b in dev)
        gaps = [(w0, first)] + gaps + [(last, w1)]
    return {"window_s": host_s, "busy_s": busy_us / 1e6,
            "kernels": {k: {"s": v[0] / 1e6, "count": v[1]} for k, v in by_name.items()},
            "launches": len(kernels),
            "idle": _name_gaps(events, gaps, win[0].get("tid"))}


def _name_gaps(events, gaps, tid) -> Dict[str, float]:
    """Seconds of device idle by what the host thread that ran the window
    was doing: ``<innermost benchmark span>: <innermost host op>``."""
    host = sorted((e["ts"], e["ts"] + e["dur"], e["name"], e["cat"]) for e in events
                  if e.get("cat") in HOST_CATS and e.get("ph") == "X" and e.get("tid") == tid)
    out: Dict[str, float] = defaultdict(float)
    stack: List[tuple] = []
    hi = 0
    for a, b in sorted(g for g in gaps if g[1] > g[0]):
        mid = 0.5 * (a + b)
        while hi < len(host) and host[hi][0] <= mid:
            while stack and stack[-1][1] < host[hi][0]:
                stack.pop()
            stack.append(host[hi])
            hi += 1
        while stack and stack[-1][1] < mid:
            stack.pop()
        inner = [s for s in stack if s[1] >= mid]
        spans = [s[2] for s in inner if s[3] == "user_annotation" and s[2] != WINDOW]
        ops = [s[2] for s in inner if s[3] == "cpu_op"]
        name = f"{spans[-1] if spans else 'between spans'}: {ops[-1] if ops else 'python'}"
        out[name] += (b - a) / 1e6
    return dict(out)


def breakdown(summary: Dict[str, Any], top: int = 10) -> Dict[str, list]:
    ops = sorted(summary["kernels"].items(), key=lambda kv: -kv[1]["s"])[:top]
    idle = sorted(summary["idle"].items(), key=lambda kv: -kv[1])[:top]
    return {"device_ops": [[k, v["s"]] for k, v in ops], "idle_gaps": [[k, v] for k, v in idle]}


def kernel_s(summary: Dict[str, Any], part: str) -> Tuple[float, int]:
    """Seconds and launches of the kernels whose name holds ``part``."""
    hits = [v for k, v in summary.get("kernels", {}).items() if part in k]
    return sum(v["s"] for v in hits), sum(v["count"] for v in hits)
