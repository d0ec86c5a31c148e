"""The program's own spans in a traced run's kept chrome trace.

The port records ``record_function`` ranges at its layer boundaries while
the profiler records (``src/repro_torch/common/scopes.py``: ``engine.*``,
``model.*``, ``moe.*``, ``head.*``), on the clock of the device's kernels and
copies. From the trace kept at ``run.trace["path"]`` this gives each
program span's intervals, the device time launched inside each span, and
the device idle inside a span; and the share of the MoE layers' routed pairs
that their capacity dispatch dropped, from the program's counters. A device event belongs to the
innermost program span around its launch: the host launch event (category
``cuda_runtime``, or ``cuda_driver`` for cuBLAS's ``cuLaunchKernelEx``) with
the event's ``args.correlation``. The benchmark's own spans
(``perfbench.*``) are not the program's and are left out.

A trace without program spans (a program that records none) or without
device events (a run on the CPU) gives empty results, and the metrics that
read them report nothing.
"""

from __future__ import annotations

import functools
import gzip
import json
import os
from collections import defaultdict
from typing import Any, Dict, List, Optional, Tuple

from harness import profile

SPAN_CAT = "user_annotation"
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
BENCH_PREFIX = "perfbench."

Interval = Tuple[float, float]


class Trace:
    """The program spans, device events and launches of one chrome trace
    (times in microseconds, as the trace has them)."""

    def __init__(self, events: List[Dict[str, Any]]):
        self.spans: List[Tuple[float, float, str, Any]] = []      # (start, end, name, tid)
        self.device: List[Tuple[float, float, Any]] = []          # (start, end, correlation)
        self.launches: Dict[Any, Tuple[float, Any]] = {}          # correlation -> (ts, tid)
        for e in events:
            if e.get("ph") != "X":
                continue
            cat = e.get("cat")
            if cat == SPAN_CAT:
                if e["name"] != profile.WINDOW and not e["name"].startswith(BENCH_PREFIX):
                    self.spans.append((e["ts"], e["ts"] + e["dur"], e["name"], e.get("tid")))
            elif cat in profile.DEVICE_CATS:
                self.device.append((e["ts"], e["ts"] + e["dur"],
                                    e.get("args", {}).get("correlation")))
            elif cat in LAUNCH_CATS:
                corr = e.get("args", {}).get("correlation")
                if corr is not None:
                    self.launches[corr] = (e["ts"], e.get("tid"))
        self.spans.sort(key=lambda s: (s[0], -s[1]))

    def intervals(self, name: str) -> List[Interval]:
        return [(a, b) for a, b, n, _ in self.spans if n == name]

    def device_s_by_span(self) -> Dict[str, float]:
        """Device seconds of the kernels, copies and sets launched inside
        each program span (its innermost), by span name."""
        launched = sorted(self.launches[corr] + (b - a,) for a, b, corr in self.device
                          if corr in self.launches)          # (ts, tid, us)
        out: Dict[str, float] = defaultdict(float)
        for (_, _, us), span in zip(launched, self._innermost(launched)):
            if span is not None:
                out[span] += us / 1e6
        return dict(out)

    def idle_inside(self, name: str) -> float:
        """Seconds of ``name``'s intervals in which no device event ran."""
        total = 0.0
        for s0, s1 in self.intervals(name):
            covered, _ = profile._union([(max(a, s0), min(b, s1)) for a, b, _ in self.device
                                         if a < s1 and b > s0])
            total += (s1 - s0) - covered
        return total / 1e6

    def _innermost(self, points: List[tuple]) -> List[Optional[str]]:
        """The innermost program span on the same thread around each of
        ``points`` ((ts, tid, ...), sorted by ts); spans of a thread nest."""
        by_tid: Dict[Any, list] = defaultdict(list)
        for s in self.spans:
            by_tid[s[3]].append(s)
        nxt: Dict[Any, int] = defaultdict(int)
        stacks: Dict[Any, list] = defaultdict(list)
        out: List[Optional[str]] = []
        for ts, tid, *_ in points:
            spans, stack = by_tid.get(tid, ()), stacks[tid]
            i = nxt[tid]
            while i < len(spans) and spans[i][0] <= ts:
                while stack and stack[-1][1] < spans[i][0]:
                    stack.pop()
                stack.append(spans[i])
                i += 1
            nxt[tid] = i
            while stack and stack[-1][1] < ts:
                stack.pop()
            out.append(stack[-1][2] if stack else None)
        return out


@functools.lru_cache(maxsize=1)
def _load(path: str, mtime_ns: int, size: int) -> Trace:
    with gzip.open(path, "rt") as f:
        return Trace(json.load(f)["traceEvents"])


def load(run) -> Optional[Trace]:
    """The program spans of the run's kept trace (read once a run), or None
    for a run without one."""
    path = (run.trace or {}).get("path")
    if not path or not os.path.exists(path):
        return None
    st = os.stat(path)
    return _load(path, st.st_mtime_ns, st.st_size)


def moe_drop_share(run, kind: str) -> Optional[float]:
    """``moe.dropped`` / ``moe.pairs`` of the program's counters over a
    ``kind`` run's traced sub-window, the only time they count; None where
    no MoE layer counted, or the program has no counters."""
    if run.kind != kind or not run.trace:
        return None
    from repro_torch.common import scopes
    counters = getattr(scopes, "counters", None)        # a program without counters
    c = counters() if counters else {}
    if not c.get("moe.pairs"):
        return None
    return c.get("moe.dropped", 0) / c["moe.pairs"]
