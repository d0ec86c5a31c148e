"""Serving telemetry: per-request event tracing, time-series gauges, and
exporters (Chrome/Perfetto timeline, Prometheus text, JSON summary).

The end-of-run aggregates (``ServeStats``/``ClusterStats``) summarize a run
to scalars, which is exactly what heavy-tailed workloads punish: a p99
regression, a coverage erosion under drift, or a preemption cascade are only
diagnosable from *when* things happened. The :class:`Tracer` is the
answer — an optional observer threaded through the serving stack via the
``tracer=`` seam on :class:`~repro.serving.engine.SimEngine`,
:class:`~repro.serving.cluster.Cluster`,
:class:`~repro.serving.adaptation.AdmissionController`,
:class:`~repro.serving.adaptation.OnlineAdapter`, and
:class:`~repro.serving.predictor.PredictorService`.

Design constraints (tested in ``tests/test_telemetry.py``):

* ``tracer=None`` is **bit-identical** to a tracer-less build — every hook
  is an ``if tracer is not None`` branch that reads state without mutating
  any simulation arithmetic (golden-pinned engine + cluster rows).
* Trace-on emits **identical event streams** from the per-slot reference
  decode path and the vectorized event-leap path. Ticks inside a leap are
  provably eventless except for first tokens, which the leap synthesizes
  from canonicalized slot state at the leap boundary (the same
  ``t + 1.0`` timestamp the per-tick loop would assign); gauge sampling
  ticks are *evented* (``ticks_to_event`` caps at the next sample tick,
  like refine ticks), so both paths sample the same state at the same
  ticks. Raw buffer order can differ across paths (a leap emits future
  first tokens early), so stream equality is defined over
  :meth:`Tracer.canonical` — a total order on
  ``(t, replica, rid, kind, data)``.

Event schema — ``TraceEvent(t, replica, rid, kind, data)`` with ``data`` a
sorted tuple of ``(key, value)`` pairs (see ``docs/observability.md`` for
the full field tables):

========== ============================================================
kind        emitted when
========== ============================================================
arrival     a request enters the system (cluster dispatch / engine run)
routed      the router picked a replica (``to``)
admission   the admission controller evaluated a request (``ok``, ``eta``)
rejected    admission declined it (terminal)
refine      a posterior refresh touched an active slot (``action``)
held_release a queued keep-mode holder's pages were sacrificed
admitted    a slot started (``grant`` tokens, ``pf`` ticks/tokens,
            ``resumed`` flag)
prefill_chunk a budget-mode prefill chunk was consumed (``take``, ``left``)
first_token the slot emitted its first token
oom_evict   the stall breaker recompute-preempted a slot
preempted   SRTF preemption (``kept`` tokens, ``mode``)
stolen      a rebalance migrated a queued request (``frm``, ``to``,
            ``pages``, ``delay``)
refresh     the online adapter hot-swapped head weights
predict     the predictor service scored one dispatch window (``n``,
            ``hits``, ``scored``)
finish      the request completed (``gen``, ``slo_ok``) — terminal
timeout     its deadline expired while queued — terminal
dropped     it proved unservable — terminal
========== ============================================================

Conservation invariant: every submitted request's stream is well-ordered
(arrival <= routed <= admitted <= first_token <= finish) and ends in exactly
one terminal kind, with ``submitted == finish + timeout + rejected +
dropped`` (:meth:`Tracer.terminal_counts`).

This module also owns the shared percentile summarization
(:func:`latency_summary` / :func:`ttft_summary` / :func:`goodput`) that
``engine.py`` and ``cluster.py`` both delegate to — one implementation, one
set of column names.

The port's own copy of ``repro.serving.telemetry`` (NumPy only), kept line
for line so that the same trace gives the same results bit for bit.
"""

from __future__ import annotations

import json
from collections import Counter, OrderedDict, deque
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np

__all__ = [
    "TraceEvent", "Tracer", "EVENT_KINDS", "TERMINAL_KINDS",
    "latency_summary", "ttft_summary", "goodput", "percentile_summary",
]


# ---------------------------------------------------------------------------
# shared percentile summarization (the one implementation ServeStats and
# ClusterStats both use — see tests/test_telemetry.py::TestSharedSummaries)
# ---------------------------------------------------------------------------

_PCTS = ((0.5, "p50"), (0.9, "p90"), (0.99, "p99"))


def percentile_summary(values: Sequence[float], prefix: str) -> dict:
    """``{mean_<prefix>, p50_<prefix>, p90_<prefix>, p99_<prefix>}`` over
    ``values`` — all ``inf`` when empty (no sample ≠ zero)."""
    arr = np.array(list(values), float)
    if arr.size == 0:
        inf = float("inf")
        return {f"mean_{prefix}": inf,
                **{f"{name}_{prefix}": inf for _, name in _PCTS}}
    out = {f"mean_{prefix}": float(arr.mean())}
    for q, name in _PCTS:
        out[f"{name}_{prefix}"] = float(np.quantile(arr, q))
    return out


def latency_summary(done: Sequence) -> dict:
    """End-to-end latency percentiles + mean queueing wait over completed
    requests (``inf`` when none completed)."""
    out = percentile_summary([r.latency for r in done], "latency")
    if done:
        out["mean_wait"] = float(np.array([r.wait for r in done]).mean())
    else:
        out["mean_wait"] = float("inf")
    return out


def ttft_summary(done: Sequence) -> dict:
    """Time-to-first-token percentiles over completed requests that emitted
    at least one token (degenerate zero-length requests carry no sample)."""
    return percentile_summary([r.t_first_token - r.arrival for r in done
                               if r.t_first_token is not None], "ttft")


def goodput(done: Sequence, makespan: float) -> float:
    """Within-SLO completed tokens per step."""
    toks = sum(r.true_len for r in done if r.slo_met)
    return toks / max(makespan, 1.0)


# ---------------------------------------------------------------------------
# events
# ---------------------------------------------------------------------------


class TraceEvent(NamedTuple):
    t: float
    replica: int
    rid: int
    kind: str
    data: tuple     # sorted (key, value) pairs — hashable, order-comparable


# Lifecycle rank: the canonical within-(t, replica, rid) order. Only ranks
# that can collide on one tick for one request matter (e.g. first_token
# before finish, refine before first_token, held_release before a same-tick
# re-admission); the rest just make the total order stable.
EVENT_KINDS = ("arrival", "routed", "admission", "rejected", "refine",
               "held_release", "admitted", "prefill_chunk", "first_token",
               "oom_evict", "preempted", "stolen", "refresh", "predict",
               "finish", "timeout", "dropped")
_RANK = {k: i for i, k in enumerate(EVENT_KINDS)}

TERMINAL_KINDS = ("finish", "timeout", "rejected", "dropped")


class Tracer:
    """Structured serving telemetry: a bounded event ring + periodic gauges.

    Parameters
    ----------
    capacity : ring-buffer size in events; older events are evicted FIFO
        (``emitted`` keeps the true total, so overflow is never silent).
    sample_every : record time-series gauges every ``k`` ticks (0 disables
        sampling; events are always recorded). Sampling ticks become
        *evented* in the vectorized engine so both decode paths sample
        identical state — heavier sampling therefore shortens leaps.
    residual_window : per-scenario-class rolling window of
        predicted-vs-realized residuals feeding the live histograms.
    residual_edges : bin edges for those histograms (tokens of signed
        residual ``true − predicted``); defaults to symmetric powers of two.
    """

    def __init__(self, capacity: int = 1_000_000, sample_every: int = 0,
                 residual_window: int = 512,
                 residual_edges: Optional[Sequence[float]] = None):
        if capacity < 1:
            raise ValueError("capacity must be >= 1")
        if sample_every < 0:
            raise ValueError("sample_every must be >= 0")
        self.capacity = int(capacity)
        self.sample_every = int(sample_every)
        self.residual_window = int(residual_window)
        if residual_edges is None:
            residual_edges = [-512.0, -128.0, -32.0, -8.0, 0.0,
                              8.0, 32.0, 128.0, 512.0]
        self.residual_edges = [float(e) for e in residual_edges]
        self.events: deque = deque(maxlen=self.capacity)
        self.emitted = 0                       # total, incl. ring-evicted
        self.counts: Counter = Counter()       # by kind, never evicted
        self.series: List[dict] = []           # gauge samples (dict rows)
        self.residual_series: List[dict] = []  # per-class histogram snapshots
        self._res: "OrderedDict[str, deque]" = OrderedDict()
        self._res_cov: Dict[str, deque] = {}
        self._last_refines: Dict[int, Tuple[int, int]] = {}

    # -- events --------------------------------------------------------------

    def emit(self, t: float, replica: int, rid: int, kind: str, **data):
        self.events.append(TraceEvent(
            float(t), int(replica), int(rid), kind,
            tuple(sorted(data.items()))))
        self.emitted += 1
        self.counts[kind] += 1

    def canonical(self) -> List[TraceEvent]:
        """The events in their canonical total order — ``(t, replica, rid,
        lifecycle rank, data)``. Leaps emit synthesized first tokens ahead
        of wall-clock order, so raw buffer order is path-dependent; this
        order is not, and is what the vec-vs-ref equality tests compare."""
        return sorted(self.events,
                      key=lambda e: (e.t, e.replica, e.rid,
                                     _RANK.get(e.kind, len(_RANK)), e.data))

    def by_rid(self) -> Dict[int, List[TraceEvent]]:
        """Canonical per-request streams (cluster/engine events with
        ``rid < 0`` — predict windows, refreshes — are skipped)."""
        out: Dict[int, List[TraceEvent]] = {}
        for e in self.canonical():
            if e.rid >= 0:
                out.setdefault(e.rid, []).append(e)
        return out

    def terminal_counts(self) -> Dict[str, int]:
        """Terminal-kind totals for the conservation invariant
        ``submitted == finish + timeout + rejected + dropped``. ``oom_evict``
        re-queues (non-terminal), but its unservable escalation also emits
        ``dropped``; a request preempted/stolen any number of times still
        terminates exactly once."""
        return {k: self.counts.get(k, 0) for k in TERMINAL_KINDS}

    # -- residual histograms (calibration drift, live) -----------------------

    def observe_residual(self, req):
        """Record a completed request's signed residual (realized − current
        predicted length) and its reservation-coverage indicator into the
        per-scenario-class rolling windows."""
        if req.predicted_len is None:
            return
        cls = req.setting or "?"
        win = self._res.get(cls)
        if win is None:
            win = self._res[cls] = deque(maxlen=self.residual_window)
            self._res_cov[cls] = deque(maxlen=self.residual_window)
        win.append(float(req.true_len) - float(req.predicted_len))
        bound = req.cal_q if req.cal_q is not None else req.reserve_len
        self._res_cov[cls].append(
            1.0 if bound is not None and float(req.true_len)
            <= float(bound) + 1e-9 else 0.0)

    def _snapshot_residuals(self, t: float):
        for cls, win in self._res.items():
            if not win:
                continue
            hist, _ = np.histogram(np.array(win), bins=self.residual_edges)
            under = int(np.sum(np.array(win) < self.residual_edges[0]))
            over = int(np.sum(np.array(win) >= self.residual_edges[-1]))
            self.residual_series.append({
                "t": float(t), "class": cls, "n": len(win),
                "counts": [under] + [int(c) for c in hist] + [over],
                "coverage": float(np.mean(self._res_cov[cls])),
                "mean_residual": float(np.mean(win)),
            })

    # -- gauges --------------------------------------------------------------

    def sample_engine(self, engine, t: float):
        """One per-replica gauge row, read from engine state at the top of a
        sample tick (both decode paths reach here with bit-identical state,
        so the series is path-independent)."""
        kv = engine.kv
        n = engine._n_active
        spec = engine.spec
        row = {
            "t": float(t), "replica": int(engine.replica_id),
            "kv_occupancy": kv.reserved_now / max(kv.capacity_tokens, 1),
            "kv_frag": (1.0 - kv.asked_now / kv.reserved_now)
            if kv.reserved_now else 0.0,
            "kv_amplification": (kv.logical_now / kv.reserved_now)
            if kv.reserved_now else 1.0,
            "queue_depth": len(engine._ready) + len(engine._future),
            "active_slots": int(n),
            "slot_util": n / max(engine.max_slots, 1),
            "held_tokens": int(engine._held_tokens),
            "refine_shrinks": int(engine.refine_shrinks),
            "refine_grows": int(engine.refine_grows),
        }
        last = self._last_refines.get(engine.replica_id, (0, 0))
        row["refine_shrink_rate"] = row["refine_shrinks"] - last[0]
        row["refine_grow_rate"] = row["refine_grows"] - last[1]
        self._last_refines[engine.replica_id] = (row["refine_shrinks"],
                                                 row["refine_grows"])
        if engine._budget is not None:
            # demand the *next* tick would put on the shared token budget —
            # a pure state function, so it is identical across decode paths
            # (the realized per-tick spend is not recorded during leaps)
            chunk = engine._chunk or int(engine._budget)
            pftok = engine._a_pftok[:n]
            pf_demand = int(np.minimum(pftok, chunk).sum())
            dec = pftok == 0
            dec_demand = int(np.minimum(
                spec.speed,
                (engine._a_tlen[:n] - engine._a_gen[:n])[dec]).sum())
            row["budget_util"] = min(pf_demand + dec_demand,
                                     int(engine._budget)) / int(engine._budget)
        self.series.append(row)

    def sample_cluster(self, cluster, t: float):
        """One fleet-level gauge row (``replica=-1``): aggregate queue/KV
        state, predictor-service cache hit rate, rolling conformal coverage
        — plus a snapshot of every per-class residual histogram."""
        engines = cluster.engines
        reserved = sum(e.kv.reserved_now for e in engines)
        capacity = sum(e.kv.capacity_tokens for e in engines)
        asked = sum(e.kv.asked_now for e in engines)
        row = {
            "t": float(t), "replica": -1,
            "kv_occupancy": reserved / max(capacity, 1),
            "kv_frag": (1.0 - asked / reserved) if reserved else 0.0,
            "queue_depth": sum(len(e._ready) + len(e._future)
                               for e in engines),
            "active_slots": sum(e._n_active for e in engines),
            "stolen": int(cluster.stolen),
            "rejected": len(cluster.rejected_requests),
        }
        svc = cluster.predictor
        adapter = svc if hasattr(svc, "observe") else None
        if adapter is not None:
            row["rolling_coverage"] = adapter.rolling_coverage()
            row["q_eff"] = adapter.q_eff if adapter.q_eff is not None \
                else float("nan")
            row["refreshes"] = int(adapter.refreshes)
            svc = adapter.base
        stats = getattr(svc, "stats", None)
        if stats is not None:
            row["predictor_hit_rate"] = stats.cache_hits / stats.requests \
                if stats.requests else 0.0
            row["predictor_batches"] = int(stats.batches)
        self.series.append(row)
        self._snapshot_residuals(t)

    # -- exporters -----------------------------------------------------------

    def summary(self) -> dict:
        """JSON-ready run summary: event totals, terminal reconciliation,
        the gauge series, and the residual-histogram series."""
        return {
            "emitted": self.emitted,
            "buffered": len(self.events),
            "evicted": self.emitted - len(self.events),
            "counts": dict(sorted(self.counts.items())),
            "terminal": self.terminal_counts(),
            "sample_every": self.sample_every,
            "series": self.series,
            "residual_edges": self.residual_edges,
            "residuals": self.residual_series,
        }

    def write_summary(self, path: str) -> dict:
        out = self.summary()
        with open(path, "w") as f:
            json.dump(out, f, indent=1, sort_keys=True)
        return out

    def to_prometheus(self) -> str:
        """Prometheus text exposition: event totals as counters, the latest
        gauge row per replica as gauges, and the latest per-class residual
        coverage."""
        lines = ["# HELP serving_events_total lifecycle events by kind",
                 "# TYPE serving_events_total counter"]
        for kind in EVENT_KINDS:
            if kind in self.counts:
                lines.append(f'serving_events_total{{kind="{kind}"}} '
                             f'{self.counts[kind]}')
        latest: "OrderedDict[int, dict]" = OrderedDict()
        for row in self.series:
            latest[row["replica"]] = row
        gauges = sorted({k for row in latest.values() for k in row
                         if k not in ("t", "replica")})
        for g in gauges:
            lines.append(f"# TYPE serving_{g} gauge")
            for rep, row in latest.items():
                if g in row:
                    val = row[g]
                    lines.append(f'serving_{g}{{replica="{rep}"}} '
                                 f'{float(val)}')
        latest_res: "OrderedDict[str, dict]" = OrderedDict()
        for row in self.residual_series:
            latest_res[row["class"]] = row
        if latest_res:
            lines.append("# TYPE serving_residual_coverage gauge")
            for cls, row in latest_res.items():
                lines.append(
                    f'serving_residual_coverage{{class="{cls}"}} '
                    f'{row["coverage"]}')
        return "\n".join(lines) + "\n"

    def to_perfetto(self) -> dict:
        """Chrome/Perfetto trace-event JSON: one process per replica, lanes
        (threads) packed by greedy interval assignment, an ``X`` span per
        slot residency — split into ``prefill`` and ``decode`` phases at the
        first token — instant markers for preempt/steal/timeout/drop/refine,
        and counter tracks from the gauge series. Load the dict (or the
        file :meth:`write_perfetto` writes) in https://ui.perfetto.dev.

        Tick times are exported as microseconds 1:1 (``displayTimeUnit``
        stays ``ms`` so one engine tick renders as 1 us)."""
        ev: List[dict] = []
        episodes: Dict[int, List[tuple]] = {}   # replica -> (start, end, ...)
        open_ep: Dict[int, tuple] = {}          # rid -> (t0, replica, first)
        instants = {"preempted": "preempt", "stolen": "steal",
                    "oom_evict": "oom_evict", "timeout": "timeout",
                    "dropped": "drop", "rejected": "reject",
                    "refine": "refine", "held_release": "held_release"}
        end_t = 0.0
        for e in self.canonical():
            end_t = max(end_t, e.t)
            if e.kind == "admitted":
                open_ep[e.rid] = (e.t, e.replica, None)
            elif e.kind == "first_token" and e.rid in open_ep:
                t0, rep, _ = open_ep[e.rid]
                open_ep[e.rid] = (t0, rep, e.t)
            elif e.kind in ("finish", "preempted", "oom_evict") \
                    and e.rid in open_ep:
                t0, rep, first = open_ep.pop(e.rid)
                episodes.setdefault(rep, []).append(
                    (t0, max(e.t, t0), e.rid, first, e.kind))
            if e.kind in instants:
                ev.append({"name": instants[e.kind], "cat": "lifecycle",
                           "ph": "i", "ts": e.t, "s": "t",
                           "pid": max(e.replica, 0), "tid": 0,
                           "args": {"rid": e.rid, **dict(e.data)}})
        for rid, (t0, rep, first) in open_ep.items():   # still active at end
            episodes.setdefault(rep, []).append(
                (t0, end_t, rid, first, "open"))
        for rep in sorted(episodes):
            ev.append({"name": "process_name", "ph": "M", "pid": rep,
                       "args": {"name": f"replica {rep}"}})
            lanes: List[float] = []     # lane -> busy-until
            for t0, t1, rid, first, endk in sorted(episodes[rep]):
                lane = next((i for i, busy in enumerate(lanes)
                             if busy <= t0), None)
                if lane is None:
                    lane = len(lanes)
                    lanes.append(0.0)
                    ev.append({"name": "thread_name", "ph": "M", "pid": rep,
                               "tid": lane + 1,
                               "args": {"name": f"slot lane {lane}"}})
                lanes[lane] = t1
                split = first if first is not None and t0 < first <= t1 \
                    else None
                spans = [("prefill", t0, split), ("decode", split, t1)] \
                    if split is not None else [("decode", t0, t1)]
                for name, a, b in spans:
                    if b > a:
                        ev.append({"name": f"{name} rid={rid}",
                                   "cat": "request", "ph": "X", "ts": a,
                                   "dur": b - a, "pid": rep, "tid": lane + 1,
                                   "args": {"rid": rid, "end": endk}})
        counter_keys = ("kv_occupancy", "queue_depth", "budget_util",
                        "rolling_coverage", "predictor_hit_rate")
        for row in self.series:
            pid = max(row["replica"], 0)
            scope = "fleet" if row["replica"] < 0 else "kv"
            for key in counter_keys:
                if key in row:
                    v = float(row[key])
                    if np.isnan(v):
                        continue
                    ev.append({"name": f"{scope}:{key}", "ph": "C",
                               "ts": row["t"], "pid": pid,
                               "args": {key: v}})
        return {"traceEvents": ev, "displayTimeUnit": "ms",
                "otherData": {"emitted": self.emitted,
                              "evicted": self.emitted - len(self.events)}}

    def write_perfetto(self, path: str) -> dict:
        out = self.to_perfetto()
        with open(path, "w") as f:
            json.dump(out, f)
        return out
