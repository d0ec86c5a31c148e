"""Multi-replica serving cluster: a router dispatching an open-loop trace to
N (possibly heterogeneous) :class:`SimEngine` replicas stepped in lockstep.

Each replica is described by a :class:`~repro.serving.engine.ReplicaSpec`
(slots, KV budget, decode speed, prefill rate), so the cluster can model a
mixed fleet — e.g. two fast large-memory accelerators next to two slow small
ones. Router load signals are speed-aware: they normalize by each replica's
service rate / budget, so a twice-as-fast replica looks half as loaded at
equal backlog (for a homogeneous fleet this reduces exactly to the unscaled
signals).

Router policies:

* ``round_robin`` — rid-order rotation, load-blind (the baseline);
* ``jsq``         — join-shortest-queue: outstanding requests per unit of
  service rate (slots × speed);
* ``least_kv``    — least outstanding reserved-KV *fraction* (active
  reservations plus queued reservation needs, over the replica's budget):
  memory-pressure-aware but length-blind;
* ``psq``         — predicted-shortest-queue: joins the replica with the
  least *predicted remaining decode tokens* per unit of service rate
  (active + queued). This is the router only a length predictor enables;
  with ``reserve="quantile"`` the same ProD-D distribution also sizes each
  request's KV reservation, giving the full prediction-aware serving stack.
* ``prefix_affine`` — prefix-affinity routing for shared-context traffic:
  a request carrying a ``prefix_id`` joins the least-loaded replica already
  holding that prefix's shared KV pages (so it hits the cache instead of
  re-prefilling and re-reserving the common context), *unless* every holder
  is overloaded — more than ``prefix_imbalance`` requests-worth of load
  above the lightest replica — in which case it falls back to jsq. A prefix
  resident everywhere (a hot system prompt) routes exactly like jsq;
  prefix-less requests route plain jsq too.

Work stealing: with ``rebalance_every=k`` the cluster pauses every k steps
and migrates *queued* (never active — their KV lives on the donor) requests
from the most- to the least-loaded replica under the router's own load
metric, until their queue lengths meet in the middle. ``steal="quantile"``
is the ProD-aware variant: it steals the requests with the largest
predicted-quantile remaining work, moving the most token-load per migration;
``steal="tail"`` takes the entries the donor would serve last. A preempted
request holding kept pages (``Policy.preempt_mode="keep"``) migrates them
with it — the donor releases, the thief re-reserves (page handoff), and the
``steal_cost`` delay scales with the pages moved.

All replicas share one global clock; dispatch happens at request arrival
(open loop — the router never sees realized lengths, only predictions).

Closed-loop adaptation: passing an
:class:`~repro.serving.adaptation.OnlineAdapter` as the ``predictor``
switches :meth:`Cluster.run` into its feedback mode — requests are annotated
at dispatch time with the adapter's current calibration/weights, and
observed completions flow back at fixed checkpoints. An optional
``admission`` controller can reject SLO-infeasible requests at the enqueue
seam, and ``steal_cost`` charges a migration delay on stolen work.

The port's own copy of ``repro.serving.cluster`` (NumPy only), kept line for
line so that the same trace gives the same ``ClusterStats`` bit for bit. A
predictor on the GPU answers at the seam in host NumPy (``PredictorService``
brings its outputs over; ``annotate_predictions`` does it for the others).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Sequence

import numpy as np

from repro_torch.serving.engine import (ReplicaSpec, SimEngine, _goodput,
                                        _latency_stats, _ttft_stats)
from repro_torch.serving.request import Request
from repro_torch.serving.scheduler import Policy, annotate_predictions

ROUTERS = ("round_robin", "jsq", "least_kv", "psq", "prefix_affine")
STEAL_MODES = ("tail", "quantile")


@dataclass
class ClusterStats:
    router: str
    policy: str
    n_replicas: int
    makespan: float
    mean_latency: float
    p50_latency: float
    p90_latency: float
    p99_latency: float
    mean_wait: float
    throughput: float              # completed tokens / step, cluster-wide
    kv_waste_ratio: float          # aggregate over replicas
    overflow_events: int
    completed: int
    preemptions: int = 0
    oom_evictions: int = 0
    dropped: int = 0
    timed_out: int = 0             # queue entries expired before starting
    slo_violations: int = 0        # completed past their deadline
    goodput: float = 0.0           # within-SLO completed tokens / step
    stolen: int = 0                # queued requests migrated by rebalancing
    steal_delay: int = 0           # total migration-delay ticks charged
    steal_pages: int = 0           # total KV pages moved by migrations
    rejected: int = 0              # admission-controlled away at enqueue
    refreshes: int = 0             # predictor weight swaps during the run
    balance: float = 1.0           # max/mean completed tokens per replica
    # paged-KV accounting, aggregated over replicas (see ServeStats)
    occupancy: float = 0.0         # mean reserved fraction of the fleet pool
    frag_ratio: float = 0.0        # page-rounding slack / reserved integral
    held_peak: int = 0             # Σ per-replica peak held tokens
    held_steps: float = 0.0        # Σ token-steps held while preempted-queued
    held_releases: int = 0         # Σ held pages dropped to break stalls
    recompute_ticks: int = 0       # prefill ticks re-paid for preempted work
    # prefix sharing, aggregated over replicas (inert without sharing)
    kv_amplification: float = 1.0  # Σ logical / Σ physical reserved steps
    prefix_hits: int = 0           # admissions that reused shared pages
    cow_copies: int = 0            # divergence-boundary pages privatized
    prefix_evictions: int = 0      # cached prefixes reclaimed under pressure
    prefill_ticks: int = 0         # prefill ticks actually paid
    prefill_saved_ticks: int = 0   # prefill ticks erased by prefix hits
    shared_peak: int = 0           # Σ per-replica peak shared tokens
    # posterior refinement, aggregated over replicas (0 with refine off)
    refine_events: int = 0
    refine_shrinks: int = 0
    refine_grows: int = 0
    # time-to-first-token percentiles over all completed requests (inf when
    # none emitted; see ServeStats)
    mean_ttft: float = float("inf")
    p50_ttft: float = float("inf")
    p90_ttft: float = float("inf")
    p99_ttft: float = float("inf")
    replica_rows: List[dict] = field(default_factory=list)

    def row(self) -> dict:
        d = self.__dict__.copy()
        # per-replica rows are exported separately (Tracer.sample_cluster /
        # replica gauge series), not as a flat scalar column
        d.pop("replica_rows")  # reprolint: disable=stats-exporter-surfacing
        return d


class Cluster:
    """N-replica trace-driven cluster simulator over per-replica specs.

    Parameters
    ----------
    specs : one :class:`~repro.serving.engine.ReplicaSpec` per replica
        (slots, KV budget, decode speed, prefill rate) — the fleet.
    policy : scheduling :class:`~repro.serving.scheduler.Policy` every
        replica runs (queue ordering × KV reservation sizing).
    router : dispatch policy, one of :data:`ROUTERS` (module docstring).
    predictor : the length predictor behind the prediction-aware paths
        (psq routing, quantile reservation, laxity ordering, quantile
        stealing). Interchangeable implementations of the same seam:
        :class:`~repro.serving.arrivals.LatentOracle` (analytic trace proxy),
        :class:`~repro.serving.predictor.PredictorService` (trained ProD-D
        head, batched jitted dispatch-time inference), and
        :class:`~repro.serving.predictor.PerfectOracle` (realized lengths —
        the upper bound). ``None`` keeps pre-annotated trace predictions.
    vectorized : use the NumPy fast path + event leap (bit-identical to the
        per-slot reference; ``False`` forces the reference loop).
    rebalance_every : steal queued work every k steps (0 disables).
    steal : victim selection, one of :data:`STEAL_MODES`.
    steal_cost : migration delay in ticks *per KV page moved* (prompt
        re-transfer, plus any kept pages a preempted holder carries): a
        migrated entry becomes runnable on the thief only
        ``steal_cost × pages_moved`` ticks after the rebalance (0 keeps the
        free-migration model). Total charged delay and pages appear in
        ``ClusterStats.steal_delay`` / ``steal_pages``.
    admission : optional SLO-aware admission controller (an object with
        ``admit(request, engine, spec, now) -> bool``, e.g.
        :class:`~repro.serving.adaptation.AdmissionController`): requests it
        declines at dispatch are counted as ``rejected`` and never enqueued.
    prefix_imbalance : ``prefix_affine`` only — how much extra load (in
        requests, normalized by the holding replica's service rate) a
        prefix-holding replica may carry over the lightest one before
        affinity yields to jsq. 0 = pure load balancing, large = sticky
        sessions.
    refiner : optional :class:`~repro.core.online.PosteriorRefiner` over
        the predictor's bin edges, handed to every replica engine. Required
        when ``policy.refine_every > 0``; ignored otherwise.

    A ``predictor`` that also exposes ``observe`` (an
    :class:`~repro.serving.adaptation.OnlineAdapter`) switches :meth:`run`
    into its closed loop: requests are annotated at dispatch time instead
    of up front, and observed completions are fed back at fixed
    ``adapter.cfg.every``-tick checkpoints (in a canonical order, so both
    decode paths see the identical feedback stream).
    """

    def __init__(self, specs: Sequence[ReplicaSpec], policy: Policy,
                 router: str = "round_robin", predictor=None,
                 vectorized: bool = True, rebalance_every: int = 0,
                 steal: str = "tail", steal_cost: int = 0, admission=None,
                 prefix_imbalance: float = 8.0, refiner=None, tracer=None):
        if router not in ROUTERS:
            raise ValueError(f"router {router!r} not in {ROUTERS}")
        if steal not in STEAL_MODES:
            raise ValueError(f"steal {steal!r} not in {STEAL_MODES}")
        if steal_cost < 0:
            raise ValueError("steal_cost must be >= 0")
        if prefix_imbalance < 0:
            raise ValueError("prefix_imbalance must be >= 0")
        specs = tuple(specs)
        if not specs:
            raise ValueError("need at least one ReplicaSpec")
        self.specs = specs
        self.n_replicas = len(specs)
        self.router = router
        self.policy = policy
        self.predictor = predictor
        self.rebalance_every = int(rebalance_every)
        self.steal = steal
        self.steal_cost = int(steal_cost)
        self.admission = admission
        self.prefix_imbalance = float(prefix_imbalance)
        self._prefix_home: dict = {}    # prefix_id -> last replica routed to
        self.stolen = 0
        self.steal_delay = 0
        self.steal_pages = 0
        self.rejected_requests: List[Request] = []
        self.refiner = refiner
        # optional telemetry, shared with every replica engine: the cluster
        # emits dispatch-level events (arrival/routed/rejected/stolen) and
        # fleet gauge rows; engines emit slot-level events + per-replica rows
        self.tracer = tracer
        self.engines = [
            SimEngine(policy=policy, predictor=None, vectorized=vectorized,
                      spec=spec, refiner=refiner, tracer=tracer)
            for spec in specs
        ]
        for i, e in enumerate(self.engines):
            e.replica_id = i
        self._rr = 0
        self._done_seen = [0] * self.n_replicas

    @classmethod
    def uniform(cls, n_replicas: int, max_slots: int, kv_budget: int,
                policy: Policy, page_size: int = 1,
                share_prefixes: bool = False, **kw) -> "Cluster":
        """Homogeneous fleet — the pre-heterogeneity constructor shape."""
        spec = ReplicaSpec(max_slots=max_slots, kv_budget=kv_budget,
                           page_size=page_size, share_prefixes=share_prefixes)
        return cls([spec] * n_replicas, policy, **kw)

    # -- dispatch ------------------------------------------------------------

    def _loads(self) -> List[float]:
        """Per-replica load under the router's own metric, normalized by
        replica capacity so heterogeneous fleets compare fairly."""
        if self.router == "least_kv":
            return [e.outstanding_kv / s.kv_budget
                    for e, s in zip(self.engines, self.specs)]
        if self.router == "psq":
            return [e.predicted_backlog() / s.service_rate
                    for e, s in zip(self.engines, self.specs)]
        # jsq — prefix_affine's base metric, and the rebalance metric for
        # round_robin
        return [e.outstanding_requests / s.service_rate
                for e, s in zip(self.engines, self.specs)]

    def _route(self, req: Request) -> int:
        if self.router == "round_robin":
            i = self._rr
            self._rr = (self._rr + 1) % self.n_replicas
            return i
        loads = self._loads()
        # capacity-aware: never choose a replica whose whole KV pool cannot
        # hold the request when one that can exists (on a no-fit fleet the
        # engine drops the request as unservable)
        need = int(req.prompt_len + req.reserve_len)
        fits = [i for i, s in enumerate(self.specs) if need <= s.kv_budget]
        pool = fits if fits and len(fits) < self.n_replicas \
            else range(self.n_replicas)
        best = min(pool, key=lambda i: loads[i])
        if self.router != "prefix_affine" or req.prefix_id is None:
            return best
        # affinity: among the replicas whose pool still holds this prefix's
        # shared pages, join the least loaded. For a prefix every replica has
        # warmed (a hot system prompt) this degenerates to exactly jsq; a
        # session context resident on one replica pulls its turns back there.
        # A prefix queued but not yet admitted has no resident pages anywhere,
        # so the replica the session was last routed to stands in as holder.
        pid = req.prefix_id
        holders = [i for i in pool if self.engines[i].kv.has_prefix(pid)]
        if not holders:
            home = self._prefix_home.get(pid)
            if home is not None and home in pool:
                holders = [home]
        if holders:
            near = min(holders, key=lambda i: loads[i])
            if (loads[near] <= loads[best]
                    + self.prefix_imbalance / self.specs[near].service_rate):
                self._prefix_home[pid] = near
                return near
        self._prefix_home[pid] = best
        return best

    # -- work stealing -------------------------------------------------------

    def _rebalance(self):
        """Migrate queued requests from the most- to the least-loaded replica
        (router load metric). The steal size equalizes *service-rate-
        normalized* queue lengths — (qd−k)/rate_d == (qt+k)/rate_t, which
        reduces to (qd−qt)/2 for equal rates — so a fast replica standing
        next to a slow one with the same raw queue length still steals.
        Only requests that fit the thief's KV pool move, and active slots
        never move — their KV pages live on the donor."""
        loads = self._loads()
        donor = int(np.argmax(loads))
        thief = int(np.argmin(loads))
        if donor == thief:
            return
        d_eng, t_eng = self.engines[donor], self.engines[thief]
        rd = self.specs[donor].service_rate
        rt = self.specs[thief].service_rate
        # queue length counts in-transit migrations (the thief's future heap
        # under steal_cost > 0) — otherwise back-to-back rebalances see the
        # thief as empty and keep over-stealing to it
        qd = len(d_eng._ready) + len(d_eng._future)
        qt = len(t_eng._ready) + len(t_eng._future)
        k = int((qd * rt - qt * rd) / (rd + rt))
        if k <= 0:
            return
        # the fit filter must round needs to the THIEF's page granularity:
        # its page-rounded grant is what has to fit its pool, not raw tokens
        moved = d_eng.steal_queued(k, mode=self.steal,
                                   fit=self.specs[thief].kv_budget,
                                   fit_page_size=self.specs[thief].page_size)
        for r in moved:
            r.replica = thief
            # pages moved: a keep-mode holder carries its kept prompt+progress
            # KV pages; a plain queued request — or a holder whose handoff
            # the thief's pool refuses (pages dropped, recompute there) —
            # only re-transfers its prompt
            held_pages = r.held // d_eng.kv.page_size if r.held else 0
            d_eng.export_held(r)
            pages = held_pages if t_eng.adopt_held(r) \
                else d_eng.kv.pages_for(r.prompt_len)
            self.steal_pages += pages
            delay = self.steal_cost * pages
            if self.steal_cost > 0:
                # migration isn't free: the stolen entry only becomes
                # runnable on the thief after a delay proportional to the
                # KV pages it moves (steal_cost ticks per page)
                t_eng.submit([r], after=t_eng.t + delay)
                self.steal_delay += delay
            else:
                t_eng.submit([r])
            if self.tracer is not None:
                self.tracer.emit(t_eng.t, thief, r.rid, "stolen", frm=donor,
                                 pages=int(pages), delay=int(delay))
        self.stolen += len(moved)

    # -- adaptation feedback (closed loop) -----------------------------------

    def _harvest_done(self) -> List[Request]:
        """Newly finished requests since the last harvest, in a canonical
        global order — (finish tick, replica, completion order) — that is
        independent of how often the harvest runs, so the adapter's feedback
        stream is bit-identical between the reference (every tick) and
        event-leap (sparse iterations) paths."""
        fresh = []
        for i, e in enumerate(self.engines):
            done = e.done
            for j in range(self._done_seen[i], len(done)):
                fresh.append((float(done[j].t_finish), i, j, done[j]))
            self._done_seen[i] = len(done)
        fresh.sort(key=lambda x: x[:3])
        return [x[3] for x in fresh]

    # -- lockstep replay -----------------------------------------------------

    def run(self, requests: Sequence[Request],
            max_steps: int = 10_000_000) -> ClusterStats:
        reqs = [r.fresh_copy() for r in requests]
        adapter = self.predictor if hasattr(self.predictor, "observe") \
            else None
        if adapter is None:
            annotate_predictions(reqs, self.predictor, self.policy)
        else:
            adapter.reset()
        reqs.sort(key=lambda r: r.arrival)
        vectorized = all(e.vectorized for e in self.engines)
        for e in self.engines:
            e.reset()
        self._rr = 0
        self._prefix_home = {}
        self.stolen = 0
        self.steal_delay = 0
        self.steal_pages = 0
        self.rejected_requests = []
        self._done_seen = [0] * self.n_replicas
        t = 0.0     # advances in unit ticks (plus integer leaps) from 0.0
        next_reb = self.rebalance_every if self.rebalance_every > 0 else None
        next_adapt = float(adapter.cfg.every) if adapter is not None else None
        tracer = self.tracer
        next_obs = float(tracer.sample_every) \
            if tracer is not None and tracer.sample_every else None
        ptr, n = 0, len(reqs)
        while True:
            batch = []
            while ptr < n and reqs[ptr].arrival <= t:
                batch.append(reqs[ptr])
                ptr += 1
            if batch:
                if adapter is not None:
                    # closed loop: annotate at dispatch time with the
                    # adapter's CURRENT calibration and weights
                    adapter.annotate(batch, self.policy)
                for r in batch:
                    if tracer is not None:
                        tracer.emit(r.arrival, -1, r.rid, "arrival")
                    i = self._route(r)
                    if (self.admission is not None
                            and not self.admission.admit(
                                r, self.engines[i], self.specs[i], t)):
                        if self.router == "round_robin":
                            # a rejected request never enqueues, so it must
                            # not burn the rotation slot either
                            self._rr = (self._rr - 1) % self.n_replicas
                        self.rejected_requests.append(r)
                        if tracer is not None:
                            tracer.emit(t, i, r.rid, "rejected")
                        continue
                    r.replica = i
                    if tracer is not None:
                        tracer.emit(t, i, r.rid, "routed", to=i)
                    self.engines[i].submit([r])
            if next_adapt is not None and t >= next_adapt:
                adapter.observe(self._harvest_done())
                adapter.maybe_refresh(t)
                next_adapt += adapter.cfg.every
            if next_reb is not None and t >= next_reb:
                self._rebalance()
                next_reb += self.rebalance_every
            if next_obs is not None and t >= next_obs:
                # fleet-level gauge row (replica = -1) each sample tick; the
                # per-engine rows fire inside each engine's own step()
                tracer.sample_cluster(self, t)
                next_obs += tracer.sample_every
            if ptr >= n and all(e.idle for e in self.engines):
                break
            if t >= max_steps:
                break
            if vectorized:
                # lockstep event leap: jump all replicas over the span in
                # which no replica can admit/preempt/grow/complete, no trace
                # arrival needs dispatching, and no rebalance or adaptation
                # tick falls
                ks = [e.ticks_to_event() for e in self.engines]
                k = min(ks)
                if ptr < n:
                    # dispatch happens at loop start (arrival <= t), i.e. one
                    # tick earlier than an engine-internal arrival would fire
                    k = min(k, max(1.0, np.ceil(reqs[ptr].arrival - t)))
                if next_reb is not None:
                    k = min(k, max(1.0, float(next_reb) - t))
                if next_adapt is not None:
                    k = min(k, max(1.0, float(next_adapt) - t))
                if next_obs is not None:
                    k = min(k, max(1.0, float(next_obs) - t))
                q = int(min(k - 1, max(max_steps - t - 1, 0)))
                if q > 0:
                    for e in self.engines:
                        e.leap(q)
                    t += float(q)
                # replicas whose own next event is still ahead take the tick
                # as a 1-step leap (identical arithmetic, skips admit/decode
                # bookkeeping); only event replicas run the full step
                for e, ke in zip(self.engines, ks):
                    if ke - q > 1.0:
                        e.leap(1)
                    else:
                        e.step()
            else:
                for e in self.engines:
                    e.step()
            t += 1.0
        if adapter is not None:
            # final harvest: completions between the last checkpoint and the
            # end of the run still count toward coverage totals
            adapter.observe(self._harvest_done())
        return self._stats(t, adapter)

    def _stats(self, t: float, adapter=None) -> ClusterStats:
        done = [r for e in self.engines for r in e.done]
        toks = sum(r.true_len for r in done)
        reserved_steps = sum(e.kv.total_reserved_steps for e in self.engines)
        asked_steps = sum(e.kv.total_asked_steps for e in self.engines)
        used_steps = sum(e.kv.total_used_steps for e in self.engines)
        logical_steps = sum(e.kv.total_logical_steps for e in self.engines)
        waste = (1.0 - used_steps / reserved_steps) if reserved_steps else 0.0
        frag = (1.0 - asked_steps / reserved_steps) if reserved_steps else 0.0
        amp = (logical_steps / reserved_steps) if reserved_steps else 1.0
        capacity = sum(e.kv.capacity_tokens for e in self.engines)
        per_replica_toks = np.array(
            [sum(r.true_len for r in e.done) for e in self.engines], float)
        mean_toks = max(float(per_replica_toks.mean()), 1e-9)
        return ClusterStats(
            router=self.router,
            policy=f"{self.policy.order}+{self.policy.reserve}",
            n_replicas=self.n_replicas,
            makespan=t,
            throughput=toks / max(t, 1.0),
            kv_waste_ratio=waste,
            overflow_events=sum(e.kv.overflow_events for e in self.engines),
            completed=len(done),
            preemptions=sum(e.preemptions for e in self.engines),
            oom_evictions=sum(e.oom_evictions for e in self.engines),
            dropped=sum(e.dropped for e in self.engines),
            timed_out=sum(e.timed_out for e in self.engines),
            slo_violations=sum(e.slo_violations for e in self.engines),
            goodput=_goodput(done, t),
            stolen=self.stolen,
            steal_delay=self.steal_delay,
            steal_pages=self.steal_pages,
            rejected=len(self.rejected_requests),
            refreshes=adapter.refreshes if adapter is not None else 0,
            balance=float(per_replica_toks.max()) / mean_toks,
            occupancy=reserved_steps / (max(t, 1.0) * max(capacity, 1)),
            frag_ratio=frag,
            held_peak=sum(e._held_peak for e in self.engines),
            held_steps=sum(e._held_steps for e in self.engines),
            held_releases=sum(e.held_releases for e in self.engines),
            recompute_ticks=sum(e.recompute_ticks for e in self.engines),
            kv_amplification=amp,
            prefix_hits=sum(e.kv.prefix_hits for e in self.engines),
            cow_copies=sum(e.kv.cow_copies for e in self.engines),
            prefix_evictions=sum(e.kv.prefix_evictions
                                 for e in self.engines),
            prefill_ticks=sum(e.prefill_ticks for e in self.engines),
            prefill_saved_ticks=sum(e.prefill_saved_ticks
                                    for e in self.engines),
            shared_peak=sum(e.kv.shared_peak for e in self.engines),
            refine_events=sum(e.refine_events for e in self.engines),
            refine_shrinks=sum(e.refine_shrinks for e in self.engines),
            refine_grows=sum(e.refine_grows for e in self.engines),
            replica_rows=[e.stats().row() for e in self.engines],
            **_latency_stats(done),
            **_ttft_stats(done),
        )
