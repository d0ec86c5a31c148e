"""Continuous-batching engines.

* :class:`SimEngine` — discrete-event simulator (Track A): slot-based
  continuous batching, KV reservation accounting, pluggable scheduler. It
  is NumPy, the port's copy of the reference's: the same trace gives the
  same stats, bit for bit.
  One engine step == one decode step for every active slot (the TPU-idiomatic
  fixed-shape batching model). Used to quantify what better length prediction
  buys in throughput/latency/memory.

  A replica's capacity is a :class:`ReplicaSpec`: slot count, KV budget, an
  integer decode-speed multiplier (tokens emitted per slot per step — a
  faster accelerator), and a prefill rate (``prefill_tokens_per_step``; an
  admitted slot spends ``ceil(prompt_tokens / rate)`` ticks prefilling before
  its first decode token, 0 = prefill is free). Requests may carry a
  ``deadline``: queue entries whose deadline has passed — including
  preempted requests waiting to resume — are dropped (``timed_out``) when
  they reach the head of the ready queue, and requests finishing past their
  deadline count as ``slo_violations``.

  The engine is *stepwise*: :meth:`submit` enqueues requests, :meth:`step`
  advances one decode tick, so a :class:`~repro.serving.cluster.Cluster` can
  drive N replicas in lockstep against a shared clock. :meth:`run` wraps the
  closed-loop single-replica flow. The per-tick decode comes in two
  implementations — a per-slot reference loop and a vectorized NumPy fast
  path over the slot arrays (default) — that produce bit-identical results;
  the fast path is what lets a 50k-request trace replay in seconds.

* :class:`RealEngine` — Track B: batched sampling over a served model.
  It prefills right-padded prompts once, takes φ — the last-layer hidden
  state of the last prompt token — for the ProD predictor, then decodes
  until every row has sampled EOS or ``max_new`` tokens. Prefill attention
  runs the flash kernel, prefill SSM layers the SSD scan kernel, and every
  decode step's attention the split-KV kernel (``kernels/``), on the device
  the parameters live on. Sampling is temperature sampling through the
  Gumbel-max trick with a seeded ``torch.Generator`` on that device;
  ``jax.random`` draws other numbers from the same seed, so the parity tests
  feed both frameworks the same tokens. ``collect_per_step`` (per-step
  hidden states) waits for the online-predictor slice.

Nothing here reads the wall clock, a global RNG or a set's order.
"""

from __future__ import annotations

import heapq
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.models.model_zoo import last_token_hidden
from repro_torch.serving.kvcache import KVCacheManager
from repro_torch.serving.request import Request
from repro_torch.serving.scheduler import (Policy, annotate_predictions, order_key,
                                           predicted_remaining, quantile_remaining)
# shared percentile summarization lives in telemetry (one implementation for
# ServeStats and ClusterStats); the underscore aliases keep the historical
# engine-module import surface working
from repro_torch.serving.telemetry import goodput as _goodput
from repro_torch.serving.telemetry import latency_summary as _latency_stats
from repro_torch.serving.telemetry import ttft_summary as _ttft_stats


@dataclass(frozen=True)
class ReplicaSpec:
    """Per-replica capacity: what a heterogeneous cluster varies.

    Parameters
    ----------
    max_slots : concurrent decode slots (continuous-batching width).
    kv_budget : KV-cache pool size in tokens; reservations draw from it.
    speed : integer decode multiplier — every active (non-prefilling) slot
        emits ``speed`` tokens per engine step (a faster accelerator).
    prefill_tokens_per_step : prompt tokens one prefill tick processes; an
        admitted slot spends ``ceil(prompt / rate)`` ticks prefilling before
        its first decode token. 0 keeps the legacy free-prefill model.
    page_size : KV-cache page granularity in tokens; reservations are whole
        pages (``kv_budget`` must be page-aligned). 1 reproduces the scalar
        token counter bit-exactly.
    share_prefixes : back requests' declared common contexts
        (``Request.prefix_id``/``prefix_len``) with ref-counted shared KV
        pages + copy-on-write instead of private copies, and skip their
        prefill. Off (the default) is bit-identical to a non-sharing pool.
    step_token_budget : vLLM-style per-step token budget — the total tokens
        (prefill chunk tokens + decode tokens) one engine tick may process.
        Prefilling slots consume their prompt in chunks drawn from this
        budget, interleaved with decode: decode slots emit fewer tokens on
        ticks where prefill spends the budget (``Policy.chunk_order`` picks
        which prefilling slot feeds first). ``None`` (the default) keeps the
        tick-based ``prefill_tokens_per_step`` model bit-identically.
    prefill_chunk_tokens : budget mode only — cap on the prefill tokens one
        slot may draw from the budget per tick. 0 means *atomic* prefill
        under the budget: a tick with any prefilling slot dedicates the
        whole budget to prefill (decode pauses), the non-chunked serving
        model chunked prefill exists to beat.
    """
    max_slots: int
    kv_budget: int
    speed: int = 1
    prefill_tokens_per_step: int = 0
    page_size: int = 1
    share_prefixes: bool = False
    step_token_budget: Optional[int] = None
    prefill_chunk_tokens: int = 0

    def __post_init__(self):
        if self.max_slots <= 0 or self.kv_budget <= 0:
            raise ValueError("max_slots and kv_budget must be positive")
        if int(self.speed) != self.speed or self.speed < 1:
            raise ValueError(f"speed must be a positive integer, got {self.speed}")
        if self.prefill_tokens_per_step < 0:
            raise ValueError("prefill_tokens_per_step must be >= 0")
        if self.page_size < 1:
            raise ValueError("page_size must be >= 1")
        if self.kv_budget % self.page_size:
            raise ValueError("kv_budget must be a multiple of page_size")
        if self.step_token_budget is not None:
            if self.step_token_budget < 1:
                raise ValueError("step_token_budget must be >= 1")
            if self.prefill_tokens_per_step:
                raise ValueError(
                    "step_token_budget and prefill_tokens_per_step are "
                    "mutually exclusive prefill cost models")
        if self.prefill_chunk_tokens < 0:
            raise ValueError("prefill_chunk_tokens must be >= 0")
        if self.prefill_chunk_tokens and self.step_token_budget is None:
            raise ValueError(
                "prefill_chunk_tokens needs step_token_budget (chunked "
                "prefill is a budget-mode knob)")

    @property
    def service_rate(self) -> float:
        """Decode tokens per step at full occupancy (the router's view of
        how fast this replica drains work)."""
        return float(self.max_slots * self.speed)


@dataclass
class ServeStats:
    policy: str
    makespan: float
    mean_latency: float
    p50_latency: float
    p90_latency: float
    p99_latency: float
    mean_wait: float
    throughput: float              # completed tokens / step
    kv_waste_ratio: float
    overflow_events: int
    # per-replica pool high-water mark; fleet-level pressure is reported as
    # occupancy, and replica_rows keeps the per-replica peaks
    peak_reserved: int  # reprolint: disable=stats-cluster-parity
    completed: int
    preemptions: int = 0
    oom_evictions: int = 0
    dropped: int = 0               # unservable: need exceeds the whole pool
    # deadline passed while queued (incl. preempted requests awaiting resume)
    timed_out: int = 0
    slo_violations: int = 0        # completed, but past the deadline
    goodput: float = 0.0           # within-SLO completed tokens / step
    # paged-KV accounting (page_size=1 ⇒ occupancy of the scalar pool,
    # frag_ratio == 0, and the held_* columns are 0 unless preempt_mode="keep")
    # replica identity, not a counter: a heterogeneous fleet has no single
    # page size — replica_rows carries the per-replica values
    page_size: int = 1  # reprolint: disable=stats-cluster-parity
    occupancy: float = 0.0         # mean reserved fraction of the pool
    frag_ratio: float = 0.0        # page-rounding slack / reserved integral
    held_peak: int = 0             # peak tokens held by preempted waiters
    held_steps: float = 0.0        # token-steps held while preempted-queued
    held_releases: int = 0         # held pages dropped to break memory stalls
    recompute_ticks: int = 0       # prefill ticks re-paid for preempted work
    # prefix sharing (all inert unless share_prefixes=True + tagged requests)
    kv_amplification: float = 1.0  # logical / physical reserved token-steps
    prefix_hits: int = 0           # admissions that reused shared pages
    cow_copies: int = 0            # divergence-boundary pages privatized
    prefix_evictions: int = 0      # cached prefixes reclaimed under pressure
    shared_peak: int = 0           # peak tokens in live shared pages
    prefill_ticks: int = 0         # prefill ticks actually paid
    prefill_saved_ticks: int = 0   # prefill ticks erased by prefix hits
    # posterior refinement (all 0 unless Policy.refine_every > 0)
    refine_events: int = 0         # active-slot quantile refreshes applied
    refine_shrinks: int = 0        # re-reservations that released pages
    refine_grows: int = 0          # re-reservations that drew new pages
    # time-to-first-token percentiles (t_first_token − arrival, over
    # completed requests that emitted at least one token; inf when none did)
    mean_ttft: float = float("inf")
    p50_ttft: float = float("inf")
    p90_ttft: float = float("inf")
    p99_ttft: float = float("inf")

    def row(self) -> dict:
        return self.__dict__.copy()


class SimEngine:
    """Discrete-event continuous-batching simulator (one replica).

    Scheduling semantics per :meth:`step`:

    1. *admit*: drop expired queue heads (``timed_out``), then pop ready
       requests in policy order — FCFS/SJF/SRTF or the deadline-aware EDF /
       least-laxity orderings (see :mod:`repro.serving.scheduler`) — while a
       slot and KV reservation budget are available (head-of-line blocks on
       memory). An admitted slot first spends its prefill ticks (see
       :class:`ReplicaSpec`) emitting nothing;
    2. *preempt* (SRTF policies): the ready request with the shortest
       predicted remaining length evicts the longest-remaining active slot
       when the gap exceeds ``preempt_factor`` (progress is kept). Under
       ``Policy.preempt_mode="recompute"`` the victim's whole reservation is
       released and resume re-reserves — and re-prefills — from scratch;
       under ``"keep"`` the victim shrinks its reservation to the pages it
       has already filled and *holds* them while queued, so resume reserves
       only the delta pages and skips the prefill recompute (a victim still
       in prefill always recomputes — its pages hold no finished work yet);
    3. *decode*: every active non-prefilling slot emits ``spec.speed``
       tokens. A slot that would outgrow its reservation first grows it by
       max(25%, 16, speed) tokens; if the budget refuses, the slot emits
       only what fits (possibly nothing) this tick and retries next tick.

    Held pages count toward the reservation integral but not the usage one:
    the waste/occupancy metrics price exactly the memory that keep-mode
    preemption pins while its owner waits. When every slot is idle or
    stalled *because* queued holders pin the pool, the engine releases held
    pages (largest-queue-key holders first — ``held_releases``), reverting
    those requests to recompute semantics rather than deadlocking.
    """

    def __init__(self, max_slots: Optional[int] = None,
                 kv_budget: Optional[int] = None,
                 policy: Optional[Policy] = None, predictor=None,
                 vectorized: bool = True, spec: Optional[ReplicaSpec] = None,
                 refiner=None, tracer=None):
        if spec is None:
            if max_slots is None or kv_budget is None:
                raise ValueError(
                    "SimEngine needs either spec=ReplicaSpec(...) or both "
                    "max_slots and kv_budget")
            spec = ReplicaSpec(max_slots=max_slots, kv_budget=kv_budget)
        if policy is None:
            raise ValueError("SimEngine needs a scheduling policy")
        self.spec = spec
        self.max_slots = spec.max_slots
        self.policy = policy
        self.predictor = predictor
        self.vectorized = vectorized
        # posterior refinement (Policy.refine_every > 0): every refine tick
        # the engine re-conditions active-slot histograms on decode progress
        # via this PosteriorRefiner; 0 keeps every legacy path bit-identical
        # (the refiner, if passed, is never consulted)
        self.refiner = refiner
        self._refine_every = int(policy.refine_every)
        if self._refine_every > 0 and refiner is None:
            raise ValueError(
                "Policy.refine_every > 0 needs a PosteriorRefiner over the "
                "predictor's bin edges (pass refiner=... to the engine)")
        self._kv_budget = spec.kv_budget
        # step-token-budget mode: None keeps every legacy path bit-identical
        self._budget = spec.step_token_budget
        # effective per-slot prefill chunk: the explicit cap, else the whole
        # budget; _atomic marks the non-chunked model (prefill ticks dedicate
        # the entire budget to prefill and decode pauses)
        self._chunk = min(spec.prefill_chunk_tokens or (spec.step_token_budget
                                                        or 0),
                          spec.step_token_budget or 0)
        self._atomic = spec.prefill_chunk_tokens == 0
        # optional telemetry (repro.serving.telemetry.Tracer): every hook is
        # an `if tracer is not None` read-only branch, so tracer=None stays
        # bit-identical to a tracer-less build (golden-pinned). Gauge sample
        # ticks are evented (like refine ticks), so both decode paths sample
        # identical state at identical ticks.
        self.tracer = tracer
        self.replica_id = 0     # a Cluster labels its engines 0..N-1
        self._sample_every = int(tracer.sample_every) \
            if tracer is not None else 0
        self.reset()

    # -- lifecycle -----------------------------------------------------------

    def reset(self):
        self.kv = KVCacheManager(budget_tokens=self._kv_budget,
                                 page_size=self.spec.page_size,
                                 share_prefixes=self.spec.share_prefixes)
        self.t = 0.0
        self.preemptions = 0
        self.oom_evictions = 0
        self.dropped = 0
        self.timed_out = 0
        self.slo_violations = 0
        self.recompute_ticks = 0
        self.prefill_ticks = 0
        self.prefill_saved_ticks = 0
        self.held_releases = 0
        self.refine_events = 0
        self.refine_shrinks = 0
        self.refine_grows = 0
        # next tick whose start crosses the refine schedule (multiples of
        # refine_every); kept a pure function of t so both decode paths and
        # idle skips land on identical refine ticks
        self._next_refine = float(self._refine_every) if self._refine_every \
            else np.inf
        # next gauge-sample tick (pure function of t, like _next_refine)
        self._next_sample = float(self._sample_every) if self._sample_every \
            else np.inf
        self._held_tokens = 0       # Σ tokens held by preempted waiters here
        self._held_ready = 0        # the ready-queue (releasable) part
        self._held_peak = 0
        self._held_steps = 0.0
        self._progress = True       # did the last decode tick advance any slot?
        self._seq = 0                       # heap tie-break, FIFO among ties
        self._future: list = []             # (due tick, seq, Request)
        self._future_need = 0               # Σ future reservation needs
        self._future_pred = 0.0             # Σ future predicted remaining
        self._ready: list = []              # (policy key, seq, Request)
        self._ready_need = 0                # Σ queued reservation needs
        self._ready_pred = 0.0              # Σ queued predicted remaining
        self._slots: List[Request] = []     # active, admission order
        self._n_active = 0
        m = self.max_slots
        self._a_gen = np.zeros(m, np.int64)
        self._a_used = np.zeros(m, np.int64)
        self._a_res = np.zeros(m, np.int64)
        self._a_plen = np.zeros(m, np.int64)
        self._a_tlen = np.zeros(m, np.int64)
        self._a_pref = np.zeros(m, np.int64)    # remaining prefill ticks
        self._a_pftok = np.zeros(m, np.int64)   # remaining prefill tokens
        #                                         (step_token_budget mode)
        self._a_pred = np.zeros(m, np.float64)
        self._a_shared = np.zeros(m, np.int64)  # grant tokens on shared pages
        # Σ physical used tokens of active slots: each slot's (used − shared)
        # — shared-page content is integrated once via kv.shared_now instead
        # of once per referencing slot. Sharing off ⇒ plain Σ used.
        self._used_sum = 0
        self._done: List[Request] = []
        self._timed_out: List[Request] = []

    # -- queue ---------------------------------------------------------------

    def _order_key(self, r: Request) -> float:
        # max_cap lets quantile_remaining spot an uninformative reserve="max"
        # reservation and fall through to the point prediction; the refiner
        # (refinement enabled only) keeps over-runner keys well-defined
        return order_key(r, self.policy.order,
                         max_cap=float(self.policy.max_seq_len),
                         refiner=self.refiner if self._refine_every else None)

    @staticmethod
    def _queue_need(r: Request) -> int:
        """Incremental KV a queued request still needs to start: its full
        reservation, minus the pages a keep-mode preemption left it holding
        (those already sit in ``kv.reserved_now``, so counting them again
        would double-bill every router/steal/admission signal)."""
        return max(0, int(r.prompt_len + r.reserve_len) - r.held)

    def _push_ready(self, r: Request):
        self._seq += 1
        heapq.heappush(self._ready, (self._order_key(r), self._seq, r))
        self._ready_need += self._queue_need(r)
        self._ready_pred += predicted_remaining(r)
        self._held_ready += r.held

    def _forget_ready(self, r: Request):
        """Undo _push_ready's aggregate accounting for a departing entry."""
        self._ready_need -= self._queue_need(r)
        self._ready_pred -= predicted_remaining(r)
        self._held_ready -= r.held

    def _pop_ready(self) -> Request:
        _, _, r = heapq.heappop(self._ready)
        self._forget_ready(r)
        return r

    def submit(self, requests: List[Request], after: Optional[float] = None):
        """Enqueue requests (already annotated with predictions/reservations).
        Requests with a future arrival wait in the arrival heap. ``after``
        holds entries back until that tick even if they already arrived —
        the work-stealing migration delay (KV pages / prompt re-transfer):
        a stolen request becomes runnable on the thief only at
        ``max(arrival, after)``, while latency still counts from ``arrival``.
        """
        for r in requests:
            due = float(r.arrival) if after is None \
                else max(float(r.arrival), float(after))
            if due > self.t:
                self._seq += 1
                heapq.heappush(self._future, (due, self._seq, r))
                self._future_need += self._queue_need(r)
                self._future_pred += predicted_remaining(r)
            else:
                self._push_ready(r)

    @property
    def idle(self) -> bool:
        return not (self._n_active or self._ready or self._future)

    @property
    def done(self) -> List[Request]:
        return self._done

    @property
    def timed_out_requests(self) -> List[Request]:
        return self._timed_out

    # -- router signals (cluster dispatch) -----------------------------------
    # these count the future heap too: in cluster use it holds exactly the
    # in-transit stolen requests (steal_cost migration delay) — work already
    # assigned to this replica that load signals must not ignore, or
    # consecutive rebalances would over-steal to the same thief

    @property
    def outstanding_requests(self) -> int:
        return self._n_active + len(self._ready) + len(self._future)

    @property
    def outstanding_kv(self) -> int:
        """Reserved KV of active slots + reservation needs of the queue
        (including in-transit migrations)."""
        return self.kv.reserved_now + self._ready_need + self._future_need

    def predicted_backlog(self) -> float:
        """Predicted remaining decode tokens across active + queued +
        in-transit requests (the ProD signal a predicted-shortest-queue
        router dispatches on)."""
        n = self._n_active
        act = float(np.maximum(self._a_pred[:n] - self._a_gen[:n], 1.0).sum())
        return act + self._ready_pred + self._future_pred

    # -- work stealing (cluster rebalance) -----------------------------------

    def steal_queued(self, k: int, mode: str = "tail",
                     fit: Optional[int] = None,
                     fit_page_size: int = 1) -> List[Request]:
        """Remove up to ``k`` queued (ready, never active) requests so the
        cluster can migrate them to a less-loaded replica.

        ``mode='tail'`` takes the entries the local policy would serve last
        (classic work-stealing deque: the owner pops the head, the thief
        steals the tail). ``mode='quantile'`` is the ProD-aware variant: it
        takes the requests with the largest predicted-quantile remaining work
        (``reserve_len`` − progress), moving the most token-load per steal.
        ``fit`` restricts stealing to requests whose full reservation need
        fits that budget (the thief's KV pool) — a keep-mode holder's kept
        pages migrate with it and are re-reserved out of the thief's pool,
        so its delta need alone would understate feasibility and strand an
        oversized request on a small replica (dropped on arrival). The need
        is rounded up to whole pages of ``fit_page_size`` — the *thief's*
        page granularity, which can be coarser than the donor's: comparing
        raw tokens would pass a request whose page-rounded grant exceeds
        the thief's pool, only for the thief to drop it on arrival.
        """
        if k <= 0 or not self._ready:
            return []
        if mode == "quantile":
            cap = float(self.policy.max_seq_len)
            rz = self.refiner if self._refine_every else None

            def keyf(e):
                return (quantile_remaining(e[2], max_cap=cap, refiner=rz),
                        e[1])
        else:   # 'tail': largest policy key = served last
            keyf = None
        idx = sorted(range(len(self._ready)),
                     key=(lambda i: keyf(self._ready[i])) if keyf
                     else self._ready.__getitem__)
        if fit is not None:
            ps = max(1, int(fit_page_size))

            def rounded_need(r):
                need = int(r.prompt_len + r.reserve_len)
                return -(-need // ps) * ps   # thief's page-rounded grant

            idx = [i for i in idx
                   if rounded_need(self._ready[i][2]) <= fit]
        chosen = idx[len(idx) - min(k, len(idx)):]   # largest keys last
        if not chosen:
            return []
        chosen_set = set(chosen)
        keep = [e for i, e in enumerate(self._ready) if i not in chosen_set]
        out = [self._ready[i][2] for i in chosen]
        self._ready = keep
        heapq.heapify(self._ready)
        for r in out:
            self._forget_ready(r)
        return out

    # -- partial-reservation handoff (keep-mode pages crossing replicas) -----

    def export_held(self, r: Request) -> int:
        """Donor side of a page handoff: the migrating request's kept pages
        leave this replica's pool (their contents travel with the steal).
        Returns the token count that left."""
        held = r.held
        if held:
            self.kv.release(r.rid)
            self._held_tokens -= held
        return held

    def adopt_held(self, r: Request) -> bool:
        """Thief side of a page handoff: re-reserve the migrated pages in
        this pool, re-rounded to this replica's page size (joining this
        pool's copy of the request's prefix, if resident). On failure the
        pages are dropped and the request reverts to recompute semantics
        (progress tokens kept, prefill re-paid)."""
        if not r.held:
            return False
        if self.kv.admit(r.rid, r.held, r.prefix_id,
                         min(int(r.prefix_len), int(r.held))):
            r.held = self.kv.reserved[r.rid]
            self._held_tokens += r.held
            self._held_peak = max(self._held_peak, self._held_tokens)
            return True
        r.held = 0
        return False

    # -- one engine tick -----------------------------------------------------

    @staticmethod
    def _prefix_args(r: Request):
        """The (prefix_id, prefix_len) pair every admission-path KV call must
        pass identically — _admit, the stall breaker, and ticks_to_event —
        or the event leap would disagree with the step about feasibility."""
        return r.prefix_id, min(int(r.prefix_len), int(r.prompt_len))

    def _prefill_ticks(self, r: Request) -> int:
        """Admission cost: ceil(prompt tokens / prefill rate). A resumed
        request that kept its pages (``r.held``) has its prompt + progress
        KV already resident — no recompute. One that lost them recomputes
        prompt + generated progress (vLLM recompute-preemption semantics);
        that whole resume charge is re-work, counted in ``recompute_ticks``.
        Prompt tokens covered by a shared-prefix cache hit are already
        resident too — they are skipped, and the erased ticks are counted in
        ``prefill_saved_ticks``. Call after the KV reservation (the skip is
        recorded at admit)."""
        pts = self.spec.prefill_tokens_per_step
        if pts <= 0:
            return 0
        if r.held > 0:
            return 0
        work = r.prompt_len + r.generated
        full = -(-work // pts)
        skip = min(self.kv.prefill_skip(r.rid), r.prompt_len)
        ticks = -(-(work - skip) // pts) if work > skip else 0
        if r.generated > 0:
            self.recompute_ticks += ticks
        self.prefill_ticks += ticks
        self.prefill_saved_ticks += full - ticks
        return ticks

    def _prefill_tokens(self, r: Request) -> int:
        """Budget-mode admission cost: prompt tokens the slot must pull from
        the step token budget before its first decode token — prompt plus
        recompute progress, minus the shared-prefix skip; a keep-mode holder
        resumes free. The tick-based counters keep their meaning in chunk
        units: ``recompute_ticks``/``prefill_saved_ticks`` are estimated at
        the effective chunk rate here, ``prefill_ticks`` counts the slot-
        ticks the budgeted tick actually spends (call after the KV
        reservation — the skip is recorded at admit)."""
        if r.held > 0:
            return 0
        work = int(r.prompt_len + r.generated)
        skip = min(self.kv.prefill_skip(r.rid), int(r.prompt_len))
        toks = max(work - skip, 0)
        ce = max(self._chunk, 1)
        if r.generated > 0:
            self.recompute_ticks += -(-toks // ce)
        self.prefill_saved_ticks += -(-work // ce) - (-(-toks // ce))
        return toks

    def _expire_ready_head(self):
        """Drop ready-queue heads that can never start here: reservation need
        larger than this replica's entire KV pool (``dropped`` — reachable on
        heterogeneous fleets when routing or stealing lands an oversized
        request on a small replica, and it must not wedge the queue), or
        deadline passed (``timed_out`` — includes preempted requests waiting
        to resume; their progress is discarded). Only the head is checked
        (lazy TTL): entries deeper in the queue are dropped when they
        surface, so router load signals may transiently count them. A
        departing entry's held pages are released here — and only here, when
        it actually times out or proves unservable."""
        while self._ready:
            r = self._ready[0][2]
            need = int(r.prompt_len + r.reserve_len)
            # sharing-aware servability: a raw pages_for(need) > pages_total
            # test would wrongly drop a session follow-up whose resident
            # shared prefix (or kept pages) already covers part of its need
            if not self.kv.servable(r.rid, need, *self._prefix_args(r)):
                self._pop_ready()
                self._drop_held(r)
                self.dropped += 1
                if self.tracer is not None:
                    self.tracer.emit(self.t, self.replica_id, r.rid,
                                     "dropped", need=need)
                continue
            if r.deadline is None or r.deadline >= self.t:
                break
            self._pop_ready()
            self._drop_held(r)
            self.timed_out += 1
            self._timed_out.append(r)
            if self.tracer is not None:
                self.tracer.emit(self.t, self.replica_id, r.rid, "timeout",
                                 deadline=float(r.deadline))

    def _drop_held(self, r: Request):
        """Release the pages a departing (timed-out/dropped/stall-broken)
        holder was keeping. Call after the entry left the ready queue."""
        if r.held:
            self.kv.release(r.rid)
            self._held_tokens -= r.held
            r.held = 0

    def _release_queued_held(self, spare: Optional[Request] = None,
                             need: Optional[int] = None,
                             max_n: Optional[int] = None) -> int:
        """Break a held-pages memory stall: release the pages of ready-queue
        holders — largest (policy key, seq) first, i.e. the entries this
        queue would serve last — reverting them to recompute semantics.
        With ``spare``/``need`` set, stop as soon as ``spare`` fits;
        ``max_n`` caps how many holders are sacrificed per call. Returns how
        many were released."""
        released = 0
        for _, _, r in sorted(self._ready, reverse=True):
            if r.held == 0 or r is spare:
                continue
            before = self._queue_need(r)
            freed = r.held
            self.kv.release(r.rid)
            self._held_tokens -= r.held
            self._held_ready -= r.held
            r.held = 0
            self._ready_need += self._queue_need(r) - before
            self.held_releases += 1
            released += 1
            if self.tracer is not None:
                self.tracer.emit(self.t, self.replica_id, r.rid,
                                 "held_release", tokens=int(freed))
            if max_n is not None and released >= max_n:
                break
            if (spare is not None
                    and self.kv.can_reserve(spare.rid, need,
                                            *self._prefix_args(spare))):
                break
        return released

    def _admit(self):
        while self._future and self._future[0][0] <= self.t:
            _, _, r = heapq.heappop(self._future)
            self._future_need -= self._queue_need(r)
            self._future_pred -= predicted_remaining(r)
            self._push_ready(r)
        self._expire_ready_head()
        while self._n_active < self.max_slots and self._ready:
            _, _, cand = self._ready[0]
            need = int(cand.prompt_len + cand.reserve_len)
            pfx = self._prefix_args(cand)
            if not self.kv.can_reserve(cand.rid, need, *pfx):
                # nothing active to free memory, yet queued holders pin the
                # pool: release their pages (recompute for them) so the head
                # can start — without this, keep mode can wedge the queue
                if not (self._n_active == 0
                        and self._held_ready > cand.held
                        and self._release_queued_held(cand, need)
                        and self.kv.can_reserve(cand.rid, need, *pfx)):
                    break  # KV-bound: head-of-line blocks on memory
            self.kv.reserve(cand.rid, need, *pfx)  # full need (joining the
            self._pop_ready()                      # prefix), delta if holding
            if cand.t_start is None:
                cand.t_start = self.t
            i = self._n_active
            self._slots.append(cand)
            self._a_gen[i] = cand.generated      # preempted resume w/ progress
            self._a_used[i] = cand.prompt_len + cand.generated
            self._a_res[i] = self.kv.reserved[cand.rid]  # page-rounded grant
            self._a_plen[i] = cand.prompt_len
            self._a_tlen[i] = cand.true_len
            if self._budget is None:
                self._a_pref[i] = self._prefill_ticks(cand)
                self._a_pftok[i] = 0
            else:
                self._a_pref[i] = 0
                self._a_pftok[i] = self._prefill_tokens(cand)
            self._a_pred[i] = (cand.predicted_len
                               if cand.predicted_len is not None
                               else float(cand.true_len))
            self._a_shared[i] = self.kv.shared_tokens_of(cand.rid)
            if cand.held:                        # kept pages now active again
                self._held_tokens -= cand.held
                cand.held = 0
            self._used_sum += int(self._a_used[i]) - int(self._a_shared[i])
            self._n_active += 1
            if self.tracer is not None:
                self.tracer.emit(
                    self.t, self.replica_id, cand.rid, "admitted",
                    grant=int(self._a_res[i]),
                    pf=int(self._a_pref[i]) or int(self._a_pftok[i]),
                    resumed=int(cand.generated > 0))
            self._expire_ready_head()

    def _maybe_preempt(self):
        # SRTF preemption: a waiting request with much shorter predicted
        # remaining evicts the longest-remaining active one (ProD-O's
        # remaining-length signal makes this decision possible)
        if not (self.policy.preempt and self._n_active and self._ready):
            return
        newcomer = self._ready[0][2]
        n = self._n_active
        rem = np.maximum(self._a_pred[:n] - self._a_gen[:n], 1.0)
        v = int(np.argmax(rem))
        if rem[v] > self.policy.preempt_factor * predicted_remaining(newcomer):
            victim = self._slots[v]
            victim.generated = int(self._a_gen[v])
            if (self.policy.preempt_mode == "keep" and self._a_pref[v] == 0
                    and self._a_pftok[v] == 0):
                # keep-pages: shrink to the filled pages and hold them, so
                # resume reserves only the delta and skips the prefill
                # recompute. A victim still prefilling has nothing finished
                # in its pages yet, so it always takes the recompute path.
                victim.held = self.kv.shrink(victim.rid, int(self._a_used[v]))
                self._held_tokens += victim.held
                self._held_peak = max(self._held_peak, self._held_tokens)
            else:
                self.kv.release(victim.rid)
            self._used_sum -= int(self._a_used[v]) - int(self._a_shared[v])
            self._drop_slot(v)
            self._push_ready(victim)   # resumes later with progress kept
            self.preemptions += 1
            if self.tracer is not None:
                self.tracer.emit(
                    self.t, self.replica_id, victim.rid, "preempted",
                    kept=int(victim.held),
                    mode="keep" if victim.held else "recompute")

    def _drop_slot(self, i: int):
        """Remove slot i, keeping admission order (stable left shift)."""
        n = self._n_active
        self._slots.pop(i)
        for a in (self._a_gen, self._a_used, self._a_res, self._a_plen,
                  self._a_tlen, self._a_pref, self._a_pftok, self._a_pred,
                  self._a_shared):
            a[i:n - 1] = a[i + 1:n]
        self._n_active = n - 1

    def _finish_slot(self, i: int):
        r = self._slots[i]
        r.t_finish = self.t
        r.generated = int(self._a_gen[i])
        if r.deadline is not None and r.t_finish > r.deadline:
            self.slo_violations += 1
        self.kv.release(r.rid)
        self._used_sum -= int(self._a_used[i]) - int(self._a_shared[i])
        self._drop_slot(i)
        self._done.append(r)
        if self.tracer is not None:
            self.tracer.emit(self.t, self.replica_id, r.rid, "finish",
                             gen=int(r.generated), slo_ok=int(bool(r.slo_met)))
            self.tracer.observe_residual(r)

    def _decode_tick_ref(self):
        """Reference per-slot decode loop (exact sequential semantics)."""
        self._progress = False
        sp = self.spec.speed
        i = 0
        while i < self._n_active:
            if self._a_pref[i] > 0:
                self._a_pref[i] -= 1    # prefill tick: no token emitted
                self._progress = True
                i += 1
                continue
            r = self._slots[i]
            emit = min(sp, int(self._a_tlen[i] - self._a_gen[i]))
            if emit <= 0:
                # degenerate zero-remaining request (true_len == generated,
                # e.g. a directly-constructed true_len=0): finishes without
                # emitting, matching the vectorized finished-mask semantics
                self._progress = True
                self._finish_slot(i)
                continue
            res = int(self._a_res[i])
            head = res - int(self._a_plen[i] + self._a_gen[i])
            if emit > head:
                # outgrew reservation: grow or emit what fits (overflow)
                if self.kv.grow(r.rid, max(int(0.25 * res), 16, sp)):
                    self._a_res[i] = self.kv.reserved[r.rid]
                    r.overflows += 1
                    # the paged grow grants whole pages, which (for
                    # page_size < speed) can still fall short of emit:
                    # re-clamp so a slot never emits past its granted pages
                    head = int(self._a_res[i]) \
                        - int(self._a_plen[i] + self._a_gen[i])
                if emit > head:
                    emit = head     # partial; 0 == stalled this tick
            if emit <= 0:
                i += 1
                continue  # stalled on the reservation, retries next tick
            if r.t_first_token is None:
                r.t_first_token = self.t
                if self.tracer is not None:
                    self.tracer.emit(self.t, self.replica_id, r.rid,
                                     "first_token")
            self._a_gen[i] += emit
            self._a_used[i] += emit
            self._used_sum += emit
            self._progress = True
            if self._a_gen[i] >= self._a_tlen[i]:
                self._finish_slot(i)
            else:
                i += 1
        if self._n_active and not self._progress:
            self._evict_stalled()

    def _evict_stalled(self):
        """KV deadlock breaker: every active slot is stalled on a reservation
        grow the budget cannot satisfy, and (with no completions pending) no
        waiting can change that. Preempt the most recently admitted slot
        (vLLM-style recompute preemption, progress kept) so the freed tokens
        let the remaining slots grow. The victim's reservation ask is bumped
        past its current progress so its re-admission can emit tokens —
        clamped to the pool size so the request stays admittable. A victim
        whose clamped ask buys no headroom needs more KV than the whole pool
        holds: it can never finish under any policy, so it is dropped.

        When queued keep-mode holders pin part of the pool, one holder's
        pages are released per stall tick instead (cheaper: that request
        merely falls back to recompute, and the rest keep their pages);
        eviction retries next tick if decode is still stuck."""
        if self._held_ready > 0 and self._release_queued_held(max_n=1):
            return
        v = self._n_active - 1
        victim = self._slots[v]
        victim.generated = int(self._a_gen[v])
        ask = max(victim.reserve_len * 1.25,
                  victim.generated + float(max(16, self.spec.speed)))
        ask = min(ask, float(self.kv.budget_tokens - victim.prompt_len))
        self.kv.release(victim.rid)
        self._used_sum -= int(self._a_used[v]) - int(self._a_shared[v])
        self._drop_slot(v)
        self.oom_evictions += 1
        if self.tracer is not None:
            self.tracer.emit(self.t, self.replica_id, victim.rid,
                             "oom_evict", ask=float(ask))
        if int(victim.prompt_len + ask) <= victim.prompt_len + victim.generated:
            self.dropped += 1      # unservable: exceeds the entire KV pool
            if self.tracer is not None:
                self.tracer.emit(self.t, self.replica_id, victim.rid,
                                 "dropped", need=int(victim.prompt_len + ask))
            return
        victim.reserve_len = float(ask)
        self._push_ready(victim)

    def _decode_tick_vec(self):
        """Vectorized decode over all active slots. Falls back to the
        reference loop on ticks with reservation growth (rare), where budget
        interactions are inherently sequential — keeping both paths exact."""
        n = self._n_active
        if n == 0:
            return
        sp = self.spec.speed
        pref = self._a_pref[:n] > 0
        emit = np.where(pref, 0,
                        np.minimum(sp, self._a_tlen[:n] - self._a_gen[:n]))
        if bool(np.any(self._a_plen[:n] + self._a_gen[:n] + emit
                       > self._a_res[:n])):
            # budget mode reaches here only on unconstrained ticks, where the
            # budgeted reference tick and the plain one agree — but route
            # through the budgeted one so the two paths share one code path
            # dispatch guard only: step() performs this same budget dispatch
            # for the reference path, so the knob is consulted on both
            if self._budget is None:  # reprolint: disable=dual-path-knob-parity
                self._decode_tick_ref()
            else:
                self._decode_tick_budget()
            return
        first = (self._a_gen[:n] == 0) & (emit > 0)
        if bool(first.any()):
            for i in np.nonzero(first)[0]:
                r = self._slots[int(i)]
                if r.t_first_token is None:
                    r.t_first_token = self.t
                    if self.tracer is not None:
                        self.tracer.emit(self.t, self.replica_id, r.rid,
                                         "first_token")
        self._progress = True
        self._a_pref[:n] -= pref
        self._a_gen[:n] += emit
        self._a_used[:n] += emit
        self._used_sum += int(emit.sum())
        finished = self._a_gen[:n] >= self._a_tlen[:n]
        if bool(finished.any()):
            for off, i in enumerate(np.nonzero(finished)[0]):
                self._finish_slot(int(i) - off)

    # budget-constrained ticks are always evented (ticks_to_event returns 1.0
    # via _budget_constrained), so the leap never spans a tick where the
    # chunk-allocation knobs below matter — deliberately reference-only
    def _decode_tick_budget(self):  # reprolint: disable=dual-path-knob-parity
        """One budgeted tick (``step_token_budget`` engines): prefill chunks
        and decode tokens draw from one shared token budget.

        1. *prefill*: each prefilling slot pulls up to ``prefill_chunk_tokens``
           of its remaining prompt from the budget, in ``Policy.chunk_order``
           (``fcfs`` = slot admission order, ``prod`` = predicted-short first,
           earliest deadline breaking ties). With ``prefill_chunk_tokens=0``
           (*atomic*) a prefill tick dedicates the whole budget to prefill
           and decode pauses — the non-chunked model.
        2. *decode*: the leftover budget feeds decoding slots in admission
           order, each emitting up to ``speed`` tokens; later slots emit
           less (or nothing) on ticks where prefill spent the budget. The
           reservation-growth/stall semantics mirror the reference loop.

        A slot whose last prefill chunk lands this tick emits its first
        token next tick, matching the tick-based prefill model. This is the
        *reference* semantics for budget mode; the vectorized path uses it
        verbatim on constrained ticks, so both paths stay bit-identical.
        """
        self._progress = False
        n = self._n_active
        if n == 0:
            return
        sp = self.spec.speed
        left = int(self._budget)
        pf = [i for i in range(n) if self._a_pftok[i] > 0]
        if pf:
            if self.policy.chunk_order == "prod":
                def chunk_key(j):
                    r = self._slots[j]
                    dl = float(r.deadline) if r.deadline is not None \
                        else float("inf")
                    return (float(self._a_pred[j]), dl, j)
                pf.sort(key=chunk_key)
            cap = left if self._atomic else self._chunk
            for j in pf:
                if left <= 0:
                    break
                take = min(cap, int(self._a_pftok[j]), left)
                if take <= 0:
                    continue
                self._a_pftok[j] -= take
                left -= take
                self.prefill_ticks += 1
                self._progress = True
                if self.tracer is not None:
                    self.tracer.emit(self.t, self.replica_id,
                                     self._slots[j].rid, "prefill_chunk",
                                     take=int(take),
                                     left=int(self._a_pftok[j]))
            if self._atomic:
                left = 0    # non-chunked: a prefill tick pauses decode
        was_pref = {self._slots[j].rid for j in pf}
        i = 0
        while i < self._n_active:
            r = self._slots[i]
            if r.rid in was_pref:
                i += 1      # still prefilling (or finished its prompt this
                continue    # tick): first decode token comes next tick
            emit = min(sp, int(self._a_tlen[i] - self._a_gen[i]))
            if emit <= 0:
                # degenerate zero-remaining request: finishes without
                # emitting (and without charging the budget)
                self._progress = True
                self._finish_slot(i)
                continue
            emit = min(emit, left)
            if emit <= 0:
                i += 1      # budget spent upstream — not a memory stall,
                continue    # this tick already made progress elsewhere
            res = int(self._a_res[i])
            head = res - int(self._a_plen[i] + self._a_gen[i])
            if emit > head:
                if self.kv.grow(r.rid, max(int(0.25 * res), 16, sp)):
                    self._a_res[i] = self.kv.reserved[r.rid]
                    r.overflows += 1
                    head = int(self._a_res[i]) \
                        - int(self._a_plen[i] + self._a_gen[i])
                if emit > head:
                    emit = head     # partial; 0 == stalled this tick
            if emit <= 0:
                i += 1
                continue
            if r.t_first_token is None:
                r.t_first_token = self.t
                if self.tracer is not None:
                    self.tracer.emit(self.t, self.replica_id, r.rid,
                                     "first_token")
            self._a_gen[i] += emit
            self._a_used[i] += emit
            self._used_sum += emit
            left -= emit
            self._progress = True
            if self._a_gen[i] >= self._a_tlen[i]:
                self._finish_slot(i)
            else:
                i += 1
        if self._n_active and not self._progress:
            self._evict_stalled()

    def _budget_constrained(self) -> bool:
        """Is the *next* tick one the shared token budget can shape? True
        when any slot is prefilling (chunks interleave with decode) or the
        decoding slots' full demand exceeds the budget. Unconstrained ticks
        are plain fixed-speed decode — leapable with the legacy arithmetic.
        """
        n = self._n_active
        if n == 0:
            return False
        if bool((self._a_pftok[:n] > 0).any()):
            return True
        return n * self.spec.speed > self._budget

    def _refine_active(self):
        """Posterior refinement of every decoding slot (one refine tick).

        For each active slot with a ProD-D histogram and decode progress
        t > 0, re-condition on survival (P[L = ℓ | L > t] via the
        :class:`~repro.core.online.PosteriorRefiner`) and refresh:

        * the median → ``predicted_len`` / ``_a_pred`` (SRTF victim choice,
          ``chunk_order="prod"``, predicted-backlog routing);
        * the work quantile → ``pred_q`` (laxity / quantile-steal keys);
        * the reservation quantile → ``reserve_len`` + a KV ``reprice``
          (pages released when the posterior moved the page-rounded grant
          down, delta pages drawn — feasibility-checked — when it moved up).

        Reservation re-cuts happen at the request's *effective* dispatch
        level: for conformally-calibrated requests the level is recovered
        once from (histogram, ``cal_q``) — the OnlineAdapter's ACI-adjusted
        ``q_eff`` — and ``cal_q`` is refreshed to the posterior quantile at
        that same level, so ACI coverage tracks the refreshed estimate
        (conformal-on-posterior). Slots still prefilling, at t = 0, or
        without a histogram (oracle annotation paths) are skipped; so are
        ``reserve="max"``/``"oracle"`` reservations (cap/realized — nothing
        to re-cut), though their ordering quantiles still refresh."""
        pol = self.policy
        rz = self.refiner
        sp = self.spec.speed
        for i in range(self._n_active):
            if self._a_pref[i] > 0 or self._a_pftok[i] > 0:
                continue            # prefilling: no decode progress yet
            t_dec = float(self._a_gen[i])
            if t_dec <= 0.0:
                continue            # posterior == prior at t = 0
            r = self._slots[i]
            p = r.pred_probs
            if p is None:
                continue            # no histogram attached (oracle paths)
            med, work = rz.quantiles(p, t_dec, (0.5, rz.work_quantile))
            r.predicted_len = float(med)
            r.pred_q = float(work)
            self._a_pred[i] = float(med)
            self.refine_events += 1
            action = "refresh"      # ordering quantiles only
            if pol.reserve == "quantile":
                if r.pred_level is None:
                    r.pred_level = rz.level_of(p, r.cal_q) \
                        if r.cal_q is not None else float(pol.quantile)
                tgt = rz.quantile(p, t_dec, r.pred_level)
            elif pol.reserve == "predicted":
                tgt = float(med) * pol.margin
            else:
                tgt = None          # max/oracle: reservation not prediction-cut
            if tgt is not None:
                res = float(min(max(tgt, 8.0), pol.max_seq_len))
                r.reserve_len = res
                if r.cal_q is not None:
                    r.cal_q = res   # conformal-on-posterior (see docstring)
                # page-boundary move only: floor at current content + one tick
                # of headroom so a shrink never forces an immediate
                # grow/overflow
                want = max(int(r.prompt_len) + int(np.ceil(res)),
                           int(self._a_used[i]) + sp)
                cur = self.kv.pages_of(r.rid)
                if self.kv.reprice(r.rid, want):
                    new = self.kv.pages_of(r.rid)
                    if new < cur:
                        self.refine_shrinks += 1
                        action = "shrink"
                    elif new > cur:
                        self.refine_grows += 1
                        action = "grow"
                    self._a_res[i] = self.kv.reserved[r.rid]
            if self.tracer is not None:
                self.tracer.emit(self.t, self.replica_id, r.rid, "refine",
                                 med=float(med), action=action)

    def step(self):
        """One engine tick: admit → (preempt) → decode one token per slot."""
        if self._refine_every and self.t >= self._next_refine:
            self._refine_active()
            self._next_refine = (np.floor(self.t / self._refine_every) + 1.0) \
                * self._refine_every
        if self._sample_every and self.t >= self._next_sample:
            # gauges read pre-admit state; sample ticks are evented (see
            # ticks_to_event), so both decode paths sample identical state
            self.tracer.sample_engine(self, self.t)
            self._next_sample = (np.floor(self.t / self._sample_every) + 1.0) \
                * self._sample_every
        if (self._n_active == 0 and not self._ready
                and (not self._future or self._future[0][0] > self.t)):
            self.t += 1.0   # fully idle tick: nothing to admit or decode
            return
        self._admit()
        self._maybe_preempt()
        self.t += 1.0
        if self._budget is not None:
            # budgeted engines: constrained ticks run the budgeted reference
            # tick (inherently sequential allocation); unconstrained ticks
            # are plain fixed-speed decode, so the vectorized fast path
            # applies unchanged and stays bit-identical
            if self.vectorized and not self._budget_constrained():
                self._decode_tick_vec()
            else:
                self._decode_tick_budget()
        elif self.vectorized:
            self._decode_tick_vec()
        else:
            self._decode_tick_ref()
        # reservation/usage integrals (waste metric), kept on the KV manager.
        # Physical usage = active slots' private content + each live shared
        # page's content once (shared_now); the logical integral is what a
        # sharing-blind pool would have reserved (kv_amplification's
        # numerator). Sharing off: shared_now == 0, logical == reserved.
        self.kv.total_reserved_steps += self.kv.reserved_now
        self.kv.total_asked_steps += self.kv.asked_now
        self.kv.total_used_steps += self._used_sum + self.kv.shared_now
        self.kv.total_logical_steps += self.kv.logical_now
        self._held_steps += self._held_tokens

    def advance_to(self, t: float):
        """Idle-skip the clock (no decode work in between)."""
        self.t = max(self.t, t)

    # -- event leap (vectorized fast path) -----------------------------------

    def ticks_to_event(self) -> float:
        """Ticks until the next tick that can admit, preempt, grow, complete,
        finish a prefill, expire a queued deadline, or see an arrival become
        due. Every tick strictly before that is provably eventless: prefilling
        slots burn one prefill tick, decoding slots emit ``speed`` tokens
        each, so the whole span can be advanced in closed form by
        :meth:`leap`."""
        k = np.inf
        sp = self.spec.speed
        if self._sample_every:
            # gauge-sample ticks are evented even when idle (an idle replica
            # still reports queue depth / occupancy rows), so a leap never
            # spans one and both decode paths sample at identical ticks
            k = min(k, max(1.0, self._next_sample - self.t))
        # lookahead mirror of step()'s refine prologue (shared by both decode
        # paths); the reference path needs no lookahead — it steps every tick
        if self._refine_every and self._n_active:  # reprolint: disable=dual-path-knob-parity
            # refine ticks are evented (like budget-constrained ticks):
            # leaps never span a posterior refresh, so both decode paths
            # refine at identical ticks and stay bit-exact
            k = min(k, max(1.0, self._next_refine - self.t))
        if self._future:
            # arrival due at the tick whose start time ≥ arrival
            k = min(k, max(1.0, np.ceil(self._future[0][0] - self.t) + 1.0))
        if self._ready:
            cand = self._ready[0][2]
            need = int(cand.prompt_len + cand.reserve_len)
            # mirror of _expire_ready_head's sharing-aware servability check
            if not self.kv.servable(cand.rid, need, *self._prefix_args(cand)):
                return 1.0   # unservable-head drop fires next tick
            # admission lookahead mirrors _admit's slot check (common to both
            # decode paths); admissions are evented, so leaps never span one
            if self._n_active < self.max_slots and (  # reprolint: disable=dual-path-knob-parity
                    self.kv.can_reserve(cand.rid, need,
                                        *self._prefix_args(cand))
                    # conservative: the held-pages stall breaker may free
                    # enough for the head — let the real step decide
                    or (self._n_active == 0 and self._held_ready > cand.held)):
                return 1.0   # admission fires next tick
            if cand.deadline is not None:
                # head expires at the first tick with t > deadline
                k = min(k, max(1.0, np.floor(cand.deadline - self.t) + 1.0))
            # preemption lookahead mirrors _maybe_preempt (common prologue of
            # both decode paths); preemptions are evented ticks
            if self.policy.preempt and self._n_active:  # reprolint: disable=dual-path-knob-parity
                n = self._n_active
                rem = np.maximum(self._a_pred[:n] - self._a_gen[:n], 1.0)
                if (rem.max() > self.policy.preempt_factor  # reprolint: disable=dual-path-knob-parity
                        * predicted_remaining(cand)):
                    return 1.0   # preemption fires next tick (monotone ↓)
        n = self._n_active
        if n and self._budget is not None and self._budget_constrained():
            # budget-shaped tick (prefill chunks in flight, or decode demand
            # over the budget): allocation is sequential and stateful, so
            # every such tick is evented; leaps only span unconstrained
            # pure-decode stretches where the legacy arithmetic is exact
            return 1.0
        if n:
            pref = self._a_pref[:n]
            prefilling = pref > 0
            if bool(prefilling.any()):
                # first decode tick of a prefilling slot is an event
                k = min(k, float(pref[prefilling].min()) + 1.0)
            if not bool(prefilling.all()):
                dec = ~prefilling
                rem = (self._a_tlen[:n] - self._a_gen[:n])[dec]
                k = min(k, float(np.ceil(rem / sp).min()))       # completion
                headroom = (self._a_res[:n] - self._a_plen[:n]
                            - self._a_gen[:n])[dec]
                k = min(k, float((headroom // sp).min() + 1))    # growth
        return max(k, 1.0)

    def leap(self, q: int):
        """Advance q provably-eventless ticks at once — bit-identical to q
        calls of :meth:`step` (each decoding slot emits ``speed`` tokens per
        tick, each prefilling slot burns one prefill tick; the usage integral
        is the arithmetic series the per-tick loop would sum)."""
        if q <= 0:
            return
        n = self._n_active
        if n:
            add = np.where(self._a_pref[:n] > 0, 0, self.spec.speed)
            self._a_pref[:n] -= np.minimum(self._a_pref[:n], q)
            first = (self._a_gen[:n] == 0) & (add > 0)
            if bool(first.any()):
                # a decoding slot entering the leap with no output emits its
                # first token on the span's first tick; with tracing on, the
                # event the per-tick loop would emit there is synthesized
                # from the canonical slot state at this leap boundary
                for i in np.nonzero(first)[0]:
                    r = self._slots[int(i)]
                    if r.t_first_token is None:
                        r.t_first_token = self.t + 1.0
                        if self.tracer is not None:
                            self.tracer.emit(self.t + 1.0, self.replica_id,
                                             r.rid, "first_token")
            gain = add * q
            self._a_gen[:n] += gain
            self._a_used[:n] += gain
            rate = int(add.sum())   # decode tokens emitted per tick
        else:
            rate = 0
        self.kv.total_used_steps += (q * (self._used_sum + self.kv.shared_now)
                                     + rate * q * (q + 1) // 2)
        self.kv.total_reserved_steps += q * self.kv.reserved_now
        self.kv.total_asked_steps += q * self.kv.asked_now
        self.kv.total_logical_steps += q * self.kv.logical_now
        self._held_steps += q * self._held_tokens
        self._used_sum += rate * q
        self.t += float(q)

    # -- closed-loop convenience --------------------------------------------

    def run(self, requests: List[Request], max_steps: int = 1_000_000) -> ServeStats:
        """Closed-loop single-replica replay: annotate, submit, step to idle.

        Parameters
        ----------
        requests : the workload; defensively copied (:meth:`Request.fresh_copy`)
            and annotated via the engine's ``predictor`` + ``policy``, so the
            caller's objects are never mutated and re-runs are reproducible.
        max_steps : hard tick cap (guards pathological non-termination).

        Returns a :class:`ServeStats` row; per-request outcomes stay on
        :attr:`done` / :attr:`timed_out_requests`.
        """
        self.reset()
        reqs = [r.fresh_copy() for r in requests]  # defensive copy
        annotate_predictions(reqs, self.predictor, self.policy)
        if self.tracer is not None:
            for r in reqs:
                self.tracer.emit(r.arrival, self.replica_id, r.rid, "arrival")
        self.submit(reqs)
        while not self.idle and self.t < max_steps:
            if self.vectorized:
                q = int(min(self.ticks_to_event() - 1,
                            max(max_steps - self.t - 1, 0)))
                self.leap(q)
            self.step()
            if self._n_active == 0 and not self._ready and self._future:
                self.advance_to(float(np.floor(self._future[0][0])))
        return self.stats()

    def stats(self) -> ServeStats:
        toks = sum(r.true_len for r in self._done)
        denom = max(self.t, 1.0) * max(self.kv.capacity_tokens, 1)
        return ServeStats(
            policy=f"{self.policy.order}+{self.policy.reserve}",
            makespan=self.t,
            throughput=toks / max(self.t, 1.0),
            kv_waste_ratio=self.kv.waste_ratio,
            overflow_events=self.kv.overflow_events,
            peak_reserved=self.kv.peak_reserved,
            completed=len(self._done),
            preemptions=self.preemptions,
            oom_evictions=self.oom_evictions,
            dropped=self.dropped,
            timed_out=self.timed_out,
            slo_violations=self.slo_violations,
            goodput=_goodput(self._done, self.t),
            page_size=self.kv.page_size,
            occupancy=self.kv.total_reserved_steps / denom,
            frag_ratio=self.kv.frag_ratio,
            held_peak=self._held_peak,
            held_steps=self._held_steps,
            held_releases=self.held_releases,
            recompute_ticks=self.recompute_ticks,
            kv_amplification=self.kv.kv_amplification,
            prefix_hits=self.kv.prefix_hits,
            cow_copies=self.kv.cow_copies,
            prefix_evictions=self.kv.prefix_evictions,
            shared_peak=self.kv.shared_peak,
            prefill_ticks=self.prefill_ticks,
            prefill_saved_ticks=self.prefill_saved_ticks,
            refine_events=self.refine_events,
            refine_shrinks=self.refine_shrinks,
            refine_grows=self.refine_grows,
            **_latency_stats(self._done),
            **_ttft_stats(self._done),
        )


# ---------------------------------------------------------------------------
# Track B: real generation over a served model
# ---------------------------------------------------------------------------


class RealEngine:
    """Batched sampling engine: prefill once, decode until EOS, harvest
    last-token hidden states for the ProD predictor."""

    def __init__(self, model, params, temperature: float = 0.8,
                 max_new: int = 256, eos_id: int = 2):
        self.model = model
        self.params = params
        self.temp = temperature
        self.max_new = max_new
        self.eos = eos_id
        self.device = params["embed"].device

    def _sample(self, logits: torch.Tensor, gen: torch.Generator) -> torch.Tensor:
        """Categorical draw from softmax(logits / T): argmax of the scaled
        logits plus Gumbel noise (-log of an Exp(1) draw)."""
        e = torch.empty_like(logits).exponential_(generator=gen)
        return torch.argmax(logits / self.temp - torch.log(e), dim=-1)

    @torch.no_grad()
    def generate(self, prompts: np.ndarray, prompt_lens: np.ndarray,
                 gen: torch.Generator, collect_hidden: bool = True) -> Dict[str, np.ndarray]:
        """prompts: (B, Sp) right-padded. Returns lengths (B,), phi (B, d)
        fp32 (None without ``collect_hidden``) and tokens (B, max_new)."""
        dev = self.device
        B, Sp = prompts.shape
        tokens = torch.as_tensor(prompts, dtype=torch.long, device=dev)
        lens = torch.as_tensor(prompt_lens, dtype=torch.int32, device=dev)
        valid = torch.arange(Sp, device=dev)[None, :] < lens[:, None]
        _, hidden, prefill_cache = self.model.prefill(self.params, tokens, attn_valid=valid,
                                                      logits_mode="none")
        last = last_token_hidden(hidden, lens)
        phi = last.float().cpu().numpy() if collect_hidden else None
        # the reference unembeds every position and gathers the last one;
        # unembedding the gathered row gives the same logits
        cur_logits = self.model.unembed(self.params, last)

        # K/V grown to Sp + max_new positions; SSM states carried over
        cache = self.model.decode_cache(prefill_cache, Sp + self.max_new)
        del prefill_cache

        lengths = lens.clone()
        finished = torch.zeros(B, dtype=torch.bool, device=dev)
        out_tokens = torch.zeros((B, self.max_new), dtype=torch.int32, device=dev)
        gen_len = torch.zeros(B, dtype=torch.int64, device=dev)
        eos = torch.full((), self.eos, dtype=torch.long, device=dev)
        for step in range(self.max_new):
            nxt = torch.where(finished, eos, self._sample(cur_logits, gen))
            out_tokens[:, step] = nxt.to(torch.int32)
            newly = ~finished & (nxt == self.eos)
            finished = finished | (nxt == self.eos)
            gen_len = torch.where(newly, step + 1, gen_len)
            if bool(finished.all()):
                break
            cur_logits, _ = self.model.decode_step(self.params, nxt, cache,
                                                   pos=lengths, lengths=lengths + 1)
            lengths = lengths + (~finished).to(torch.int32)
        gen_len = torch.where(gen_len == 0, self.max_new, gen_len)
        return {"lengths": gen_len.cpu().numpy(), "phi": phi,
                "tokens": out_tokens.cpu().numpy()}

    def repeated_sampling(self, prompts: np.ndarray, prompt_lens: np.ndarray,
                          r: int, seed: int = 0):
        """The paper's data-collection loop: r independent generations per
        prompt. Returns (lengths (B, r) int64, phi (B, d) fp32)."""
        B = prompts.shape[0]
        lens = np.zeros((B, r), np.int64)
        phi = None
        for j in range(r):
            gen = torch.Generator(device=self.device).manual_seed(seed * 997 + j)
            out = self.generate(prompts, prompt_lens, gen, collect_hidden=(j == 0))
            lens[:, j] = out["lengths"]
            if j == 0:
                phi = out["phi"]
        return lens, phi
