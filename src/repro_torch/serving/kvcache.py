"""Paged KV-cache reservation accounting (the paper's §4 serving motivation).

Serving frameworks that reserve for the *maximum possible* output waste memory
and cap the batch; reserving for the *predicted* output admits more concurrent
requests but risks overflow re-reservations. This manager tracks both costs so
the benchmark can quantify the trade-off that length prediction buys.

The pool is **page-granular** (vLLM-style): ``budget_tokens`` is split into
``budget_tokens // page_size`` pages and every reservation is a whole number
of pages. A request that asks for ``n`` tokens is *granted*
``ceil(n / page_size) * page_size`` tokens; the ask is remembered separately
so the page-rounding slack shows up as **internal fragmentation**
(:attr:`frag_ratio`). ``page_size=1`` reproduces the original scalar token
counter bit-exactly — every comparison reduces to the same integer
arithmetic — which is what lets the engine's vectorized-vs-reference golden
tests anchor the paged rewrite.

Page-granular accounting is what makes **partial-reservation handoff**
possible: a preempted request can :meth:`shrink` its reservation down to the
pages it has already filled and keep holding them while it waits to resume
(``Policy.preempt_mode="keep"``), instead of releasing everything and
re-reserving — and re-prefilling — from scratch.

**Prefix sharing** (``share_prefixes=True``): requests that declare a common
context — ``admit(rid, n, prefix_id, prefix_len)`` — share the physical pages
holding that prefix instead of each reserving its own copy. Shared pages
carry a *refcount*, not a single owner; the first request to materialize a
page of the prefix contributes it to the prefix store, later requests attach
(``prefix_hits``) and skip re-prefilling the covered tokens
(:meth:`prefill_skip`). A request whose context diverges *inside* a shared
page pays a **copy-on-write**: it privatizes the boundary page
(``cow_copies``) rather than writing to the shared one. When the last holder
detaches, the prefix's pages stay resident as reclaimable cache
(``cached_now``) and are evicted LRU only when an allocation actually needs
them (``prefix_evictions``) — a later request with the same ``prefix_id``
revives them for free.

Sharing splits the books in two: **physical** (``reserved_now`` counts every
page once, no matter how many requests reference it) and **logical**
(``logical_now`` = Σ per-request grants, what a sharing-blind allocator would
have reserved). Their step-integral ratio is :attr:`kv_amplification` — how
many tokens of KV capacity sharing manufactured per physical token. With
sharing off the two coincide and every code path is bit-identical to the
non-sharing manager.

Accounting is O(1) per operation (page *counts*, not page IDs). Pass
``track_pages=True`` to additionally materialize an explicit free-page stack
and per-request page tables — O(pages) per op, used by the allocator property
tests (no page leaked or double-assigned) and by the external-fragmentation
probe :meth:`fragmentation`. Prefix-owned pages live in their
:class:`_Prefix` entry's ``ids`` list, never in a request's page table.

The port's own copy of ``repro.serving.kvcache`` (NumPy only), kept line
for line so that the same trace gives the same results bit for bit.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional


@dataclass
class _Prefix:
    """One shared-prefix entry: ``pages`` physical pages holding the common
    context, referenced by ``refs`` live requests (0 = retained cache,
    reclaimable). ``stamp`` orders LRU eviction; ``ids`` are the page IDs
    when the pool tracks them."""
    pages: int = 0
    refs: int = 0
    stamp: int = 0
    ids: List[int] = field(default_factory=list)


@dataclass
class KVCacheManager:
    budget_tokens: int                       # total KV slots across the pool
    page_size: int = 1                       # tokens per page (1 = scalar mode)
    track_pages: bool = False                # materialize page IDs (tests)
    share_prefixes: bool = False             # ref-counted prefix page sharing
    reserved: Dict[int, int] = field(default_factory=dict)  # rid -> granted
    asked: Dict[int, int] = field(default_factory=dict)     # rid -> requested
    used: Dict[int, int] = field(default_factory=dict)
    reserved_now: int = 0                    # Σ live *physical* tokens
    asked_now: int = 0                       # Σ asked tokens, incremental
    used_now: int = 0                        # Σ used tokens, incremental
    logical_now: int = 0                     # Σ per-request grants (sharing-blind)
    shared_now: int = 0                      # live (refs>0) prefix tokens
    cached_now: int = 0                      # retained refs==0 prefix tokens
    peak_reserved: int = 0
    peak_logical: int = 0
    shared_peak: int = 0
    overflow_events: int = 0
    prefix_hits: int = 0                     # admits that reused prefix pages
    prefix_misses: int = 0                   # admits that registered a new one
    cow_copies: int = 0                      # boundary pages privatized
    prefix_evictions: int = 0                # cached prefixes reclaimed (LRU)
    total_reserved_steps: float = 0.0        # token-steps of physical reservation
    total_asked_steps: float = 0.0           # token-steps actually asked for
    total_used_steps: float = 0.0
    total_logical_steps: float = 0.0         # token-steps of logical grants
    page_table: Dict[int, List[int]] = field(default_factory=dict)
    prefixes: Dict[str, _Prefix] = field(default_factory=dict)
    _free_ids: List[int] = field(default_factory=list)
    _attached: Dict[int, str] = field(default_factory=dict)   # rid -> prefix
    _shared_tok: Dict[int, int] = field(default_factory=dict)  # rid -> tokens
    _skip: Dict[int, int] = field(default_factory=dict)  # rid -> prefill skip
    _clock: int = 0                          # LRU stamp source

    def __post_init__(self):
        if self.page_size < 1:
            raise ValueError("page_size must be >= 1")
        self.pages_total = self.budget_tokens // self.page_size
        self.pages_free = self.pages_total
        if self.track_pages:
            # LIFO free stack: churn scrambles it, so page tables genuinely
            # fragment — what the fragmentation() probe measures
            self._free_ids = list(range(self.pages_total - 1, -1, -1))

    # -- page math -----------------------------------------------------------

    def pages_for(self, n_tokens: int) -> int:
        """Pages needed to hold ``n_tokens`` (ceil division)."""
        return -(-int(n_tokens) // self.page_size)

    def pages_of(self, rid: int) -> int:
        """Pages currently granted to ``rid`` (0 if unknown). Includes the
        shared prefix pages its grant is backed by."""
        return self.reserved.get(rid, 0) // self.page_size

    @property
    def capacity_tokens(self) -> int:
        """Usable pool size: whole pages only (== budget when aligned)."""
        return self.pages_total * self.page_size

    @property
    def pages_reserved(self) -> int:
        """Physically allocated pages (live reservations, live prefixes, and
        retained prefix cache)."""
        return self.pages_total - self.pages_free

    @property
    def shared_pages(self) -> int:
        """Live shared-prefix pages (each counted once)."""
        return self.shared_now // self.page_size

    @property
    def occupancy(self) -> float:
        """Fraction of the pool's pages currently reserved."""
        if self.pages_total == 0:
            return 0.0
        return self.pages_reserved / self.pages_total

    # -- allocation ----------------------------------------------------------

    def _take_pages(self, rid: int, k: int):
        self.pages_free -= k
        if self.track_pages:
            tbl = self.page_table.setdefault(rid, [])
            for _ in range(k):
                tbl.append(self._free_ids.pop())

    def _give_pages(self, rid: int, k: int):
        self.pages_free += k
        if self.track_pages:
            tbl = self.page_table.get(rid, [])
            for _ in range(k):
                self._free_ids.append(tbl.pop())
            if not tbl:
                self.page_table.pop(rid, None)

    # -- prefix store --------------------------------------------------------

    def has_prefix(self, prefix_id: str) -> bool:
        """Is this prefix resident here (live or retained cache)? The
        prefix-affinity router's residency signal."""
        return prefix_id in self.prefixes

    def shared_tokens_of(self, rid: int) -> int:
        """Tokens of ``rid``'s grant backed by shared prefix pages."""
        return self._shared_tok.get(rid, 0)

    def prefill_skip(self, rid: int) -> int:
        """Prompt tokens ``rid`` can skip re-prefilling: covered by a prefix
        cache hit (plus a copy-on-write boundary page's copied content)."""
        return self._skip.get(rid, 0)

    def _reclaimable(self, exclude: Optional[str]) -> int:
        """Retained-cache pages an allocation could evict (LRU), excluding
        the prefix the allocation itself is about to attach to."""
        if not self.share_prefixes or self.cached_now == 0:
            return 0
        pages = self.cached_now // self.page_size
        if exclude is not None:
            e = self.prefixes.get(exclude)
            if e is not None and e.refs == 0:
                pages -= e.pages
        return pages

    def _avail_pages(self, exclude: Optional[str] = None) -> int:
        return self.pages_free + self._reclaimable(exclude)

    def _reclaim(self, need: int, exclude: Optional[str] = None):
        """Evict refs==0 prefix entries (oldest stamp first) until ``need``
        pages are free. No page is ever freed while shared (refs > 0)."""
        if self.pages_free >= need or not self.share_prefixes:
            return
        victims = sorted((e.stamp, k) for k, e in self.prefixes.items()
                         if e.refs == 0 and k != exclude)
        for _, key in victims:
            if self.pages_free >= need:
                break
            e = self.prefixes.pop(key)
            self.pages_free += e.pages
            self.cached_now -= e.pages * self.page_size
            if self.track_pages:
                self._free_ids.extend(reversed(e.ids))
            self.prefix_evictions += 1

    def _sharing(self, prefix_id: Optional[str], prefix_len: int) -> bool:
        return (self.share_prefixes and prefix_id is not None
                and prefix_len > 0)

    def _admit_need(self, n_tokens: int, prefix_id: Optional[str],
                    prefix_len: int):
        """Physical pages a fresh admit would newly allocate, and the prefix
        key it would attach to (the reclaim-exclusion). The single source of
        truth :meth:`can_admit`/:meth:`can_reserve`/:meth:`admit` all use —
        the feasibility check and the grant can't drift apart."""
        k_total = self.pages_for(n_tokens)
        if not self._sharing(prefix_id, prefix_len):
            return k_total, None
        target = min(int(prefix_len), int(n_tokens)) // self.page_size
        entry = self.prefixes.get(prefix_id)
        hit = min(entry.pages, target) if entry is not None else 0
        return k_total - hit, prefix_id

    def can_admit(self, n_tokens: int, prefix_id: Optional[str] = None,
                  prefix_len: int = 0) -> bool:
        need, excl = self._admit_need(n_tokens, prefix_id, prefix_len)
        return need <= self._avail_pages(excl)

    def servable(self, rid: int, n_tokens: int,
                 prefix_id: Optional[str] = None, prefix_len: int = 0) -> bool:
        """Sharing-aware "could this request *ever* start here": the pages it
        would still have to allocate, against the whole pool. Unlike the raw
        ``pages_for(n_tokens) <= pages_total`` test, this routes through the
        same :meth:`_admit_need` arithmetic admission uses, so a session
        follow-up whose full need exceeds a small replica's pool but whose
        resident shared prefix already covers part of it is *not* declared
        unservable — the resident prefix pages are capacity the request does
        not need to find again. A keep-mode holder's kept pages likewise
        count toward its own need (only the delta pages must still fit).
        Retained (refs==0) cache never caps servability: it is reclaimable
        the moment an allocation wants the pages."""
        if rid in self.reserved:            # holder: delta on the kept pages
            want = max(int(n_tokens), self.asked[rid])
            return self.pages_for(want) - self.pages_of(rid) \
                <= self.pages_total
        need, _ = self._admit_need(n_tokens, prefix_id, prefix_len)
        return need <= self.pages_total

    def admit(self, rid: int, n_tokens: int, prefix_id: Optional[str] = None,
              prefix_len: int = 0) -> bool:
        if not self._sharing(prefix_id, prefix_len):
            k = self.pages_for(n_tokens)
            if k > self._avail_pages():
                return False
            self._reclaim(k)
            self._take_pages(rid, k)
            self.reserved[rid] = k * self.page_size
            self.asked[rid] = int(n_tokens)
            self.used[rid] = 0
            self.reserved_now += k * self.page_size
            self.logical_now += k * self.page_size
            self.asked_now += int(n_tokens)
            self._bump_peaks()
            return True
        return self._admit_shared(rid, int(n_tokens), prefix_id,
                                  min(int(prefix_len), int(n_tokens)))

    def _admit_shared(self, rid: int, n_tokens: int, prefix_id: str,
                      prefix_len: int) -> bool:
        ps = self.page_size
        k_total = self.pages_for(n_tokens)
        target = prefix_len // ps           # full pages inside the prefix
        rem = prefix_len - target * ps      # boundary tokens past them
        entry = self.prefixes.get(prefix_id)
        have = entry.pages if entry is not None else 0
        hit = min(have, target)
        ext = max(0, target - have)         # prefix pages this admit registers
        # copy-on-write: the context diverges inside a page the prefix store
        # holds — privatize that boundary page instead of writing to it; the
        # copied content still skips re-prefill
        cow = entry is not None and have > target and rem > 0
        need_new = k_total - hit            # ext prefix pages + private pages
        if need_new > self._avail_pages(prefix_id):
            return False
        self._reclaim(need_new, prefix_id)
        self._clock += 1
        if entry is not None:
            if hit > 0 or cow:
                self.prefix_hits += 1
            entry.stamp = self._clock
        else:
            self.prefix_misses += 1
            if ext > 0:
                entry = self.prefixes[prefix_id] = _Prefix(stamp=self._clock)
        if cow:
            self.cow_copies += 1
        shared = 0
        if entry is not None and (hit > 0 or ext > 0):
            if entry.refs == 0 and entry.pages > 0:   # revive retained cache
                tok = entry.pages * ps
                self.cached_now -= tok
                self.reserved_now += tok
                self.shared_now += tok
            entry.refs += 1
            if ext > 0:                     # extend: new pages prefix-owned
                self.pages_free -= ext
                if self.track_pages:
                    for _ in range(ext):
                        entry.ids.append(self._free_ids.pop())
                entry.pages += ext
                self.reserved_now += ext * ps
                self.shared_now += ext * ps
            shared = (hit + ext) * ps
            self._attached[rid] = prefix_id
            self._shared_tok[rid] = shared
        self._take_pages(rid, k_total - hit - ext)      # private pages
        self.reserved[rid] = k_total * ps
        self.asked[rid] = n_tokens
        self.used[rid] = 0
        self.reserved_now += (k_total - hit - ext) * ps
        self.logical_now += k_total * ps
        self.asked_now += n_tokens
        self._skip[rid] = hit * ps + (rem if cow else 0)
        self._bump_peaks()
        return True

    def _bump_peaks(self):
        self.peak_reserved = max(self.peak_reserved, self.reserved_now)
        self.peak_logical = max(self.peak_logical, self.logical_now)
        self.shared_peak = max(self.shared_peak, self.shared_now)

    def grow(self, rid: int, extra: int) -> bool:
        """Overflow: the request outgrew its reservation (mispredicted short).
        Grants whole pages — at least one: the caller only grows when out of
        granted space, and a zero-page "success" would let it emit past its
        reservation. The ask grows by exactly ``extra`` (what was actually
        requested); the grant may exceed it when the one-page minimum rounds
        up, and that slack is fragmentation, not demand."""
        want = self.asked[rid] + int(extra)
        delta = max(self.pages_for(want), self.pages_of(rid) + 1) \
            - self.pages_of(rid)
        if delta > self._avail_pages():
            return False
        self._reclaim(delta)
        self._take_pages(rid, delta)
        self.reserved[rid] += delta * self.page_size
        self.reserved_now += delta * self.page_size
        self.logical_now += delta * self.page_size
        self.asked_now += want - self.asked[rid]
        self.asked[rid] = want
        self.overflow_events += 1
        self._bump_peaks()
        return True

    # -- partial-reservation handoff (keep-pages preemption) -----------------

    def shrink(self, rid: int, keep_tokens: int) -> int:
        """Release every page beyond ``ceil(keep_tokens / page_size)`` —
        a preempted request keeping the pages it has already filled. Never
        grows, and never gives back shared prefix pages (they belong to the
        prefix store; only :meth:`release` detaches). Returns the new granted
        token count (page-rounded)."""
        keep = min(max(0, int(keep_tokens)), self.reserved[rid])
        keep = max(keep, self._shared_tok.get(rid, 0))
        k = self.pages_for(keep)
        self._give_pages(rid, self.pages_of(rid) - k)
        freed = self.reserved[rid] - k * self.page_size
        self.reserved_now -= freed
        self.logical_now -= freed
        self.asked_now += keep - self.asked[rid]
        self.reserved[rid] = k * self.page_size
        self.asked[rid] = keep
        if self.used.get(rid, 0) > keep:     # content beyond the kept pages
            self.used_now -= self.used[rid] - keep
            self.used[rid] = keep
        return self.reserved[rid]

    def reprice(self, rid: int, n_tokens: int) -> bool:
        """Move a live reservation to the page-rounded grant for ``n_tokens``
        — the posterior-refinement primitive. A smaller target shrinks
        (frees the pages beyond it and lowers the ask, so a later grow
        re-ratchets from the new level); a larger one grows through
        :meth:`reserve` (feasibility-checked delta pages, not counted as an
        overflow); an unchanged page count is a no-op (the ask keeps its
        dispatch value — same-page re-cuts are fragmentation noise, not
        demand). Returns whether the grant now covers ``n_tokens``; a
        refused grow leaves the reservation exactly as it was."""
        if rid not in self.reserved:
            return False
        want = max(0, int(n_tokens))
        k = self.pages_for(max(want, self._shared_tok.get(rid, 0)))
        cur = self.pages_of(rid)
        if k < cur:
            return self.shrink(rid, want) >= want
        if k > cur:
            if not self.can_reserve(rid, want):
                return False
            return self.reserve(rid, want)
        return True

    def can_reserve(self, rid: int, n_tokens: int,
                    prefix_id: Optional[str] = None,
                    prefix_len: int = 0) -> bool:
        """Admission feasibility — the *same* ``want`` :meth:`reserve` would
        grant: delta pages on a holder's ratcheted ask, fresh pages (minus
        any prefix hit) otherwise. ``can_reserve == reserve-would-succeed``
        by construction."""
        if rid in self.reserved:
            want = max(int(n_tokens), self.asked[rid])
            return self.pages_for(want) - self.pages_of(rid) \
                <= self._avail_pages()
        need, excl = self._admit_need(n_tokens, prefix_id, prefix_len)
        return need <= self._avail_pages(excl)

    def reserve(self, rid: int, n_tokens: int,
                prefix_id: Optional[str] = None, prefix_len: int = 0) -> bool:
        """Unified admission: a fresh request reserves its full need (joining
        its declared prefix, if any); a holder (preempted with kept pages)
        reserves only the *delta* pages on top of what it already holds. Not
        counted as an overflow."""
        if rid not in self.reserved:
            return self.admit(rid, n_tokens, prefix_id, prefix_len)
        want = max(int(n_tokens), self.asked[rid])
        delta = self.pages_for(want) - self.pages_of(rid)
        if delta > self._avail_pages():
            return False
        self._reclaim(delta)
        self._take_pages(rid, delta)
        self.reserved[rid] += delta * self.page_size
        self.reserved_now += delta * self.page_size
        self.logical_now += delta * self.page_size
        self.asked_now += want - self.asked[rid]
        self.asked[rid] = want
        self._bump_peaks()
        return True

    # -- usage / release -----------------------------------------------------

    def use(self, rid: int, n_tokens: int = 1):
        self.used[rid] = self.used.get(rid, 0) + n_tokens
        self.used_now += n_tokens

    def tick(self):
        """Accumulate per-step reservation/usage integrals (waste metric).
        O(1): the per-rid sums are kept incrementally in ``use``/``release``
        instead of re-summing the dicts in the hottest loop. ``used_now`` is
        the logical view; the engine integrates the physical one itself."""
        self.total_reserved_steps += self.reserved_now
        self.total_asked_steps += self.asked_now
        self.total_used_steps += self.used_now
        self.total_logical_steps += self.logical_now

    def release(self, rid: int):
        granted = self.reserved.pop(rid, 0)
        shared = self._shared_tok.pop(rid, 0)
        self._skip.pop(rid, None)
        self._give_pages(rid, (granted - shared) // self.page_size)
        self.reserved_now -= granted - shared
        self.logical_now -= granted
        prefix_id = self._attached.pop(rid, None)
        if prefix_id is not None:
            entry = self.prefixes[prefix_id]
            entry.refs -= 1
            if entry.refs == 0:
                # last holder gone: pages stay resident as reclaimable cache
                tok = entry.pages * self.page_size
                self.reserved_now -= tok
                self.shared_now -= tok
                self.cached_now += tok
        self.asked_now -= self.asked.pop(rid, 0)
        self.used_now -= self.used.pop(rid, 0)

    # -- metrics -------------------------------------------------------------

    @property
    def waste_ratio(self) -> float:
        if self.total_reserved_steps == 0:
            return 0.0
        return 1.0 - self.total_used_steps / self.total_reserved_steps

    @property
    def frag_ratio(self) -> float:
        """Internal fragmentation: the fraction of reserved token-steps that
        is page-rounding slack (granted − asked). 0 at ``page_size=1``."""
        if self.total_reserved_steps == 0:
            return 0.0
        return 1.0 - self.total_asked_steps / self.total_reserved_steps

    @property
    def kv_amplification(self) -> float:
        """Logical over physical reserved token-steps: how much KV capacity
        prefix sharing manufactured (1.0 with sharing off)."""
        if self.total_reserved_steps == 0:
            return 1.0
        return self.total_logical_steps / self.total_reserved_steps

    def fragmentation(self) -> float:
        """External fragmentation of the free list (``track_pages`` only):
        1 − largest contiguous free run / free pages. 0 when the free space
        is one run (or the pool is full)."""
        if not self.track_pages:
            raise ValueError("fragmentation() needs track_pages=True")
        if not self._free_ids:
            return 0.0
        ids = sorted(self._free_ids)
        best = run = 1
        for a, b in zip(ids, ids[1:]):
            run = run + 1 if b == a + 1 else 1
            best = max(best, run)
        return 1.0 - best / len(ids)
