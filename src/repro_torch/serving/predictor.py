"""Predictor service: the trained ProD-D head in the serving loop.

This module closes the paper→cluster loop. The cluster simulator historically
routed, reserved, and stole using :class:`~repro_torch.serving.arrivals.LatentOracle`
— an analytic stand-in that inverts the length laws. Here the *actual* paper
artifact (the ProD-D head of :mod:`repro_torch.core.heads`, the fused CUDA
kernel behind ``kernels.ops.prod_head``) serves predictions at dispatch time:

* :class:`PredictorService` — wraps a trained
  :class:`~repro_torch.core.predictor.LengthPredictor` behind a batched
  inference API. Requests arriving within one ``window``-step span are
  featurized (their noise-corrupted latents ARE the features, matching the
  informativeness calibration of :mod:`repro_torch.serving.arrivals`), scored
  in a single padded-batch fused ``head_quantiles`` call (median + q0.9 + the
  policy's reservation quantile + the full histogram in one evaluation), and
  annotated onto :class:`~repro_torch.serving.request.Request` for the router,
  KV reservation, EDF/least-laxity ordering, and work stealing to consume. A
  small LRU cache short-circuits repeated features (retried / duplicated
  prompts) without re-running the head.

* :class:`PerfectOracle` — the zero-error upper bound: "predicts" the
  realized length. Interchangeable with the service and the latent oracle at
  the ``Cluster(predictor=...)`` seam, so benchmarks can bracket the trained
  head between the analytic proxy and perfection.

* :func:`fit_trace_head` — trains a ProD-D head on repeated-generation
  targets drawn from the same calibrated heavy-tailed laws the trace
  generator uses (the paper's §2.3 protocol at trace scale), returning a
  predictor ready to drop into a :class:`PredictorService`.

The port of ``repro.serving.predictor``. The reference jit-compiles one fused
forward per padded bucket; here each bucket is one ``head_quantiles`` call on
the predictor's device (one ``prod_head`` launch on the GPU), and the bucket
sizes, batching and cache are the reference's, so ``ServiceStats`` count the
same calls. ``fit_trace_head`` takes an integer seed and a device.
"""

from __future__ import annotations

from collections import OrderedDict
from dataclasses import dataclass, field
from typing import List, Optional, Tuple

import numpy as np
import torch

from repro_torch.common.config import PredictorConfig
from repro_torch.common.device import DeviceLike, resolve_device
from repro_torch.core import bins as bins_mod
from repro_torch.core import targets as targets_mod
from repro_torch.core.heads import head_quantiles
from repro_torch.core.predictor import train_predictor
from repro_torch.data.lengths import sample_lengths, sample_prompt_latents
from repro_torch.data.scenarios import get_spec
from repro_torch.serving.arrivals import corrupt_latents
from repro_torch.serving.request import Request
from repro_torch.serving.scheduler import Policy


@dataclass
class ServiceStats:
    """Operational counters for one :class:`PredictorService` lifetime.

    ``requests`` — requests annotated; ``scored`` — requests that reached the
    head (misses); ``cache_hits`` — served from the LRU; ``batches`` — fused
    head calls; ``padded`` — wasted pad slots across those calls; ``buckets``
    — distinct padded batch shapes (one compile each in the reference);
    ``refreshes`` — weight swaps installed via
    :meth:`PredictorService.swap_weights`.
    """

    requests: int = 0
    scored: int = 0
    cache_hits: int = 0
    batches: int = 0
    padded: int = 0
    refreshes: int = 0
    buckets: set = field(default_factory=set)

    def row(self) -> dict:
        d = self.__dict__.copy()
        d["buckets"] = sorted(self.buckets)
        d["hit_rate"] = self.cache_hits / max(self.requests, 1)
        d["mean_batch"] = self.scored / max(self.batches, 1)
        return d


class PredictorService:
    """Batched dispatch-time inference over a trained ProD-D head.

    Parameters
    ----------
    predictor : a :class:`~repro_torch.core.predictor.LengthPredictor`
        (params + bin edges) — typically from :func:`fit_trace_head`. Its
        edges' device is where the head runs.
    window : dispatch window in engine steps. Requests whose arrivals fall in
        the same window are scored together — one fused head call per window
        (per ``max_batch`` chunk), amortizing inference exactly the way a
        real serving frontend batches prediction at admission.
    max_batch : cap on one fused call's batch; windows larger than this are
        chunked. Batches are padded up to the next power of two (≥ 8, ≤
        ``max_batch``), the reference's buckets.
    cache_size : LRU entries keyed by the feature bytes (+ quantile set); 0
        disables caching.
    work_quantile : CDF level attached as ``Request.pred_q`` — the
        pessimistic remaining-work signal least-laxity ordering and quantile
        stealing consume (paper-aligned default: q0.9).
    attach_hist : also attach the full predictive histogram as
        ``Request.pred_probs`` (float32, K bins).
    step_token_budget, prefill_chunk_tokens : the serving engine's
        chunked-prefill knobs (see
        :class:`~repro_torch.serving.engine.ReplicaSpec`). When a budget is
        given, dispatch-time scoring rides the chunked batch-prefill: one
        engine step starts at most ``budget // chunk`` prompts' first chunks,
        so a fused inference batch larger than that never forms. The
        effective ``max_batch`` is capped at that lane count (power-of-two
        rounded, floor 8 to match the pad buckets). Annotation *results* are
        unchanged — prediction is deterministic in the features — only
        batching shape and :class:`ServiceStats` move.
    """

    def __init__(self, predictor, window: float = 16.0, max_batch: int = 512,
                 cache_size: int = 8192, work_quantile: float = 0.9,
                 attach_hist: bool = True,
                 step_token_budget: Optional[int] = None,
                 prefill_chunk_tokens: int = 0, tracer=None):
        if window <= 0:
            raise ValueError("window must be positive")
        if max_batch <= 0:
            raise ValueError("max_batch must be positive")
        if step_token_budget is not None:
            if step_token_budget < 1:
                raise ValueError("step_token_budget must be >= 1")
            ce = min(prefill_chunk_tokens or step_token_budget,
                     step_token_budget)
            lanes = max(1, int(step_token_budget) // max(int(ce), 1))
            max_batch = min(int(max_batch),
                            max(8, 1 << (lanes - 1).bit_length()))
        self.step_token_budget = step_token_budget
        self.prefill_chunk_tokens = int(prefill_chunk_tokens)
        self.predictor = predictor
        self.window = float(window)
        self.max_batch = int(max_batch)
        self.cache_size = int(cache_size)
        self.work_quantile = float(work_quantile)
        self.attach_hist = attach_hist
        self.tracer = tracer
        self.stats = ServiceStats()
        self._cache: "OrderedDict[tuple, tuple]" = OrderedDict()

    # -- weight refresh (online adaptation) ----------------------------------

    def swap_weights(self, predictor):
        """Install re-fit head weights without losing batching/cache stats.

        The live service keeps its window/bucket/LRU configuration and
        operational counters; only the underlying
        :class:`~repro_torch.core.predictor.LengthPredictor` changes. Cache
        hygiene: the LRU is cleared wholesale, so a stale (pre-refresh)
        prediction can never be served after a swap; ``stats.refreshes``
        counts the installed weight versions."""
        self.predictor = predictor
        self._cache.clear()
        self.stats.refreshes += 1

    # -- fused inference -----------------------------------------------------

    def _forward(self, phi: np.ndarray, qs: Tuple[float, ...]):
        """One padded-batch fused call per bucket: (n, d) -> (probs (n, K)
        fp32, quants (n, Q) fp64), host NumPy. Pads to a power-of-two bucket,
        the reference's bounded set of shapes."""
        pred = self.predictor
        dev = pred.edges.device
        n = phi.shape[0]
        bucket = max(8, 1 << (n - 1).bit_length())
        bucket = min(bucket, self.max_batch)
        probs_out, quants_out = [], []
        for lo in range(0, n, bucket):
            chunk = phi[lo:lo + bucket]
            pad = bucket - chunk.shape[0]
            if pad:
                chunk = np.concatenate([chunk, np.zeros((pad, chunk.shape[1]),
                                                        chunk.dtype)])
            p, q = head_quantiles(pred.params,
                                  torch.as_tensor(chunk, dtype=torch.float32,
                                                  device=dev),
                                  pred.edges, qs)
            m = bucket - pad
            probs_out.append(p[:m].cpu().numpy())
            quants_out.append(q[:m].cpu().numpy().astype(np.float64))
            self.stats.batches += 1
            self.stats.padded += pad
            self.stats.buckets.add(bucket)
        return np.concatenate(probs_out), np.concatenate(quants_out)

    def _qs_for(self, policy: Policy) -> Tuple[float, ...]:
        """CDF levels one dispatch batch needs: median (routing signal), the
        work quantile (laxity/steal), and the reservation quantile."""
        qs = {0.5, self.work_quantile}
        if policy.reserve == "quantile":
            qs.add(float(policy.quantile))
        return tuple(sorted(qs))

    # -- dispatch-time annotation (the cluster/engine entry point) -----------

    def annotate(self, requests: List[Request], policy: Policy):
        """Score ``requests`` in arrival-window batches and attach
        median/quantile/histogram predictions + the policy's reservation.

        Called by :func:`~repro_torch.serving.scheduler.annotate_predictions`
        via the ``Cluster``/``SimEngine`` ``predictor=`` seam. Deterministic:
        prediction depends only on features, so window batching and caching
        cannot change simulation results — only inference cost."""
        if not requests:
            return
        qs = self._qs_for(policy)
        iq = {q: i for i, q in enumerate(qs)}
        order = sorted(range(len(requests)),
                       key=lambda i: float(requests[i].arrival))
        # split the arrival-sorted stream into dispatch windows
        windows: List[List[int]] = []
        w_end = None
        for i in order:
            t = float(requests[i].arrival)
            if w_end is None or t >= w_end:
                windows.append([])
                w_end = (np.floor(t / self.window) + 1.0) * self.window
            windows[-1].append(i)
        for win in windows:
            self._annotate_window([requests[i] for i in win], qs, iq, policy)

    def _annotate_window(self, reqs: List[Request], qs, iq, policy: Policy):
        self.stats.requests += len(reqs)
        hits0 = self.stats.cache_hits
        scored0 = self.stats.scored
        keys = []
        misses: List[int] = []
        results: List[Optional[tuple]] = [None] * len(reqs)
        for j, r in enumerate(reqs):
            if r.phi is None:
                raise ValueError(f"request {r.rid} has no features (phi)")
            key = (np.ascontiguousarray(r.phi).tobytes(), qs)
            keys.append(key)
            if self.cache_size and key in self._cache:
                self._cache.move_to_end(key)
                results[j] = self._cache[key]
                self.stats.cache_hits += 1
            else:
                misses.append(j)
        if misses:
            # dedupe identical features within the window: score once
            uniq: "OrderedDict[tuple, List[int]]" = OrderedDict()
            for j in misses:
                uniq.setdefault(keys[j], []).append(j)
            phi = np.stack([np.asarray(reqs[js[0]].phi, np.float64)
                            for js in uniq.values()])
            probs, quants = self._forward(phi, qs)
            self.stats.scored += phi.shape[0]
            for row, (key, js) in enumerate(uniq.items()):
                hit = (quants[row], probs[row])
                for j in js:
                    results[j] = hit
                if self.cache_size:
                    self._cache[key] = hit
                    if len(self._cache) > self.cache_size:
                        self._cache.popitem(last=False)
        for r, res in zip(reqs, results):
            quant, probs = res
            r.predicted_len = float(quant[iq[0.5]])
            r.pred_q = float(quant[iq[self.work_quantile]])
            if self.attach_hist:
                r.pred_probs = probs
            if policy.reserve == "quantile":
                rv = float(quant[iq[float(policy.quantile)]])
            elif policy.reserve == "predicted":
                rv = r.predicted_len * policy.margin
            elif policy.reserve == "oracle":
                rv = float(r.true_len)
            else:
                rv = float(policy.max_seq_len)
            r.reserve_len = float(min(max(rv, 8.0), policy.max_seq_len))
        if self.tracer is not None:
            # one event per fused inference window, keyed to the window's
            # first arrival (the time the batch formed)
            self.tracer.emit(float(reqs[0].arrival), -1, -1, "predict",
                             n=len(reqs),
                             hits=self.stats.cache_hits - hits0,
                             scored=self.stats.scored - scored0)

    # -- raw predictor protocol (interchangeability) -------------------------

    def predict(self, phi) -> np.ndarray:
        """Point (median) predictions for stacked features — the unbatched
        predictor protocol, so a service can stand anywhere a
        :class:`~repro_torch.serving.arrivals.LatentOracle` does."""
        _, quants = self._forward(np.asarray(phi, np.float64), (0.5,))
        return quants[:, 0]

    def quantile(self, phi, q: float) -> np.ndarray:
        """Interpolated predictive q-quantiles for stacked features."""
        _, quants = self._forward(np.asarray(phi, np.float64), (float(q),))
        return quants[:, 0]


class PerfectOracle:
    """Zero-error predictor: annotates each request with its realized length.

    The upper bound every predictor row is measured against — plugs into the
    same ``predictor=`` seam as :class:`PredictorService` and
    :class:`~repro_torch.serving.arrivals.LatentOracle`. Under
    ``reserve="max"`` it still reserves the policy cap (the reservation
    rule, not the prediction, is what ``max`` ablates)."""

    def annotate(self, requests: List[Request], policy: Policy):
        """Attach ``true_len`` as median, q0.9, and (non-max) reservation."""
        for r in requests:
            tl = float(r.true_len)
            r.predicted_len = tl
            r.pred_q = tl
            rv = float(policy.max_seq_len) if policy.reserve == "max" else tl
            r.reserve_len = float(min(max(rv, 8.0), policy.max_seq_len))


def fit_trace_head(cfg, n_train: int = 4000, r: int = 16, n_bins: int = 32,
                   hidden: int = 128, epochs: int = 25, seed: int = 1234,
                   device: DeviceLike = None):
    """Train a ProD-D head for traces generated by ``cfg`` (a
    :class:`~repro_torch.serving.arrivals.TraceConfig`).

    The paper's §2.3 protocol at trace scale: per training prompt, draw ``r``
    independent lengths from its heavy-tailed law, bin them into a histogram
    target (ProD-D), and fit the shared 2-layer head on the *noise-corrupted*
    latents — the exact feature distribution trace requests carry, so serving
    error honestly reflects the per-scenario informativeness calibration.
    Bins are log-spaced up to ``cfg.max_seq_len`` (constant relative
    resolution under heavy tails).

    The training data are the reference's bit for bit (``np.random`` from
    ``seed``); the head's init and minibatch order come from the integer
    ``seed`` through :func:`~repro_torch.core.predictor.train_predictor`.
    Returns a :class:`~repro_torch.core.predictor.LengthPredictor` on
    ``device``, ready for :class:`PredictorService`. Deterministic in
    ``(cfg, seed)`` and independent of the trace seed — the head never sees
    the served trace.
    """
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    settings = cfg.settings()
    pick = rng.integers(0, len(settings), size=n_train)
    phi = np.zeros((n_train, 4), np.float64)
    lens = np.zeros((n_train, r), np.int64)
    for si, (model, scen) in enumerate(settings):
        idx = np.nonzero(pick == si)[0]
        if len(idx) == 0:
            continue
        spec = get_spec(model, scen)
        lat = sample_prompt_latents(rng, spec.law, len(idx))
        lens[idx] = sample_lengths(rng, lat, r, spec.law)
        phi[idx] = corrupt_latents(rng, lat, spec, cfg.view)
    lens = np.minimum(lens, cfg.max_seq_len)

    pcfg = PredictorConfig(n_bins=n_bins, hidden=hidden, bin_spacing="log",
                           bin_max=float(cfg.max_seq_len), epochs=epochs)
    edges = bins_mod.make_edges(pcfg.n_bins, pcfg.bin_max, pcfg.bin_spacing,
                                device=dev)
    tgt = targets_mod.dist_target(
        torch.as_tensor(lens, dtype=torch.float32, device=dev), edges)
    return train_predictor(seed, phi, tgt, pcfg, edges, device=dev)
