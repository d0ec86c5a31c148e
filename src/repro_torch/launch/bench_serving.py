"""The cluster tables of the serving benchmark that put the ProD head in the
loop, on the port: the twin of the reference's ``benchmarks/bench_serving.py``
for its router, predictor, posterior-refinement and adaptation tables, with
the same matrices, traces, rows and ``validate_*`` checks.

* ``run_cluster``            — router × reservation over a ≥50k-request
  heavy-tailed open-loop trace (all eight model×scenario laws) replayed
  across N ``SimEngine`` replicas, with the ``LatentOracle`` standing in for
  the head (no kernel runs here).
* ``run_cluster_predictors`` — predictor-in-the-loop: the TRAINED ProD-D
  head (batched dispatch-time inference through ``PredictorService``, one
  ``prod_head`` call per padded bucket) vs the analytic ``LatentOracle`` vs
  the zero-error ``PerfectOracle``, crossed with FCFS / EDF / least-laxity.
* ``run_cluster_refine``     — mid-flight posterior refinement: prompt-only
  vs truncate-renorm vs learned-hazard (a hazard head fit and evaluated on
  its progress grid through the kernel), crossed with SRTF+preempt-keep /
  laxity in a KV-bound regime.
* ``run_cluster_adaptation`` — closed-loop online adaptation: static vs
  adaptive-conformal vs conformal+refresh (warm-start refits hot-swapped
  into the live service), on a stationary vs a drifting trace.

Heads train on ``--device`` (``cuda`` unless the CPU is asked for) and the
service scores every dispatch window there; the simulator is NumPy on the
host. Rows that used a ``PredictorService`` carry its ``ServiceStats`` row
(``service``); the refine rows also carry that of the service that annotates
the hazard fit's and the held-out traces (``annotation_service``).

    PYTHONPATH=src python -m repro_torch.launch.bench_serving [--device cpu]
        [--n-requests 50000] [--tables cluster,predictors,refine,adaptation]
"""

from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np

from repro_torch.common.device import DeviceLike, resolve_device
from repro_torch.core.online import PosteriorRefiner, fit_hazard_table
from repro_torch.serving.adaptation import (AdaptationConfig, AdmissionController,
                                            OnlineAdapter, coverage_of)
from repro_torch.serving.arrivals import (DriftSpec, LatentOracle, TraceConfig,
                                          make_trace, mean_true_length, stable_rate)
from repro_torch.serving.cluster import Cluster
from repro_torch.serving.engine import ReplicaSpec
from repro_torch.serving.predictor import (PerfectOracle, PredictorService,
                                           fit_trace_head)
from repro_torch.serving.scheduler import Policy


def make_oracle(cfg: TraceConfig) -> LatentOracle:
    """Shared LatentOracle construction seam for every cluster table (its only
    coupling to ``cfg`` is the trace's ``view`` noise, which the requests'
    features carry)."""
    del cfg
    return LatentOracle()


def _rate(n_replicas: int, max_slots: int, load: float, seed: int) -> float:
    """The arrival rate giving ``load`` utilization, from a 2,000-request
    probe trace's mean length (every table's rule)."""
    probe = make_trace(TraceConfig(n_requests=2000, rate=1.0, seed=seed))
    return stable_rate(n_replicas, max_slots, mean_true_length(probe), load)


def predictor_trace_config(n_requests=50_000, n_replicas=4, max_slots=32,
                           pattern="bursty", load=0.7, slo_factor=10.0,
                           slo_floor=300.0, seed=0) -> TraceConfig:
    """The predictor table's SLO-carrying trace."""
    rate = _rate(n_replicas, max_slots, load, seed)
    return TraceConfig(n_requests=n_requests, rate=rate, pattern=pattern,
                       model="mix", scenario="mix", seed=seed,
                       slo_factor=slo_factor, slo_floor=slo_floor)


# ---------------------------------------------------------------------------
# cluster scale: router × reservation matrix over a heavy-tailed open trace
# ---------------------------------------------------------------------------

CLUSTER_MATRIX = (
    # (router, policy) — round_robin+max is the prediction-blind baseline;
    # psq + quantile is the full ProD-aware stack (predicted-shortest-queue
    # dispatch + distributional-quantile KV reservation)
    ("round_robin", Policy("fcfs", "max", max_seq_len=4096)),
    ("round_robin", Policy("fcfs", "quantile", quantile=0.9, max_seq_len=4096)),
    ("least_kv", Policy("fcfs", "quantile", quantile=0.9, max_seq_len=4096)),
    ("jsq", Policy("fcfs", "quantile", quantile=0.9, max_seq_len=4096)),
    ("psq", Policy("fcfs", "quantile", quantile=0.9, max_seq_len=4096)),
)


def run_cluster(n_requests=50_000, n_replicas=4, max_slots=32,
                pattern="bursty", load=0.7, seed=0, verbose=True):
    """Replay one heavy-tailed mixed-scenario trace under every
    router × reservation policy, at the rate that puts the quantile-reserving
    cluster at ``load`` utilization (the max-reserve baseline is then
    structurally overloaded)."""
    rate = _rate(n_replicas, max_slots, load, seed)
    cfg = TraceConfig(n_requests=n_requests, rate=rate, pattern=pattern,
                      model="mix", scenario="mix", seed=seed)
    t0 = time.time()
    reqs = make_trace(cfg)
    if not reqs:
        print("empty trace (n_requests=0): nothing to replay")
        return []
    if verbose:
        print(f"trace: {n_requests} requests ({pattern}, rate {rate:.3f}/step,"
              f" mean len {mean_true_length(reqs):.0f},"
              f" max len {max(r.true_len for r in reqs)})"
              f" built in {time.time() - t0:.1f}s")
        print(f"  {'router':12s} {'policy':20s} {'makespan':>9s} {'p50':>8s} "
              f"{'p99':>9s} {'waste':>6s} {'ovf':>6s} {'bal':>5s} {'secs':>6s}")
    kv_budget = 8 * (256 + 4096)     # per replica: 8 full max-reservations
    oracle = make_oracle(cfg)
    rows = []
    for router, pol in CLUSTER_MATRIX:
        t0 = time.time()
        st = Cluster.uniform(n_replicas, max_slots, kv_budget, pol,
                             router=router, predictor=oracle).run(reqs)
        dt = time.time() - t0
        row = st.row()
        row["seconds"] = dt
        rows.append(row)
        if verbose:
            print(f"  {st.router:12s} {st.policy:20s} {st.makespan:9.0f} "
                  f"{st.p50_latency:8.1f} {st.p99_latency:9.1f} "
                  f"{st.kv_waste_ratio:6.3f} {st.overflow_events:6d} "
                  f"{st.balance:5.2f} {dt:6.1f}")
    return rows


def validate_cluster(rows) -> dict:
    if not rows:
        return {"empty_trace": True}
    by = {(r["router"], r["policy"]): r for r in rows}
    naive = by[("round_robin", "fcfs+max")]
    prod = by[("psq", "fcfs+quantile")]
    return {
        "all_completed": all(r["completed"] == rows[0]["completed"]
                             for r in rows),
        "prod_beats_naive_p99": prod["p99_latency"] < naive["p99_latency"],
        "prod_p99_gain_x": naive["p99_latency"]
        / max(prod["p99_latency"], 1e-9),
        "prod_reduces_waste": prod["kv_waste_ratio"] < naive["kv_waste_ratio"],
        "replay_seconds_max": max(r["seconds"] for r in rows),
        "replay_under_60s": all(r["seconds"] < 60.0 for r in rows),
    }


# ---------------------------------------------------------------------------
# predictor-in-the-loop: trained ProD-D head vs oracle proxies × orderings
# ---------------------------------------------------------------------------

ORDER_MATRIX = ("fcfs", "edf", "laxity")


def run_cluster_predictors(n_requests=50_000, n_replicas=4, max_slots=32,
                           pattern="bursty", load=0.7, slo_factor=10.0,
                           slo_floor=300.0, seed=0, n_train=4000,
                           verbose=True, device: DeviceLike = None):
    """The paper's head in the serving path: replay one SLO-carrying trace
    under predictor ∈ {LatentOracle (analytic proxy), trained ProD-D head
    (batched dispatch-time inference through the kernel), PerfectOracle
    (upper bound)} × ordering ∈ {fcfs, edf, laxity}, all with psq routing +
    q0.9 quantile reservation. The trained head is fit on repeated-generation
    targets from the same calibrated laws (never on the served trace)."""
    dev = resolve_device(device)
    cfg = predictor_trace_config(n_requests, n_replicas, max_slots, pattern,
                                 load, slo_factor, slo_floor, seed)
    t0 = time.time()
    reqs = make_trace(cfg)
    if not reqs:
        print("empty trace (n_requests=0): nothing to replay")
        return []
    t_trace = time.time() - t0
    t0 = time.time()
    head = fit_trace_head(cfg, n_train=n_train, r=16, seed=seed + 7, device=dev)
    t_train = time.time() - t0
    if verbose:
        print(f"predictor trace: {n_requests} requests ({pattern}, rate "
              f"{cfg.rate:.3f}/step, SLO = arrival + {slo_floor:.0f} + "
              f"{slo_factor:.0f}x class median) built in {t_trace:.1f}s; "
              f"ProD-D head trained on {n_train}x16 repeated draws "
              f"in {t_train:.1f}s on {dev}")
        print(f"  {'predictor':14s} {'order':8s} {'p50':>8s} {'p99':>9s} "
              f"{'viol':>6s} {'t/o':>6s} {'goodput':>8s} {'waste':>6s} "
              f"{'secs':>6s}")
    kv_budget = 8 * (256 + 4096)
    predictors = (
        ("latent-oracle", lambda: make_oracle(cfg)),
        ("trained-prod-d", lambda: PredictorService(head, window=16.0)),
        ("perfect", lambda: PerfectOracle()),
    )
    rows = []
    for pname, make_pred in predictors:
        for order in ORDER_MATRIX:
            pol = Policy(order, "quantile", quantile=0.9, max_seq_len=4096)
            pred = make_pred()
            t0 = time.time()
            st = Cluster.uniform(n_replicas, max_slots, kv_budget, pol,
                                 router="psq", predictor=pred).run(reqs)
            dt = time.time() - t0
            row = st.row()
            row.update(predictor=pname, order=order, seconds=dt)
            if isinstance(pred, PredictorService):
                row["service"] = pred.stats.row()
            rows.append(row)
            if verbose:
                print(f"  {pname:14s} {order:8s} {st.p50_latency:8.1f} "
                      f"{st.p99_latency:9.1f} {st.slo_violations:6d} "
                      f"{st.timed_out:6d} {st.goodput:8.2f} "
                      f"{st.kv_waste_ratio:6.3f} {dt:6.1f}")
    if verbose:
        srow = next(r["service"] for r in rows if "service" in r)
        print(f"  service: {srow['batches']} fused batches, mean batch "
              f"{srow['mean_batch']:.1f}, hit rate {srow['hit_rate']:.3f}, "
              f"buckets {srow['buckets']}")
    return rows


def validate_cluster_predictors(rows) -> dict:
    if not rows:
        return {"empty_trace": True}
    by = {(r["predictor"], r["order"]): r for r in rows}

    def bad(r):
        return r["slo_violations"] + r["timed_out"]

    trained_f = by[("trained-prod-d", "fcfs")]
    trained_l = by[("trained-prod-d", "laxity")]
    trained_e = by[("trained-prod-d", "edf")]
    oracle_f = by[("latent-oracle", "fcfs")]
    perfect_f = by[("perfect", "fcfs")]
    deadline_best = min(bad(trained_e), bad(trained_l))
    srow = trained_f.get("service", {})
    return {
        "trained_head_in_loop": srow.get("batches", 0) > 0,
        "service_mean_batch": srow.get("mean_batch", 0.0),
        "perfect_is_bound_p99": perfect_f["p99_latency"]
        <= trained_f["p99_latency"] * 1.05,
        "trained_within_2x_oracle_p99": trained_f["p99_latency"]
        <= 2.0 * oracle_f["p99_latency"],
        "trained_p99_vs_oracle_x": trained_f["p99_latency"]
        / max(oracle_f["p99_latency"], 1e-9),
        "deadline_order_cuts_slo_misses": deadline_best < bad(trained_f),
        "deadline_slo_gain_x": bad(trained_f) / max(deadline_best, 1e-9),
        "replay_under_90s": all(r["seconds"] < 90.0 for r in rows),
    }


# ---------------------------------------------------------------------------
# mid-flight posterior refinement: prompt-only vs truncate-renorm vs hazard
# ---------------------------------------------------------------------------

REFINE_MODES = (
    # (label, refine?, hazard?) — "prompt-only" is the dispatch-time head
    # frozen for the request's lifetime (refine_every=0); "renorm"
    # re-conditions each active slot's ProD-D histogram on survival
    # (P[L = l | L > t], pure truncate-renormalize) every refine tick;
    # "hazard" additionally applies the learned hazard-rate correction fit
    # from repeated-generation traces.
    ("prompt-only", False, False),
    ("renorm", True, False),
    ("hazard", True, True),
)

REFINE_T_GRID = (16, 32, 64, 128, 256, 512)


def _mae_by_progress(reqs, refiner, t_grid=REFINE_T_GRID) -> list:
    """Remaining-work MAE by decode progress on an annotated trace:
    posterior quantile-0.5 remaining vs the static prompt-only median
    (``max(predicted_len − t, 1)``), over requests still alive at t."""
    out = []
    for t in t_grid:
        alive = [r for r in reqs if r.true_len > t]
        if len(alive) < 50:
            break
        post = float(np.mean(
            [abs((refiner.quantile(r.pred_probs, float(t), 0.5) - t)
                 - (r.true_len - t)) for r in alive]))
        prompt = float(np.mean(
            [abs(max(r.predicted_len - t, 1.0) - (r.true_len - t))
             for r in alive]))
        out.append({"t": t, "alive": len(alive), "posterior_mae": post,
                    "prompt_only_mae": prompt, "posterior_wins":
                    bool(post < prompt)})
    return out


def run_cluster_refine(n_requests=50_000, n_replicas=4, max_slots=16,
                       load=0.97, seed=0, refine_every=128, verbose=True,
                       device: DeviceLike = None):
    """Mid-flight posterior refinement table: {prompt-only, truncate-renorm,
    learned-hazard} × {SRTF+preempt-keep, least-laxity} on one KV-bound
    heavy-tailed mixed trace served by the trained ProD-D head (d=4,
    hidden 64, K=32). The hazard table is fit on a disjoint trace annotated
    by the head, and a held-out trace gives the MAE-by-progress sub-table."""
    if n_requests <= 0:
        print("empty trace (n_requests=0): nothing to replay")
        return []
    dev = resolve_device(device)
    rate = _rate(n_replicas, max_slots, load, seed)
    cfg = TraceConfig(n_requests=n_requests, rate=rate, pattern="bursty",
                      model="mix", scenario="mix", seed=seed,
                      slo_factor=6.0, slo_floor=100.0)
    t0 = time.time()
    head = fit_trace_head(cfg, n_train=2000, r=8, n_bins=32, hidden=64,
                          seed=seed + 7, device=dev)
    t_train = time.time() - t0
    edges = head.edges.cpu().numpy().astype(np.float64)
    anno_pol = Policy("fcfs", "quantile", quantile=0.9, max_seq_len=4096)
    svc = PredictorService(head, window=16.0)
    # hazard correction: fit on a disjoint repeated-generation trace
    t0 = time.time()
    fit_reqs = make_trace(TraceConfig(n_requests=3000, rate=1.0, model="mix",
                                      scenario="mix", seed=seed + 101))
    svc.annotate(fit_reqs, anno_pol)
    hazard = fit_hazard_table(
        seed + 3, np.stack([r.pred_probs for r in fit_reqs]),
        np.array([r.true_len for r in fit_reqs], np.float64), edges,
        device=dev)
    t_hazard = time.time() - t0
    refiners = {"renorm": PosteriorRefiner(edges),
                "hazard": PosteriorRefiner(edges, hazard=hazard)}
    # held-out MAE-by-progress table (how fast the posterior wins)
    held = make_trace(TraceConfig(n_requests=3000, rate=1.0, model="mix",
                                  scenario="mix", seed=seed + 202))
    svc.annotate(held, anno_pol)
    mae = {m: _mae_by_progress(held, rz) for m, rz in refiners.items()}
    reqs = make_trace(cfg)
    if verbose:
        print(f"refine trace: {len(reqs)} requests (bursty, rate "
              f"{rate:.3f}/step, KV-bound); head fit {t_train:.1f}s, hazard "
              f"table fit {t_hazard:.1f}s ({len(hazard.ts)} grid rows) on "
              f"{dev}; refine_every={refine_every}")
        for m in refiners:
            won = [r["t"] for r in mae[m] if r["posterior_wins"]]
            print(f"  mae_by_t[{m}]: posterior wins from t={won[0] if won else '-'}"
                  f" (grid {', '.join(str(r['t']) for r in mae[m])})")
        print(f"  {'mode':12s} {'order':10s} {'p50':>7s} {'p99':>9s} "
              f"{'slo':>5s} {'t/o':>5s} {'goodput':>8s} {'thr':>7s} "
              f"{'waste':>6s} {'shrink':>6s} {'grow':>6s} {'secs':>5s}")
    rows = []
    for order in ("srtf_pred", "laxity"):
        for label, refine, use_hazard in REFINE_MODES:
            pol = Policy(order, "quantile", quantile=0.9, max_seq_len=4096,
                         preempt=(order == "srtf_pred"), preempt_factor=1.5,
                         preempt_mode="keep",
                         refine_every=refine_every if refine else 0)
            rz = refiners["hazard" if use_hazard else "renorm"] \
                if refine else None
            specs = tuple(ReplicaSpec(max_slots=max_slots, kv_budget=8192,
                                      page_size=16, speed=2,
                                      prefill_tokens_per_step=64)
                          for _ in range(n_replicas))
            pred = PredictorService(head, window=16.0)
            t0 = time.time()
            st = Cluster(specs, pol, router="psq", predictor=pred,
                         refiner=rz).run(reqs)
            dt = time.time() - t0
            row = st.row()
            row.update(mode=label, order=order, seconds=dt,
                       mae_by_t=mae.get(label, []), service=pred.stats.row(),
                       annotation_service=svc.stats.row())
            rows.append(row)
            if verbose:
                print(f"  {label:12s} {order:10s} {st.p50_latency:7.1f} "
                      f"{st.p99_latency:9.1f} {st.slo_violations:5d} "
                      f"{st.timed_out:5d} {st.goodput:8.2f} "
                      f"{st.throughput:7.2f} {st.kv_waste_ratio:6.3f} "
                      f"{st.refine_shrinks:6d} {st.refine_grows:6d} "
                      f"{dt:5.1f}")
    return rows


def validate_cluster_refine(rows) -> dict:
    if not rows:
        return {"empty_trace": True}
    by = {(r["mode"], r["order"]): r for r in rows}
    po_s = by[("prompt-only", "srtf_pred")]
    rn_s = by[("renorm", "srtf_pred")]
    hz_s = by[("hazard", "srtf_pred")]
    po_l = by[("prompt-only", "laxity")]
    hz_l = by[("hazard", "laxity")]
    n = po_s["completed"] + po_s["timed_out"] + po_s["dropped"] \
        + po_s["rejected"]
    mae = rn_s["mae_by_t"]
    wins = [m["t"] for m in mae if m["posterior_wins"]]
    return {
        "all_accounted": all(
            r["completed"] + r["timed_out"] + r["dropped"] + r["rejected"]
            == n for r in rows),
        "refine_exercised": rn_s["refine_events"] > 0
        and hz_s["refine_shrinks"] > 0,
        "prompt_only_is_inert": po_s["refine_events"] == 0,
        # the posterior's remaining-work MAE strictly beats the frozen
        # prompt-only head from some progress point on
        "mae_posterior_wins_at_some_t": bool(wins),
        "mae_first_win_t": wins[0] if wins else None,
        "mae_final_gain_pct": 100.0 * (1.0 - mae[-1]["posterior_mae"]
                                       / max(mae[-1]["prompt_only_mae"],
                                             1e-9)) if mae else 0.0,
        # refreshed SRTF keys must not cost tail latency ...
        "posterior_srtf_p99_not_worse":
            rn_s["p99_latency"] <= po_s["p99_latency"]
        and hz_s["p99_latency"] <= po_s["p99_latency"],
        "srtf_p99_gain_pct": 100.0 * (1.0 - rn_s["p99_latency"]
                                      / max(po_s["p99_latency"], 1e-9)),
        # ... and buy an SLO-attainment win on the SRTF row
        "posterior_srtf_slo_win":
            rn_s["slo_violations"] < po_s["slo_violations"],
        # hazard shrinks hand KV capacity back on the laxity row
        "hazard_laxity_goodput_not_worse":
            hz_l["goodput"] >= po_l["goodput"],
        "hazard_laxity_goodput_gain_pct":
            100.0 * (hz_l["goodput"] / max(po_l["goodput"], 1e-9) - 1.0),
        # grown posterior reservations eat KV-bound throughput (reported)
        "renorm_srtf_goodput_delta_pct":
            100.0 * (rn_s["goodput"] / max(po_s["goodput"], 1e-9) - 1.0),
        "replay_under_120s": all(r["seconds"] < 120.0 for r in rows),
    }


# ---------------------------------------------------------------------------
# online adaptation: static vs conformal vs conformal+refresh, under drift
# ---------------------------------------------------------------------------

ADAPT_MODES = (
    # (label, gamma, refresh?) — "static" runs the identical closed-loop code
    # path with a frozen quantile, so coverage is measured apples-to-apples
    ("static", 0.0, False),
    ("conformal", 0.01, False),
    ("conformal+refresh", 0.01, True),
)


def _coverage_split(cl: Cluster, switch: float) -> tuple:
    """(overall, post-switch) reservation coverage over completed requests
    (see :func:`repro_torch.serving.adaptation.coverage_of`)."""
    done = [r for e in cl.engines for r in e.done]
    return coverage_of(done), coverage_of(done, since=switch)


def run_cluster_adaptation(n_requests=50_000, n_replicas=4, max_slots=32,
                           pattern="bursty", load=0.7, slo_factor=10.0,
                           slo_floor=300.0, scale_mult=1.5, seed=0,
                           n_train=4000, target=0.9, verbose=True,
                           device: DeviceLike = None):
    """Closed-loop adaptation table: serve the trained ProD-D head through an
    ``OnlineAdapter`` in mode ∈ {static, conformal, conformal+refresh} ×
    trace ∈ {stationary, drift} (true-length scales × ``scale_mult`` half way
    through, features unchanged), all with SLO-aware admission. Reports
    reservation coverage (overall and post-switch), p99, SLO misses,
    rejects, refreshes, and goodput."""
    dev = resolve_device(device)
    rate = _rate(n_replicas, max_slots, load, seed)
    switch = 0.5 * n_requests / rate
    base_cfg = TraceConfig(n_requests=n_requests, rate=rate, pattern=pattern,
                           model="mix", scenario="mix", seed=seed,
                           slo_factor=slo_factor, slo_floor=slo_floor)
    traces = (
        ("stationary", make_trace(base_cfg)),
        ("drift", make_trace(dataclasses.replace(
            base_cfg,
            drift=DriftSpec(switch_step=switch, scale_mult=scale_mult)))),
    )
    t0 = time.time()
    head = fit_trace_head(base_cfg, n_train=n_train, r=16, seed=seed + 7,
                          device=dev)
    t_train = time.time() - t0
    makespan_est = n_requests / rate
    if verbose:
        print(f"adaptation traces: {n_requests} requests ({pattern}, rate "
              f"{rate:.3f}/step; drift = x{scale_mult} true-length scale at "
              f"step {switch:.0f}); ProD-D head trained in {t_train:.1f}s on "
              f"{dev}; coverage target {target}")
        print(f"  {'trace':11s} {'mode':18s} {'cov':>6s} {'cov>sw':>7s} "
              f"{'p99':>9s} {'viol':>6s} {'t/o':>6s} {'rej':>6s} "
              f"{'refit':>5s} {'q_eff':>6s} {'goodput':>8s} {'secs':>6s}")
    kv_budget = 8 * (256 + 4096)
    pol = Policy("fcfs", "quantile", quantile=target, max_seq_len=4096)
    rows = []
    for tname, reqs in traces:
        for label, gamma, refresh in ADAPT_MODES:
            cfg = AdaptationConfig(
                target_coverage=target, gamma=gamma, window=512, every=32,
                refresh_every=makespan_est / 8.0 if refresh else 0.0,
                refresh_min_samples=512, refresh_epochs=2,
                buffer_size=4096, refresh_seed=seed + 11)
            adapter = OnlineAdapter(PredictorService(head, window=16.0), cfg)
            cl = Cluster.uniform(n_replicas, max_slots, kv_budget, pol,
                                 router="psq", predictor=adapter,
                                 admission=AdmissionController())
            t0 = time.time()
            st = cl.run(reqs)
            dt = time.time() - t0
            cov, cov_post = _coverage_split(cl, switch)
            row = st.row()
            row.update(trace=tname, mode=label, coverage=cov,
                       coverage_post=cov_post, seconds=dt,
                       adapter=adapter.row(),
                       service=adapter.base.stats.row())
            rows.append(row)
            if verbose:
                print(f"  {tname:11s} {label:18s} {cov:6.3f} {cov_post:7.3f} "
                      f"{st.p99_latency:9.1f} {st.slo_violations:6d} "
                      f"{st.timed_out:6d} {st.rejected:6d} "
                      f"{st.refreshes:5d} {adapter.q_eff:6.3f} "
                      f"{st.goodput:8.2f} {dt:6.1f}")
    return rows


def validate_cluster_adaptation(rows, target=0.9) -> dict:
    if not rows:
        return {"empty_trace": True}
    by = {(r["trace"], r["mode"]): r for r in rows}
    stat_static = by[("stationary", "static")]
    stat_adapt = by[("stationary", "conformal+refresh")]
    dr_static = by[("drift", "static")]
    dr_conf = by[("drift", "conformal")]
    dr_adapt = by[("drift", "conformal+refresh")]
    return {
        # static coverage collapses under drift ...
        "static_drift_cov_drop": target - dr_static["coverage_post"],
        "static_drift_degrades": dr_static["coverage_post"] <= target - 0.10,
        # ... while the adapted stack holds the target post-switch
        "adapted_drift_cov_err": abs(dr_adapt["coverage_post"] - target),
        "adapted_holds_target": abs(dr_adapt["coverage_post"] - target)
        <= 0.05,
        "conformal_recovers": dr_conf["coverage_post"]
        > dr_static["coverage_post"],
        "refresh_used": dr_adapt["refreshes"] > 0,
        "refresh_cuts_slo_misses": (dr_adapt["slo_violations"]
                                    + dr_adapt["timed_out"])
        <= (dr_static["slo_violations"] + dr_static["timed_out"]),
        # no p99 regression from running the adaptation loop when stationary
        "stationary_p99_ok": stat_adapt["p99_latency"]
        <= 1.05 * stat_static["p99_latency"],
        "stationary_cov_err": abs(stat_adapt["coverage"] - target),
        "replay_under_120s": all(r["seconds"] < 120.0 for r in rows),
    }


TABLES = {
    "cluster": (run_cluster, validate_cluster),
    "predictors": (run_cluster_predictors, validate_cluster_predictors),
    "refine": (run_cluster_refine, validate_cluster_refine),
    "adaptation": (run_cluster_adaptation, validate_cluster_adaptation),
}


def run_table(name: str, n_requests: int = 50_000, seed: int = 0,
              device: DeviceLike = None, verbose: bool = True):
    """One table at its reference defaults: (rows, checks)."""
    run, validate = TABLES[name]
    kw = dict(n_requests=n_requests, seed=seed, verbose=verbose)
    if name != "cluster":
        kw["device"] = device
    rows = run(**kw)
    return rows, validate(rows)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--n-requests", type=int, default=50_000)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--tables", default=",".join(TABLES),
                    help="comma-separated subset of " + ", ".join(TABLES))
    args = ap.parse_args(argv)
    names = [t for t in args.tables.split(",") if t]
    bad = [t for t in names if t not in TABLES]
    if bad:
        ap.error(f"unknown tables {bad}; choose from {list(TABLES)}")
    dev = resolve_device(args.device)
    out = {}
    for name in names:
        rows, checks = run_table(name, args.n_requests, args.seed, dev)
        print(f"{name} checks:", checks)
        out[name] = (rows, checks)
    return out


if __name__ == "__main__":
    main()
