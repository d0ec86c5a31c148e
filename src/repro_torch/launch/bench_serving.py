"""The serving benchmark on the port: the twin of the reference's
``benchmarks/bench_serving.py``, every table with the same matrices, traces,
rows and ``validate_*`` checks.

* ``run``                    — single replica, head TRAINED on scenario
  features (qwen/chat): FCFS/max-reserve (vLLM-naive) vs ProD-driven SJF +
  quantile reservation vs the oracle upper bound, under a KV-memory-bound
  regime; each ``SimEngine`` run predicts its medians in one ``prod_head``
  call.
* ``run_cluster``            — router × reservation over a ≥50k-request
  heavy-tailed open-loop trace (all eight model×scenario laws) replayed
  across N ``SimEngine`` replicas, with the ``LatentOracle`` standing in for
  the head (no kernel runs here).
* ``run_cluster_hetero``     — heterogeneous fleet × per-class SLOs × work
  stealing (``LatentOracle``).
* ``run_cluster_predictors`` — predictor-in-the-loop: the TRAINED ProD-D
  head (batched dispatch-time inference through ``PredictorService``, one
  ``prod_head`` call per padded bucket) vs the analytic ``LatentOracle`` vs
  the zero-error ``PerfectOracle``, crossed with FCFS / EDF / least-laxity.
* ``run_cluster_preemption`` — keep-pages vs recompute preemption at equal KV
  budget (``LatentOracle``).
* ``run_cluster_adaptation`` — closed-loop online adaptation: static vs
  adaptive-conformal vs conformal+refresh (warm-start refits hot-swapped
  into the live service), on a stationary vs a drifting trace.
* ``run_cluster_prefix``     — shared-context traffic with ref-counted
  prefix sharing off/on × {jsq, prefix_affine} (``LatentOracle``).
* ``run_cluster_chunked``    — chunked prefill under a per-step token
  budget: TTFT vs throughput (``LatentOracle``).
* ``run_cluster_refine``     — mid-flight posterior refinement: prompt-only
  vs truncate-renorm vs learned-hazard (a hazard head fit and evaluated on
  its progress grid through the kernel), crossed with SRTF+preempt-keep /
  laxity in a KV-bound regime.
* ``run_obs``                — the telemetry smoke table: tracer inertness,
  equal event streams on both decode paths, conservation, and the Perfetto /
  Prometheus / JSON artifacts written to ``out_dir`` (``LatentOracle``).

Heads train on ``--device`` (``cuda`` unless the CPU is asked for) and the
service scores every dispatch window there; the simulator is NumPy on the
host, so the ``LatentOracle`` tables touch no tensor. Rows that used a
``PredictorService`` carry its ``ServiceStats`` row (``service``); the
refine rows also carry that of the service that annotates the hazard fit's
and the held-out traces (``annotation_service``). ``--tables`` picks tables
(by default every one but ``obs``, as the reference's ``main``); named
alone, a table whose reference ``--<table>-only`` mode gates on its
acceptance booleans exits non-zero when one of them fails. ``--stamp PATH``
writes each table's rows and checks to PATH as it finishes, under the
reference's keys (``STAMP_KEYS``), with the meta knobs the reference records;
``launch/check_regression.py`` gates one stamp against another.

    PYTHONPATH=src python -m repro_torch.launch.bench_serving [--device cpu]
        [--n-requests 50000] [--tables single,cluster,hetero,...] [--obs-dir DIR]
        [--stamp PATH [--timestamp TS]]
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import time

import numpy as np
import torch

from repro_torch.common.device import DeviceLike, resolve_device
from repro_torch.core import bins as bins_mod
from repro_torch.core import targets as targets_mod
from repro_torch.core.online import PosteriorRefiner, fit_hazard_table
from repro_torch.core.predictor import train_predictor
from repro_torch.data import make_scenario
from repro_torch.launch.table1 import scenario_pcfg
from repro_torch.serving.adaptation import (AdaptationConfig, AdmissionController,
                                            OnlineAdapter, coverage_of)
from repro_torch.serving.arrivals import (DriftSpec, LatentOracle, TraceConfig,
                                          make_trace, mean_true_length, stable_rate,
                                          stable_rate_specs)
from repro_torch.serving.cluster import Cluster
from repro_torch.serving.engine import ReplicaSpec, SimEngine
from repro_torch.serving.predictor import (PerfectOracle, PredictorService,
                                           fit_trace_head)
from repro_torch.serving.request import workload_from_scenario
from repro_torch.serving.scheduler import Policy
from repro_torch.serving.telemetry import Tracer


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
# single replica: a head trained on scenario features, SimEngine policies
# ---------------------------------------------------------------------------

POLICIES = (
    Policy("fcfs", "max", max_seq_len=2048),
    Policy("fcfs", "predicted", max_seq_len=2048),
    Policy("sjf_pred", "predicted", max_seq_len=2048),
    Policy("sjf_pred", "quantile", quantile=0.9, max_seq_len=2048),
    Policy("srtf_pred", "quantile", quantile=0.9, max_seq_len=2048,
           preempt=True),
    Policy("sjf_oracle", "oracle", max_seq_len=2048),
)


def run(model="qwen", scen="chat", n_requests=250, fast=True, seed=0,
        verbose=True, device: DeviceLike = None):
    """A ProD-D head trained on the scenario's last-token φ, then its test
    split served by one ``SimEngine`` replica under every policy of
    :data:`POLICIES` in a KV-memory-bound regime. The reference seeds the
    head with ``PRNGKey(seed)``; the port with ``seed`` itself."""
    dev = resolve_device(device)
    data = make_scenario(model, scen, n_train=800 if fast else None,
                         n_test=max(400, n_requests), seed=seed,
                         full_paper_splits=not fast)
    pcfg = scenario_pcfg(data, epochs=15 if fast else 30)
    edges = bins_mod.make_edges(pcfg.n_bins, pcfg.bin_max, device=dev)
    tgt = targets_mod.dist_target(
        torch.as_tensor(data.len_train, dtype=torch.float32, device=dev), edges)
    pred = train_predictor(seed, data.phi_train["last"], tgt, pcfg, edges,
                           device=dev)
    reqs = workload_from_scenario(data, n_requests, seed=seed, arrival_rate=3.0)
    # memory-bound regime: budget ~8 full reservations
    kv_budget = 8 * (128 + 2048)
    rows = []
    for pol in POLICIES:
        st = SimEngine(max_slots=64, kv_budget=kv_budget, policy=pol,
                       predictor=pred).run(reqs)
        rows.append(st.row())
        if verbose:
            print(f"  {st.policy:24s} lat={st.mean_latency:9.1f} "
                  f"p90={st.p90_latency:9.1f} thr={st.throughput:6.2f} "
                  f"waste={st.kv_waste_ratio:.3f} ovf={st.overflow_events} "
                  f"peak={st.peak_reserved}")
    return rows


def validate(rows) -> dict:
    by = {r["policy"]: r for r in rows}
    naive = by["fcfs+max"]
    prod = by["sjf_pred+quantile"]
    srtf = by.get("srtf_pred+quantile", prod)
    oracle = by["sjf_oracle+oracle"]
    return {
        "prod_beats_naive_latency": prod["mean_latency"] < naive["mean_latency"],
        "prod_latency_gain_pct": 100 * (naive["mean_latency"] - prod["mean_latency"])
        / naive["mean_latency"],
        "prod_reduces_waste": prod["kv_waste_ratio"] < naive["kv_waste_ratio"],
        "oracle_is_bound": oracle["mean_latency"] <= prod["mean_latency"] * 1.05,
        "prod_throughput_gain_pct": 100 * (prod["throughput"] - naive["throughput"])
        / max(naive["throughput"], 1e-9),
        "srtf_not_worse_than_sjf": srtf["mean_latency"]
        <= prod["mean_latency"] * 1.05,
        "srtf_preemptions": srtf.get("preemptions", 0),
    }


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
# heterogeneous fleet × SLO × work stealing
# ---------------------------------------------------------------------------

def hetero_specs(max_slots=32) -> tuple:
    """2 fast large replicas + 2 slow small ones (half the slots/KV, 1/2 the
    decode speed) — the mixed-fleet regime where load-blind routing breaks."""
    kv_fast = 8 * (256 + 4096)
    return (
        ReplicaSpec(max_slots, kv_fast, speed=2, prefill_tokens_per_step=256),
        ReplicaSpec(max_slots, kv_fast, speed=2, prefill_tokens_per_step=256),
        ReplicaSpec(max_slots // 2, kv_fast // 2, speed=1,
                    prefill_tokens_per_step=128),
        ReplicaSpec(max_slots // 2, kv_fast // 2, speed=1,
                    prefill_tokens_per_step=128),
    )


HETERO_MATRIX = (
    # (router, policy, rebalance_every, steal) — the load/speed-blind
    # round_robin baseline vs increasingly prediction-aware stacks, ending in
    # the full ProD stack: psq dispatch + quantile reservation + ProD-aware
    # quantile work stealing
    ("round_robin", Policy("fcfs", "max", max_seq_len=4096), 0, "tail"),
    ("round_robin", Policy("fcfs", "quantile", quantile=0.9,
                           max_seq_len=4096), 0, "tail"),
    ("jsq", Policy("fcfs", "quantile", quantile=0.9, max_seq_len=4096),
     0, "tail"),
    ("psq", Policy("fcfs", "quantile", quantile=0.9, max_seq_len=4096),
     0, "tail"),
    ("psq", Policy("fcfs", "quantile", quantile=0.9, max_seq_len=4096),
     100, "tail"),
    ("psq", Policy("fcfs", "quantile", quantile=0.9, max_seq_len=4096),
     100, "quantile"),
)


def run_cluster_hetero(n_requests=50_000, max_slots=32, pattern="bursty",
                       load=0.8, slo_factor=8.0, slo_floor=200.0, seed=0,
                       verbose=True):
    """Heterogeneous 4-replica fleet under per-class SLOs: router ×
    reservation × work-stealing matrix over one heavy-tailed trace. The
    arrival rate targets ``load`` of the fleet's speed-weighted decode
    capacity, so speed-blind dispatch structurally overloads the slow
    replicas — the regime where prediction-aware routing + stealing pays."""
    specs = hetero_specs(max_slots)
    probe = make_trace(TraceConfig(n_requests=2000, rate=1.0, seed=seed))
    rate = stable_rate_specs(specs, mean_true_length(probe), load)
    cfg = TraceConfig(n_requests=n_requests, rate=rate, pattern=pattern,
                      model="mix", scenario="mix", seed=seed,
                      slo_factor=slo_factor, slo_floor=slo_floor)
    t0 = time.time()
    reqs = make_trace(cfg)
    if not reqs:
        print("empty trace (n_requests=0): nothing to replay")
        return []
    if verbose:
        print(f"hetero trace: {n_requests} requests ({pattern}, "
              f"rate {rate:.3f}/step, mean len {mean_true_length(reqs):.0f}, "
              f"SLO = arrival + {slo_floor:.0f} + {slo_factor:.0f}x class "
              f"median) built in {time.time() - t0:.1f}s")
        print(f"  specs: 2x(slots={max_slots},speed=2) + "
              f"2x(slots={max_slots // 2},speed=1), prefill modeled")
        print(f"  {'router':12s} {'policy':16s} {'steal':>12s} {'p50':>8s} "
              f"{'p99':>9s} {'viol':>6s} {'t/o':>6s} {'goodput':>8s} "
              f"{'stolen':>7s} {'secs':>6s}")
    oracle = make_oracle(cfg)
    rows = []
    for router, pol, reb, steal in HETERO_MATRIX:
        t0 = time.time()
        st = Cluster(specs, pol, router=router, predictor=oracle,
                     rebalance_every=reb, steal=steal).run(reqs)
        dt = time.time() - t0
        row = st.row()
        row["seconds"] = dt
        row["rebalance_every"] = reb
        row["steal"] = steal if reb else "off"
        rows.append(row)
        if verbose:
            label = f"{steal}@{reb}" if reb else "off"
            print(f"  {st.router:12s} {st.policy:16s} {label:>12s} "
                  f"{st.p50_latency:8.1f} {st.p99_latency:9.1f} "
                  f"{st.slo_violations:6d} {st.timed_out:6d} "
                  f"{st.goodput:8.2f} {st.stolen:7d} {dt:6.1f}")
    return rows


def validate_cluster_hetero(rows) -> dict:
    if not rows:
        return {"empty_trace": True}
    by = {(r["router"], r["policy"], r["steal"]): r for r in rows}
    naive = by[("round_robin", "fcfs+max", "off")]
    prod = by[("psq", "fcfs+quantile", "quantile")]

    def bad(r):
        return r["slo_violations"] + r["timed_out"]

    return {
        "prod_steal_beats_rr_p99": prod["p99_latency"] < naive["p99_latency"],
        "prod_steal_beats_rr_slo": bad(prod) < bad(naive),
        "prod_p99_gain_x": naive["p99_latency"]
        / max(prod["p99_latency"], 1e-9),
        "prod_slo_gain_x": bad(naive) / max(bad(prod), 1e-9),
        "prod_goodput_gain_x": prod["goodput"]
        / max(naive["goodput"], 1e-9),
        "stealing_used": prod["stolen"] > 0,
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
# preemption modes: recompute vs keep-pages, over orderings x quantiles
# ---------------------------------------------------------------------------

PREEMPTION_MATRIX = tuple(
    # (order, preempt_mode, quantile, preempt) — the paired recompute/keep
    # rows differ ONLY in what happens to a victim's KV reservation, so the
    # delta is exactly the partial-reservation handoff; the preempt=False
    # pair is the no-regression control (modes must be bit-identical there)
    (order, mode, q, True)
    for order in ("srtf_pred", "laxity")
    for q in (0.75, 0.9)
    for mode in ("recompute", "keep")
) + (("srtf_pred", "recompute", 0.9, False),
     ("srtf_pred", "keep", 0.9, False))


def run_cluster_preemption(n_requests=50_000, n_replicas=4, max_slots=32,
                           pattern="bursty", load=0.55, page_size=16,
                           seed=0, verbose=True):
    """Keep-pages vs recompute preemption at equal KV budget: replay one
    heavy-tailed trace under srtf/laxity preemptive orderings × reservation
    quantiles × ``preempt_mode``, on a paged (``page_size``-token) KV pool
    with an expensive prefill (so a recompute-mode resume visibly re-pays
    ceil((prompt+progress)/rate) ticks that keep mode skips). The load is
    feasible — every request completes — so the latency columns isolate the
    recompute waste instead of saturating at the SLO deadline."""
    rate = _rate(n_replicas, max_slots, load, seed)
    cfg = TraceConfig(n_requests=n_requests, rate=rate, pattern=pattern,
                      model="mix", scenario="mix", seed=seed,
                      slo_factor=30.0, slo_floor=2000.0)
    t0 = time.time()
    reqs = make_trace(cfg)
    if not reqs:
        print("empty trace (n_requests=0): nothing to replay")
        return []
    kv_budget = (8 * (256 + 4096)) // page_size * page_size
    specs = (ReplicaSpec(max_slots, kv_budget, speed=1,
                         prefill_tokens_per_step=8,
                         page_size=page_size),) * n_replicas
    if verbose:
        print(f"preemption trace: {n_requests} requests ({pattern}, rate "
              f"{rate:.3f}/step) built in {time.time() - t0:.1f}s; "
              f"page_size={page_size}, kv={kv_budget}/replica, prefill "
              f"8 tok/tick")
        print(f"  {'order':10s} {'mode':10s} {'q':>5s} {'preempt':>8s} "
              f"{'p50':>8s} {'p99':>9s} {'recomp':>7s} {'heldpk':>7s} "
              f"{'occ':>6s} {'frag':>6s} {'secs':>6s}")
    oracle = make_oracle(cfg)
    rows = []
    for order, mode, q, preempt in PREEMPTION_MATRIX:
        pol = Policy(order, "quantile", quantile=q, max_seq_len=4096,
                     preempt=preempt, preempt_factor=1.2, preempt_mode=mode)
        t0 = time.time()
        st = Cluster(specs, pol, router="psq", predictor=oracle).run(reqs)
        dt = time.time() - t0
        row = st.row()
        row.update(order=order, mode=mode, quantile=q, preempt=preempt,
                   seconds=dt)
        rows.append(row)
        if verbose:
            print(f"  {order:10s} {mode:10s} {q:5.2f} {str(preempt):>8s} "
                  f"{st.p50_latency:8.1f} {st.p99_latency:9.1f} "
                  f"{st.recompute_ticks:7d} {st.held_peak:7d} "
                  f"{st.occupancy:6.3f} {st.frag_ratio:6.4f} {dt:6.1f}")
    return rows


def validate_cluster_preemption(rows) -> dict:
    if not rows:
        return {"empty_trace": True}
    by = {(r["order"], r["mode"], r["quantile"], r["preempt"]): r
          for r in rows}
    pairs = [((o, "recompute", q, True), (o, "keep", q, True))
             for o in ("srtf_pred", "laxity") for q in (0.75, 0.9)]
    recomp_cut = all(by[k]["recompute_ticks"] > by[kk]["recompute_ticks"]
                     for k, kk in pairs)
    # headline claim: strict p99 reduction on the srtf pairs (the classic
    # SRTF-churn regime); the laxity pairs must stay within noise (5%)
    p99_srtf = all(by[("srtf_pred", "keep", q, True)]["p99_latency"]
                   < by[("srtf_pred", "recompute", q, True)]["p99_latency"]
                   for q in (0.75, 0.9))
    p99_not_worse = all(by[kk]["p99_latency"] <= by[k]["p99_latency"] * 1.05
                        for k, kk in pairs)
    base = by[("srtf_pred", "recompute", 0.9, True)]
    keep = by[("srtf_pred", "keep", 0.9, True)]
    # preempt=False control: the mode knob must be completely inert
    off_a = dict(by[("srtf_pred", "recompute", 0.9, False)])
    off_b = dict(by[("srtf_pred", "keep", 0.9, False)])
    for d in (off_a, off_b):
        for k in ("seconds", "mode"):
            d.pop(k, None)
    return {
        "preemptions_exercised": all(
            by[k]["preemptions"] > 0 for k, _ in pairs),
        "keep_cuts_recompute_ticks": recomp_cut,
        "recompute_ticks_saved": base["recompute_ticks"]
        - keep["recompute_ticks"],
        "keep_p99_reduced_srtf": p99_srtf,
        "keep_p99_srtf_gain_pct": 100 * (base["p99_latency"]
                                         - keep["p99_latency"])
        / max(base["p99_latency"], 1e-9),
        "keep_p99_within_5pct_everywhere": p99_not_worse,
        "keep_mean_latency_gain": base["mean_latency"] - keep["mean_latency"],
        "keep_holds_pages": keep["held_peak"] > 0,
        # conservation, not equality: at 50k a handful of SLO timeouts may
        # land differently per row, but nothing may vanish and the load must
        # stay feasible (≥ 99.5% completion everywhere)
        "all_accounted": len({r["completed"] + r["timed_out"] + r["dropped"]
                              + r["rejected"] for r in rows}) == 1,
        "completion_rate_min": min(
            r["completed"] / (r["completed"] + r["timed_out"] + r["dropped"]
                              + r["rejected"]) for r in rows),
        "load_feasible": all(
            r["completed"] >= 0.995 * (r["completed"] + r["timed_out"]
                                       + r["dropped"] + r["rejected"])
            for r in rows),
        "no_regression_when_preempt_off": off_a == off_b,
        "replay_under_90s": all(r["seconds"] < 90.0 for r in rows),
    }


# ---------------------------------------------------------------------------
# prefix sharing: session traffic x {sharing off/on} x {jsq, prefix_affine}
# ---------------------------------------------------------------------------

PREFIX_MATRIX = (
    # (router, share_prefixes) — the share=False row is the plain paged pool
    # (every request pays for its full context privately); the share=True rows add
    # ref-counted prefix pages, and the router axis isolates what affinity
    # placement buys on top of the pool mechanism itself
    ("jsq", False),
    ("jsq", True),
    ("prefix_affine", True),
)


def run_cluster_prefix(n_requests=50_000, n_replicas=4, max_slots=16,
                       load=0.6, seed=0, verbose=True):
    """Shared-context serving: a single-setting trace where every request
    carries a 512-token system prompt and ~2/3 of traffic arrives as
    multi-turn chat sessions / agentic loops whose later turns extend earlier
    context, replayed with the KV pool's ref-counted prefix sharing off vs on
    × {jsq, prefix_affine} routing. ``n_requests`` is the *base* request
    count — session turns append on top (~2.1x total). Reports the KV
    amplification (logical tokens served per physical token reserved),
    prefill ticks actually paid vs erased by prefix hits, and the usual
    latency columns."""
    base = dict(n_requests=n_requests, model="qwen", scenario="math",
                seed=seed, session_frac=0.30, agentic_frac=0.35,
                system_prompt_len=512, session_gap_mean=60.0,
                agentic_gap_mean=2.0, session_turns_mean=3.0,
                agentic_turns_mean=6.0, prompt_min=16, prompt_max=48,
                max_seq_len=1280)
    if n_requests <= 0:
        print("empty trace (n_requests=0): nothing to replay")
        return []
    probe = make_trace(TraceConfig(rate=1.0, **base))
    specs = tuple(ReplicaSpec(max_slots=max_slots, kv_budget=32_768,
                              page_size=16, prefill_tokens_per_step=64)
                  for _ in range(n_replicas))
    rate = stable_rate_specs(specs, mean_true_length(probe), load)
    cfg = TraceConfig(rate=rate, **base)
    t0 = time.time()
    reqs = make_trace(cfg)
    n_sess = sum(1 for r in reqs if r.prefix_id
                 and not r.prefix_id.startswith("sys/"))
    if verbose:
        print(f"prefix trace: {len(reqs)} requests ({n_requests} base + "
              f"{len(reqs) - n_requests} session turns, {n_sess} carrying "
              f"session context, rate {rate:.3f}/step, 512-token system "
              f"prompt) built in {time.time() - t0:.1f}s")
        print(f"  {'router':14s} {'share':>5s} {'p50':>8s} {'p99':>9s} "
              f"{'amp':>6s} {'prefill':>8s} {'saved':>8s} {'hits':>7s} "
              f"{'cow':>5s} {'secs':>6s}")
    pol = Policy("fcfs", "quantile", quantile=0.9, max_seq_len=1280)
    oracle = make_oracle(cfg)
    rows = []
    for router, share in PREFIX_MATRIX:
        sspecs = tuple(ReplicaSpec(
            max_slots=s.max_slots, kv_budget=s.kv_budget,
            page_size=s.page_size,
            prefill_tokens_per_step=s.prefill_tokens_per_step,
            share_prefixes=share) for s in specs)
        t0 = time.time()
        st = Cluster(sspecs, pol, router=router, predictor=oracle).run(reqs)
        dt = time.time() - t0
        row = st.row()
        row.update(share=share, seconds=dt)
        rows.append(row)
        if verbose:
            print(f"  {st.router:14s} {int(share):5d} {st.p50_latency:8.1f} "
                  f"{st.p99_latency:9.1f} {st.kv_amplification:6.3f} "
                  f"{st.prefill_ticks:8d} {st.prefill_saved_ticks:8d} "
                  f"{st.prefix_hits:7d} {st.cow_copies:5d} {dt:6.1f}")
    return rows


def validate_cluster_prefix(rows) -> dict:
    if not rows:
        return {"empty_trace": True}
    by = {(r["router"], r["share"]): r for r in rows}
    off = by[("jsq", False)]
    jsq = by[("jsq", True)]
    aff = by[("prefix_affine", True)]
    return {
        "all_completed": all(r["completed"] == rows[0]["completed"]
                             for r in rows),
        # sharing off must be inert: the pool reports no amplification
        "off_is_inert": off["kv_amplification"] == 1.0
        and off["prefill_saved_ticks"] == 0,
        # acceptance: >1.2x KV-capacity amplification under session traffic
        "amplification_x": aff["kv_amplification"],
        "amplification_over_1_2": aff["kv_amplification"] > 1.2,
        # ... with a measurable prefill reduction (>=10% of the ticks the
        # sharing-off pool pays)
        "prefill_saved_pct": 100 * aff["prefill_saved_ticks"]
        / max(off["prefill_ticks"], 1),
        "prefill_reduced": aff["prefill_saved_ticks"]
        >= 0.10 * off["prefill_ticks"],
        # ... and affinity placement beats jsq on both axes
        "affine_beats_jsq_amp": aff["kv_amplification"]
        > jsq["kv_amplification"],
        "affine_beats_jsq_saved": aff["prefill_saved_ticks"]
        > jsq["prefill_saved_ticks"],
        "affine_p99_not_worse": aff["p99_latency"]
        <= jsq["p99_latency"] * 1.05,
        "replay_under_90s": all(r["seconds"] < 90.0 for r in rows),
    }


# ---------------------------------------------------------------------------
# chunked prefill: TTFT vs throughput under a per-step token budget
# ---------------------------------------------------------------------------

CHUNKED_MATRIX = (
    # (label, order, chunk_order, prefill_chunk_tokens) — all four rows run
    # the SAME per-step token budget. "atomic" is the non-chunked baseline
    # (a prefilling tick dedicates the whole budget to one prompt; decode
    # pauses); the chunked rows stream prompts in chunks interleaved with
    # decode. The last row is the ProD-aware stack: predicted-short-first
    # admission AND predicted-short-first chunk allocation.
    ("atomic", "fcfs", "fcfs", 0),
    ("chunked", "fcfs", "fcfs", 32),
    ("chunked", "fcfs", "prod", 32),       # chunk_order knob in isolation
    ("chunked", "sjf_pred", "prod", 32),   # full ProD-aware stack
)


def run_cluster_chunked(n_requests=50_000, n_replicas=4, max_slots=16,
                        load=0.9, seed=0, budget=96, chunk=32, verbose=True):
    """Chunked prefill under a shared per-step token budget: TTFT vs
    throughput. One heavy-tailed mixed-scenario trace replayed at the same
    ``step_token_budget`` across :data:`CHUNKED_MATRIX`. Slot decode speed
    is the binding resource at ``load``; the budget binds on ticks where
    prompts stream in, which is exactly where chunking and the
    ``chunk_order`` knob act. Reports the TTFT percentiles the chunked
    engine records per request."""
    base = dict(n_requests=n_requests, model="mix", scenario="mix",
                seed=seed, prompt_min=64, prompt_max=512,
                slo_factor=40.0, slo_floor=8000.0)
    if n_requests <= 0:
        print("empty trace (n_requests=0): nothing to replay")
        return []
    probe = make_trace(TraceConfig(rate=1.0, **dict(base, n_requests=2000)))
    ml = mean_true_length(probe)
    mp = float(np.mean([r.prompt_len for r in probe]))
    speed = 2
    # per-slot service time: chunked prefill ticks + decode ticks; rate puts
    # the slot pool (the binding resource) at `load` utilization
    service = mp / chunk + ml / speed
    rate = load * n_replicas * max_slots / service
    cfg = TraceConfig(rate=rate, **base)
    t0 = time.time()
    reqs = make_trace(cfg)
    if verbose:
        print(f"chunked trace: {len(reqs)} requests (rate {rate:.3f}/step, "
              f"mean len {ml:.0f}, mean prompt {mp:.0f}, budget {budget}, "
              f"chunk {chunk}) built in {time.time() - t0:.1f}s")
        print(f"  {'mode':8s} {'order':9s} {'chunks':6s} {'meanTTFT':>9s} "
              f"{'p50TTFT':>8s} {'p99TTFT':>9s} {'thr':>7s} {'p99lat':>9s} "
              f"{'secs':>6s}")
    oracle = make_oracle(cfg)
    rows = []
    for label, order, corder, ck in CHUNKED_MATRIX:
        pol = Policy(order, "quantile", quantile=0.9, max_seq_len=4096,
                     chunk_order=corder)
        specs = tuple(ReplicaSpec(max_slots=max_slots, kv_budget=65_536,
                                  page_size=16, speed=speed,
                                  step_token_budget=budget,
                                  prefill_chunk_tokens=ck)
                      for _ in range(n_replicas))
        t0 = time.time()
        st = Cluster(specs, pol, router="jsq", predictor=oracle).run(reqs)
        dt = time.time() - t0
        row = st.row()
        row.update(mode=label, chunk_order=corder, chunk=ck, seconds=dt)
        rows.append(row)
        if verbose:
            print(f"  {label:8s} {order:9s} {corder:6s} {st.mean_ttft:9.1f} "
                  f"{st.p50_ttft:8.1f} {st.p99_ttft:9.1f} "
                  f"{st.throughput:7.2f} {st.p99_latency:9.1f} {dt:6.1f}")
    return rows


def validate_cluster_chunked(rows) -> dict:
    if not rows:
        return {"empty_trace": True}
    by = {(r["mode"], r["policy"].split("+")[0], r["chunk_order"]): r
          for r in rows}
    atomic = by[("atomic", "fcfs", "fcfs")]
    cf = by[("chunked", "fcfs", "fcfs")]
    ck = by[("chunked", "fcfs", "prod")]
    cp = by[("chunked", "sjf_pred", "prod")]
    n = rows[0]["completed"] + rows[0]["timed_out"] + rows[0]["dropped"] \
        + rows[0]["rejected"]
    return {
        "all_accounted": all(
            r["completed"] + r["timed_out"] + r["dropped"] + r["rejected"]
            == n for r in rows),
        # acceptance: the ProD-aware chunked stack beats the atomic FCFS
        # baseline on p99 TTFT by >2x at equal-or-better throughput
        "prod_chunked_beats_fcfs_atomic_p99_ttft":
            cp["p99_ttft"] < 0.5 * atomic["p99_ttft"],
        "p99_ttft_gain_x": atomic["p99_ttft"] / max(cp["p99_ttft"], 1e-9),
        # ... and beats FCFS chunk allocation on mean TTFT (SJF-on-chunks
        # pulls short answers' first tokens forward) at equal throughput
        "prod_beats_fcfs_chunked_mean_ttft":
            cp["mean_ttft"] < cf["mean_ttft"],
        "mean_ttft_gain_pct":
            100.0 * (1.0 - cp["mean_ttft"] / max(cf["mean_ttft"], 1e-9)),
        "throughput_equal": cp["throughput"] >= 0.97 * cf["throughput"]
        and cp["throughput"] >= atomic["throughput"],
        # the chunk_order knob alone (fcfs admission) must not cost
        # throughput; its mean-TTFT delta is reported, not gated (at fcfs
        # admission the ordering only reshuffles within-tick budget)
        "chunk_order_only_mean_ttft_delta_pct":
            100.0 * (1.0 - ck["mean_ttft"] / max(cf["mean_ttft"], 1e-9)),
        "chunk_order_only_throughput_ok":
            ck["throughput"] >= 0.97 * cf["throughput"],
        "chunking_throughput_not_worse":
            cf["throughput"] >= atomic["throughput"],
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


# ---------------------------------------------------------------------------
# observability smoke: tracer inertness, path equality, artifact export
# ---------------------------------------------------------------------------


def run_obs(n_requests=8000, n_replicas=4, max_slots=32, pattern="bursty",
            seed=0, out_dir=".", verbose=True):
    """Telemetry smoke table: replay one traced cluster on both decode paths
    plus an untraced control, then export the Perfetto/Prometheus/JSON
    artifacts from the vectorized trace. The three runs pin the telemetry
    contract end to end — tracing must not perturb the simulation
    (control == traced rows), the reference and event-leap paths must emit
    the same canonical event stream, and the event log must conserve
    requests (every arrival reaches exactly one terminal event)."""
    n_requests = min(int(n_requests), 8000)   # the ref path steps every tick
    rate = _rate(n_replicas, max_slots, 0.7, seed)
    cfg = TraceConfig(n_requests=n_requests, rate=rate, pattern=pattern,
                      model="mix", scenario="mix", seed=seed,
                      slo_factor=3.0, slo_floor=80.0)
    reqs = make_trace(cfg)
    if not reqs:
        print("empty trace (n_requests=0): nothing to replay")
        return []
    kv_budget = 8 * (256 + 4096)
    oracle = make_oracle(cfg)
    pol = Policy("srtf_pred", "quantile", quantile=0.9, preempt=True,
                 preempt_factor=1.5, preempt_mode="keep")
    rows, tracers = [], {}
    for label, vec, tracer in (("control", True, None),
                               ("vec", True, Tracer(sample_every=32)),
                               ("ref", False, Tracer(sample_every=32))):
        t0 = time.time()
        cl = Cluster.uniform(n_replicas, max_slots, kv_budget, pol,
                             router="psq", predictor=oracle,
                             rebalance_every=64, steal="quantile",
                             admission=AdmissionController(slack=0.9,
                                                           tracer=tracer),
                             vectorized=vec, tracer=tracer)
        st = cl.run(reqs)
        dt = time.time() - t0
        row = st.row()
        row.update(path=label, seconds=dt,
                   events=tracer.emitted if tracer else 0,
                   samples=len(tracer.series) if tracer else 0)
        rows.append(row)
        if tracer is not None:
            tracers[label] = tracer
        if verbose:
            print(f"  {label:8s} p99 {st.p99_latency:9.1f} "
                  f"goodput {st.goodput:8.2f} events {row['events']:7d} "
                  f"samples {row['samples']:5d} {dt:6.1f}s")
    tr = tracers["vec"]
    # cross-run facts the validator needs but a single row can't see
    rows[1]["_events_equal"] = (tr.canonical()
                                == tracers["ref"].canonical())
    rows[1]["_terminal"] = dict(tr.terminal_counts())
    os.makedirs(out_dir, exist_ok=True)
    tr.write_perfetto(os.path.join(out_dir, "trace.json"))
    with open(os.path.join(out_dir, "metrics.prom"), "w") as f:
        f.write(tr.to_prometheus())
    tr.write_summary(os.path.join(out_dir, "summary.json"))
    if verbose:
        print(f"  artifacts -> {out_dir}/{{trace.json,metrics.prom,"
              f"summary.json}}")
    return rows


def validate_obs(rows, n_requests=8000) -> dict:
    if not rows:
        return {"empty_trace": True}
    n_requests = min(int(n_requests), 8000)
    by = {r["path"]: r for r in rows}

    def core(r):
        return {k: v for k, v in r.items() if not k.startswith("_")
                and k not in ("path", "seconds", "events", "samples")}

    term = by["vec"].get("_terminal", {})
    accounted = (term.get("finish", -1) == by["vec"]["completed"]
                 and term.get("timeout", -1) == by["vec"]["timed_out"]
                 and term.get("rejected", -1) == by["vec"]["rejected"]
                 and sum(term.values()) == n_requests)
    return {
        "tracer_off_inert": core(by["control"]) == core(by["vec"]),
        "paths_bitexact_rows": core(by["vec"]) == core(by["ref"]),
        "paths_bitexact_events": by["vec"].get("_events_equal", False),
        "all_accounted": accounted,
        "events_emitted": by["vec"]["events"] > 0,
        "series_sampled": by["vec"]["samples"] > 0,
        "replay_under_120s": all(r["seconds"] < 120.0 for r in rows),
    }


TABLES = {
    "single": (run, validate),
    "cluster": (run_cluster, validate_cluster),
    "hetero": (run_cluster_hetero, validate_cluster_hetero),
    "predictors": (run_cluster_predictors, validate_cluster_predictors),
    "preemption": (run_cluster_preemption, validate_cluster_preemption),
    "adaptation": (run_cluster_adaptation, validate_cluster_adaptation),
    "prefix": (run_cluster_prefix, validate_cluster_prefix),
    "chunked": (run_cluster_chunked, validate_cluster_chunked),
    "refine": (run_cluster_refine, validate_cluster_refine),
    "obs": (run_obs, validate_obs),
}
DEFAULT_TABLES = tuple(t for t in TABLES if t != "obs")
HEAD_TABLES = ("single", "predictors", "adaptation", "refine")   # train a head on --device

# the acceptance booleans on which the reference's --<table>-only modes exit
# non-zero (benchmarks/bench_serving.py's main)
HARD_CHECKS = {
    "obs": ("tracer_off_inert", "paths_bitexact_rows", "paths_bitexact_events",
            "all_accounted", "events_emitted", "series_sampled", "replay_under_120s"),
    "refine": ("all_accounted", "refine_exercised", "prompt_only_is_inert",
               "mae_posterior_wins_at_some_t", "posterior_srtf_p99_not_worse",
               "posterior_srtf_slo_win", "hazard_laxity_goodput_not_worse",
               "replay_under_120s"),
    "chunked": ("all_accounted", "prod_chunked_beats_fcfs_atomic_p99_ttft",
                "prod_beats_fcfs_chunked_mean_ttft", "throughput_equal",
                "chunk_order_only_throughput_ok", "chunking_throughput_not_worse",
                "replay_under_90s"),
    "prefix": ("all_completed", "off_is_inert", "amplification_over_1_2",
               "prefill_reduced", "affine_beats_jsq_amp", "affine_beats_jsq_saved",
               "affine_p99_not_worse"),
    "preemption": ("preemptions_exercised", "keep_cuts_recompute_ticks",
                   "keep_p99_reduced_srtf", "keep_p99_within_5pct_everywhere",
                   "keep_holds_pages", "no_regression_when_preempt_off",
                   "all_accounted", "load_feasible"),
    "adaptation": ("static_drift_degrades", "adapted_holds_target",
                   "conformal_recovers", "refresh_used", "stationary_p99_ok"),
}


def run_table(name: str, n_requests: int = 50_000, seed: int = 0,
              device: DeviceLike = None, verbose: bool = True,
              out_dir: str = "obs_artifacts"):
    """One table at its reference defaults, as the reference's ``main``
    calls it: (rows, checks). The single-replica track keeps its own 250
    requests; ``obs`` writes its artifacts to ``out_dir``."""
    run_fn, validate_fn = TABLES[name]
    kw = dict(seed=seed, verbose=verbose)
    if name != "single":
        kw["n_requests"] = n_requests
    if name in HEAD_TABLES:
        kw["device"] = device
    if name == "obs":
        kw["out_dir"] = out_dir
    rows = run_fn(**kw)
    if name == "obs":
        return rows, validate_fn(rows, n_requests=n_requests)
    return rows, validate_fn(rows)


# the reference's stamp keys (benchmarks/bench_serving.py's ``finish`` calls)
STAMP_KEYS = {"single": "single_replica", "cluster": "cluster", "hetero": "cluster_hetero",
              "predictors": "cluster_predictors", "preemption": "cluster_preemption",
              "adaptation": "cluster_adaptation", "prefix": "cluster_prefix",
              "chunked": "cluster_chunked", "refine": "cluster_refine", "obs": "obs"}
# the experiment knobs the reference's ``main`` records in a stamp's meta,
# at its defaults, which are the port's tables'
STAMP_META = dict(n_replicas=4, max_slots=32, pattern="bursty")


def _git_sha():
    """Best-effort current commit SHA for stamp provenance ("unknown" when
    git is unavailable — e.g. a source tarball)."""
    import subprocess
    try:
        out = subprocess.run(
            ["git", "rev-parse", "HEAD"], capture_output=True, text=True,
            timeout=10, cwd=os.path.dirname(os.path.abspath(__file__)))
        sha = out.stdout.strip()
        return sha if out.returncode == 0 and sha else "unknown"
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def _write_stamp(path, tables, timestamp=None, **meta):
    """Stamp bench rows + validation checks to ``path`` (JSON), as the
    reference's ``_write_stamp``: each entry is one table's raw rows and its
    ``validate_*`` booleans/metrics, keyed by table name, plus a ``meta``
    block (config knobs, git SHA, caller-supplied timestamp) that
    ``launch/check_regression.py`` keys its diff on. Tables already stamped
    in an existing file are kept, and meta is merged non-destructively
    (existing keys survive unless this run supplies a new value), so a
    partial run refreshes one table without dropping the rest. NumPy scalars
    are written as JSON natives; no wall clock is read here."""
    import json

    def scrub(x):
        if isinstance(x, dict):
            return {k: scrub(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return [scrub(v) for v in x]
        if isinstance(x, (np.integer,)):
            return int(x)
        if isinstance(x, (np.floating,)):
            return float(x)
        if isinstance(x, (np.bool_,)):
            return bool(x)
        return x

    merged, old_meta = {}, {}
    if os.path.exists(path):
        try:
            with open(path) as f:
                prior = json.load(f)
            merged = prior.get("tables", {})
            old_meta = prior.get("meta", {})
        except (ValueError, OSError):
            merged, old_meta = {}, {}
    merged.update(scrub(tables))
    new_meta = dict(old_meta)
    new_meta.update(scrub(meta))
    new_meta["git_sha"] = _git_sha()
    if timestamp is not None:
        # caller-supplied, so runs stay replayable; an unstamped refresh
        # keeps the previous one
        new_meta["timestamp"] = str(timestamp)
    with open(path, "w") as f:
        json.dump({"meta": new_meta, "tables": merged}, f, indent=1,
                  sort_keys=True)
    print(f"stamped {len(tables)} table(s) ({len(merged)} total) -> {path}")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--n-requests", type=int, default=50_000)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--tables", default=",".join(DEFAULT_TABLES),
                    help="comma-separated subset of " + ", ".join(TABLES))
    ap.add_argument("--obs-dir", metavar="DIR", default="obs_artifacts",
                    help="directory for the obs table's artifacts "
                         "(trace.json, metrics.prom, summary.json)")
    ap.add_argument("--stamp", metavar="PATH", default=None,
                    help="write rows + validation checks of every table run "
                         "to PATH as JSON, under the reference's keys")
    ap.add_argument("--timestamp", default=None,
                    help="provenance timestamp recorded in the stamp's meta "
                         "block (caller-supplied, e.g. $(date -uIs))")
    args = ap.parse_args(argv)
    names = [t for t in args.tables.split(",") if t]
    bad = [t for t in names if t not in TABLES]
    if bad:
        ap.error(f"unknown tables {bad}; choose from {list(TABLES)}")
    dev = resolve_device(args.device) if any(t in HEAD_TABLES for t in names) else None
    out, stamped = {}, {}
    for name in names:
        t0 = time.time()
        rows, checks = run_table(name, args.n_requests, args.seed, dev,
                                 out_dir=args.obs_dir)
        print(f"{name} checks:", checks)
        print(f"{name}: {time.time() - t0:.1f} s wall")
        out[name] = (rows, checks)
        if args.stamp:
            stamped[STAMP_KEYS[name]] = {"rows": rows, "checks": checks}
            _write_stamp(args.stamp, stamped, timestamp=args.timestamp,
                         n_requests=args.n_requests, seed=args.seed, **STAMP_META)
    if len(names) == 1 and names[0] in HARD_CHECKS:
        failed = [k for k in HARD_CHECKS[names[0]] if not out[names[0]][1].get(k, False)]
        if failed:
            raise SystemExit(f"{names[0]} acceptance failed: {failed}")
    return out


if __name__ == "__main__":
    main()
