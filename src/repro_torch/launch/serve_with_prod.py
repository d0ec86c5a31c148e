"""End-to-end serving pipeline, the port's twin of ``examples/serve_with_prod.py``
(same 9 stages, arguments and defaults, plus ``--device``, default ``cuda``):
serve a small model with batched requests, with the ProD predictor driving
scheduling and KV reservation.

  1. train tiny-lm on the heavy-tailed toy corpus (``train_loop``);
  2. collect r repeated generations per prompt at temperature 0.8 through
     ``RealEngine`` (flash prefill and decode kernels on the card) and
     harvest the last-layer hidden states φ of the prefill;
  3. build ProD-D targets and train the head on φ;
  4. serve a fresh workload through ``SimEngine``: FCFS/max-reserve against
     ProD-driven SJF + quantile reservation;
  5. replay it across a heterogeneous 2-replica ``Cluster`` with SLOs and
     work stealing: round-robin/max against the ProD-aware psq router;
  6. the trained head in the dispatch loop: a ``PredictorService`` scores
     each arrival window in one ``prod_head`` call, under FCFS, EDF and
     least-laxity queue orders;
  7. online adaptation under a 1.5x mid-stream output drift: the static head
     against an ``OnlineAdapter`` (adaptive conformal calibration, warm-start
     refresh, SLO-aware admission);
  8. paged KV: an SRTF-preemptive replica under ``preempt_mode="recompute"``
     against ``"keep"``;
  9. a shared 24-token system prompt: private copies against ref-counted
     shared prefix pages.

Each stage is a function of what the earlier ones made, prints the
reference's rows and returns them; :func:`main` runs all nine in order.
The head trains with integer seeds (the reference's ``PRNGKey(seed + 1)``
is ``seed + 1`` here), so the rows follow the reference's in kind, not
digit for digit.

    PYTHONPATH=src python -m repro_torch.launch.serve_with_prod [--train-steps 300]
    PYTHONPATH=src python -m repro_torch.launch.serve_with_prod --device cpu \\
        --train-steps 25 --n-prompts 12 --r 3 --max-new 40 --n-serve 24
"""

from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Any, Dict, List, Tuple

import numpy as np
import torch

from repro_torch.common.config import PredictorConfig, TrainConfig
from repro_torch.common.device import resolve_device
from repro_torch.configs import get_config
from repro_torch.core import bins as B
from repro_torch.core import targets as T
from repro_torch.core.metrics import mae, noise_radius
from repro_torch.core.predictor import LengthPredictor, train_predictor
from repro_torch.data.pipeline import batch_iterator, make_lm_dataset
from repro_torch.data.tokenizer import N_TOPICS, ToyTokenizer
from repro_torch.models.model_zoo import Model, build_model
from repro_torch.serving.adaptation import (AdaptationConfig, AdmissionController,
                                            OnlineAdapter, coverage_of)
from repro_torch.serving.cluster import Cluster
from repro_torch.serving.engine import RealEngine, ReplicaSpec, SimEngine
from repro_torch.serving.predictor import PredictorService
from repro_torch.serving.request import Request
from repro_torch.serving.scheduler import Policy
from repro_torch.training.trainer import train_loop

Row = Dict[str, Any]


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--train-steps", type=int, default=300)
    ap.add_argument("--n-prompts", type=int, default=64)
    ap.add_argument("--r", type=int, default=8)
    ap.add_argument("--max-new", type=int, default=96)
    ap.add_argument("--n-serve", type=int, default=96)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


def train_lm(args, dev: torch.device) -> Tuple[Model, Dict[str, Any]]:
    """Stage 1: the served LM, tiny-lm in fp32. Returns (model, params)."""
    cfg = get_config("tiny-lm").with_overrides(dtype="float32")
    model = build_model(cfg)
    tcfg = TrainConfig(lr=3e-3, warmup_steps=10, decay_steps=args.train_steps,
                       seed=args.seed)
    ds = make_lm_dataset(2048, 96, seed=args.seed)
    print(f"[1/9] training tiny-lm for {args.train_steps} steps ...")
    state = train_loop(model, tcfg, batch_iterator(ds, 16, seed=args.seed, device=dev),
                       args.train_steps, log_every=100, device=dev)
    return model, state.params


def collect(args, model: Model, params, rng: np.random.Generator
            ) -> Tuple[np.ndarray, np.ndarray, float]:
    """Stage 2: r generations per prompt at temperature 0.8. Returns the
    lengths (N, r), φ (N, d) and the noise radius."""
    print(f"[2/9] collecting {args.r} generations x {args.n_prompts} prompts ...")
    eng = RealEngine(model, params, max_new=args.max_new, temperature=0.8)
    tok = ToyTokenizer()
    prompts = np.zeros((args.n_prompts, 6), np.int32)
    for i in range(args.n_prompts):
        prompts[i] = tok.prompt(rng, int(rng.integers(0, N_TOPICS)), n_style=4)
    plens = np.full(args.n_prompts, 6)
    t0 = time.perf_counter()
    lens, phi = eng.repeated_sampling(prompts, plens, r=args.r, seed=args.seed)
    nr = noise_radius(torch.as_tensor(lens))
    print(f"      lengths: median={np.median(lens):.0f} "
          f"max/med={np.max(lens) / max(np.median(lens), 1):.2f} "
          f"noise radius={nr:.2f}  ({time.perf_counter() - t0:.0f}s)")
    return lens, phi, nr


def fit_head(args, lens: np.ndarray, phi: np.ndarray, nr: float,
             dev: torch.device) -> Tuple[LengthPredictor, float]:
    """Stage 3: ProD-D targets from the lengths and the head trained on φ.
    Returns the predictor and its in-sample MAE against the prompt medians."""
    print("[3/9] training ProD-D head on the served model's hidden states ...")
    pcfg = PredictorConfig(n_bins=24, bin_max=float(lens.max() + 8), epochs=40,
                           batch_size=32)
    edges = B.make_edges(pcfg.n_bins, pcfg.bin_max, device=dev)
    tgt = T.dist_target(torch.as_tensor(lens, dtype=torch.float32, device=dev), edges)
    pred = train_predictor(args.seed + 1, phi, tgt, pcfg, edges, device=dev)
    est = pred.predict(phi)
    err = mae(est, torch.as_tensor(np.median(lens, axis=1), dtype=torch.float32,
                                   device=dev))
    print(f"      in-sample MAE vs prompt medians: {err:.2f} (noise radius {nr:.2f})")
    return pred, err


def serve_sim(args, pred, lens: np.ndarray, phi: np.ndarray,
              rng: np.random.Generator) -> Tuple[List[Request], List[Row]]:
    """Stage 4: a fresh workload through ``SimEngine``, FCFS/max against
    ProD SJF + quantile. Returns the requests and the two rows."""
    print(f"[4/9] serving {args.n_serve} batched requests ...")
    arrivals = np.cumsum(rng.exponential(1.5, args.n_serve))
    fresh = rng.integers(0, args.n_prompts, args.n_serve)
    reqs = []
    for i, (j, t) in enumerate(zip(fresh, arrivals)):
        draw = int(lens[j, rng.integers(0, args.r)])  # a fresh-ish realization
        reqs.append(Request(rid=i, arrival=float(t), prompt_len=6,
                            true_len=draw, phi=phi[j]))
    rows = []
    for pol in (Policy("fcfs", "max", max_seq_len=args.max_new),
                Policy("sjf_pred", "quantile", quantile=0.9,
                       max_seq_len=args.max_new)):
        st = SimEngine(max_slots=8, kv_budget=4 * (6 + args.max_new),
                       policy=pol, predictor=pred).run(reqs)
        print(f"      {st.policy:20s} mean_lat={st.mean_latency:7.1f} "
              f"p90={st.p90_latency:7.1f} waste={st.kv_waste_ratio:.3f} "
              f"thr={st.throughput:.2f}")
        rows.append(st.row())
    return reqs, rows


def replica_specs(args) -> Tuple[ReplicaSpec, ReplicaSpec]:
    """A fast large replica next to a slow small one."""
    return (ReplicaSpec(4, 2 * (6 + args.max_new), speed=2, prefill_tokens_per_step=8),
            ReplicaSpec(2, 6 + args.max_new, speed=1, prefill_tokens_per_step=4))


def cluster_replay(args, pred, reqs: List[Request]) -> List[Row]:
    """Stage 5: the heterogeneous 2-replica cluster with tiered SLOs (sets
    each request's deadline) and ProD-aware work stealing."""
    print("[5/9] replaying across a heterogeneous 2-replica cluster "
          "(speed 2x+1x, SLOs, work stealing) ...")
    specs = replica_specs(args)
    for i, r in enumerate(reqs):
        r.deadline = r.arrival + (2.0 + 2.0 * (i % 3)) * args.max_new
    rows = []
    for router, pol, reb in (
            ("round_robin", Policy("fcfs", "max", max_seq_len=args.max_new), 0),
            ("psq", Policy("fcfs", "quantile", quantile=0.9,
                           max_seq_len=args.max_new), 25)):
        st = Cluster(specs, pol, router=router, predictor=pred,
                     rebalance_every=reb, steal="quantile").run(reqs)
        label = f"steal@{reb}" if reb else "no-steal"
        print(f"      {st.router:12s}+{st.policy:14s} {label:9s} "
              f"p50={st.p50_latency:7.1f} p99={st.p99_latency:7.1f} "
              f"viol={st.slo_violations} t/o={st.timed_out} "
              f"goodput={st.goodput:.2f} stolen={st.stolen} "
              f"balance={st.balance:.2f}")
        rows.append(st.row())
    return rows


def service_in_the_loop(args, pred, reqs: List[Request]) -> List[Row]:
    """Stage 6: the trained head served through ``PredictorService`` at
    dispatch time under FCFS, EDF and least-laxity orders."""
    print("[6/9] predictor-in-the-loop: batched dispatch-time inference + "
          "deadline-aware ordering ...")
    rows = []
    for order in ("fcfs", "edf", "laxity"):
        svc = PredictorService(pred, window=8.0)
        pol = Policy(order, "quantile", quantile=0.9, max_seq_len=args.max_new)
        st = Cluster(replica_specs(args), pol, router="psq", predictor=svc,
                     rebalance_every=25, steal="quantile").run(reqs)
        srow = svc.stats.row()
        print(f"      order={order:7s} p50={st.p50_latency:7.1f} "
              f"p99={st.p99_latency:7.1f} viol={st.slo_violations} "
              f"t/o={st.timed_out} goodput={st.goodput:.2f} "
              f"[{srow['batches']} fused batches, mean "
              f"{srow['mean_batch']:.1f} reqs, hit rate {srow['hit_rate']:.2f}]")
        rows.append({**st.row(), "order": order, "service": srow})
    return rows


def online_adaptation(args, pred, lens: np.ndarray, phi: np.ndarray,
                      rng: np.random.Generator) -> List[Row]:
    """Stage 7: outputs grow 1.5x after the first third of a 3x longer
    workload; the frozen head against an ``OnlineAdapter``. Coverage is
    scored on the settled last third."""
    print("[7/9] online adaptation: mid-stream 1.5x output drift, static vs "
          "adaptive-conformal + refresh ...")
    n_ad = 3 * args.n_serve
    arr2 = np.cumsum(rng.exponential(1.5, n_ad))
    picks = rng.integers(0, args.n_prompts, n_ad)
    t_switch = float(arr2[n_ad // 3])
    t_tail = float(arr2[2 * n_ad // 3])
    drift_reqs = []
    for i, (j, t) in enumerate(zip(picks, arr2)):
        draw = int(lens[j, rng.integers(0, args.r)])
        if t >= t_switch:
            draw = int(min(args.max_new, round(1.5 * draw)))
        drift_reqs.append(Request(
            rid=i, arrival=float(t), prompt_len=6, true_len=draw, phi=phi[j],
            deadline=float(t) + (2.0 + 2.0 * (i % 3)) * args.max_new))
    rows = []
    for label, gamma, refresh in (("static", 0.0, False),
                                  ("conformal+refresh", 0.05, True)):
        acfg = AdaptationConfig(
            target_coverage=0.9, gamma=gamma, window=64, every=8,
            refresh_every=0.25 * t_switch if refresh else 0.0,
            refresh_min_samples=24, refresh_epochs=30, buffer_size=128)
        adapter = OnlineAdapter(PredictorService(pred, window=8.0), acfg)
        pol = Policy("fcfs", "quantile", quantile=0.9, max_seq_len=args.max_new)
        cl = Cluster(replica_specs(args), pol, router="psq", predictor=adapter,
                     admission=AdmissionController())
        st = cl.run(drift_reqs)
        cov = coverage_of([r for e in cl.engines for r in e.done], since=t_tail)
        print(f"      {label:18s} settled post-drift coverage={cov:.2f} "
              f"(target 0.90) p99={st.p99_latency:7.1f} "
              f"viol={st.slo_violations} t/o={st.timed_out} "
              f"rejected={st.rejected} refits={st.refreshes} "
              f"q_eff={adapter.q_eff:.3f}")
        rows.append({**st.row(), "label": label, "coverage": cov, "q_eff": adapter.q_eff})
    return rows


def paged_preemption(args, pred, reqs: List[Request]) -> List[Row]:
    """Stage 8: SRTF preemption on paged KV, recompute against keep-pages."""
    print("[8/9] paged KV: recompute vs keep-pages preemption "
          "(page_size=4, prefill 4 tok/tick) ...")
    rows = []
    for mode in ("recompute", "keep"):
        pol = Policy("srtf_pred", "quantile", quantile=0.9,
                     max_seq_len=args.max_new, preempt=True,
                     preempt_factor=1.2, preempt_mode=mode)
        spec = ReplicaSpec(2, 4 * (6 + args.max_new) // 4 * 4, speed=2,
                           prefill_tokens_per_step=4, page_size=4)
        st = SimEngine(policy=pol, predictor=pred, spec=spec).run(reqs)
        print(f"      {mode:10s} p50={st.p50_latency:7.1f} "
              f"p99={st.p99_latency:7.1f} preempt={st.preemptions} "
              f"recompute_ticks={st.recompute_ticks} "
              f"held_peak={st.held_peak} occ={st.occupancy:.3f} "
              f"frag={st.frag_ratio:.4f}")
        rows.append({**st.row(), "mode": mode})
    return rows


def shared_prefix(args, pred, reqs: List[Request]) -> List[Row]:
    """Stage 9: every request carries the same 24-token system prompt;
    private copies against ref-counted shared prefix pages."""
    print("[9/9] shared system prompt: private copies vs ref-counted "
          "prefix pages ...")
    sys_len = 24
    shared_reqs = [dataclasses.replace(r, prompt_len=r.prompt_len + sys_len,
                                       prefix_id="sys/toy", prefix_len=sys_len)
                   for r in reqs]
    pol = Policy("fcfs", "quantile", quantile=0.9, max_seq_len=args.max_new)
    rows = []
    for share in (False, True):
        spec = ReplicaSpec(4, 4 * (32 + args.max_new), speed=2,
                           prefill_tokens_per_step=4, page_size=4,
                           share_prefixes=share)
        st = SimEngine(policy=pol, predictor=pred, spec=spec).run(shared_reqs)
        print(f"      share_prefixes={str(share):5s} "
              f"p50={st.p50_latency:7.1f} p99={st.p99_latency:7.1f} "
              f"amp={st.kv_amplification:.3f} prefill={st.prefill_ticks} "
              f"saved={st.prefill_saved_ticks} hits={st.prefix_hits}")
        rows.append({**st.row(), "share_prefixes": share})
    return rows


def main(argv=None) -> Dict[str, Any]:
    """All nine stages in order. Returns each stage's rows by name."""
    args = parse_args(argv)
    dev = resolve_device(args.device)
    model, params = train_lm(args, dev)
    rng = np.random.default_rng(args.seed)
    lens, phi, nr = collect(args, model, params, rng)
    pred, err = fit_head(args, lens, phi, nr, dev)
    reqs, sim_rows = serve_sim(args, pred, lens, phi, rng)
    out = {"lengths": lens, "phi": phi, "noise_radius": nr, "predictor": pred,
           "head_mae": err, "requests": reqs, "serve": sim_rows,
           "cluster": cluster_replay(args, pred, reqs),
           "service": service_in_the_loop(args, pred, reqs),
           "adaptation": online_adaptation(args, pred, lens, phi, rng),
           "paged": paged_preemption(args, pred, reqs),
           "prefix": shared_prefix(args, pred, reqs)}
    print("done — ProD scheduling/routing/stealing vs prediction-blind "
          "baselines shown above; stage 6 serves the trained head itself "
          "at dispatch time, stage 7 keeps it calibrated while the workload "
          "drifts, stage 8 keeps preempted requests' KV pages so resume "
          "skips the prefill recompute, stage 9 shares one physical copy "
          "of the system prompt across every concurrent request.")
    return out


if __name__ == "__main__":
    main()
