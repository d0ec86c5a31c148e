"""Perf-trajectory regression gate over bench stamps, on the port: its own
copy of the reference's ``benchmarks/check_regression.py``, with the same
flags, messages and exit codes.

``launch/bench_serving.py --stamp`` records each table's raw rows, validation
checks, and a provenance ``meta`` block (config knobs, git SHA, timestamp).
This script diffs a freshly produced candidate stamp against a baseline and
fails (exit 1) when any row regresses beyond the configured tolerances:

* tail latency — ``p99_latency`` / ``p99_ttft`` may grow at most
  ``--max-p99-regress`` (fractional, default 10%);
* ``goodput`` may shrink to no less than ``--min-goodput-ratio`` of the
  baseline (default 95%).

Comparison rules keep the diff honest rather than exhaustive:

* only tables present in BOTH stamps are compared — the trajectory grows a
  table at a time, and a new table has no baseline yet;
* rows are matched positionally within a table and must agree on their
  identity fields (router/policy/mode/...): an identity mismatch means the
  bench matrix itself changed, so the row pair is reported as *skipped*,
  not scored — a matrix change needs a baseline refresh, not a red gate;
* the meta config knobs (n_requests, replicas, slots, pattern, seed) must
  match, else the candidate measured a different experiment and every
  per-row delta is noise (``--ignore-meta`` overrides, for local spelunking).

It reads JSON files only: no tensor and no device, so it is the one entry
point of the port that the device rule (``common/device.py``) does not
apply to. Typical usage::

    PYTHONPATH=src python -m repro_torch.launch.bench_serving --n-requests 8000 \
        --tables predictors --stamp /tmp/candidate.json
    PYTHONPATH=src python -m repro_torch.launch.check_regression \
        --baseline /tmp/baseline.json --candidate /tmp/candidate.json
"""

from __future__ import annotations

import argparse
import json
import sys

# meta knobs that define "same experiment"; git_sha/timestamp are provenance,
# not identity
META_KNOBS = ("n_requests", "n_replicas", "max_slots", "pattern", "seed")

# row fields that identify which configuration a row measured (present
# subsets vary by table)
ID_FIELDS = ("router", "policy", "mode", "trace", "chunk", "chunk_order",
             "balance_mode", "path", "predictor", "label", "order", "steal")

# (metric, direction): +1 means larger-is-worse (latency), -1 smaller-is-worse
P99_METRICS = ("p99_latency", "p99_ttft")
GOODPUT_METRIC = "goodput"


def load_stamp(path):
    with open(path) as f:
        doc = json.load(f)
    if "tables" not in doc:
        raise SystemExit(f"{path}: not a bench stamp (no 'tables' key)")
    return doc


def row_identity(row):
    return {k: row[k] for k in ID_FIELDS if k in row}


def compare(baseline, candidate, max_p99_regress, min_goodput_ratio,
            ignore_meta=False):
    """Return (violations, skipped, compared) lists of human-readable
    strings; the gate is red iff ``violations`` is non-empty."""
    violations, skipped, compared = [], [], []
    if not ignore_meta:
        bm, cm = baseline.get("meta", {}), candidate.get("meta", {})
        for k in META_KNOBS:
            if k in bm and k in cm and bm[k] != cm[k]:
                violations.append(
                    f"meta mismatch: {k} baseline={bm[k]!r} "
                    f"candidate={cm[k]!r} (different experiment; rerun with "
                    f"matching knobs or pass --ignore-meta)")
        if violations:
            return violations, skipped, compared
    bt, ct = baseline["tables"], candidate["tables"]
    for name in sorted(set(bt) & set(ct)):
        brows = bt[name].get("rows", [])
        crows = ct[name].get("rows", [])
        if len(brows) != len(crows):
            skipped.append(f"{name}: row count {len(brows)} -> {len(crows)} "
                           f"(matrix changed; refresh the baseline)")
            continue
        for i, (b, c) in enumerate(zip(brows, crows)):
            bid, cid = row_identity(b), row_identity(c)
            tag = f"{name}[{i}]" + (f" {bid}" if bid else "")
            if bid != cid:
                skipped.append(f"{tag}: identity changed to {cid} "
                               f"(matrix changed; refresh the baseline)")
                continue
            for m in P99_METRICS:
                if m not in b or m not in c:
                    continue
                base, cand = float(b[m]), float(c[m])
                limit = base * (1.0 + max_p99_regress)
                compared.append(f"{tag}.{m}: {base:.2f} -> {cand:.2f}")
                if cand > limit:
                    violations.append(
                        f"{tag}.{m}: {base:.2f} -> {cand:.2f} "
                        f"(+{(cand / max(base, 1e-12) - 1) * 100:.1f}%, "
                        f"limit +{max_p99_regress * 100:.0f}%)")
            if GOODPUT_METRIC in b and GOODPUT_METRIC in c:
                base = float(b[GOODPUT_METRIC])
                cand = float(c[GOODPUT_METRIC])
                compared.append(
                    f"{tag}.{GOODPUT_METRIC}: {base:.2f} -> {cand:.2f}")
                if cand < base * min_goodput_ratio:
                    violations.append(
                        f"{tag}.{GOODPUT_METRIC}: {base:.2f} -> {cand:.2f} "
                        f"({cand / max(base, 1e-12) * 100:.1f}% of baseline, "
                        f"floor {min_goodput_ratio * 100:.0f}%)")
    if not compared and not skipped:
        violations.append("no comparable tables between baseline and "
                          "candidate (nothing was gated)")
    return violations, skipped, compared


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="fail when a fresh bench stamp regresses vs the "
                    "committed one")
    ap.add_argument("--baseline", required=True,
                    help="committed stamp (e.g. BENCH_serving.json)")
    ap.add_argument("--candidate", required=True,
                    help="freshly produced stamp to gate")
    ap.add_argument("--max-p99-regress", type=float, default=0.10,
                    help="max fractional p99 latency/TTFT growth "
                         "(default 0.10 = +10%%)")
    ap.add_argument("--min-goodput-ratio", type=float, default=0.95,
                    help="min candidate/baseline goodput ratio "
                         "(default 0.95)")
    ap.add_argument("--ignore-meta", action="store_true",
                    help="compare rows even when the meta config knobs "
                         "differ")
    ap.add_argument("--verbose", action="store_true",
                    help="print every compared metric, not just violations")
    args = ap.parse_args(argv)
    baseline = load_stamp(args.baseline)
    candidate = load_stamp(args.candidate)
    violations, skipped, compared = compare(
        baseline, candidate, args.max_p99_regress, args.min_goodput_ratio,
        ignore_meta=args.ignore_meta)
    if args.verbose:
        for line in compared:
            print("  ok  " + line)
    for line in skipped:
        print("skip  " + line)
    print(f"{len(compared)} metric(s) compared, {len(skipped)} skipped, "
          f"{len(violations)} violation(s)")
    if violations:
        for line in violations:
            print("FAIL  " + line, file=sys.stderr)
        return 1
    print("no perf regression vs baseline")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
