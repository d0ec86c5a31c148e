"""The output check: what the timed path produced, against the plain
reference (``harness/reference.py``) worked out again from the same inputs.

``admit``: of the first cycle's batches that completed, the heaviest (the
widest, then the most real tokens) and one drawn from the seed. Per row:

* ``logit_err``: the largest |logit - reference logit| of the last prompt
  token's unembedding (the distribution the first token is drawn from);
* ``phi_err``: |φ - φ_ref| / |φ_ref| of the last prompt token's hidden state;
* ``probs_err``, ``quant_err``: the head's histogram and its quantiles (in
  tokens) against the reference head on the port's own φ, so that the head
  is judged apart from the model before it.

A per-row number is given as its widest reading over the rows (its plain
name) and as the mean of its lowest three quarters (``_low75``): a fault in
more than a quarter of the rows (half of a batch) reaches the latter, while
one row's routing near a tie moves only the widest.

``collect``: the first call of the window. Its greedy rows' served tokens
are judged: ``token_gap`` is the widest gap by which a served token's
reference logit lies below the reference's best at that position, over a
sample of greedy rows drawn from the seed with the longest prompt's among
them, up to each row's EOS, and ``token_gap_mean`` their mean; ``phi_err``
as above, on those rows of a dense model and on every row of a MoE model's
call. A dense model's rows are replayed alone; a MoE model's call is
replayed whole, since one row's routing takes capacity from the others'.

``control=True`` also puts the reference in float8 (the head in TF32) in the
port's place and returns its readings of the same numbers.
"""

from __future__ import annotations

from typing import Any, Dict, List, Tuple

import numpy as np
import torch

from harness import reference, traffic
from harness.model import seed_of


def _rel_rows(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    a, b = a.to(torch.float32), b.to(torch.float32)
    return (a - b).norm(dim=-1) / b.norm(dim=-1).clamp(min=1e-30)


def _row_stats(name: str, rows: torch.Tensor) -> Dict[str, float]:
    """A per-row error's widest reading (``name``) and ``<name>_low75``, the
    mean of the lowest three quarters of the rows (rounded up): a fault in
    more than a quarter of the rows reaches it, while one row's routing near
    a tie moves only the widest."""
    r = rows.to(torch.float32)
    low = r.sort().values[:-(-3 * r.numel() // 4)]
    return {name: float(r.max()), f"{name}_low75": float(low.mean())}


def admit_sample(units: List[Dict[str, Any]], seed: int) -> List[Dict[str, Any]]:
    kept = [u for u in units if "out" in u]
    heavy = max(range(len(kept)), key=lambda i: (kept[i]["width"], sum(kept[i]["lens"])))
    rest = [i for i in range(len(kept)) if i != heavy]
    picks = [heavy]
    if rest:
        picks.append(rest[int(np.random.default_rng(seed_of(seed, 7)).integers(len(rest)))])
    return [kept[i] for i in picks]


def _admit_segments(md, units, dev) -> Tuple[list, list]:
    """Segments to replay and, per unit, where each row's last token is:
    (segment index, row in it, position)."""
    segs, where = [], []
    for u in units:
        toks = torch.as_tensor(u["toks"], device=dev)
        lens = torch.as_tensor(u["lens"], device=dev)
        if md["family"] == "moe":
            segs.append(reference.Segment(toks, lens))
            where.append([(len(segs) - 1, b, int(n) - 1) for b, n in enumerate(u["lens"])])
        else:            # a dense row's pads reach no real token: replay it alone
            w = []
            for b, n in enumerate(u["lens"]):
                segs.append(reference.Segment(toks[b:b + 1, :n], lens[b:b + 1]))
                w.append((len(segs) - 1, 0, int(n) - 1))
            where.append(w)
    return segs, where


def check_admit(cell, units, control: bool = False) -> Dict[str, Dict[str, float]]:
    md, params, dev = cell.md, cell.params, cell.dev
    picked = admit_sample(units, cell.seed)
    segs, where = _admit_segments(md, picked, dev)
    qs = tuple(cell.mix["quantiles"])
    out = {}
    precisions = ("fp32",)
    if control:
        precisions += ("fp8", "fp32r") if md["family"] == "moe" else ("fp8",)
    refs = {}
    for prec in precisions:
        ref = reference.Reference(md, params, prec, cell.serving.get("capacity_factor", 1.25))
        hid = ref.hidden(segs)
        phi = torch.stack([hid[s][b, p] for w in where for (s, b, p) in w])
        refs[prec] = (phi, ref.logits(phi))
        del hid
    phi_r, log_r = refs["fp32"]
    phi_p = torch.cat([u["out"]["phi"] for u in picked]).to(torch.float32)
    log_p = torch.cat([u["out"]["logits"] for u in picked])
    probs_p = torch.cat([u["out"]["probs"] for u in picked])
    quants_p = torch.cat([u["out"]["quants"] for u in picked])
    probs_r, quants_r = reference.head(phi_p, cell.head, cell.edges, qs)

    def model_numbers(phi, log):
        return {**_row_stats("logit_err", (log - log_r).abs().amax(dim=-1)),
                **_row_stats("phi_err", _rel_rows(phi, phi_r))}

    out["program"] = {**model_numbers(phi_p, log_p),
                      "probs_err": float((probs_p - probs_r).abs().max()),
                      "quant_err": float((quants_p - quants_r).abs().max())}
    if control:
        probs_c, quants_c = reference.head(phi_p, cell.head, cell.edges, qs, tf32=True)
        out["control"] = {**model_numbers(*refs["fp8"]),
                          "probs_err": float((probs_c - probs_r).abs().max()),
                          "quant_err": float((quants_c - quants_r).abs().max())}
    if "fp32r" in refs:
        out["witness"] = model_numbers(*refs["fp32r"])
    return out


def collect_rows(cell, unit) -> np.ndarray:
    """The greedy rows judged: ``check.rows`` of them drawn from the seed,
    the one with the longest prompt among them."""
    greedy = traffic.greedy_rows(cell.mix)
    lens = np.asarray(unit["lens"])
    longest = greedy[np.argmax(lens[greedy])]
    rest = np.setdiff1d(greedy, [longest])
    n = min(cell.mix["check"]["rows"], len(greedy)) - 1
    rng = np.random.default_rng(seed_of(cell.seed, 8))
    return np.sort(np.concatenate([[longest], rng.choice(rest, size=n, replace=False)]))


def check_collect(cell, units, control: bool = False) -> Dict[str, Dict[str, float]]:
    md, params, dev = cell.md, cell.params, cell.dev
    unit = units[0]
    res = unit["out"]
    rows = collect_rows(cell, unit)
    max_new = unit["max_new"]
    steps = max_new - 1                       # decode items whose logits pick a token
    served = torch.as_tensor(res["tokens"], device=dev).to(torch.long)
    prompts = torch.as_tensor(unit["prompts"], device=dev)
    lens = torch.as_tensor(unit["lens"], device=dev)
    tok, pos, last = reference.decode_plan(served, lens, cell.eos, steps)
    finished = (tok == cell.eos).any(dim=1)
    if md["family"] == "moe":
        segs = [reference.Segment(prompts, lens, tok, pos, last)]
        loc = {int(b): (0, int(b)) for b in rows}
    else:
        segs = [reference.Segment(prompts[b:b + 1, :int(lens[b])], lens[b:b + 1],
                                  tok[b:b + 1], pos[b:b + 1], last[b:b + 1]) for b in rows]
        loc = {int(b): (i, 0) for i, b in enumerate(rows)}
    Sp = {i: s.tokens.shape[1] for i, s in enumerate(segs)}
    # φ of every replayed row: the whole call of a MoE model, the judged rows else
    phi_rows = np.arange(len(unit["lens"])) if md["family"] == "moe" else rows
    phi_loc = loc if md["family"] != "moe" else {int(b): (0, int(b)) for b in phi_rows}
    phi_p = torch.as_tensor(res["phi"][phi_rows], device=dev)

    def readings(prec):
        ref = reference.Reference(md, params, prec, cell.serving.get("capacity_factor", 1.25))
        hid = ref.hidden(segs)
        per_row = []
        for b in rows:
            s, r = loc[int(b)]
            n = int(lens[b])
            # the items whose logits chose served tokens 0 .. upto
            upto = int(last[b]) if bool(finished[b]) else max_new - 1
            items = torch.cat([hid[s][r, n - 1:n], hid[s][r, Sp[s]:Sp[s] + upto]])
            per_row.append((ref.logits(items), upto))
        phi = torch.stack([hid[phi_loc[int(b)][0]][phi_loc[int(b)][1], int(lens[b]) - 1]
                           for b in phi_rows])
        return per_row, phi

    def numbers(gaps, phi):
        gaps = torch.cat(gaps)
        rel = _rel_rows(phi_p if phi is None else phi, phi_r)
        return {"token_gap": float(gaps.max()), "token_gap_mean": float(gaps.mean()),
                **_row_stats("phi_err", rel)}

    ref_rows, phi_r = readings("fp32")
    best = [lr.max(dim=-1).values for lr, _ in ref_rows]
    gaps = [m - lr.gather(1, served[b, :upto + 1, None])[:, 0]
            for m, (lr, upto), b in zip(best, ref_rows, rows)]
    out = {"program": numbers(gaps, None)}
    if control:
        ctrl_rows, phi_c = readings("fp8")
        cg = [m - lr.gather(1, lc.argmax(dim=-1)[:, None])[:, 0]
              for m, (lr, _), (lc, _) in zip(best, ref_rows, ctrl_rows)]
        out["control"] = numbers(cg, phi_c)
        if md["family"] == "moe":
            w_rows, phi_w = readings("fp32r")
            wg = [m - lr.gather(1, lw.argmax(dim=-1)[:, None])[:, 0]
                  for m, (lr, _), (lw, _) in zip(best, ref_rows, w_rows)]
            out["witness"] = numbers(wg, phi_w)
    return out


def judge(readings: Dict[str, float], limits: Dict[str, float]) -> Tuple[bool, Dict]:
    """The numbers the cell's limits name, each beside its limit; correct
    where every one is finite and within its limit."""
    checks = {k: {"value": readings.get(k, float("nan")), "limit": v} for k, v in limits.items()}
    ok = bool(checks) and all(np.isfinite(c["value"]) and c["value"] <= c["limit"]
                              for c in checks.values())
    return ok, checks
