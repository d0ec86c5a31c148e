"""Theorem 1 / Lemma 3 numerical validation (paper §2.3, App. B).

Reports: Lemma-3 moment ratio, the exponential failure-probability term vs r,
the r* = 8·log(4N/δ) threshold, and empirical coverage of the pointwise bound
under median-of-r vs single-draw labels. The twin of the reference's
``benchmarks/bench_theory.py``: NumPy only, over the port's copies of
``core/theory.py`` and ``data/synthetic.py``, so its outputs are the
reference's bit for bit.

    PYTHONPATH=src python -m repro_torch.launch.bench_theory
"""

from __future__ import annotations

import numpy as np

from repro_torch.core import theory as TH
from repro_torch.data.synthetic import surrogate_linear_data


def run(verbose=True):
    out = {}
    # Lemma 3 across tail weights
    lemma3 = {}
    for eps in (0.25, 0.5, 1.0):
        base, med = TH.lemma3_moment(
            lambda rng, s: rng.standard_t(1 + 2 * eps, size=s), r=16, eps=eps,
            n_trials=60000)
        lemma3[eps] = {"E|X|^{1+eps}": base, "E|med_r|^{1+eps}": med,
                       "ratio": med / base}
    out["lemma3"] = lemma3

    # failure probability vs r
    N = 2000
    out["failure_prob"] = {r: TH.failure_prob(N, r) for r in (8, 16, 32, 64, 96)}
    out["r_required_delta_0.05"] = TH.r_required(N, 0.05)

    # estimation error: single vs median labels (20 trials)
    errs_s, errs_m = [], []
    for t in range(20):
        phi, eta, theta = surrogate_linear_data(800, 8, eps=0.5, v=1.0, r=16,
                                                seed=t)
        y = phi @ theta
        errs_s.append(np.linalg.norm(TH.ridge_fit(phi, y + eta[:, 0]).theta - theta))
        errs_m.append(np.linalg.norm(
            TH.ridge_fit(phi, y + np.median(eta, axis=1)).theta - theta))
    out["ridge_err_single"] = (float(np.mean(errs_s)), float(np.std(errs_s)))
    out["ridge_err_median"] = (float(np.mean(errs_m)), float(np.std(errs_m)))

    # coverage of the Theorem-1 bound at r >= r*
    N2, d, eps, v, S, delta, lam = 600, 6, 0.5, 1.0, 1.0, 0.1, 1.0
    r_star = TH.r_required(N2, delta)
    phi, eta, theta = surrogate_linear_data(N2, d, eps=eps, v=v, r=r_star, seed=7)
    fit = TH.ridge_fit(phi, phi @ theta + np.median(eta, axis=1), lam=lam)
    beta = TH.theorem1_beta(N2, d, v, eps, delta, lam, S)
    out["coverage_at_r_star"] = TH.empirical_coverage(fit, phi, phi @ theta, beta)
    if verbose:
        print(f"  lemma3 ratios: { {k: round(v['ratio'],3) for k,v in lemma3.items()} }")
        print(f"  ridge err single={out['ridge_err_single'][0]:.4f} "
              f"median={out['ridge_err_median'][0]:.4f}")
        print(f"  r*={out['r_required_delta_0.05']} coverage={out['coverage_at_r_star']:.3f}")
    return out


def validate(out) -> dict:
    return {
        "lemma3_bound_holds": all(v["ratio"] <= 2.05 for v in out["lemma3"].values()),
        "median_labels_reduce_error": out["ridge_err_median"][0]
        < out["ridge_err_single"][0],
        "coverage_ge_1_minus_2delta": out["coverage_at_r_star"] >= 0.8,
        "failure_prob_monotone": all(
            a > b for a, b in zip(list(out["failure_prob"].values())[:-1],
                                  list(out["failure_prob"].values())[1:])),
    }


def main():
    out = run()
    print("checks:", validate(out))
    return out


if __name__ == "__main__":
    main()
