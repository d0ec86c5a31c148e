"""Scenario calibration — the eight (served model × scenario) settings.

Targets taken from the paper (A.4 + Table 1 + the S³ bin_max grids of A.2):

* median prompt-level noise radius (tokens):
  Qwen:  Math 27.8, Coding 21.7, LongSeq 42.9, Chat 35.3
  Llama: Math 16.1, Coding 23.0, LongSeq 38.0, Chat 33.4
* noise ratio (Median-MAE / prompt median): 11.5% (Qwen/Math) … 18.2% (Llama/LongSeq)
* representative max/median heavy-tail ratios 2–4×
* scenario length scales implied by the A.2 bin_max grids
  (Qwen: Math ≈ 1243-max grid, Coding ≈ 799, LongSeq ≈ 3262, Chat ≈ 6593)
* Chat is the hardest regime: its prompt medians are extremely dispersed and
  its features least informative (paper: ProD-D MAE ≈ 2× noise radius).

``feature_noise`` per view encodes each probe's information content —
last-token hidden state (best) > mean-pooled > auxiliary proxy (S³) >
entropy-pooled (EGTP, which the paper observes collapses onto early tokens).

The port's own copy of ``repro.data.scenarios`` (NumPy only): the same seed gives the
same arrays, bit for bit.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Tuple

from repro_torch.data.lengths import LengthLaw

MODELS = ("qwen", "llama")
SCENARIOS = ("math", "coding", "longseq", "chat")

# per-view latent-observation noise (σ in units of the latent scale) and
# pooled-view attenuation; chat multiplies feature noise further.
VIEW_NOISE = {"last": 0.12, "mean": 0.30, "proxy": 0.55, "entropy": 0.95}


@dataclass(frozen=True)
class ScenarioSpec:
    law: LengthLaw
    feature_hardness: float      # scales VIEW_NOISE (chat ≫ math)
    d_feature: int = 64
    paper_noise_radius: float = 0.0   # reference values for validation
    paper_bin_max: float = 0.0


_CAL: Dict[Tuple[str, str], ScenarioSpec] = {
    # (model, scenario): length law + feature hardness
    ("qwen", "math"): ScenarioSpec(
        LengthLaw(median_scale=240, median_spread=0.45, sigma_body=0.142,
                  tail_weight=0.028, tail_alpha=2.8),
        feature_hardness=1.0, paper_noise_radius=27.8, paper_bin_max=1243),
    ("qwen", "coding"): ScenarioSpec(
        LengthLaw(median_scale=165, median_spread=0.52, sigma_body=0.16,
                  tail_weight=0.028, tail_alpha=2.6),
        feature_hardness=1.1, paper_noise_radius=21.7, paper_bin_max=799),
    ("qwen", "longseq"): ScenarioSpec(
        LengthLaw(median_scale=330, median_spread=0.75, sigma_body=0.145,
                  tail_weight=0.035, tail_alpha=2.2),
        feature_hardness=1.35, paper_noise_radius=42.9, paper_bin_max=3262),
    ("qwen", "chat"): ScenarioSpec(
        LengthLaw(median_scale=260, median_spread=1.05, sigma_body=0.16,
                  tail_weight=0.018, tail_alpha=2.0),
        feature_hardness=2.6, paper_noise_radius=35.3, paper_bin_max=6593),
    ("llama", "math"): ScenarioSpec(
        LengthLaw(median_scale=130, median_spread=0.42, sigma_body=0.152,
                  tail_weight=0.028, tail_alpha=2.8),
        feature_hardness=1.0, paper_noise_radius=16.1, paper_bin_max=938),
    ("llama", "coding"): ScenarioSpec(
        LengthLaw(median_scale=150, median_spread=0.55, sigma_body=0.183,
                  tail_weight=0.032, tail_alpha=2.4),
        feature_hardness=1.15, paper_noise_radius=23.0, paper_bin_max=866),
    ("llama", "longseq"): ScenarioSpec(
        LengthLaw(median_scale=250, median_spread=0.72, sigma_body=0.162,
                  tail_weight=0.042, tail_alpha=2.0),
        feature_hardness=1.3, paper_noise_radius=38.0, paper_bin_max=2689),
    ("llama", "chat"): ScenarioSpec(
        LengthLaw(median_scale=215, median_spread=1.0, sigma_body=0.185,
                  tail_weight=0.012, tail_alpha=2.0),
        feature_hardness=2.5, paper_noise_radius=33.4, paper_bin_max=4422),
}

# paper's official split sizes (3.1); benchmarks default to reduced sizes on CPU
PAPER_SPLITS = {
    "math": (7473, 1319), "coding": (374, 500),
    "longseq": (3789, 961), "chat": (4070, 930),
}


ALL_SETTINGS: Tuple[Tuple[str, str], ...] = tuple(
    (m, s) for m in MODELS for s in SCENARIOS
)


def get_spec(model: str, scenario: str) -> ScenarioSpec:
    return _CAL[(model, scenario)]


def feature_sigma(spec: ScenarioSpec, view: str = "last") -> float:
    """Effective log-median observation noise of a probe view for a scenario:
    the per-view latent noise scaled by scenario feature hardness. This is the
    σ a trace-level predictor proxy corrupts log m with, so that prediction
    error tracks the paper's view-informativeness ordering (last > mean >
    proxy > entropy) and scenario difficulty (chat ≫ math)."""
    return spec.feature_hardness * VIEW_NOISE[view]
