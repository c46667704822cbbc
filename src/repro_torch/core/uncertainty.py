"""Uncertainty quantification metrics (port of
``repro/core/uncertainty.py``, paper §V-B2).

The paper's evaluation protocol on Monte-Carlo logit samples:

  * predictive statistics: the mean predictive distribution, its
    entropy, the expected entropy of the samples and their difference,
    the mutual information (epistemic share), and max-prob confidence;
  * risk–coverage curves and their area, AURC (selective error among
    the most confident predictions kept);
  * adaptive-binning calibration errors AECE / AMCE (equal-mass bins).

Sorting is stable, as ``jnp.argsort``'s, so tied confidences rank as in
the reference.
"""

from __future__ import annotations

import math

import torch


def predictive_stats(logit_samples: torch.Tensor) -> dict:
    """From [R, B, C] logit samples compute predictive quantities."""
    s = logit_samples.to(torch.float32)
    logp = torch.log_softmax(s, dim=-1)
    # Mean predictive distribution p̄ = E_r softmax(logits_r).
    logp_mean = torch.logsumexp(logp, dim=0) - math.log(s.shape[0])
    p_mean = torch.exp(logp_mean)
    pred_entropy = -(p_mean * logp_mean).sum(-1)
    # Expected entropy of individual samples (aleatoric part).
    exp_entropy = (-(torch.exp(logp) * logp).sum(-1)).mean(0)
    return {
        "probs": p_mean,                          # [B, C]
        "confidence": p_mean.amax(-1),            # [B]
        "prediction": p_mean.argmax(-1),          # [B]
        "predictive_entropy": pred_entropy,       # [B] total uncertainty
        "expected_entropy": exp_entropy,          # [B] aleatoric
        "mutual_information": pred_entropy - exp_entropy,  # [B] epistemic
        # population SD over samples (ddof 0), as jnp.std
        "logit_std": s.std(0, correction=0).mean(-1),
    }


def risk_coverage_curve(confidence: torch.Tensor, correct: torch.Tensor):
    """Selective risk at every coverage level: (coverage [B], risk [B]),
    entry i keeping the i+1 most confident predictions."""
    order = torch.argsort(-confidence, stable=True)
    correct_sorted = correct[order].to(torch.float32)
    n = confidence.shape[0]
    kept = torch.arange(1, n + 1, dtype=torch.float32,
                        device=confidence.device)
    return kept / n, 1.0 - torch.cumsum(correct_sorted, 0) / kept


def aurc(confidence: torch.Tensor, correct: torch.Tensor) -> torch.Tensor:
    """Area under the risk–coverage curve (lower is better)."""
    coverage, risk = risk_coverage_curve(confidence, correct)
    return torch.trapezoid(risk, coverage)


def _adaptive_bins(confidence: torch.Tensor, n_bins: int) -> torch.Tensor:
    """Equal-mass bin assignment by confidence rank."""
    n = confidence.shape[0]
    ranks = torch.argsort(torch.argsort(confidence, stable=True), stable=True)
    return torch.clamp((ranks * n_bins) // n, max=n_bins - 1)


def adaptive_calibration_errors(confidence: torch.Tensor,
                                correct: torch.Tensor, n_bins: int = 15):
    """(AECE, AMCE) with equal-mass (adaptive) binning: the paper's
    metric."""
    bins = _adaptive_bins(confidence, n_bins)
    correct = correct.to(torch.float32)
    one_hot = torch.nn.functional.one_hot(bins, n_bins).to(torch.float32)
    counts = one_hot.sum(0)
    acc = (one_hot * correct[:, None]).sum(0) / counts.clamp_min(1.0)
    conf = (one_hot * confidence[:, None]).sum(0) / counts.clamp_min(1.0)
    gap = (acc - conf).abs()
    aece = (counts / confidence.shape[0] * gap).sum()
    amce = torch.where(counts > 0, gap, torch.zeros_like(gap)).amax()
    return aece, amce


def uq_report(logit_samples: torch.Tensor, labels: torch.Tensor,
              n_bins: int = 15) -> dict:
    """The paper-style UQ report from MC logit samples and labels (0-dim
    tensors)."""
    stats = predictive_stats(logit_samples)
    correct = stats["prediction"] == labels.to(stats["prediction"].device)
    aece, amce = adaptive_calibration_errors(stats["confidence"], correct,
                                             n_bins)
    return {
        "accuracy": correct.to(torch.float32).mean(),
        "aurc": aurc(stats["confidence"], correct),
        "aece": aece,
        "amce": amce,
        "mean_predictive_entropy": stats["predictive_entropy"].mean(),
        "mean_mutual_information": stats["mutual_information"].mean(),
    }


def deterministic_report(logits: torch.Tensor, labels: torch.Tensor,
                         n_bins: int = 15) -> dict:
    """The same report for a deterministic model (the CNN baseline)."""
    return uq_report(logits[None], labels, n_bins)
