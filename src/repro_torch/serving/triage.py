"""Confidence triage: the paper's Fig. 1 three-way decision (port of
``repro/serving/triage.py``).

  ACCEPT    confidence ≥ τ_conf and mutual information ≤ τ_mi, certain
            at the current sample count;
  FLAG      confidently outside the accept region;
  ESCALATE  the accept/flag boundary lies within ±z·SE of the estimate:
            draw more samples.

At the sample budget (``final``) the verdict collapses onto the point
estimates — what a fixed-R = 20 system decides.
"""

from __future__ import annotations

import dataclasses

import torch

ACCEPT, ESCALATE, FLAG = 0, 1, 2
VERDICT_NAMES = {ACCEPT: "accept", ESCALATE: "escalate", FLAG: "flag"}


@dataclasses.dataclass(frozen=True)
class TriagePolicy:
    """Thresholds of the three-way decision and the escalation budget."""
    conf_threshold: float = 0.8
    mi_threshold: float = 0.5
    z: float = 1.0
    r_min: int = 4
    r_max: int = 20
    r_growth: int = 2

    def __post_init__(self):
        if self.r_min < 1:
            raise ValueError(f"r_min must be >= 1, got {self.r_min}")
        if self.r_max < self.r_min:
            raise ValueError(
                f"r_max ({self.r_max}) must be >= r_min ({self.r_min})")
        if self.r_growth < 1:
            raise ValueError(f"r_growth must be >= 1, got {self.r_growth}")


def decide(stats: dict, policy: TriagePolicy, *, final) -> torch.Tensor:
    """Three-way verdict [B] (int32) from ``adaptive.finalize`` output.

    ``final`` (bool or [B] bool tensor): sample budget exhausted.
    """
    conf = stats["confidence"]
    mi = stats["mutual_information"]
    conf_se = policy.z * stats["confidence_se"]
    mi_se = policy.z * stats["mutual_information_se"]
    tau_c, tau_mi = policy.conf_threshold, policy.mi_threshold

    in_accept = (conf >= tau_c) & (mi <= tau_mi)
    accept_certain = (conf - conf_se >= tau_c) & (mi + mi_se <= tau_mi)
    flag_certain = (conf + conf_se < tau_c) | (mi - mi_se > tau_mi)

    final = torch.as_tensor(final, device=conf.device).expand(conf.shape)
    verdict = torch.full(conf.shape, ESCALATE, dtype=torch.int32,
                         device=conf.device)
    verdict = torch.where(accept_certain, ACCEPT, verdict)
    verdict = torch.where(flag_certain, FLAG, verdict)
    forced = torch.where(in_accept, ACCEPT, FLAG).to(torch.int32)
    return torch.where(final & (verdict == ESCALATE), forced,
                       verdict).to(torch.int32)


def fixed_r_decide(stats: dict, policy: TriagePolicy) -> torch.Tensor:
    """The non-adaptive baseline: accept/flag on point estimates."""
    in_accept = ((stats["confidence"] >= policy.conf_threshold)
                 & (stats["mutual_information"] <= policy.mi_threshold))
    return torch.where(in_accept, ACCEPT, FLAG).to(torch.int32)
