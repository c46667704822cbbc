"""Adaptive-fidelity sampling state (port of ``repro/serving/adaptive.py``).

Each decision starts at a small R and escalates while the triage is
ambiguous.  Escalation draws later positions of the same selection
stream (exact extension), and the predictive statistics are running
sums, so ``finalize`` of the accumulated state equals the statistics
of all samples at once.

Stream indices are uint32 values carried in int64 tensors.
"""

from __future__ import annotations

import torch

from repro_torch.core.hashing import MASK32
from repro_torch.core.lfsr import indexed_selections
from repro_torch.serving.triage import TriagePolicy

_EPS = 1e-12


def escalation_schedule(policy: TriagePolicy) -> tuple:
    """Round sizes (r_1, r_2, ...) summing to exactly r_max, geometric
    with ratio ``r_growth`` from ``r_min`` (the LM engine's schedule)."""
    rounds, total, step = [], 0, policy.r_min
    while total < policy.r_max:
        step = min(step, policy.r_max - total)
        rounds.append(step)
        total += step
        step *= policy.r_growth
    return tuple(rounds)


def init_stats(batch: int, n_classes: int, device=None) -> dict:
    """Zeroed running sufficient statistics for ``batch`` slots."""
    def z(*shape, dtype=torch.float32):
        return torch.zeros(shape, dtype=dtype, device=device)
    return {"n": z(batch, dtype=torch.int32),
            "sum_p": z(batch, n_classes), "sum_psq": z(batch, n_classes),
            "sum_ent": z(batch), "sum_entsq": z(batch)}


def update_stats(stats: dict, logit_samples: torch.Tensor,
                 mask=None) -> dict:
    """Fold [R, B, C] logit samples into the running sums (a new dict).

    ``mask`` [B] bool: False rows keep their old sums.
    """
    logp = torch.log_softmax(logit_samples.to(torch.float32), dim=-1)
    p = torch.exp(logp)                                   # [R, B, C]
    ent = -(p * logp).sum(-1)                             # [R, B]
    r = logit_samples.shape[0]
    upd = {
        "n": stats["n"] + r,
        "sum_p": stats["sum_p"] + p.sum(0),
        "sum_psq": stats["sum_psq"] + (p * p).sum(0),
        "sum_ent": stats["sum_ent"] + ent.sum(0),
        "sum_entsq": stats["sum_entsq"] + (ent * ent).sum(0),
    }
    if mask is None:
        return upd
    keep = torch.as_tensor(mask, device=stats["n"].device)
    return {k: torch.where(keep.reshape((-1,) + (1,) * (new.ndim - 1)),
                           new, stats[k])
            for k, new in upd.items()}


def finalize(stats: dict) -> dict:
    """Predictive quantities + MC standard errors from running sums."""
    n = stats["n"].clamp_min(1).to(torch.float32)
    p_mean = stats["sum_p"] / n[:, None]                  # [B, C]
    pred = p_mean.argmax(-1)               # first maximum on ties
    conf = p_mean.amax(-1)
    logp_mean = torch.log(p_mean.clamp_min(_EPS))
    pred_entropy = -(p_mean * logp_mean).sum(-1)
    exp_entropy = stats["sum_ent"] / n

    p_pred = stats["sum_p"].gather(1, pred[:, None])[:, 0] / n
    psq_pred = stats["sum_psq"].gather(1, pred[:, None])[:, 0] / n
    var_conf = (psq_pred - p_pred**2).clamp_min(0.0)
    var_ent = (stats["sum_entsq"] / n - exp_entropy**2).clamp_min(0.0)

    return {
        "probs": p_mean,
        "confidence": conf,
        "prediction": pred,
        "predictive_entropy": pred_entropy,
        "expected_entropy": exp_entropy,
        "mutual_information": pred_entropy - exp_entropy,
        "confidence_se": torch.sqrt(var_conf / n),
        "mutual_information_se": torch.sqrt(var_ent / n),
        "n": stats["n"],
    }


def stream_indices(base: torch.Tensor, n_drawn: torch.Tensor,
                   num: int) -> torch.Tensor:
    """Absolute stream positions of the NEXT ``num`` samples, [num, B]
    (uint32 values in int64) — also the read-noise key."""
    r = torch.arange(num, dtype=torch.int64, device=base.device)[:, None]
    return (base.to(torch.int64)[None, :] + n_drawn.to(torch.int64)[None, :]
            + r) & MASK32


def stream_selections(grng_cfg, base: torch.Tensor, n_drawn: torch.Tensor,
                      num: int) -> torch.Tensor:
    """Per-slot selection vectors for the next ``num`` samples:
    [num, B, 16], consecutive stream positions per slot."""
    return indexed_selections(grng_cfg.lfsr_seed,
                              stream_indices(base, n_drawn, num))
