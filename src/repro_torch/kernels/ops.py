"""Public entry points of the kernels package (port of
``repro/kernels/ops.py``: the decision update so far)."""

from __future__ import annotations

import torch

from repro_torch.core import clt_grng as g
from repro_torch.kernels.decision import decision_stats


def decision_update(stats: dict, abasis: dict, sel: torch.Tensor,
                    cfg: g.GRNGConfig, sample_idx=None, mask=None,
                    rows=None) -> dict:
    """Fused drop-in for ``update_stats(stats, mix_samples(...), mask)``.

    Folds one escalation round into the running statistics through the
    fused decision kernel (``kernels/decision.py``): the [R, B, N]
    logit samples never exist.  Unlike the reference, which returns new
    arrays, the sums are updated IN PLACE (the serving pool keeps one
    copy of its statistics) and ``stats`` is returned.  ``mask`` [B]
    bool: False rows keep their sums and count.
    """
    delta = decision_stats(abasis["y_mu"], abasis["x_sigma"], abasis["m"],
                           sel, cfg, x_sigsq=abasis.get("x_sigsq"),
                           sample_idx=sample_idx, mask=mask, rows=rows)
    r = sel.shape[0]
    if mask is None:
        stats["n"] += r
    else:
        stats["n"] += torch.as_tensor(mask, device=stats["n"].device).to(
            stats["n"].dtype) * r
    for key in ("sum_p", "sum_psq", "sum_ent", "sum_entsq"):
        stats[key] += delta[key]
    return stats
