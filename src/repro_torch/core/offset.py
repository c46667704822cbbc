"""Static offset compensation (port of ``repro/core/offset.py``,
paper §III-B1).

Each CLT-GRNG cell has a static mean offset Δε from its particular draw
of device states; folding it into the stored mean once,

    µ' = µ − σ·Δε   ⇒   w = µ' + σ·ε  (ε zero-mean),

removes it.  The virtual devices give Δε in closed form
(``clt_grng.cell_mean_offset``); a deployment on a real die measures it
with N samples instead (``clt_grng.estimate_mean_offset``, what
``hw/calib.py`` does per chip).  ``compensation_report`` waits for a
later slice.
"""

from __future__ import annotations

import torch

from repro_torch.core import clt_grng as g


def compensate_mu(mu: torch.Tensor, sigma: torch.Tensor,
                  cfg: g.GRNGConfig, exact: bool = True,
                  n_est: int = 64) -> torch.Tensor:
    """Return µ' = µ − σ·Δε, with Δε in closed form (``exact``) or
    estimated from ``n_est`` samples."""
    k, n = mu.shape
    if exact:
        d_eps = g.cell_mean_offset(cfg, k, n, device=mu.device)
    else:
        d_eps = g.estimate_mean_offset(cfg, k, n, n_est, device=mu.device)
    return mu - sigma * d_eps
