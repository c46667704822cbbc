"""Static offset compensation (port of ``repro/core/offset.py``,
paper §III-B1).

Each CLT-GRNG cell has a static mean offset Δε from its particular draw
of device states; folding it into the stored mean once,

    µ' = µ − σ·Δε   ⇒   w = µ' + σ·ε  (ε zero-mean),

removes it.  The virtual devices give Δε in closed form
(``clt_grng.cell_mean_offset``); the N-sample estimate of the
reference waits for a later slice.
"""

from __future__ import annotations

import torch

from repro_torch.core import clt_grng as g


def compensate_mu(mu: torch.Tensor, sigma: torch.Tensor,
                  cfg: g.GRNGConfig) -> torch.Tensor:
    """Return µ' = µ − σ·Δε with the exact closed-form Δε."""
    k, n = mu.shape
    return mu - sigma * g.cell_mean_offset(cfg, k, n, device=mu.device)
