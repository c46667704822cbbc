"""Static offset compensation (port of ``repro/core/offset.py``,
paper §III-B1).

Each CLT-GRNG cell has a static mean offset Δε from its particular draw
of device states; folding it into the stored mean once,

    µ' = µ − σ·Δε   ⇒   w = µ' + σ·ε  (ε zero-mean),

removes it.  The virtual devices give Δε in closed form
(``clt_grng.cell_mean_offset``); a deployment on a real die measures it
with N samples instead (``clt_grng.estimate_mean_offset``, what
``hw/calib.py`` does per chip).  The compensation consumes µ-subarray
range: ``compensation_report`` gives the worst cell's correction in µ
LSBs and the effective µ bits left (the paper: ~6.54 of 8).
"""

from __future__ import annotations

import dataclasses
import math

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


@dataclasses.dataclass(frozen=True)
class CompensationReport:
    max_correction_lsb: float     # |σ·Δε| / µ_LSB, worst cell
    effective_mu_bits: float      # paper: ~6.54
    residual_mean_offset: float   # post-compensation |E[ε̂]|


def compensation_report(mu: torch.Tensor, sigma: torch.Tensor,
                        cfg: g.GRNGConfig,
                        mu_bits: int = 8) -> CompensationReport:
    """The compensation's cost in µ range, on µ's device: the worst
    cell's |σ·Δε| in µ LSBs, the effective µ bits once that span is
    reserved, and the residual mean offset of 256 samples of ε̂ on the
    (≤64)×(≤64) corner after exact compensation."""
    k, n = mu.shape
    d_eps = g.cell_mean_offset(cfg, k, n, device=mu.device)
    corr_max = float((sigma * d_eps).abs().max())
    mu_max = float(mu.abs().max())
    mu_lsb = mu_max / (2 ** (mu_bits - 1) - 1)
    span_ratio = 1.0 + corr_max / max(mu_max, 1e-12)
    ks, ns = min(k, 64), min(n, 64)
    eps_hat = g.eps(cfg, ks, ns, 256, device=mu.device)
    d_small = g.cell_mean_offset(cfg, ks, ns, device=mu.device)
    return CompensationReport(
        max_correction_lsb=corr_max / max(mu_lsb, 1e-12),
        effective_mu_bits=mu_bits - math.log2(span_ratio),
        residual_mean_offset=float((eps_hat - d_small[None]).mean().abs()))
