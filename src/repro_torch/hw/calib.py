"""Per-instance recalibration (port of ``repro/hw/calib.py``, paper
§III-B1 applied per chip).

An uncalibrated deployment ships every die with the golden serving
transform: µ' compensated against the golden chip's closed-form offsets
and ε standardized by the nominal Fig. 9 constants.  Calibration is the
paper's two-step measurement on the die's digital twin:

  1. measure (sum_mean, sum_std) from N reads across a cell block
     (``measured_grng``), and serve with the measured constants;
  2. re-measure each cell's mean offset Δε with N samples and fold it
     into µ' (``offset.compensate_mu(exact=False)``).

Conductance programming error hits whatever is written, calibrated or
not.  ``calibration_report`` waits for a later slice.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.core import clt_grng as g
from repro_torch.core import quant as q
from repro_torch.core.offset import compensate_mu
from repro_torch.core.sampling import (BayesHeadConfig, hoisted_sigma_basis,
                                       prepare_serving_head)
from repro_torch.hw.instance import ChipInstance


# The calibration measurement: reads of a block of cells, and samples
# per cell both for the sum constants and for each cell's offset.
_CALIB_CELLS = 2048
_CALIB_SAMPLES = 64


def measured_grng(icfg: g.GRNGConfig) -> g.GRNGConfig:
    """The calibrated serving view: physical params + measured
    constants (mean and population SD, ddof 0, of the raw sums of
    ``_CALIB_SAMPLES`` reads of ``_CALIB_CELLS`` cells)."""
    raw = g.raw_sums(icfg, _CALIB_CELLS, 1, _CALIB_SAMPLES)
    return dataclasses.replace(icfg, sum_mean=float(raw.mean()),
                               sum_std=float(raw.std(correction=0)))


def prepare_instance_head(mu: torch.Tensor, sigma: torch.Tensor,
                          cfg: BayesHeadConfig,
                          instance: ChipInstance | None = None,
                          calibrated: bool = True
                          ) -> tuple[dict, BayesHeadConfig]:
    """Deploy (µ, σ) onto a chip instance.

    Returns (head, serving_cfg): the head whose stored values went
    through compensation → quantization → conductance programming
    error, and the config whose ``grng`` is the die's physical view
    (measured constants when ``calibrated``).  ``instance=None`` is
    ``prepare_serving_head``.
    """
    if instance is None:
        return prepare_serving_head(mu, sigma, cfg), cfg
    icfg = instance.grng(cfg.grng)
    if calibrated:
        scfg = measured_grng(icfg)
        mu_p = compensate_mu(mu, sigma, scfg, exact=False,
                             n_est=_CALIB_SAMPLES)
    else:
        # the factory (golden) transform: right math, wrong chip
        scfg = icfg
        mu_p = compensate_mu(mu, sigma, cfg.grng, exact=True)
    if cfg.quant.enabled:
        mu_p, _ = q.quantize_mu(mu_p, cfg.quant)
        sigma, _ = q.quantize_sigma(sigma, cfg.quant)
    mu_p = instance.program_weights(mu_p, tag=0)
    sigma = instance.program_weights(sigma, tag=1)
    head = {"mu_prime": mu_p.to(cfg.compute_dtype),
            "sigma": sigma.to(cfg.compute_dtype)}
    serving_cfg = dataclasses.replace(cfg, grng=scfg)
    if cfg.hoist_basis and cfg.mode == "rank16":
        head["sigma_basis"] = hoisted_sigma_basis(sigma, scfg,
                                                  cfg.compute_dtype)
    return head, serving_cfg
