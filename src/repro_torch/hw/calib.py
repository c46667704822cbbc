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
not.  ``calibration_report`` measures one die against the golden chip
(constants, residual offsets, the paper's cost of the measurement).
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch import resolve_device
from repro_torch.core import clt_grng as g
from repro_torch.core import energy
from repro_torch.core import quant as q
from repro_torch.core.offset import compensate_mu
from repro_torch.core.sampling import (BayesHeadConfig, hoisted_sigma_basis,
                                       prepare_serving_head)
from repro_torch.hw.instance import ChipInstance


# The calibration measurement: reads of a block of cells, and samples
# per cell both for the sum constants and for each cell's offset.
_CALIB_CELLS = 2048
_CALIB_SAMPLES = 64


@dataclasses.dataclass(frozen=True)
class CalibrationReport:
    chip_id: int
    nominal_sum_mean: float
    nominal_sum_std: float
    measured_sum_mean: float
    measured_sum_std: float
    residual_eps_uncal: float     # |E[ε]| under nominal constants+offsets
    residual_eps_cal: float       # |E[ε]| after per-chip recalibration
    n_samples: int
    energy_J: float               # §III-B1 measurement cost
    time_s: float


def measured_grng(icfg: g.GRNGConfig, n_samples: int = _CALIB_SAMPLES,
                  device=None) -> g.GRNGConfig:
    """The calibrated serving view: physical params + measured
    constants (mean and population SD, ddof 0, of the raw sums of
    ``n_samples`` reads of ``_CALIB_CELLS`` cells), drawn on
    ``device`` (None = the card, "cpu" on the CPU)."""
    raw = g.raw_sums(icfg, _CALIB_CELLS, 1, n_samples,
                     device=resolve_device(device))
    return dataclasses.replace(icfg, sum_mean=float(raw.mean()),
                               sum_std=float(raw.std(correction=0)))


def calibration_report(instance: ChipInstance, base: g.GRNGConfig,
                       n_samples: int = 64, probe: int = 64,
                       device=None) -> CalibrationReport:
    """Measure one die against the golden chip on ``device`` (None =
    the card): the constants from ``n_samples`` reads, and the residual
    mean offset of 256 samples of ε̂ over a ``probe``×``probe`` corner,
    uncalibrated (nominal constants, the golden offsets) and calibrated
    (measured constants, offsets measured with ``n_samples``); the
    cost from the paper's model (``energy.offset_compensation_cost``)."""
    dev = resolve_device(device)
    icfg = instance.grng(base)
    ccfg = measured_grng(icfg, n_samples=n_samples, device=dev)
    eps_uncal = g.eps(icfg, probe, probe, 256, device=dev)
    d_gold = g.cell_mean_offset(base, probe, probe, device=dev)
    resid_uncal = float((eps_uncal - d_gold[None]).mean().abs())
    eps_cal = g.eps(ccfg, probe, probe, 256, device=dev)
    d_meas = g.estimate_mean_offset(ccfg, probe, probe, n_samples,
                                    device=dev)
    resid_cal = float((eps_cal - d_meas[None]).mean().abs())
    e_j, t_s = energy.offset_compensation_cost(n_samples)
    return CalibrationReport(
        chip_id=instance.chip_id,
        nominal_sum_mean=base.sum_mean, nominal_sum_std=base.sum_std,
        measured_sum_mean=ccfg.sum_mean, measured_sum_std=ccfg.sum_std,
        residual_eps_uncal=resid_uncal, residual_eps_cal=resid_cal,
        n_samples=n_samples, energy_J=e_j, time_s=t_s)


def prepare_instance_head(mu: torch.Tensor, sigma: torch.Tensor,
                          cfg: BayesHeadConfig,
                          instance: ChipInstance | None = None,
                          calibrated: bool = True,
                          hoist_tile_n: int | None = None
                          ) -> tuple[dict, BayesHeadConfig]:
    """Deploy (µ, σ) onto a chip instance.

    Returns (head, serving_cfg): the head whose stored values went
    through compensation → quantization → conductance programming
    error, and the config whose ``grng`` is the die's physical view
    (measured constants when ``calibrated``).  ``cfg.mode`` may be
    'rank16', 'paper' or 'moment'; the σ⊙I_j basis is hoisted
    (``hoist_basis``) for rank16 only, in host chunks at
    ``hoist_tile_n`` (None: ``cfg.hoist_tile_n``).  ``instance=None`` is
    ``prepare_serving_head``.  Every step runs on µ's device, the
    measurement included.
    """
    if instance is None:
        return prepare_serving_head(mu, sigma, cfg, hoist_tile_n), cfg
    icfg = instance.grng(cfg.grng)
    if calibrated:
        scfg = measured_grng(icfg, device=mu.device)
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
    tile_n = cfg.hoist_tile_n if hoist_tile_n is None else hoist_tile_n
    if cfg.hoist_basis and cfg.mode == "rank16":
        head.update(hoisted_sigma_basis(sigma, scfg, cfg.compute_dtype,
                                        tile_n))
    return head, serving_cfg
