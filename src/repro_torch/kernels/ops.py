"""Public entry points of the kernels package (port of
``repro/kernels/ops.py``): the decision update and the chunked-ADC CIM
products of a chip instance's conv trunk."""

from __future__ import annotations

import torch

from repro_torch.core import clt_grng as g
from repro_torch.core.quant import QuantConfig
from repro_torch.kernels.cim import cim_mvm
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


def measured_full_scale(x: torch.Tensor, w: torch.Tensor,
                        qcfg: QuantConfig) -> torch.Tensor:
    """ADC range calibration from the measured partial-sum RMS of the
    first 16 rows: clip_sigmas × RMS of their 64-deep chunk sums.  A
    0-dim tensor on x's device (never pulled to the host)."""
    xs = x[: min(16, x.shape[0])].to(torch.float32)
    kc = x.shape[1] // qcfg.chunk
    xb = xs.reshape(xs.shape[0], kc, qcfg.chunk)
    wb = w.to(torch.float32).reshape(kc, qcfg.chunk, w.shape[1])
    ps = torch.einsum("bkc,kcn->bkn", xb, wb)
    return qcfg.adc_clip_sigmas * torch.sqrt((ps * ps).mean() + 1e-12)


def cim_matmul(x: torch.Tensor, w: torch.Tensor,
               qcfg: QuantConfig) -> torch.Tensor:
    """Deterministic chunked-ADC CIM product (µ-only subarray)."""
    return cim_mvm(x, w, measured_full_scale(x, w, qcfg).reshape(1),
                   qcfg)


def cim_matmul_nonideal(x: torch.Tensor, w: torch.Tensor,
                        qcfg: QuantConfig, col_gain: torch.Tensor,
                        col_offset: torch.Tensor) -> torch.Tensor:
    """Chip-instance CIM product: the die's per-column ADC gain/offset
    [N].  Fold conductance programming error into ``w`` first
    (``hw.instance.ChipInstance.program_weights``)."""
    return cim_mvm(x, w, measured_full_scale(x, w, qcfg).reshape(1), qcfg,
                   col_gain=col_gain, col_offset=col_offset)
