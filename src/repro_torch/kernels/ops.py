"""Public entry points of the kernels package (port of
``repro/kernels/ops.py``): the GRNG ε block, the fused Bayesian head,
the decision update and the chunked-ADC CIM products of a chip
instance's conv trunk."""

from __future__ import annotations

import torch

from repro_torch import resolve_device
from repro_torch.core import clt_grng as g
from repro_torch.core.quant import QuantConfig, adc_full_scale
from repro_torch.kernels import bayes
from repro_torch.kernels import grng as grng_kernel
from repro_torch.kernels.cim import cim_mvm
from repro_torch.kernels.decision import (MAX_SAMPLES, decision_stats,
                                          decision_stats_sharded)


def grng_eps(cfg: g.GRNGConfig, n_rows: int, n_cols: int, num_samples: int,
             sample0: int = 0, row0: int = 0, col0: int = 0,
             device=None) -> torch.Tensor:
    """CLT-GRNG ε block [R, n_rows, n_cols] through the ε kernel, on
    ``device`` (None = the card; "cpu" runs the plain version)."""
    _layer_only(cfg, "the ε kernel")
    dev = resolve_device(device)
    sel = g.selections(cfg, num_samples, sample0, device=dev)
    return grng_kernel.grng_eps(sel, cfg, n_rows, n_cols, row0=row0,
                                col0=col0, sample0=sample0)


def _layer_only(cfg: g.GRNGConfig, what: str) -> None:
    """The kernels read one selection stream shared by the block, as
    the reference's (``kernels/ref.py``): other granularities are drawn
    by the plain ``clt_grng`` / ``sampling`` functions."""
    if cfg.granularity != "layer":
        raise ValueError(f"{what} takes 'layer' selections, not "
                         f"granularity={cfg.granularity!r}")


def _rms(t: torch.Tensor) -> torch.Tensor:
    return torch.sqrt((t.to(torch.float32) ** 2).mean() + 1e-12)


def bayes_head_mvm(x: torch.Tensor, mu_prime: torch.Tensor,
                   sigma: torch.Tensor, cfg: g.GRNGConfig, num_samples: int,
                   sample0: int = 0, mode: str = "rank16",
                   qcfg: QuantConfig | None = None,
                   sel: torch.Tensor | None = None) -> torch.Tensor:
    """Fused Bayesian head: [R, B, N] logit samples on x's device.

    mode='rank16': R-independent (16 basis products and a mix); on a die
    with read noise it adds the logit-level projection, drawn from the
    same hash stream as ``core/sampling.mix_samples``.  mode='paper':
    one σε product per sample with per-cell read noise; ``qcfg``
    (enabled) adds the 6-bit chunked ADC, whose full scales
    ``adc_full_scale(rms(x), rms(µ'))`` and ``adc_full_scale(rms(x),
    rms(σ))`` stay on the device.  'layer' granularity only.  ``sel``
    [num_samples, 16]: selections to draw with in place of the stream's
    from ``sample0`` (the read noise stays keyed on ``sample0 + r``).
    """
    _layer_only(cfg, "the head kernel")
    if sel is None:
        sel = g.selections(cfg, num_samples, sample0, device=x.device)
    elif tuple(sel.shape) != (num_samples, 16):
        raise ValueError(f"sel has shape {tuple(sel.shape)}, expected "
                         f"({num_samples}, 16)")
    if qcfg is not None and not qcfg.enabled:
        qcfg = None
    if mode == "rank16":
        assert qcfg is None, "ADC path requires hardware sample order"
        return bayes.bayes_rank16(x, mu_prime, sigma, sel, cfg,
                                  sample0=sample0)
    if mode != "paper":
        raise ValueError(mode)
    fs = None
    if qcfg is not None:
        x_rms = _rms(x)
        # σε RMS: Var[σ·ε] ≈ E[σ²] for standardized ε.
        fs = torch.stack([adc_full_scale(x_rms, _rms(mu_prime), qcfg),
                          adc_full_scale(x_rms, _rms(sigma), qcfg)])
    return bayes.bayes_paper(x, mu_prime, sigma, sel, fs, cfg, qcfg=qcfg,
                             sample0=sample0)


def decision_update(stats: dict, abasis: dict, sel: torch.Tensor,
                    cfg: g.GRNGConfig, sample_idx=None, mask=None,
                    rows=None, shard=None, row0: int = 0) -> dict:
    """Fused drop-in for ``update_stats(stats, mix_samples(...), mask)``.

    Folds one escalation round into the running statistics through the
    fused decision kernel (``kernels/decision.py``): the [R, B, N]
    logit samples never exist, and each launch adds its deltas straight
    into ``stats`` (the kernel's accumulate epilogue: no delta buffers,
    no add kernels).  A round of R > ``MAX_SAMPLES`` samples (a fixed-R
    round of r_max) is cut along R into consecutive pieces of at most
    ``MAX_SAMPLES``, one launch each, folded in sample order; every draw
    keeps its absolute stream index, so only the float order of the
    sums changes.  Unlike the reference, which returns new arrays, the
    sums are updated IN PLACE (the serving pool keeps one copy of its
    statistics) and ``stats`` is returned.  ``mask`` [B] bool: False
    rows keep their sums and count.  ``row0``: the global slot id of
    row 0 for the read-noise hash (a slot shard's first slot) when
    ``rows`` is None.

    ``shard``: a sequence of torch devices (may repeat one) — each piece
    goes through ``decision_stats_sharded`` over that many slot shards,
    one launch a run of shards on one device, read noise keyed on global
    slot ids (``rows``, default arange(B)), so the round's bits are the
    unsharded round's.
    """
    r = sel.shape[0]
    for r0 in range(0, r, MAX_SAMPLES):
        piece = slice(r0, min(r, r0 + MAX_SAMPLES))
        args = (abasis["y_mu"], abasis["x_sigma"], abasis["m"],
                sel[piece].contiguous(), cfg)
        kw = dict(x_sigsq=abasis.get("x_sigsq"),
                  sample_idx=(None if sample_idx is None
                              else sample_idx[piece].contiguous()),
                  mask=mask, rows=rows, out=stats)
        if shard is None:
            decision_stats(*args, row0=row0, **kw)
        else:
            decision_stats_sharded(*args, devices=shard, **kw)
    if mask is None:
        stats["n"] += r
    else:
        stats["n"] += torch.as_tensor(mask, device=stats["n"].device).to(
            stats["n"].dtype) * r
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
