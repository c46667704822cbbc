"""CIM tile execution semantics (port of ``repro/core/cim.py``, paper
§IV) in plain tensor ops.

A 64×64 tile computes its MVM in one shot: 8-bit IDAC inputs drive the
wordlines, the bitline charge is the analog 64-product partial sum, and
a 6-bit SAR ADC digitizes each column.  A logical [B,K]×[K,N] product
is therefore ⌈K/64⌉ analog chunks whose partial sums are quantized to
6 bits each before the digital sum.  Here the ADC full scale is
calibrated from the whole batch's partial-sum RMS (the reference's
``cfg.cim_execution`` trunk); the chip-instance path
(``kernels/ops.cim_matmul_nonideal``, the CIM kernel) samples 16 rows
instead.  The reference computes this outside any Pallas kernel, so it
stays plain tensor code; its einsum runs in float32 (no TF32) on the
card.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch import float32_math
from repro_torch.core import quant as q


def cim_matmul(x: torch.Tensor, w: torch.Tensor,
               cfg: q.QuantConfig) -> torch.Tensor:
    """Quantized CIM matmul with a per-64-chunk 6-bit ADC: x [B, K]
    activations, w [K, N] weights -> [B, N] float32."""
    if not cfg.enabled:
        with float32_math():
            return x @ w
    xq, _ = q.quantize_input(x, cfg)
    wq, _ = q.quantize_mu(w, cfg)
    pad = (-x.shape[-1]) % cfg.chunk
    xq = F.pad(xq, (0, pad))
    wq = F.pad(wq, (0, 0, 0, pad))
    kc = xq.shape[-1] // cfg.chunk
    xb = xq.reshape(x.shape[0], kc, cfg.chunk)
    wb = wq.reshape(kc, cfg.chunk, w.shape[1])
    with float32_math():
        psums = torch.einsum("bkc,kcn->bkn", xb, wb)     # [B, kc, N]
    # ADC full scale from the MEASURED partial-sum RMS (the hardware's
    # one-time range calibration): the independence model breaks for
    # ReLU-correlated activations and zero-padded im2col chunks.
    fs = cfg.adc_clip_sigmas * torch.sqrt(
        (psums.detach() ** 2).mean() + 1e-12)
    return q.adc_quantize(psums, fs, cfg).sum(dim=1)


def cim_dense(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor | None,
              cfg: q.QuantConfig) -> torch.Tensor:
    """Dense layer through the CIM path; leading dims of x are batch."""
    lead = x.shape[:-1]
    y = cim_matmul(x.reshape(-1, x.shape[-1]), w, cfg)
    y = y.reshape(*lead, w.shape[-1])
    return y if b is None else y + b


def adc_snr_db(x: torch.Tensor, w: torch.Tensor,
               cfg: q.QuantConfig) -> torch.Tensor:
    """SNR of the CIM path against the exact matmul, in dB."""
    with float32_math():
        exact = x @ w
    err = cim_matmul(x, w, cfg) - exact
    return 10.0 * torch.log10((exact**2).mean()
                              / ((err**2).mean() + 1e-20))
