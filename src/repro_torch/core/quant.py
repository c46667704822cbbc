"""CIM numeric-path quantization (port of ``repro/core/quant.py``).

The paper's split-precision tile stores signed 8-bit µ and unsigned
4-bit σ; inputs enter through 8-bit IDACs, and every 64-deep analog
partial sum is digitized by a 6-bit SAR ADC before digital
accumulation.  The straight-through (QAT) flavours wait for the
training slice.  ``torch.round`` rounds half to even, as ``jnp.round``
does.
"""

from __future__ import annotations

import dataclasses
import math

import torch


@dataclasses.dataclass(frozen=True)
class QuantConfig:
    mu_bits: int = 8
    sigma_bits: int = 4
    input_bits: int = 8
    adc_bits: int = 6
    # ADC full-scale as a multiple of the partial-sum RMS (calibrated).
    adc_clip_sigmas: float = 4.0
    # Depth of the analog accumulation before ADC digitization.
    chunk: int = 64
    enabled: bool = True


def _amax(x: torch.Tensor, axis) -> torch.Tensor:
    return x.amax() if axis is None else x.amax(dim=axis, keepdim=True)


def symmetric_scale(x: torch.Tensor, bits: int, axis=None) -> torch.Tensor:
    """Max-abs scale so that x/scale fits signed ``bits`` integers."""
    qmax = 2 ** (bits - 1) - 1
    return _amax(x.abs(), axis).clamp_min(1e-12) / qmax


def quantize(x: torch.Tensor, scale: torch.Tensor, bits: int,
             signed: bool = True) -> torch.Tensor:
    """Round-to-nearest-even integer code."""
    if signed:
        lo, hi = -(2 ** (bits - 1)), 2 ** (bits - 1) - 1
    else:
        lo, hi = 0, 2**bits - 1
    return torch.clamp(torch.round(x / scale), lo, hi)


def fake_quant(x: torch.Tensor, scale: torch.Tensor, bits: int,
               signed: bool = True) -> torch.Tensor:
    return quantize(x, scale, bits, signed) * scale


def quantize_mu(mu: torch.Tensor, cfg: QuantConfig,
                per_channel: bool = True):
    """Quantize mean weights (per-output-channel scale) -> (µq, scale)."""
    axis = tuple(range(mu.ndim - 1)) if per_channel else None
    scale = symmetric_scale(mu, cfg.mu_bits, axis=axis)
    return fake_quant(mu, scale, cfg.mu_bits), scale


def quantize_sigma(sigma: torch.Tensor, cfg: QuantConfig,
                   per_channel: bool = True):
    """Quantize σ ≥ 0 to unsigned 4-bit codes -> (σq, scale)."""
    axis = tuple(range(sigma.ndim - 1)) if per_channel else None
    qmax = 2**cfg.sigma_bits - 1
    scale = _amax(sigma, axis).clamp_min(1e-12) / qmax
    return quantize(sigma, scale, cfg.sigma_bits, signed=False) * scale, scale


def quantize_input(x: torch.Tensor, cfg: QuantConfig):
    """IDAC path: per-tensor symmetric 8-bit -> (xq, scale)."""
    scale = symmetric_scale(x, cfg.input_bits)
    return fake_quant(x, scale, cfg.input_bits), scale


def adc_quantize(psum: torch.Tensor, full_scale, cfg: QuantConfig):
    """6-bit mid-tread ADC on an analog partial sum; codes saturate
    (clip) as a SAR ADC does.  ``full_scale`` is the ±range."""
    levels = 2 ** (cfg.adc_bits - 1) - 1
    lsb = full_scale / levels
    code = torch.clamp(torch.round(psum / lsb), -levels - 1, levels)
    return code * lsb


def adc_full_scale(x_rms, w_rms, cfg: QuantConfig):
    """Calibrated ADC range: clip_sigmas × RMS of a 64-product sum
    (Var[Σ_64 x·w] = 64·σx²·σw² for zero-mean independent x, w)."""
    return cfg.adc_clip_sigmas * math.sqrt(float(cfg.chunk)) * x_rms * w_rms
