"""Parameterized FeFET nonideality model (port of ``repro/hw/device.py``).

A deployed die differs from the golden chip of ``core/clt_grng.py``
along five axes: the programming draw of its GRNG arrays (a
chip-specific hash ``seed``), the process corner (fractional
multipliers on i_lo, Δi, γ), a uniform temperature drift of the
currents (which folds into the same three parameters), cycle-to-cycle
read noise (``GRNGConfig.read_sigma``) and the peripheral errors: per-
column ADC gain/offset and conductance programming error
(``hw/instance.py``).  ``VariationSpec`` holds the population
statistics a die is drawn from; ``retention_decades`` is the clock of
the aging laws (``hw/aging.py``).
"""

from __future__ import annotations

import dataclasses
import math

from repro_torch.core.clt_grng import GRNGConfig

# Reference temperature of the paper's Fig. 9 fit.
T_NOMINAL_C = 25.0


@dataclasses.dataclass(frozen=True)
class VariationSpec:
    """Population statistics of a chip instance (fractional spreads; a
    mid-severity corner for a 28 nm FeFET process)."""
    # Corner spread: per-chip fractional sigma of the current model.
    sigma_i_lo: float = 0.02
    sigma_delta_i: float = 0.03
    sigma_gamma: float = 0.15
    # Read noise on the 8-device sum [µA RMS]: |N(mean, mean·spread)|.
    read_sigma_mean: float = 0.08
    read_sigma_spread: float = 0.5
    # Operating temperature ~ N(temp_mean, temp_spread); currents drift
    # by ``tc_current`` per °C away from 25 °C.
    temp_mean_c: float = 25.0
    temp_spread_c: float = 15.0
    tc_current: float = -2.2e-3
    # SAR ADC column front end.
    adc_gain_sigma: float = 0.01
    adc_offset_sigma_lsb: float = 0.3
    # Conductance programming error (fractional, per written cell).
    program_sigma: float = 0.01

    def scaled(self, severity: float) -> "VariationSpec":
        """Every variation magnitude times ``severity``.  At 0 a die
        keeps its own device and noise seeds: golden statistics, but
        not the golden chip."""
        return dataclasses.replace(
            self,
            sigma_i_lo=self.sigma_i_lo * severity,
            sigma_delta_i=self.sigma_delta_i * severity,
            sigma_gamma=self.sigma_gamma * severity,
            read_sigma_mean=self.read_sigma_mean * severity,
            temp_spread_c=self.temp_spread_c * severity,
            adc_gain_sigma=self.adc_gain_sigma * severity,
            adc_offset_sigma_lsb=self.adc_offset_sigma_lsb * severity,
            program_sigma=self.program_sigma * severity,
        )


def drift_factor(tc_current: float, temp_c: float) -> float:
    """Uniform current drift at ``temp_c`` relative to the 25 °C fit."""
    return 1.0 + tc_current * (temp_c - T_NOMINAL_C)


def retention_decades(t_s: float, t0_s: float) -> float:
    """Retention-loss clock: ln(1 + t/t0) elapsed "decades" at age t.

    FeFET polarization retention is log-linear in time.  ``log1p`` pins
    age 0 to exactly 0.0 decades, so an un-aged die is bit for bit its
    birth state; ``t0_s`` is the knee below which a die is fresh."""
    if t_s < 0.0:
        raise ValueError(f"age must be >= 0, got {t_s}")
    return math.log1p(t_s / t0_s)


def degraded_grng(base: GRNGConfig, *, device_seed: int, noise_seed: int,
                  f_i_lo: float = 1.0, f_delta_i: float = 1.0,
                  f_gamma: float = 1.0, drift: float = 1.0,
                  read_sigma: float = 0.0, imprint: float = 0.0,
                  imprint_seed: int | None = None) -> GRNGConfig:
    """The chip's physical GRNG: redrawn devices, shifted corner,
    drifted currents and read noise, with the NOMINAL standardization
    constants (what an uncalibrated deployment believes; ``hw/calib``
    swaps in measured ones).  ``imprint`` is the age-only axis."""
    return dataclasses.replace(
        base,
        seed=device_seed,
        i_lo=base.i_lo * f_i_lo * drift,
        delta_i=base.delta_i * f_delta_i * drift,
        gamma=base.gamma * f_gamma * drift,
        read_sigma=read_sigma,
        noise_seed=noise_seed,
        imprint=imprint,
        imprint_seed=(base.imprint_seed if imprint_seed is None
                      else imprint_seed),
    )
