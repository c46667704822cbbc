"""Time-evolving FeFET aging (port of ``repro/hw/aging.py``): retention
loss that arrives in the field instead of being frozen at die creation.

The GRNG arrays are programmed once and read forever, so the
nonideality budget moves: polarization retention loss droops the mean
current, imprint spreads the device-to-device distribution (γ growth),
read disturb raises the cycle-to-cycle noise floor, and each device's
Vth walks away from its programmed state (the ``imprint`` term of
``core/clt_grng``).  ``hw/instance.py`` samples a die's birth corner;
this module evolves it:

    aged = chip.at_age(t_s)          # the ChipInstance at field age t_s

All four laws are log-linear in time (``device.retention_decades``).  A
die's rates are drawn with numpy's ``default_rng`` keyed by its
serialized seeds, by the same code as the reference, so an aged die
equals the reference's field for field, bit for bit; ``at_age(0)`` is
the birth instance itself.  Aging touches the GRNG subarrays only
(currents, read σ, imprint): the trunk's ADC front ends and written
conductances stay as programmed.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.hw import device as dev

# Tag mixed into the aging-rate PRNG key so the rate draw never aliases
# the die's device, noise or weight streams.
_SEED_AGE = 0xA6ED


@dataclasses.dataclass(frozen=True)
class AgingSpec:
    """Population statistics of the aging laws (rates per ln-decade).

    The defaults are published FeFET retention corners: a fraction of a
    percent of mean current lost per ln-decade after a ~1 h knee, plus a
    per-device imprint walk.
    """

    t0_s: float = 3600.0            # retention knee [s]
    # Mean fractional current droop per ln-decade (negative: loss), on
    # i_lo and Δi.
    drift_per_decade: float = -0.005
    # Device-to-device spread γ grows per ln-decade (fractional).
    gamma_per_decade: float = 0.008
    # Read-disturb accumulation: σ_read grows per ln-decade [µA].
    read_sigma_per_decade: float = 0.004
    # Imprint: an additive per-device Gaussian Vth walk of this RMS per
    # ln-decade [µA]; the axis that moves each cell's mean offset away
    # from its calibration-time value.
    imprint_per_decade: float = 0.06
    # Per-die spread of all four rates around their means.
    rate_spread: float = 0.3


def die_rates(device_seed: int, noise_seed: int,
              spec: AgingSpec | None = None
              ) -> tuple[float, float, float, float]:
    """(drift, γ growth, σ_read growth, imprint) rates per ln-decade for
    one die, keyed only by its serialized seeds."""
    spec = spec or AgingSpec()
    rng = np.random.default_rng(
        (int(device_seed) ^ _SEED_AGE, int(noise_seed), _SEED_AGE))
    z = rng.standard_normal(4)
    drift = spec.drift_per_decade * (1.0 + spec.rate_spread * z[0])
    gamma = abs(spec.gamma_per_decade * (1.0 + spec.rate_spread * z[1]))
    read = abs(spec.read_sigma_per_decade * (1.0 + spec.rate_spread * z[2]))
    imprint = abs(spec.imprint_per_decade * (1.0 + spec.rate_spread * z[3]))
    return float(drift), float(gamma), float(read), float(imprint)


def age_factors(chip, t_s: float, spec: AgingSpec | None = None
                ) -> tuple[float, float, float, float]:
    """(f_drift, f_gamma, d_read_sigma, d_imprint) at age ``t_s``:
    multiplier, multiplier, additive µA, additive µA RMS; exactly
    (1.0, 1.0, 0.0, 0.0) at t = 0."""
    spec = spec or AgingSpec()
    dec = dev.retention_decades(float(t_s), spec.t0_s)
    drift, gamma, read, imprint = die_rates(
        chip.device_seed, chip.noise_seed, spec)
    return 1.0 + drift * dec, 1.0 + gamma * dec, read * dec, imprint * dec


def at_age(chip, t_s: float, spec: AgingSpec | None = None):
    """``chip`` (a birth-state ChipInstance) after ``t_s`` field seconds,
    as a new frozen instance.  Ages are absolute, never compounded:
    an already-aged input raises."""
    if getattr(chip, "age_s", 0.0) != 0.0:
        raise ValueError(
            f"at_age expects the birth (age-0) instance; this die is "
            f"already at age {chip.age_s:g}s — keep the birth instance "
            f"and call birth.at_age(t) with absolute t")
    t_s = float(t_s)
    if t_s == 0.0:
        return chip
    f_drift, f_gamma, d_read, d_imprint = age_factors(chip, t_s, spec)
    return dataclasses.replace(
        chip,
        f_i_lo=chip.f_i_lo * f_drift,
        f_delta_i=chip.f_delta_i * f_drift,
        f_gamma=chip.f_gamma * f_gamma,
        read_sigma=chip.read_sigma + d_read,
        imprint=chip.imprint + d_imprint,
        age_s=t_s)
