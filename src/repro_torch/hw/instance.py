"""Sampled chip instances (port of ``repro/hw/instance.py``).

A ``ChipInstance`` is everything that distinguishes one physical die
from the golden model: the programming draw of its GRNG arrays (a seed),
its process corner, operating temperature, read-noise magnitude,
per-column ADC errors and the conductance programming error of
everything written to it.  Dies are drawn with numpy's
``default_rng(seed)`` by the same code as the reference, so both
packages draw the same dies field for field, and are immutable
afterwards.

``at_age`` and ``save_instances``/``load_instances`` wait for the
lifetime and checkpoint slices; ``to_tree``/``from_tree`` carry a die as
a dict of numpy arrays (``bridge.instance_from_tree`` takes the
reference's).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.clt_grng import GRNGConfig
from repro_torch.core.hashing import gaussianish, hash3
from repro_torch.hw import device as dev

# Tags mixed into per-chip hash seeds so chip streams never collide with
# the golden chip's (seed 0xC1A0) or each other's.
_SEED_DEVICE = 0xD1E0
_SEED_NOISE = 0x0A15
_SEED_WEIGHT = 0x3E17
_SEED_IMPRINT = 0x16B1
# Physical ADC columns of one array tile; ``adc_columns`` tiles their
# front ends over a layer's logical output columns.
_ADC_COLUMNS = 64


@dataclasses.dataclass(frozen=True, eq=False)
class ChipInstance:
    """One die.  Scalars are its frozen corner draw; ``adc_gain`` /
    ``adc_offset`` are per-physical-column ([_ADC_COLUMNS]) arrays tiled
    over logical output columns by ``adc_columns``."""
    chip_id: int
    device_seed: int            # GRNG array programming draw
    noise_seed: int             # cycle-to-cycle read-noise stream
    weight_seed: int            # conductance programming-error draw
    f_i_lo: float = 1.0
    f_delta_i: float = 1.0
    f_gamma: float = 1.0
    temp_c: float = dev.T_NOMINAL_C
    tc_current: float = 0.0
    read_sigma: float = 0.0
    program_sigma: float = 0.0
    age_s: float = 0.0          # simulated seconds since programming
    imprint: float = 0.0        # accumulated Vth-walk RMS [µA] at age_s
    adc_gain: np.ndarray = dataclasses.field(
        default_factory=lambda: np.ones((_ADC_COLUMNS,), np.float32))
    adc_offset: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros((_ADC_COLUMNS,), np.float32))

    def grng(self, base: GRNGConfig) -> GRNGConfig:
        """This chip's physical GRNG config at its operating point
        (uncalibrated view: nominal standardization constants)."""
        return dev.degraded_grng(
            base, device_seed=self.device_seed, noise_seed=self.noise_seed,
            f_i_lo=self.f_i_lo, f_delta_i=self.f_delta_i,
            f_gamma=self.f_gamma,
            drift=dev.drift_factor(self.tc_current, self.temp_c),
            read_sigma=self.read_sigma,
            imprint=self.imprint,
            # an un-aged die keeps the base seed, so that a golden die's
            # config equals the golden config
            imprint_seed=(self.device_seed ^ _SEED_IMPRINT
                          if self.imprint else None))

    def program_weights(self, w: torch.Tensor, tag: int = 0) -> torch.Tensor:
        """Conductance programming error: w·(1 + σ_p·ν(k,n)), with ν
        hash-frozen per (cell, tag): writing the same matrix to the same
        array twice lands on the same conductances; ``tag`` tells
        co-located arrays apart (µ 0, σε 1, conv trunk 16 + layer)."""
        if self.program_sigma == 0.0:
            return w
        rows = torch.arange(w.shape[0], dtype=torch.int64,
                            device=w.device)[:, None]
        cols = torch.arange(w.shape[1], dtype=torch.int64,
                            device=w.device)[None, :]
        h = hash3(rows, cols, tag, self.weight_seed)
        return w * (1.0 + self.program_sigma * gaussianish(h)).to(w.dtype)

    def adc_columns(self, n_cols: int) -> tuple[np.ndarray, np.ndarray]:
        """(gain [n_cols], offset [n_cols]): the 64 physical column
        front ends tiled over the logical output columns."""
        reps = -(-n_cols // self.adc_gain.shape[0])
        return (np.tile(self.adc_gain, reps)[:n_cols],
                np.tile(self.adc_offset, reps)[:n_cols])

    def to_tree(self) -> dict:
        return {f.name: np.asarray(getattr(self, f.name))
                for f in dataclasses.fields(self)}

    @classmethod
    def from_tree(cls, tree: dict) -> "ChipInstance":
        kw = {}
        for f in dataclasses.fields(cls):
            if f.name not in tree:
                continue            # a field newer than the tree: default
            v = np.asarray(tree[f.name])
            if v.ndim == 0:
                v = v.item()
            kw[f.name] = v
        return cls(**kw)


def golden_instance() -> ChipInstance:
    """The characterized die itself: every nonideality zero and the
    golden config's hash seeds, so the instance path reproduces the
    golden path bit for bit."""
    base = GRNGConfig()
    return ChipInstance(chip_id=-1, device_seed=base.seed,
                        noise_seed=base.noise_seed, weight_seed=_SEED_WEIGHT)


def sample_instances(seed: int, n: int,
                     spec: dev.VariationSpec | None = None
                     ) -> tuple[ChipInstance, ...]:
    """Draw ``n`` frozen chip instances from the population ``spec``
    (numpy ``default_rng(seed)``, draw for draw as the reference), each
    with ``_ADC_COLUMNS`` physical column front ends."""
    spec = spec or dev.VariationSpec()
    tile = _ADC_COLUMNS
    rng = np.random.default_rng(seed)
    chips = []
    for i in range(n):
        sd = rng.integers(0, 2**31 - 1, size=3)
        chips.append(ChipInstance(
            chip_id=i,
            device_seed=int(sd[0]) ^ _SEED_DEVICE,
            noise_seed=int(sd[1]) ^ _SEED_NOISE,
            weight_seed=int(sd[2]) ^ _SEED_WEIGHT,
            f_i_lo=float(1.0 + spec.sigma_i_lo * rng.standard_normal()),
            f_delta_i=float(1.0 + spec.sigma_delta_i * rng.standard_normal()),
            f_gamma=float(abs(1.0 + spec.sigma_gamma * rng.standard_normal())),
            temp_c=float(spec.temp_mean_c
                         + spec.temp_spread_c * rng.standard_normal()),
            tc_current=spec.tc_current,
            read_sigma=float(abs(rng.normal(
                spec.read_sigma_mean,
                spec.read_sigma_mean * spec.read_sigma_spread))),
            program_sigma=spec.program_sigma,
            adc_gain=(1.0 + spec.adc_gain_sigma
                      * rng.standard_normal(tile)).astype(np.float32),
            adc_offset=(spec.adc_offset_sigma_lsb
                        * rng.standard_normal(tile)).astype(np.float32),
        ))
    return tuple(chips)
