"""Analytic hardware energy model (port of the parts of
``repro/core/energy.py`` that serving metrics and the tile compiler
call; paper §V-A, Table I).

Pure Python: the paper's component constants and the logical tile
count of a layer.  Units: joules, seconds, mm².
"""

from __future__ import annotations

import dataclasses
import math

# PAPER constants (§III, §V-A, Table I)
GRNG_ENERGY_PER_SAMPLE = 640e-18        # 640 aJ/sample incl. selection
TILE_MVM_ENERGY = 688e-12               # full-tile MVM, worst case
SIGMA_MVM_ENERGY = 230e-12              # σε-subarray-only MVM
TILE_AREA_MM2 = 0.0964
TILE_DIM = 64                           # 64×64 subarrays
COMPUTE_DENSITY_TOPS_MM2 = 1.27
DEPLOY_R = 20                           # samples per inference

# DEDUCED: compute density 1.27 TOPS/mm² over 2 subarrays × 2·64² ops
# implies an effective MVM latency of ~134 ns.
TILE_OPS_PER_MVM = 2 * 2 * TILE_DIM * TILE_DIM
MVM_LATENCY = TILE_OPS_PER_MVM / (COMPUTE_DENSITY_TOPS_MM2 * 1e12
                                  * TILE_AREA_MM2)


def tile_efficiency_tops_w() -> float:
    """2·64² MACs in each subarray per MVM over the measured energies
    (≈ 17.8 TOPS/W, Table I)."""
    return TILE_OPS_PER_MVM / (TILE_MVM_ENERGY + SIGMA_MVM_ENERGY) / 1e12


def efficiency_density() -> float:
    """TOPS/W/mm² headline: tile efficiency / tile area ≈ 185."""
    return tile_efficiency_tops_w() / TILE_AREA_MM2


@dataclasses.dataclass(frozen=True)
class LayerShape:
    d_in: int
    d_out: int
    bayesian: bool = False


def tiles_for_layer(l: LayerShape) -> int:
    return math.ceil(l.d_in / TILE_DIM) * math.ceil(l.d_out / TILE_DIM)
