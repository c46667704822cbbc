"""Analytic hardware energy/latency/area model (port of
``repro/core/energy.py``; paper §V-A, Table I).

The paper's energy claims are reproduced analytically from its own
component constants.  Quantities the paper states directly are tagged
PAPER; quantities deduced to make the numbers mutually consistent are
tagged DEDUCED (with the derivation).  Pure Python ``math``: every
function equals the reference's to the last bit.

Units: joules, seconds, mm², unless suffixed.
"""

from __future__ import annotations

import dataclasses
import math

# ----------------------------------------------------------------------
# PAPER constants (§III, §V-A, Table I)
# ----------------------------------------------------------------------
GRNG_ENERGY_PER_SAMPLE = 640e-18        # PAPER: 640 aJ/sample incl. selection
GRNG_SELECTION_SHARE = 134e-18          # PAPER: amortized selection logic
SELECTION_BLOCK_ENERGY_PER_CYCLE = 550e-15  # PAPER: global selector, 550 fJ
TILE_MVM_ENERGY = 688e-12               # PAPER: full-tile MVM, worst case
SIGMA_MVM_ENERGY = 230e-12              # PAPER: σε-subarray-only MVM
ADC_READ_ENERGY_SHARE = 0.99            # PAPER: ADCs = 99 % of read energy
GRNG_TILE_ENERGY_SHARE = 0.004          # PAPER: GRNG = 0.4 % of tile energy
GRNG_SIGMA_ENERGY_SHARE = 0.007         # PAPER: 0.7 % of σε-only energy
ADC_EFF_PER_CONV_STEP = 14e-15          # PAPER: 14 fJ/conv-step, 6-bit SAR
WRITE_ENERGY_MU = 92.7e-12              # PAPER: µ subarray write @4.0 V
WRITE_ENERGY_SIGMA = 46.3e-12           # PAPER: σε subarray write
TILE_AREA_MM2 = 0.0964                  # PAPER
SIGMA_SUBARRAY_AREA_SHARE = 0.601       # PAPER: σε subarray share of tile
SIGMA_BITCELL_AREA_SHARE = 0.631        # PAPER: bitcells within σε subarray
GRNG_CELL_AREA_SHARE = 0.361            # PAPER: GRNG cells within σε subarray
MU_CELL_AREA_SHARE = 0.102              # PAPER: µ cells within µ subarray
GRNG_AREA_UM2 = 5.11                    # PAPER: Table I
TILE_EFFICIENCY_TOPS_W = 17.8           # PAPER: Table I
COMPUTE_DENSITY_TOPS_MM2 = 1.27         # PAPER: Table I
EFFICIENCY_DENSITY = 185.0              # PAPER: title, TOPS/W/mm²
GRNG_THROUGHPUT_GSAS = 40.96            # PAPER: Table I
CLOCK_HZ = 100e6                        # PAPER: both subarrays at 100 MHz
TILE_DIM = 64                           # PAPER: 64×64 subarrays
DIGITAL_BNN_OVERHEAD_PER_R = 6.2        # PAPER: 6.2·R× vs INT8 deterministic [20]
OFFSET_COMP_E0, OFFSET_COMP_E1 = 54e-12, 458e-12    # PAPER: 54 + 458·N pJ
OFFSET_COMP_T0, OFFSET_COMP_T1 = 12.8e-6, 0.64e-6   # PAPER: 12.8 + 0.64·N µs
ENDURANCE_CYCLES_OPTIMISTIC = 1e12      # PAPER: generous FeFET endurance
RANGE_COLLAPSE_CYCLES = 30_000          # PAPER: 50 % output-range collapse
FEFET_WRITE_TIME = 100e-9               # PAPER: 100 ns write
SOTA_GRNG_ENERGY = 360e-15              # PAPER: [12], 360 fJ/Sa -> 560× claim

# Paper §V-B deployment (YOLO26n + Bayesian last layer)
DEPLOY_BAYES_TILES = 24                 # PAPER
DEPLOY_MU_SUBARRAYS = 1659              # PAPER
DEPLOY_AREA_MM2 = 76.0                  # PAPER
DEPLOY_ENERGY_J = 3.70e-3               # PAPER: end-to-end macro energy
DEPLOY_LATENCY_S = 13.8e-3              # PAPER: 72.2 FPS
DEPLOY_POWER_24FPS_W = 88.7e-3          # PAPER
DEPLOY_R = 20                           # PAPER: samples per inference

# ----------------------------------------------------------------------
# DEDUCED constants (derivations in comments; validated in benchmarks)
# ----------------------------------------------------------------------
# GRNG throughput 40.96 GSa/s over 64×64=4096 concurrent cells implies a
# 100 ns sample period (10 cycles @ 100 MHz — the SAR conversion pipeline):
#     4096 cells / 100 ns = 40.96 GSa/s.
GRNG_SAMPLE_PERIOD = TILE_DIM * TILE_DIM / (GRNG_THROUGHPUT_GSAS * 1e9)
# Compute density 1.27 TOPS/mm² over 2 subarrays × 2·64² ops implies an
# effective MVM latency of ~134 ns (ADC + accumulation pipeline):
#     16384 ops / (1.27e12 ops/s/mm² × 0.0964 mm²) = 133.8 ns.
TILE_OPS_PER_MVM = 2 * 2 * TILE_DIM * TILE_DIM   # both subarrays, MAC=2 ops
MVM_LATENCY = TILE_OPS_PER_MVM / (COMPUTE_DENSITY_TOPS_MM2 * 1e12 * TILE_AREA_MM2)


# ----------------------------------------------------------------------
# Derived / cross-checked quantities
# ----------------------------------------------------------------------
def tile_efficiency_tops_w() -> float:
    """2·64² MACs in each subarray per MVM over the measured energies.

    (688 + 230) pJ for a concurrent µ + σε MVM -> 17.8 TOPS/W (Table I).
    """
    return TILE_OPS_PER_MVM / (TILE_MVM_ENERGY + SIGMA_MVM_ENERGY) / 1e12


def efficiency_density() -> float:
    """TOPS/W/mm² headline: tile efficiency / tile area ≈ 185."""
    return tile_efficiency_tops_w() / TILE_AREA_MM2


def grng_throughput_gsas() -> float:
    return TILE_DIM * TILE_DIM / GRNG_SAMPLE_PERIOD / 1e9


def grng_energy_improvement() -> float:
    """vs SOTA BNN GRNG [12]: 360 fJ / 640 aJ = 562×."""
    return SOTA_GRNG_ENERGY / GRNG_ENERGY_PER_SAMPLE


def adc_energy_per_mvm(bits: int = 6, columns: int = TILE_DIM) -> float:
    """SAR ADC energy: 14 fJ/conv-step × 2^bits steps × columns."""
    return ADC_EFF_PER_CONV_STEP * (2**bits) * columns


def offset_compensation_cost(n_samples: int) -> tuple[float, float]:
    """(energy J, time s) of §III-B1 calibration with N samples."""
    return (OFFSET_COMP_E0 + OFFSET_COMP_E1 * n_samples,
            OFFSET_COMP_T0 + OFFSET_COMP_T1 * n_samples)


def endurance_hours(write_rate_hz: float,
                    endurance_cycles: float = ENDURANCE_CYCLES_OPTIMISTIC) -> float:
    """Lifetime of a REWRITE-based GRNG (paper §III-B: ~30 h at 10 MHz)."""
    return endurance_cycles / write_rate_hz / 3600.0


def writefree_lifetime_hours() -> float:
    return math.inf  # the point of the paper


# ----------------------------------------------------------------------
# Deployment model: map a network onto tiles (paper §V-B1)
# ----------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class LayerShape:
    d_in: int
    d_out: int
    bayesian: bool = False


def tiles_for_layer(l: LayerShape) -> int:
    return math.ceil(l.d_in / TILE_DIM) * math.ceil(l.d_out / TILE_DIM)


def inference_energy(layers: list[LayerShape], r_samples: int = DEPLOY_R,
                     batch: int = 1) -> dict:
    """Analytic energy/latency for one batched inference.

    Deterministic layers: one µ-subarray MVM per tile per input.
    Bayesian layers: one µ MVM + r σε MVMs per tile per input (the
    σε subarray re-samples; X·µ is computed once — paper §IV).
    """
    e_det = e_bayes = 0.0
    t_serial = 0.0
    n_grng_samples = 0
    for l in layers:
        nt = tiles_for_layer(l)
        if l.bayesian:
            e_bayes += batch * nt * (TILE_MVM_ENERGY + r_samples * SIGMA_MVM_ENERGY)
            t_serial += (1 + r_samples) * MVM_LATENCY
            n_grng_samples += batch * nt * TILE_DIM * TILE_DIM * r_samples
        else:
            e_det += batch * nt * TILE_MVM_ENERGY
            t_serial += MVM_LATENCY
    total = e_det + e_bayes
    return {
        "energy_J": total,
        "energy_det_J": e_det,
        "energy_bayes_J": e_bayes,
        "latency_s": t_serial,           # tiles within a layer are parallel
        "grng_samples": n_grng_samples,
        "grng_energy_J": n_grng_samples * GRNG_ENERGY_PER_SAMPLE,
    }


def grid_inference_energy(*, n_det_tiles: int, n_bayes_tiles: int,
                          r_samples: int = DEPLOY_R, batch: int = 1,
                          n_passes: int = 1, n_bayes_passes: int = 1,
                          physical_tiles: int | None = None,
                          utilization: float = 1.0,
                          r_latency: int | None = None) -> dict:
    """Tile-compiler-aware energy/latency/area (hw/tilemap.py reports).

    Unlike ``inference_energy`` (which counts *logical* tiles per
    layer), this takes the compiler's placed-block counts, so padding
    waste inside partially-filled tiles is charged — a placed block
    burns a full tile MVM regardless of how many cells it maps.  Passes
    serialize: a time-multiplexed network pays one MVM latency per pass
    plus ``r_latency`` serial σε re-reads for every pass containing
    Bayesian blocks (``r_latency`` < r_samples when the compiler
    replicated Bayesian blocks into free tiles: the R samples split
    across concurrent replicas, same total energy, shorter serial
    chain).  Area is the *physical* tiles allocated; the headline
    TOPS/W/mm² scales by the compiler's utilization — the deployed
    number, vs Table I's ideal 185.
    """
    e_det = batch * n_det_tiles * TILE_MVM_ENERGY
    e_bayes = batch * n_bayes_tiles * (
        TILE_MVM_ENERGY + r_samples * SIGMA_MVM_ENERGY)
    grng_samples = batch * n_bayes_tiles * TILE_DIM**2 * r_samples
    phys = (physical_tiles if physical_tiles is not None
            else n_det_tiles + n_bayes_tiles)
    r_lat = r_samples if r_latency is None else r_latency
    latency = (n_passes + r_lat * n_bayes_passes) * MVM_LATENCY
    return {
        "energy_J": e_det + e_bayes,
        "energy_det_J": e_det,
        "energy_bayes_J": e_bayes,
        "grng_samples": grng_samples,
        "grng_energy_J": grng_samples * GRNG_ENERGY_PER_SAMPLE,
        "latency_s": latency,
        "area_mm2": phys * TILE_AREA_MM2,
        "utilization": utilization,
        "tops_w_mm2_effective": efficiency_density() * utilization,
    }


def digital_baseline_energy(layers: list[LayerShape], r_samples: int = DEPLOY_R,
                            batch: int = 1) -> float:
    """SOTA digital BNN cost model: 6.2·R× per op on Bayesian layers [20]."""
    int8_op = TILE_MVM_ENERGY / (2 * TILE_DIM * TILE_DIM)  # per-MAC from our tile
    e = 0.0
    for l in layers:
        macs = batch * l.d_in * l.d_out
        mult = DIGITAL_BNN_OVERHEAD_PER_R * r_samples if l.bayesian else 1.0
        e += macs * 2 * int8_op * mult
    return e
