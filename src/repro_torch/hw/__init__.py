"""Hardware model of the port (mirrors ``repro/hw``): the tile compiler
(``tilemap.py``), the FeFET nonideality model (``device.py``), sampled
chip instances (``instance.py``), per-chip calibration (``calib.py``),
aging in the field (``aging.py``) and recalibrate-and-redeploy
(``redeploy.py``)."""

from repro_torch.hw.aging import AgingSpec, age_factors, at_age, die_rates
from repro_torch.hw.calib import (CalibrationReport, calibration_report,
                                  measured_grng, prepare_instance_head)
from repro_torch.hw.device import (VariationSpec, degraded_grng,
                                   drift_factor, retention_decades)
from repro_torch.hw.instance import (ChipInstance, golden_instance,
                                     load_instances, sample_instances,
                                     save_instances)
from repro_torch.hw.redeploy import (HealEvent, LifetimeConfig,
                                     SelfHealingController,
                                     aged_belief_view, recalibrate)
from repro_torch.hw.tilemap import (Placement, TileGrid, TileProgram,
                                    compile_layer, compile_network,
                                    shard_column_partition)

__all__ = [
    "AgingSpec", "CalibrationReport", "ChipInstance", "HealEvent",
    "LifetimeConfig", "Placement", "SelfHealingController", "TileGrid",
    "TileProgram", "VariationSpec", "age_factors", "aged_belief_view",
    "at_age", "calibration_report", "compile_layer", "compile_network",
    "degraded_grng", "die_rates", "drift_factor", "golden_instance",
    "load_instances", "measured_grng", "prepare_instance_head",
    "recalibrate", "retention_decades", "sample_instances",
    "save_instances", "shard_column_partition",
]
