"""Hardware model of the port (mirrors ``repro/hw``): the tile compiler
(``tilemap.py``), the FeFET nonideality model (``device.py``), sampled
chip instances (``instance.py``) and per-chip calibration
(``calib.py``)."""

from repro_torch.hw.calib import measured_grng, prepare_instance_head
from repro_torch.hw.device import (VariationSpec, degraded_grng,
                                   drift_factor)
from repro_torch.hw.instance import (ChipInstance, golden_instance,
                                     sample_instances)
from repro_torch.hw.tilemap import (Placement, TileGrid, TileProgram,
                                    compile_layer, compile_network)

__all__ = ["ChipInstance", "Placement", "TileGrid", "TileProgram",
           "VariationSpec", "compile_layer", "compile_network",
           "degraded_grng", "drift_factor", "golden_instance",
           "measured_grng", "prepare_instance_head", "sample_instances"]
