"""Hardware model of the port: the tile compiler (``tilemap.py``)."""

from repro_torch.hw.tilemap import (Placement, TileGrid, TileProgram,
                                    compile_layer, compile_network)

__all__ = ["Placement", "TileGrid", "TileProgram", "compile_layer",
           "compile_network"]
