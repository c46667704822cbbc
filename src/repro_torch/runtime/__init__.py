"""Runtime policies of the trainer (mirrors ``repro/runtime``): the
straggler monitor and elastic re-meshing of a train state over fewer
devices (mesh coordinates) after a failure."""

from repro_torch.runtime.elastic import (make_elastic_mesh,
                                         remesh_train_state, remesh_tree,
                                         shrink_mesh)
from repro_torch.runtime.straggler import StragglerConfig, StragglerMonitor

__all__ = ["StragglerConfig", "StragglerMonitor", "make_elastic_mesh",
           "remesh_train_state", "remesh_tree", "shrink_mesh"]
