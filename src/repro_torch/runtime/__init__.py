"""Runtime policies of the trainer (mirrors ``repro/runtime``): the
straggler monitor.  ``elastic`` (re-meshing a train state over fewer
devices after a failure) has no twin on one card: it waits for more
than one GPU (ROADMAP A10)."""

from repro_torch.runtime.straggler import StragglerConfig, StragglerMonitor

__all__ = ["StragglerConfig", "StragglerMonitor"]
