"""Observability of the port (mirrors ``repro/obs``):

  telemetry  counters, histograms and GRNG probe moments as device
             tensors updated in place by the rounds; one pull to read
  drift      streaming z-test of the probe's moments against the
             deployment's calibration-time belief; recalibration
             advisories
  alerts     one typed advisory stream (drift, heal; SLO burn and
             backpressure take None until obs/slo and the fleet land)
  log        structured logger (REPRO_LOG_LEVEL / REPRO_LOG_JSON)

Tracing, profiling, SLO tracking and the metric exporters wait for a
later slice.
"""

from repro_torch.obs.alerts import Advisory, AlertBus
from repro_torch.obs.drift import (DriftGate, DriftMonitor, DriftReference,
                                   DriftStatus, drift_status, reference_for)
from repro_torch.obs.log import get_logger
from repro_torch.obs.telemetry import (TelemetryConfig, count_dispatch,
                                       init_telemetry, merge_snapshots,
                                       record_decisions, record_round,
                                       snapshot)

__all__ = [
    "Advisory", "AlertBus", "DriftGate", "DriftMonitor", "DriftReference",
    "DriftStatus", "TelemetryConfig", "count_dispatch", "drift_status",
    "get_logger", "init_telemetry", "merge_snapshots", "record_decisions",
    "record_round", "reference_for", "snapshot",
]
