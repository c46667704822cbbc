"""Observability of the port (mirrors ``repro/obs``):

  telemetry  counters, histograms and GRNG probe moments as device
             tensors updated in place by the rounds; one pull to read
  drift      streaming z-test of the probe's moments against the
             deployment's calibration-time belief; recalibration
             advisories
  alerts     one typed advisory stream (drift, heal, SLO burn,
             backpressure)
  slo        time-to-verdict histograms, SLOs and their error budgets
  prof       stage profiler, build counters, kernel cost records,
             torch.profiler capture
  trace      request spans as a Chrome/Perfetto trace; mission_trace
  registry   Prometheus text and JSON exporters
  log        structured logger (REPRO_LOG_LEVEL / REPRO_LOG_JSON)
"""

from repro_torch.obs.alerts import Advisory, AlertBus
from repro_torch.obs.drift import (DriftGate, DriftMonitor, DriftReference,
                                   DriftStatus, drift_status, reference_for)
from repro_torch.obs.log import get_logger
from repro_torch.obs.prof import (NULL_PROFILER, SERVING_STAGES,
                                  StageProfiler, builder_builds,
                                  compile_counters, compiled_cost,
                                  trace_capture)
from repro_torch.obs.registry import (MetricsRegistry, mission_registry,
                                      quantile, serving_registry)
from repro_torch.obs.slo import NULL_SLO, SLO, SloTracker
from repro_torch.obs.telemetry import (TelemetryConfig, count_dispatch,
                                       init_telemetry, merge_snapshots,
                                       record_decisions, record_round,
                                       snapshot)
from repro_torch.obs.trace import NULL_TRACER, Tracer, mission_trace

__all__ = [
    "Advisory", "AlertBus", "DriftGate", "DriftMonitor",
    "DriftReference", "DriftStatus", "MetricsRegistry", "NULL_PROFILER",
    "NULL_SLO", "NULL_TRACER", "SERVING_STAGES", "SLO", "SloTracker",
    "StageProfiler", "TelemetryConfig", "Tracer", "builder_builds",
    "compile_counters", "compiled_cost", "count_dispatch",
    "drift_status", "get_logger", "init_telemetry", "merge_snapshots",
    "mission_registry", "mission_trace", "quantile", "record_decisions",
    "record_round", "reference_for", "serving_registry", "snapshot",
    "trace_capture",
]
