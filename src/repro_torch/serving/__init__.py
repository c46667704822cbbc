"""Adaptive-fidelity serving (port of ``repro/serving``).

  engine    continuous-batching schedulers (slots, admission, retirement):
            SarServingEngine (image patches), LMServingEngine (tokens)
  fleet     SarServingFleet: SAR pools behind a least-loaded router, one
            pull a tick
  adaptive  incremental predictive stats + escalation stream
  triage    the paper's Fig. 1 accept / escalate / flag policy
  metrics   per-request latency, samples/decision, energy accounting
  load      seeded arrival processes driving an engine or a fleet
            open-loop
"""

from repro_torch.serving.adaptive import (escalation_schedule, finalize,
                                          init_stats, stream_indices,
                                          stream_selections, update_stats,
                                          update_stats_streamed)
from repro_torch.serving.engine import (LMServingEngine, Request,
                                        SarServingEngine)
from repro_torch.serving.fleet import SarServingFleet
from repro_torch.serving.load import ArrivalSpec, run_open_loop
from repro_torch.serving.metrics import (DecisionCost, RequestRecord,
                                         ServingMetrics, decision_cost,
                                         decision_energy, decision_latency,
                                         energy_terms, request_energy)
from repro_torch.serving.triage import (ACCEPT, ESCALATE, FLAG,
                                        TriagePolicy, decide,
                                        fixed_r_decide)

__all__ = [
    "ACCEPT", "ArrivalSpec", "DecisionCost", "ESCALATE", "FLAG",
    "LMServingEngine", "Request",
    "RequestRecord", "SarServingEngine", "SarServingFleet",
    "ServingMetrics", "TriagePolicy",
    "decide", "decision_cost", "decision_energy", "decision_latency",
    "energy_terms", "escalation_schedule", "finalize", "fixed_r_decide",
    "init_stats", "request_energy", "run_open_loop", "stream_indices",
    "stream_selections", "update_stats", "update_stats_streamed",
]
