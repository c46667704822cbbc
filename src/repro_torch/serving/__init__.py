"""Adaptive-fidelity SAR serving (port of ``repro/serving``).

  engine    continuous-batching scheduler (slots, admission, retirement)
  adaptive  incremental predictive stats + escalation stream
  triage    the paper's Fig. 1 accept / escalate / flag policy
  metrics   per-request latency, samples/decision, energy accounting
"""

from repro_torch.serving.adaptive import (escalation_schedule, finalize,
                                          init_stats, stream_indices,
                                          stream_selections, update_stats)
from repro_torch.serving.engine import Request, SarServingEngine
from repro_torch.serving.metrics import (DecisionCost, RequestRecord,
                                         ServingMetrics, decision_cost,
                                         decision_energy, decision_latency,
                                         energy_terms, request_energy)
from repro_torch.serving.triage import (ACCEPT, ESCALATE, FLAG,
                                        TriagePolicy, decide,
                                        fixed_r_decide)

__all__ = [
    "ACCEPT", "DecisionCost", "ESCALATE", "FLAG", "Request",
    "RequestRecord", "SarServingEngine", "ServingMetrics", "TriagePolicy",
    "decide", "decision_cost", "decision_energy", "decision_latency",
    "energy_terms", "escalation_schedule", "finalize", "fixed_r_decide",
    "init_stats", "request_energy", "stream_indices", "stream_selections",
    "update_stats",
]
