"""Metric registry with Prometheus-text and JSON exporters (port of
``repro/obs/registry.py``; plain Python, its own copy).

"Export" means writing the standard Prometheus text exposition format
(and a JSON twin) to files that operators can scrape or diff; nothing
here talks to a network.  Histograms are emitted with cumulative
``_bucket{le=...}`` counts per the exposition spec; ``_sum`` is
approximated from bin midpoints unless the true total is given.  Given
the same input dicts, every exporter writes the reference's text and
JSON byte for byte.

Two exporters know the port's own keys besides the reference's:
``add_compile_counters`` exports ``nvcc_builds``/``nvcc_seconds`` and
writes the XLA counters only when the input carries them (the port's
``obs.prof.compile_counters`` has none: no XLA runs here), and
``add_compiled_costs`` also exports a kernel record's launches, hash3
count and bound (``obs.prof.compiled_cost``).
"""

from __future__ import annotations

import json
import math
from typing import Any

_BAD = {ord(c): "_" for c in "-. /"}


def _name(n: str) -> str:
    return n.translate(_BAD)


def _escape(v: Any) -> str:
    """Escape a label VALUE per the exposition spec: backslash, double
    quote, and newline must be backslash-escaped inside the quotes."""
    return (str(v).replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", "\\n"))


def _labels(labels: dict[str, Any]) -> str:
    if not labels:
        return ""
    inner = ",".join(f'{_name(str(k))}="{_escape(v)}"'
                     for k, v in labels.items())
    return "{" + inner + "}"


def _fmt(v: float) -> str:
    if isinstance(v, float) and math.isnan(v):
        return "NaN"
    if v == float("inf"):
        return "+Inf"
    return repr(float(v)) if isinstance(v, float) else str(v)


class MetricsRegistry:
    """Ordered collection of counters, gauges, and histograms."""

    def __init__(self, namespace: str = "repro"):
        self.namespace = namespace
        self._metrics: list[dict[str, Any]] = []

    def _add(self, kind: str, name: str, value, help_: str,
             labels: dict[str, Any]) -> None:
        self._metrics.append({
            "kind": kind, "name": f"{self.namespace}_{_name(name)}",
            "value": value, "help": help_, "labels": dict(labels or {})})

    def counter(self, name: str, value: float, help: str = "",
                **labels) -> None:
        self._add("counter", name, float(value), help, labels)

    def gauge(self, name: str, value: float, help: str = "",
              **labels) -> None:
        self._add("gauge", name, float(value), help, labels)

    def histogram(self, name: str, counts: list, edges: list,
                  help: str = "", overflow: int = 0, sum: float | None = None,
                  **labels) -> None:
        """``counts`` has len(edges)-1 bins; edges are ascending.

        ``overflow`` counts observations above the last edge (they land
        only in the ``+Inf`` bucket); ``sum`` overrides the midpoint
        approximation of ``_sum`` when the true total is known (e.g.
        StageProfiler tracks total_s exactly).  Non-finite bin counts
        (NaN propagated through a device histogram) sanitize to 0 so
        the exposition stays parseable."""
        clean = [int(c) if c == c and abs(c) != float("inf") else 0
                 for c in counts]
        self._add("histogram", name,
                  {"counts": clean,
                   "edges": [float(e) for e in edges],
                   "overflow": int(overflow),
                   "sum": None if sum is None else float(sum)},
                  help, labels)

    def to_json(self) -> dict[str, Any]:
        return {"namespace": self.namespace, "metrics": self._metrics}

    def to_prometheus(self) -> str:
        lines: list[str] = []
        seen_header: set[str] = set()
        for m in self._metrics:
            name, kind = m["name"], m["kind"]
            if name not in seen_header:
                if m["help"]:
                    lines.append(f"# HELP {name} {m['help']}")
                lines.append(f"# TYPE {name} {kind}")
                seen_header.add(name)
            if kind in ("counter", "gauge"):
                lines.append(f"{name}{_labels(m['labels'])} "
                             f"{_fmt(m['value'])}")
                continue
            counts, edges = m["value"]["counts"], m["value"]["edges"]
            over = m["value"].get("overflow", 0)
            cum, approx_sum = 0, 0.0
            for i, c in enumerate(counts):
                cum += c
                mid = 0.5 * (edges[i] + edges[i + 1])
                if math.isfinite(mid):
                    approx_sum += c * mid
                lb = dict(m["labels"]);  lb["le"] = _fmt(float(edges[i + 1]))
                lines.append(f"{name}_bucket{_labels(lb)} {cum}")
            total = cum + over
            if over and edges and math.isfinite(edges[-1]):
                approx_sum += over * edges[-1]
            lb = dict(m["labels"]);  lb["le"] = "+Inf"
            lines.append(f"{name}_bucket{_labels(lb)} {total}")
            true_sum = m["value"].get("sum")
            lines.append(f"{name}_sum{_labels(m['labels'])} "
                         f"{_fmt(approx_sum if true_sum is None else true_sum)}")
            lines.append(f"{name}_count{_labels(m['labels'])} {total}")
        return "\n".join(lines) + "\n"

    def write(self, prefix: str) -> tuple[str, str]:
        """Write ``<prefix>.prom`` and ``<prefix>.json``; return paths."""
        import os
        d = os.path.dirname(prefix)
        if d:
            os.makedirs(d, exist_ok=True)
        prom, js = f"{prefix}.prom", f"{prefix}.json"
        with open(prom, "w") as f:
            f.write(self.to_prometheus())
        with open(js, "w") as f:
            json.dump(self.to_json(), f, indent=2)
        return prom, js


def quantile(hist: dict[str, Any], q: float) -> float:
    """Estimate the ``q``-quantile (0..1) of a binned histogram.

    ``hist`` is the shared snapshot shape: ``counts`` (len(edges)-1
    bins), ``edges`` (ascending), optional ``overflow`` above the last
    edge.  Within the landing bin the mass is interpolated
    geometrically when both edges are positive (the edges are
    log-spaced, so log-linear interpolation is the unbiased choice),
    linearly otherwise.  Overflow mass resolves to the last edge — a
    deliberate underestimate that keeps the readout monotone.  NaN on
    an empty histogram.
    """
    counts = [float(c) for c in hist["counts"]]
    edges = [float(e) for e in hist["edges"]]
    over = float(hist.get("overflow", 0))
    total = sum(counts) + over
    if total <= 0:
        return float("nan")
    target = min(max(float(q), 0.0), 1.0) * total
    cum = 0.0
    for i, c in enumerate(counts):
        if c > 0 and cum + c >= target:
            frac = (target - cum) / c
            lo, hi = edges[i], edges[i + 1]
            if lo > 0 and hi > 0:
                return lo * (hi / lo) ** frac
            return lo + (hi - lo) * frac
        cum += c
    return edges[-1]


def add_summary(reg: MetricsRegistry, summary: dict[str, Any],
                **labels) -> None:
    """Map a ServingMetrics / mission summary's scalars to gauges."""
    for k, v in summary.items():
        if isinstance(v, bool) or not isinstance(v, (int, float)):
            continue
        reg.gauge(k, float(v), **labels)


def add_telemetry(reg: MetricsRegistry, snap: dict[str, Any],
                  **labels) -> None:
    """Map an obs.telemetry snapshot into the registry."""
    if not snap:
        return
    for k in ("rounds", "dispatches", "samples", "decisions"):
        reg.counter(f"telemetry_{k}_total", snap[k], **labels)
    for verdict, c in snap["verdicts"].items():
        reg.counter("telemetry_verdicts_total", c, verdict=verdict,
                    **labels)
    r_hist = snap["r_hist"]
    reg.histogram("telemetry_samples_at_verdict", r_hist,
                  list(range(len(r_hist) + 1)),
                  help="GRNG samples spent when the verdict landed",
                  **labels)
    reg.histogram("telemetry_confidence", snap["conf_hist"],
                  snap["conf_edges"], **labels)
    reg.histogram("telemetry_predictive_entropy", snap["ent_hist"],
                  snap["ent_edges"], **labels)
    reg.histogram("telemetry_mutual_information", snap["mi_hist"],
                  snap["ent_edges"], **labels)
    g = snap["grng"]
    reg.gauge("grng_probe_samples", g["n"], **labels)
    reg.gauge("grng_probe_sum_mean_uA", g["sum_mean_uA"], **labels)
    reg.gauge("grng_probe_sum_std_uA", g["sum_std_uA"], **labels)


def add_drift(reg: MetricsRegistry, status: dict[str, Any],
              **labels) -> None:
    """Map an obs.drift status dict into the registry."""
    if not status:
        return
    reg.gauge("grng_drift_z_mean", status["z_mean"], **labels)
    reg.gauge("grng_drift_z_std", status["z_std"], **labels)
    reg.gauge("grng_drift_advisory", 1.0 if status["drifted"] else 0.0,
              help="1 when recalibration is advised", **labels)


def add_stage_profile(reg: MetricsRegistry, snap: dict[str, Any],
                      **labels) -> None:
    """Map an obs.prof.StageProfiler snapshot into the registry: one
    ``stage_latency_seconds`` histogram per stage plus an exact-count
    counter (the histogram's +Inf bucket carries overflow)."""
    for stage, rec in (snap or {}).items():
        reg.counter("stage_total", rec["count"],
                    help="loop-stage executions", stage=stage, **labels)
        reg.histogram("stage_latency_seconds", rec["counts"],
                      rec["edges"], overflow=rec.get("overflow", 0),
                      sum=rec.get("total_s"),
                      help="host-side latency of one serving-loop stage",
                      stage=stage, **labels)


def add_compile_counters(reg: MetricsRegistry, counters: dict[str, Any],
                         **labels) -> None:
    """Map a compile-counter snapshot into the registry: builds per
    cached builder, then the port's nvcc builds and seconds when the
    snapshot has them (``obs.prof.compile_counters``), else the
    reference's XLA compile counters."""
    if not counters:
        return
    for builder, n in sorted(counters.get("builder_builds", {}).items()):
        reg.counter("engine_builder_builds_total", n,
                    help="executable constructions per cached engine "
                         "builder (lru_cache misses)",
                    builder=builder, **labels)
    if "nvcc_builds" in counters:          # the port's: no XLA runs
        reg.counter("nvcc_builds_total", counters["nvcc_builds"],
                    help="kernel libraries compiled by nvcc in this "
                         "process", **labels)
        reg.counter("nvcc_seconds_total",
                    counters.get("nvcc_seconds", 0.0), **labels)
        return
    reg.counter("xla_compile_events_total",
                counters.get("xla_compile_events", 0),
                help="XLA backend compiles observed in this process",
                **labels)
    reg.counter("xla_compile_seconds_total",
                counters.get("xla_compile_seconds", 0.0), **labels)


def add_compiled_costs(reg: MetricsRegistry, records: list,
                       **labels) -> None:
    """Map cost records into per-function gauges (in the port, one per
    ``obs.prof.compiled_cost`` kernel record)."""
    for rec in records or []:
        lb = dict(labels, fn=rec["name"])
        for k in ("flops", "hbm_bytes", "peak_live_bytes", "compile_s",
                  "xla_flops", "xla_bytes_accessed", "launches_per_dispatch",
                  "launches_per_admission", "hash3_evals", "bound_ms"):
            if k in rec:
                reg.gauge(f"compiled_{k}", rec[k], **lb)


def add_slo(reg: MetricsRegistry, snap: dict[str, Any],
            **labels) -> None:
    """Map an obs.slo.SloTracker snapshot into the registry."""
    if not snap:
        return
    reg.counter("slo_requests_total", snap.get("requests", 0), **labels)
    for key, metric in (("time_to_verdict", "slo_time_to_verdict_seconds"),
                        ("queue_wait", "slo_queue_wait_seconds"),
                        ("service", "slo_service_seconds"),
                        ("router", "slo_router_decision_seconds")):
        h = snap.get(key)
        if h and h.get("count"):
            reg.histogram(metric, h["counts"], h["edges"],
                          overflow=h.get("overflow", 0),
                          sum=h.get("total_s"), **labels)
    for verdict, h in (snap.get("by_verdict") or {}).items():
        reg.histogram("slo_time_to_verdict_seconds", h["counts"],
                      h["edges"], overflow=h.get("overflow", 0),
                      sum=h.get("total_s"), verdict=verdict, **labels)
    for r, h in (snap.get("by_r") or {}).items():
        reg.gauge("slo_ttv_p99_seconds", quantile(h, 0.99),
                  help="p99 time-to-verdict by samples-at-verdict",
                  r_at_verdict=r, **labels)
        reg.counter("slo_requests_by_r_total", h["count"],
                    r_at_verdict=r, **labels)
    for k in ("p50_s", "p95_s", "p99_s", "mean_s", "queue_wait_share"):
        if k in snap:
            reg.gauge(f"slo_ttv_{k}" if k.endswith("_s") else f"slo_{k}",
                      snap[k], **labels)
    for s in snap.get("slos") or []:
        lb = dict(labels, slo=s["name"])
        reg.gauge("slo_attainment", s["attainment"],
                  help="fraction of requests within the SLO target", **lb)
        reg.gauge("slo_burn_rate", s["burn_rate"],
                  help="observed miss rate over the error budget", **lb)
        reg.gauge("slo_breach", 1.0 if s["breach"] else 0.0, **lb)
    fleet = snap.get("fleet")
    if fleet:
        reg.counter("fleet_ticks_total", fleet["ticks"], **labels)
        reg.counter("fleet_backpressure_ticks_total",
                    fleet["backpressure_ticks"],
                    help="fleet ticks where routing left backlog behind",
                    **labels)
        reg.gauge("fleet_backlog_peak", fleet["backlog_peak"], **labels)
        reg.gauge("fleet_backlog_mean", fleet["backlog_mean"], **labels)
        for p, peak in enumerate(fleet.get("queue_depth_peak", [])):
            reg.gauge("fleet_queue_depth_peak", peak, pool=p, **labels)
        for p, mean in enumerate(fleet.get("queue_depth_mean", [])):
            reg.gauge("fleet_queue_depth_mean", mean, pool=p, **labels)


def add_alerts(reg: MetricsRegistry, advisories: list,
               **labels) -> None:
    """Map an obs.alerts advisory stream into the registry: counters
    per (kind, severity) plus the last-event timestamp per kind."""
    if not advisories:
        return
    counts: dict[tuple, int] = {}
    last_ts: dict[str, float] = {}
    for a in advisories:
        d = a if isinstance(a, dict) else a.to_dict()
        counts[(d["kind"], d["severity"])] = \
            counts.get((d["kind"], d["severity"]), 0) + 1
        last_ts[d["kind"]] = max(last_ts.get(d["kind"], 0.0),
                                 float(d.get("ts_s", 0.0)))
    for (kind, sev), n in sorted(counts.items()):
        reg.counter("alerts_total", n, kind=kind, severity=sev, **labels)
    for kind, ts in sorted(last_ts.items()):
        reg.gauge("alert_last_ts_seconds", ts, kind=kind, **labels)


def serving_registry(summary: dict[str, Any], *,
                     telemetry: dict[str, Any] | None = None,
                     drift: dict[str, Any] | None = None,
                     profile: dict[str, Any] | None = None,
                     compile_counters: dict[str, Any] | None = None,
                     compiled_costs: list | None = None,
                     slo: dict[str, Any] | None = None,
                     alerts: list | None = None,
                     **labels) -> MetricsRegistry:
    """One-call registry for a serving run's summary + telemetry.

    ``profile`` / ``compile_counters`` default to what the engine
    attached to the summary (``stage_profile`` / ``compile_counters``
    keys), so callers that just forward the run dict get the perf
    exposition for free."""
    reg = MetricsRegistry()
    add_summary(reg, summary, job="serving", **labels)
    if telemetry:
        add_telemetry(reg, telemetry, job="serving", **labels)
    if drift:
        add_drift(reg, drift, job="serving", **labels)
    profile = profile if profile is not None else \
        summary.get("stage_profile")
    if profile:
        add_stage_profile(reg, profile, job="serving", **labels)
    compile_counters = compile_counters if compile_counters is not None \
        else summary.get("compile_counters")
    if compile_counters:
        add_compile_counters(reg, compile_counters, job="serving",
                             **labels)
    if compiled_costs:
        add_compiled_costs(reg, compiled_costs, job="serving", **labels)
    slo = slo if slo is not None else summary.get("slo")
    if slo:
        add_slo(reg, slo, job="serving", **labels)
    if alerts:
        add_alerts(reg, alerts, job="serving", **labels)
    return reg


def mission_registry(summary: dict[str, Any], *,
                     telemetry: dict[str, Any] | None = None,
                     alerts: list | None = None,
                     **labels) -> MetricsRegistry:
    """Registry for a mission run; ``telemetry`` maps group name →
    {"telemetry": snapshot, "drift": status}."""
    reg = MetricsRegistry()
    add_summary(reg, summary, job="mission", **labels)
    for group, t in (telemetry or {}).items():
        if t.get("telemetry"):
            add_telemetry(reg, t["telemetry"], job="mission",
                          die_group=group, **labels)
        if t.get("drift"):
            add_drift(reg, t["drift"], job="mission", die_group=group,
                      **labels)
    if alerts:
        add_alerts(reg, alerts, job="mission", **labels)
    return reg
