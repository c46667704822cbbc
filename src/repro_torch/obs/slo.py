"""Time-to-verdict tracking and SLOs (port of ``repro/obs/slo.py``;
plain Python and numpy, its own copy).

Per-request **time to verdict**, the quantity SAR operations care
about, as a continuously monitored stream:

- :class:`SloTracker` folds every retired
  :class:`~repro_torch.serving.metrics.RequestRecord` into log-spaced
  latency histograms (overall, per verdict, per samples at verdict,
  plus the queue-wait / service split) and tracks violations against
  declared :class:`SLO` objects with error-budget burn-rate accounting.
- The fleet hooks (router decision latency, per-pool queue depths,
  backpressure) are plain bookkeeping too; ``serving/fleet.py`` calls
  them every tick and its summary carries the ``fleet`` block.

Everything is host-side bookkeeping done where the engine already is on
the host (after its one pull a dispatch): no device tensor is touched,
so verdicts and host syncs are the same with tracking on or off
(tests/test_torch_slo.py).  :data:`NULL_SLO` is the no-op twin so call
sites never branch.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Iterable

import numpy as np

from repro_torch.obs.registry import quantile

# Log-spaced latency edges: 1 µs .. 100 s, 4 buckets per decade — one
# decade wider at the top than obs/prof's stage edges because queue
# delays under overload legitimately reach tens of seconds.
_EDGES = np.logspace(-6, 2, 33)

# Triage verdict codes (serving/triage.py: ACCEPT/ESCALATE/FLAG).
# Spelled out rather than imported so obs stays importable while the
# serving package is still mid-initialisation (engine.py imports obs).
_VERDICTS = {0: "accept", 1: "escalate", 2: "flag"}


def _percentile(tag: str) -> float:
    """``"p99"`` / ``"99"`` / ``"0.99"`` → 0.99."""
    v = float(tag.lower().lstrip("p"))
    return v / 100.0 if v > 1.0 else v


@dataclasses.dataclass(frozen=True)
class SLO:
    """A latency objective: ``percentile`` of requests must see a
    verdict within ``target_s``.  The error budget is the allowed miss
    fraction (1 - percentile); ``burn_rate`` is observed-miss-rate over
    that budget, and a breach fires when it exceeds ``burn_alert``."""

    target_s: float
    percentile: float = 0.99
    burn_alert: float = 2.0

    @classmethod
    def parse(cls, spec: str) -> "SLO":
        """Parse ``"0.25:p99"`` / ``"0.25:p99:2.0"`` / ``"0.25"``."""
        parts = [p for p in str(spec).split(":") if p]
        target = float(parts[0])
        pct = _percentile(parts[1]) if len(parts) > 1 else 0.99
        burn = float(parts[2]) if len(parts) > 2 else 2.0
        return cls(target_s=target, percentile=pct, burn_alert=burn)

    @property
    def error_budget(self) -> float:
        return max(1.0 - self.percentile, 1e-9)

    @property
    def name(self) -> str:
        return f"p{self.percentile * 100.0:g}<={self.target_s:g}s"

    def evaluate(self, violations: int, n: int) -> dict[str, Any]:
        miss = violations / n if n else float("nan")
        burn = miss / self.error_budget if n else float("nan")
        return {
            "name": self.name,
            "target_s": self.target_s,
            "percentile": self.percentile,
            "burn_alert": self.burn_alert,
            "requests": int(n),
            "violations": int(violations),
            "attainment": 1.0 - miss if n else float("nan"),
            "error_budget": self.error_budget,
            "burn_rate": burn,
            "breach": bool(n and burn > self.burn_alert),
        }


class _Hist:
    """One streaming log-spaced histogram (same bin semantics as
    StageProfiler: NaN dropped, negatives clamp to the first bin,
    observations past the last edge land in ``overflow``)."""

    __slots__ = ("counts", "overflow", "total_s", "n")

    def __init__(self):
        self.counts = np.zeros(len(_EDGES) - 1, dtype=np.int64)
        self.overflow = 0
        self.total_s = 0.0
        self.n = 0

    def observe(self, dt_s: float) -> None:
        dt = float(dt_s)
        if math.isnan(dt):
            return
        dt = max(dt, 0.0)
        self.total_s += dt
        self.n += 1
        if dt >= _EDGES[-1]:
            self.overflow += 1
            return
        i = int(np.searchsorted(_EDGES, dt, side="right")) - 1
        self.counts[max(i, 0)] += 1

    def to_dict(self) -> dict[str, Any]:
        return {"count": int(self.n), "total_s": self.total_s,
                "counts": self.counts.tolist(),
                "overflow": int(self.overflow),
                "edges": _EDGES.tolist()}


class SloTracker:
    """Streams retired requests into TTV histograms and SLO ledgers."""

    edges = _EDGES

    def __init__(self, slos: Iterable[SLO | str] = ()):
        self.slos: list[SLO] = [
            SLO.parse(s) if isinstance(s, str) else s for s in slos]
        self._violations = [0] * len(self.slos)
        self._ttv = _Hist()
        self._queue = _Hist()
        self._service = _Hist()
        self._router = _Hist()
        self._by_verdict: dict[str, _Hist] = {}
        self._by_r: dict[int, _Hist] = {}
        self._n = 0
        self._first_arrival = math.inf
        self._last_done = -math.inf
        # fleet-path gauges (per-tick samples)
        self._ticks = 0
        self.backpressure_ticks = 0
        self.backlog_peak = 0
        self._backlog_sum = 0
        self._pool_depth_peak: list[int] = []
        self._pool_depth_sum: list[int] = []
        self._active_sum = 0

    @property
    def enabled(self) -> bool:
        return True

    def add_slo(self, slo: SLO | str) -> None:
        self.slos.append(SLO.parse(slo) if isinstance(slo, str) else slo)
        self._violations.append(0)

    # ---- request path (called at existing host-sync points) ----

    def observe(self, rec) -> None:
        """Fold one retired RequestRecord into the stream."""
        t = rec.verdict_latency_s
        if math.isnan(t):
            t = rec.latency_s
        self._n += 1
        self._ttv.observe(t)
        self._queue.observe(rec.queue_latency_s)
        self._service.observe(rec.service_latency_s)
        name = _VERDICTS.get(int(rec.verdict), str(int(rec.verdict)))
        h = self._by_verdict.get(name)
        if h is None:
            h = self._by_verdict[name] = _Hist()
        h.observe(t)
        r = int(round(rec.n_samples / max(rec.n_decisions, 1)))
        hr = self._by_r.get(r)
        if hr is None:
            hr = self._by_r[r] = _Hist()
        hr.observe(t)
        for k, slo in enumerate(self.slos):
            if t > slo.target_s:
                self._violations[k] += 1
        arr = rec.arrival_pc
        if math.isnan(arr):
            arr = rec.arrival_s
        self._first_arrival = min(self._first_arrival, arr)
        self._last_done = max(self._last_done, rec.done_s)

    # ---- fleet path ----

    def observe_router(self, dt_s: float) -> None:
        self._router.observe(dt_s)

    def sample_queues(self, depths: Iterable[int], active: Iterable[int],
                      backlog: int) -> None:
        """Per-tick gauge sample: per-pool admission-queue depths,
        per-pool active-slot counts, and the fleet backlog depth."""
        self._ticks += 1
        depths = list(depths)
        while len(self._pool_depth_peak) < len(depths):
            self._pool_depth_peak.append(0)
            self._pool_depth_sum.append(0)
        for p, d in enumerate(depths):
            d = int(d)
            self._pool_depth_peak[p] = max(self._pool_depth_peak[p], d)
            self._pool_depth_sum[p] += d
        self._active_sum += int(sum(active))
        backlog = int(backlog)
        self.backlog_peak = max(self.backlog_peak, backlog)
        self._backlog_sum += backlog

    def backpressure(self, backlog_depth: int) -> None:
        """One fleet tick where routing left requests in the backlog
        because every pool's bounded queue was full."""
        self.backpressure_ticks += 1
        self.backlog_peak = max(self.backlog_peak, int(backlog_depth))

    # ---- readout ----

    def snapshot(self) -> dict[str, Any]:
        """JSON-ready snapshot: histograms + quantiles + SLO ledgers.
        Empty dict when nothing was observed (so summaries stay clean
        on untracked runs)."""
        if self._n == 0 and self._ticks == 0:
            return {}
        ttv = self._ttv.to_dict()
        qsum, ssum = self._queue.total_s, self._service.total_s
        out: dict[str, Any] = {
            "requests": self._n,
            "time_to_verdict": ttv,
            "queue_wait": self._queue.to_dict(),
            "service": self._service.to_dict(),
            "by_verdict": {k: h.to_dict()
                           for k, h in sorted(self._by_verdict.items())},
            "by_r": {str(r): h.to_dict()
                     for r, h in sorted(self._by_r.items())},
            "p50_s": quantile(ttv, 0.50),
            "p95_s": quantile(ttv, 0.95),
            "p99_s": quantile(ttv, 0.99),
            "mean_s": ttv["total_s"] / max(self._n, 1),
            "queue_wait_share": qsum / (qsum + ssum)
                                if (qsum + ssum) > 0 else 0.0,
            "span_s": (self._last_done - self._first_arrival)
                      if self._n else float("nan"),
            "slos": [slo.evaluate(v, self._n)
                     for slo, v in zip(self.slos, self._violations)],
        }
        if self._router.n:
            out["router"] = self._router.to_dict()
        if self._ticks:
            t = self._ticks
            out["fleet"] = {
                "ticks": t,
                "backpressure_ticks": self.backpressure_ticks,
                "backlog_peak": self.backlog_peak,
                "backlog_mean": self._backlog_sum / t,
                "queue_depth_peak": list(self._pool_depth_peak),
                "queue_depth_mean": [s / t for s in self._pool_depth_sum],
                "mean_active_slots": self._active_sum / t,
            }
        return out


class _NullSloTracker(SloTracker):
    """No-op twin so call sites never branch on ``slo is None``."""

    def __init__(self):
        super().__init__()

    @property
    def enabled(self) -> bool:
        return False

    def observe(self, rec) -> None:
        pass

    def observe_router(self, dt_s) -> None:
        pass

    def sample_queues(self, depths, active, backlog) -> None:
        pass

    def backpressure(self, backlog_depth) -> None:
        pass

    def snapshot(self) -> dict[str, Any]:
        return {}


NULL_SLO = _NullSloTracker()
