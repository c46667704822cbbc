"""Unified alert bus (port of ``repro/obs/alerts.py``): one typed
advisory stream for drift advisories (``obs/drift``), lifetime heal
events (``hw/redeploy``), SLO burn and backpressure, each logged through
``obs/log`` as it arrives.  Feeding the bus is host-side and after the
fact; it never touches the device path.

``observe_slo`` and ``observe_backpressure`` read an ``obs/slo``
snapshot (``launch/serve.collect_alerts`` passes the serve summary's);
backpressure fires only on a fleet's snapshot (``serve_sar_fleet``).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any

from repro_torch.obs.log import get_logger

KINDS = ("drift", "heal", "slo_burn", "backpressure")
SEVERITIES = ("info", "warning", "critical")

_log = get_logger("repro_torch.alerts")


@dataclasses.dataclass(frozen=True)
class Advisory:
    kind: str
    severity: str
    source: str
    message: str
    fields: dict[str, Any] = dataclasses.field(default_factory=dict)
    ts_s: float = 0.0

    def to_dict(self) -> dict[str, Any]:
        return dataclasses.asdict(self)


class AlertBus:
    """Collects advisories; read ``advisories`` / ``counts()``, export
    with ``to_json()``."""

    def __init__(self, clock=time.time, logger=None):
        self._clock = clock
        self._log = logger if logger is not None else _log
        self.advisories: list[Advisory] = []

    def __len__(self) -> int:
        return len(self.advisories)

    def emit(self, kind: str, severity: str, source: str, message: str,
             **fields) -> Advisory:
        adv = Advisory(kind=kind, severity=severity, source=source,
                       message=message, fields=dict(fields),
                       ts_s=float(self._clock()))
        self.advisories.append(adv)
        emit = self._log.error if severity == "critical" else (
            self._log.warning if severity == "warning" else self._log.info)
        emit(message, kind=kind, source=source,
             **{k: v for k, v in fields.items()
                if isinstance(v, (int, float, bool, str))})
        return adv

    def observe_drift(self, status: dict[str, Any] | None,
                      source: str = "serving") -> None:
        """Feed a ``DriftStatus.to_dict()``."""
        if not status or not status.get("drifted"):
            return
        self.emit("drift", "warning", source,
                  status.get("advisory") or "GRNG drift detected",
                  z_mean=status.get("z_mean"), z_std=status.get("z_std"),
                  n=status.get("n"))

    def observe_heal(self, event, source: str = "serving") -> None:
        """Feed a ``hw.redeploy.HealEvent`` (or its dict)."""
        d = event if isinstance(event, dict) else event.to_dict()
        self.emit("heal", "info", source,
                  "die recalibrated and head redeployed",
                  age_s=d.get("age_s"), calib_epoch=d.get("calib_epoch"),
                  z_mean=d.get("z_mean"), z_std=d.get("z_std"))

    def observe_slo(self, snap: dict[str, Any] | None,
                    source: str = "serving") -> None:
        """Feed an SLO snapshot: one critical advisory per SLO whose
        error-budget burn breached its threshold."""
        for s in (snap or {}).get("slos") or []:
            if s.get("breach"):
                self.emit(
                    "slo_burn", "critical", source,
                    f"SLO {s['name']} burning error budget at "
                    f"{s['burn_rate']:.1f}x (alert at "
                    f"{s['burn_alert']:g}x)",
                    slo=s["name"], burn_rate=s["burn_rate"],
                    violations=s["violations"], requests=s["requests"])

    def observe_backpressure(self, snap: dict[str, Any] | None,
                             source: str = "fleet") -> None:
        """Feed an SLO snapshot's fleet block: advise when routing
        saturated."""
        fleet = (snap or {}).get("fleet") or {}
        bp = fleet.get("backpressure_ticks", 0)
        if not bp:
            return
        ticks = max(fleet.get("ticks", 1), 1)
        sev = "critical" if bp / ticks > 0.5 else "warning"
        self.emit("backpressure", sev, source,
                  f"router backpressured on {bp}/{ticks} ticks "
                  f"(backlog peak {fleet.get('backlog_peak', 0)})",
                  backpressure_ticks=bp, ticks=ticks,
                  backlog_peak=fleet.get("backlog_peak", 0))

    def counts(self) -> dict[str, int]:
        out: dict[str, int] = {}
        for a in self.advisories:
            out[a.kind] = out.get(a.kind, 0) + 1
        return out

    def worst_severity(self) -> str | None:
        worst = None
        for a in self.advisories:
            if worst is None or (SEVERITIES.index(a.severity)
                                 > SEVERITIES.index(worst)):
                worst = a.severity
        return worst

    def to_json(self) -> list[dict[str, Any]]:
        return [a.to_dict() for a in self.advisories]
