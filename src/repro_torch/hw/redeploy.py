"""Recalibrate and redeploy without stopping (port of
``repro/hw/redeploy.py``).

``obs/drift`` raises a recalibration advisory when the telemetry probe's
streamed GRNG moments z-fail against the deployment's belief.  This
module acts on it: it re-runs the paper's §III-B1 calibration
(``hw/calib.prepare_instance_head``) on the AGED die and hands back a
head and config that a running engine swaps in between dispatches
(``SarServingEngine.swap_head``).

  * ``aged_belief_view``: the STALE deployment on an aged die: physics
    from ``hw/aging``, the head's constants and µ' from calibration time.
  * ``recalibrate``: fresh measurement and compensation on the aged die,
    at a new ``BayesHeadConfig.calib_epoch``.
  * ``SelfHealingController``: one die's lifetime: the birth instance,
    the deployed belief, a streaming ``DriftMonitor``; it advances the
    age, folds telemetry deltas and heals on an advisory.
    ``launch/serve.serve_sar_lifetime`` and ``mission/rollout`` drive
    their loops through it.

The controller never mutates the birth instance: an age is absolute
(``birth.at_age(t)``), so one (die, t) is the same die whether reached
in one jump or over twenty segments.  Every measurement runs on µ's
device.
"""

from __future__ import annotations

import dataclasses
from typing import Any

from repro_torch.core.sampling import BayesHeadConfig, hoisted_sigma_basis
from repro_torch.hw.aging import AgingSpec, at_age
from repro_torch.hw.calib import prepare_instance_head
from repro_torch.hw.instance import ChipInstance
from repro_torch.obs.drift import (DriftGate, DriftMonitor, DriftStatus,
                                   reference_for)


@dataclasses.dataclass(frozen=True)
class LifetimeConfig:
    """How a serve stream or a mission ages its dies.

    ``age_rate``: simulated field seconds per decision (serving) or per
    mission step; ``epochs``: the age/heal checkpoints the stream is cut
    into.  With ``age_rate`` 0 (``active`` False) the callers take their
    exact un-aged path."""

    age_rate: float = 0.0
    epochs: int = 4
    auto_recalibrate: bool = False
    spec: AgingSpec = dataclasses.field(default_factory=AgingSpec)
    gate: DriftGate = dataclasses.field(default_factory=DriftGate)

    @property
    def active(self) -> bool:
        return self.age_rate > 0.0 and self.epochs > 0


@dataclasses.dataclass(frozen=True)
class HealEvent:
    """One recalibrate-and-redeploy, for reports."""

    age_s: float
    calib_epoch: int
    z_mean: float
    z_std: float
    n: float
    advisory: str | None

    def to_dict(self) -> dict[str, Any]:
        return dataclasses.asdict(self)


def aged_belief_view(head: dict, hcfg: BayesHeadConfig, aged: ChipInstance,
                     base_grng) -> tuple[dict, BayesHeadConfig]:
    """The deployed head served on aged physics with a stale belief.

    The config's GRNG carries the aged die's physical params (currents,
    read σ, imprint) and the deployment-time standardization constants;
    µ' and σ are untouched (write-free cells are not rewritten).  The
    hoisted σ⊙I_j basis is rebuilt (dense, or in host chunks at
    ``hcfg.hoist_tile_n``): it caches physically read currents, and an
    aged die reads aged ones.  ``base_grng``: the factory config
    the die's physical view folds over (``cfg.grng``)."""
    phys = aged.grng(base_grng)
    view_grng = dataclasses.replace(phys, sum_mean=hcfg.grng.sum_mean,
                                    sum_std=hcfg.grng.sum_std)
    hcfg_view = dataclasses.replace(hcfg, grng=view_grng)
    head_view = dict(head)
    if "sigma_basis" in head or "sigma_basis_host" in head:
        head_view.pop("sigma_basis", None)
        head_view.pop("sigma_basis_host", None)
        head_view.update(hoisted_sigma_basis(
            head["sigma"], view_grng, hcfg.compute_dtype,
            hcfg.hoist_tile_n))
    return head_view, hcfg_view


def recalibrate(mu, sigma, base_hcfg: BayesHeadConfig, aged: ChipInstance,
                *, epoch: int) -> tuple[dict, BayesHeadConfig]:
    """§III-B1 calibration on the aged die at ``calib_epoch = epoch``:
    the whole ``prepare_instance_head`` path on µ's device, so a healed
    head is bit for bit a cold deployment on the same aged die."""
    base = dataclasses.replace(base_hcfg, calib_epoch=int(epoch))
    return prepare_instance_head(mu, sigma, base, aged, calibrated=True)


class SelfHealingController:
    """One die's lifetime: age advance, drift watch, heal on advisory.

    Holds the birth instance and the (µ, σ) to deploy; ``advance(t)``
    returns the stale-belief (head, hcfg) at age t, ``observe_snapshot``
    folds a cumulative telemetry snapshot's delta into the monitor, and
    ``heal()`` recalibrates at the current age, bumps ``calib_epoch``
    and re-references the monitor.
    """

    def __init__(self, chip: ChipInstance, mu, sigma,
                 base_hcfg: BayesHeadConfig, *, calibrated: bool = True,
                 spec: AgingSpec | None = None,
                 gate: DriftGate | None = None, probe_cells: int = 32):
        if chip.age_s != 0.0:
            raise ValueError("SelfHealingController owns a die from "
                             "birth; pass the age-0 instance")
        self.chip = chip
        self.mu, self.sigma = mu, sigma
        self.base_hcfg = base_hcfg
        self.calibrated = bool(calibrated)
        self.spec = spec or AgingSpec()
        self.gate = gate or DriftGate()
        self.probe_cells = int(probe_cells)
        self.epoch = 0
        self.age_s = 0.0
        self._belief_age_s = 0.0      # the age the deployed head was
        self._last = (0.0, 0.0, 0.0)  # measured at (0: birth calibration)
        self.events: list[HealEvent] = []
        self.head, self.hcfg = prepare_instance_head(
            mu, sigma, base_hcfg, chip, calibrated=calibrated)
        self.monitor = DriftMonitor(self._belief_reference(), self.gate)

    def _belief_reference(self):
        return reference_for(self.base_hcfg, self.hcfg,
                             calibrated=self.calibrated,
                             probe_cells=self.probe_cells,
                             device=self.mu.device)

    def view(self) -> tuple[dict, BayesHeadConfig]:
        """(head, hcfg) the engine should serve at the current age."""
        if self.age_s == self._belief_age_s:
            return self.head, self.hcfg
        aged = at_age(self.chip, self.age_s, self.spec)
        return aged_belief_view(self.head, self.hcfg, aged,
                                self.base_hcfg.grng)

    def advance(self, t_s: float) -> tuple[dict, BayesHeadConfig]:
        """Move the die to absolute field age ``t_s`` (monotone)."""
        t_s = float(t_s)
        if t_s < self.age_s:
            raise ValueError(f"age runs forward: {t_s} < {self.age_s}")
        self.age_s = t_s
        return self.view()

    def observe_snapshot(self, snapshot: dict[str, Any]) -> DriftStatus:
        """Fold a CUMULATIVE telemetry snapshot; returns the status."""
        g = snapshot.get("grng", snapshot)
        n, s, ssq = float(g["n"]), float(g["sum"]), float(g["sumsq"])
        ln, ls, lssq = self._last
        self._last = (n, s, ssq)
        if n > ln:
            self.monitor.observe(n - ln, s - ls, ssq - lssq)
        return self.monitor.status()

    def heal(self, status: DriftStatus | None = None) -> HealEvent:
        """Recalibrate at the current age and redeploy the belief."""
        status = status or self.monitor.status()
        aged = at_age(self.chip, self.age_s, self.spec)
        self.epoch += 1
        self.head, self.hcfg = recalibrate(self.mu, self.sigma,
                                           self.base_hcfg, aged,
                                           epoch=self.epoch)
        self.calibrated = True
        self._belief_age_s = self.age_s
        self.monitor = DriftMonitor(self._belief_reference(), self.gate)
        ev = HealEvent(age_s=self.age_s, calib_epoch=self.epoch,
                       z_mean=status.z_mean, z_std=status.z_std,
                       n=status.n, advisory=status.advisory)
        self.events.append(ev)
        return ev

    def maybe_heal(self, status: DriftStatus) -> HealEvent | None:
        """Heal iff the status carries an advisory."""
        return self.heal(status) if status.drifted else None

    def report(self) -> dict[str, Any]:
        return {"age_s": self.age_s, "calib_epoch": self.epoch,
                "heals": len(self.events),
                "events": [e.to_dict() for e in self.events],
                "status": self.monitor.status().to_dict()}
