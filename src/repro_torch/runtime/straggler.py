"""Straggler detection and its mitigation policy (port of
``repro/runtime/straggler.py``).

The monitor keeps an EMA of step durations and flags a step longer
than ``threshold`` × EMA; ``patience`` consecutive flags escalate to
the policy: ``log`` (record only, the default), ``rebatch`` (halve this
node's microbatch share) or ``exclude`` (vote the node out for an
elastic re-mesh, which on one card has nothing to act on).  Flagged
steps stay out of the EMA, so a long stall does not poison it.

On the card the trainer calls ``end_step`` after the step's one
metrics pull, so a duration is the device's as well as the host's.
Detection is host-local and cheap: pure host arithmetic.
"""

from __future__ import annotations

import dataclasses
import time


@dataclasses.dataclass
class StragglerConfig:
    ema_decay: float = 0.9
    threshold: float = 2.0      # flag when step > threshold × EMA
    patience: int = 3           # consecutive flags before escalation
    policy: str = "log"         # log | rebatch | exclude


class StragglerMonitor:
    def __init__(self, cfg: StragglerConfig | None = None):
        self.cfg = cfg or StragglerConfig()
        self.ema: float | None = None
        self.flags = 0
        self.events: list[dict] = []
        self._t0: float | None = None

    def start_step(self) -> None:
        self._t0 = time.monotonic()

    def end_step(self, step: int, duration: float | None = None) -> dict:
        """Record a step (its duration since ``start_step`` unless
        given) -> {step, duration, flagged, action}."""
        if duration is None:
            duration = time.monotonic() - (self._t0 or time.monotonic())
        out = {"step": step, "duration": duration, "flagged": False,
               "action": None}
        if self.ema is None:
            self.ema = duration
            return out
        if duration > self.cfg.threshold * self.ema:
            self.flags += 1
            out["flagged"] = True
            if self.flags >= self.cfg.patience:
                out["action"] = self.cfg.policy
                self.events.append(out)
                self.flags = 0
        else:
            self.flags = 0
        if not out["flagged"]:
            d = self.cfg.ema_decay
            self.ema = d * self.ema + (1 - d) * duration
        return out

    def microbatch_share(self, base: int) -> int:
        """``rebatch``: halve this node's microbatch after an
        escalation."""
        if self.cfg.policy != "rebatch" or not self.events:
            return base
        return max(1, base // 2)
