"""Open-loop load harness: seeded arrival processes driving a serving
engine or fleet (port of ``repro/serving/load.py``; plain Python and
numpy, its own copy).

Fed everything at once, an engine's queue wait measures burst
absorption, never a traffic regime.  This module generates
deterministic, seeded arrival-time sequences (steady Poisson, bursty,
ramped) and drives a :class:`~repro_torch.serving.SarServingEngine` or
:class:`~repro_torch.serving.SarServingFleet` open-loop: each request is
submitted when its arrival time comes due on the real clock while the
target keeps ticking, so admission-queue wait, backpressure and time to
verdict under a given offered load are measured, not simulated.
Arrivals do NOT wait for the system: under overload the queue grows
and latency explodes.

Spec strings (CLI ``--arrival``):

- ``poisson:RATE`` — iid exponential gaps at RATE req/s.
- ``burst:RATE[:FACTOR]`` — same mean RATE, but alternating groups of
  16 requests arrive with gaps compressed by FACTOR (default 10) and
  stretched in the lull groups so the overall mean rate is preserved.
- ``ramp:LO:HI`` — rate ramps linearly LO → HI req/s over the stream.

All draws come from ``np.random.default_rng(seed)``: the same spec +
seed + n is the same arrival sequence on any machine, and the same as
the reference's.
"""

from __future__ import annotations

import dataclasses
import math
import time
from typing import Any, Sequence

import numpy as np

BURST_GROUP = 16  # requests per burst/lull alternation in burst mode


@dataclasses.dataclass(frozen=True)
class ArrivalSpec:
    """One arrival process: ``kind`` in {poisson, burst, ramp}."""

    kind: str
    rate: float                  # mean req/s (poisson/burst); LO (ramp)
    rate_hi: float = 0.0         # HI rate (ramp only)
    burst_factor: float = 10.0   # gap compression inside bursts

    @classmethod
    def parse(cls, spec: str) -> "ArrivalSpec":
        parts = [p for p in str(spec).split(":") if p]
        kind = parts[0].lower()
        if kind == "poisson":
            return cls(kind="poisson", rate=float(parts[1]))
        if kind == "burst":
            factor = float(parts[2]) if len(parts) > 2 else 10.0
            return cls(kind="burst", rate=float(parts[1]),
                       burst_factor=factor)
        if kind == "ramp":
            return cls(kind="ramp", rate=float(parts[1]),
                       rate_hi=float(parts[2]))
        raise ValueError(
            f"unknown arrival spec {spec!r} — want poisson:RATE, "
            f"burst:RATE[:FACTOR], or ramp:LO:HI")

    @property
    def mean_rate(self) -> float:
        """Realized overall rate (requests / total span).  For a ramp
        the stream spends 1/rate_i per request, so the effective rate
        is the LOG-mean (hi-lo)/ln(hi/lo), not the arithmetic mean."""
        if self.kind == "ramp":
            lo, hi = self.rate, self.rate_hi
            if lo <= 0 or hi <= 0 or lo == hi:
                return lo
            return (hi - lo) / math.log(hi / lo)
        return self.rate

    def to_dict(self) -> dict[str, Any]:
        return dataclasses.asdict(self) | {"mean_rate": self.mean_rate}

    def offsets(self, n: int, seed: int = 0) -> np.ndarray:
        """[n] arrival offsets in seconds from the stream start
        (ascending, first arrival at its own first gap)."""
        if n <= 0:
            return np.zeros((0,), np.float64)
        rng = np.random.default_rng(seed)
        if self.kind == "poisson":
            gaps = rng.exponential(1.0 / self.rate, size=n)
        elif self.kind == "burst":
            gaps = rng.exponential(1.0 / self.rate, size=n)
            group = (np.arange(n) // BURST_GROUP) % 2
            f = self.burst_factor
            # burst groups compress gaps by f; lull groups stretch by
            # (2 - 1/f) so the mean gap — and the offered load — is
            # unchanged: (1/f + (2 - 1/f)) / 2 == 1.
            gaps = np.where(group == 0, gaps / f, gaps * (2.0 - 1.0 / f))
        elif self.kind == "ramp":
            t = np.arange(n) / max(n - 1, 1)
            rate = self.rate + (self.rate_hi - self.rate) * t
            gaps = rng.exponential(1.0, size=n) / rate
        else:  # pragma: no cover - parse() rejects unknown kinds
            raise ValueError(f"unknown arrival kind {self.kind!r}")
        return np.cumsum(gaps)


def run_open_loop(target, requests: Sequence, offsets, *,
                  speed: float = 1.0, max_wall_s: float = 600.0) -> dict:
    """Drive an engine or a fleet open-loop and return its summary.

    ``target``: anything with ``start``/``submit``/``pending``/
    ``n_active``/``drain`` and a per-tick ``step`` (an engine) or
    ``tick`` (a fleet).  Request ``i`` is submitted when
    ``offsets[i] / speed`` seconds of real time have elapsed; between
    arrivals the target keeps ticking so in-flight work drains.  Arrival
    stamps are taken at actual submission time — queue wait is
    measured, not simulated.  ``speed`` > 1 compresses the schedule (the
    same sequence at a proportionally higher offered load);
    ``max_wall_s`` bounds a run whose offered load the target cannot
    drain.  A target with ``wall_s`` (a fleet) gets the harness's wall.
    """
    offsets = np.asarray(offsets, np.float64) / float(speed)
    n = len(requests)
    if n != len(offsets):
        raise ValueError(f"{n} requests vs {len(offsets)} offsets")
    step = getattr(target, "step", None) or target.tick
    target.start()
    i = 0
    t0 = time.perf_counter()
    while True:
        now = time.perf_counter() - t0
        while i < n and offsets[i] <= now:
            req = requests[i]
            req.arrival_s = time.time()
            req.arrival_pc = time.perf_counter()
            target.submit(req)
            i += 1
        worked = step()
        if i >= n and not worked and target.pending == 0 \
                and target.n_active == 0:
            break
        if now > max_wall_s:
            break
        if not worked and i < n:
            # idle until the next arrival comes due
            wait = offsets[i] - (time.perf_counter() - t0)
            if wait > 0:
                time.sleep(min(wait, 0.05))
    wall = time.perf_counter() - t0
    if hasattr(target, "wall_s"):
        target.wall_s = wall
    out = target.drain()
    out["offered"] = {
        "requests": n, "submitted": i,
        "offered_rps": n / offsets[-1] if n and offsets[-1] > 0
                       else float("nan"),
        "harness_wall_s": wall,
    }
    return out
