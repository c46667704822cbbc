"""Per-request span tracing with Chrome-trace / Perfetto JSON export
(port of ``repro/obs/trace.py``; plain Python, its own copy).

Spans are recorded on ``time.perf_counter`` (monotonic) relative to the
tracer's construction time, and exported in the Chrome trace-event
format: open the JSON in https://ui.perfetto.dev or ``chrome://tracing``.

Track layout for serving: tid 0 is the engine loop (featurize and
sar_rounds spans); tids 1..n_slots are request tracks, one complete
span per request from admission to retirement with verdict /
sample-count args.  :func:`mission_trace` builds the same format after
the fact from mission logs on the SIMULATED mission clock.

Fleet runs (``serving/fleet.py``) stitch all pools into ONE timeline:
pid 0 is the router (fleet_tick spans, backpressure instants, flow
starts), pid p+1 is pool p (its gang-dispatch track at tid 0 and its
slot tracks).  Each request carries a Perfetto flow (ph "s"/"f" keyed by
rid) from the router tick that routed it to the slot span where its
verdict landed, so one request is followable router → pool → slot.

The tracer reads host clocks only: a span never waits on the card, so
a ``sar_rounds`` span covers the host's launches and the one pull.
"""

from __future__ import annotations

import json
import time
from contextlib import contextmanager
from typing import Any

import numpy as np


class Tracer:
    """Collects trace events; export with :meth:`export` / :meth:`to_chrome`."""

    def __init__(self, process_name: str = "repro-serving"):
        self.t0 = time.perf_counter()
        self.process_name = process_name
        self.events: list[dict[str, Any]] = []
        self._thread_names: dict[tuple[int, int], str] = {}
        self._process_names: dict[int, str] = {}

    @property
    def enabled(self) -> bool:
        return True

    def now(self) -> float:
        """Seconds since tracer start (monotonic)."""
        return time.perf_counter() - self.t0

    def name_thread(self, tid: int, name: str, pid: int = 0) -> None:
        self._thread_names[(int(pid), int(tid))] = name

    def name_process(self, pid: int, name: str) -> None:
        self._process_names[int(pid)] = name

    def complete(self, name: str, ts_s: float, dur_s: float, *,
                 tid: int = 0, pid: int = 0, **args) -> None:
        """Record a complete ("X") span at ``ts_s`` lasting ``dur_s`` (s)."""
        self.events.append({
            "name": name, "ph": "X", "pid": int(pid), "tid": int(tid),
            "ts": float(ts_s) * 1e6, "dur": max(float(dur_s), 0.0) * 1e6,
            "args": {k: _plain(v) for k, v in args.items()},
        })

    def instant(self, name: str, ts_s: float | None = None, *,
                tid: int = 0, pid: int = 0, **args) -> None:
        """Record an instant ("i", thread-scoped) event at ``ts_s``
        (now by default)."""
        if ts_s is None:
            ts_s = self.now()
        self.events.append({
            "name": name, "ph": "i", "s": "t", "pid": int(pid),
            "tid": int(tid), "ts": float(ts_s) * 1e6,
            "args": {k: _plain(v) for k, v in args.items()},
        })

    @contextmanager
    def span(self, name: str, *, tid: int = 0, pid: int = 0, **args):
        start = self.now()
        try:
            yield
        finally:
            self.complete(name, start, self.now() - start,
                          tid=tid, pid=pid, **args)

    def _flow(self, ph: str, name: str, flow_id: int, ts_s: float, *,
              tid: int, pid: int, cat: str) -> None:
        ev = {"name": name, "ph": ph, "cat": cat, "id": int(flow_id),
              "pid": int(pid), "tid": int(tid), "ts": float(ts_s) * 1e6}
        if ph == "f":
            ev["bp"] = "e"  # bind to the enclosing slice, not the next
        self.events.append(ev)

    def flow_start(self, name: str, flow_id: int,
                   ts_s: float | None = None, *, tid: int = 0,
                   pid: int = 0, cat: str = "req") -> None:
        """Open a Perfetto flow arrow at ``ts_s`` (must land inside a
        slice on that track; Perfetto draws the arrow slice to slice)."""
        self._flow("s", name, flow_id, self.now() if ts_s is None
                   else ts_s, tid=tid, pid=pid, cat=cat)

    def flow_step(self, name: str, flow_id: int,
                  ts_s: float | None = None, *, tid: int = 0,
                  pid: int = 0, cat: str = "req") -> None:
        self._flow("t", name, flow_id, self.now() if ts_s is None
                   else ts_s, tid=tid, pid=pid, cat=cat)

    def flow_end(self, name: str, flow_id: int,
                 ts_s: float | None = None, *, tid: int = 0,
                 pid: int = 0, cat: str = "req") -> None:
        self._flow("f", name, flow_id, self.now() if ts_s is None
                   else ts_s, tid=tid, pid=pid, cat=cat)

    def to_chrome(self) -> dict[str, Any]:
        pnames = dict(self._process_names)
        pnames.setdefault(0, self.process_name)
        meta = [{"name": "process_name", "ph": "M", "pid": pid, "tid": 0,
                 "args": {"name": name}}
                for pid, name in sorted(pnames.items())]
        for (pid, tid), name in sorted(self._thread_names.items()):
            meta.append({"name": "thread_name", "ph": "M", "pid": pid,
                         "tid": tid, "args": {"name": name}})
        return {"traceEvents": meta + self.events,
                "displayTimeUnit": "ms"}

    def export(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.to_chrome(), f)


class _NullTracer(Tracer):
    """No-op tracer so call sites never branch on ``tracer is None``."""

    def __init__(self):
        super().__init__("null")

    @property
    def enabled(self) -> bool:
        return False

    def name_thread(self, tid, name, pid=0):
        pass

    def name_process(self, pid, name):
        pass

    def complete(self, *a, **k):
        pass

    def instant(self, *a, **k):
        pass

    def _flow(self, *a, **k):
        pass

    @contextmanager
    def span(self, *a, **k):
        yield


NULL_TRACER = _NullTracer()


def _plain(v):
    if isinstance(v, (np.generic,)):
        return v.item()
    if isinstance(v, (int, float, bool, str, type(None))):
        return v
    return str(v)


def mission_trace(logs: dict[str, Any],
                  process_name: str = "repro-mission") -> dict[str, Any]:
    """Chrome trace of a mission rollout on the simulated clock.

    ``logs`` is ``MissionResult.logs``: arrays shaped [steps, drones]
    (``time_s`` gives each step's simulated end time).  One track per
    drone; each step becomes a span named by what happened there
    (found / verify / orbit / look) carrying verdict / spent /
    confidence args.  Purely post-hoc — no serving-path cost.
    """
    t = np.asarray(logs["time_s"], dtype=np.float64)
    steps, drones = t.shape
    tr = Tracer(process_name)
    for d in range(drones):
        tr.name_thread(d + 1, f"drone {d}")
    prev = np.zeros(drones)
    active = np.asarray(logs["active"], dtype=bool)
    verdict = np.asarray(logs["verdict"])
    spent = np.asarray(logs["spent"])
    conf = np.asarray(logs["confidence"], dtype=np.float64)
    found = np.asarray(logs.get("found", np.zeros_like(active)), dtype=bool)
    verify = np.asarray(logs.get("verify", np.zeros_like(active)), dtype=bool)
    orbited = np.asarray(logs.get("orbited", np.zeros_like(active)),
                         dtype=bool)
    for s in range(steps):
        for d in range(drones):
            if not active[s, d]:
                continue
            if found[s, d]:
                name = "found"
            elif verify[s, d]:
                name = "verify"
            elif orbited[s, d]:
                name = "orbit"
            else:
                name = "look"
            dur = max(float(t[s, d]) - float(prev[d]), 0.0)
            tr.complete(name, float(prev[d]), dur, tid=d + 1,
                        step=s, cell=int(np.asarray(logs["cell"])[s, d]),
                        verdict=int(verdict[s, d]), spent=int(spent[s, d]),
                        confidence=round(float(conf[s, d]), 4))
            prev[d] = t[s, d]
    return tr.to_chrome()
