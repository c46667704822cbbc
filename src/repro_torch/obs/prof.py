"""Performance observability: stage profiler, build counters, kernel
cost records and a profiler trace (port of ``repro/obs/prof.py``).

Four instruments, all host-side: none touches a device tensor, adds a
host sync or changes what a kernel computes (tests/test_torch_prof.py).
Where the reference reads XLA, the port reads what stands in its place:

``StageProfiler``, ``NULL_PROFILER``, ``SERVING_STAGES``
    As in the reference: per-stage latency histograms (``perf_counter``)
    over the serving loop's phases, admission, featurize, dispatch,
    triage_loop and retirement, on log-spaced buckets.  In eager PyTorch
    the engine's ``dispatch`` stage times the host issuing a dispatch's
    ~700 kernel launches and ``triage_loop`` the one blocking pull,
    i.e. the wait for the card to finish them; the two split a
    dispatch's wall into host launch time and device wait.

``builder_builds`` / ``compile_counters``
    The reference counts executable constructions in its ``lru_cache``
    jit builders and every XLA backend compile.  The port has no jit:
    its cached builders are the kernels' launch plans and ctypes
    launchers (``kernels/decision.py``, ``cim.py``, ``bayes.py``,
    ``grng.py``) and the library load (``kernels/build.load``), and
    each cache's ``cache_info().misses`` is its number of
    constructions; the compiles are ``nvcc`` runs
    (``kernels/build.nvcc_counters``).  ``compile_counters()`` reports
    those; it has no ``xla_*`` key, since no XLA runs here.

``compiled_cost``
    The reference AOT-compiles a jitted function and records XLA's cost
    analysis.  The port's hot functions are hand-written kernels, so a
    record is one kernel at the live shapes: its launches per dispatch
    (or per admission), and the bytes, float operations and hash3 count
    of ``kernels/bounds`` (the same count ``chip_smoke.py``'s bounds
    use) with the bound they give.  Nothing is compiled or launched to
    make one.

``trace_capture``
    The reference wraps ``jax.profiler``; here ``torch.profiler`` with
    CPU and (on a machine with a card) CUDA activities, whose Chrome
    trace is written into the directory.  A profiler that fails to
    start raises: a run asked to be profiled is not run unprofiled.
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import Counter
from typing import Any

import numpy as np

from repro_torch.obs.registry import quantile

# ----------------------------------------------------------------------
# stage profiler
# ----------------------------------------------------------------------
# The serving engine's loop phases, in loop order (export order);
# StageProfiler accepts any stage string.
SERVING_STAGES = ("admission", "featurize", "dispatch", "triage_loop",
                  "retirement")

# Log-spaced latency edges: 1 µs .. 10 s, 4 buckets per decade.
_EDGES = np.logspace(-6, 1, 29)


class StageProfiler:
    """Host-side per-stage latency histograms (perf_counter clocks).

    Host arithmetic on scalars the engine loop already measured: no
    device interaction.  ``snapshot()`` is JSON-ready and feeds
    ``obs.registry.add_stage_profile``.
    """

    edges = _EDGES

    def __init__(self):
        self._counts: dict[str, np.ndarray] = {}
        self._over: Counter = Counter()
        self._total_s: Counter = Counter()
        self._n: Counter = Counter()

    @property
    def enabled(self) -> bool:
        return True

    def observe(self, stage: str, dt_s: float) -> None:
        """Fold one latency observation into ``stage``'s histogram.

        NaN observations are dropped; negative ones clamp to 0; past the
        last edge (or +inf) lands in the overflow (+Inf) bucket."""
        if dt_s != dt_s:                               # NaN
            return
        dt_s = max(float(dt_s), 0.0)
        if stage not in self._counts:
            self._counts[stage] = np.zeros(len(_EDGES) - 1, np.int64)
        self._n[stage] += 1
        if np.isfinite(dt_s):
            self._total_s[stage] += dt_s
        if dt_s >= _EDGES[-1] or not np.isfinite(dt_s):
            self._over[stage] += 1
            return
        self._counts[stage][
            np.searchsorted(_EDGES, dt_s, side="right") - 1 if
            dt_s >= _EDGES[0] else 0] += 1

    @contextlib.contextmanager
    def span(self, stage: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.observe(stage, time.perf_counter() - t0)

    def snapshot(self) -> dict[str, Any]:
        """{stage: {count, total_s, mean_s, p50/p95/p99_s, counts,
        overflow, edges}}; percentiles from the binned histogram by
        ``registry.quantile``."""
        out: dict[str, Any] = {}
        order = [s for s in SERVING_STAGES if s in self._counts]
        order += [s for s in self._counts if s not in SERVING_STAGES]
        for stage in order:
            n = int(self._n[stage])
            rec = {
                "count": n,
                "total_s": float(self._total_s[stage]),
                "mean_s": float(self._total_s[stage]) / n if n else
                float("nan"),
                "counts": self._counts[stage].tolist(),
                "overflow": int(self._over[stage]),
                "edges": _EDGES.tolist(),
            }
            rec["p50_s"] = quantile(rec, 0.50)
            rec["p95_s"] = quantile(rec, 0.95)
            rec["p99_s"] = quantile(rec, 0.99)
            out[stage] = rec
        return out


class _NullStageProfiler(StageProfiler):
    """No-op profiler so engine call sites never branch."""

    @property
    def enabled(self) -> bool:
        return False

    def observe(self, stage, dt_s):
        pass

    @contextlib.contextmanager
    def span(self, stage):
        yield

    def snapshot(self):
        return {}


NULL_PROFILER = _NullStageProfiler()


# ----------------------------------------------------------------------
# build counters
# ----------------------------------------------------------------------
def _cached_builders() -> dict:
    """The port's ``lru_cache`` builders by counter name."""
    from repro_torch.kernels import bayes, build, cim, decision, grng
    return {"build_load": build.load,
            "cim_launch_plan": cim.launch_plan,
            "cim_launcher": cim._launcher,
            "cim_sm_count": cim._sm_count,
            "decision_launcher": decision._launcher,
            "decision_plan": decision.decision_plan,
            "grng_launcher": grng._launcher,
            "head_launcher": bayes._launcher,
            "head_plan": bayes.head_plan,
            "head_sm_count": bayes._sm_count}


def builder_builds() -> dict[str, int]:
    """Constructions per cached builder since the process started (its
    cache's misses; the caches are process-wide)."""
    return {name: fn.cache_info().misses
            for name, fn in _cached_builders().items()}


def compile_counters() -> dict[str, Any]:
    """JSON-ready snapshot: builds per cached builder, and the ``nvcc``
    runs of this process with their seconds."""
    from repro_torch.kernels.build import nvcc_counters
    nvcc = nvcc_counters()
    return {"builder_builds": builder_builds(),
            "nvcc_builds": nvcc["builds"],
            "nvcc_seconds": nvcc["seconds"]}


# ----------------------------------------------------------------------
# kernel cost records
# ----------------------------------------------------------------------
def compiled_cost(name: str, work: dict, *, kernel: str, source: str,
                  launches: int, per: str = "dispatch", shape: str = "",
                  plan: dict | None = None) -> dict:
    """One kernel's cost record at given shapes.

    ``name``: the record's own name (one per kernel and shape, the
    registry's ``fn`` label); ``kernel``: the kernel it counts;
    ``work``: a ``kernels/bounds`` count (``bound_line``'s dict) of one
    launch's work; ``launches``: launches per ``per`` ("dispatch" or
    "admission"), 0 where the caller's route does not launch the
    kernel.  Returns {name, kernel, source, shape, plan,
    launches_per_<per>, hbm_bytes, flops, hash3_evals, bound_ms,
    bound_by}."""
    rec = {"name": name, "kernel": kernel, "source": source, "shape": shape,
           f"launches_per_{per}": int(launches),
           "hbm_bytes": int(work["bound_bytes"]),
           "flops": int(work["bound_ops"]),
           "hash3_evals": int(work["hash3_evals"]),
           "bound_ms": float(work["bound_ms"]),
           "bound_by": work["bound_by"]}
    if plan is not None:
        rec["plan"] = dict(plan)
    return rec


# ----------------------------------------------------------------------
# profiler trace
# ----------------------------------------------------------------------
class TraceFile:
    """What ``trace_capture`` yields: ``path`` is the Chrome trace it
    wrote, set when the block ends (None while it runs)."""
    path: str | None = None


@contextlib.contextmanager
def trace_capture(log_dir: str | None):
    """``torch.profiler`` over the block, its Chrome trace written to
    ``<log_dir>/trace-<pid>-<n>.json`` (Perfetto / chrome://tracing).
    CPU activity always, CUDA activity where a card is present (kernel
    events then carry the CUDA symbols).  ``None`` is a no-op, so a CLI
    passes its flag straight through.  A profiler that fails to start
    raises."""
    out = TraceFile()
    if not log_dir:
        yield out
        return
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.obs.log import get_logger
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    prof = profile(activities=acts)
    prof.__enter__()
    try:
        yield out
    finally:
        prof.__exit__(None, None, None)
        n = 0
        while os.path.exists(path := os.path.join(
                log_dir, f"trace-{os.getpid()}-{n}.json")):
            n += 1
        prof.export_chrome_trace(path)
        out.path = path
        get_logger("prof").info("profiler trace written", path=path)
