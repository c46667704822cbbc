"""Fleet serving: several complete SarServingEngine pools behind one
router (port of ``repro/serving/fleet.py``).

Architecture (each box is a full SarServingEngine on its own device):

    submit() ──▶ fleet backlog ──▶ least-loaded router
                                     │ (bounded per-pool queues:
                                     │  a saturated pool backpressures)
          ┌───────────┬──────────────┼──────────────┐
          ▼           ▼              ▼              ▼
      ┌───────┐   ┌───────┐      ┌───────┐      ┌───────┐
      │pool 0 │   │pool 1 │      │pool 2 │      │pool 3 │
      └───┬───┘   └───┬───┘      └───┬───┘      └───┬───┘
          └───────────┴───── gang ───┴──────────────┘
                 every pool's rounds launched, no sync
                          │
                          ▼
              one blocking host pull a tick:
              retire + refill every pool's slots

The reference tiles its pools over a ``("pool",)`` device mesh and
shard_maps one jitted round over it.  Here a list of torch devices
takes the mesh axis's place, and it may repeat a device: pool p runs on
``devices[p]``, by default ``cuda:{p mod device_count}``.  A *gang*
tick launches each pool's ``_multi_round`` in turn on its own device,
with its own device-side exit flag and no sync between pools, gathers
every pool's packed verdicts, statistics and round count onto the
first pool's device, and pulls them in ONE transfer: ``host_syncs``
grows by one a tick, where the sequential arm (``gang=False``) pulls
once per active pool.  On one card every pool shares ``cuda:0``, so a
fleet there shows bit-identity and the syncs a tick, not scaling
across cards.

Bit-identity: each pool is an unmodified engine whose exit flag sees
only its own slots, and its stream bases come from its own decision
counter at admission, so a pool in the gang decides bit for bit as a
standalone engine fed the same admissions.  An idle pool in a gang tick
runs its rounds fully masked, as the reference's: zero deltas, and only
its telemetry's dispatch counter ticks (``record_round`` adds
``any(mask)`` rounds); the sequential arm skips idle pools.

Aggregation reuses the single-pool machinery: per-pool
``ServingMetrics`` (the fleet's energy is the exact sum of the pools',
each the sum of its records'), per-pool telemetry merged with
``obs.telemetry.merge_snapshots``, one shared StageProfiler, one shared
SloTracker fed the router latency, the per-pool queue depths and the
backpressured ticks, and one tracer stitching the fleet into a single
timeline (``obs/trace``)."""

from __future__ import annotations

import time
from collections import deque

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.obs.prof import NULL_PROFILER, StageProfiler
from repro_torch.obs.slo import NULL_SLO, SloTracker
from repro_torch.obs.telemetry import TelemetryConfig, merge_snapshots
from repro_torch.obs.trace import NULL_TRACER
from repro_torch.serving.engine import Request, SarServingEngine
from repro_torch.serving.metrics import ServingMetrics
from repro_torch.serving.triage import TriagePolicy


def pool_devices(n_pools: int, devices=None) -> list[torch.device]:
    """The pools' devices: ``devices`` as given (one a pool, repeats
    allowed), or ``cuda:{p mod device_count}`` for pool p (raises
    without CUDA)."""
    if devices is None:
        resolve_device(None)
        count = torch.cuda.device_count()
        return [torch.device(f"cuda:{p % count}") for p in range(n_pools)]
    devices = [resolve_device(d) for d in devices]
    if len(devices) != n_pools:
        raise ValueError(f"devices: expected {n_pools} entries (one a "
                         f"pool), got {len(devices)}")
    return devices


class SarServingFleet:
    """Data-parallel fleet of SAR serving pools behind one router.

    ``n_pools`` complete ``SarServingEngine``s of ``slots_per_pool``
    slots each, pool p on ``devices[p]`` (``pool_devices``).  ``gang``:
    True (the default with more than one pool) launches every pool's
    rounds and pulls their results once a tick; False dispatches and
    pulls pool by pool, with identical verdicts and more host syncs.

    Routing is *consistent least-loaded*: each backlog request goes to
    the pool with the smallest (in-flight + queued) load, ties to the
    lowest pool id, so a given submission sequence always routes the
    same way.  Per-pool admission queues hold at most ``queue_cap``
    (default ``slots_per_pool``): a pool with a full queue is skipped (it
    backpressures), and when every pool is saturated the rest waits in
    the fleet backlog (``backlog_peak``).

    ``head``/``hcfg``/``chip`` bind every pool to the same die, as in
    the single-pool engine; ``layers``/``tile_program`` feed each pool's
    energy accounting; ``tracer``/``profiler``/``slo`` are shared by the
    pools."""

    def __init__(self, params, cfg, *, n_pools: int = 2,
                 slots_per_pool: int = 32,
                 policy: TriagePolicy = TriagePolicy(),
                 adaptive_mode: bool = True,
                 head: dict | None = None, hcfg=None, chip=None,
                 fused: bool = True,
                 telemetry: bool | TelemetryConfig = True,
                 layers=None, tile_program=None,
                 queue_cap: int | None = None,
                 gang: bool | None = None,
                 profiler: bool | StageProfiler = True,
                 tracer=None, slo=True, devices=None):
        if n_pools < 1:
            raise ValueError("n_pools must be >= 1")
        self.n_pools = n_pools
        self.slots_per_pool = slots_per_pool
        self.policy = policy
        self.queue_cap = slots_per_pool if queue_cap is None else queue_cap
        if self.queue_cap < 1:
            raise ValueError("queue_cap must be >= 1")
        self.devices = pool_devices(n_pools, devices)
        if profiler is True:
            profiler = StageProfiler()
        self.profiler: StageProfiler = profiler or NULL_PROFILER
        # one tracer, one timeline: pid 0 = router, pid p+1 = pool p
        self.tracer = tracer if tracer is not None else NULL_TRACER
        if slo is True:
            slo = SloTracker()
        self.slo: SloTracker = slo or NULL_SLO
        if self.tracer.enabled:
            self.tracer.name_process(0, "router")
            self.tracer.name_thread(0, "fleet ticks", pid=0)
            for p in range(n_pools):
                self.tracer.name_process(p + 1, f"pool {p}")
                self.tracer.name_thread(0, "pool loop", pid=p + 1)
        self.engines = [
            SarServingEngine(
                params, cfg, n_slots=slots_per_pool, policy=policy,
                adaptive_mode=adaptive_mode,
                metrics=ServingMetrics(layers=layers, extra={"pool": p},
                                       tile_program=tile_program),
                head=head, hcfg=hcfg, chip=chip, fused=fused,
                telemetry=telemetry, profiler=profiler,
                tracer=self.tracer, slo=self.slo, trace_pid=p + 1,
                device=self.devices[p])
            for p in range(n_pools)]
        self.tcfg = self.engines[0].tcfg
        self.gang = n_pools > 1 if gang is None else bool(gang)
        self.backlog: deque[Request] = deque()
        self.routes: dict[int, int] = {}          # rid -> pool id
        self.host_syncs = 0
        self.backlog_peak = 0
        self.wall_s = float("nan")
        # per tick: {"wall_s", "trips": [P]}, trips = each pool's own
        # round count (≥ 1 for an idle pool in the gang, 0 sequential)
        self.tick_log: list[dict] = []

    # -- admission router ----------------------------------------------
    def submit(self, request: Request) -> None:
        if request.arrival_s == 0.0:
            request.arrival_s = time.time()
        if request.arrival_pc == 0.0:
            request.arrival_pc = time.perf_counter()
        self.backlog.append(request)
        self.backlog_peak = max(self.backlog_peak, len(self.backlog))

    def _pick_pool(self) -> int | None:
        """Least-loaded pool with queue headroom; None = all saturated."""
        best, best_load = None, None
        for p, eng in enumerate(self.engines):
            if len(eng.queue) >= self.queue_cap:
                continue                          # saturated: backpressure
            load = eng.n_active + len(eng.queue)
            if best_load is None or load < best_load:
                best, best_load = p, load
        return best

    def _route(self) -> None:
        had_work = bool(self.backlog)
        t0 = time.perf_counter()
        while self.backlog:
            p = self._pick_pool()
            if p is None:
                break                # every pool saturated: hold here
            req = self.backlog.popleft()
            self.routes[req.rid] = p
            self.engines[p].queue.append(req)
            if self.tracer.enabled:
                # the owning pool's slot span closes this flow
                self.tracer.flow_start(f"req {req.rid}", req.rid,
                                       tid=0, pid=0)
        if had_work:
            self.slo.observe_router(time.perf_counter() - t0)
        if self.backlog:
            self.slo.backpressure(len(self.backlog))
            if self.tracer.enabled:
                self.tracer.instant("backpressure", tid=0, pid=0,
                                    backlog=len(self.backlog))

    @property
    def pending(self) -> int:
        return len(self.backlog) + sum(len(e.queue) for e in self.engines)

    @property
    def n_active(self) -> int:
        return sum(e.n_active for e in self.engines)

    # -- dispatch -------------------------------------------------------
    def _dispatch_gang(self, actives: list[np.ndarray]) -> list[int]:
        """Every pool's rounds, idle pools fully masked; one pull."""
        template = next(e.pools[0] for e in self.engines
                        if e.pools is not None)
        for eng in self.engines:
            eng.ensure_pool(like=template)
        home = self.engines[0].device
        with self.profiler.span("dispatch"):
            packed = torch.cat([eng._dispatch(a).to(home)
                                for eng, a in zip(self.engines, actives)])
        # ONE blocking pull for the whole fleet
        with self.profiler.span("triage_loop"):
            packed = packed.cpu().numpy()
        self.host_syncs += 1
        t_verdict = time.perf_counter()
        trips, off = [], 0
        with self.profiler.span("retirement"):
            for eng, active in zip(self.engines, actives):
                size = 4 * eng.n_slots + 1
                part = packed[off:off + size]
                off += size
                trips.append(int(part[-1]))
                if active.any():
                    eng._land(part, active, t_verdict)
        return trips

    def _dispatch_sequential(self, actives: list[np.ndarray]) -> list[int]:
        """One dispatch and one pull per active pool."""
        trips = [0] * self.n_pools
        for p, (eng, active) in enumerate(zip(self.engines, actives)):
            if not active.any():
                continue
            with self.profiler.span("dispatch"):
                packed = eng._dispatch(active)
            with self.profiler.span("triage_loop"):
                packed = packed.cpu().numpy()
            self.host_syncs += 1
            eng.host_syncs += 1
            t_verdict = time.perf_counter()
            with self.profiler.span("retirement"):
                trips[p] = eng._land(packed, active, t_verdict)
        return trips

    # -- main loop ------------------------------------------------------
    def start(self) -> None:
        """Reset every pool's stream bases.  ``run`` calls this;
        the open-loop harness (``serving/load.py``) calls it once, then
        interleaves ``submit`` with ``tick`` on its own clock."""
        for eng in self.engines:
            eng.start()

    def tick(self) -> bool:
        """One fleet tick: route the backlog, admit per pool, one gang
        (or sequential) dispatch, retire.  False when no pool had
        active work."""
        t_tick = time.perf_counter()
        t_tr = self.tracer.now()
        with self.profiler.span("route"):
            self._route()
        for eng in self.engines:
            eng._admit()
        self.slo.sample_queues(
            [len(e.queue) for e in self.engines],
            [e.n_active for e in self.engines], len(self.backlog))
        actives = [eng.active_mask() for eng in self.engines]
        if not any(a.any() for a in actives):
            return False
        for eng, active in zip(self.engines, actives):
            eng._stamp_first_dispatch(active)
        t_disp = self.tracer.now()
        trips = (self._dispatch_gang(actives) if self.gang
                 else self._dispatch_sequential(actives))
        self.tick_log.append(
            {"wall_s": time.perf_counter() - t_tick, "trips": trips})
        if self.tracer.enabled:
            now = self.tracer.now()
            tick_no = len(self.tick_log) - 1
            for p in range(self.n_pools):
                if actives[p].any():
                    self.tracer.complete(
                        "gang_dispatch", t_disp, now - t_disp,
                        tid=0, pid=p + 1, tick=tick_no, trips=trips[p],
                        n_active=int(actives[p].sum()))
            self.tracer.complete(
                "fleet_tick", t_tr, now - t_tr, tid=0, pid=0,
                tick=tick_no, backlog=len(self.backlog),
                n_active=sum(int(a.sum()) for a in actives),
                max_trips=max(trips))
        return True

    def drain(self) -> dict:
        """Attach per-pool telemetry and profiles, build the summary
        (the shared SLO snapshot lands on the fleet's summary only)."""
        for eng in self.engines:
            if eng.tcfg is not None:
                eng.metrics.attach_telemetry(eng.telemetry_snapshot())
            eng._attach_perf()
        return self.summary()

    def run(self, max_ticks: int = 100_000) -> dict:
        t0 = time.perf_counter()
        self.start()
        for _ in range(max_ticks):
            if not self.tick():
                if not self.backlog and not any(
                        e.queue for e in self.engines):
                    break
        self.wall_s = time.perf_counter() - t0
        return self.drain()

    # -- aggregation ----------------------------------------------------
    def summary(self) -> dict:
        """Fleet report: exact sums of the per-pool reports.
        ``energy_total_J`` is the sum over pools of their sums over
        records; ``telemetry`` merges the pools' snapshots (each
        request's counters live in one pool's)."""
        pool_summaries = [e.metrics.summary() for e in self.engines]
        decisions = sum(s["decisions"] for s in pool_summaries)
        requests = sum(s["requests"] for s in pool_summaries)
        wall = self.wall_s
        out = {
            "n_pools": self.n_pools,
            "slots_per_pool": self.slots_per_pool,
            "gang": self.gang,
            "requests": requests,
            "decisions": decisions,
            "wall_s": wall,
            "decisions_per_s": (decisions / wall
                                if wall and wall > 0 else float("nan")),
            "host_syncs": self.host_syncs,
            "host_syncs_per_decision": (self.host_syncs / decisions
                                        if decisions else float("nan")),
            "backlog_peak": self.backlog_peak,
            "routed_per_pool": [
                sum(1 for p in self.routes.values() if p == q)
                for q in range(self.n_pools)],
            "ticks": len(self.tick_log),
            "tick_log": [dict(t) for t in self.tick_log],
        }
        if decisions:
            out["mean_samples_per_decision"] = sum(
                s["mean_samples_per_decision"] * s["decisions"]
                for s in pool_summaries if s["decisions"]) / decisions
            for frac in ("accept_fraction", "flag_fraction"):
                if requests and all(frac in s for s in pool_summaries):
                    out[frac] = sum(
                        s[frac] * s["requests"]
                        for s in pool_summaries if s["requests"]
                    ) / requests
        if all("energy_total_J" in s for s in pool_summaries):
            out["energy_total_J"] = float(sum(
                s["energy_total_J"] for s in pool_summaries
                if s["requests"]))
        snaps = [s.get("telemetry") for s in pool_summaries]
        snaps = [s for s in snaps if s is not None]
        if snaps:
            out["telemetry"] = merge_snapshots(snaps)
        out["pools"] = [
            {k: s.get(k) for k in
             ("pool", "requests", "decisions", "decisions_per_s",
              "mean_samples_per_decision", "energy_total_J",
              "accept_fraction", "flag_fraction")}
            for s in pool_summaries]
        snap = self.profiler.snapshot()
        if snap:
            out["stage_profile"] = snap
        slo_snap = self.slo.snapshot()
        if slo_snap:
            out["slo"] = slo_snap
            out["backpressure_ticks"] = self.slo.backpressure_ticks
        return out
