"""Continuous-batching serving engines (port of ``SarServingEngine``
and ``LMServingEngine`` from ``repro/serving/engine.py``).  Both run
over one scheduler skeleton, ``_EngineBase``: the queue, the slots, the
selection-stream bases, retirement into ``serving/metrics``, telemetry
and the host instruments.

``SarServingEngine``: a request is one aerial image patch.  A fixed
pool of slots holds each in-flight request's rank-16 activation basis
(computed once at admission) and its running predictive statistics;
every escalation round draws ``r_step`` more samples per active slot,
folds them into the statistics and re-runs the triage.  A slot retires
the moment its verdict leaves ESCALATE and is refilled from the queue.

One blocking device→host pull per ``step()``.  The reference runs its
rounds in a device-resident ``lax.while_loop`` that exits when any
active slot decides; eager PyTorch has no such loop, and a Python
``while`` on the exit predicate would sync every round.  Instead each
dispatch runs a FIXED ``ceil(r_max / r_step)`` rounds (5 in adaptive
mode at r_min=4, r_max=20; 1 with ``adaptive_mode=False``), which is
enough because every active slot reaches r_max by then and is forced
to decide.  A device-side flag ``looping`` reproduces the reference's
exit: round 0 always runs; after each round

    looping &= any(active) & ~any(active & (verdict != ESCALATE)),

later rounds use the mask ``active & looping`` (masked slots advance
nothing) and ``rounds += looping``.  Statistics, verdicts and round
counts are then exactly the reference's; the rounds launched after the
exit are wasted work, the known price of having no sync.

``fused=True`` folds each round through the CUDA decision kernel
(``kernels/ops.decision_update``), with no [R, B, N] samples in memory;
``fused=False`` keeps the materializing ``mix_samples → update_stats``
path, the cross-check of the kernel's verdicts.

Unlike the reference, whose jitted updates return new (donated)
buffers, the pool and the statistics are updated IN PLACE: admission
scatters the featurized rows with ``index_copy_`` and zeroes the
admitted slots' statistics with ``index_fill_``.

On a chip instance (``chip=``) admission runs the conv trunk on that
die's nonideal CIM arrays (``models/sar_cnn.features``): the weight
matrices are programmed once, when the engine binds the die, and each
admission pays the input quantization, the ADC full scale and one CIM
kernel launch per conv layer.  The head deployed on the same die
(``hw.calib.prepare_instance_head``) comes in through ``head``/``hcfg``.

``featurize`` (trunk + basis) and ``token_decision`` (one whole
escalation schedule with no host sync, the reference's
``_lm_token_fn``) are the engine's building blocks as functions; the
mission rollout (``mission/rollout.py``) runs on them.

Telemetry (``obs/telemetry``, on by default as in the reference) rides
the rounds as device tensors updated in place: each round records the
mask it really updated (``active & looping``), so a round after the
exit adds nothing, and the retiring decisions and the dispatch are
recorded after the loop.  It adds no host sync; ``telemetry_snapshot``
reads it with one pull, and ``drain`` attaches that to the summary.
``swap_head`` replaces the deployed head between runs (the lifetime
loop's recalibrate-and-redeploy).

Host instruments (the reference's defaults: ``profiler=True``,
``slo=True``, ``tracer=None``) read host clocks only; none adds a host
sync or touches a device tensor, so verdicts and ``host_syncs`` are the
same with them on or off.  The stage profiler (``obs/prof``) splits a
tick into admission (featurize inside it), dispatch, triage_loop and
retirement.  In eager PyTorch ``dispatch`` is the host issuing the
dispatch's ~700 kernel launches (the rounds run behind it on the card)
and ``triage_loop`` the one blocking pull, i.e. the wait for the card
to finish them: together the per-layer host split of a dispatch.  Each
record carries ``first_dispatch_s`` (stamped before a dispatch's
launches) and ``verdict_s`` (right after its pull); the SLO tracker
(``obs/slo``) folds every retired record into time-to-verdict
histograms, and a tracer (``obs/trace``) records featurize and
sar_rounds spans and a span per request on its slot's track.
``drain`` attaches the stage profile, the build counters and the SLO
snapshot to the summary; ``compiled_cost_records`` gives each kernel's
work at the live shapes (``obs/prof.compiled_cost``).

Slot sharding (``slot_devices``, the reference's ``slot_axis``/``mesh``):
a list of torch devices, which may repeat one, cuts the slot axis into
that many contiguous shards, and consecutive shards on one device form
a run (``kernels/decision.slot_runs``).  The pool and its statistics
live as one set of tensors a run, on the run's device (the reference
constrains its pool to the slot axis): admission copies each admitted
row into its run, and every round draws its stream indices and
selections, folds (one accumulating decision launch a run, read noise
keyed on the run's global slot ids through ``row0``), finalizes and
decides run by run on the run's device.  Only the verdicts, and at the
end of a dispatch the finalized fields (with telemetry, each round's
selections, indices and mask) come to the engine's device, so the
verdicts are the unsharded pool's bit for bit and a dispatch keeps its
one pull.  An unsharded engine, or every shard on one device, is one
run: today's whole tensors on the engine's device.  When ``n_slots``
does not divide over the shards the pool is one run, as the
reference's unsharded kernel, and the summary's ``shards`` says which
ran (``runs``: the runs).  ``serving/fleet.py`` runs several engines
behind one router with one pull a tick (``_dispatch`` / ``_land``).

``LMServingEngine``: token streams.  Slots share one decode clock (the
KV cache's ``pos``, kept on the host), and a tick decides one token for
every active slot: the rank-16 activation basis of each slot's hidden
state at vocabulary width (no hoist, as the reference's), one whole
escalation schedule through ``token_decision`` (the decision kernel
with ``fused=True``), one blocking pull, retirement on FLAG or on
ACCEPT at ``max_new_tokens``, then ``decode_hidden`` of the committed
tokens into the next hidden states.  Admission prefills a batch of
left-padded prompts; mid-stream (pool clock ahead of the prompt length
by delta), the cached keys are rolled by delta and re-rotated by RoPE
(``_rotate_k``: rotations compose additively), values rolled, and the
per-slot ``start`` shifted, which is exact for RoPE trunks.  Where the
reference scatters admission rows with ``mode="drop"`` past a sentinel
slot, the port copies only the admitted rows (``index_copy_``).  The
reference's first admission takes the prefill cache as the pool with
its rows in request order while the requests take slots from the free
list's end, so a request can decode against another's cache (ROADMAP
C20); the port scatters the first admission's rows into their slots as
it does every later one's.  On the card the engine's products run with
TF32 off and bfloat16 products reduced in float32
(``repro_torch.float32_math``).
"""

from __future__ import annotations

import dataclasses
import math
import time
from collections import deque
from typing import Any

import numpy as np
import torch

from repro_torch import float32_math, resolve_device
from repro_torch.core.bayes_layer import to_serving
from repro_torch.core.lfsr import indexed_selections
from repro_torch.core.sampling import (BayesHeadConfig, activation_basis,
                                       mix_samples)
from repro_torch.kernels import bounds
from repro_torch.kernels.cim import launch_plan
from repro_torch.kernels.decision import (MAX_SAMPLES, decision_plan,
                                          slot_runs)
from repro_torch.kernels.ops import decision_update
from repro_torch.models.sar_cnn import features, program_trunk
from repro_torch.obs import prof
from repro_torch.obs.prof import NULL_PROFILER, StageProfiler
from repro_torch.obs.slo import NULL_SLO, SloTracker
from repro_torch.obs.telemetry import (TelemetryConfig, count_dispatch,
                                       init_telemetry, record_decisions,
                                       record_round)
from repro_torch.obs.telemetry import snapshot as telemetry_snapshot
from repro_torch.obs.trace import NULL_TRACER
from repro_torch.serving import adaptive, triage
from repro_torch.serving.metrics import RequestRecord, ServingMetrics
from repro_torch.serving.triage import ACCEPT, ESCALATE, FLAG, TriagePolicy


@dataclasses.dataclass
class Request:
    """One unit of admission: an image [H, W, 1] (SAR) or a prompt [L]
    of token ids (LM).  ``arrival_s`` is wall clock; ``arrival_pc`` its
    monotonic ``perf_counter`` twin; ``max_new_tokens``: LM only."""
    rid: int
    payload: Any
    arrival_s: float = 0.0
    meta: dict = dataclasses.field(default_factory=dict)
    arrival_pc: float = 0.0
    max_new_tokens: int = 8


@dataclasses.dataclass
class _Slot:
    req: Request | None = None
    admit_s: float = 0.0              # perf_counter stamp at admission
    first_dispatch_s: float = 0.0     # first dispatch covering this slot
    n_samples: int = 0                # accumulated over the request
    n_decisions: int = 0              # tokens decided (LM) / 1 (SAR)


def featurize(params, head: dict, images: torch.Tensor, cfg,
              hcfg: BayesHeadConfig, trunk: list | None = None) -> dict:
    """Images [B, H, W, 1] -> activation-basis rows (port of
    ``_sar_featurize_fn``): the conv trunk (``trunk``: a die's arrays
    from ``program_trunk``; None: the float trunk), then the head's
    rank-16 basis, dense on the device even where the head is hoisted
    in host chunks (the decision kernel reads one ``m``)."""
    feats = features(params, images, cfg, trunk=trunk)
    return activation_basis(head, feats, hcfg, dense=True)


def token_decision(abasis: dict, base: torch.Tensor, active: torch.Tensor,
                   *, hcfg: BayesHeadConfig, policy: TriagePolicy,
                   adaptive_mode: bool, schedule: tuple,
                   fused: bool = True, telem: dict | None = None,
                   tcfg: TelemetryConfig | None = None,
                   launched: torch.Tensor | None = None,
                   shard=None) -> tuple:
    """One whole decision per slot with no host sync (port of
    ``_lm_token_fn``'s ``token_decision``) -> (verdict, fin, spent), or
    (verdict, fin, spent, telem) when ``telem`` is given.

    Zeroed statistics, then one round per entry of ``schedule``
    (``adaptive.escalation_schedule(policy)``, or ``(r_max,)`` for fixed
    R); a round draws for the slots that are ``active`` and still
    undecided, folds the samples in (the decision kernel, or
    ``mix_samples`` + ``update_stats`` with ``fused=False``), finalizes
    and decides (``triage.decide``, or ``fixed_r_decide``).  ``base``
    [B]: each slot's selection-stream base (uint32 in int64).

    The reference skips a round under ``lax.cond`` once no slot is
    undecided.  Here every round runs, and its verdict is taken only
    where the device predicate ``any(undecided)`` holds: a skipped
    round's mask is all False, so the statistics, ``spent`` and the
    undecided set already stand still, and re-deciding on unchanged
    statistics would give the same ``fin`` but not the same verdict
    (a decision with no lane active keeps ESCALATE, as the reference's).

    ``telem``/``tcfg``: device telemetry, updated in place: each round
    records its update mask (a skipped round's is empty and adds 0),
    every active slot's verdict is recorded once at the end, and the
    dispatch counts once, or only where the device bool ``launched``
    holds (a decision the reference would have skipped whole).

    ``shard``: a sequence of torch devices (``_lm_token_fn``'s
    ``slot_axis``/``mesh``): with ``fused`` and B divisible over them,
    every round goes through ``decision_stats_sharded`` (bit for bit the
    unsharded rounds); otherwise the unsharded kernel, as the reference.
    """
    b, n = abasis["y_mu"].shape
    dev = abasis["y_mu"].device
    if shard is not None and b % len(shard):
        shard = None
    if fused:      # the kernel takes contiguous rows
        abasis = {k: v.contiguous() for k, v in abasis.items()}
    grng = hcfg.grng
    stats = adaptive.init_stats(b, n, device=dev)
    fin = adaptive.finalize(stats)
    verdict = torch.full((b,), ESCALATE, dtype=torch.int32, device=dev)
    spent = torch.zeros((b,), dtype=torch.int32, device=dev)
    undecided = active
    for r in schedule:
        ran = undecided.any()
        upd = active & undecided
        idx = adaptive.stream_indices(base, stats["n"], r)
        sel = indexed_selections(grng.lfsr_seed, idx)
        if fused:
            decision_update(stats, abasis, sel, grng, sample_idx=idx,
                            mask=upd, shard=shard)
        else:
            samples = mix_samples(abasis, sel, hcfg, sample_idx=idx)
            stats = adaptive.update_stats(stats, samples, mask=upd)
        fin = adaptive.finalize(stats)
        if adaptive_mode:
            decided = triage.decide(fin, policy,
                                    final=fin["n"] >= policy.r_max)
        else:
            decided = triage.fixed_r_decide(fin, policy)
        verdict = torch.where(ran, decided, verdict)
        spent = spent + torch.where(upd, r, 0).to(torch.int32)
        undecided = undecided & (decided == ESCALATE)
        if telem is not None:
            record_round(telem, tcfg, grng, sel, idx, upd)
    if telem is None:
        return verdict, fin, spent
    record_decisions(telem, tcfg, fin, verdict, active)
    count_dispatch(telem, launched)
    return verdict, fin, spent, telem


def _home(parts: list, device, dim: int = 0) -> torch.Tensor:
    """Per-run tensors joined along the slot axis ``dim`` on ``device``
    (one run: its tensor, moved if it lies elsewhere)."""
    if len(parts) == 1:
        return parts[0].to(device)
    return torch.cat([t.to(device) for t in parts], dim)


def _to_device(tree, device):
    if isinstance(tree, torch.Tensor):
        return tree.to(device)
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_device(v, device) for v in tree)
    return tree


def _deploy_head(head: dict, device) -> dict:
    """A serving head on the engine's device; the host chunks of a
    basis hoisted with ``hoist_tile_n`` stay on the host
    (``activation_basis`` streams them)."""
    return {k: v if k == "sigma_basis_host" else _to_device(v, device)
            for k, v in head.items()}


class _EngineBase:
    """Queue and slot bookkeeping shared by both engines: the slots and
    the free list, the admission queue, the selection-stream bases,
    retirement into the metrics, the device telemetry and the host
    instruments (module docstring); ``device``: None = the card (raises
    without CUDA), "cpu" on purpose."""

    def __init__(self, n_slots: int, policy: TriagePolicy,
                 metrics: ServingMetrics | None,
                 telemetry: bool | TelemetryConfig = True, tracer=None,
                 profiler: bool | StageProfiler = True, slo=True,
                 trace_pid: int = 0, device=None):
        self.device = resolve_device(device)
        self.n_slots = n_slots
        self.policy = policy
        self.queue: deque[Request] = deque()
        self.slots = [_Slot() for _ in range(n_slots)]
        self.free: list[int] = list(range(n_slots))
        self.metrics = metrics or ServingMetrics()
        self._decision_counter = 0
        # Blocking device→host round trips on the decision path: one
        # per dispatch (the verdict pull).
        self.host_syncs = 0
        # Admission batches (one featurize or prefill pass each).
        self.admissions = 0
        # device-resident telemetry, read only by telemetry_snapshot()
        if telemetry is True:
            telemetry = TelemetryConfig()
        self.tcfg: TelemetryConfig | None = telemetry or None
        self._telem = (init_telemetry(self.tcfg, policy.r_max, self.device)
                       if self.tcfg else None)
        # host instruments (module docstring)
        self.tracer = tracer if tracer is not None else NULL_TRACER
        if profiler is True:
            profiler = StageProfiler()
        self.profiler: StageProfiler = profiler or NULL_PROFILER
        self._own_slo = slo is True
        if slo is True:
            slo = SloTracker()
        self.slo: SloTracker = slo or NULL_SLO
        self.trace_pid = int(trace_pid)
        for i in range(n_slots):
            self.tracer.name_thread(i + 1, f"slot {i}", pid=self.trace_pid)

    # -- queue ----------------------------------------------------------
    def submit(self, request: Request) -> None:
        if request.arrival_s == 0.0:
            request.arrival_s = time.time()
        if request.arrival_pc == 0.0:
            request.arrival_pc = time.perf_counter()
        self.queue.append(request)

    @property
    def n_active(self) -> int:
        return self.n_slots - len(self.free)

    @property
    def pending(self) -> int:
        """Requests in the queue, not yet in a slot."""
        return len(self.queue)

    def active_mask(self) -> np.ndarray:
        """[n_slots] bool — which slots hold an in-flight request."""
        return np.array([s.req is not None for s in self.slots])

    def _next_bases(self, count: int) -> np.ndarray:
        """Reserve fresh selection-stream regions: decision ``id`` owns
        [id·r_max, (id+1)·r_max) of the global stream."""
        ids = np.arange(self._decision_counter,
                        self._decision_counter + count, dtype=np.uint32)
        self._decision_counter += count
        return ids * np.uint32(self.policy.r_max)

    # -- retirement -----------------------------------------------------
    def _retire(self, slot_idx: int, verdict: int, fin: dict,
                verdict_s: float = float("nan")) -> None:
        slot = self.slots[slot_idx]
        req = slot.req
        now = time.perf_counter()
        self.metrics.mark(now)
        rec = RequestRecord(
            rid=req.rid, verdict=int(verdict), n_samples=slot.n_samples,
            n_decisions=max(slot.n_decisions, 1),
            arrival_s=req.arrival_s, admit_s=slot.admit_s, done_s=now,
            prediction=int(fin["prediction"][slot_idx]),
            confidence=float(fin["confidence"][slot_idx]),
            mutual_information=float(fin["mutual_information"][slot_idx]),
            arrival_pc=req.arrival_pc,
            first_dispatch_s=slot.first_dispatch_s or float("nan"),
            verdict_s=verdict_s)
        self.metrics.record(rec)
        self.slo.observe(rec)
        if self.tracer.enabled:
            start = slot.admit_s - self.tracer.t0
            self.tracer.complete(
                f"req {req.rid}", start, now - slot.admit_s,
                tid=slot_idx + 1, pid=self.trace_pid, verdict=int(verdict),
                n_samples=slot.n_samples,
                n_decisions=max(slot.n_decisions, 1))
            # close the request's flow on its slot span: a fleet's
            # router opened it when it routed the request
            self.tracer.flow_end(f"req {req.rid}", req.rid, start,
                                 tid=slot_idx + 1, pid=self.trace_pid)
        slot.req = None
        slot.n_samples = slot.n_decisions = 0
        slot.first_dispatch_s = 0.0
        self.free.append(slot_idx)

    def _stamp_first_dispatch(self, active) -> None:
        """Stamp the slots this dispatch covers for the first time
        (host clock, before the dispatch's launches)."""
        now = time.perf_counter()
        for i in np.nonzero(active)[0]:
            if self.slots[i].first_dispatch_s == 0.0:
                self.slots[i].first_dispatch_s = now

    def telemetry_snapshot(self) -> dict | None:
        """The device telemetry on the host (one pull); None without."""
        if self._telem is None:
            return None
        return telemetry_snapshot(self._telem, self.tcfg)

    def _attach_perf(self) -> None:
        """Attach the stage profile and the process's build counters
        (``stage_profile``/``compile_counters``), and the SLO snapshot
        when this engine owns its tracker."""
        self.metrics.attach_profile(self.profiler.snapshot() or None,
                                    prof.compile_counters())
        if self._own_slo:
            self.metrics.attach_slo(self.slo.snapshot())

    def drain(self) -> dict:
        """Attach the telemetry, profile and SLO snapshots and build the
        summary."""
        if self._telem is not None:
            self.metrics.attach_telemetry(self.telemetry_snapshot())
        self._attach_perf()
        return self.metrics.summary()


class SarServingEngine(_EngineBase):
    """Adaptive-fidelity victim/no-victim triage over an image stream.

    ``params``: port params (``models.sar_cnn.init_sar_cnn`` or
    ``bridge.params_from_jax``); ``head``/``hcfg``: a pre-deployed
    serving head and its config (default: the golden head from
    ``params``); ``chip``: a ``hw.ChipInstance`` whose nonideal CIM
    arrays run the conv trunk; ``adaptive_mode=False`` runs the paper's
    fixed-R dataflow (one r_max-sample round, decide); ``telemetry``:
    True (a default ``TelemetryConfig``), a config, or False for none;
    ``tracer``: an ``obs.trace.Tracer`` (None: none); ``profiler``: True
    (a fresh ``StageProfiler``), a shared one, or False; ``slo``: True
    (a tracker this engine owns and attaches to its summary), a shared
    ``SloTracker`` (its owner attaches it), or False; ``trace_pid``: the
    tracer's process track; ``device``: None = the card (raises without
    CUDA), "cpu" on purpose; ``slot_devices``: the slot shards' devices
    (module docstring), None for the unsharded pool.
    """

    def __init__(self, params, cfg, *, n_slots: int = 32,
                 policy: TriagePolicy = TriagePolicy(),
                 adaptive_mode: bool = True,
                 metrics: ServingMetrics | None = None,
                 head: dict | None = None,
                 hcfg: BayesHeadConfig | None = None,
                 chip=None, fused: bool = True,
                 telemetry: bool | TelemetryConfig = True, tracer=None,
                 profiler: bool | StageProfiler = True, slo=True,
                 trace_pid: int = 0, device=None, slot_devices=None):
        super().__init__(n_slots, policy, metrics, telemetry, tracer,
                         profiler, slo, trace_pid, device)
        # Escalation rounds launched, wasted ones after the exit included.
        self.rounds_launched = 0
        self._shard = None
        self.shards = None
        if slot_devices is not None:
            devs = [resolve_device(d) for d in slot_devices]
            if not devs:
                raise ValueError("slot_devices needs at least one device")
            self._shard = devs if n_slots % len(devs) == 0 else None
            self.shards = len(devs) if self._shard else 1
        # the slot runs the pool lives in, one set of tensors each
        self.runs = slot_runs(self._shard or [self.device], n_slots)
        self.cfg = cfg
        self.adaptive_mode = adaptive_mode
        self.fused = fused
        self.hcfg = hcfg or BayesHeadConfig(
            num_samples=policy.r_max, mode="rank16", grng=cfg.grng,
            compute_dtype=torch.float32, hoist_basis=True)
        self._params = _to_device(params, self.device)
        self._head = (to_serving(self._params["head"], self.hcfg)
                      if head is None else _deploy_head(head, self.device))
        self._trunk = (None if chip is None
                       else program_trunk(self._params, cfg, chip))
        self.r_step = policy.r_min if adaptive_mode else policy.r_max
        self.max_rounds = (math.ceil(policy.r_max / self.r_step)
                           if adaptive_mode else 1)
        self.pools: list[dict] | None = None      # a basis dict a run
        self.stats: list[dict] | None = None      # statistics a run
        self.base: np.ndarray | None = None

    # -- lifetime -------------------------------------------------------
    def swap_head(self, head: dict, hcfg: BayesHeadConfig) -> None:
        """Replace the deployed head and its config between runs (the
        lifetime loop's recalibrate-and-redeploy, or an aged die's stale
        view).  In-flight slots hold activations featurized under the
        old head, so the pool must be empty: swap after ``run()``.
        Queue, metrics, telemetry and the decision-stream counter
        survive the swap; the die's trunk (not aged) stays bound."""
        if self.n_active:
            raise RuntimeError(
                f"swap_head with {self.n_active} in-flight slots — "
                f"drain the pool (run()) and swap between segments")
        self.hcfg = hcfg
        self._head = _deploy_head(head, self.device)

    # -- admission ------------------------------------------------------
    def featurize(self, images) -> dict:
        """Images [B, H, W, 1] -> activation-basis rows on the device."""
        x = torch.as_tensor(np.asarray(images), dtype=torch.float32,
                            device=self.device)
        return featurize(self._params, self._head, x, self.cfg, self.hcfg,
                         self._trunk)

    def ensure_pool(self, like: dict) -> None:
        """Allocate the (pool, stats) state of every run, rows shaped
        like ``like``'s, on the run's device (contiguous, as the decision
        kernel takes it)."""
        if self.pools is not None:
            return
        self.pools = [{k: torch.zeros((run.stop - run.start,)
                                      + tuple(v.shape[1:]), dtype=v.dtype,
                                      device=run.device)
                       for k, v in like.items()} for run in self.runs]
        self.stats = [adaptive.init_stats(run.stop - run.start,
                                          like["y_mu"].shape[-1],
                                          device=run.device)
                      for run in self.runs]

    def _admit(self) -> None:
        take = min(len(self.free), len(self.queue))
        if take == 0:
            return
        with self.profiler.span("admission"):
            reqs = [self.queue.popleft() for _ in range(take)]
            imgs = np.stack([np.asarray(r.payload, np.float32)
                             for r in reqs])
            if take < self.n_slots:                   # fixed-shape batch
                pad = np.repeat(imgs[-1:], self.n_slots - take, axis=0)
                imgs = np.concatenate([imgs, pad], axis=0)
            with self.tracer.span("featurize", pid=self.trace_pid,
                                  n_admitted=take), \
                    self.profiler.span("featurize"):
                rows = self.featurize(imgs)
            self.admissions += 1
            now = time.perf_counter()
            bases = self._next_bases(take)
            taken = []
            for j, req in enumerate(reqs):
                s = self.free.pop()
                taken.append(s)
                self.slots[s].req = req
                self.slots[s].admit_s = now
                self.base[s] = bases[j]
            self.ensure_pool(like=rows)
            taken = np.asarray(taken)
            for run, pool, stats in zip(self.runs, self.pools, self.stats):
                mine = np.nonzero((taken >= run.start)
                                  & (taken < run.stop))[0]
                if mine.size == 0:
                    continue
                idx = torch.as_tensor(taken[mine] - run.start,
                                      dtype=torch.int64, device=run.device)
                pick = (None if mine.size == take else
                        torch.as_tensor(mine, device=self.device))
                for k, v in rows.items():             # in place
                    v = v[:take] if pick is None else v.index_select(0, pick)
                    pool[k].index_copy_(0, idx, v.to(run.device))
                for v in stats.values():
                    v.index_fill_(0, idx, 0)
            self.metrics.mark(now)

    # -- rounds ---------------------------------------------------------
    def _one_round(self, bases: list, mask: torch.Tensor):
        """Draw r_step samples for the masked slots, fold them into the
        statistics, finalize and decide, run by run on each run's device
        (``bases``: a run's stream bases; ``mask`` [n_slots] on the
        engine's device).  -> (verdict on the engine's device, the runs'
        fin dicts)."""
        grng = self.hcfg.grng
        verdicts, fins, sels, idxs = [], [], [], []
        for i, (run, base) in enumerate(zip(self.runs, bases)):
            pool, stats = self.pools[i], self.stats[i]
            upd = mask[run.start:run.stop].to(run.device)
            idx = adaptive.stream_indices(base, stats["n"], self.r_step)
            sel = indexed_selections(grng.lfsr_seed, idx)  # = stream_selections
            if self.fused:
                decision_update(stats, pool, sel, grng, sample_idx=idx,
                                mask=upd, row0=run.start)
            else:
                samples = mix_samples(pool, sel, self.hcfg, sample_idx=idx,
                                      row0=run.start)
                stats = self.stats[i] = adaptive.update_stats(
                    stats, samples, mask=upd)
            fin = adaptive.finalize(stats)
            if self.adaptive_mode:
                verdicts.append(triage.decide(
                    fin, self.policy, final=fin["n"] >= self.policy.r_max))
            else:
                verdicts.append(triage.fixed_r_decide(fin, self.policy))
            fins.append(fin)
            sels.append(sel)
            idxs.append(idx)
        if self._telem is not None:
            record_round(self._telem, self.tcfg, grng,
                         _home(sels, self.device, 1),
                         _home(idxs, self.device, 1), mask)
        return _home(verdicts, self.device), fins

    def _multi_round(self, bases: list, active: torch.Tensor):
        """The fixed-length escalation loop with the device-side exit
        flag (module docstring).  -> (verdict, fin, rounds) on the
        engine's device."""
        verdict, fins = self._one_round(bases, active)
        rounds = torch.ones((), dtype=torch.int32, device=self.device)
        looping = active.any() & ~(active & (verdict != ESCALATE)).any()
        for _ in range(self.max_rounds - 1):
            verdict, fins = self._one_round(bases, active & looping)
            rounds += looping.to(torch.int32)
            looping = looping & ~(active & (verdict != ESCALATE)).any()
        self.rounds_launched += self.max_rounds
        fin = {k: _home([f[k] for f in fins], self.device) for k in fins[0]}
        if self._telem is not None:
            record_decisions(self._telem, self.tcfg, fin, verdict,
                             active & (verdict != ESCALATE))
            count_dispatch(self._telem)
        return verdict, fin, rounds

    # -- retirement -----------------------------------------------------
    def _retire_decided(self, active, verdict, fin, spent: int,
                        verdict_s: float = float("nan")) -> int:
        """Charge samples to every active slot, retire those whose
        verdict left ESCALATE (``verdict_s``: the stamp of the pull that
        brought the verdicts).  Returns the number retired."""
        retired = 0
        for i in np.nonzero(active)[0]:
            self.slots[i].n_samples += spent
            if verdict[i] != ESCALATE:
                self.slots[i].n_decisions = 1
                self._retire(i, verdict[i], fin, verdict_s)
                retired += 1
        return retired

    # -- main loop ------------------------------------------------------
    def start(self) -> None:
        """Reset the per-run selection-stream bases."""
        self.base = np.zeros((self.n_slots,), np.uint32)

    def _dispatch(self, active: np.ndarray) -> torch.Tensor:
        """Launch one dispatch's rounds for the ``active`` [n_slots]
        slots, no sync -> the packed result on the device: verdict,
        prediction, confidence, mutual information [n_slots] each and
        the round count, in one float64 tensor (exact for each)."""
        verdict, fin, rounds = self._multi_round(
            [torch.as_tensor(self.base[run.start:run.stop].astype(np.int64),
                             device=run.device) for run in self.runs],
            torch.as_tensor(active, device=self.device))
        return torch.cat([
            torch.stack([verdict.double(), fin["prediction"].double(),
                         fin["confidence"].double(),
                         fin["mutual_information"].double()]).reshape(-1),
            rounds.double().reshape(1)])

    def _land(self, packed: np.ndarray, active: np.ndarray,
              verdict_s: float) -> int:
        """Retire from a pulled ``_dispatch`` result (``verdict_s``: the
        stamp of its pull).  Returns the dispatch's round count."""
        b = self.n_slots
        rounds = int(packed[4 * b])
        host_fin = {"prediction": packed[b:2 * b].astype(np.int64),
                    "confidence": packed[2 * b:3 * b],
                    "mutual_information": packed[3 * b:4 * b]}
        self._retire_decided(active, packed[:b].astype(np.int32), host_fin,
                             self.r_step * rounds, verdict_s=verdict_s)
        return rounds

    def step(self) -> bool:
        """One scheduler tick: admit, dispatch the escalation rounds,
        pull the verdicts once, retire.  False when nothing was active."""
        self._admit()
        if self.n_active == 0:
            return False
        active = self.active_mask()
        self._stamp_first_dispatch(active)
        t_disp = self.tracer.now()
        with self.profiler.span("dispatch"):       # the host's launches
            packed = self._dispatch(active)
        # ONE blocking device→host pull: the wait for the card
        with self.profiler.span("triage_loop"):
            packed = packed.cpu().numpy()
        t_verdict = time.perf_counter()
        self.host_syncs += 1
        if self.tracer.enabled:
            rounds = int(packed[4 * self.n_slots])
            self.tracer.complete(
                "sar_rounds", t_disp, self.tracer.now() - t_disp,
                pid=self.trace_pid, rounds=rounds,
                n_active=int(active.sum()),
                samples_per_slot=self.r_step * rounds)
        with self.profiler.span("retirement"):
            self._land(packed, active, t_verdict)
        return True

    def drain(self) -> dict:
        """The base summary, with ``shards`` (the slot shards the rounds
        ran over, 1 where the pool did not divide) and ``runs`` (the
        runs of shards on one device the pool lives in) when
        ``slot_devices`` was given."""
        out = super().drain()
        if self.shards is not None:
            out["shards"] = self.shards
            out["runs"] = len(self.runs)
        return out

    def run(self, max_ticks: int = 100_000) -> dict:
        self.start()
        for _ in range(max_ticks):
            if not self.step() and not self.queue:
                break
        return self.drain()

    # -- cost records (profiling path only) -----------------------------
    def compiled_cost_records(self) -> list[dict]:
        """One ``obs/prof.compiled_cost`` record per hand-written kernel
        on this engine's path, at its live shapes: the decision kernel
        (every slot active, one record per launch piece of a round:
        ``ceil(r_step / 64)`` launches a round, ``max_rounds`` rounds a
        dispatch) and, on a die, the CIM kernel per trunk layer (one
        launch a layer an admission of ``n_slots`` images).  Each holds
        the kernel's launch plan (a cached builder) and the work of
        ``kernels/bounds`` (the decision kernel accumulating into the
        statistics).  A sharded pool's decision launches are counted a
        run: with runs of more than one size, one record a size, B the
        run's slots.  A kernel this engine's route does not launch (any
        kernel on the CPU, where the wrappers take the plain versions;
        the decision kernel with ``fused=False``) has 0 launches.  Reads
        shapes only: nothing is launched."""
        if self.pools is None:
            raise RuntimeError(
                "compiled_cost_records needs live pool shapes: run the "
                "engine (or admit once) first")
        recs = []
        on_card = self.device.type == "cuda"
        n = self.pools[0]["y_mu"].shape[1]
        sizes = [run.stop - run.start for run in self.runs]
        grng = self.hcfg.grng
        pieces = [min(MAX_SAMPLES, self.r_step - r0)
                  for r0 in range(0, self.r_step, MAX_SAMPLES)]
        for b in sorted(set(sizes)):
            cards = sum(run.device.type == "cuda" for run, size
                        in zip(self.runs, sizes) if size == b)
            for r in sorted(set(pieces)):
                work = bounds.decision_work(
                    b, n, r, b, sel_per_slot=True,
                    read_sigma=grng.read_sigma, idx_per_slot=True,
                    accumulate=True)
                name = ("decision_stats" if len(pieces) == 1
                        else f"decision_stats/r{r}")
                recs.append(prof.compiled_cost(
                    name if len(set(sizes)) == 1 else f"{name}/b{b}",
                    work, kernel="decision_stats",
                    source="src/repro_torch/kernels/csrc/decision.cu",
                    launches=(self.max_rounds * pieces.count(r) * cards
                              if self.fused else 0),
                    shape=f"B={b} N={n} R={r}, every slot active",
                    plan=decision_plan(n, r, b)._asdict()))
        if self._trunk is not None:
            h = self.cfg.image_size
            for i, layer in enumerate(self._trunk):
                h = (h - layer["k"]) // 2 + 1
                k, cout = layer["w"].shape
                m = self.n_slots * h * h
                recs.append(prof.compiled_cost(
                    f"cim_mvm/trunk{i}", bounds.cim_work(m, k, cout),
                    kernel="cim_mvm",
                    source="src/repro_torch/kernels/csrc/cim_mvm.cu",
                    launches=int(on_card), per="admission",
                    shape=f"trunk{i}: M={m} K={k} N={cout}",
                    plan=launch_plan(m, k, cout)._asdict()))
        return recs


# ----------------------------------------------------------------------
# LM token-stream engine
# ----------------------------------------------------------------------
def _rotate_k(k: torch.Tensor, delta: int, theta: float) -> torch.Tensor:
    """Re-base cached RoPE'd keys [..., Sc, H, dh] by ``delta``
    positions: rotations about a fixed plane compose additively, so
    R_Δ(R_i·k) = R_{i+Δ}·k."""
    from repro_torch.models.blocks import apply_rope
    flat = k.reshape((-1,) + tuple(k.shape[-3:]))
    pos = torch.full(flat.shape[:2], delta, dtype=torch.int32,
                     device=k.device)
    return apply_rope(flat, pos, theta).reshape(k.shape)


class LMServingEngine(_EngineBase):
    """Continuous-batching LM decode with adaptive per-token fidelity
    (module docstring).

    ``params``: port params of the model (the registry's ``init`` or
    ``bridge.lm_params_from_jax``), moved to the engine's device;
    ``cfg``: its ``ModelConfig`` (every family of the registry);
    ``n_slots`` slots of prompts left-padded to ``prompt_len`` (an SSM
    config's a multiple of its ``ssm_chunk``) in a KV cache of
    ``cache_len`` (at most a sliding window: such a cache decodes as the
    rolling one).  ``extras``: the memory inputs every prefill takes
    (``frames`` for the audio family, ``image_embeds`` for the VLM,
    [n_slots, n, d_model]), moved to the engine's device.  An SSM
    cache's recurrent ``ssm``/``conv`` rows and a cross-attention
    family's memory ``xk``/``xv`` rows are slot-local and admitted as
    they are; the self-attention k/v (the hybrid's shared block's too)
    are rolled and re-rotated, so every RoPE family admits mid-stream.
    A learned-position trunk (whisper) cannot be re-based: its
    admissions wait for the pool to drain (``midstream_ok``).
    ``adaptive_mode=False`` draws
    r_max samples a token in one round; ``fused=False`` folds rounds
    through ``mix_samples`` + ``update_stats`` instead of the decision
    kernel.  The other arguments are the SAR engine's.  One blocking
    pull a token (``host_syncs``); ``ticks`` counts the decode ticks.
    """

    def __init__(self, params, cfg, *, n_slots: int = 4,
                 prompt_len: int = 16, cache_len: int = 64,
                 policy: TriagePolicy = TriagePolicy(),
                 adaptive_mode: bool = True,
                 metrics: ServingMetrics | None = None,
                 extras: dict | None = None, fused: bool = True,
                 telemetry: bool | TelemetryConfig = True, tracer=None,
                 profiler: bool | StageProfiler = True, slo=True,
                 trace_pid: int = 0, device=None):
        super().__init__(n_slots, policy, metrics, telemetry, tracer,
                         profiler, slo, trace_pid, device)
        from repro_torch.models.registry import get_api
        from repro_torch.models.transformer import _head_serving
        assert cfg.bayesian_head, "adaptive serving needs the Bayesian head"
        if cfg.swa_window is not None and cache_len > cfg.swa_window:
            raise ValueError(
                f"cache_len={cache_len} exceeds swa_window="
                f"{cfg.swa_window}: the rolling-cache decode path does "
                "not support continuous-batching admission; use "
                f"cache_len <= {cfg.swa_window} or a non-SWA arch")
        self.cfg = cfg
        self.adaptive_mode = adaptive_mode
        self.fused = fused
        self.prompt_len = prompt_len
        self.cache_len = cache_len
        # mid-stream admission re-bases keys by a uniform RoPE rotation;
        # other trunks wait for the pool to drain (delta = 0)
        self.midstream_ok = bool(cfg.use_rope) and not cfg.learned_pos
        self._api = get_api(cfg)
        self._params = _to_device(params, self.device)
        self._extras = _to_device(dict(extras or {}), self.device)
        self.hcfg = BayesHeadConfig(
            num_samples=policy.r_max, mode="rank16", grng=cfg.grng,
            compute_dtype=cfg.dtype, hoist_basis=False)
        self._head = _head_serving(self._params, cfg)
        self.schedule = (adaptive.escalation_schedule(policy)
                         if adaptive_mode else (policy.r_max,))
        self.vocab_padded = cfg.vocab_padded
        self.ticks = 0
        self.cache: dict | None = None
        self.token: torch.Tensor | None = None
        self.hidden: torch.Tensor | None = None
        self.base: np.ndarray | None = None

    # -- the model ------------------------------------------------------
    def prefill(self, tokens: torch.Tensor, lengths: torch.Tensor):
        return self._api.prefill(self._params, tokens, self.cfg,
                                 cache_len=self.cache_len,
                                 prompt_lengths=lengths, **self._extras)

    def decode(self, cache: dict, token: torch.Tensor):
        return self._api.decode_hidden(self._params, cache, token, self.cfg)

    def basis(self, hidden: torch.Tensor) -> dict:
        """The rank-16 activation basis of the slots' hidden states in
        float32 against the cfg.dtype head (products promoted)."""
        return activation_basis(self._head, hidden.to(torch.float32),
                                self.hcfg)

    # -- admission ------------------------------------------------------
    def _pad_prompt(self, tokens) -> tuple[np.ndarray, int]:
        tokens = np.asarray(tokens, np.int32)[-self.prompt_len:]
        length = tokens.shape[0]
        if length < self.prompt_len:
            tokens = np.concatenate(
                [np.zeros((self.prompt_len - length,), np.int32), tokens])
        return tokens, length

    def _align_scatter(self, new: dict, idx: torch.Tensor, take: int,
                       delta: int) -> None:
        """Copy the ``take`` admitted rows of a prefill cache into the
        pool's slots ``idx``, in place, re-based to the pool clock: k
        rolled by ``delta`` along the cache and re-rotated, v rolled,
        ``start`` shifted by ``delta``; the SSM's ``ssm``/``conv`` rows
        and the memory's ``xk``/``xv`` rows are slot-local and copied as
        they are (cast to the pool's dtype: a decode step leaves the
        conv state in float32, as the reference's)."""
        for key, leaf in self.cache.items():
            if key == "pos":
                continue
            nw = new[key]
            if key == "start":
                leaf.index_copy_(0, idx, nw[:take] + delta)
                continue
            rows = nw[:, :take]
            if key in ("k", "v") and delta:
                rows = torch.roll(rows, delta, dims=2)
                if key == "k" and self.cfg.use_rope:
                    rows = _rotate_k(rows, delta, self.cfg.rope_theta)
            leaf.index_copy_(1, idx, rows.to(leaf.dtype))

    def _admit(self) -> None:
        if not self.queue:
            return
        pos = self.cache["pos"] if self.cache is not None else \
            self.prompt_len
        # FIFO admission with a per-request capacity bound: a request
        # admitted at clock ``pos`` writes cache entries up to
        # pos + max_new_tokens - 1; the first that would overflow waits
        # for the pool to drain and rebase.
        if self.prompt_len + self.queue[0].max_new_tokens > self.cache_len:
            bad = self.queue[0]
            raise ValueError(
                f"request {bad.rid}: max_new_tokens={bad.max_new_tokens} "
                f"cannot fit even a fresh pool (prompt_len="
                f"{self.prompt_len}, cache_len={self.cache_len})")
        if self.cache is not None and pos > self.prompt_len \
                and not self.midstream_ok:
            return
        reqs = []
        while (self.queue and len(reqs) < len(self.free)
               and pos + self.queue[0].max_new_tokens <= self.cache_len):
            reqs.append(self.queue.popleft())
        take = len(reqs)
        if take == 0:
            return
        with self.profiler.span("admission"):
            toks = np.zeros((self.n_slots, self.prompt_len), np.int32)
            lens = np.full((self.n_slots,), self.prompt_len, np.int32)
            for j, r in enumerate(reqs):
                toks[j], lens[j] = self._pad_prompt(r.payload)
            # prefill is the LM engine's featurize
            with self.tracer.span("prefill", pid=self.trace_pid,
                                  n_admitted=take), \
                    self.profiler.span("featurize"):
                new_cache, last_h = self.prefill(
                    torch.as_tensor(toks, device=self.device),
                    torch.as_tensor(lens, device=self.device))
            self.admissions += 1
            now = time.perf_counter()
            taken = []
            for req in reqs:
                s = self.free.pop()
                taken.append(s)
                self.slots[s].req = req
                self.slots[s].admit_s = now
            idx = torch.as_tensor(taken, dtype=torch.int64,
                                  device=self.device)
            if self.cache is None:          # a fresh (or rebased) pool
                self.cache = {k: v.clone() if torch.is_tensor(v) else v
                              for k, v in new_cache.items()}
                self.hidden = torch.zeros(
                    (self.n_slots, last_h.shape[-1]), dtype=last_h.dtype,
                    device=self.device)
                self._align_scatter(new_cache, idx, take, 0)
            else:
                self._align_scatter(new_cache, idx, take,
                                    pos - self.prompt_len)
            # the prefill hidden decides each admitted slot's first token
            self.hidden.index_copy_(0, idx,
                                    last_h[:take].to(self.hidden.dtype))
            self.metrics.mark(now)

    # -- main loop ------------------------------------------------------
    def _tick(self) -> None:
        """Decide one token for every active slot (one dispatch, one
        pull), retire, then decode the committed tokens."""
        active = self.active_mask()
        self._stamp_first_dispatch(active)
        t_disp = self.tracer.now()
        with self.profiler.span("dispatch"):
            abasis = self.basis(self.hidden)
            self.base = self._next_bases(self.n_slots)
            out = token_decision(
                abasis, torch.as_tensor(self.base.astype(np.int64),
                                        device=self.device),
                torch.as_tensor(active, device=self.device),
                hcfg=self.hcfg, policy=self.policy,
                adaptive_mode=self.adaptive_mode, schedule=self.schedule,
                fused=self.fused, telem=self._telem, tcfg=self.tcfg)
            verdict, fin, spent = out[:3]
            self.token = fin["prediction"].to(torch.int64)[:, None]
            # verdict, token, confidence, mutual information and samples
            # spent in one tensor (float64 holds each exactly)
            packed = torch.stack([
                verdict.double(), fin["prediction"].double(),
                fin["confidence"].double(),
                fin["mutual_information"].double(), spent.double()])
        with self.profiler.span("triage_loop"):   # the one blocking pull
            packed = packed.cpu().numpy()
        self.host_syncs += 1
        t_verdict = time.perf_counter()
        verdict = packed[0].astype(np.int32)
        spent = packed[4].astype(np.int64)
        host_fin = {"prediction": packed[1].astype(np.int64),
                    "confidence": packed[2],
                    "mutual_information": packed[3]}
        if self.tracer.enabled:
            self.tracer.complete(
                "lm_token", t_disp, self.tracer.now() - t_disp,
                pid=self.trace_pid, n_active=int(active.sum()),
                samples=int(spent[active].sum()))
        with self.profiler.span("retirement"):
            for i in np.nonzero(active)[0]:
                slot = self.slots[i]
                slot.n_samples += int(spent[i])
                slot.n_decisions += 1
                done = slot.n_decisions >= slot.req.max_new_tokens
                if verdict[i] == FLAG or (verdict[i] == ACCEPT and done):
                    self._retire(i, verdict[i], host_fin, t_verdict)
        if self.n_active == 0 and not self.queue:
            return
        with self.profiler.span("dispatch"):  # the pool clock advances
            self.hidden, self.cache = self.decode(self.cache, self.token)

    def run(self, max_ticks: int = 10_000) -> dict:
        """Tick until the queue and the pool are empty; the first token
        of every request comes from its prefill hidden state, so each
        prompt token enters the KV cache once.  Returns the summary."""
        self.base = np.zeros((self.n_slots,), np.uint32)
        with float32_math():
            for _ in range(max_ticks):
                self._admit()
                if self.n_active == 0:
                    if not self.queue:
                        break
                    self.cache = None                  # rebase the pool
                    continue
                self.ticks += 1
                self._tick()
                if self.n_active == 0 and not self.queue:
                    break
        return self.drain()

    # -- cost records (profiling path only) -----------------------------
    def compiled_cost_records(self) -> list[dict]:
        """The decision kernel's ``obs/prof.compiled_cost`` records at
        the live shapes (B = n_slots, N = the padded vocabulary, every
        slot active): one per distinct launch piece of the escalation
        schedule (rounds cut at 64 samples), with its launches a token
        dispatch (0 off the card or with ``fused=False``).  Reads shapes
        only."""
        if self.hidden is None:
            raise RuntimeError(
                "compiled_cost_records needs live shapes: run the "
                "engine (or admit once) first")
        on_card = self.device.type == "cuda"
        b, n = self.n_slots, self.vocab_padded
        grng = self.hcfg.grng
        pieces = [min(MAX_SAMPLES, r - r0) for r in self.schedule
                  for r0 in range(0, r, MAX_SAMPLES)]
        recs = []
        for r in sorted(set(pieces)):
            work = bounds.decision_work(
                b, n, r, b, sel_per_slot=True, read_sigma=grng.read_sigma,
                idx_per_slot=True, accumulate=True)
            recs.append(prof.compiled_cost(
                f"lm_token/r{r}", work, kernel="decision_stats",
                source="src/repro_torch/kernels/csrc/decision.cu",
                launches=(pieces.count(r) if on_card and self.fused
                          else 0),
                shape=f"B={b} N={n} R={r}, every slot active",
                plan=decision_plan(n, r, b)._asdict()))
        return recs
