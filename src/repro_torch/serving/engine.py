"""Continuous-batching SAR triage engine (port of ``SarServingEngine``
from ``repro/serving/engine.py``).

A request is one aerial image patch.  A fixed pool of slots holds each
in-flight request's rank-16 activation basis (computed once at
admission) and its running predictive statistics; every escalation
round draws ``r_step`` more samples per active slot, folds them into
the statistics and re-runs the triage.  A slot retires the moment its
verdict leaves ESCALATE and is refilled from the queue.

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

Telemetry, tracing, profiling, SLO tracking, slot sharding and head
hot-swap wait for later slices.
"""

from __future__ import annotations

import dataclasses
import math
import time
from collections import deque
from typing import Any

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core.bayes_layer import to_serving
from repro_torch.core.lfsr import indexed_selections
from repro_torch.core.sampling import (BayesHeadConfig, activation_basis,
                                       mix_samples)
from repro_torch.kernels.ops import decision_update
from repro_torch.models.sar_cnn import features, program_trunk
from repro_torch.serving import adaptive, triage
from repro_torch.serving.metrics import RequestRecord, ServingMetrics
from repro_torch.serving.triage import ESCALATE, TriagePolicy


@dataclasses.dataclass
class Request:
    """One unit of admission: an image [H, W, 1].  ``arrival_s`` is wall
    clock; ``arrival_pc`` its monotonic ``perf_counter`` twin."""
    rid: int
    payload: Any
    arrival_s: float = 0.0
    meta: dict = dataclasses.field(default_factory=dict)
    arrival_pc: float = 0.0


@dataclasses.dataclass
class _Slot:
    req: Request | None = None
    admit_s: float = 0.0              # perf_counter stamp at admission
    n_samples: int = 0                # accumulated over the request
    n_decisions: int = 0              # 1 once decided


def _to_device(tree, device):
    if isinstance(tree, torch.Tensor):
        return tree.to(device)
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_device(v, device) for v in tree)
    return tree


class SarServingEngine:
    """Adaptive-fidelity victim/no-victim triage over an image stream.

    ``params``: port params (``models.sar_cnn.init_sar_cnn`` or
    ``bridge.params_from_jax``); ``head``/``hcfg``: a pre-deployed
    serving head and its config (default: the golden head from
    ``params``); ``chip``: a ``hw.ChipInstance`` whose nonideal CIM
    arrays run the conv trunk; ``adaptive_mode=False`` runs the paper's
    fixed-R dataflow (one r_max-sample round, decide); ``device``: None
    = the card (raises without CUDA), "cpu" on purpose.
    """

    def __init__(self, params, cfg, *, n_slots: int = 32,
                 policy: TriagePolicy = TriagePolicy(),
                 adaptive_mode: bool = True,
                 metrics: ServingMetrics | None = None,
                 head: dict | None = None,
                 hcfg: BayesHeadConfig | None = None,
                 chip=None, fused: bool = True, device=None):
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
        # Escalation rounds launched, wasted ones after the exit included.
        self.rounds_launched = 0
        # Featurized admission batches (one trunk pass each).
        self.admissions = 0
        self.cfg = cfg
        self.adaptive_mode = adaptive_mode
        self.fused = fused
        self.hcfg = hcfg or BayesHeadConfig(
            num_samples=policy.r_max, mode="rank16", grng=cfg.grng,
            compute_dtype=torch.float32, hoist_basis=True)
        self._params = _to_device(params, self.device)
        self._head = (to_serving(self._params["head"], self.hcfg)
                      if head is None else _to_device(head, self.device))
        self._trunk = (None if chip is None
                       else program_trunk(self._params, cfg, chip))
        self.r_step = policy.r_min if adaptive_mode else policy.r_max
        self.max_rounds = (math.ceil(policy.r_max / self.r_step)
                           if adaptive_mode else 1)
        self.pool: dict | None = None
        self.stats: dict | None = None
        self.base: np.ndarray | None = None

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

    # -- admission ------------------------------------------------------
    def featurize(self, images) -> dict:
        """Images [B, H, W, 1] -> activation-basis rows on the device."""
        x = torch.as_tensor(np.asarray(images), dtype=torch.float32,
                            device=self.device)
        feats = features(self._params, x, self.cfg, trunk=self._trunk)
        return activation_basis(self._head, feats, self.hcfg)

    def ensure_pool(self, like: dict) -> None:
        """Allocate the (pool, stats) device state shaped like ``like``
        (contiguous, as the decision kernel takes it)."""
        if self.pool is not None:
            return
        self.pool = {k: torch.zeros(v.shape, dtype=v.dtype,
                                    device=self.device)
                     for k, v in like.items()}
        self.stats = adaptive.init_stats(self.n_slots,
                                         like["y_mu"].shape[-1],
                                         device=self.device)

    def _admit(self) -> None:
        take = min(len(self.free), len(self.queue))
        if take == 0:
            return
        reqs = [self.queue.popleft() for _ in range(take)]
        imgs = np.stack([np.asarray(r.payload, np.float32) for r in reqs])
        if take < self.n_slots:                       # fixed-shape batch
            pad = np.repeat(imgs[-1:], self.n_slots - take, axis=0)
            imgs = np.concatenate([imgs, pad], axis=0)
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
        idx = torch.as_tensor(taken, dtype=torch.int64, device=self.device)
        self.ensure_pool(like=rows)
        for k, v in rows.items():                     # in place
            self.pool[k].index_copy_(0, idx, v[:take])
        for v in self.stats.values():
            v.index_fill_(0, idx, 0)
        self.metrics.mark(now)

    # -- rounds ---------------------------------------------------------
    def _one_round(self, base: torch.Tensor, mask: torch.Tensor):
        """Draw r_step samples for the masked slots, fold them into the
        statistics, finalize and decide.  -> (verdict, fin)."""
        grng = self.hcfg.grng
        idx = adaptive.stream_indices(base, self.stats["n"], self.r_step)
        sel = indexed_selections(grng.lfsr_seed, idx)  # = stream_selections
        if self.fused:
            decision_update(self.stats, self.pool, sel, grng,
                            sample_idx=idx, mask=mask)
        else:
            samples = mix_samples(self.pool, sel, self.hcfg, sample_idx=idx)
            self.stats = adaptive.update_stats(self.stats, samples, mask=mask)
        fin = adaptive.finalize(self.stats)
        if self.adaptive_mode:
            verdict = triage.decide(fin, self.policy,
                                    final=fin["n"] >= self.policy.r_max)
        else:
            verdict = triage.fixed_r_decide(fin, self.policy)
        return verdict, fin

    def _multi_round(self, base: torch.Tensor, active: torch.Tensor):
        """The fixed-length escalation loop with the device-side exit
        flag (module docstring).  -> (verdict, fin, rounds) on device."""
        verdict, fin = self._one_round(base, active)
        rounds = torch.ones((), dtype=torch.int32, device=self.device)
        looping = active.any() & ~(active & (verdict != ESCALATE)).any()
        for _ in range(self.max_rounds - 1):
            verdict, fin = self._one_round(base, active & looping)
            rounds += looping.to(torch.int32)
            looping = looping & ~(active & (verdict != ESCALATE)).any()
        self.rounds_launched += self.max_rounds
        return verdict, fin, rounds

    # -- retirement -----------------------------------------------------
    def _retire(self, slot_idx: int, verdict: int, fin: dict) -> None:
        slot = self.slots[slot_idx]
        req = slot.req
        now = time.perf_counter()
        self.metrics.mark(now)
        self.metrics.record(RequestRecord(
            rid=req.rid, verdict=int(verdict), n_samples=slot.n_samples,
            n_decisions=max(slot.n_decisions, 1),
            arrival_s=req.arrival_s, admit_s=slot.admit_s, done_s=now,
            prediction=int(fin["prediction"][slot_idx]),
            confidence=float(fin["confidence"][slot_idx]),
            mutual_information=float(fin["mutual_information"][slot_idx]),
            arrival_pc=req.arrival_pc))
        slot.req = None
        slot.n_samples = slot.n_decisions = 0
        self.free.append(slot_idx)

    def _retire_decided(self, active, verdict, fin, spent: int) -> int:
        """Charge samples to every active slot, retire those whose
        verdict left ESCALATE.  Returns the number retired."""
        retired = 0
        for i in np.nonzero(active)[0]:
            self.slots[i].n_samples += spent
            if verdict[i] != ESCALATE:
                self.slots[i].n_decisions = 1
                self._retire(i, verdict[i], fin)
                retired += 1
        return retired

    # -- main loop ------------------------------------------------------
    def start(self) -> None:
        """Reset the per-run selection-stream bases."""
        self.base = np.zeros((self.n_slots,), np.uint32)

    def step(self) -> bool:
        """One scheduler tick: admit, dispatch the escalation rounds,
        pull the verdicts once, retire.  False when nothing was active."""
        self._admit()
        if self.n_active == 0:
            return False
        active = self.active_mask()
        verdict, fin, rounds = self._multi_round(
            torch.as_tensor(self.base.astype(np.int64), device=self.device),
            torch.as_tensor(active, device=self.device))
        # ONE blocking device→host pull: verdict, prediction, confidence,
        # mutual information and the round count in a single transfer
        # (float64 holds each of them exactly).
        b = self.n_slots
        packed = torch.cat([
            torch.stack([verdict.double(), fin["prediction"].double(),
                         fin["confidence"].double(),
                         fin["mutual_information"].double()]).reshape(-1),
            rounds.double().reshape(1)]).cpu().numpy()
        self.host_syncs += 1
        host_fin = {"prediction": packed[b:2 * b].astype(np.int64),
                    "confidence": packed[2 * b:3 * b],
                    "mutual_information": packed[3 * b:4 * b]}
        spent = self.r_step * int(packed[4 * b])
        self._retire_decided(active, packed[:b].astype(np.int32), host_fin,
                             spent)
        return True

    def drain(self) -> dict:
        return self.metrics.summary()

    def run(self, max_ticks: int = 100_000) -> dict:
        self.start()
        for _ in range(max_ticks):
            if not self.step() and not self.queue:
                break
        return self.drain()
