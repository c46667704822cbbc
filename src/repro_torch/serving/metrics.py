"""Per-request serving metrics + analytic energy accounting (port of
``repro/serving/metrics.py``; host-side numpy).

Each retired request carries its queueing and service latency, the
GRNG samples its decision drew and its triage verdict.  The summary
reports throughput, latency percentiles, mean samples per decision and
the FeFET engine's analytic energy those sample counts imply: one
µ-subarray MVM per placed block plus ``n_samples`` σε re-reads of the
Bayesian blocks, 640 aJ per GRNG sample.  With a compiled
``TileProgram`` (hw/tilemap.py) the accounting charges PLACED blocks and
the summary carries the deployed area and utilization.

Run metadata (``extra``, e.g. the chip instance served on) is merged
into the summary, and so are what the engine attaches at drain time:
its telemetry snapshot (``attach_telemetry``), its stage profile and
build counters (``attach_profile``: ``stage_profile``,
``compile_counters``) and its SLO snapshot (``attach_slo``: ``slo``),
under the reference's keys.  A record carries the lifecycle stamps of
the reference: the first dispatch covering its slot and the host pull
that brought its verdict.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np

from repro_torch.core import energy
from repro_torch.serving.triage import VERDICT_NAMES


@dataclasses.dataclass
class RequestRecord:
    """One retired request.  ``admit_s``/``done_s`` come from
    ``time.perf_counter``; ``arrival_pc`` is the monotonic twin of the
    wall-clock ``arrival_s`` (NaN falls back to ``arrival_s``).
    ``first_dispatch_s`` (the first dispatch covering the slot) and
    ``verdict_s`` (right after the host pull that brought the verdict)
    are on the same clock, NaN where the engine did not stamp them."""
    rid: int
    verdict: int                 # triage.ACCEPT or triage.FLAG
    n_samples: int               # GRNG samples spent on this decision
    n_decisions: int             # 1 for SAR
    arrival_s: float
    admit_s: float
    done_s: float
    prediction: int = -1
    confidence: float = float("nan")
    mutual_information: float = float("nan")
    arrival_pc: float = float("nan")
    first_dispatch_s: float = float("nan")
    verdict_s: float = float("nan")

    @property
    def _arrival(self) -> float:
        return (self.arrival_pc if math.isfinite(self.arrival_pc)
                else self.arrival_s)

    @property
    def queue_latency_s(self) -> float:
        return self.admit_s - self._arrival

    @property
    def service_latency_s(self) -> float:
        return self.done_s - self.admit_s

    @property
    def latency_s(self) -> float:
        return self.done_s - self._arrival

    @property
    def dispatch_wait_s(self) -> float:
        """Admission → the first dispatch that covered this slot."""
        return self.first_dispatch_s - self.admit_s

    @property
    def verdict_latency_s(self) -> float:
        """Time to verdict: arrival → the host pull that brought the
        verdict (NaN without the stamp; ``latency_s`` then stands in,
        which also holds the retirement)."""
        return self.verdict_s - self._arrival


@dataclasses.dataclass(frozen=True)
class DecisionCost:
    """Per-decision cost coefficients of one layer stack + placement:
        E(n) = e_fixed_J + n · e_per_sample_J
        T(n) = t_fixed_s + n · t_per_sample_s
    """
    e_fixed_J: float          # one MVM sweep over every placed block
    e_per_sample_J: float     # σε re-read of the Bayesian blocks
    grng_cells_per_sample: float
    t_fixed_s: float          # serial layer walk at n = 0
    t_per_sample_s: float     # per-sample σε latency share

    def decision_energy_J(self, n_samples):
        return self.e_fixed_J + n_samples * self.e_per_sample_J

    def decision_latency_s(self, n_samples):
        return self.t_fixed_s + n_samples * self.t_per_sample_s

    def grng_energy_aJ(self, n_samples):
        return (self.grng_cells_per_sample * n_samples
                * energy.GRNG_ENERGY_PER_SAMPLE * 1e18)


def _check_program(layers, tile_program) -> None:
    shapes = [s for _, s in tile_program.layers]
    if [dataclasses.astuple(s) for s in shapes] != \
            [dataclasses.astuple(s) for s in layers]:
        raise ValueError(
            "tile_program was compiled for a different layer stack")


def energy_terms(layers, tile_program=None) -> dict:
    """{e_fixed: J per decision, e_per_sample: J per GRNG sample,
    cells_per_sample: GRNG draws per sample}, from the compiler's placed
    blocks when ``tile_program`` is given, else logical tiles.  Every
    block is priced at the paper's physical 64×64 tile."""
    if tile_program is not None:
        _check_program(layers, tile_program)
        counts = list(tile_program.layer_block_counts().values())
    else:
        counts = [energy.tiles_for_layer(l) for l in layers]
    e_fixed = e_per_sample = cells = 0.0
    for l, nt in zip(layers, counts):
        e_fixed += nt * energy.TILE_MVM_ENERGY
        if l.bayesian:
            e_per_sample += nt * energy.SIGMA_MVM_ENERGY
            cells += nt * energy.TILE_DIM**2
    return {"e_fixed": e_fixed, "e_per_sample": e_per_sample,
            "cells_per_sample": cells}


def decision_cost(layers, tile_program=None,
                  terms: dict | None = None) -> DecisionCost:
    """The frozen per-decision cost struct of a layer stack."""
    t = terms if terms is not None else energy_terms(layers, tile_program)
    n_bayes = sum(1 for l in layers if l.bayesian)
    return DecisionCost(
        e_fixed_J=t["e_fixed"], e_per_sample_J=t["e_per_sample"],
        grng_cells_per_sample=t["cells_per_sample"],
        t_fixed_s=len(layers) * energy.MVM_LATENCY,
        t_per_sample_s=n_bayes * energy.MVM_LATENCY)


def decision_latency(n_samples: float, layers) -> float:
    """Analytic per-decision latency on the FeFET engine (§V-A): one MVM
    per deterministic layer, 1 + n_samples serial σε re-reads for a
    Bayesian layer."""
    t = 0.0
    for l in layers:
        t += ((1 + n_samples) if l.bayesian else 1) * energy.MVM_LATENCY
    return t


def placed_decision_latency(n_samples: float, layers, tile_program,
                            replicated: bool = False) -> float:
    """The serial layer walk charged with each layer's number of
    distinct passes; ``replicated`` credits Bayesian replicas (an
    optimistic bound)."""
    _check_program(layers, tile_program)
    t = 0.0
    for name, shape in tile_program.layers:
        span = len({p.pass_idx
                    for p in tile_program.layer_placements(name)})
        if shape.bayesian:
            r_eff = n_samples
            if replicated:
                rep = tile_program.replication_factor(name)
                if rep > 1:
                    r_eff = math.ceil(n_samples / rep)
            t += span * (1 + r_eff) * energy.MVM_LATENCY
        else:
            t += span * energy.MVM_LATENCY
    return t


def decision_energy(n_samples: float, layers, tile_program=None,
                    terms: dict | None = None) -> dict:
    """Analytic per-decision energy for ``n_samples`` drawn samples."""
    cost = decision_cost(layers, tile_program, terms=terms)
    return {
        "energy_J": cost.decision_energy_J(n_samples),
        "energy_sigma_J": n_samples * cost.e_per_sample_J,
        "grng_energy_aJ": cost.grng_energy_aJ(n_samples),
        "grng_samples": cost.grng_cells_per_sample * n_samples,
    }


def request_energy(rec: RequestRecord, layers, tile_program=None,
                   terms: dict | None = None) -> float:
    """Energy (J) one retired request spent: one fixed MVM sweep per
    decision plus its measured GRNG sample spend."""
    t = terms if terms is not None else energy_terms(layers, tile_program)
    return (max(rec.n_decisions, 1) * t["e_fixed"]
            + rec.n_samples * t["e_per_sample"])


class ServingMetrics:
    """Aggregates RequestRecords into the serving report."""

    def __init__(self, layers=None, extra: dict | None = None,
                 tile_program=None):
        self.records: list[RequestRecord] = []
        self.layers = layers          # energy.LayerShape list or None
        self.extra = dict(extra or {})
        self.tile_program = tile_program
        self.wall_start: float | None = None
        self.wall_end: float | None = None
        # snapshots the engine attaches at drain time, surfaced under
        # summary()["telemetry"], ["stage_profile"], ["compile_counters"]
        # and ["slo"]
        self.telemetry: dict | None = None
        self.stage_profile: dict | None = None
        self.compile_counters: dict | None = None
        self.slo: dict | None = None

    def record(self, rec: RequestRecord) -> None:
        self.records.append(rec)

    def attach_telemetry(self, snapshot: dict | None) -> None:
        self.telemetry = snapshot

    def attach_profile(self, stage_profile: dict | None,
                       compile_counters: dict | None = None) -> None:
        self.stage_profile = stage_profile
        self.compile_counters = compile_counters

    def attach_slo(self, snapshot: dict | None) -> None:
        self.slo = snapshot or None

    def mark(self, t: float) -> None:
        if self.wall_start is None:
            self.wall_start = t
        self.wall_end = t

    def summary(self) -> dict:
        if not self.records:
            nan = float("nan")
            out = {"requests": 0, "decisions": 0, "wall_s": nan,
                   "decisions_per_s": nan, "mean_samples_per_decision": nan,
                   "p50_latency_s": nan, "p95_latency_s": nan,
                   "p99_latency_s": nan, "mean_service_s": nan,
                   "mean_queue_wait_s": nan, "queue_wait_total_s": nan,
                   "service_total_s": nan, "queue_wait_share": nan,
                   "accept_fraction": nan, "flag_fraction": nan}
            if self.layers is not None:
                out.update(energy_per_decision_pJ=nan,
                           grng_energy_per_decision_aJ=nan,
                           energy_total_J=nan,
                           energy_saving_vs_R20=nan, model_latency_s=nan,
                           model_decisions_per_s=nan)
                if self.tile_program is not None:
                    out.update(placed_latency_s=nan,
                               placed_decisions_per_s=nan,
                               placed_latency_replicated_s=nan)
            out.update(self._tile_summary())
            if self.telemetry is not None:
                out["telemetry"] = self.telemetry
            out.update(self._perf_summary())
            out.update(self.extra)
            return out
        n_dec = sum(r.n_decisions for r in self.records)
        samples = np.array([r.n_samples / max(r.n_decisions, 1)
                            for r in self.records], np.float64)
        lat = np.array([r.latency_s for r in self.records], np.float64)
        service = np.array([r.service_latency_s for r in self.records])
        queue = np.array([r.queue_latency_s for r in self.records],
                         np.float64)
        verdicts = np.array([r.verdict for r in self.records])
        wall = ((self.wall_end - self.wall_start)
                if self.wall_start is not None else float("nan"))
        q_tot, s_tot = float(queue.sum()), float(service.sum())
        out = {
            "requests": len(self.records),
            "decisions": n_dec,
            "wall_s": wall,
            "decisions_per_s": n_dec / wall if wall and wall > 0 else
            float("nan"),
            "mean_samples_per_decision": float(samples.mean()),
            "p50_latency_s": float(np.percentile(lat, 50)),
            "p95_latency_s": float(np.percentile(lat, 95)),
            "p99_latency_s": float(np.percentile(lat, 99)),
            "mean_service_s": float(service.mean()),
            "mean_queue_wait_s": float(queue.mean()),
            "queue_wait_total_s": q_tot,
            "service_total_s": s_tot,
            "queue_wait_share": q_tot / (q_tot + s_tot)
                                if (q_tot + s_tot) > 0 else 0.0,
        }
        for code, name in VERDICT_NAMES.items():
            if name != "escalate":
                out[f"{name}_fraction"] = float((verdicts == code).mean())
        if self.layers is not None:
            n_bar = float(samples.mean())
            terms = energy_terms(self.layers, self.tile_program)
            e = decision_energy(n_bar, self.layers, terms=terms)
            e20 = decision_energy(energy.DEPLOY_R, self.layers, terms=terms)
            out["energy_per_decision_pJ"] = e["energy_J"] * 1e12
            out["grng_energy_per_decision_aJ"] = e["grng_energy_aJ"]
            out["energy_total_J"] = sum(
                request_energy(r, self.layers, terms=terms)
                for r in self.records)
            out["energy_saving_vs_R20"] = (
                e20["energy_J"] / max(e["energy_J"], 1e-30))
            lat_model = decision_latency(n_bar, self.layers)
            out["model_latency_s"] = lat_model
            out["model_decisions_per_s"] = 1.0 / lat_model
            if self.tile_program is not None:
                placed = placed_decision_latency(n_bar, self.layers,
                                                 self.tile_program)
                out["placed_latency_s"] = placed
                out["placed_decisions_per_s"] = 1.0 / placed
                out["placed_latency_replicated_s"] = \
                    placed_decision_latency(n_bar, self.layers,
                                            self.tile_program,
                                            replicated=True)
        out.update(self._tile_summary())
        if self.telemetry is not None:
            out["telemetry"] = self.telemetry
        out.update(self._perf_summary())
        out.update(self.extra)
        return out

    def _perf_summary(self) -> dict:
        out = {}
        if self.stage_profile is not None:
            out["stage_profile"] = self.stage_profile
        if self.compile_counters is not None:
            out["compile_counters"] = self.compile_counters
        if self.slo is not None:
            out["slo"] = self.slo
        return out

    def _tile_summary(self) -> dict:
        if self.tile_program is None:
            return {}
        p = self.tile_program
        return {
            "tile_area_mm2": p.physical_tiles_used * energy.TILE_AREA_MM2,
            "tile_utilization": p.utilization,
            "tile_passes": p.n_passes,
            "tops_w_mm2_effective": (energy.efficiency_density()
                                     * p.utilization),
        }
