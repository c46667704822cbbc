"""Online GRNG drift monitoring from serving-time telemetry (port of
``repro/obs/drift.py``).

``hw/calib.measured_grng`` measures a die's Fig. 9 sum statistics once,
at calibration time.  The telemetry probe (``obs/telemetry``) keeps
re-reading the same probe block while the die serves, and the monitor
here z-tests the streamed moments against a calibration-time reference,
so a deployment that drifts (temperature, read disturb, aging) raises a
recalibration advisory instead of silently degrading its verdicts.

The reference is MEASURED over the probe block (rows 0…P−1, column 0),
not taken from the analytic constants: a finite block's cells carry
fixed per-cell offsets, so even a golden die's probe mean sits ~0.1 µA
off the population constant.  Which config it is measured from is the
deployment's BELIEF: the measured instance config when calibrated
(``hcfg.grng``), the golden factory config otherwise (``cfg.grng``).

CLI: serve a golden die and a degraded uncalibrated die with telemetry
on, on the card unless ``--device cpu``, and assert that the monitor
separates them::

    python -m repro_torch.obs.drift --severity 2.5 --out drift_report.json
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

import numpy as np

from repro_torch import resolve_device
from repro_torch.core import clt_grng


@dataclasses.dataclass(frozen=True)
class DriftReference:
    """Calibration-time probe-block statistics to z-test against."""

    sum_mean_uA: float
    sum_std_uA: float
    n: float
    probe_cells: int = 32

    @staticmethod
    def measure(grng_cfg, probe_cells: int = 32, n_samples: int = 256,
                device=None) -> "DriftReference":
        """Measure the probe block of ``grng_cfg``: its raw sums drawn on
        ``device`` (None: the card), their mean and SD (ddof 1) in
        float64 on the host."""
        raw = clt_grng.raw_sums(grng_cfg, probe_cells, 1, n_samples,
                                device=resolve_device(device))
        raw = raw.cpu().numpy().astype(np.float64)
        return DriftReference(sum_mean_uA=float(raw.mean()),
                              sum_std_uA=float(raw.std(ddof=1)),
                              n=float(raw.size),
                              probe_cells=int(probe_cells))

    def to_dict(self) -> dict[str, Any]:
        return dataclasses.asdict(self)


@dataclasses.dataclass(frozen=True)
class DriftGate:
    """Advisory thresholds: z ≈ 5 keeps false fires negligible while a
    severity-2.5 die against a golden belief lands far beyond it;
    ``min_samples`` guards the small-n regime."""

    z_gate: float = 5.0
    min_samples: int = 256


@dataclasses.dataclass
class DriftStatus:
    """Outcome of one drift evaluation."""

    ok: bool
    drifted: bool
    z_mean: float
    z_std: float
    n: float
    measured_mean_uA: float
    measured_std_uA: float
    reference: DriftReference
    gate: DriftGate
    advisory: str | None = None

    def to_dict(self) -> dict[str, Any]:
        return {"ok": self.ok, "drifted": self.drifted,
                "z_mean": self.z_mean, "z_std": self.z_std, "n": self.n,
                "measured_mean_uA": self.measured_mean_uA,
                "measured_std_uA": self.measured_std_uA,
                "reference": self.reference.to_dict(),
                "gate": {"z_gate": self.gate.z_gate,
                         "min_samples": self.gate.min_samples},
                "advisory": self.advisory}


def _evaluate(n: float, s: float, ssq: float, ref: DriftReference,
              gate: DriftGate) -> DriftStatus:
    if n < gate.min_samples or ref.n < 2:
        nan = float("nan")
        return DriftStatus(ok=True, drifted=False, z_mean=nan, z_std=nan,
                           n=n, measured_mean_uA=nan, measured_std_uA=nan,
                           reference=ref, gate=gate)
    mean = s / n
    var = max((ssq - n * mean * mean) / (n - 1.0), 1e-12)
    std = math.sqrt(var)
    ref_var = max(ref.sum_std_uA ** 2, 1e-12)
    # two-sample z for the mean: stream and reference both carry
    # sampling error
    se_mean = ref.sum_std_uA * math.sqrt(1.0 / n + 1.0 / ref.n)
    z_mean = (mean - ref.sum_mean_uA) / max(se_mean, 1e-12)
    # log-variance-ratio z: Var[ln s²] ≈ 2/(n−1) for near-normal sums
    se_lv = math.sqrt(2.0 / max(n - 1.0, 1.0) + 2.0 / max(ref.n - 1.0, 1.0))
    z_std = math.log(var / ref_var) / max(se_lv, 1e-12)
    drifted = max(abs(z_mean), abs(z_std)) > gate.z_gate
    advisory = None
    if drifted:
        advisory = (
            f"GRNG drift detected on probe block ({ref.probe_cells} cells): "
            f"measured sum stats ({mean:.3f} ± {std:.3f}) µA vs reference "
            f"({ref.sum_mean_uA:.3f} ± {ref.sum_std_uA:.3f}) µA, "
            f"|z_mean|={abs(z_mean):.1f}, |z_std|={abs(z_std):.1f} "
            f"(gate {gate.z_gate:.1f}). Schedule hw/calib recalibration "
            f"(calib.measured_grng + prepare_instance_head) for this die.")
    return DriftStatus(ok=not drifted, drifted=drifted,
                       z_mean=float(z_mean), z_std=float(z_std), n=n,
                       measured_mean_uA=float(mean),
                       measured_std_uA=float(std), reference=ref, gate=gate,
                       advisory=advisory)


def drift_status(snapshot: dict[str, Any], ref: DriftReference,
                 gate: DriftGate | None = None) -> DriftStatus:
    """Evaluate a telemetry snapshot (or its ``grng`` sub-dict)."""
    gate = gate or DriftGate()
    g = snapshot.get("grng", snapshot)
    return _evaluate(float(g["n"]), float(g["sum"]), float(g["sumsq"]),
                     ref, gate)


class DriftMonitor:
    """Streaming monitor: fold snapshots in, ask for the status anytime."""

    def __init__(self, ref: DriftReference, gate: DriftGate | None = None):
        self.ref = ref
        self.gate = gate or DriftGate()
        self.n = 0.0
        self.sum = 0.0
        self.sumsq = 0.0

    def observe(self, n: float, s: float, ssq: float) -> None:
        self.n += float(n)
        self.sum += float(s)
        self.sumsq += float(ssq)

    def observe_snapshot(self, snapshot: dict[str, Any]) -> None:
        g = snapshot.get("grng", snapshot)
        self.observe(g["n"], g["sum"], g["sumsq"])

    def status(self) -> DriftStatus:
        return _evaluate(self.n, self.sum, self.sumsq, self.ref, self.gate)


def reference_for(cfg, hcfg=None, *, calibrated: bool = True,
                  probe_cells: int = 32, n_samples: int = 256,
                  device=None) -> DriftReference:
    """The reference matching a deployment's belief about its GRNG: the
    measured instance config (``hcfg.grng``) when calibrated, the
    factory config (``cfg.grng``) otherwise or with ``hcfg=None``;
    measured on ``device`` (None: the card)."""
    grng = hcfg.grng if (calibrated and hcfg is not None) else cfg.grng
    return DriftReference.measure(grng, probe_cells=probe_cells,
                                  n_samples=n_samples, device=device)


def _main(argv=None) -> int:
    import argparse
    import json
    import os

    from repro_torch.obs.log import get_logger

    log = get_logger("obs:drift")
    ap = argparse.ArgumentParser(
        description="Drift-monitor smoke: serve a golden and a degraded "
                    "die with telemetry on; assert the monitor separates "
                    "them.")
    ap.add_argument("--severity", type=float, default=2.5)
    ap.add_argument("--chip-seed", type=int, default=11)
    ap.add_argument("--requests", type=int, default=96)
    ap.add_argument("--slots", type=int, default=16)
    ap.add_argument("--z-gate", type=float, default=5.0)
    ap.add_argument("--out", type=str, default=None)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)

    from repro_torch.hw import VariationSpec, sample_instances
    from repro_torch.launch.serve import serve_sar

    gate = DriftGate(z_gate=args.z_gate)
    report: dict[str, Any] = {"z_gate": args.z_gate,
                              "severity": args.severity, "dies": {}}

    def serve_and_judge(tag: str, **kw) -> DriftStatus:
        out = serve_sar(n_requests=args.requests, n_slots=args.slots,
                        device=args.device, **kw)
        # serve_sar measured the belief reference; re-judge the streamed
        # moments under this CLI's gate
        ref = DriftReference(**out["drift"]["reference"])
        st = drift_status(out["telemetry"], ref, gate)
        report["dies"][tag] = {"status": st.to_dict(),
                               "decisions": out["telemetry"]["decisions"]}
        return st

    # golden die: reality matches the factory belief
    st_g = serve_and_judge("golden")
    log.info("golden die", drifted=st_g.drifted,
             z_mean=round(st_g.z_mean, 2), z_std=round(st_g.z_std, 2))
    # degraded, uncalibrated die: the physics moved, the belief did not
    inst = sample_instances(args.chip_seed, 1,
                            VariationSpec().scaled(args.severity))[0]
    st_d = serve_and_judge("degraded_uncalibrated", chip_instance=inst,
                           calibrated=False)
    if st_d.advisory:
        log.warning(st_d.advisory)
    log.info("degraded die", drifted=st_d.drifted,
             z_mean=round(st_d.z_mean, 2), z_std=round(st_d.z_std, 2))

    separated = (not st_g.drifted) and st_d.drifted
    report["separated"] = separated
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(report, f, indent=2)
        log.info("report written", path=args.out, separated=separated)
    if not separated:
        log.error("drift monitor failed to separate golden from degraded",
                  golden_drifted=st_g.drifted, degraded_drifted=st_d.drifted)
        return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(_main())
