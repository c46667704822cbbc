"""SAR serving CLI: a thin layer over the port's engine (port of
``serve_sar`` and its CLI from ``repro/launch/serve.py``).

The stream is synthetic SARD patches with a corrupted fraction mixed
in, classified by the Bayesian-head CNN with per-slot escalation.  It
runs on the card unless ``--device cpu`` is given, and prints one
summary line.  ``--chip-instance N`` serves on a die sampled with seed
N: the conv trunk on its nonideal CIM arrays, the Bayesian head on its
degraded GRNG, recalibrated per chip unless ``--uncalibrated``.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.serve --arch sar_cnn \\
      --requests 192 --corrupt-frac 0.25 --corruption fog [--fixed] \\
      [--chip-instance 11 --chip-severity 2.0 --uncalibrated]

The LM archs, fleets, lifetime, arrival processes, SLOs and drift
monitoring of the reference CLI wait for later slices.
"""

from __future__ import annotations

import argparse
import time

import torch

from repro_torch import resolve_device
from repro_torch.core.energy import LayerShape
from repro_torch.hw import compile_network
from repro_torch.serving import (Request, SarServingEngine, ServingMetrics,
                                 TriagePolicy)


def sar_layer_shapes(cfg) -> list:
    """Energy-model layers: the conv trunk as im2col matmuls + the
    Bayesian head."""
    shapes, c_in = [], 1
    for c_out in cfg.channels:
        shapes.append(LayerShape(cfg.kernel**2 * c_in, c_out))
        c_in = c_out
    shapes.append(LayerShape(cfg.channels[-1], cfg.n_classes, bayesian=True))
    return shapes


def make_sar_stream(n_requests: int, *, corrupt_frac: float = 0.0,
                    corruption: str = "fog", severity: float = 1.0,
                    image_size: int = 32, seed: int = 7, batch: int = 32,
                    step0: int = 1000) -> list:
    """Request stream over synthetic SARD with a corrupted head of every
    batch; ``meta={'corrupted': bool, 'label': int}``.  ``step0`` keeps
    serving off the training stream."""
    from repro_torch.data.sard import SardConfig, batch_at, corrupted_batch
    dcfg = SardConfig(image_size=image_size, seed=seed)
    reqs, rid = [], 0
    n_dirty = int(round(batch * corrupt_frac))
    for b in range((n_requests + batch - 1) // batch):
        clean = batch_at(dcfg, step0 + b, batch)
        dirty = (corrupted_batch(dcfg, step0 + b, batch, corruption,
                                 severity) if n_dirty else clean)
        for i in range(min(batch, n_requests - rid)):
            corrupted = i < n_dirty
            img = (dirty if corrupted else clean)["images"][i]
            reqs.append(Request(
                rid=rid, payload=img.numpy(), arrival_s=time.time(),
                meta={"corrupted": corrupted,
                      "label": int(clean["labels"][i])}))
            rid += 1
    return reqs


def make_sar_engine(*, n_slots: int = 32, adaptive: bool = True,
                    policy: TriagePolicy | None = None, params=None,
                    cfg=None, seed: int = 0, chip_instance=None,
                    calibrated: bool = True, fused: bool = True,
                    device=None) -> SarServingEngine:
    """The engine ``serve_sar`` drives: untrained params from
    ``init_sar_cnn`` seeded ``3 + seed`` unless ``params`` is given,
    tilemap-true energy accounting (placed blocks of the compiled layer
    stack), on ``device`` (None = the card).

    ``chip_instance``: a ``hw.ChipInstance`` (or an int seed: one die
    from the default ``VariationSpec``).  The engine then serves fully
    on that die: the conv trunk on its nonideal CIM arrays, the head
    deployed by ``prepare_instance_head`` on ``device``, calibration
    included (``calibrated`` selects the per-chip recalibration over the
    golden factory transform).  The summary gains the die's metadata.
    """
    from repro_torch.models.sar_cnn import SarCnnConfig, init_sar_cnn
    cfg = cfg or SarCnnConfig()
    device = resolve_device(device)
    if params is None:
        params = init_sar_cnn(torch.Generator().manual_seed(3 + seed), cfg)
    policy = policy or TriagePolicy(conf_threshold=0.7, mi_threshold=0.05)
    layers = sar_layer_shapes(cfg)
    head = hcfg = None
    extra = {}
    if chip_instance is not None:
        from repro_torch.core.bayes_layer import sigma_of
        from repro_torch.core.sampling import BayesHeadConfig
        from repro_torch.hw import prepare_instance_head, sample_instances
        if not hasattr(chip_instance, "grng"):
            chip_instance = sample_instances(int(chip_instance), 1)[0]
        base_hcfg = BayesHeadConfig(
            num_samples=policy.r_max, mode="rank16", grng=cfg.grng,
            compute_dtype=torch.float32, hoist_basis=True)
        dev_head = {k: v.to(device) for k, v in params["head"].items()}
        head, hcfg = prepare_instance_head(
            dev_head["mu"], sigma_of(dev_head), base_hcfg,
            chip_instance, calibrated=calibrated)
        extra = {"chip_id": chip_instance.chip_id,
                 "chip_device_seed": chip_instance.device_seed,
                 "chip_read_sigma": chip_instance.read_sigma,
                 "chip_temp_c": chip_instance.temp_c,
                 "calibrated": bool(calibrated)}
    metrics = ServingMetrics(layers=layers, extra=extra,
                             tile_program=compile_network(layers))
    return SarServingEngine(params, cfg, n_slots=n_slots, policy=policy,
                            adaptive_mode=adaptive, metrics=metrics,
                            head=head, hcfg=hcfg, chip=chip_instance,
                            fused=fused, device=device)


def serve_sar(*, n_requests: int = 128, n_slots: int = 32,
              adaptive: bool = True, policy: TriagePolicy | None = None,
              corrupt_frac: float = 0.0, corruption: str = "fog",
              params=None, cfg=None, seed: int = 0, chip_instance=None,
              calibrated: bool = True, fused: bool = True,
              device=None) -> dict:
    """SAR image-stream serving on ``device`` (None = the card) through
    ``make_sar_engine`` (``chip_instance``/``calibrated``: serve on a
    sampled die, see there).  Returns the metrics summary plus host
    syncs, rounds launched, admissions and per-request verdicts."""
    engine = make_sar_engine(n_slots=n_slots, adaptive=adaptive,
                             policy=policy, params=params, cfg=cfg,
                             seed=seed, chip_instance=chip_instance,
                             calibrated=calibrated, fused=fused,
                             device=device)
    reqs = make_sar_stream(n_requests, corrupt_frac=corrupt_frac,
                           corruption=corruption,
                           image_size=engine.cfg.image_size)
    t0 = time.perf_counter()
    for r in reqs:
        engine.submit(r)
    out = engine.run()
    out["wall_s"] = time.perf_counter() - t0
    out["device"] = str(engine.device)
    out["host_syncs"] = engine.host_syncs
    out["host_syncs_per_decision"] = (engine.host_syncs
                                      / max(out["decisions"], 1))
    out["rounds_launched"] = engine.rounds_launched
    out["admissions"] = engine.admissions
    out["flagged_fraction"] = out.get("flag_fraction", float("nan"))
    out["verdicts"] = [
        {"rid": r.rid, "verdict": r.verdict, "prediction": r.prediction,
         "confidence": r.confidence,
         "mutual_information": r.mutual_information,
         "n_samples": r.n_samples} for r in engine.metrics.records]
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", choices=("sar_cnn",), required=True)
    ap.add_argument("--slots", type=int, default=None,
                    help="decode slots (default 32)")
    ap.add_argument("--requests", type=int, default=None)
    ap.add_argument("--fixed", action="store_true",
                    help="fixed R=r_max per decision (paper baseline)")
    ap.add_argument("--no-fused", dest="fused", action="store_false",
                    default=True,
                    help="use the materializing mix_samples → "
                         "update_stats path instead of the decision "
                         "kernel (verdict-identical)")
    ap.add_argument("--conf-threshold", type=float, default=0.8)
    ap.add_argument("--mi-threshold", type=float, default=0.5)
    ap.add_argument("--r-min", type=int, default=4)
    ap.add_argument("--r-max", type=int, default=20)
    ap.add_argument("--corrupt-frac", type=float, default=0.0)
    ap.add_argument("--corruption", default="fog",
                    choices=("fog", "frost", "motion", "snow"))
    ap.add_argument("--chip-instance", type=int, default=None,
                    help="serve on a sampled FeFET chip instance drawn "
                         "with this seed")
    ap.add_argument("--chip-severity", type=float, default=1.0,
                    help="variation severity multiplier for the sampled "
                         "chip")
    ap.add_argument("--uncalibrated", action="store_true",
                    help="skip per-instance recalibration (golden "
                         "factory transform on the degraded chip)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    args = ap.parse_args(argv)
    chip = None
    if args.chip_instance is not None:
        from repro_torch.hw import VariationSpec, sample_instances
        chip = sample_instances(args.chip_instance, 1,
                                VariationSpec().scaled(args.chip_severity))[0]
    policy = TriagePolicy(conf_threshold=args.conf_threshold,
                          mi_threshold=args.mi_threshold,
                          r_min=args.r_min, r_max=args.r_max)
    out = serve_sar(n_requests=args.requests or 128,
                    n_slots=args.slots or 32, adaptive=not args.fixed,
                    policy=policy, corrupt_frac=args.corrupt_frac,
                    corruption=args.corruption, chip_instance=chip,
                    calibrated=not args.uncalibrated, fused=args.fused,
                    device=args.device)
    chip_note = ""
    if chip is not None:
        chip_note = (f" [chip seed={args.chip_instance} "
                     f"id={out['chip_id']} "
                     f"device_seed={out['chip_device_seed']} "
                     f"read_sigma={out['chip_read_sigma']:.4f} "
                     f"T={out['chip_temp_c']:.1f}C "
                     f"{'cal' if out['calibrated'] else 'UNCAL'}]")
    print(f"[sar] {out['decisions']} decisions in {out['wall_s']:.2f}s "
          f"({out['decisions_per_s']:.1f}/s) on {out['device']}; "
          f"mean samples/decision "
          f"{out['mean_samples_per_decision']:.1f}; "
          f"{100 * out['flagged_fraction']:.1f}% flagged; GRNG "
          f"{out['grng_energy_per_decision_aJ']:.0f} aJ/decision; "
          f"host syncs/decision {out['host_syncs_per_decision']:.3f}"
          + chip_note)


if __name__ == "__main__":
    main()
