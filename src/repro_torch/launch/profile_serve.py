"""Where the time of the SAR serving path goes on the card.

Runs ``serve_sar`` on the card (192 fog-mixed requests, 32 slots, the
given policy) and prints JSON lines:

  * ``wall``: decisions/s over ``--repeats`` unprofiled runs (min,
    median, max) for the fused and the ``fused=False`` path;
  * ``profile``: one ``engine.run()`` under ``torch.profiler``: the
    union of device kernel intervals against the run's wall time (device
    busy and idle share; the profiler's own host cost makes this idle
    share an upper bound), kernel launches per dispatch, the device time
    of the decision kernel and, on a chip instance, of the CIM kernel
    (each per launch and as a share of device-busy time), and the
    kernels with the most device time; and the engine's own host
    instruments over that run: the stage profile (count, mean, p50 and
    p99 a stage, ``obs/prof``) and the SLO snapshot's time to verdict
    (p50/p95/p99, mean, queue-wait share, ``obs/slo``), both inflated
    by the profiler's host cost.

``--chip-instance N`` serves on a die sampled with seed N (severity
``--chip-severity``, calibrated): the conv trunk runs through the CIM
kernel, three launches per admission.

Usage (on a machine with a CUDA card):
  PYTHONPATH=src python -m repro_torch.launch.profile_serve \\
      [--conf-threshold 0.7 --mi-threshold 0.05 --repeats 5] \\
      [--chip-instance 11 --chip-severity 2.0]
"""

from __future__ import annotations

import argparse
import json
import statistics
import time

import torch

from repro_torch.launch.serve import (make_sar_engine, make_sar_stream,
                                      serve_sar)
from repro_torch.serving import TriagePolicy


def _union_us(intervals) -> float:
    total, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


def profile_once(policy: TriagePolicy, n_requests: int, fused: bool,
                 chip=None) -> dict:
    """One engine run under the profiler; only the submissions and
    ``engine.run()`` are inside the profiled region (params, head, die
    and stream are built before it), so the time to verdict does not
    hold the profiler's start."""
    from torch.profiler import ProfilerActivity, profile
    serve_sar(n_requests=n_requests, n_slots=32, corrupt_frac=0.25,
              policy=policy, device="cuda", fused=fused,
              chip_instance=chip)                           # warm-up
    engine = make_sar_engine(policy=policy, fused=fused, device="cuda",
                             chip_instance=chip)
    reqs = make_sar_stream(n_requests, corrupt_frac=0.25)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for r in reqs:             # arrivals stamped once profiling runs
            engine.submit(r)
        out = engine.run()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    if not kernels:
        raise RuntimeError("the profiler recorded no device kernels")
    busy_us = _union_us((e.time_range.start, e.time_range.end)
                        for e in kernels)
    by_name: dict[str, list] = {}
    for e in kernels:
        by_name.setdefault(e.name, []).append(e.time_range.elapsed_us())
    top = sorted(by_name.items(), key=lambda kv: -sum(kv[1]))[:8]
    decision = [u for k, v in by_name.items() if "decision_stats" in k
                for u in v]
    cim = [u for k, v in by_name.items() if "cim_mvm" in k for u in v]
    int64 = sum(len(v) for k, v in by_name.items() if "<long" in k)
    return {
        "fused": fused, "requests": out["requests"],
        "host_syncs": engine.host_syncs,
        "rounds_launched": engine.rounds_launched,
        "run_wall_us_profiled": wall_us,
        "device_busy_us": busy_us,
        "device_idle_share_profiled": 1.0 - busy_us / wall_us,
        "device_kernels": len(kernels),
        "device_kernels_per_dispatch": len(kernels) / engine.host_syncs,
        "int64_elementwise_kernels": int64,
        "decision_kernel_launches": len(decision),
        "decision_kernel_device_us_mean": (
            statistics.fmean(decision) if decision else None),
        "decision_kernel_share_of_device_busy": sum(decision) / busy_us,
        "chip_instance": chip is not None,
        "admissions": engine.admissions,
        "cim_kernel_launches": len(cim),
        "cim_kernel_device_us_mean": statistics.fmean(cim) if cim else None,
        "cim_kernel_share_of_device_busy": sum(cim) / busy_us,
        "top_kernels": [{"name": k[:80], "count": len(v),
                         "device_us_total": sum(v),
                         "device_us_mean": statistics.fmean(v)}
                        for k, v in top],
        "stage_profile": {
            stage: {k: rec[k] for k in ("count", "mean_s", "p50_s",
                                        "p99_s")}
            for stage, rec in out["stage_profile"].items()},
        "slo": {k: out["slo"][k] for k in (
            "requests", "p50_s", "p95_s", "p99_s", "mean_s",
            "queue_wait_share")},
    }


def wall_rates(policy: TriagePolicy, n_requests: int, fused: bool,
               repeats: int, chip=None) -> dict:
    kw = dict(n_requests=n_requests, n_slots=32, corrupt_frac=0.25,
              policy=policy, device="cuda", fused=fused, chip_instance=chip)
    serve_sar(**kw)                                   # warm-up
    rates, syncs, samples = [], None, None
    for _ in range(repeats):
        out = serve_sar(**kw)
        rates.append(out["decisions"] / out["wall_s"])
        syncs = out["host_syncs_per_decision"]
        samples = out["mean_samples_per_decision"]
    return {"fused": fused, "chip_instance": chip is not None,
            "repeats": repeats,
            "decisions_per_s_min": min(rates),
            "decisions_per_s_median": statistics.median(rates),
            "decisions_per_s_max": max(rates),
            "host_syncs_per_decision": syncs,
            "mean_samples_per_decision": samples}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--conf-threshold", type=float, default=0.7)
    ap.add_argument("--mi-threshold", type=float, default=0.05)
    ap.add_argument("--requests", type=int, default=192)
    ap.add_argument("--repeats", type=int, default=5)
    ap.add_argument("--chip-instance", type=int, default=None,
                    help="serve on a die sampled with this seed")
    ap.add_argument("--chip-severity", type=float, default=1.0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_serve measures the card; none found")
    chip = None
    if args.chip_instance is not None:
        from repro_torch.hw import VariationSpec, sample_instances
        chip = sample_instances(args.chip_instance, 1,
                                VariationSpec().scaled(args.chip_severity))[0]
    policy = TriagePolicy(conf_threshold=args.conf_threshold,
                          mi_threshold=args.mi_threshold, r_min=4, r_max=20)
    print(json.dumps({"gpu": torch.cuda.get_device_name(0),
                      "policy": [args.conf_threshold, args.mi_threshold],
                      "chip_instance": args.chip_instance,
                      "chip_severity": args.chip_severity}))
    for fused in (True, False, False, True):          # in turns
        print(json.dumps({"wall": wall_rates(policy, args.requests, fused,
                                             args.repeats, chip)}),
              flush=True)
    for fused in (True, False):
        print(json.dumps({"profile": profile_once(policy, args.requests,
                                                  fused, chip)}), flush=True)


if __name__ == "__main__":
    main()
