"""Mission driver: fly the closed-loop SAR simulator from the CLI (port
of ``repro/launch/mission.py``).

Builds the world and fleet from flags, trains (or restores) the
weather-augmented detector, optionally binds every drone to a sampled
FeFET chip instance, flies the mission with one host pull per die group
and prints two summary lines.  It runs on the card unless ``--device
cpu`` is given.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.mission \\
      --grid 14 --victims 10 --drones 4 --steps 70 --episodes 2
  PYTHONPATH=src python -m repro_torch.launch.mission --policy deterministic
  PYTHONPATH=src python -m repro_torch.launch.mission \\
      --chip-instance 11 --chip-severity 2.5 [--uncalibrated]
  PYTHONPATH=src python -m repro_torch.launch.mission --device cpu \\
      --train-steps 3 --steps 10        # a quick run on the CPU

``--policy``: bayes_adaptive (default) | bayes_fixed | deterministic.
Telemetry is on unless ``--no-telemetry``: each die group's drift
status is printed, and drift advisories and heal events go through the
alert bus.  ``--age-rate`` (field seconds a step) flies the chip-bound
group aged, in ``--age-epochs`` segments; ``--auto-recalibrate`` heals
it in flight.

``--trace PATH`` writes a Chrome/Perfetto trace of the mission on the
simulated clock (``obs/trace.mission_trace`` of the logs, one track a
drone), ``--metrics-out PREFIX`` writes ``PREFIX.prom`` and
``PREFIX.json`` (``obs/registry.mission_registry``: the summary, each
die group's telemetry and drift, the alerts) and ``--profile DIR``
runs the detector and the rollout under ``torch.profiler``
(``obs/prof.trace_capture``).  All three read what the mission already
pulled; the step loop stays free of host syncs.
"""

from __future__ import annotations

import argparse


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--grid", type=int, default=14)
    ap.add_argument("--victims", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0,
                    help="world seed (episode e uses seed+e)")
    ap.add_argument("--corruption", default="snow",
                    choices=("fog", "frost", "motion", "snow"))
    ap.add_argument("--severity-hi", type=float, default=0.5,
                    help="worst-weather corner of the severity field")
    ap.add_argument("--drones", type=int, default=4)
    ap.add_argument("--battery-uJ", type=float, default=320.0,
                    help="per-sortie energy budget in microjoules")
    ap.add_argument("--steps", type=int, default=70)
    ap.add_argument("--episodes", type=int, default=1)
    ap.add_argument("--policy", default="bayes_adaptive",
                    choices=("bayes_adaptive", "bayes_fixed",
                             "deterministic"))
    ap.add_argument("--planner", default="lawnmower",
                    choices=("lawnmower", "infogain"))
    ap.add_argument("--flag-action", default="orbit",
                    choices=("orbit", "skip"))
    ap.add_argument("--conf-threshold", type=float, default=0.8)
    ap.add_argument("--mi-threshold", type=float, default=0.5)
    ap.add_argument("--r-min", type=int, default=4)
    ap.add_argument("--r-max", type=int, default=20)
    ap.add_argument("--chip-instance", type=int, default=None,
                    help="bind the fleet to a FeFET die sampled with "
                         "this seed (hw/ digital twin)")
    ap.add_argument("--chip-severity", type=float, default=1.0)
    ap.add_argument("--uncalibrated", action="store_true",
                    help="skip per-die head recalibration AND the "
                         "mission operating-point transfer")
    ap.add_argument("--age-rate", type=float, default=0.0,
                    help="simulated field seconds of FeFET aging per "
                         "mission step (hw/aging.py); 0 disables the "
                         "lifetime loop")
    ap.add_argument("--age-epochs", type=int, default=4,
                    help="age/heal segments the mission is cut into")
    ap.add_argument("--auto-recalibrate", action="store_true",
                    help="heal drift advisories in flight: recalibrate "
                         "the aged die between segments and redeploy "
                         "(hw/redeploy.py)")
    ap.add_argument("--no-telemetry", dest="telemetry",
                    action="store_false", default=True,
                    help="fly without the per-die-group device telemetry "
                         "and its drift check")
    ap.add_argument("--no-fused", dest="fused", action="store_false",
                    default=True)
    ap.add_argument("--train-steps", type=int, default=None,
                    help="detector training steps (default: the shared "
                         "1600-step detector)")
    ap.add_argument("--trace", default=None, metavar="PATH",
                    help="write a Chrome/Perfetto trace JSON of the "
                         "mission (a track a drone, on the simulated "
                         "clock) to PATH")
    ap.add_argument("--metrics-out", default=None, metavar="PREFIX",
                    help="write PREFIX.prom / PREFIX.json with the "
                         "mission summary, per-die telemetry and alerts")
    ap.add_argument("--profile", default=None, metavar="DIR",
                    help="run the detector and the rollout under "
                         "torch.profiler, its Chrome trace written into "
                         "DIR")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)

    from repro_torch.mission import (MissionPolicy, UavConfig, WorldConfig,
                                     fly_mission, trained_detector)
    from repro_torch.serving import TriagePolicy

    wcfg = WorldConfig(grid=args.grid, n_victims=args.victims,
                       seed=args.seed, corruption=args.corruption,
                       severity_hi=args.severity_hi)
    ucfg = UavConfig(n_drones=args.drones,
                     battery_J=args.battery_uJ * 1e-6)
    pol = MissionPolicy(
        mode=args.policy, planner=args.planner,
        flag_action=args.flag_action,
        triage=TriagePolicy(conf_threshold=args.conf_threshold,
                            mi_threshold=args.mi_threshold,
                            r_min=args.r_min, r_max=args.r_max))
    chips = None
    chip_note = ""
    if args.chip_instance is not None:
        from repro_torch.hw import VariationSpec, sample_instances
        chips = sample_instances(
            args.chip_instance, 1,
            VariationSpec().scaled(args.chip_severity))[0]
        chip_note = (f" [chip seed={args.chip_instance} "
                     f"sev={args.chip_severity} "
                     f"{'UNCAL' if args.uncalibrated else 'cal'}]")
    det_kw = {} if args.train_steps is None else {"steps": args.train_steps}
    lifetime = None
    if args.age_rate > 0.0 or args.auto_recalibrate:
        from repro_torch.hw.redeploy import LifetimeConfig
        lifetime = LifetimeConfig(age_rate=args.age_rate,
                                  epochs=args.age_epochs,
                                  auto_recalibrate=args.auto_recalibrate)
    from repro_torch.obs.prof import trace_capture
    with trace_capture(args.profile) as captured:
        params, cfg = trained_detector(corruption=args.corruption,
                                       severity_hi=args.severity_hi,
                                       device=args.device, **det_kw)
        res = fly_mission(wcfg, ucfg, pol, params=params, cfg=cfg,
                          chips=chips, calibrated=not args.uncalibrated,
                          n_steps=args.steps, n_episodes=args.episodes,
                          fused=args.fused, telemetry=args.telemetry,
                          lifetime=lifetime, device=args.device)
    s = res.summary
    print(f"[{args.policy}/{args.planner}] "
          f"{s['episodes']}x{s['n_drones']} drones on "
          f"{s['grid']}x{s['grid']}{chip_note}: "
          f"rescued {s['rescued']}/{s['victims']}, "
          f"rescue delay {s['rescue_delay_s']:.0f}s, "
          f"coverage {100 * s['coverage']:.0f}%, "
          f"false-verification rate "
          f"{100 * s['false_verification_rate']:.1f}% "
          f"({s['false_verifications']}/{s['verifications']})")
    print(f"{s['decisions']} decisions, "
          f"{s['mean_samples_per_decision']:.1f} samples/decision, "
          f"{s['orbits']} orbits; energy "
          f"{1e6 * s['energy_total_J']:.0f} uJ "
          f"(decisions {1e6 * s['energy_decision_J']:.2f}, verify "
          f"{1e6 * s['energy_verify_J']:.0f}, flight "
          f"{1e6 * s['energy_flight_J']:.0f}); "
          f"host syncs {res.host_syncs}")
    for group, lt in (res.lifetime or {}).items():
        print(f"[lifetime {group}] age {lt['age_s']:.0f}s: "
              f"{lt['advisories']} advisories, {lt['heals']} heals, "
              f"calib_epoch {lt['calib_epoch']}")
    for group, t in (res.telemetry or {}).items():
        drift = t["drift"]
        print(f"[telemetry {group}] {t['telemetry']['decisions']} "
              f"decisions, {t['telemetry']['rounds']} rounds; drift "
              f"{'ADVISORY' if drift['drifted'] else 'healthy'} "
              f"z_mean={drift['z_mean']:.2f} z_std={drift['z_std']:.2f}")
    # the alert bus over the finished mission: per-group drift statuses
    # and heal events as one advisory stream
    from repro_torch.obs.alerts import AlertBus
    bus = AlertBus()
    for group, t in (res.telemetry or {}).items():
        bus.observe_drift(t.get("drift"), source=f"mission/{group}")
    for group, lt in (res.lifetime or {}).items():
        for ev in lt.get("events", []):
            bus.observe_heal(ev, source=f"mission/{group}")
    alerts = bus.to_json() if bus.advisories else None
    if args.trace:
        import json
        import os
        from repro_torch.obs.trace import mission_trace
        d = os.path.dirname(args.trace)
        if d:
            os.makedirs(d, exist_ok=True)
        with open(args.trace, "w") as f:
            json.dump(mission_trace(res.logs), f)
        print(f"[trace] {args.trace}")
    if args.metrics_out:
        from repro_torch.obs.registry import mission_registry
        reg = mission_registry(s, telemetry=res.telemetry, alerts=alerts,
                               policy=args.policy, planner=args.planner)
        prom, js = reg.write(args.metrics_out)
        print(f"[metrics] {prom} {js}")
    if captured.path:
        print(f"[profile] {captured.path}")
    return s


if __name__ == "__main__":
    main()
