#!/usr/bin/env python3
"""Split the port's mission outcomes by input, against the reference.

The port's episode equals the reference's lane for lane when both see
the same worlds, exposures and detector (``tests/test_torch_mission.py``).
At ``benchmarks/mission_bench.py``'s default scale the port's outcomes
still differ from the reference's bench run, so the difference lies in
one of three inputs: the maps, the rendered exposures or the detector.
This script flies the PORT's episode, on the CPU, on three input sets:

  a  the port's worlds, renders and detector (what ``fly_mission`` does);
  b  the reference's worlds and rendered exposures, the port's detector;
  c  the reference's worlds and exposures, the reference's detector
     (trained by its ``trained_detector`` into a fresh directory and
     carried across with ``bridge.params_from_jax``);

and, as the anchor, the reference's own ``fly_mission`` on its inputs.
Each on the ideal die and on the seed-11 severity-2.5 die, in
bayes_adaptive and deterministic mode.  In (b) and (c) the die's
operating-point calibration also sees the reference's calibration
patches (the same draw, ``batch_at(SardConfig(seed=0xCA1))``).

Then it compares the inputs' statistics: the maps (victim count,
severity range), the renders (per-corruption pixel moments over victim
and empty cells), the detectors' training batches (SARD seed 7 clean
and snow-corrupted, the same moments) and the two detectors on the same
patches (detection rate and margin moments on both packages' renders).
``--spread-seeds`` trains both detectors on further training streams
and flies each on the reference's worlds, to show how far a detector's
draw alone moves the outcome.

Usage (CPU; ~10-20 minutes, most of it rendering the reference's
exposure table of 2 × 196 cells × 210 looks):

  PYTHONPATH=src JAX_PLATFORMS=cpu python scripts/mission_input_split.py \\
      --work /tmp/split --out /tmp/split/rows.json

``--work`` holds the two detectors' checkpoints (trained there when
missing: ~30 s for the reference, ~90 s for the port on 8 CPU cores) and the
exposure table cache.  It imports both packages, so it is a tool of the
repository, not part of the port.
"""

from __future__ import annotations

import argparse
import json
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.hw import VariationSpec as JVariationSpec
from repro.hw import sample_instances as j_sample
from repro.mission import detector as jdet
from repro.mission import policy as jpolicy
from repro.mission import rollout as jroll
from repro.mission import uav as juav
from repro.mission import world as jworld
from repro.data import sard as jsard
from repro_torch.bridge import instance_from_tree, params_from_jax, \
    worlds_from_jax
from repro_torch.mission import detector as tdet
from repro_torch.mission import policy as tpolicy
from repro_torch.mission import rollout as troll
from repro_torch.mission import uav as tuav
from repro_torch.mission import world as tworld
from repro_torch.models import sar_cnn as tsar

GRID, VICTIMS, WORLD_SEED = 14, 10, 0
DRONES, BATTERY_J = 4, 320e-6
STEPS, EPISODES = 70, 2
DIE_SEED, DIE_SEVERITY = 11, 2.5
MODES = ("bayes_adaptive", "deterministic")
SARD_BATCHES = 40
ROW_KEYS = ("rescued", "victims", "rescue_delay_s", "false_verification_rate",
            "mean_samples_per_decision", "verifications", "detections",
            "orbits", "coverage")


def reference_exposures(wcfg, worlds, cache: Path) -> np.ndarray:
    """The reference's renders at every cell and look of the mission:
    [E, n_cells, 3·STEPS, H, W, 1] float32 (cached in ``cache``)."""
    if cache.exists():
        return np.load(cache)
    c, looks = wcfg.n_cells, 3 * STEPS
    out = np.empty((EPISODES, c, looks, wcfg.image_size, wcfg.image_size,
                    1), np.float32)
    render = jax.jit(lambda w, wid, cells, look: jworld.observe_cells(
        wcfg, w, wid, cells, look))
    for e in range(EPISODES):
        for look in range(looks):
            cells = jnp.arange(c, dtype=jnp.int32)
            out[e, :, look] = np.asarray(render(
                worlds, jnp.full((c,), e, jnp.int32), cells,
                jnp.full((c,), look, jnp.int32)))
    np.save(cache, out)
    return out


def reference_detector(work: Path, data_seed: int = jdet.DATA_SEED):
    """The reference's ``trained_detector`` at its defaults (training
    stream ``data_seed``), trained into a fresh directory (so its
    checkpoint restore is never reached) and kept as an npz."""
    import tempfile
    from repro.models.sar_cnn import SarCnnConfig
    cache = work / f"ref_params_s{data_seed}.npz"
    if not cache.exists():
        saved, jdet.DATA_SEED = jdet.DATA_SEED, data_seed
        try:
            params, _ = jdet.trained_detector(
                ckpt_dir=Path(tempfile.mkdtemp(dir=work)))
        finally:
            jdet.DATA_SEED = saved
        flat = {f"conv{i}_{k}": np.asarray(c[k])
                for i, c in enumerate(params["convs"]) for k in ("w", "b")}
        flat.update({f"head_{k}": np.asarray(v)
                     for k, v in params["head"].items()})
        np.savez(cache, **flat)
    z = np.load(cache)
    n = len([k for k in z.files if k.endswith("_w")])
    return ({"convs": [{"w": jnp.asarray(z[f"conv{i}_w"]),
                        "b": jnp.asarray(z[f"conv{i}_b"])}
                       for i in range(n)],
             "head": {k[5:]: jnp.asarray(z[k]) for k in z.files
                      if k.startswith("head_")}}, SarCnnConfig())


def port_detector(work: Path, data_seed: int = tdet.DATA_SEED):
    """The port's ``trained_detector`` on the CPU, training stream
    ``data_seed``."""
    saved, tdet.DATA_SEED = tdet.DATA_SEED, data_seed
    try:
        return tdet.trained_detector(ckpt_dir=work / f"port_det_s{data_seed}",
                                     device="cpu")
    finally:
        tdet.DATA_SEED = saved


def port_group_run(params, cfg, pol, chip, worlds, patches) -> dict:
    """The port's ``fly_mission`` for one die group on given worlds
    (and, on a die, given operating-point calibration patches)."""
    wcfg = tworld.WorldConfig(grid=GRID, n_victims=VICTIMS, seed=WORLD_SEED)
    ucfg = tuav.UavConfig(n_drones=DRONES, battery_J=BATTERY_J)
    cost = troll.sar_mission_cost(cfg)
    head, hcfg = troll._prepare_group_head(params, cfg, pol.triage, chip,
                                           True)
    bias = troll.operating_point_bias(params, cfg, head, chip,
                                      images=patches)
    trunk = None if chip is None else tsar.program_trunk(params, cfg, chip)
    fn = troll._episode_fn(wcfg, ucfg, pol, cfg, hcfg, trunk, cost, True,
                           STEPS)
    maps0 = {k: torch.as_tensor(v) for k, v in
             troll.init_maps(wcfg, EPISODES, cfg.n_classes).items()}
    out = fn(params, head, torch.as_tensor(bias), worlds,
             tuav.init_fleet(ucfg, GRID, EPISODES, device="cpu"), maps0,
             tuav.fleet_bindings(ucfg, GRID, EPISODES, device="cpu"))
    got = troll._pull(dict(zip(("fleet", "maps", "logs"), out)))
    np_worlds = {k: v.numpy() for k, v in worlds.items()
                 if k != "exposures"}
    return troll.summarize(wcfg, ucfg, pol, cost, STEPS, np_worlds,
                           got["maps"], got["logs"], got["fleet"])


def row(s: dict) -> dict:
    return {k: s[k] for k in ROW_KEYS}


def map_stats(victims, severity) -> dict:
    v = np.asarray(victims, bool)
    s = np.asarray(severity, np.float64)
    return {"victims": v.sum(1).tolist(), "severity_min": float(s.min()),
            "severity_max": float(s.max()), "severity_mean": float(s.mean())}


def pixel_stats(images, victims_per_image) -> dict:
    """Pixel moments and the snow-speck share (pixels at 2.0), over the
    victim and the empty cells' images."""
    out = {}
    x = np.asarray(images, np.float64).reshape(len(victims_per_image), -1)
    for tag, sel in (("victim", victims_per_image),
                     ("empty", ~victims_per_image)):
        xs = x[sel]
        out[tag] = {"mean": float(xs.mean()), "std": float(xs.std()),
                    "max_mean": float(xs.max(1).mean()),
                    "speck_share": float((xs == 2.0).mean())}
    return out


def detector_stats(params, cfg, images, labels) -> dict:
    """Detection rate, accuracy and the margin's moments of a port-side
    detector (µ head, float trunk) on the same images."""
    from repro_torch.core.bayes_layer import to_serving
    from repro_torch.core.sampling import BayesHeadConfig
    gold = to_serving(params["head"], BayesHeadConfig(
        mode="rank16", grng=cfg.grng, compute_dtype=torch.float32))
    with torch.no_grad():
        y = (tsar.features(params, torch.as_tensor(images), cfg)
             @ gold["mu_prime"]).numpy().astype(np.float64)
    m = y[:, 1] - y[:, 0]
    lab = np.asarray(labels, bool)
    return {"detect_rate_victim": float((m[lab] > 0).mean()),
            "detect_rate_empty": float((m[~lab] > 0).mean()),
            "margin_mean_victim": float(m[lab].mean()),
            "margin_mean_empty": float(m[~lab].mean()),
            "margin_std_victim": float(m[lab].std()),
            "margin_std_empty": float(m[~lab].std())}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--work", type=Path, required=True)
    ap.add_argument("--out", type=Path, required=True)
    ap.add_argument("--threads", type=int, default=4)
    ap.add_argument("--spread-seeds", type=int, nargs="*", default=(),
                    help="more training streams: both detectors trained "
                         "on each, their statistics and the ideal "
                         "bayes_adaptive row on the reference's inputs")
    args = ap.parse_args()
    torch.set_num_threads(args.threads)
    args.work.mkdir(parents=True, exist_ok=True)
    t_start = time.perf_counter()
    report: dict = {"scale": {"grid": GRID, "victims": VICTIMS,
                              "world_seed": WORLD_SEED, "drones": DRONES,
                              "battery_J": BATTERY_J, "steps": STEPS,
                              "episodes": EPISODES,
                              "die": [DIE_SEED, DIE_SEVERITY]},
                    "rows": {}, "stats": {}}

    # the detectors: the reference's (fresh directory: its restore is
    # never reached on a first call) and the port's, both 1600 steps
    j_params, j_cfg = reference_detector(args.work)
    t_params, t_cfg = port_detector(args.work)
    j_as_port = params_from_jax(jax.device_get(j_params))

    # the worlds
    jw = jworld.WorldConfig(grid=GRID, n_victims=VICTIMS, seed=WORLD_SEED)
    tw = tworld.WorldConfig(grid=GRID, n_victims=VICTIMS, seed=WORLD_SEED)
    j_worlds = jworld.stack_worlds(jw, EPISODES)
    table = reference_exposures(jw, j_worlds, args.work / "exposures.npy")
    bridged = worlds_from_jax(jax.device_get(j_worlds), table)
    t_worlds = tworld.stack_worlds(tw, EPISODES, device="cpu")
    dcfg = jsard.SardConfig(image_size=32, seed=0xCA1)
    ref_patches = np.concatenate([np.asarray(jsard.batch_at(dcfg, i, 64)
                                             ["images"]) for i in range(4)])

    j_chip = j_sample(DIE_SEED, 1, JVariationSpec().scaled(DIE_SEVERITY))[0]
    t_chip = instance_from_tree(j_chip.to_tree())
    dies = {"ideal": (None, None), "die": (j_chip, t_chip)}
    ju = juav.UavConfig(n_drones=DRONES, battery_J=BATTERY_J)
    tu = tuav.UavConfig(n_drones=DRONES, battery_J=BATTERY_J)

    for die, (jc, tc) in dies.items():
        for mode in MODES:
            key = f"{die}/{mode}"
            t0 = time.perf_counter()
            ref = jroll.fly_mission(jw, ju, jpolicy.MissionPolicy(mode=mode),
                                    params=j_params, cfg=j_cfg, chips=jc,
                                    n_steps=STEPS, n_episodes=EPISODES,
                                    telemetry=False)
            a = troll.fly_mission(tw, tu, tpolicy.MissionPolicy(mode=mode),
                                  params=t_params, cfg=t_cfg, chips=tc,
                                  n_steps=STEPS, n_episodes=EPISODES,
                                  telemetry=False, device="cpu")
            b = port_group_run(t_params, t_cfg,
                               tpolicy.MissionPolicy(mode=mode), tc,
                               bridged, ref_patches)
            c = port_group_run(j_as_port, t_cfg,
                               tpolicy.MissionPolicy(mode=mode), tc,
                               bridged, ref_patches)
            report["rows"][key] = {"reference": row(ref.summary),
                                   "a": row(a.summary), "b": row(b),
                                   "c": row(c)}
            print(key, json.dumps(report["rows"][key]),
                  f"{time.perf_counter() - t0:.1f}s", flush=True)

    # the inputs' statistics
    victims_j = np.asarray(j_worlds["victims"])
    report["stats"]["maps"] = {
        "reference": map_stats(victims_j, j_worlds["severity"]),
        "port": map_stats(t_worlds["victims"].numpy(),
                          t_worlds["severity"].numpy())}
    c = jw.n_cells
    cells = torch.arange(c).repeat(EPISODES)
    wid = torch.arange(EPISODES).repeat_interleave(c)
    lab = victims_j.reshape(-1)
    renders = {"reference": [], "port": []}
    for look in range(0, 3 * STEPS, 15):
        renders["reference"].append(table[:, :, look].reshape(
            (EPISODES * c,) + table.shape[3:]))
        port_vict = t_worlds["victims"].reshape(-1).numpy()
        renders["port"].append((tworld.observe_cells(
            tw, t_worlds, wid, cells, look).numpy(), port_vict))
    ref_imgs = np.concatenate(renders["reference"])
    ref_lab = np.tile(lab, len(renders["reference"]))
    port_imgs = np.concatenate([x for x, _ in renders["port"]])
    port_lab = np.concatenate([v for _, v in renders["port"]])
    report["stats"]["renders"] = {
        "reference": pixel_stats(ref_imgs, ref_lab),
        "port": pixel_stats(port_imgs, port_lab)}
    report["stats"]["detectors_on_reference_renders"] = {
        "reference_detector": detector_stats(j_as_port, t_cfg, ref_imgs,
                                             ref_lab),
        "port_detector": detector_stats(t_params, t_cfg, ref_imgs,
                                        ref_lab)}
    report["stats"]["detectors_on_port_renders"] = {
        "reference_detector": detector_stats(j_as_port, t_cfg, port_imgs,
                                             port_lab),
        "port_detector": detector_stats(t_params, t_cfg, port_imgs,
                                        port_lab)}
    # the detectors' training data: SARD seed 7's first batches, clean
    # and as each trainer corrupts them (snow at per-image severities
    # ~ U(0, 0.5))
    j_sard = jsard.SardConfig(image_size=32, seed=jdet.DATA_SEED)
    t_sard = tdet.SardConfig(image_size=32, seed=tdet.DATA_SEED)
    batches = {"reference_clean": [], "reference_train": [],
               "port_clean": [], "port_train": []}
    labels = {"reference": [], "port": []}
    for step in range(SARD_BATCHES):
        b = jsard.batch_at(j_sard, step, jdet.TRAIN_BATCH)
        k1, k2 = jax.random.split(jax.random.fold_in(
            jax.random.PRNGKey(0xA06), step))
        sev = jax.random.uniform(k1, (jdet.TRAIN_BATCH,), maxval=0.5)
        batches["reference_clean"].append(np.asarray(b["images"]))
        batches["reference_train"].append(np.asarray(
            jsard.corrupt(b["images"], k2, sev, "snow")))
        labels["reference"].append(np.asarray(b["labels"], bool))
        t = tdet.training_batch(t_sard, step, "snow", 0.5)
        batches["port_clean"].append(tdet.batch_at(
            t_sard, step, tdet.TRAIN_BATCH)["images"].numpy())
        batches["port_train"].append(t["images"].numpy())
        labels["port"].append(t["labels"].numpy().astype(bool))
    report["stats"]["sard_training_batches"] = {
        k: pixel_stats(np.concatenate(v), np.concatenate(
            labels[k.split("_")[0]])) for k, v in batches.items()}

    # the draw: both detectors from other training streams, on the
    # reference's renders and worlds
    spread = report["stats"]["spread"] = {}
    for seed in args.spread_seeds:
        jp, _ = reference_detector(args.work, seed)
        tp, _ = port_detector(args.work, seed)
        jp_port = params_from_jax(jax.device_get(jp))
        pol = tpolicy.MissionPolicy()
        spread[seed] = {
            "reference_detector": detector_stats(jp_port, t_cfg, ref_imgs,
                                                 ref_lab),
            "port_detector": detector_stats(tp, t_cfg, ref_imgs, ref_lab),
            "reference_detector_row": row(port_group_run(
                jp_port, t_cfg, pol, None, bridged, ref_patches)),
            "port_detector_row": row(port_group_run(
                tp, t_cfg, pol, None, bridged, ref_patches))}
        print("spread", seed, json.dumps(spread[seed]), flush=True)
    report["seconds"] = time.perf_counter() - t_start
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps(report, indent=1))
    print(json.dumps(report["stats"], indent=1))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
