"""Device-resident mission rollouts: the closed loop (port of
``repro/mission/rollout.py``).

An episode is a Python loop over mission steps that never waits for the
card: every step, for the whole (episodes × drones) fleet batch of one
die group,

  observe   render every drone's cell on the device (world.observe_cells)
  featurize the serving engine's trunk + activation basis
            (``serving.engine.featurize``; the die's CIM trunk when a
            chip is bound), less the die's operating-point logit bias
  decide    ``serving.engine.token_decision``: the escalation schedule
            through the decision kernel
  route     accept + detection → verification descent; a flagged
            detection → orbit: two more looks, each re-featurized and
            decided at full R, descend if either detects again
  ledger    battery and clock from ``serving.metrics.DecisionCost`` plus
            flight and maneuver costs (uav.py)
  plan      lawnmower or information-gain next cell (policy.py)

The reference runs an episode as one ``lax.scan`` and skips the orbit
under ``lax.cond`` when nothing is flagged.  Eager PyTorch has neither,
and a Python ``if`` on a device value would wait for the card every
step.  So the orbit runs every step and everything it produces is taken
only under the ``flagged`` mask (re-look detections, confidence,
entropy; its decisions spend nothing on unflagged lanes), which gives
the reference's logs exactly, at the price of two more trunk sweeps and
two more decision rounds a step.  Map updates go through flat indices
wid·n_cells + cell with ``scatter_reduce``; sectors partition the map,
so no two lanes of a step write one cell.

``fly_mission`` groups drones by die: each group runs its episode and
is read back in ONE blocking device→host transfer (``host_syncs``
counts them), then the groups' logs and maps merge.

Telemetry (on by default, as in the reference) rides the step loop as
device tensors updated in place and comes home in the group's one pull;
the orbit's decisions count only on steps where something is flagged
(the reference's ``lax.cond``).  With a ``lifetime`` (``hw/redeploy.
LifetimeConfig``) each die group is flown in ``epochs`` segments over
ABSOLUTE step indices, so its decisions draw the streams of the
unsegmented mission; between segments the die ages, its drift monitor
folds the telemetry, and an advisory may heal it: one pull a segment.
``devices`` (the reference's ``slot_axis``/``mesh``) cuts each die
group's episodes × drones batch into slot shards, one a device (the
list may repeat one): every decision round goes through
``decision_stats_sharded`` (one launch a run of shards on one device)
with read noise keyed on global lanes, so
the logs are the unsharded mission's bit for bit; a batch that does not
divide takes the unsharded kernel, as the reference's.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch import float32_math, resolve_device
from repro_torch.core.hashing import MASK32
from repro_torch.mission import policy as mpolicy
from repro_torch.mission import uav as muav
from repro_torch.mission import world as mworld
from repro_torch.mission.policy import MissionPolicy
from repro_torch.mission.uav import UavConfig
from repro_torch.mission.world import WorldConfig
from repro_torch.obs.drift import drift_status, reference_for
from repro_torch.obs.telemetry import (TelemetryConfig, init_telemetry,
                                       record_decisions)
from repro_torch.obs.telemetry import snapshot as telemetry_snapshot
from repro_torch.serving import adaptive
from repro_torch.serving.engine import _to_device, featurize, token_decision
from repro_torch.serving.metrics import DecisionCost, decision_cost
from repro_torch.serving.triage import ACCEPT, FLAG


def sar_mission_cost(cfg) -> DecisionCost:
    """The ledger's per-decision cost: tilemap-true (compiled placement)
    for the SAR detector, the numbers ``serve_sar``'s summaries charge."""
    from repro_torch.hw import compile_network
    from repro_torch.launch.serve import sar_layer_shapes
    layers = sar_layer_shapes(cfg)
    return decision_cost(layers, compile_network(layers))


def _episode_fn(wcfg: WorldConfig, ucfg: UavConfig, pol: MissionPolicy,
                cfg, hcfg, trunk, cost: DecisionCost, fused: bool,
                n_steps: int, tcfg: TelemetryConfig | None = None,
                step0: int = 0, devices=None):
    """-> episode(params, head, logit_bias, worlds, fleet0, maps0, bind,
    telem0=None) -> (fleet, maps, logs {name: [n_steps, B]}), all on the
    device, plus the telemetry when ``telem0`` is given.

    ``trunk``: the die's programmed arrays (``models.sar_cnn.
    program_trunk``), None on the ideal die.  ``step0``: the absolute
    mission step of the first iteration; a segmented mission (the
    lifetime loop) scans absolute steps, so every decision keeps the
    stream base of the unsegmented mission.  ``tcfg``: the telemetry's
    config; ``telem0`` is updated in place, the other inputs are not
    modified.  ``devices``: the decision rounds' slot shards
    (``token_decision``'s ``shard``), None for none."""
    tri = pol.triage
    grid, n_cells = wcfg.grid, wcfg.n_cells
    decide = orbit = None
    if pol.bayesian:
        adaptive_mode = pol.mode == "bayes_adaptive"
        schedule = (adaptive.escalation_schedule(tri) if adaptive_mode
                    else (tri.r_max,))

        def decide(rows, base, active, telem, launched=None):
            out = token_decision(rows, base, active, hcfg=hcfg, policy=tri,
                                 adaptive_mode=adaptive_mode,
                                 schedule=schedule, fused=fused,
                                 telem=telem, tcfg=tcfg, launched=launched,
                                 shard=devices)
            return out[:3]

        if pol.flag_action == "orbit":
            def orbit(rows, base, active, telem, launched):
                out = token_decision(rows, base, active, hcfg=hcfg,
                                     policy=tri, adaptive_mode=False,
                                     schedule=(tri.r_max,), fused=fused,
                                     telem=telem, tcfg=tcfg,
                                     launched=launched, shard=devices)
                return out[:3]

    def step(params, head, logit_bias, worlds, bind, fleet, maps, t, telem):
        wid, cells = bind["wid"], fleet["pos"]
        n_batch = cells.shape[0]
        lane = torch.arange(n_batch, dtype=torch.int64, device=cells.device)
        active = fleet["energy_J"] < ucfg.battery_J

        def look_at(look):
            """Observe and featurize one exposure, at the die's
            operating point (per-class logit bias subtracted)."""
            imgs = mworld.observe_cells(wcfg, worlds, wid, cells, look)
            rows = featurize(params, head, imgs, cfg, hcfg, trunk)
            rows["y_mu"] = rows["y_mu"] - logit_bias
            return rows

        def detection(rows):
            return rows["y_mu"].argmax(-1).to(torch.int32)

        def bases(j):
            """Decision slot j of 3 per (step, drone): the stream bases."""
            return ((3 * t + j) * n_batch + lane) * tri.r_max & MASK32

        # exposure 3·t: the scene is persistent, the noise and the
        # transient weather are drawn anew at every look
        rows = look_at(3 * t)
        orbited = torch.zeros((n_batch,), dtype=torch.bool,
                              device=cells.device)
        if not pol.bayesian:
            logp = torch.log_softmax(rows["y_mu"].to(torch.float32), -1)
            pred = logp.argmax(-1).to(torch.int32)
            conf = torch.exp(logp.amax(-1))
            pred_ent = -(torch.exp(logp) * logp).sum(-1)
            verdict = torch.full((n_batch,), ACCEPT, dtype=torch.int32,
                                 device=cells.device)
            spent = torch.zeros((n_batch,), dtype=torch.int32,
                                device=cells.device)
            want_verify = pred == 1           # verify every detection
            if telem is not None:
                # no sampled statistics here: the softmax's quality
                # fields keep the histograms comparable across modes
                record_decisions(telem, tcfg, {
                    "probs": torch.exp(logp), "confidence": conf,
                    "predictive_entropy": pred_ent,
                    "mutual_information": torch.zeros_like(conf),
                    "n": torch.zeros_like(verdict)}, verdict, active)
        else:
            # the detection is the µ-MVM's; the posterior gates it
            pred = detection(rows)
            verdict, fin, spent = decide(rows, bases(0), active, telem)
            conf = fin["confidence"]
            pred_ent = fin["predictive_entropy"]
            want_verify = (verdict == ACCEPT) & (pred == 1)
            if orbit is not None:
                flagged = active & (verdict == FLAG) & (pred == 1)
                # the reference runs the orbit only when this holds
                any_flagged = flagged.any()
                relook = torch.zeros_like(flagged)
                for j in (1, 2):
                    rows_j = look_at(3 * t + j)
                    _, fin_j, spent_j = orbit(rows_j, bases(j), flagged,
                                              telem, any_flagged)
                    relook = relook | (detection(rows_j) == 1)
                    conf = torch.where(flagged, fin_j["confidence"], conf)
                    pred_ent = torch.where(
                        flagged, fin_j["predictive_entropy"], pred_ent)
                    spent = spent + spent_j       # 0 on unflagged lanes
                orbited = flagged
                want_verify = want_verify | (flagged & relook)

        flat = wid.long() * n_cells + cells.long()
        truth = worlds["victims"].reshape(-1)[flat]
        already = (torch.isfinite(maps["rescued_t"].reshape(-1)[flat])
                   | (maps["cleared"].reshape(-1)[flat] > 0))
        verify = active & want_verify & ~already
        found = verify & truth
        false_verify = verify & ~truth

        # ledger: an orbit re-featurizes twice and re-samples, so it
        # charges 2·e_fixed more and its samples
        spent_f = spent.to(torch.float32)
        n_dec = 1.0 + 2.0 * orbited.to(torch.float32)
        e_dec = n_dec * cost.e_fixed_J + spent_f * cost.e_per_sample_J
        t_dec = n_dec * cost.t_fixed_s + spent_f * cost.t_per_sample_s
        e_step = (ucfg.flight_energy_J + e_dec
                  + torch.where(orbited, ucfg.orbit_energy_J, 0.0)
                  + torch.where(verify, ucfg.verify_energy_J, 0.0))
        t_step = (ucfg.flight_time_s + t_dec
                  + torch.where(orbited, ucfg.orbit_time_s, 0.0)
                  + torch.where(verify, ucfg.verify_time_s, 0.0))
        energy = fleet["energy_J"] + torch.where(active, e_step, 0.0)
        time_s = fleet["time_s"] + torch.where(active, t_step, 0.0)

        def scatter(name, src, reduce):
            m = maps[name]
            return m.reshape(-1).scatter_reduce(0, flat, src.to(m.dtype),
                                                reduce).reshape(m.shape)

        ent = maps["entropy"].reshape(-1)
        ent_seen = torch.where(found, 0.0, pred_ent)
        maps = {
            "rescued_t": scatter("rescued_t",
                                 torch.where(found, time_s, torch.inf),
                                 "amin"),
            "cleared": scatter("cleared", verify, "amax"),
            "visited": scatter("visited", active, "amax"),
            "entropy": ent.scatter(0, flat, torch.where(
                active, ent_seen, ent[flat])).reshape(maps["entropy"].shape),
        }

        path_k = fleet["path_k"] + active.to(torch.int32)
        ent_view = maps["entropy"][wid.long()]
        if pol.planner == "infogain":
            # never loiter: the just-observed cell is out this turn
            here = torch.arange(n_cells, device=cells.device)[None] \
                == cells.long()[:, None]
            ent_view = torch.where(here, -torch.inf, ent_view)
        nxt = mpolicy.next_cell(pol, grid, sector=bind["sector"],
                                path_k=path_k, pos=cells, entropy=ent_view,
                                sector_mask=bind["sector_mask"])
        fleet = {"pos": torch.where(active, nxt, cells), "path_k": path_k,
                 "energy_J": energy, "time_s": time_s}
        log = {"cell": cells, "active": active, "verdict": verdict,
               "prediction": pred, "confidence": conf, "spent": spent,
               "orbited": orbited, "verify": verify, "found": found,
               "false_verify": false_verify, "truth": truth,
               "e_decision_J": torch.where(active, e_dec, 0.0),
               "energy_J": energy, "time_s": time_s}
        return fleet, maps, log

    def episode(params, head, logit_bias, worlds, fleet0, maps0, bind,
                telem0=None):
        fleet, maps, logs = fleet0, maps0, []
        with float32_math():
            for t in range(step0, step0 + n_steps):
                fleet, maps, log = step(params, head, logit_bias, worlds,
                                        bind, fleet, maps, t, telem0)
                logs.append(log)
        logs = {k: torch.stack([lg[k] for lg in logs]) for k in logs[0]}
        if telem0 is None:
            return fleet, maps, logs
        return fleet, maps, logs, telem0

    return episode


def init_maps(wcfg: WorldConfig, n_episodes: int, n_classes: int) -> dict:
    """The mission maps before the first step, on the host: nobody
    rescued, cleared or visited, every cell at the prior entropy
    ln(n_classes).  [n_episodes, n_cells] each."""
    shape = (n_episodes, wcfg.n_cells)
    return {"rescued_t": np.full(shape, np.inf, np.float32),
            "cleared": np.zeros(shape, np.int32),
            "visited": np.zeros(shape, np.int32),
            "entropy": np.full(shape, np.log(n_classes), np.float32)}


def _np_dtype(t: torch.Tensor) -> np.dtype:
    return np.dtype(str(t.dtype).removeprefix("torch."))


def _pull(tree: dict) -> dict:
    """Nested dicts of device tensors -> numpy arrays, in ONE blocking
    device→host transfer: every leaf is packed into one float64 vector
    (float64 holds bool, int32 and float32 values exactly)."""
    leaves = []

    def flatten(t):
        if isinstance(t, dict):
            for v in t.values():
                flatten(v)
        else:
            leaves.append(t)

    flatten(tree)
    packed = torch.cat([v.reshape(-1).to(torch.float64)
                        for v in leaves]).cpu().numpy()
    out_leaves, off = [], 0
    for v in leaves:
        n = v.numel()
        out_leaves.append(packed[off:off + n].astype(_np_dtype(v))
                          .reshape(v.shape))
        off += n
    it = iter(out_leaves)

    def rebuild(t):
        if isinstance(t, dict):
            return {k: rebuild(v) for k, v in t.items()}
        return next(it)

    return rebuild(tree)


@dataclasses.dataclass
class MissionResult:
    summary: dict
    logs: dict           # numpy [n_steps, E·D] arrays, fleet order
    maps: dict           # merged {rescued_t, cleared, visited, entropy}
    worlds: dict         # numpy {victims, severity, seed} [E, ...]
    host_syncs: int      # blocking device→host pulls: one per die group,
    #                      or one per segment of an aged group
    # per die group: {"drones", "telemetry": snapshot, "drift": status
    # dict}; None with telemetry off
    telemetry: dict | None = None
    # per AGED die group: the controller's report plus advisory and
    # epoch counts; None when no lifetime loop ran
    lifetime: dict | None = None


def _group_base_hcfg(cfg, tri):
    from repro_torch.core.sampling import BayesHeadConfig
    return BayesHeadConfig(num_samples=tri.r_max, mode="rank16",
                           grng=cfg.grng, compute_dtype=torch.float32,
                           hoist_basis=True)


def _prepare_group_head(params, cfg, tri, chip, calibrated: bool):
    """(head, serving hcfg) for one die group on the params' device: the
    golden transform when ``chip`` is None, else hw/calib's per-instance
    deployment."""
    from repro_torch.core.bayes_layer import sigma_of
    from repro_torch.hw import prepare_instance_head
    return prepare_instance_head(params["head"]["mu"],
                                 sigma_of(params["head"]),
                                 _group_base_hcfg(cfg, tri), chip,
                                 calibrated=calibrated)


def operating_point_bias(params, cfg, head, chip, n_patches: int = 256,
                         images=None) -> np.ndarray:
    """Per-die detection operating-point transfer: a logit bias [N] to
    subtract from y_mu (zeros when ``chip`` is None).

    A degraded conv trunk shifts and compresses the margin y₁ − y₀ and
    so moves the die's alarm rate.  ``n_patches`` held-out SARD patches
    (``images``: [n, H, W, 1], default ``batch_at(SardConfig(seed=
    0xCA1))``'s) go through the golden model and through the die, and
    the margin offset τ that gives the die the golden chip's alarm rate
    is the quantile of the die's margins (no labels needed).  Runs on
    the params' device; the margins come back in one transfer."""
    if chip is None:
        return np.zeros((cfg.n_classes,), np.float32)
    if cfg.n_classes != 2:
        raise NotImplementedError(
            "operating-point transfer is margin-based (binary heads)")
    from repro_torch.core.bayes_layer import to_serving
    from repro_torch.core.sampling import BayesHeadConfig
    from repro_torch.data.sard import SardConfig, batch_at
    from repro_torch.models.sar_cnn import features
    dev = params["head"]["mu"].device
    if images is None:
        dcfg = SardConfig(image_size=cfg.image_size, seed=0xCA1)
        images = torch.cat([batch_at(dcfg, i, 64)["images"]
                            for i in range((n_patches + 63) // 64)])
        images = images[:n_patches]
    imgs = torch.tensor(np.asarray(images), dtype=torch.float32,
                        device=dev)
    gold = to_serving(params["head"], BayesHeadConfig(
        mode="rank16", grng=cfg.grng, compute_dtype=torch.float32))
    with float32_math():
        y_g = features(params, imgs, cfg) @ gold["mu_prime"]
        y_d = features(params, imgs, cfg, chip=chip) @ head[
            "mu_prime"].to(torch.float32)
    y = _pull({"g": y_g, "d": y_d})
    q = float((y["g"][:, 1] - y["g"][:, 0] > 0).mean())
    tau = float(np.quantile(y["d"][:, 1] - y["d"][:, 0], 1.0 - q))
    return np.asarray([0.0, tau], np.float32)


def _group_bias(params, cfg, head, chip, calibrated: bool) -> torch.Tensor:
    """The operating-point bias on the head's device (zeros
    uncalibrated)."""
    bias = operating_point_bias(params, cfg, head, chip) \
        if calibrated else np.zeros((cfg.n_classes,), np.float32)
    return torch.as_tensor(bias, device=head["mu_prime"].device)


def group_episode(wcfg: WorldConfig, ucfg: UavConfig, pol: MissionPolicy,
                  params, cfg, chip, calibrated: bool, cost: DecisionCost,
                  fused: bool, n_steps: int,
                  tcfg: TelemetryConfig | None = None, devices=None):
    """One die group's deployment, on the params' device: the head
    (``_prepare_group_head``), the operating-point bias (zeros
    uncalibrated), the die's trunk arrays, and the episode over them
    (its decisions over the slot shards ``devices``, None for none).
    -> (episode, head, bias, hcfg); ``episode(params, head, bias,
    worlds, fleet0, maps0, bind[, telem0])`` runs the step loop with no
    host sync."""
    from repro_torch.models.sar_cnn import program_trunk
    head, hcfg = _prepare_group_head(params, cfg, pol.triage, chip,
                                     calibrated)
    trunk = None if chip is None else program_trunk(params, cfg, chip)
    episode = _episode_fn(wcfg, ucfg, pol, cfg, hcfg, trunk, cost, fused,
                          n_steps, tcfg, devices=devices)
    return episode, head, _group_bias(params, cfg, head, chip,
                                      calibrated), hcfg


def _fly_group_lifetime(wcfg, ucfg, pol, cfg, chip, cost, fused,
                        n_steps, tcfg, params, calibrated, worlds,
                        fleet0_g, maps0, bind_g, lifetime, devices=None):
    """One AGED die group's mission: ``lifetime.epochs`` segments over
    absolute steps.  Between segments the die moves to the age its step
    count implies (the stale view keeps the bias, a µ'-only quantity),
    the cumulative telemetry's delta folds into the drift monitor and,
    with ``auto_recalibrate``, an advisory heals the die: recalibration
    at its age, a new ``calib_epoch`` and a re-derived bias.  The
    carry (fleet, maps, telemetry) stays on the device; each segment
    makes one pull.  -> (fleet, maps, logs, telemetry snapshot,
    controller, host syncs, advisories), on the host."""
    from repro_torch.core.bayes_layer import sigma_of
    from repro_torch.hw.redeploy import SelfHealingController
    from repro_torch.models.sar_cnn import program_trunk
    ctl = SelfHealingController(
        chip, params["head"]["mu"], sigma_of(params["head"]),
        _group_base_hcfg(cfg, pol.triage), calibrated=calibrated,
        spec=lifetime.spec, gate=lifetime.gate,
        probe_cells=tcfg.probe_cells)
    head, hcfg = ctl.head, ctl.hcfg
    bias = _group_bias(params, cfg, head, chip, calibrated)
    trunk = program_trunk(params, cfg, chip)
    epochs = max(1, int(lifetime.epochs))
    seg = -(-n_steps // epochs)
    fleet, maps = fleet0_g, maps0
    telem = init_telemetry(tcfg, pol.triage.r_max, bias.device)
    logs_parts: list[dict] = []
    step0 = n_syncs = advisories = 0
    while step0 < n_steps:
        ns = min(seg, n_steps - step0)
        if step0:
            head, hcfg = ctl.advance(lifetime.age_rate * step0)
        fn = _episode_fn(wcfg, ucfg, pol, cfg, hcfg, trunk, cost, fused,
                         ns, tcfg, step0, devices)
        fleet, maps, logs, telem = fn(params, head, bias, worlds, fleet,
                                      maps, bind_g, telem)
        # the single blocking pull of this segment
        got = _pull({"fleet": fleet, "maps": maps, "logs": logs,
                     "telem": telem})
        n_syncs += 1
        logs_parts.append(got["logs"])
        snap = telemetry_snapshot(got["telem"], tcfg)
        status = ctl.observe_snapshot(snap)
        if status.drifted:
            advisories += 1
        if lifetime.auto_recalibrate and status.drifted:
            ctl.heal(status)
            head, hcfg = ctl.view()
            if calibrated:
                bias = _group_bias(params, cfg, ctl.head, chip, True)
        step0 += ns
    logs_g = {k: np.concatenate([p[k] for p in logs_parts], axis=0)
              for k in logs_parts[0]}
    return (got["fleet"], got["maps"], logs_g, snap, ctl, n_syncs,
            advisories)


def fly_mission(wcfg: WorldConfig, ucfg: UavConfig, pol: MissionPolicy,
                *, params=None, cfg=None, chips=None,
                calibrated: bool = True, n_steps: int = 96,
                n_episodes: int = 1, fused: bool = True,
                telemetry: bool | TelemetryConfig = True, lifetime=None,
                devices=None, mesh=None, device=None) -> MissionResult:
    """Fly ``n_episodes`` independent missions for the whole fleet on
    ``device`` (None = the card; "cpu" on purpose).

    ``chips``: None (ideal fleet), one ``hw.ChipInstance`` (the whole
    fleet on that die), or a sequence of per-drone instances/None:
    drones are grouped by die and each group flies its sectors with one
    blocking pull.  Episodes are independent worlds (seeds wcfg.seed+e)
    batched into the decision kernel's slot dimension.  ``params``:
    default random params from a generator seeded 3.

    ``telemetry``: each die group's device telemetry, home in the
    group's pull; its snapshot and drift status (against the group's
    calibration-time belief) land in ``MissionResult.telemetry``.
    ``lifetime`` (``hw/redeploy.LifetimeConfig``): each chip-bound group
    ages ``lifetime.age_rate`` field seconds a step, flown in
    ``lifetime.epochs`` segments (one pull each) with drift watch and,
    with ``auto_recalibrate``, heals in flight; ideal groups and
    inactive lifetimes keep the one-pull path.  ``devices``: shard each
    die group's episodes × drones batch over these torch devices (may
    repeat one; module docstring), the reference's ``slot_axis``/
    ``mesh``; a JAX ``mesh`` has no counterpart and raises.
    """
    if mesh is not None:
        raise NotImplementedError(
            "the port shards a mission over devices=[torch devices], not "
            "a JAX mesh")
    from repro_torch.models.sar_cnn import SarCnnConfig, init_sar_cnn
    dev = resolve_device(device)
    if devices is not None:
        devices = [resolve_device(x) for x in devices]
    cfg = cfg or SarCnnConfig()
    if params is None:
        params = init_sar_cnn(torch.Generator().manual_seed(3), cfg)
    params = _to_device(params, dev)
    d, e = ucfg.n_drones, n_episodes
    if chips is None or not isinstance(chips, (tuple, list)):
        chips = [chips] * d
    if len(chips) != d:
        raise ValueError(f"chips: expected {d} per-drone entries, "
                         f"got {len(chips)}")
    cost = sar_mission_cost(cfg)
    host_worlds = mworld.stack_worlds(wcfg, e, device="cpu")
    dev_worlds = _to_device(host_worlds, dev)
    fleet0 = muav.init_fleet(ucfg, wcfg.grid, e, device=dev)
    bind = muav.fleet_bindings(ucfg, wcfg.grid, e, device=dev)
    maps_merged = init_maps(wcfg, e, cfg.n_classes)
    maps0 = {k: torch.as_tensor(v, device=dev)
             for k, v in maps_merged.items()}

    groups: dict[int, list[int]] = {}
    for di, chip in enumerate(chips):
        groups.setdefault(id(chip), []).append(di)

    if telemetry is True:
        telemetry = TelemetryConfig()
    tcfg = telemetry or None
    lt_active = lifetime is not None and lifetime.active
    if lt_active and tcfg is None:
        raise ValueError("lifetime missions watch drift through the "
                         "device-resident telemetry probe — telemetry "
                         "must stay enabled")

    logs_full: dict[str, np.ndarray] = {}
    fleet_final = {k: np.zeros(tuple(v.shape), _np_dtype(v))
                   for k, v in fleet0.items()}
    host_syncs = 0
    telemetry_out: dict | None = {} if tcfg else None
    lifetime_out: dict | None = {} if lt_active else None
    for drone_ids in groups.values():
        chip = chips[drone_ids[0]]
        rows = np.asarray([ep * d + di for ep in range(e)
                           for di in drone_ids])
        idx = torch.as_tensor(rows, device=dev)

        def sub(tree):
            return {k: v[idx] for k, v in tree.items()}

        gname = ("ideal" if chip is None else
                 f"chip{chip.chip_id}_seed{chip.device_seed}")
        if lt_active and chip is not None:
            (fleet_g, maps_g, logs_g, snap, ctl, n_syncs,
             advisories) = _fly_group_lifetime(
                wcfg, ucfg, pol, cfg, chip, cost, fused, n_steps, tcfg,
                params, calibrated, dev_worlds, sub(fleet0), maps0,
                sub(bind), lifetime, devices)
            host_syncs += n_syncs
            # drift as the controller's monitor judges it: folded per
            # belief epoch, so a healed group reports its post-heal state
            telemetry_out[gname] = {
                "drones": [int(di) for di in drone_ids], "telemetry": snap,
                "drift": ctl.monitor.status().to_dict()}
            lifetime_out[gname] = dict(
                ctl.report(), advisories=advisories,
                epochs=int(lifetime.epochs),
                age_rate=float(lifetime.age_rate),
                auto_recalibrate=bool(lifetime.auto_recalibrate))
        else:
            episode, head, bias, hcfg = group_episode(
                wcfg, ucfg, pol, params, cfg, chip, calibrated, cost,
                fused, n_steps, tcfg, devices)
            telem0 = (init_telemetry(tcfg, pol.triage.r_max, dev)
                      if tcfg else None)
            out = episode(params, head, bias, dev_worlds, sub(fleet0),
                          maps0, sub(bind), telem0)
            # the single blocking pull of this group's whole episode,
            # the telemetry included
            got = _pull(dict(zip(("fleet", "maps", "logs", "telem"), out)))
            fleet_g, maps_g, logs_g = got["fleet"], got["maps"], got["logs"]
            host_syncs += 1
            if tcfg:
                snap = telemetry_snapshot(got["telem"], tcfg)
                ref = reference_for(cfg, hcfg, calibrated=calibrated,
                                    probe_cells=tcfg.probe_cells, device=dev)
                telemetry_out[gname] = {
                    "drones": [int(di) for di in drone_ids],
                    "telemetry": snap,
                    "drift": drift_status(snap, ref).to_dict()}
        for k, v in logs_g.items():
            logs_full.setdefault(k, np.zeros((n_steps, e * d), v.dtype))
            logs_full[k][:, rows] = v
        for k in fleet_final:
            fleet_final[k][rows] = fleet_g[k]
        # sectors partition the map: each group moved only its own cells
        maps_merged["rescued_t"] = np.minimum(maps_merged["rescued_t"],
                                              maps_g["rescued_t"])
        maps_merged["cleared"] = np.maximum(maps_merged["cleared"],
                                            maps_g["cleared"])
        maps_merged["visited"] = np.maximum(maps_merged["visited"],
                                            maps_g["visited"])
        maps_merged["entropy"] = np.minimum(maps_merged["entropy"],
                                            maps_g["entropy"])

    np_worlds = {k: v.numpy() for k, v in host_worlds.items()}
    summary = summarize(wcfg, ucfg, pol, cost, n_steps, np_worlds,
                        maps_merged, logs_full, fleet_final)
    return MissionResult(summary=summary, logs=logs_full, maps=maps_merged,
                         worlds=np_worlds, host_syncs=host_syncs,
                         telemetry=telemetry_out, lifetime=lifetime_out)


def mission_horizon_s(ucfg: UavConfig, cost: DecisionCost, tri,
                      n_steps: int) -> float:
    """Static worst-case mission clock, the rescue-delay penalty for a
    victim never rescued: every step flies, orbits (3 full decisions of
    up to r_max samples) and verifies."""
    per_step = (ucfg.flight_time_s + ucfg.orbit_time_s
                + ucfg.verify_time_s
                + 3 * cost.decision_latency_s(tri.r_max))
    return float(n_steps * per_step)


def summarize(wcfg: WorldConfig, ucfg: UavConfig, pol: MissionPolicy,
              cost: DecisionCost, n_steps: int, worlds: dict,
              maps: dict, logs: dict, fleet_final: dict) -> dict:
    """Mission metrics over all episodes (on the host, after the pull)."""
    victims = np.asarray(worlds["victims"], bool)           # [E, C]
    rescued_t = np.asarray(maps["rescued_t"])               # [E, C]
    e = victims.shape[0]
    horizon = mission_horizon_s(ucfg, cost, pol.triage, n_steps)

    rescued = np.isfinite(rescued_t) & victims
    n_victims = victims.sum(1)                              # [E]
    n_rescued = rescued.sum(1)
    t_rescue = np.where(n_rescued > 0,
                        np.where(rescued, rescued_t, np.inf).min(1),
                        horizon)
    delay = np.where(victims, np.minimum(rescued_t, horizon), 0.0)
    rescue_delay = delay.sum(1) / np.maximum(n_victims, 1)

    active = logs["active"]
    # first DETECTION (µ-positive on a true victim cell) per episode
    det_hit = active & (logs["prediction"] == 1) & logs["truth"]
    drone_ep = np.arange(det_hit.shape[1]) // ucfg.n_drones  # [E·D]
    t_first_det = np.full((e,), horizon)
    for ep in range(e):
        t = logs["time_s"][:, drone_ep == ep][det_hit[:, drone_ep == ep]]
        if t.size:
            t_first_det[ep] = t.min()
    decisions = active.sum()
    samples = logs["spent"].sum()
    verifies = logs["verify"].sum()
    false_verifies = logs["false_verify"].sum()
    detections = (active & (logs["prediction"] == 1)).sum()
    energy_total = fleet_final["energy_J"].sum()
    e_decision = logs["e_decision_J"].sum()
    e_verify = ucfg.verify_energy_J * verifies
    e_orbit = ucfg.orbit_energy_J * logs["orbited"].sum()
    e_flight = ucfg.flight_energy_J * decisions

    return {
        "episodes": int(e),
        "n_drones": int(ucfg.n_drones),
        "grid": int(wcfg.grid),
        "n_steps": int(n_steps),
        "battery_J": float(ucfg.battery_J),
        "horizon_s": horizon,
        "decisions": int(decisions),
        "mean_samples_per_decision": float(samples / max(decisions, 1)),
        "coverage": float(np.asarray(maps["visited"]).mean()),
        "time_to_first_detection_s": float(t_first_det.mean()),
        "time_to_first_rescue_s": float(t_rescue.mean()),
        "rescue_delay_s": float(rescue_delay.mean()),
        "victims": int(n_victims.sum()),
        "rescued": int(n_rescued.sum()),
        "missed_victim_rate": float(
            1.0 - n_rescued.sum() / max(n_victims.sum(), 1)),
        "detections": int(detections),
        "verifications": int(verifies),
        "false_verifications": int(false_verifies),
        "false_verification_rate": float(
            false_verifies / max(verifies, 1)),
        "orbits": int(logs["orbited"].sum()),
        "energy_total_J": float(energy_total),
        "energy_decision_J": float(e_decision),
        "energy_verify_J": float(e_verify),
        "energy_orbit_J": float(e_orbit),
        "energy_flight_J": float(e_flight),
        "mean_time_s": float(fleet_final["time_s"].mean()),
        "mode": pol.mode,
        "planner": pol.planner,
        "flag_action": pol.flag_action,
    }
