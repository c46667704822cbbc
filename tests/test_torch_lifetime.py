"""The die's lifetime in the port against the JAX reference: the stale
view of an aged die, recalibrate-and-redeploy, the self-healing
controller, ``swap_head``, ``serve_sar_lifetime`` and the mission's
telemetry and lifetime arms.

  * ``aged_belief_view`` (on a dense head and on one hoisted in host
    chunks) and ``recalibrate`` on the seed-11
    severity-2.5 die at 30 days: the configs' physics equal the
    reference's, the measured constants and the arrays within 1e-6 (a
    calibrated head's constants differ by 1–2 ulp, ROADMAP C9); within
    the port a healed head equals a cold deployment on the same aged die
    bit for bit;
  * the controller's advise → heal → quiet sequence, fed the same
    snapshots as the reference's: the same flags and epochs, z within
    1e-2;
  * ``swap_head`` serves the new head and refuses while slots are in
    flight;
  * ``serve_sar_lifetime`` at 24 requests, 2 epochs, 8 slots and a
    narrow width, on the reference's images: the same advisories, heals,
    ``calib_epoch``, host syncs and verdicts as the reference's (both
    given the same fog-mixed images); with an inactive lifetime it is
    ``serve_sar``;
  * the mission at the reference's test size (``tests/test_mission.py``:
    6×6, 3 victims, 2 drones of 120 µJ; 8 steps here) on the
    reference's worlds and rendered exposures: the episode with
    telemetry on gives the reference's logs and telemetry (counters
    exact, moments within 1e-6) in bayes_adaptive (with the orbit) and
    deterministic mode; a 2-epoch lifetime mission on a die gives the
    reference's logs lane for lane (confidence within 2e-3: ADC code
    flips, and each package deploys and heals its own head, C9), its
    heals and one pull a segment; segmented with no aging, the port's mission equals its
    unsegmented one bit for bit; telemetry changes no log and no sync.

The reference runs its ``fused=False`` path (no interpret-mode decision
kernel; its fused case is in ``tests/test_torch_obs.py``).  Both packages' die groups take the
same operating-point bias (pinned), as ``tests/test_torch_mission.py``
does.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.bayes_layer import sigma_of as j_sigma_of
from repro.core.sampling import BayesHeadConfig as JHeadCfg
from repro.hw import VariationSpec as JVariationSpec
from repro.hw import prepare_instance_head as j_prepare
from repro.hw import redeploy as jredeploy
from repro.hw import sample_instances as j_sample
from repro.mission import policy as jpolicy
from repro.mission import rollout as jroll
from repro.mission import uav as juav
from repro.mission import world as jworld
from repro.models import sar_cnn as jsar
from repro.obs import telemetry as jtel
from repro_torch.bridge import instance_from_tree, params_from_jax, \
    worlds_from_jax
from repro_torch.core.bayes_layer import sigma_of
from repro_torch.core.sampling import BayesHeadConfig
from repro_torch.hw import (AgingSpec, LifetimeConfig, aged_belief_view,
                            prepare_instance_head, recalibrate, redeploy)
from repro_torch.mission import policy as tpolicy
from repro_torch.mission import rollout as troll
from repro_torch.mission import uav as tuav
from repro_torch.mission import world as tworld
from repro_torch.models import sar_cnn as tsar
from repro_torch.obs import telemetry as ttel

AGE_30D = 30 * 86400.0
NARROW = dict(channels=(4, 8, 8))
GRID, N_VICTIMS, WORLD_SEED = 6, 3, 2
N_DRONES, BATTERY_J, N_STEPS = 2, 120e-6, 8
BIAS = np.asarray([0.0, -0.3], np.float32)
J_W = jworld.WorldConfig(grid=GRID, n_victims=N_VICTIMS, seed=WORLD_SEED)
J_U = juav.UavConfig(n_drones=N_DRONES, battery_J=BATTERY_J)
T_W = tworld.WorldConfig(grid=GRID, n_victims=N_VICTIMS, seed=WORLD_SEED)
T_U = tuav.UavConfig(n_drones=N_DRONES, battery_J=BATTERY_J)
INT_LOGS = ("cell", "active", "verdict", "prediction", "spent", "orbited",
            "verify", "found", "false_verify", "truth")
COUNTERS = ("rounds", "dispatches", "samples", "decisions", "verdicts",
            "r_hist", "conf_hist", "ent_hist", "mi_hist")


def _die(severity=2.5):
    j = j_sample(11, 1, JVariationSpec().scaled(severity))[0]
    return j, instance_from_tree(j.to_tree())


def _heads():
    jh = JHeadCfg(num_samples=20, mode="rank16", grng=jsar.SarCnnConfig().grng,
                  compute_dtype=jnp.float32, hoist_basis=True)
    th = BayesHeadConfig(num_samples=20, mode="rank16",
                         grng=tsar.SarCnnConfig().grng,
                         compute_dtype=torch.float32, hoist_basis=True)
    return jh, th


@pytest.fixture(scope="module")
def jax_params():
    return jsar.init_sar_cnn(jax.random.PRNGKey(3), jsar.SarCnnConfig())


@pytest.fixture(scope="module")
def port_params(jax_params):
    return params_from_jax(jax.device_get(jax_params))


def _mu_sigma(jax_params):
    mu, sigma = jax_params["head"]["mu"], j_sigma_of(jax_params["head"])
    return (mu, sigma), (torch.tensor(np.asarray(mu)),
                         torch.tensor(np.asarray(sigma)))


def _same_head(got: dict, want: dict, got_cfg, want_cfg):
    assert set(got) == set(want)
    for k in got:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=1e-6, atol=1e-6, err_msg=k)
    g, w = dataclasses.asdict(got_cfg.grng), dataclasses.asdict(
        want_cfg.grng)
    for k in g:
        if k in ("sum_mean", "sum_std"):
            np.testing.assert_allclose(g[k], w[k], rtol=1e-6, err_msg=k)
        else:
            assert g[k] == w[k], k
    assert got_cfg.calib_epoch == want_cfg.calib_epoch


# ----------------------------------------------------------------------
# the stale view, the healed head, the controller
# ----------------------------------------------------------------------
def test_stale_view_and_healed_head_match_reference(jax_params):
    (mu, sigma), (mu_t, sigma_t) = _mu_sigma(jax_params)
    jchip, tchip = _die()
    jh, th = _heads()
    head_j, hcfg_j = j_prepare(mu, sigma, jh, jchip)
    head_t, hcfg_t = prepare_instance_head(mu_t, sigma_t, th, tchip)
    aged_j, aged_t = jchip.at_age(AGE_30D), tchip.at_age(AGE_30D)
    view_j = jredeploy.aged_belief_view(head_j, hcfg_j, aged_j, jh.grng)
    view_t = aged_belief_view(head_t, hcfg_t, aged_t, th.grng)
    _same_head(view_t[0], jax.device_get(view_j[0]), view_t[1], view_j[1])
    # the belief's constants are the birth calibration's, the physics aged
    assert view_t[1].grng.sum_mean == hcfg_t.grng.sum_mean
    assert view_t[1].grng.imprint == aged_t.imprint > 0
    assert view_t[0]["mu_prime"] is head_t["mu_prime"]
    healed_j = jredeploy.recalibrate(mu, sigma, jh, aged_j, epoch=1)
    healed_t = recalibrate(mu_t, sigma_t, th, aged_t, epoch=1)
    _same_head(healed_t[0], jax.device_get(healed_j[0]), healed_t[1],
               healed_j[1])
    assert healed_t[1].calib_epoch == 1
    # within the port: a heal is a cold deployment on the aged die
    cold = prepare_instance_head(mu_t, sigma_t, dataclasses.replace(
        th, calib_epoch=1), aged_t)
    assert cold[1] == healed_t[1]
    for k in cold[0]:
        assert torch.equal(cold[0][k], healed_t[0][k]), k
    # a head hoisted in host chunks (hoist_tile_n): the view rebuilds
    # the chunks from the aged currents, as the reference's does
    jt, tt = (dataclasses.replace(c, hoist_tile_n=1) for c in (jh, th))
    head_jt, hcfg_jt = j_prepare(mu, sigma, jt, jchip)
    head_tt, hcfg_tt = prepare_instance_head(mu_t, sigma_t, tt, tchip)
    view_jt = jredeploy.aged_belief_view(head_jt, hcfg_jt, aged_j, jh.grng)
    view_tt = aged_belief_view(head_tt, hcfg_tt, aged_t, th.grng)
    chunks_j = view_jt[0].pop("sigma_basis_host")
    chunks_t = view_tt[0].pop("sigma_basis_host")
    assert len(chunks_t) == len(chunks_j) == 2
    for got, want in zip(chunks_t, chunks_j):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-6, atol=1e-6)
    assert not any(torch.equal(a, b) for a, b in
                   zip(chunks_t, head_tt["sigma_basis_host"]))
    _same_head(view_tt[0], jax.device_get(view_jt[0]), view_tt[1],
               view_jt[1])


def _snapshot(grng_cfg, sample0: int, cum=None):
    """A cumulative probe snapshot: 512 samples of the probe block of
    ``grng_cfg`` (the reference's raw sums) added to ``cum``."""
    from repro.core import clt_grng as jg
    raw = np.asarray(jg.raw_sums(grng_cfg, 32, 1, 512, sample0), np.float64)
    g = dict(cum["grng"]) if cum else {"n": 0.0, "sum": 0.0, "sumsq": 0.0}
    g = {"n": g["n"] + raw.size, "sum": g["sum"] + raw.sum(),
         "sumsq": g["sumsq"] + (raw * raw).sum()}
    return {"grng": g}


def test_controller_advise_heal_quiet_matches_reference(jax_params):
    (mu, sigma), (mu_t, sigma_t) = _mu_sigma(jax_params)
    jchip, tchip = _die()
    jh, th = _heads()
    ctl_j = jredeploy.SelfHealingController(jchip, mu, sigma, jh)
    ctl_t = redeploy.SelfHealingController(tchip, mu_t, sigma_t, th)
    with pytest.raises(ValueError, match="birth"):
        redeploy.SelfHealingController(tchip.at_age(1.0), mu_t, sigma_t, th)
    snap = _snapshot(ctl_j.hcfg.grng, 10_000)         # fresh: quiet
    flags = []
    for ctl in (ctl_j, ctl_t):
        flags.append(ctl.observe_snapshot(snap).drifted)
    assert flags == [False, False]
    ctl_j.advance(AGE_30D)
    view_t = ctl_t.advance(AGE_30D)
    with pytest.raises(ValueError, match="forward"):
        ctl_t.advance(1.0)
    snap = _snapshot(ctl_j.view()[1].grng, 20_000, snap)  # aged: advisory
    st_j, st_t = ctl_j.observe_snapshot(snap), ctl_t.observe_snapshot(snap)
    assert st_j.drifted and st_t.drifted and st_t.advisory
    assert abs(st_j.z_mean) > 5.5
    np.testing.assert_allclose(st_t.z_mean, st_j.z_mean, atol=1e-2)
    np.testing.assert_allclose(st_t.z_std, st_j.z_std, atol=1e-2)
    assert view_t[1].grng.imprint > 0
    ev_j, ev_t = ctl_j.heal(st_j), ctl_t.maybe_heal(st_t)
    assert (ev_t.age_s, ev_t.calib_epoch) == (ev_j.age_s, ev_j.calib_epoch) \
        == (AGE_30D, 1)
    assert ctl_t.view()[1].calib_epoch == 1
    snap = _snapshot(ctl_j.hcfg.grng, 30_000, snap)   # healed: quiet again
    st_j, st_t = ctl_j.observe_snapshot(snap), ctl_t.observe_snapshot(snap)
    assert not st_j.drifted and not st_t.drifted
    assert ctl_t.maybe_heal(st_t) is None
    rep = ctl_t.report()
    assert (rep["heals"], rep["calib_epoch"]) == (1, 1)
    assert rep["events"] == [ev_t.to_dict()]


# ----------------------------------------------------------------------
# serving over a lifetime
# ----------------------------------------------------------------------
def _jax_requests(reqs):
    from repro.serving import Request
    return [Request(rid=r.rid, payload=np.asarray(r.payload),
                    meta=dict(r.meta)) for r in reqs]


def test_swap_head_serves_the_new_head_and_refuses_in_flight(port_params):
    from repro_torch.launch.serve import make_sar_engine, make_sar_stream
    _, tchip = _die()
    eng = make_sar_engine(n_slots=8, params=port_params, chip_instance=tchip,
                          device="cpu")
    reqs = make_sar_stream(16, corrupt_frac=0.25)
    for r in reqs[:8]:
        eng.submit(r)
    eng.run()
    _, th = _heads()
    head, hcfg = recalibrate(port_params["head"]["mu"],
                             sigma_of(port_params["head"]), th,
                             tchip.at_age(AGE_30D), epoch=1)
    eng.swap_head(head, hcfg)
    assert eng.hcfg.calib_epoch == 1 and eng._head["mu_prime"] is not None
    for r in reqs[8:]:
        eng.submit(r)
    eng.start()
    eng._admit()                                     # slots in flight
    with pytest.raises(RuntimeError, match="in-flight"):
        eng.swap_head(head, hcfg)
    for _ in range(10):
        eng.step()
    assert eng.n_active == 0 and len(eng.metrics.records) == 16
    assert eng.telemetry_snapshot()["decisions"] == 16


@pytest.fixture(scope="module")
def narrow():
    from repro_torch.launch.serve import make_sar_stream
    jcfg = jsar.SarCnnConfig(**NARROW)
    jp = jsar.init_sar_cnn(jax.random.PRNGKey(5), jcfg)
    return {"jcfg": jcfg, "jparams": jp, "tcfg": tsar.SarCnnConfig(**NARROW),
            "tparams": params_from_jax(jax.device_get(jp)),
            "stream": make_sar_stream(24, corrupt_frac=0.25,
                                      corruption="fog")}


def test_serve_sar_lifetime_matches_reference(narrow, monkeypatch):
    from repro.launch import serve as jserve
    from repro.serving import TriagePolicy as JPolicy
    from repro_torch.launch import serve as tserve
    from repro_torch.serving import TriagePolicy
    jchip, tchip = _die()
    pol = dict(conf_threshold=0.55, mi_threshold=0.05)
    lt_kw = dict(age_rate=AGE_30D / 12, epochs=2, auto_recalibrate=True)
    # both packages serve the same images
    monkeypatch.setattr(jserve, "make_sar_stream", lambda *a, **k:
                        _jax_requests(narrow["stream"]))
    monkeypatch.setattr(tserve, "make_sar_stream", lambda *a, **k:
                        narrow["stream"])
    want = jserve.serve_sar_lifetime(
        lifetime=jredeploy.LifetimeConfig(**lt_kw), chip_instance=jchip,
        n_requests=24, n_slots=8, policy=JPolicy(**pol),
        params=narrow["jparams"], cfg=narrow["jcfg"], fused=False,
        profiler=False)
    got = tserve.serve_sar_lifetime(
        lifetime=LifetimeConfig(**lt_kw), chip_instance=tchip,
        n_requests=24, n_slots=8, policy=TriagePolicy(**pol),
        params=narrow["tparams"], cfg=narrow["tcfg"], device="cpu")
    lt_j, lt_t = want["lifetime"], got["lifetime"]
    for k in ("advisories", "heals", "calib_epoch", "age_s", "epochs"):
        assert lt_t[k] == lt_j[k], k
    assert lt_t["heals"] >= 1 and lt_t["advisories"] >= 1
    assert [a["kind"] for a in got["alerts"]] == \
        [a["kind"] for a in want["alerts"]]
    assert got["host_syncs"] == want["host_syncs"]
    assert [(v["rid"], v["verdict"], v["n_samples"])
            for v in got["verdicts"]] == \
        [(v["rid"], v["verdict"], v["n_samples"]) for v in want["verdicts"]]
    for k in ("rounds", "dispatches", "samples", "verdicts", "r_hist"):
        assert got["telemetry"][k] == want["telemetry"][k], k
    with pytest.raises(ValueError, match="telemetry"):
        tserve.serve_sar_lifetime(lifetime=LifetimeConfig(**lt_kw),
                                  chip_instance=tchip, telemetry=False,
                                  device="cpu")


def test_inactive_lifetime_is_serve_sar(narrow):
    from repro_torch.launch.serve import serve_sar, serve_sar_lifetime
    _, tchip = _die()
    kw = dict(n_requests=24, n_slots=8, params=narrow["tparams"],
              cfg=narrow["tcfg"], chip_instance=tchip, device="cpu")
    a = serve_sar_lifetime(lifetime=LifetimeConfig(), **kw)
    b = serve_sar(**kw)
    assert a["lifetime"] == {"active": False, "age_s": 0.0, "heals": 0,
                             "advisories": 0, "epochs": 1}
    assert a["verdicts"] == b["verdicts"]
    assert a["host_syncs"] == b["host_syncs"]


def test_serve_cli_lifetime_flags(capsys):
    from repro_torch.launch import serve
    serve.main(["--arch", "sar_cnn", "--device", "cpu", "--requests", "16",
                "--slots", "8", "--chip-instance", "11", "--chip-severity",
                "2.5", "--age-rate", "200000", "--age-epochs", "2",
                "--auto-recalibrate"])
    out = capsys.readouterr().out
    assert "[lifetime] age" in out and "2 epochs" in out
    serve.main(["--arch", "sar_cnn", "--device", "cpu", "--requests", "16",
                "--slots", "8", "--no-telemetry"])
    assert capsys.readouterr().out.startswith("[sar] 16 decisions")


# ----------------------------------------------------------------------
# the mission's telemetry and lifetime arms
# ----------------------------------------------------------------------
@pytest.fixture(scope="module")
def bridged_worlds():
    worlds = jworld.stack_worlds(J_W, 1)
    c, looks = J_W.n_cells, 3 * N_STEPS
    cells = np.repeat(np.arange(c, dtype=np.int32), looks)
    look = np.tile(np.arange(looks, dtype=np.int32), c)
    imgs = np.asarray(jworld.observe_cells(
        J_W, worlds, jnp.zeros_like(cells), jnp.asarray(cells),
        jnp.asarray(look)))
    table = imgs.reshape((1, c, looks) + imgs.shape[1:])
    return jax.device_get(worlds), worlds_from_jax(jax.device_get(worlds),
                                                   table)


def _maps0():
    return troll.init_maps(T_W, 1, 2)


def _same_logs(got, want, conf_atol):
    for k in INT_LOGS:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    np.testing.assert_allclose(got["confidence"], want["confidence"],
                               rtol=0, atol=conf_atol)
    for k in ("energy_J", "time_s"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-6, err_msg=k)


def _same_telemetry(got: dict, want: dict):
    for k in COUNTERS:
        assert got[k] == want[k], k
    for k in ("n", "sum", "sumsq"):
        np.testing.assert_allclose(got["grng"][k], want["grng"][k],
                                   rtol=1e-6, err_msg=k)


@pytest.mark.parametrize("mode", ["bayes_adaptive", "deterministic"])
def test_episode_telemetry_matches_reference(jax_params, port_params,
                                             bridged_worlds, mode):
    cfg_j, cfg_t = jsar.SarCnnConfig(), tsar.SarCnnConfig()
    jpol, tpol = (jpolicy.MissionPolicy(mode=mode),
                  tpolicy.MissionPolicy(mode=mode))
    jt, tt = jtel.TelemetryConfig(), ttel.TelemetryConfig()
    head_j, hcfg_j = jroll._prepare_group_head(jax_params, cfg_j,
                                               jpol.triage, None, True)
    fn_j = jroll._episode_fn(J_W, J_U, jpol, cfg_j, hcfg_j, None,
                             jroll.sar_mission_cost(cfg_j), False, N_STEPS,
                             N_DRONES, cfg_j.n_classes, jt)
    out_j = jax.device_get(fn_j(
        jax_params, head_j, jnp.asarray(BIAS),
        jax.tree.map(jnp.asarray, bridged_worlds[0]),
        juav.init_fleet(J_U, GRID, 1), jax.tree.map(jnp.asarray, _maps0()),
        juav.fleet_bindings(J_U, GRID, 1), jtel.init_telemetry(jt, 20)))
    fn_t, head_t, _, hcfg_t = troll.group_episode(
        T_W, T_U, tpol, port_params, cfg_t, None, True,
        troll.sar_mission_cost(cfg_t), True, N_STEPS, tt)
    assert hcfg_t.calib_epoch == 0
    state = (bridged_worlds[1], tuav.init_fleet(T_U, GRID, 1, device="cpu"),
             {k: torch.as_tensor(v) for k, v in _maps0().items()},
             tuav.fleet_bindings(T_U, GRID, 1, device="cpu"))
    out_t = fn_t(port_params, head_t, torch.as_tensor(BIAS), *state,
                 ttel.init_telemetry(tt, 20, device="cpu"))
    got = troll._pull(dict(zip(("fleet", "maps", "logs", "telem"), out_t)))
    _same_logs(got["logs"], out_j[2], 1e-5)
    snap_j = jtel.snapshot(out_j[3], jt)
    snap_t = ttel.snapshot(got["telem"], tt)
    _same_telemetry(snap_t, snap_j)
    if mode == "bayes_adaptive":
        # the orbit flew on some steps and not on others
        orbits = got["logs"]["orbited"].any(1)
        assert orbits.any() and not orbits.all()
        assert N_STEPS < snap_t["dispatches"] < 3 * N_STEPS
    # telemetry off: the same logs
    off = troll._pull(dict(zip(("fleet", "maps", "logs"),
                               fn_t(port_params, head_t,
                                    torch.as_tensor(BIAS), *state))))
    for k in INT_LOGS:
        np.testing.assert_array_equal(off["logs"][k], got["logs"][k])


def test_lifetime_mission_matches_reference(jax_params, port_params,
                                            bridged_worlds, monkeypatch):
    """Two segments of 3 steps on the seed-11 severity-1.5 die, aged 30
    days a step and healing on advisories, at the pinned bias.  The
    trunks may differ by an ADC code (ROADMAP C9) and the two packages'
    calibrated heads by 1–2 ulp, so confidence is held to 2e-3 (1.4e-3
    measured over 12 steps) and every integer log exactly."""
    jchip, tchip = _die(1.5)
    monkeypatch.setattr(jroll, "operating_point_bias",
                        lambda *a, **k: BIAS)
    monkeypatch.setattr(troll, "operating_point_bias",
                        lambda *a, **k: BIAS)
    lt_kw = dict(age_rate=AGE_30D, epochs=2, auto_recalibrate=True)
    jpol, tpol = jpolicy.MissionPolicy(), tpolicy.MissionPolicy()
    cfg_j, cfg_t = jsar.SarCnnConfig(), tsar.SarCnnConfig()
    jt, tt = jtel.TelemetryConfig(), ttel.TelemetryConfig()
    rows, steps = np.arange(N_DRONES), 6
    want = jroll._fly_group_lifetime(
        J_W, J_U, jpol, cfg_j, jchip, jroll.sar_mission_cost(cfg_j), False,
        steps, 1, jt, jax_params, True,
        jax.tree.map(jnp.asarray, bridged_worlds[0]),
        juav.init_fleet(J_U, GRID, 1), jax.tree.map(jnp.asarray, _maps0()),
        juav.fleet_bindings(J_U, GRID, 1), rows,
        jredeploy.LifetimeConfig(**lt_kw))
    got = troll._fly_group_lifetime(
        T_W, T_U, tpol, cfg_t, tchip, troll.sar_mission_cost(cfg_t), True,
        steps, tt, port_params, True, bridged_worlds[1],
        tuav.init_fleet(T_U, GRID, 1, device="cpu"),
        {k: torch.as_tensor(v) for k, v in _maps0().items()},
        tuav.fleet_bindings(T_U, GRID, 1, device="cpu"),
        LifetimeConfig(**lt_kw))
    _same_logs(got[2], want[2], 2e-3)
    assert got[5] == want[5] == 2                   # one pull a segment
    assert got[6] == want[6]                        # advisories
    ctl_j, ctl_t = want[4], got[4]
    assert (ctl_t.epoch, ctl_t.age_s, len(ctl_t.events)) == \
        (ctl_j.epoch, ctl_j.age_s, len(ctl_j.events))
    for k in ("rounds", "dispatches", "samples", "verdicts", "r_hist"):
        assert got[3][k] == jtel.snapshot(want[3], jt)[k], k
    assert got[2]["active"].any()


def test_segmented_mission_without_aging_is_the_mission(port_params):
    """Three segments over absolute steps, a die that does not age: the
    same logs and maps bit for bit as one segment; one pull a segment;
    telemetry on or off, the same logs."""
    _, tchip = _die(1.5)
    still = AgingSpec(drift_per_decade=0.0, gamma_per_decade=0.0,
                      read_sigma_per_decade=0.0, imprint_per_decade=0.0)
    kw = dict(params=port_params, chips=tchip, n_steps=9, device="cpu")
    one = troll.fly_mission(T_W, T_U, tpolicy.MissionPolicy(), **kw)
    seg = troll.fly_mission(T_W, T_U, tpolicy.MissionPolicy(),
                            lifetime=LifetimeConfig(age_rate=1.0, epochs=3,
                                                    spec=still), **kw)
    off = troll.fly_mission(T_W, T_U, tpolicy.MissionPolicy(),
                            telemetry=False, **kw)
    assert (one.host_syncs, seg.host_syncs, off.host_syncs) == (1, 3, 1)
    for k in one.logs:
        np.testing.assert_array_equal(seg.logs[k], one.logs[k], err_msg=k)
        np.testing.assert_array_equal(off.logs[k], one.logs[k], err_msg=k)
    for k in one.maps:
        np.testing.assert_array_equal(seg.maps[k], one.maps[k], err_msg=k)
    (group, lt), = seg.lifetime.items()
    assert lt["epochs"] == 3 and lt["heals"] == 0 and lt["age_s"] == 6.0
    assert seg.telemetry[group]["telemetry"]["decisions"] == \
        one.telemetry[group]["telemetry"]["decisions"]
    assert off.telemetry is None and one.lifetime is None
    with pytest.raises(ValueError, match="telemetry"):
        troll.fly_mission(T_W, T_U, tpolicy.MissionPolicy(), telemetry=False,
                          lifetime=LifetimeConfig(age_rate=1.0), **kw)


def test_mission_cli_lifetime_flags(tmp_path, monkeypatch, capsys):
    from repro_torch.launch import mission
    monkeypatch.chdir(tmp_path)          # the detector's cache goes here
    mission.main(["--device", "cpu", "--train-steps", "2", "--grid", "6",
                  "--victims", "3", "--drones", "2", "--steps", "4",
                  "--chip-instance", "11", "--chip-severity", "2.5",
                  "--age-rate", "1e6", "--age-epochs", "2",
                  "--auto-recalibrate"])
    out = capsys.readouterr().out
    assert "host syncs 2" in out and "[lifetime chip0_seed" in out
    assert "[telemetry chip0_seed" in out
    mission.main(["--device", "cpu", "--train-steps", "2", "--grid", "6",
                  "--victims", "3", "--drones", "2", "--steps", "4",
                  "--no-telemetry"])
    out = capsys.readouterr().out
    assert "host syncs 1" in out and "[telemetry" not in out
