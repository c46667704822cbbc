"""The closed-loop mission slice of the port against the JAX reference.

Sizes are the reference's own (``tests/test_mission.py``): a 6×6 world
with 3 victims (seed 2), 2 drones with 120 µJ batteries, 18 steps, the
full-width ``SarCnnConfig()`` with the reference's seed-3 params bridged
into the port.  Untrained params never detect at this size, so the
episodes fly at a logit bias of [0, −0.3]: the reference's run then
detects, orbits, verifies and runs its drones out of battery, which the
tests assert so that they exercise what they claim to.

  * uav and policy: the sector tables, the fleet and the planners equal
    the reference's on integers, ``infogain`` ties included.
  * world: the port draws its own maps and renders on the device from
    counter-based draws, so it is held to the reference's structure
    (shapes, victim count, severity range, a persistent scene under a
    fresh exposure) and its corruptions to the reference's per-image
    ones (fog and motion to 1e-6 on the same image, snow and frost by
    their statistics).
  * the token decision against ``_lm_token_fn`` on the reference's
    activation basis: verdict and samples spent equal, ``fin`` within
    1e-5 (ROADMAP C6), with no lane active included.
  * the per-group episode on the reference's worlds and rendered
    exposures (``bridge.worlds_from_jax``): every log equal lane for
    lane (confidence within 1e-5, energy and time within rtol 1e-6),
    the maps equal (entropy within rtol 1e-6), the summary's integers
    equal and its floats within rtol 1e-6, for the three modes and the
    infogain planner, through the port's decision kernel path
    (``fused``; on the CPU its plain version) and through
    ``mix_samples`` + ``update_stats``.  The reference runs with
    telemetry off, its decision kernel in interpret mode.
  * a die (seed 11, severity 1.5): the operating-point bias on the
    reference's patches, and the episode, whose logs are equal unless
    the trunk flipped an ADC code between the packages (ROADMAP C9;
    counted as in ``tests/test_torch_cim.py``).
  * the reference's mission properties on the port alone: determinism,
    the ledger against ``decision_cost``/``request_energy``,
    verifications ≤ detections, the deterministic mode verifies every
    detection, one host sync per die group.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data import sard as jsard
from repro.hw import VariationSpec as JVariationSpec
from repro.hw import sample_instances as j_sample
from repro.mission import policy as jpolicy
from repro.mission import rollout as jroll
from repro.mission import uav as juav
from repro.mission import world as jworld
from repro.models import sar_cnn as jsar
from repro.serving import triage as jtri
from repro_torch.bridge import (instance_from_tree, params_from_jax,
                                worlds_from_jax)
from repro_torch.mission import policy as tpolicy
from repro_torch.mission import rollout as troll
from repro_torch.mission import uav as tuav
from repro_torch.mission import world as tworld
from repro_torch.models import sar_cnn as tsar
from repro_torch.serving import triage as ttri

GRID, N_VICTIMS, WORLD_SEED = 6, 3, 2
N_DRONES, BATTERY_J = 2, 120e-6
N_STEPS = 18
BIAS = np.asarray([0.0, -0.3], np.float32)
J_W = jworld.WorldConfig(grid=GRID, n_victims=N_VICTIMS, seed=WORLD_SEED)
J_U = juav.UavConfig(n_drones=N_DRONES, battery_J=BATTERY_J)
T_W = tworld.WorldConfig(grid=GRID, n_victims=N_VICTIMS, seed=WORLD_SEED)
T_U = tuav.UavConfig(n_drones=N_DRONES, battery_J=BATTERY_J)
INT_LOGS = ("cell", "active", "verdict", "prediction", "spent", "orbited",
            "verify", "found", "false_verify", "truth")
CONFIGS = {"adaptive": {}, "fixed": {"mode": "bayes_fixed"},
           "deterministic": {"mode": "deterministic"},
           "infogain": {"planner": "infogain"}}


def _policies(**kw):
    return jpolicy.MissionPolicy(**kw), tpolicy.MissionPolicy(**kw)


def _maps0():
    return troll.init_maps(T_W, 1, 2)


@pytest.fixture(scope="module")
def jax_params():
    return jsar.init_sar_cnn(jax.random.PRNGKey(3), jsar.SarCnnConfig())


@pytest.fixture(scope="module")
def port_params(jax_params):
    return params_from_jax(jax.device_get(jax_params))


@pytest.fixture(scope="module")
def bridged_worlds():
    """The reference's world and its rendered exposures at every cell and
    look of the mission (looks 0 … 3·N_STEPS − 1), bridged."""
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


def _jax_episode(jax_params, pol, worlds_np, chip=None, bias=BIAS,
                 deployed=None):
    cfg = jsar.SarCnnConfig()
    head, hcfg = deployed or jroll._prepare_group_head(
        jax_params, cfg, pol.triage, chip, True)
    fn = jroll._episode_fn(J_W, J_U, pol, cfg, hcfg, chip,
                           jroll.sar_mission_cost(cfg), True, N_STEPS,
                           N_DRONES, cfg.n_classes)
    out = fn(jax_params, head, jnp.asarray(bias),
             jax.tree.map(jnp.asarray, worlds_np),
             juav.init_fleet(J_U, GRID, 1), jax.tree.map(jnp.asarray,
                                                         _maps0()),
             juav.fleet_bindings(J_U, GRID, 1))
    return dict(zip(("fleet", "maps", "logs"), jax.device_get(out)))


def _port_episode(port_params, pol, worlds, chip=None, bias=BIAS,
                  fused=True):
    cfg = tsar.SarCnnConfig()
    head, hcfg = troll._prepare_group_head(port_params, cfg, pol.triage,
                                           chip, True)
    trunk = None if chip is None else tsar.program_trunk(port_params, cfg,
                                                         chip)
    fn = troll._episode_fn(T_W, T_U, pol, cfg, hcfg, trunk,
                           troll.sar_mission_cost(cfg), fused, N_STEPS)
    out = fn(port_params, head, torch.as_tensor(bias), worlds,
             tuav.init_fleet(T_U, GRID, 1, device="cpu"),
             {k: torch.as_tensor(v) for k, v in _maps0().items()},
             tuav.fleet_bindings(T_U, GRID, 1, device="cpu"))
    return troll._pull(dict(zip(("fleet", "maps", "logs"), out)))


@pytest.fixture(scope="module")
def reference_runs(jax_params, bridged_worlds):
    """The reference's episode per config (ideal die), on first use."""
    runs = {}

    def get(name):
        if name not in runs:
            pol, _ = _policies(**CONFIGS[name])
            runs[name] = _jax_episode(jax_params, pol, bridged_worlds[0])
        return runs[name]

    return get


def _assert_same_episode(got, want, conf_atol=1e-5):
    for k in INT_LOGS:
        np.testing.assert_array_equal(got["logs"][k], want["logs"][k],
                                      err_msg=k)
        assert got["logs"][k].dtype == want["logs"][k].dtype, k
    np.testing.assert_allclose(got["logs"]["confidence"],
                               want["logs"]["confidence"], rtol=0,
                               atol=conf_atol)
    for k in ("energy_J", "time_s", "e_decision_J"):
        np.testing.assert_allclose(got["logs"][k], want["logs"][k],
                                   rtol=1e-6, err_msg=k)
    for k in ("rescued_t", "cleared", "visited"):
        np.testing.assert_array_equal(got["maps"][k], want["maps"][k],
                                      err_msg=k)
    np.testing.assert_allclose(got["maps"]["entropy"],
                               want["maps"]["entropy"], rtol=1e-6,
                               atol=conf_atol)
    for k in ("pos", "path_k"):
        np.testing.assert_array_equal(got["fleet"][k], want["fleet"][k])


# ----------------------------------------------------------------------
# uav and policy: integers, bit for bit
# ----------------------------------------------------------------------
@pytest.mark.parametrize("grid,d", [(6, 2), (7, 3), (12, 5), (14, 4)])
def test_sectors_and_fleet_match(grid, d):
    np.testing.assert_array_equal(tuav.sector_rows(grid, d),
                                  juav.sector_rows(grid, d))
    masks = tuav.sector_masks(grid, d)
    np.testing.assert_array_equal(masks, juav.sector_masks(grid, d))
    np.testing.assert_array_equal(masks.sum(0), np.ones(grid * grid))
    ju, tu = juav.UavConfig(n_drones=d), tuav.UavConfig(n_drones=d)
    for want, got in ((juav.init_fleet(ju, grid, 2),
                       tuav.init_fleet(tu, grid, 2, device="cpu")),
                      (juav.fleet_bindings(ju, grid, 2),
                       tuav.fleet_bindings(tu, grid, 2, device="cpu"))):
        assert set(want) == set(got)
        for k in want:
            w, g = np.asarray(want[k]), got[k].numpy()
            assert g.dtype == w.dtype, k
            np.testing.assert_array_equal(g, w, err_msg=k)
    with pytest.raises(ValueError, match="exceeds grid"):
        tuav.sector_rows(3, 4)


def test_planners_match():
    rng = np.random.default_rng(0)
    grid, b = 7, 12
    d = 3
    sector = np.tile(juav.sector_rows(grid, d), (b // d, 1))
    mask = np.tile(juav.sector_masks(grid, d), (b // d, 1))
    k = rng.integers(0, 200, b).astype(np.int32)
    np.testing.assert_array_equal(
        tpolicy.lawnmower_cell(torch.as_tensor(sector), grid,
                               torch.as_tensor(k)).numpy(),
        np.asarray(jpolicy.lawnmower_cell(jnp.asarray(sector), grid,
                                          jnp.asarray(k))))
    pos = np.asarray([rng.choice(np.nonzero(m)[0]) for m in mask],
                     np.int32)
    flat = np.full((b, grid * grid), np.log(2), np.float32)
    # every cell at the prior entropy (ties everywhere), then a map with
    # some cells observed and some excluded
    seen = flat.copy()
    seen[rng.random(seen.shape) < 0.4] = 0.3
    seen[np.arange(b), pos] = -np.inf
    for ent in (flat, seen):
        for lam in (0.05, 0.0):
            want = np.asarray(jpolicy.infogain_cell(
                jnp.asarray(pos), jnp.asarray(ent), jnp.asarray(mask),
                grid, lam))
            got = tpolicy.infogain_cell(
                torch.as_tensor(pos), torch.as_tensor(ent),
                torch.as_tensor(mask), grid, lam)
            assert got.dtype == torch.int32
            np.testing.assert_array_equal(got.numpy(), want)
    with pytest.raises(ValueError, match="planner"):
        tpolicy.MissionPolicy(planner="spiral")


# ----------------------------------------------------------------------
# world: the port's own draws, held to the reference's structure
# ----------------------------------------------------------------------
def test_make_world():
    cfg = tworld.WorldConfig(grid=9, n_victims=7, seed=4, severity_lo=0.2,
                             severity_hi=0.9)
    w = tworld.make_world(cfg, device="cpu")
    assert w["victims"].shape == (81,) and w["victims"].dtype == torch.bool
    assert int(w["victims"].sum()) == 7
    sev = w["severity"]
    assert sev.dtype == torch.float32 and sev.shape == (81,)
    assert float(sev.min()) == pytest.approx(0.2, abs=1e-6)
    assert float(sev.max()) == pytest.approx(0.9, abs=1e-6)
    again = tworld.make_world(cfg, device="cpu")
    assert all(torch.equal(w[k], again[k]) for k in w)
    other = tworld.make_world(cfg, seed=5, device="cpu")
    assert not torch.equal(w["victims"], other["victims"])
    stacked = tworld.stack_worlds(cfg, 3, device="cpu")
    assert stacked["seed"].tolist() == [4, 5, 6]
    assert torch.equal(stacked["severity"][1], other["severity"])
    # the field is spatially correlated: neighbours closer than a shuffle
    field = tworld.make_world(dataclasses.replace(cfg, grid=24),
                             device="cpu")[
        "severity"].reshape(24, 24)
    near = (field[:, 1:] - field[:, :-1]).abs().mean()
    far = (field.reshape(-1) - field.reshape(-1)[torch.randperm(
        576, generator=torch.Generator().manual_seed(0))]).abs().mean()
    assert near < 0.5 * far


def test_world_and_fleet_default_to_the_card():
    """With no device, the worlds and the fleet go where every entry
    point of the port runs: the card, or an error without one."""
    cfg, ucfg = tworld.WorldConfig(grid=6, n_victims=3), tuav.UavConfig(2)
    makers = (lambda: tworld.make_world(cfg),
              lambda: tworld.stack_worlds(cfg, 2),
              lambda: tuav.init_fleet(ucfg, cfg.grid, 2),
              lambda: tuav.fleet_bindings(ucfg, cfg.grid, 2))
    for make in makers:
        if torch.cuda.is_available():
            assert all(v.is_cuda for v in make().values())
        else:
            with pytest.raises(RuntimeError, match="device='cpu'"):
                make()


def _render(corruption, severity, has, looks, cells=None, seed=9):
    n = len(looks)
    cells = torch.arange(n) % 36 if cells is None else cells
    return tworld._render(
        tworld.WorldConfig(corruption=corruption), torch.full((n,), seed),
        cells, torch.full((n,), float(has)),
        torch.full((n,), float(severity)), torch.as_tensor(looks))


def test_scene_persists_exposure_does_not():
    looks0 = torch.zeros(64, dtype=torch.int64)
    a = _render("fog", 0.0, 1, looks0)
    b = _render("fog", 0.0, 1, looks0 + 1)
    assert a.shape == (64, 32, 32, 1) and a.dtype == torch.float32
    assert torch.equal(a, _render("fog", 0.0, 1, looks0))
    # a second look: the same scene under fresh sensor noise
    # (0.1·N(0,1) each, so the difference has SD 0.1·√2)
    diff = (a - b).reshape(-1)
    assert abs(float(diff.std()) - 0.1 * 2 ** 0.5) < 0.005
    assert abs(float(diff.mean())) < 0.003
    # the victim is part of the scene: its blob is the whole difference
    blob = a - _render("fog", 0.0, 0, looks0)
    assert float(blob.min()) >= 0.0
    assert 1.0 < float(blob.amax(dim=(1, 2, 3)).min())
    assert float(blob.amax()) <= 2.4 + 1e-5
    # different cells and seeds draw different scenes
    other = _render("fog", 0.0, 1, looks0, seed=10)
    assert float((a - other).abs().mean()) > 0.1
    # the scene draws match make_image's: altitude-scaled blobs, clutter
    # of SD ≈ 0.8·√(1 + 1/4 + 1/16) before smoothing losses
    clutter = _render("fog", 0.0, 0, looks0)
    assert 0.4 < float(clutter.std()) < 1.2


@pytest.mark.parametrize("corruption", ["fog", "motion"])
def test_deterministic_corruptions_match_reference(corruption):
    looks = torch.arange(16)
    clean = _render(corruption if corruption == "fog" else "fog", 0.0, 1,
                    looks)
    ref = jax.jit(jax.vmap(
        lambda img, sev: jsard.CORRUPTIONS_IMAGE[corruption](img, None,
                                                             sev)))
    for sev in (0.3, 1.0, 2.5):
        got = _render(corruption, sev, 1, looks)
        want = ref(jnp.asarray(clean.numpy()), jnp.full((16,), sev,
                                                        jnp.float32))
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-6, atol=1e-6)


def test_snow_specks_at_the_reference_rate():
    n_img, sev = 256, 1.5
    looks = torch.arange(n_img)
    clean = _render("snow", 0.0, 1, looks)
    got = _render("snow", sev, 1, looks)
    specks = got != clean
    assert bool((got[specks] == 2.0).all())
    rate, p = float(specks.float().mean()), 0.04 * sev
    sd = (p * (1 - p) / specks.numel()) ** 0.5
    assert abs(rate - p) < 4 * sd
    # fresh specks at every look
    assert not torch.equal(specks[0], _render("snow", sev, 1, looks + 1)[0]
                           != clean[0])


def test_frost_matches_reference_statistics():
    n_img, sev = 128, 1.0
    looks = torch.arange(n_img)
    clean = _render("frost", 0.0, 1, looks)
    got = _render("frost", sev, 1, looks)
    frosted = got != clean
    np.testing.assert_allclose(got[frosted].numpy(),
                               (clean[frosted] * (1 - 0.8 * sev)
                                + 1.5 * sev).numpy(), rtol=1e-6, atol=1e-6)
    masks = jax.jit(jax.vmap(lambda k: jsard._smooth_noise(
        k, 32, octaves=2)))(jax.random.split(jax.random.PRNGKey(1), n_img))
    want = float((np.asarray(masks) > 0.7).mean())
    assert abs(float(frosted.float().mean()) - want) < 0.25 * want


def test_observe_cells_reads_the_exposure_table(bridged_worlds):
    worlds = bridged_worlds[1]
    wid = torch.zeros(2, dtype=torch.int32)
    cells = torch.tensor([3, 20], dtype=torch.int32)
    got = tworld.observe_cells(T_W, worlds, wid, cells, 7)
    assert torch.equal(got, worlds["exposures"][0, [3, 20], 7])
    drawn = tworld.observe_cells(
        T_W, {k: v for k, v in worlds.items() if k != "exposures"}, wid,
        cells, 7)
    assert drawn.shape == got.shape and not torch.equal(drawn, got)


# ----------------------------------------------------------------------
# the token decision
# ----------------------------------------------------------------------
@pytest.fixture(scope="module")
def token_case(jax_params):
    """The reference's activation basis of 8 SARD patches at a policy
    whose decisions escalate, and the stream bases of 8 lanes."""
    from repro.serving import engine as jeng
    cfg = jsar.SarCnnConfig()
    tri = jtri.TriagePolicy(conf_threshold=0.55, mi_threshold=0.05)
    head, hcfg = jroll._prepare_group_head(jax_params, cfg, tri, None, True)
    imgs = jsard.batch_at(jsard.SardConfig(seed=5), 0, 8)["images"]
    rows = jeng._sar_featurize_fn(cfg, hcfg, None, None)(jax_params, head,
                                                         imgs)
    base = (np.arange(8, dtype=np.uint32) + 40) * np.uint32(20)
    return tri, jax.device_get(dict(rows)), base


@pytest.mark.parametrize("mask", ["all", "half", "none"])
@pytest.mark.parametrize("fused", [True, False], ids=["fused", "plain"])
@pytest.mark.parametrize("adaptive", [True, False],
                         ids=["adaptive", "fixed"])
def test_token_decision_matches_reference(token_case, adaptive, fused,
                                          mask):
    from repro.serving import adaptive as jad
    from repro.serving.engine import _lm_token_fn
    from repro_torch.core.sampling import BayesHeadConfig
    from repro_torch.serving import adaptive as tad
    from repro_torch.serving.engine import token_decision
    tri, rows, base = token_case
    active = {"all": np.ones(8, bool), "none": np.zeros(8, bool),
              "half": np.arange(8) % 2 == 0}[mask]
    schedule = jad.escalation_schedule(tri) if adaptive else (tri.r_max,)
    jcfg = jroll._group_base_hcfg(jsar.SarCnnConfig(), tri)
    want_v, want_fin, want_spent = jax.device_get(_lm_token_fn(
        jcfg, tri, adaptive, schedule, True, 8, 2)(
            {k: jnp.asarray(v) for k, v in rows.items()},
            jnp.asarray(base), jnp.asarray(active)))
    ttri_pol = ttri.TriagePolicy(conf_threshold=0.55, mi_threshold=0.05)
    assert tad.escalation_schedule(ttri_pol) == tuple(jad.escalation_schedule(
        tri))
    got_v, got_fin, got_spent = token_decision(
        {k: torch.tensor(v) for k, v in rows.items()},
        torch.tensor(base.astype(np.int64)), torch.tensor(active),
        hcfg=BayesHeadConfig(num_samples=20, mode="rank16",
                             grng=tsar.SarCnnConfig().grng,
                             compute_dtype=torch.float32, hoist_basis=True),
        policy=ttri_pol, adaptive_mode=adaptive, schedule=schedule,
        fused=fused)
    np.testing.assert_array_equal(got_v.numpy(), want_v)
    np.testing.assert_array_equal(got_spent.numpy(), want_spent)
    for k, v in want_fin.items():
        # an SE is sqrt((Σx²/n − (Σx/n)²)/n): the difference of two sums
        # of ~0.5 cancels, so a few float32 steps of the sums (summed in
        # another order) move it by up to sqrt(1e-7 · 20 / n) ≈ 1e-4
        atol = 1e-4 if k.endswith("_se") else 1e-5
        np.testing.assert_allclose(got_fin[k].numpy(), v, rtol=1e-5,
                                   atol=atol, err_msg=k)
    if mask == "none":          # no round ran: ESCALATE, nothing spent
        assert (want_v == ttri.ESCALATE).all()
        assert (want_spent == 0).all()
    elif adaptive and mask == "all":
        # the case escalates: some lanes go past the first round
        assert len(set(want_spent.tolist())) >= 2


# ----------------------------------------------------------------------
# the episode on the reference's worlds and exposures
# ----------------------------------------------------------------------
@pytest.mark.parametrize("fused", [True, False], ids=["fused", "plain"])
@pytest.mark.parametrize("name", list(CONFIGS))
def test_episode_matches_reference(port_params, bridged_worlds,
                                   reference_runs, name, fused):
    want = reference_runs(name)
    logs = want["logs"]
    # the reference's run exercises the branches this test claims
    assert logs["verify"].sum() > 0
    assert (~logs["active"]).sum() > 0
    if name != "deterministic":
        assert logs["orbited"].sum() > 0
    _, pol = _policies(**CONFIGS[name])
    got = _port_episode(port_params, pol, bridged_worlds[1], fused=fused)
    _assert_same_episode(got, want)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_summary_matches_reference(port_params, bridged_worlds,
                                   reference_runs, name):
    want = reference_runs(name)
    jpol, tpol = _policies(**CONFIGS[name])
    got = _port_episode(port_params, tpol, bridged_worlds[1])
    cost_j = jroll.sar_mission_cost(jsar.SarCnnConfig())
    cost_t = troll.sar_mission_cost(tsar.SarCnnConfig())
    assert dataclasses.astuple(cost_t) == dataclasses.astuple(cost_j)
    worlds = {k: np.asarray(v) for k, v in bridged_worlds[0].items()}
    s_want = jroll.summarize(J_W, J_U, jpol, cost_j, N_STEPS, worlds,
                             want["maps"], want["logs"], want["fleet"])
    s_got = troll.summarize(T_W, T_U, tpol, cost_t, N_STEPS, worlds,
                            got["maps"], got["logs"], got["fleet"])
    assert set(s_got) == set(s_want)
    for k, v in s_want.items():
        if isinstance(v, float):
            np.testing.assert_allclose(s_got[k], v, rtol=1e-6, err_msg=k)
        else:
            assert s_got[k] == v, k


# ----------------------------------------------------------------------
# a die
# ----------------------------------------------------------------------
@pytest.fixture(scope="module")
def die_case(jax_params):
    chip = j_sample(11, 1, JVariationSpec().scaled(1.5))[0]
    patches = np.asarray(jsard.batch_at(
        jsard.SardConfig(image_size=32, seed=0xCA1), 0, 64)["images"])
    cfg = jsar.SarCnnConfig()
    deployed = jroll._prepare_group_head(jax_params, cfg,
                                         jtri.TriagePolicy(), chip, True)
    bias = jroll.operating_point_bias(jax_params, cfg, deployed[0], chip,
                                      n_patches=64)
    return (chip, instance_from_tree(chip.to_tree()), patches, bias,
            deployed)


def test_operating_point_bias_on_a_die(port_params, die_case):
    _, tchip, patches, want, _ = die_case
    cfg = tsar.SarCnnConfig()
    head, _ = troll._prepare_group_head(port_params, cfg,
                                        ttri.TriagePolicy(), tchip, True)
    got = troll.operating_point_bias(port_params, cfg, head, tchip,
                                     images=patches)
    assert got.dtype == np.float32 and got[0] == 0.0
    # the die's margins are within a few ADC codes' effect (C9)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    assert float(want[1]) != 0.0


def test_operating_point_bias_zero_without_chip(port_params):
    bias = troll.operating_point_bias(port_params, tsar.SarCnnConfig(),
                                      None, None)
    np.testing.assert_array_equal(bias, np.zeros((2,), np.float32))


def test_die_episode_matches_reference(jax_params, port_params,
                                       bridged_worlds, die_case):
    """The trunk runs on the die's CIM arrays in both packages, each
    deploying its own head, at the reference's bias.  Outputs of the
    trunk that differ by an ADC code (C9) are counted over the batches
    the episode featurized; with none, the logs are held as on the
    ideal die, with some, confidence and entropy to 1e-3 (a flipped
    code's effect through the GAP and the head; 393 of the 620,352
    outputs flip here, moving confidence by at most 9.0e-4 and entropy
    by 5.0e-4) and the flips to at most 1e-3 of the trunk's outputs."""
    chip, tchip, _, bias, deployed = die_case
    jpol, tpol = _policies()
    want = _jax_episode(jax_params, jpol, bridged_worlds[0], chip=chip,
                        bias=bias, deployed=deployed)
    got = _port_episode(port_params, tpol, bridged_worlds[1], chip=tchip,
                        bias=bias)
    cfg_j, cfg_t = jsar.SarCnnConfig(), tsar.SarCnnConfig()

    @jax.jit
    def jax_layers(h):
        outs = []
        for i, layer in enumerate(jax_params["convs"]):
            h = jsar._conv(h, layer["w"], layer["b"], cfg_j, chip=chip,
                           layer_idx=i)
            outs.append(h)
        return outs

    trunk = tsar.program_trunk(port_params, cfg_t, tchip)
    table = bridged_worlds[1]["exposures"][0]
    flips = outputs = 0
    for t, cells in enumerate(want["logs"]["cell"]):
        for j in range(3):
            x = table[torch.tensor(cells, dtype=torch.long), 3 * t + j]
            hj = jax_layers(jnp.asarray(x.numpy()))
            for i in range(len(trunk)):
                x = tsar._cim_conv(x, trunk[i], cfg_t)
                gap = np.abs(x.numpy() - np.asarray(hj[i]))
                flips += int((gap > 1e-3).sum())
                outputs += gap.size
    assert flips <= 1e-3 * outputs, f"{flips} ADC code flips in {outputs}"
    _assert_same_episode(got, want, conf_atol=1e-3 if flips else 1e-5)


# ----------------------------------------------------------------------
# the reference's mission properties, on the port alone
# ----------------------------------------------------------------------
def _fly(port_params, pol=None, ucfg=T_U, **kw):
    kw.setdefault("n_steps", N_STEPS)
    return troll.fly_mission(T_W, ucfg, pol or tpolicy.MissionPolicy(),
                             params=port_params, device="cpu", **kw)


def test_mission_determinism_and_one_sync(port_params):
    a = _fly(port_params)
    b = _fly(port_params)
    assert a.host_syncs == b.host_syncs == 1
    assert a.summary == b.summary
    for k in a.logs:
        np.testing.assert_array_equal(a.logs[k], b.logs[k], err_msg=k)
    for k in a.maps:
        np.testing.assert_array_equal(a.maps[k], b.maps[k], err_msg=k)
    assert set(a.worlds) == {"victims", "severity", "seed"}


def test_mission_ledger_reconciles_with_serving_metrics(port_params):
    from repro_torch.hw import compile_network
    from repro_torch.launch.serve import sar_layer_shapes
    from repro_torch.serving.metrics import (RequestRecord, decision_cost,
                                             energy_terms, request_energy)
    cfg = tsar.SarCnnConfig()
    res = _fly(port_params, tpolicy.MissionPolicy(
        triage=ttri.TriagePolicy(conf_threshold=0.52, mi_threshold=0.05)))
    layers = sar_layer_shapes(cfg)
    program = compile_network(layers)
    assert troll.sar_mission_cost(cfg) == decision_cost(layers, program)
    terms = energy_terms(layers, program)
    logs = res.logs
    want = sum(
        request_energy(
            RequestRecord(rid=0, verdict=0,
                          n_samples=int(logs["spent"][t, b]),
                          n_decisions=1 + 2 * int(logs["orbited"][t, b]),
                          arrival_s=0.0, admit_s=0.0, done_s=0.0),
            layers, terms=terms)
        for t, b in zip(*np.nonzero(logs["active"])))
    got = float(logs["e_decision_J"].sum())
    np.testing.assert_allclose(got, want, rtol=1e-5)
    s = res.summary
    assert s["energy_decision_J"] == got
    np.testing.assert_allclose(
        s["energy_total_J"], s["energy_decision_J"] + s["energy_verify_J"]
        + s["energy_orbit_J"] + s["energy_flight_J"], rtol=1e-5)


def test_mission_verifications_bounded_by_detections(port_params):
    res = _fly(port_params, n_episodes=2)
    assert res.host_syncs == 1                # episodes batch, not loop
    logs = res.logs
    assert logs["cell"].shape == (N_STEPS, 2 * N_DRONES)
    detections = logs["active"] & (logs["prediction"] == 1)
    assert (logs["verify"] <= detections).all()
    assert (logs["orbited"] <= detections).all()
    assert (logs["found"] <= logs["verify"]).all()
    assert (logs["found"] <= logs["truth"]).all()
    s = res.summary
    assert s["verifications"] <= s["detections"]
    assert s["false_verifications"] <= s["verifications"]
    assert s["rescued"] <= s["victims"] == 2 * N_VICTIMS


def test_mission_deterministic_mode_verifies_every_detection(port_params):
    res = _fly(port_params, tpolicy.MissionPolicy(mode="deterministic"))
    logs = res.logs
    fresh = (logs["active"] & (logs["prediction"] == 1) & ~logs["verify"])
    # a detection goes unverified only on a cell already cleared
    cleared_before = np.zeros_like(fresh)
    seen = set()
    for t in range(fresh.shape[0]):
        for b in range(fresh.shape[1]):
            cleared_before[t, b] = logs["cell"][t, b] in seen
            if logs["verify"][t, b]:
                seen.add(logs["cell"][t, b])
    assert not (fresh & ~cleared_before).any()
    assert res.summary["orbits"] == 0
    assert res.summary["mean_samples_per_decision"] == 0.0


def test_mission_infogain_stays_in_sector(port_params):
    res = _fly(port_params, tpolicy.MissionPolicy(planner="infogain"),
               ucfg=dataclasses.replace(T_U, battery_J=400e-6))
    masks = tuav.sector_masks(GRID, N_DRONES)
    for d in range(N_DRONES):
        assert masks[d, res.logs["cell"][:, d]].all()
    assert res.summary["coverage"] > 0.2


def test_per_drone_chips_one_sync_per_die(port_params):
    from repro_torch.hw import VariationSpec, sample_instances
    chip = sample_instances(11, 1, VariationSpec().scaled(1.5))[0]
    res = _fly(port_params, chips=[None, chip], n_steps=10)
    assert res.host_syncs == 2
    assert (res.logs["energy_J"][-1] > 0).all()
    assert res.logs["active"][0].all()
    with pytest.raises(ValueError, match="per-drone"):
        _fly(port_params, chips=[None])


@pytest.mark.parametrize("kw,item", [({"mesh": object()}, "devices=")])
def test_unported_arms_raise(port_params, kw, item):
    with pytest.raises(NotImplementedError, match=item):
        _fly(port_params, **kw)


def test_mission_runs_on_the_card_by_default(port_params, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        troll.fly_mission(T_W, T_U, tpolicy.MissionPolicy(),
                          params=port_params, n_steps=2)


def test_mission_cli_on_the_cpu(tmp_path, monkeypatch, capsys):
    from repro_torch.launch import mission
    monkeypatch.chdir(tmp_path)          # the detector's cache goes here
    s = mission.main(["--device", "cpu", "--train-steps", "2", "--grid",
                      "6", "--victims", "3", "--drones", "2", "--steps",
                      "5", "--policy", "bayes_fixed"])
    out = capsys.readouterr().out
    assert "[bayes_fixed/lawnmower] 1x2 drones on 6x6" in out
    assert "host syncs 1" in out
    assert s["n_steps"] == 5 and s["mode"] == "bayes_fixed"
    assert (tmp_path / "artifacts" / "mission").is_dir()
