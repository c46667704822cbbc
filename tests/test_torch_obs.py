"""Telemetry, drift and aging of the port against the JAX reference.

  * aging: ``retention_decades``, ``die_rates``, ``age_factors`` and
    ``ChipInstance.at_age`` over several dies and ages equal the
    reference's bit for bit (the laws are numpy draws and host floats);
    ``at_age(0)`` is the birth instance itself, and an aged die refuses
    to age again;
  * telemetry: ``record_round`` on the reference's own round operands
    (selections, stream indices and update masks, bridged as numpy)
    with and without read noise, an all-masked round included;
    ``record_decisions`` on the reference's ``fin``; ``snapshot``.
    Counters and histograms equal exactly (no value on these seeds sits
    within 1e-5 of a bin edge, asserted), the GRNG moments within a
    relative 1e-6 (the port sums the probe block in another order);
  * drift: ``DriftReference.measure`` on the golden die and the seed-11
    severity-2.5 die (relative 1e-6), and ``drift_status`` /
    ``DriftMonitor`` on the same snapshots: z-scores within 1e-2 and the
    same ``drifted`` flag, with each case's |z| at least 0.5 from the
    gate (asserted, so the flag is compared, not gambled);
  * the serving engine with telemetry on against the reference's at a
    narrow width: the snapshot's counters and ``r_hist`` exactly, the
    moments within 1e-6, even though the port launches rounds after the
    exit (their masks are empty); telemetry changes no verdict and no
    host-sync count; the port's ``serve_sar`` drift and alerts.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import clt_grng as jg
from repro.hw import VariationSpec as JVariationSpec
from repro.hw import aging as jaging
from repro.hw import device as jdevice
from repro.hw import sample_instances as j_sample
from repro.obs import drift as jdrift
from repro.obs import telemetry as jtel
from repro.serving import adaptive as jadaptive
from repro_torch.bridge import instance_from_tree, params_from_jax
from repro_torch.core import clt_grng as tg
from repro_torch.hw import VariationSpec, aging, device, sample_instances
from repro_torch.obs import drift, telemetry as ttel

AGES = (0.0, 60.0, 3600.0, 2.6e6, 7.8e6)
NARROW = dict(channels=(4, 8, 8))


def _port_grng(cfg):
    return tg.GRNGConfig(**{f.name: getattr(cfg, f.name)
                            for f in dataclasses.fields(cfg)})


def _dies():
    """The golden die's seeds and two sampled dies of each package."""
    j = j_sample(11, 2, JVariationSpec().scaled(2.5)) + \
        j_sample(3, 1, JVariationSpec())
    return [(a, instance_from_tree(a.to_tree())) for a in j]


def _fields_equal(a, b):
    ta, tb = a.to_tree(), b.to_tree()
    assert set(ta) == set(tb)
    for key in ta:
        assert ta[key].dtype == tb[key].dtype, key
        np.testing.assert_array_equal(ta[key], tb[key], err_msg=key)


# ----------------------------------------------------------------------
# aging
# ----------------------------------------------------------------------
@pytest.mark.parametrize("t_s", AGES)
def test_retention_decades_bit_equal(t_s):
    for t0 in (3600.0, 60.0):
        assert device.retention_decades(t_s, t0) == \
            jdevice.retention_decades(t_s, t0)
    with pytest.raises(ValueError):
        device.retention_decades(-1.0, 3600.0)


@pytest.mark.parametrize("spread", [0.0, 0.3, 1.5])
def test_die_rates_bit_equal(spread):
    for j, t in _dies():
        js = jaging.AgingSpec(rate_spread=spread)
        ts = aging.AgingSpec(rate_spread=spread)
        assert aging.die_rates(t.device_seed, t.noise_seed, ts) == \
            jaging.die_rates(j.device_seed, j.noise_seed, js)


@pytest.mark.parametrize("t_s", AGES)
def test_at_age_bit_equal(t_s):
    for j, t in _dies():
        assert aging.age_factors(t, t_s) == jaging.age_factors(j, t_s)
        aged_t, aged_j = t.at_age(t_s), j.at_age(t_s)
        _fields_equal(aged_t, aged_j)
        assert dataclasses.asdict(aged_t.grng(tg.GRNGConfig())) == \
            dataclasses.asdict(aged_j.grng(jg.GRNGConfig()))
        if t_s == 0.0:
            assert aged_t is t              # the birth instance itself
        else:
            assert aged_t.age_s == t_s and aged_t.imprint > 0
            with pytest.raises(ValueError, match="birth"):
                aged_t.at_age(2 * t_s)      # ages never compound


# ----------------------------------------------------------------------
# telemetry on one round's own operands
# ----------------------------------------------------------------------
def _round_operands(seed: int, b: int, r: int, mask: str):
    rng = np.random.default_rng(seed)
    base = (rng.integers(0, 1000, b) * 20).astype(np.uint32)
    n = rng.integers(0, 16, b).astype(np.int32)
    upd = {"all": np.ones(b, bool), "none": np.zeros(b, bool),
           "some": rng.random(b) < 0.5}[mask]
    if mask == "some":
        upd[0] = False                # the probe lane is not lane 0
        upd[-1] = True
    return base, n, upd


@pytest.mark.parametrize("mask", ["all", "some", "none"])
@pytest.mark.parametrize("read_sigma", [0.0, 0.2])
def test_record_round_matches_reference(mask, read_sigma):
    grng = jg.GRNGConfig(read_sigma=read_sigma)
    tcfg_j, tcfg_t = jtel.TelemetryConfig(), ttel.TelemetryConfig()
    tel_j = jtel.init_telemetry(tcfg_j, 20)
    tel_t = ttel.init_telemetry(tcfg_t, 20, device="cpu")
    for rnd, r in enumerate((4, 8, 8)):
        base, n, upd = _round_operands(rnd, 6, r, mask)
        sel = jadaptive.stream_selections(grng, jnp.asarray(base),
                                          jnp.asarray(n), r)
        idx = jadaptive.stream_indices(jnp.asarray(base), jnp.asarray(n), r)
        tel_j = jtel.record_round(tel_j, tcfg_j, grng, sel, idx,
                                  jnp.asarray(upd))
        ttel.record_round(tel_t, tcfg_t, _port_grng(grng),
                          torch.tensor(np.asarray(sel)),
                          torch.tensor(np.asarray(idx).astype(np.int64)),
                          torch.tensor(upd))
    want = jax.device_get(tel_j)
    for key in ("rounds", "samples"):
        assert int(tel_t[key]) == int(want[key]), key
    for key in ("grng_n", "grng_sum", "grng_sumsq"):
        np.testing.assert_allclose(float(tel_t[key]), float(want[key]),
                                   rtol=1e-6, err_msg=key)
    if mask == "none":
        assert float(tel_t["grng_n"]) == 0 and int(tel_t["rounds"]) == 0


def _fin(seed: int, b: int):
    """A reference ``fin`` from random running sums."""
    rng = np.random.default_rng(seed)
    n = rng.integers(1, 21, b).astype(np.int32)
    p = rng.dirichlet([0.7, 0.7], b).astype(np.float32)
    stats = {"n": jnp.asarray(n),
             "sum_p": jnp.asarray(p * n[:, None]),
             "sum_psq": jnp.asarray(p * p * n[:, None] * 1.1),
             "sum_ent": jnp.asarray(rng.random(b).astype(np.float32) * n),
             "sum_entsq": jnp.asarray(rng.random(b).astype(np.float32) * n)}
    return jax.device_get(jadaptive.finalize(stats))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_record_decisions_and_snapshot_match_reference(seed):
    tcfg_j, tcfg_t = jtel.TelemetryConfig(), ttel.TelemetryConfig()
    fin = _fin(seed, 24)
    rng = np.random.default_rng(seed + 10)
    verdict = rng.integers(0, 3, 24).astype(np.int32)
    decided = rng.random(24) < 0.7
    # no value within 1e-5 of a bin edge: the histograms compare exactly
    ent_max = np.log(2.0)
    for x, scale, bins in ((fin["confidence"], 1.0, 16),
                           (fin["predictive_entropy"], ent_max, 16),
                           (fin["mutual_information"], ent_max, 16)):
        pos = np.asarray(x, np.float64) / scale * bins
        assert np.abs(pos - np.round(pos)).min() > 1e-5 * bins
    tel_j = jtel.record_decisions(jtel.init_telemetry(tcfg_j, 20), tcfg_j,
                                  jax.tree.map(jnp.asarray, fin),
                                  jnp.asarray(verdict), jnp.asarray(decided))
    tel_j = jtel.count_dispatch(tel_j)
    tel_t = ttel.init_telemetry(tcfg_t, 20, device="cpu")
    ttel.record_decisions(tel_t, tcfg_t,
                          {k: torch.tensor(np.asarray(v))
                           for k, v in fin.items()},
                          torch.tensor(verdict), torch.tensor(decided))
    ttel.count_dispatch(tel_t)
    ttel.count_dispatch(tel_t, torch.tensor(False))     # a skipped orbit
    snap_j = jtel.snapshot(tel_j, tcfg_j)
    snap_t = ttel.snapshot(tel_t, tcfg_t)
    for key in ("rounds", "dispatches", "samples", "decisions", "verdicts",
                "r_hist", "conf_hist", "ent_hist", "mi_hist", "conf_edges",
                "ent_edges", "ent_max"):
        assert snap_t[key] == snap_j[key], key
    assert snap_t["decisions"] == int(decided.sum())
    # NaN moments (no probe here) compare equal under assert_equal
    np.testing.assert_equal(ttel.merge_snapshots([snap_t, snap_t]),
                            jtel.merge_snapshots([snap_j, snap_j]))


# ----------------------------------------------------------------------
# drift
# ----------------------------------------------------------------------
def _probe_dies():
    j = j_sample(11, 1, JVariationSpec().scaled(2.5))[0]
    return {"golden": (jg.GRNGConfig(), tg.GRNGConfig()),
            "die": (j.grng(jg.GRNGConfig()),
                    instance_from_tree(j.to_tree()).grng(tg.GRNGConfig()))}


@pytest.mark.parametrize("die", ["golden", "die"])
def test_drift_reference_measure_matches(die):
    jcfg, tcfg = _probe_dies()[die]
    want = jdrift.DriftReference.measure(jcfg)
    got = drift.DriftReference.measure(tcfg, device="cpu")
    assert (got.n, got.probe_cells) == (want.n, want.probe_cells)
    np.testing.assert_allclose(got.sum_mean_uA, want.sum_mean_uA, rtol=1e-6)
    np.testing.assert_allclose(got.sum_std_uA, want.sum_std_uA, rtol=1e-6)


@pytest.mark.parametrize("case", [("golden", "golden"), ("golden", "die"),
                                  ("die", "die"), ("die", "golden")])
def test_drift_status_and_monitor_match(case):
    """Belief ``case[0]`` against a stream from ``case[1]``: the probe's
    moments of 512 samples of 32 cells drawn by each package's
    ``raw_sums`` at an offset past the reference's measurement."""
    belief, served = case
    dies = _probe_dies()
    ref_j = jdrift.DriftReference.measure(dies[belief][0])
    ref_t = drift.DriftReference.measure(dies[belief][1], device="cpu")
    raw = np.asarray(jg.raw_sums(dies[served][0], 32, 1, 512, 4096),
                     np.float32)
    snap = {"grng": {"n": float(raw.size),
                     "sum": float(np.float32(raw.sum())),
                     "sumsq": float(np.float32((raw * raw).sum()))}}
    st_j = jdrift.drift_status(snap, ref_j)
    st_t = drift.drift_status(snap, ref_t)
    assert abs(max(abs(st_j.z_mean), abs(st_j.z_std)) - 5.0) >= 0.5
    assert st_t.drifted == st_j.drifted == (belief != served)
    np.testing.assert_allclose(st_t.z_mean, st_j.z_mean, atol=1e-2)
    np.testing.assert_allclose(st_t.z_std, st_j.z_std, atol=1e-2)
    assert (st_t.advisory is None) == (st_j.advisory is None)
    mon_j, mon_t = jdrift.DriftMonitor(ref_j), drift.DriftMonitor(ref_t)
    for half in (snap, snap):
        mon_j.observe_snapshot(half)
        mon_t.observe_snapshot(half)
    assert mon_t.status().drifted == mon_j.status().drifted
    np.testing.assert_allclose(mon_t.status().z_mean,
                               mon_j.status().z_mean, atol=1e-2)
    # below min_samples nothing is judged
    small = {"n": 100.0, "sum": 1000.0, "sumsq": 11000.0}
    assert not drift.drift_status(small, ref_t).drifted
    assert np.isnan(drift.drift_status(small, ref_t).z_mean)


def test_reference_for_follows_the_belief():
    from repro_torch.core.sampling import BayesHeadConfig
    from repro_torch.models.sar_cnn import SarCnnConfig
    cfg = SarCnnConfig()
    die = _probe_dies()["die"][1]
    hcfg = BayesHeadConfig(grng=die)
    golden = drift.DriftReference.measure(cfg.grng, device="cpu")
    assert drift.reference_for(cfg, hcfg, calibrated=False,
                               device="cpu") == golden
    assert drift.reference_for(cfg, None, device="cpu") == golden
    assert drift.reference_for(cfg, hcfg, device="cpu") == \
        drift.DriftReference.measure(die, device="cpu")


# ----------------------------------------------------------------------
# the engine with telemetry on
# ----------------------------------------------------------------------
@pytest.fixture(scope="module")
def narrow():
    from repro.models.sar_cnn import SarCnnConfig as JCfg
    from repro.models.sar_cnn import init_sar_cnn
    from repro_torch.launch.serve import make_sar_stream
    from repro_torch.models.sar_cnn import SarCnnConfig
    jcfg = JCfg(**NARROW)
    jp = init_sar_cnn(jax.random.PRNGKey(5), jcfg)
    return {"jcfg": jcfg, "tcfg": SarCnnConfig(**NARROW), "jparams": jp,
            "tparams": params_from_jax(jax.device_get(jp)),
            "stream": make_sar_stream(40, corrupt_frac=0.25,
                                      corruption="fog")}


def _engines(narrow, policy_kw, fused):
    from repro.serving import Request as JRequest
    from repro.serving import SarServingEngine as JEngine
    from repro.serving import TriagePolicy as JPolicy
    from repro_torch.serving import Request, SarServingEngine, TriagePolicy
    jeng = JEngine(narrow["jparams"], narrow["jcfg"], n_slots=8,
                   policy=JPolicy(**policy_kw), fused=fused,
                   profiler=False, slo=False)
    out = {}
    for tel in (True, False):
        out[tel] = SarServingEngine(
            narrow["tparams"], narrow["tcfg"], n_slots=8,
            policy=TriagePolicy(**policy_kw), telemetry=tel, device="cpu")
    for r in narrow["stream"]:
        jeng.submit(JRequest(rid=r.rid, payload=np.asarray(r.payload)))
        for eng in out.values():
            eng.submit(Request(rid=r.rid, payload=np.asarray(r.payload)))
    return jeng, out


@pytest.mark.parametrize("policy_kw,fused", [
    (dict(conf_threshold=0.7, mi_threshold=0.05), False),
    (dict(conf_threshold=0.55, mi_threshold=0.05), False),
    (dict(conf_threshold=0.55, mi_threshold=0.05), True)])
def test_engine_snapshot_matches_reference(narrow, policy_kw, fused):
    jeng, ports = _engines(narrow, policy_kw, fused)
    want = jeng.run()["telemetry"]
    got = ports[True].run()
    off = ports[False].run()
    snap = got["telemetry"]
    for key in ("rounds", "dispatches", "samples", "decisions", "verdicts",
                "r_hist", "conf_hist", "ent_hist", "mi_hist"):
        assert snap[key] == want[key], key
    for key in ("n", "sum", "sumsq"):
        np.testing.assert_allclose(snap["grng"][key], want["grng"][key],
                                   rtol=1e-6, err_msg=key)
    # the port launched rounds after the exit that the reference never
    # ran; their empty masks added nothing
    assert ports[True].rounds_launched > snap["rounds"]
    # telemetry changes no verdict and no host sync
    assert [(r.rid, r.verdict, r.n_samples) for r in
            ports[True].metrics.records] == \
        [(r.rid, r.verdict, r.n_samples) for r in
         ports[False].metrics.records]
    assert ports[True].host_syncs == ports[False].host_syncs == \
        jeng.host_syncs
    assert "telemetry" not in off
    assert ports[False].telemetry_snapshot() is None


def test_engine_snapshot_on_a_read_noise_die(narrow):
    chip = j_sample(11, 1, JVariationSpec().scaled(2.0))[0]
    policy_kw = dict(conf_threshold=0.55, mi_threshold=0.05)
    from repro.core.bayes_layer import sigma_of
    from repro.core.sampling import BayesHeadConfig as JHead
    from repro.hw import prepare_instance_head as j_prepare
    from repro.serving import Request as JRequest
    from repro.serving import SarServingEngine as JEngine
    from repro.serving import TriagePolicy as JPolicy
    from repro_torch.bridge import head_from_jax
    from repro_torch.serving import Request, SarServingEngine, TriagePolicy
    jp = narrow["jparams"]
    head, hcfg = j_prepare(jp["head"]["mu"], sigma_of(jp["head"]),
                           JHead(mode="rank16", grng=narrow["jcfg"].grng,
                                 compute_dtype=jnp.float32,
                                 hoist_basis=True), chip)
    # both engines serve the same deployed head (the port's own
    # deployment differs by 1–2 ulp, ROADMAP C9), on the float trunk
    jeng = JEngine(jp, narrow["jcfg"], n_slots=8, policy=JPolicy(**policy_kw),
                   head=head, hcfg=hcfg, fused=False, profiler=False,
                   slo=False)
    from repro_torch.core.sampling import BayesHeadConfig
    thcfg = BayesHeadConfig(mode="rank16", grng=_port_grng(hcfg.grng),
                            compute_dtype=torch.float32, hoist_basis=True)
    teng = SarServingEngine(narrow["tparams"], narrow["tcfg"], n_slots=8,
                            policy=TriagePolicy(**policy_kw),
                            head=head_from_jax(jax.device_get(head)),
                            hcfg=thcfg, device="cpu")
    assert hcfg.grng.read_sigma > 0
    for r in narrow["stream"][:24]:
        jeng.submit(JRequest(rid=r.rid, payload=np.asarray(r.payload)))
        teng.submit(Request(rid=r.rid, payload=np.asarray(r.payload)))
    want = jeng.run()["telemetry"]
    snap = teng.run()["telemetry"]
    for key in ("rounds", "dispatches", "samples", "verdicts", "r_hist"):
        assert snap[key] == want[key], key
    for key in ("n", "sum", "sumsq"):
        np.testing.assert_allclose(snap["grng"][key], want["grng"][key],
                                   rtol=1e-6, err_msg=key)


def test_serve_sar_drift_and_alerts():
    from repro_torch.launch.serve import serve_sar
    from repro_torch.models.sar_cnn import SarCnnConfig
    cfg = SarCnnConfig(**NARROW)
    die = sample_instances(11, 1, VariationSpec().scaled(2.5))[0]
    gold = serve_sar(n_requests=48, n_slots=16, cfg=cfg, device="cpu")
    bad = serve_sar(n_requests=48, n_slots=16, cfg=cfg, chip_instance=die,
                    calibrated=False, device="cpu")
    assert gold["telemetry"]["decisions"] == 48
    assert not gold["drift"]["drifted"] and "alerts" not in gold
    assert bad["drift"]["drifted"]
    assert [a["kind"] for a in bad["alerts"]] == ["drift"]
    off = serve_sar(n_requests=48, n_slots=16, cfg=cfg, telemetry=False,
                    device="cpu")
    assert "telemetry" not in off and "drift" not in off
    assert [v["verdict"] for v in off["verdicts"]] == \
        [v["verdict"] for v in gold["verdicts"]]
    assert off["host_syncs"] == gold["host_syncs"]


def test_drift_cli_separates_dies(tmp_path):
    out = tmp_path / "drift.json"
    assert drift._main(["--device", "cpu", "--requests", "48", "--slots",
                        "16", "--out", str(out)]) == 0
    import json
    report = json.loads(out.read_text())
    assert report["separated"]
    assert report["dies"]["degraded_uncalibrated"]["status"]["drifted"]
