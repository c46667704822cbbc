"""Time to verdict, SLOs, the open-loop harness and the alert bus of the
port against the JAX reference (twins ``tests/test_slo.py`` without its
fleet tests).

  * ``obs/slo``: the same synthetic ``RequestRecord`` stream goes into
    both packages' ``SloTracker`` and the snapshots come out equal
    exactly (histograms, quantiles, SLO ledgers: the same float
    arithmetic on the same numbers); ``quantile``, ``SLO.parse``, the
    burn math and the bad specs match;
  * ``serving/load``: ``ArrivalSpec.offsets`` equal the reference's bit
    for bit from the same seed, and hit their mean rates;
  * the port's engine at a narrow width on the CPU: verdicts and host
    syncs identical with the SLO tracker on and off; queue + service =
    latency for every record and dispatch wait ≤ time to verdict ≤
    latency; the open-loop harness; SLO targets and breaches;
  * the SLO snapshot's request counts by verdict and by samples at
    verdict equal those of the reference engine on the same 12-request
    stream (latencies are host clocks, not compared across packages);
  * the alert bus on SLO burn and backpressure, and its export.
"""

import json
import math

import jax
import numpy as np
import pytest

from repro.obs import slo as jslo
from repro.serving import load as jload
from repro_torch.obs import registry as treg
from repro_torch.obs.alerts import AlertBus
from repro_torch.obs.registry import MetricsRegistry, add_alerts, add_slo, \
    quantile
from repro_torch.obs.slo import NULL_SLO, SLO, SloTracker, _EDGES
from repro_torch.serving.load import ArrivalSpec, run_open_loop

NARROW = dict(channels=(4, 8, 8))
POLICY = dict(conf_threshold=0.7, mi_threshold=0.05, r_min=4, r_max=20)


@pytest.fixture(scope="module")
def narrow():
    """The reference's params at the narrow width and the port's copy."""
    from repro.models.sar_cnn import SarCnnConfig as JCfg
    from repro.models.sar_cnn import init_sar_cnn
    from repro_torch.bridge import params_from_jax
    from repro_torch.models.sar_cnn import SarCnnConfig
    jcfg = JCfg(**NARROW)
    jp = init_sar_cnn(jax.random.PRNGKey(5), jcfg)
    return {"jcfg": jcfg, "jparams": jp, "cfg": SarCnnConfig(**NARROW),
            "params": params_from_jax(jax.device_get(jp))}


def _stream(n):
    from repro_torch.launch.serve import make_sar_stream
    return make_sar_stream(n, corrupt_frac=0.25, corruption="fog")


def _engine(narrow, *, slo=True, n_slots=8, policy=POLICY):
    from repro_torch.serving import SarServingEngine, TriagePolicy
    return SarServingEngine(narrow["params"], narrow["cfg"], n_slots=n_slots,
                            policy=TriagePolicy(**policy), telemetry=False,
                            slo=slo, device="cpu")


def _served(narrow, n, **kw):
    eng = _engine(narrow, **kw)
    for r in _stream(n):
        eng.submit(r)
    out = eng.run()
    return eng, out


# ----------------------------------------------------------------------
# the tracker against the reference's, on one record stream
# ----------------------------------------------------------------------
def _records(rec_cls, n, seed=0):
    rng = np.random.default_rng(seed)
    arrival = np.cumsum(rng.exponential(0.01, n))
    wait = rng.lognormal(-6, 1.5, n)
    service = rng.lognormal(-5, 1.0, n)
    verdict = rng.integers(0, 3, n)
    r = rng.choice([4, 8, 12, 16, 20], n)
    out = []
    for i in range(n):
        admit = arrival[i] + wait[i]
        done = admit + service[i]
        kw = dict(rid=i, verdict=int(verdict[i]), n_samples=int(r[i]),
                  n_decisions=1, arrival_s=1e9 + float(arrival[i]),
                  admit_s=float(admit), done_s=float(done),
                  arrival_pc=float(arrival[i]))
        if i % 5:                 # every fifth record has no verdict stamp
            kw.update(first_dispatch_s=float(admit + 1e-4),
                      verdict_s=float(done - 2e-5))
        if i % 7 == 3:
            kw["arrival_pc"] = float("nan")
            kw["arrival_s"] = float(arrival[i])
        out.append(rec_cls(**kw))
    return out


@pytest.mark.parametrize("slos", [(), ("0.05:p99", "0.02:p50:3",
                                        "1e-3:p99.9")])
def test_tracker_snapshot_equals_reference(slos):
    """Exact equality of the two snapshots (``==`` on the dicts, as
    JSON): the same numpy binning, sums and quantile interpolation."""
    from repro.serving.metrics import RequestRecord as JRecord
    from repro_torch.serving.metrics import RequestRecord
    port, ref = SloTracker(slos=slos), jslo.SloTracker(slos=slos)
    for a, b in zip(_records(RequestRecord, 400), _records(JRecord, 400)):
        port.observe(a)
        ref.observe(b)
    ref.observe_router(3e-5)
    port.observe_router(3e-5)
    got, want = port.snapshot(), ref.snapshot()
    assert json.dumps(got) == json.dumps(want)
    assert got["requests"] == 400
    assert sum(h["count"] for h in got["by_verdict"].values()) == 400
    assert set(got["by_r"]) == {"4", "8", "12", "16", "20"}


def test_quantile_matches_numpy_within_a_bucket_and_the_reference():
    from repro.obs.registry import quantile as jquantile
    rng = np.random.default_rng(0)
    samples = rng.lognormal(mean=-5.0, sigma=1.5, size=4000)
    h = SloTracker()
    for s in samples:
        h._ttv.observe(float(s))
    hist = h._ttv.to_dict()
    ratio = hist["edges"][1] / hist["edges"][0]
    for q in (0.5, 0.9, 0.95, 0.99):
        est = quantile(hist, q)
        exact = float(np.quantile(samples, q))
        assert exact / ratio <= est <= exact * ratio, (q, est, exact)
        assert est == jquantile(hist, q)
    assert math.isnan(quantile({"counts": [0, 0], "edges": [0.1, 1.0, 10.0],
                                "overflow": 0}, 0.5))
    assert quantile({"counts": [0, 0], "edges": [0.1, 1.0, 10.0],
                     "overflow": 5}, 0.5) == 10.0
    assert 0.1 <= quantile({"counts": [4, 0], "edges": [0.1, 1.0, 10.0],
                            "overflow": 0}, 0.5) <= 1.0


def test_slo_parse_and_burn_math_match_reference():
    for spec in ("0.25:p99", "0.25", "1.5:p95:4", "0.1:99", "2:0.9",
                 "1e-9:p99.9:1.5"):
        a, b = SLO.parse(spec), jslo.SLO.parse(spec)
        assert (a.target_s, a.percentile, a.burn_alert, a.name,
                a.error_budget) == (b.target_s, b.percentile, b.burn_alert,
                                    b.name, b.error_budget), spec
        for v, n in ((5, 100), (1, 100), (0, 0), (3, 7), (10, 100)):
            got, want = a.evaluate(v, n), b.evaluate(v, n)
            assert json.dumps(got) == json.dumps(want), (spec, v, n)
    s = SLO.parse("0.25:p99")
    assert s.name == "p99<=0.25s" and abs(s.error_budget - 0.01) < 1e-9
    assert s.evaluate(5, 100)["breach"] is True
    assert s.evaluate(1, 100)["breach"] is False
    assert SLO.parse("1.5:p95:4").evaluate(10, 100)["breach"] is False
    assert SLO.parse("0.1:p99").evaluate(0, 0)["breach"] is False


def test_slo_bad_specs_raise():
    for bad in ("0.25:q99", "fast:p99"):
        with pytest.raises(ValueError):
            SLO.parse(bad)
        with pytest.raises(ValueError):
            jslo.SLO.parse(bad)


def test_slo_hist_edges_cover_wide_range():
    t = SloTracker()
    for v in (1e-7, float("nan"), -1.0, 1e3):
        t._ttv.observe(v)
    d = t._ttv.to_dict()
    assert d["count"] == 3 and d["overflow"] == 1
    assert sum(d["counts"]) + d["overflow"] == 3
    assert d["edges"] == jslo._EDGES.tolist() and len(_EDGES) == 33


def test_null_slo_is_inert():
    NULL_SLO.observe(object())
    NULL_SLO.observe_router(0.1)
    NULL_SLO.sample_queues([1], [1], 2)
    NULL_SLO.backpressure(5)
    assert NULL_SLO.snapshot() == {} and not NULL_SLO.enabled


def test_fleet_bookkeeping_matches_reference():
    """The fleet hooks are plain bookkeeping, held to the reference's
    here (the fleet that calls them: tests/test_torch_fleet.py)."""
    port, ref = SloTracker(), jslo.SloTracker()
    for t in (port, ref):
        t.sample_queues([3, 0, 5], [8, 8, 2], 4)
        t.sample_queues([1, 2], [8, 1], 0)
        t.backpressure(9)
        t.observe_router(2e-4)
    assert json.dumps(port.snapshot()) == json.dumps(ref.snapshot())


# ----------------------------------------------------------------------
# arrival processes
# ----------------------------------------------------------------------
@pytest.mark.parametrize("spec_str,mean", [
    ("poisson:50", 50.0), ("burst:50", 50.0), ("burst:50:4", 50.0),
    ("ramp:20:80", 60.0 / math.log(4.0))])
def test_arrival_offsets_bit_equal_and_rated(spec_str, mean):
    spec = ArrivalSpec.parse(spec_str)
    assert spec.to_dict() == jload.ArrivalSpec.parse(spec_str).to_dict()
    assert spec.mean_rate == pytest.approx(mean)
    for seed in (0, 3):
        a = spec.offsets(4000, seed=seed)
        np.testing.assert_array_equal(
            a, jload.ArrivalSpec.parse(spec_str).offsets(4000, seed=seed))
        assert a.dtype == np.float64
    a = spec.offsets(4000, seed=3)
    assert not np.array_equal(a, spec.offsets(4000, seed=4))
    assert np.all(np.diff(a) >= 0)
    assert len(a) / a[-1] == pytest.approx(mean, rel=0.1)
    assert spec.offsets(0).shape == (0,)


def test_burst_spec_actually_bursts():
    gaps = np.diff(np.concatenate(
        [[0.0], ArrivalSpec.parse("burst:100:10").offsets(640, seed=0)]))
    group = (np.arange(640) // 16) % 2
    assert gaps[group == 1].mean() > 5 * gaps[group == 0].mean()


def test_arrival_parse_rejects_unknown():
    with pytest.raises(ValueError):
        ArrivalSpec.parse("uniform:5")


# ----------------------------------------------------------------------
# the engine
# ----------------------------------------------------------------------
def test_engine_slo_zero_overhead(narrow):
    n = 24
    on, _ = _served(narrow, n, slo=True)
    off, out_off = _served(narrow, n, slo=False)
    assert [(r.rid, r.verdict, r.prediction, r.n_samples)
            for r in on.metrics.records] == \
        [(r.rid, r.verdict, r.prediction, r.n_samples)
         for r in off.metrics.records]
    assert on.host_syncs == off.host_syncs
    assert off.slo is NULL_SLO and "slo" not in out_off
    snap = on.slo.snapshot()
    assert snap["requests"] == n
    assert snap["time_to_verdict"]["count"] == n
    assert sum(v["count"] for v in snap["by_verdict"].values()) == n
    assert snap["p50_s"] <= snap["p95_s"] <= snap["p99_s"]


def test_queue_plus_service_reconciles_with_latency(narrow):
    """Per record (absolute 1e-9 s: one subtraction each on the same
    perf_counter stamps): queue wait + service = latency; the dispatch
    wait precedes the verdict, which precedes the retirement."""
    n = 16
    eng, out = _served(narrow, n)
    span = out["slo"]["span_s"]
    for rec in eng.metrics.records:
        q, s, tot = rec.queue_latency_s, rec.service_latency_s, \
            rec.latency_s
        assert q >= 0 and s >= 0
        assert q + s == pytest.approx(tot, rel=1e-6, abs=1e-9)
        assert tot <= span + 1e-3
        assert 0.0 <= rec.dispatch_wait_s
        assert rec.dispatch_wait_s <= rec.verdict_latency_s <= tot + 1e-9
    summ = eng.metrics.summary()
    assert summ["queue_wait_total_s"] + summ["service_total_s"] == \
        pytest.approx(sum(r.latency_s for r in eng.metrics.records),
                      rel=1e-6)
    assert 0.0 <= summ["queue_wait_share"] <= 1.0


def test_open_loop_engine_and_snapshot(narrow):
    n = 16
    eng = _engine(narrow, n_slots=4)
    spec = ArrivalSpec.parse("poisson:400")
    out = run_open_loop(eng, _stream(n), spec.offsets(n, seed=0))
    assert out["requests"] == n
    assert out["offered"]["submitted"] == n
    snap = out["slo"]
    assert snap["requests"] == n
    assert snap["p50_s"] <= snap["p95_s"] <= snap["p99_s"]
    assert math.isfinite(snap["mean_s"])
    with pytest.raises(ValueError):
        run_open_loop(eng, _stream(2), [0.0])


def test_serve_sar_open_loop_and_slo_specs(narrow):
    from repro_torch.launch.serve import serve_sar
    out = serve_sar(n_requests=12, n_slots=4, cfg=narrow["cfg"],
                    telemetry=False, slo=("1e9:p50", "1e-9:p99"),
                    arrival="poisson:500", device="cpu")
    assert out["arrival"]["kind"] == "poisson"
    assert out["offered"]["submitted"] == 12
    res = {s["name"]: s for s in out["slo"]["slos"]}
    assert res["p50<=1e+09s"]["violations"] == 0
    assert res["p99<=1e-09s"]["violations"] == 12
    assert [a["kind"] for a in out["alerts"]] == ["slo_burn"]
    assert "stage_profile" in out and "compile_counters" in out


def test_slo_tracker_targets_and_breach(narrow):
    n = 12
    tracker = SloTracker(slos=("1e9:p50", "1e-9:p99"))
    eng, _ = _served(narrow, n, slo=tracker, n_slots=4)
    results = {s["name"]: s for s in tracker.snapshot()["slos"]}
    assert results["p50<=1e+09s"]["violations"] == 0
    assert results["p50<=1e+09s"]["breach"] is False
    tiny = results["p99<=1e-09s"]
    assert tiny["violations"] == n and tiny["breach"] is True
    assert tiny["attainment"] == 0.0
    assert "slo" not in eng.metrics.summary()      # the caller's tracker


def test_slo_counts_match_reference_engine(narrow):
    """The same 12 requests through the reference's engine (its own SLO
    tracker on) and the port's: the same verdicts, so the same request
    counts by verdict and by samples at verdict.  At this width and
    threshold the stream accepts, flags, and escalates to 16 samples."""
    from repro.serving import Request as JRequest
    from repro.serving import SarServingEngine as JEngine
    from repro.serving import TriagePolicy as JPolicy
    policy = dict(POLICY, conf_threshold=0.52)
    reqs = _stream(12)
    jeng = JEngine(narrow["jparams"], narrow["jcfg"], n_slots=4,
                   policy=JPolicy(**policy), fused=False, telemetry=False,
                   profiler=False, slo=True)
    for r in reqs:
        jeng.submit(JRequest(rid=r.rid, payload=np.asarray(r.payload)))
    want = jeng.run()["slo"]
    eng, out = _served(narrow, 12, n_slots=4, policy=policy)
    got = out["slo"]

    def counts(snap, key):
        return {k: h["count"] for k, h in snap[key].items()}

    assert counts(got, "by_verdict") == counts(want, "by_verdict")
    assert counts(got, "by_r") == counts(want, "by_r")
    assert len(counts(got, "by_r")) >= 2           # the stream escalates
    assert len(counts(got, "by_verdict")) >= 2
    assert got["requests"] == want["requests"] == 12


# ----------------------------------------------------------------------
# alert bus
# ----------------------------------------------------------------------
def test_alert_bus_slo_burn_fires_and_quiet():
    bus = AlertBus()
    breached = {"slos": [
        {"name": "p99<=0.25s", "breach": True, "burn_rate": 8.0,
         "burn_alert": 2.0, "violations": 9, "requests": 100},
        {"name": "p50<=1s", "breach": False, "burn_rate": 0.1,
         "burn_alert": 2.0, "violations": 0, "requests": 100}]}
    bus.observe_slo(breached, source="test")
    assert bus.counts() == {"slo_burn": 1}
    assert bus.worst_severity() == "critical"
    quiet = AlertBus()
    quiet.observe_slo({"slos": [breached["slos"][1]]}, source="test")
    quiet.observe_drift({"drifted": False}, source="test")
    quiet.observe_backpressure({"fleet": {"backpressure_ticks": 0,
                                          "ticks": 9}})
    quiet.observe_slo(None)
    assert len(quiet) == 0


def test_alert_bus_backpressure_severity_scales():
    bus = AlertBus()
    bus.observe_backpressure({"fleet": {"backpressure_ticks": 1,
                                        "ticks": 10, "backlog_peak": 3}})
    bus.observe_backpressure({"fleet": {"backpressure_ticks": 9,
                                        "ticks": 10, "backlog_peak": 40}})
    assert [a.severity for a in bus.advisories] == ["warning", "critical"]


def test_mission_summary_unchanged_by_alert_bus():
    summary = {"decisions": 10, "rescued": 1}
    telem = {"g0": {"drift": {"drifted": True, "advisory": "drift!",
                              "z_mean": 9.0, "z_std": 1.0, "n": 64}}}
    before = json.dumps([telem, summary], sort_keys=True)
    bus = AlertBus()
    for g, t in telem.items():
        bus.observe_drift(t["drift"], source=f"mission/{g}")
    assert len(bus) == 1 and bus.advisories[0].kind == "drift"
    assert json.dumps([telem, summary], sort_keys=True) == before


def test_registry_exports_slo_and_alerts(narrow, tmp_path):
    from repro.obs import registry as jreg
    _, out = _served(narrow, 12, n_slots=4)
    bus = AlertBus(clock=lambda: 7.0)
    bus.emit("slo_burn", "critical", "test", "burning")
    regs = []
    for mod in (treg, jreg):
        reg = mod.MetricsRegistry()
        mod.add_slo(reg, out["slo"], job="test")
        mod.add_alerts(reg, bus.to_json(), job="test")
        regs.append(reg)
    assert regs[0].to_prometheus() == regs[1].to_prometheus()
    reg = MetricsRegistry()
    add_slo(reg, out["slo"], job="test")
    add_alerts(reg, bus.to_json(), job="test")
    text = reg.to_prometheus()
    for key in ("slo_requests_total", "slo_time_to_verdict_seconds_bucket",
                'le="+Inf"', "alerts_total", 'kind="slo_burn"'):
        assert key in text, key
    reg.write(str(tmp_path / "m"))
    doc = json.loads((tmp_path / "m.json").read_text())
    names = [m["name"] for m in doc["metrics"]]
    assert any(n.endswith("slo_requests_total") for n in names)
    assert any(n.endswith("alerts_total") for n in names)


def test_collect_alerts_folds_in_the_slo_snapshot():
    from repro_torch.launch.serve import collect_alerts
    out = {"slo": {"slos": [SLO.parse("1e-9:p99").evaluate(12, 12)]},
           "drift": {"drifted": False}}
    bus = collect_alerts(out, "serve_sar")
    assert bus.counts() == {"slo_burn": 1}
    assert out["alerts"][0]["fields"]["violations"] == 12
