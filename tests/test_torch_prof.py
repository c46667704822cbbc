"""Stage profiles, build counters, cost records, traces, metric exports
and the analytic energy model of the port against the JAX reference.

Twins ``tests/test_perf_obs.py``'s profiler and exposition checks and
``tests/test_obs.py``'s tracer, registry and profiler-identity checks:

  * ``obs/registry``: the same summary, telemetry, drift, stage-profile,
    compile-counter, cost, SLO and alert dicts go into both packages'
    ``serving_registry`` / ``mission_registry`` / primitives and come out
    as equal Prometheus text and JSON, byte for byte; the port's own
    compile counters (nvcc, no XLA) export no ``xla_*`` line;
  * ``obs/prof``: ``StageProfiler`` snapshots equal the reference's on the
    same observations; the engine's stage profile, build counters and
    cost records; two engines of one config build each cached builder
    at most once between them; ``trace_capture``;
  * ``obs/trace``: the engine's spans, with the same verdicts and host
    syncs with the tracer on and off; ``mission_trace`` on the port's
    episode over the reference's bridged worlds equals the reference's
    ``mission_trace`` of the same logs;
  * ``core/energy``: the nine analytic functions equal the reference's
    bit for bit (plain ``math`` on the same constants), and a served
    batch's per-request energies sum to ``grid_inference_energy`` of the
    same placed blocks (relative 1e-9, as tests/test_hw_conformance.py:
    the sum runs over records in another order);
  * ``kernels/bounds``: the counts PERF.md §6's Bound column and
    ``chip_smoke.py`` use, pinned at its shapes.

The port's engine runs on the CPU at a narrow width (convs 4/8/8).
Latencies are host clocks, so they are compared only to themselves.
"""

import json
import math

import jax
import pytest
import torch

from repro.core import energy as jenergy
from repro.obs import registry as jreg
from repro.obs import trace as jtrace
from repro.obs.prof import StageProfiler as JStageProfiler
from repro_torch.core import energy as tenergy
from repro_torch.core.clt_grng import GRNGConfig
from repro_torch.kernels import bounds
from repro_torch.obs import prof
from repro_torch.obs import registry as treg
from repro_torch.obs.prof import NULL_PROFILER, StageProfiler
from repro_torch.obs.trace import NULL_TRACER, Tracer, mission_trace

NARROW = dict(channels=(4, 8, 8))
POLICY = dict(conf_threshold=0.7, mi_threshold=0.05, r_min=4, r_max=20)


@pytest.fixture(scope="module")
def narrow():
    from repro_torch.models.sar_cnn import SarCnnConfig, init_sar_cnn
    cfg = SarCnnConfig(**NARROW)
    return init_sar_cnn(torch.Generator().manual_seed(3), cfg), cfg


def _stream(n):
    from repro_torch.launch.serve import make_sar_stream
    return make_sar_stream(n, corrupt_frac=0.25, corruption="fog")


def _run(narrow, n, *, policy=POLICY, **kw):
    from repro_torch.serving import SarServingEngine, TriagePolicy
    params, cfg = narrow
    kw.setdefault("telemetry", False)
    eng = SarServingEngine(params, cfg, n_slots=8,
                           policy=TriagePolicy(**policy), device="cpu", **kw)
    for r in _stream(n):
        eng.submit(r)
    eng.run()
    return eng


def _records_match(a, b, n):
    ra = {r.rid: r for r in a.metrics.records}
    rb = {r.rid: r for r in b.metrics.records}
    assert set(ra) == set(rb) == set(range(n))
    for rid in ra:
        assert (ra[rid].verdict, ra[rid].prediction, ra[rid].n_samples) == \
            (rb[rid].verdict, rb[rid].prediction, rb[rid].n_samples), rid


def _same_export(treg_obj, jreg_obj):
    assert treg_obj.to_prometheus() == jreg_obj.to_prometheus()
    assert json.dumps(treg_obj.to_json()) == json.dumps(jreg_obj.to_json())


def _parse_prom(text):
    out = {}
    for line in text.splitlines():
        if not line or line.startswith("#"):
            continue
        key, val = line.rsplit(" ", 1)
        out[key] = float(val)
    return out


# ----------------------------------------------------------------------
# stage profiler primitives
# ----------------------------------------------------------------------
def test_stage_profiler_observe_and_snapshot_match_reference():
    obs = [("dispatch", 1e-4), ("dispatch", 2e-4), ("dispatch", float("nan")),
           ("dispatch", -1.0), ("dispatch", 1e9), ("triage_loop", 3e-6),
           ("rollout", 0.25), ("admission", 1e-7), ("retirement", 12.0)]
    p, j = StageProfiler(), JStageProfiler()
    for stage, dt in obs:
        p.observe(stage, dt)
        j.observe(stage, dt)
    snap = p.snapshot()
    assert json.dumps(snap) == json.dumps(j.snapshot())
    d = snap["dispatch"]
    assert d["count"] == 4 and d["overflow"] == 1 and sum(d["counts"]) == 3
    assert d["total_s"] == pytest.approx(1e9 + 3e-4)
    # serving stages first, in loop order; others after
    assert list(snap) == ["admission", "dispatch", "triage_loop",
                          "retirement", "rollout"]
    with p.span("featurize"):
        pass
    assert p.snapshot()["featurize"]["count"] == 1


def test_null_profiler_is_inert():
    assert NULL_PROFILER.enabled is False
    NULL_PROFILER.observe("x", 1.0)
    with NULL_PROFILER.span("x"):
        pass
    assert NULL_PROFILER.snapshot() == {}


def test_compile_counters_shape():
    from repro_torch.kernels.cim import launch_plan
    cc = prof.compile_counters()
    assert set(cc) == {"builder_builds", "nvcc_builds", "nvcc_seconds"}
    assert isinstance(cc["builder_builds"], dict)
    assert cc["builder_builds"]["cim_launch_plan"] == \
        launch_plan.cache_info().misses
    assert not any(k.startswith("xla") for k in cc)
    reg = treg.MetricsRegistry()
    treg.add_compile_counters(reg, cc, job="serving")
    text = reg.to_prometheus()
    assert "repro_nvcc_builds_total" in text and "xla" not in text


def test_trace_capture_none_is_noop_and_dir_writes_a_trace(tmp_path):
    with prof.trace_capture(None) as got:
        pass
    assert got.path is None
    with prof.trace_capture(str(tmp_path / "p")) as got:
        torch.ones(8).sum()
    doc = json.loads(open(got.path).read())
    assert doc["traceEvents"]
    assert got.path.startswith(str(tmp_path / "p"))


# ----------------------------------------------------------------------
# the engine's instruments
# ----------------------------------------------------------------------
def test_stage_profiler_verdict_identity_and_exposition(narrow):
    """Profiler on vs off: the same verdicts and host syncs, the stage
    histograms in the summary, stage and build metrics in the .prom."""
    n = 16
    on = _run(narrow, n, profiler=True)
    off = _run(narrow, n, profiler=False)
    _records_match(on, off, n)
    assert on.host_syncs == off.host_syncs
    assert "stage_profile" not in off.metrics.summary()
    s_on = on.metrics.summary()
    snap = s_on["stage_profile"]
    for stage in prof.SERVING_STAGES:
        assert snap[stage]["count"] > 0, stage
        assert sum(snap[stage]["counts"]) + snap[stage]["overflow"] == \
            snap[stage]["count"]
    # one dispatch, one pull and one retirement pass per host sync;
    # featurize runs inside admission
    for stage in ("dispatch", "triage_loop", "retirement"):
        assert snap[stage]["count"] == on.host_syncs
    assert snap["featurize"]["count"] == snap["admission"]["count"] == \
        on.admissions
    assert snap["featurize"]["total_s"] <= snap["admission"]["total_s"]
    text = treg.serving_registry(s_on).to_prometheus()
    assert "repro_stage_latency_seconds_bucket" in text
    assert 'stage="triage_loop"' in text
    assert "repro_nvcc_builds_total" in text


def test_engine_builders_built_once_across_instances(narrow):
    """Two engines of one config on a die: the first's cost records
    build the cached CIM launch plan once per trunk shape (a width no
    other test uses: cold keys), the second builds nothing.  (On the
    CPU no launcher is built; tests/test_torch_cuda.py covers those.)"""
    from repro_torch.hw import VariationSpec, sample_instances
    from repro_torch.models.sar_cnn import SarCnnConfig, init_sar_cnn
    from repro_torch.serving import SarServingEngine, TriagePolicy
    cfg = SarCnnConfig(channels=(5, 7, 9))
    params = init_sar_cnn(torch.Generator().manual_seed(11), cfg)
    die = sample_instances(11, 1, VariationSpec().scaled(2.0))[0]

    def run_one():
        before = prof.builder_builds()
        eng = SarServingEngine(params, cfg, n_slots=6, chip=die,
                               policy=TriagePolicy(**POLICY),
                               telemetry=False, device="cpu")
        for r in _stream(6):
            eng.submit(r)
        eng.run()
        recs = eng.compiled_cost_records()
        after = prof.builder_builds()
        return recs, {k: after.get(k, 0) - before.get(k, 0)
                      for k in set(after) | set(before)}

    recs, delta1 = run_one()
    assert delta1.get("cim_launch_plan") == 3          # one per layer
    assert all(v <= 3 for v in delta1.values()), delta1
    assert [r["name"] for r in recs] == [
        "decision_stats", "cim_mvm/trunk0", "cim_mvm/trunk1",
        "cim_mvm/trunk2"]
    _, delta2 = run_one()
    assert all(v == 0 for v in delta2.values()), delta2


def test_compiled_cost_records_from_engine(narrow):
    """The engine's cost records at its live shapes come from the same
    count as chip_smoke.py's bounds (kernels/bounds).  On the CPU the
    decision wrapper takes its plain version, so the record counts no
    launch.  The engine's launches fold into its statistics (the
    kernel's accumulate epilogue), and the record counts that."""
    eng = _run(narrow, 8)
    (rec,) = eng.compiled_cost_records()
    b, n = eng.n_slots, 2
    want = bounds.decision_work(b, n, 4, b, sel_per_slot=True,
                                idx_per_slot=True, accumulate=True)
    assert rec["kernel"] == "decision_stats"
    assert eng.max_rounds == 5 and eng.rounds_launched > 0
    assert rec["launches_per_dispatch"] == 0           # a CPU engine
    assert (rec["hbm_bytes"], rec["flops"], rec["hash3_evals"],
            rec["bound_ms"]) == (want["bound_bytes"], want["bound_ops"],
                                 want["hash3_evals"], want["bound_ms"])
    assert rec["plan"]["variant"] == "small_n"
    assert "max_memory_allocated" not in rec
    reg = treg.MetricsRegistry()
    treg.add_compiled_costs(reg, [rec], job="serving")
    parsed = _parse_prom(reg.to_prometheus())
    assert parsed['repro_compiled_launches_per_dispatch'
                  '{job="serving",fn="decision_stats"}'] == 0
    assert parsed['repro_compiled_hbm_bytes'
                  '{job="serving",fn="decision_stats"}'] == \
        want["bound_bytes"]
    with pytest.raises(RuntimeError, match="live pool"):
        from repro_torch.serving import SarServingEngine
        SarServingEngine(*narrow, device="cpu").compiled_cost_records()


def test_tracer_chrome_export_and_verdict_identity(narrow, tmp_path):
    n = 16
    tracer = Tracer("test-serving")
    eng_t = _run(narrow, n, telemetry=True, tracer=tracer)
    eng_0 = _run(narrow, n, telemetry=True, tracer=None)
    _records_match(eng_t, eng_0, n)
    assert eng_t.host_syncs == eng_0.host_syncs
    assert eng_0.tracer is NULL_TRACER and not NULL_TRACER.enabled
    doc = tracer.to_chrome()
    spans = [e for e in doc["traceEvents"] if e.get("ph") == "X"]
    req_spans = [e for e in spans if e["name"].startswith("req ")]
    assert len(req_spans) == n
    assert sum(e["name"] == "sar_rounds" for e in spans) == eng_t.host_syncs
    assert sum(e["name"] == "featurize" for e in spans) == eng_t.admissions
    for e in spans:
        assert e["dur"] >= 0.0 and e["ts"] >= 0.0
    for e in req_spans:
        assert e["args"]["verdict"] in (0, 1, 2)
        assert e["args"]["n_samples"] >= POLICY["r_min"]
    threads = {e["tid"] for e in doc["traceEvents"]
               if e.get("name") == "thread_name"}
    assert threads == set(range(1, 9))
    path = tmp_path / "trace.json"
    tracer.export(str(path))
    assert json.loads(path.read_text())["traceEvents"]


def test_request_record_clock_fallback_and_stamps():
    from repro_torch.serving.metrics import RequestRecord
    r = RequestRecord(rid=0, verdict=0, n_samples=4, n_decisions=1,
                      arrival_s=10.0, admit_s=11.0, done_s=12.0)
    assert r.queue_latency_s == 1.0 and r.latency_s == 2.0
    assert math.isnan(r.dispatch_wait_s) and math.isnan(r.verdict_latency_s)
    r2 = RequestRecord(rid=0, verdict=0, n_samples=4, n_decisions=1,
                       arrival_s=99.0, admit_s=11.0, done_s=12.0,
                       arrival_pc=10.5, first_dispatch_s=11.25,
                       verdict_s=11.75)
    assert r2.queue_latency_s == 0.5 and r2.latency_s == 1.5
    assert r2.dispatch_wait_s == 0.25 and r2.verdict_latency_s == 1.25


# ----------------------------------------------------------------------
# exporters: byte for byte against the reference
# ----------------------------------------------------------------------
def test_prometheus_primitives_match_reference(tmp_path):
    """Label escaping, non-finite histogram counts, empty histograms,
    overflow and an explicit sum, counters and gauges: the same calls
    give the same text and JSON, files included."""
    regs = []
    for mod in (treg, jreg):
        reg = mod.MetricsRegistry()
        reg.counter("decisions_total", 3, path='a\\b"c\nd')
        reg.counter("a_total", 7, job="x")
        reg.gauge("g", 0.5)
        reg.gauge("nan_gauge", float("nan"))
        reg.gauge("inf_gauge", float("inf"))
        reg.histogram("lat", [float("nan"), 2, float("inf")],
                      [0.0, 1.0, 2.0, 3.0])
        reg.histogram("empty", [], [0.0, 1.0])
        reg.histogram("over", [1, 1], [0.0, 0.5, 1.0], overflow=3, sum=42.0)
        reg.histogram("confidence", [5, 10, 9], [0.0, 0.5, 0.8, 1.0])
        regs.append(reg)
    _same_export(*regs)
    text = regs[0].to_prometheus()
    parsed = _parse_prom(text)
    assert parsed['repro_decisions_total{path="a\\\\b\\"c\\nd"}'] == 3
    assert parsed['repro_lat_bucket{le="1.0"}'] == 0
    assert parsed['repro_lat_bucket{le="+Inf"}'] == 2
    assert parsed['repro_empty_bucket{le="+Inf"}'] == 0
    assert parsed['repro_over_bucket{le="+Inf"}'] == 5
    assert parsed["repro_over_sum"] == 42.0
    assert 'repro_confidence_bucket{le="0.8"} 15' in text
    prom, js = regs[0].write(str(tmp_path / "sub" / "m"))
    jprom, jjs = regs[1].write(str(tmp_path / "ref"))
    assert open(prom).read() == open(jprom).read() == text
    assert open(js).read() == open(jjs).read()
    hists = ({"counts": [0, 0], "edges": [0.1, 1.0, 10.0], "overflow": 5},
             {"counts": [4, 0], "edges": [0.1, 1.0, 10.0]},
             {"counts": [1, 3, 0], "edges": [-1.0, 0.0, 2.0, 4.0]})
    for h in hists:
        for q in (0.0, 0.3, 0.99, 1.5):
            assert treg.quantile(h, q) == jreg.quantile(h, q), (h, q)


@pytest.fixture(scope="module")
def served(narrow):
    """A port engine's summary with every section, the drift status of
    its telemetry and an alert stream: the exporters' inputs."""
    from repro_torch.obs import AlertBus, SloTracker, drift
    tracker = SloTracker(slos=("0.5:p99", "1e-9:p99"))
    eng = _run(narrow, 16, telemetry=True, slo=tracker)
    summary = eng.drain()
    summary["slo"] = tracker.snapshot()
    ref = drift.reference_for(narrow[1], eng.hcfg, calibrated=False,
                              probe_cells=eng.tcfg.probe_cells,
                              device="cpu")
    status = drift.drift_status(summary["telemetry"], ref).to_dict()
    bus = AlertBus(clock=lambda: 1234.5)
    bus.observe_slo(summary["slo"], source="test")
    bus.observe_drift({"drifted": True, "advisory": "recalibrate",
                       "z_mean": 7.5, "z_std": 2.0, "n": 64},
                      source="test")
    return {"summary": summary, "drift": status, "alerts": bus.to_json(),
            "costs": eng.compiled_cost_records()}


def test_serving_registry_matches_reference(served):
    s = served["summary"]
    scalars = {k: v for k, v in s.items()
               if isinstance(v, (int, float)) and not isinstance(v, bool)}
    ref_cc = {"builder_builds": {"sar_round": 1, "cim_launch_plan": 3},
              "xla_compile_events": 10, "xla_compile_seconds": 0.5}
    ref_costs = [{"name": "sar_round", "flops": 1e6, "hbm_bytes": 2e6,
                  "peak_live_bytes": 65536, "compile_s": 0.1,
                  "backend": "cpu"}]
    kw = dict(telemetry=s["telemetry"], drift=served["drift"],
              profile=s["stage_profile"], compile_counters=ref_cc,
              compiled_costs=ref_costs, slo=s["slo"],
              alerts=served["alerts"], arch="sar_cnn")
    _same_export(treg.serving_registry(scalars, **kw),
                 jreg.serving_registry(scalars, **kw))
    # the summary's own sections, picked up when not passed (its
    # compile counters in the reference's shape)
    s_ref = dict(s, compile_counters=ref_cc)
    _same_export(treg.serving_registry(s_ref), jreg.serving_registry(s_ref))
    text = treg.serving_registry(scalars, **kw).to_prometheus()
    for key in ("repro_slo_time_to_verdict_seconds_bucket",
                "repro_stage_latency_seconds_bucket", 'slo="p99<=0.5s"',
                "repro_telemetry_decisions_total", "repro_grng_drift_z_mean",
                'kind="slo_burn"', "repro_xla_compile_events_total"):
        assert key in text, key
    # the port's own counters and cost records: nvcc lines, no XLA line
    own = treg.serving_registry(
        scalars, compile_counters=prof.compile_counters(),
        compiled_costs=served["costs"]).to_prometheus()
    assert "repro_nvcc_builds_total" in own and "xla" not in own
    assert 'fn="decision_stats"' in own


def test_mission_registry_matches_reference(served):
    summary = {"decisions": 140, "rescued": 7, "coverage": 0.5,
               "mode": "bayes_adaptive", "ok": True}
    telem = {"ideal": {"telemetry": served["summary"]["telemetry"],
                       "drift": served["drift"]},
             "die11": {"telemetry": served["summary"]["telemetry"],
                       "drift": None}}
    kw = dict(telemetry=telem, alerts=served["alerts"], policy="adaptive")
    _same_export(treg.mission_registry(summary, **kw),
                 jreg.mission_registry(summary, **kw))


# ----------------------------------------------------------------------
# mission_trace on bridged mission logs
# ----------------------------------------------------------------------
def test_mission_trace_matches_reference_on_bridged_logs():
    """The port's episode (6×6, 3 victims, 2 drones, 8 steps) over the
    reference's worlds (bridged; the port renders them): the trace of
    its logs equals the reference's ``mission_trace`` of the same logs,
    event for event."""
    from repro.mission import world as jworld
    from repro_torch.bridge import worlds_from_jax
    from repro_torch.mission import policy as tpolicy
    from repro_torch.mission import rollout as troll
    from repro_torch.mission import uav as tuav
    from repro_torch.mission import world as tworld
    from repro_torch.models import sar_cnn as tsar
    steps = 8
    jw = jworld.WorldConfig(grid=6, n_victims=3, seed=2)
    tw = tworld.WorldConfig(grid=6, n_victims=3, seed=2)
    tu = tuav.UavConfig(n_drones=2, battery_J=120e-6)
    bridged = worlds_from_jax(jax.device_get(jworld.stack_worlds(jw, 1)))
    cfg = tsar.SarCnnConfig()
    params = tsar.init_sar_cnn(torch.Generator().manual_seed(3), cfg)
    pol = tpolicy.MissionPolicy()
    head, hcfg = troll._prepare_group_head(params, cfg, pol.triage, None,
                                           True)
    fn = troll._episode_fn(tw, tu, pol, cfg, hcfg, None,
                           troll.sar_mission_cost(cfg), True, steps)
    out = fn(params, head, torch.zeros(2), bridged,
             tuav.init_fleet(tu, 6, 1, device="cpu"),
             {k: torch.as_tensor(v)
              for k, v in troll.init_maps(tw, 1, 2).items()},
             tuav.fleet_bindings(tu, 6, 1, device="cpu"))
    logs = troll._pull(dict(zip(("fleet", "maps", "logs"), out)))["logs"]
    assert logs["active"].any() and logs["verdict"].shape == (steps, 2)
    got = mission_trace(logs)
    assert json.dumps(got) == json.dumps(jtrace.mission_trace(logs))
    spans = [e for e in got["traceEvents"] if e["ph"] == "X"]
    assert len(spans) == int(logs["active"].sum())
    assert {e["tid"] for e in spans} <= {1, 2}


# ----------------------------------------------------------------------
# core/energy: the paper's analytic numbers
# ----------------------------------------------------------------------
def _layers(mod):
    L = mod.LayerShape
    return [L(9, 16), L(144, 32), L(288, 64), L(64, 2, bayesian=True),
            L(1024, 4096, bayesian=True), L(70, 130)]


@pytest.mark.parametrize("r,batch", [(1, 1), (20, 1), (7, 64), (100, 3)])
def test_energy_functions_bit_equal(r, batch):
    """Exact equality (==): the same Python float arithmetic on the same
    constants."""
    for name in ("grng_throughput_gsas", "grng_energy_improvement",
                 "writefree_lifetime_hours", "tile_efficiency_tops_w",
                 "efficiency_density"):
        assert getattr(tenergy, name)() == getattr(jenergy, name)(), name
    for bits in (4, 6, 8):
        assert tenergy.adc_energy_per_mvm(bits, 64 + r) == \
            jenergy.adc_energy_per_mvm(bits, 64 + r)
    assert tenergy.adc_energy_per_mvm() == jenergy.adc_energy_per_mvm()
    assert tenergy.offset_compensation_cost(r) == \
        jenergy.offset_compensation_cost(r)
    for rate in (1e3, 1e7 * r):
        assert tenergy.endurance_hours(rate) == jenergy.endurance_hours(rate)
        assert tenergy.endurance_hours(rate, 3e4) == \
            jenergy.endurance_hours(rate, 3e4)
    assert tenergy.inference_energy(_layers(tenergy), r, batch) == \
        jenergy.inference_energy(_layers(jenergy), r, batch)
    assert tenergy.digital_baseline_energy(_layers(tenergy), r, batch) == \
        jenergy.digital_baseline_energy(_layers(jenergy), r, batch)
    for kw in (dict(n_det_tiles=5, n_bayes_tiles=2),
               dict(n_det_tiles=7, n_bayes_tiles=3, r_samples=r + 0.25,
                    batch=batch, n_passes=2, n_bayes_passes=2,
                    physical_tiles=12, utilization=0.61, r_latency=4)):
        assert tenergy.grid_inference_energy(**kw) == \
            jenergy.grid_inference_energy(**kw)
    for name in dir(jenergy):
        if name.isupper():
            assert getattr(tenergy, name) == getattr(jenergy, name), name


def test_request_energies_sum_to_grid_inference_energy():
    """A served batch: the per-request energies' total equals the
    placement-level ``grid_inference_energy`` of the same placed blocks
    at the batch's mean sample spend (relative 1e-9)."""
    from repro_torch.hw import compile_network
    from repro_torch.launch.serve import sar_layer_shapes, serve_sar
    from repro_torch.models.sar_cnn import SarCnnConfig
    cfg = SarCnnConfig(**NARROW)
    out = serve_sar(n_requests=10, n_slots=4, cfg=cfg, telemetry=False,
                    device="cpu")
    layers = sar_layer_shapes(cfg)
    program = compile_network(layers)
    shapes = dict(program.layers)
    counts = program.layer_block_counts()
    det = sum(c for n, c in counts.items() if not shapes[n].bayesian)
    bayes = sum(c for n, c in counts.items() if shapes[n].bayesian)
    r_bar = out["mean_samples_per_decision"]
    grid = tenergy.grid_inference_energy(
        n_det_tiles=det, n_bayes_tiles=bayes, r_samples=r_bar,
        batch=out["decisions"])
    assert out["energy_total_J"] == pytest.approx(grid["energy_J"],
                                                  rel=1e-9)
    per_dec = tenergy.grid_inference_energy(
        n_det_tiles=det, n_bayes_tiles=bayes, r_samples=r_bar)
    assert out["energy_per_decision_pJ"] == pytest.approx(
        per_dec["energy_J"] * 1e12, rel=1e-9)


# ----------------------------------------------------------------------
# kernels/bounds: one count of each kernel's work
# ----------------------------------------------------------------------
def test_bounds_pinned_at_perf_shapes():
    """PERF.md §6's Bound column: decision at B=32 N=2, half the slots
    masked (R = 4 and 20), CIM at the three trunk shapes of 32 slots, ε
    at Fig. 9's block (ideal and the gate die), kernel_bench's
    512×2048×20 and the training draw, the heads at the UQ path's shape
    and kernel_bench's (R = 20).  (bytes, operations, hash3) exactly,
    the bound to the last bit of its formula."""
    from repro_torch.hw import VariationSpec, sample_instances

    def key(w):
        return (w["bound_bytes"], w["bound_ops"], w["hash3_evals"],
                w["bound_by"])

    def dec(r):
        return bounds.decision_work(32, 2, r, 16, sel_per_slot=True)

    assert key(dec(4)) == (7200, 5632, 0, "bytes")
    assert dec(4)["bound_ms"] == 7200 / bounds.HBM_BYTES_PER_S * 1e3
    assert key(dec(20)) == (23584, 28160, 0, "bytes")
    assert [key(bounds.cim_work(*s)) for s in (
        (7200, 64, 16), (1568, 192, 32), (288, 320, 64))] == [
        (2308228, 15667200, 0, "bytes"), (1429764, 20471808, 0, "bytes"),
        (524804, 12533760, 0, "operations")]
    ideal = GRNGConfig()
    die = sample_instances(11, 1, VariationSpec().scaled(2.0))[0].grng(ideal)
    assert key(bounds.grng_bound(256, 256, 8, ideal)) == \
        (2097664, 25165824, 1048576, "bytes")
    assert key(bounds.grng_bound(256, 256, 8, die)) == \
        (2097664, 28311552, 1572864, "bytes")
    assert key(bounds.grng_bound(512, 2048, 20, ideal)) == \
        (83887360, 830472192, 16777216, "bytes")
    assert key(bounds.grng_bound(64, 2, 1, ideal)) == \
        (576, 18688, 2048, "operations")
    assert key(bounds.head_bound("rank16", 64, 64, 2, 20, ideal)) == \
        (28928, 403456, 2048, "bytes")
    assert key(bounds.head_bound("rank16", 8, 512, 2048, 20, ideal)) == \
        (9716992, 448004096, 16777216, "operations")
    assert key(bounds.head_bound("paper", 8, 512, 2048, 20, ideal)) == \
        (9716992, 1220542464, 16777216, "operations")
