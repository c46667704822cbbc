"""Slot sharding and the serving fleet of the port against the JAX
reference, on the CPU (the card's checks are in tests/test_torch_cuda.py
and chip_smoke.py's ``fleet`` phase).

  * ``kernels/decision.decision_stats_sharded`` with CPU devices × 2 and
    × 4 against the unsharded plain version, bit for bit (read noise,
    masks, explicit and default global ``rows``, shared and per-slot
    selections, N ≤ 32 and N > 32); ``ops.decision_update(shard=...)``
    and ``token_decision(shard=...)`` bit for bit the unsharded calls;
    ``slot_runs``' grouping of device lists; ``fold_runs`` over two
    explicit CPU runs bit for bit one run (every CPU device is 'cpu', so
    the public grouping gives one run here); the accumulating call
    (``out=``) bit for bit ``stats + delta`` with masked rows untouched,
    R > 64 cut into pieces; ``row0`` equal to explicit ``rows``; a pool
    split into two runs by hand bit for bit the unsharded pool;
  * one subprocess with 2 fake JAX host devices runs the reference's
    ``decision_stats_sharded`` (interpret mode) and its gang fleet; the
    port matches the kernel within C6's 1e-5 and the gang's routes,
    verdicts and per-pool telemetry, an idle pool's dispatch counter
    included;
  * the slot-sharded pool (``slot_devices``) against the reference's
    unsharded engine on bridged params (the side of
    ``tests/test_spmd.py:105-141``), and against the port's unsharded
    pool on a die bit for bit;
  * ``SarServingFleet`` gang and sequential against the reference's
    ``SarServingFleet(gang=False)``: routes, verdicts, routed_per_pool,
    backlog_peak; the gang with fewer host syncs; the counterparts of
    ``tests/test_fleet.py`` and of ``tests/test_slo.py``'s fleet tests;
  * ``run_open_loop`` on a fleet, ``serve_sar_fleet``, the CLI's
    ``--pools``, and the sharded mission equal to the unsharded one.

Widths: the narrow SAR trunk (channels 4, 8, 8) where the reference
runs in process; the reference's jitted rounds compile once for the
whole module (every engine has 4 slots and the default telemetry).
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.launch.serve import make_sar_stream as j_stream
from repro.models.sar_cnn import SarCnnConfig as JCfg
from repro.models.sar_cnn import init_sar_cnn as j_init
from repro_torch.bridge import params_from_jax
from repro_torch.core.clt_grng import GRNGConfig
from repro_torch.kernels import decision as tdec
from repro_torch.kernels import ops as tops
from repro_torch.models.sar_cnn import SarCnnConfig
from repro_torch.serving import (Request, SarServingEngine,
                                 SarServingFleet, TriagePolicy)
from repro_torch.serving import adaptive as tad

ROOT = Path(__file__).resolve().parents[1]
NARROW = dict(channels=(4, 8, 8))
POLICY = dict(conf_threshold=0.55, mi_threshold=0.05, r_min=4, r_max=20)
STATS = ("sum_p", "sum_psq", "sum_ent", "sum_entsq")
KERNEL_CASES = (          # (B, N, R, read_sigma, per-slot sel, rows0)
    (8, 2, 4, 0.0, False, None), (8, 2, 20, 0.4, True, None),
    (4, 40, 6, 0.4, False, 1000), (8, 300, 3, 0.0, True, None))

# The reference side of the subprocess: 2 fake host devices.  It reads
# the kernel cases from argv[1] and writes its results to argv[2].
_SPMD = r"""
import json, sys
import jax, jax.numpy as jnp, numpy as np
from repro.core import clt_grng as g
from repro.kernels.decision_kernel import decision_stats_sharded
from repro.launch.mesh import make_mesh_compat
from repro.launch.serve import make_sar_stream
from repro.models.sar_cnn import SarCnnConfig, init_sar_cnn
from repro.serving import TriagePolicy
from repro.serving.fleet import SarServingFleet

cases = np.load(sys.argv[1])
mesh = make_mesh_compat((2,), ("slot",))
out = {}
for i in range(int(cases["n"])):
    c = {k[len(f"c{i}_"):]: cases[k] for k in cases.files
         if k.startswith(f"c{i}_")}
    cfg = g.GRNGConfig(read_sigma=float(c["read_sigma"]))
    got = decision_stats_sharded(
        jnp.asarray(c["y_mu"]), jnp.asarray(c["x_sigma"]),
        jnp.asarray(c["m"]), jnp.asarray(c["sel"]), cfg, mesh=mesh,
        axis="slot", x_sigsq=jnp.asarray(c["x_sigsq"]),
        sample_idx=jnp.asarray(c["idx"].astype(np.uint32)),
        mask=jnp.asarray(c["mask"]),
        rows=(jnp.asarray(c["rows"].astype(np.uint32))
              if "rows" in c else None), interpret=True)
    for k, v in got.items():
        out[f"c{i}_{k}"] = np.asarray(v)
cfg = SarCnnConfig(channels=(4, 8, 8))
params = init_sar_cnn(jax.random.PRNGKey(5), cfg)
fleet = SarServingFleet(params, cfg, n_pools=2, slots_per_pool=4,
                        policy=TriagePolicy(**json.loads(sys.argv[3])),
                        queue_cap=4, gang=True)
for r in make_sar_stream(9, corrupt_frac=0.25):
    fleet.submit(r)
summ = fleet.run()
assert summ["gang"] is True
recs = {r.rid: [int(r.prediction), int(r.verdict), int(r.n_samples),
                float(r.confidence), float(r.mutual_information)]
        for e in fleet.engines for r in e.metrics.records}
tel = [{k: int(e.metrics.telemetry[k]) for k in
        ("rounds", "dispatches", "samples", "decisions")}
       for e in fleet.engines]
out["gang"] = np.frombuffer(json.dumps({
    "routes": {str(k): v for k, v in fleet.routes.items()},
    "records": {str(k): v for k, v in recs.items()}, "telemetry": tel,
    "trips": [t["trips"] for t in summ["tick_log"]],
    "host_syncs": summ["host_syncs"],
    "routed_per_pool": summ["routed_per_pool"]}).encode(), np.uint8)
np.savez(sys.argv[2], **out)
print("OK")
"""


def _kernel_case(b, n, r, read_sigma, per_slot, rows0, seed):
    rng = np.random.default_rng(seed)
    f32 = np.float32
    sel_shape = (r, b, 16) if per_slot else (r, 16)
    c = {"y_mu": rng.standard_normal((b, n)).astype(f32),
         "x_sigma": np.abs(rng.standard_normal((b, n))).astype(f32) * 0.3,
         "m": (rng.standard_normal((b, n, 16)) * 0.2).astype(f32),
         "sel": rng.integers(0, 2, sel_shape).astype(f32),
         "x_sigsq": np.abs(rng.standard_normal((b, n))).astype(f32) * 0.1,
         "idx": rng.integers(0, 2**32, (r, b) if per_slot else (r,),
                             dtype=np.int64),
         "mask": np.arange(b) % 2 == 0,
         "read_sigma": np.float32(read_sigma)}
    if rows0 is not None:
        c["rows"] = np.arange(rows0, rows0 + b, dtype=np.int64)
    return c


@pytest.fixture(scope="module")
def spmd(tmp_path_factory):
    """The reference's sharded kernel and gang fleet, in ONE subprocess
    with 2 fake host devices, started first and read last (its
    compiles overlap the in-process tests)."""
    d = tmp_path_factory.mktemp("spmd")
    cases = [_kernel_case(*spec, seed=i)
             for i, spec in enumerate(KERNEL_CASES)]
    flat = {"n": np.int64(len(cases))}
    for i, c in enumerate(cases):
        flat.update({f"c{i}_{k}": v for k, v in c.items()})
    np.savez(d / "cases.npz", **flat)
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=2",
               PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.Popen(
        [sys.executable, "-c", _SPMD, str(d / "cases.npz"),
         str(d / "out.npz"), json.dumps(POLICY)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    result = {}

    def read():
        if not result:
            out, err = proc.communicate(timeout=600)
            assert proc.returncode == 0, err[-3000:]
            got = dict(np.load(d / "out.npz"))
            result["gang"] = json.loads(got.pop("gang").tobytes())
            result["kernel"] = got
            result["cases"] = cases
        return result

    yield read
    if proc.poll() is None:
        proc.kill()
        proc.communicate()


@pytest.fixture(scope="module", autouse=True)
def _start_spmd(spmd):
    """Start the subprocess before the module's first test."""
    return spmd


@pytest.fixture(scope="module")
def narrow():
    jcfg = JCfg(**NARROW)
    jp = j_init(jax.random.PRNGKey(5), jcfg)
    return {"jcfg": jcfg, "jparams": jp, "cfg": SarCnnConfig(**NARROW),
            "params": params_from_jax(jax.device_get(jp))}


def _torch_case(c):
    t = {k: torch.as_tensor(np.asarray(v)) for k, v in c.items()
         if k != "read_sigma"}
    cfg = GRNGConfig(read_sigma=float(c["read_sigma"]))
    kw = dict(x_sigsq=t["x_sigsq"], sample_idx=t["idx"], mask=t["mask"],
              rows=t.get("rows"))
    return (t["y_mu"], t["x_sigma"], t["m"], t["sel"], cfg), kw


def _port_reqs(n, **kw):
    return [Request(rid=r.rid, payload=np.asarray(r.payload),
                    meta=dict(r.meta))
            for r in j_stream(n, corrupt_frac=0.25, **kw)]


def _records(engines):
    return {r.rid: (int(r.prediction), int(r.verdict), int(r.n_samples),
                    float(r.confidence), float(r.mutual_information))
            for e in engines for r in e.metrics.records}


def _fleet(narrow, **kw):
    kw.setdefault("policy", TriagePolicy(**POLICY))
    kw.setdefault("devices", ["cpu"] * kw.get("n_pools", 2))
    return SarServingFleet(narrow["params"], narrow["cfg"], **kw)


def _served(target, reqs):
    for r in reqs:
        target.submit(r)
    return target.run()


# ----------------------------------------------------------------------
# the sharded kernel, port against port
# ----------------------------------------------------------------------
@pytest.mark.parametrize("spec", KERNEL_CASES + ((8, 2, 4, 0.4, False,
                                                   None),))
@pytest.mark.parametrize("shards", [2, 4])
def test_sharded_kernel_bit_for_bit_the_unsharded(spec, shards):
    args, kw = _torch_case(_kernel_case(*spec, seed=7))
    want = tdec.decision_stats_plain(*args, **kw)
    got = tdec.decision_stats_sharded(*args, devices=["cpu"] * shards, **kw)
    plain = tdec.decision_stats_sharded_plain(*args, shards=shards, **kw)
    for key in STATS:
        assert torch.equal(got[key], want[key]), key
        assert torch.equal(plain[key], want[key]), key
    assert (got["sum_p"][~kw["mask"]] == 0).all()


def test_sharded_kernel_keys_read_noise_on_global_rows():
    """Each shard hashes with its global slot ids: the default rows are
    arange(B) before the split, so local ids would draw other noise."""
    args, kw = _torch_case(_kernel_case(8, 3, 4, 0.4, False, None, seed=2))
    want = tdec.decision_stats_plain(*args, **kw)
    got = tdec.decision_stats_sharded(*args, devices=["cpu"] * 2, **kw)
    assert all(torch.equal(got[k], want[k]) for k in STATS)
    local = torch.cat([tdec.decision_stats_plain(
        *(a[4 * i:4 * i + 4] for a in args[:3]), args[3], args[4],
        x_sigsq=kw["x_sigsq"][4 * i:4 * i + 4], sample_idx=kw["sample_idx"],
        mask=kw["mask"][4 * i:4 * i + 4])["sum_p"] for i in range(2)])
    assert not torch.equal(local, want["sum_p"])


def test_sharded_kernel_refuses_an_uneven_split_and_counts_no_cpu_launch():
    args, kw = _torch_case(_kernel_case(6, 2, 4, 0.0, False, None, seed=1))
    before = tdec.decision_stats_sharded.launches
    tdec.decision_stats_sharded(*args, devices=["cpu"] * 3, **kw)
    assert tdec.decision_stats_sharded.launches == before
    with pytest.raises(ValueError, match="not divisible"):
        tdec.decision_stats_sharded(*args, devices=["cpu"] * 4, **kw)


@pytest.mark.parametrize("r", [6, 100])
def test_decision_update_shard_is_the_unsharded_update(r):
    """``ops.decision_update(shard=...)``, the R > 64 cut inside each
    shard included, equals the unsharded update bit for bit."""
    b, n = 8, 3
    args, kw = _torch_case(_kernel_case(b, n, r, 0.4, True, None, seed=5))
    abasis = {"y_mu": args[0], "x_sigma": args[1], "m": args[2],
              "x_sigsq": kw["x_sigsq"]}
    want = tops.decision_update(tad.init_stats(b, n), abasis, args[3],
                                args[4], sample_idx=kw["sample_idx"],
                                mask=kw["mask"])
    got = tops.decision_update(tad.init_stats(b, n), abasis, args[3],
                               args[4], sample_idx=kw["sample_idx"],
                               mask=kw["mask"], shard=["cpu"] * 4)
    for key in want:
        assert torch.equal(got[key], want[key]), key


def test_token_decision_shard_is_the_unsharded_decision():
    from repro_torch.core.sampling import BayesHeadConfig
    from repro_torch.obs.telemetry import TelemetryConfig, init_telemetry
    from repro_torch.serving.engine import token_decision
    b, n = 8, 2
    args, kw = _torch_case(_kernel_case(b, n, 4, 0.4, False, None, seed=9))
    abasis = {"y_mu": args[0] * 0.1, "x_sigma": args[1], "m": args[2],
              "x_sigsq": kw["x_sigsq"]}
    pol = TriagePolicy(**POLICY)
    hcfg = BayesHeadConfig(mode="rank16", grng=args[4],
                           compute_dtype=torch.float32)
    tcfg = TelemetryConfig()
    outs = []
    for shard in (None, ["cpu"] * 2, ["cpu"] * 3):   # 3: unsharded route
        telem = init_telemetry(tcfg, pol.r_max, "cpu")
        outs.append(token_decision(
            abasis, torch.arange(b, dtype=torch.int64) * 20, kw["mask"],
            hcfg=hcfg, policy=pol, adaptive_mode=True,
            schedule=tad.escalation_schedule(pol), telem=telem, tcfg=tcfg,
            shard=shard))
    for got in outs[1:]:
        assert torch.equal(got[0], outs[0][0]) and torch.equal(got[2],
                                                               outs[0][2])
        for key in outs[0][1]:
            assert torch.equal(got[1][key], outs[0][1][key]), key
        for key in outs[0][3]:
            assert torch.equal(got[3][key], outs[0][3][key]), key


@pytest.mark.parametrize("devices,want", [
    (["cpu"] * 4, [("cpu", 0, 8)]),
    (["cpu", "meta", "meta", "cpu"],
     [("cpu", 0, 2), ("meta", 2, 6), ("cpu", 6, 8)]),
    (["meta", "cpu"], [("meta", 0, 4), ("cpu", 4, 8)])])
def test_slot_runs_group_consecutive_shards_on_one_device(devices, want):
    runs = tdec.slot_runs(devices, 8)
    assert [(r.device.type, r.start, r.stop) for r in runs] == want
    with pytest.raises(ValueError, match="not divisible"):
        tdec.slot_runs(devices, 6 if len(devices) == 4 else 7)


def _two_runs(b):
    return [tdec.SlotRun(torch.device("cpu"), 0, b // 2),
            tdec.SlotRun(torch.device("cpu"), b // 2, b)]


def _stats0(b, n, seed):
    g = torch.Generator().manual_seed(seed)
    return {"sum_p": torch.rand((b, n), generator=g) * 3,
            "sum_psq": torch.rand((b, n), generator=g),
            "sum_ent": torch.rand((b,), generator=g) * 5,
            "sum_entsq": torch.rand((b,), generator=g) * 9,
            "n": torch.full((b,), 8, dtype=torch.int32)}


@pytest.mark.parametrize("n,r", [(3, 6), (40, 6), (3, 100)])
def test_accumulating_call_is_stats_plus_delta(n, r):
    """``decision_stats(out=stats)`` (plain here; the card's accumulate
    epilogue in tests/test_torch_cuda.py) adds the deltas into the
    running sums on the active rows, bit for bit ``stats + delta``;
    masked rows keep their bits (NaN included).  Over R > 64,
    ``ops.decision_update`` folds the pieces in sample order, each
    ``stats + delta``, and over two runs the same bits."""
    b = 8
    args, kw = _torch_case(_kernel_case(b, n, r, 0.4, True, None, seed=4))
    mask = kw["mask"]
    stats0 = _stats0(b, n, seed=1)
    stats0["sum_p"][1, 0] = float("nan")               # a masked row
    want = {k: v.clone() for k, v in stats0.items()}
    for r0 in range(0, r, tdec.MAX_SAMPLES):
        piece = slice(r0, min(r, r0 + tdec.MAX_SAMPLES))
        delta = tdec.decision_stats(
            *args[:3], args[3][piece], args[4], kw["x_sigsq"],
            kw["sample_idx"][piece], mask)
        for key in STATS:
            keep = mask if want[key].ndim == 1 else mask[:, None]
            want[key] = torch.where(keep, want[key] + delta[key], want[key])
    abasis = {"y_mu": args[0], "x_sigma": args[1], "m": args[2],
              "x_sigsq": kw["x_sigsq"]}
    for shard in (None, _two_runs(b)):
        got = {k: v.clone() for k, v in stats0.items()}
        if shard is None:
            tops.decision_update(got, abasis, args[3], args[4],
                                 sample_idx=kw["sample_idx"], mask=mask)
        else:
            for r0 in range(0, r, tdec.MAX_SAMPLES):
                piece = slice(r0, min(r, r0 + tdec.MAX_SAMPLES))
                tdec.fold_runs(shard, *args[:3], args[3][piece], args[4],
                               x_sigsq=kw["x_sigsq"],
                               sample_idx=kw["sample_idx"][piece],
                               mask=mask, out=got)
        for key in STATS:
            assert torch.equal(got[key][mask], want[key][mask]), key
            assert torch.equal(got[key][~mask].view(torch.int32),
                               stats0[key][~mask].view(torch.int32)), key
        if shard is None:
            assert torch.equal(got["n"], stats0["n"] + r * mask)


@pytest.mark.parametrize("n", [3, 40])
def test_row0_is_explicit_global_rows(n):
    """Read noise keyed on ``row0 + b`` equals ``rows = arange(row0,
    row0 + B)``, in the plain version and the tiled algorithm's."""
    args, kw = _torch_case(_kernel_case(6, n, 5, 0.4, False, None, seed=6))
    rows = torch.arange(1000, 1006, dtype=torch.int64)
    kw.pop("rows")
    want = tdec.decision_stats_plain(*args, **kw, rows=rows)
    got = tdec.decision_stats_plain(*args, **kw, row0=1000)
    local = tdec.decision_stats_plain(*args, **kw)
    for key in STATS:
        assert torch.equal(got[key], want[key]), key
    assert not torch.equal(local["sum_p"], want["sum_p"])
    tiled = [tdec.decision_stats_tiled_plain(*args, **kw, tile=16, **extra)
             for extra in ({"rows": rows}, {"row0": 1000})]
    assert all(torch.equal(tiled[0][k], tiled[1][k]) for k in STATS)


# ----------------------------------------------------------------------
# the trace's fleet events, format for format
# ----------------------------------------------------------------------
def test_trace_fleet_events_match_reference():
    from repro.obs import trace as jtrace
    from repro_torch.obs import trace as ttrace
    docs = []
    for mod in (jtrace, ttrace):
        tr = mod.Tracer("fleet")
        tr.name_process(0, "router")
        tr.name_process(2, "pool 1")
        tr.name_thread(3, "slot 2", pid=2)
        tr.complete("fleet_tick", 0.5, 0.25, tid=0, pid=0, tick=np.int64(1))
        tr.instant("backpressure", 0.625, tid=0, pid=0, backlog=3)
        tr.flow_start("req 7", 7, 0.5, tid=0, pid=0)
        tr.flow_step("req 7", 7, 0.625, tid=0, pid=2)
        tr.flow_end("req 7", 7, 0.75, tid=3, pid=2)
        docs.append(tr.to_chrome())
        null = mod.NULL_TRACER
        null.name_process(1, "x")
        null.instant("x")
        null.flow_start("x", 1)
        null.flow_end("x", 1)
        assert null.events == []
    assert json.dumps(docs[0]) == json.dumps(docs[1])


# ----------------------------------------------------------------------
# the slot-sharded pool
# ----------------------------------------------------------------------
def _engine(narrow, **kw):
    return SarServingEngine(narrow["params"], narrow["cfg"], n_slots=4,
                            policy=TriagePolicy(**POLICY), device="cpu",
                            **kw)


def test_sharded_pool_matches_reference_engine(narrow):
    from repro.serving import SarServingEngine as JEngine
    from repro.serving import TriagePolicy as JPolicy
    ref = JEngine(narrow["jparams"], narrow["jcfg"], n_slots=4,
                  policy=JPolicy(**POLICY))
    _served(ref, j_stream(24, corrupt_frac=0.25))
    eng = _engine(narrow, slot_devices=["cpu"] * 2)
    out = _served(eng, _port_reqs(24))
    want, got = _records([ref]), _records([eng])
    assert set(got) == set(want) == set(range(24))
    for rid, w in want.items():
        assert got[rid][:3] == w[:3], rid
        np.testing.assert_allclose(got[rid][3:], w[3:], atol=1e-5)
    assert eng.host_syncs == ref.host_syncs
    assert out["shards"] == 2 and out["runs"] == 1
    for k in ("rounds", "dispatches", "samples", "decisions"):
        assert out["telemetry"][k] == ref.metrics.summary()[
            "telemetry"][k], k


def _die(narrow):
    from repro_torch.core.bayes_layer import sigma_of
    from repro_torch.core.sampling import BayesHeadConfig
    from repro_torch.hw import (VariationSpec, prepare_instance_head,
                                sample_instances)
    chip = sample_instances(11, 1, VariationSpec().scaled(2.0))[0]
    head = narrow["params"]["head"]
    base = BayesHeadConfig(num_samples=POLICY["r_max"], mode="rank16",
                           grng=narrow["cfg"].grng,
                           compute_dtype=torch.float32, hoist_basis=True)
    h, hcfg = prepare_instance_head(head["mu"], sigma_of(head), base, chip,
                                    calibrated=True)
    return dict(chip=chip, head=h, hcfg=hcfg)


@pytest.mark.parametrize("shards", [2, 4])
def test_sharded_pool_on_a_die_is_the_unsharded_pool(narrow, shards):
    """On the gate die the read noise keys on global slot ids: the
    sharded pool's records equal the unsharded pool's bit for bit."""
    die = _die(narrow)
    a, b = _engine(narrow, **die), _engine(
        narrow, slot_devices=["cpu"] * shards, **die)
    _served(a, _port_reqs(16))
    out = _served(b, _port_reqs(16))
    assert die["hcfg"].grng.read_sigma > 0
    assert _records([a]) == _records([b])
    assert out["shards"] == shards and a.host_syncs == b.host_syncs


@pytest.mark.parametrize("fused", [True, False])
def test_pool_over_two_runs_is_the_unsharded_pool(narrow, fused):
    """A pool split by hand into two runs (the CPU has one device, so
    ``slot_runs`` gives one run here): every run's state, rounds and
    read noise on its global slot ids give the unsharded pool's records
    and telemetry bit for bit on the gate die."""
    die = _die(narrow)
    a = _engine(narrow, fused=fused, **die)
    b = _engine(narrow, fused=fused, slot_devices=["cpu"] * 2, **die)
    b.runs = _two_runs(4)
    _served(a, _port_reqs(16))
    out = _served(b, _port_reqs(16))
    assert _records([a]) == _records([b]) and out["runs"] == 2
    assert [p["y_mu"].shape[0] for p in b.pools] == [2, 2]
    assert out["telemetry"] == a.metrics.summary()["telemetry"]
    assert a.host_syncs == b.host_syncs


def test_sharded_pool_falls_back_when_slots_do_not_divide(narrow):
    eng = _engine(narrow, slot_devices=["cpu"] * 3)
    out = _served(eng, _port_reqs(6))
    assert eng._shard is None and out["shards"] == 1
    assert "shards" not in _served(_engine(narrow), _port_reqs(2))


# ----------------------------------------------------------------------
# the fleet against the reference's
# ----------------------------------------------------------------------
@pytest.fixture(scope="module")
def ref_fleet(narrow):
    from repro.launch.serve import sar_layer_shapes
    from repro.serving import TriagePolicy as JPolicy
    from repro.serving.fleet import SarServingFleet as JFleet
    fleet = JFleet(narrow["jparams"], narrow["jcfg"], n_pools=2,
                   slots_per_pool=4, policy=JPolicy(**POLICY), gang=False,
                   layers=sar_layer_shapes(narrow["jcfg"]))
    out = _served(fleet, j_stream(24, corrupt_frac=0.25))
    return fleet, out


@pytest.mark.parametrize("gang", [False, True])
def test_fleet_matches_reference(narrow, ref_fleet, gang):
    from repro_torch.launch.serve import sar_layer_shapes
    jf, jout = ref_fleet
    fleet = _fleet(narrow, n_pools=2, slots_per_pool=4, gang=gang,
                   layers=sar_layer_shapes(narrow["cfg"]))
    out = _served(fleet, _port_reqs(24))
    assert out["gang"] is gang
    assert fleet.routes == jf.routes
    assert out["routed_per_pool"] == jout["routed_per_pool"] == [12, 12]
    assert out["backlog_peak"] == jout["backlog_peak"]
    want, got = _records(jf.engines), _records(fleet.engines)
    assert set(got) == set(want) == set(range(24))
    for rid, w in want.items():
        assert got[rid][:3] == w[:3], rid
        np.testing.assert_allclose(got[rid][3:], w[3:], atol=1e-5)
    np.testing.assert_allclose(out["energy_total_J"],
                               jout["energy_total_J"], rtol=1e-9)
    for k in ("rounds", "samples", "decisions"):
        assert out["telemetry"][k] == jout["telemetry"][k], k
    if gang:       # every pool dispatches every tick, idle ones masked
        assert out["host_syncs"] == out["ticks"] < jout["host_syncs"]
        assert out["telemetry"]["dispatches"] == 2 * out["ticks"]
        assert len(out["tick_log"]) == len(jout["tick_log"])
    else:
        assert out["host_syncs"] == jout["host_syncs"]
        assert [e.host_syncs for e in fleet.engines] == \
            [e.host_syncs for e in jf.engines]
        assert out["telemetry"]["dispatches"] == \
            jout["telemetry"]["dispatches"]
        assert [t["trips"] for t in out["tick_log"]] == \
            [t["trips"] for t in jout["tick_log"]]


def test_gang_equals_sequential_with_fewer_syncs(narrow):
    reqs = _port_reqs(20)
    outs, recs = [], []
    for gang in (True, False):
        fleet = _fleet(narrow, n_pools=3, slots_per_pool=4, gang=gang)
        outs.append(_served(fleet, [Request(rid=r.rid, payload=r.payload,
                                            meta=r.meta) for r in reqs]))
        recs.append(_records(fleet.engines))
    assert recs[0] == recs[1] and len(recs[0]) == 20
    assert outs[0]["routed_per_pool"] == outs[1]["routed_per_pool"]
    assert outs[0]["host_syncs"] < outs[1]["host_syncs"]
    assert outs[0]["decisions"] == outs[1]["decisions"] == 20


# ----------------------------------------------------------------------
# the counterparts of tests/test_fleet.py
# ----------------------------------------------------------------------
def test_single_pool_fleet_matches_standalone_engine(narrow):
    eng = _engine(narrow)
    _served(eng, _port_reqs(20))
    fleet = _fleet(narrow, n_pools=1, slots_per_pool=4)
    out = _served(fleet, _port_reqs(20))
    assert _records([eng]) == _records(fleet.engines)
    assert out["gang"] is False and out["routed_per_pool"] == [20]


def test_router_is_consistent_least_loaded(narrow):
    routes = []
    for _ in range(2):
        fleet = _fleet(narrow, n_pools=2, slots_per_pool=4)
        _served(fleet, _port_reqs(16))
        routes.append(dict(fleet.routes))
    assert routes[0] == routes[1]
    assert [sum(p == q for p in routes[0].values()) for q in (0, 1)] == \
        [8, 8]
    fleet = _fleet(narrow, n_pools=3, slots_per_pool=4)
    for r in _port_reqs(4):
        fleet.submit(r)
    fleet._route()                    # ties go to the lowest pool id
    assert [fleet.routes[i] for i in range(4)] == [0, 1, 2, 0]


def test_router_backpressure_skips_saturated_pool(narrow):
    fleet = _fleet(narrow, n_pools=2, slots_per_pool=4, queue_cap=2)
    stream = _port_reqs(10)
    for r in stream[:2]:
        fleet.engines[0].queue.append(r)
    for r in stream[2:]:
        fleet.submit(r)
    fleet._route()
    assert len(fleet.engines[0].queue) == 2
    assert all(p == 1 for p in fleet.routes.values())
    assert len(fleet.engines[1].queue) == 2
    assert len(fleet.backlog) == 6 and fleet.backlog_peak >= 6
    out = fleet.run()
    assert out["requests"] == out["decisions"] == 10
    assert not fleet.backlog and all(not e.queue for e in fleet.engines)
    assert sum(p == 0 for p in fleet.routes.values()) > 0
    assert out["backpressure_ticks"] >= 1
    from repro_torch.launch.serve import collect_alerts
    bus = collect_alerts(out, "fleet")
    assert bus.counts().get("backpressure") == 1
    assert out["alerts"]


def test_fleet_energy_reconciles_to_per_request_sum(narrow):
    from repro_torch.launch.serve import sar_layer_shapes
    from repro_torch.serving.metrics import request_energy
    layers = sar_layer_shapes(narrow["cfg"])
    fleet = _fleet(narrow, n_pools=2, slots_per_pool=4, layers=layers)
    out = _served(fleet, _port_reqs(24))
    per_record = sum(request_energy(r, layers) for e in fleet.engines
                     for r in e.metrics.records)
    per_pool = sum(e.metrics.summary()["energy_total_J"]
                   for e in fleet.engines)
    assert out["energy_total_J"] == pytest.approx(per_record, rel=1e-9)
    assert out["energy_total_J"] == pytest.approx(per_pool, rel=1e-12)
    assert sum(p["energy_total_J"] for p in out["pools"]) == \
        pytest.approx(out["energy_total_J"], rel=1e-12)


def test_fleet_telemetry_merges_and_idle_pools_match_reference_gang(
        narrow, spmd):
    """Each request's counters live in one pool's snapshot; in the gang
    an idle pool's dispatch counter ticks while its rounds do not, as
    the reference's gang (9 requests on 2 pools of 4 slots with queues
    of 4: the second tick leaves pool 1 idle)."""
    fleet = _fleet(narrow, n_pools=2, slots_per_pool=4, queue_cap=4)
    out = _served(fleet, _port_reqs(9))
    snaps = [e.metrics.telemetry for e in fleet.engines]
    for k in ("rounds", "dispatches", "samples", "decisions"):
        assert out["telemetry"][k] == sum(s[k] for s in snaps), k
    assert out["telemetry"]["decisions"] == out["decisions"] == 9
    assert out["telemetry"]["samples"] == sum(
        r.n_samples for e in fleet.engines for r in e.metrics.records)
    ref = spmd()["gang"]
    assert [{k: int(s[k]) for k in ("rounds", "dispatches", "samples",
                                    "decisions")} for s in snaps] == \
        ref["telemetry"]
    assert snaps[1]["dispatches"] > snaps[1]["rounds"]      # idle tick
    assert [t["trips"] for t in out["tick_log"]] == ref["trips"]
    assert {str(k): v for k, v in fleet.routes.items()} == ref["routes"]
    assert out["routed_per_pool"] == ref["routed_per_pool"]
    assert out["host_syncs"] == ref["host_syncs"]
    got = _records(fleet.engines)
    for rid, w in ref["records"].items():
        assert list(got[int(rid)][:3]) == w[:3], rid
        np.testing.assert_allclose(got[int(rid)][3:], w[3:], atol=1e-5)


def test_sharded_kernel_matches_reference(spmd):
    """The port's sharded kernel against the reference's under a 2-device
    mesh (interpret mode), C6's 1e-5."""
    res = spmd()
    for i, c in enumerate(res["cases"]):
        args, kw = _torch_case(c)
        got = tdec.decision_stats_sharded(*args, devices=["cpu"] * 2, **kw)
        for key in STATS:
            np.testing.assert_allclose(got[key].numpy(),
                                       res["kernel"][f"c{i}_{key}"],
                                       rtol=1e-5, atol=1e-5,
                                       err_msg=f"case {i} {key}")


@pytest.mark.parametrize("case", range(len(KERNEL_CASES)))
def test_fold_over_two_runs_is_one_run_and_the_reference(spmd, case):
    """``fold_runs`` over two explicit CPU runs equals the fold over one
    run and the sharded plain version bit for bit, and the reference's
    ``decision_stats_sharded`` under a 2-device mesh within C6's 1e-5."""
    res = spmd()
    c = res["cases"][case]
    args, kw = _torch_case(c)
    b = args[0].shape[0]
    one = tdec.fold_runs(tdec.slot_runs(["cpu"] * 2, b), *args, **kw)
    two = tdec.fold_runs(_two_runs(b), *args, **kw)
    plain = tdec.decision_stats_sharded_plain(*args, shards=2, **kw)
    for key in STATS:
        assert torch.equal(two[key], one[key]), key
        assert torch.equal(two[key], plain[key]), key
        np.testing.assert_allclose(two[key].numpy(),
                                   res["kernel"][f"c{case}_{key}"],
                                   rtol=1e-5, atol=1e-5, err_msg=key)


# ----------------------------------------------------------------------
# the counterparts of tests/test_slo.py's fleet tests
# ----------------------------------------------------------------------
def test_fleet_slo_zero_overhead(narrow):
    outs, fleets = [], []
    for slo in (True, False):
        fleet = _fleet(narrow, n_pools=2, slots_per_pool=4, slo=slo,
                       telemetry=False)
        outs.append(_served(fleet, _port_reqs(24)))
        fleets.append(fleet)
    assert _records(fleets[0].engines) == _records(fleets[1].engines)
    assert fleets[0].host_syncs == fleets[1].host_syncs
    snap = outs[0]["slo"]
    assert snap["requests"] == 24 and snap["fleet"]["ticks"] >= 1
    assert len(snap["fleet"]["queue_depth_peak"]) == 2
    assert "slo" not in outs[1]


def test_fleet_trace_single_stitched_timeline(narrow):
    from repro_torch.obs.trace import Tracer
    tr = Tracer("fleet-test")
    fleet = _fleet(narrow, n_pools=2, slots_per_pool=4, tracer=tr)
    _served(fleet, _port_reqs(16))
    ev = tr.to_chrome()["traceEvents"]
    pnames = {e["pid"]: e["args"]["name"] for e in ev
              if e["ph"] == "M" and e["name"] == "process_name"}
    assert pnames == {0: "router", 1: "pool 0", 2: "pool 1"}
    assert any(e["ph"] == "X" and e["name"] == "fleet_tick"
               and e["pid"] == 0 for e in ev)
    disp = {e["pid"] for e in ev
            if e["ph"] == "X" and e["name"] == "gang_dispatch"}
    assert disp and disp <= {1, 2}
    starts = {e["id"]: e for e in ev if e["ph"] == "s"}
    ends = {e["id"]: e for e in ev if e["ph"] == "f"}
    assert set(starts) == set(ends) == set(range(16))
    for rid in range(16):
        assert starts[rid]["pid"] == 0 and ends[rid]["bp"] == "e"
        assert ends[rid]["pid"] == fleet.routes[rid] + 1
        assert starts[rid]["ts"] <= ends[rid]["ts"]
    spans = {e["name"]: e for e in ev
             if e["ph"] == "X" and e["name"].startswith("req ")}
    for rid in range(16):
        assert spans[f"req {rid}"]["pid"] == fleet.routes[rid] + 1


# ----------------------------------------------------------------------
# load, CLI, mission
# ----------------------------------------------------------------------
def test_open_loop_drives_a_fleet(narrow):
    from repro_torch.serving.load import ArrivalSpec, run_open_loop
    fleet = _fleet(narrow, n_pools=2, slots_per_pool=4)
    spec = ArrivalSpec.parse("poisson:2000")
    out = run_open_loop(fleet, _port_reqs(16), spec.offsets(16, seed=1),
                        speed=2.0)
    assert out["requests"] == out["decisions"] == 16
    assert out["offered"]["submitted"] == 16
    assert fleet.wall_s == out["wall_s"] == out["offered"]["harness_wall_s"]
    assert len(out["slo"]["fleet"]["queue_depth_peak"]) == 2


def test_serve_sar_fleet_and_cli_on_the_cpu(capsys):
    from repro_torch.launch import serve
    kw = dict(n_requests=12, n_pools=2, slots_per_pool=4,
              corrupt_frac=0.25, devices=["cpu", "cpu"],
              policy=TriagePolicy(**POLICY))
    a = serve.serve_sar_fleet(gang=True, **kw)
    b = serve.serve_sar_fleet(gang=False, **kw)
    assert a["verdicts"] == b["verdicts"]
    assert [v["rid"] for v in a["verdicts"]] == list(range(12))
    assert a["routed_per_pool"] == b["routed_per_pool"]
    assert a["host_syncs"] < b["host_syncs"]
    assert a["devices"] == ["cpu", "cpu"]
    out = serve.main(["--arch", "sar_cnn", "--device", "cpu", "--pools",
                      "2", "--slots-per-pool", "4", "--requests", "8"])
    assert out["n_pools"] == 2 and out["decisions"] == 8
    assert "[sar fleet] 8 decisions" in capsys.readouterr().out
    with pytest.raises(SystemExit):
        serve.main(["--arch", "sar_cnn", "--device", "cpu", "--pools", "2",
                    "--mesh", "2"])


def test_fleet_defaults_to_the_card(narrow, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        SarServingFleet(narrow["params"], narrow["cfg"], n_pools=2)
    with pytest.raises(ValueError, match="one a pool"):
        _fleet(narrow, n_pools=2, devices=["cpu"])


def test_sharded_mission_equals_the_unsharded_one(narrow):
    from repro_torch.hw import VariationSpec, sample_instances
    from repro_torch.mission import policy as tpolicy
    from repro_torch.mission import rollout as troll
    from repro_torch.mission import uav as tuav
    from repro_torch.mission import world as tworld
    wcfg = tworld.WorldConfig(grid=6, n_victims=3, seed=2)
    ucfg = tuav.UavConfig(n_drones=2, battery_J=120e-6)
    chip = sample_instances(11, 1, VariationSpec().scaled(2.5))[0]
    runs = [troll.fly_mission(wcfg, ucfg, tpolicy.MissionPolicy(),
                              params=narrow["params"], cfg=narrow["cfg"],
                              chips=[None, chip], n_steps=8, n_episodes=2,
                              devices=devices, device="cpu")
            for devices in (None, ["cpu", "cpu"])]
    assert runs[0].summary == runs[1].summary
    for k in runs[0].logs:
        np.testing.assert_array_equal(runs[0].logs[k], runs[1].logs[k],
                                      err_msg=k)
    assert runs[1].host_syncs == 2
