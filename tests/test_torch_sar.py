"""The ideal-die SAR serving slice of the port against the JAX reference.

  * the conv trunk + GAP (``models.sar_cnn.features``) on bridged
    ``init_sar_cnn(PRNGKey(3))`` params and bridged ``make_sar_stream``
    images, atol 1e-5;
  * the slice as a whole: the port's ``SarServingEngine(device="cpu")``
    against the JAX engine on the 192-request fog stream with the
    policy of ``tests/test_decision_kernel.py:203`` — per request the
    same verdict, prediction and sample count, confidence and MI within
    atol 1e-5, equal host syncs and energy (rtol 1e-9); and again under
    a policy whose requests escalate, through both of the port's
    decision paths;
  * the package stands alone: no module imports ``jax`` or ``repro``;
  * entry points default to the card and raise without one.
"""

import re
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.launch.serve import make_sar_stream as j_stream
from repro.launch.serve import sar_layer_shapes as j_shapes
from repro.models.sar_cnn import SarCnnConfig as JCfg
from repro.models.sar_cnn import features as j_features
from repro.models.sar_cnn import init_sar_cnn as j_init
from repro_torch import resolve_device
from repro_torch.bridge import params_from_jax, params_to_jax, to_numpy
from repro_torch.launch.serve import sar_layer_shapes
from repro_torch.models.sar_cnn import SarCnnConfig, features

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"


@pytest.fixture(scope="module")
def jax_params():
    return j_init(jax.random.PRNGKey(3), JCfg())


@pytest.fixture(scope="module")
def stream_192():
    return j_stream(192, corrupt_frac=0.25, corruption="fog")


def test_bridge_round_trip(jax_params):
    tree = jax.device_get(jax_params)
    back = params_to_jax(params_from_jax(tree))
    for a, b in zip(back["convs"], tree["convs"]):
        np.testing.assert_array_equal(a["w"], b["w"])
        np.testing.assert_array_equal(a["b"], b["b"])
    for key in ("mu", "rho"):
        np.testing.assert_array_equal(back["head"][key], tree["head"][key])
    assert params_from_jax(tree)["convs"][0]["w"].shape == (16, 1, 3, 3)


def test_features_match_reference(jax_params, stream_192):
    imgs = np.stack([r.payload for r in stream_192[:48]])
    want = np.asarray(j_features(jax_params, imgs, JCfg()))
    got = features(params_from_jax(jax.device_get(jax_params)),
                   torch.as_tensor(imgs), SarCnnConfig())
    assert got.shape == (48, 64)
    np.testing.assert_allclose(to_numpy(got), want, rtol=1e-5, atol=1e-5)


def _jax_engine(params, reqs, policy, fused):
    from repro.hw import compile_network
    from repro.serving import SarServingEngine, ServingMetrics
    layers = j_shapes(JCfg())
    eng = SarServingEngine(
        params, JCfg(), n_slots=32, policy=policy, adaptive_mode=True,
        metrics=ServingMetrics(layers=layers,
                               tile_program=compile_network(layers)),
        fused=fused, telemetry=False, profiler=False, slo=False)
    for r in reqs:
        eng.submit(r)
    return eng, eng.run()


def _port_engine(params, reqs, policy, fused):
    from repro_torch.hw import compile_network
    from repro_torch.serving import (Request, SarServingEngine,
                                     ServingMetrics)
    layers = sar_layer_shapes(SarCnnConfig())
    eng = SarServingEngine(
        params_from_jax(jax.device_get(params)), SarCnnConfig(),
        n_slots=32, policy=policy, adaptive_mode=True,
        metrics=ServingMetrics(layers=layers,
                               tile_program=compile_network(layers)),
        fused=fused, device="cpu")
    for r in reqs:
        eng.submit(Request(rid=r.rid, payload=np.asarray(r.payload),
                           meta=dict(r.meta)))
    return eng, eng.run()


def _assert_same_decisions(eng_t, eng_j, n):
    recs_t = {r.rid: r for r in eng_t.metrics.records}
    recs_j = {r.rid: r for r in eng_j.metrics.records}
    assert set(recs_t) == set(recs_j) == set(range(n))
    for rid, a in recs_j.items():
        b = recs_t[rid]
        assert (b.verdict, b.prediction, b.n_samples) == \
            (a.verdict, a.prediction, a.n_samples), rid
        np.testing.assert_allclose(b.confidence, a.confidence, atol=1e-5)
        np.testing.assert_allclose(b.mutual_information,
                                   a.mutual_information, atol=1e-5)
    assert eng_t.host_syncs == eng_j.host_syncs


def test_engine_matches_reference_192(jax_params, stream_192):
    """Acceptance of the slice: the port's engine gives the JAX engine's
    decisions on the fixed 192-request fog stream."""
    from repro.serving import TriagePolicy as JPolicy
    from repro_torch.serving import TriagePolicy
    eng_j, out_j = _jax_engine(
        jax_params, stream_192,
        JPolicy(conf_threshold=0.7, mi_threshold=0.05, r_min=4, r_max=20),
        fused=True)
    eng_t, out_t = _port_engine(
        jax_params, stream_192,
        TriagePolicy(conf_threshold=0.7, mi_threshold=0.05, r_min=4,
                     r_max=20), fused=True)
    _assert_same_decisions(eng_t, eng_j, 192)
    assert eng_t.host_syncs <= 192
    np.testing.assert_allclose(out_t["energy_total_J"],
                               out_j["energy_total_J"], rtol=1e-9)
    assert out_t["tile_area_mm2"] == out_j["tile_area_mm2"]
    # the fixed-length loop launched every round of every dispatch
    assert eng_t.rounds_launched == eng_t.max_rounds * eng_t.host_syncs


@pytest.mark.parametrize("fused", [True, False])
def test_engine_escalation_matches_reference(jax_params, stream_192, fused):
    """A policy under which the untrained model's requests escalate (to
    4..16 samples on this stream): the port's fixed-length loop with its
    device-side exit flag reproduces the reference's while-loop round
    counts."""
    from repro.serving import TriagePolicy as JPolicy
    from repro_torch.serving import TriagePolicy
    reqs = stream_192[:96]
    eng_j, _ = _jax_engine(
        jax_params, reqs,
        JPolicy(conf_threshold=0.55, mi_threshold=0.05, r_min=4, r_max=20),
        fused=False)
    eng_t, _ = _port_engine(
        jax_params, reqs,
        TriagePolicy(conf_threshold=0.55, mi_threshold=0.05, r_min=4,
                     r_max=20), fused=fused)
    _assert_same_decisions(eng_t, eng_j, 96)
    depths = {r.n_samples for r in eng_t.metrics.records}
    assert len(depths) >= 4, depths


def test_port_imports_no_jax():
    """Importing the whole port loads neither jax nor the reference."""
    mods = sorted(
        "repro_torch." + ".".join(p.relative_to(PORT).with_suffix("").parts)
        for p in PORT.rglob("*.py") if p.name != "__init__.py")
    code = ("import sys, importlib\n"
            "import repro_torch\n"
            f"for m in {mods!r}:\n"
            "    importlib.import_module(m)\n"
            "bad = [m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m == 'repro' or "
            "m.startswith('repro.')]\n"
            "assert not bad, bad\n"
            "print(len(sys.modules))\n")
    env = {"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"}
    res = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr


def test_no_source_imports_jax_or_reference():
    pat = re.compile(r"^\s*(import jax|from jax|from repro(\.| import)"
                     r"|import repro\b)")
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    offenders = [f"{f.relative_to(ROOT)}:{i}"
                 for f in files
                 for i, line in enumerate(f.read_text().splitlines(), 1)
                 if pat.match(line)]
    assert not offenders, offenders
    assert len(files) > 20


def test_default_device_is_the_card(monkeypatch):
    from repro_torch.launch.serve import serve_sar
    from repro_torch.serving import SarServingEngine
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert resolve_device(None) == torch.device("cuda")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device(None)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        SarServingEngine({}, SarCnnConfig())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve_sar(n_requests=4)
    assert resolve_device("cpu") == torch.device("cpu")


def test_serve_cli_on_cpu(capsys):
    from repro_torch.launch.serve import main, serve_sar
    main(["--arch", "sar_cnn", "--requests", "40", "--slots", "8",
          "--corrupt-frac", "0.25", "--device", "cpu", "--fixed"])
    line = capsys.readouterr().out.strip().splitlines()
    assert len(line) == 1 and line[0].startswith("[sar] 40 decisions")
    out = serve_sar(n_requests=40, n_slots=8, corrupt_frac=0.25,
                    device="cpu", fused=False)
    assert out["requests"] == 40 and out["decisions"] == 40
    assert out["host_syncs"] <= 40 and out["device"] == "cpu"
    assert out["mean_samples_per_decision"] >= 4
    assert np.isfinite(out["energy_total_J"])
