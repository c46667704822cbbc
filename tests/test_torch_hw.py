"""The chip-instance slice of the port against the JAX reference: dies,
their GRNG, calibration, the deployed head and serving on a die.

  * ``sample_instances`` (seeds 0/11/21 × severities 0/1/2) and
    ``golden_instance``: every field equal; ``ChipInstance.grng``: the
    same config; ``program_weights``: bit-equal per tag;
  * ``read_noise`` bit-equal; ``raw_sums``, ``eps`` and
    ``estimate_mean_offset`` with read noise: atol 2e-6 (ROADMAP C2:
    float order);
  * ``measured_grng``: the measured constants to rtol 1e-6 (a mean and
    an SD over 131,072 sums, reduced in another order than XLA's);
  * ``prepare_instance_head``, calibrated or not: the arrays to 1e-6;
    the 8-bit µ and 4-bit σ codes equal, with any flip counted;
  * the engine gate (``tests/test_decision_kernel.py:219``): 48 fog-
    mixed requests on ``sample_instances(11, 1, VariationSpec().
    scaled(2.0))``, the port's engine on the CPU, fused and not, against
    the JAX engine: the same verdict, prediction and sample count per
    request, confidence and MI within atol 1e-5; again under a policy
    whose requests escalate;
  * the CLI prints the die's fields.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import clt_grng as jg
from repro.core import quant as jq
from repro.core.bayes_layer import sigma_of as j_sigma_of
from repro.core.offset import compensate_mu as j_compensate
from repro.core.sampling import BayesHeadConfig as JHeadCfg
from repro.hw import VariationSpec as JVariationSpec
from repro.hw import golden_instance as j_golden
from repro.hw import measured_grng as j_measured
from repro.hw import prepare_instance_head as j_prepare
from repro.hw import sample_instances as j_sample
from repro.launch.serve import make_sar_stream as j_stream
from repro.launch.serve import sar_layer_shapes as j_shapes
from repro.models.sar_cnn import SarCnnConfig as JCfg
from repro.models.sar_cnn import init_sar_cnn as j_init
from repro_torch.bridge import head_from_jax, instance_from_tree
from repro_torch.bridge import params_from_jax
from repro_torch.core import clt_grng as tg
from repro_torch.core import quant as tq
from repro_torch.core.offset import compensate_mu
from repro_torch.core.sampling import BayesHeadConfig
from repro_torch.hw import (VariationSpec, golden_instance, measured_grng,
                            prepare_instance_head, sample_instances)
from repro_torch.models.sar_cnn import SarCnnConfig


def _port_grng(cfg: jg.GRNGConfig) -> tg.GRNGConfig:
    return tg.GRNGConfig(**{f.name: getattr(cfg, f.name)
                            for f in dataclasses.fields(cfg)})


def _fields_equal(a, b):
    ta, tb = a.to_tree(), b.to_tree()
    assert set(ta) == set(tb)
    for key in ta:
        assert ta[key].dtype == tb[key].dtype, key
        np.testing.assert_array_equal(ta[key], tb[key], err_msg=key)


@pytest.mark.parametrize("severity", [0.0, 1.0, 2.0])
@pytest.mark.parametrize("seed", [0, 11, 21])
def test_sampled_dies_are_the_reference_dies(seed, severity):
    want = j_sample(seed, 3, JVariationSpec().scaled(severity))
    got = sample_instances(seed, 3, VariationSpec().scaled(severity))
    assert len(got) == 3
    for a, b in zip(got, want):
        _fields_equal(a, b)
        assert dataclasses.asdict(a.grng(tg.GRNGConfig())) == \
            dataclasses.asdict(b.grng(jg.GRNGConfig()))
    # the bridge carries a die across field for field
    _fields_equal(instance_from_tree(want[1].to_tree()), want[1])


def test_golden_instance_is_the_golden_chip():
    _fields_equal(golden_instance(), j_golden())
    gold = golden_instance()
    assert gold.grng(tg.GRNGConfig()) == tg.GRNGConfig()
    w = torch.randn(5, 3)
    assert gold.program_weights(w, tag=16) is w
    gain, off = gold.adc_columns(130)
    assert gain.shape == off.shape == (130,)


@pytest.mark.parametrize("tag", [0, 1, 16, 17, 18])
def test_program_weights_bit_equal(tag):
    chip = j_sample(21, 1, JVariationSpec().scaled(2.0))[0]
    w = np.random.default_rng(tag).standard_normal((150, 70)).astype(
        np.float32)
    want = np.asarray(chip.program_weights(jnp.asarray(w), tag=tag))
    got = instance_from_tree(chip.to_tree()).program_weights(
        torch.as_tensor(w), tag=tag)
    np.testing.assert_array_equal(got.numpy(), want)
    assert not np.array_equal(want, w)


def _degraded(seed=11, severity=2.0):
    return j_sample(seed, 1, JVariationSpec().scaled(severity))[0].grng(
        jg.GRNGConfig())


def test_read_noise_bit_equal():
    jc = _degraded()
    assert jc.read_sigma > 0
    want = np.asarray(jg.read_noise(jc, 33, 7, 5, sample0=19, row0=4,
                                    col0=2))
    got = tg.read_noise(_port_grng(jc), 33, 7, 5, sample0=19, row0=4,
                        col0=2)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("seed", [0, 21])
def test_sums_eps_and_offset_estimate_match(seed):
    jc = _degraded(seed)
    tc = _port_grng(jc)
    np.testing.assert_allclose(
        tg.raw_sums(tc, 40, 9, 6, sample0=3).numpy(),
        np.asarray(jg.raw_sums(jc, 40, 9, 6, sample0=3)), rtol=0, atol=2e-6)
    np.testing.assert_allclose(
        tg.eps(tc, 40, 9, 6).numpy(), np.asarray(jg.eps(jc, 40, 9, 6)),
        rtol=0, atol=2e-6)
    np.testing.assert_allclose(
        tg.estimate_mean_offset(tc, 40, 9, 64).numpy(),
        np.asarray(jg.estimate_mean_offset(jc, 40, 9, 64)), rtol=0,
        atol=2e-6)


@pytest.mark.parametrize("seed", [0, 11, 21])
def test_measured_grng_constants(seed):
    jc = _degraded(seed)
    want = j_measured(jc, n_samples=64)
    got = measured_grng(_port_grng(jc), device="cpu")
    np.testing.assert_allclose(got.sum_mean, want.sum_mean, rtol=1e-6)
    np.testing.assert_allclose(got.sum_std, want.sum_std, rtol=1e-6)
    assert dataclasses.replace(got, sum_mean=0.0, sum_std=0.0) == \
        _port_grng(dataclasses.replace(want, sum_mean=0.0, sum_std=0.0))


@pytest.fixture(scope="module")
def jax_params():
    return j_init(jax.random.PRNGKey(3), JCfg())


def _head_cfgs():
    jh = JHeadCfg(num_samples=20, mode="rank16", grng=JCfg().grng,
                  compute_dtype=jnp.float32, hoist_basis=True)
    th = BayesHeadConfig(num_samples=20, mode="rank16",
                         grng=SarCnnConfig().grng,
                         compute_dtype=torch.float32, hoist_basis=True)
    return jh, th


def _deploy_both(jax_params, chip, calibrated):
    jh, th = _head_cfgs()
    mu, sigma = jax_params["head"]["mu"], j_sigma_of(jax_params["head"])
    head_j, hcfg_j = j_prepare(mu, sigma, jh, chip, calibrated=calibrated)
    tchip = instance_from_tree(chip.to_tree())
    head_t, hcfg_t = prepare_instance_head(
        torch.tensor(np.asarray(mu)), torch.tensor(np.asarray(sigma)),
        th, tchip, calibrated=calibrated)
    return (jax.device_get(head_j), hcfg_j), (head_t, hcfg_t)


def _codes_j(mu, sigma, grng_j, calibrated, qcfg):
    if calibrated:
        scfg = j_measured(grng_j, n_samples=64)
        mu_p = j_compensate(mu, sigma, scfg, exact=False, n_est=64)
    else:
        mu_p = j_compensate(mu, sigma, jg.GRNGConfig(), exact=True)
    mu_scale = jq.symmetric_scale(mu_p, qcfg.mu_bits, axis=(0,))
    sig_scale = jnp.max(sigma, axis=0, keepdims=True) / 15
    return (np.asarray(jq.quantize(mu_p, mu_scale, qcfg.mu_bits)),
            np.asarray(jq.quantize(sigma, sig_scale, qcfg.sigma_bits,
                                   signed=False)))


def _codes_t(mu, sigma, grng_t, calibrated, qcfg):
    if calibrated:
        scfg = measured_grng(grng_t, device=mu.device)
        mu_p = compensate_mu(mu, sigma, scfg, exact=False, n_est=64)
    else:
        mu_p = compensate_mu(mu, sigma, tg.GRNGConfig(), exact=True)
    mu_scale = tq.symmetric_scale(mu_p, qcfg.mu_bits, axis=(0,))
    sig_scale = sigma.amax(dim=0, keepdim=True) / 15
    return (tq.quantize(mu_p, mu_scale, qcfg.mu_bits).numpy(),
            tq.quantize(sigma, sig_scale, qcfg.sigma_bits,
                        signed=False).numpy())


@pytest.mark.parametrize("calibrated", [True, False])
@pytest.mark.parametrize("quant", [False, True])
def test_instance_head_matches(jax_params, calibrated, quant):
    """The deployed head carried across with ``head_from_jax`` equals
    the port's own deployment to 1e-6; with quantization the 8-bit µ and
    4-bit σ codes are equal (0 flips on this die)."""
    chip = j_sample(11, 1, JVariationSpec().scaled(2.0))[0]
    jh, th = _head_cfgs()
    if quant:
        jh = dataclasses.replace(jh, quant=jq.QuantConfig(enabled=True))
        th = dataclasses.replace(th, quant=tq.QuantConfig(enabled=True))
    mu, sigma = jax_params["head"]["mu"], j_sigma_of(jax_params["head"])
    head_j, hcfg_j = j_prepare(mu, sigma, jh, chip, calibrated=calibrated)
    tchip = instance_from_tree(chip.to_tree())
    mu_t = torch.tensor(np.asarray(mu))
    sigma_t = torch.tensor(np.asarray(sigma))
    head_t, hcfg_t = prepare_instance_head(mu_t, sigma_t, th, tchip,
                                           calibrated=calibrated)
    bridged = head_from_jax(jax.device_get(head_j))
    assert set(bridged) == set(head_t) == {"mu_prime", "sigma",
                                           "sigma_basis"}
    for key in head_t:
        np.testing.assert_allclose(head_t[key].numpy(),
                                   bridged[key].numpy(), rtol=1e-6,
                                   atol=1e-6, err_msg=key)
    np.testing.assert_allclose(hcfg_t.grng.sum_mean, hcfg_j.grng.sum_mean,
                               rtol=1e-6)
    np.testing.assert_allclose(hcfg_t.grng.sum_std, hcfg_j.grng.sum_std,
                               rtol=1e-6)
    assert hcfg_t.grng.read_sigma == hcfg_j.grng.read_sigma > 0
    if quant:
        icfg = chip.grng(jg.GRNGConfig())
        mu_j, sig_j = _codes_j(mu, sigma, icfg, calibrated, jh.quant)
        mu_c, sig_c = _codes_t(mu_t, sigma_t, _port_grng(icfg), calibrated,
                               th.quant)
        flips = int((mu_c != mu_j).sum()) + int((sig_c != sig_j).sum())
        assert flips == 0, f"{flips} quantization codes flipped"


def _jax_engine(params, reqs, policy, fused, chip, head, hcfg):
    from repro.hw import compile_network
    from repro.serving import SarServingEngine, ServingMetrics
    layers = j_shapes(JCfg())
    eng = SarServingEngine(
        params, JCfg(), n_slots=32, policy=policy, adaptive_mode=True,
        metrics=ServingMetrics(layers=layers,
                               tile_program=compile_network(layers)),
        head=head, hcfg=hcfg, chip=chip, fused=fused, telemetry=False,
        profiler=False, slo=False)
    for r in reqs:
        eng.submit(r)
    eng.run()
    return eng


def _port_engine(params, reqs, policy, fused, chip, head, hcfg):
    from repro_torch.hw import compile_network
    from repro_torch.launch.serve import sar_layer_shapes
    from repro_torch.serving import (Request, SarServingEngine,
                                     ServingMetrics)
    layers = sar_layer_shapes(SarCnnConfig())
    eng = SarServingEngine(
        params_from_jax(jax.device_get(params)), SarCnnConfig(),
        n_slots=32, policy=policy, adaptive_mode=True,
        metrics=ServingMetrics(layers=layers,
                               tile_program=compile_network(layers)),
        head=head, hcfg=hcfg, chip=chip, fused=fused, device="cpu")
    for r in reqs:
        eng.submit(Request(rid=r.rid, payload=np.asarray(r.payload),
                           meta=dict(r.meta)))
    eng.run()
    return eng


@pytest.fixture(scope="module")
def chip_gate(jax_params):
    """The gate die, its 48 requests, both packages' deployed heads and
    the JAX engine's decisions per policy (fused, as the reference's own
    gate checks it against ``fused=False``), computed on first use."""
    from repro.serving import TriagePolicy as JPolicy
    chip = j_sample(11, 1, JVariationSpec().scaled(2.0))[0]
    (head_j, hcfg_j), (head_t, hcfg_t) = _deploy_both(jax_params, chip,
                                                      True)
    reqs = j_stream(48, corrupt_frac=0.25, corruption="fog")
    engines = {}

    def jax_engine(conf):
        if conf not in engines:
            engines[conf] = _jax_engine(
                jax_params, reqs,
                JPolicy(conf_threshold=conf, mi_threshold=0.05, r_min=4,
                        r_max=20), True, chip, head_j, hcfg_j)
        return engines[conf]

    return chip, reqs, jax_engine, head_t, hcfg_t


@pytest.mark.parametrize("conf", [0.7, 0.55], ids=["gate", "escalating"])
@pytest.mark.parametrize("fused", [True, False])
def test_engine_on_chip_instance_matches_reference(jax_params, chip_gate,
                                                   fused, conf):
    """Acceptance of the slice: the port's engine on the gate die gives
    the JAX engine's decisions request for request, under the gate's
    policy (0.7, 0.05) and under (0.55, 0.05), whose requests escalate
    to 4..20 samples through the read-noise rounds."""
    from repro_torch.serving import TriagePolicy
    chip, reqs, jax_engine, head_t, hcfg_t = chip_gate
    eng_j = jax_engine(conf)
    assert hcfg_t.grng.read_sigma > 0
    eng_t = _port_engine(
        jax_params, reqs,
        TriagePolicy(conf_threshold=conf, mi_threshold=0.05, r_min=4,
                     r_max=20), fused, instance_from_tree(chip.to_tree()),
        head_t, hcfg_t)
    recs_t = {r.rid: r for r in eng_t.metrics.records}
    recs_j = {r.rid: r for r in eng_j.metrics.records}
    assert set(recs_t) == set(recs_j) == set(range(48))
    for rid, a in recs_j.items():
        b = recs_t[rid]
        assert (b.verdict, b.prediction, b.n_samples) == \
            (a.verdict, a.prediction, a.n_samples), rid
        np.testing.assert_allclose(b.confidence, a.confidence, atol=1e-5)
        np.testing.assert_allclose(b.mutual_information,
                                   a.mutual_information, atol=1e-5)
    assert eng_t.host_syncs == eng_j.host_syncs
    assert eng_t.admissions >= 2                 # 32 + 16 requests at least
    if conf < 0.7:
        assert len({r.n_samples for r in recs_t.values()}) >= 3


def test_serve_cli_prints_the_chip(capsys):
    from repro_torch.launch.serve import main, serve_sar
    main(["--arch", "sar_cnn", "--requests", "24", "--slots", "8",
          "--chip-instance", "11", "--chip-severity", "2.0",
          "--corrupt-frac", "0.25", "--device", "cpu"])
    lines = capsys.readouterr().out.strip().splitlines()
    chip = sample_instances(11, 1, VariationSpec().scaled(2.0))[0]
    assert len(lines) == 1 and lines[0].startswith("[sar] 24 decisions")
    assert (f"[chip seed=11 id=0 device_seed={chip.device_seed} "
            f"read_sigma={chip.read_sigma:.4f}") in lines[0]
    assert lines[0].endswith(" cal]")
    out = serve_sar(n_requests=24, n_slots=8, chip_instance=11,
                    calibrated=False, device="cpu")
    default_die = sample_instances(11, 1)[0]
    assert out["requests"] == 24 and out["calibrated"] is False
    assert (out["chip_id"], out["chip_device_seed"], out["chip_read_sigma"],
            out["chip_temp_c"]) == (0, default_die.device_seed,
                                    default_die.read_sigma,
                                    default_die.temp_c)
    assert out["admissions"] >= 3
