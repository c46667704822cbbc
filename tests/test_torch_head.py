"""The sampled-head slice of the port against the JAX reference: the
GRNG ε block, the fused Bayesian head in both modes, fixed-R sampling of
the SAR model and the UQ report (the paper's Fig. 16 path), and Fig. 9's
calibration.  Inputs are made with numpy from a seed and handed to both;
the reference's Pallas kernels run in interpret mode.

  * ``grng_eps``: the port's plain version against ``ops.grng_eps
    (interpret=True)`` at (200, 130) and (1, 1), R = 8, with row, column
    and sample offsets, read noise 0.5 and imprint 0.37: atol 1e-5
    (``tests/test_kernels.py:26``; the 16-term sum and the reciprocal
    match, XLA's fusion may round a last bit otherwise);
  * ``bayes_head_mvm`` rank16 and paper at (3, 130, 70) and (8, 256,
    192): 1e-4 in float32, 2e-2 in bfloat16 (the reference's tolerances;
    both read bf16 as float32); the ADC paper path at (4, 128, 128),
    R = 3: 1e-4; rank16 with read noise draw for draw against
    ``ref.bayes_mvm_rank16_ref`` at sample0 0 and 7: 1e-4; the two modes
    agree to 1e-4 without read noise;
  * ``logit_samples_serve`` (R = 20, both modes, and the deterministic
    head) on bridged ``init_sar_cnn(PRNGKey(3))`` params and one of
    Fig. 16's 64-image test batches: 1e-5; ``uq_report`` and
    ``deterministic_report`` on the same samples: 1e-5;
  * a die's head (``prepare_instance_head`` on ``sample_instances(13, 1,
    VariationSpec().scaled(s))``): paper draw for draw against the
    reference (1e-5), and paper against rank16 in distribution at
    R = 400 as ``tests/test_hw_conformance.py:229-256`` holds it;
  * Fig. 9: ``calibrate`` (rtol 1e-6: a mean and an SD over 262,144
    sums reduced in another order) and ``distribution_sample`` (atol
    1e-6).
The kernels never run here: every launch count stays 0.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import clt_grng as jg
from repro.core import uncertainty as ju
from repro.core.quant import QuantConfig as JQuant
from repro.core.sampling import BayesHeadConfig as JHeadCfg
from repro.core.sampling import logit_samples_paper as j_paper
from repro.data.sard import SardConfig as JSard
from repro.data.sard import batch_at as j_batch_at
from repro.hw import VariationSpec as JVariationSpec
from repro.hw import prepare_instance_head as j_prepare
from repro.hw import sample_instances as j_sample
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models.sar_cnn import SarCnnConfig as JCfg
from repro.models.sar_cnn import init_sar_cnn as j_init
from repro.models.sar_cnn import logit_samples_serve as j_serve
from repro_torch.bridge import head_from_jax, params_from_jax, to_numpy
from repro_torch.core import clt_grng as tg
from repro_torch.core import uncertainty as tu
from repro_torch.core.quant import QuantConfig
from repro_torch.core.sampling import (BayesHeadConfig, logit_samples,
                                       logit_samples_paper,
                                       logit_samples_rank16)
from repro_torch.hw import (VariationSpec, prepare_instance_head,
                            sample_instances)
from repro_torch.kernels import bayes, grng, ops
from repro_torch.models.sar_cnn import SarCnnConfig, logit_samples_serve


def _port_grng(cfg: jg.GRNGConfig) -> tg.GRNGConfig:
    return tg.GRNGConfig(**{f.name: getattr(cfg, f.name)
                            for f in dataclasses.fields(cfg)})


def _head_arrays(b, k, n, seed, sigma_scale=0.1):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, k)).astype(np.float32)
    mu = (rng.standard_normal((k, n)) * 0.05).astype(np.float32)
    sigma = (np.log1p(np.exp(rng.standard_normal((k, n)) - 2.0))
             * sigma_scale).astype(np.float32)
    return x, mu, sigma


def _both(arrays, dtype):
    """The same arrays for the reference and the port, in ``dtype``
    ('float32' or 'bfloat16'; both round to nearest even)."""
    jd = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    td = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    return ([jnp.asarray(a).astype(jd) for a in arrays],
            [torch.as_tensor(a).to(td) for a in arrays])


@pytest.fixture(autouse=True)
def no_kernel_launches():
    """Every wrapper here sees CPU tensors: no kernel may launch."""
    counters = (grng.grng_eps, bayes.bayes_rank16, bayes.bayes_paper)
    before = [c.launches for c in counters]
    yield
    assert [c.launches for c in counters] == before


# ----------------------------------------------------------------------
# the GRNG ε block
# ----------------------------------------------------------------------
@pytest.mark.parametrize("case", [
    dict(shape=(200, 130), r=8, row0=0, col0=0, sample0=0, noisy=False),
    dict(shape=(200, 130), r=8, row0=16, col0=40, sample0=5, noisy=True),
    dict(shape=(1, 1), r=8, row0=3, col0=9, sample0=11, noisy=True),
], ids=["ideal", "die_offsets", "one_cell"])
def test_grng_eps_matches_reference(case):
    jcfg = jg.GRNGConfig()
    if case["noisy"]:
        jcfg = dataclasses.replace(jcfg, read_sigma=0.5, imprint=0.37)
    k, n = case["shape"]
    kw = dict(sample0=case["sample0"], row0=case["row0"], col0=case["col0"])
    want = np.asarray(jops.grng_eps(jcfg, k, n, case["r"], interpret=True,
                                    **kw))
    got = to_numpy(ops.grng_eps(_port_grng(jcfg), k, n, case["r"],
                                device="cpu", **kw))
    assert got.shape == (case["r"], k, n)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_grng_eps_extends_the_stream():
    cfg = tg.GRNGConfig(read_sigma=0.4)
    whole = ops.grng_eps(cfg, 32, 48, 6, device="cpu")
    tail = ops.grng_eps(cfg, 32, 48, 2, sample0=4, device="cpu")
    assert torch.equal(whole[4:], tail)


# ----------------------------------------------------------------------
# the fused Bayesian head
# ----------------------------------------------------------------------
@pytest.mark.parametrize("shape", [(3, 130, 70), (8, 256, 192)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mode", ["rank16", "paper"])
def test_bayes_head_mvm_matches_reference(shape, dtype, mode):
    (jx, jmu, jsg), (tx, tmu, tsg) = _both(_head_arrays(*shape, seed=0),
                                           dtype)
    cfg = jg.GRNGConfig()
    want = np.asarray(jops.bayes_head_mvm(jx, jmu, jsg, cfg, 5, mode=mode,
                                          interpret=True))
    got = to_numpy(ops.bayes_head_mvm(tx, tmu, tsg, _port_grng(cfg), 5,
                                      mode=mode))
    tol = 2e-2 if dtype == "bfloat16" else 1e-4
    assert got.shape == (5, shape[0], shape[2])
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol)


def test_adc_paper_path_matches_reference():
    (jx, jmu, jsg), (tx, tmu, tsg) = _both(_head_arrays(4, 128, 128, seed=2),
                                           "float32")
    cfg = jg.GRNGConfig()
    want = np.asarray(jops.bayes_head_mvm(jx, jmu, jsg, cfg, 3, mode="paper",
                                          qcfg=JQuant(enabled=True),
                                          interpret=True))
    oracle = np.asarray(jref.bayes_mvm_adc_ref(jx, jmu, jsg, cfg,
                                               JQuant(enabled=True), 3))
    got = to_numpy(ops.bayes_head_mvm(tx, tmu, tsg, _port_grng(cfg), 3,
                                      mode="paper",
                                      qcfg=QuantConfig(enabled=True)))
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got, oracle, rtol=1e-4, atol=1e-4)
    with pytest.raises(AssertionError, match="hardware sample order"):
        ops.bayes_head_mvm(tx, tmu, tsg, _port_grng(cfg), 3, mode="rank16",
                           qcfg=QuantConfig(enabled=True))


@pytest.mark.parametrize("sample0", [0, 7])
def test_rank16_read_noise_draw_for_draw(sample0):
    (jx, jmu, jsg), (tx, tmu, tsg) = _both(
        _head_arrays(4, 40, 10, seed=3, sigma_scale=0.2), "float32")
    cfg = dataclasses.replace(jg.GRNGConfig(), read_sigma=0.5)
    want = np.asarray(jref.bayes_mvm_rank16_ref(jx, jmu, jsg, cfg, 6,
                                                sample0=sample0))
    got = ops.bayes_head_mvm(tx, tmu, tsg, _port_grng(cfg), 6,
                             sample0=sample0, mode="rank16")
    np.testing.assert_allclose(to_numpy(got), want, rtol=1e-4, atol=1e-4)
    # the engine's fast path (mix_samples) draws the same noise
    hcfg = BayesHeadConfig(num_samples=6, grng=_port_grng(cfg),
                           compute_dtype=torch.float32)
    mix = logit_samples_rank16({"mu_prime": tmu, "sigma": tsg}, tx, hcfg,
                               sample0=sample0)
    torch.testing.assert_close(got, mix, rtol=1e-4, atol=1e-4)


def test_modes_agree_without_read_noise():
    _, (tx, tmu, tsg) = _both(_head_arrays(4, 128, 128, seed=1), "float32")
    cfg = tg.GRNGConfig()
    a = ops.bayes_head_mvm(tx, tmu, tsg, cfg, 7, mode="rank16")
    p = ops.bayes_head_mvm(tx, tmu, tsg, cfg, 7, mode="paper")
    torch.testing.assert_close(a, p, rtol=1e-4, atol=1e-4)


# ----------------------------------------------------------------------
# sampled inference of the SAR model and the UQ report (Fig. 16)
# ----------------------------------------------------------------------
@pytest.fixture(scope="module")
def fig16_batch():
    data = j_batch_at(JSard(image_size=32, seed=7), 10_000, 64)
    return np.array(data["images"]), np.array(data["labels"])


def _close_reports(got: dict, want: dict, atol=1e-5):
    assert set(got) == set(want)
    for key in want:
        np.testing.assert_allclose(float(got[key]), float(want[key]),
                                   rtol=0, atol=atol, err_msg=key)


@pytest.mark.parametrize("mode", ["rank16", "paper"])
def test_logit_samples_serve_and_uq_report(mode, fig16_batch):
    images, labels = fig16_batch
    jparams = j_init(jax.random.PRNGKey(3), JCfg())
    want = np.array(j_serve(jparams, images, JCfg(), 20, mode=mode))
    params = params_from_jax(jax.device_get(jparams))
    got = to_numpy(logit_samples_serve(params, torch.tensor(images),
                                       SarCnnConfig(), 20, mode=mode))
    assert got.shape == (20, 64, 2)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    _close_reports(tu.uq_report(torch.as_tensor(want),
                                torch.as_tensor(labels)),
                   ju.uq_report(jnp.asarray(want), jnp.asarray(labels)))
    stats_t = tu.predictive_stats(torch.as_tensor(want))
    stats_j = ju.predictive_stats(jnp.asarray(want))
    for key in stats_j:
        np.testing.assert_allclose(to_numpy(stats_t[key]),
                                   np.asarray(stats_j[key]), rtol=0,
                                   atol=1e-5, err_msg=key)


def test_deterministic_head_and_report(fig16_batch):
    images, labels = fig16_batch
    jcfg = JCfg(bayesian_head=False)
    jparams = j_init(jax.random.PRNGKey(3), jcfg)
    want = np.array(j_serve(jparams, images, jcfg, 1))
    got = to_numpy(logit_samples_serve(
        params_from_jax(jax.device_get(jparams)), torch.as_tensor(images),
        SarCnnConfig(bayesian_head=False), 1))
    assert got.shape == want.shape == (1, 64, 2)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    _close_reports(tu.deterministic_report(torch.as_tensor(want[0]),
                                           torch.as_tensor(labels)),
                   ju.deterministic_report(jnp.asarray(want[0]),
                                           jnp.asarray(labels)))


def test_uq_metrics_on_ties_and_shift():
    """Coarse logits give tied confidences, where the rank order of the
    risk curve and the adaptive bins must follow the reference's stable
    sort."""
    rng = np.random.default_rng(4)
    samples = np.round(rng.standard_normal((20, 97, 3)) * 2) / 2
    labels = rng.integers(0, 3, 97)
    _close_reports(
        tu.uq_report(torch.as_tensor(samples, dtype=torch.float32),
                     torch.as_tensor(labels), n_bins=7),
        ju.uq_report(jnp.asarray(samples, jnp.float32), jnp.asarray(labels),
                     n_bins=7))


# ----------------------------------------------------------------------
# a die's head: paper draw for draw, paper vs rank16 in distribution
# ----------------------------------------------------------------------
def _ks_statistic(a, b) -> float:
    a = np.sort(np.asarray(a, np.float64).ravel())
    b = np.sort(np.asarray(b, np.float64).ravel())
    grid = np.concatenate([a, b])
    cdf_a = np.searchsorted(a, grid, side="right") / a.size
    cdf_b = np.searchsorted(b, grid, side="right") / b.size
    return float(np.abs(cdf_a - cdf_b).max())


def _ks_threshold(n: int, m: int, alpha: float = 1e-3) -> float:
    return np.sqrt(-0.5 * np.log(alpha / 2.0)) * np.sqrt((n + m) / (n * m))


def _standardized(samples) -> np.ndarray:
    s = np.asarray(samples, np.float64)
    sd = np.maximum(s.std(axis=0, keepdims=True), 1e-12)
    return ((s - s.mean(axis=0, keepdims=True)) / sd).ravel()


def test_die_head_paper_matches_reference():
    x, mu, sg = _head_arrays(4, 48, 6, seed=5, sigma_scale=0.2)
    jcfg = JHeadCfg(num_samples=12, mode="paper", compute_dtype=jnp.float32)
    jdie = j_sample(13, 1, JVariationSpec().scaled(2.5))[0]
    jhead, jscfg = j_prepare(jnp.asarray(mu), jnp.asarray(sg), jcfg, jdie)
    assert jscfg.grng.read_sigma > 0
    want = np.asarray(j_paper(jhead, jnp.asarray(x), jscfg, 12, sample0=3))
    head = head_from_jax(jax.device_get(jhead))
    scfg = BayesHeadConfig(num_samples=12, mode="paper",
                           grng=_port_grng(jscfg.grng),
                           compute_dtype=torch.float32)
    tx = torch.as_tensor(x)
    np.testing.assert_allclose(
        to_numpy(logit_samples_paper(head, tx, scfg, 12, sample0=3)), want,
        rtol=0, atol=1e-5)
    np.testing.assert_allclose(
        to_numpy(logit_samples(head, tx, scfg, 12, sample0=3)), want,
        rtol=0, atol=1e-5)


@pytest.mark.parametrize("severity", [1.0, 2.5])
def test_die_head_modes_agree_in_distribution(severity):
    x, mu, sg = (torch.as_tensor(a) for a in
                 _head_arrays(4, 48, 6, seed=0, sigma_scale=0.2))
    die = sample_instances(13, 1, VariationSpec().scaled(severity))[0]
    cfg = BayesHeadConfig(num_samples=400, mode="rank16",
                          compute_dtype=torch.float32)
    head, scfg = prepare_instance_head(mu, sg, cfg, die, calibrated=True)
    assert scfg.grng.read_sigma > 0
    paper = to_numpy(logit_samples_paper(head, x, scfg, 400))
    mix = to_numpy(logit_samples_rank16(head, x, scfg, 400))
    kern = to_numpy(ops.bayes_head_mvm(x, head["mu_prime"], head["sigma"],
                                       scfg.grng, 400, mode="rank16"))
    np.testing.assert_allclose(kern, mix, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(paper.mean(0), mix.mean(0), atol=0.05)
    np.testing.assert_allclose(paper.std(0), mix.std(0), rtol=0.15,
                               atol=0.02)
    crit = _ks_threshold(paper.size, mix.size)
    for other in (mix, kern):
        assert _ks_statistic(_standardized(paper),
                             _standardized(other)) < crit


# ----------------------------------------------------------------------
# Fig. 9: calibration and the ε distribution sample
# ----------------------------------------------------------------------
def test_fig9_calibrate_and_distribution_sample():
    jcfg = jg.GRNGConfig()
    cfg = _port_grng(jcfg)
    mean, std = tg.calibrate(cfg, 4096, 64, device="cpu")
    jmean, jstd = jg.calibrate(jcfg, 4096, 64)
    np.testing.assert_allclose(float(mean), float(jmean), rtol=1e-6)
    np.testing.assert_allclose(float(std), float(jstd), rtol=1e-6)
    got = tg.distribution_sample(cfg, 8192, 32, device="cpu")
    want = jg.distribution_sample(jcfg, 8192, 32)
    assert got.shape == want.shape == (8192 * 32,)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
