"""The training slice of the port against the JAX reference, at small
widths (channels (4, 8, 8), batch 8): inputs made with numpy from a
seed and bridged into both packages.

  * ``sample_weights_at``: ε within 1 float32 step of the reference's
    arithmetic (the reference divides by ``sum_std``, the ε kernel and
    its plain version multiply by float32(1/sum_std)), and within 2e-6
    of the reference's compiled draw (see the test); w within 1e-7;
  * ``fake_quant_ste``: the forward value bit for bit, the gradient the
    identity's; ``kl_divergence`` within rtol 1e-6;
  * ``train_loss``: the value within rtol 1e-6, its gradients (autograd
    against ``jax.value_and_grad``) within atol 1e-6 / rtol 1e-5;
  * ``adamw_update``: the new params within 1 float32 step, ``count``
    equal; ``warmup_cosine`` (gaps stated in the tests);
  * a 5-step trajectory of the whole training step: params within 1e-5;
  * ``trained_detector`` caches: restores bit-equal on its second call,
    draws each step's ε through the ε kernel's wrapper, writes nothing
    outside its ``ckpt_dir``, and raises where the card is asked for and
    absent;
  * the ``cim_execution`` trunk (``core/cim``): ``cim_matmul`` and the
    features against the reference's within 1e-4, ADC code flips counted
    and bounded (ROADMAP C9);
  * ``logit_samples_ideal`` (the paper's 'BNN' rows): per-logit sample
    mean and SD against µ·x and √(x²·σ²) within a stated band.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import bayes_layer as jb
from repro.core import cim as jcim
from repro.core import hashing as jhash
from repro.core import lfsr as jlfsr
from repro.core import quant as jq
from repro.models import sar_cnn as js
from repro.optim import adamw as ja
from repro.optim import schedules as jsch
from repro_torch.bridge import (opt_state_from_jax, opt_state_to_jax,
                                params_from_jax, params_to_jax)
from repro_torch.core import bayes_layer as tb
from repro_torch.core import cim as tcim
from repro_torch.core import quant as tq
from repro_torch.data.sard import SardConfig
from repro_torch.kernels import grng
from repro_torch.mission import detector
from repro_torch.models import sar_cnn as ts
from repro_torch.optim import adamw as ta
from repro_torch.optim import schedules as tsch
from repro_torch.utils.trees import leaves

NARROW = dict(channels=(4, 8, 8))
JCFG, TCFG = js.SarCnnConfig(**NARROW), ts.SarCnnConfig(**NARROW)
JOPT = ja.AdamWConfig(lr=1e-3, weight_decay=0.01)
STEPS = (0, 1, 799, 1599, 2**32 - 1)


def _ulps(a, b) -> np.ndarray:
    """Float32 steps between a and b, elementwise."""
    ia = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    ib = np.asarray(b, np.float32).view(np.int32).astype(np.int64)
    return np.abs(ia - ib)


@pytest.fixture(scope="module")
def jax_params():
    """The reference's narrow init, with ρ spread so that σ varies."""
    p = jax.device_get(js.init_sar_cnn(jax.random.PRNGKey(3), JCFG))
    rng = np.random.default_rng(0)
    p["head"]["rho"] = (p["head"]["rho"] + rng.normal(
        0, 0.3, p["head"]["rho"].shape)).astype(np.float32)
    return p


def _batch(seed: int, b: int = 8) -> dict:
    rng = np.random.default_rng(seed)
    return {"images": rng.standard_normal((b, 32, 32, 1)).astype(np.float32),
            "labels": rng.permutation(np.arange(b) % 2).astype(np.int32)}


def _unit_sigma_rho() -> np.float32:
    """A float32 ρ whose softplus is exactly 1.0 in both packages, so a
    draw w = 0 + σ·ε gives ε itself."""
    rho = np.float32(np.log(np.e - 1))
    for _ in range(64):
        if float(jax.nn.softplus(jnp.float32(rho))) == 1.0:
            return rho
        rho = np.nextafter(rho, np.float32(1))
    raise AssertionError("no float32 ρ with softplus(ρ) == 1")


def _reference_eps_eager(g, d_in: int, d_out: int, step: int):
    """The reference's ε at ``step`` as ``sample_weights_at`` writes it
    (the indexed selection, 16 currents summed in order, then
    ``(raw − sum_mean) / sum_std``), op by op with the reference's own
    functions, uncompiled."""
    sel = np.asarray(jlfsr.indexed_selections(
        g.lfsr_seed, jnp.asarray(step, jnp.uint32)))
    rows = jnp.arange(d_in, dtype=jnp.uint32)[:, None]
    cols = jnp.arange(d_out, dtype=jnp.uint32)[None, :]
    raw = jnp.zeros((d_in, d_out), jnp.float32)
    for j in range(16):
        h = jhash.hash3(rows, cols, jnp.uint32(j), g.seed)
        i_j = (g.i_lo + g.delta_i * jhash.uniform_bit(h)
               + g.gamma * jhash.gaussianish(h))
        raw = raw + sel[j] * i_j
    return np.asarray((raw - g.sum_mean) / g.sum_std)


@pytest.mark.parametrize("step", STEPS)
def test_sample_weights_at_matches_reference(jax_params, step):
    """ε within 1 float32 step of the reference's arithmetic (op by op;
    the kernel multiplies by float32(1/sum_std) where the reference
    divides).  The reference's own ``sample_weights_at`` compiles its
    scan, and XLA folds γ·((s − 382.5)·(1/127.99316)) into
    (s − 382.5)·(γ/127.99316), which moves a device current by a last
    bit and the raw sum (≈ 10) by up to one of its steps (9.5e-7): its
    ε, read with µ = 0 and σ = 1 exactly, is held to atol 2e-6 (measured
    up to 9.6e-7, 9 float32 steps where ε is small).  w = µ + σ·ε within
    1e-7 (σ ≤ 0.07 here)."""
    head_j = jax_params["head"]
    hcfg_j, hcfg_t = JCFG.head_cfg(), TCFG.head_cfg()
    eps_t = tb.eps_at(hcfg_t.grng, 8, 2, step, device="cpu").numpy()
    assert eps_t.shape == (8, 2)
    assert _ulps(eps_t, _reference_eps_eager(hcfg_j.grng, 8, 2,
                                             step)).max() <= 1
    rho = np.full(head_j["rho"].shape, _unit_sigma_rho(), np.float32)
    unit = {"mu": np.zeros_like(head_j["mu"]), "rho": rho}
    eps_j = np.asarray(jb.sample_weights_at(unit, hcfg_j, jnp.uint32(step)))
    np.testing.assert_allclose(eps_t, eps_j, rtol=0, atol=2e-6)
    assert np.array_equal(tb.sample_weights_at(
        params_from_jax({"convs": [], "head": unit})["head"], hcfg_t,
        step).numpy(), eps_t)
    want = np.asarray(jb.sample_weights_at(head_j, hcfg_j, jnp.uint32(step)))
    got = tb.sample_weights_at(params_from_jax(jax_params)["head"], hcfg_t,
                               step)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-7)


def test_eps_takes_the_ideal_draw_and_no_gradient(jax_params):
    """The reference's training draw has no read noise and no imprint:
    a die's GRNG config gives the ideal ε; µ and ρ get gradients, ε
    none."""
    cfg = tb.BayesDenseConfig(d_in=8, d_out=2)
    noisy = dataclasses.replace(cfg.grng, read_sigma=0.3, imprint=0.05)
    assert torch.equal(tb.eps_at(noisy, 8, 2, 7, device="cpu"),
                       tb.eps_at(cfg.grng, 8, 2, 7, device="cpu"))
    head = {k: v.requires_grad_() for k, v in
            params_from_jax(jax_params)["head"].items()}
    w = tb.sample_weights_at(head, cfg, 7)
    w.sum().backward()
    assert torch.equal(head["mu"].grad, torch.ones_like(head["mu"]))
    eps = tb.eps_at(cfg.grng, 8, 2, 7, device="cpu")
    sig = torch.sigmoid(head["rho"].detach())
    np.testing.assert_allclose(head["rho"].grad.numpy(), (eps * sig).numpy(),
                               rtol=1e-6, atol=1e-7)


def test_fake_quant_ste_forward_bits_and_identity_gradient():
    rng = np.random.default_rng(1)
    x = (rng.standard_normal((33, 7)) * 0.3).astype(np.float32)
    scale = jq.symmetric_scale(jnp.asarray(x), 8)
    want = np.asarray(jq.fake_quant_ste(jnp.asarray(x), scale, 8))
    xt = torch.tensor(x, requires_grad=True)
    got = tq.fake_quant_ste(xt, tq.symmetric_scale(xt.detach(), 8), 8)
    np.testing.assert_array_equal(got.detach().numpy(), want)
    c = rng.standard_normal(x.shape).astype(np.float32)
    (got * torch.as_tensor(c)).sum().backward()
    gj = jax.grad(lambda v: (jq.fake_quant_ste(v, scale, 8) * c).sum())(
        jnp.asarray(x))
    np.testing.assert_array_equal(xt.grad.numpy(), c)
    np.testing.assert_array_equal(np.asarray(gj), c)


def test_sample_weights_quantized_matches_reference(jax_params):
    """``sample_weights`` (stream sample 0, 8-bit STE quantizer on)."""
    qj = dataclasses.replace(JCFG.head_cfg(),
                             quant=jq.QuantConfig(enabled=True))
    qt = dataclasses.replace(TCFG.head_cfg(),
                             quant=tq.QuantConfig(enabled=True))
    want = np.asarray(jb.sample_weights(jax_params["head"], qj, 0))
    got = tb.sample_weights(params_from_jax(jax_params)["head"], qt, 0)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)


def test_kl_divergence_matches_reference(jax_params):
    want = float(jb.kl_divergence(jax_params["head"], JCFG.head_cfg()))
    got = float(tb.kl_divergence(params_from_jax(jax_params)["head"],
                                 TCFG.head_cfg()))
    assert got == pytest.approx(want, rel=1e-6)


def _grad_tree(params):
    return {"convs": [{k: v.detach().clone().requires_grad_()
                       for k, v in c.items()} for c in params["convs"]],
            "head": {k: v.detach().clone().requires_grad_()
                     for k, v in params["head"].items()}}


@pytest.mark.parametrize("bayesian", [True, False])
def test_train_loss_and_gradients_match_reference(bayesian):
    """The reference's loss and gradients under ``jax.jit``, as its
    trainer takes them."""
    jcfg = dataclasses.replace(JCFG, bayesian_head=bayesian)
    tcfg = dataclasses.replace(TCFG, bayesian_head=bayesian)
    jp = jax.device_get(js.init_sar_cnn(jax.random.PRNGKey(5), jcfg))
    batch = _batch(2)
    (loss_j, m_j), g_j = jax.jit(jax.value_and_grad(
        lambda p: js.train_loss(p, jax.tree.map(jnp.asarray, batch), jcfg,
                                jnp.int32(11)), has_aux=True))(
        jax.tree.map(jnp.asarray, jp))
    tp = _grad_tree(params_from_jax(jp))
    loss_t, m_t = ts.train_loss(tp, {k: torch.as_tensor(v)
                                     for k, v in batch.items()}, tcfg, 11)
    assert float(loss_t.detach()) == pytest.approx(float(loss_j), rel=1e-6)
    for k in ("ce", "kl", "acc"):
        assert float(m_t[k]) == pytest.approx(float(m_j[k]), rel=1e-6,
                                              abs=1e-7)
    loss_t.backward()
    got = params_to_jax(jax.tree.map(lambda p: p.grad, tp,
                                     is_leaf=torch.is_tensor))
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(jax.device_get(
            g_j))):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("count", [0, 36])
def test_adamw_update_matches_reference(jax_params, count):
    """Identical params, grads and state (moments from a seed), with the
    clip active (‖g‖ ≈ 15).  Each leaf's sum of squares is taken in
    another order than XLA's (and over another layout for the convs), so
    the global norm, and with it the clip scale, may differ in its last
    bit; the bias corrections are float32 powers b^count that the two
    packages' math libraries round to within a step of each other.  A
    last bit of g·scale moves m = b1·m + (1 − b1)·g by a fraction of a
    step of its terms (≈ 0.009 here: measured 2.3e-10) whatever m's own
    size, and the update m̂/√v̂ divides that by √v̂.  So the new params
    are held to rtol 2^-23 (one float32 step) and atol 1e-8, 1e-5 of
    the lr (measured up to 2.8e-9 where the update is ~1e-3), the
    moments to rtol 1e-6 / atol 1e-8 (measured 2.3e-10); ``count``
    exactly and the norm to rtol 1e-6."""
    rng = np.random.default_rng(count)

    def like(scale):
        return jax.tree.map(lambda p: (rng.standard_normal(p.shape)
                                       * scale).astype(np.float32),
                            jax_params)
    grads, mu, nu = like(0.5), like(0.01), like(1e-4)
    nu = jax.tree.map(np.abs, nu)
    state = {"mu": mu, "nu": nu, "count": np.int32(count)}
    jp, js_, jm = ja.adamw_update(
        jax.tree.map(jnp.asarray, jax_params), jax.tree.map(jnp.asarray,
                                                            grads),
        jax.tree.map(jnp.asarray, state), JOPT)
    tp, ts_, tm = ta.adamw_update(
        params_from_jax(jax_params), params_from_jax(grads),
        opt_state_from_jax(state), detector.OPT)
    assert int(ts_["count"]) == int(js_["count"]) == count + 1
    assert float(tm["grad_norm"]) == pytest.approx(float(jm["grad_norm"]),
                                                   rel=1e-6)
    for a, b in zip(jax.tree.leaves(params_to_jax(tp)),
                    jax.tree.leaves(jax.device_get(jp))):
        np.testing.assert_allclose(a, b, rtol=2.0**-23, atol=1e-8)
    back = opt_state_to_jax(ts_)
    for key in ("mu", "nu"):
        for a, b in zip(jax.tree.leaves(back[key]),
                        jax.tree.leaves(jax.device_get(js_[key]))):
            np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-8)


def test_opt_state_bridge_round_trip(jax_params):
    state = jax.device_get(ja.init_opt_state(jax_params))
    state["count"] = np.int32(9)
    back = opt_state_to_jax(opt_state_from_jax(state))
    assert back["count"] == 9 and back["count"].dtype == np.int32
    for key in ("mu", "nu"):
        for a, b in zip(jax.tree.leaves(back[key]),
                        jax.tree.leaves(state[key])):
            np.testing.assert_array_equal(a, b)
    fresh = ta.init_opt_state(params_from_jax(jax_params))
    assert fresh["count"].dtype == torch.int32
    assert all(not bool(x.any()) for x in leaves(fresh["mu"]))


def test_warmup_cosine_matches_reference():
    """Over steps 0…2999 (warmup 100, total 2500).  The warmup ramp and
    cos(π·progress) agree within 1 float32 step (the two packages' cos
    differ by at most one).  Once cos < 0, 1 + cos cancels, and one step
    of cos (up to 6e-8) becomes 0.45·6e-8 ≈ 2.7e-8 of a scale that falls
    to 0.1 (a step of 7.5e-9): the measured gap is 2 float32 steps at
    progress 0.8 and 4 near the end.  So the scale is held to 1 step
    while cos ≥ 0 (progress ≤ 0.5), and everywhere to the larger of 1
    step and 3e-8."""
    steps = np.arange(3000, dtype=np.int32)
    kw = dict(warmup_steps=100, total_steps=2500)
    want = np.asarray(jsch.warmup_cosine(jnp.asarray(steps), **kw))
    got = tsch.warmup_cosine(torch.as_tensor(steps), **kw).numpy()
    progress = np.clip((steps - 100) / 2400, 0, 1)
    assert _ulps(got, want)[progress <= 0.5].max() <= 1
    assert ((_ulps(got, want) <= 1) | (np.abs(got - want) <= 3e-8)).all()
    p = np.clip((steps.astype(np.float32) - 100) / np.float32(2400), 0, 1)
    cj = np.asarray(jnp.cos(jnp.pi * jnp.asarray(p, jnp.float32)))
    ct = torch.cos(np.pi * torch.as_tensor(p, dtype=torch.float32)).numpy()
    assert _ulps(ct, cj).max() <= 1
    assert float(tsch.warmup_cosine(50, **kw)) == float(
        jsch.warmup_cosine(50, **kw))


def test_five_step_trajectory_matches_reference():
    """The whole step (loss, autograd, AdamW) five times from the same
    params on the same snow-corrupted batches (the port's training
    batches, bridged): params within 1e-5 and the per-step ce within
    1e-5 of the reference's jitted step."""
    jp = js.init_sar_cnn(jax.random.PRNGKey(3), JCFG)
    tp = params_from_jax(jax.device_get(jp))
    jopt, topt = ja.init_opt_state(jp), ta.init_opt_state(tp)

    @jax.jit
    def step_fn(params, opt, batch, step):
        (_, m), g = jax.value_and_grad(
            lambda p: js.train_loss(p, batch, JCFG, step), has_aux=True)(
            params)
        params, opt, _ = ja.adamw_update(params, g, opt, JOPT)
        return params, opt, m

    dcfg = SardConfig(seed=detector.DATA_SEED)
    for s in range(5):
        b = detector.training_batch(dcfg, s, "snow", 0.5, batch=8)
        jp, jopt, mj = step_fn(jp, jopt, {"images": jnp.asarray(
            b["images"].numpy()), "labels": jnp.asarray(
            b["labels"].numpy().astype(np.int32))}, jnp.int32(s))
        tp, topt, mt = detector.train_step(tp, topt, b, TCFG, s)
        assert float(mt["ce"]) == pytest.approx(float(mj["ce"]), abs=1e-5)
    assert int(topt["count"]) == int(jopt["count"]) == 5
    for a, b in zip(jax.tree.leaves(params_to_jax(tp)),
                    jax.tree.leaves(jax.device_get(jp))):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-5)


def test_trained_detector_caches_in_its_dir(tmp_path, monkeypatch):
    """Three steps on the CPU into ``tmp_path``: each step draws its ε
    through the ε kernel's wrapper (its plain version here), the second
    call restores the params bit for bit, the training history is
    stored beside them, and nothing is written anywhere else (the
    working directory stays empty)."""
    cwd = tmp_path / "cwd"
    cwd.mkdir()
    monkeypatch.chdir(cwd)
    calls = []
    wrapper = grng.grng_eps
    monkeypatch.setattr(grng, "grng_eps",
                        lambda *a, **k: calls.append(k) or wrapper(*a, **k))
    ckpt = tmp_path / "ckpt"
    first, cfg = detector.trained_detector(TCFG, steps=3, ckpt_dir=ckpt,
                                           device="cpu")
    assert cfg == TCFG
    assert [c["sample0"] for c in calls] == [0, 1, 2]
    again, _ = detector.trained_detector(TCFG, steps=3, ckpt_dir=ckpt,
                                         device="cpu")
    assert len(calls) == 3                       # restored, not retrained
    for a, b in zip(leaves(first), leaves(again)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    from repro_torch.ckpt import restore
    tree, step = restore(ckpt)
    assert step == 3 and tree["history"]["ce"].shape == (3,)
    assert np.isfinite(tree["history"]["ce"]).all()
    assert sorted(p.name for p in tmp_path.iterdir()) == ["ckpt", "cwd"]
    assert list(cwd.iterdir()) == []
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        detector.trained_detector(TCFG, steps=3, ckpt_dir=tmp_path / "c2")
    assert not (tmp_path / "c2").exists()


# ----------------------------------------------------------------------
# Fig. 16's "this work" trunk and the 'BNN' ablation
# ----------------------------------------------------------------------
@pytest.mark.parametrize("shape", [(37, 150, 9)])
def test_cim_matmul_matches_reference(shape):
    """Bit for bit but for ADC code flips: the full scale is a mean over
    every partial sum taken in another order than XLA's, so it may
    differ in its last bit, and a partial sum on a half-code tie then
    lands one code away (counted: none at these shapes)."""
    b, k, n = shape
    rng = np.random.default_rng(k)
    x = np.maximum(rng.standard_normal((b, k)), 0).astype(np.float32)
    w = (rng.standard_normal((k, n)) * 0.1).astype(np.float32)
    qj, qt = jq.QuantConfig(), tq.QuantConfig()
    want = np.asarray(jcim.cim_matmul(jnp.asarray(x), jnp.asarray(w), qj))
    got = tcim.cim_matmul(torch.as_tensor(x), torch.as_tensor(w), qt).numpy()
    assert int((np.abs(got - want) > 1e-4).sum()) == 0
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    dense = tcim.cim_dense(torch.as_tensor(x), torch.as_tensor(w),
                           torch.ones(n), qt).numpy()
    np.testing.assert_allclose(dense, got + 1, rtol=1e-6)
    snr_j = float(jcim.adc_snr_db(jnp.asarray(x), jnp.asarray(w), qj))
    snr_t = float(tcim.adc_snr_db(torch.as_tensor(x), torch.as_tensor(w),
                                  qt))
    assert snr_t == pytest.approx(snr_j, abs=1e-3)


def test_cim_execution_features_match_reference():
    """``features`` with ``cim_execution=True`` at the published widths
    on 8 images, layer by layer (each fed the reference's input) and end
    to end.  ADC code flips (see above) are counted: at most 1e-3 of a
    layer's outputs, each at most a code; every other output within
    1e-4, and the features within 1e-4 when no code flipped.  The
    reference's layers run under ``jax.jit`` (eager dispatch compiles
    each op apart and takes ~10 s here)."""
    jcfg = js.SarCnnConfig(cim_execution=True)
    tcfg = ts.SarCnnConfig(cim_execution=True)
    jp = jax.device_get(js.init_sar_cnn(jax.random.PRNGKey(3), jcfg))
    tp = params_from_jax(jp)
    imgs = _batch(4)["images"]
    h = jnp.asarray(imgs)
    flips = outputs = 0
    conv = jax.jit(lambda x, w, b: js._conv(x, w, b, jcfg))
    for layer, tlayer in zip(jp["convs"], tp["convs"]):
        want = np.asarray(conv(h, layer["w"], layer["b"]))
        got = ts._cim_exec_conv(torch.as_tensor(np.asarray(h)), tlayer,
                                tcfg).numpy()
        off = np.abs(got - want) > 1e-4
        flips += int(off.sum())
        outputs += got.size
        assert off.sum() <= 1e-3 * got.size
        np.testing.assert_allclose(got[~off], want[~off], rtol=1e-4,
                                   atol=1e-4)
        h = jnp.asarray(want)
    want = np.asarray(h).mean(axis=(1, 2))   # the reference's features
    got = ts.features(tp, torch.as_tensor(imgs), tcfg).numpy()
    assert got.shape == (8, 64)
    np.testing.assert_allclose(got, want, rtol=1e-4,
                               atol=1e-4 if flips == 0 else 1e-2,
                               err_msg=f"{flips} of {outputs} codes flipped")
    # the float trunk differs: the CIM path quantizes
    assert not np.allclose(got, ts.features(tp, torch.as_tensor(imgs),
                                            TCFG.__class__()).numpy(),
                           atol=1e-4)


def test_logit_samples_ideal_statistics(jax_params):
    """R = 4000 ideal-Gaussian draws of the head on 8 images: per logit
    the sample mean within 5 standard errors of µ·x (σ_m = s/√R) and the
    sample SD within 10 % of √(x²·σ²) (its standard error is ~1.1 % at
    this R); the reference's draw (``jax.random``) meets the same band.
    The samples are [R, B, C] on the params' device."""
    r = 4000
    imgs = _batch(6)["images"]
    tp = params_from_jax(jax_params)
    gen = torch.Generator().manual_seed(11)
    s = ts.logit_samples_ideal(tp, torch.as_tensor(imgs), TCFG, r, gen)
    assert s.shape == (r, 8, 2)
    feats = ts.features(tp, torch.as_tensor(imgs), TCFG).double()
    mu = tp["head"]["mu"].double()
    sigma = tb.sigma_of(tp["head"]).double()
    mean_want = feats @ mu
    sd_want = torch.sqrt(feats**2 @ sigma**2)
    for samples in (s.double(), torch.as_tensor(np.asarray(
            js.logit_samples_ideal(jax_params, jnp.asarray(imgs), JCFG, r,
                                   jax.random.PRNGKey(11)))).double()):
        sd = samples.std(0)
        assert ((samples.mean(0) - mean_want).abs()
                <= 5 * sd / np.sqrt(r)).all()
        assert ((sd / sd_want - 1).abs() <= 0.10).all()
    again = ts.logit_samples_ideal(tp, torch.as_tensor(imgs), TCFG, r,
                                   torch.Generator().manual_seed(11))
    assert torch.equal(again, s)
