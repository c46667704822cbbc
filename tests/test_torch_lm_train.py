"""The LM training losses of the port against the JAX reference, on the
CPU (SMOKE sizes).

Inputs are numpy arrays from a seed; params are the reference's
``init`` draws carried over by ``bridge.lm_params_from_jax``.  One
reference function is compiled per case.

  * ``blocks.rms_norm``'s custom backward in bfloat16: dx and dscale
    equal element for element to the reference's ``custom_vjp`` run op
    by op (plain autograd of the forward would round dx differently);
    ``causal_cross_entropy`` over a padded vocabulary, value and
    gradient.
  * ``get_api(cfg).train_loss`` and every gradient leaf for the dense,
    MoE (two configs), audio and VLM SMOKE configs and
    ``train_loss_ssm`` for mamba2 and zamba2, at stream offset 5 over
    32 tokens (two SSD chunks).  Float32: the loss within F32_LOSS_REL,
    each leaf within F32_GRAD_REL of its largest entry (the float
    order of sums and of ε's standardization, one float32 step: see
    ``core/bayes_layer.eps_at``).  bfloat16: the loss within
    BF16_LOSS_REL and each leaf's error norm within BF16_GRAD_REL of its
    norm: the reference runs jitted, and XLA keeps some bf16
    intermediates of a fused chain in float32 where the port rounds
    every operation (its rms_norm backward differs from its own op-by-op
    run in ~4 % of elements under jit), so the two differ by bf16
    steps, which add up over the layers and the backward (measured:
    loss ≤ 3.5e-4, leaves ≤ 2.7e-2).
  * every gradient finite at a full SSD chunk of 256 (ROADMAP C30: the
    reference's masked exp overflows there and its gradients are NaN).
  * remat ``full``, ``dots`` and ``none``: the same loss and gradients
    bit for bit (float32).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.models import blocks as jb
from repro.models.registry import get_api as jget_api
from repro_torch.bridge import lm_params_from_jax
from repro_torch.configs import get_config
from repro_torch.launch.steps import loss_and_grads
from repro_torch.models import blocks as tb
from repro_torch.models.registry import get_api
from repro_torch.utils.trees import leaves

F32_LOSS_REL = 1e-5
F32_GRAD_REL = 1e-4
BF16_LOSS_REL = 1e-3
BF16_GRAD_REL = 0.05
STEP = 5
ARCHS = ("qwen3-0.6b", "mixtral-8x7b", "qwen3-moe-235b-a22b",
         "whisper-medium", "llama-3.2-vision-11b", "mamba2-130m",
         "zamba2-2.7b")


def _cfgs(arch: str, dtype: str, **kw):
    jc = dataclasses.replace(jget_config(arch, smoke=True), **kw)
    tc = dataclasses.replace(get_config(arch, smoke=True), **kw)
    if dtype == "f32":
        jc = dataclasses.replace(jc, dtype=jnp.float32)
        tc = dataclasses.replace(tc, dtype=torch.float32)
    return jc, tc


def _batch(cfg, b: int = 2, s: int = 32, seed: int = 0) -> dict:
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, cfg.vocab, (b, s), dtype=np.int32),
           "labels": rng.integers(0, cfg.vocab, (b, s), dtype=np.int32)}
    if cfg.family == "audio":
        out["frames"] = rng.standard_normal(
            (b, cfg.n_frames, cfg.d_model)).astype(np.float32)
    if cfg.family == "vlm":
        out["image_embeds"] = rng.standard_normal(
            (b, cfg.n_image_tokens, cfg.d_model)).astype(np.float32)
    return out


_INITS: dict = {}


def _reference_params(jc):
    """The reference's init at PRNGKey(0), once per config (the init
    does not depend on the compute dtype)."""
    key = dataclasses.replace(jc, dtype=jnp.float32)
    if key not in _INITS:
        _INITS[key] = jget_api(jc).init(jax.random.PRNGKey(0), jc)
    return _INITS[key]


def _reference(jc, batch: dict, step: int = STEP):
    api = jget_api(jc)
    jp = _reference_params(jc)
    fn = jax.jit(jax.value_and_grad(
        lambda p, b: api.train_loss(p, b, jc, step=step), has_aux=True))
    (loss, metrics), grads = fn(jp, {k: jnp.asarray(v)
                                     for k, v in batch.items()})
    return jp, float(loss), {k: float(v) for k, v in metrics.items()}, [
        np.asarray(jnp.asarray(g, jnp.float32))
        for g in jax.tree_util.tree_leaves(grads)]


def _f32(t: torch.Tensor) -> np.ndarray:
    return t.detach().to(torch.float32).numpy()


# ----------------------------------------------------------------------
# blocks
# ----------------------------------------------------------------------
def test_rms_norm_backward_bf16_equals_reference():
    rng = np.random.default_rng(0)
    x = jnp.asarray(rng.standard_normal((3, 7, 64)), jnp.bfloat16)
    g = jnp.asarray(rng.standard_normal((3, 7, 64)), jnp.bfloat16)
    s = (1 + 0.2 * rng.standard_normal(64)).astype(np.float32)
    y, vjp = jax.vjp(lambda a, b: jb.rms_norm(a, b), x, jnp.asarray(s))
    dx, ds = vjp(g)

    def port(x_):
        xt = torch.tensor(np.asarray(x_.astype(jnp.float32))).to(
            torch.bfloat16).requires_grad_()
        st = torch.tensor(s).requires_grad_()
        gt = torch.tensor(np.asarray(g.astype(jnp.float32))).to(
            torch.bfloat16)
        return xt, st, gt
    xt, st, gt = port(x)
    yt = tb.rms_norm(xt, st)
    dxt, dst = torch.autograd.grad(yt, (xt, st), gt)
    assert dxt.dtype == torch.bfloat16 and dst.dtype == torch.float32
    np.testing.assert_array_equal(_f32(yt), np.asarray(y, np.float32))
    np.testing.assert_array_equal(_f32(dxt), np.asarray(dx, np.float32))
    np.testing.assert_array_equal(_f32(dst), np.asarray(ds))
    # autograd of the forward alone widens the cotangent to float32
    xp, sp, _ = port(x)
    var = xp.to(torch.float32).square().mean(-1, keepdim=True)
    yp = xp * torch.rsqrt(var + 1e-6).to(xp.dtype) * sp.to(xp.dtype)
    dxp, = torch.autograd.grad(yp, (xp,), gt)
    assert (_f32(dxp) != np.asarray(dx, np.float32)).any()


def test_causal_cross_entropy_padded_vocabulary():
    rng = np.random.default_rng(1)
    logits = (3 * rng.standard_normal((2, 7, 80))).astype(np.float32)
    labels = rng.integers(0, 70, (2, 7), dtype=np.int32)
    want, jgrad = jax.value_and_grad(
        lambda z: jb.causal_cross_entropy(z, jnp.asarray(labels), 70))(
        jnp.asarray(logits))
    lt = torch.tensor(logits, requires_grad=True)
    got = tb.causal_cross_entropy(lt, torch.tensor(labels), 70)
    grad, = torch.autograd.grad(got, (lt,))
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-6)
    np.testing.assert_allclose(grad.numpy(), np.asarray(jgrad), atol=1e-7)
    assert (grad[..., 70:] == 0).all()


# ----------------------------------------------------------------------
# train_loss and every gradient, every family
# ----------------------------------------------------------------------
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_train_loss_and_gradients_match_reference(arch, dtype):
    jc, tc = _cfgs(arch, dtype)
    batch = _batch(jc)
    jp, want, jm, jgrads = _reference(jc, batch)
    params = lm_params_from_jax(jax.device_get(jp))
    loss, metrics, grads = loss_and_grads(
        tc, params, {k: torch.tensor(v) for k, v in batch.items()}, STEP)
    assert get_api(tc).train_loss is not None
    tgrads = [_f32(g) for g in leaves(grads)]
    assert len(tgrads) == len(jgrads)
    assert all(np.isfinite(g).all() for g in tgrads)
    rel = abs(float(loss) - want) / abs(want)
    for k in ("ce", "kl", "aux"):
        np.testing.assert_allclose(
            float(metrics[k]), jm[k], atol=1e-6,
            rtol=F32_GRAD_REL if dtype == "f32" else BF16_LOSS_REL)
    if dtype == "f32":
        assert rel <= F32_LOSS_REL, rel
        for want_g, got_g in zip(jgrads, tgrads):
            err = np.abs(want_g - got_g).max()
            assert err <= F32_GRAD_REL * max(np.abs(want_g).max(), 1e-30)
    else:
        assert rel <= BF16_LOSS_REL, rel
        for want_g, got_g in zip(jgrads, tgrads):
            err = np.linalg.norm(want_g - got_g)
            assert err <= BF16_GRAD_REL * max(np.linalg.norm(want_g), 1e-30)
    if tc.n_experts:                       # through the router and its aux
        router = _f32(grads["blocks"]["moe"]["router"])
        assert np.abs(router).max() > 0


def test_gradients_finite_at_a_full_ssd_chunk():
    """mamba2 SMOKE widths at the published chunk of 256 over 256
    tokens: the port's gradients are finite; the reference's are not
    (its ``_segsum_exp`` takes exp before the mask, ROADMAP C30)."""
    jc, tc = _cfgs("mamba2-130m", "f32", ssm_chunk=256)
    batch = _batch(jc, b=1, s=256)
    _, want, _, jgrads = _reference(jc, batch)
    assert not all(np.isfinite(g).all() for g in jgrads)
    loss, _, grads = loss_and_grads(
        tc, lm_params_from_jax(jax.device_get(_reference_params(jc))),
        {k: torch.tensor(v) for k, v in batch.items()}, STEP)
    assert abs(float(loss) - want) <= F32_LOSS_REL * abs(want)
    assert all(torch.isfinite(g).all() for g in leaves(grads))


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "mixtral-8x7b",
                                  "whisper-medium", "llama-3.2-vision-11b",
                                  "zamba2-2.7b"])
def test_remat_policies_change_no_bit(arch):
    runs = []
    for remat in ("none", "full", "dots"):
        _, tc = _cfgs(arch, "f32", remat=remat)
        params = get_api(tc).init(torch.Generator().manual_seed(0), tc)
        batch = {k: torch.tensor(v) for k, v in _batch(tc).items()}
        runs.append(loss_and_grads(tc, params, batch, STEP))
    (loss0, _, g0), *rest = runs
    for loss, _, g in rest:
        assert torch.equal(loss, loss0)
        assert all(torch.equal(a, b) for a, b in zip(leaves(g), leaves(g0)))
