"""The dense LM slice of the port against the JAX reference, on the CPU.

Inputs are numpy arrays from a seed; params are the reference's
``init_transformer`` draws carried over by ``bridge.lm_params_from_jax``.

  * blocks and attention: ``rms_norm``, ``apply_rope``, ``swiglu``
    (float32 to 1e-6, bfloat16 to the reference's bf16 bound below);
    the activations in bfloat16 element by element: ``silu``, ``gelu``
    and the MLPs and MoE experts built on them round each step as
    ``jax.nn.silu``/``jax.nn.gelu(approximate=True)`` do, so at most
    ACT_FRACTION of their elements differ, each by one bf16 step;
    ``chunked_attention`` (causal, padding, ``kv_start``, ``window``,
    chunk sizes that do not divide S; float32 to 1e-5) and
    ``decode_attention`` with ``start``.
  * the trunk: ``prefill`` (cache k/v, ``pos``, ``start``, last hidden)
    and three ``decode_hidden`` steps for each of the four dense SMOKE
    configs, in float32 to F32_REL (max error over max magnitude; only
    the summation order differs) and in bfloat16 to BF16_REL = 0.05
    (the reference's own bound, ``tests/test_serving.py``); the
    Bayesian head's ``decode_step`` logits the same way.
  * admission: the port's own ``test_lm_admission_alignment_is_faithful``
    and ``align_scatter`` against the reference's jitted one.
  * ``LMServingEngine`` against the reference's on bridged params and
    the same prompts in float32: 3 requests on 2 slots (the third
    admitted mid-stream) under accept-always, default, escalating and
    fixed-R policies, through the decision kernel's plain version and
    through ``mix_samples`` + ``update_stats``: verdicts, tokens,
    samples and decisions equal request for request, confidence and MI
    within 1e-5 (ROADMAP C6), telemetry counters equal.  Both engines
    start from the free list [1, 0], under which the reference's first
    admission puts each request's cache in its own slot (ROADMAP C20:
    under its default order it does not; the port scatters the rows
    into their slots whatever the order, tested on its own).
  * ``serve()``'s summary and the CLI (whisper-medium's SMOKE config
    among the archs); ``data/tokens``' bigram and its purity in (seed,
    step); the ``lm_params`` bridge; the audio and VLM families taken
    by the registry (``train_loss`` raising, naming ROADMAP A14);
    importing every module of the port loads neither jax nor the
    reference.
"""

import dataclasses
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.models import attention as jattn
from repro.models import blocks as jblocks
from repro.models import moe as jmoe
from repro.models import transformer as jtr
from repro.serving import LMServingEngine as JEngine
from repro.serving import Request as JRequest
from repro.serving import TriagePolicy as JPolicy
from repro.serving.engine import _rotate_k as j_rotate_k
from repro_torch.bridge import lm_params_from_jax, lm_params_to_jax
from repro_torch.configs import ARCHS, get_config
from repro_torch.data import tokens as ttok
from repro_torch.models import attention as tattn
from repro_torch.models import blocks as tblocks
from repro_torch.models import moe as tmoe
from repro_torch.models import transformer as ttr
from repro_torch.models.registry import get_api
from repro_torch.serving import LMServingEngine, Request, TriagePolicy
from repro_torch.serving.engine import _rotate_k

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
F32_REL = 1e-5
BF16_REL = 0.05
ATTN_ATOL = 1e-5
FIN_ATOL = 1e-5            # ROADMAP C6
ACT_FRACTION = 1e-3        # bf16 activations: elements that may differ


def _rel(want, got) -> float:
    """max |want − got| / max |want| (floor 1e-3), as the reference's
    bf16 check measures."""
    want = np.asarray(want, np.float32)
    got = got.detach().to(torch.float32).numpy()
    return float(np.abs(want - got).max() / max(np.abs(want).max(), 1e-3))


def _t(a, dtype=None):
    t = torch.tensor(np.asarray(a))
    return t if dtype is None else t.to(dtype)


def _cfgs(arch: str, dtype: str):
    jc, tc = jget_config(arch, smoke=True), get_config(arch, smoke=True)
    if dtype == "f32":
        jc = dataclasses.replace(jc, dtype=jnp.float32)
        tc = dataclasses.replace(tc, dtype=torch.float32)
    return jc, tc


def _params(jc, seed: int = 0):
    jp = jtr.init_transformer(jax.random.PRNGKey(seed), jc)
    if jc.qkv_bias:       # non-zero biases, so the bias path is exercised
        for name in ("bq", "bk", "bv"):
            b = jp["blocks"]["attn"][name]
            jp["blocks"]["attn"][name] = 0.1 * jax.random.normal(
                jax.random.PRNGKey(seed + 7), b.shape)
    return jp, lm_params_from_jax(jax.device_get(jp))


# ----------------------------------------------------------------------
# blocks and attention
# ----------------------------------------------------------------------
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_blocks_match_reference(dtype):
    rng = np.random.default_rng(0)
    jdt, tdt = ((jnp.float32, torch.float32) if dtype == "f32"
                else (jnp.bfloat16, torch.bfloat16))
    tol = F32_REL if dtype == "f32" else BF16_REL
    x = rng.standard_normal((2, 5, 3, 16)).astype(np.float32)
    scale = rng.uniform(0.5, 1.5, 16).astype(np.float32)
    want = jblocks.rms_norm(jnp.asarray(x, jdt), jnp.asarray(scale))
    got = tblocks.rms_norm(_t(x, tdt), _t(scale))
    assert got.dtype == tdt and _rel(want, got) < tol
    pos = rng.integers(0, 40, (2, 5)).astype(np.int32)
    want = jblocks.apply_rope(jnp.asarray(x, jdt), jnp.asarray(pos), 1e6)
    got = tblocks.apply_rope(_t(x, tdt), _t(pos), 1e6)
    assert got.dtype == tdt and _rel(want, got) < tol
    h = rng.standard_normal((4, 8)).astype(np.float32)
    wi, wg = (rng.standard_normal((8, 12)).astype(np.float32) / 3
              for _ in range(2))
    wo = rng.standard_normal((12, 8)).astype(np.float32) / 3
    want = jblocks.swiglu(*(jnp.asarray(a, jdt) for a in (h, wi, wg, wo)))
    got = tblocks.swiglu(*(_t(a, tdt) for a in (h, wi, wg, wo)))
    assert _rel(want, got) < tol
    bi = rng.standard_normal(12).astype(np.float32)
    bo = rng.standard_normal(8).astype(np.float32)
    want = jblocks.gelu_mlp(*(jnp.asarray(a) for a in (h, wi, bi, wo, bo)))
    got = tblocks.gelu_mlp(*(_t(a) for a in (h, wi, bi, wo, bo)))
    assert _rel(want, got) < F32_REL
    ln_b = rng.standard_normal(16).astype(np.float32)
    want = jblocks.layer_norm(jnp.asarray(x), jnp.asarray(scale),
                              jnp.asarray(ln_b))
    assert _rel(want, tblocks.layer_norm(_t(x), _t(scale), _t(ln_b))) \
        < F32_REL


def _bf16_steps(want, got: torch.Tensor) -> torch.Tensor:
    """Distance in bf16 steps between the reference's bf16 array and
    the port's bf16 tensor, element by element (the bit patterns mapped
    to a monotone integer scale)."""
    def ordered(t):
        i = t.contiguous().view(torch.int16).to(torch.int32)
        return torch.where(i < 0, -32768 - i, i)
    want = torch.tensor(np.asarray(want.astype(jnp.float32))).bfloat16()
    return (ordered(want) - ordered(got)).abs()


def _activation_case(name: str):
    """-> (reference output, port output) in bf16 on inputs of std 3
    (the activation alone) or through N(0, 1/d_in) weights."""
    rng = np.random.default_rng(5)
    x = (rng.standard_normal((64, 256)) * 3).astype(np.float32)
    if name in ("silu", "gelu"):
        jf = {"silu": jax.nn.silu,
              "gelu": lambda a: jax.nn.gelu(a, approximate=True)}[name]
        return (jf(jnp.asarray(x, jnp.bfloat16)),
                getattr(tblocks, name)(_t(x, torch.bfloat16)))
    if name == "moe":
        e, d, f = 4, 64, 128
        xm = rng.standard_normal((4, 16, d)).astype(np.float32)
        arrays = [xm, (rng.standard_normal((d, e)) / 8).astype(np.float32),
                  *((rng.standard_normal((e, d, f)) / 8).astype(np.float32)
                    for _ in range(2)),
                  (rng.standard_normal((e, f, d)) / np.sqrt(f))
                  .astype(np.float32)]
        want, _ = jmoe.moe_apply(*(jnp.asarray(a, jnp.bfloat16)
                                   for a in arrays), top_k=2)
        got, _ = tmoe.moe_apply(*(_t(a, torch.bfloat16) for a in arrays),
                                top_k=2)
        return want, got
    wi = (rng.standard_normal((256, 512)) / 16).astype(np.float32)
    wg = (rng.standard_normal((256, 512)) / 16).astype(np.float32)
    wo = (rng.standard_normal((512, 256)) / np.sqrt(512)).astype(np.float32)
    bi = rng.standard_normal(512).astype(np.float32)
    bo = rng.standard_normal(256).astype(np.float32)
    arrays = (x, wi, wg, wo) if name == "swiglu" else (x, wi, bi, wo, bo)
    return (getattr(jblocks, name)(*(jnp.asarray(a, jnp.bfloat16)
                                     for a in arrays)),
            getattr(tblocks, name)(*(_t(a, torch.bfloat16)
                                     for a in arrays)))


@pytest.mark.parametrize("name", ["silu", "gelu", "swiglu", "gelu_mlp",
                                  "moe"])
def test_activations_match_reference_elementwise_in_bf16(name):
    """``F.silu`` and ``F.gelu(approximate="tanh")`` round once and
    differ from the reference's step-by-step forms in ~40 % of bf16
    elements; the port's ``silu``/``gelu`` and the MLPs and MoE experts
    on them differ in at most ACT_FRACTION.  An activation's differing
    elements are one bf16 step off; an MLP's, where such a step has
    gone through the output product, within one bf16 step at the
    output's largest magnitude."""
    want, got = _activation_case(name)
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == want.shape
    steps = _bf16_steps(want, got)
    assert float((steps > 0).float().mean()) <= ACT_FRACTION
    if name in ("silu", "gelu"):
        assert int(steps.max()) <= 1
    else:
        w = np.asarray(want.astype(jnp.float32))
        step = 2.0 ** (np.floor(np.log2(np.abs(w).max())) - 7)
        assert float(np.abs(w - got.float().numpy()).max()) <= step


@pytest.mark.parametrize("kw", [
    dict(causal=True),
    dict(causal=True, chunk_q=4, chunk_kv=3),
    dict(causal=False, kv_valid_len=9, chunk_q=5, chunk_kv=4),
    dict(causal=True, window=4, chunk_q=3, chunk_kv=5),
    dict(causal=True, kv_start=True, chunk_q=4, chunk_kv=4),
    dict(causal=True, kv_start=True, window=6, q_offset=2, chunk_kv=7)])
def test_chunked_attention_matches_reference(kw):
    rng = np.random.default_rng(1)
    q, k, v = (rng.standard_normal((3, 11, 4, 8)).astype(np.float32)
               for _ in range(3))
    kw = dict(kw)
    jkw, tkw = dict(kw), dict(kw)
    if kw.get("kv_start"):
        start = np.array([0, 3, 9], np.int32)   # row 2: its early queries
        jkw["kv_start"] = jnp.asarray(start)    # see no key at all
        tkw["kv_start"] = _t(start)
    want = jattn.chunked_attention(jnp.asarray(q), jnp.asarray(k),
                                   jnp.asarray(v), **jkw)
    got = tattn.chunked_attention(_t(q), _t(k), _t(v), **tkw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=ATTN_ATOL, rtol=0)


@pytest.mark.parametrize("window", [None, 5])
def test_decode_attention_and_expand_kv_match_reference(window):
    rng = np.random.default_rng(2)
    q = rng.standard_normal((3, 1, 4, 8)).astype(np.float32)
    ck, cv = (rng.standard_normal((3, 12, 2, 8)).astype(np.float32)
              for _ in range(2))
    start = np.array([0, 4, 7], np.int32)
    want = jattn.decode_attention(jnp.asarray(q), jnp.asarray(ck),
                                  jnp.asarray(cv), jnp.int32(9),
                                  window=window, start=jnp.asarray(start))
    got = tattn.decode_attention(_t(q), _t(ck), _t(cv), 9, window=window,
                                 start=_t(start))
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=ATTN_ATOL, rtol=0)
    np.testing.assert_array_equal(
        tattn.expand_kv(_t(ck), 4).numpy(),
        np.asarray(jattn.expand_kv(jnp.asarray(ck), 4)))
    # before the circular cache wraps, its decode is the linear one
    # without start (ROADMAP C25)
    linear = tattn.decode_attention(_t(q), _t(ck), _t(cv), 9, window=window)
    assert torch.equal(tattn.decode_attention(_t(q), _t(ck), _t(cv), 9,
                                              window=window, rolling=True,
                                              start=_t(start)), linear)


# ----------------------------------------------------------------------
# the trunk
# ----------------------------------------------------------------------
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("arch", ["qwen3-0.6b", "qwen3-1.7b", "yi-9b",
                                  "qwen1.5-110b"])
def test_prefill_and_decode_match_reference(arch, dtype):
    jc, tc = _cfgs(arch, dtype)
    tol = F32_REL if dtype == "f32" else BF16_REL
    jp, tp = _params(jc)
    rng = np.random.default_rng(3)
    toks = rng.integers(0, jc.vocab, (2, 12)).astype(np.int32)
    lens = np.array([12, 7], np.int32)
    for cache_len in (20, 9):            # 9: the prompt front-truncated
        jcache, jh = jtr.prefill(jp, jnp.asarray(toks), jc,
                                 cache_len=cache_len,
                                 prompt_lengths=jnp.asarray(lens))
        tcache, th = ttr.prefill(tp, _t(toks), tc, cache_len=cache_len,
                                 prompt_lengths=_t(lens))
        assert th.dtype == tc.dtype and tcache["k"].dtype == tc.dtype
        assert tcache["pos"] == int(jcache["pos"]) == 12
        np.testing.assert_array_equal(tcache["start"].numpy(),
                                      np.asarray(jcache["start"]))
        assert tuple(tcache["k"].shape) == jcache["k"].shape
        for want, got in ((jh, th), (jcache["k"], tcache["k"]),
                          (jcache["v"], tcache["v"])):
            assert _rel(want, got) < tol
    jcache, _ = jtr.prefill(jp, jnp.asarray(toks), jc, cache_len=20,
                            prompt_lengths=jnp.asarray(lens))
    tcache, _ = ttr.prefill(tp, _t(toks), tc, cache_len=20,
                            prompt_lengths=_t(lens))
    tok = toks[:, -1:]
    for step in range(3):
        jx, jcache = jtr.decode_hidden(jp, jcache, jnp.asarray(tok), jc)
        tx, tcache = ttr.decode_hidden(tp, tcache, _t(tok), tc)
        assert tcache["pos"] == int(jcache["pos"]) == 13 + step
        assert _rel(jx, tx) < tol
        assert _rel(jcache["k"], tcache["k"]) < tol
        tok = rng.integers(0, jc.vocab, (2, 1)).astype(np.int32)
    jl, _ = jtr.decode_step(jp, jcache, jnp.asarray(tok), jc)
    tl, tcache2 = ttr.decode_step(tp, tcache, _t(tok), tc)
    assert tuple(tl.shape) == jl.shape == (jc.uq_samples, 2,
                                           jc.vocab_padded)
    assert _rel(jl, tl) < tol
    assert tcache2["pos"] == tcache["pos"] + 1


def test_decode_hidden_leaves_its_input_cache():
    jc, tc = _cfgs("qwen3-0.6b", "f32")
    _, tp = _params(jc)
    toks = _t(np.arange(16, dtype=np.int32).reshape(2, 8))
    cache, _ = ttr.prefill(tp, toks, tc, cache_len=12)
    k0 = cache["k"].clone()
    ttr.decode_hidden(tp, cache, toks[:, -1:], tc)
    assert torch.equal(cache["k"], k0) and cache["pos"] == 8


def test_lm_admission_alignment_is_faithful():
    """Left-pad + roll + RoPE re-rotation + start-mask admission equals
    an isolated decode of the same prompt (bf16 tolerance), as the
    reference's test of the same name, on the port."""
    cfg = get_config("qwen3-0.6b", smoke=True)
    api = get_api(cfg)
    params = api.init(torch.Generator().manual_seed(0), cfg)
    p0, cl, delta = 12, 32, 7
    prompt = torch.randint(0, cfg.vocab, (1, 8),
                           generator=torch.Generator().manual_seed(5))
    cache_ref, _ = api.prefill(params, prompt, cfg, cache_len=cl)
    padded = torch.cat([torch.zeros((1, p0 - 8), dtype=prompt.dtype),
                        prompt], 1)
    cache_adm, _ = api.prefill(params, padded, cfg, cache_len=cl,
                               prompt_lengths=torch.tensor([8]))
    k = _rotate_k(torch.roll(cache_adm["k"], delta, dims=2), delta,
                  cfg.rope_theta)
    cache_adm = dict(cache_adm, k=k,
                     v=torch.roll(cache_adm["v"], delta, dims=2),
                     pos=p0 + delta, start=cache_adm["start"] + delta)
    tok = prompt[:, -1:]
    for _ in range(2):
        x_ref, cache_ref = api.decode_hidden(params, cache_ref, tok, cfg)
        x_adm, cache_adm = api.decode_hidden(params, cache_adm, tok, cfg)
        ref, adm = x_ref.float().numpy(), x_adm.float().numpy()
        assert np.abs(ref - adm).max() / max(np.abs(ref).max(), 1e-3) \
            < BF16_REL
        tok = torch.argmax(x_ref @ params["head"]["mu"].to(x_ref.dtype),
                           -1)[:, None] % cfg.vocab


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_align_scatter_matches_reference(dtype):
    """The port's admission scatter (roll, re-rotate, slot rows, start +
    delta) against the reference's jitted ``align_scatter`` on the same
    pool and prefill caches; slot 2 takes nothing and keeps its rows."""
    jc, tc = _cfgs("qwen3-0.6b", dtype)
    tol = F32_REL if dtype == "f32" else BF16_REL
    jp, tp = _params(jc)
    rng = np.random.default_rng(4)
    pool_toks = rng.integers(0, jc.vocab, (3, 8)).astype(np.int32)
    new_toks = rng.integers(0, jc.vocab, (3, 8)).astype(np.int32)
    lens = np.array([8, 5, 8], np.int32)
    jpool, _ = jtr.prefill(jp, jnp.asarray(pool_toks), jc, cache_len=20,
                           prompt_lengths=jnp.asarray(lens))
    jpool = jax.tree_util.tree_map(jnp.copy, jpool)  # donated below
    jnew, _ = jtr.prefill(jp, jnp.asarray(new_toks), jc, cache_len=20,
                          prompt_lengths=jnp.asarray(lens[::-1].copy()))
    jeng = JEngine(jp, jc, n_slots=3, prompt_len=8, cache_len=20,
                   telemetry=False)
    delta = 5
    want = jeng._align_scatter(jpool, jnew, jnp.array([1, 0, 3], jnp.int32),
                               jnp.int32(delta))
    teng = LMServingEngine(tp, tc, n_slots=3, prompt_len=8, cache_len=20,
                           telemetry=False, device="cpu")
    teng.cache, _ = ttr.prefill(tp, _t(pool_toks), tc, cache_len=20,
                                prompt_lengths=_t(lens))
    tnew, _ = ttr.prefill(tp, _t(new_toks), tc, cache_len=20,
                          prompt_lengths=_t(lens[::-1].copy()))
    teng._align_scatter(tnew, torch.tensor([1, 0]), 2, delta)
    np.testing.assert_array_equal(teng.cache["start"].numpy(),
                                  np.asarray(want["start"]))
    assert teng.cache["pos"] == int(want["pos"])
    for key in ("k", "v"):
        assert _rel(want[key], teng.cache[key]) < tol, key
    pool, _ = ttr.prefill(tp, _t(pool_toks), tc, cache_len=20,
                          prompt_lengths=_t(lens))
    assert torch.equal(teng.cache["k"][:, 2], pool["k"][:, 2])  # untaken
    rk = j_rotate_k(jnew["k"], 3, jc.rope_theta)
    assert _rel(rk, _rotate_k(tnew["k"], 3, tc.rope_theta)) < tol


# ----------------------------------------------------------------------
# the engine
# ----------------------------------------------------------------------
POLICIES = {
    "accept_always": dict(conf_threshold=0.0, mi_threshold=1e9, r_min=4,
                          r_max=8),
    "default": dict(),
    # MI ≈ 0.01 ± 0.008 at 4 samples here: rounds past the first run,
    # and some requests are accepted, some flagged
    "escalating": dict(conf_threshold=0.0, mi_threshold=0.015, r_min=4,
                       r_max=20),
}


@pytest.fixture(scope="module")
def lm_f32():
    jc, tc = _cfgs("qwen3-0.6b", "f32")
    jp, tp = _params(jc)
    prompts = np.random.default_rng(1).integers(
        0, jc.vocab, (3, 8)).astype(np.int32)
    return jc, tc, jp, tp, prompts


def _run_pair(lm, policy: dict, adaptive: bool, fused: bool = True,
              n_tokens: int = 3):
    jc, tc, jp, tp, prompts = lm
    jeng = JEngine(jp, jc, n_slots=2, prompt_len=8, cache_len=24,
                   policy=JPolicy(**policy), adaptive_mode=adaptive)
    teng = LMServingEngine(tp, tc, n_slots=2, prompt_len=8, cache_len=24,
                           policy=TriagePolicy(**policy),
                           adaptive_mode=adaptive, fused=fused,
                           device="cpu")
    for eng, req in ((jeng, JRequest), (teng, Request)):
        eng.free = [1, 0]                 # ROADMAP C20 (module docstring)
        for i in range(3):
            eng.submit(req(rid=i, payload=prompts[i],
                           max_new_tokens=n_tokens))
    return jeng, jeng.run(), teng, teng.run()


def _records(eng):
    return sorted(eng.metrics.records, key=lambda r: r.rid)


@pytest.mark.parametrize("name,adaptive,fused", [
    ("accept_always", True, True), ("default", True, True),
    ("escalating", True, True), ("escalating", True, False),
    ("default", False, True)])
def test_engine_matches_reference(lm_f32, name, adaptive, fused):
    jeng, jout, teng, tout = _run_pair(lm_f32, POLICIES[name], adaptive,
                                       fused)
    want, got = _records(jeng), _records(teng)
    assert [r.rid for r in got] == [0, 1, 2]
    assert [(r.rid, r.verdict, r.prediction, r.n_samples, r.n_decisions)
            for r in got] == \
        [(r.rid, r.verdict, r.prediction, r.n_samples, r.n_decisions)
         for r in want]
    for a, b in zip(got, want):
        assert abs(a.confidence - b.confidence) < FIN_ATOL
        assert abs(a.mutual_information - b.mutual_information) < FIN_ATOL
    assert teng.host_syncs == jeng.host_syncs
    for key in ("requests", "decisions", "accept_fraction",
                "flag_fraction", "mean_samples_per_decision"):
        assert tout[key] == jout[key], key
    for key in ("rounds", "dispatches", "samples", "decisions", "verdicts",
                "r_hist", "conf_hist", "ent_hist", "mi_hist"):
        assert tout["telemetry"][key] == jout["telemetry"][key], key
    assert set(tout["stage_profile"]) >= {"admission", "featurize",
                                          "dispatch", "triage_loop",
                                          "retirement"}
    assert teng.admissions == 2 and teng.n_active == 0 and not teng.queue
    if name == "accept_always":          # the third admitted mid-stream
        assert tout["decisions"] == 9 and tout["accept_fraction"] == 1.0
    if name == "escalating":
        assert max(r.n_samples / r.n_decisions for r in got) > 4
        assert {r.verdict for r in got} == {0, 2}     # ACCEPT and FLAG


def test_first_admission_puts_each_cache_row_in_its_slot(lm_f32):
    """Under the default free list the requests of the first admission
    take slots from its end; each slot's cache row and hidden state are
    its own request's prefill (ROADMAP C20)."""
    _, tc, _, tp, prompts = lm_f32
    eng = LMServingEngine(tp, tc, n_slots=2, prompt_len=8, cache_len=24,
                          telemetry=False, device="cpu")
    for i in range(2):
        eng.submit(Request(rid=i, payload=prompts[i], max_new_tokens=3))
    eng._admit()
    for s, slot in enumerate(eng.slots):
        rid = slot.req.rid
        cache, h = ttr.prefill(tp, _t(prompts[rid:rid + 1]), tc,
                               cache_len=24, prompt_lengths=_t([8]))
        assert torch.equal(eng.cache["k"][:, s], cache["k"][:, 0])
        assert torch.equal(eng.hidden[s], h[0])
    assert [s.req.rid for s in eng.slots] == [1, 0]


def test_engine_cost_records_and_capacity(lm_f32):
    _, tc, _, tp, prompts = lm_f32
    eng = LMServingEngine(tp, tc, n_slots=2, prompt_len=8, cache_len=24,
                          device="cpu")
    with pytest.raises(RuntimeError, match="live shapes"):
        eng.compiled_cost_records()
    eng.submit(Request(rid=0, payload=prompts[0], max_new_tokens=2))
    eng.run()
    recs = eng.compiled_cost_records()
    assert [r["name"] for r in recs] == ["lm_token/r4", "lm_token/r8"]
    assert all(r["launches_per_dispatch"] == 0 for r in recs)   # CPU
    assert all(f"N={tc.vocab_padded}" in r["shape"] for r in recs)
    eng.submit(Request(rid=1, payload=prompts[1], max_new_tokens=17))
    with pytest.raises(ValueError, match="cannot fit"):
        eng.run()


# ----------------------------------------------------------------------
# serve(), the CLI, tokens, bridge, registry, imports
# ----------------------------------------------------------------------
def test_serve_summary_and_cli(capsys):
    from repro_torch.launch import serve as tserve
    out = tserve.serve("qwen3-0.6b", batch=2, prompt_len=8, gen_len=2,
                       n_requests=3, cost_records=True, device="cpu")
    assert out["requests"] == 3 and out["device"] == "cpu"
    for key in ("decisions", "tokens_per_s", "wall_s", "host_syncs",
                "flagged_fraction", "mean_samples_per_decision",
                "telemetry", "stage_profile", "compiled_costs",
                "energy_per_decision_pJ", "tile_area_mm2", "ticks"):
        assert key in out, key
    assert sorted(v["rid"] for v in out["verdicts"]) == [0, 1, 2]
    assert out["host_syncs"] == out["ticks"]
    shapes = tserve.lm_layer_shapes(get_config("qwen3-0.6b"))
    assert len(shapes) == 4 * 28 + 1 and shapes[-1].d_out == 152064
    cli = tserve.main(["--arch", "yi-9b", "--device", "cpu", "--slots", "2",
                       "--requests", "2", "--gen", "2", "--prompt-len", "6",
                       "--fixed"])
    assert cli["requests"] == 2
    assert "[yi-9b] 2 requests" in capsys.readouterr().out
    cli = tserve.main(["--arch", "whisper-medium", "--device", "cpu",
                       "--slots", "2", "--requests", "3", "--gen", "2",
                       "--prompt-len", "8"])
    assert cli["requests"] == 3 and cli["admissions"] == 2
    assert "[whisper-medium] 3 requests" in capsys.readouterr().out


def test_params_init_matches_reference_tree():
    from repro_torch.launch.serve import params_init
    cfg = get_config("qwen1.5-110b", smoke=True)
    tp = params_init(cfg, 3, "cpu")
    jp = jtr.init_transformer(jax.random.PRNGKey(0),
                              jget_config("qwen1.5-110b", smoke=True))
    jtree = jax.tree_util.tree_map(lambda a: (a.shape, str(a.dtype)), jp)
    ttree = jax.tree_util.tree_map(
        lambda t: (tuple(t.shape), str(t.dtype).replace("torch.", "")), tp)
    assert ttree == jtree
    assert float(tp["embed"].std()) == pytest.approx(0.02, rel=0.05)
    wq = tp["blocks"]["attn"]["wq"]
    assert float(wq.std()) == pytest.approx(64 ** -0.5, rel=0.05)


def test_token_pipeline_bigram_and_purity():
    cfg = ttok.TokenPipelineConfig(vocab=151936, seq_len=64,
                                   global_batch=8, seed=3)
    b = ttok.batch_at(cfg, 5)
    again = ttok.batch_at(cfg, 5)
    assert torch.equal(b["tokens"], again["tokens"])
    assert torch.equal(b["labels"], again["labels"])
    assert not torch.equal(b["tokens"], ttok.batch_at(cfg, 6)["tokens"])
    other = dataclasses.replace(cfg, seed=4)
    assert not torch.equal(b["tokens"], ttok.batch_at(other, 5)["tokens"])
    tok, lab = b["tokens"].numpy(), b["labels"].numpy()
    assert tok.dtype == lab.dtype == np.int32
    assert (tok >= 0).all() and (tok < cfg.vocab).all()
    np.testing.assert_array_equal(tok[:, 1:], lab[:, :-1])
    # the reference's successor, in its int32 arithmetic (the product
    # wraps at this vocabulary): ~90 % of transitions follow it
    want = ((tok.astype(np.int32) * np.int32(cfg.a) + np.int32(cfg.c))
            .astype(np.int64) % cfg.vocab)
    follows = (want == lab).mean()
    assert 0.8 < follows < 0.97
    np.testing.assert_array_equal(
        ttok.bigram_next(cfg, torch.tensor(tok, dtype=torch.int64)).numpy(),
        want)
    it = ttok.batch_iterator(cfg, start_step=5)
    step, first = next(it)
    assert step == 5 and torch.equal(first["tokens"], b["tokens"])
    assert next(it)[0] == 6


def test_lm_params_bridge_round_trip():
    jc = jget_config("qwen3-0.6b", smoke=True)
    jp = jax.device_get(jtr.init_transformer(jax.random.PRNGKey(2), jc))
    back = lm_params_to_jax(lm_params_from_jax(jp))
    flat_j = jax.tree_util.tree_leaves_with_path(jp)
    flat_b = jax.tree_util.tree_leaves_with_path(back)
    assert [p for p, _ in flat_j] == [p for p, _ in flat_b]
    for (path, a), (_, b) in zip(flat_j, flat_b):
        assert b.dtype == np.asarray(a).dtype, path
        np.testing.assert_array_equal(b, np.asarray(a))


@pytest.mark.parametrize("arch", ["whisper-medium", "llama-3.2-vision-11b"])
def test_audio_and_vlm_families_are_ported(arch):
    """get_config, get_api and init_transformer take both archs (the
    memory's leaves in the params: whisper's encoder, the VLM's cross
    layers); train_loss raises naming ROADMAP A14; a prefill without
    the memory input raises."""
    cfg = get_config(arch, smoke=True)
    assert get_config(arch).family == cfg.family
    api = get_api(cfg)
    assert api.prefill is ttr.prefill
    assert (api.needs_frames, api.needs_images) == (
        arch == "whisper-medium", arch == "llama-3.2-vision-11b")
    params = ttr.init_transformer(torch.Generator().manual_seed(0), cfg)
    assert ("encoder" in params) == (arch == "whisper-medium")
    assert ("blocks_cross" in params) == (arch != "whisper-medium")
    with pytest.raises(NotImplementedError, match="ROADMAP A14"):
        api.train_loss(params, {}, cfg)
    with pytest.raises(ValueError, match="stub"):
        ttr.prefill(params, torch.zeros((1, 4), dtype=torch.int32), cfg,
                    cache_len=8)


def test_configs_port_as_data():
    assert set(ARCHS) == {"qwen3-0.6b", "qwen3-1.7b", "yi-9b",
                          "qwen1.5-110b", "mixtral-8x7b",
                          "qwen3-moe-235b-a22b", "mamba2-130m",
                          "zamba2-2.7b", "whisper-medium",
                          "llama-3.2-vision-11b"}
    for arch in ARCHS:
        for smoke in (False, True):
            jc, tc = jget_config(arch, smoke), get_config(arch, smoke)
            jd, td = dataclasses.asdict(jc), dataclasses.asdict(tc)
            assert jd.keys() == td.keys()
            assert {k: v for k, v in jd.items() if k != "dtype"} == \
                {k: v for k, v in td.items() if k != "dtype"}
            assert tc.dtype == torch.bfloat16
            assert tc.vocab_padded == jc.vocab_padded
            assert tc.param_count() == jc.param_count()
            assert tc.head_bayes_cfg().d_out == jc.vocab_padded
    assert get_config("qwen3-0.6b").vocab_padded == 152064


def test_lm_port_imports_neither_jax_nor_reference():
    """Importing every module of the port, the LM slice included, loads
    neither jax nor the reference package."""
    mods = sorted(
        "repro_torch." + ".".join(p.relative_to(PORT).with_suffix("").parts)
        for p in PORT.rglob("*.py") if p.name != "__init__.py")
    assert {"repro_torch.models.transformer", "repro_torch.configs.yi_9b",
            "repro_torch.data.tokens", "repro_torch.models.moe",
            "repro_torch.configs.mixtral_8x7b",
            "repro_torch.configs.qwen3_moe_235b_a22b",
            "repro_torch.models.mamba2", "repro_torch.models.ssm_lm",
            "repro_torch.configs.mamba2_130m",
            "repro_torch.configs.zamba2_2_7b",
            "repro_torch.configs.whisper_medium",
            "repro_torch.configs.llama_3_2_vision_11b"} <= set(mods)
    code = ("import sys, importlib\n"
            f"for m in {mods + ['repro_torch.configs']!r}:\n"
            "    importlib.import_module(m)\n"
            "bad = [m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m == 'repro' or "
            "m.startswith('repro.')]\n"
            "assert not bad, bad\n")
    env = {"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"}
    res = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
