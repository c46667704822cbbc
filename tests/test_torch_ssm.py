"""The SSM and hybrid language models of the port (mamba2-130m,
zamba2-2.7b) against the JAX reference, on the CPU (SMOKE sizes).

Inputs are numpy arrays from a seed; params are the reference's
``init_ssm_lm`` draws carried over by ``bridge.lm_params_from_jax``
(with A_log, dt_bias, D, conv_b and the norms perturbed where a test
says so, so that their paths are exercised: the reference initializes
them to 0 or 1).

  * ``_causal_conv_full`` (bit for bit in float32: the same shift-adds
    in the same order), ``_segsum_exp`` and ``ssd_chunked`` at one and
    three chunks, with and without ``state0``, and with G = 2 groups
    (``jnp.repeat`` is ``repeat_interleave``): float32 to F32_ATOL.
  * ``mamba_block_full`` (with and without carried SSD and conv states)
    and ``mamba_block_decode`` in float32 to F32_ATOL.
  * ``trunk_forward_ssm``, ``prefill_ssm`` (with ``prompt_lengths``),
    ``decode_hidden_ssm`` and ``decode_step_ssm`` for both SMOKE
    configs, in float32 to F32_REL (max error over max magnitude) and in
    bfloat16 to BF16_REL (the reference's own bound).
  * prefill + decode steps against the full-sequence forward (the twin
    of ``test_decode_matches_full_forward_ssm`` in
    ``tests/test_models_smoke.py``), and the left-pad pollution of the
    SSM state at admission measured on the port equal to the
    reference's (the twin of ``test_ssm_leftpad_admission_pollution_
    quantified`` in ``tests/test_serving.py``).
  * the hybrid's prefill attention is not masked by ``start`` (ROADMAP
    C26, a fault of the reference the port matches): the shared block
    equals the reference's unmasked one and differs from a masked one.
  * ``LMServingEngine`` on both SMOKE configs in float32 against the
    reference's, both from the free list [1, 0] (ROADMAP C20), the third
    request admitted mid-stream: verdicts, tokens, samples, host syncs
    and telemetry equal request for request, confidence and MI within
    1e-5 (ROADMAP C6).
  * ``serve()`` and the CLI on both archs, the params' tree and scales,
    the bridge's round trip, the registry and configs, and
    ``train_loss_ssm`` refusing a sequence of part of a chunk.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.models import mamba2 as jm
from repro.models import ssm_lm as js
from repro.serving import LMServingEngine as JEngine
from repro.serving import Request as JRequest
from repro.serving import TriagePolicy as JPolicy
from repro_torch.bridge import lm_params_from_jax, lm_params_to_jax
from repro_torch.configs import get_config
from repro_torch.models import mamba2 as tm
from repro_torch.models import ssm_lm as ts
from repro_torch.models import transformer as ttr
from repro_torch.models.registry import get_api
from repro_torch.serving import LMServingEngine, Request, TriagePolicy

F32_ATOL = 1e-5            # the SSD, the blocks: float32, order only
F32_REL = 1e-5             # the trunk: max error over max magnitude
BF16_REL = 0.05            # the dense tests' (and the reference's) bound
FIN_ATOL = 1e-5            # ROADMAP C6
SSM_ARCHS = ("mamba2-130m", "zamba2-2.7b")


def _rel(want, got) -> float:
    want = np.asarray(want, np.float32)
    got = got.detach().to(torch.float32).numpy()
    return float(np.abs(want - got).max() / max(np.abs(want).max(), 1e-3))


def _t(a, dtype=None):
    t = torch.tensor(np.asarray(a))
    return t if dtype is None else t.to(dtype)


def _close(want, got, atol=F32_ATOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=0, atol=atol)


def _cfgs(arch: str, dtype: str):
    jc, tc = jget_config(arch, smoke=True), get_config(arch, smoke=True)
    if dtype == "f32":
        jc = dataclasses.replace(jc, dtype=jnp.float32)
        tc = dataclasses.replace(tc, dtype=torch.float32)
    return jc, tc


def _perturb(jp, seed: int):
    """The mamba leaves the reference sets to 0 or 1, drawn instead."""
    m = dict(jp["mamba"])
    keys = jax.random.split(jax.random.PRNGKey(seed), 5)
    m["A_log"] = 0.5 * jax.random.normal(keys[0], m["A_log"].shape)
    m["dt_bias"] = 0.5 * jax.random.normal(keys[1], m["dt_bias"].shape)
    m["D"] = 1.0 + 0.3 * jax.random.normal(keys[2], m["D"].shape)
    m["conv_b"] = 0.1 * jax.random.normal(keys[3], m["conv_b"].shape)
    m["norm"] = 1.0 + 0.1 * jax.random.normal(keys[4], m["norm"].shape)
    return dict(jp, mamba=m)


def _params(jc, seed: int = 0, perturb: bool = True):
    jp = js.init_ssm_lm(jax.random.PRNGKey(seed), jc)
    if perturb:
        jp = _perturb(jp, seed + 11)
    return jp, lm_params_from_jax(jax.device_get(jp))


# ----------------------------------------------------------------------
# the SSD and the mamba blocks
# ----------------------------------------------------------------------
def test_causal_conv_and_segsum_match_reference():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 11, 6)).astype(np.float32)
    w = rng.standard_normal((6, 4)).astype(np.float32)
    b = rng.standard_normal((6,)).astype(np.float32)
    want = jm._causal_conv_full(jnp.asarray(x), jnp.asarray(w),
                                jnp.asarray(b))
    got = tm._causal_conv_full(_t(x), _t(w), _t(b))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    a = -np.abs(rng.standard_normal((2, 3, 9))).astype(np.float32)
    _close(jm._segsum_exp(jnp.asarray(a)), tm._segsum_exp(_t(a)), 1e-6)
    assert bool((tm._segsum_exp(_t(a))[..., 0, 1:] == 0).all())


def _ssd_case(seed, s, h, g, p=4, n=5, b=2):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, s, h, p)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((b, s, h)))).astype(np.float32)
    a = -np.exp(0.5 * rng.standard_normal((h,))).astype(np.float32)
    bm = rng.standard_normal((b, s, g, n)).astype(np.float32)
    cm = rng.standard_normal((b, s, g, n)).astype(np.float32)
    st = rng.standard_normal((b, h, p, n)).astype(np.float32)
    return x, dt, a, bm, cm, st


@pytest.mark.parametrize("chunks,g,with_state", [
    (1, 1, False), (3, 1, False), (3, 1, True), (1, 2, True),
    (3, 2, False)])
def test_ssd_chunked_matches_reference(chunks, g, with_state):
    chunk = 8
    x, dt, a, bm, cm, st = _ssd_case(chunks * 10 + g, chunks * chunk, 4, g)
    st0 = st if with_state else None
    jy, jst = jm.ssd_chunked(
        *(jnp.asarray(v) for v in (x, dt, a, bm, cm)), chunk,
        None if st0 is None else jnp.asarray(st0))
    ty, tst = tm.ssd_chunked(*(_t(v) for v in (x, dt, a, bm, cm)), chunk,
                             None if st0 is None else _t(st0))
    _close(jy, ty)
    _close(jst, tst)


def test_ssd_chunked_carries_its_state_and_refuses_unaligned():
    """Three chunks at once equal one chunk then two with the state
    carried, and a length that is not a multiple of the chunk is
    refused, as the reference asserts."""
    x, dt, a, bm, cm, _ = _ssd_case(7, 24, 4, 2)
    args = [_t(v) for v in (x, dt, a, bm, cm)]
    y, st = tm.ssd_chunked(*args, 8)
    y1, st1 = tm.ssd_chunked(*(v[:, :8] if v.ndim > 1 else v
                               for v in args), 8)
    y2, st2 = tm.ssd_chunked(*(v[:, 8:] if v.ndim > 1 else v
                               for v in args), 8, st1)
    torch.testing.assert_close(torch.cat([y1, y2], 1), y, rtol=0,
                               atol=F32_ATOL)
    torch.testing.assert_close(st2, st, rtol=0, atol=F32_ATOL)
    with pytest.raises(ValueError, match="chunk-aligned"):
        tm.ssd_chunked(*(v[:, :12] if v.ndim > 1 else v for v in args), 8)
    with pytest.raises(AssertionError):
        jm.ssd_chunked(*(jnp.asarray(np.asarray(v)[:, :12])
                         if np.asarray(v).ndim > 1 else jnp.asarray(v)
                         for v in (x, dt, a, bm, cm)), 8)


@pytest.mark.parametrize("carried", [False, True])
@pytest.mark.parametrize("arch", SSM_ARCHS)
def test_mamba_block_full_matches_reference(arch, carried):
    jc, tc = _cfgs(arch, "f32")
    jp, tp = _params(jc)
    dims = jm.mamba_dims(jc)
    rng = np.random.default_rng(5)
    h = rng.standard_normal((2, 2 * jc.ssm_chunk, jc.d_model)).astype(
        np.float32)
    st0 = cst0 = None
    if carried:
        st0 = rng.standard_normal((2, dims["nheads"], dims["headdim"],
                                   dims["d_state"])).astype(np.float32)
        cst0 = rng.standard_normal((2, dims["conv_dim"],
                                    dims["d_conv"] - 1)).astype(np.float32)
    jout, (jst, jcst) = jm.mamba_block_full(
        jnp.asarray(h), ttr._layer(jp["mamba"], 1), jc,
        None if st0 is None else jnp.asarray(st0),
        None if cst0 is None else jnp.asarray(cst0))
    tout, (tst, tcst) = tm.mamba_block_full(
        _t(h), ttr._layer(tp["mamba"], 1), tc,
        None if st0 is None else _t(st0),
        None if cst0 is None else _t(cst0))
    _close(jout, tout)
    _close(jst, tst)
    _close(jcst, tcst)          # in_proj's outputs: the product's order


@pytest.mark.parametrize("arch", SSM_ARCHS)
def test_mamba_block_decode_matches_reference(arch):
    jc, tc = _cfgs(arch, "f32")
    jp, tp = _params(jc)
    dims = jm.mamba_dims(jc)
    rng = np.random.default_rng(6)
    h = rng.standard_normal((3, 1, jc.d_model)).astype(np.float32)
    st = rng.standard_normal((3, dims["nheads"], dims["headdim"],
                              dims["d_state"])).astype(np.float32)
    cst = rng.standard_normal((3, dims["conv_dim"],
                               dims["d_conv"] - 1)).astype(np.float32)
    jout, (jst, jcst) = jm.mamba_block_decode(
        jnp.asarray(h), ttr._layer(jp["mamba"], 0), jc, jnp.asarray(st),
        jnp.asarray(cst))
    tout, (tst, tcst) = tm.mamba_block_decode(
        _t(h), ttr._layer(tp["mamba"], 0), tc, _t(st), _t(cst))
    _close(jout, tout)
    _close(jst, tst)
    assert tcst.dtype == torch.float32
    _close(jcst, tcst)


# ----------------------------------------------------------------------
# the trunk, prefill and decode
# ----------------------------------------------------------------------
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("arch", SSM_ARCHS)
def test_prefill_and_decode_match_reference(arch, dtype):
    """The trunk's hidden states, a left-padded prefill (cache_len 40,
    and for the hybrid 20: its k/v front-truncated) and three decode
    steps, then a ``decode_step``."""
    jc, tc = _cfgs(arch, dtype)
    tol = F32_REL if dtype == "f32" else BF16_REL
    jp, tp = _params(jc)
    rng = np.random.default_rng(3)
    s = 2 * jc.ssm_chunk
    toks = rng.integers(0, jc.vocab, (2, s)).astype(np.int32)
    lens = np.array([s, 7], np.int32)
    jh, _, _ = js.trunk_forward_ssm(jp, jnp.asarray(toks), jc)
    th, aux, caches = ts.trunk_forward_ssm(tp, _t(toks), tc)
    assert caches is None and float(aux) == 0.0 and th.dtype == tc.dtype
    assert _rel(jh, th) < tol
    for cache_len in ((20, 40) if jc.hybrid_attn_every else (40,)):
        jcache, jx = js.prefill_ssm(jp, jnp.asarray(toks), jc,
                                    cache_len=cache_len,
                                    prompt_lengths=jnp.asarray(lens))
        tcache, tx = ts.prefill_ssm(tp, _t(toks), tc, cache_len=cache_len,
                                    prompt_lengths=_t(lens))
        assert tcache["pos"] == int(jcache["pos"]) == s
        np.testing.assert_array_equal(tcache["start"].numpy(),
                                      np.asarray(jcache["start"]))
        assert set(tcache) == set(jcache)
        for key in set(jcache) - {"pos", "start"}:
            assert tuple(tcache[key].shape) == jcache[key].shape, key
            assert str(tcache[key].dtype).replace("torch.", "") == \
                str(jcache[key].dtype), key
            assert _rel(jcache[key], tcache[key]) < tol, key
        assert _rel(jx, tx) < tol
    tok = toks[:, -1:]
    for step in range(3):
        jx, jcache = js.decode_hidden_ssm(jp, jcache, jnp.asarray(tok), jc)
        tx, tcache = ts.decode_hidden_ssm(tp, tcache, _t(tok), tc)
        assert tcache["pos"] == int(jcache["pos"]) == s + 1 + step
        assert tcache["conv"].dtype == torch.float32
        assert _rel(jx, tx) < tol
        for key in ("ssm", "conv", "k", "v"):
            if key in jcache:
                assert _rel(jcache[key], tcache[key]) < tol, key
        tok = rng.integers(0, jc.vocab, (2, 1)).astype(np.int32)
    jl, _ = js.decode_step_ssm(jp, jcache, jnp.asarray(tok), jc)
    tl, tcache2 = ts.decode_step_ssm(tp, tcache, _t(tok), tc)
    assert tuple(tl.shape) == jl.shape == (jc.uq_samples, 2,
                                           jc.vocab_padded)
    assert _rel(jl, tl) < tol
    assert tcache2["pos"] == tcache["pos"] + 1


def test_decode_hidden_leaves_its_input_cache():
    jc, tc = _cfgs("zamba2-2.7b", "f32")
    _, tp = _params(jc)
    toks = _t(np.arange(32, dtype=np.int32).reshape(2, 16))
    cache, _ = ts.prefill_ssm(tp, toks, tc, cache_len=20)
    saved = {k: v.clone() for k, v in cache.items() if torch.is_tensor(v)}
    ts.decode_hidden_ssm(tp, cache, toks[:, -1:], tc)
    assert cache["pos"] == 16
    for k, v in saved.items():
        assert torch.equal(cache[k], v), k


@pytest.mark.parametrize("arch", SSM_ARCHS)
def test_decode_matches_full_forward(arch):
    """Prefill of 4 tokens then 4 decode steps against the trunk over 8
    (chunk 4, deterministic head), the reference's test on the port, and
    the port's logits against the reference's."""
    cfg = dataclasses.replace(get_config(arch, smoke=True),
                              bayesian_head=False, ssm_chunk=4)
    jcfg = dataclasses.replace(jget_config(arch, smoke=True),
                               bayesian_head=False, ssm_chunk=4)
    jp = jax.device_get(js.init_ssm_lm(jax.random.PRNGKey(0), jcfg))
    tp = lm_params_from_jax(jp)
    tokens = np.random.default_rng(1).integers(0, cfg.vocab, (1, 8)).astype(
        np.int32)
    h, _, _ = ts.trunk_forward_ssm(tp, _t(tokens), cfg)
    full = (h @ tp["head"]["w"].to(h.dtype))[:, -1]
    cache, _ = ts.prefill_ssm(tp, _t(tokens[:, :4]), cfg, cache_len=8)
    jcache, _ = js.prefill_ssm(jp, jnp.asarray(tokens[:, :4]), jcfg,
                               cache_len=8)
    for t in range(4, 8):
        logits, cache = ts.decode_step_ssm(tp, cache, _t(tokens[:, t:t + 1]),
                                           cfg)
        jlogits, jcache = js.decode_step_ssm(
            jp, jcache, jnp.asarray(tokens[:, t:t + 1]), jcfg)
        assert _rel(jlogits, logits) < BF16_REL
    np.testing.assert_allclose(logits[0].float().numpy(),
                               full.float().numpy(), rtol=0.1, atol=0.15)


def test_leftpad_admission_pollution_matches_reference():
    """The SSM state absorbs a left-padded prompt's pad (prefill_ssm's
    docstring; ROADMAP C26): measured on the port as the reference's
    test measures it (a 4-token prompt behind 28 pad tokens against an
    exact decode from a zeroed state, then three decode steps), the
    errors equal the reference's measured the same way, and they keep
    the reference's asserted shape (an approximation at admission that
    decays below 5 %)."""
    arch = "mamba2-130m"
    jc, tc = jget_config(arch, smoke=True), get_config(arch, smoke=True)
    jp = jax.device_get(js.init_ssm_lm(jax.random.PRNGKey(0), jc))
    tp = lm_params_from_jax(jp)
    n = jc.ssm_chunk
    full = np.asarray(jax.random.randint(jax.random.PRNGKey(5), (1, n), 1,
                                         jc.vocab), np.int32)
    prompt = full[:, :4]
    padded = np.concatenate([np.zeros((1, 2 * n - 4), np.int32), prompt], 1)

    def rel(a, b):
        a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
        return float(np.abs(a - b).max() / np.abs(a).max())

    def measure(prefill, decode, arr, to_np):
        c0, _ = prefill(arr(np.zeros((1, n), np.int32)))
        cache = {k: (v * 0 if k in ("ssm", "conv") else v)
                 for k, v in c0.items()}
        h_ref = None
        for i in range(prompt.shape[1]):
            h_ref, cache = decode(cache, arr(prompt[:, i:i + 1]))
        cache_adm, h_adm = prefill(arr(padded), lengths=arr(
            np.array([4], np.int32)))
        errs = [rel(to_np(h_ref), to_np(h_adm))]
        tok = prompt[:, -1:]
        for _ in range(3):
            h_ref, cache = decode(cache, arr(tok))
            h_adm, cache_adm = decode(cache_adm, arr(tok))
            errs.append(rel(to_np(h_ref), to_np(h_adm)))
            tok = (tok + 1) % jc.vocab
        return np.array(errs)

    want = measure(
        lambda t, lengths=None: js.prefill_ssm(
            jp, t, jc, cache_len=4 * n, prompt_lengths=lengths),
        lambda c, t: js.decode_hidden_ssm(jp, c, t, jc), jnp.asarray,
        lambda a: np.asarray(a, np.float32))
    got = measure(
        lambda t, lengths=None: ts.prefill_ssm(
            tp, t, tc, cache_len=4 * n, prompt_lengths=lengths),
        lambda c, t: ts.decode_hidden_ssm(tp, c, t, tc), _t,
        lambda a: a.float().numpy())
    assert got[0] > 0.01 and got[-1] < 0.05 and got[-1] < 0.5 * got[0]
    np.testing.assert_allclose(got, want, rtol=0.1, atol=2e-3)


def test_hybrid_prefill_attention_is_not_masked():
    """ROADMAP C26: the hybrid's shared block runs its prefill attention
    over the left pad (the reference calls ``_block_full`` without
    ``kv_start``).  The port's shared block equals the reference's on a
    left-padded row, and differs from the same block with the pad
    masked."""
    jc, tc = _cfgs("zamba2-2.7b", "f32")
    jp, tp = _params(jc)
    rng = np.random.default_rng(9)
    s = jc.ssm_chunk
    h = rng.standard_normal((2, s, jc.d_model)).astype(np.float32)
    h0 = rng.standard_normal((2, s, jc.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(s, dtype=np.int32), (2, s))
    want, (jk, _) = js._shared_block_full(jnp.asarray(h), jnp.asarray(h0),
                                          jp, jc, jnp.asarray(pos))
    got, (tk, _) = ts._shared_block_full(_t(h), _t(h0), tp, tc, _t(pos))
    assert _rel(want, got) < F32_REL and _rel(jk, tk) < F32_REL
    u = torch.cat([_t(h), _t(h0)], -1) @ tp["shared_w_in"]
    masked, _, _, _ = ttr._block_full(u, tp["shared_attn"], tc, _t(pos),
                                      causal=True,
                                      kv_start=torch.tensor([0, s - 5]))
    masked = _t(h) + masked @ tp["shared_w_out"]
    assert torch.allclose(masked[0], got[0], atol=1e-5)  # nothing masked
    assert float((masked[1] - got[1]).abs().max()) > 1e-3


# ----------------------------------------------------------------------
# the engine
# ----------------------------------------------------------------------
POLICIES = {
    "accept_always": (dict(conf_threshold=0.0, mi_threshold=1e9, r_min=4,
                           r_max=8), True),
    "escalating": (dict(conf_threshold=0.0, mi_threshold=0.015, r_min=4,
                        r_max=20), True),
}


@pytest.mark.parametrize("name", list(POLICIES))
@pytest.mark.parametrize("arch", SSM_ARCHS)
def test_ssm_engine_matches_reference(arch, name):
    """Two slots, three requests of 3 tokens (the third admitted into
    the decoding pool), prompts of one chunk (16) left-padded."""
    jc, tc = _cfgs(arch, "f32")
    jp, tp = _params(jc, perturb=False)
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, jc.vocab, (n,)).astype(np.int32)
               for n in (16, 9, 12)]
    policy, adaptive = POLICIES[name]
    kw = dict(n_slots=2, prompt_len=16, cache_len=24,
              adaptive_mode=adaptive)
    jeng = JEngine(jp, jc, policy=JPolicy(**policy), **kw)
    teng = LMServingEngine(tp, tc, policy=TriagePolicy(**policy),
                           device="cpu", **kw)
    deltas = []
    scatter = teng._align_scatter
    teng._align_scatter = lambda new, idx, take, delta: (
        deltas.append(delta), scatter(new, idx, take, delta))
    for eng, req in ((jeng, JRequest), (teng, Request)):
        eng.free = [1, 0]                 # ROADMAP C20
        for i in range(3):
            eng.submit(req(rid=i, payload=prompts[i], max_new_tokens=3))
    jout, tout = jeng.run(), teng.run()
    want = sorted(jeng.metrics.records, key=lambda r: r.rid)
    got = sorted(teng.metrics.records, key=lambda r: r.rid)
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
    assert teng.midstream_ok and teng.admissions == 2
    assert deltas[0] == 0 and deltas[1] > 0       # the third mid-stream
    if name == "accept_always":
        assert tout["decisions"] == 9
    if name == "escalating":
        assert tout["telemetry"]["rounds"] > tout["telemetry"]["dispatches"]


def test_fresh_pool_puts_each_state_row_in_its_slot():
    """Under the default free list the first admission's requests take
    slots from its end; each slot's SSM rows and hidden state are its
    own request's prefill (ROADMAP C20's repair, on a cache with no
    k)."""
    cfg = dataclasses.replace(get_config("mamba2-130m", smoke=True),
                              dtype=torch.float32)
    params = get_api(cfg).init(torch.Generator().manual_seed(0), cfg)
    prompts = np.random.default_rng(2).integers(0, cfg.vocab, (2, 16))
    eng = LMServingEngine(params, cfg, n_slots=2, prompt_len=16,
                          cache_len=24, telemetry=False, device="cpu")
    assert "k" not in eng._api.prefill(params, _t(prompts), cfg,
                                       cache_len=24)[0]
    for i in range(2):
        eng.submit(Request(rid=i, payload=prompts[i], max_new_tokens=3))
    eng._admit()
    for s, slot in enumerate(eng.slots):
        rid = slot.req.rid
        cache, h = ts.prefill_ssm(params, _t(prompts[rid:rid + 1]), cfg,
                                  cache_len=24, prompt_lengths=_t([16]))
        for key in ("ssm", "conv"):
            assert torch.equal(eng.cache[key][:, s], cache[key][:, 0]), key
        assert torch.equal(eng.hidden[s], h[0])
    assert [s.req.rid for s in eng.slots] == [1, 0]


# ----------------------------------------------------------------------
# params, bridge, registry, serve
# ----------------------------------------------------------------------
@pytest.mark.parametrize("arch", SSM_ARCHS)
def test_ssm_families_are_ported(arch):
    for smoke in (False, True):
        cfg = get_config(arch, smoke)
        jc = jget_config(arch, smoke)
        jd, td = dataclasses.asdict(jc), dataclasses.asdict(cfg)
        assert {k: v for k, v in jd.items() if k != "dtype"} == \
            {k: v for k, v in td.items() if k != "dtype"}
        assert cfg.dtype == torch.bfloat16
        assert cfg.vocab_padded == jc.vocab_padded
        api = get_api(cfg)
        assert api.prefill is ts.prefill_ssm
        assert api.decode_hidden is ts.decode_hidden_ssm
    assert get_config("mamba2-130m").vocab_padded == 50432


def test_ssm_params_match_reference_tree_and_scales():
    from repro_torch.launch.serve import params_init
    for arch in SSM_ARCHS:
        cfg = get_config(arch, smoke=True)
        tp = params_init(cfg, 3, "cpu")
        jp = js.init_ssm_lm(jax.random.PRNGKey(0),
                            jget_config(arch, smoke=True))
        jtree = jax.tree_util.tree_map(lambda a: (a.shape, str(a.dtype)),
                                       jp)
        ttree = jax.tree_util.tree_map(
            lambda t: (tuple(t.shape), str(t.dtype).replace("torch.", "")),
            tp)
        assert ttree == jtree
        m = tp["mamba"]
        assert float(m["in_proj"].std()) == pytest.approx(
            cfg.d_model ** -0.5, rel=0.05)
        assert float(m["conv_w"].std()) == pytest.approx(0.1, rel=0.05)
        assert float(m["A_log"].abs().max()) == 0.0
        assert bool((m["D"] == 1).all()) and bool((m["norm"] == 1).all())
        assert not torch.equal(m["in_proj"][0], m["in_proj"][1])
        if cfg.hybrid_attn_every:
            assert float(tp["shared_w_in"].std()) == pytest.approx(
                (2 * cfg.d_model) ** -0.5, rel=0.05)
            assert tp["shared_attn"]["attn"]["wq"].ndim == 2


@pytest.mark.parametrize("arch", SSM_ARCHS)
def test_ssm_params_bridge_round_trip(arch):
    jc = jget_config(arch, smoke=True)
    jp = jax.device_get(js.init_ssm_lm(jax.random.PRNGKey(2), jc))
    tp = lm_params_from_jax(jp)
    assert tuple(tp["mamba"]["in_proj"].shape) == jp["mamba"]["in_proj"].shape
    back = lm_params_to_jax(tp)
    flat_j = jax.tree_util.tree_leaves_with_path(jp)
    flat_b = jax.tree_util.tree_leaves_with_path(back)
    assert [p for p, _ in flat_j] == [p for p, _ in flat_b]
    for (path, a), (_, b) in zip(flat_j, flat_b):
        assert b.dtype == np.asarray(a).dtype, path
        np.testing.assert_array_equal(b, np.asarray(a))


def test_serve_and_cli_take_the_ssm_archs(capsys):
    from repro_torch.launch import serve as tserve
    out = tserve.serve("zamba2-2.7b", batch=2, prompt_len=16, gen_len=2,
                       n_requests=3, device="cpu")
    assert out["requests"] == 3 and out["host_syncs"] == out["ticks"]
    assert out["admissions"] == 2
    with pytest.raises(ValueError, match="ssm_chunk"):
        tserve.make_lm_engine(get_config("mamba2-130m", smoke=True),
                              batch=2, prompt_len=12, device="cpu")
    cli = tserve.main(["--arch", "mamba2-130m", "--device", "cpu",
                       "--slots", "2", "--requests", "2", "--gen", "2",
                       "--fixed"])
    assert cli["requests"] == 2
    assert "[mamba2-130m] 2 requests" in capsys.readouterr().out


def test_train_loss_ssm_raises():
    """The registry hands out the SSM training loss; it refuses a
    sequence that is not a whole number of SSD chunks (its parity with
    the reference is in tests/test_torch_lm_train.py)."""
    cfg = get_config("mamba2-130m", smoke=True)
    assert get_api(cfg).train_loss is ts.train_loss_ssm
    params = get_api(cfg).init(torch.Generator().manual_seed(0), cfg)
    tokens = torch.zeros((1, cfg.ssm_chunk + 1), dtype=torch.int32)
    with pytest.raises(ValueError, match="chunk-aligned"):
        get_api(cfg).train_loss(params, {"tokens": tokens,
                                         "labels": tokens}, cfg)
