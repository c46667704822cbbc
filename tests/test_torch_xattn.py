"""The audio and VLM language models of the port (whisper-medium's
encoder-decoder, llama-3.2-vision-11b's cross-attention layers) against
the JAX reference, on the CPU (SMOKE sizes: whisper-smoke 2 encoder + 2
decoder layers over 24 frames, llama-vision-smoke 4 self + 2 cross
layers over 18 image tokens).

Inputs are numpy arrays from a seed, passed to both packages (the stub
frames and image embeddings included: parity never depends on either
package's own draws); params are the reference's ``init_transformer``
draws carried over by ``bridge.lm_params_from_jax``, with the zero
biases and unit norms of the layer-norm trunk perturbed so that their
paths run.

  * ``chunked_attention`` non-causal over 1,500 and 1,601 keys (one
    chunk of 1,024 and a padded second, masked as the reference's
    ``valid``), float32 to 1e-5.
  * ``_encode``, ``trunk_forward`` with the memory (hidden, k/v,
    xk/xv), ``prefill`` with ``prompt_lengths``, ``decode_hidden`` over
    three steps and ``decode_step``, in float32 to F32_REL (max error
    over max magnitude) and bfloat16 to BF16_REL (the reference's own
    bound); decode past the learned-position table (the reference's
    clamp to its last row).
  * prefill over S + 1 tokens against prefill over S and one decode: the
    VLM's agree (float32 to F32_REL); whisper's agree once the decode's
    position term is taken as the reference's decode takes it (the
    row's first element, ROADMAP C28), in both packages.
  * ``LMServingEngine`` on both SMOKE configs in float32 against the
    reference's under accept-always, fixed R and a policy escalating on
    confidence (ROADMAP C6: the MI's standard error is ill-conditioned
    on these near-uniform softmaxes): two slots, three requests.  whisper's third waits for the pool to
    drain and rebase (no admission into a decoding pool); the VLM's
    third is admitted mid-stream, its xk/xv rows copied into its slot.
    Both engines admit every fresh pool from the free list [1, 0]
    (ROADMAP C20).  Verdicts, tokens, samples and decisions equal
    request for request, confidence and MI within 1e-5 (ROADMAP C6),
    telemetry counters equal.
  * the admission scatter copies xk/xv rows slot-locally; the stub
    draws; the params tree and scales; the bridge's round trip; the
    configs and param counts; ``serve()`` (the registry, the CLI and
    ``train_loss`` raising are in ``tests/test_torch_lm.py``).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.models import attention as jattn
from repro.models import transformer as jtr
from repro.serving import LMServingEngine as JEngine
from repro.serving import Request as JRequest
from repro.serving import TriagePolicy as JPolicy
from repro_torch.bridge import lm_params_from_jax, lm_params_to_jax
from repro_torch.configs import get_config
from repro_torch.data import tokens as ttok
from repro_torch.models import attention as tattn
from repro_torch.models import transformer as ttr
from repro_torch.serving import LMServingEngine, Request, TriagePolicy

F32_REL = 1e-5             # max error over max magnitude, float32
BF16_REL = 0.05            # the dense tests' (and the reference's) bound
ATTN_ATOL = 1e-5
FIN_ATOL = 1e-5            # ROADMAP C6
ARCHS = ("whisper-medium", "llama-3.2-vision-11b")


def _rel(want, got) -> float:
    """max |want − got| / max |want| (floor 1e-3); ``got`` a tensor or
    an array."""
    want = np.asarray(want, np.float32)
    got = (got.detach().to(torch.float32).numpy()
           if isinstance(got, torch.Tensor) else np.asarray(got, np.float32))
    return float(np.abs(want - got).max() / max(np.abs(want).max(), 1e-3))


def _t(a, dtype=None):
    t = torch.tensor(np.asarray(a))
    return t if dtype is None else t.to(dtype)


def _cfgs(arch: str, dtype: str, **over):
    jc, tc = jget_config(arch, smoke=True), get_config(arch, smoke=True)
    if dtype == "f32":
        jc = dataclasses.replace(jc, dtype=jnp.float32)
        tc = dataclasses.replace(tc, dtype=torch.float32)
    return (dataclasses.replace(jc, **over),
            dataclasses.replace(tc, **over))


def _perturb(tree, key):
    """Layer-norm biases and scales away from 0 and 1, recursively."""
    out = {}
    for name, v in tree.items():
        key, sub = jax.random.split(key)
        if isinstance(v, dict):
            out[name] = _perturb(v, sub)
        elif name.endswith("_b") or name in ("bi", "bo"):
            out[name] = 0.1 * jax.random.normal(sub, v.shape)
        elif name.startswith("ln") or name.startswith("final_norm"):
            out[name] = 1.0 + 0.1 * jax.random.normal(sub, v.shape)
        else:
            out[name] = v
    return out


def _params(jc, seed: int = 0):
    jp = jtr.init_transformer(jax.random.PRNGKey(seed), jc)
    jp = _perturb(jp, jax.random.PRNGKey(seed + 11))
    return jp, lm_params_from_jax(jax.device_get(jp))


def _memory(jc, b: int, seed: int = 5) -> dict:
    """The stub memory input of ``jc``'s family as numpy float32."""
    rng = np.random.default_rng(seed)
    if jc.encoder_layers:
        return {"frames": rng.standard_normal(
            (b, jc.n_frames, jc.d_model)).astype(np.float32)}
    return {"image_embeds": rng.standard_normal(
        (b, jc.n_image_tokens, jc.d_model)).astype(np.float32)}


def _both(extras: dict):
    return ({k: jnp.asarray(v) for k, v in extras.items()},
            {k: _t(v) for k, v in extras.items()})


@pytest.fixture(scope="module")
def bridged():
    """Both SMOKE configs' reference params and their port copies (the
    params are float32 whatever the compute dtype)."""
    out = {}
    for arch in ARCHS:
        jc, _ = _cfgs(arch, "f32")
        out[arch] = _params(jc)
    return out


# ----------------------------------------------------------------------
# attention over the memory
# ----------------------------------------------------------------------
@pytest.mark.parametrize("sk", [1500, 1601])
@pytest.mark.parametrize("valid", [None, 1493])
def test_chunked_attention_over_long_memory_matches_reference(sk, valid):
    """Non-causal over 1,500 frames / 1,601 image tokens: KV chunks of
    1,024, the second padded and masked (``kv_valid_len`` or Sk)."""
    rng = np.random.default_rng(sk)
    q = rng.standard_normal((2, 5, 2, 8)).astype(np.float32)
    k, v = (rng.standard_normal((2, sk, 2, 8)).astype(np.float32)
            for _ in range(2))
    kw = dict(causal=False, kv_valid_len=valid, chunk_q=512, chunk_kv=1024)
    want = jattn.chunked_attention(jnp.asarray(q), jnp.asarray(k),
                                   jnp.asarray(v), **kw)
    got = tattn.chunked_attention(_t(q), _t(k), _t(v), **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=ATTN_ATOL, rtol=0)


# ----------------------------------------------------------------------
# the trunk
# ----------------------------------------------------------------------
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_encode_matches_reference(bridged, dtype):
    jc, tc = _cfgs("whisper-medium", dtype)
    jp, tp = bridged["whisper-medium"]
    frames = _memory(jc, 2)["frames"]
    want = jtr._encode(jp, jnp.asarray(frames), jc)
    got = ttr._encode(tp, _t(frames), tc)
    assert got.dtype == tc.dtype and tuple(got.shape) == want.shape
    assert _rel(want, got) < (F32_REL if dtype == "f32" else BF16_REL)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_trunk_forward_with_memory_matches_reference(bridged, arch, dtype):
    jc, tc = _cfgs(arch, dtype)
    tol = F32_REL if dtype == "f32" else BF16_REL
    jp, tp = bridged[arch]
    toks = np.random.default_rng(3).integers(0, jc.vocab, (2, 10)) \
        .astype(np.int32)
    jx, tx = _both(_memory(jc, 2))
    start = np.array([0, 4], np.int32)
    jh, jaux, jcache, jmem = jtr.trunk_forward(
        jp, jnp.asarray(toks), jc, collect_cache=True,
        kv_start=jnp.asarray(start), **jx)
    th, taux, tcache, tmem = ttr.trunk_forward(
        tp, _t(toks), tc, collect_cache=True, kv_start=_t(start), **tx)
    assert float(taux) == float(jaux) == 0.0
    assert _rel(jh, th) < tol and _rel(jmem, tmem) < tol
    assert set(tcache) == set(jcache) == {"k", "v", "xk", "xv"}
    for key in tcache:
        assert tuple(tcache[key].shape) == jcache[key].shape, key
        assert _rel(jcache[key], tcache[key]) < tol, key
    n_x = jc.n_layers if jc.encoder_layers else \
        jc.n_layers // jc.cross_attn_every
    assert tcache["xk"].shape[0] == n_x


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_reference(bridged, arch, dtype):
    jc, tc = _cfgs(arch, dtype)
    tol = F32_REL if dtype == "f32" else BF16_REL
    jp, tp = bridged[arch]
    rng = np.random.default_rng(4)
    toks = rng.integers(0, jc.vocab, (2, 12)).astype(np.int32)
    lens = np.array([12, 7], np.int32)
    jx, tx = _both(_memory(jc, 2))
    jcache, jh = jtr.prefill(jp, jnp.asarray(toks), jc, cache_len=20,
                             prompt_lengths=jnp.asarray(lens), **jx)
    tcache, th = ttr.prefill(tp, _t(toks), tc, cache_len=20,
                             prompt_lengths=_t(lens), **tx)
    assert tcache["pos"] == int(jcache["pos"]) == 12
    assert set(tcache) == set(jcache)
    np.testing.assert_array_equal(tcache["start"].numpy(),
                                  np.asarray(jcache["start"]))
    for key in ("k", "v", "xk", "xv"):
        assert tuple(tcache[key].shape) == jcache[key].shape, key
        assert tcache[key].dtype == tc.dtype, key
        assert _rel(jcache[key], tcache[key]) < tol, key
    assert _rel(jh, th) < tol
    tok = toks[:, -1:]
    for step in range(3):
        jy, jcache = jtr.decode_hidden(jp, jcache, jnp.asarray(tok), jc)
        ty, tcache = ttr.decode_hidden(tp, tcache, _t(tok), tc)
        assert tcache["pos"] == int(jcache["pos"]) == 13 + step
        assert _rel(jy, ty) < tol
        assert _rel(jcache["k"], tcache["k"]) < tol
        tok = rng.integers(0, jc.vocab, (2, 1)).astype(np.int32)
    jl, _ = jtr.decode_step(jp, jcache, jnp.asarray(tok), jc)
    tl, _ = ttr.decode_step(tp, tcache, _t(tok), tc)
    assert tuple(tl.shape) == jl.shape == (jc.uq_samples, 2,
                                           jc.vocab_padded)
    assert _rel(jl, tl) < tol


def test_decode_past_the_learned_positions_clamps_as_the_reference():
    """A learned-position table of 14 rows and prompts of 12: decode at
    positions 12 to 15, the last two past the table, where the
    reference's ``dynamic_slice_in_dim`` clamps to the last row."""
    jc, tc = _cfgs("whisper-medium", "f32", learned_pos=14)
    jp, tp = _params(jc, seed=1)
    toks = np.random.default_rng(6).integers(0, jc.vocab, (2, 12)) \
        .astype(np.int32)
    jx, tx = _both(_memory(jc, 2))
    jcache, _ = jtr.prefill(jp, jnp.asarray(toks), jc, cache_len=18, **jx)
    tcache, _ = ttr.prefill(tp, _t(toks), tc, cache_len=18, **tx)
    rows = []
    for step in range(4):
        tok = toks[:, step:step + 1]
        jy, jcache = jtr.decode_hidden(jp, jcache, jnp.asarray(tok), jc)
        ty, tcache = ttr.decode_hidden(tp, tcache, _t(tok), tc)
        assert _rel(jy, ty) < F32_REL
        rows.append(float(ttr._learned_position(tp, 12 + step, tc)))
    last = float(tp["pos_embed"][13, 0])
    assert rows[1:] == [last] * 3 and rows[0] == float(tp["pos_embed"][12, 0])


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_prefill_one_token_longer(bridged, arch):
    """The last hidden of prefill over S + 1 tokens against prefill over
    S and one ``decode_hidden``, float32, in both packages.  The VLM's
    agree.  whisper's decode adds only the first element of the
    position row (ROADMAP C28, the reference's ``pe[None, 0:1, 0]``):
    its decode agrees with a prefill whose table has row S replaced by
    that element, and not with the plain prefill."""
    jc, tc = _cfgs(arch, "f32")
    jp, tp = bridged[arch]
    toks = np.random.default_rng(7).integers(0, jc.vocab, (2, 9)) \
        .astype(np.int32)
    jx, tx = _both(_memory(jc, 2))
    s = 8
    jcache, _ = jtr.prefill(jp, jnp.asarray(toks[:, :s]), jc, cache_len=12,
                            **jx)
    tcache, _ = ttr.prefill(tp, _t(toks[:, :s]), tc, cache_len=12, **tx)
    jy, _ = jtr.decode_hidden(jp, jcache, jnp.asarray(toks[:, s:]), jc)
    ty, _ = ttr.decode_hidden(tp, tcache, _t(toks[:, s:]), tc)
    _, jfull = jtr.prefill(jp, jnp.asarray(toks), jc, cache_len=12, **jx)
    _, tfull = ttr.prefill(tp, _t(toks), tc, cache_len=12, **tx)
    if not jc.learned_pos:
        assert _rel(jfull, jy) < F32_REL and _rel(tfull, ty) < F32_REL
        return
    assert _rel(jfull, jy) > 0.05 and _rel(tfull, ty) > 0.05
    jpe = jp["pos_embed"].at[s].set(jp["pos_embed"][s, 0])
    tpe = tp["pos_embed"].clone()
    tpe[s] = tp["pos_embed"][s, 0]
    _, jalt = jtr.prefill(dict(jp, pos_embed=jpe), jnp.asarray(toks), jc,
                          cache_len=12, **jx)
    _, talt = ttr.prefill(dict(tp, pos_embed=tpe), _t(toks), tc,
                          cache_len=12, **tx)
    assert _rel(jalt, jy) < F32_REL and _rel(talt, ty) < F32_REL
    assert _rel(jy, ty) < F32_REL


# ----------------------------------------------------------------------
# the engine
# ----------------------------------------------------------------------
POLICIES = {
    "accept_always": (dict(conf_threshold=0.0, mi_threshold=1e9, r_min=4,
                           r_max=8), True),
    "fixed": (dict(conf_threshold=0.0, mi_threshold=1e9, r_min=4,
                   r_max=20), False),
    # escalation on confidence: its standard error is a difference of
    # float32 sums of p² and p (p ~ 1/30) and well conditioned, while
    # the mutual information's is one of squared entropies near
    # log(512) and differs between the packages by up to a third at
    # R = 4 on these near-uniform softmaxes (ROADMAP C6)
    "escalating": (dict(conf_threshold=0.03, mi_threshold=1e9, r_min=4,
                        r_max=20), True),
}


def _fresh_pools_from_1_0(eng):
    """Every fresh pool admits from the free list [1, 0], so that the
    reference's first admission puts each cache row in its own slot
    (ROADMAP C20); whisper's pool rebases after each drain."""
    admit = eng._admit

    def admit_sorted():
        if eng.cache is None:
            eng.free.sort(reverse=True)
        admit()
    eng._admit = admit_sorted


@pytest.mark.parametrize("name", list(POLICIES))
@pytest.mark.parametrize("arch", ARCHS)
def test_xattn_engine_matches_reference(bridged, arch, name):
    jc, tc = _cfgs(arch, "f32")
    jp, tp = bridged[arch]
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, jc.vocab, (n,)).astype(np.int32)
               for n in (8, 5, 7)]
    policy, adaptive = POLICIES[name]
    jx, tx = _both(_memory(jc, 2, seed=9))
    kw = dict(n_slots=2, prompt_len=8, cache_len=24, adaptive_mode=adaptive)
    jeng = JEngine(jp, jc, policy=JPolicy(**policy), extras=jx, **kw)
    teng = LMServingEngine(tp, tc, policy=TriagePolicy(**policy),
                           extras=tx, device="cpu", **kw)
    deltas = []
    scatter = teng._align_scatter
    teng._align_scatter = lambda new, idx, take, delta: (
        deltas.append(delta), scatter(new, idx, take, delta))
    for eng, req in ((jeng, JRequest), (teng, Request)):
        _fresh_pools_from_1_0(eng)
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
    assert teng.admissions == 2 and len(deltas) == 2
    if arch == "whisper-medium":      # the third waits for the drain
        assert not teng.midstream_ok and deltas == [0, 0]
    else:                             # the third joins the decoding pool
        assert teng.midstream_ok and deltas[0] == 0 and deltas[1] > 0
    if name != "escalating":
        assert tout["decisions"] == 9
    else:
        assert tout["telemetry"]["rounds"] > tout["telemetry"]["dispatches"]


@pytest.mark.parametrize("arch", ARCHS)
def test_admission_copies_memory_rows_into_their_slots(bridged, arch):
    """A fresh pool under the default free list and an admission into
    a decoding pool: each slot's xk/xv rows are its own request's
    prefill rows, whatever the slot and the clock (``_align_scatter``'s
    slot-local branch); k/v and start are re-based only for RoPE."""
    jc, tc = _cfgs(arch, "f32")
    _, tp = bridged[arch]
    _, tx = _both(_memory(jc, 3, seed=2))
    prompts = np.random.default_rng(2).integers(0, tc.vocab, (3, 8)) \
        .astype(np.int32)
    eng = LMServingEngine(tp, tc, n_slots=3, prompt_len=8, cache_len=20,
                          extras=tx, telemetry=False, device="cpu")
    for i in range(2):
        eng.submit(Request(rid=i, payload=prompts[i], max_new_tokens=3))
    eng._admit()
    assert [s.req.rid if s.req else None for s in eng.slots] == \
        [None, 1, 0]
    new, _ = ttr.prefill(tp, _t(prompts), tc, cache_len=20,
                         prompt_lengths=_t([8, 8, 8]), **tx)
    for slot, row in ((2, 0), (1, 1)):
        for key in ("xk", "xv", "k", "v"):
            assert torch.equal(eng.cache[key][:, slot], new[key][:, row])
    eng.cache = dict(eng.cache, pos=11)           # a decoding pool
    pool = {k: v.clone() for k, v in eng.cache.items() if k != "pos"}
    eng._align_scatter(new, torch.tensor([0]), 1, 3)
    for key in ("xk", "xv"):
        assert torch.equal(eng.cache[key][:, 0], new[key][:, 0])
        assert torch.equal(eng.cache[key][:, 1:], pool[key][:, 1:])
    assert torch.equal(eng.cache["v"][:, 0],
                       torch.roll(new["v"][:, 0], 3, dims=1))
    assert int(eng.cache["start"][0]) == 3


# ----------------------------------------------------------------------
# params, bridge, data, registry, serve
# ----------------------------------------------------------------------
@pytest.mark.parametrize("arch", ARCHS)
def test_params_match_reference_tree_and_scales(arch):
    from repro_torch.launch.serve import params_init
    cfg = get_config(arch, smoke=True)
    tp = params_init(cfg, 3, "cpu")
    jp = jtr.init_transformer(jax.random.PRNGKey(0),
                              jget_config(arch, smoke=True))
    jtree = jax.tree_util.tree_map(lambda a: (a.shape, str(a.dtype)), jp)
    ttree = jax.tree_util.tree_map(
        lambda t: (tuple(t.shape), str(t.dtype).replace("torch.", "")), tp)
    assert ttree == jtree
    if cfg.encoder_layers:
        for table in (tp["pos_embed"], tp["encoder"]["pos_embed"]):
            assert float(table.std()) == pytest.approx(0.02, rel=0.1)
        wq = tp["blocks"]["xattn"]["wq"]
    else:
        wq = tp["blocks_cross"]["attn"]["wq"]
    assert float(wq.std()) == pytest.approx(cfg.d_model ** -0.5, rel=0.1)


@pytest.mark.parametrize("arch", ARCHS)
def test_params_bridge_round_trip(arch):
    jc = jget_config(arch, smoke=True)
    jp = jax.device_get(jtr.init_transformer(jax.random.PRNGKey(2), jc))
    back = lm_params_to_jax(lm_params_from_jax(jp))
    flat_j = jax.tree_util.tree_leaves_with_path(jp)
    flat_b = jax.tree_util.tree_leaves_with_path(back)
    assert [p for p, _ in flat_j] == [p for p, _ in flat_b]
    for (path, a), (_, b) in zip(flat_j, flat_b):
        assert b.dtype == np.asarray(a).dtype, path
        np.testing.assert_array_equal(b, np.asarray(a))


def test_stub_embeddings_are_pure_draws():
    cfg = ttok.TokenPipelineConfig(vocab=512, seq_len=8, global_batch=2,
                                   seed=3)
    f = ttok.stub_frames(cfg, 24, 64, 0, 2)
    assert f.dtype == torch.float32 and tuple(f.shape) == (2, 24, 64)
    assert torch.equal(f, ttok.stub_frames(cfg, 24, 64, 0, 2))
    assert not torch.equal(f, ttok.stub_frames(cfg, 24, 64, 1, 2))
    img = ttok.stub_image_embeds(cfg, 24, 64, 0, 2)
    assert not torch.equal(f, img)
    other = dataclasses.replace(cfg, seed=4)
    assert not torch.equal(img, ttok.stub_image_embeds(other, 24, 64, 0, 2))
    assert abs(float(img.std()) - 1.0) < 0.05


@pytest.mark.parametrize("arch", ARCHS)
def test_configs_and_param_counts_match_reference(arch):
    for smoke in (False, True):
        cfg, jc = get_config(arch, smoke), jget_config(arch, smoke)
        assert {k: v for k, v in dataclasses.asdict(jc).items()
                if k != "dtype"} == \
            {k: v for k, v in dataclasses.asdict(cfg).items()
             if k != "dtype"}
        assert cfg.param_count() == jc.param_count()
        assert cfg.vocab_padded == jc.vocab_padded


def test_serve_takes_the_xattn_archs():
    from repro_torch.launch import serve as tserve
    out = tserve.serve("llama-3.2-vision-11b", batch=2, prompt_len=8,
                       gen_len=2, n_requests=3, device="cpu")
    assert out["requests"] == 3 and out["host_syncs"] == out["ticks"]
    assert out["admissions"] == 2
    extras = tserve.lm_extras(get_config("whisper-medium"), 4)
    assert tuple(extras["frames"].shape) == (4, 1500, 1024)
    shapes = tserve.lm_layer_shapes(get_config("llama-3.2-vision-11b"))
    assert len(shapes) == 4 * 40 + 1 and shapes[-1].d_out == 128256
