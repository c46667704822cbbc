"""The MoE family and the rolling sliding-window cache of the port
against the JAX reference, on the CPU (SMOKE sizes).

  * ``moe_apply`` at (E, k) = (4, 2), (8, 2), (16, 8) in float32 and
    bfloat16, with pairs dropped at the capacity: the routing (the
    reference's ``lax.top_k``) and the keep mask (its trash-slot
    ``where``) equal, aux within 1e-6, y within 1e-5 (float32) or the
    dense tests' bf16 bound BF16_REL (max error over max magnitude).
  * the combine at k = 8 in bf16 equals the reference's scatter-add bit
    for bit (its order matters there; another order is shown to
    differ); a router with duplicated columns ties gates, and the lower
    expert wins as in ``lax.top_k``.
  * ``decode_attention``/``cache_update`` with ``rolling=True``, with
    and without ``start`` (which the reference ignores there, ROADMAP
    C25), before and after the cache wraps.
  * ``prefill`` past the window (a rolling cache of the window's size,
    then rolling decode), and its refusal of ``prompt_lengths``.
  * mixtral-8x7b's and qwen3-moe-235b-a22b's SMOKE ``prefill`` +
    ``decode_hidden`` + ``decode_step`` in float32 and bf16.
  * ``LMServingEngine`` on mixtral's SMOKE config at cache_len 16 (its
    window), the third request admitted mid-stream, both engines from
    the free list [1, 0] (ROADMAP C20), under accept-always, escalating
    and fixed R: verdicts, samples, host syncs and telemetry equal.
  * the MoE params' tree and scales, the bridge's round trip of a MoE
    tree, ``serve`` and the CLI on both MoE archs.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models.moe as jmoe
from repro.configs import get_config as jget_config
from repro.models import attention as jattn
from repro.models import transformer as jtr
from repro.serving import LMServingEngine as JEngine
from repro.serving import Request as JRequest
from repro.serving import TriagePolicy as JPolicy
from repro_torch.bridge import lm_params_from_jax, lm_params_to_jax
from repro_torch.configs import get_config
from repro_torch.models import attention as tattn
from repro_torch.models import moe as tmoe
from repro_torch.models import transformer as ttr
from repro_torch.serving import LMServingEngine, Request, TriagePolicy

F32_REL = 1e-5
BF16_REL = 0.05            # the dense tests' (and the reference's) bound
Y_ATOL = 1e-5
AUX_ATOL = 1e-6
ATTN_ATOL = 1e-5
FIN_ATOL = 1e-5            # ROADMAP C6
MOE_ARCHS = ("mixtral-8x7b", "qwen3-moe-235b-a22b")


def _rel(want, got) -> float:
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
    return jp, lm_params_from_jax(jax.device_get(jp))


class _Recorded:
    """The reference's routing (``lax.top_k``) and keep mask (the
    condition of ``moe.py``'s first ``jnp.where``) as it computes them."""

    def __init__(self, monkeypatch):
        self.top_k, self.keep = [], []
        top_k = jax.lax.top_k

        def rec_top_k(x, k):
            out = top_k(x, k)
            self.top_k.append(np.asarray(out[1]))
            return out

        rec = self

        class _Jnp:
            def __getattr__(self, name):
                return getattr(jnp, name)

            @staticmethod
            def where(cond, *a):
                if len(rec.keep) < len(rec.top_k):
                    rec.keep.append(np.asarray(cond))
                return jnp.where(cond, *a)

        monkeypatch.setattr(jax.lax, "top_k", rec_top_k)
        monkeypatch.setattr(jmoe, "jnp", _Jnp())


def _moe_case(e: int, f: int = 48, d: int = 32, seed: int = 0,
              tie: bool = False):
    """x [3, 5, D] and experts of E, the router's first column tilted so
    that expert 0 overflows its capacity; ``tie``: every odd column a
    copy of the one before it (gates tie in pairs)."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((3, 5, d)).astype(np.float32)
    router = (rng.standard_normal((d, e)) / np.sqrt(d)).astype(np.float32)
    router[:, 0] += x.reshape(-1, d).mean(0) / 2
    if tie:
        router[:, 1::2] = router[:, 0::2]
    wi, wg = ((rng.standard_normal((e, d, f)) / np.sqrt(d)).astype(np.float32)
              for _ in range(2))
    wo = (rng.standard_normal((e, f, d)) / np.sqrt(f)).astype(np.float32)
    return x, router, wi, wg, wo


def _both_moe(monkeypatch, arrays, k: int, dtype: str):
    jdt, tdt = ((jnp.float32, torch.float32) if dtype == "f32"
                else (jnp.bfloat16, torch.bfloat16))
    rec = _Recorded(monkeypatch)
    jy, jaux = jmoe.moe_apply(*(jnp.asarray(a, jdt) for a in arrays),
                              top_k=k)
    routed = []
    route = tmoe.route

    def rec_route(*a):
        out = route(*a)
        routed.append(out[2])
        return out

    monkeypatch.setattr(tmoe, "route", rec_route)
    ty, taux = tmoe.moe_apply(*(_t(a, tdt) for a in arrays), top_k=k)
    return rec, (jy, jaux), routed[0], (ty, taux)


# ----------------------------------------------------------------------
# moe_apply
# ----------------------------------------------------------------------
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("e,k", [(4, 2), (8, 2), (16, 8)])
def test_moe_apply_matches_reference(monkeypatch, e, k, dtype):
    arrays = _moe_case(e)
    rec, (jy, jaux), experts, (ty, taux) = _both_moe(monkeypatch, arrays,
                                                     k, dtype)
    np.testing.assert_array_equal(experts.numpy(), rec.top_k[0])
    t = arrays[0].shape[0] * arrays[0].shape[1]
    capacity = int(max(k, 1.25 * t * k / e))
    _, _, keep = tmoe.dispatch(experts, e, capacity)
    np.testing.assert_array_equal(keep.numpy(), rec.keep[0])
    assert not bool(keep.all())                       # some pairs drop
    assert abs(float(taux) - float(jaux)) <= AUX_ATOL
    assert ty.dtype == (torch.float32 if dtype == "f32" else torch.bfloat16)
    if dtype == "f32":
        np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=Y_ATOL,
                                   rtol=0)
    else:
        assert _rel(jy.astype(jnp.float32), ty) < BF16_REL


def test_moe_combine_adds_in_sorted_pair_order():
    """At k = 8 in bf16 the order of a token's additions matters; the
    port's combine equals the reference's ``.at[token_sorted].add``
    bit for bit, and adding the same pairs in reverse does not."""
    rng = np.random.default_rng(5)
    t, k, d, e = 24, 8, 16, 16
    experts = np.stack([rng.permutation(e)[:k] for _ in range(t)])
    contrib = (rng.standard_normal((t * k, d))
               * 10.0 ** rng.integers(-3, 3, (t * k, 1))).astype(np.float32)
    order, _, _ = tmoe.dispatch(_t(experts).long(), e, t * k)
    want = jnp.zeros((t, d), jnp.bfloat16).at[
        jnp.asarray(order.numpy() // k)].add(jnp.asarray(contrib,
                                                         jnp.bfloat16))
    got = tmoe.combine(_t(contrib, torch.bfloat16), order, k)
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want.astype(jnp.float32)))
    place = torch.empty_like(order)
    place[order] = torch.arange(order.numel())
    mine, _ = torch.sort(place.reshape(t, k), dim=1)
    backward = torch.zeros((t, d), dtype=torch.bfloat16)
    for j in reversed(range(k)):
        backward = backward + _t(contrib, torch.bfloat16)[mine[:, j]]
    assert not torch.equal(backward, got)


def test_router_ties_pick_the_lower_expert(monkeypatch):
    arrays = _moe_case(8, tie=True)
    rec, (jy, jaux), experts, (ty, taux) = _both_moe(monkeypatch, arrays, 3,
                                                     "f32")
    np.testing.assert_array_equal(experts.numpy(), rec.top_k[0])
    pairs = experts[:, :2]
    tied = pairs[:, 0] // 2 == pairs[:, 1] // 2       # a tie's two experts
    assert bool(tied.any())
    assert bool((pairs[tied, 0] < pairs[tied, 1]).all())
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=Y_ATOL,
                               rtol=0)
    assert abs(float(taux) - float(jaux)) <= AUX_ATOL


# ----------------------------------------------------------------------
# the rolling cache
# ----------------------------------------------------------------------
@pytest.mark.parametrize("pos", [5, 13, 23])
@pytest.mark.parametrize("with_start", [False, True])
def test_rolling_decode_attention_and_cache_update(pos, with_start):
    """A circular cache of 8 slots under a window of 6, before (pos 5)
    and after it wraps; ``start`` is ignored by both (ROADMAP C25)."""
    rng = np.random.default_rng(6)
    q = rng.standard_normal((3, 1, 4, 8)).astype(np.float32)
    ck, cv = (rng.standard_normal((3, 8, 2, 8)).astype(np.float32)
              for _ in range(2))
    kn, vn = (rng.standard_normal((3, 1, 2, 8)).astype(np.float32)
              for _ in range(2))
    start = np.array([0, 3, 6], np.int32)
    jck, jcv = jattn.cache_update(jnp.asarray(ck), jnp.asarray(cv),
                                  jnp.asarray(kn), jnp.asarray(vn),
                                  jnp.int32(pos), rolling=True)
    tck, tcv = tattn.cache_update(_t(ck), _t(cv), _t(kn), _t(vn), pos,
                                  rolling=True)
    np.testing.assert_array_equal(tck.numpy(), np.asarray(jck))
    np.testing.assert_array_equal(tcv.numpy(), np.asarray(jcv))
    jkw = dict(window=6, rolling=True,
               start=jnp.asarray(start) if with_start else None)
    tkw = dict(window=6, rolling=True,
               start=_t(start) if with_start else None)
    want = jattn.decode_attention(jnp.asarray(q), jck, jcv, jnp.int32(pos),
                                  **jkw)
    got = tattn.decode_attention(_t(q), tck, tcv, pos, **tkw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=ATTN_ATOL, rtol=0)
    if with_start:                               # C25: start changes nothing
        plain = tattn.decode_attention(_t(q), tck, tcv, pos, window=6,
                                       rolling=True)
        assert torch.equal(got, plain)


@pytest.mark.parametrize("s", [12, 20])
def test_prefill_past_the_window_matches_reference(s):
    """mixtral's SMOKE config (window 16) at cache_len 24: a rolling
    cache of 16 slots, then rolling decode; with prompt_lengths both
    refuse."""
    jc, tc = _cfgs("mixtral-8x7b", "f32")
    jp, tp = _params(jc)
    toks = np.random.default_rng(7).integers(0, jc.vocab, (2, s)).astype(
        np.int32)
    jcache, jh = jtr.prefill(jp, jnp.asarray(toks), jc, cache_len=24)
    tcache, th = ttr.prefill(tp, _t(toks), tc, cache_len=24)
    assert tuple(tcache["k"].shape) == jcache["k"].shape
    assert tcache["k"].shape[2] == jc.swa_window
    assert tcache["pos"] == int(jcache["pos"]) == s
    for want, got in ((jh, th), (jcache["k"], tcache["k"]),
                      (jcache["v"], tcache["v"])):
        assert _rel(want, got) < F32_REL
    tok = toks[:, -1:]
    for step in range(2):
        jx, jcache = jtr.decode_hidden(jp, jcache, jnp.asarray(tok), jc)
        tx, tcache = ttr.decode_hidden(tp, tcache, _t(tok), tc)
        assert _rel(jx, tx) < F32_REL
        assert _rel(jcache["k"], tcache["k"]) < F32_REL
        tok = toks[:, step:step + 1]
    lens = np.array([s, s - 3], np.int32)
    with pytest.raises(ValueError, match="rolling"):
        jtr.prefill(jp, jnp.asarray(toks), jc, cache_len=24,
                    prompt_lengths=jnp.asarray(lens))
    with pytest.raises(ValueError, match="rolling"):
        ttr.prefill(tp, _t(toks), tc, cache_len=24,
                    prompt_lengths=_t(lens))


# ----------------------------------------------------------------------
# the trunk
# ----------------------------------------------------------------------
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_prefill_and_decode_match_reference(arch, dtype):
    """Left-padded prefill (cache_len 9: the prompt front-truncated,
    and 16), three ``decode_hidden`` steps (mixtral's rolling,
    start ignored; qwen3-moe's linear, start applied) and a
    ``decode_step``."""
    jc, tc = _cfgs(arch, dtype)
    tol = F32_REL if dtype == "f32" else BF16_REL
    jp, tp = _params(jc)
    rng = np.random.default_rng(3)
    toks = rng.integers(0, jc.vocab, (2, 12)).astype(np.int32)
    lens = np.array([12, 7], np.int32)
    for cache_len in (9, 16):
        jcache, jh = jtr.prefill(jp, jnp.asarray(toks), jc,
                                 cache_len=cache_len,
                                 prompt_lengths=jnp.asarray(lens))
        tcache, th = ttr.prefill(tp, _t(toks), tc, cache_len=cache_len,
                                 prompt_lengths=_t(lens))
        assert th.dtype == tc.dtype and tcache["k"].dtype == tc.dtype
        np.testing.assert_array_equal(tcache["start"].numpy(),
                                      np.asarray(jcache["start"]))
        for want, got in ((jh, th), (jcache["k"], tcache["k"]),
                          (jcache["v"], tcache["v"])):
            assert _rel(want, got) < tol
    tok = toks[:, -1:]
    for step in range(3):
        jx, jcache = jtr.decode_hidden(jp, jcache, jnp.asarray(tok), jc)
        tx, tcache = ttr.decode_hidden(tp, tcache, _t(tok), tc)
        assert tcache["pos"] == int(jcache["pos"]) == 13 + step
        assert _rel(jx, tx) < tol
        assert _rel(jcache["k"], tcache["k"]) < tol
        tok = rng.integers(0, jc.vocab, (2, 1)).astype(np.int32)
    jl, _ = jtr.decode_step(jp, jcache, jnp.asarray(tok), jc)
    tl, _ = ttr.decode_step(tp, tcache, _t(tok), tc)
    assert tuple(tl.shape) == jl.shape == (jc.uq_samples, 2,
                                           jc.vocab_padded)
    assert _rel(jl, tl) < tol


def test_moe_aux_is_summed_over_the_layers():
    jc, tc = _cfgs("qwen3-moe-235b-a22b", "f32")
    jp, tp = _params(jc)
    toks = np.random.default_rng(8).integers(0, jc.vocab, (2, 10)).astype(
        np.int32)
    _, jaux, _, _ = jtr.trunk_forward(jp, jnp.asarray(toks), jc)
    _, taux, _, _ = ttr.trunk_forward(tp, _t(toks), tc)
    assert float(taux) > 0
    assert abs(float(taux) - float(jaux)) <= jc.n_layers * AUX_ATOL


# ----------------------------------------------------------------------
# the engine
# ----------------------------------------------------------------------
POLICIES = {
    "accept_always": (dict(conf_threshold=0.0, mi_threshold=1e9, r_min=4,
                           r_max=8), True),
    "escalating": (dict(conf_threshold=0.0, mi_threshold=0.015, r_min=4,
                        r_max=20), True),
    "fixed_r": (dict(conf_threshold=0.0, mi_threshold=1e9, r_min=4,
                     r_max=20), False),
}


@pytest.fixture(scope="module")
def mixtral_f32():
    jc, tc = _cfgs("mixtral-8x7b", "f32")
    jp, tp = _params(jc)
    prompts = np.random.default_rng(1).integers(
        0, jc.vocab, (3, 8)).astype(np.int32)
    return jc, tc, jp, tp, prompts


@pytest.mark.parametrize("name", list(POLICIES))
def test_moe_engine_matches_reference(mixtral_f32, name):
    jc, tc, jp, tp, prompts = mixtral_f32
    policy, adaptive = POLICIES[name]
    jeng = JEngine(jp, jc, n_slots=2, prompt_len=8, cache_len=16,
                   policy=JPolicy(**policy), adaptive_mode=adaptive)
    teng = LMServingEngine(tp, tc, n_slots=2, prompt_len=8, cache_len=16,
                           policy=TriagePolicy(**policy),
                           adaptive_mode=adaptive, device="cpu")
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
    assert teng.admissions == 2                   # the third mid-stream
    if name == "accept_always":
        assert tout["decisions"] == 9
    if name == "escalating":
        assert tout["telemetry"]["rounds"] > tout["telemetry"]["dispatches"]
    if name == "fixed_r":
        assert tout["mean_samples_per_decision"] == 20


# ----------------------------------------------------------------------
# params, bridge, serve
# ----------------------------------------------------------------------
def test_moe_params_match_reference_tree_and_scales():
    from repro_torch.launch.serve import params_init
    for arch in MOE_ARCHS:
        cfg = get_config(arch, smoke=True)
        tp = params_init(cfg, 3, "cpu")
        jp = jtr.init_transformer(jax.random.PRNGKey(0),
                                  jget_config(arch, smoke=True))
        jtree = jax.tree_util.tree_map(lambda a: (a.shape, str(a.dtype)),
                                       jp)
        ttree = jax.tree_util.tree_map(
            lambda t: (tuple(t.shape), str(t.dtype).replace("torch.", "")),
            tp)
        assert ttree == jtree
        moe = tp["blocks"]["moe"]
        for name, fan_in in (("router", cfg.d_model), ("wi", cfg.d_model),
                             ("wg", cfg.d_model), ("wo", cfg.d_ff)):
            assert float(moe[name].std()) == pytest.approx(
                fan_in ** -0.5, rel=0.05), name
        assert not torch.equal(moe["wi"][0], moe["wi"][1])


def test_moe_params_bridge_round_trip():
    jc = jget_config("mixtral-8x7b", smoke=True)
    jp = jax.device_get(jtr.init_transformer(jax.random.PRNGKey(2), jc))
    tp = lm_params_from_jax(jp)
    assert tuple(tp["blocks"]["moe"]["wi"].shape) == (
        jc.n_layers, jc.n_experts, jc.d_model, jc.d_ff)
    back = lm_params_to_jax(tp)
    flat_j = jax.tree_util.tree_leaves_with_path(jp)
    flat_b = jax.tree_util.tree_leaves_with_path(back)
    assert [p for p, _ in flat_j] == [p for p, _ in flat_b]
    for (path, a), (_, b) in zip(flat_j, flat_b):
        assert b.dtype == np.asarray(a).dtype, path
        np.testing.assert_array_equal(b, np.asarray(a))


def test_serve_and_cli_take_the_moe_archs(capsys):
    from repro_torch.launch import serve as tserve
    out = tserve.serve("mixtral-8x7b", batch=2, prompt_len=8, gen_len=2,
                       n_requests=3, device="cpu")
    assert out["requests"] == 3 and out["host_syncs"] == out["ticks"]
    assert out["admissions"] == 2
    eng = tserve.make_lm_engine(get_config("mixtral-8x7b", smoke=True),
                                batch=2, prompt_len=8, gen_len=4,
                                device="cpu")
    assert eng.cache_len == 16                      # capped at the window
    cli = tserve.main(["--arch", "qwen3-moe-235b-a22b", "--device", "cpu",
                       "--slots", "2", "--requests", "2", "--gen", "2",
                       "--prompt-len", "6", "--fixed"])
    assert cli["requests"] == 2
    assert "[qwen3-moe-235b-a22b] 2 requests" in capsys.readouterr().out
