"""The GRNG's other granularities, the moment mode and the host-tiled
hoist in the port against the JAX reference, on numpy-seeded inputs.

Tolerances:
  * integer streams (``tile_seeds``, ``cell_selections``,
    ``selection_stream``, tile ``selections``) and
    ``enumerate_reachable``'s count and frequencies: bit for bit;
  * tile/cell raw sums and ε on a ragged 96×80 block, R = 6, ideal and
    aged die (imprint and read noise): bit for bit (the 16 terms summed
    in the order the reference's contraction gives);
  * paper-mode logit samples at tile/cell: rtol/atol 1e-5 (C6's
    standard: matrix products of depth K in another order);
  * ``logit_moments``: rtol 1e-6 (a 16-term variance, then depth-K
    products); moment-mode samples on statistics only (the generators
    differ): 4,096 draws, mean within 5 standard errors and variance
    within 10 % of the analytic ones;
  * the chunk-hoisted basis against the reference's host chunks: rtol
    1e-6; ``update_stats_streamed`` against the dense
    ``update_stats(mix_samples(...))`` and against the reference's
    streamed update: rtol/atol 1e-5 (``tests/test_decision_kernel.py:
    144-170``);
  * a chunk-hoisted SAR head serves 16 fog-mixed requests with the
    dense head's verdicts, fused and not (``tests/
    test_decision_kernel.py:246-268``; confidence and MI within 1e-5).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import clt_grng as jg
from repro.core import lfsr as jl
from repro.core import sampling as js
from repro.hw import VariationSpec as JVariationSpec
from repro.hw import sample_instances as j_sample
from repro.serving import adaptive as jad
from repro_torch.core import clt_grng as tg
from repro_torch.core import lfsr as tl
from repro_torch.core import sampling as ts
from repro_torch.serving import adaptive as tad

AGE_30D = 30 * 86400.0


def _port_grng(cfg):
    return tg.GRNGConfig(**{f.name: getattr(cfg, f.name)
                            for f in dataclasses.fields(cfg)})


def _aged_die_grng():
    die = j_sample(11, 1, JVariationSpec().scaled(2.5))[0].at_age(AGE_30D)
    return die.grng(jg.GRNGConfig())


def _t(a):
    return torch.as_tensor(np.asarray(a).astype(np.int64))


# ----------------------------------------------------------------------
# integer streams
# ----------------------------------------------------------------------
@pytest.mark.parametrize("seed", [0, 0xACE1, 0xFFFFFFFF, 12345])
def test_tile_seeds_and_selection_stream_bit_equal(seed):
    np.testing.assert_array_equal(
        tl.tile_seeds(seed, 257).numpy(),
        np.asarray(jl.tile_seeds(seed, 257)).astype(np.int64))
    np.testing.assert_array_equal(
        tl.selection_stream(seed, 300).numpy(),
        np.asarray(jl.selection_stream(seed, 300)))


def test_cell_selections_bit_equal():
    rng = np.random.default_rng(0)
    rows = rng.integers(0, 2**32, (40, 1), dtype=np.uint64).astype(np.uint32)
    cols = rng.integers(0, 2**32, (1, 24), dtype=np.uint64).astype(np.uint32)
    for r, seed in ((0, 0xACE1), (2**32 - 1, 7), (123456, 0)):
        want = np.asarray(jl.cell_selections(jnp.asarray(rows),
                                             jnp.asarray(cols), r, seed))
        got = tl.cell_selections(_t(rows), _t(cols), r, seed)
        np.testing.assert_array_equal(got.numpy(), want)
        assert (got.sum(-1) == 8).all()


def test_enumerate_reachable_matches():
    count, freq = tl.enumerate_reachable(device="cpu")
    want_count, want_freq = jl.enumerate_reachable()
    assert count == want_count
    np.testing.assert_array_equal(freq.numpy(), np.asarray(want_freq))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            tl.enumerate_reachable()      # None means the card


# ----------------------------------------------------------------------
# tile and cell selections, sums and ε
# ----------------------------------------------------------------------
BLOCKS = {"origin": dict(sample0=0, row0=0, col0=0),
          "offset": dict(sample0=5, row0=3, col0=7)}


@pytest.mark.parametrize("block", sorted(BLOCKS))
@pytest.mark.parametrize("aged", [False, True])
@pytest.mark.parametrize("gran", ["tile", "cell"])
def test_tile_and_cell_sums_and_eps_bit_equal(gran, aged, block):
    base = _aged_die_grng() if aged else jg.GRNGConfig()
    jc = dataclasses.replace(base, granularity=gran, tile=32)
    tc = _port_grng(jc)
    kw = BLOCKS[block]
    k, n, r = 96, 80, 6
    if gran == "tile":
        got = tg.selections(tc, r, kw["sample0"], k, n, device="cpu")
        want = np.asarray(jg.selections(jc, r, kw["sample0"], k, n))
        assert got.shape == (r, 3, 3, 16)            # ragged edge tiles
        np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        tg.raw_sums(tc, k, n, r, device="cpu", **kw).numpy(),
        np.asarray(jg.raw_sums(jc, k, n, r, **kw)))
    np.testing.assert_array_equal(
        tg.eps(tc, k, n, r, device="cpu", **kw).numpy(),
        np.asarray(jg.eps(jc, k, n, r, **kw)))


def test_tile_selection_is_shared_within_a_tile_only():
    tc = tg.GRNGConfig(granularity="tile", tile=32)
    sel = tg.block_selections(tc, 96, 80, 4, device="cpu")
    assert sel.shape == (4, 96, 80, 16)
    assert torch.equal(sel[:, 0, 0], sel[:, 31, 31])
    assert not torch.equal(sel[:, 0, 0], sel[:, 32, 0])
    assert torch.equal(sel[:, 64, 64], sel[:, 95, 79])
    with pytest.raises(ValueError, match="n_rows"):
        tg.selections(tc, 4)
    with pytest.raises(ValueError, match="granularity"):
        tg.selections(dataclasses.replace(tc, granularity="cell"), 4)


# ----------------------------------------------------------------------
# paper mode at tile / cell
# ----------------------------------------------------------------------
def _head_inputs(b, k, n, seed=0):
    rng = np.random.default_rng(seed)
    mu = (rng.standard_normal((k, n)) * 0.05).astype(np.float32)
    sg = (np.log1p(np.exp(rng.standard_normal((k, n)) - 2.0))
          * 0.2).astype(np.float32)
    return mu, sg, rng.standard_normal((b, k)).astype(np.float32)


def _heads(jgrng, mode, b=5, k=40, n=9, **kw):
    mu, sg, x = _head_inputs(b, k, n)
    jh = js.BayesHeadConfig(num_samples=7, mode=mode, grng=jgrng,
                            compute_dtype=jnp.float32, **kw)
    th = ts.BayesHeadConfig(num_samples=7, mode=mode,
                            grng=_port_grng(jgrng),
                            compute_dtype=torch.float32, **kw)
    head_j = js.prepare_serving_head(jnp.asarray(mu), jnp.asarray(sg), jh)
    head_t = ts.prepare_serving_head(torch.as_tensor(mu),
                                     torch.as_tensor(sg), th)
    return (head_j, jh, jnp.asarray(x)), (head_t, th, torch.as_tensor(x))


@pytest.mark.parametrize("read_sigma", [0.0, 0.4])
@pytest.mark.parametrize("gran", ["tile", "cell"])
def test_paper_mode_at_tile_and_cell_matches(gran, read_sigma):
    jc = dataclasses.replace(jg.GRNGConfig(), granularity=gran, tile=16,
                             read_sigma=read_sigma)
    (hj, cj, xj), (ht, ct, xt) = _heads(jc, "paper")
    # the reference reads its shared selection stream unless handed
    # ``sel``, which it does not use at these granularities
    want = np.asarray(js.logit_samples_paper(hj, xj, cj, 7, 3,
                                             sel=jnp.zeros((7, 16))))
    got = ts.logit_samples(ht, xt, ct, 7, sample0=3)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    assert torch.equal(got, ts.logit_samples_paper(ht, xt, ct, 7, 3))
    with pytest.raises(ValueError, match="'layer' selections"):
        ts.logit_samples(ht, xt, dataclasses.replace(ct, mode="rank16"), 7)


# ----------------------------------------------------------------------
# the moment mode
# ----------------------------------------------------------------------
@pytest.mark.parametrize("read_sigma", [0.0, 0.4])
def test_logit_moments_match(read_sigma):
    jc = dataclasses.replace(jg.GRNGConfig(), read_sigma=read_sigma)
    (hj, cj, xj), (ht, ct, xt) = _heads(jc, "moment")
    mean_j, var_j = js.logit_moments(hj, xj, cj)
    mean_t, var_t = ts.logit_moments(ht, xt, ct)
    np.testing.assert_allclose(mean_t.numpy(), np.asarray(mean_j),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(var_t.numpy(), np.asarray(var_j), rtol=1e-6)


def test_moment_samples_follow_the_moments():
    (hj, cj, xj), (ht, ct, xt) = _heads(jg.GRNGConfig(read_sigma=0.4),
                                        "moment")
    mean, var = (v.numpy() for v in ts.logit_moments(ht, xt, ct))
    num = 4096
    got = ts.logit_samples(ht, xt, ct, num, sample0=11).numpy()
    ref = np.asarray(js.logit_samples(hj, xj, cj, num, sample0=11))
    for s in (got, ref):
        assert s.shape == (num,) + mean.shape
        se = np.sqrt(var / num)
        assert (np.abs(s.mean(0) - mean) < 5 * se).all()
        np.testing.assert_allclose(s.var(0), var, rtol=0.1)
    # seeded from sample0 unless a generator is given
    assert np.array_equal(got, ts.logit_samples(ht, xt, ct, num,
                                                sample0=11).numpy())
    gen = torch.Generator().manual_seed(11)
    assert np.array_equal(got, ts.logit_samples(ht, xt, ct, num,
                                                generator=gen).numpy())
    assert not np.array_equal(got, ts.logit_samples(ht, xt, ct, num,
                                                    sample0=12).numpy())
    assert ts.prepare_serving_head(ht["mu_prime"], ht["sigma"], ct).keys() \
        == {"mu_prime", "sigma"}


# ----------------------------------------------------------------------
# the host-tiled hoist
# ----------------------------------------------------------------------
def _bases(b, k, n, read_sigma, tile_n):
    jc = dataclasses.replace(jg.GRNGConfig(), read_sigma=read_sigma)
    (hj, cj, xj), (ht, ct, xt) = _heads(jc, "rank16", b, k, n,
                                        hoist_basis=True,
                                        hoist_tile_n=tile_n)
    return ((hj, js.activation_basis(hj, xj, cj), cj),
            (ht, ts.activation_basis(ht, xt, ct), ct))


def _round(b, r):
    base = torch.arange(b, dtype=torch.int64) * 100
    drawn = torch.zeros(b, dtype=torch.int32)
    return (tad.stream_selections(tg.GRNGConfig(), base, drawn, r),
            tad.stream_indices(base, drawn, r))


@pytest.mark.parametrize("read_sigma", [0.0, 0.4])
def test_update_stats_streamed_matches_dense(read_sigma):
    b, k, n = 5, 40, 9
    (hj, abj, cj), (ht, abt, ct) = _bases(b, k, n, read_sigma, tile_n=4)
    _, (_, abd, cd) = _bases(b, k, n, read_sigma, tile_n=0)
    # the head's chunks and the activation basis stay host chunks
    assert "sigma_basis" not in ht and "m" not in abt and "m" in abd
    assert [c.shape[1] for c in ht["sigma_basis_host"]] == [4, 4, 1]
    for got, want in zip(ht["sigma_basis_host"], hj["sigma_basis_host"]):
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=0)
    for got, want in zip(abt["m_host"], abj["m_host"]):
        assert got.device.type == "cpu"
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)
    sel, idx = _round(b, 6)
    mask = torch.as_tensor(np.arange(b) % 2 == 0)
    dense = tad.update_stats(tad.init_stats(b, n),
                             ts.mix_samples(abd, sel, cd, sample_idx=idx),
                             mask=mask)
    got = tad.update_stats_streamed(tad.init_stats(b, n), abt, sel, ct,
                                    sample_idx=idx, mask=mask)
    want = jad.update_stats_streamed(
        jad.init_stats(b, n), abj, jnp.asarray(sel.numpy()), cj,
        sample_idx=jnp.asarray(idx.numpy().astype(np.uint32)),
        mask=jnp.asarray(mask.numpy()))
    for key in dense:
        np.testing.assert_allclose(got[key].numpy(), dense[key].numpy(),
                                   rtol=1e-5, atol=1e-5, err_msg=key)
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]),
                                   rtol=1e-5, atol=1e-5, err_msg=key)
    # the sampled path over host chunks equals dense mixing
    np.testing.assert_allclose(
        ts.mix_samples(abt, sel, ct, sample_idx=idx).numpy(),
        ts.mix_samples(abd, sel, cd, sample_idx=idx).numpy(),
        rtol=1e-5, atol=1e-5)
    # the engine's featurize asks for the dense concat instead
    x = torch.as_tensor(_head_inputs(b, k, n)[2])
    dense_m = ts.activation_basis(ht, x, ct, dense=True)["m"]
    np.testing.assert_allclose(dense_m.numpy(), abd["m"].numpy(),
                               rtol=1e-6, atol=1e-6)


def _serve(params, head, hcfg, fused, n_requests=16):
    from repro_torch.launch.serve import make_sar_engine, make_sar_stream
    from repro_torch.serving.triage import TriagePolicy
    policy = TriagePolicy(conf_threshold=0.7, mi_threshold=0.05, r_min=4,
                          r_max=20)
    eng = make_sar_engine(params=params, policy=policy, head=head,
                          hcfg=hcfg, fused=fused, telemetry=False,
                          profiler=False, slo=False, device="cpu")
    for r in make_sar_stream(n_requests, corrupt_frac=0.25):
        eng.submit(r)
    eng.run()
    return {r.rid: r for r in eng.metrics.records}


def test_sar_engine_serves_a_chunk_hoisted_head():
    from repro_torch.core.bayes_layer import to_serving
    from repro_torch.models.sar_cnn import SarCnnConfig, init_sar_cnn
    cfg = SarCnnConfig()
    params = init_sar_cnn(torch.Generator().manual_seed(3), cfg)
    hcfg_t = ts.BayesHeadConfig(num_samples=20, mode="rank16", grng=cfg.grng,
                                compute_dtype=torch.float32,
                                hoist_basis=True, hoist_tile_n=1)
    head_t = to_serving(params["head"], hcfg_t)
    assert len(head_t["sigma_basis_host"]) == 2
    want = _serve(params, None, None, True)
    for fused in (True, False):
        got = _serve(params, head_t, hcfg_t, fused)
        assert set(got) == set(want) == set(range(16))
        for rid, a in want.items():
            b = got[rid]
            assert (b.verdict, b.prediction, b.n_samples) == \
                (a.verdict, a.prediction, a.n_samples), rid
            np.testing.assert_allclose(b.confidence, a.confidence, atol=1e-5)
            np.testing.assert_allclose(b.mutual_information,
                                       a.mutual_information, atol=1e-5)
