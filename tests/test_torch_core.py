"""Parity of the port's core math (``repro_torch.core``) with the JAX
reference on the same numpy-seeded inputs.

Tolerances:
  * integer streams (hashes, LFSR states, selections, stream indices):
    bit for bit;
  * ``gaussianish`` and the device currents: within 1 ulp (XLA may
    contract the current's multiply-adds into FMAs);
  * ``compensate_mu`` / ``prepare_serving_head``: rtol 1e-6 (the same
    arithmetic in the same order; in practice bit-equal);
  * activation basis: rtol 1e-5 / atol 1e-6 (matrix products of depth
    K summed in another order);
  * logit samples: rtol 1e-5 / atol 1e-5.  A sample is
    (Σ_j s_j·m_j − sum_mean·x_sigma) / sum_std: both terms are ~10× the
    difference, so the 16-term mix summed in another order than XLA's
    leaves ~2 ulp of the terms (≈2e-6 at |mix| ≈ 16) in the result.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import clt_grng as jg
from repro.core import hashing as jh
from repro.core import lfsr as jl
from repro.core import sampling as js
from repro.core.bayes_layer import sigma_of as j_sigma_of
from repro.core.quant import QuantConfig as JQuant
from repro.serving import adaptive as jad
from repro_torch.core import clt_grng as tg
from repro_torch.core import hashing as th
from repro_torch.core import lfsr as tl
from repro_torch.core import sampling as ts
from repro_torch.core.bayes_layer import sigma_of as t_sigma_of
from repro_torch.core.quant import QuantConfig as TQuant
from repro_torch.serving import adaptive as tad

TOP = np.arange(2**32 - 64, 2**32, dtype=np.uint64)    # near 2³²−1


def _u32(seed, size):
    rng = np.random.default_rng(seed)
    x = rng.integers(0, 2**32, size, dtype=np.uint64)
    return np.concatenate([x, TOP, [0, 1, 2**31 - 1, 2**31]]).astype(
        np.uint32)


def _t(a):
    """numpy uint32 -> the port's int64 carrier."""
    return torch.as_tensor(np.asarray(a).astype(np.int64))


def _j(a):
    return np.asarray(a).astype(np.int64)


def test_mul32_wraps_exactly_near_2_32():
    x = _u32(0, 4096).astype(np.uint64)
    for c in (0x7FEB352D, 0x846CA68B, 0x9E3779B9, 0x85EBCA6B, 0xC2B2AE35,
              0xFFFFFFFF):
        want = (x * np.uint64(c)) & np.uint64(0xFFFFFFFF)
        got = th.mul32(_t(x), c).numpy()
        np.testing.assert_array_equal(got, want.astype(np.int64))


def test_mix32_hash3_hash2_bit_equal():
    x = _u32(1, 4096)
    np.testing.assert_array_equal(th.mix32(_t(x)).numpy(),
                                  _j(jh.mix32(jnp.asarray(x))))
    k, n, j = _u32(2, 2048), _u32(3, 2048), _u32(4, 2048)
    for seed in (0xC1A0, 0x51CE, 0xFFFFFFFF):
        np.testing.assert_array_equal(
            th.hash3(_t(k), _t(n), _t(j), seed).numpy(),
            _j(jh.hash3(jnp.asarray(k), jnp.asarray(n), jnp.asarray(j),
                        seed)))
        np.testing.assert_array_equal(
            th.hash2(_t(k), _t(n), seed).numpy(),
            _j(jh.hash2(jnp.asarray(k), jnp.asarray(n), seed)))
    # broadcasting, as device_currents uses it
    rows, cols = k[:7, None], n[None, :5]
    np.testing.assert_array_equal(
        th.hash3(_t(rows), _t(cols), 3, 11).numpy(),
        _j(jh.hash3(jnp.asarray(rows), jnp.asarray(cols), 3, 11)))


def test_gaussianish_and_bits_within_one_ulp():
    h = _u32(5, 8192)
    np.testing.assert_array_max_ulp(
        th.gaussianish(_t(h)).numpy(),
        np.asarray(jh.gaussianish(jnp.asarray(h))), maxulp=1)
    np.testing.assert_array_equal(
        th.uniform_bit(_t(h)).numpy(),
        np.asarray(jh.uniform_bit(jnp.asarray(h))))


@pytest.mark.parametrize("imprint", [0.0, 0.37])
def test_device_currents_within_one_ulp(imprint):
    cfg_j = dataclasses.replace(jg.GRNGConfig(), imprint=imprint)
    cfg_t = tg.GRNGConfig(imprint=imprint)
    got = tg.device_currents_grid(cfg_t, 40, 9, row0=5, col0=2**20)
    want = jg.device_currents_grid(cfg_j, 40, 9, row0=5, col0=2**20)
    np.testing.assert_array_max_ulp(got.numpy(), np.asarray(want),
                                    maxulp=1)
    got_j = tg.device_current_j(cfg_t, torch.arange(40)[:, None],
                                torch.arange(9)[None, :], 7)
    want_j = jg.device_current_j(cfg_j, jnp.arange(40, dtype=jnp.uint32)
                                 [:, None], jnp.arange(9, dtype=jnp.uint32)
                                 [None, :], 7)
    np.testing.assert_array_max_ulp(got_j.numpy(), np.asarray(want_j),
                                    maxulp=1)
    np.testing.assert_array_max_ulp(
        tg.read_noise_at(tg.GRNGConfig(read_sigma=0.4),
                         torch.arange(6)[:, None], torch.arange(4), 9).numpy(),
        np.asarray(jg.read_noise_at(
            dataclasses.replace(jg.GRNGConfig(), read_sigma=0.4),
            jnp.arange(6, dtype=jnp.uint32)[:, None],
            jnp.arange(4, dtype=jnp.uint32), 9)), maxulp=1)


def test_lfsr_and_selections_bit_equal():
    for seed in (0, 0x1FFFF):
        np.testing.assert_array_equal(
            tl.lfsr_states(seed, 300).numpy(),
            _j(jl.lfsr_states(seed, 300)))
    s = _u32(6, 512) & np.uint32(0xFFFF)
    np.testing.assert_array_equal(
        tl.lfsr_next(_t(s)).numpy(), _j(jl.lfsr_next(jnp.asarray(s))))
    np.testing.assert_array_equal(
        tl.swapper_select(_t(s).reshape(4, -1)).numpy(),
        np.asarray(jl.swapper_select(jnp.asarray(s).reshape(4, -1))))
    idx = _u32(7, 1024)
    np.testing.assert_array_equal(
        tl.indexed_states(0xACE1, _t(idx)).numpy(),
        _j(jl.indexed_states(0xACE1, jnp.asarray(idx))))
    np.testing.assert_array_equal(
        tg.selections(tg.GRNGConfig(), 12, sample0=5).numpy(),
        np.asarray(jg.selections(jg.GRNGConfig(), 12, 5)))


def test_stream_indices_and_selections_bit_equal():
    base = np.array([0, 20, 40, 2**32 - 20, 2**32 - 3], np.uint32)
    drawn = np.array([0, 4, 8, 16, 12], np.int32)
    for num in (1, 4, 20):
        want_i = jad.stream_indices(jnp.asarray(base), jnp.asarray(drawn), num)
        got_i = tad.stream_indices(_t(base), torch.as_tensor(drawn), num)
        np.testing.assert_array_equal(got_i.numpy(), _j(want_i))
        np.testing.assert_array_equal(
            tad.stream_selections(tg.GRNGConfig(), _t(base),
                                  torch.as_tensor(drawn), num).numpy(),
            np.asarray(jad.stream_selections(jg.GRNGConfig(),
                                             jnp.asarray(base),
                                             jnp.asarray(drawn), num)))


def _head_inputs(k, n, seed=0):
    rng = np.random.default_rng(seed)
    mu = (rng.standard_normal((k, n)) * 0.05).astype(np.float32)
    rho = (rng.standard_normal((k, n)) - 3.0).astype(np.float32)
    return mu, rho


@pytest.mark.parametrize("quant", [False, True])
def test_prepare_serving_head_matches(quant):
    mu, rho = _head_inputs(48, 7)
    sig_j = j_sigma_of({"rho": jnp.asarray(rho)})
    sig_t = t_sigma_of({"rho": torch.as_tensor(rho)})
    np.testing.assert_allclose(sig_t.numpy(), np.asarray(sig_j), rtol=1e-6)
    hj = js.BayesHeadConfig(mode="rank16", compute_dtype=jnp.float32,
                            hoist_basis=True, quant=JQuant(enabled=quant))
    ht = ts.BayesHeadConfig(mode="rank16", compute_dtype=torch.float32,
                            hoist_basis=True, quant=TQuant(enabled=quant))
    # both sides from the same σ so only the transform is compared
    sig = np.array(sig_j)
    want = js.prepare_serving_head(jnp.asarray(mu), jnp.asarray(sig), hj)
    got = ts.prepare_serving_head(torch.as_tensor(mu), torch.as_tensor(sig),
                                  ht)
    assert set(got) == set(want)
    for key in want:
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]),
                                   rtol=1e-6, atol=1e-9, err_msg=key)


def _bases(b, k, n, read_sigma, hoist, seed=1):
    mu, rho = _head_inputs(k, n, seed)
    sig = np.array(j_sigma_of({"rho": jnp.asarray(rho)}))
    x = np.random.default_rng(seed + 1).standard_normal((b, k)).astype(
        np.float32)
    gj = dataclasses.replace(jg.GRNGConfig(), read_sigma=read_sigma)
    gt = tg.GRNGConfig(read_sigma=read_sigma)
    hj = js.BayesHeadConfig(mode="rank16", grng=gj,
                            compute_dtype=jnp.float32, hoist_basis=hoist)
    ht = ts.BayesHeadConfig(mode="rank16", grng=gt,
                            compute_dtype=torch.float32, hoist_basis=hoist)
    abj = js.activation_basis(
        js.prepare_serving_head(jnp.asarray(mu), jnp.asarray(sig), hj),
        jnp.asarray(x), hj)
    abt = ts.activation_basis(
        ts.prepare_serving_head(torch.as_tensor(mu), torch.as_tensor(sig),
                                ht), torch.as_tensor(x), ht)
    return abj, abt, hj, ht


@pytest.mark.parametrize("hoist", [True, False])
@pytest.mark.parametrize("read_sigma", [0.0, 0.4])
def test_activation_basis_matches(hoist, read_sigma):
    abj, abt, _, _ = _bases(6, 40, 9, read_sigma, hoist)
    assert set(abt) == set(abj)
    for key in abj:
        np.testing.assert_allclose(abt[key].numpy(), np.asarray(abj[key]),
                                   rtol=1e-5, atol=1e-6, err_msg=key)


@pytest.mark.parametrize("read_sigma", [0.0, 0.4])
@pytest.mark.parametrize("per_slot", [True, False])
def test_mix_samples_matches(read_sigma, per_slot):
    b, n = 6, 9
    abj, abt, hj, ht = _bases(b, 40, n, read_sigma, True)
    base = np.arange(b, dtype=np.uint32) * 20 + np.uint32(2**32 - 64)
    drawn = np.full((b,), 4, np.int32)
    if per_slot:
        idx_j = jad.stream_indices(jnp.asarray(base), jnp.asarray(drawn), 5)
        sel_j = jad.stream_selections(hj.grng, jnp.asarray(base),
                                      jnp.asarray(drawn), 5)
    else:
        idx_j = jnp.arange(7, 12, dtype=jnp.uint32)
        sel_j = jg.selections(hj.grng, 5, 7)
    want = js.mix_samples(abj, sel_j, hj, sample_idx=idx_j)
    got = ts.mix_samples(abt, torch.as_tensor(np.array(sel_j)), ht,
                         sample_idx=_t(idx_j))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    if read_sigma:      # the packed-selection key of a call without indices
        want = js.mix_samples(abj, sel_j, hj)
        got = ts.mix_samples(abt, torch.as_tensor(np.array(sel_j)), ht)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-5, atol=1e-5)


def test_energy_terms_and_tilemap_match():
    from repro.core.energy import LayerShape as JL
    from repro.hw import compile_network as jcompile
    from repro.serving import metrics as jm
    from repro_torch.core.energy import LayerShape as TL
    from repro_torch.hw import compile_network as tcompile
    from repro_torch.serving import metrics as tm
    shapes = [(9, 16, False), (144, 32, False), (288, 64, False),
              (64, 2, True), (3000, 700, False)]
    lj = [JL(*s) for s in shapes]
    lt = [TL(*s) for s in shapes]
    pj, pt = jcompile(lj), tcompile(lt)
    assert pt.layer_block_counts() == pj.layer_block_counts()
    assert (pt.n_passes, pt.physical_tiles_used, pt.utilization) == \
        (pj.n_passes, pj.physical_tiles_used, pj.utilization)
    for prog_j, prog_t in ((None, None), (pj, pt)):
        assert tm.energy_terms(lt, prog_t) == jm.energy_terms(lj, prog_j)
        for n_s in (4.0, 11.5, 20):
            assert (tm.decision_energy(n_s, lt, prog_t)
                    == jm.decision_energy(n_s, lj, prog_j))
    assert tm.placed_decision_latency(7.0, lt, pt, replicated=True) == \
        jm.placed_decision_latency(7.0, lj, pj, replicated=True)
    assert tm.decision_latency(7.0, lt) == jm.decision_latency(7.0, lj)
