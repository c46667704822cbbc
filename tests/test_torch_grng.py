"""The arithmetic the GRNG ε kernel (``kernels/csrc/grng_eps.cu``) and the
head kernels rest on, held on the CPU against the JAX reference, and the
die's head deployed on the device it is given.

  * hash3 factored by its coordinates, as ``csrc/hash.cuh`` computes it
    (key prefix of the device or sample, column prefix, one mix32 a
    row): equal to ``repro.core.hashing.hash3`` and to the port's, on
    random coordinates and across the 2^32 wrap;
  * the three bytes turned into floats by their bit patterns
    (``gauss_bytes``): equal to ``gaussianish`` bit for bit over all
    2^24 byte triples;
  * a device current from the hash's top bit and gauss (``current_of``),
    with bytes as floats or looked up by (top bit, byte sum) in
    ``grng_eps.cu``'s tables at the dp4a byte offset, and the read
    noise's table: equal to the reference's and the port's bit for bit;
  * a 0/1 selection row summed as fused multiply-adds, or as the
    selected currents added in order: equal to ``subset_sums``'s
    in-order product chain bit for bit; the swapper's rows are all 0/1
    with eight ones;
  * ``measured_grng`` and ``prepare_instance_head`` draw on the device
    they are given, and ``make_sar_engine`` deploys the die's head on
    its own device; their values against the reference are held by
    ``tests/test_torch_hw.py`` (rtol 1e-6).
Numpy emulates the kernels' float32 steps: each numpy float32 operation
rounds to nearest, and a fused multiply-add whose product is exact is a
float64 sum rounded once to float32.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import clt_grng as jg
from repro.core import hashing as jh
from repro.hw import VariationSpec as JVariationSpec
from repro.hw import measured_grng as j_measured
from repro.hw import sample_instances as j_sample
from repro_torch.core import clt_grng as tg
from repro_torch.core import hashing as th
from repro_torch.core.bayes_layer import sigma_of
from repro_torch.core.sampling import BayesHeadConfig
from repro_torch.hw import (VariationSpec, measured_grng,
                            prepare_instance_head, sample_instances)
from repro_torch.hw import calib

U32 = np.uint32


def _mix32(x):
    x = x ^ (x >> U32(16))
    x = x * U32(0x7FEB352D)
    x = x ^ (x >> U32(15))
    x = x * U32(0x846CA68B)
    return x ^ (x >> U32(16))


def _key_prefix(j, seed):
    j = np.atleast_1d(np.asarray(j, dtype=U32))
    return _mix32(j * U32(0xC2B2AE35) + U32(seed))


def _col_hash(n, key):
    return _mix32(n * U32(0x85EBCA6B) + key)


def _row_hash(k, prefix):
    return _mix32(k * U32(0x9E3779B9) + prefix)


def _gauss_bytes(h):
    """csrc/hash.cuh gauss_bytes: 0x4B0000bb is 2^23 + bb."""
    f = [((h >> U32(8 * i)) & U32(0xFF) | U32(0x4B000000)).view(np.float32)
         for i in range(3)]
    b01 = f[0] + (f[1] - np.float32(2**24))
    total = b01 + (f[2] - np.float32(2**23))
    return (total - np.float32(382.5)) * np.float32(1.0 / 127.99316)


def _port_grng(cfg):
    return tg.GRNGConfig(**{f.name: getattr(cfg, f.name)
                            for f in dataclasses.fields(cfg)})


@pytest.mark.parametrize("seed", [0xC1A0, 0x1A9E, 0x51CE, 0xFFFFFFFF])
def test_hash3_factors_into_key_column_and_row(seed):
    rng = np.random.default_rng(seed & 0xFFFF)
    k = rng.integers(0, 2**32, 4096, dtype=np.uint64).astype(U32)
    n = rng.integers(0, 2**32, 4096, dtype=np.uint64).astype(U32)
    j = rng.integers(0, 2**32, 4096, dtype=np.uint64).astype(U32)
    # a block's coordinates across the wrap: row0 + k and col0 + n past
    # 2^32 reduce mod 2^32, as the kernels' uint32 sums do
    k[:64] = (2**32 - 32 + np.arange(64)) % 2**32
    n[64:128] = (2**32 - 7 + np.arange(64)) % 2**32
    j[128:144] = np.arange(16)
    got = _row_hash(k, _col_hash(n, _key_prefix(j, seed)))
    want = np.asarray(jh.hash3(jnp.asarray(k), jnp.asarray(n),
                               jnp.asarray(j), seed))
    np.testing.assert_array_equal(got, want)
    port = th.hash3(torch.as_tensor(k.astype(np.int64)),
                    torch.as_tensor(n.astype(np.int64)),
                    torch.as_tensor(j.astype(np.int64)), seed)
    np.testing.assert_array_equal(got, port.numpy().astype(U32))


@pytest.mark.parametrize("quarter", range(4))
def test_bytes_as_floats_equal_gaussianish(quarter):
    """Every byte triple, a quarter of them per case, under a random top
    byte (which neither reads)."""
    rng = np.random.default_rng(quarter)
    low = np.arange(quarter << 22, (quarter + 1) << 22, dtype=U32)
    h = low | (rng.integers(0, 256, low.size, dtype=np.uint64)
               .astype(U32) << U32(24))
    got = _gauss_bytes(h)
    want = np.asarray(jh.gaussianish(jnp.asarray(h)))
    np.testing.assert_array_equal(got.view(U32), want.view(U32))
    port = th.gaussianish(torch.as_tensor(h[:1 << 16].astype(np.int64)))
    np.testing.assert_array_equal(got[:1 << 16].view(U32),
                                  port.numpy().view(U32))


def _gauss_of_sum(total):
    """csrc/hash.cuh gauss_of_sum: (s - 382.5) * scale, one rounding."""
    return (total - np.float32(382.5)) * np.float32(1.0 / 127.99316)


def _current_of(cfg, top, gauss):
    """csrc/hash.cuh current_of: (i_lo + delta_i*bit) + gamma*gauss."""
    f32 = np.float32
    base = f32(cfg.i_lo) + np.where(top, f32(cfg.delta_i), f32(0.0))
    return base + f32(cfg.gamma) * gauss


def _kernel_currents(cfg, rows, cols, tables):
    """[rows, cols, 16] as the kernels compute them: hash.cuh ``current``
    (bytes as floats), or grng_eps.cu's tables by (top bit, byte sum),
    indexed by the dp4a byte offset 4 (b0 + b1 + b2) + 3072 bit."""
    sums = np.arange(768, dtype=np.float32)
    cur_tab = np.concatenate([_current_of(cfg, False, _gauss_of_sum(sums)),
                              _current_of(cfg, True, _gauss_of_sum(sums))])
    imp_tab = np.float32(cfg.imprint) * _gauss_of_sum(sums)
    out = []
    for j in range(16):
        h = _row_hash(rows[:, None], _col_hash(cols[None, :],
                                               _key_prefix(j, cfg.seed)))
        hi = _row_hash(rows[:, None], _col_hash(
            cols[None, :], _key_prefix(j, cfg.imprint_seed)))
        if tables:
            b = [(h >> U32(8 * i)) & U32(0xFF) for i in range(3)]
            offset = 4 * (b[0] + b[1] + b[2]) + 3072 * (h >> U32(31))
            cur = cur_tab[offset // 4]
            bi = [(hi >> U32(8 * i)) & U32(0xFF) for i in range(3)]
            imp = imp_tab[bi[0] + bi[1] + bi[2]]
        else:
            cur = _current_of(cfg, (h >> U32(31)) == 1, _gauss_bytes(h))
            imp = np.float32(cfg.imprint) * _gauss_bytes(hi)
        out.append(cur + imp if cfg.imprint else cur)
    return np.stack(out, axis=-1)


@pytest.mark.parametrize("tables", [False, True], ids=["formula", "tables"])
@pytest.mark.parametrize("aged", [False, True])
def test_kernel_currents_equal_the_reference(aged, tables):
    jcfg = jg.GRNGConfig(imprint=0.37 if aged else 0.0)
    row0, col0 = 2**32 - 9, 40
    rows = ((row0 + np.arange(24)) % 2**32).astype(U32)
    cols = (col0 + np.arange(17)).astype(U32)
    got = _kernel_currents(jcfg, rows, cols, tables)
    want = np.asarray(jg.device_currents(jcfg, jnp.asarray(rows)[:, None],
                                         jnp.asarray(cols)[None, :]))
    np.testing.assert_array_equal(got.view(U32), want.view(U32))
    port = tg.device_currents_grid(_port_grng(jcfg), 24, 17, row0, col0,
                                   device="cpu")
    np.testing.assert_array_equal(got.view(U32), port.numpy().view(U32))


def test_read_noise_table_equals_the_reference():
    """read_sigma * gauss by byte sum, as grng_eps.cu tabulates it."""
    jcfg = jg.GRNGConfig(read_sigma=0.37)
    sums = np.arange(768, dtype=np.float32)
    table = np.float32(jcfg.read_sigma) * _gauss_of_sum(sums)
    rows = ((2**32 - 3 + np.arange(9)) % 2**32).astype(U32)
    cols = (5 + np.arange(11)).astype(U32)
    r_abs = ((2**32 - 2 + np.arange(4)) % 2**32).astype(U32)
    h = _row_hash(rows[None, :, None], _col_hash(
        cols[None, None, :], _key_prefix(r_abs, jcfg.noise_seed)[:, None,
                                                                 None]))
    b = [(h >> U32(8 * i)) & U32(0xFF) for i in range(3)]
    got = table[b[0] + b[1] + b[2]]
    want = np.asarray(jg.read_noise_at(jcfg, jnp.asarray(rows)[None, :, None],
                                       jnp.asarray(cols)[None, None, :],
                                       jnp.asarray(r_abs)[:, None, None]))
    np.testing.assert_array_equal(got.view(U32), want.view(U32))


@pytest.mark.parametrize("sample0", [0, 13, 4000])
@pytest.mark.parametrize("aged", [False, True])
def test_fused_and_masked_sums_equal_the_product_chain(sample0, aged):
    cfg = tg.GRNGConfig(imprint=0.37 if aged else 0.0)
    currents = tg.device_currents_grid(cfg, 40, 33, 7, 3, device="cpu")
    sel = tg.selections(cfg, 64, sample0, device="cpu")
    s = sel.numpy()
    assert set(np.unique(s)) <= {0.0, 1.0}
    assert (s.sum(axis=1) == 8).all()
    want = tg.subset_sums(currents, sel, cfg).numpy()     # [R, K, N]
    cur = currents.numpy().astype(np.float64)
    fused = np.zeros(want.shape, np.float32)
    masked = np.zeros(want.shape, np.float32)
    for j in range(16):
        # fma(sel_j, I_j, raw): the product is exact, one rounding
        fused = (s[:, j, None, None] * cur[None, ..., j]
                 + fused).astype(np.float32)
        add = masked + currents.numpy()[None, ..., j]
        masked = np.where(s[:, j, None, None] == 1.0, add, masked)
    np.testing.assert_array_equal(fused.view(U32), want.view(U32))
    np.testing.assert_array_equal(masked.view(U32), want.view(U32))


def _die(seed=11, severity=2.0):
    return sample_instances(seed, 1, VariationSpec().scaled(severity))[0]


def _recording_raw_sums(monkeypatch):
    seen = []
    raw_sums = calib.g.raw_sums

    def recording(*args, **kw):
        seen.append(torch.device(kw["device"]))
        return raw_sums(*args, **kw)

    monkeypatch.setattr(calib.g, "raw_sums", recording)
    return seen


def test_measured_grng_draws_on_the_device_it_is_given(monkeypatch):
    seen = _recording_raw_sums(monkeypatch)
    icfg = _die().grng(tg.GRNGConfig())
    got = measured_grng(icfg, device="cpu")
    assert seen == [torch.device("cpu")]
    want = j_measured(j_sample(11, 1, JVariationSpec().scaled(2.0))[0]
                      .grng(jg.GRNGConfig()), n_samples=64)
    np.testing.assert_allclose(got.sum_mean, want.sum_mean, rtol=1e-6)
    np.testing.assert_allclose(got.sum_std, want.sum_std, rtol=1e-6)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            measured_grng(icfg)          # None means the card: no fallback


@pytest.mark.parametrize("mode", ["rank16", "paper"])
def test_prepare_instance_head_calibrates_on_mu_device(monkeypatch, mode):
    seen = _recording_raw_sums(monkeypatch)
    gen = torch.Generator().manual_seed(1)
    mu = torch.randn((64, 2), generator=gen) * 0.3
    sigma = torch.rand((64, 2), generator=gen) * 0.1
    cfg = BayesHeadConfig(mode=mode, compute_dtype=torch.float32,
                          hoist_basis=mode == "rank16")
    head, scfg = prepare_instance_head(mu, sigma, cfg, _die())
    # the constants' measurement, then the offsets' (compensate_mu)
    assert seen == [torch.device("cpu")] * 2
    assert all(v.device.type == "cpu" for v in head.values())
    assert scfg.grng == measured_grng(_die().grng(cfg.grng), device="cpu")


def test_make_sar_engine_deploys_the_head_on_its_device(monkeypatch):
    from repro_torch.launch.serve import make_sar_engine
    from repro_torch.models.sar_cnn import SarCnnConfig, init_sar_cnn
    seen = _recording_raw_sums(monkeypatch)
    die = _die()
    engine = make_sar_engine(n_slots=4, chip_instance=die, device="cpu")
    assert seen == [torch.device("cpu")] * 2
    cfg = SarCnnConfig()
    params = init_sar_cnn(torch.Generator().manual_seed(3), cfg)
    base = BayesHeadConfig(num_samples=20, mode="rank16", grng=cfg.grng,
                           compute_dtype=torch.float32, hoist_basis=True)
    want, wcfg = prepare_instance_head(
        params["head"]["mu"], sigma_of(params["head"]), base, die)
    assert engine.hcfg == wcfg
    assert set(engine._head) == set(want)
    for key, value in want.items():
        assert engine._head[key].device.type == "cpu"
        assert torch.equal(engine._head[key], value), key
