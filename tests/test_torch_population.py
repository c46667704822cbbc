"""A population of dies in the port against the JAX reference: what is
measured of a die, how dies are shipped, and how weights map onto tiles.

  * ``compensation_report`` on numpy-seeded heads (64×64 and 80×96, the
    ideal die and a degraded one): the worst correction in µ LSBs to
    rtol 1e-5, the effective µ bits to 1e-6, the residual offset (a
    mean over 256×64×64 ε, reduced in another order than XLA's) to
    atol 1e-6;
  * ``calibration_report`` on the two dies of ``sample_instances(5, 2,
    VariationSpec().scaled(2.0))``: cost fields and ids equal, measured
    constants to rtol 1e-6 (``tests/test_torch_hw.py``'s standard),
    residuals to atol 1e-6, and the calibrated residual under a fifth
    of the uncalibrated one (``tests/test_hw.py:169-175``);
  * ``save_instances``/``load_instances``: the reference's dies
    (``benchmarks/hw_variation.py``'s population, seed 2026, 16 dies,
    severity 2.5), carried across by ``to_tree``, come back field for
    field through the port's checkpoints (the reference's own round
    trip fails on its zstd restore, ROADMAP C1);
  * the tile map on the shapes of ``tests/test_hw.py:103-148``:
    ``layer_utilization``, ``det_bayes_blocks``, ``report`` (bit for
    bit), ``shard_column_partition``, and ``shard_weights`` block for
    block against the reference's numpy blocks; ``reconstruct`` is an
    exact round trip on the weight's dtype.
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro.core import clt_grng as jg
from repro.core.energy import LayerShape as JLayer
from repro.core.offset import compensation_report as j_comp_report
from repro.hw import TileGrid as JGrid
from repro.hw import VariationSpec as JVariationSpec
from repro.hw import calibration_report as j_cal_report
from repro.hw import compile_network as j_compile
from repro.hw import sample_instances as j_sample
from repro.hw import shard_column_partition as j_partition
from repro_torch.bridge import instance_from_tree
from repro_torch.core import clt_grng as tg
from repro_torch.core.energy import LayerShape
from repro_torch.core.offset import compensation_report
from repro_torch.hw import (TileGrid, VariationSpec, calibration_report,
                            compile_network, load_instances,
                            sample_instances, save_instances,
                            shard_column_partition)


def _port_grng(cfg):
    return tg.GRNGConfig(**{f.name: getattr(cfg, f.name)
                            for f in dataclasses.fields(cfg)})


def _jax_die(seed=11, severity=2.0):
    return j_sample(seed, 1, JVariationSpec().scaled(severity))[0]


def _head(k, n, seed):
    rng = np.random.default_rng(seed)
    mu = (rng.standard_normal((k, n)) * 0.05).astype(np.float32)
    sigma = (np.log1p(np.exp(rng.standard_normal((k, n)) - 2.0))
             * 0.1).astype(np.float32)
    return mu, sigma


# ----------------------------------------------------------------------
# compensation and calibration reports
# ----------------------------------------------------------------------
@pytest.mark.parametrize("shape", [(64, 64), (80, 96)])
@pytest.mark.parametrize("die", [False, True])
def test_compensation_report_matches(shape, die):
    mu, sigma = _head(*shape, seed=shape[1])
    jc = _jax_die().grng(jg.GRNGConfig()) if die else jg.GRNGConfig()
    want = j_comp_report(mu, sigma, jc, mu_bits=8)
    got = compensation_report(torch.as_tensor(mu), torch.as_tensor(sigma),
                              _port_grng(jc), mu_bits=8)
    np.testing.assert_allclose(got.max_correction_lsb,
                               want.max_correction_lsb, rtol=1e-5)
    np.testing.assert_allclose(got.effective_mu_bits,
                               want.effective_mu_bits, rtol=0, atol=1e-6)
    np.testing.assert_allclose(got.residual_mean_offset,
                               want.residual_mean_offset, rtol=0, atol=1e-6)
    assert 5.0 < got.effective_mu_bits <= 8.0


@pytest.mark.parametrize("idx", [0, 1])
def test_calibration_report_matches(idx):
    jchip = j_sample(5, 2, JVariationSpec().scaled(2.0))[idx]
    tchip = instance_from_tree(jchip.to_tree())
    want = j_cal_report(jchip, jg.GRNGConfig(), n_samples=64)
    got = calibration_report(tchip, tg.GRNGConfig(), n_samples=64,
                             device="cpu")
    for f in ("chip_id", "nominal_sum_mean", "nominal_sum_std",
              "n_samples", "energy_J", "time_s"):
        assert getattr(got, f) == getattr(want, f), f
    for f in ("measured_sum_mean", "measured_sum_std"):
        np.testing.assert_allclose(getattr(got, f), getattr(want, f),
                                   rtol=1e-6, err_msg=f)
    for f in ("residual_eps_uncal", "residual_eps_cal"):
        np.testing.assert_allclose(getattr(got, f), getattr(want, f),
                                   rtol=0, atol=1e-6, err_msg=f)
    assert got.residual_eps_cal < 0.2 * got.residual_eps_uncal
    assert got.energy_J == pytest.approx(54e-12 + 458e-12 * 64)


def test_calibration_report_runs_on_the_card_by_default():
    chip = sample_instances(5, 1, VariationSpec().scaled(2.0))[0]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            calibration_report(chip, tg.GRNGConfig())


# ----------------------------------------------------------------------
# shipping dies
# ----------------------------------------------------------------------
def _fields_equal(a, b):
    for f in dataclasses.fields(a):
        va, vb = getattr(a, f.name), getattr(b, f.name)
        if isinstance(va, np.ndarray):
            assert va.dtype == np.asarray(vb).dtype, f.name
            np.testing.assert_array_equal(va, vb, err_msg=f.name)
        else:
            assert va == vb and type(va) is type(vb), f.name


def test_save_load_returns_the_reference_population(tmp_path):
    jdies = j_sample(2026, 16, JVariationSpec().scaled(2.5))
    tdies = tuple(instance_from_tree(d.to_tree()) for d in jdies)
    path = save_instances(tmp_path, tdies, step=3)
    assert path.name == "step_0000000003"
    back = load_instances(tmp_path)
    assert len(back) == 16
    for j, t in zip(jdies, back):
        _fields_equal(t, j)
    # the port draws the same population itself
    for a, b in zip(sample_instances(2026, 16, VariationSpec().scaled(2.5)),
                    back):
        _fields_equal(a, b)
    # a later step does not shadow an explicit one
    save_instances(tmp_path, tdies[:2], step=4)
    assert len(load_instances(tmp_path)) == 2
    assert len(load_instances(tmp_path, step=3)) == 16


# ----------------------------------------------------------------------
# the tile map
# ----------------------------------------------------------------------
def _layers(mod):
    return [mod(144, 16), mod(150, 70), mod(64, 2, bayesian=True)]


PROGRAMS = {
    "4x4": lambda L, G, c: c(_layers(L), G(4, 4)),
    "2x2_no_replicas": lambda L, G, c: c(_layers(L), G(2, 2),
                                         replicate_bayesian=False),
    "sharded": lambda L, G, c: c([L(128, 256)], G(8, 8), n_shards=2),
}


def _programs(name):
    build = PROGRAMS[name]
    return build(JLayer, JGrid, j_compile), build(LayerShape, TileGrid,
                                                  compile_network)


@pytest.mark.parametrize("name", sorted(PROGRAMS))
def test_tilemap_queries_and_report_match(name):
    jp, tp = _programs(name)
    assert tp.det_bayes_blocks() == jp.det_bayes_blocks()
    for layer, _ in jp.layers:
        assert tp.layer_utilization(layer) == jp.layer_utilization(layer)
        assert shard_column_partition(tp, layer) == j_partition(jp, layer)
    for r, batch in ((20, 1), (7, 4)):
        assert tp.report(r_samples=r, batch=batch) == \
            jp.report(r_samples=r, batch=batch)
    assert tp.report() == jp.report()


@pytest.mark.parametrize("name", sorted(PROGRAMS))
def test_shard_weights_match_and_reconstruct_exactly(name):
    jp, tp = _programs(name)
    rng = np.random.default_rng(0)
    for layer, shape in jp.layers:
        w = rng.standard_normal((shape.d_in, shape.d_out)).astype(np.float32)
        want = jp.shard_weights(layer, w)
        got = tp.shard_weights(layer, torch.as_tensor(w))
        assert list(got) == list(want)
        for key, blk in want.items():
            np.testing.assert_array_equal(got[key].numpy(), blk)
        back = tp.reconstruct(layer, got)
        assert back.dtype == torch.float32
        assert torch.equal(back, torch.as_tensor(w))
        for dtype in (torch.bfloat16, torch.int8):
            wt = torch.as_tensor(w * 50).to(dtype)
            shards = tp.shard_weights(layer, wt)
            assert all(b.dtype == dtype for b in shards.values())
            assert torch.equal(tp.reconstruct(layer, shards), wt)
