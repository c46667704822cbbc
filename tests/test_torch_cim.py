"""The chip-instance conv trunk of the port against the JAX reference:
the IDAC/ADC quantizers, the chunked-ADC CIM product and the nonideal
trunk of ``models/sar_cnn``.

  * ``cim_mvm_plain`` (the kernel's plain version) against the Pallas
    kernel in interpret mode (``ops.cim_matmul_nonideal``) and against
    its oracle ``ref.cim_mvm_nonideal_ref``, rtol/atol 1e-4 as
    tests/test_kernels.py holds the reference kernel to its oracle: the
    64-term partial sums are taken in another order, which moves an
    output by float rounding unless an ADC code flips; a flip moves it
    by one LSB (~0.05), so the count of outputs off by more than 1e-4
    is asserted to be 0 here;
  * the zero-variation front end gives the ideal ADC's bits;
  * ``_im2col`` exactly; each nonideal conv layer fed the same input,
    and ``features(chip=…)`` on 4 images, atol 1e-5, with ADC code
    flips counted and bounded where the two packages' full scales
    differ in their last bit (see the tests' docstrings).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import quant as jq
from repro.hw import VariationSpec as JVariationSpec
from repro.hw import golden_instance as j_golden
from repro.hw import sample_instances as j_sample
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.launch.serve import make_sar_stream as j_stream
from repro.models import sar_cnn as jsar
from repro_torch.bridge import instance_from_tree, params_from_jax
from repro_torch.core import quant as tq
from repro_torch.kernels import ops as tops
from repro_torch.kernels.cim import cim_mvm, cim_mvm_plain
from repro_torch.models import sar_cnn as tsar

JQCFG = jq.QuantConfig(enabled=True)
TQCFG = tq.QuantConfig(enabled=True)


def _operands(b, k, n, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, k)).astype(np.float32)
    w = (rng.standard_normal((k, n)) * 0.05).astype(np.float32)
    gain = (1.0 + 0.05 * rng.standard_normal(n)).astype(np.float32)
    off = (0.5 * rng.standard_normal(n)).astype(np.float32)
    return x, w, gain, off


def test_input_and_adc_quantizers_match():
    rng = np.random.default_rng(1)
    x = (rng.standard_normal((37, 50)) * 3).astype(np.float32)
    xq_j, s_j = jq.quantize_input(jnp.asarray(x), JQCFG)
    xq_t, s_t = tq.quantize_input(torch.as_tensor(x), TQCFG)
    np.testing.assert_array_equal(xq_t.numpy(), np.asarray(xq_j))
    assert float(s_t) == float(s_j)
    fs = np.float32(2.3)
    np.testing.assert_array_equal(
        tq.adc_quantize(torch.as_tensor(x), torch.tensor(fs), TQCFG).numpy(),
        np.asarray(jq.adc_quantize(jnp.asarray(x), fs, JQCFG)))
    got = tq.adc_full_scale(torch.tensor(0.7), torch.tensor(0.3), TQCFG)
    want = jq.adc_full_scale(jnp.float32(0.7), jnp.float32(0.3), JQCFG)
    assert float(got) == float(want)


@pytest.mark.parametrize("shape", [(8, 128, 128), (130, 192, 257),
                                   (8, 192, 70)])
def test_cim_plain_matches_kernel_and_oracle(shape):
    x, w, gain, off = _operands(*shape)
    xj, wj, gj, oj = map(jnp.asarray, (x, w, gain, off))
    fs = jops._measured_full_scale(xj, wj, JQCFG)
    kernel = np.asarray(jops.cim_matmul_nonideal(xj, wj, JQCFG, gj, oj,
                                                 interpret=True))
    oracle = np.asarray(jref.cim_mvm_nonideal_ref(xj, wj, JQCFG, fs, gj, oj))
    fs_t = tops.measured_full_scale(torch.as_tensor(x), torch.as_tensor(w),
                                    TQCFG)
    np.testing.assert_allclose(float(fs_t), float(fs), rtol=1e-6)
    got = cim_mvm_plain(torch.as_tensor(x), torch.as_tensor(w),
                        torch.tensor([float(fs)]), TQCFG,
                        torch.as_tensor(gain), torch.as_tensor(off)).numpy()
    for want in (kernel, oracle):
        flips = int((np.abs(got - want) > 1e-4).sum())
        assert flips == 0, f"{flips} outputs off by an ADC code"
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    # the public entry point on CPU tensors is the plain version
    via_ops = tops.cim_matmul_nonideal(
        torch.as_tensor(x), torch.as_tensor(w), TQCFG,
        torch.as_tensor(gain), torch.as_tensor(off)).numpy()
    np.testing.assert_allclose(via_ops, kernel, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("shape", [(8, 192, 70), (50, 64, 16)])
def test_zero_variation_front_end_is_the_ideal_adc(shape):
    x, w, _, _ = _operands(*shape, seed=2)
    xt, wt = torch.as_tensor(x), torch.as_tensor(w)
    n = shape[2]
    ideal = tops.cim_matmul(xt, wt, TQCFG)
    zero = tops.cim_matmul_nonideal(xt, wt, TQCFG, torch.ones(n),
                                    torch.zeros(n))
    assert torch.equal(zero, ideal)
    want = np.asarray(jops.cim_matmul(jnp.asarray(x), jnp.asarray(w), JQCFG,
                                      interpret=True))
    np.testing.assert_allclose(ideal.numpy(), want, rtol=1e-4, atol=1e-4)


def test_cim_wrapper_refuses_what_the_kernel_does_not_take():
    x, w, _, _ = _operands(4, 96, 8)
    with pytest.raises(ValueError, match="multiple of the chunk"):
        cim_mvm(torch.as_tensor(x), torch.as_tensor(w), torch.ones(1),
                TQCFG)
    meta = torch.empty((4, 64), device="meta")
    with pytest.raises(ValueError, match="no CIM kernel"):
        cim_mvm(meta, torch.empty((64, 8), device="meta"),
                torch.ones(1, device="meta"), TQCFG)


def test_im2col_matches_reference():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((3, 15, 15, 16)).astype(np.float32)
    want = np.asarray(jsar._im2col(jnp.asarray(x), 3, 2))
    got = tsar._im2col(torch.as_tensor(x), 3, 2).numpy()
    assert got.shape == want.shape == (3, 7, 7, 144)
    np.testing.assert_array_equal(got, want)


@pytest.fixture(scope="module")
def trunk_case():
    params = jsar.init_sar_cnn(jax.random.PRNGKey(3), jsar.SarCnnConfig())
    imgs = np.stack([r.payload for r in j_stream(4, corrupt_frac=0.25,
                                                 corruption="fog")])
    return jax.device_get(params), imgs


def _chips():
    return [("golden", j_golden()),
            ("seed11_sev2", j_sample(11, 1, JVariationSpec().scaled(2.0))[0]),
            ("seed0_sev1", j_sample(0, 1, JVariationSpec())[0])]


def _flips(got, want):
    """Outputs off by an ADC code.  A conv output is a sum of code·lsb
    steps (lsb ≈ 0.01-0.08 here), so two packages differ either by float
    rounding (≤ 1e-6) or by at least part of one LSB (ReLU may cut it)."""
    return np.abs(got - want) > 1e-3


@pytest.mark.parametrize("which", [0, 1, 2], ids=[c[0] for c in _chips()])
def test_nonideal_conv_layers_match(trunk_case, which):
    """Each conv layer on the die, fed the reference's input.  The ADC
    full scale is a mean over the first 16 rows' chunk sums, taken in
    another order than XLA's, so it may differ in its last bit; where a
    partial sum sits on a half-code tie (8-bit inputs and weights put
    them on a lattice) that flips one 6-bit code by one LSB.  Such flips
    are counted, each must be at most one LSB, and at most 1e-3 of the
    outputs may flip; every other output agrees to 1e-5."""
    params, imgs = trunk_case
    chip = _chips()[which][1]
    cfg_j, cfg_t = jsar.SarCnnConfig(), tsar.SarCnnConfig()
    trunk = tsar.program_trunk(params_from_jax(params), cfg_t,
                               instance_from_tree(chip.to_tree()))
    h = jnp.asarray(imgs)
    for i, layer in enumerate(params["convs"]):
        want = np.asarray(jsar._conv(h, layer["w"], layer["b"], cfg_j,
                                     chip=chip, layer_idx=i))
        got = tsar._cim_conv(torch.tensor(np.asarray(h)), trunk[i],
                             cfg_t).numpy()
        assert got.shape == want.shape
        # this layer's LSB, from the reference's full scale
        cols = np.asarray(jsar._im2col(h, layer["w"].shape[0], 2))
        xq, _ = jq.quantize_input(jnp.asarray(cols.reshape(-1,
                                                           cols.shape[-1])),
                                  cfg_j.quant)
        xq = np.pad(np.asarray(xq), ((0, 0), (0, trunk[i]["w"].shape[0]
                                              - cols.shape[-1])))
        lsb = float(jops._measured_full_scale(
            jnp.asarray(xq), jnp.asarray(trunk[i]["w"].numpy()),
            cfg_j.quant)) / 31
        flips = _flips(got, want)
        assert flips.sum() <= 1e-3 * got.size, \
            f"layer {i}: {flips.sum()} ADC code flips in {got.size}"
        assert (np.abs(got - want)[flips] <= lsb * (1 + 1e-4)).all(), \
            f"layer {i}: a difference larger than one LSB ({lsb})"
        np.testing.assert_allclose(got[~flips], want[~flips], rtol=1e-5,
                                   atol=1e-5)
        h = jnp.asarray(want)


@pytest.mark.parametrize("which", [0, 1, 2], ids=[c[0] for c in _chips()])
def test_chip_features_match(trunk_case, which):
    """``features(chip=…)`` on 4 images.  Both trunks run end to end;
    their layer outputs are compared on the way and ADC code flips
    (see above) counted.  With none, the features agree to atol 1e-5.
    A flip moves later layers' inputs and the batch-wide input scale
    and full scale, so with flips the features are held to atol 1e-2
    (a first-layer LSB over the GAP window) and the flips to at most
    1e-3 of the trunk's outputs."""
    params, imgs = trunk_case
    chip = _chips()[which][1]
    cfg_j, cfg_t = jsar.SarCnnConfig(), tsar.SarCnnConfig()
    tparams = params_from_jax(params)
    tchip = instance_from_tree(chip.to_tree())
    trunk = tsar.program_trunk(tparams, cfg_t, tchip)
    hj, ht = jnp.asarray(imgs), torch.as_tensor(imgs)
    flips = outputs = 0
    for i, layer in enumerate(params["convs"]):
        hj = jsar._conv(hj, layer["w"], layer["b"], cfg_j, chip=chip,
                        layer_idx=i)
        ht = tsar._cim_conv(ht, trunk[i], cfg_t)
        flips += int(_flips(ht.numpy(), np.asarray(hj)).sum())
        outputs += ht.numel()
    want = np.asarray(jsar.features(params, jnp.asarray(imgs), cfg_j,
                                    chip=chip))
    got = tsar.features(tparams, torch.as_tensor(imgs), cfg_t, chip=tchip)
    assert got.shape == (4, 64)
    np.testing.assert_array_equal(got.numpy(),
                                  ht.mean(dim=(1, 2)).numpy())
    assert flips <= 1e-3 * outputs, f"{flips} ADC code flips in {outputs}"
    atol = 1e-5 if flips == 0 else 1e-2
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=atol,
                               err_msg=f"{flips} ADC code flips upstream")
    # the arrays programmed once give the same trunk
    again = tsar.features(tparams, torch.as_tensor(imgs), cfg_t,
                          trunk=trunk)
    assert torch.equal(again, got)
