"""The port's CUDA kernels against their plain PyTorch versions, on a
Hopper card (compute capability 9.0).  Marked ``cuda``: elsewhere every
test here skips with its reason.  Run on the card with

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Decision kernel: rtol/atol 1e-5, as tests/test_decision_kernel.py: the
kernel sums the online logsumexp and the 16-term mix in its own order.
CIM kernel: rtol/atol 1e-4, as tests/test_kernels.py; the kernel sums
each 64-term partial sum in its own order, so an output may land one
ADC code away where the partial sum sits on a half-code tie: such
outputs are counted, held to one LSB and to at most 1e-4 of the
outputs.
"""

import pytest
import torch

from repro_torch.core.clt_grng import GRNGConfig
from repro_torch.core.quant import QuantConfig
from repro_torch.core.sampling import (BayesHeadConfig, activation_basis,
                                       prepare_serving_head)
from repro_torch.kernels.cim import cim_mvm, cim_mvm_plain
from repro_torch.kernels.decision import (decision_stats,
                                          decision_stats_plain)
from repro_torch.kernels.ops import measured_full_scale
from repro_torch.serving import adaptive

pytestmark = pytest.mark.cuda
KEYS = ("sum_p", "sum_psq", "sum_ent", "sum_entsq")


@pytest.fixture(scope="module")
def hopper():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (compute capability 9.0)")
    if torch.cuda.get_device_capability(0) != (9, 0):
        pytest.skip("the kernels are built for sm_90a (Hopper)")
    return torch.device("cuda")


def _case(dev, b, n, r, read_sigma, seed=0):
    gen = torch.Generator().manual_seed(seed)
    grng = GRNGConfig(read_sigma=read_sigma)
    hcfg = BayesHeadConfig(mode="rank16", grng=grng,
                           compute_dtype=torch.float32, hoist_basis=True)
    mu = (torch.randn((48, n), generator=gen) * 0.3).to(dev)
    sigma = torch.nn.functional.softplus(
        torch.randn((48, n), generator=gen) - 3).to(dev)
    x = torch.randn((b, 48), generator=gen).to(dev)
    ab = activation_basis(prepare_serving_head(mu, sigma, hcfg), x, hcfg)
    base = torch.arange(b, dtype=torch.int64, device=dev) * 20
    drawn = torch.zeros(b, dtype=torch.int32, device=dev)
    return dict(y_mu=ab["y_mu"].contiguous(),
                x_sigma=ab["x_sigma"].contiguous(), m=ab["m"].contiguous(),
                sel=adaptive.stream_selections(grng, base, drawn, r),
                cfg=grng,
                x_sigsq=(ab["x_sigsq"].contiguous() if read_sigma else None),
                sample_idx=adaptive.stream_indices(base, drawn, r),
                mask=torch.arange(b, device=dev) % 3 != 0)


@pytest.mark.parametrize("shape", [(32, 2, 4), (32, 2, 20), (9, 300, 6),
                                   (3, 129, 64)])
@pytest.mark.parametrize("read_sigma", [0.0, 0.4])
def test_decision_kernel_matches_plain(hopper, shape, read_sigma):
    args = _case(hopper, *shape, read_sigma)
    before = decision_stats.launches
    got = decision_stats(**args)
    want = decision_stats_plain(**args)
    again = decision_stats(**args)
    torch.cuda.synchronize()
    assert decision_stats.launches == before + 2
    for key in KEYS:
        torch.testing.assert_close(got[key], want[key], rtol=1e-5,
                                   atol=1e-5, msg=key)
        assert torch.equal(got[key], again[key]), key     # deterministic


def test_decision_wrapper_refuses_what_the_kernel_does_not_take(hopper):
    args = _case(hopper, 4, 2, 65, 0.0)
    with pytest.raises(ValueError, match="1..64"):
        decision_stats(**args)
    args = _case(hopper, 4, 2, 4, 0.0)
    with pytest.raises(TypeError, match="float32"):
        decision_stats(**dict(args, y_mu=args["y_mu"].double()))
    with pytest.raises(ValueError, match="contiguous"):
        decision_stats(**dict(args, m=args["m"].transpose(0, 1)
                              .contiguous().transpose(0, 1)))


QCFG = QuantConfig(enabled=True)


def _cim_case(dev, m, k, n, seed=0):
    gen = torch.Generator().manual_seed(seed)
    x = torch.randn((m, k), generator=gen).to(dev)
    w = (torch.randn((k, n), generator=gen) * 0.05).to(dev)
    return dict(x=x, w=w, fs=measured_full_scale(x, w, QCFG).reshape(1),
                col_gain=(1 + 0.02 * torch.randn(n, generator=gen)).to(dev),
                col_offset=(0.6 * torch.randn(n, generator=gen)).to(dev))


@pytest.mark.parametrize("shape", [(7200, 64, 16), (1568, 192, 32),
                                   (288, 320, 64), (130, 192, 257),
                                   (8, 192, 70)])
@pytest.mark.parametrize("front", ["ideal", "die"])
def test_cim_kernel_matches_plain(hopper, shape, front):
    args = _cim_case(hopper, *shape)
    if front == "ideal":
        args.update(col_gain=None, col_offset=None)
    before = cim_mvm.launches
    got = cim_mvm(qcfg=QCFG, **args)
    want = cim_mvm_plain(qcfg=QCFG, **args)
    again = cim_mvm(qcfg=QCFG, **args)
    torch.cuda.synchronize()
    assert cim_mvm.launches == before + 2
    assert torch.equal(got, again)                        # deterministic
    err = (got - want).abs()
    flips = err > 1e-4
    assert int(flips.sum()) <= 1e-4 * got.numel()
    assert bool((err[flips] <= float(args["fs"]) / 31 * (1 + 1e-4)).all())
    torch.testing.assert_close(got[~flips], want[~flips], rtol=1e-4,
                               atol=1e-4)


def test_cim_zero_variation_is_the_ideal_adc(hopper):
    args = _cim_case(hopper, 1568, 192, 32, seed=1)
    n = args["w"].shape[1]
    ideal = cim_mvm(args["x"], args["w"], args["fs"], QCFG)
    zero = cim_mvm(args["x"], args["w"], args["fs"], QCFG,
                   torch.ones(n, device=hopper),
                   torch.zeros(n, device=hopper))
    torch.cuda.synchronize()
    assert torch.equal(ideal, zero)


def test_cim_wrapper_refuses_what_the_kernel_does_not_take(hopper):
    args = _cim_case(hopper, 8, 192, 70)
    with pytest.raises(ValueError, match="multiple of the chunk"):
        cim_mvm(args["x"][:, :100].contiguous(), args["w"][:100],
                args["fs"], QCFG)
    with pytest.raises(ValueError, match="expected cuda"):
        cim_mvm(args["x"], args["w"].cpu(), args["fs"], QCFG)
    with pytest.raises(ValueError, match="expected cuda"):
        cim_mvm(args["x"], args["w"], args["fs"].cpu(), QCFG)
    with pytest.raises(TypeError, match="float32"):
        cim_mvm(args["x"].double(), args["w"], args["fs"], QCFG)
    with pytest.raises(ValueError, match="contiguous"):
        cim_mvm(args["x"], args["w"].t().contiguous().t(), args["fs"],
                QCFG)
