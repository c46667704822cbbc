"""The port's CUDA kernels against their plain PyTorch versions, on a
Hopper card (compute capability 9.0).  Marked ``cuda``: elsewhere every
test here skips with its reason.  Run on the card with

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Tolerance rtol/atol 1e-5, as tests/test_decision_kernel.py: the kernel
sums the online logsumexp and the 16-term mix in its own order.
"""

import pytest
import torch

from repro_torch.core.clt_grng import GRNGConfig
from repro_torch.core.sampling import (BayesHeadConfig, activation_basis,
                                       prepare_serving_head)
from repro_torch.kernels.decision import (decision_stats,
                                          decision_stats_plain)
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
