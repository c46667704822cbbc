"""The port's CUDA kernels against their plain PyTorch versions, on a
Hopper card (compute capability 9.0).  Marked ``cuda``: elsewhere every
test here skips with its reason.  Run on the card with

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Decision kernel: rtol/atol 1e-5, as tests/test_decision_kernel.py: the
kernel sums the logsumexp, the 16-term mix and the sums over samples in
its own order.  The cases cover both variants (N ≤ 32 small-N, N > 32
tiled, ``kernels/decision.py`` ``decision_plan``), R from 1 to 64,
read noise keyed on global ``rows``, masked slots, shared and per-slot
selections, and N on both sides of a tile boundary.  Above N = 32 each
statistic is also held to rtol 1e-4 with absolute floors of 1e-4 × R/N
(sum_p), × R/N² (sum_psq) and × R (the entropies): at N = 4,097 a
sum_psq entry is ~1e-6, which atol 1e-5 alone would not see.
CIM kernel: rtol/atol 1e-4, as tests/test_kernels.py; the kernel sums
each 64-term partial sum in its own order, so an output may land one
ADC code away where the partial sum sits on a half-code tie: such
outputs are counted, held to one LSB and to at most 1e-4 of the
outputs.  The shapes cover every branch of ``kernels/cim.py``
``launch_plan``: chunks split over a cluster and walked by one block
(one chunk, and several), N of 16, 32, 48, 64, 70 and 257, ragged M, K
of 64 to 640, and x not 16-byte aligned; and every plan the kernel
takes gives the bits of the one ``launch_plan`` picks.
GRNG ε kernel: equal bits (``torch.equal``): it rounds every step as
the plain version does, and a 0/1 selection row's fused multiply-adds
round as its product chain does (tests/test_torch_grng.py).
The gate die's head deployed on the card (calibration included): the
constants and arrays within 1e-6 of the CPU's deployment, no
quantization code different.
Head kernels (rank16, paper, paper with the ADC): rtol/atol 1e-4, as
tests/test_kernels.py; they sum over K in their own order (an ADC code
flipped by that order is counted and held to one LSB).  Every plan
``kernels/bayes.py`` ``head_plans`` lists gives the bits of the plan
``head_plan`` picks: each computes a chunk's partial sums as the same
chains and folds them in chunk order.
``ops.decision_update`` over R > 64 (two launches a round): rtol/atol
1e-5 against one unsplit plain call.
Training: the float trunk in float32 on the card even where cuDNN's
TF32 switch is on (its default), within 1e-5 of the CPU; the ε kernel
bit for bit at the training draw's shape (64, 2, R = 1); ten training
steps on the card against the CPU (tolerance stated in the test).
Mission: a short mission on the card against the CPU in each mode (the
same logs, confidence within 1e-5, decision launches = steps × rounds
a step), and a die's step loop under ``set_sync_debug_mode("error")``.
Telemetry and lifetime: the serving engine's telemetry on the card
against the CPU (counters and histograms equal, GRNG moments within a
relative 1e-5: the probe sums in another order), with the same verdicts
and host syncs as with telemetry off; a lifetime serve on an aged die,
card against CPU (the same advisories, heals and ``calib_epoch``;
verdicts equal unless the two trunks differ by an ADC code, ROADMAP
C9); an aged mission's segments under ``set_sync_debug_mode("error")``
with one sync a segment.
The dense LM: the decision kernel at N = 152,064 (qwen3-0.6b's padded
vocabulary) against its plain version, rtol 1e-4 with absolute floors
scaled to a uniform distribution's entries (stated in the test); the
SMOKE config's engine in float32 on the card against the CPU.
The MoE LM: ``moe_apply`` on the card against its CPU run in float32
(the same routing and keep mask, y within 1e-5, aux within 1e-6; E 8,
k 2 as mixtral and E 128, k 8 as qwen3-moe, with drops); the decision
kernel at mixtral's padded vocabulary (N = 32,000, B 4) to the dense
LM's tolerance and rank16 at its head (B 4, K 4,096, N 32,000, R 8,
bf16 operands widened by the wrapper) to rtol/atol 1e-4.
The SSM LMs: the decision kernel at mamba2-130m's and zamba2-2.7b's
padded vocabularies (N = 50,432 and 32,000, B 4) to the dense LM's
tolerance, rank16 at their heads (K 768 and 2,560, R 8, bf16) to
rtol/atol 1e-4, and ``ssd_chunked`` at mamba2-130m's layer shape: 512
tokens equal to two chunks with the state carried, card against CPU.
The audio and VLM LMs: the decision kernel at whisper-medium's and
llama-3.2-vision-11b's padded vocabularies (N = 51,968 and 128,256, B 4)
to the dense LM's tolerance, rank16 at their heads (K 1,024 and 4,096,
R 8, bf16) to rtol/atol 1e-4, and both SMOKE configs' engines in
float32, card against CPU, as qwen3-0.6b's.
The LM trainer: the ε kernel at qwen3-0.6b's head width ([1,024 ×
152,064], one launch) bit for bit on three column blocks; three float32
SMOKE training steps card against CPU (tolerances stated in the test);
``train``'s resume after ``fail_at`` bit for bit on the card.
Observability: the engine's cost records against the launches the
wrappers count (the same verdicts and syncs with the instruments on and
off), and ``trace_capture``'s trace holding every decision and CIM
launch under its CUDA symbol.
"""

import numpy as np
import pytest
import torch

from repro_torch.core.clt_grng import GRNGConfig, selections
from repro_torch.core.quant import QuantConfig, adc_full_scale
from repro_torch.core.sampling import (BayesHeadConfig, activation_basis,
                                       prepare_serving_head)
from repro_torch.kernels import bayes, cim, grng
from repro_torch.kernels.cim import cim_mvm, cim_mvm_plain
from repro_torch.kernels.decision import (decision_stats,
                                          decision_stats_plain)
from repro_torch.kernels.ops import (bayes_head_mvm, decision_update,
                                     measured_full_scale)
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


def _case(dev, b, n, r, read_sigma, seed=0, shared_sel=False,
          row_offset=0):
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
    sel = adaptive.stream_selections(grng, base, drawn, r)
    idx = adaptive.stream_indices(base, drawn, r)
    if shared_sel:
        sel, idx = sel[:, 0].contiguous(), idx[:, 0].contiguous()
    rows = (torch.arange(b, dtype=torch.int64, device=dev) + row_offset
            if row_offset else None)
    return dict(y_mu=ab["y_mu"].contiguous(),
                x_sigma=ab["x_sigma"].contiguous(), m=ab["m"].contiguous(),
                sel=sel, cfg=grng,
                x_sigsq=(ab["x_sigsq"].contiguous() if read_sigma else None),
                sample_idx=idx, mask=torch.arange(b, device=dev) % 3 != 0,
                rows=rows)


def _floor(key, r, n):
    """The scale of a statistic's entries: R/N, R/N² or R."""
    return {"sum_p": r / n, "sum_psq": r / n**2, "sum_ent": r,
            "sum_entsq": r}[key]


def _check_decision(args):
    before = decision_stats.launches
    got = decision_stats(**args)
    want = decision_stats_plain(**args)
    again = decision_stats(**args)
    torch.cuda.synchronize()
    assert decision_stats.launches == before + 2
    n, r = args["y_mu"].shape[1], args["sel"].shape[0]
    for key in KEYS:
        torch.testing.assert_close(got[key], want[key], rtol=1e-5,
                                   atol=1e-5, msg=key)
        if n > 32:
            torch.testing.assert_close(got[key], want[key], rtol=1e-4,
                                       atol=1e-4 * _floor(key, r, n),
                                       msg=key)
        assert torch.equal(got[key], again[key]), key     # deterministic
    masked = ~args["mask"]
    assert bool((got["sum_p"][masked] == 0).all())
    assert bool((got["sum_ent"][masked] == 0).all())


@pytest.mark.parametrize("shape", [
    (32, 2, 1), (32, 2, 4), (32, 2, 20), (32, 2, 32), (32, 2, 33),
    (32, 2, 64), (7, 1, 5), (6, 3, 17), (7, 32, 64), (7, 33, 64),
    (9, 300, 6), (3, 129, 64),
    # the tiled variant on both sides of its tile boundaries (256 and
    # 512 columns), and wide
    (5, 33, 20), (4, 255, 4), (4, 256, 20), (4, 257, 64), (3, 511, 1),
    (3, 512, 20), (3, 513, 8), (3, 4097, 20), (2, 50280, 20)])
@pytest.mark.parametrize("read_sigma", [0.0, 0.4])
def test_decision_kernel_matches_plain(hopper, shape, read_sigma):
    _check_decision(_case(hopper, *shape, read_sigma))


@pytest.mark.parametrize("n", [2, 32, 33, 255, 256, 257, 4097])
@pytest.mark.parametrize("shared_sel", [False, True])
def test_decision_kernel_rows_and_shared_selections(hopper, n, shared_sel):
    """Read noise keyed on global slot ids (a shard's ``rows``), with a
    selection per slot or one for all slots, on both sides of the small-N
    routing threshold and of a tile boundary of the tiled variant."""
    _check_decision(_case(hopper, 12, n, 20, 0.4, seed=3,
                          shared_sel=shared_sel, row_offset=1000))


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
                                   (8, 192, 70), (7200, 192, 64),
                                   (130, 320, 16), (8, 64, 32),
                                   (288, 640, 70), (576, 320, 48)])
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


@pytest.mark.parametrize("shape", [(7200, 64, 16), (288, 320, 64),
                                   (130, 192, 257)])
def test_cim_kernel_reads_unaligned_x(hopper, shape):
    """x 4 bytes past a 16-byte boundary takes the kernel's 4-byte copies;
    the bits are those of the aligned copy."""
    args = _cim_case(hopper, *shape, seed=2)
    m, k = args["x"].shape
    flat = torch.empty(m * k + 1, device=hopper)
    x = flat[1:].view(m, k)
    x.copy_(args["x"])
    assert x.data_ptr() % 16 and x.is_contiguous()
    got = cim_mvm(qcfg=QCFG, **dict(args, x=x))
    want = cim_mvm(qcfg=QCFG, **args)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.parametrize("shape", [(1568, 192, 32), (288, 320, 64),
                                   (130, 192, 257), (8, 512, 70)])
def test_cim_every_plan_gives_the_same_bits(hopper, shape):
    """Each tile_m, split or walked, folds the same chunk codes in the
    same order: the bits do not depend on the plan."""
    args = _cim_case(hopper, *shape, seed=3)
    x, w, fs = args["x"], args["w"], args["fs"]
    (m, k), n = x.shape, w.shape[1]
    chosen = cim.launch_plan(m, k, n)
    want = cim_mvm(qcfg=QCFG, **args)
    splits = sorted({1, k // cim.CHUNK})
    tried = 0
    for tile_m in cim.TILE_M:
        for split in splits:
            plan = cim.make_plan(m, n, tile_m, chosen.tile_n, split)
            if plan.smem_bytes > cim.SMEM_LIMIT:
                continue
            got = cim._launch(x, w, fs, QCFG, args["col_gain"],
                              args["col_offset"], plan=plan)
            torch.cuda.synchronize()
            assert torch.equal(got, want), plan
            tried += 1
    assert tried >= len(cim.TILE_M)


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


WRAP = 2**32


@pytest.mark.parametrize("case", [
    (256, 256, 8, 0, 0, 0), (200, 130, 8, 16, 40, 5), (1, 1, 3, 3, 9, 11),
    (300, 70, 64, 0, 0, 100), (512, 2048, 20, 0, 0, 0), (37, 45, 1, 7, 3, 2),
    (70, 33, 64, WRAP - 20, WRAP - 7, WRAP - 30),
    (41, 90, 5, WRAP + 5, 2 * WRAP - 3, WRAP + 2), (20, 40, 130, 0, 0, 3)])
@pytest.mark.parametrize("die", [False, True])
def test_grng_eps_kernel_matches_plain(hopper, case, die):
    """Bit for bit: Fig. 9's block, kernel_bench's ε block, ragged K and
    N, R = 1 and R = 130 (three stages of samples), and offsets up to
    and past the 2^32 wrap, on an ideal and an aged, noisy die."""
    k, n, r, row0, col0, sample0 = case
    cfg = (GRNGConfig(read_sigma=0.5, imprint=0.37) if die
           else GRNGConfig())
    sel = selections(cfg, r, sample0 % 4096, device=hopper)
    kw = dict(row0=row0, col0=col0, sample0=sample0)
    before = grng.grng_eps.launches
    got = grng.grng_eps(sel, cfg, k, n, **kw)
    want = grng.grng_eps_plain(sel, cfg, k, n, **kw)
    again = grng.grng_eps(sel, cfg, k, n, **kw)
    torch.cuda.synchronize()
    assert grng.grng_eps.launches == before + 2
    assert torch.equal(got, again)
    assert torch.equal(got, want)


@pytest.mark.parametrize("die", [False, True])
def test_grng_eps_kernel_product_chain(hopper, die):
    """Selection rows holding values other than 0 and 1 (the kernel's
    product chain), among 0/1 rows (its fused sums): bit for bit."""
    cfg = (GRNGConfig(read_sigma=0.5, imprint=0.37) if die
           else GRNGConfig())
    gen = torch.Generator().manual_seed(4)
    sel = selections(cfg, 12, 0, device=hopper)
    sel[1] = torch.rand(16, generator=gen).to(hopper)
    sel[5] = torch.where(sel[5] > 0, 0.5, -0.25)
    sel[11] = -sel[11]
    got = grng.grng_eps(sel, cfg, 40, 70, row0=3, col0=8, sample0=2)
    want = grng.grng_eps_plain(sel, cfg, 40, 70, row0=3, col0=8, sample0=2)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.parametrize("quant", [False, True])
def test_die_head_deployed_on_the_card(hopper, quant):
    """The gate die's calibrated head deployed on the card against the
    CPU's deployment: the measured constants to rtol 1e-6 and the arrays
    to 1e-6, as tests/test_torch_hw.py holds the port to the reference
    (a mean and an SD over 131,072 sums, reduced in another order); with
    the 8-bit µ' / 4-bit σ quantization no code differs."""
    import dataclasses

    from repro_torch.core.bayes_layer import sigma_of
    from repro_torch.hw import (VariationSpec, prepare_instance_head,
                                sample_instances)
    from repro_torch.models.sar_cnn import SarCnnConfig, init_sar_cnn
    die = sample_instances(11, 1, VariationSpec().scaled(2.0))[0]
    cfg = SarCnnConfig()
    head = init_sar_cnn(torch.Generator().manual_seed(3), cfg)["head"]
    hcfg = BayesHeadConfig(num_samples=20, mode="rank16", grng=cfg.grng,
                           compute_dtype=torch.float32, hoist_basis=True,
                           quant=QuantConfig(enabled=quant))
    mu, sigma = head["mu"], sigma_of(head)
    card, card_cfg = prepare_instance_head(mu.to(hopper), sigma.to(hopper),
                                           hcfg, die)
    cpu, cpu_cfg = prepare_instance_head(mu, sigma, hcfg, die)
    assert dataclasses.replace(card_cfg.grng, sum_mean=0., sum_std=0.) == \
        dataclasses.replace(cpu_cfg.grng, sum_mean=0., sum_std=0.)
    torch.testing.assert_close(card_cfg.grng.sum_mean, cpu_cfg.grng.sum_mean,
                               rtol=1e-6, atol=0)
    torch.testing.assert_close(card_cfg.grng.sum_std, cpu_cfg.grng.sum_std,
                               rtol=1e-6, atol=0)
    assert set(card) == set(cpu)
    for key, value in cpu.items():
        assert card[key].device.type == "cuda", key
        torch.testing.assert_close(card[key].cpu(), value, rtol=1e-6,
                                   atol=1e-6, msg=key)
    if quant:
        for key, levels in (("mu_prime", 127), ("sigma", 15)):
            step = cpu[key].abs().amax(dim=0, keepdim=True) / levels
            flips = (card[key].cpu() - cpu[key]).abs() > 0.5 * step
            assert int(flips.sum()) == 0, f"{key}: codes differ"


def _rms(t):
    return torch.sqrt((t.float() ** 2).mean() + 1e-12)


def _head_case(dev, b, k, n, dtype=torch.float32, seed=0):
    gen = torch.Generator().manual_seed(seed)
    x = torch.randn((b, k), generator=gen)
    mu = torch.randn((k, n), generator=gen) * 0.05
    sigma = torch.nn.functional.softplus(
        torch.randn((k, n), generator=gen) - 2.0) * 0.1
    return [t.to(dev, dtype) for t in (x, mu, sigma)]


@pytest.mark.parametrize("shape", [(8, 512, 2048), (64, 64, 2), (3, 130, 70),
                                   (9, 200, 33)])
@pytest.mark.parametrize("r", [4, 20, 64])
@pytest.mark.parametrize("mode", ["rank16", "paper", "paper_adc"])
@pytest.mark.parametrize("read_sigma", [0.0, 0.4])
def test_head_kernels_match_plain(hopper, shape, r, mode, read_sigma):
    cfg = GRNGConfig(read_sigma=read_sigma)
    x, mu, sigma = _head_case(hopper, *shape)
    sel = selections(cfg, r, 7, device=hopper)
    if mode == "rank16":
        fn, plain, args = bayes.bayes_rank16, bayes.bayes_rank16_plain, ()
    else:
        fn, plain = bayes.bayes_paper, bayes.bayes_paper_plain
        qcfg = QCFG if mode == "paper_adc" else None
        fs = torch.stack([adc_full_scale(_rms(x), _rms(w), QCFG)
                          for w in (mu, sigma)])
        args = (fs, cfg, qcfg)
    kw = dict(row0=3, col0=5, sample0=7)
    before = fn.launches
    if mode == "rank16":
        got = fn(x, mu, sigma, sel, cfg, **kw)
        want = plain(x, mu, sigma, sel, cfg, **kw)
        again = fn(x, mu, sigma, sel, cfg, **kw)
    else:
        got = fn(x, mu, sigma, sel, *args, **kw)
        want = plain(x, mu, sigma, sel, *args, **kw)
        again = fn(x, mu, sigma, sel, *args, **kw)
    torch.cuda.synchronize()
    assert fn.launches == before + 2
    assert got.shape == (r, shape[0], shape[2])
    assert torch.equal(got, again)                        # deterministic
    if mode == "paper_adc":
        # an ADC code may flip where a partial sum sits on a half-code
        # tie and the two sum in another order: held to one LSB, rare
        err = (got - want).abs()
        flips = err > 1e-4
        assert int(flips.sum()) <= 1e-4 * got.numel()
        assert bool((err[flips] <= float(fs.max()) / 31 * (1 + 1e-4)).all())
        got, want = got[~flips], want[~flips]
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("mode", ["rank16", "paper"])
def test_head_kernels_read_bf16(hopper, mode):
    cfg = GRNGConfig()
    x, mu, sigma = _head_case(hopper, 8, 256, 192, dtype=torch.bfloat16)
    got = bayes_head_mvm(x, mu, sigma, cfg, 5, mode=mode)
    want = bayes_head_mvm(x.float(), mu.float(), sigma.float(), cfg, 5,
                          mode=mode)
    mixed = bayes_head_mvm(x.float(), mu, sigma, cfg, 5, mode=mode)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(mixed, want, rtol=1e-4, atol=1e-4)


def test_head_and_grng_wrappers_refuse_what_the_kernels_do_not_take(hopper):
    cfg = GRNGConfig()
    x, mu, sigma = _head_case(hopper, 4, 64, 8)
    sel = selections(cfg, 4, device=hopper)
    with pytest.raises(ValueError, match="expected cuda"):
        bayes.bayes_rank16(x, mu.cpu(), sigma, sel, cfg)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        bayes.bayes_rank16(x.double(), mu, sigma, sel, cfg)
    with pytest.raises(TypeError, match="must match"):
        bayes.bayes_paper(x, mu, sigma.bfloat16(), sel, None, cfg)
    with pytest.raises(ValueError, match="contiguous"):
        bayes.bayes_paper(x, mu.t().contiguous().t(), sigma, sel, None, cfg)
    with pytest.raises(ValueError, match="fs must be"):
        bayes.bayes_paper(x, mu, sigma, sel, torch.zeros(2), cfg, QCFG)
    with pytest.raises(ValueError, match="every 64 rows"):
        bayes.bayes_paper(x, mu, sigma, sel, torch.zeros(2, device=hopper),
                          cfg, QuantConfig(chunk=32))
    with pytest.raises(ValueError, match=r"\[R, 16\]"):
        grng.grng_eps(sel.t().contiguous(), cfg, 8, 8)
    with pytest.raises(TypeError, match="float32"):
        grng.grng_eps(sel.double(), cfg, 8, 8)


@pytest.mark.parametrize("r", [65, 100])
@pytest.mark.parametrize("read_sigma", [0.0, 0.4])
def test_decision_update_above_the_kernel_cap(hopper, r, read_sigma):
    """A round of R > 64 samples: ⌈R/64⌉ launches whose deltas add up to
    the plain version of the whole round."""
    args = _case(hopper, 12, 2, r, read_sigma, seed=5)
    stats = adaptive.init_stats(12, 2, device=hopper)
    before = decision_stats.launches
    got = decision_update(stats, {k: args[k] for k in
                                  ("y_mu", "x_sigma", "m", "x_sigsq")
                                  if args[k] is not None},
                          args["sel"], args["cfg"],
                          sample_idx=args["sample_idx"], mask=args["mask"])
    want = decision_stats_plain(**args)
    torch.cuda.synchronize()
    assert decision_stats.launches == before + 2
    for key in KEYS:
        torch.testing.assert_close(got[key], want[key], rtol=1e-5,
                                   atol=1e-5, msg=key)
    assert bool((got["n"] == args["mask"].to(got["n"].dtype) * r).all())


def _plain_head(mode, x, mu, sigma, sel, fs, cfg, **kw):
    if mode == "rank16":
        return bayes.bayes_rank16_plain(x, mu, sigma, sel, cfg, **kw)
    return bayes.bayes_paper_plain(x, mu, sigma, sel, fs, cfg,
                                   QCFG if mode == "paper_adc" else None,
                                   **kw)


@pytest.mark.parametrize("shape", [(64, 64, 2, 20), (8, 512, 2048, 20),
                                   (3, 130, 70, 100), (9, 200, 33, 20),
                                   (70, 64, 5, 4)])
@pytest.mark.parametrize("mode", ["rank16", "paper", "paper_adc"])
def test_head_every_plan_gives_the_chosen_bits(hopper, shape, mode):
    """Every plan of ``head_plans`` (tile widths, threads, the samples
    a paper block carries) gives the bits of ``head_plan``'s
    plan, which agrees with the plain version, with read noise and
    offsets; B = 70 takes two row tiles, R = 100 two sample chunks."""
    b, k, n, r = shape
    cfg = GRNGConfig(read_sigma=0.4)
    x, mu, sigma = _head_case(hopper, b, k, n, seed=4)
    sel = selections(cfg, r, 7, device=hopper)
    fs = torch.stack([adc_full_scale(_rms(x), _rms(w), QCFG)
                      for w in (mu, sigma)])
    kind = "rank16" if mode == "rank16" else "paper"
    levels = 31 if mode == "paper_adc" else 0
    args = (kind, x, mu, sigma, sel, fs, cfg, levels, 3, 5, 7)
    chosen = bayes.head_plan(kind, b, k, n, r)
    want = bayes._launch(*args, plan=chosen)
    plans = bayes.head_plans(kind, b, k, n, r)
    assert chosen in plans
    for plan in plans:
        got = bayes._launch(*args, plan=plan)
        torch.cuda.synchronize()
        assert torch.equal(got, want), plan
    plain = _plain_head(mode, x, mu, sigma, sel, fs, cfg, row0=3, col0=5,
                        sample0=7)
    err = (want - plain).abs()
    flips = err > 1e-4 + 1e-4 * plain.abs() if levels else err < 0
    assert int(flips.sum()) <= 1e-4 * want.numel()
    assert bool((err[flips] <= float(fs.max()) / 31 * (1 + 1e-4)).all())
    torch.testing.assert_close(want[~flips], plain[~flips], rtol=1e-4,
                               atol=1e-4)


# ----------------------------------------------------------------------
# the training slice on the card
# ----------------------------------------------------------------------
def test_float_trunk_is_float32_on_the_card(hopper):
    """The card's ``features`` of the published ``SarCnnConfig()``
    against the CPU's within 1e-5, with cuDNN's TF32 switch forced back
    to PyTorch's default (True) around the call: the trunk must pin its
    convolutions to float32 itself (a TF32 convolution keeps a 10-bit
    mantissa and misses by ~1e-3)."""
    from repro_torch.data.sard import SardConfig, batch_at
    from repro_torch.models import sar_cnn
    cfg = sar_cnn.SarCnnConfig()
    params = sar_cnn.init_sar_cnn(torch.Generator().manual_seed(3), cfg)
    images = batch_at(SardConfig(seed=7), 10_000, 64)["images"]
    dev_params = {"convs": [{k: v.to(hopper) for k, v in c.items()}
                            for c in params["convs"]],
                  "head": {k: v.to(hopper) for k, v in params["head"].items()}}
    saved = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    try:
        card = sar_cnn.features(dev_params, images.to(hopper), cfg)
    finally:
        torch.backends.cudnn.allow_tf32 = saved
    assert torch.backends.cudnn.allow_tf32 == saved
    cpu = sar_cnn.features(params, images, cfg)
    torch.testing.assert_close(card.cpu(), cpu, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("sample0", [0, 1, 799, 1599, 2**32 - 1])
def test_grng_eps_at_the_training_shape(hopper, sample0):
    """The training draw's ε block, (64, 2, R = 1) at the step's indexed
    selection, bit for bit against the plain version."""
    from repro_torch.core import lfsr
    cfg = GRNGConfig()
    idx = torch.full((1,), sample0, dtype=torch.int64, device=hopper)
    sel = lfsr.indexed_selections(cfg.lfsr_seed, idx)
    got = grng.grng_eps(sel, cfg, 64, 2, sample0=sample0)
    want = grng.grng_eps_plain(sel, cfg, 64, 2, sample0=sample0)
    torch.cuda.synchronize()
    assert got.shape == (1, 64, 2) and torch.equal(got, want)


TRAJECTORY_ATOL = 1e-4


def test_training_trajectory_card_against_cpu(hopper):
    """Ten training steps of the published ``SarCnnConfig()`` on the
    snow-augmented batches of ``trained_detector``, from the same init,
    on the card and on the CPU: one ε launch a step on the card, the
    per-step ce within 1e-5 and the params within TRAJECTORY_ATOL.  The
    two devices sum the convolutions and reductions in other orders
    (float32 both, cuDNN deterministic), and AdamW's normalized update
    carries a last-bit difference of a gradient into the params at the
    scale of lr where a gradient component is near zero."""
    from repro_torch.data.sard import SardConfig
    from repro_torch.mission import detector
    from repro_torch.models import sar_cnn
    from repro_torch.optim import init_opt_state
    from repro_torch.utils.trees import leaves
    cfg = sar_cnn.SarCnnConfig()
    dcfg = SardConfig(seed=detector.DATA_SEED)
    state = {}
    for dev in ("cpu", hopper):
        params = sar_cnn.init_sar_cnn(torch.Generator().manual_seed(3), cfg,
                                      device=dev)
        state[str(dev)] = [params, init_opt_state(params), []]
    grng.grng_eps.launches = 0
    for s in range(10):
        batch = detector.training_batch(dcfg, s, "snow", 0.5)
        for dev, st in state.items():
            b = {k: v.to(dev) for k, v in batch.items()}
            st[0], st[1], m = detector.train_step(st[0], st[1], b, cfg, s)
            st[2].append(float(m["ce"]))
    assert grng.grng_eps.launches == 10
    cpu, card = state["cpu"], state[str(hopper)]
    np.testing.assert_allclose(card[2], cpu[2], rtol=0, atol=1e-5)
    for a, b in zip(leaves(card[0]), leaves(cpu[0])):
        assert a.device.type == "cuda"
        torch.testing.assert_close(a.cpu(), b, rtol=0, atol=TRAJECTORY_ATOL)


MISSION_INT_LOGS = ("cell", "active", "verdict", "prediction", "spent",
                    "orbited", "verify", "found", "false_verify", "truth")


def _short_mission(device, chip=None, mode="bayes_adaptive"):
    from repro_torch.mission import (MissionPolicy, UavConfig, WorldConfig,
                                     fly_mission)
    from repro_torch.models import sar_cnn
    cfg = sar_cnn.SarCnnConfig()
    params = sar_cnn.init_sar_cnn(torch.Generator().manual_seed(3), cfg,
                                  device=device)
    return fly_mission(WorldConfig(grid=6, n_victims=3, seed=2),
                       UavConfig(n_drones=2, battery_J=120e-6),
                       MissionPolicy(mode=mode), params=params, chips=chip,
                       n_steps=8, device=device)


@pytest.mark.parametrize("mode", ["bayes_adaptive", "bayes_fixed",
                                  "deterministic"])
def test_mission_card_against_cpu(hopper, mode):
    """A short mission (the reference's test world, 8 steps, random
    params seeded 3) on the card and on the CPU: the same logs lane for
    lane, confidence within 1e-5 (the float trunk and the decision
    kernel sum in their own orders), one host sync each, and the
    decision kernel launched steps × rounds a step (3 + 2 adaptive,
    1 + 2 fixed, 0 deterministic)."""
    from repro_torch.kernels.decision import decision_stats
    decision_stats.launches = 0
    card = _short_mission(hopper, mode=mode)
    launches = decision_stats.launches
    cpu = _short_mission("cpu", mode=mode)
    assert card.host_syncs == cpu.host_syncs == 1
    assert launches == 8 * {"bayes_adaptive": 5, "bayes_fixed": 3,
                            "deterministic": 0}[mode]
    for k in MISSION_INT_LOGS:
        np.testing.assert_array_equal(card.logs[k], cpu.logs[k], err_msg=k)
    np.testing.assert_allclose(card.logs["confidence"],
                               cpu.logs["confidence"], rtol=0, atol=1e-5)
    np.testing.assert_allclose(card.logs["energy_J"], cpu.logs["energy_J"],
                               rtol=1e-6)


def test_mission_step_loop_does_not_sync(hopper):
    """The episode's step loop on a die (CIM trunk, read-noise decision
    rounds, the orbit) under ``set_sync_debug_mode("error")``: no call
    inside it waits for the card."""
    from repro_torch.hw import VariationSpec, sample_instances
    from repro_torch.kernels.cim import cim_mvm
    from repro_torch.mission import (MissionPolicy, UavConfig, WorldConfig,
                                     rollout, uav, world)
    from repro_torch.models import sar_cnn
    cfg = sar_cnn.SarCnnConfig()
    params = sar_cnn.init_sar_cnn(torch.Generator().manual_seed(3), cfg,
                                  device=hopper)
    chip = sample_instances(11, 1, VariationSpec().scaled(2.5))[0]
    wcfg = WorldConfig(grid=6, n_victims=3, seed=2)
    ucfg = UavConfig(n_drones=2, battery_J=120e-6)
    fn, head, bias, _ = rollout.group_episode(
        wcfg, ucfg, MissionPolicy(), params, cfg, chip, True,
        rollout.sar_mission_cost(cfg), True, 6)
    state = (world.stack_worlds(wcfg, 1, device=hopper),
             uav.init_fleet(ucfg, wcfg.grid, 1, device=hopper),
             {k: torch.as_tensor(v, device=hopper)
              for k, v in rollout.init_maps(wcfg, 1, 2).items()},
             uav.fleet_bindings(ucfg, wcfg.grid, 1, device=hopper))
    torch.cuda.synchronize()
    cim_mvm.launches = 0
    torch.cuda.set_sync_debug_mode("error")
    try:
        _, _, logs = fn(params, head, bias, *state)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert cim_mvm.launches == 3 * 3 * 6
    assert logs["verdict"].shape == (6, 2)
    assert bool(torch.isfinite(logs["confidence"]).all())


def test_mission_state_defaults_to_the_card(hopper):
    """The worlds and the fleet, built with no device, are on the card
    (the world is drawn on the host and moved there)."""
    from repro_torch.mission import UavConfig, WorldConfig, uav, world
    wcfg, ucfg = WorldConfig(grid=6, n_victims=3, seed=2), UavConfig(2)
    for state in (world.make_world(wcfg), world.stack_worlds(wcfg, 2),
                  uav.init_fleet(ucfg, wcfg.grid, 2),
                  uav.fleet_bindings(ucfg, wcfg.grid, 2)):
        assert all(v.device.type == "cuda" for v in state.values())
    assert torch.equal(world.make_world(wcfg)["severity"].cpu(),
                       world.make_world(wcfg, device="cpu")["severity"])


def _telemetry_serve(device, telemetry=True, chip=None):
    from repro_torch.launch.serve import serve_sar
    from repro_torch.serving import TriagePolicy
    return serve_sar(n_requests=64, n_slots=16, corrupt_frac=0.25,
                     policy=TriagePolicy(conf_threshold=0.55,
                                         mi_threshold=0.05),
                     chip_instance=chip, telemetry=telemetry, device=device)


def test_serving_telemetry_card_against_cpu(hopper):
    """The engine's telemetry on the card equals the CPU's: counters and
    histograms exactly, the GRNG moments within a relative 1e-5; with
    telemetry off the card serves the same verdicts with the same
    syncs."""
    card = _telemetry_serve(hopper)
    cpu = _telemetry_serve("cpu")
    off = _telemetry_serve(hopper, telemetry=False)
    for key in ("rounds", "dispatches", "samples", "decisions", "verdicts",
                "r_hist", "conf_hist", "ent_hist", "mi_hist"):
        assert card["telemetry"][key] == cpu["telemetry"][key], key
    for key in ("n", "sum", "sumsq"):
        np.testing.assert_allclose(card["telemetry"]["grng"][key],
                                   cpu["telemetry"]["grng"][key], rtol=1e-5)
    assert [v["verdict"] for v in card["verdicts"]] == \
        [v["verdict"] for v in off["verdicts"]]
    assert card["host_syncs"] == off["host_syncs"] == cpu["host_syncs"]
    assert card["drift"]["drifted"] == cpu["drift"]["drifted"] is False


def test_lifetime_serve_card_against_cpu(hopper):
    """A lifetime serve on the seed-11 severity-2.5 die (30 days over 48
    requests, 2 epochs, healing), card against CPU."""
    from repro_torch.hw import (LifetimeConfig, VariationSpec,
                                sample_instances)
    from repro_torch.launch.serve import serve_sar_lifetime
    chip = sample_instances(11, 1, VariationSpec().scaled(2.5))[0]
    kw = dict(lifetime=LifetimeConfig(age_rate=30 * 86400 / 48, epochs=2,
                                      auto_recalibrate=True),
              chip_instance=chip, n_requests=48, n_slots=16,
              corrupt_frac=0.25)
    card = serve_sar_lifetime(device=hopper, **kw)
    cpu = serve_sar_lifetime(device="cpu", **kw)
    for key in ("advisories", "heals", "calib_epoch", "age_s"):
        assert card["lifetime"][key] == cpu["lifetime"][key], key
    assert card["lifetime"]["heals"] >= 1
    same = sum(a["verdict"] == b["verdict"] for a, b in
               zip(card["verdicts"], cpu["verdicts"]))
    assert same >= 46, f"{48 - same} verdicts differ card vs CPU"


def test_aged_mission_segments_do_not_sync(hopper, monkeypatch):
    """An aged mission: each segment's step loop under
    ``set_sync_debug_mode("error")``, one pull a segment."""
    from repro_torch.hw import (LifetimeConfig, VariationSpec,
                                sample_instances)
    from repro_torch.mission import rollout
    chip = sample_instances(11, 1, VariationSpec().scaled(2.5))[0]
    real = rollout._episode_fn

    def checked(*args, **kw):
        fn = real(*args, **kw)

        def run(*a, **k):
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("error")
            try:
                return fn(*a, **k)
            finally:
                torch.cuda.set_sync_debug_mode(0)
        return run

    monkeypatch.setattr(rollout, "_episode_fn", checked)
    res = _short_mission(hopper, chip=chip)
    assert res.host_syncs == 1
    from repro_torch.mission import (MissionPolicy, UavConfig, WorldConfig,
                                     fly_mission)
    from repro_torch.models import sar_cnn
    cfg = sar_cnn.SarCnnConfig()
    params = sar_cnn.init_sar_cnn(torch.Generator().manual_seed(3), cfg,
                                  device=hopper)
    aged = fly_mission(WorldConfig(grid=6, n_victims=3, seed=2),
                       UavConfig(n_drones=2, battery_J=120e-6),
                       MissionPolicy(), params=params, chips=chip,
                       n_steps=8, device=hopper,
                       lifetime=LifetimeConfig(age_rate=86400.0, epochs=4))
    assert aged.host_syncs == 4


@pytest.mark.parametrize("die,fused", [(False, True), (True, True),
                                       (True, False)])
def test_cost_records_match_the_launch_counts(hopper, die, fused):
    """The engine's cost records on the card: launches a dispatch (an
    admission) times the dispatches (admissions) equal the launches the
    wrappers counted, and 0 for the decision kernel on the unfused
    route; the run states the allocator's peak once; the instruments on
    and off give the same verdicts and syncs."""
    from repro_torch.hw import VariationSpec, sample_instances
    from repro_torch.launch.serve import serve_sar
    from repro_torch.obs.trace import Tracer
    chip = sample_instances(11, 1, VariationSpec().scaled(2.0))[0] \
        if die else None
    kw = dict(n_requests=64, n_slots=16, corrupt_frac=0.25,
              chip_instance=chip, fused=fused, device=hopper)
    cim_mvm.launches = decision_stats.launches = 0
    out = serve_sar(cost_records=True, tracer=Tracer(), slo=("0.25:p99",),
                    **kw)
    costs = out["compiled_costs"]
    per_dispatch = sum(c["launches_per_dispatch"] for c in costs
                       if c["kernel"] == "decision_stats")
    per_admission = sum(c["launches_per_admission"] for c in costs
                        if c["kernel"] == "cim_mvm")
    assert per_dispatch * out["host_syncs"] == decision_stats.launches
    assert (decision_stats.launches > 0) == fused
    assert per_admission * out["admissions"] == cim_mvm.launches
    assert (cim_mvm.launches > 0) == die
    assert out["max_memory_allocated"] > 0
    assert not any("max_memory_allocated" in c for c in costs)
    off = serve_sar(profiler=False, slo=False, **kw)
    assert [(v["verdict"], v["n_samples"]) for v in off["verdicts"]] == \
        [(v["verdict"], v["n_samples"]) for v in out["verdicts"]]
    assert off["host_syncs"] == out["host_syncs"]
    assert "slo" not in off and out["slo"]["requests"] == 64


def test_second_engine_builds_nothing(hopper):
    """The kernels' cached builders (plans, launchers, library loads)
    are built by the first engine of a config and by no later one."""
    from repro_torch.hw import VariationSpec, sample_instances
    from repro_torch.launch.serve import serve_sar
    from repro_torch.obs.prof import builder_builds
    chip = sample_instances(11, 1, VariationSpec().scaled(2.0))[0]
    kw = dict(n_requests=32, n_slots=16, chip_instance=chip,
              cost_records=True, device=hopper)
    serve_sar(**kw)
    first = builder_builds()
    assert first["decision_launcher"] == first["cim_launcher"] == 1
    serve_sar(**kw)
    assert builder_builds() == first


def test_trace_capture_names_the_kernels(hopper, tmp_path):
    """``trace_capture`` on the card: the Chrome trace holds one kernel
    event per decision and CIM launch, under their CUDA symbols."""
    import json
    from repro_torch.hw import VariationSpec, sample_instances
    from repro_torch.launch.serve import serve_sar
    from repro_torch.obs.prof import trace_capture
    chip = sample_instances(11, 1, VariationSpec().scaled(2.0))[0]
    kw = dict(n_requests=32, n_slots=16, chip_instance=chip, device=hopper)
    serve_sar(**kw)                                       # warm-up
    cim_mvm.launches = decision_stats.launches = 0
    with trace_capture(str(tmp_path)) as got:
        serve_sar(**kw)
        torch.cuda.synchronize()
    names = [e["name"] for e in json.loads(open(got.path).read())
             ["traceEvents"] if e.get("cat") == "kernel"]
    assert sum("decision_stats_small_n_kernel" in n for n in names) == \
        decision_stats.launches > 0
    assert sum("cim_mvm_kernel" in n for n in names) == \
        cim_mvm.launches > 0


# ----------------------------------------------------------------------
# the dense LM at vocabulary width
# ----------------------------------------------------------------------
LM_N = 152064            # qwen3-0.6b's padded vocabulary


@pytest.mark.parametrize("r", [4, 20])
@pytest.mark.parametrize("read_sigma", [0.0, 0.4])
def test_decision_kernel_at_vocabulary_width(hopper, r, read_sigma):
    """The tiled variant at N = 152,064 against its plain version.
    A sum_p entry is ~R/N here, so atol 1e-5 would pass a 10 % error:
    rtol 1e-4 with absolute floors of 1e-4 × R/N (sum_p), × R/N²
    (sum_psq) and × R (the entropies)."""
    args = _case(hopper, 4, LM_N, r, read_sigma)
    before = decision_stats.launches
    got = decision_stats(**args)
    want = decision_stats_plain(**args)
    torch.cuda.synchronize()
    assert decision_stats.launches == before + 1
    for key in KEYS:
        torch.testing.assert_close(got[key], want[key], rtol=1e-4,
                                   atol=1e-4 * _floor(key, r, LM_N), msg=key)
    assert bool((got["sum_p"][~args["mask"]] == 0).all())


@pytest.mark.parametrize("adaptive", [True, False])
def test_lm_engine_smoke_card_against_cpu(hopper, adaptive):
    """qwen3-0.6b's SMOKE config in float32 served on the card (the
    decision kernel) and on the CPU (its plain version) from the same
    params and prompts, accepting every token (adaptive: 4 samples a
    token; fixed: R = 20): the same verdicts, tokens, samples and token
    counts, confidence and MI within 1e-5 (ROADMAP C6).  An escalating
    policy is not held to equality here: a standard error that differs
    by C6's ~1e-5 can move a decision at its threshold by a round."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import params_init, serve
    from repro_torch.serving import TriagePolicy
    cfg = dataclasses.replace(get_config("qwen3-0.6b", smoke=True),
                              dtype=torch.float32)
    params = params_init(cfg, 0, "cpu")
    outs = {}
    for dev in ("cpu", "cuda"):
        before = decision_stats.launches
        outs[dev] = serve("qwen3-0.6b", cfg=cfg, params=params, device=dev,
                          batch=2, prompt_len=8, gen_len=3, n_requests=3,
                          adaptive=adaptive,
                          policy=TriagePolicy(conf_threshold=0.0,
                                              mi_threshold=1e9, r_min=4,
                                              r_max=20))
        launched = decision_stats.launches - before
        assert (launched > 0) == (dev == "cuda")
    got = sorted(outs["cuda"]["verdicts"], key=lambda v: v["rid"])
    want = sorted(outs["cpu"]["verdicts"], key=lambda v: v["rid"])
    assert [(v["rid"], v["verdict"], v["prediction"], v["n_samples"],
             v["n_tokens"]) for v in got] == \
        [(v["rid"], v["verdict"], v["prediction"], v["n_samples"],
          v["n_tokens"]) for v in want]
    for a, b in zip(got, want):
        assert abs(a["confidence"] - b["confidence"]) <= 1e-5
        assert abs(a["mutual_information"]
                   - b["mutual_information"]) <= 1e-5
    assert outs["cuda"]["host_syncs"] == outs["cpu"]["host_syncs"]


# ----------------------------------------------------------------------
# the MoE LM
# ----------------------------------------------------------------------
MIXTRAL_N = 32000        # mixtral-8x7b's padded vocabulary


@pytest.mark.parametrize("e,k", [(8, 2), (128, 8)])
def test_moe_apply_card_against_cpu(hopper, e, k):
    """moe_apply in float32 on the card and on the CPU from the same
    inputs: routing and keep mask equal, y within 1e-5, aux within
    1e-6 (the products sum in another order; TF32 off)."""
    from repro_torch import float32_math
    from repro_torch.models import moe
    gen = torch.Generator().manual_seed(e)
    d, f = 256, 192
    x = torch.randn((4, 16, d), generator=gen)
    router = torch.randn((d, e), generator=gen) / d ** 0.5
    router[:, 0] += x.reshape(-1, d).mean(0)          # expert 0 overflows
    wi, wg = (torch.randn((e, d, f), generator=gen) / d ** 0.5
              for _ in range(2))
    wo = torch.randn((e, f, d), generator=gen) / f ** 0.5
    args = (x, router, wi, wg, wo)
    out, routes = {}, {}
    with float32_math():
        for dev in ("cpu", "cuda"):
            a = [t.to(dev) for t in args]
            _, _, experts = moe.route(a[0].reshape(-1, d), a[1], k)
            t = experts.shape[0]
            routes[dev] = (experts.cpu(), moe.dispatch(
                experts, e, int(max(k, 1.25 * t * k / e)))[2].cpu())
            out[dev] = [v.cpu() for v in moe.moe_apply(*a, top_k=k)]
    assert torch.equal(routes["cuda"][0], routes["cpu"][0])
    assert torch.equal(routes["cuda"][1], routes["cpu"][1])
    assert not bool(routes["cpu"][1].all())             # some pairs drop
    torch.testing.assert_close(out["cuda"][0], out["cpu"][0], rtol=0,
                               atol=1e-5)
    torch.testing.assert_close(out["cuda"][1], out["cpu"][1], rtol=0,
                               atol=1e-6)


@pytest.mark.parametrize("r", [4, 8, 20])
def test_decision_kernel_at_mixtral_vocabulary(hopper, r):
    args = _case(hopper, 4, MIXTRAL_N, r, 0.0)
    got = decision_stats(**args)
    want = decision_stats_plain(**args)
    torch.cuda.synchronize()
    for key in KEYS:
        torch.testing.assert_close(got[key], want[key], rtol=1e-4,
                                   atol=1e-4 * _floor(key, r, MIXTRAL_N),
                                   msg=key)


def test_rank16_at_mixtral_head(hopper):
    """decode_step's head at mixtral's width: B 4, K 4,096, N 32,000,
    R 8 (its uq_samples), bf16 x, µ' and σ."""
    cfg = GRNGConfig()
    x, mu, sigma = _head_case(hopper, 4, 4096, MIXTRAL_N,
                              dtype=torch.bfloat16)
    sel = selections(cfg, 8, 11, device=hopper)
    before = bayes.bayes_rank16.launches
    got = bayes.bayes_rank16(x, mu, sigma, sel, cfg)
    want = bayes.bayes_rank16_plain(x, mu, sigma, sel, cfg)
    torch.cuda.synchronize()
    assert bayes.bayes_rank16.launches == before + 1
    assert got.shape == (8, 4, MIXTRAL_N)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


# ----------------------------------------------------------------------
# the SSM and hybrid LMs
# ----------------------------------------------------------------------
SSM_HEADS = {"mamba2-130m": (768, 50432), "zamba2-2.7b": (2560, 32000)}


@pytest.mark.parametrize("arch", list(SSM_HEADS))
@pytest.mark.parametrize("r,read_sigma", [(4, 0.0), (20, 0.0), (20, 0.4)])
def test_decision_kernel_at_ssm_vocabulary(hopper, arch, r, read_sigma):
    """The tiled variant at each SSM arch's padded vocabulary (B 4),
    held as at qwen3-0.6b's: rtol 1e-4 with absolute floors of 1e-4 ×
    R/N, × R/N² and × R."""
    n = SSM_HEADS[arch][1]
    args = _case(hopper, 4, n, r, read_sigma)
    got = decision_stats(**args)
    want = decision_stats_plain(**args)
    torch.cuda.synchronize()
    for key in KEYS:
        torch.testing.assert_close(got[key], want[key], rtol=1e-4,
                                   atol=1e-4 * _floor(key, r, n), msg=key)


@pytest.mark.parametrize("arch", list(SSM_HEADS))
def test_rank16_at_ssm_heads(hopper, arch):
    """decode_step_ssm's head: B 4, K d_model, N the padded vocabulary,
    R 8 (uq_samples), bf16 x, µ' and σ; rtol/atol 1e-4."""
    k, n = SSM_HEADS[arch]
    cfg = GRNGConfig()
    x, mu, sigma = _head_case(hopper, 4, k, n, dtype=torch.bfloat16)
    sel = selections(cfg, 8, 13, device=hopper)
    before = bayes.bayes_rank16.launches
    got = bayes.bayes_rank16(x, mu, sigma, sel, cfg)
    want = bayes.bayes_rank16_plain(x, mu, sigma, sel, cfg)
    torch.cuda.synchronize()
    assert bayes.bayes_rank16.launches == before + 1
    assert got.shape == (8, 4, n)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


def test_ssm_chunk_carry_card_against_cpu(hopper):
    """ssd_chunked in float32 at mamba2-130m's full-width layer shape (B
    2, H 24, P 64, N 128, chunk 256) over 512 tokens equals two 256-token
    calls with the state carried, on the card, and the card equals the
    CPU (the products sum in another order; TF32 off): y and the final
    state within rtol 1e-4, atol 1e-5."""
    from repro_torch import float32_math
    from repro_torch.models.mamba2 import ssd_chunked
    gen = torch.Generator().manual_seed(3)
    b, s, h, p, n = 2, 512, 24, 64, 128
    args = [torch.randn((b, s, h, p), generator=gen) * 0.5,
            torch.nn.functional.softplus(torch.randn((b, s, h),
                                                     generator=gen) - 2),
            -torch.exp(torch.randn((h,), generator=gen) * 0.3),
            torch.randn((b, s, 1, n), generator=gen) * 0.3,
            torch.randn((b, s, 1, n), generator=gen) * 0.3]
    out = {}
    with float32_math():
        for dev in ("cpu", "cuda"):
            a = [t.to(dev) for t in args]
            y, st = ssd_chunked(*a, 256)
            y1, st1 = ssd_chunked(*(t[:, :256] if t.ndim > 1 else t
                                    for t in a), 256)
            y2, st2 = ssd_chunked(*(t[:, 256:] if t.ndim > 1 else t
                                    for t in a), 256, st1)
            torch.testing.assert_close(torch.cat([y1, y2], 1), y,
                                       rtol=1e-4, atol=1e-5)
            torch.testing.assert_close(st2, st, rtol=1e-4, atol=1e-5)
            out[dev] = (y.cpu(), st.cpu())
    for got, want in zip(out["cuda"], out["cpu"]):
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-5)


# ----------------------------------------------------------------------
# the audio and VLM LMs
# ----------------------------------------------------------------------
XATTN_HEADS = {"whisper-medium": (1024, 51968),
               "llama-3.2-vision-11b": (4096, 128256)}


@pytest.mark.parametrize("arch", list(XATTN_HEADS))
@pytest.mark.parametrize("r,read_sigma", [(4, 0.0), (20, 0.0), (20, 0.4)])
def test_decision_kernel_at_xattn_vocabulary(hopper, arch, r, read_sigma):
    """The tiled variant at each arch's padded vocabulary (B 4), held as
    at qwen3-0.6b's: rtol 1e-4 with absolute floors of 1e-4 × R/N,
    × R/N² and × R."""
    n = XATTN_HEADS[arch][1]
    args = _case(hopper, 4, n, r, read_sigma)
    got = decision_stats(**args)
    want = decision_stats_plain(**args)
    torch.cuda.synchronize()
    for key in KEYS:
        torch.testing.assert_close(got[key], want[key], rtol=1e-4,
                                   atol=1e-4 * _floor(key, r, n), msg=key)


@pytest.mark.parametrize("arch", list(XATTN_HEADS))
def test_rank16_at_xattn_heads(hopper, arch):
    """decode_step's head: B 4, K d_model, N the padded vocabulary, R 8
    (uq_samples), bf16 x, µ' and σ; rtol/atol 1e-4."""
    k, n = XATTN_HEADS[arch]
    cfg = GRNGConfig()
    x, mu, sigma = _head_case(hopper, 4, k, n, dtype=torch.bfloat16)
    sel = selections(cfg, 8, 17, device=hopper)
    before = bayes.bayes_rank16.launches
    got = bayes.bayes_rank16(x, mu, sigma, sel, cfg)
    want = bayes.bayes_rank16_plain(x, mu, sigma, sel, cfg)
    torch.cuda.synchronize()
    assert bayes.bayes_rank16.launches == before + 1
    assert got.shape == (8, 4, n)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("arch", list(XATTN_HEADS))
def test_xattn_engine_smoke_card_against_cpu(hopper, arch):
    """Each SMOKE config in float32 served on the card and on the CPU
    from the same params, prompts and stub memory, accepting every
    token: the same verdicts, tokens, samples and host syncs,
    confidence and MI within 1e-5 (ROADMAP C6); whisper's third request
    waits for the drain, so both runs admit twice."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import params_init, serve
    from repro_torch.serving import TriagePolicy
    cfg = dataclasses.replace(get_config(arch, smoke=True),
                              dtype=torch.float32)
    params = params_init(cfg, 0, "cpu")
    outs = {}
    for dev in ("cpu", "cuda"):
        outs[dev] = serve(arch, cfg=cfg, params=params, device=dev, batch=2,
                          prompt_len=8, gen_len=3, n_requests=3,
                          policy=TriagePolicy(conf_threshold=0.0,
                                              mi_threshold=1e9, r_min=4,
                                              r_max=8))
    got = sorted(outs["cuda"]["verdicts"], key=lambda v: v["rid"])
    want = sorted(outs["cpu"]["verdicts"], key=lambda v: v["rid"])
    assert [(v["rid"], v["verdict"], v["prediction"], v["n_samples"],
             v["n_tokens"]) for v in got] == \
        [(v["rid"], v["verdict"], v["prediction"], v["n_samples"],
          v["n_tokens"]) for v in want]
    for a, b in zip(got, want):
        assert abs(a["confidence"] - b["confidence"]) <= 1e-5
        assert abs(a["mutual_information"]
                   - b["mutual_information"]) <= 1e-5
    assert outs["cuda"]["host_syncs"] == outs["cpu"]["host_syncs"]
    assert outs["cuda"]["admissions"] == outs["cpu"]["admissions"] == 2


# ----------------------------------------------------------------------
# the LM trainer on the card
# ----------------------------------------------------------------------
LM_TRAIN_LOSS_ATOL = 1e-4
LM_TRAIN_PARAM_ATOL = 1e-3


def test_grng_eps_at_vocabulary_width(hopper):
    """The LM trainer's head draw at qwen3-0.6b's full width, [1,024 ×
    152,064] at one step's indexed selection (623 MB, one launch),
    bit for bit against the plain version on the first, a middle and
    the last (ragged) column block of 4,096 at their offsets."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.core import lfsr
    cfg = get_config("qwen3-0.6b")
    ideal = dataclasses.replace(cfg.grng, read_sigma=0.0, imprint=0.0)
    k, n, step = cfg.d_model, cfg.vocab_padded, 29
    sel = lfsr.indexed_selections(ideal.lfsr_seed, torch.full(
        (1,), step, dtype=torch.int64, device=hopper))
    before = grng.grng_eps.launches
    got = grng.grng_eps(sel, ideal, k, n, sample0=step)
    assert grng.grng_eps.launches == before + 1
    assert got.shape == (1, k, n)
    for c0 in (0, 77824, 151552):
        c1 = min(c0 + 4096, n)
        want = grng.grng_eps_plain(sel, ideal, k, c1 - c0, col0=c0,
                                   sample0=step)
        assert torch.equal(got[:, :, c0:c1], want), (c0, c1)


def test_lm_train_steps_card_against_cpu(hopper):
    """Three float32 training steps of qwen3-0.6b SMOKE through
    ``make_train_step`` on the card and on the CPU from the same params
    (drawn on the CPU) and batches: one ε launch a step on the card,
    each step's loss within LM_TRAIN_LOSS_ATOL and the params within
    LM_TRAIN_PARAM_ATOL (the float order of sums; AdamW's normalized
    update carries a last-bit gradient difference at lr's scale)."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.data.tokens import TokenPipelineConfig
    from repro_torch.launch.serve import params_init
    from repro_torch.launch.steps import make_train_step
    from repro_torch.launch.train import build_batch, pull_metrics
    from repro_torch.optim import AdamWConfig, init_opt_state
    from repro_torch.utils.trees import leaves, tree_map
    cfg = dataclasses.replace(get_config("qwen3-0.6b", smoke=True),
                              dtype=torch.float32)
    pipe = TokenPipelineConfig(vocab=cfg.vocab, seq_len=16, global_batch=4)
    step_fn = make_train_step(cfg, AdamWConfig(), total_steps=3,
                              warmup_steps=1)
    runs = {}
    grng.grng_eps.launches = 0
    for dev in ("cpu", "cuda"):
        params = tree_map(lambda t: t.to(dev), params_init(cfg, 0, "cpu"))
        opt = init_opt_state(params)
        losses = []
        for s in range(3):
            params, opt, m = step_fn(params, opt,
                                     build_batch(cfg, pipe, s, dev), s)
            losses.append(pull_metrics(m)["loss"])
        runs[dev] = (losses, params)
    assert grng.grng_eps.launches == 3
    np.testing.assert_allclose(runs["cuda"][0], runs["cpu"][0], rtol=0,
                               atol=LM_TRAIN_LOSS_ATOL)
    for a, b in zip(leaves(runs["cuda"][1]), leaves(runs["cpu"][1])):
        assert a.is_cuda
        torch.testing.assert_close(a.cpu(), b, rtol=0,
                                   atol=LM_TRAIN_PARAM_ATOL)


def test_lm_train_resume_on_the_card(hopper, tmp_path):
    """``train`` at SMOKE on the card: failing at step 3 with
    checkpoints every 2 steps, then rerun, equals an uninterrupted run
    bit for bit (params and losses)."""
    from repro_torch.launch.train import train
    from repro_torch.utils.trees import leaves
    kw = dict(steps=5, batch=4, seq=16)
    whole = train("qwen3-0.6b", **kw)
    with pytest.raises(SystemExit):
        train("qwen3-0.6b", ckpt_dir=str(tmp_path), ckpt_every=2, fail_at=3,
              **kw)
    resumed = train("qwen3-0.6b", ckpt_dir=str(tmp_path), ckpt_every=2,
                    **kw)
    assert [h["step"] for h in resumed["history"]] == [2, 3, 4]
    assert [h["loss"] for h in resumed["history"]] == \
        [h["loss"] for h in whole["history"][2:]]
    assert all(a.is_cuda and torch.equal(a, b) for a, b in
               zip(leaves(resumed["params"]), leaves(whole["params"])))
