"""Fused Bayesian head: the CUDA kernels' wrappers and their plain
versions.

Replaces the Pallas TPU kernel ``bayes_mvm_pallas``
(``repro/kernels/bayes_mvm.py:202``) in both of its modes, for
x [B, K], µ'/σ [K, N] (float32 or bfloat16, read as float32) and the
shared selections sel [R, 16] -> R logit samples [R, B, N] float32:

  * ``bayes_rank16``: y = x·µ', x·σ and the 16 basis products
    x·(σ⊙I_j), mixed with sel, minus sum_mean·x·σ, plus (on a die with
    read noise) its logit-level projection read_sigma·√((x²)·(σ²))·
    gauss(hash3(sample0+r, b, col0+n, noise_seed)), times
    float32(1/sum_std), plus y (``_rank16_kernel``, :58);
  * ``bayes_paper``: y + x·(σ⊙ε_r) per sample, ε_r with the per-cell
    read noise (``_paper_kernel``, :130); with the 6-bit ADC every
    64-row partial sum of x·µ' and of each x·(σ⊙ε_r) is digitized,
    full scales ``fs`` = [fs_µ, fs_σε] on the device.

Both route by where x lies: CPU tensors take the plain versions
(``bayes_rank16_plain``, ``core/sampling``'s basis products and mix;
``bayes_paper_plain``, ``core/sampling._sigma_eps_mvm`` without the ADC
and ``cim.cim_mvm_plain``'s chunked ADC with it — the oracles
``bayes_mvm_ref``, ``bayes_mvm_rank16_ref`` and ``bayes_mvm_adc_ref`` of
``repro/kernels/ref.py``); CUDA tensors launch ``csrc/bayes_mvm.cu`` or
raise.  There is no fallback.  ``bayes_rank16.launches`` and
``bayes_paper.launches`` count kernel launches.  ``head_plan`` picks the
kernel's tile, threads and samples a block carries from the shape.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.core import clt_grng as g
from repro_torch.core.quant import QuantConfig
from repro_torch.core.sampling import (BayesHeadConfig, _mix_block,
                                       _noise_key, _sigma_eps_mvm,
                                       sigma_basis_products)
from repro_torch.kernels.cim import cim_mvm_plain
from repro_torch.kernels.grng import GrngParams, grng_params

CHUNK = 64                # the ADC's analog accumulation depth
H100_SMS = 132
TILE_N = (1, 2, 4, 8, 16, 32)   # output columns a block may own
SAMPLES = (4, 8, 16, 32, 64)    # samples a paper block may carry at once
THREADS = (128, 256, 512)       # a block's threads
MAX_TILE_B = 64           # output rows a block owns (B > 64: more tiles)
SMEM_LIMIT = 227 * 1024   # a block's opt-in shared memory on the H100
_X_STRIDE = CHUNK + 4     # a padded x row in shared memory (floats)
_DTYPES = (torch.float32, torch.bfloat16)
_P = ctypes.c_void_p
_U32 = ctypes.c_uint


def _f32(*ts):
    return [t.to(torch.float32) for t in ts]


def bayes_rank16_plain(x, mu, sigma, sel, cfg: g.GRNGConfig, row0: int = 0,
                       col0: int = 0, sample0: int = 0) -> torch.Tensor:
    """Plain PyTorch version of the rank16 kernel: the activation basis
    in float32 (``core/sampling.sigma_basis_products``) mixed by
    ``core/sampling._mix_block``, the read noise keyed on the absolute
    sample indices."""
    x, mu, sigma = _f32(x, mu, sigma)
    m = sigma_basis_products(x, sigma, cfg, row0, col0)        # [B, N, 16]
    x_sigsq = (x * x) @ (sigma * sigma) if cfg.read_sigma else None
    idx = sample0 + torch.arange(sel.shape[0], dtype=torch.int64,
                                 device=x.device)
    return _mix_block(m, x @ mu, x @ sigma, x_sigsq, sel,
                      BayesHeadConfig(grng=cfg), _noise_key(sel, idx),
                      col0=col0)


def bayes_paper_plain(x, mu, sigma, sel, fs, cfg: g.GRNGConfig,
                      qcfg: QuantConfig | None = None, row0: int = 0,
                      col0: int = 0, sample0: int = 0) -> torch.Tensor:
    """Plain PyTorch version of the paper kernel: x·µ' plus one σε
    product per sample (``core/sampling._sigma_eps_mvm``), or with
    ``qcfg`` each product through ``cim.cim_mvm_plain`` (the chunked
    6-bit ADC, K zero-padded to the chunk), full scales fs [2]."""
    x, mu, sigma = _f32(x, mu, sigma)
    if qcfg is None:
        return (x @ mu)[None] + _sigma_eps_mvm(x, sigma, cfg, sel, sample0,
                                               row0, col0)
    kdim, n = sigma.shape
    fs = fs.to(torch.float32).reshape(2)
    pad = (-kdim) % qcfg.chunk
    xp = F.pad(x, (0, pad))

    def adc_mvm(w, full_scale):
        return cim_mvm_plain(xp, F.pad(w, (0, 0, 0, pad)), full_scale, qcfg)

    currents = g.device_currents_grid(cfg, kdim, n, row0, col0,
                                      device=x.device)
    y_mu = adc_mvm(mu, fs[0])
    return torch.stack([
        y_mu + adc_mvm(sigma * g.eps_at(currents, sel[r], cfg, sample0 + r,
                                        row0, col0), fs[1])
        for r in range(sel.shape[0])])


class HeadPlan(NamedTuple):
    """How ``csrc/bayes_mvm.cu`` covers one head product: a grid of
    output tiles of ``tile_n`` columns × ``tile_b`` rows (B rounded up to
    4, at most 64), one block a tile walking the K/64 chunks in order; a
    paper block carries ``samples`` samples at once and loops over the
    rest (0 for rank16).  The launcher refuses ``threads`` and
    ``smem_bytes`` that differ from what the tiles need."""
    tile_n: int
    tile_b: int
    samples: int
    threads: int
    blocks: int
    smem_bytes: int


def _quad(n: int) -> int:
    return -(-n // 4) * 4


def _tile_cols(kind: str, tile_n: int, samples: int) -> int:
    """Columns of a block's weight tile, whole 4-column micro-tiles:
    rank16 the 16 currents', µ's and σ's; paper ``samples`` σε columns
    and µ's."""
    return _quad((samples + 1) * tile_n if kind == "paper" else 18 * tile_n)


def _smem_bytes(kind: str, tile_n: int, tile_b: int, samples: int, r: int,
                chunks: int) -> int:
    """The kernel's shared memory (``layout`` in ``csrc/bayes_mvm.cu``),
    each region on 16 bytes: the ADC's steps, the selections (4 zero rows
    after R), x rows and µ/σ columns (two stages where there are several
    chunks), hash prefixes (the read noise's: paper a sample and
    column's, rank16 a row and column's), (paper: the chunk's currents in
    rows of 16 tile_n + 1), the weight tile (paper by column, in padded
    rows) and the sums (rank16 20 a column)."""
    paper = kind == "paper"
    stages = 2 if chunks > 1 else 1
    sums = (r + 1) * tile_n if paper else 20 * tile_n
    regions = [4, (_quad(r) + 4) * 16, stages * tile_b * _X_STRIDE,
               stages * CHUNK * tile_n, stages * CHUNK * tile_n,
               16 * tile_n, 16 * tile_n,
               samples * tile_n if paper else tile_b * tile_n,
               CHUNK * (16 * tile_n + 1) if paper else 0,
               _tile_cols(kind, tile_n, samples)
               * (_X_STRIDE if paper else CHUNK),
               tile_b * sums]
    return 4 * sum(_quad(f) for f in regions)


def make_head_plan(kind: str, b: int, k: int, n: int, r: int, tile_n: int,
                   samples: int, threads: int) -> HeadPlan:
    """The plan of the given tile width, samples (paper; 0 for rank16)
    and block threads for a product of x [b, k] and [k, n] weights into
    r samples."""
    if kind not in ("rank16", "paper"):
        raise ValueError(f"no head kernel of kind {kind!r}")
    tile_b = min(MAX_TILE_B, _quad(b))
    samples = samples if kind == "paper" else 0
    blocks = -(-n // tile_n) * -(-b // tile_b)
    return HeadPlan(tile_n, tile_b, samples, threads, blocks,
                    _smem_bytes(kind, tile_n, tile_b, samples, r,
                                -(-k // CHUNK)))


def _fits(kind: str, plan: HeadPlan) -> bool:
    """Shared memory within the card's; a thread for each of the 16
    tile_n generated columns, and (paper) for each of a chunk's cells."""
    cells = CHUNK if kind == "paper" else 16
    return (plan.smem_bytes <= SMEM_LIMIT
            and cells * plan.tile_n <= plan.threads)


def head_plans(kind: str, b: int, k: int, n: int, r: int) -> list[HeadPlan]:
    """Every plan the kernel takes for this product: each tile width up
    to N's power of two and each thread count, and for paper each sample
    count of ``SAMPLES`` below R, and R itself up to 64."""
    widest = 1 << (n - 1).bit_length()
    counts = ((0,) if kind == "rank16" else sorted(
        {s for s in SAMPLES if s < r} | ({r} if r <= SAMPLES[-1] else set())))
    plans = [make_head_plan(kind, b, k, n, r, t, s, th)
             for t in TILE_N if t <= widest for s in counts
             for th in THREADS]
    return [p for p in plans if _fits(kind, p)]


@functools.lru_cache(maxsize=None)
def head_plan(kind: str, b: int, k: int, n: int, r: int,
              sms: int = H100_SMS) -> HeadPlan:
    """The head kernel's launch plan for ``kind`` ('rank16' or 'paper')
    on a card of ``sms`` SMs, fitted to ``chip_smoke.py``'s head plan
    sweep (PERF.md) at the UQ path's shape and at kernel_bench's (R = 20,
    and paper at R = 64):

    * 512 threads;
    * paper carries all R samples at once where they fit, else the most
      of ``SAMPLES`` that fit;
    * the widest tile that still gives every SM a block and lets two
      blocks share an SM's shared memory, else the narrowest."""
    plans = [p for p in head_plans(kind, b, k, n, r) if p.threads == 512]
    if not plans:
        raise ValueError(f"no {kind} head plan fits B={b} K={k} N={n} "
                         f"R={r}")
    most = max(p.samples for p in plans)
    plans = [p for p in plans if p.samples == most]
    plans = [p for p in plans if 2 * p.smem_bytes <= SMEM_LIMIT] or plans
    return next((p for p in reversed(plans) if p.blocks >= sms), plans[0])


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


@functools.lru_cache(maxsize=None)
def _launcher():
    from repro_torch.kernels.build import load
    fn = load("bayes_mvm").bayes_head_launch
    fn.argtypes = ([ctypes.c_int] + [_P] * 6 + [ctypes.c_int] * 4
                   + [_U32] * 3 + [ctypes.c_int] * 6
                   + [ctypes.POINTER(GrngParams), _P])
    fn.restype = ctypes.c_int
    return fn


def _check(x, mu, sigma, sel):
    dev = x.device
    b, kdim = x.shape
    n = mu.shape[1]
    for name, t, shape in (("x", x, (b, kdim)), ("mu", mu, (kdim, n)),
                           ("sigma", sigma, (kdim, n)),
                           ("sel", sel, (sel.shape[0], 16))):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, expected {dev}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                             f"{shape}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if sel.data_ptr() % 16:
        raise ValueError("sel must be 16-byte aligned (float4 loads)")
    if x.dtype not in _DTYPES or mu.dtype not in _DTYPES:
        raise TypeError(f"x is {x.dtype} and mu {mu.dtype}: the kernels take "
                        f"float32 or bfloat16")
    if sigma.dtype != mu.dtype:
        raise TypeError(f"sigma is {sigma.dtype}, mu {mu.dtype}: they must "
                        f"match")
    if sel.dtype != torch.float32:
        raise TypeError(f"sel is {sel.dtype}, the kernels take float32")
    if min(b, kdim, n, sel.shape[0]) < 1:
        raise ValueError("empty head product")
    return b, kdim, n, sel.shape[0]


def _u32(v: int) -> int:
    return v & 0xFFFFFFFF


def _launch(kind: str, x, mu, sigma, sel, fs, cfg: g.GRNGConfig,
            levels: int = 0, row0: int = 0, col0: int = 0, sample0: int = 0,
            plan: HeadPlan | None = None) -> torch.Tensor:
    """Launches the head kernel of ``kind`` under ``head_plan``'s plan, or
    under ``plan`` where one is given (a plan sweep).  bfloat16 operands
    are widened to float32 first, exactly, as the kernel reads them."""
    b, kdim, n, r = _check(x, mu, sigma, sel)
    x, mu, sigma = _f32(x, mu, sigma)
    if plan is None:
        plan = head_plan(kind, b, kdim, n, r, _sm_count(x.device.index))
    out = torch.empty((r, b, n), dtype=torch.float32, device=x.device)
    params = grng_params(cfg)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = _launcher()(
            int(kind == "paper"), x.data_ptr(), mu.data_ptr(),
            sigma.data_ptr(), sel.data_ptr(),
            fs.data_ptr() if levels else None, out.data_ptr(), b, kdim, n,
            r, _u32(row0), _u32(col0), _u32(sample0), levels, plan.tile_n,
            plan.tile_b, plan.samples, plan.threads,
            plan.smem_bytes, ctypes.byref(params), stream)
    if err != 0:
        raise RuntimeError(f"{kind} head kernel launch failed: cudaError "
                           f"{err}")
    return out


def bayes_rank16(x, mu, sigma, sel, cfg: g.GRNGConfig, row0: int = 0,
                 col0: int = 0, sample0: int = 0) -> torch.Tensor:
    """Rank-16 head samples [R, B, N] float32.  CPU tensors take the
    plain version; CUDA tensors (x/µ'/σ float32 or bfloat16, µ' and σ
    alike, sel float32, all contiguous) launch the kernel or raise."""
    if x.device.type == "cpu":
        return bayes_rank16_plain(x, mu, sigma, sel, cfg, row0, col0,
                                  sample0)
    if x.device.type != "cuda":
        raise ValueError(f"no head kernel for device {x.device}")
    out = _launch("rank16", x, mu, sigma, sel, None, cfg, row0=row0,
                  col0=col0, sample0=sample0)
    bayes_rank16.launches += 1
    return out


def bayes_paper(x, mu, sigma, sel, fs, cfg: g.GRNGConfig,
                qcfg: QuantConfig | None = None, row0: int = 0,
                col0: int = 0, sample0: int = 0) -> torch.Tensor:
    """Paper-mode head samples [R, B, N] float32, with the 6-bit ADC
    when ``qcfg`` is given (``fs`` [2] float32 on x's device, the µ and
    σε full scales; unread, and may be None, without it).  CPU tensors take the plain
    version; CUDA tensors launch the kernel or raise (as
    ``bayes_rank16``; the ADC must be 6-bit over 64 rows)."""
    if x.device.type == "cpu":
        return bayes_paper_plain(x, mu, sigma, sel, fs, cfg, qcfg, row0,
                                 col0, sample0)
    if x.device.type != "cuda":
        raise ValueError(f"no head kernel for device {x.device}")
    out = _launch("paper", x, mu, sigma, sel, fs, cfg, _paper_levels(
        x, fs, qcfg), row0, col0, sample0)
    bayes_paper.launches += 1
    return out


def _paper_levels(x, fs, qcfg: QuantConfig | None) -> int:
    """The ADC's largest code (0 without the ADC), after checking that
    the kernel takes ``qcfg`` and ``fs``."""
    if qcfg is None:
        return 0
    if qcfg.chunk != CHUNK:
        raise ValueError(f"the head kernel digitizes every {CHUNK} rows, "
                         f"got chunk={qcfg.chunk}")
    if (fs.device != x.device or fs.dtype != torch.float32
            or fs.numel() != 2 or not fs.is_contiguous()):
        raise ValueError("fs must be 2 contiguous float32 values on "
                         f"{x.device}")
    return 2 ** (qcfg.adc_bits - 1) - 1


bayes_rank16.launches = 0
bayes_paper.launches = 0
