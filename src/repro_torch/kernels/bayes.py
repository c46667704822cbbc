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
``bayes_paper.launches`` count kernel launches.
"""

from __future__ import annotations

import ctypes
import functools

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


@functools.lru_cache(maxsize=None)
def _launchers():
    from repro_torch.kernels.build import load
    lib = load("bayes_mvm")
    params = ctypes.POINTER(GrngParams)
    rank16 = lib.bayes_rank16_launch
    rank16.argtypes = ([_P] * 5 + [ctypes.c_int] * 4 + [_U32] * 3
                       + [ctypes.c_int] * 2 + [params, _P])
    rank16.restype = ctypes.c_int
    paper = lib.bayes_paper_launch
    paper.argtypes = ([_P] * 6 + [ctypes.c_int] * 4 + [_U32] * 3
                      + [ctypes.c_int] * 3 + [params, _P])
    paper.restype = ctypes.c_int
    return rank16, paper


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
    b, kdim, n, r = _check(x, mu, sigma, sel)
    out = torch.empty((r, b, n), dtype=torch.float32, device=x.device)
    params = grng_params(cfg)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = _launchers()[0](
            x.data_ptr(), mu.data_ptr(), sigma.data_ptr(), sel.data_ptr(),
            out.data_ptr(), b, kdim, n, r, _u32(row0), _u32(col0),
            _u32(sample0), int(x.dtype == torch.bfloat16),
            int(mu.dtype == torch.bfloat16), ctypes.byref(params), stream)
    if err != 0:
        raise RuntimeError(f"rank16 head kernel launch failed: cudaError "
                           f"{err}")
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
    b, kdim, n, r = _check(x, mu, sigma, sel)
    levels = 0
    if qcfg is not None:
        if qcfg.chunk != CHUNK:
            raise ValueError(f"the head kernel digitizes every {CHUNK} rows, "
                             f"got chunk={qcfg.chunk}")
        levels = 2 ** (qcfg.adc_bits - 1) - 1
        if (fs.device != x.device or fs.dtype != torch.float32
                or fs.numel() != 2 or not fs.is_contiguous()):
            raise ValueError("fs must be 2 contiguous float32 values on "
                             f"{x.device}")
    out = torch.empty((r, b, n), dtype=torch.float32, device=x.device)
    params = grng_params(cfg)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = _launchers()[1](
            x.data_ptr(), mu.data_ptr(), sigma.data_ptr(), sel.data_ptr(),
            fs.data_ptr() if levels else None, out.data_ptr(), b, kdim, n, r,
            _u32(row0), _u32(col0), _u32(sample0), levels,
            int(x.dtype == torch.bfloat16), int(mu.dtype == torch.bfloat16),
            ctypes.byref(params), stream)
    if err != 0:
        raise RuntimeError(f"paper head kernel launch failed: cudaError "
                           f"{err}")
    bayes_paper.launches += 1
    return out


bayes_rank16.launches = 0
bayes_paper.launches = 0
