"""Fused decision update: the CUDA kernel's wrapper and its plain version.

Replaces the Pallas TPU kernel ``decision_stats_pallas``
(``repro/kernels/decision_kernel.py:165``).  One escalation round of the
SAR triage engine goes from the rank-16 activation basis straight to
the masked deltas of the running predictive statistics

    {sum_p [B,N], sum_psq [B,N], sum_ent [B], sum_entsq [B]}

without the [R, B, N] logit samples ever reaching device memory.  The
kernel (``csrc/decision.cu``) moves about 7 KB a round at the main
path's shape and is bound in practice by its launch; its source notes
the design.  ``decision_plan`` routes a round to the kernel's small-N
variant (N ≤ 32: a thread per (sample, class) pair) or to its streaming
variant (N > 32).

``decision_stats`` routes by where the tensors lie: CPU tensors go to
``decision_stats_plain``, the plain PyTorch version (mix, log-softmax,
masked sums, as ``repro/kernels/ref.py`` ``decision_stats_ref``); CUDA
tensors launch the kernel or raise.  There is no fallback.
``decision_stats.launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from repro_torch.core.clt_grng import GRNGConfig
from repro_torch.core.hashing import as_u32, gaussianish, hash3

MAX_SAMPLES = 64          # the kernel keeps a round's R selections in smem
SMALL_N_MAX = 32          # widest N of the small-N variant: one warp
STREAMING_THREADS = 128
_P = ctypes.c_void_p


class DecisionPlan(NamedTuple):
    """The decision kernel's variant for one round: ``np`` = 0 is the
    streaming variant; ``np`` > 0 the small-N variant, whose threads
    cover the R × np (sample, column) pairs, np = N rounded up to a
    power of two (padding lanes carry no logit)."""
    variant: str
    np: int
    threads: int


def decision_plan(n: int, r: int) -> DecisionPlan:
    """Route a round of ``r`` samples over ``n`` classes: N ≤ 32 to the
    small-N variant (a thread per pair, at least a warp, at most 1024
    threads, pairs beyond that loop), N > 32 to the streaming one."""
    if n > SMALL_N_MAX:
        return DecisionPlan("streaming", 0, STREAMING_THREADS)
    np_ = 1 << (n - 1).bit_length()
    return DecisionPlan("small_n", np_, min(1024, -(-r * np_ // 32) * 32))


def decision_stats_plain(y_mu, x_sigma, m, sel, cfg: GRNGConfig,
                         x_sigsq=None, sample_idx=None, mask=None,
                         rows=None) -> dict:
    """Plain PyTorch version: materializes the [R, B, N] samples, then
    ``update_stats`` on zeroed sums, multiplied by the [B] mask."""
    b, n = y_mu.shape
    dev = y_mu.device
    if sel.ndim == 2:
        sel = sel[:, None, :].expand(sel.shape[0], b, 16)
    mix = torch.einsum("rbj,bnj->rbn", sel.to(torch.float32),
                       m.to(torch.float32))
    out = mix - cfg.sum_mean * x_sigma.to(torch.float32)[None]
    if cfg.read_sigma:
        if x_sigsq is None or sample_idx is None:
            raise ValueError("read noise needs x_sigsq and sample_idx")
        key = as_u32(sample_idx, device=dev)
        if key.ndim == 1:
            key = key[:, None]
        row_ids = (torch.arange(b, dtype=torch.int64, device=dev)
                   if rows is None else as_u32(rows, device=dev))
        cols = torch.arange(n, dtype=torch.int64, device=dev)
        h = hash3(key[..., None], row_ids[None, :, None],
                  cols[None, None, :], cfg.noise_seed)
        sigma_read = cfg.read_sigma * torch.sqrt(
            x_sigsq.to(torch.float32).clamp_min(0.0))
        out = out + gaussianish(h) * sigma_read[None]
    samples = y_mu.to(torch.float32)[None] + out / cfg.sum_std
    logp = torch.log_softmax(samples, dim=-1)
    p = torch.exp(logp)
    ent = -(p * logp).sum(-1)                            # [R, B]
    mk = (torch.ones((b,), dtype=torch.float32, device=dev) if mask is None
          else torch.as_tensor(mask, device=dev).to(torch.float32))
    return {"sum_p": p.sum(0) * mk[:, None],
            "sum_psq": (p * p).sum(0) * mk[:, None],
            "sum_ent": ent.sum(0) * mk,
            "sum_entsq": (ent * ent).sum(0) * mk}


@functools.lru_cache(maxsize=None)
def _launcher():
    from repro_torch.kernels.build import load
    fn = load("decision").decision_stats_launch
    fn.argtypes = ([_P] * 12 + [ctypes.c_int] * 5
                   + [ctypes.c_float] * 3
                   + [ctypes.c_uint, ctypes.c_int, ctypes.c_int, _P])
    fn.restype = ctypes.c_int
    return fn


def _check(name, t, shape, dtype, device):
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} is {t.dtype}, the kernel takes {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _launch(y_mu, x_sigma, m, sel, cfg: GRNGConfig, x_sigsq, sample_idx,
            mask, rows) -> dict:
    dev = y_mu.device
    b, n = y_mu.shape
    r = sel.shape[0]
    if not 1 <= r <= MAX_SAMPLES:
        raise ValueError(f"the decision kernel takes 1..{MAX_SAMPLES} "
                         f"samples per round, got {r}")
    f32 = torch.float32
    _check("y_mu", y_mu, (b, n), f32, dev)
    _check("x_sigma", x_sigma, (b, n), f32, dev)
    _check("m", m, (b, n, 16), f32, dev)
    if m.data_ptr() % 16:
        raise ValueError("m must be 16-byte aligned (float4 loads)")
    sel_per_slot = sel.ndim == 3
    _check("sel", sel, (r, b, 16) if sel_per_slot else (r, 16), f32, dev)
    if mask is not None:
        _check("mask", mask, (b,), torch.bool, dev)
    noisy = cfg.read_sigma > 0
    idx_per_slot = 0
    if noisy:
        if x_sigsq is None or sample_idx is None:
            raise ValueError("read noise needs x_sigsq and sample_idx")
        _check("x_sigsq", x_sigsq, (b, n), f32, dev)
        idx_per_slot = sample_idx.ndim == 2
        _check("sample_idx", sample_idx, (r, b) if idx_per_slot else (r,),
               torch.int64, dev)
        if rows is not None:
            _check("rows", rows, (b,), torch.int64, dev)
    out = {"sum_p": torch.empty((b, n), dtype=f32, device=dev),
           "sum_psq": torch.empty((b, n), dtype=f32, device=dev),
           "sum_ent": torch.empty((b,), dtype=f32, device=dev),
           "sum_entsq": torch.empty((b,), dtype=f32, device=dev)}
    plan = decision_plan(n, r)

    def ptr(t):
        return None if t is None else t.data_ptr()

    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _launcher()(
            ptr(y_mu), ptr(x_sigma), ptr(m), ptr(sel), ptr(mask),
            ptr(x_sigsq) if noisy else None,
            ptr(sample_idx) if noisy else None,
            ptr(rows) if noisy else None,
            ptr(out["sum_p"]), ptr(out["sum_psq"]), ptr(out["sum_ent"]),
            ptr(out["sum_entsq"]), b, n, r, int(sel_per_slot),
            int(idx_per_slot), cfg.sum_mean, cfg.sum_std, cfg.read_sigma,
            cfg.noise_seed & 0xFFFFFFFF, plan.np, plan.threads, stream)
    if err != 0:
        raise RuntimeError(f"decision kernel launch failed: cudaError {err}")
    decision_stats.launches += 1
    return out


def decision_stats(y_mu, x_sigma, m, sel, cfg: GRNGConfig, x_sigsq=None,
                   sample_idx=None, mask=None, rows=None) -> dict:
    """Fused decision-statistic deltas for one escalation round.

    y_mu/x_sigma: [B, N]; m: [B, N, 16] (``activation_basis``); sel:
    [R, B, 16] or [R, 16]; x_sigsq: [B, N] and sample_idx: [R, B] or
    [R] absolute stream indices (int64 holding uint32), both required
    when ``cfg.read_sigma > 0``; rows: [B] global slot ids for the
    read-noise hash (None = arange(B)); mask: [B] bool, None = all.

    Returns the deltas, zero on masked rows.  CPU tensors take the plain
    version; CUDA tensors launch the kernel (float32, contiguous, R ≤ 64)
    or raise.
    """
    if y_mu.device.type == "cpu":
        return decision_stats_plain(y_mu, x_sigma, m, sel, cfg, x_sigsq,
                                    sample_idx, mask, rows)
    if y_mu.device.type != "cuda":
        raise ValueError(f"no decision kernel for device {y_mu.device}")
    return _launch(y_mu, x_sigma, m, sel, cfg, x_sigsq, sample_idx, mask,
                   rows)


decision_stats.launches = 0
