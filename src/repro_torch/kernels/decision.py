"""Fused decision update: the CUDA kernel's wrapper and its plain versions.

Replaces the Pallas TPU kernel ``decision_stats_pallas``
(``repro/kernels/decision_kernel.py:165``).  One escalation round of the
SAR triage engine, or one round of an LM's token decision, goes from
the rank-16 activation basis straight to the masked deltas of the
running predictive statistics

    {sum_p [B,N], sum_psq [B,N], sum_ent [B], sum_entsq [B]}

without the [R, B, N] logit samples ever reaching device memory.
``decision_plan`` routes a round to one of the kernel's two variants
(``csrc/decision.cu``'s header notes both designs):

- small N (N ≤ 32, SAR's N = 2): one launch, a block per slot, a thread
  per (sample, class) pair; bound in practice by its launch.
- tiled (N > 32, an LM's vocabulary): three launches over tiles of
  TILE = 256 columns × slots, so a round spreads over the whole card at
  any B.  A: each (slot, tile, sample)'s max logit m_t, S1 = Σ e^(l−m_t)
  and S2 = Σ e^(l−m_t)·(l−m_t) into a scratch buffer allocated here.
  M: per slot and sample, the tiles merged in float64 into
  lse = M + log Z and the entropy log Z − S2/Z (Z, S2 shifted to the
  row's max M), so the entropy needs no second pass over N.  B: p = exp(l − lse) per column,
  the logits recomputed, summed over the samples in order.
  ``decision_stats_tiled_plain`` is that algorithm in plain PyTorch, for
  the tests.

``decision_stats`` routes by where the tensors lie: CPU tensors go to
``decision_stats_plain``, the plain PyTorch version (mix, log-softmax,
masked sums, as ``repro/kernels/ref.py`` ``decision_stats_ref``, with
the tiled variant's float64 entropies above N = 32); CUDA
tensors launch the kernel or raise.  There is no fallback.
``decision_stats.launches`` counts wrapper calls that launched (one a
round piece, whatever number of kernels the plan runs).

``decision_stats_sharded`` replaces ``decision_stats_sharded``
(``decision_kernel.py:263``): the slot axis cut over a list of torch
devices (one card may hold every shard), one ``decision_stats`` call a
shard, read noise keyed on global slot ids, bit for bit the unsharded
launch.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple

import torch

from repro_torch.core.clt_grng import GRNGConfig
from repro_torch.core.hashing import as_u32, gaussianish, hash3

MAX_SAMPLES = 64          # the kernel keeps a round's R selections in smem
SMALL_N_MAX = 32          # widest N of the small-N variant: one warp
TILED_THREADS = 128       # a block of the tiled variant's kernels A and B
TILE = 256                # columns a block of the tiled variant: 2 a thread
_P = ctypes.c_void_p


class DecisionPlan(NamedTuple):
    """The decision kernel's variant for one round.  small_n: ``np`` =
    N rounded up to a power of two, the threads covering the R × np
    (sample, column) pairs (padding lanes carry no logit), one kernel of
    B blocks.  tiled: ``np`` = 0, ``tile`` columns a block of
    ``threads``, ``tiles`` a slot, kernels A and B of ``blocks`` =
    tiles × B blocks around the merge's B.  ``smem_bytes``: the static
    shared memory of its largest kernel (sized for R = MAX_SAMPLES)."""
    variant: str
    np: int
    threads: int
    tile: int
    tiles: int
    blocks: int
    kernels: int
    smem_bytes: int


# static shared memory of csrc/decision.cu's kernels, in bytes
_SMALL_N_SMEM = 4 * (MAX_SAMPLES * 17 + SMALL_N_MAX * 17 + 3 * SMALL_N_MAX
                     + MAX_SAMPLES + 2 * 32 * SMALL_N_MAX + 2 * 32)
_TILED_SMEM = (4 * (MAX_SAMPLES * 16 + MAX_SAMPLES
                    + (TILED_THREADS // 32) * MAX_SAMPLES)
               + 8 * 2 * (TILED_THREADS // 32) * MAX_SAMPLES)


@functools.lru_cache(maxsize=None)
def decision_plan(n: int, r: int, b: int = 1) -> DecisionPlan:
    """Route a round of ``r`` samples over ``b`` slots of ``n`` classes:
    N ≤ 32 to the small-N variant (a thread per pair, at least a warp,
    at most 1024 threads, pairs beyond that loop), N > 32 to the tiled
    one, ceil(N / TILE) tiles a slot."""
    if n > SMALL_N_MAX:
        tiles = -(-n // TILE)
        return DecisionPlan("tiled", 0, TILED_THREADS, TILE, tiles,
                            tiles * b, 3, _TILED_SMEM)
    np_ = 1 << (n - 1).bit_length()
    return DecisionPlan("small_n", np_, min(1024, -(-r * np_ // 32) * 32),
                        0, 1, b, 1, _SMALL_N_SMEM)


def _plain_samples(y_mu, x_sigma, m, sel, cfg: GRNGConfig, x_sigsq,
                   sample_idx, rows) -> torch.Tensor:
    """The round's [R, B, N] logit samples, as ``mix_samples``."""
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
    return y_mu.to(torch.float32)[None] + out / cfg.sum_std


def _sum_samples(x: torch.Tensor) -> torch.Tensor:
    """Sum over the leading sample axis, each slot's R terms reduced as
    one contiguous row: ``sum(0)`` over an outer axis picks its order by
    the whole tensor's shape, so a slot's sum would change with B and a
    slot-sharded round would not give the unsharded round's bits."""
    return x.movedim(0, -1).contiguous().sum(-1)


def _masked(p, ent, mask) -> dict:
    """The four deltas of [R, B, N] probabilities and [R, B] entropies,
    multiplied by the [B] mask (None = all active); the entropies' sums
    in their dtype, rounded to float32 once."""
    b = p.shape[1]
    mk = (torch.ones((b,), dtype=torch.float32, device=p.device)
          if mask is None
          else torch.as_tensor(mask, device=p.device).to(torch.float32))
    return {"sum_p": _sum_samples(p) * mk[:, None],
            "sum_psq": _sum_samples(p * p) * mk[:, None],
            "sum_ent": (_sum_samples(ent) * mk).to(torch.float32),
            "sum_entsq": (_sum_samples(ent * ent) * mk).to(torch.float32)}


def decision_stats_plain(y_mu, x_sigma, m, sel, cfg: GRNGConfig,
                         x_sigsq=None, sample_idx=None, mask=None,
                         rows=None) -> dict:
    """Plain PyTorch version: materializes the [R, B, N] samples, then
    ``update_stats`` on zeroed sums, multiplied by the [B] mask.  Above
    SMALL_N_MAX the entropies are the tiled variant's: in float64 from
    the float32 logits, their sums over the samples rounded to float32
    once.  A standard error the engine derives from sum_ent and
    sum_entsq differences squares of ~6, so the float32 entropies' last
    bits move it by ~1e-4 (ROADMAP C6), and the card's float64 ones
    would then disagree with the plain version's by that much."""
    samples = _plain_samples(y_mu, x_sigma, m, sel, cfg, x_sigsq,
                             sample_idx, rows)
    logp = torch.log_softmax(samples, dim=-1)
    p = torch.exp(logp)
    if samples.shape[-1] > SMALL_N_MAX:
        lp = torch.log_softmax(samples.to(torch.float64), dim=-1)
        return _masked(p, -(torch.exp(lp) * lp).sum(-1), mask)
    return _masked(p, -(p * logp).sum(-1), mask)


def decision_stats_tiled_plain(y_mu, x_sigma, m, sel, cfg: GRNGConfig,
                               x_sigsq=None, sample_idx=None, mask=None,
                               rows=None, *, tile: int) -> dict:
    """The tiled variant's algorithm in plain PyTorch (tests only): per
    (sample, slot, tile of ``tile`` columns, the last one ragged) the
    tile's max m_t, S1 = Σ e^(l−m_t) and S2 = Σ e^(l−m_t)·(l−m_t), summed
    in float64 as the kernel's trees; the tiles merged in tile order into
    the row's max M, Z = Σ e^(l−M) and S2 = Σ e^(l−M)·(l−M);
    lse = M + log Z and ent = log Z − S2/Z in float64, the entropies'
    sums over the samples rounded to float32 once; then a second pass
    p = exp(l − lse) summed over the samples in float32."""
    logits = _plain_samples(y_mu, x_sigma, m, sel, cfg, x_sigsq,
                            sample_idx, rows)
    r, b, n = logits.shape
    tiles = -(-n // tile)
    lt = torch.nn.functional.pad(logits, (0, tiles * tile - n),
                                 value=-math.inf).reshape(r, b, tiles, tile)
    mt = lt.amax(-1)                         # every tile holds a column
    d = lt - mt[..., None]                   # -inf on the padding
    e = torch.exp(d)
    f64 = torch.float64
    s1 = e.to(f64).sum(-1)
    s2 = torch.where(e > 0, e * d, 0.0).to(f64).sum(-1)
    mt = mt.to(f64)
    big_m, z, s2m = mt[..., 0], s1[..., 0], s2[..., 0]
    for t in range(1, tiles):
        mn = torch.maximum(big_m, mt[..., t])
        da, db = big_m - mn, mt[..., t] - mn
        ea, eb = torch.exp(da), torch.exp(db)
        z, s2m = (ea * z + eb * s1[..., t],
                  ea * (s2m + da * z) + eb * (s2[..., t] + db * s1[..., t]))
        big_m = mn
    log_z = torch.log(z)
    lse = (big_m + log_z).to(torch.float32)
    p = torch.exp(logits - lse[..., None])
    out = _masked(p, log_z - s2m / z, mask)
    return {k: v.to(torch.float32) for k, v in out.items()}


@functools.lru_cache(maxsize=None)
def _launcher():
    from repro_torch.kernels.build import load
    fn = load("decision").decision_stats_launch
    fn.argtypes = ([_P] * 12 + [ctypes.c_int] * 5
                   + [ctypes.c_float] * 3
                   + [ctypes.c_uint] + [ctypes.c_int] * 3 + [_P, _P])
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
    plan = decision_plan(n, r, b)
    scratch = (torch.empty(b * r * (5 * plan.tiles + 3), dtype=f32,
                           device=dev) if plan.variant == "tiled" else None)

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
            cfg.noise_seed & 0xFFFFFFFF, plan.np, plan.threads, plan.tile,
            ptr(scratch), stream)
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


def _split_slots(k: int, y_mu, x_sigma, m, sel, cfg: GRNGConfig, x_sigsq,
                 sample_idx, mask, rows) -> list[dict]:
    """The round's operands cut into ``k`` contiguous slot shards (views
    on the caller's device): shared selections and stream indices
    broadcast per slot, the mask defaulted to all-True and, with read
    noise, ``rows`` to the GLOBAL slot ids arange(B) before the cut."""
    b, _ = y_mu.shape
    if k < 1:
        raise ValueError("a sharded round needs at least one shard")
    if b % k:
        raise ValueError(f"batch {b} not divisible over {k} shards")
    home = y_mu.device
    r = sel.shape[0]
    if sel.ndim == 2:
        sel = sel[:, None, :].expand(r, b, 16)
    if mask is None:
        mask = torch.ones((b,), dtype=torch.bool, device=home)
    if cfg.read_sigma:
        if x_sigsq is None or sample_idx is None:
            raise ValueError("read noise needs x_sigsq and sample_idx")
        if sample_idx.ndim == 1:
            sample_idx = sample_idx[:, None].expand(r, b)
        if rows is None:
            rows = torch.arange(b, dtype=torch.int64, device=home)
    else:
        x_sigsq = sample_idx = rows = None
    s = b // k

    def cut(t, i, slot_dim=0):
        if t is None:
            return None
        sl = slice(i * s, (i + 1) * s)
        return t[sl] if slot_dim == 0 else t[:, sl]

    return [dict(y_mu=cut(y_mu, i), x_sigma=cut(x_sigma, i), m=cut(m, i),
                 sel=cut(sel, i, 1), x_sigsq=cut(x_sigsq, i),
                 sample_idx=cut(sample_idx, i, 1), mask=cut(mask, i),
                 rows=cut(rows, i)) for i in range(k)]


def decision_stats_sharded(y_mu, x_sigma, m, sel, cfg: GRNGConfig, *,
                           devices, x_sigsq=None, sample_idx=None,
                           mask=None, rows=None) -> dict:
    """``decision_stats`` over the slot axis cut into ``len(devices)``
    contiguous shards (port of ``decision_stats_sharded``,
    ``repro/kernels/decision_kernel.py:263``): shard k runs
    ``decision_stats`` on ``devices[k]`` (the kernel on a CUDA device,
    the plain version on the CPU) over slots [k·B/K, (k+1)·B/K), and the
    deltas are concatenated on y_mu's device.

    ``devices`` stands where the reference's mesh axis does; it may
    repeat a device (one card holds every shard).  Every statistic is
    slot-local and the kernel's launch plan scales only its block count
    with B, so the shards give the unsharded launch's bits, provided each
    hashes its read noise with its GLOBAL slot ids: ``rows`` defaults to
    arange(B) before the split.  Shared selections [R, 16] and stream
    indices [R] are broadcast to [R, B, 16] and [R, B] before the split,
    as the reference's.  Raises when B does not divide over the shards
    (callers route such a round to the unsharded kernel).
    ``decision_stats_sharded.launches`` counts calls that launched the
    kernel on at least one shard."""
    devices = [torch.device(d) for d in devices]
    parts = _split_slots(len(devices), y_mu, x_sigma, m, sel, cfg, x_sigsq,
                         sample_idx, mask, rows)
    outs = [decision_stats(cfg=cfg, **{
        key: None if t is None else t.to(dev).contiguous()
        for key, t in part.items()}) for part, dev in zip(parts, devices)]
    if any(dev.type == "cuda" for dev in devices):
        decision_stats_sharded.launches += 1
    return {key: torch.cat([o[key].to(y_mu.device) for o in outs])
            for key in ("sum_p", "sum_psq", "sum_ent", "sum_entsq")}


decision_stats_sharded.launches = 0


def decision_stats_sharded_plain(y_mu, x_sigma, m, sel, cfg: GRNGConfig, *,
                                 shards: int, x_sigsq=None, sample_idx=None,
                                 mask=None, rows=None) -> dict:
    """The sharded round's plain version: ``decision_stats_plain`` on
    each of ``shards`` slot shards, on y_mu's device, the deltas
    concatenated."""
    parts = _split_slots(shards, y_mu, x_sigma, m, sel, cfg, x_sigsq,
                         sample_idx, mask, rows)
    outs = [decision_stats_plain(cfg=cfg, **part) for part in parts]
    return {key: torch.cat([o[key] for o in outs])
            for key in ("sum_p", "sum_psq", "sum_ent", "sum_entsq")}
