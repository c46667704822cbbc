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
round piece, whatever number of kernels the plan runs).  With
``out=stats`` the call folds the round into the running statistics in
place (the kernel's accumulate epilogue: an active slot's sums plus its
deltas, one float32 add an element, a masked slot untouched), bit for
bit ``stats[key] += delta[key]``; ``row0`` is the global slot id of
slot 0 for the read-noise hash when ``rows`` is None.

``decision_stats_sharded`` replaces ``decision_stats_sharded``
(``decision_kernel.py:263``): the slot axis cut over a list of torch
devices (one card may hold every shard).  Consecutive shards on one
device form a run (``slot_runs``), and ``fold_runs`` makes one
accumulating ``decision_stats`` call a run over views of its slot range
(``row0`` its first global slot, shared selections and stream indices
as they are, per-slot ones through their strides), so a round costs one
launch a device, and read noise stays keyed on global slot ids: bit for
bit the unsharded launch.
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
                   sample_idx, rows, row0: int = 0) -> torch.Tensor:
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
        row_ids = (torch.arange(row0, row0 + b, dtype=torch.int64,
                                device=dev)
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


STATS = ("sum_p", "sum_psq", "sum_ent", "sum_entsq")


def _stat_shape(key: str, b: int, n: int) -> tuple:
    return (b, n) if key in ("sum_p", "sum_psq") else (b,)


def _fold_into(out: dict, delta: dict, mask) -> dict:
    """``out[key] += delta[key]`` in place on the active rows (all when
    ``mask`` is None); masked rows keep their bits."""
    for key in STATS:
        if mask is None:
            out[key].add_(delta[key])
            continue
        keep = torch.as_tensor(mask, device=out[key].device)
        if out[key].ndim == 2:
            keep = keep[:, None]
        out[key].copy_(torch.where(keep, out[key] + delta[key], out[key]))
    return out


def decision_stats_plain(y_mu, x_sigma, m, sel, cfg: GRNGConfig,
                         x_sigsq=None, sample_idx=None, mask=None,
                         rows=None, row0: int = 0, out=None) -> dict:
    """Plain PyTorch version: materializes the [R, B, N] samples, then
    ``update_stats`` on zeroed sums, multiplied by the [B] mask (with
    ``out``: added into ``out`` on the active rows, in place).  Above
    SMALL_N_MAX the entropies are the tiled variant's: in float64 from
    the float32 logits, their sums over the samples rounded to float32
    once.  A standard error the engine derives from sum_ent and
    sum_entsq differences squares of ~6, so the float32 entropies' last
    bits move it by ~1e-4 (ROADMAP C6), and the card's float64 ones
    would then disagree with the plain version's by that much."""
    samples = _plain_samples(y_mu, x_sigma, m, sel, cfg, x_sigsq,
                             sample_idx, rows, row0)
    logp = torch.log_softmax(samples, dim=-1)
    p = torch.exp(logp)
    if samples.shape[-1] > SMALL_N_MAX:
        lp = torch.log_softmax(samples.to(torch.float64), dim=-1)
        delta = _masked(p, -(torch.exp(lp) * lp).sum(-1), mask)
    else:
        delta = _masked(p, -(p * logp).sum(-1), mask)
    return delta if out is None else _fold_into(out, delta, mask)


def decision_stats_tiled_plain(y_mu, x_sigma, m, sel, cfg: GRNGConfig,
                               x_sigsq=None, sample_idx=None, mask=None,
                               rows=None, row0: int = 0, *,
                               tile: int) -> dict:
    """The tiled variant's algorithm in plain PyTorch (tests only): per
    (sample, slot, tile of ``tile`` columns, the last one ragged) the
    tile's max m_t, S1 = Σ e^(l−m_t) and S2 = Σ e^(l−m_t)·(l−m_t), summed
    in float64 as the kernel's trees; the tiles merged in tile order into
    the row's max M, Z = Σ e^(l−M) and S2 = Σ e^(l−M)·(l−M);
    lse = M + log Z and ent = log Z − S2/Z in float64, the entropies'
    sums over the samples rounded to float32 once; then a second pass
    p = exp(l − lse) summed over the samples in float32."""
    logits = _plain_samples(y_mu, x_sigma, m, sel, cfg, x_sigsq,
                            sample_idx, rows, row0)
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
    fn.argtypes = ([_P] * 12 + [ctypes.c_int] * 7
                   + [ctypes.c_float] * 3
                   + [ctypes.c_uint] * 2 + [ctypes.c_int] * 4 + [_P, _P])
    fn.restype = ctypes.c_int
    return fn


def _check(name, t, shape, dtype, device, contiguous: bool = True):
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} is {t.dtype}, the kernel takes {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")
    if contiguous and not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _leading(name, t, shape, dtype, device) -> int:
    """Check a per-slot operand ([R, B, ...]) whose slots may be a view
    of a wider round's: rows of its trailing dims contiguous, samples
    ``ld`` slots apart.  -> ld (B when contiguous)."""
    _check(name, t, shape, dtype, device, contiguous=False)
    inner = math.prod(shape[2:])
    if not t[0].is_contiguous():
        raise ValueError(f"{name}'s slots must be contiguous")
    if shape[0] == 1:
        return shape[1]
    if t.stride(0) % inner or t.stride(0) < shape[1] * inner:
        raise ValueError(f"{name}'s sample stride {t.stride(0)} does not "
                         f"step whole slot rows")
    return t.stride(0) // inner


def _launch(y_mu, x_sigma, m, sel, cfg: GRNGConfig, x_sigsq, sample_idx,
            mask, rows, row0, out) -> dict:
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
    sel_ld = idx_ld = b
    if sel_per_slot:
        sel_ld = _leading("sel", sel, (r, b, 16), f32, dev)
    else:
        _check("sel", sel, (r, 16), f32, dev)
    if mask is not None:
        _check("mask", mask, (b,), torch.bool, dev)
    noisy = cfg.read_sigma > 0
    idx_per_slot = 0
    if noisy:
        if x_sigsq is None or sample_idx is None:
            raise ValueError("read noise needs x_sigsq and sample_idx")
        _check("x_sigsq", x_sigsq, (b, n), f32, dev)
        idx_per_slot = sample_idx.ndim == 2
        if idx_per_slot:
            idx_ld = _leading("sample_idx", sample_idx, (r, b),
                              torch.int64, dev)
        else:
            _check("sample_idx", sample_idx, (r,), torch.int64, dev)
        if rows is not None:
            _check("rows", rows, (b,), torch.int64, dev)
    accumulate = out is not None
    if accumulate:
        for key in STATS:
            _check(f"out[{key!r}]", out[key], _stat_shape(key, b, n), f32,
                   dev)
    else:
        out = {key: torch.empty(_stat_shape(key, b, n), dtype=f32,
                                device=dev) for key in STATS}
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
            int(idx_per_slot), sel_ld, idx_ld, cfg.sum_mean, cfg.sum_std,
            cfg.read_sigma, cfg.noise_seed & 0xFFFFFFFF, row0 & 0xFFFFFFFF,
            int(accumulate), plan.np, plan.threads, plan.tile,
            ptr(scratch), stream)
    if err != 0:
        raise RuntimeError(f"decision kernel launch failed: cudaError {err}")
    decision_stats.launches += 1
    return out


def decision_stats(y_mu, x_sigma, m, sel, cfg: GRNGConfig, x_sigsq=None,
                   sample_idx=None, mask=None, rows=None, row0: int = 0,
                   out=None) -> dict:
    """Fused decision-statistic deltas for one escalation round.

    y_mu/x_sigma: [B, N]; m: [B, N, 16] (``activation_basis``); sel:
    [R, B, 16] or [R, 16]; x_sigsq: [B, N] and sample_idx: [R, B] or
    [R] absolute stream indices (int64 holding uint32), both required
    when ``cfg.read_sigma > 0``; rows: [B] global slot ids for the
    read-noise hash (None = row0 + arange(B)); mask: [B] bool, None =
    all.  Per-slot sel and sample_idx may be slot ranges of a wider
    round (their samples a whole row apart); the rest is contiguous.

    Returns the deltas, zero on masked rows; with ``out`` (the running
    statistics, float32, contiguous, on the same device) adds them into
    ``out`` on the active rows in place and returns it.  CPU tensors take
    the plain version; CUDA tensors launch the kernel (float32, R ≤ 64)
    or raise.
    """
    if y_mu.device.type == "cpu":
        return decision_stats_plain(y_mu, x_sigma, m, sel, cfg, x_sigsq,
                                    sample_idx, mask, rows, row0, out)
    if y_mu.device.type != "cuda":
        raise ValueError(f"no decision kernel for device {y_mu.device}")
    return _launch(y_mu, x_sigma, m, sel, cfg, x_sigsq, sample_idx, mask,
                   rows, row0, out)


decision_stats.launches = 0


class SlotRun(NamedTuple):
    """Consecutive slot shards on one device: slots [start, stop)."""
    device: torch.device
    start: int
    stop: int


def _device(d) -> torch.device:
    dev = torch.device(d)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def slot_runs(devices, b: int) -> list[SlotRun]:
    """The slot axis of ``b`` slots cut into ``len(devices)`` contiguous
    shards, shard k on ``devices[k]``, and consecutive shards on one
    device merged into a run: ``['cuda:0'] * 4`` is one run,
    ``['cuda:0', 'cuda:1', 'cuda:1', 'cuda:0']`` three.  Raises when
    ``b`` does not divide over the shards."""
    devices = [_device(d) for d in devices]
    k = len(devices)
    if k < 1:
        raise ValueError("a sharded round needs at least one shard")
    if b % k:
        raise ValueError(f"batch {b} not divisible over {k} shards")
    s = b // k
    runs: list[SlotRun] = []
    for i, dev in enumerate(devices):
        if runs and runs[-1].device == dev:
            runs[-1] = runs[-1]._replace(stop=(i + 1) * s)
        else:
            runs.append(SlotRun(dev, i * s, (i + 1) * s))
    return runs


def fold_runs(runs, y_mu, x_sigma, m, sel, cfg: GRNGConfig, *,
              x_sigsq=None, sample_idx=None, mask=None, rows=None,
              out=None, plain: bool = False) -> dict:
    """One round folded run by run: for each ``SlotRun`` (covering
    [0, B) in order) one accumulating ``decision_stats`` call
    (``decision_stats_plain`` with ``plain``) on the run's device over
    its slot range, read noise keyed on the run's global slot ids
    (``row0`` = its start, or ``rows``' range).  Operands are views where
    they already lie on the run's device, else one copy of the run's
    rows; shared selections [R, 16] and stream indices [R] go as they
    are.  ``out``: the running statistics [B, ...] (any one device),
    updated in place and returned; a run on another device adds into a
    copy of its rows, copied back.  None: the deltas on y_mu's device
    (one run there: its call's own; else each run's copied into its
    rows)."""
    b, n = y_mu.shape
    if (not runs or runs[0].start != 0 or runs[-1].stop != b
            or any(p.stop != q.start for p, q in zip(runs, runs[1:]))):
        raise ValueError(f"runs {runs} do not cover {b} slots in order")
    if cfg.read_sigma:
        if x_sigsq is None or sample_idx is None:
            raise ValueError("read noise needs x_sigsq and sample_idx")
    else:
        x_sigsq = sample_idx = rows = None
    fold = decision_stats_plain if plain else decision_stats
    deltas = []
    for run in runs:
        dev, sl = run.device, slice(run.start, run.stop)

        def cut(t, per_slot=True, slot_dim=0):
            if t is None:
                return None
            if per_slot:
                t = t[sl] if slot_dim == 0 else t[:, sl]
            return t if t.device == dev else t.to(dev)

        target = None if out is None else {key: cut(out[key])
                                           for key in STATS}
        got = fold(cut(y_mu), cut(x_sigma), cut(m),
                   cut(sel, sel.ndim == 3, 1), cfg, cut(x_sigsq),
                   cut(sample_idx, sample_idx is not None
                       and sample_idx.ndim == 2, 1),
                   cut(mask), cut(rows), run.start, out=target)
        if out is None:
            deltas.append(got)
            continue
        for key in STATS:
            if got[key].device != out[key].device:
                out[key][sl].copy_(got[key])
    if out is not None:
        return out
    if len(runs) == 1 and runs[0].device == y_mu.device:
        return deltas[0]
    out = {key: torch.empty(_stat_shape(key, b, n), dtype=torch.float32,
                            device=y_mu.device) for key in STATS}
    for run, got in zip(runs, deltas):
        for key in STATS:
            out[key][run.start:run.stop].copy_(got[key])
    return out


def decision_stats_sharded(y_mu, x_sigma, m, sel, cfg: GRNGConfig, *,
                           devices, x_sigsq=None, sample_idx=None,
                           mask=None, rows=None, out=None) -> dict:
    """``decision_stats`` over the slot axis cut into ``len(devices)``
    contiguous shards (port of ``decision_stats_sharded``,
    ``repro/kernels/decision_kernel.py:263``): shard k covers slots
    [k·B/K, (k+1)·B/K) on ``devices[k]`` (the kernel on a CUDA device,
    the plain version on the CPU), and ``fold_runs`` makes one
    accumulating call a run of consecutive shards on one device.

    ``devices`` stands where the reference's mesh axis does; it may
    repeat a device (one card holds every shard: one launch).  Every
    statistic is slot-local and the kernel's launch plan scales only its
    block count with B, so the runs give the unsharded launch's bits,
    each hashing its read noise with its GLOBAL slot ids.  ``out``: the
    running statistics to fold into (returned); None returns the deltas.
    Raises when B does not divide over the shards (callers route such a
    round to the unsharded kernel).  ``decision_stats_sharded.launches``
    counts calls that launched the kernel on at least one run,
    ``launches_per_call`` the kernel launches the last call made."""
    runs = slot_runs(devices, y_mu.shape[0])
    out = fold_runs(runs, y_mu, x_sigma, m, sel, cfg, x_sigsq=x_sigsq,
                    sample_idx=sample_idx, mask=mask, rows=rows, out=out)
    launched = sum(run.device.type == "cuda" for run in runs)
    decision_stats_sharded.launches_per_call = launched
    decision_stats_sharded.launches += launched > 0
    return out


decision_stats_sharded.launches = 0
decision_stats_sharded.launches_per_call = 0


def decision_stats_sharded_plain(y_mu, x_sigma, m, sel, cfg: GRNGConfig, *,
                                 shards: int, x_sigsq=None, sample_idx=None,
                                 mask=None, rows=None) -> dict:
    """The sharded round's plain version: ``decision_stats_plain`` on
    each of ``shards`` slot shards in turn, on y_mu's device, folded
    into zeroed sums (``fold_runs(plain=True)``, a run a shard)."""
    b = y_mu.shape[0]
    if shards < 1 or b % shards:
        raise ValueError(f"batch {b} not divisible over {shards} shards")
    s = b // shards
    runs = [SlotRun(y_mu.device, i * s, (i + 1) * s) for i in range(shards)]
    return fold_runs(runs, y_mu, x_sigma, m, sel, cfg, x_sigsq=x_sigsq,
                     sample_idx=sample_idx, mask=mask, rows=rows, plain=True)
