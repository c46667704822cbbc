"""Chunked-ADC CIM matrix product: the CUDA kernel's wrapper and its
plain version.

Replaces the Pallas TPU kernel ``cim_mvm_pallas``
(``repro/kernels/cim_mvm.py:72``): the deterministic µ-only subarray
product of the paper (§V-B1).  Every 64-deep analog partial sum passes
the column front end ``v = gain[n]·psum + offset[n]·lsb`` and a 6-bit
ADC, ``clip(round(v / lsb), −32, 31)`` with ``lsb = fs / 31``, before
it joins the digital accumulator.  With ``gain``/``offset`` omitted the
ADC is ideal; gain 1 and offset 0 give the same bits.

``cim_mvm`` routes by where the tensors lie: CPU tensors go to
``cim_mvm_plain`` (a port of ``repro/kernels/ref.py``
``cim_mvm_nonideal_ref`` that accumulates the chunks in order, as the
TPU kernel does); CUDA tensors launch ``csrc/cim_mvm.cu`` or raise.
There is no fallback.  ``cim_mvm.launches`` counts kernel launches.
``launch_plan`` picks the kernel's tiles and chunk split from the shape.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from repro_torch.core.quant import QuantConfig, adc_quantize

CHUNK = 64                # the kernel's analog accumulation depth
H100_SMS = 132
TILE_M = (32, 16, 8, 4)   # output rows a block may own, largest first
MAX_SPLIT = 8             # blocks of a portable thread-block cluster
SPLIT_TILE_M = 16         # a split block's rows: fastest in the plan sweep
SMEM_LIMIT = 48 * 1024    # static-size shared memory, no opt-in needed
_X_STRIDE = CHUNK + 4     # a padded x row in shared memory (floats)
_P = ctypes.c_void_p


class CimPlan(NamedTuple):
    """How ``csrc/cim_mvm.cu`` covers one product: a grid of
    ``tile_m × tile_n`` output tiles; ``split`` > 1 runs the K/64 chunks
    of a tile at once in a cluster of ``split`` blocks (one chunk each,
    codes folded in chunk order), ``split`` = 1 has one block walk them
    in order.  The launcher refuses ``threads`` and ``smem_bytes`` that
    differ from what the tiles need."""
    tile_m: int
    tile_n: int
    split: int
    threads: int
    blocks: int
    smem_bytes: int


def _smem_bytes(tile_m: int, tile_n: int, split: int) -> int:
    stage = tile_m * _X_STRIDE + CHUNK * tile_n   # one chunk's x and w
    return 4 * (stage + (split * tile_m * tile_n if split > 1 else 0))


def make_plan(m: int, n: int, tile_m: int, tile_n: int,
              split: int) -> CimPlan:
    """The plan of the given tiles and split, for an [m, n] output."""
    blocks = -(-m // tile_m) * -(-n // tile_n) * split
    return CimPlan(tile_m, tile_n, split, tile_m * tile_n // 4, blocks,
                   _smem_bytes(tile_m, tile_n, split))


@functools.lru_cache(maxsize=None)
def launch_plan(m: int, k: int, n: int, sms: int = H100_SMS) -> CimPlan:
    """The CIM kernel's launch plan for x [m, k] · w [k, n] on a card of
    ``sms`` SMs.  tile_n is n rounded up to 16, at most 64.  The 2..8
    chunks of a tile are split over a cluster when the largest tiles do
    not give every SM a block; a split takes tile_m = 16 where the
    shared memory holds it, the fastest at every split trunk shape of
    ``chip_smoke.py``'s plan sweep (PERF.md), else the largest that
    fits.  Unsplit, tile_m is the largest that gives every SM a block,
    else the smallest."""
    chunks = k // CHUNK
    tile_n = min(64, -(-n // 16) * 16)

    def plan(tile_m, split):
        return make_plan(m, n, tile_m, tile_n, split)

    if 1 < chunks <= MAX_SPLIT and plan(TILE_M[0], 1).blocks < sms:
        fits = [plan(t, chunks) for t in TILE_M
                if t <= SPLIT_TILE_M
                and _smem_bytes(t, tile_n, chunks) <= SMEM_LIMIT]
        return fits[0]
    fits = [plan(t, 1) for t in TILE_M]
    return next((p for p in fits if p.blocks >= sms), fits[-1])


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _levels(qcfg: QuantConfig) -> int:
    return 2 ** (qcfg.adc_bits - 1) - 1


def cim_mvm_plain(x, w, fs, qcfg: QuantConfig, col_gain=None,
                  col_offset=None) -> torch.Tensor:
    """Plain PyTorch version: every chunk's partial sums at once, then
    the front end, the ADC (``quant.adc_quantize``) and the in-order
    accumulation."""
    m, kdim = x.shape
    n = w.shape[1]
    if kdim % qcfg.chunk:
        raise ValueError(f"K={kdim} is not a multiple of the chunk "
                         f"{qcfg.chunk}")
    kc = kdim // qcfg.chunk
    xb = x.to(torch.float32).reshape(m, kc, qcfg.chunk)
    wb = w.to(torch.float32).reshape(kc, qcfg.chunk, n)
    v = torch.einsum("mkc,kcn->kmn", xb, wb)              # [kc, M, N]
    fs = torch.as_tensor(fs, dtype=torch.float32,
                         device=x.device).reshape(())
    if col_gain is not None:
        v = col_gain.to(torch.float32) * v
    if col_offset is not None:
        v = v + col_offset.to(torch.float32) * (fs / _levels(qcfg))
    steps = adc_quantize(v, fs, qcfg)
    out = torch.zeros((m, n), dtype=torch.float32, device=x.device)
    for c in range(kc):
        out = out + steps[c]
    return out


@functools.lru_cache(maxsize=None)
def _launcher():
    from repro_torch.kernels.build import load
    fn = load("cim_mvm").cim_mvm_launch
    fn.argtypes = [_P] * 6 + [ctypes.c_int] * 9 + [_P]
    fn.restype = ctypes.c_int
    return fn


def _check(name, t, shape, device):
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != torch.float32:
        raise TypeError(f"{name} is {t.dtype}, the kernel takes float32")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _launch(x, w, fs, qcfg: QuantConfig, col_gain, col_offset,
            plan: CimPlan | None = None):
    """Launches the kernel under ``launch_plan``'s plan, or under
    ``plan`` where one is given (a plan sweep)."""
    dev = x.device
    m, kdim = x.shape
    n = w.shape[1]
    if qcfg.chunk != CHUNK:
        raise ValueError(f"the CIM kernel digitizes every {CHUNK} rows, "
                         f"got chunk={qcfg.chunk}")
    _check("x", x, (m, kdim), dev)
    _check("w", w, (kdim, n), dev)
    _check("fs", fs.reshape(1), (1,), dev)
    for name, t in (("col_gain", col_gain), ("col_offset", col_offset)):
        if t is not None:
            _check(name, t, (n,), dev)
    out = torch.empty((m, n), dtype=torch.float32, device=dev)
    if plan is None:
        plan = launch_plan(m, kdim, n, _sm_count(dev.index))

    def ptr(t):
        return None if t is None else t.data_ptr()

    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _launcher()(ptr(x), ptr(w), ptr(fs), ptr(col_gain),
                          ptr(col_offset), ptr(out), m, kdim, n,
                          _levels(qcfg), plan.tile_m, plan.tile_n,
                          plan.split, plan.threads, plan.smem_bytes,
                          stream)
    if err != 0:
        raise RuntimeError(f"CIM kernel launch failed: cudaError {err}")
    cim_mvm.launches += 1
    return out


def cim_mvm(x, w, fs, qcfg: QuantConfig, col_gain=None,
            col_offset=None) -> torch.Tensor:
    """Chunked-ADC product x [M, K] · w [K, N] -> [M, N] float32.

    ``fs``: the ADC full scale, a one-element tensor on x's device (read
    by the kernel there: no host sync).  ``col_gain``/``col_offset``:
    optional [N] front end (offset in LSB units).  K must be a multiple
    of ``qcfg.chunk``.  CPU tensors take the plain version; CUDA tensors
    (float32, contiguous, chunk 64) launch the kernel or raise.
    """
    if x.shape[1] % qcfg.chunk:
        raise ValueError(f"K={x.shape[1]} is not a multiple of the chunk "
                         f"{qcfg.chunk}: pad K first")
    if x.device.type == "cpu":
        return cim_mvm_plain(x, w, fs, qcfg, col_gain, col_offset)
    if x.device.type != "cuda":
        raise ValueError(f"no CIM kernel for device {x.device}")
    return _launch(x, w, fs, qcfg, col_gain, col_offset)


cim_mvm.launches = 0
