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
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.core.quant import QuantConfig, adc_quantize

CHUNK = 64                # the kernel's analog accumulation depth
_P = ctypes.c_void_p


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
    fn.argtypes = [_P] * 6 + [ctypes.c_int] * 4 + [_P]
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


def _launch(x, w, fs, qcfg: QuantConfig, col_gain, col_offset):
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

    def ptr(t):
        return None if t is None else t.data_ptr()

    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _launcher()(ptr(x), ptr(w), ptr(fs), ptr(col_gain),
                          ptr(col_offset), ptr(out), m, kdim, n,
                          _levels(qcfg), stream)
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
