"""Write-free CLT-GRNG ε block: the CUDA kernel's wrapper and its plain
version.

Replaces the Pallas TPU kernel ``grng_eps_pallas``
(``repro/kernels/clt_grng_kernel.py:103``): the standardized subset sums

    ε[r, k, n] = (Σ_j sel[r, j] · I(row0+k, col0+n, j)
                  + read_noise(row0+k, col0+n, sample0+r) − sum_mean)
                 · float32(1 / sum_std)

of a weight block, the 16 device currents hashed from the coordinate and
never stored, summed in order j = 0…15.  The read noise enters only when
``cfg.read_sigma > 0``.

``grng_eps`` routes by where ``sel`` lies: a CPU tensor goes to
``grng_eps_plain``; a CUDA tensor launches ``csrc/grng_eps.cu`` or
raises.  There is no fallback.  ``grng_eps.launches`` counts kernel
launches.  ``grng_params`` packs a ``GRNGConfig`` into the float32
constants every GRNG kernel of the port reads (``GrngParams`` in
``csrc/hash.cuh``).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.core import clt_grng as g

_P = ctypes.c_void_p
_U32 = ctypes.c_uint


class GrngParams(ctypes.Structure):
    """The C struct ``GrngParams`` of ``csrc/hash.cuh``, field for
    field."""
    _fields_ = [("i_lo", ctypes.c_float), ("delta_i", ctypes.c_float),
                ("gamma", ctypes.c_float), ("imprint", ctypes.c_float),
                ("read_sigma", ctypes.c_float), ("sum_mean", ctypes.c_float),
                ("inv_std", ctypes.c_float), ("seed", ctypes.c_uint32),
                ("imprint_seed", ctypes.c_uint32),
                ("noise_seed", ctypes.c_uint32)]


def grng_params(cfg: g.GRNGConfig) -> GrngParams:
    """The config's constants as the kernels read them: each Python
    float rounded to float32, ``inv_std = float32(1 / sum_std)`` (the
    reciprocal taken in double first, as the reference's weakly typed
    constant is), the seeds as uint32."""
    if cfg.n_devices != 16:
        raise ValueError(f"the GRNG kernels hash 16 devices, got "
                         f"{cfg.n_devices}")
    m = 0xFFFFFFFF
    return GrngParams(cfg.i_lo, cfg.delta_i, cfg.gamma, cfg.imprint,
                      cfg.read_sigma, cfg.sum_mean, 1.0 / cfg.sum_std,
                      cfg.seed & m, cfg.imprint_seed & m, cfg.noise_seed & m)


def grng_eps_plain(sel, cfg: g.GRNGConfig, n_rows: int, n_cols: int,
                   row0: int = 0, col0: int = 0,
                   sample0: int = 0) -> torch.Tensor:
    """Plain PyTorch version: the block's currents once, then
    ``clt_grng.eps_at`` per sample -> [R, n_rows, n_cols]."""
    currents = g.device_currents_grid(cfg, n_rows, n_cols, row0, col0,
                                      device=sel.device)
    return torch.stack([g.eps_at(currents, sel[r], cfg, sample0 + r, row0,
                                 col0) for r in range(sel.shape[0])])


@functools.lru_cache(maxsize=None)
def _launcher():
    from repro_torch.kernels.build import load
    fn = load("grng_eps").grng_eps_launch
    fn.argtypes = [_P, _P] + [ctypes.c_int] * 3 + [_U32] * 3 + [
        ctypes.POINTER(GrngParams), _P]
    fn.restype = ctypes.c_int
    return fn


def _launch(sel, cfg, n_rows, n_cols, row0, col0, sample0):
    dev = sel.device
    r = sel.shape[0]
    if sel.dtype != torch.float32:
        raise TypeError(f"sel is {sel.dtype}, the kernel takes float32")
    if tuple(sel.shape) != (r, 16) or not sel.is_contiguous():
        raise ValueError(f"sel must be a contiguous [R, 16] tensor, got "
                         f"{tuple(sel.shape)}")
    if min(r, n_rows, n_cols) < 1:
        raise ValueError("empty ε block")
    out = torch.empty((r, n_rows, n_cols), dtype=torch.float32, device=dev)
    params = grng_params(cfg)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _launcher()(sel.data_ptr(), out.data_ptr(), r, n_rows, n_cols,
                          row0 & 0xFFFFFFFF, col0 & 0xFFFFFFFF,
                          sample0 & 0xFFFFFFFF, ctypes.byref(params), stream)
    if err != 0:
        raise RuntimeError(f"GRNG ε kernel launch failed: cudaError {err}")
    grng_eps.launches += 1
    return out


def grng_eps(sel: torch.Tensor, cfg: g.GRNGConfig, n_rows: int,
             n_cols: int, row0: int = 0, col0: int = 0,
             sample0: int = 0) -> torch.Tensor:
    """ε block [R, n_rows, n_cols] float32 for the selections ``sel``
    [R, 16] (samples ``sample0`` …, the read-noise key) at global
    coordinates offset by (``row0``, ``col0``).  A CPU ``sel`` takes the
    plain version; a CUDA one (float32, contiguous) launches the kernel
    or raises."""
    if cfg.granularity != "layer":
        raise ValueError("the ε kernel takes shared ('layer') selections")
    if sel.device.type == "cpu":
        return grng_eps_plain(sel, cfg, n_rows, n_cols, row0, col0, sample0)
    if sel.device.type != "cuda":
        raise ValueError(f"no GRNG kernel for device {sel.device}")
    return _launch(sel, cfg, n_rows, n_cols, row0, col0, sample0)


grng_eps.launches = 0
