"""Counter-based integer hashing (port of ``repro/core/hashing.py``).

A virtual FeFET's state is a pure hash of its coordinate: ``mix32`` is
the "lowbias32" finalizer, ``hash3`` folds a 3-D coordinate and a seed.
The streams must equal the reference bit for bit.

PyTorch's CPU ``uint32`` has no ``>>`` and no ``+``, so every uint32
value here is carried in an ``int64`` tensor and masked back to 32
bits after each step.  A product of a 32-bit value with a constant of
2³¹ or more can pass 2⁶³ in int64, so ``mul32`` splits the constant
into 16-bit halves: each partial product stays below 2⁴⁹.  The CUDA
kernels use native ``uint32`` (``kernels/csrc/hash.cuh``).
"""

from __future__ import annotations

import torch

MASK32 = 0xFFFFFFFF

# Knuth/Weyl multiplicative constants for coordinate folding.
_C1 = 0x9E3779B9
_C2 = 0x85EBCA6B
_C3 = 0xC2B2AE35

# float32(1 / 127.99316): the Irwin–Hall (n=3) byte-sum standardizer.
_GAUSS_SCALE = 1.0 / 127.99316


def as_u32(x, device=None) -> torch.Tensor:
    """Integers (tensor, array or Python int) -> int64 tensor holding
    their uint32 value, i.e. reduced mod 2³² as a uint32 cast would."""
    t = torch.as_tensor(x, device=device)
    if t.dtype.is_floating_point or t.dtype == torch.bool:
        raise TypeError(f"as_u32 takes integers, got {t.dtype}")
    return t.to(torch.int64) & MASK32


def mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x · c) mod 2³² for int64 ``x`` in [0, 2³²) and a constant
    ``c`` < 2³², never passing 2⁶³ (``c`` is split into 16-bit
    halves: x·c = x·lo + 2¹⁶·x·hi)."""
    lo, hi = c & 0xFFFF, c >> 16
    return (x * lo + (((x * hi) & 0xFFFF) << 16)) & MASK32


def mix32(x) -> torch.Tensor:
    """lowbias32 finalizer on uint32 values (int64 carrier)."""
    x = as_u32(x)
    x = x ^ (x >> 16)
    x = mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = mul32(x, 0x846CA68B)
    x = x ^ (x >> 16)
    return x


def hash3(k, n, j, seed: int) -> torch.Tensor:
    """Hash a 3-D coordinate + seed into 32 uniform bits.

    Arguments broadcast against each other; any integer dtype.
    """
    s = int(seed) & MASK32
    h = mix32((mul32(as_u32(j), _C3) + s) & MASK32)
    h = mix32((mul32(as_u32(n), _C2) + h) & MASK32)
    return mix32((mul32(as_u32(k), _C1) + h) & MASK32)


def hash2(a, b, seed: int) -> torch.Tensor:
    s = int(seed) & MASK32
    h = mix32((mul32(as_u32(b), _C2) + s) & MASK32)
    return mix32((mul32(as_u32(a), _C1) + h) & MASK32)


def uniform_bit(h: torch.Tensor, bit: int = 31) -> torch.Tensor:
    """One Bernoulli(1/2) bit of a hash word, as float32 0/1."""
    return ((h >> bit) & 1).to(torch.float32)


def gaussianish(h: torch.Tensor) -> torch.Tensor:
    """CLT-of-bytes standard-normal surrogate: the sum of the three low
    bytes of a hash word, standardized (Irwin–Hall, n=3)."""
    b0 = (h & 0xFF).to(torch.float32)
    b1 = ((h >> 8) & 0xFF).to(torch.float32)
    b2 = ((h >> 16) & 0xFF).to(torch.float32)
    return (b0 + b1 + b2 - 382.5) * _GAUSS_SCALE
