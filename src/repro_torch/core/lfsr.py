"""16-bit LFSR + two-layer swapper selection network (port of
``repro/core/lfsr.py``, paper Fig. 10).

One 16-bit Galois LFSR (x^16+x^14+x^13+x^11+1, mask 0xB400) drives two
layers of wire swappers over the fixed input [1,0,1,0,...]: layer 1
swaps adjacent bits (2n, 2n+1) under the low 8 state bits, layer 2
swaps bit n with bit n+8 under the high 8.  Exactly 8 of 16 devices
are selected whatever the state.

States are uint32 values carried in int64 tensors (see hashing.py).
The serving engine reads the stream by random access
(``indexed_selections``): the sample index is hashed into a state.
The 'tile' granularity gives each tile×tile macro its own LFSR
(``tile_seeds``, ``lfsr_walk``); the 'cell' one hashes a state per
(cell, sample) (``cell_selections``).
"""

from __future__ import annotations

import torch

from repro_torch import resolve_device
from repro_torch.core.hashing import MASK32, as_u32, hash3, mix32, mul32

LFSR_MASK = 0xB400  # taps 16,14,13,11 (maximal length)
FIXED_INPUT = tuple([1, 0] * 8)  # eight 1s, alternating
_SEED_FALLBACK = 0xACE1          # 0 is the LFSR's fixed point


def lfsr_next(state) -> torch.Tensor:
    """One Galois LFSR step on 16-bit states (int64 carrier)."""
    state = as_u32(state)
    shifted = state >> 1
    return torch.where((state & 1) == 1, shifted ^ LFSR_MASK, shifted)


def lfsr_states(seed: int, num: int, device=None) -> torch.Tensor:
    """``num`` successive LFSR states from ``seed`` -> [num] int64.

    Off the hot path (the engine uses ``indexed_selections``), so a
    host loop over Python ints stands in for the reference's scan.
    """
    s = int(seed) & 0xFFFF or _SEED_FALLBACK
    out = []
    for _ in range(num):
        out.append(s)
        s = (s >> 1) ^ LFSR_MASK if s & 1 else s >> 1
    return torch.tensor(out, dtype=torch.int64, device=device)


def lfsr_walk(seeds: torch.Tensor, num: int) -> torch.Tensor:
    """``num`` successive states of one LFSR per seed, stepped together
    on the seeds' device: seeds [*S] (16-bit, nonzero) -> [num, *S]."""
    states, s = [], as_u32(seeds)
    for _ in range(num):
        states.append(s)
        s = lfsr_next(s)
    return torch.stack(states)


def swapper_select(state) -> torch.Tensor:
    """LFSR state(s) [*S] -> selection vectors float32 [*S, 16], exactly
    eight ones each (arithmetic only, as in the reference)."""
    state = as_u32(state)
    shape = tuple(state.shape)
    bits = torch.arange(8, dtype=torch.int64, device=state.device)
    c1 = ((state[..., None] >> bits) & 1).to(torch.float32)        # [*S, 8]
    c2 = ((state[..., None] >> (8 + bits)) & 1).to(torch.float32)  # [*S, 8]
    # FIXED_INPUT made on the state's device (a tensor from a Python list
    # would be a host-to-device copy, which waits for the card)
    v = (torch.arange(16, device=state.device) % 2 == 0).to(
        torch.float32).expand(shape + (16,))
    # Layer 1: swap within adjacent pairs (2n, 2n+1).
    pairs = v.reshape(shape + (8, 2))
    a, b = pairs[..., 0], pairs[..., 1]
    a1 = a + c1 * (b - a)
    b1 = b + c1 * (a - b)
    v1 = torch.stack([a1, b1], dim=-1).reshape(shape + (16,))
    # Layer 2: swap bit n with bit n+8.
    lo, hi = v1[..., :8], v1[..., 8:]
    lo2 = lo + c2 * (hi - lo)
    hi2 = hi + c2 * (lo - hi)
    return torch.cat([lo2, hi2], dim=-1)


def selection_stream(seed: int, num: int, device=None) -> torch.Tensor:
    """``num`` successive selection vectors -> float32 [num, 16]."""
    return swapper_select(lfsr_states(seed, num, device=device))


def _nonzero_state(h: torch.Tensor) -> torch.Tensor:
    s = h & 0xFFFF
    return torch.where(s == 0, torch.full_like(s, _SEED_FALLBACK), s)


def tile_seeds(base_seed: int, n_tiles: int, device=None) -> torch.Tensor:
    """Per-tile LFSR seeds (the hardware's per-macro selector
    instances) -> [n_tiles] int64: tile t's seed is the stream state
    ``indexed_states`` gives sample t."""
    return indexed_states(base_seed, torch.arange(
        n_tiles, dtype=torch.int64, device=device))


def cell_selections(rows, cols, r, seed: int) -> torch.Tensor:
    """Idealized independent selections per (cell, sample), 'cell'
    granularity: the swapper network under the state hash3(row, col,
    r, seed), so exactly 8 of 16 still hold.  Arguments broadcast ->
    float32 [..., 16]."""
    return swapper_select(_nonzero_state(hash3(rows, cols, r, seed)))


def enumerate_reachable(device=None) -> tuple[int, torch.Tensor]:
    """Distinct selection patterns over all 65,535 nonzero LFSR states,
    walked on ``device`` (None = the card) -> (count, per-position
    selection frequency float32 [16])."""
    dev = resolve_device(device)
    sels = swapper_select(torch.arange(1, 1 << 16, dtype=torch.int64,
                                       device=dev))          # [65535, 16]
    pow2 = 1 << torch.arange(16, dtype=torch.int64, device=dev)
    codes = (sels.to(torch.int64) * pow2).sum(-1)
    return int(torch.unique(codes).numel()), sels.mean(dim=0)


def indexed_states(seed: int, idx) -> torch.Tensor:
    """Random-access 16-bit selection states for sample indices: the
    index is hashed into a state (0 maps to the fallback seed)."""
    return _nonzero_state(mix32(
        (mul32(as_u32(idx), 0x9E3779B9) + (int(seed) & MASK32)) & MASK32))


def indexed_selections(seed: int, idx) -> torch.Tensor:
    """Selection vectors for arbitrary sample indices. [*idx, 16]."""
    return swapper_select(indexed_states(seed, idx))
