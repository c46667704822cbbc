"""Attention: GQA + RoPE'd keys + qk-norm + sliding window (port of
``repro/models/attention.py``).

Prefill runs a flash-style chunked attention: an online softmax over KV
chunks inside Q chunks, accumulated in float32, so no S×S score matrix
exists.  Decode reads the cache directly (scores are [B, H, 1, S]).
These are plain products outside any Pallas kernel in the reference,
so plain ``torch`` is their port.  ``scaled_dot_product_attention`` is
not used: its masking and accumulation differ from the reference's, and
masked scores here are ``NEG_INF = -1e30``, not ``-inf``, as there (a
query row whose keys are all masked averages the chunk's values, as the
reference's does).

Sliding-window decode takes a rolling (circular) cache: slot s holds
position pos − ((pos − s) mod Sc) and a new entry goes to pos mod Sc.
There, as in the reference, a slot's ``start`` is not applied (ROADMAP
C25: a fault of the reference that the port matches).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

NEG_INF = -1e30


def expand_kv(k: torch.Tensor, n_heads: int) -> torch.Tensor:
    """Repeat KV heads [B, S, Hkv, dh] to the query head count: query
    head h reads KV head h // (n_heads / Hkv)."""
    hkv = k.shape[2]
    if hkv == n_heads:
        return k
    return torch.repeat_interleave(k, n_heads // hkv, dim=2)


def _pad_seq(x: torch.Tensor, pad: int) -> torch.Tensor:
    return F.pad(x, (0, 0, 0, 0, 0, pad)) if pad else x


def chunked_attention(q, k, v, *, causal: bool = True,
                      window: int | None = None, q_offset: int = 0,
                      kv_valid_len: int | None = None, kv_start=None,
                      chunk_q: int = 512, chunk_kv: int = 1024):
    """Flash-style attention.  q [B, Sq, H, dh]; k, v [B, Sk, H, dh]
    (KV heads expanded with ``expand_kv``).

    q_offset: global position of q[0]; kv_valid_len: valid KV entries
    (None = Sk); kv_start: optional [B] first valid KV position per row
    (left-padded prompts of a continuous-batching pool).  A key is
    masked where it is padding, in the future (``causal``), outside
    ``window`` or before its row's ``kv_start``.  Returns [B, Sq, H, dh]
    in q.dtype; scores, softmax and accumulation in float32."""
    b, sq, hq, dh = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    assert hkv == hq, "expand KV heads before calling (expand_kv)"
    dev = q.device
    scale = 1.0 / math.sqrt(dh)
    chunk_q, chunk_kv = min(chunk_q, sq), min(chunk_kv, sk)
    qp = _pad_seq(q, (-sq) % chunk_q)
    kp = _pad_seq(k, (-sk) % chunk_kv)
    vp = _pad_seq(v, (-sk) % chunk_kv)
    nq, nk = qp.shape[1] // chunk_q, kp.shape[1] // chunk_kv
    valid = sk if kv_valid_len is None else kv_valid_len
    f32 = torch.float32
    outs = []
    for iq in range(nq):
        qc = qp[:, iq * chunk_q:(iq + 1) * chunk_q]
        q_pos = q_offset + iq * chunk_q + torch.arange(chunk_q, device=dev)
        qcf = qc.to(f32) * scale
        m = torch.full((b, hq, chunk_q), NEG_INF, dtype=f32, device=dev)
        l = torch.zeros((b, hq, chunk_q), dtype=f32, device=dev)
        acc = torch.zeros((b, hq, chunk_q, dh), dtype=f32, device=dev)
        for ik in range(nk):
            sl = slice(ik * chunk_kv, (ik + 1) * chunk_kv)
            kv_pos = ik * chunk_kv + torch.arange(chunk_kv, device=dev)
            s = torch.einsum("bqhd,bkhd->bhqk", qcf, kp[:, sl].to(f32))
            mask = (kv_pos[None, :] < valid).expand(chunk_q, chunk_kv)
            if causal:
                mask = mask & (kv_pos[None, :] <= q_pos[:, None])
            if window is not None:
                mask = mask & (kv_pos[None, :] > q_pos[:, None] - window)
            mask = mask[None, None]                          # [1,1,Qc,Kc]
            if kv_start is not None:
                bmask = kv_pos[None, :] >= kv_start[:, None]  # [B, Kc]
                mask = mask & bmask[:, None, None, :]
            s = torch.where(mask, s, NEG_INF)
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(dim=-1)
            acc = (acc * corr[..., None]
                   + torch.einsum("bhqk,bkhd->bhqd", p, vp[:, sl].to(f32)))
            m = m_new
        out = acc / torch.clamp(l[..., None], min=1e-30)    # [B,H,Qc,dh]
        outs.append(out.transpose(1, 2))                     # [B,Qc,H,dh]
    return torch.cat(outs, dim=1)[:, :sq].to(q.dtype)


def decode_attention(q, cache_k, cache_v, pos: int, *,
                     window: int | None = None, rolling: bool = False,
                     start=None):
    """One token's attention against a KV cache.

    q [B, 1, Hq, dh]; cache_k/v [B, Sc, Hkv, dh]; pos: the new token's
    position (already inserted); start: optional [B] first valid cache
    position per slot (left-padded admissions stay masked), applied only
    to a linear cache, as the reference applies it (ROADMAP C25).  With
    ``rolling`` the cache is circular: slot s holds position p = pos −
    ((pos − s) mod Sc), valid if 0 ≤ p ≤ pos and p > pos − window.  GQA
    without expanding the cache: query head h = kv·g + i reads KV head
    kv.  Returns [B, 1, Hq, dh] in q.dtype."""
    b, _, hq, dh = q.shape
    sc, hkv = cache_k.shape[1], cache_k.shape[2]
    g = hq // hkv
    f32 = torch.float32
    qf = q.reshape(b, hkv, g, dh).to(f32) * (1.0 / math.sqrt(dh))
    s = torch.einsum("bhgd,bkhd->bhgk", qf, cache_k.to(f32))
    idx = torch.arange(sc, device=q.device)
    p = pos - torch.remainder(pos - idx, sc) if rolling else idx
    mask = (p >= 0) & (p <= pos)
    if window is not None:
        mask = mask & (p > pos - window)
    mask = mask[None, None, None]                            # [1,1,1,Sc]
    if start is not None and not rolling:
        mask = mask & (idx[None, :] >= start[:, None])[:, None, None, :]
    p = torch.softmax(torch.where(mask, s, NEG_INF), dim=-1)
    out = torch.einsum("bhgk,bkhd->bhgd", p, cache_v.to(f32))
    return out.reshape(b, 1, hq, dh).to(q.dtype)


def cache_update(cache_k, cache_v, k_new, v_new, pos: int, *,
                 rolling: bool = False):
    """Write [B, 1, Hkv, dh] entries at cache position ``pos`` (rolling:
    pos mod Sc) IN PLACE and return the caches.  A linear cache's
    position is clamped into the cache as the reference's
    ``dynamic_update_slice`` clamps its start."""
    sc = cache_k.shape[1]
    slot = int(pos) % sc if rolling else min(max(int(pos), 0), sc - 1)
    cache_k[:, slot] = k_new[:, 0]
    cache_v[:, slot] = v_new[:, 0]
    return cache_k, cache_v
