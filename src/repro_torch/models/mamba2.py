"""Mamba2 (state-space duality, SSD): the attention-free trunk (port of
``repro/models/mamba2.py``).

The chunked SSD algorithm of Dao & Gu (arXiv:2405.21060): within a
chunk the quadratic dual form runs as batched products; across chunks a
[B, H, P, N] state is carried, here by a Python loop over the chunks
where the reference scans.  Decode is one O(1) recurrent state update.
The reference has no Pallas body here: its SSD is einsums under
``lax.scan``, so plain ``torch`` is their port.

Layer = in_proj → causal depthwise conv (shift-add form) → SSD → gated
RMSNorm → out_proj.  The projections and the conv of a full sequence
run in the activations' dtype; the SSD arithmetic, the decode conv and
the recurrent state are float32, as in the reference.  A prefill's conv
state keeps the activations' dtype and a decode step's is float32, as
the reference's are.

Parameters stack on a leading layer axis, as the reference's scan
stacks do (``init_mamba_stack``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models import blocks
from repro_torch.models.transformer import _stack


def mamba_dims(cfg) -> dict:
    d_inner = cfg.ssm_expand * cfg.d_model
    nheads = d_inner // cfg.ssm_headdim
    conv_dim = d_inner + 2 * cfg.ssm_ngroups * cfg.ssm_state
    d_proj = 2 * d_inner + 2 * cfg.ssm_ngroups * cfg.ssm_state + nheads
    return dict(d_inner=d_inner, nheads=nheads, conv_dim=conv_dim,
                d_proj=d_proj, d_state=cfg.ssm_state, ngroups=cfg.ssm_ngroups,
                headdim=cfg.ssm_headdim, d_conv=cfg.ssm_conv)


def init_mamba_stack(generator: torch.Generator, cfg, l: int) -> dict:
    """``l`` mamba2 layers in the reference's tree and float32 layout,
    drawn from ``generator`` on its device with the reference's scales:
    in_proj [L, D, d_proj] and out_proj [L, d_inner, D] N(0, 1/d_in),
    conv_w [L, conv_dim, K] N(0, 0.1²), conv_b 0, dt_bias 0, A_log 0
    (A = −1), D 1, norm 1.  The draws are the port's own."""
    dims = mamba_dims(cfg)
    d, dev = cfg.d_model, generator.device
    in_proj = _stack(generator, l, d, dims["d_proj"])
    conv_w = torch.randn((l, dims["conv_dim"], dims["d_conv"]),
                         generator=generator, device=dev) * 0.1
    return {
        "in_proj": in_proj,
        "conv_w": conv_w,
        "conv_b": torch.zeros((l, dims["conv_dim"]), device=dev),
        "dt_bias": torch.zeros((l, dims["nheads"]), device=dev),
        "A_log": torch.zeros((l, dims["nheads"]), device=dev),
        "D": torch.ones((l, dims["nheads"]), device=dev),
        "norm": torch.ones((l, dims["d_inner"]), device=dev),
        "out_proj": _stack(generator, l, dims["d_inner"], d),
    }


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """log(exp(x) + 1), ``jax.nn.softplus``'s form (PyTorch's
    ``softplus`` switches to the identity above 20)."""
    return torch.logaddexp(x, torch.zeros_like(x))


def _causal_conv_full(x, w, b):
    """Depthwise causal conv as shift-adds in the reference's order.
    x [B, S, C], w [C, K], b [C]; in x.dtype."""
    k, s = w.shape[-1], x.shape[1]
    y = torch.zeros_like(x)
    for i in range(k):
        shift = k - 1 - i
        xi = F.pad(x, (0, 0, shift, 0))[:, :s]
        y = y + xi * w[:, i].to(x.dtype)
    return y + b.to(x.dtype)


def _segsum_exp(a):
    """L[i, j] = exp(Σ_{j<t≤i} a_t) for i ≥ j, else 0.  a [..., Q]."""
    q = a.shape[-1]
    cs = torch.cumsum(a, dim=-1)
    diff = cs[..., :, None] - cs[..., None, :]               # [..., Q, Q]
    mask = torch.tril(torch.ones((q, q), dtype=torch.bool, device=a.device))
    return torch.where(mask, torch.exp(diff), torch.zeros((), device=a.device))


def ssd_chunked(x, dt, a, b_mat, c_mat, chunk: int, state0=None):
    """Chunked SSD scan, float32.

    x [B, S, H, P] inputs (before the dt scaling); dt [B, S, H] positive
    step sizes; a [H] negative decay rates; b_mat, c_mat [B, S, G, N];
    ``state0`` an optional [B, H, P, N] state carried in.  S must be a
    multiple of ``chunk`` (ValueError, where the reference asserts): a
    prompt is not padded to it.  -> (y [B, S, H, P], final state
    [B, H, P, N])."""
    bsz, s, h, p = x.shape
    g, n = b_mat.shape[2], b_mat.shape[3]
    if s % chunk:
        raise ValueError(f"sequence must be chunk-aligned: S = {s} is not "
                         f"a multiple of the SSD chunk {chunk}")
    rep = h // g
    state = (torch.zeros((bsz, h, p, n), dtype=torch.float32,
                         device=x.device) if state0 is None else state0)
    ys = []
    for c0 in range(0, s, chunk):
        xq, dtq = x[:, c0:c0 + chunk], dt[:, c0:c0 + chunk]
        bq_h = torch.repeat_interleave(b_mat[:, c0:c0 + chunk], rep, dim=2)
        cq_h = torch.repeat_interleave(c_mat[:, c0:c0 + chunk], rep, dim=2)
        adt_t = (dtq * a).transpose(1, 2)                    # [B, H, Q]
        cum = torch.cumsum(adt_t, dim=-1)
        lmat = _segsum_exp(adt_t)                            # [B, H, Q, Q]
        xdt = xq * dtq[..., None]                            # [B, Q, H, P]
        scores = torch.einsum("bzhn,bshn->bhzs", cq_h, bq_h)
        y_diag = torch.einsum("bhzs,bshp->bzhp", scores * lmat, xdt)
        decay_out = torch.exp(cum).transpose(1, 2)[..., None]  # [B,Q,H,1]
        y_off = torch.einsum("bzhn,bhpn->bzhp", cq_h, state) * decay_out
        decay_st = torch.exp(cum[..., -1:] - cum)            # [B, H, Q]
        new_contrib = torch.einsum(
            "bshn,bshp->bhpn", bq_h * decay_st.transpose(1, 2)[..., None],
            xdt)
        state = (state * torch.exp(cum[..., -1])[..., None, None]
                 + new_contrib)
        ys.append(y_diag + y_off)
    return torch.cat(ys, dim=1), state


def mamba_block_full(h, lp: dict, cfg, state0=None, conv_state0=None):
    """One mamba2 layer over a sequence h [B, S, D], optionally from a
    carried SSD state [B, H, P, N] and conv state [B, conv_dim, K−1].
    -> (out [B, S, D], (ssm state, conv state: the last K−1 raw conv
    inputs, [B, conv_dim, K−1] in h.dtype))."""
    dims = mamba_dims(cfg)
    bsz, s, _ = h.shape
    d_in, nh, hd = dims["d_inner"], dims["nheads"], dims["headdim"]
    g, n = dims["ngroups"], dims["d_state"]

    zxbcdt = h @ lp["in_proj"].to(h.dtype)
    z, xbc, dt = torch.split(zxbcdt, [d_in, dims["conv_dim"], nh], dim=-1)
    if conv_state0 is not None:          # prepend, conv, strip
        xbc_ext = torch.cat(
            [conv_state0.to(xbc.dtype).transpose(1, 2), xbc], dim=1)
        y = _causal_conv_full(xbc_ext, lp["conv_w"], lp["conv_b"])
        xbc_conv = y[:, conv_state0.shape[2]:]
    else:
        xbc_conv = _causal_conv_full(xbc, lp["conv_w"], lp["conv_b"])
    xbc_conv = blocks.silu(xbc_conv)
    x, b_mat, c_mat = torch.split(xbc_conv, [d_in, g * n, g * n], dim=-1)

    f32 = torch.float32
    x = x.reshape(bsz, s, nh, hd).to(f32)
    b_mat = b_mat.reshape(bsz, s, g, n).to(f32)
    c_mat = c_mat.reshape(bsz, s, g, n).to(f32)
    dt = _softplus(dt.to(f32) + lp["dt_bias"][None, None])
    a = -torch.exp(lp["A_log"].to(f32))

    y, state = ssd_chunked(x, dt, a, b_mat, c_mat, cfg.ssm_chunk, state0)
    y = y + x * lp["D"].to(f32)[None, None, :, None]
    y = y.reshape(bsz, s, d_in).to(h.dtype)
    y = blocks.rms_norm(y * blocks.silu(z), lp["norm"])
    out = y @ lp["out_proj"].to(h.dtype)
    new_conv_state = xbc[:, -(dims["d_conv"] - 1):].transpose(1, 2)
    return out, (state, new_conv_state.contiguous())


def mamba_block_decode(h, lp: dict, cfg, ssm_state, conv_state):
    """One token's mamba2 step: h [B, 1, D] against the layer's SSD state
    [B, H, P, N] and conv state [B, conv_dim, K−1].  -> (out [B, 1, D],
    (new ssm state, new conv state in float32))."""
    dims = mamba_dims(cfg)
    bsz = h.shape[0]
    d_in, nh, hd = dims["d_inner"], dims["nheads"], dims["headdim"]
    g, n, k = dims["ngroups"], dims["d_state"], dims["d_conv"]
    f32 = torch.float32

    zxbcdt = h[:, 0] @ lp["in_proj"].to(h.dtype)
    z, xbc, dt = torch.split(zxbcdt, [d_in, dims["conv_dim"], nh], dim=-1)

    w = lp["conv_w"].to(f32)                                 # [C, K]
    hist = conv_state.to(f32)
    xbc32 = xbc.to(f32)
    y = (hist * w[None, :, :k - 1]).sum(-1) + xbc32 * w[None, :, k - 1]
    y = blocks.silu(y + lp["conv_b"].to(f32)[None])
    new_conv_state = torch.cat([hist[:, :, 1:], xbc32[:, :, None]], dim=-1)

    x, b_mat, c_mat = torch.split(y, [d_in, g * n, g * n], dim=-1)
    x = x.reshape(bsz, nh, hd)
    b_mat = torch.repeat_interleave(b_mat.reshape(bsz, g, n), nh // g, dim=1)
    c_mat = torch.repeat_interleave(c_mat.reshape(bsz, g, n), nh // g, dim=1)
    dt = _softplus(dt.to(f32) + lp["dt_bias"][None])
    a = -torch.exp(lp["A_log"].to(f32))

    decay = torch.exp(dt * a[None])                          # [B, H]
    ssm_state = (ssm_state * decay[..., None, None]
                 + x[..., :, None] * b_mat[..., None, :]
                 * dt[..., None, None])
    y = torch.einsum("bhpn,bhn->bhp", ssm_state, c_mat)
    y = y + x * lp["D"].to(f32)[None, :, None]
    y = y.reshape(bsz, d_in).to(h.dtype)
    y = blocks.rms_norm(y * blocks.silu(z), lp["norm"])
    out = (y @ lp["out_proj"].to(h.dtype))[:, None]
    return out, (ssm_state, new_conv_state)
