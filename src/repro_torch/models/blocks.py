"""Shared model building blocks (port of ``repro/models/blocks.py``).

Parameters are plain nested dicts of tensors; layer stacks carry a
leading L axis on every leaf, as the reference's ``lax.scan`` stacks
do.  The port runs forward only: ``rms_norm``'s custom backward (the
reference keeps [B, S, D] cotangents in x.dtype) waits for the LM
trainer, as does ``causal_cross_entropy``.

Statistics (norm moments, RoPE angles) are float32; their application
is in x.dtype, as the reference's: an f32 rotation or norm would widen
every activation.
"""

from __future__ import annotations

import math

import torch


def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    """x · rsqrt(mean(x²) + eps) · scale: the statistic in float32,
    cast to x.dtype, then applied in x.dtype."""
    var = x.to(torch.float32).square().mean(dim=-1, keepdim=True)
    inv = torch.rsqrt(var + eps).to(x.dtype)
    return x * inv * scale.to(x.dtype)


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    """Moments in float32, application in x.dtype."""
    xf = x.to(torch.float32)
    mean = xf.mean(dim=-1, keepdim=True)
    var = xf.var(dim=-1, keepdim=True, correction=0)
    inv = torch.rsqrt(var + eps)
    return ((x - mean.to(x.dtype)) * inv.to(x.dtype)
            * scale.to(x.dtype) + bias.to(x.dtype))


def dense_init(generator: torch.Generator, d_in: int, d_out: int,
               dtype=torch.float32) -> torch.Tensor:
    """N(0, 1/d_in) [d_in, d_out], drawn on the generator's device."""
    w = torch.randn((d_in, d_out), generator=generator, dtype=dtype,
                    device=generator.device)
    return w * (1.0 / math.sqrt(d_in))


def embed_init(generator: torch.Generator, vocab: int, dim: int,
               dtype=torch.float32) -> torch.Tensor:
    """N(0, 0.02²) [vocab, dim], drawn on the generator's device."""
    return torch.randn((vocab, dim), generator=generator, dtype=dtype,
                       device=generator.device) * 0.02


def silu(x: torch.Tensor) -> torch.Tensor:
    """x · 1/(1 + exp(−x)), each step rounded in x.dtype: the form
    ``jax.nn.silu`` lowers to (``F.silu`` rounds once, and in bfloat16
    differs from it in a third of the elements)."""
    return x * (1.0 / (1.0 + torch.exp(-x)))


def gelu(x: torch.Tensor) -> torch.Tensor:
    """x · 0.5·(1 + tanh(√(2/π)·(x + 0.044715·x·x·x))), each step rounded
    in x.dtype with both constants rounded to x.dtype first: the form
    ``jax.nn.gelu(approximate=True)`` lowers to (``x ** 3`` as x·(x·x)).
    ``F.gelu(approximate="tanh")`` rounds once and in bfloat16 differs
    from it in ~40 % of the elements."""
    # the constants rounded on the host (no copy to the card)
    c = torch.tensor(math.sqrt(2.0 / math.pi), dtype=x.dtype).item()
    a = torch.tensor(0.044715, dtype=x.dtype).item()
    return x * (0.5 * (1.0 + torch.tanh(c * (x + a * (x * (x * x))))))


def swiglu(x: torch.Tensor, wi: torch.Tensor, wg: torch.Tensor,
           wo: torch.Tensor) -> torch.Tensor:
    """SwiGLU MLP: silu(x·wg) ⊙ (x·wi) · wo, silu in the reference's
    form (``silu``)."""
    return (silu(x @ wg) * (x @ wi)) @ wo


def gelu_mlp(x: torch.Tensor, wi: torch.Tensor, bi: torch.Tensor,
             wo: torch.Tensor, bo: torch.Tensor) -> torch.Tensor:
    """GELU (tanh form, the reference's rounding: ``gelu``) MLP with
    biases (whisper)."""
    return gelu(x @ wi + bi) @ wo + bo


# ----------------------------------------------------------------------
# Rotary position embeddings
# ----------------------------------------------------------------------
def rope_frequencies(head_dim: int, theta: float, device=None) -> torch.Tensor:
    """1 / θ^(2i/dh) in float32 (θ taken as a float32 scalar, with no
    host-to-device copy)."""
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / torch.pow(float(theta), exps)


def apply_rope(x: torch.Tensor, positions, theta: float) -> torch.Tensor:
    """x [B, S, H, dh]; positions [B, S] or [S] (integers).  The angles'
    cos and sin in float32, cast to x.dtype; the rotation in x.dtype."""
    freqs = rope_frequencies(x.shape[-1], theta, device=x.device)
    pos = torch.as_tensor(positions, device=x.device)
    angles = pos[..., None].to(torch.float32) * freqs      # [.., S, dh/2]
    cos = torch.cos(angles)[..., None, :].to(x.dtype)       # [.., S, 1, dh/2]
    sin = torch.sin(angles)[..., None, :].to(x.dtype)
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
