"""Gradient compression with error feedback (port of
``repro/optim/compression.py``).

Per-leaf symmetric int8 quantization with a max-abs scale; the
quantization residual (g + err) − dequant is carried into the next
step as the error state, which is laid out like the params, so the
compressed trajectory tracks the exact one (Seide et al.; Karimireddy
et al.).  In the reference the codes are what crosses a slow link in a
cross-pod gradient reduction; on one card there is no link, and the
trainer's ``--compress`` applies the quantize-dequantize round trip to
its gradients as the reference's does.

The arithmetic is the reference's, in float32: scale = max(max|g|,
1e-12) / 127, codes = clip(round(g / scale), −127, 127) with round half
to even (``torch.round``, as ``jnp.round``), both divisions true
divisions by tensors (PyTorch on the card multiplies by the reciprocal
when it divides by a Python number).
"""

from __future__ import annotations

import torch

from repro_torch.utils.trees import leaves, tree_map, unflatten_like


def init_error_state(params):
    """Zero float32 residuals shaped like ``params``, on their device."""
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), params)


def quantize_leaf(g: torch.Tensor):
    """g -> (int8 codes, float32 scale)."""
    g = g.to(torch.float32)
    amax = torch.clamp(g.abs().max(), min=1e-12)
    scale = amax / torch.full_like(amax, 127.0)
    codes = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
    return codes, scale


def dequantize_leaf(codes: torch.Tensor, scale: torch.Tensor):
    return codes.to(torch.float32) * scale


def compress_grads(grads, err_state):
    """Error-feedback compression: -> (tree of (codes, scale), new error
    state), the residual (g + err) − dequant staying local."""
    comp, new_err = [], []
    for g, e in zip(leaves(grads), leaves(err_state)):
        corrected = g.to(torch.float32) + e
        codes, scale = quantize_leaf(corrected)
        comp.append((codes, scale))
        new_err.append(corrected - dequantize_leaf(codes, scale))
    return unflatten_like(grads, comp), unflatten_like(grads, new_err)


def decompress_grads(comp):
    """Tree of (codes, scale) pairs -> float32 gradients."""
    if isinstance(comp, tuple) and len(comp) == 2 and isinstance(
            comp[0], torch.Tensor):
        return dequantize_leaf(*comp)
    if isinstance(comp, dict):
        return {k: decompress_grads(v) for k, v in comp.items()}
    return type(comp)(decompress_grads(v) for v in comp)


def compressed_gradients(grads, err_state):
    """Quantize -> dequantize with error feedback in one call: ->
    (grads', new error state)."""
    comp, new_err = compress_grads(grads, err_state)
    return decompress_grads(comp), new_err
