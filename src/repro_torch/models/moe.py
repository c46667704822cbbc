"""Mixture-of-Experts layer: top-k routing with sort-based dispatch
(port of the unsharded path of ``repro/models/moe.py``).

Capacity-bounded, drop-on-overflow dispatch: the (token, choice) pairs
are sorted stably by expert, each pair takes the next slot of its
expert's capacity-padded buffer, pairs past the capacity go to a trash
slot and contribute exactly 0, the experts run as batched products
[E, C, D] × [E, D, F], and each token sums its kept pairs' outputs.
The products are plain batched matmuls outside any Pallas kernel in the
reference; routing and dispatch are plain ``torch`` with no host sync.

The reference's ``make_sharded_moe``/``_dispatch_local`` (its mesh
path, expert- or tensor-parallel over devices) wait for more than one
GPU (ROADMAP A10b); ``ep_axis`` is a sharding constraint there and has
no meaning on one card.

Aux load-balancing loss follows Switch/Mixtral: E · Σ_e f_e · p_e.
"""

from __future__ import annotations

import math

import torch

from repro_torch.models import blocks


def _normal_stack(generator: torch.Generator, shape: tuple,
                  scale: float) -> torch.Tensor:
    """N(0, scale²) of ``shape`` in float32 on the generator's device,
    allocated once and drawn one leading slice at a time (a stack of
    per-layer draws would briefly hold the leaf twice)."""
    out = torch.empty(shape, dtype=torch.float32, device=generator.device)
    for part in out:
        part.normal_(generator=generator).mul_(scale)
    return out


def init_moe(generator: torch.Generator, l: int, d_model: int, d_ff: int,
             n_experts: int) -> dict:
    """Router [L, D, E] and experts ``wi``/``wg`` [L, E, D, F], ``wo``
    [L, E, F, D] in float32 with the reference's scales: router, wi and
    wg N(0, 1/d_model), wo N(0, 1/d_ff).  The draws are the port's own,
    from ``generator`` on its device."""
    s_in, s_out = 1.0 / math.sqrt(d_model), 1.0 / math.sqrt(d_ff)
    return {
        "router": _normal_stack(generator, (l, d_model, n_experts), s_in),
        "wi": _normal_stack(generator, (l, n_experts, d_model, d_ff), s_in),
        "wg": _normal_stack(generator, (l, n_experts, d_model, d_ff), s_in),
        "wo": _normal_stack(generator, (l, n_experts, d_ff, d_model), s_out),
    }


def route(xf: torch.Tensor, router: torch.Tensor, top_k: int):
    """Gates, top-k weights and experts of tokens ``xf`` [T, D]: the
    softmax of xf·router in float32 ([T, E]); the k largest gates a
    token, ties to the lower expert as ``lax.top_k`` takes them (a
    stable descending sort); the weights renormalized by max(sum,
    1e-9).  -> (gates, weights [T, k] float32, experts [T, k] int64)."""
    gates = torch.softmax(xf.to(torch.float32) @ router.to(torch.float32),
                          dim=-1)
    vals, idx = torch.sort(gates, dim=-1, descending=True, stable=True)
    weights, experts = vals[:, :top_k], idx[:, :top_k]
    weights = weights / torch.clamp(weights.sum(-1, keepdim=True), min=1e-9)
    return gates, weights, experts


def dispatch(experts: torch.Tensor, n_experts: int, capacity: int):
    """Each (token, choice) pair's slot in the experts' capacity-padded
    buffer: pairs sorted stably by expert (``jnp.argsort``'s order), a
    pair's place in its expert's run from ``searchsorted`` (left), pairs
    past ``capacity`` to the trash slot E·capacity.  ``experts`` [T, k].
    -> (order [T·k]: pair index by sorted place, slot, keep: both in
    sorted order)."""
    dev = experts.device
    sel_sorted, order = torch.sort(experts.reshape(-1), stable=True)
    run_start = torch.searchsorted(
        sel_sorted, torch.arange(n_experts, dtype=sel_sorted.dtype,
                                 device=dev))
    pos_in_run = (torch.arange(order.numel(), device=dev)
                  - run_start[sel_sorted])
    keep = pos_in_run < capacity
    slot = torch.where(keep, sel_sorted * capacity + pos_in_run,
                       n_experts * capacity)
    return order, slot, keep


def combine(contrib: torch.Tensor, order: torch.Tensor, top_k: int):
    """Each token's sum of its pairs' ``contrib`` [T·k, D] (sorted
    order), added from zero in sorted-pair order with one rounding in
    contrib.dtype an addition: the reference's scatter-add, whose order
    matters in bf16 once k > 2.  -> [T, D]."""
    n, d = contrib.shape
    t = n // top_k
    place = torch.empty_like(order)
    place[order] = torch.arange(n, device=order.device)
    mine, _ = torch.sort(place.reshape(t, top_k), dim=1)
    y = torch.zeros((t, d), dtype=contrib.dtype, device=contrib.device)
    for j in range(top_k):
        y = y + contrib[mine[:, j]]
    return y


def moe_apply(x: torch.Tensor, router: torch.Tensor, wi: torch.Tensor,
              wg: torch.Tensor, wo: torch.Tensor, *, top_k: int,
              capacity_factor: float = 1.25):
    """x [B, S, D] -> (y [B, S, D] in x.dtype, aux loss float32 scalar).

    Experts ``wi``/``wg`` [E, D, F], ``wo`` [E, F, D] in x.dtype.  The
    capacity is int(max(k, capacity_factor·T·k/E)) per expert; the pair
    weights are cast to x.dtype before they scale the expert outputs."""
    b, s, d = x.shape
    e = router.shape[-1]
    t = b * s
    dev = x.device
    xf = x.reshape(t, d)
    gates, weights, experts = route(xf, router, top_k)

    # aux load-balancing loss, before any drop (every addend is the same,
    # so the order of index_add_'s atomics on the card cannot matter)
    frac_tokens = torch.zeros(e, dtype=torch.float32, device=dev)
    frac_tokens.index_add_(0, experts.reshape(-1), torch.full(
        (t * top_k,), 1.0 / (t * top_k), dtype=torch.float32, device=dev))
    aux = e * torch.sum(frac_tokens * gates.mean(0))

    capacity = int(max(top_k, capacity_factor * t * top_k / e))
    order, slot, keep = dispatch(experts, e, capacity)
    buf = torch.zeros((e * capacity + 1, d), dtype=x.dtype, device=dev)
    buf[slot] = xf[order // top_k]
    xe = buf[:e * capacity].reshape(e, capacity, d)
    h = blocks.silu(torch.bmm(xe, wg)) * torch.bmm(xe, wi)
    yf = torch.bmm(h, wo).reshape(e * capacity, d)

    y_pairs = torch.where(keep[:, None],
                          yf[torch.clamp(slot, max=e * capacity - 1)],
                          torch.zeros((), dtype=yf.dtype, device=dev))
    w_pairs = weights.reshape(-1)[order].to(y_pairs.dtype)
    y = combine(y_pairs * w_pairs[:, None], order, top_k)
    return y.reshape(b, s, d), aux
