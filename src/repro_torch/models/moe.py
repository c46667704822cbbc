"""Mixture-of-Experts layer: top-k routing with sort-based dispatch
(port of the unsharded path of ``repro/models/moe.py``).

Capacity-bounded, drop-on-overflow dispatch: the (token, choice) pairs
are sorted stably by expert, each pair takes the next slot of its
expert's capacity-padded buffer, pairs past the capacity go to a trash
slot and contribute exactly 0, the experts run as batched products
[E, C, D] × [E, D, F], and each token sums its kept pairs' outputs.
The products are plain batched matmuls outside any Pallas kernel in the
reference; routing and dispatch are plain ``torch`` with no host sync.

The mesh path (``make_sharded_moe``, ``_dispatch_local``; the
reference's §Perf I1): routing is parallel over the batch, so a shard
body at mesh coordinate (row, j) routes its row's tokens to its own
experts with no dispatch communication.  Experts sit on 'model' when E
divides it (expert parallelism, EP: coordinate j holds experts
[j·E/M, (j+1)·E/M)); else d_ff does (TP-F: every coordinate holds all E
experts' j-th slice of F).  The body gathers its expert pieces over
'data' (FSDP), dispatches its local pairs, and the model coordinates'
outputs are added (one psum).  ``ep_axis`` of the unsharded path is a
GSPMD constraint with no effect on values and has no twin.

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
    order; ``order`` from ``dispatch``), added from zero in sorted-pair
    order with one rounding in contrib.dtype an addition: the
    reference's scatter-add, whose order matters in bf16 once k > 2.
    -> [T, D]."""
    return _scatter_add_sorted(contrib, order // top_k,
                               contrib.shape[0] // top_k, top_k)


def _scatter_add_sorted(contrib: torch.Tensor, token_sorted: torch.Tensor,
                        t: int, top_k: int) -> torch.Tensor:
    """``zeros((t, D)).at[token_sorted].add(contrib)`` with the pairs of
    each token added in their sorted order (``contrib`` [q, D] and
    ``token_sorted`` [q] in sorted-pair order; a token holds at most
    ``top_k`` of them, maybe none: a shard's local pairs).  -> [t, D]."""
    q, d = contrib.shape
    dev = contrib.device
    tok, perm = torch.sort(token_sorted, stable=True)
    first = torch.searchsorted(tok, torch.arange(t, dtype=tok.dtype,
                                                 device=dev))
    rank = torch.arange(q, device=dev) - first[tok]
    table = torch.full((t * top_k,), q, dtype=torch.int64, device=dev)
    table[tok * top_k + rank] = perm
    table = table.reshape(t, top_k)
    ext = torch.cat([contrib, contrib.new_zeros((1, d))])  # q: no pair
    y = torch.zeros((t, d), dtype=contrib.dtype, device=dev)
    for j in range(top_k):
        y = y + ext[table[:, j]]
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


# ----------------------------------------------------------------------
# The mesh path (shard bodies) — §Perf I1
# ----------------------------------------------------------------------
def _dispatch_local(xf, expert_idx, weights, e0: int, e_loc: int,
                    capacity: int):
    """Local-token -> local-expert dispatch (no collectives).

    xf: [T, D]; expert_idx/weights: [T, k] global expert ids + gates.
    Selects pairs with e0 <= id < e0+e_loc (foreign ones take the
    sentinel e_loc and sort last, stably), packs them into
    [e_loc, capacity, D].  §Perf I1b: only the head of the sorted pair
    list can land in the buffers, so it is cut to q = min(T·k,
    2·e_loc·capacity); a local pair beyond it drops, as an overflow
    does.  Returns (xe, slot, keep, token_sorted, w_sorted) over the q
    pairs, for the combine step."""
    t, d = xf.shape
    k = expert_idx.shape[1]
    dev = xf.device
    sel = expert_idx.reshape(-1) - e0                  # [T*k]
    mine = (sel >= 0) & (sel < e_loc)
    sel_c = torch.where(mine, sel, e_loc)              # foreign -> sentinel
    _, order = torch.sort(sel_c, stable=True)
    q = min(t * k, 2 * e_loc * capacity)
    order_q = order[:q]
    sel_sorted = sel_c[order_q]
    token_sorted = order_q // k
    run_start = torch.searchsorted(
        sel_sorted, torch.arange(e_loc, dtype=sel_sorted.dtype, device=dev))
    pos_in_run = (torch.arange(q, device=dev)
                  - run_start[torch.clamp(sel_sorted, max=e_loc - 1)])
    keep = (sel_sorted < e_loc) & (pos_in_run < capacity)
    slot = torch.where(keep, sel_sorted * capacity + pos_in_run,
                       e_loc * capacity)
    buf = torch.zeros((e_loc * capacity + 1, d), dtype=xf.dtype, device=dev)
    buf[slot] = torch.where(keep[:, None], xf[token_sorted],
                            torch.zeros((), dtype=xf.dtype, device=dev))
    xe = buf[:e_loc * capacity].reshape(e_loc, capacity, d)
    w_sorted = weights.reshape(-1)[order_q].to(xf.dtype)
    return xe, slot, keep, token_sorted, w_sorted


def make_sharded_moe(mesh, *, top_k: int, capacity_factor: float,
                     n_experts: int, dp_axes: tuple, stats: list = None):
    """-> moe(x, router, wi, wg, wo, row=None) -> (y, aux), the
    reference's shard_map body run once a mesh coordinate
    (``launch/mesh``).  Expert placement follows ``sharding/specs``:
    EP (``wi``/``wg`` P('model', 'data', None), ``wo`` P('model', None,
    'data')) when E divides 'model', else TP-F (P(None, 'data',
    'model') / P(None, 'model', 'data')); weights may come placed
    (``Placed``, re-cut where their spec differs) or whole.

    The body at (row, j) gathers its expert pieces over 'data', routes
    the row's tokens (gates in float32, top-k, weights renormalized),
    computes the aux loss and the capacity from the row's own token
    count t_loc (so a small capacity factor drops other pairs than
    ``moe_apply`` on the whole batch), dispatches its local pairs
    (``_dispatch_local``), runs its experts and adds its pairs a token
    in sorted order; the row's output is the psum of its model
    coordinates' outputs, in x.dtype, on the row's device.

    ``row=None``: ``x`` is the whole batch [B, S, D], cut over 'data'
    into rows; -> (y [B, S, D] on x's device, aux pmean'd over the rows).
    ``row=d``: ``x`` is row d's tokens (a mesh step's row body); -> the
    row's y and its own aux (the step pmeans the rows').  ``stats``: a
    list that gets {row, model, experts, local_pairs, kept} a body (a
    host read each)."""
    from repro_torch.launch.mesh import all_gather, axis_index, pmean, psum
    from repro_torch.sharding.specs import P, Placed, place_tensor

    if tuple(dp_axes) != ("data",):
        raise ValueError(f"dp axes {tuple(dp_axes)}: the port's meshes "
                         "batch over 'data' alone")
    n_data, n_model = mesh.shape["data"], mesh.shape["model"]
    ep = n_experts % n_model == 0
    wi_spec = P("model", "data", None) if ep else P(None, "data", "model")
    wo_spec = P("model", None, "data") if ep else P(None, "model", "data")

    def placed(w, spec):
        return w if isinstance(w, Placed) else place_tensor(w, spec, mesh)

    def body(row, x_loc, router, wi, wg, wo):
        b_loc, s, d = x_loc.shape
        t_loc = b_loc * s
        e = n_experts
        capacity = int(max(top_k, capacity_factor * t_loc * top_k / e))
        ys, aux = [], None
        for j in range(n_model):
            coord = (row, j)
            dev = mesh.device(coord)
            wi_f, wg_f = (all_gather([w.block(wi_spec, (i, j), dev)
                                      for i in range(n_data)],
                                     mesh, "data", 1) for w in (wi, wg))
            wo_f = all_gather([wo.block(wo_spec, (i, j), dev)
                               for i in range(n_data)], mesh, "data", 2)
            e_loc = wi_f.shape[0]
            e0 = axis_index(mesh, "model", coord) * e_loc if ep else 0
            xf = x_loc.to(dev).reshape(t_loc, d)
            gates, weights, experts = route(
                xf, router.block(P(None, None), coord, dev), top_k)
            if aux is None:   # replicated over 'model': one body's
                frac_tokens = torch.zeros(e, dtype=torch.float32, device=dev)
                frac_tokens.index_add_(0, experts.reshape(-1), torch.full(
                    (t_loc * top_k,), 1.0 / (t_loc * top_k),
                    dtype=torch.float32, device=dev))
                aux = (e * torch.sum(frac_tokens * gates.mean(0))).to(
                    x_loc.device)
            xe, slot, keep, token_sorted, w_sorted = _dispatch_local(
                xf, experts, weights, e0, e_loc, capacity)
            h = blocks.silu(torch.bmm(xe, wg_f)) * torch.bmm(xe, wi_f)
            yf = torch.bmm(h, wo_f).reshape(e_loc * capacity, d)
            y_pairs = torch.where(
                keep[:, None], yf[torch.clamp(slot, max=e_loc * capacity - 1)],
                torch.zeros((), dtype=yf.dtype, device=dev))
            contrib = y_pairs * w_sorted[:, None].to(y_pairs.dtype)
            ys.append(_scatter_add_sorted(contrib, token_sorted, t_loc,
                                          top_k))
            if stats is not None:
                local = (experts >= e0) & (experts < e0 + e_loc)
                stats.append({"row": row, "model": j,
                              "experts": [e0, e0 + e_loc],
                              "capacity": capacity,
                              "local_pairs": int(local.sum()),
                              "kept": int(keep.sum())})
        y = psum(ys, mesh, "model", x_loc.device)
        return y.reshape(b_loc, s, d), aux

    def moe(x, router, wi, wg, wo, row: int | None = None):
        router = placed(router, P(None, None))
        wi, wg = placed(wi, wi_spec), placed(wg, wi_spec)
        wo = placed(wo, wo_spec)
        if row is not None:
            return body(row, x, router, wi, wg, wo)
        if x.shape[0] % n_data:
            raise ValueError(f"batch {x.shape[0]} does not divide over "
                             f"'data' ({n_data})")
        b_loc = x.shape[0] // n_data
        outs = [body(d, x.narrow(0, d * b_loc, b_loc).to(
            mesh.device((d, 0))), router, wi, wg, wo)
            for d in range(n_data)]
        y = torch.cat([o[0].to(x.device) for o in outs])
        return y, pmean([o[1] for o in outs], mesh, "data", x.device)

    return moe
