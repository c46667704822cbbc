"""AdamW with global-norm clipping (port of ``repro/optim/adamw.py``).

The reference's own update, not ``torch.optim.AdamW`` (whose decoupled
decay rounds differently): per leaf, in the reference's leaf order and
operation order, all in float32,

    g ← g·min(1, clip/(‖g‖ + 1e-9));  m ← b1·m + (1−b1)·g;
    v ← b2·v + (1−b2)·g·g;  c_i = 1 − b_i^count (a float32 power);
    p ← p − lr·((m/c1)/(√(v/c2) + eps) + wd·p).

The update is functional, as the reference's: it returns new tensors
(no graph) and leaves its arguments alone.  Nothing is read back to
the host.  With ``master_weights`` the state holds a float32 master
copy of the params (``state["master"]``), which is what the update
reads and writes; the params the step returns are the master cast to
their own dtype (bf16 compute params).
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.utils.trees import leaves, tree_map, unflatten_like


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    # keep compute params in bf16 and the float32 master copy in the
    # optimizer state (the reference's §Perf I2)
    master_weights: bool = False


def init_opt_state(params, master_weights: bool = False) -> dict:
    """Zero moments shaped like ``params`` and an int32 step count, on
    the params' device; with ``master_weights`` also ``master``, the
    params as float32 (the caller passes float32 init params and casts
    its compute copy afterwards)."""
    def zeros(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)
    state = {"mu": tree_map(zeros, params), "nu": tree_map(zeros, params),
             "count": torch.zeros((), dtype=torch.int32,
                                  device=leaves(params)[0].device)}
    if master_weights:
        state["master"] = tree_map(
            lambda p: p.detach().to(torch.float32, copy=True), params)
    return state


def global_norm(tree) -> torch.Tensor:
    """√(Σ over leaves, in order, of Σ x²), float32, on the first
    leaf's device (a mesh's pieces may sit on several)."""
    flat = leaves(tree)
    total = 0
    for x in flat:
        total = total + torch.square(x.to(torch.float32)).sum().to(
            flat[0].device)
    return torch.sqrt(total)


@torch.no_grad()
def adamw_update(params, grads, state: dict, cfg: AdamWConfig,
                 lr_scale: float = 1.0):
    """-> (new_params, new_state, metrics {grad_norm, lr}).  With
    ``state["master"]`` the float32 master is the source of truth and
    the new params are the new master in the params' dtype."""
    gnorm = global_norm(grads)
    # a Python number over a tensor would be its reciprocal times the
    # number in PyTorch; the reference divides
    scale = torch.clamp(torch.full_like(gnorm, cfg.clip_norm)
                        / (gnorm + 1e-9), max=1.0)
    count = state["count"] + 1
    c1 = 1.0 - torch.pow(cfg.b1, count.to(torch.float32))
    c2 = 1.0 - torch.pow(cfg.b2, count.to(torch.float32))
    lr = cfg.lr * lr_scale

    def upd(p, g, m, v, master):
        dev = g.device
        g = g.to(torch.float32) * scale.to(dev)
        m = cfg.b1 * m + (1 - cfg.b1) * g
        v = cfg.b2 * v + (1 - cfg.b2) * g * g
        mh = m / c1.to(dev)
        vh = v / c2.to(dev)
        src = master if master is not None else p.detach().to(torch.float32)
        step = mh / (torch.sqrt(vh) + cfg.eps) + cfg.weight_decay * src
        new_master = src - lr * step
        return new_master.to(p.dtype), m, v, new_master

    flat_p = leaves(params)
    flat_w = (leaves(state["master"]) if "master" in state
              else [None] * len(flat_p))
    out = [upd(*xs) for xs in zip(flat_p, leaves(grads), leaves(state["mu"]),
                                  leaves(state["nu"]), flat_w)]
    new_p = unflatten_like(params, [o[0] for o in out])
    new_state = {"mu": unflatten_like(params, [o[1] for o in out]),
                 "nu": unflatten_like(params, [o[2] for o in out]),
                 "count": count}
    if "master" in state:
        new_state["master"] = unflatten_like(params, [o[3] for o in out])
    return new_p, new_state, {"grad_norm": gnorm, "lr": lr}
