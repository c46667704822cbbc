"""AdamW with global-norm clipping (port of ``repro/optim/adamw.py``).

The reference's own update, not ``torch.optim.AdamW`` (whose decoupled
decay rounds differently): per leaf, in the reference's leaf order and
operation order, all in float32,

    g ← g·min(1, clip/(‖g‖ + 1e-9));  m ← b1·m + (1−b1)·g;
    v ← b2·v + (1−b2)·g·g;  c_i = 1 − b_i^count (a float32 power);
    p ← p − lr·((m/c1)/(√(v/c2) + eps) + wd·p).

The update is functional, as the reference's: it returns new tensors
(no graph) and leaves its arguments alone.  Nothing is read back to
the host.  The LM trainer's bf16 master weights are not ported.
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


def init_opt_state(params) -> dict:
    """Zero moments shaped like ``params`` and an int32 step count, on
    the params' device."""
    def zeros(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)
    return {"mu": tree_map(zeros, params), "nu": tree_map(zeros, params),
            "count": torch.zeros((), dtype=torch.int32,
                                 device=leaves(params)[0].device)}


def global_norm(tree) -> torch.Tensor:
    """√(Σ over leaves, in order, of Σ x²), float32."""
    total = 0
    for x in leaves(tree):
        total = total + torch.square(x.to(torch.float32)).sum()
    return torch.sqrt(total)


@torch.no_grad()
def adamw_update(params, grads, state: dict, cfg: AdamWConfig,
                 lr_scale: float = 1.0):
    """-> (new_params, new_state, metrics {grad_norm, lr})."""
    gnorm = global_norm(grads)
    # a Python number over a tensor would be its reciprocal times the
    # number in PyTorch; the reference divides
    scale = torch.clamp(torch.full_like(gnorm, cfg.clip_norm)
                        / (gnorm + 1e-9), max=1.0)
    count = state["count"] + 1
    c1 = 1.0 - torch.pow(cfg.b1, count.to(torch.float32))
    c2 = 1.0 - torch.pow(cfg.b2, count.to(torch.float32))
    lr = cfg.lr * lr_scale

    def upd(p, g, m, v):
        g = g.to(torch.float32) * scale
        m = cfg.b1 * m + (1 - cfg.b1) * g
        v = cfg.b2 * v + (1 - cfg.b2) * g * g
        mh = m / c1
        vh = v / c2
        src = p.detach().to(torch.float32)
        step = mh / (torch.sqrt(vh) + cfg.eps) + cfg.weight_decay * src
        return (src - lr * step).to(p.dtype), m, v

    out = [upd(*xs) for xs in zip(leaves(params), leaves(grads),
                                  leaves(state["mu"]), leaves(state["nu"]))]
    new_p = unflatten_like(params, [o[0] for o in out])
    new_state = {"mu": unflatten_like(params, [o[1] for o in out]),
                 "nu": unflatten_like(params, [o[2] for o in out]),
                 "count": count}
    return new_p, new_state, {"grad_norm": gnorm, "lr": lr}
