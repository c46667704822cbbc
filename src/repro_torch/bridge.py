"""Weights carried across between the reference's pytrees and the port.

The bridge takes and gives numpy only, so it imports no JAX: callers
holding JAX arrays pass ``jax.device_get(tree)``.  The one layout move
is the conv weights: the reference keeps HWIO ``(k, k, cin, cout)``,
the port OIHW ``(cout, cin, k, k)``; biases and the Bayesian head's
``mu``/``rho`` pass through.  A transformer LM's params keep the
reference's tree and stacked layout as they are.  A chip instance crosses as the dict of
numpy arrays its ``to_tree`` gives, a deployed serving head as its
arrays, an AdamW state as its two moment trees (laid out like the
params), its int32 count and, with master weights, its float32 master
tree (a gradient-compression error state is laid out like the params
and crosses as they do), mission worlds as their arrays and, optionally, the reference's
rendered exposures.  numpy has no bfloat16 of its own: a bfloat16 array
of the reference (``ml_dtypes``' type, whose name is ``bfloat16``)
crosses by its 16-bit patterns, and ``to_numpy`` widens a bfloat16
tensor to float32 (exactly).
"""

from __future__ import annotations

import numpy as np
import torch


def params_from_jax(tree: dict, device="cpu") -> dict:
    """SAR CNN params, reference layout (numpy) -> port params."""
    def t(a):
        return torch.as_tensor(np.array(a, copy=True), device=device)
    return {
        "convs": [{"w": t(np.transpose(np.asarray(c["w"]), (3, 2, 0, 1))),
                   "b": t(c["b"])} for c in tree["convs"]],
        "head": {k: t(v) for k, v in tree["head"].items()},
    }


def params_to_jax(params: dict) -> dict:
    """Port params -> the reference's layout as numpy (inverse of
    ``params_from_jax``)."""
    return {
        "convs": [{"w": np.transpose(to_numpy(c["w"]), (2, 3, 1, 0)),
                   "b": to_numpy(c["b"])} for c in params["convs"]],
        "head": to_numpy(params["head"]),
    }


def lm_params_from_jax(tree: dict, device="cpu") -> dict:
    """LM params of the reference's ``init_transformer`` or
    ``init_ssm_lm`` (numpy) -> the port's: the same tree and layout
    (blocks and mamba layers stacked on a leading layer axis, the
    hybrid's shared block without one; whisper's ``encoder`` subtree,
    learned ``pos_embed`` tables and decoder ``xattn``/``lnx``/``lnx_b``
    leaves, the VLM's ``blocks_cross``), as tensors."""
    if isinstance(tree, dict):
        return {k: lm_params_from_jax(v, device) for k, v in tree.items()}
    arr = np.array(tree, copy=True)
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(
            torch.bfloat16).to(device)
    return torch.as_tensor(arr, device=device)


def lm_params_to_jax(params: dict) -> dict:
    """Port LM params -> the reference's tree as numpy (inverse of
    ``lm_params_from_jax``)."""
    return to_numpy(params)


def opt_state_from_jax(state: dict, device="cpu") -> dict:
    """The reference's ``init_opt_state``/``adamw_update`` state (numpy)
    of SAR CNN params -> the port's (``optim.adamw``)."""
    return {"mu": params_from_jax(state["mu"], device),
            "nu": params_from_jax(state["nu"], device),
            "count": torch.tensor(np.asarray(state["count"]),
                                  dtype=torch.int32, device=device)}


def opt_state_to_jax(state: dict) -> dict:
    """Inverse of ``opt_state_from_jax``."""
    return {"mu": params_to_jax(state["mu"]),
            "nu": params_to_jax(state["nu"]),
            "count": np.asarray(to_numpy(state["count"]), np.int32)}


def lm_opt_state_from_jax(state: dict, device="cpu") -> dict:
    """The reference's AdamW state of LM params (numpy: ``mu``, ``nu``,
    ``count`` and, with master weights, ``master``) -> the port's, each
    tree in ``lm_params_from_jax``'s layout."""
    out = {k: lm_params_from_jax(state[k], device)
           for k in ("mu", "nu", "master") if k in state}
    out["count"] = torch.tensor(np.asarray(state["count"]),
                                dtype=torch.int32, device=device)
    return out


def lm_opt_state_to_jax(state: dict) -> dict:
    """Inverse of ``lm_opt_state_from_jax`` (numpy)."""
    out = {k: to_numpy(state[k]) for k in ("mu", "nu", "master")
           if k in state}
    out["count"] = np.asarray(to_numpy(state["count"]), np.int32)
    return out


def instance_from_tree(tree: dict):
    """The reference's ``ChipInstance.to_tree()`` (numpy) -> the port's
    ``hw.ChipInstance``, field for field."""
    from repro_torch.hw.instance import ChipInstance
    return ChipInstance.from_tree(tree)


def head_from_jax(head: dict) -> dict:
    """A deployed serving head of the reference (``mu_prime``,
    ``sigma``, ``sigma_basis``…; numpy) -> CPU tensors (the engine
    moves them to its device)."""
    return {k: torch.tensor(np.asarray(v)) for k, v in head.items()}


def worlds_from_jax(worlds: dict, exposures=None) -> dict:
    """The reference's stacked mission worlds (numpy ``victims``,
    ``severity``, ``seed`` [E, ...]) -> the port's, on the host.
    ``exposures``: the reference's rendered images [E, n_cells, n_looks,
    H, W, 1] (its ``observe_cells`` at every cell and look), which the
    port's ``observe_cells`` then reads instead of rendering."""
    out = {"victims": torch.tensor(np.asarray(worlds["victims"], bool)),
           "severity": torch.tensor(np.asarray(worlds["severity"],
                                               np.float32)),
           "seed": torch.tensor(np.asarray(worlds["seed"], np.int64))}
    if exposures is not None:
        out["exposures"] = torch.tensor(np.asarray(exposures, np.float32))
    return out


def to_numpy(tree):
    """Tensors (nested in dicts/lists/tuples) -> numpy arrays."""
    if isinstance(tree, torch.Tensor):
        t = tree.detach().cpu()
        return (t.to(torch.float32) if t.dtype == torch.bfloat16
                else t).numpy()
    if isinstance(tree, dict):
        return {k: to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_numpy(v) for v in tree)
    return tree
