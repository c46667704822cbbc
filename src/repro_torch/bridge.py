"""Weights carried across between the reference's pytrees and the port.

The bridge takes and gives numpy only, so it imports no JAX: callers
holding JAX arrays pass ``jax.device_get(tree)``.  The one layout move
is the conv weights: the reference keeps HWIO ``(k, k, cin, cout)``,
the port OIHW ``(cout, cin, k, k)``; biases and the Bayesian head's
``mu``/``rho`` pass through.  A chip instance crosses as the dict of
numpy arrays its ``to_tree`` gives, a deployed serving head as its
arrays.
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


def to_numpy(tree):
    """Tensors (nested in dicts/lists/tuples) -> numpy arrays."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy()
    if isinstance(tree, dict):
        return {k: to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_numpy(v) for v in tree)
    return tree
