"""Elastic scaling: re-mesh live state when the device pool changes
(port of ``repro/runtime/elastic.py``).

When devices are lost (or added) the mesh shape changes.  The recovery
path:

  1. ``shrink_mesh``/``make_elastic_mesh`` builds a new mesh over the
     surviving devices (keeping the 'model' extent if possible: TP
     degree is baked into weight shapes' divisibility, DP is not);
  2. ``remesh_tree`` re-places a live tree on the new mesh with freshly
     resolved specs (the divisibility-aware rules in
     ``sharding/specs`` re-evaluate against the new axis sizes);
  3. the launcher builds its step for the new mesh and continues from
     the in-memory state (no checkpoint round trip when the state
     survived; else ``ckpt.restore`` provides it).

A mesh may repeat a device (``launch/mesh``), so a lost device is named
by its mesh coordinates, not by the device.
"""

from __future__ import annotations

import torch

from repro_torch.launch.mesh import DeviceMesh, make_mesh
from repro_torch.sharding import specs as S


def make_elastic_mesh(devices=None,
                      model_parallel: int | None = None) -> DeviceMesh:
    """Mesh over a device list (default: every visible card):
    ('data', 'model'), 'model' the first of 16, 8, 4, 2 that divides
    the count (else 1) unless given."""
    devices = list(devices if devices is not None else [
        torch.device("cuda", i) for i in range(torch.cuda.device_count())])
    n = len(devices)
    if model_parallel is None:
        model_parallel = next((c for c in (16, 8, 4, 2) if n % c == 0), 1)
    if n % model_parallel:
        raise ValueError(f"{n} devices do not divide into model-parallel "
                         f"groups of {model_parallel}")
    return make_mesh((n // model_parallel, model_parallel),
                     ("data", "model"), devices)


def shrink_mesh(mesh: DeviceMesh, lost: set) -> DeviceMesh:
    """Rebuild the mesh without the coordinates in ``lost`` (same axis
    names): the survivors in row-major order, 'model' halved until it
    divides their count, the remainder dropped."""
    survivors = [mesh.device(c) for c in mesh.coords()
                 if tuple(c) not in {tuple(x) for x in lost}]
    model = mesh.shape.get("model", 1)
    while model > 1 and len(survivors) % model != 0:
        model //= 2
    usable = (len(survivors) // model) * model
    return make_elastic_mesh(survivors[:usable], model_parallel=model)


def remesh_tree(tree, new_mesh: DeviceMesh, spec_fn=S.param_specs):
    """Re-place a live tree (placed or whole) on a new mesh: each leaf
    gathered on the new mesh's first device and placed by ``spec_fn``'s
    specs for the new axis sizes.  Values move bit for bit."""
    return S.place(tree, spec_fn(tree, new_mesh), new_mesh)


def remesh_train_state(params, opt_state, new_mesh: DeviceMesh):
    params = remesh_tree(params, new_mesh, S.param_specs)
    opt_state = remesh_tree(opt_state, new_mesh, S.opt_state_specs)
    return params, opt_state
