"""Sharding rules and placement over a device mesh (port of
``repro/sharding/specs.py``).

Mesh axes ('data', 'model') (the reference's multi-pod 'pod' axis is
read where a mesh has one).  The rules are the reference's, copied:

  * batch dims            -> the DP axes ('pod', 'data')
  * weight "in" dims      -> 'data'   (FSDP: weights and Adam moments)
  * weight "out"/TP dims  -> 'model'  (heads, d_ff, experts, vocab)
  * KV-cache sequence dim -> 'model'  (SP)
  * SSM state             -> heads (or headdim) on 'model'

A dim is sharded only when the axis size divides it (``_ok``); else the
next candidate, then replication.  A spec is a ``PartitionSpec``: one
axis name, a tuple of names or None per dim, the reference's
``jax.sharding.PartitionSpec`` as data (a one-name tuple normalized to
the name, as JAX does).

``place(tree, specs, mesh)`` stands where the reference's
``to_named`` + ``jax.device_put`` do: each tensor becomes a ``Placed``,
the grid of its local pieces, one a mesh coordinate.  A piece is a view
of the tensor moved to its coordinate's device, so coordinates on the
tensor's own device (a mesh may repeat a device) add no bytes, and
coordinates that hold the same slice on the same device share one
piece.  ``gather(tree)`` assembles each ``Placed`` whole again.
"""

from __future__ import annotations

import re
from typing import Any

import torch

from repro_torch.launch.mesh import as_device
from repro_torch.utils.trees import tree_map, tree_map_with_name


class PartitionSpec:
    """One entry a dim: None, an axis name or a tuple of axis names."""

    def __init__(self, *dims):
        self._dims = tuple(
            (d[0] if len(d) == 1 else tuple(d))
            if isinstance(d, (tuple, list)) else d for d in dims)

    def __iter__(self):
        return iter(self._dims)

    def __len__(self) -> int:
        return len(self._dims)

    def __getitem__(self, i):
        return self._dims[i]

    def __eq__(self, other) -> bool:
        return isinstance(other, PartitionSpec) and self._dims == other._dims

    def __hash__(self) -> int:
        return hash(self._dims)

    def __repr__(self) -> str:
        return f"PartitionSpec{self._dims!r}"

    def padded(self, ndim: int) -> "PartitionSpec":
        """The spec with None for the dims it leaves out."""
        return PartitionSpec(*self._dims, *([None] * (ndim - len(self))))


P = PartitionSpec


def _ndim(leaf) -> int:
    return len(leaf.shape) if hasattr(leaf, "shape") else 0


def _axis_size(mesh, axis) -> int:
    if axis is None:
        return 1
    if isinstance(axis, (tuple, list)):
        out = 1
        for a in axis:
            out *= mesh.shape[a]
        return out
    return mesh.shape[axis]


def dp_axes(mesh):
    """The data-parallel batch axes present in this mesh."""
    return ("pod", "data") if "pod" in mesh.axis_names else ("data",)


def _ok(dim: int, mesh, axis) -> bool:
    return dim % _axis_size(mesh, axis) == 0


def _spec2(shape, mesh, in_axis="data", out_axis="model", lead=0):
    """[lead..., in, out] weight spec with divisibility fallback."""
    dims = [None] * lead
    d_in, d_out = shape[lead], shape[lead + 1]
    dims.append(in_axis if _ok(d_in, mesh, in_axis) else None)
    dims.append(out_axis if _ok(d_out, mesh, out_axis) else None)
    return P(*dims)


_STACKED = re.compile(r"(^|/)(blocks|blocks_cross|mamba|encoder/blocks)/")


def stacked(name: str) -> bool:
    """Whether the leaf at slash path ``name`` stacks layers on its
    leading dim."""
    return bool(_STACKED.search(name))


# ----------------------------------------------------------------------
# Parameters
# ----------------------------------------------------------------------
def param_spec_for(name: str, shape: tuple, mesh) -> P:
    """Single-leaf rule.  ``name`` is the slash path in the params tree;
    a leading dim may be a stacked layer axis (handled via ``lead``)."""
    lead = 1 if stacked(name) else 0
    base = name.rsplit("/", 1)[-1]

    # --- MoE experts -------------------------------------------------
    if re.search(r"moe/(wi|wg|wo)$", name):
        e, d1, d2 = shape[lead], shape[lead + 1], shape[lead + 2]
        if _ok(e, mesh, "model"):                 # expert parallelism
            dims = [None] * lead + ["model",
                                    "data" if _ok(d1, mesh, "data") else None,
                                    None]
        elif base == "wo":                        # TP inside experts [E, F, D]
            dims = [None] * lead + [None,
                                    "model" if _ok(d1, mesh, "model") else None,
                                    "data" if _ok(d2, mesh, "data") else None]
        else:                                     # [E, D, F]
            dims = [None] * lead + [None,
                                    "data" if _ok(d1, mesh, "data") else None,
                                    "model" if _ok(d2, mesh, "model") else None]
        return P(*dims)
    if base == "router":
        return _spec2(shape, mesh, "data", None, lead)

    # --- attention / mlp ---------------------------------------------
    if base in ("wq", "wk", "wv", "wi", "wg"):
        return _spec2(shape, mesh, "data", "model", lead)
    if base in ("wo", "out_proj"):
        return _spec2(shape, mesh, "model", "data", lead)
    if base in ("bq", "bk", "bv", "bi"):
        d = shape[lead]
        return P(*([None] * lead + ["model" if _ok(d, mesh, "model") else None]))

    # --- embeddings / head -------------------------------------------
    if base == "embed":
        return _spec2(shape, mesh, "model", "data", 0)     # [V, D]
    if name.startswith("head/") or "/head/" in name:
        return _spec2(shape, mesh, "data", "model", 0)     # [D, Vp]
    if base == "pos_embed":
        s, d = shape
        return P("data" if _ok(s, mesh, "data") else None, None)

    # --- mamba ---------------------------------------------------------
    if base == "in_proj":
        return _spec2(shape, mesh, "data", "model", lead)
    if base == "conv_w":
        c = shape[lead]
        return P(*([None] * lead
                   + ["model" if _ok(c, mesh, "model") else None, None]))
    if base in ("conv_b", "norm"):
        c = shape[lead]
        return P(*([None] * lead + ["model" if _ok(c, mesh, "model") else None]))
    if base in ("shared_w_in", "shared_w_out"):
        return _spec2(shape, mesh, "data", "model", 0)

    # --- everything else (norm scales, small vectors): replicate ------
    return P(*([None] * len(shape)))


def param_specs(abstract_params: Any, mesh):
    return tree_map_with_name(
        lambda name, leaf: param_spec_for(name, tuple(leaf.shape), mesh),
        abstract_params)


def opt_state_specs(abstract_opt: Any, mesh):
    """Adam moments (and the master copy) shard exactly like their
    parameters; the count is replicated."""
    def rule(name, leaf):
        if name.endswith("count") or _ndim(leaf) == 0:
            return P()
        # strip the leading "mu/" or "nu/" prefix to reuse param rules
        stripped = name.split("/", 1)[1] if "/" in name else name
        return param_spec_for(stripped, tuple(leaf.shape), mesh)
    return tree_map_with_name(rule, abstract_opt)


# ----------------------------------------------------------------------
# Activations / batches / caches
# ----------------------------------------------------------------------
def _batch_axis(b: int, mesh):
    dp = dp_axes(mesh)
    return dp if _ok(b, mesh, dp) else (
        "data" if _ok(b, mesh, "data") else None)


def batch_specs(abstract_batch: Any, mesh):
    """tokens/labels [B, S] -> P(dp, None); stub embeddings likewise."""
    def rule(name, leaf):
        return P(_batch_axis(leaf.shape[0], mesh),
                 *([None] * (_ndim(leaf) - 1)))
    return tree_map_with_name(rule, abstract_batch)


def cache_specs(abstract_cache: Any, mesh):
    """KV caches: batch->dp, sequence->'model' (SP); SSM state: heads (or
    headdim) -> 'model'; conv state: channels -> 'model'.  The port's
    host-int ``pos`` is a scalar (P())."""
    def rule(name, leaf):
        if _ndim(leaf) == 0:      # pos counter
            return P()
        shape = leaf.shape
        base = name.rsplit("/", 1)[-1]
        if base in ("k", "v", "xk", "xv"):
            # [L, B, S, Hkv, dh] (or [G, ...])
            _, b, s, _, _ = shape
            sax = "model" if _ok(s, mesh, "model") else None
            return P(None, _batch_axis(b, mesh), sax, None, None)
        if base == "ssm":
            # [L, B, H, Pd, N]
            _, b, h, pd, _ = shape
            bax = _batch_axis(b, mesh)
            if _ok(h, mesh, "model"):
                return P(None, bax, "model", None, None)
            if _ok(pd, mesh, "model"):
                return P(None, bax, None, "model", None)
            return P(None, bax, None, None, None)
        if base == "conv":
            # [L, B, C, K-1]
            _, b, c, _ = shape
            cax = "model" if _ok(c, mesh, "model") else None
            return P(None, _batch_axis(b, mesh), cax, None)
        return P(*([None] * _ndim(leaf)))
    return tree_map_with_name(rule, abstract_cache)


def logits_spec(mesh, batch: int, with_samples: bool = True) -> P:
    """[R, B, Vp] logit samples: batch on dp, vocab on model."""
    dp = dp_axes(mesh)
    bax = dp if batch % _axis_size(mesh, dp) == 0 else (
        "data" if batch % _axis_size(mesh, "data") == 0 else None)
    if with_samples:
        return P(None, bax, "model")
    return P(bax, "model")


def validate_specs(abstract_tree: Any, specs: Any, mesh) -> list[str]:
    """Return a list of (path, problem) strings for non-divisible specs."""
    flat_specs: dict = {}
    tree_map_with_name(lambda name, s: flat_specs.setdefault(name, s),
                       specs)
    problems: list[str] = []

    def rule(name, leaf):
        spec = flat_specs[name]
        for dim, axis in zip(tuple(leaf.shape) if _ndim(leaf) else (),
                             tuple(spec) + (None,) * _ndim(leaf)):
            if axis is not None and dim % _axis_size(mesh, axis) != 0:
                problems.append(f"{name}: dim {dim} not divisible by {axis}")
        return leaf

    tree_map_with_name(rule, abstract_tree)
    return problems


# ----------------------------------------------------------------------
# Placement
# ----------------------------------------------------------------------
def _key(spec: P, mesh, coord) -> tuple:
    """The slice index a dim at mesh coordinate ``coord``: the
    coordinate's place along the dim's axes, row-major over them."""
    at = dict(zip(mesh.axis_names, coord))
    out = []
    for axis in spec:
        k = 0
        for a in (() if axis is None else
                  (axis,) if isinstance(axis, str) else axis):
            k = k * mesh.shape[a] + at[a]
        out.append(k)
    return tuple(out)


def _cut(x: torch.Tensor, spec: P, mesh, key: tuple) -> torch.Tensor:
    """The slice ``key`` of ``x`` under ``spec`` (a view)."""
    for dim, k in enumerate(key):
        n = _axis_size(mesh, spec[dim])
        if n > 1:
            size = x.shape[dim] // n
            x = x.narrow(dim, k * size, size)
    return x


class Placed:
    """A global tensor of ``shape`` as the grid of its local pieces:
    ``pieces[coord]`` is the slice ``spec`` gives mesh coordinate
    ``coord``, on that coordinate's device.  ``row`` binds it to one
    data row's shard body (the device its gathers land on is then
    ``mesh.device((row, 0))``); ``keep`` tells ``models/transformer.
    _layer`` to hand it on placed (a sharded path reads it piece by
    piece) instead of gathering it."""

    def __init__(self, shape, dtype, spec: P, mesh, pieces: dict,
                 row: int | None = None, keep: bool = False):
        self.shape = torch.Size(shape)
        self.dtype = dtype
        self.spec = spec.padded(len(self.shape))
        self.mesh = mesh
        self.pieces = pieces
        self.row = row
        self.keep = keep

    @property
    def ndim(self) -> int:
        return len(self.shape)

    @property
    def home(self) -> torch.device:
        if self.row is None:
            return self.mesh.first_device
        return self.mesh.device((self.row,) + (0,) * (
            len(self.mesh.axis_names) - 1))

    def __repr__(self) -> str:
        return (f"Placed({tuple(self.shape)}, {self.dtype}, {self.spec}, "
                f"{self.mesh.shape}, {len(self.distinct())} pieces)")

    def _like(self, pieces: dict, shape=None, spec=None, dtype=None):
        return Placed(self.shape if shape is None else shape,
                      self.dtype if dtype is None else dtype,
                      self.spec if spec is None else spec, self.mesh,
                      pieces, self.row, self.keep)

    def _map(self, fn, **kw) -> "Placed":
        """``fn`` over each distinct piece once."""
        done: dict = {}
        out = {}
        for c, t in self.pieces.items():
            if id(t) not in done:
                done[id(t)] = fn(t)
            out[c] = done[id(t)]
        return self._like(out, **kw)

    def distinct(self) -> list:
        """[(coord, piece)] for each distinct piece, row-major."""
        seen, out = set(), []
        for c, t in self.pieces.items():
            if id(t) not in seen:
                seen.add(id(t))
                out.append((c, t))
        return out

    def canonical(self) -> dict:
        """{slice key: the piece at the first coordinate holding it}."""
        out: dict = {}
        for c, t in self.pieces.items():
            out.setdefault(_key(self.spec, self.mesh, c), t)
        return out

    def with_canonical(self, new: dict) -> "Placed":
        """The same placement with each slice's piece ``new[key]`` (on
        its first holder's device) copied to the other holders'
        devices (the same tensor where the device repeats)."""
        cache: dict = {}
        out = {}
        for c in self.pieces:
            key, dev = _key(self.spec, self.mesh, c), self.mesh.device(c)
            if (key, dev) not in cache:
                cache[(key, dev)] = new[key].to(dev)
            out[c] = cache[(key, dev)]
        return self._like(out, dtype=next(iter(new.values())).dtype)

    def bind(self, row: int, keep: bool) -> "Placed":
        out = self._like(self.pieces)
        out.row, out.keep = row, keep
        return out

    def layer(self, l: int) -> "Placed":
        """Layer ``l`` of a stacked leaf (its lead dim unsharded)."""
        if self.spec[0] is not None:
            raise ValueError(f"layer of a leaf sharded on its lead dim "
                             f"({self.spec})")
        return self._map(lambda t: t[l], shape=self.shape[1:],
                         spec=P(*tuple(self.spec)[1:]))

    def to(self, dtype) -> "Placed":
        """Each piece cast to ``dtype`` (a no-op where it already is)."""
        return self._map(lambda t: t.to(dtype), dtype=dtype)

    def gather(self, device=None) -> torch.Tensor:
        """The whole tensor on ``device`` (default ``home``): each
        slice from a holder on that device where there is one,
        concatenated over the sharded dims in order."""
        dev = self.home if device is None else as_device(device)
        pick: dict = {}
        for c, t in self.pieces.items():
            key = _key(self.spec, self.mesh, c)
            if key not in pick or (pick[key].device != dev
                                   and t.device == dev):
                pick[key] = t
        sharded = [d for d in range(self.ndim)
                   if _axis_size(self.mesh, self.spec[d]) > 1]

        def rec(i: int, key: list):
            if i == len(sharded):
                return pick[tuple(key)].to(dev)
            dim = sharded[i]
            parts = []
            for k in range(_axis_size(self.mesh, self.spec[dim])):
                key[dim] = k
                parts.append(rec(i + 1, key))
            key[dim] = 0
            return torch.cat(parts, dim)
        return rec(0, [0] * self.ndim)

    def row_part(self, dim: int, row: int, n_rows: int) -> torch.Tensor:
        """Data row ``row`` of ``n_rows`` equal rows of dim ``dim`` (a
        batch dim), whole on the row's device: its pieces when ``dim``
        is cut over 'data' into those rows, else cut from the gathered
        tensor."""
        dev = self.mesh.device((row,) + (0,) * (len(self.mesh.axis_names)
                                                - 1))
        if n_rows == 1:
            return self.gather(dev)
        if self.spec[dim] == "data" and n_rows == self.mesh.shape["data"]:
            i = self.mesh.axis_names.index("data")
            shape = list(self.shape)
            shape[dim] //= n_rows
            inner = P(*(None if k == dim else a
                        for k, a in enumerate(self.spec)))
            return Placed(shape, self.dtype, inner, self.mesh,
                          {c: t for c, t in self.pieces.items()
                           if c[i] == row}).gather(dev)
        size = self.shape[dim] // n_rows
        return self.gather(dev).narrow(dim, row * size, size)

    def block(self, spec: P, coord, device) -> torch.Tensor:
        """The slice ``spec`` gives ``coord``, on ``device``: this
        placement's own piece when ``spec`` is its spec, else cut from
        the gathered tensor (a reshard)."""
        spec = spec.padded(self.ndim)
        if spec == self.spec:
            return self.pieces[tuple(coord)].to(device)
        return _cut(self.gather(device), spec, self.mesh,
                    _key(spec, self.mesh, coord))


def place_tensor(x, spec: P, mesh) -> "Placed":
    """``x`` (a tensor, or a ``Placed`` to re-place) as a ``Placed``
    under ``spec`` on ``mesh``; a non-tensor leaf (the cache's host-int
    ``pos``) is returned as it is."""
    if isinstance(x, Placed):
        if x.mesh is mesh and x.spec == spec.padded(x.ndim):
            return x
        x = x.gather(mesh.first_device)
    if not isinstance(x, torch.Tensor):
        return x
    spec = spec.padded(x.ndim)
    for dim, axis in enumerate(spec):
        if x.shape[dim] % _axis_size(mesh, axis):
            raise ValueError(f"dim {dim} of {tuple(x.shape)} does not "
                             f"divide over {axis!r} ({spec})")
    cache: dict = {}
    pieces = {}
    for c in mesh.coords():
        key, dev = _key(spec, mesh, c), mesh.device(c)
        if (key, dev) not in cache:
            cache[(key, dev)] = _cut(x, spec, mesh, key).to(dev)
        pieces[c] = cache[(key, dev)]
    return Placed(x.shape, x.dtype, spec, mesh, pieces)


def place_rows(parts: list, dim: int, spec: P, mesh) -> Placed:
    """The tensor whose equal data rows along ``dim`` are ``parts``
    (each on its row's device, a shard body's output), placed under
    ``spec``: a coordinate's piece is cut from its own row's part when
    ``dim`` is cut over 'data' into those rows, else from their
    concatenation on the mesh's first device."""
    spec = spec.padded(parts[0].ndim)
    n = mesh.shape["data"]
    if len(parts) == 1 or spec[dim] != "data" or len(parts) != n:
        whole = parts[0] if len(parts) == 1 else torch.cat(
            [t.to(mesh.first_device) for t in parts], dim)
        return place_tensor(whole, spec, mesh)
    i = mesh.axis_names.index("data")
    inner = P(*(None if k == dim else a for k, a in enumerate(spec)))
    shape = list(parts[0].shape)
    shape[dim] *= n
    cache: dict = {}
    pieces = {}
    for c in mesh.coords():
        key = (c[i], _key(inner, mesh, c), mesh.device(c))
        if key not in cache:
            cache[key] = _cut(parts[c[i]], inner, mesh, key[1]).to(key[2])
        pieces[c] = cache[key]
    return Placed(shape, parts[0].dtype, spec, mesh, pieces)


def place(tree: Any, specs: Any, mesh) -> Any:
    """Each leaf of ``tree`` placed by the spec at its path: ``specs``
    is a tree of specs shaped like ``tree`` or a rule such as
    ``param_specs`` (called as ``specs(tree, mesh)``, keyed by the
    reference's slash paths)."""
    if callable(specs):
        specs = specs(tree, mesh)
    return tree_map(lambda x, s: place_tensor(x, s, mesh), tree, specs)


def gather(tree: Any, device=None) -> Any:
    """Each ``Placed`` leaf whole again (on ``device``, default its
    mesh's first device); other leaves as they are."""
    return tree_map(lambda x: x.gather(device) if isinstance(x, Placed)
                    else x, tree)
