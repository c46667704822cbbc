"""The (data, model) device mesh as a grid of torch devices (port of
``repro/launch/mesh.py``).

The reference drives a ``jax.sharding.Mesh`` from one Python process:
GSPMD places arrays by ``sharding/specs`` and its few explicit
collectives sit at the start or the end of a ``shard_map`` body (an
FSDP ``all_gather`` of weights on entry, a ``psum``/``pmean`` on exit).
The port is single-controller too and needs no process group: a mesh
is a grid of ``torch.device`` with axis names, a placed tensor is the
grid of its local pieces (``sharding/specs.Placed``), and a shard body
runs once per mesh coordinate in one Python thread, its pieces as
lists.  A gather is a concatenation of pieces, a psum a sum of
partials, both on the body's device; autograd through the cross-device
copies gives a gradient's reduce-scatter.  On several cards the
per-device launches are asynchronous and overlap.

A mesh may repeat a device: ``make_mesh((2, 2), devices=["cuda:0"] *
4)`` puts four coordinates on one card, so one card checks the sharded
paths' arithmetic (not their scaling), and ``["cpu"] * k`` serves the
tests.  ``mesh.shape[axis]`` plays the reference's axis size.

What has no twin: ``make_production_mesh`` (16×16 and 2×16×16 TPU
pods of 256–512 chips, whose 'pod' axis crosses the inter-pod network)
and the version shims ``make_mesh_compat``/``mesh_context``/
``shard_map_compat``/``abstract_mesh_or``, which bridge releases of the
XLA API; the port has no XLA program to lower and no ambient mesh (a
step builder passes its mesh down).
"""

from __future__ import annotations

import functools
import itertools

import torch


def as_device(d) -> torch.device:
    """``d`` as a torch device with its index (``"cuda"`` is the
    current card), so that placement compares devices exactly."""
    dev = torch.device(d)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


class DeviceMesh:
    """A grid of torch devices with named axes (``("data", "model")``).
    ``shape`` maps axis -> size, as the reference's ``mesh.shape``;
    ``device(coord)`` is the device at a coordinate (a tuple of ints,
    one an axis); ``coords()`` walks the grid in row-major order."""

    def __init__(self, devices, axis_names: tuple):
        grid = list(devices)
        dims = []
        probe = grid
        while isinstance(probe, (list, tuple)):
            dims.append(len(probe))
            probe = probe[0]
        if len(dims) != len(axis_names):
            raise ValueError(f"a grid of {len(dims)} dims for axes "
                             f"{axis_names}")
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, dims))
        self._grid = {c: as_device(self._at(grid, c)) for c in
                      itertools.product(*(range(n) for n in dims))}

    @staticmethod
    def _at(grid, coord):
        for i in coord:
            grid = grid[i]
        return grid

    @property
    def size(self) -> int:
        return len(self._grid)

    def coords(self) -> list:
        return list(self._grid)

    def device(self, coord) -> torch.device:
        return self._grid[tuple(coord)]

    @property
    def devices(self) -> list:
        """The devices in row-major order (repeats kept)."""
        return list(self._grid.values())

    @property
    def first_device(self) -> torch.device:
        return self._grid[(0,) * len(self.axis_names)]

    def __repr__(self) -> str:
        return (f"DeviceMesh({self.shape}, "
                f"{[str(d) for d in self.devices]})")


def make_mesh(shape: tuple, axes: tuple = ("data", "model"),
              devices=None) -> DeviceMesh:
    """A mesh of ``shape`` over ``devices`` (row-major; a device may
    repeat; default: the visible cards, one a coordinate)."""
    n = functools.reduce(lambda a, b: a * b, shape, 1)
    devs = list(devices) if devices is not None else [
        torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    if len(devs) != n:
        raise ValueError(f"a {tuple(shape)} mesh needs {n} devices, got "
                         f"{len(devs)}")

    def nest(flat, dims):
        if len(dims) == 1:
            return list(flat)
        step = len(flat) // dims[0]
        return [nest(flat[i * step:(i + 1) * step], dims[1:])
                for i in range(dims[0])]
    return DeviceMesh(nest(devs, list(shape)), axes)


def make_debug_mesh(devices=None) -> DeviceMesh:
    """A (data, model) mesh over ``devices`` (default: every visible
    card), the reference's rule: ``model`` is the first of 4, 2, 1 that
    divides the device count."""
    devs = list(devices) if devices is not None else [
        torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    if not devs:
        raise RuntimeError("make_debug_mesh: no CUDA device; pass devices "
                           "(e.g. ['cpu'] * 4)")
    n = len(devs)
    model = next(c for c in (4, 2, 1) if n % c == 0)
    return make_mesh((n // model, model), ("data", "model"), devs)


# ----------------------------------------------------------------------
# Collectives as list operations over a body's pieces
# ----------------------------------------------------------------------
def axis_index(mesh: DeviceMesh, axis: str, coord) -> int:
    """The reference's ``lax.axis_index(axis)`` in the body at
    ``coord``."""
    return tuple(coord)[mesh.axis_names.index(axis)]


def _check(pieces: list, mesh: DeviceMesh, axis: str) -> None:
    if len(pieces) != mesh.shape[axis]:
        raise ValueError(f"{len(pieces)} pieces over axis {axis!r} of "
                         f"size {mesh.shape[axis]}")


def all_gather(pieces: list, mesh: DeviceMesh, axis: str, dim: int,
               device=None) -> torch.Tensor:
    """``lax.all_gather(x, axis, axis=dim, tiled=True)``: the pieces
    along ``axis`` (in axis order) concatenated on ``dim``, on
    ``device`` (default: the first piece's)."""
    _check(pieces, mesh, axis)
    dev = pieces[0].device if device is None else device
    if len(pieces) == 1:
        return pieces[0].to(dev)
    return torch.cat([p.to(dev) for p in pieces], dim)


def psum(pieces: list, mesh: DeviceMesh, axis: str,
         device=None) -> torch.Tensor:
    """``lax.psum(x, axis)``: the partials along ``axis`` added in axis
    order, in their dtype, on ``device`` (default: the first's)."""
    _check(pieces, mesh, axis)
    dev = pieces[0].device if device is None else device
    out = pieces[0].to(dev)
    for p in pieces[1:]:
        out = out + p.to(dev)
    return out


def pmean(pieces: list, mesh: DeviceMesh, axis: str,
          device=None) -> torch.Tensor:
    """``lax.pmean(x, axis)``: ``psum`` over the axis size (a single
    piece is returned as it is)."""
    out = psum(pieces, mesh, axis, device)
    return out if len(pieces) == 1 else out / len(pieces)
