"""Tile compiler (port of ``repro/hw/tilemap.py``).

A chip exposes a finite ``TileGrid`` of 64×64 tiles; the compiler cuts
every layer's weight matrix into tile blocks (K-splits of an output
column stay consecutive and on one shard), places them, time-
multiplexes in passes when the network needs more tiles than the chip
has, and replicates the Bayesian blocks into the last pass's free
tiles.  Serving metrics charge the PLACED blocks (padding waste
included) and report the deployed area and utilization; ``report``
gives the placed network's energy, latency and area
(``core/energy.grid_inference_energy``).

``shard_weights`` cuts a weight matrix into its placed [tile, tile]
blocks and ``reconstruct`` puts them back, an exact round trip, on the
weight's device and in its dtype.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Sequence

import torch

from repro_torch.core import energy
from repro_torch.core.energy import LayerShape


@dataclasses.dataclass(frozen=True)
class TileGrid:
    """Physical tile resources of one chip."""
    rows: int = 8
    cols: int = 8
    tile: int = 64

    @property
    def n_tiles(self) -> int:
        return self.rows * self.cols


@dataclasses.dataclass(frozen=True)
class Placement:
    """One [≤tile, ≤tile] weight block bound to a physical tile."""
    layer: str
    r0: int                 # weight-matrix row (d_in) origin
    c0: int                 # weight-matrix col (d_out) origin
    rows: int
    cols: int
    tile_idx: int           # physical tile
    pass_idx: int           # time-multiplex round
    shard: int = 0          # mesh shard owning this output-column group
    replica: int = 0        # >0: throughput replica of a Bayesian block


@dataclasses.dataclass(frozen=True, eq=False)
class TileProgram:
    grid: TileGrid
    layers: tuple            # (name, LayerShape) pairs, placement order
    placements: tuple        # Placement, ...
    n_shards: int = 1

    def layer_placements(self, name: str, replicas: bool = False):
        return tuple(p for p in self.placements
                     if p.layer == name and (replicas or p.replica == 0))

    @property
    def n_passes(self) -> int:
        return max(p.pass_idx for p in self.placements) + 1

    @property
    def physical_tiles_used(self) -> int:
        return len({p.tile_idx for p in self.placements})

    @property
    def utilization(self) -> float:
        """Mapped bitcells / allocated bitcells (padding waste included)."""
        active = sum(p.rows * p.cols for p in self.placements)
        return active / (len(self.placements) * self.grid.tile**2)

    def replication_factor(self, name: str) -> int:
        """1 + replicas per block: concurrent sample streams for a layer."""
        base = self.layer_placements(name)
        if not base:
            return 0
        return len(self.layer_placements(name, replicas=True)) // len(base)

    def layer_block_counts(self, replicas: bool = False) -> dict:
        """{layer name: placed blocks} in placement (= layer) order;
        primary blocks only unless ``replicas``."""
        out = {name: 0 for name, _ in self.layers}
        for p in self.placements:
            if p.replica and not replicas:
                continue
            out[p.layer] += 1
        return out

    def layer_utilization(self, name: str) -> float:
        """Mapped / allocated bitcells of one layer's primary blocks."""
        ps = self.layer_placements(name)
        active = sum(p.rows * p.cols for p in ps)
        return active / (len(ps) * self.grid.tile**2)

    def det_bayes_blocks(self) -> tuple[int, int]:
        """(deterministic blocks, Bayesian primary blocks): the placed
        counts the energy model takes."""
        shapes = dict(self.layers)
        counts = self.layer_block_counts()
        det = sum(c for n, c in counts.items() if not shapes[n].bayesian)
        bayes = sum(c for n, c in counts.items() if shapes[n].bayesian)
        return det, bayes

    def shard_weights(self, name: str, w: torch.Tensor) -> dict:
        """Dense [d_in, d_out] -> {(pass_idx, tile_idx): [tile, tile]
        block}, zero-padded to the physical tile, primary blocks only,
        on w's device and in its dtype."""
        t = self.grid.tile
        out = {}
        for p in self.layer_placements(name):
            blk = w.new_zeros((t, t))
            blk[:p.rows, :p.cols] = w[p.r0:p.r0 + p.rows,
                                      p.c0:p.c0 + p.cols]
            out[(p.pass_idx, p.tile_idx)] = blk
        return out

    def reconstruct(self, name: str, shards: dict) -> torch.Tensor:
        """Inverse of ``shard_weights``: an exact round trip."""
        ps = self.layer_placements(name)
        d_in = max(p.r0 + p.rows for p in ps)
        d_out = max(p.c0 + p.cols for p in ps)
        w = next(iter(shards.values())).new_zeros((d_in, d_out))
        for p in ps:
            blk = shards[(p.pass_idx, p.tile_idx)]
            w[p.r0:p.r0 + p.rows, p.c0:p.c0 + p.cols] = blk[:p.rows, :p.cols]
        return w

    def report(self, r_samples: int = energy.DEPLOY_R,
               batch: int = 1) -> dict:
        """Energy, latency, area and utilization of the placed network
        (``energy.grid_inference_energy``) and its placement counts.
        Replicas split the R samples over concurrent tiles: the energy
        counts primary blocks, the latency ⌈R / replication⌉."""
        shapes = dict(self.layers)
        det, bayes = self.det_bayes_blocks()
        bayes_passes = {p.pass_idx for p in self.placements
                        if not p.replica and shapes[p.layer].bayesian}
        rep = min((self.replication_factor(n) for n, s in self.layers
                   if s.bayesian), default=0)
        r_latency = math.ceil(r_samples / rep) if rep > 1 else r_samples
        e = energy.grid_inference_energy(
            n_det_tiles=det, n_bayes_tiles=bayes, r_samples=r_samples,
            batch=batch, n_passes=self.n_passes,
            n_bayes_passes=len(bayes_passes),
            physical_tiles=self.physical_tiles_used,
            utilization=self.utilization, r_latency=r_latency)
        e.update(n_blocks=len(self.placements), n_passes=self.n_passes,
                 n_shards=self.n_shards,
                 physical_tiles=self.physical_tiles_used,
                 grid_tiles=self.grid.n_tiles)
        return e


def compile_layer(name: str, shape: LayerShape, grid: TileGrid,
                  seq0: int, n_shards: int = 1) -> tuple[list, int]:
    """Split one [d_in, d_out] layer into placed tile blocks, column-
    major over output-column groups; returns (placements, next_seq)."""
    t = grid.tile
    n_rb = math.ceil(shape.d_in / t)
    n_cb = math.ceil(shape.d_out / t)
    seq = seq0
    out = []
    for cb in range(n_cb):
        shard = (cb * n_shards) // n_cb
        c0 = cb * t
        cols = min(t, shape.d_out - c0)
        for rb in range(n_rb):
            r0 = rb * t
            out.append(Placement(
                layer=name, r0=r0, c0=c0,
                rows=min(t, shape.d_in - r0), cols=cols,
                tile_idx=seq % grid.n_tiles,
                pass_idx=seq // grid.n_tiles,
                shard=shard))
            seq += 1
    return out, seq


def compile_network(layers: Sequence, grid: TileGrid | None = None,
                    n_shards: int = 1, names: Sequence[str] | None = None,
                    replicate_bayesian: bool = True) -> TileProgram:
    """Place a whole network; time-multiplex when it exceeds the grid,
    and replicate Bayesian blocks into the last pass's free tiles."""
    grid = grid or TileGrid()
    names = list(names or (f"layer{i}" for i in range(len(layers))))
    if len(names) != len(set(names)):
        raise ValueError("layer names must be unique")
    placements: list[Placement] = []
    seq = 0
    for name, shape in zip(names, layers):
        ps, seq = compile_layer(name, shape, grid, seq, n_shards)
        placements.extend(ps)
    if replicate_bayesian:
        free = (-seq) % grid.n_tiles
        last_pass = (seq - 1) // grid.n_tiles
        shapes = dict(zip(names, layers))
        bayes = [p for p in placements if shapes[p.layer].bayesian]
        if bayes and free >= len(bayes):
            for rep in range(1, free // len(bayes) + 1):
                for p in bayes:
                    placements.append(dataclasses.replace(
                        p, tile_idx=seq % grid.n_tiles,
                        pass_idx=last_pass, replica=rep))
                    seq += 1
    return TileProgram(grid=grid, layers=tuple(zip(names, layers)),
                       placements=tuple(placements), n_shards=n_shards)


def shard_column_partition(program: TileProgram, name: str) -> dict:
    """{shard: sorted output-column origins}: shards partition a layer's
    output columns, and every K-split of a column group lives on one."""
    out: dict[int, set] = {}
    for p in program.layer_placements(name):
        out.setdefault(p.shard, set()).add(p.c0)
    return {s: sorted(v) for s, v in out.items()}
