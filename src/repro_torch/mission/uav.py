"""UAV fleet model: sectors, kinematics counters and the per-sortie
ledger (port of ``repro/mission/uav.py``).

A drone is four numbers of mutable state (flat cell position, a
path-step counter, cumulative energy spent, cumulative mission time)
plus static bindings: its search sector, a contiguous row band of the
map (sectors partition the grid, so drones never collide), and its
chip instance (``rollout.fly_mission`` groups drones by die).

The battery is a ledger, not a decrement: energy accumulates from zero
and a drone goes inactive once it crosses ``battery_J``.  Decision
energy and latency are charged from the same ``serving.metrics.
DecisionCost`` the serving summaries use.  The sector tables are
integers and match the reference bit for bit.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch import resolve_device


@dataclasses.dataclass(frozen=True)
class UavConfig:
    """Fleet-wide platform constants.  One cell transit costs about 200
    decisions of the SAR CNN, a verification maneuver about 6000:
    maneuvers dominate and inference is the cheap gate."""
    n_drones: int = 3
    battery_J: float = 250e-6         # per-sortie energy budget
    flight_energy_J: float = 1.5e-6   # one cell-to-cell transit
    verify_energy_J: float = 40e-6    # descend-orbit-confirm maneuver
    orbit_energy_J: float = 8e-6      # flag-and-orbit second look
    flight_time_s: float = 2.0
    verify_time_s: float = 25.0
    orbit_time_s: float = 8.0


def sector_rows(grid: int, n_drones: int) -> np.ndarray:
    """[n_drones, 2] int32 (row0, n_rows): contiguous row bands that
    partition the map as evenly as possible.  Requires n_drones ≤ grid:
    a zero-row sector would alias its drone onto a neighbour's cells."""
    if n_drones > grid:
        raise ValueError(
            f"n_drones={n_drones} exceeds grid rows={grid}: row-band "
            f"sectors cannot give every drone at least one row")
    base, extra = divmod(grid, n_drones)
    out, r0 = [], 0
    for d in range(n_drones):
        rows = base + (1 if d < extra else 0)
        out.append((r0, rows))
        r0 += rows
    return np.asarray(out, np.int32)


def sector_masks(grid: int, n_drones: int) -> np.ndarray:
    """[n_drones, grid²] bool: each drone's owned cells (the
    information-gain planner's argmax domain)."""
    rows = sector_rows(grid, n_drones)
    cell_row = np.arange(grid * grid) // grid
    return np.stack([(cell_row >= r0) & (cell_row < r0 + nr)
                     for r0, nr in rows])


def init_fleet(ucfg: UavConfig, grid: int, n_episodes: int = 1,
               device=None) -> dict:
    """Fresh fleet state for ``n_episodes`` stacked worlds, flattened to
    one batch of B = n_episodes · n_drones drones (the decision kernel's
    batch), on ``device`` (None: the card).  Each drone starts at its
    sector's origin."""
    device = resolve_device(device)
    start = sector_rows(grid, ucfg.n_drones)[:, 0] * grid
    b = n_episodes * ucfg.n_drones
    return {
        "pos": torch.as_tensor(np.tile(start, n_episodes), device=device),
        "path_k": torch.zeros((b,), dtype=torch.int32, device=device),
        "energy_J": torch.zeros((b,), dtype=torch.float32, device=device),
        "time_s": torch.zeros((b,), dtype=torch.float32, device=device),
    }


def fleet_bindings(ucfg: UavConfig, grid: int, n_episodes: int = 1,
                   device=None) -> dict:
    """Static per-drone tensors of the flattened fleet: world id ``wid``
    [B], sector (row0, n_rows) [B, 2], sector mask [B, grid²], on
    ``device`` (None: the card)."""
    device = resolve_device(device)
    d = ucfg.n_drones
    return {
        "wid": torch.arange(n_episodes, dtype=torch.int32,
                            device=device).repeat_interleave(d),
        "sector": torch.as_tensor(
            np.tile(sector_rows(grid, d), (n_episodes, 1)), device=device),
        "sector_mask": torch.as_tensor(
            np.tile(sector_masks(grid, d), (n_episodes, 1)), device=device),
    }
