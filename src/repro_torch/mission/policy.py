"""Mission policies: coverage planners and the verification router (port
of ``repro/mission/policy.py``).

Two coverage planners, both index arithmetic or an argmax over [B]
batches that run on the device inside the rollout's step loop:

  * ``lawnmower``: the serpentine sweep of the drone's sector;
  * ``infogain``: fly to the sector cell with the highest remaining
    predictive entropy, less ``infogain_lambda`` per cell of Manhattan
    distance.  Unvisited cells carry the prior entropy ln(n_classes), so
    ties are the normal case: the argmax takes the first maximum, as
    ``jnp.argmax`` does.

The verification router turns a triage verdict and the class prediction
into a flight decision: accept + victim → verification descent; flag →
``flag_action`` ('orbit': two further looks at full R, descend if either
detects again; 'skip': move on).  ``mode`` picks the decision engine:
Bayesian adaptive R, Bayesian fixed R = r_max, or the deterministic
µ-only baseline that verifies every detection.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.serving.triage import TriagePolicy

PLANNERS = ("lawnmower", "infogain")
MODES = ("bayes_adaptive", "bayes_fixed", "deterministic")
FLAG_ACTIONS = ("orbit", "skip")


@dataclasses.dataclass(frozen=True)
class MissionPolicy:
    """The mission's decision policy."""
    mode: str = "bayes_adaptive"
    planner: str = "lawnmower"
    flag_action: str = "orbit"
    # Fig. 1 thresholds: conf 0.8 / MI 0.5 (TriagePolicy defaults).
    triage: TriagePolicy = dataclasses.field(default_factory=TriagePolicy)
    infogain_lambda: float = 0.05     # distance discount, nats per cell

    def __post_init__(self):
        if self.mode not in MODES:
            raise ValueError(f"mode must be one of {MODES}: {self.mode}")
        if self.planner not in PLANNERS:
            raise ValueError(
                f"planner must be one of {PLANNERS}: {self.planner}")
        if self.flag_action not in FLAG_ACTIONS:
            raise ValueError(
                f"flag_action must be one of {FLAG_ACTIONS}: "
                f"{self.flag_action}")

    @property
    def bayesian(self) -> bool:
        return self.mode != "deterministic"


def lawnmower_cell(sector: torch.Tensor, grid: int,
                   k: torch.Tensor) -> torch.Tensor:
    """Serpentine cell for path step ``k`` [B] in ``sector`` [B, 2]
    (row0, n_rows); wraps at the sector's size."""
    row0, n_rows = sector[:, 0], sector[:, 1]
    s = k % (n_rows * grid)
    r, c = s // grid, s % grid
    col = torch.where(r % 2 == 0, c, grid - 1 - c)
    return (row0 + r) * grid + col


def infogain_cell(pos: torch.Tensor, entropy: torch.Tensor,
                  sector_mask: torch.Tensor, grid: int,
                  lam: float) -> torch.Tensor:
    """Greedy next cell [B] int32: the first argmax over the drone's
    sector of entropy − lam · Manhattan distance (float32, in that
    order).  pos [B]; entropy [B, n_cells]; sector_mask [B, n_cells]."""
    cells = torch.arange(entropy.shape[-1], dtype=pos.dtype,
                         device=pos.device)
    pr, pc = pos // grid, pos % grid
    cr, cc = cells // grid, cells % grid
    dist = ((cr[None] - pr[:, None]).abs()
            + (cc[None] - pc[:, None]).abs()).to(torch.float32)
    score = entropy - lam * dist
    score = torch.where(sector_mask, score, -torch.inf)
    return score.argmax(-1).to(torch.int32)


def next_cell(policy: MissionPolicy, grid: int, *, sector, path_k, pos,
              entropy, sector_mask) -> torch.Tensor:
    """The planner ``policy.planner`` names."""
    if policy.planner == "lawnmower":
        return lawnmower_cell(sector, grid, path_k)
    return infogain_cell(pos, entropy, sector_mask, grid,
                         policy.infogain_lambda)
