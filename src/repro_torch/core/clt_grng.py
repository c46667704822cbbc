"""Write-free CLT-GRNG (port of ``repro/core/clt_grng.py``).

Each Bayesian weight cell (k, n) owns 16 virtual devices whose currents
are fixed hashes of the coordinate:

    I(k,n,j) = i_lo + Δi · b(k,n,j) + γ · v(k,n,j)  [+ imprint · w(k,n,j)]

with b a hash bit and v, w CLT-of-bytes normals.  A sample of ε sums
the currents of the 8 devices the shared LFSR selection picks,

    ε(k,n,r) = (Σ_j s_r[j] · I(k,n,j) + read noise − sum_mean) / sum_std.

Only the 'layer' selection granularity is ported (the serving path's,
the per-chip calibration's and Fig. 9's); 'tile' and 'cell' wait for a
later slice.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core import lfsr as lfsr_mod
from repro_torch.core.hashing import gaussianish, hash3, uniform_bit


@dataclasses.dataclass(frozen=True)
class GRNGConfig:
    n_devices: int = 16
    k_select: int = 8
    # Device current model [µA] — fitted to paper Fig. 9 statistics.
    i_lo: float = 0.926
    delta_i: float = 0.673
    gamma: float = 0.100
    # Fig. 9 measured sum statistics used for standardization.
    sum_mean: float = 10.1
    sum_std: float = 0.993
    # Entropy source seeds ("programming" seed / selector seed).
    seed: int = 0xC1A0
    lfsr_seed: int = 0xACE1
    # Selection sharing: 'layer' | 'tile' | 'cell'.
    granularity: str = "layer"
    tile: int = 64
    # Cycle-to-cycle read noise [µA RMS], hash-keyed by the absolute
    # sample index so escalation extends the stream exactly.
    read_sigma: float = 0.0
    noise_seed: int = 0x51CE
    # Aging imprint: a hash-frozen per-device Vth walk [µA RMS].
    imprint: float = 0.0
    imprint_seed: int = 0x1A9E

    def analytic_sum_stats(self) -> tuple[float, float]:
        """Closed-form mean/SD of the 8-device sum (read noise
        included)."""
        mean = self.k_select * (self.i_lo + 0.5 * self.delta_i)
        var = (self.k_select * (self.delta_i**2 / 4.0 + self.gamma**2
                                + self.imprint**2)
               + self.read_sigma**2)
        return mean, float(np.sqrt(var))


def _current(cfg: GRNGConfig, rows, cols, j) -> torch.Tensor:
    h = hash3(rows, cols, j, cfg.seed)
    out = cfg.i_lo + cfg.delta_i * uniform_bit(h) + cfg.gamma * gaussianish(h)
    if cfg.imprint:
        out = out + cfg.imprint * gaussianish(
            hash3(rows, cols, j, cfg.imprint_seed))
    return out


def device_currents(cfg: GRNGConfig, rows: torch.Tensor,
                    cols: torch.Tensor) -> torch.Tensor:
    """Virtual device currents I(k, n, j): rows/cols broadcast,
    -> float32 [..., n_devices]."""
    j = torch.arange(cfg.n_devices, dtype=torch.int64, device=rows.device)
    return _current(cfg, rows[..., None], cols[..., None], j)


def device_current_j(cfg: GRNGConfig, rows: torch.Tensor,
                     cols: torch.Tensor, j: int) -> torch.Tensor:
    """Single virtual-device current I(k, n, j) — one hash per cell."""
    return _current(cfg, rows, cols, int(j))


def _grid(n_rows: int, n_cols: int, row0: int, col0: int, device):
    rows = row0 + torch.arange(n_rows, dtype=torch.int64, device=device)
    cols = col0 + torch.arange(n_cols, dtype=torch.int64, device=device)
    return rows[:, None], cols[None, :]


def device_currents_grid(cfg: GRNGConfig, n_rows: int, n_cols: int,
                         row0: int = 0, col0: int = 0,
                         device=None) -> torch.Tensor:
    """[n_rows, n_cols, n_devices] device currents for a block."""
    rows, cols = _grid(n_rows, n_cols, row0, col0, device)
    return device_currents(cfg, rows, cols)


def selections(cfg: GRNGConfig, num_samples: int, sample0: int = 0,
               device=None) -> torch.Tensor:
    """Selection vectors for consecutive samples, 'layer' granularity:
    -> float32 [R, 16]."""
    if cfg.granularity != "layer":
        raise NotImplementedError(
            f"granularity={cfg.granularity!r} is not ported yet")
    states = lfsr_mod.lfsr_states(cfg.lfsr_seed, sample0 + num_samples,
                                  device=device)
    return lfsr_mod.swapper_select(states[sample0:])


def read_noise_at(cfg: GRNGConfig, rows, cols, r_abs) -> torch.Tensor:
    """Read noise for broadcastable (cell, absolute-sample) coordinates."""
    return cfg.read_sigma * gaussianish(
        hash3(rows, cols, r_abs, cfg.noise_seed))


def read_noise(cfg: GRNGConfig, n_rows: int, n_cols: int, num_samples: int,
               sample0: int = 0, row0: int = 0, col0: int = 0,
               device=None) -> torch.Tensor:
    """Cycle-to-cycle read noise on the raw 8-device sum (µA):
    -> [R, n_rows, n_cols], keyed by (cell, ABSOLUTE sample index) so a
    draw at ``sample0 = s`` reproduces sample ``s`` of a larger draw."""
    rows, cols = _grid(n_rows, n_cols, row0, col0, device)
    r_abs = sample0 + torch.arange(num_samples, dtype=torch.int64,
                                   device=device)
    return read_noise_at(cfg, rows[None], cols[None], r_abs[:, None, None])


def sum_in_order(x: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis term by term, j = 0, 1, …: the order the
    reference's reductions give these 16-term sums (``torch.sum`` would
    pair the terms differently)."""
    total = x[..., 0]
    for j in range(1, x.shape[-1]):
        total = total + x[..., j]
    return total


def subset_sums(currents: torch.Tensor, sel: torch.Tensor, cfg: GRNGConfig,
                sample0: int = 0, row0: int = 0,
                col0: int = 0) -> torch.Tensor:
    """Raw sums of a block's device currents [K, N, 16] under the
    selections sel [R, 16] (samples ``sample0`` …), the 16 terms summed
    in order, plus the read noise -> [R, K, N] (µA)."""
    raw = sum_in_order(sel[:, None, None, :].to(torch.float32)
                       * currents[None])
    if cfg.read_sigma:
        k, n = currents.shape[:2]
        raw = raw + read_noise(cfg, k, n, sel.shape[0], sample0, row0, col0,
                               device=raw.device)
    return raw


def raw_sums(cfg: GRNGConfig, n_rows: int, n_cols: int, num_samples: int,
             sample0: int = 0, row0: int = 0, col0: int = 0,
             device=None) -> torch.Tensor:
    """Un-standardized subset sums, 'layer' granularity:
    -> [R, n_rows, n_cols] (µA)."""
    currents = device_currents_grid(cfg, n_rows, n_cols, row0, col0,
                                    device=device)             # [K, N, 16]
    sel = selections(cfg, num_samples, sample0, device=device)  # [R, 16]
    return subset_sums(currents, sel, cfg, sample0, row0, col0)


def eps(cfg: GRNGConfig, n_rows: int, n_cols: int, num_samples: int,
        sample0: int = 0, row0: int = 0, col0: int = 0,
        device=None) -> torch.Tensor:
    """Standardized ε samples -> [R, n_rows, n_cols]."""
    raw = raw_sums(cfg, n_rows, n_cols, num_samples, sample0, row0, col0,
                   device=device)
    return (raw - cfg.sum_mean) / cfg.sum_std


def eps_at(currents: torch.Tensor, sel_r: torch.Tensor, cfg: GRNGConfig,
           r_abs: int, row0: int = 0, col0: int = 0) -> torch.Tensor:
    """ε of one sample from a block's device currents [K, N, 16]: its
    ``subset_sums`` at absolute sample ``r_abs``, standardized as the
    GRNG kernels do, times float32(1/sum_std) rather than ``eps``'s
    division -> [K, N]."""
    raw = subset_sums(currents, sel_r[None], cfg, r_abs, row0, col0)[0]
    return (raw - cfg.sum_mean) * (1.0 / cfg.sum_std)


def estimate_mean_offset(cfg: GRNGConfig, n_rows: int, n_cols: int,
                         num_samples: int, sample0: int = 0,
                         device=None) -> torch.Tensor:
    """N-sample estimate of Δε: the paper's measurement procedure."""
    return eps(cfg, n_rows, n_cols, num_samples, sample0,
               device=device).mean(dim=0)


def cell_mean_offset(cfg: GRNGConfig, n_rows: int, n_cols: int,
                     row0: int = 0, col0: int = 0,
                     device=None) -> torch.Tensor:
    """Exact static per-cell offset Δε (paper §III-B1), closed form:
    every device is selected with probability k/n."""
    currents = device_currents_grid(cfg, n_rows, n_cols, row0, col0,
                                    device=device)
    # in order, so the offset (a difference of nearly equal terms)
    # matches the reference bit for bit
    expect_raw = sum_in_order(currents) * (cfg.k_select / cfg.n_devices)
    return (expect_raw - cfg.sum_mean) / cfg.sum_std


def calibrate(cfg: GRNGConfig, n_cells: int = 4096, num_samples: int = 64,
              device=None) -> tuple[torch.Tensor, torch.Tensor]:
    """Empirical (sum_mean, sum_std) of the raw sums over ``n_cells``
    cells × ``num_samples`` samples: the paper's Fig. 9 measurement.
    Two 0-dim tensors (µA); the SD is the population one (ddof 0).
    ``device``: None runs on the card, "cpu" on the CPU."""
    raw = raw_sums(cfg, n_cells, 1, num_samples,
                   device=resolve_device(device))
    return raw.mean(), raw.std(correction=0)


def distribution_sample(cfg: GRNGConfig, n_cells: int, num_samples: int,
                        device=None) -> np.ndarray:
    """Flat numpy array of ε draws for distribution-quality analysis
    (Fig. 9), computed on ``device`` (None = the card)."""
    e = eps(cfg, n_cells, 1, num_samples, device=resolve_device(device))
    return e.reshape(-1).cpu().numpy()
