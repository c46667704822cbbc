"""Write-free CLT-GRNG (port of ``repro/core/clt_grng.py``).

Each Bayesian weight cell (k, n) owns 16 virtual devices whose currents
are fixed hashes of the coordinate:

    I(k,n,j) = i_lo + Δi · b(k,n,j) + γ · v(k,n,j)  [+ imprint · w(k,n,j)]

with b a hash bit and v, w CLT-of-bytes normals.  A sample of ε sums
the currents of the 8 devices the shared LFSR selection picks,

    ε(k,n,r) = (Σ_j s_r[j] · I(k,n,j) + read noise − sum_mean) / sum_std.

Selection granularity, as the hardware's selection lines are shared:
'layer' (one stream for every cell: the serving path's, the per-chip
calibration's, Fig. 9's and the only one the kernels take), 'tile' (one
LFSR per ``tile``×``tile`` macro) and 'cell' (an idealized independent
selection per cell and sample, an ablation).  The 8 selected currents
are summed in the order the reference's contraction gives at each
granularity, so that the sums equal its bit for bit.
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
               n_rows: int | None = None, n_cols: int | None = None,
               device=None) -> torch.Tensor:
    """Selection vectors for consecutive samples -> float32 [R, 16] at
    'layer' granularity, [R, ⌈n_rows/tile⌉, ⌈n_cols/tile⌉, 16] at
    'tile' (each tile's LFSR stepped from its ``tile_seeds`` seed).
    'cell' has no shared stream (``raw_sums`` draws it per cell)."""
    if cfg.granularity == "layer":
        states = lfsr_mod.lfsr_states(cfg.lfsr_seed, sample0 + num_samples,
                                      device=device)
        return lfsr_mod.swapper_select(states[sample0:])
    if cfg.granularity == "tile":
        if n_rows is None or n_cols is None:
            raise ValueError("'tile' selections need the block's n_rows "
                             "and n_cols")
        nt_r, nt_c = -(-n_rows // cfg.tile), -(-n_cols // cfg.tile)
        seeds = lfsr_mod.tile_seeds(cfg.lfsr_seed, nt_r * nt_c,
                                    device=device).reshape(nt_r, nt_c)
        states = lfsr_mod.lfsr_walk(seeds, sample0 + num_samples)
        return lfsr_mod.swapper_select(states[sample0:])
    raise ValueError(
        f"selections() is not defined for granularity={cfg.granularity!r}")


def _expand_tile_sel(sel_t: torch.Tensor, n_rows: int, n_cols: int,
                     tile: int) -> torch.Tensor:
    """[.., nt_r, nt_c, 16] -> [.., n_rows, n_cols, 16]: each tile's
    selection broadcast over its cells, ragged edge tiles cut."""
    s = sel_t.repeat_interleave(tile, dim=-3)[..., :n_rows, :, :]
    return s.repeat_interleave(tile, dim=-2)[..., :, :n_cols, :]


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


def sum_in_halves(x: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis (a power of two long) by halves, first
    half plus second, until one term is left: the order the reference's
    per-cell contraction at 'cell' granularity gives."""
    while x.shape[-1] > 1:
        half = x.shape[-1] // 2
        x = x[..., :half] + x[..., half:]
    return x[..., 0]


def subset_sums(currents: torch.Tensor, sel: torch.Tensor, cfg: GRNGConfig,
                sample0: int = 0, row0: int = 0,
                col0: int = 0) -> torch.Tensor:
    """Raw sums of a block's device currents [K, N, 16] under the
    selections of samples ``sample0`` …: sel [R, 16] shared by the
    block, or [R, K, N, 16] a cell's own; the 16 terms summed in the
    reference's order (in order; by halves at 'cell' granularity), plus
    the read noise -> [R, K, N] (µA)."""
    if sel.ndim == 2:
        sel = sel[:, None, None, :]
    total = sum_in_halves if cfg.granularity == "cell" else sum_in_order
    raw = total(sel.to(torch.float32) * currents[None])
    if cfg.read_sigma:
        k, n = currents.shape[:2]
        raw = raw + read_noise(cfg, k, n, sel.shape[0], sample0, row0, col0,
                               device=raw.device)
    return raw


def block_selections(cfg: GRNGConfig, n_rows: int, n_cols: int,
                     num_samples: int, sample0: int = 0, row0: int = 0,
                     col0: int = 0, device=None) -> torch.Tensor:
    """The selections a block's cells see, by granularity: [R, 16]
    ('layer'), else [R, n_rows, n_cols, 16] (a tile's broadcast over
    its cells; a cell's from hash3(row, col, r, lfsr_seed))."""
    if cfg.granularity == "layer":
        return selections(cfg, num_samples, sample0, device=device)
    if cfg.granularity == "tile":
        sel = selections(cfg, num_samples, sample0, n_rows, n_cols,
                         device=device)              # [R, nt_r, nt_c, 16]
        return _expand_tile_sel(sel, n_rows, n_cols, cfg.tile)
    if cfg.granularity == "cell":
        rows, cols = _grid(n_rows, n_cols, row0, col0, device)
        r_abs = sample0 + torch.arange(num_samples, dtype=torch.int64,
                                       device=device)
        return lfsr_mod.cell_selections(rows[None], cols[None],
                                        r_abs[:, None, None], cfg.lfsr_seed)
    raise ValueError(f"unknown granularity {cfg.granularity!r}")


def raw_sums(cfg: GRNGConfig, n_rows: int, n_cols: int, num_samples: int,
             sample0: int = 0, row0: int = 0, col0: int = 0,
             device=None) -> torch.Tensor:
    """Un-standardized subset sums at the config's granularity:
    -> [R, n_rows, n_cols] (µA)."""
    currents = device_currents_grid(cfg, n_rows, n_cols, row0, col0,
                                    device=device)             # [K, N, 16]
    sel = block_selections(cfg, n_rows, n_cols, num_samples, sample0, row0,
                           col0, device=device)
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
