"""Grid-world SAR environment: victims and spatially correlated weather
(port of ``repro/mission/world.py``).

The mission map is a ``grid × grid`` lattice of aerial patches.  A map
holds its victims, a per-cell corruption severity from a smooth
multi-octave field min-max normalized into [severity_lo, severity_hi],
and its seed.  ``make_world`` draws it once per episode on the host,
from a generator keyed by (``_SEED_LAYOUT``, seed): victims placed
without replacement, the field from ``data/sard._smooth_noise``.

``observe_cells`` renders what each drone sees every step, on the
device, as ``data/sard.make_image`` and the per-image corruptions draw
it: clutter octaves by bilinear upsampling, altitude, the distractor
rock, the victim blob and its pose, sensor noise, then the map's
weather at the cell's severity.  The random numbers come from counters,
not generators, so no draw waits for the host:

  * the SCENE (terrain, rock, victim placement and pose) from
    ``hash3(counter, cell, map seed, _SEED_SCENE)``, a pure function of
    (map seed, cell) that persists across looks;
  * the EXPOSURE (sensor noise, falling snow, frost) from
    ``hash3(counter, cell, hash2(look, map seed), _SEED_WEATHER)``,
    fresh at every look.

A uniform is the top 24 bits of a hash word over 2²⁴; a normal comes
from a pair of uniforms by Box–Muller.  These are the port's own draws,
as every SARD draw of the port is: they match the reference in
distribution and in structure (an orbit or a revisit sees the same
ground truth under a new exposure, which the rollout's 2-of-3 evidence
rule depends on), not in bits.  A world may carry a pre-rendered
``exposures`` table [E, n_cells, n_looks, H, W, 1] (``bridge.
worlds_from_jax``); ``observe_cells`` then reads its images from it.
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F

from repro_torch import resolve_device
from repro_torch.core.hashing import hash2, hash3
from repro_torch.data.sard import (CORRUPTIONS, SardConfig, _generator,
                                   _smooth_noise, frost_with_mask)

# Domain-separation tags of the world's three random streams.
_SEED_SCENE = 0x0B5E
_SEED_WEATHER = 0x7EA7
_SEED_LAYOUT = 0x5A12

_CLUTTER_OCTAVES = 3              # make_image's terrain
_FROST_OCTAVES = 2                # corrupt_frost's mask


@dataclasses.dataclass(frozen=True)
class WorldConfig:
    """Static mission-map parameters."""
    grid: int = 12                   # grid × grid cells
    n_victims: int = 5
    seed: int = 0
    corruption: str = "snow"         # the map's weather modality
    severity_lo: float = 0.0         # clear-sky corner of the field
    severity_hi: float = 0.5         # worst-weather corner of the field
    field_octaves: int = 3
    image_size: int = 32

    @property
    def n_cells(self) -> int:
        return self.grid * self.grid

    def sard(self) -> SardConfig:
        return SardConfig(image_size=self.image_size, seed=self.seed)


def make_world(cfg: WorldConfig, seed: int | None = None,
               device=None) -> dict:
    """One mission map, drawn on the host and moved to ``device`` (None:
    the card; ``"cpu"`` on purpose):

      victims   [n_cells] bool
      severity  [n_cells] float32, the cell's corruption severity
      seed      []        int64, keys the cell's scene and exposures

    ``seed`` overrides ``cfg.seed`` (``stack_worlds`` draws world i from
    seed + i)."""
    dev = resolve_device(device)
    s = cfg.seed if seed is None else seed
    gen = _generator(_SEED_LAYOUT, s)
    placed = torch.randperm(cfg.n_cells, generator=gen)[:cfg.n_victims]
    victims = torch.zeros((cfg.n_cells,), dtype=torch.bool)
    victims[placed] = True
    field = _smooth_noise(gen, cfg.grid, octaves=cfg.field_octaves)
    lo, hi = field.min(), field.max()
    field = (field - lo) / torch.clamp(hi - lo, min=1e-9)
    severity = cfg.severity_lo + (cfg.severity_hi - cfg.severity_lo) * field
    return {"victims": victims.to(dev),
            "severity": severity.reshape(-1).to(torch.float32).to(dev),
            "seed": torch.tensor(s, dtype=torch.int64, device=dev)}


def stack_worlds(cfg: WorldConfig, n_episodes: int, device=None) -> dict:
    """``n_episodes`` independent maps (seeds cfg.seed … cfg.seed+E-1)
    stacked on a leading episode axis, on ``device`` (None: the card)."""
    worlds = [make_world(cfg, cfg.seed + e, device) for e in range(n_episodes)]
    return {k: torch.stack([w[k] for w in worlds]) for k in worlds[0]}


# ----------------------------------------------------------------------
# the device renderer
# ----------------------------------------------------------------------
def _octave_sizes(n: int, octaves: int) -> list[int]:
    """The coarse grid of each octave of ``data/sard._smooth_noise``."""
    return [max(2, n // (2 ** (octaves - o))) for o in range(octaves)]


def _uniforms(h: torch.Tensor) -> torch.Tensor:
    """Hash words (uint32 in int64) -> float32 uniforms in [0, 1)."""
    return (h >> 8).to(torch.float32) * (1.0 / (1 << 24))


def _normals(u: torch.Tensor) -> torch.Tensor:
    """[..., 2k] uniforms -> [..., k] standard normals (Box–Muller)."""
    u1, u2 = u[..., 0::2], u[..., 1::2]
    return torch.sqrt(-2.0 * torch.log1p(-u1)) * torch.cos(
        (2.0 * math.pi) * u2)


def _smooth(z: torch.Tensor, n: int, octaves: int) -> torch.Tensor:
    """Batched ``_smooth_noise`` from drawn normals: z [B, Σ size²] ->
    [B, n, n], each octave's coarse grid upsampled bilinearly."""
    img = z.new_zeros((z.shape[0], n, n))
    off = 0
    for o, size in enumerate(_octave_sizes(n, octaves)):
        coarse = z[:, off:off + size * size].reshape(-1, 1, size, size)
        up = F.interpolate(coarse, size=(n, n), mode="bilinear",
                           align_corners=False)
        img = img + up[:, 0] / (2 ** o)
        off += size * size
    return img


def _blobs(n: int, cy, cx, sy, sx, theta) -> torch.Tensor:
    """Batched anisotropic Gaussian blobs: [B] parameters -> [B, n, n]."""
    grid = torch.arange(n, dtype=torch.float32, device=cy.device)
    y = grid[None, :, None] - cy[:, None, None]
    x = grid[None, None, :] - cx[:, None, None]
    ct = torch.cos(theta)[:, None, None]
    st = torch.sin(theta)[:, None, None]
    u = ct * y + st * x
    v = -st * y + ct * x
    return torch.exp(-0.5 * ((u / sy[:, None, None]) ** 2
                             + (v / sx[:, None, None]) ** 2))


def _scene(cfg: SardConfig, wseed, cells, has_victim) -> torch.Tensor:
    """The persistent part of ``make_image``: [B, n, n] keyed by
    (map seed, cell)."""
    n = cfg.image_size
    t = sum(s * s for s in _octave_sizes(n, _CLUTTER_OCTAVES))
    ctr = torch.arange(2 * t + 6, dtype=torch.int64, device=cells.device)
    u = _uniforms(hash3(ctr[None], cells[:, None], wseed[:, None],
                        _SEED_SCENE))
    img = cfg.clutter * _smooth(_normals(u[:, :2 * t]), n, _CLUTTER_OCTAVES)
    alt, dcy, dcx, vcy, vcx, theta = u[:, 2 * t:].unbind(1)
    lo, hi = cfg.altitude_range
    altitude = lo + (hi - lo) * alt
    span = n - 8.0                         # centres ~ U(4, n - 4)
    rock = 1.5 / altitude
    img = img + cfg.distractor_intensity * _blobs(
        n, 4.0 + span * dcy, 4.0 + span * dcx, rock, rock,
        torch.zeros_like(theta))
    victim = cfg.victim_intensity * _blobs(
        n, 4.0 + span * vcy, 4.0 + span * vcx, 2.5 / altitude,
        1.0 / altitude, math.pi * theta)
    return img + has_victim[:, None, None] * victim


def _exposure_words(corruption: str, n: int) -> int:
    """Uniforms a look draws after its 2n² for sensor noise."""
    if corruption == "snow":
        return n * n
    if corruption == "frost":
        return 2 * sum(s * s for s in _octave_sizes(n, _FROST_OCTAVES))
    return 0


def _render(wcfg: WorldConfig, wseed, cells, has_victim, severity,
            look) -> torch.Tensor:
    """[B] (map seed, cell, victim, severity, look) -> [B, n, n, 1]."""
    cfg = wcfg.sard()
    n = cfg.image_size
    img = _scene(cfg, wseed, cells, has_victim)
    extra = _exposure_words(wcfg.corruption, n)
    ctr = torch.arange(2 * n * n + extra, dtype=torch.int64,
                       device=cells.device)
    key = hash2(look, wseed, _SEED_WEATHER)
    u = _uniforms(hash3(ctr[None], cells[:, None], key[:, None],
                        _SEED_WEATHER))
    noise = _normals(u[:, :2 * n * n]).reshape(-1, n, n)
    img = (img + 0.1 * noise)[..., None]                 # [B, n, n, 1]
    sev = severity.to(torch.float32).reshape(-1, 1, 1, 1)
    weather = u[:, 2 * n * n:]
    if wcfg.corruption == "snow":
        specks = weather.reshape(-1, n, n, 1) < 0.04 * sev
        return torch.where(specks, 2.0, img)
    if wcfg.corruption == "frost":
        mask = _smooth(_normals(weather), n, _FROST_OCTAVES)[..., None]
        return frost_with_mask(img, mask, sev)
    return CORRUPTIONS[wcfg.corruption](img, sev)        # fog, motion


def observe_cells(cfg: WorldConfig, worlds: dict, wid: torch.Tensor,
                  cells: torch.Tensor, look: int) -> torch.Tensor:
    """Drone b (on world ``wid[b]``) looks at ``cells[b]`` at exposure
    ``look``: [B, H, W, 1] detector inputs on the worlds' device.  With
    an ``exposures`` table in ``worlds`` the images are read from it."""
    wid, cells = wid.long(), cells.long()
    if "exposures" in worlds:
        return worlds["exposures"][wid, cells, look]
    looks = torch.full_like(cells, look)
    return _render(cfg, worlds["seed"][wid], cells,
                   worlds["victims"][wid, cells].to(torch.float32),
                   worlds["severity"][wid, cells], looks)
