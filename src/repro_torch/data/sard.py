"""Synthetic SARD: aerial search-and-rescue imagery stand-in (port of
``repro/data/sard.py``, paper §V-B).

A patch is smooth multi-octave terrain clutter, a compact distractor
rock (always present, the hard negative), and — for label 1 — an
elongated Gaussian "victim" blob whose size shrinks with simulated
altitude, plus sensor noise.  Labels are balanced and every batch is a
pure function of (seed, step).

The reference draws with ``jax.random`` and resizes with
``jax.image.resize``; this port draws from ``torch.Generator``s and
``F.interpolate``, so its images match the reference in distribution,
not in bits.  Tests that need the reference's exact images bridge them.
Only the fog corruption is ported; frost, motion and snow wait.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
import torch.nn.functional as F


@dataclasses.dataclass(frozen=True)
class SardConfig:
    image_size: int = 32
    seed: int = 0
    victim_intensity: float = 2.4
    distractor_intensity: float = 1.3   # close to victims: hard negatives
    altitude_range: tuple = (0.6, 1.4)  # scales blob size (15–75 m proxy)
    clutter: float = 0.8


def _generator(*words: int) -> torch.Generator:
    """A CPU generator seeded from integer words (order matters)."""
    state = np.random.SeedSequence(list(words)).generate_state(1, np.uint64)
    return torch.Generator().manual_seed(int(state[0]))


def _uniform(gen, shape, lo: float, hi: float) -> torch.Tensor:
    return lo + (hi - lo) * torch.rand(shape, generator=gen)


def _smooth_noise(gen: torch.Generator, n: int, octaves: int = 3):
    """Multi-octave smooth clutter [n, n] (bilinear upsampling)."""
    img = torch.zeros((n, n))
    for o in range(octaves):
        size = max(2, n // (2 ** (octaves - o)))
        coarse = torch.randn((1, 1, size, size), generator=gen)
        up = F.interpolate(coarse, size=(n, n), mode="bilinear",
                           align_corners=False)
        img = img + up[0, 0] / (2 ** o)
    return img


def _blob(n: int, cy, cx, sy, sx, theta) -> torch.Tensor:
    """Anisotropic Gaussian blob (elongation ~ lying pose)."""
    y = torch.arange(n, dtype=torch.float32)[:, None] - cy
    x = torch.arange(n, dtype=torch.float32)[None, :] - cx
    ct, st = math.cos(theta), math.sin(theta)
    u = ct * y + st * x
    v = -st * y + ct * x
    return torch.exp(-0.5 * ((u / sy) ** 2 + (v / sx) ** 2))


def make_image(cfg: SardConfig, gen: torch.Generator,
               has_victim: float) -> torch.Tensor:
    """One patch [n, n, 1], drawn from ``gen`` (scene, then noise)."""
    n = cfg.image_size
    img = cfg.clutter * _smooth_noise(gen, n)
    altitude = float(_uniform(gen, (), *cfg.altitude_range))
    dc = _uniform(gen, (2,), 4.0, n - 4.0)
    img = img + cfg.distractor_intensity * _blob(
        n, float(dc[0]), float(dc[1]), 1.5 / altitude, 1.5 / altitude, 0.0)
    vc = _uniform(gen, (2,), 4.0, n - 4.0)
    theta = float(_uniform(gen, (), 0.0, math.pi))
    victim = cfg.victim_intensity * _blob(
        n, float(vc[0]), float(vc[1]), 2.5 / altitude, 1.0 / altitude, theta)
    img = img + has_victim * victim
    img = img + 0.1 * torch.randn((n, n), generator=gen)   # sensor noise
    return img[..., None]


def make_batch(cfg: SardConfig, gen: torch.Generator, batch: int) -> dict:
    """{"images": [B, n, n, 1] float32, "labels": [B] int32}, balanced."""
    labels = (torch.arange(batch) % 2).to(torch.int32)
    labels = labels[torch.randperm(batch, generator=gen)]
    images = torch.stack([make_image(cfg, gen, float(y)) for y in labels])
    return {"images": images, "labels": labels}


def batch_at(cfg: SardConfig, step: int, batch: int) -> dict:
    return make_batch(cfg, _generator(cfg.seed, step), batch)


def corrupt_fog(images: torch.Tensor, severity: float = 1.0):
    """Haze: blend toward a bright constant."""
    haze = 0.7 * severity
    return images * (1 - haze) + haze * 1.2


CORRUPTIONS = {"fog": corrupt_fog}


def corrupted_batch(cfg: SardConfig, step: int, batch: int,
                    corruption: str = "fog", severity: float = 1.0) -> dict:
    if corruption not in CORRUPTIONS:
        raise NotImplementedError(
            f"corruption {corruption!r} is not ported yet (fog only)")
    data = batch_at(cfg, step, batch)
    return {"images": CORRUPTIONS[corruption](data["images"], severity),
            "labels": data["labels"]}
