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

Corr partitions (paper Fig. 17): fog, frost, motion and snow.  Fog and
motion are deterministic and give the reference's bits; frost's mask
and snow's specks are drawn from generators keyed by a tuple of integer
words (the port's stand-in for a JAX key: ``_generator(*key)`` for the
batch, ``_generator(*key, i)`` for image i), so they match the
reference's given the same mask, and in distribution otherwise.
``corrupt`` takes one severity for the batch or one per image (the
reference's severity-field API).
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


# ----------------------------------------------------------------------
# Corr partitions (paper Fig. 17).  Each takes images [B, n, n, 1], a
# severity (a Python number, or a [B, 1, 1, 1] float32 tensor: one per
# image) and a key (a tuple of integer words).
# ----------------------------------------------------------------------
def corrupt_fog(images: torch.Tensor, severity=1.0, key=()):
    """Haze: blend toward a bright constant."""
    haze = 0.7 * severity
    return images * (1 - haze) + haze * 1.2


def frost_masks(key: tuple, n: int, count: int | None = None):
    """Frost's smooth-noise masks: one [1, n, n, 1] from ``key``, or
    ``count`` [count, n, n, 1], image i's from ``key + (i,)``."""
    if count is None:
        return _smooth_noise(_generator(*key), n, octaves=2)[None, ..., None]
    return torch.stack([_smooth_noise(_generator(*key, i), n, octaves=2)
                        for i in range(count)])[..., None]


def frost_with_mask(images: torch.Tensor, mask: torch.Tensor, severity):
    """Frost's deterministic part: where the mask passes 0.7, dim the
    image and add a bright ice layer."""
    frost = (mask > 0.7).to(images.dtype)
    return images * (1 - 0.8 * severity * frost) + 1.5 * severity * frost


def corrupt_frost(images: torch.Tensor, severity=1.0, key=()):
    per_image = torch.is_tensor(severity)
    mask = frost_masks(key, images.shape[1],
                       images.shape[0] if per_image else None)
    return frost_with_mask(images, mask.to(images.device), severity)


MOTION_TAPS_CAP = 17


def corrupt_motion(images: torch.Tensor, severity=1.0, key=()):
    """Directional box blur (horizontal camera motion) of
    int(2 + 3·severity) taps; per image the count is taken in float32
    and capped at MOTION_TAPS_CAP (= one severity of 5), as the
    reference's per-image twin does."""
    if not torch.is_tensor(severity):
        taps = int(2 + 3 * severity)
        out = torch.zeros_like(images)
        for i in range(taps):
            out = out + torch.roll(images, i - taps // 2, dims=2)
        return out / taps
    taps = torch.floor(2 + 3 * severity.reshape(-1)).to(torch.int32).clamp(
        2, MOTION_TAPS_CAP).to(images.device)                  # [B]
    w = images.shape[2]
    cols = torch.arange(w, device=images.device)
    out = torch.zeros_like(images)
    for i in range(MOTION_TAPS_CAP):
        src = (cols[None, :] - (i - taps // 2)[:, None]) % w    # [B, W]
        rolled = torch.gather(images, 2, src[:, None, :, None].expand(
            images.shape))
        keep = (i < taps)[:, None, None, None]
        out = out + torch.where(keep, rolled, 0.0)
    return out / taps[:, None, None, None].to(images.dtype)


def corrupt_snow(images: torch.Tensor, severity=1.0, key=()):
    """Bright specks, each pixel with probability 0.04·severity: uniform
    draws from one generator for the batch, or one per image."""
    shape = tuple(images.shape)
    if torch.is_tensor(severity):
        u = torch.stack([torch.rand(shape[1:], generator=_generator(*key, i))
                         for i in range(shape[0])])
    else:
        u = torch.rand(shape, generator=_generator(*key))
    specks = u.to(images.device) < 0.04 * severity
    return torch.where(specks, 2.0, images)


CORRUPTIONS = {"fog": corrupt_fog, "frost": corrupt_frost,
               "motion": corrupt_motion, "snow": corrupt_snow}


def corrupt(images: torch.Tensor, key: tuple, severity,
            corruption: str = "fog") -> torch.Tensor:
    """Corrupt a batch at one severity (a Python number) or at one per
    image (a [B] sequence or tensor, taken as float32), keyed by ``key``
    (a tuple of integer words)."""
    if corruption not in CORRUPTIONS:
        raise ValueError(f"unknown corruption {corruption!r}")
    if not (torch.is_tensor(severity) or hasattr(severity, "__len__")):
        return CORRUPTIONS[corruption](images, float(severity), tuple(key))
    sev = torch.as_tensor(severity, dtype=torch.float32,
                          device=images.device).reshape(-1, 1, 1, 1)
    return CORRUPTIONS[corruption](images, sev, tuple(key))


def corrupted_batch(cfg: SardConfig, step: int, batch: int,
                    corruption: str = "fog", severity=1.0) -> dict:
    data = batch_at(cfg, step, batch)
    return {"images": corrupt(data["images"], (cfg.seed ^ 0xC0DE, step),
                              severity, corruption),
            "labels": data["labels"]}
