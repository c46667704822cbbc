"""The port's synthetic SARD stream against the reference.

The reference draws with ``jax.random``, the port with
``torch.Generator``s, so their images agree in distribution, not in
bits.  Over 8 batches of 32 (128 images per label) the stated band is:
per-label pixel mean within 0.1, pixel standard deviation and mean
per-image peak within 10 % of the reference's (the two differ by
≤ 0.04, ≤ 2 % and ≤ 4 % at this size).

Corruptions: fog and motion are deterministic and must match exactly,
at one severity for the batch and at one per image (motion's per-image
tap count in float32, capped at 17 taps); frost must match exactly on
the reference's own mask; snow's speck rate must sit within a 4σ
binomial band of 0.04·severity.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data import sard as jsard
from repro_torch.data import sard as tsard
from repro_torch.launch.serve import make_sar_stream


def _stats(imgs, labels):
    out = {}
    for y in (0, 1):
        x = imgs[labels == y]
        out[y] = (float(x.mean()), float(x.std()),
                  float(x.reshape(len(x), -1).max(1).mean()))
    return out


def test_batches_shapes_dtypes_and_balance():
    cfg = tsard.SardConfig(seed=7)
    b = tsard.batch_at(cfg, 1000, 32)
    assert b["images"].shape == (32, 32, 32, 1)
    assert b["images"].dtype == torch.float32
    assert b["labels"].dtype == torch.int32
    assert int(b["labels"].sum()) == 16
    again = tsard.batch_at(cfg, 1000, 32)            # pure function of step
    assert torch.equal(again["images"], b["images"])
    assert not torch.equal(tsard.batch_at(cfg, 1001, 32)["images"],
                           b["images"])


def test_batches_match_reference_in_distribution():
    steps = range(1000, 1008)
    jb = [jsard.batch_at(jsard.SardConfig(seed=7), s, 32) for s in steps]
    tb = [tsard.batch_at(tsard.SardConfig(seed=7), s, 32) for s in steps]
    want = _stats(np.concatenate([np.asarray(b["images"]) for b in jb]),
                  np.concatenate([np.asarray(b["labels"]) for b in jb]))
    got = _stats(np.concatenate([b["images"].numpy() for b in tb]),
                 np.concatenate([b["labels"].numpy() for b in tb]))
    for y in (0, 1):
        (gm, gs, gp), (wm, ws, wp) = got[y], want[y]
        assert abs(gm - wm) < 0.1, (y, gm, wm)
        assert abs(gs / ws - 1) < 0.10, (y, gs, ws)
        assert abs(gp / wp - 1) < 0.10, (y, gp, wp)
    # victims raise the per-image peak in both
    assert got[1][2] > got[0][2] + 0.3 and want[1][2] > want[0][2] + 0.3


@pytest.mark.parametrize("severity", [1.0, 0.4])
def test_corrupt_fog_exact(severity):
    x = np.random.default_rng(0).standard_normal((4, 32, 32, 1)).astype(
        np.float32)
    want = np.asarray(jsard.corrupt_fog(jnp.asarray(x), None, severity))
    got = tsard.corrupt_fog(torch.as_tensor(x), severity).numpy()
    np.testing.assert_array_equal(got, want)


def test_stream_meta_and_corrupted_head():
    reqs = make_sar_stream(40, corrupt_frac=0.25)
    assert [r.rid for r in reqs] == list(range(40))
    assert sum(r.meta["corrupted"] for r in reqs) == 8 + 8
    assert reqs[0].payload.shape == (32, 32, 1)
    frost = make_sar_stream(40, corrupt_frac=0.25, corruption="frost")
    assert [r.meta for r in frost] == [r.meta for r in reqs]
    for f, r in zip(frost, reqs):     # only the corrupted head differs
        assert np.array_equal(f.payload, r.payload) != r.meta["corrupted"]
    with pytest.raises(ValueError, match="haze"):
        make_sar_stream(4, corrupt_frac=0.5, corruption="haze")


def _images(seed=0, b=6):
    return np.random.default_rng(seed).standard_normal(
        (b, 32, 32, 1)).astype(np.float32)


SEVERITIES = np.array([0.0, 0.3, 1.0, 1.7, 4.9, 7.5], np.float32)


@pytest.mark.parametrize("corruption", ["fog", "motion"])
@pytest.mark.parametrize("severity", [0.4, 1.0, 2.5, "per_image"])
def test_deterministic_corruptions_exact(corruption, severity):
    x = _images(1)
    sev = SEVERITIES if severity == "per_image" else severity
    key = jax.random.PRNGKey(0)
    want = np.asarray(jsard.corrupt(jnp.asarray(x), key, sev, corruption))
    got = tsard.corrupt(torch.as_tensor(x), (0,), sev, corruption).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("severity", [0.6, "per_image"])
def test_frost_exact_on_the_reference_mask(severity):
    """The reference's masks (its ``_smooth_noise`` of the batch key, or
    of each image's split key) through the port's deterministic part."""
    x = _images(2)
    key = jax.random.PRNGKey(5)
    if severity == "per_image":
        sev = SEVERITIES
        keys = jax.random.split(key, len(x))
        mask = np.stack([np.asarray(jsard._smooth_noise(k, 32, octaves=2))
                         for k in keys])[..., None]
        tsev = torch.as_tensor(sev).reshape(-1, 1, 1, 1)
    else:
        sev = tsev = severity
        mask = np.asarray(jsard._smooth_noise(key, 32, octaves=2))[
            None, ..., None]
    want = np.asarray(jsard.corrupt(jnp.asarray(x), key, sev, "frost"))
    got = tsard.frost_with_mask(torch.as_tensor(x), torch.as_tensor(mask),
                                tsev).numpy()
    np.testing.assert_array_equal(got, want)
    # the port's own masks: the same share of frosted pixels in law
    ours = tsard.frost_masks((5,), 32, 256)
    theirs = mask if severity == "per_image" else np.stack(
        [np.asarray(jsard._smooth_noise(k, 32, octaves=2))
         for k in jax.random.split(key, 6)])
    assert abs(float((ours > 0.7).float().mean())
               - float((theirs > 0.7).mean())) < 0.1


@pytest.mark.parametrize("severity", [0.5, 1.0, "per_image"])
def test_snow_speck_rate_in_binomial_band(severity):
    """Per image, specks (pixels set to 2.0 where the image was not)
    counted over 64 images of 1024 pixels: the rate lies within 4σ of
    0.04·severity, σ the binomial SD of that count."""
    x = torch.as_tensor(_images(3, 64)) * 0.1          # never 2.0
    sev = (np.linspace(0.0, 1.0, 64).astype(np.float32)
           if severity == "per_image" else np.full(64, severity, np.float32))
    arg = sev if severity == "per_image" else float(severity)
    y = tsard.corrupt(x, (9, 1), arg, "snow")
    specks = (y == 2.0) & (x != 2.0)
    assert torch.equal(torch.where(specks, x, y), x)   # only specks change
    n = 32 * 32
    if severity == "per_image":
        counts = specks.reshape(64, -1).sum(1).numpy()
        p = 0.04 * sev
        assert (np.abs(counts - n * p) <= 4 * np.sqrt(n * p * (1 - p))).all()
        assert counts[0] == 0
        assert tsard.corrupt(x, (9, 1), arg, "snow").equal(y)
        assert not tsard.corrupt(x, (9, 2), arg, "snow").equal(y)
    total, p = 64 * n, 0.04 * float(severity if severity != "per_image"
                                     else sev.mean())
    assert abs(int(specks.sum()) - total * p) <= 4 * np.sqrt(
        total * p * (1 - p))


@pytest.mark.parametrize("corruption", ["fog", "frost", "motion", "snow"])
def test_corrupted_batches_are_pure_functions_of_the_step(corruption):
    cfg = tsard.SardConfig(seed=7)
    a = tsard.corrupted_batch(cfg, 10_000, 8, corruption, 1.0)
    b = tsard.corrupted_batch(cfg, 10_000, 8, corruption, 1.0)
    clean = tsard.batch_at(cfg, 10_000, 8)
    assert torch.equal(a["images"], b["images"])
    assert torch.equal(a["labels"], clean["labels"])
    assert a["images"].dtype == torch.float32
    assert not torch.equal(a["images"], clean["images"])
