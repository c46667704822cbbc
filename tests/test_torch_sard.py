"""The port's synthetic SARD stream against the reference.

The reference draws with ``jax.random``, the port with
``torch.Generator``s, so their images agree in distribution, not in
bits.  Over 8 batches of 32 (128 images per label) the stated band is:
per-label pixel mean within 0.1, pixel standard deviation and mean
per-image peak within 10 % of the reference's (the two differ by
≤ 0.04, ≤ 2 % and ≤ 4 % at this size).  The fog corruption is a
deterministic blend and must match exactly.
"""

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
    with pytest.raises(NotImplementedError, match="frost"):
        make_sar_stream(4, corrupt_frac=0.5, corruption="frost")
