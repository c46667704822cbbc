"""The decision kernel's tiled variant (N > 32), its algorithm on the CPU.

``csrc/decision.cu`` splits a round's N columns into tiles: per (slot,
tile, sample) the tile's max logit m_t, S1 = Σ e^(l−m_t) and
S2 = Σ e^(l−m_t)·(l−m_t); the tiles merged into lse and the entropy
(no second pass over N for it); then p = exp(l − lse) per column,
summed over the samples.  ``kernels/decision.decision_stats_tiled_plain``
is that algorithm in plain PyTorch.  Here it is held against the JAX
reference's oracle ``repro.kernels.ref.decision_stats_ref`` and against
the port's ``decision_stats_plain`` (log-softmax over the whole row),
at N of 33, 300 and 4,097 with a tile width that leaves a ragged last
tile and one that leaves a single tile, R of 1, 20 and 64, with and
without read noise, half the slots masked; then with read noise keyed
on global ``rows`` and one selection row shared by the slots.  The
kernel itself is held against ``decision_stats_plain`` on the card by
``tests/test_torch_cuda.py`` and ``chip_smoke.py``.

Tolerance rtol/atol 1e-5, as ``tests/test_torch_decision.py``: the
tiled merge and the one-shot log-softmax sum in different orders.  Each
statistic is also held to rtol 1e-4 with absolute floors of 1e-4 × R/N
(sum_p), × R/N² (sum_psq) and × R (the entropies), as the card's test
at vocabulary width: at N = 4,097 a sum_psq entry is ~1e-6, which atol
1e-5 alone would not see.
"""

import dataclasses
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import clt_grng as jg
from repro.core import sampling as js
from repro.kernels import ref as jref
from repro_torch.core import clt_grng as tg
from repro_torch.core import sampling as ts
from repro_torch.kernels import decision as tdec
from repro_torch.serving import adaptive as tad

KEYS = ("sum_p", "sum_psq", "sum_ent", "sum_entsq")
B, K = 4, 16
# (N, a tile width leaving a ragged last tile, one leaving a single tile)
TILES = {33: (16, 64), 300: (128, 512), 4097: (128, 8192)}


def _inputs(b, k, n, seed):
    rng = np.random.default_rng(seed)
    mu = (rng.standard_normal((k, n)) * 0.5).astype(np.float32)
    sig = (np.log1p(np.exp(rng.standard_normal((k, n)) - 3)) * 0.4).astype(
        np.float32)
    return mu, sig, rng.standard_normal((b, k)).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _bases(n, read_sigma, seed=0):
    """One numpy-seeded head and activations through both packages'
    ``activation_basis``: (reference basis, port basis, configs)."""
    mu, sig, x = _inputs(B, K, n, seed)
    gj = dataclasses.replace(jg.GRNGConfig(), read_sigma=read_sigma)
    hj = js.BayesHeadConfig(mode="rank16", grng=gj,
                            compute_dtype=jnp.float32, hoist_basis=True)
    abj = js.activation_basis(js.prepare_serving_head(
        jnp.asarray(mu), jnp.asarray(sig), hj), jnp.asarray(x), hj)
    gt = tg.GRNGConfig(read_sigma=read_sigma)
    ht = ts.BayesHeadConfig(mode="rank16", grng=gt,
                            compute_dtype=torch.float32, hoist_basis=True)
    abt = ts.activation_basis(
        ts.prepare_serving_head(torch.as_tensor(mu), torch.as_tensor(sig),
                                ht), torch.as_tensor(x), ht)
    return abj, abt, gj, gt


def _round(r, shared_sel=False):
    """A round's selections and absolute stream indices at per-slot
    offsets (the integer streams are bit-equal in both packages,
    tests/test_torch_core.py)."""
    base = torch.arange(B, dtype=torch.int64) * 100 + 7
    drawn = torch.full((B,), 3, dtype=torch.int32)
    sel = tad.stream_selections(tg.GRNGConfig(), base, drawn, r)
    idx = tad.stream_indices(base, drawn, r)
    if shared_sel:
        sel, idx = sel[:, 0].contiguous(), idx[:, 0].contiguous()
    return sel, idx


def _three_ways(n, r, read_sigma, tile, shared_sel=False, rows=None):
    """(tiled plain, port plain, reference oracle) on one round."""
    abj, abt, gj, gt = _bases(n, read_sigma)
    sel, idx = _round(r, shared_sel)
    mask = np.arange(B) % 2 == 0
    kw = dict(x_sigsq=abt.get("x_sigsq"), sample_idx=idx,
              mask=torch.as_tensor(mask),
              rows=None if rows is None else torch.as_tensor(rows))
    args = (abt["y_mu"], abt["x_sigma"], abt["m"], sel, gt)
    tiled = tdec.decision_stats_tiled_plain(*args, **kw, tile=tile)
    plain = tdec.decision_stats_plain(*args, **kw)
    oracle = jref.decision_stats_ref(
        abj["y_mu"], abj["x_sigma"], abj["m"], jnp.asarray(sel.numpy()), gj,
        x_sigsq=abj.get("x_sigsq"),
        sample_idx=jnp.asarray(idx.numpy().astype(np.uint32)),
        mask=jnp.asarray(mask),
        rows=None if rows is None else jnp.asarray(rows, jnp.uint32))
    return ({k: tiled[k].numpy() for k in KEYS},
            {k: plain[k].numpy() for k in KEYS},
            {k: np.asarray(oracle[k]) for k in KEYS}, mask)


def _assert_close(got, want, msg, r):
    n = got["sum_p"].shape[-1]
    floors = {"sum_p": r / n, "sum_psq": r / n**2, "sum_ent": r,
              "sum_entsq": r}
    for key in KEYS:
        np.testing.assert_allclose(got[key], want[key], rtol=1e-5,
                                   atol=1e-5, err_msg=f"{msg}{key}")
        np.testing.assert_allclose(got[key], want[key], rtol=1e-4,
                                   atol=1e-4 * floors[key],
                                   err_msg=f"{msg}{key} (relative)")


@pytest.mark.parametrize("n", sorted(TILES))
@pytest.mark.parametrize("which", ["ragged", "single"])
@pytest.mark.parametrize("r", [1, 20, 64])
@pytest.mark.parametrize("read_sigma", [0.0, 0.4])
def test_tiled_algorithm_matches_reference(n, which, r, read_sigma):
    tile = TILES[n][which == "single"]
    tiles = -(-n // tile)
    assert (tiles == 1) == (which == "single")
    assert which == "single" or n % tile != 0        # a ragged last tile
    tiled, plain, oracle, mask = _three_ways(n, r, read_sigma, tile)
    _assert_close(tiled, oracle, "oracle:", r)
    _assert_close(tiled, plain, "plain:", r)
    for key in KEYS:
        assert (tiled[key][~mask] == 0).all(), key
    np.testing.assert_allclose(tiled["sum_p"][mask].sum(-1), r, rtol=1e-5)


@pytest.mark.parametrize("n", sorted(TILES))
@pytest.mark.parametrize("shared_sel", [False, True])
def test_tiled_algorithm_rows_and_shared_selection(n, shared_sel):
    """Read noise keyed on global slot ids (a shard's ``rows``), with a
    selection row per slot or one for all slots, R = 20."""
    rows = np.arange(B, dtype=np.int64) + 1000
    tiled, plain, oracle, _ = _three_ways(n, 20, 0.4, TILES[n][0],
                                          shared_sel=shared_sel, rows=rows)
    _assert_close(tiled, oracle, "oracle:", 20)
    _assert_close(tiled, plain, "plain:", 20)


@pytest.mark.parametrize("n", [255, 256, 257, 4097])
def test_tiled_algorithm_at_the_kernel_tile(n):
    """The kernel's tile width (``decision_plan``'s TILE = 256) at N one
    below, at and one above it and at 4,097 (a last tile of one column),
    R = 20, read noise."""
    tile = tdec.decision_plan(n, 20, B).tile
    assert tile == tdec.TILE
    tiled, plain, oracle, _ = _three_ways(n, 20, 0.4, tile)
    _assert_close(tiled, oracle, "oracle:", 20)
    _assert_close(tiled, plain, "plain:", 20)


def test_tiled_entropy_keeps_its_digits_at_large_logits():
    """Every logit shifted by +1,000: the entropy from the shifted S2
    keeps its float32 digits (the unshifted Σ e^(l−m)·l, ~1,000 times
    the entropy, would cancel), within 1e-5 of the plain version's
    log-softmax on the same logits."""
    _, abt, _, gt = _bases(300, 0.0)
    sel, idx = _round(20)
    args = (abt["y_mu"] + 1000.0, abt["x_sigma"], abt["m"], sel, gt)
    tiled = tdec.decision_stats_tiled_plain(*args, sample_idx=idx, tile=128)
    plain = tdec.decision_stats_plain(*args, sample_idx=idx)
    _assert_close({k: v.numpy() for k, v in tiled.items()},
                  {k: v.numpy() for k, v in plain.items()}, "plain:", 20)
