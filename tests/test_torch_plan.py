"""The launch plans of the port's two main-path kernels, checked on the
CPU: ``kernels/cim.py`` ``launch_plan`` (tiles and chunk split of
``csrc/cim_mvm.cu``) and ``kernels/decision.py`` ``decision_plan`` (the
decision kernel's variant).

The CIM plan is replayed here with the kernel's own index arithmetic
(block → tile and cluster rank, thread → column and four rows, rank 0's
fold over the tile): every output of every chunk must be summed
exactly once, and every output stored exactly once, after its chunks
are folded in order 0…C−1.  The decision plan must put each (sample,
class) pair of a round on exactly one thread, a sample's classes on
neighbouring lanes of one warp.
"""

import numpy as np
import pytest

from repro_torch.kernels.cim import (CHUNK, H100_SMS, SMEM_LIMIT, CimPlan,
                                     launch_plan, make_plan)
from repro_torch.kernels.decision import (MAX_SAMPLES, SMALL_N_MAX,
                                          decision_plan)

# The conv trunk's products: an admission of 32 slots (the serving main
# path) and a UQ batch of 64 images (Fig. 16), for 32×32 patches.
TRUNK_32 = [(7200, 64, 16), (1568, 192, 32), (288, 320, 64)]
TRUNK_64 = [(14400, 64, 16), (3136, 192, 32), (576, 320, 64)]
RAGGED = [(130, 192, 257), (8, 192, 70), (7200, 192, 64), (7200, 640, 70),
          (130, 320, 16), (8, 64, 32), (1, 64, 1), (5000, 512, 48)]


def _replay(plan: CimPlan, m: int, k: int, n: int):
    """(summed[m, n, c], stored[m, n]): how often the kernel's index
    arithmetic under ``plan`` sums chunk c of output (m, n) and stores
    (m, n)."""
    chunks = k // CHUNK
    tiles_m = -(-m // plan.tile_m)
    tiles_n = -(-n // plan.tile_n)
    rs = plan.tile_m // 4
    tid = np.arange(plan.threads)
    col, g = tid % plan.tile_n, tid // plan.tile_n
    assert (g + 3 * rs < plan.tile_m).all()          # rows inside the tile
    summed = np.zeros((tiles_m * plan.tile_m, tiles_n * plan.tile_n,
                       chunks), np.int64)
    stored = np.zeros(summed.shape[:2], np.int64)
    outputs = plan.tile_m * plan.tile_n
    for tm in range(tiles_m):
        for tn in range(tiles_n):
            m0, n0 = tm * plan.tile_m, tn * plan.tile_n
            for rank in range(plan.split):
                own = range(chunks) if plan.split == 1 else [rank]
                for i in range(4):
                    for c in own:
                        np.add.at(summed, (m0 + g + i * rs, n0 + col, c), 1)
                if plan.split == 1:                  # each thread stores its 4
                    for i in range(4):
                        np.add.at(stored, (m0 + g + i * rs, n0 + col), 1)
                elif rank == 0:                      # rank 0 folds the tile
                    o = np.arange(0, outputs, plan.threads)[:, None] + tid
                    o = o[o < outputs]
                    np.add.at(stored, (m0 + o // plan.tile_n,
                                       n0 + o % plan.tile_n), 1)
    return summed[:m, :n], stored[:m, :n]


@pytest.mark.parametrize("shape", TRUNK_32 + TRUNK_64 + RAGGED)
def test_cim_plan_covers_each_output_and_chunk_once(shape):
    m, k, n = shape
    plan = launch_plan(m, k, n)
    summed, stored = _replay(plan, m, k, n)
    assert (summed == 1).all()          # every chunk of every output, once
    assert (stored == 1).all()          # every output written once
    # The fold: split blocks leave one chunk each in rank 0's shared
    # memory, which adds ranks 0…split−1 = chunks 0…C−1; an unsplit block
    # walks them in order.
    assert plan.split in (1, k // CHUNK)


@pytest.mark.parametrize("shape", TRUNK_32 + TRUNK_64 + RAGGED)
def test_cim_plan_fits_the_kernel(shape):
    m, k, n = shape
    plan = launch_plan(m, k, n)
    assert plan.tile_n == min(64, -(-n // 16) * 16)  # N=16 wastes no thread
    assert plan.tile_m in (4, 8, 16, 32)
    assert plan.threads == plan.tile_m * plan.tile_n // 4 <= 512
    assert plan.smem_bytes <= SMEM_LIMIT
    assert plan.split <= 8                           # a portable cluster


@pytest.mark.parametrize("shape", TRUNK_32 + TRUNK_64)
def test_cim_plan_fills_the_card_at_trunk_shapes(shape):
    """Every trunk shape puts a block on every SM but the third conv of
    a 32-slot admission, (288, 320, 64): its split at tile_m 16 makes 90
    blocks, which ran faster than tile_m 8's 180 blocks in
    ``chip_smoke.py``'s plan sweep on the H100 (PERF.md)."""
    plan = launch_plan(*shape)
    if shape == (288, 320, 64):
        assert (plan.tile_m, plan.split, plan.blocks) == (16, 5, 90)
    else:
        assert plan.blocks >= H100_SMS
    if shape[1] > CHUNK and launch_plan(shape[0], CHUNK, shape[2]).blocks \
            < H100_SMS:
        assert plan.split == shape[1] // CHUNK       # chunks run at once


def test_cim_plan_at_the_main_path_shapes():
    """The plans the served path launches (32 slots), as the kernel's
    source note describes them."""
    got = [launch_plan(*s)[:3] for s in TRUNK_32]
    assert got == [(32, 16, 1), (16, 32, 3), (16, 64, 5)]


def test_cim_plan_at_the_uq_batch_shapes():
    """A UQ batch of 64 images takes the same tiles and splits."""
    got = [launch_plan(*s)[:3] for s in TRUNK_64]
    assert got == [(32, 16, 1), (16, 32, 3), (16, 64, 5)]


def test_cim_plan_of_a_product_too_small_to_fill_the_card():
    """(8, 192, 70) has 560 outputs: split over its three chunks at
    tile_m 16 it makes 6 blocks, and no plan would fill the card."""
    plan = launch_plan(8, 192, 70)
    assert plan.blocks < H100_SMS
    assert (plan.tile_m, plan.split, plan.blocks) == (16, 3, 6)


def test_cim_plan_split_shrinks_the_tile_to_fit_shared_memory():
    """Eight chunks of 64-wide tiles hold 16 rows' codes in no less
    than 53.5 KB, over the 48 KB a block takes without opting in: the
    split takes tile_m 8."""
    plan = launch_plan(8, 512, 70)
    assert (plan.tile_m, plan.split) == (8, 8)
    assert make_plan(8, 70, 16, 64, 8).smem_bytes > SMEM_LIMIT
    assert plan.smem_bytes <= SMEM_LIMIT


def test_cim_plan_walks_chunks_when_the_tiles_fill_the_card_or_k_is_deep():
    assert launch_plan(7200, 192, 64).split == 1     # tiles fill the card
    assert launch_plan(288, 640, 64).split == 1      # 10 chunks > a cluster


@pytest.mark.parametrize("n", [1, 2, 3, 16, 31, SMALL_N_MAX])
@pytest.mark.parametrize("r", [1, 4, 20, 32, 33, MAX_SAMPLES])
def test_decision_plan_small_n_covers_each_pair_once(n, r):
    plan = decision_plan(n, r)
    assert plan.variant == "small_n"
    assert plan.np >= n and plan.np & (plan.np - 1) == 0 and plan.np <= 32
    assert plan.threads % 32 == 0 and 32 <= plan.threads <= 1024
    # the kernel's pair loop: pair = base + tid, r = pair >> log2(np),
    # n = pair & (np - 1)
    pairs = np.arange(0, r * plan.np, plan.threads)[:, None] \
        + np.arange(plan.threads)
    rr, nn = pairs // plan.np, pairs % plan.np
    live = (rr < r) & (nn < n)
    seen = np.zeros((r, n), np.int64)
    np.add.at(seen, (rr[live], nn[live]), 1)
    assert (seen == 1).all()
    # a sample's np columns sit on neighbouring lanes of one warp
    warp = pairs // 32
    first = pairs - nn                               # the sample's lane 0
    assert (first // 32 == warp).all()


@pytest.mark.parametrize("n", [SMALL_N_MAX + 1, 130, 300, 2048])
def test_decision_plan_routes_wide_n_to_streaming(n):
    plan = decision_plan(n, 4)
    assert (plan.variant, plan.np, plan.threads) == ("streaming", 0, 128)
