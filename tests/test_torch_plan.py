"""The launch plans of the port's kernels, checked on the CPU:
``kernels/cim.py`` ``launch_plan`` (tiles and chunk split of
``csrc/cim_mvm.cu``), ``kernels/decision.py`` ``decision_plan`` (the
decision kernel's variant and, above N = 32, its tiles) and
``kernels/bayes.py`` ``head_plan`` (tile, threads and samples a block
carries of ``csrc/bayes_mvm.cu``).

The CIM plan is replayed here with the kernel's own index arithmetic
(block → tile and cluster rank, thread → column and four rows, rank 0's
fold over the tile): every output of every chunk must be summed
exactly once, and every output stored exactly once, after its chunks
are folded in order 0…C−1.  The decision plan must put each (sample,
class) pair of a round on exactly one thread, a sample's classes on
neighbouring lanes of one warp.  The head plans are replayed the same
way: every sum of a block's tile is put exactly once per chunk, every
σε column a product thread reads was mixed in that sample chunk, and
every output is stored exactly once.
"""

import numpy as np
import pytest

from repro_torch.kernels import bayes
from repro_torch.kernels.cim import (CHUNK, H100_SMS, SMEM_LIMIT, CimPlan,
                                     launch_plan, make_plan)
from repro_torch.kernels.decision import (MAX_SAMPLES, SMALL_N_MAX, TILE,
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
    """N > 32 streams N in tiles: the tiled variant's three kernels."""
    plan = decision_plan(n, 4)
    assert (plan.variant, plan.np, plan.threads) == ("tiled", 0, 128)
    assert plan.tile == TILE and plan.kernels == 3


# The tiled variant's shapes: ragged and exact tiles on both sides of
# one and two tiles, the LM's padded vocabulary (qwen3-0.6b) at its
# serving B and others, mamba2-130m's head.
WIDE = [(1, 33), (7, 65), (9, 300), (5, 130), (6, 1000), (3, 4097),
        (4, 127), (4, 128), (4, 129), (4, 255), (4, 256), (4, 257),
        (3, 511), (3, 512), (3, 513), (1, 50280), (2, 50280), (8, 50280),
        (1, 152064), (4, 152064), (16, 152064), (32, 152064)]


@pytest.mark.parametrize("shape", WIDE)
def test_decision_tiled_plan_covers_each_column_once(shape):
    """Kernels A and B's index arithmetic (block (tile, slot), thread t,
    column q: n = tile·T + q·128 + t, live where n < N) reaches every
    (slot, column) exactly once, every tile holds a live column, and
    the merge's partials [B][R][tiles] have one entry a (slot, tile)."""
    b, n = shape
    plan = decision_plan(n, 20, b)
    cols = plan.tile // plan.threads
    assert cols * plan.threads == plan.tile == TILE and cols == 2
    seen = np.zeros((b, n), np.int64)
    t = np.arange(plan.threads)
    for tl in range(plan.tiles):
        cn = (tl * plan.tile + np.arange(cols)[:, None] * plan.threads
              + t).ravel()
        live = cn[cn < n]
        assert live.size > 0                  # lse's merge sees a column
        seen[:, live] += 1
    assert (seen == 1).all()
    assert plan.blocks == plan.tiles * b and plan.tiles == -(-n // TILE)


@pytest.mark.parametrize("shape", WIDE)
def test_decision_tiled_plan_fits_shared_memory_at_r64(shape):
    """Every kernel's static shared memory is sized for R = 64 and fits
    the 48 KB a block takes without opting in; R does not move it."""
    b, n = shape
    plan = decision_plan(n, MAX_SAMPLES, b)
    assert plan.smem_bytes <= SMEM_LIMIT
    assert plan == decision_plan(n, 1, b)


def test_decision_plan_fills_the_card_at_the_lm_shape():
    """qwen3-0.6b's round (B 4, N 152,064): 256 columns a tile, 594
    tiles a slot and 2,376 blocks, 18 for each of the H100's 132 SMs;
    at B 1 still every SM a block."""
    plan = decision_plan(152064, 20, 4)
    assert (plan.tile, plan.tiles, plan.blocks) == (256, 594, 2376)
    assert plan.blocks >= 18 * H100_SMS
    assert decision_plan(152064, 20, 1).blocks >= H100_SMS


@pytest.mark.parametrize("n", [1, 2, 3, 16, 31, SMALL_N_MAX])
@pytest.mark.parametrize("b", [1, 4, 32])
def test_decision_plan_small_n_unchanged(n, b):
    """The small-N plans as before the tiled variant: one kernel of B
    blocks, its variant, np and threads independent of B."""
    for r in (1, 4, 20, 64):
        plan = decision_plan(n, r, b)
        assert plan[:3] == decision_plan(n, r)[:3]
        assert (plan.variant, plan.tile, plan.kernels, plan.blocks) == \
            ("small_n", 0, 1, b)
        assert plan.smem_bytes <= SMEM_LIMIT
    assert decision_plan(2, 4)[:3] == ("small_n", 2, 32)
    assert decision_plan(2, 20)[:3] == ("small_n", 2, 64)


# The head kernels' shapes: the UQ path's (Fig. 16's batch of 64 through
# the 64 -> 2 head), kernel_bench's head at its sample counts, and the
# card tests' ragged ones (K = 130 and 200 are not multiples of 64;
# B = 70 takes two row tiles).
HEAD_PATH = (64, 64, 2, 20)
HEAD_BENCH = [(8, 512, 2048, r) for r in (4, 16, 20, 64)]
HEAD_RAGGED = [(3, 130, 70, 100), (9, 200, 33, 20), (70, 64, 5, 4),
               (8, 256, 192, 5), (4, 40, 10, 6), (1, 1, 1, 1)]
HEAD_SHAPES = [HEAD_PATH] + HEAD_BENCH + HEAD_RAGGED


def _quad(n):
    return -(-n // 4) * 4


def _head_tile_cols(kind, tn, samples):
    return _quad((samples + 1) * tn if kind == "paper" else 18 * tn)


def _head_layout_bytes(kind, tn, tb, samples, r, chunks):
    """The shared memory of ``layout`` in ``csrc/bayes_mvm.cu``, region
    by region, each rounded up to 4 floats."""
    paper = kind == "paper"
    stages = 2 if chunks > 1 else 1
    regions = [4,                                    # ADC steps
               (_quad(r) + 4) * 16,                  # selections
               stages * tb * 68,                     # x rows
               stages * 64 * tn, stages * 64 * tn,   # µ, σ
               16 * tn, 16 * tn,                     # hash prefixes
               samples * tn if paper else tb * tn,   # noise prefixes
               64 * (16 * tn + 1) if paper else 0,   # currents
               _head_tile_cols(kind, tn, samples) * (68 if paper else 64),
               tb * ((r + 1) * tn if paper else 20 * tn)]
    return 4 * sum(_quad(f) for f in regions)


def _head_replay(kind, plan, b, k, n, r):
    """Replays one block's products (micro-tiles of one row and 4
    columns, per sample chunk) and every block's epilogue under
    ``plan``: (puts[row, sum column], reads of unmixed columns,
    stored[r, b, n])."""
    tn, tb, ns = plan.tile_n, plan.tile_b, plan.samples
    sh = tn.bit_length() - 1
    paper = kind == "paper"
    cols = _head_tile_cols(kind, tn, ns)
    acols = (r + 1) * tn if paper else 20 * tn
    tiles = tb * cols // 4
    puts = np.zeros((tb, acols), np.int64)
    unmixed = 0
    for q in range(-(-r // ns) if paper else 1):
        r0 = q * ns
        rc = min(ns, r - r0) if paper else 0
        mixed = set(range(18 * tn))                  # rank16: all of W
        if paper:
            groups = -(-rc // 4)
            mixed = {(gc >> sh) * 4 * tn + u * tn + (gc & (tn - 1))
                     for gc in range(groups * tn) for u in range(4)
                     if (gc >> sh) * 4 + u < rc}
            if q == 0:
                mixed |= {ns * tn + c for c in range(tn)}
        for t in range(tiles):
            row, c4 = t % tb, 4 * (t // tb)
            for col in range(c4, c4 + 4):
                if paper:
                    mu_col = col >= ns * tn
                    if (mu_col and (q != 0 or col >= (ns + 1) * tn)) or (
                            not mu_col and (col >> sh) >= rc):
                        continue
                    acol = (col - ns * tn if mu_col else
                            (1 + r0 + (col >> sh)) * tn + (col & (tn - 1)))
                else:
                    if col >= 18 * tn:
                        continue
                    acol = (col & (tn - 1)) * 20 + (col >> sh)
                unmixed += col not in mixed
                puts[row, acol] += 1
        if not paper:                                # (x²)·(σ²)
            for t in range(tb * tn):
                puts[t >> sh, (t & (tn - 1)) * 20 + 18] += 1
    # the epilogue walks every sample r of each (row, column) item alike
    stored = np.zeros((b, n), np.int64)
    rn = np.arange(tb * tn)
    row, nn = rn >> sh, rn & (tn - 1)
    bt, nt = np.meshgrid(np.arange(-(-b // tb)), np.arange(-(-n // tn)),
                         indexing="ij")
    bb = (bt.reshape(-1, 1) * tb + row).ravel()
    gn = (nt.reshape(-1, 1) * tn + nn).ravel()
    live = (bb < b) & (gn < n)
    np.add.at(stored, (bb[live], gn[live]), 1)
    return puts, unmixed, stored


@pytest.mark.parametrize("shape", HEAD_SHAPES)
@pytest.mark.parametrize("kind", ["rank16", "paper"])
def test_head_plans_cover_each_sum_and_output_once(shape, kind):
    """Every plan the head kernel takes, the chosen one among them."""
    b, k, n, r = shape
    plans = bayes.head_plans(kind, b, k, n, r)
    assert bayes.head_plan(kind, b, k, n, r) in plans
    # the threads only stride the same items: one plan per tiling
    tilings = {p[:3]: p for p in plans}
    for plan in tilings.values():
        puts, unmixed, stored = _head_replay(kind, plan, b, k, n, r)
        if kind == "rank16":              # sum 19 of a column is unused
            puts[:, 19::20] += 1
        assert (puts == 1).all(), plan    # each sum once per chunk
        assert unmixed == 0, plan         # products read mixed columns
        assert (stored == 1).all(), plan  # each output once


@pytest.mark.parametrize("shape", HEAD_SHAPES)
@pytest.mark.parametrize("kind", ["rank16", "paper"])
def test_head_plans_fit_the_kernel(shape, kind):
    b, k, n, r = shape
    chunks = -(-k // CHUNK)
    for plan in bayes.head_plans(kind, b, k, n, r):
        assert plan.tile_b == min(64, -(-b // 4) * 4)
        assert plan.tile_n & (plan.tile_n - 1) == 0  # shifts in the kernel
        assert plan.threads in bayes.THREADS
        assert 16 * plan.tile_n <= plan.threads      # a generated column each
        if kind == "paper":
            assert 64 * plan.tile_n <= plan.threads  # a chunk's cell each
        assert plan.smem_bytes == _head_layout_bytes(
            kind, plan.tile_n, plan.tile_b, plan.samples, r, chunks)
        assert plan.smem_bytes <= bayes.SMEM_LIMIT
        assert plan.blocks == -(-n // plan.tile_n) * -(-b // plan.tile_b)
        if kind == "paper":
            assert 1 <= plan.samples <= r
        else:
            assert plan.samples == 0


def test_head_plan_at_the_uq_path_shape():
    """B=64 K=64 N=2 R=20: one chunk; all 64 rows in one tile;
    one-column tiles, so two blocks; paper carries all 20 samples; 512
    threads (the fastest plans of the sweep, PERF.md)."""
    assert bayes.head_plan("rank16", *HEAD_PATH)[:4] == (1, 64, 0, 512)
    assert bayes.head_plan("paper", *HEAD_PATH)[:4] == (1, 64, 20, 512)
    assert bayes.head_plan("paper", *HEAD_PATH).blocks == 2


@pytest.mark.parametrize("shape", HEAD_BENCH)
def test_head_plan_at_kernel_bench_shape(shape):
    """B=8 K=512 N=2048: blocks of 512 threads walk the eight chunks;
    paper carries every sample at once, up to R = 64; eight columns a
    tile (tiles give every SM a block), but at R = 64 paper's 8-column
    block would fill an SM's shared memory alone, so it takes 4."""
    r = shape[3]
    assert bayes.head_plan("rank16", *shape)[:4] == (8, 8, 0, 512)
    paper = bayes.head_plan("paper", *shape)
    width = 4 if r == 64 else 8
    assert paper[:4] == (width, 8, r, 512)
    assert paper.blocks == 2048 // width >= H100_SMS
    assert 2 * paper.smem_bytes <= bayes.SMEM_LIMIT
    assert 2 * bayes.make_head_plan("paper", *shape, 8, r, 512) \
        .smem_bytes > bayes.SMEM_LIMIT or r != 64


def test_head_plan_walks_a_narrow_deep_head():
    """kernel_bench's depth cut to 64 columns: no tile width gives every
    SM a block, so the narrowest (one column, 64 blocks), whose blocks
    walk the 8 chunks."""
    rank16 = bayes.head_plan("rank16", 8, 512, 64, 20)
    assert rank16[:5] == (1, 8, 0, 512, 64)
    assert bayes.head_plan("paper", 8, 512, 64, 20)[:5] == (1, 8, 20, 512, 64)
    assert rank16.smem_bytes == _head_layout_bytes("rank16", 1, 8, 0, 20, 8)


@pytest.mark.parametrize("shape", [(8, 512, 2048, 100), (3, 130, 70, 100)])
def test_head_plan_loops_samples_above_a_block(shape):
    """R = 100 does not fit a paper block at once: it carries 64 samples
    and loops over two sample chunks."""
    plan = bayes.head_plan("paper", *shape)
    assert plan.samples == 64 < shape[3]
    assert -(-shape[3] // plan.samples) == 2


@pytest.mark.parametrize("shape,chunks", [((3, 130, 70, 4), 3),
                                          ((9, 200, 33, 20), 4),
                                          ((4, 40, 10, 6), 1)])
@pytest.mark.parametrize("kind", ["rank16", "paper"])
def test_head_plan_k_not_a_multiple_of_64(shape, chunks, kind):
    """A last chunk of fewer than 64 rows (zero-padded in the kernel)
    still counts as a chunk: a block walking two or more double-buffers
    them.  One-column tiles leave SMs without a block here."""
    plan = bayes.head_plan(kind, *shape)
    assert plan.tile_n == 1 and plan.threads == 512
    assert plan.smem_bytes == _head_layout_bytes(
        kind, 1, plan.tile_b, plan.samples, shape[3], chunks)
