"""The work partition of the persistent kernels A and B (``tiling.py``).

Each kernel's blocks stride over the tiles that ``tiling.work_items``
lists, in the order ``csrc/persist.cuh`` decodes them. These tests check,
for a range of batch sizes, lengths and card sizes, that every output
element of every product phase is covered by exactly one tile, or by
exactly one tile of each split-K part, that the parts' slab ranges
partition the reduction, and that every tile goes to exactly one block.
CPU only: no kernel runs.
"""

import numpy as np
import pytest

from phoonnx_tpu_torch import tiling

# (SMs, blocks an SM holds): an H100, a smaller card, one SM
CARDS = [(132, 8), (132, 1), (114, 3), (1, 1)]
SHAPES = [(1, 1), (1, 5), (1, 37), (1, 128), (4, 128), (2, 509), (3, 1024)]


def coverage(batch, t, n, slabs, splits=1, per=0):
    """Check that the tiles of each split-K part cover every output element
    once and that the parts' slab ranges partition the reduction."""
    count = np.zeros((splits, batch, t, n), np.int32)
    ranges = set()
    for b, ts, cols, qs in tiling.work_items(batch, t, n, slabs, splits,
                                             per):
        assert len(ts) and len(cols) and len(qs), "an empty work item"
        assert len(ts) <= tiling.TILE_M and len(cols) <= tiling.TILE_N
        s = qs.start // (per or slabs)
        count[s, b, ts.start:ts.stop, cols.start:cols.stop] += 1
        ranges.add((qs.start, qs.stop))
    assert (count == 1).all()
    edges = sorted(ranges)
    assert len(edges) == splits
    assert edges[0][0] == 0 and edges[-1][1] == slabs
    assert all(a[1] == b[0] for a, b in zip(edges, edges[1:]))


@pytest.mark.parametrize("sms,per_sm", CARDS)
@pytest.mark.parametrize("batch,t", SHAPES)
def test_encoder_phases_cover_once(sms, per_sm, batch, t):
    hidden, filt, ffn_k = 192, 768, 3
    grid = tiling.grid_size(per_sm, sms)
    assert sms <= grid <= sms * tiling.MAX_BLOCKS_PER_SM
    plan = tiling.encoder_plan(batch, t, hidden, filt, ffn_k, grid)
    # QKV and FFN first conv: whole reductions
    for n, slabs in ((3 * hidden, tiling.n_slabs(1, hidden)),
                     (filt, tiling.n_slabs(ffn_k, hidden))):
        coverage(batch, t, n, slabs)
    # output projection and FFN second conv: split-K parts
    for splits, per, slabs in (
            (plan.split_o, plan.per_o, tiling.n_slabs(1, hidden)),
            (plan.split_2, plan.per_2, tiling.n_slabs(ffn_k, filt))):
        assert 1 <= splits <= min(tiling.MAX_SPLIT, slabs)
        assert splits <= plan.parts
        coverage(batch, t, hidden, slabs, splits, per)


def test_split_k_fills_the_grid():
    """At batch 1 and 128 text positions on an H100 the narrow products
    get as many work items as the grid has blocks, up to MAX_SPLIT."""
    grid = tiling.grid_size(8, 132)
    plan = tiling.encoder_plan(1, 128, 192, 768, 3, grid)
    tiles = 8 * 6
    assert plan.split_2 == tiling.MAX_SPLIT
    assert plan.split_o * tiles >= 132
    assert tiling.split_k(1000, 12, grid) == (1, 12)


@pytest.mark.parametrize("batch,t", SHAPES)
def test_flow_phases_cover_once(batch, t):
    half, hidden, k = 96, 192, 5
    # pre, in-conv (gate pairs interleaved), res/skip, last skip-only, post
    for n, slabs in ((hidden, tiling.n_slabs(1, half)),
                     (2 * hidden, tiling.n_slabs(k, hidden)),
                     (2 * hidden, tiling.n_slabs(1, hidden)),
                     (hidden, tiling.n_slabs(1, hidden)),
                     (half, tiling.n_slabs(1, hidden))):
        coverage(batch, t, n, slabs)


@pytest.mark.parametrize("grid", [1, 132, 396, 528])
@pytest.mark.parametrize("items", [1, 16, 96, 131, 384, 396, 1000])
def test_each_item_goes_to_one_block(grid, items):
    """Blocks take items first_item(b), first_item(b) + grid, ...: every
    item exactly once, and with fewer items than blocks, one a block
    spread over the whole grid."""
    taken = []
    for b in range(grid):
        w = tiling.first_item(b, items, grid)
        taken.extend(range(w, items, grid))
        if items < grid:
            assert w == items or w * grid // items == b
    assert sorted(taken) == list(range(items))
    if items < grid:
        owners = [b for b in range(grid)
                  if tiling.first_item(b, items, grid) < items]
        assert owners[-1] >= grid - grid // items - 1


def test_no_cooperative_launch_without_a_resident_block():
    with pytest.raises(RuntimeError, match="cooperative"):
        tiling.grid_size(0, 132)
