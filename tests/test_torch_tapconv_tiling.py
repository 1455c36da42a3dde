"""Kernel C's tap-convolution tiles (``tiling.tap_tile``), on the CPU.

The CUDA side mirrors this rule (``csrc/tapconv.cuh`` ``tap_tile``; the
card test ``test_tap_tile_matches_the_host_rule`` compares the two). Here:
the blocks of a conv's grid, and the accumulator fragments of a block's
threads, cover every output row and channel exactly once; every medium
stage at 512 frames gives each of an H100's 132 SMs at least two blocks;
every preset's convs fit a block's 227 KB of shared memory.
"""

import numpy as np
import pytest

from phoonnx_tpu_torch import tiling
from phoonnx_tpu_torch.models.vits.fused_stage import _check_conv
from phoonnx_tpu_torch.models.vits.model import VitsHParams

H100_SMS = 132
FRAMES = 512
QUALITIES = ("micro", "x-low", "medium", "high", "medium-istft",
             "medium-mb-istft")


def stage_convs(quality):
    """(T at 512 frames, C, taps, dilation) of every tap conv of every
    decoder stage of a preset."""
    hp = VitsHParams.preset(quality)
    t = FRAMES
    for i, rate in enumerate(hp.upsample_rates):
        t *= rate
        c = hp.upsample_initial_channel // 2 ** (i + 1)
        for k, dils in zip(hp.resblock_kernel_sizes,
                           hp.resblock_dilation_sizes):
            for d in dils:
                yield t, c, k, d
                if hp.resblock == "1":  # each unit's second conv, at 1
                    yield t, c, k, 1


def distinct(quality):
    return sorted(set(stage_convs(quality)))


def coverage(tile, batch, t, n):
    counts = np.zeros((batch, t, n), np.int32)
    for b, rows, cols in tiling.tap_blocks(tile, batch, t, n):
        counts[b, rows.start:rows.stop, cols.start:cols.stop] += 1
    return counts


@pytest.mark.parametrize("quality", ["micro", "medium", "high"])
def test_blocks_cover_every_output_once(quality):
    for t, c, k, d in distinct(quality):
        tile = tiling.tap_tile(1, t, c, k, d, H100_SMS)
        assert (coverage(tile, 1, t, c) == 1).all(), (quality, t, c, tile)


@pytest.mark.parametrize("batch,t,c,k,d", [
    (1, 1, 20, 7, 12),      # T = 1, far shorter than the halo
    (2, 50, 20, 7, 12),     # T shorter than the halo
    (3, 1001, 13, 3, 1),    # no multiple of any tile or 16-byte chunk
    (1, 257, 48, 11, 5),    # 48 channels: a 32-column class, 2 tiles
    (4, 700, 100, 5, 2),    # 100: 64-column tiles, a ragged last one
    (1, 33, 1, 3, 1),       # one channel
    (2, 4096, 256, 11, 5),  # high's widest window, batch 2
])
def test_blocks_cover_odd_shapes_once(batch, t, c, k, d):
    tile = tiling.tap_tile(batch, t, c, k, d, H100_SMS)
    assert (coverage(tile, batch, t, c) == 1).all(), tile
    assert tile.smem <= tiling.TAP_SMEM_LIMIT


@pytest.mark.parametrize("shape", sorted({
    shape for tiles in tiling.TAP_TILES.values() for shape in tiles}))
def test_fragments_cover_the_block_tile_once(shape):
    bm, bn, wn = shape
    tile = tiling.TapTile(bm, bn, wn, 16, 0)
    counts = np.zeros((bm, bn), np.int32)
    threads = set()
    for tid, row, col in tiling.tap_fragment_cells(tile):
        counts[row, col] += 1
        threads.add(tid)
    assert (counts == 1).all()
    assert threads == set(range(tile.threads))
    assert bm % tiling.TAP_WARP_ROWS == 0 and bn % wn == 0 and wn % 8 == 0


def test_medium_stages_give_every_sm_two_blocks():
    hp = VitsHParams.preset("medium")
    seen = set()
    for t, c, k, d in stage_convs("medium"):
        tile = tiling.tap_tile(1, t, c, k, d, H100_SMS)
        blocks = tiling.cdiv(t, tile.bm) * tiling.cdiv(c, tile.bn)
        assert blocks >= 2 * H100_SMS, (t, c, k, d, tile, blocks)
        seen.add(c)
    assert seen == {hp.upsample_initial_channel // 2 ** (i + 1)
                    for i in range(len(hp.upsample_rates))}
    # stage 0 (T 4,096, C 128) was one block an SM on 128 SMs before
    stage0 = tiling.tap_tile(1, FRAMES * 8, 128, 7, 12, H100_SMS)
    assert (tiling.cdiv(FRAMES * 8, stage0.bm)
            * tiling.cdiv(128, stage0.bn)) > H100_SMS


@pytest.mark.parametrize("quality", QUALITIES)
def test_every_preset_conv_fits_shared_memory(quality):
    for t, c, k, d in distinct(quality):
        for batch in (1, 4):
            tile = tiling.tap_tile(batch, t, c, k, d, H100_SMS)
            assert tile.smem == tiling.tap_smem_bytes(tile.bm, tile.bn,
                                                      tile.bk, k, d)
            assert tile.smem <= tiling.TAP_SMEM_LIMIT, (quality, c, k, d)
            assert tile.bk in (8, 16) and (tile.bk == 8 or c > 8)
        _check_conv(c, k, d)  # the wrapper takes it


def test_high_widest_window_takes_16_channel_slabs_or_fits():
    # high's first stage: 256 channels, k 11 at dilation 5 (a window of
    # BM + 50 rows) -- the case where staging all channels would not fit
    tile = tiling.tap_tile(1, FRAMES * 8, 256, 11, 5, H100_SMS)
    assert tile.smem <= tiling.TAP_SMEM_LIMIT
    everything = tiling.tap_smem_bytes(tile.bm, tile.bn, 256, 11, 5)
    assert everything > tiling.TAP_SMEM_LIMIT


def test_a_conv_no_tile_takes_raises_with_the_reason():
    with pytest.raises(ValueError, match="shared memory"):
        tiling.tap_tile(1, 100, 64, 200, 20, H100_SMS)
    with pytest.raises(ValueError, match="200 taps at dilation 20"):
        _check_conv(64, 200, 20)
