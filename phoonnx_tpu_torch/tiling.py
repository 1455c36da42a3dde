"""Work partition of the persistent kernels A and B (``csrc/persist.cuh``).

Each kernel is one cooperative launch whose blocks stride over a list of
output tiles in every phase. This module holds the host's side of that
partition: the tile shape (mirroring the header's constants), the grid
size, the split-K factors of kernel A's narrow products, the order in
which the kernel lists a phase's tiles (:func:`work_items`, the formula of
``persist.cuh``'s ``decode``) and the blocks that take them
(:func:`first_item`). The tests check on the CPU that the tiles of every
phase cover each output element once, or once per split-K part whose
slab ranges partition the reduction, and that each tile goes to one
block.
"""

from typing import Iterator, NamedTuple, Tuple

# persist.cuh: a tile is TILE_M rows x TILE_N columns, the reduction runs
# in SLAB_K-deep slabs
TILE_M = 16
TILE_N = 32
SLAB_K = 32
# resident blocks an SM is given at most: more would lengthen every grid
# barrier for phases that have no more tiles than this fills
MAX_BLOCKS_PER_SM = 4
# split-K parts at most (each is a [B, T, N] plane of partial sums)
MAX_SPLIT = 8


def cdiv(a: int, b: int) -> int:
    return -(-a // b)


def grid_size(blocks_per_sm: int, sms: int) -> int:
    """Blocks of a cooperative launch: what the card holds at once, at
    most MAX_BLOCKS_PER_SM an SM. Raises if not one block fits."""
    if blocks_per_sm < 1 or sms < 1:
        raise RuntimeError(f"the kernel fits {blocks_per_sm} blocks on each "
                           f"of {sms} SMs: a cooperative launch is impossible")
    return sms * min(blocks_per_sm, MAX_BLOCKS_PER_SM)


def n_slabs(taps: int, cin: int) -> int:
    """Reduction slabs of a tap-form product: taps x ceil(cin / SLAB_K)."""
    return taps * cdiv(cin, SLAB_K)


def split_k(tiles: int, slabs: int, grid: int) -> Tuple[int, int]:
    """(parts, slabs per part) for a product of `tiles` output tiles: as
    many parts as it takes to give every block of the grid a work item, at
    most MAX_SPLIT and at most one part a slab, none of them empty."""
    want = max(1, min(MAX_SPLIT, slabs, cdiv(grid, tiles)))
    per = cdiv(slabs, want)
    return cdiv(slabs, per), per


class EncoderPlan(NamedTuple):
    grid: int
    split_o: int
    per_o: int
    split_2: int
    per_2: int

    @property
    def parts(self) -> int:
        """Partial-sum planes of [B, T, H] the kernel needs."""
        return max(self.split_o, self.split_2)


def encoder_plan(batch: int, t: int, hidden: int, filt: int, ffn_k: int,
                 grid: int) -> EncoderPlan:
    """Kernel A's split-K factors: the output projection ([H] -> [H]) and
    the FFN's second conv (ffn_k taps of [F] -> [H]) have only H output
    columns, so they are cut along the reduction too."""
    tiles = batch * cdiv(t, TILE_M) * cdiv(hidden, TILE_N)
    split_o, per_o = split_k(tiles, n_slabs(1, hidden), grid)
    split_2, per_2 = split_k(tiles, n_slabs(ffn_k, filt), grid)
    return EncoderPlan(grid, split_o, per_o, split_2, per_2)


def first_item(block: int, items: int, grid: int) -> int:
    """The first work item a block takes in a phase of `items` items (the
    next are `grid` apart; `items` means none): with fewer items than
    blocks, item w goes to block w * grid // items, spreading the items
    over the whole grid (``persist.cuh``'s ``first_item``)."""
    if items >= grid:
        return block
    w = cdiv(block * items, grid)
    return w if w < items and w * grid // items == block else items


def work_items(batch: int, t: int, n: int, slabs: int, splits: int = 1,
               per: int = 0) -> Iterator[Tuple[int, range, range, range]]:
    """The tiles of one product phase in the kernel's order: item w is
    (split s, batch b, row tile, column tile) with the column tile
    fastest. Yields (b, rows, output columns, slabs) per item."""
    per = per or slabs
    tiles_m, tiles_n = cdiv(t, TILE_M), cdiv(n, TILE_N)
    for w in range(tiles_m * tiles_n * batch * splits):
        tn, rest = w % tiles_n, w // tiles_n
        tm, rest = rest % tiles_m, rest // tiles_m
        b, s = rest % batch, rest // batch
        q0 = s * per
        yield (b, range(tm * TILE_M, min(t, (tm + 1) * TILE_M)),
               range(tn * TILE_N, min(n, (tn + 1) * TILE_N)),
               range(q0, min(slabs, q0 + per)))
