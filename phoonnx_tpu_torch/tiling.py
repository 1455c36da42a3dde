"""Work partition of the port's hand-written kernels, on the host side.

Kernels A and B (``csrc/persist.cuh``) are each one cooperative launch
whose blocks stride over a list of output tiles in every phase. This
module holds the host's side of that partition: the tile shape
(mirroring the header's constants), the grid size, the split-K factors of
kernel A's narrow products, the order in which the kernel lists a phase's
tiles (:func:`work_items`, the formula of ``persist.cuh``'s ``decode``)
and the blocks that take them (:func:`first_item`).

Kernel C's tap convolution (``csrc/tapconv.cuh``) launches one grid a
conv; :func:`tap_tile` is the tile rule its C side mirrors
(``tap_tile``), and :func:`tap_blocks` the output each block of that
grid owns.

The tests check on the CPU that the tiles of every phase or grid cover
each output element once (or once per split-K part whose slab ranges
partition the reduction), and that each tile goes to one block.
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


# tapconv.cuh: a warp multiplies TAP_WARP_ROWS rows; slabs ring through
# TAP_STAGES stages; a block may use TAP_SMEM_LIMIT bytes of shared memory
# and a slab of 16 channels is taken while the ring fits TAP_SMEM_TARGET
# (four blocks an SM); a tile is as large as still gives every SM
# TAP_MIN_BLOCKS_PER_SM blocks
TAP_WARP_ROWS = 32
TAP_STAGES = 2
TAP_SMEM_LIMIT = 227 * 1024
TAP_SMEM_TARGET = TAP_SMEM_LIMIT // 4
TAP_MIN_BLOCKS_PER_SM = 2
# (rows, columns, warp columns) per output-width class, largest first
TAP_TILES = {
    64: ((64, 64, 32), (32, 64, 32), (32, 32, 16)),
    32: ((128, 32, 32), (64, 32, 32), (32, 32, 16)),
    16: ((128, 16, 16), (64, 16, 16), (32, 16, 16)),
}


class TapTile(NamedTuple):
    bm: int  # output rows of a block
    bn: int  # output columns of a block
    wn: int  # output columns of a warp (which takes TAP_WARP_ROWS rows)
    bk: int  # input channels of a slab
    smem: int  # dynamic shared memory of a block, bytes

    @property
    def threads(self) -> int:
        return (self.bm // TAP_WARP_ROWS) * (self.bn // self.wn) * 32


def tap_smem_bytes(bm: int, bn: int, bk: int, taps: int, dil: int) -> int:
    """The ring of (window, weights) slabs and the window's lo half."""
    win = (bm + (taps - 1) * dil) * (bk + 4)
    wts = taps * bk * (bn + 8)
    return 4 * ((TAP_STAGES + 1) * win + TAP_STAGES * wts)


def tap_class(n: int) -> int:
    """The output-width class of a conv with n output channels."""
    padded = cdiv(n, 16) * 16
    return 64 if padded >= 64 else 32 if padded >= 32 else 16


def tap_tile(batch: int, t: int, n: int, taps: int, dil: int,
             sms: int) -> TapTile:
    """The tile of a conv of `taps` taps at dilation `dil` over [batch, t]
    rows and n channels in and out, on a card of `sms` SMs: the first
    candidate of its class whose grid gives every SM
    TAP_MIN_BLOCKS_PER_SM blocks (else the smallest); 16-channel slabs
    where n > 8 and the ring fits TAP_SMEM_TARGET, else 8; a smaller tile
    while the ring exceeds TAP_SMEM_LIMIT. Raises ValueError if none
    fits."""
    tiles = TAP_TILES[tap_class(n)]
    pick = len(tiles) - 1
    for i, (bm, bn, _) in enumerate(tiles):
        if batch * cdiv(t, bm) * cdiv(n, bn) >= TAP_MIN_BLOCKS_PER_SM * sms:
            pick = i
            break
    for bm, bn, wn in tiles[pick:]:
        deep = tap_smem_bytes(bm, bn, 16, taps, dil)
        if n > 8 and deep <= TAP_SMEM_TARGET:
            return TapTile(bm, bn, wn, 16, deep)
        shallow = tap_smem_bytes(bm, bn, 8, taps, dil)
        if shallow <= TAP_SMEM_LIMIT:
            return TapTile(bm, bn, wn, 8, shallow)
    bm, bn, _ = tiles[-1]
    raise ValueError(
        f"kernel C cannot take a conv of {taps} taps at dilation {dil} over "
        f"{n} channels: its smallest tile ({bm} x {bn}, 8-channel slabs) "
        f"stages a window of {bm + (taps - 1) * dil} rows and needs "
        f"{tap_smem_bytes(bm, bn, 8, taps, dil)} B of shared memory; a "
        f"block gets {TAP_SMEM_LIMIT}")


def tap_blocks(tile: TapTile, batch: int, t: int,
               n: int) -> Iterator[Tuple[int, range, range]]:
    """The output of each block of a tap conv's grid (x: row tile, y:
    column tile, z: batch element): (b, rows, columns)."""
    for b in range(batch):
        for y in range(cdiv(n, tile.bn)):
            for x in range(cdiv(t, tile.bm)):
                yield (b, range(x * tile.bm, min(t, (x + 1) * tile.bm)),
                       range(y * tile.bn, min(n, (y + 1) * tile.bn)))


def tap_fragment_cells(tile: TapTile) -> Iterator[Tuple[int, int, int]]:
    """(thread, row, column) within a block's tile of each accumulator
    element, as the kernel's epilogue stores it: warp w takes rows
    (w // warps_n) * TAP_WARP_ROWS and columns (w % warps_n) * wn; in an
    m16n8 fragment, lane l holds rows l // 4 and l // 4 + 8, columns
    2 * (l % 4) and the next."""
    warps_n = tile.bn // tile.wn
    for tid in range(tile.threads):
        warp, lane = divmod(tid, 32)
        g, q = divmod(lane, 4)
        wm0 = (warp // warps_n) * TAP_WARP_ROWS
        wn0 = (warp % warps_n) * tile.wn
        for mt in range(TAP_WARP_ROWS // 16):
            for h in range(2):
                for nt in range(tile.wn // 8):
                    for e in range(2):
                        yield (tid, wm0 + mt * 16 + g + 8 * h,
                               wn0 + nt * 8 + 2 * q + e)
