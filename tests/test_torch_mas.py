"""Kernel D (monotonic alignment search) against the JAX package.

On the CPU the port's ``maximum_path`` runs its plain version, which must
be bit-identical (``assert_array_equal``) to JAX ``maximum_path`` (the
``lax.scan`` DP), to the Pallas kernel in interpret mode, and to the host
oracle ``maximum_path_numpy`` wherever a monotonic path exists: the
oracle's triangle loops leave cells uncomputed where x_len > y_len, so
there it differs from the full-grid DP that JAX, the kernel and the port
share. An emulation of ``csrc/mas.cu`` row by row, vectorised over the
lanes with numpy (each lane's cells, the neighbour from the lane or warp
below, the decision bits packed a word a lane as the kernel packs them,
the backtrack over bits staged a chunk at a time, the index-to-dense
write),
checks the kernel's indexing and its tiling rule ``mas.plan`` against
the plain version, which the card then holds the kernel to
(``tests/test_torch_cuda.py``, ``chip_smoke.py``).
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from phoonnx_tpu.ops.mas import maximum_path as jax_maximum_path
from phoonnx_tpu.ops.mas import maximum_path_numpy as jax_numpy_oracle
from phoonnx_tpu.ops.mas_pallas import maximum_path_pallas
from phoonnx_tpu_torch.ops import mas

# (y_len, x_len) per batch element; the plane is the largest of each
CASES = {
    "ragged": [(40, 16), (31, 9), (17, 5), (40, 1)],
    "x_len_above_y_len": [(12, 20), (5, 9), (10, 3)],
    "one_valid_frame": [(1, 1), (1, 4), (24, 8)],
    "ties": [(36, 12), (20, 20), (29, 6)],
    "above_256_frames": [(300, 24), (257, 17)],
}


def _case(name, seed=0):
    return _case_of(CASES[name], seed, ties=name == "ties")


def _case_of(lengths, seed=0, ties=False):
    rng = np.random.default_rng(seed)
    t_y = max(y for y, _ in lengths)
    t_x = max(x for _, x in lengths)
    neg_cent = rng.standard_normal((len(lengths), t_y, t_x)) * 3
    if ties:
        neg_cent = np.round(neg_cent / 3)  # small integers: many exact ties
    mask = np.zeros_like(neg_cent)
    for i, (y, x) in enumerate(lengths):
        mask[i, :y, :x] = 1
    return neg_cent.astype(np.float32), mask.astype(np.float32)


@pytest.mark.parametrize("name", sorted(CASES))
def test_maximum_path_bit_identical_to_jax(name):
    neg_cent, mask = _case(name)
    got = mas.maximum_path(torch.from_numpy(neg_cent),
                           torch.from_numpy(mask)).numpy()
    scan = np.asarray(jax_maximum_path(jnp.asarray(neg_cent),
                                       jnp.asarray(mask), impl="scan"))
    pallas = np.asarray(maximum_path_pallas(
        jnp.asarray(neg_cent), jnp.asarray(mask), interpret=True))
    np.testing.assert_array_equal(got, scan)
    np.testing.assert_array_equal(got, pallas)
    for i, (y, x) in enumerate(CASES[name]):
        if x <= y:  # a monotonic path exists: the oracle agrees
            np.testing.assert_array_equal(
                got[i], jax_numpy_oracle(neg_cent[i:i + 1],
                                         mask[i:i + 1])[0])
            # one text position per valid frame, each position reached
            assert (got[i, :y].sum(1) == 1).all()
            assert (got[i, :, :x].sum(0) >= 1).all()
    assert (got[mask == 0] == 0).all()


def test_numpy_oracle_copy_matches_the_jax_package():
    for name in sorted(CASES):
        neg_cent, mask = _case(name, seed=3)
        np.testing.assert_array_equal(
            mas.maximum_path_numpy(neg_cent, mask),
            jax_numpy_oracle(neg_cent, mask))


def test_lengths_counted_in_int32_past_256():
    """A bf16 mask sums 257 ones to 256; the port counts in int32."""
    neg_cent, mask = _case("above_256_frames")
    _, y_lens, x_lens = mas.lengths_and_value(
        torch.from_numpy(neg_cent), torch.from_numpy(mask).bfloat16())
    assert y_lens.dtype == torch.int32
    assert y_lens.tolist() == [300, 257] and x_lens.tolist() == [24, 17]


def emulate_kernel(value, y_lens, x_lens):
    """csrc/mas.cu row by row for each batch element (one block each).

    Forward: thread g of ``warps * 32`` holds cells ``g*k .. g*k + k-1``
    of the row (``[threads, k]`` here); the cell left of its first comes
    from the lane below (``__shfl_up_sync``) or, for lane 0, from the last
    lane of the warp below through the exchange slots; cells past T_x
    load 0. Each row's decision bits are ``warps * 32`` words: word g has
    bit j for cell g*k + j, and x == 0 never steps back. Backtrack:
    chunks of ``chunk`` rows from row y_len - 1 down, each staged from the
    bit buffer into a double buffer and walked by one thread, whose x
    indexes become the dense path rows; rows past y_len are 0."""
    b, t_y, t_x = value.shape
    n_warps, k, chunk = mas.plan(t_x)
    threads = n_warps * 32
    neg = np.float32(mas.NEG_INF)
    x_of = np.arange(threads)[:, None] * k + np.arange(k)[None, :]
    cell_bit = np.uint32(1) << np.arange(k, dtype=np.uint32)
    path = np.full((b, t_y, t_x), np.nan, np.float32)
    for blk in range(b):
        y_n = min(max(int(y_lens[blk]), 0), t_y)
        v = np.zeros((t_y, threads * k), np.float32)
        v[:, :t_x] = value[blk]
        v = v.reshape(t_y, threads, k)
        bits = np.zeros((t_y, threads), np.uint32)
        q = np.full((threads, k), neg, np.float32)
        for y in range(y_n):
            last = q[:, k - 1].reshape(n_warps, 32)
            left = np.empty_like(last)
            left[:, 1:] = last[:, :-1]       # __shfl_up_sync
            left[1:, 0] = last[:-1, 31]      # the exchange slot
            left[0, 0] = neg
            diag = np.concatenate([left.reshape(threads, 1), q[:, :-1]], 1)
            stay = np.where(x_of == y, neg, q)
            advance = np.where(x_of == 0, np.float32(0.0 if y == 0 else neg),
                               diag)
            d = (x_of != 0) & ((x_of == y) | (q < diag))
            q = (v[y] + np.maximum(stay, advance)).astype(np.float32)
            bits[y] = (d * cell_bit[None, :]).sum(1, dtype=np.uint32)
        assert y_n == 0 or not bits[0].any()  # the walk steps on row 0 too

        path[blk, y_n:] = 0.0
        x = min(max(int(x_lens[blk]), 1), t_x) - 1
        # the staged double buffer, with the word a window may read past
        # a row's end (the next row's, or the index buffer's)
        staged = np.zeros((2, chunk * threads + 1), np.uint32)
        for c in range((y_n + chunk - 1) // chunk):
            hi = y_n - c * chunk
            lo = max(hi - chunk, 0)
            buf = staged[c & 1]
            buf[:(hi - lo) * threads] = bits[lo:hi].reshape(-1)
            idx = _walk(buf, threads, k, lo, hi, x)
            x = int(idx[0]) - _bit(bits[lo], k, int(idx[0]))
            path[blk, lo:hi] = np.arange(t_x)[None, :] == idx[:, None]
    return path


def _bit(row, k, x):
    return int(row[x // k] >> np.uint32(x % k)) & 1


def _walk(buf, words, k, lo, hi, x):
    """The kernel's walk of rows [lo, hi): a block of k rows keeps to
    columns [x - k + 1, x], so each of its rows reads one window of two
    words from word (x - k) // k, loaded before the block's steps (rows
    below lo repeat row lo). Row 0 steps on its bits too: they are 0."""
    idx = np.empty(hi - lo, np.int64)
    for top in range(hi - 1, lo - 1, -k):
        g0 = max(x - k, 0) // k
        first = g0 * k
        win = []
        for r in range(k):
            at = (max(top - r, lo) - lo) * words + g0
            win.append(int(buf[at]) | int(buf[at + 1]) << k)
        p = x - first
        for r in range(k):
            if top - r < lo:
                break
            idx[top - r - lo] = first + p
            assert 0 <= p < 2 * k
            p -= (win[r] >> p) & 1
        x = first + p
    return idx


# (lengths, integer scores) of emulated shapes beyond CASES, whose T_x
# reaches each split of a row through mas.plan: 2 and 4 warps of 4 cells,
# 8 warps (chunks of 32 rows), and the 32-cell build on 2 and 5 warps;
# each path crosses a warp boundary in the row
EMULATED = {
    "warp_boundaries": ([(300, 200), (250, 150), (200, 200)], False),
    "warp_boundaries_ties": ([(500, 450), (460, 400), (420, 420)], True),
    "eight_warps": ([(1100, 1024)], False),
    "wide_rows": ([(40, 4100), (23, 3000)], False),
    "wide_boundary": ([(1300, 1100)], False),
    "short_narrow": ([(2, 1), (1, 1)], False),
}


@pytest.mark.parametrize("name", [
    "ragged", "x_len_above_y_len", "ties", "one_valid_frame",
    "above_256_frames", *EMULATED])
def test_kernel_emulation_matches_plain(name):
    if name in EMULATED:
        lengths, ties = EMULATED[name]
        neg_cent, mask = _case_of(lengths, seed=1, ties=ties)
    else:
        neg_cent, mask = _case(name, seed=1)
    value, y_lens, x_lens = mas.lengths_and_value(torch.from_numpy(neg_cent),
                                                  torch.from_numpy(mask))
    want = mas.maximum_path_plain(value, y_lens, x_lens).numpy()
    got = emulate_kernel(value.numpy(), y_lens.numpy(), x_lens.numpy())
    np.testing.assert_array_equal(got, want)


def test_plan_covers_every_row_width():
    """The tiling rule: as few warps as hold a row at up to 4 cells a lane
    on up to 8 warps, then 32 cells a lane on up to 32 warps; a backtrack
    chunk of at most 128 rows and 8192 words; wider rows raise."""
    assert mas.plan(320) == (3, 4, 85)
    assert mas.plan(33) == (1, 2, 128)
    assert mas.plan(600) == (5, 4, 51)
    assert mas.plan(1024) == (8, 4, 32)
    assert mas.plan(1025) == (2, 32, 128)
    assert mas.plan(5000) == (5, 32, 51)
    for t_x in (1, 31, 32, 33, 511, 512, 513, 1024, 1025, 4096, 4097,
                29056, 32768):
        warps, cells, chunk = mas.plan(t_x)
        assert warps * 32 * cells >= t_x
        assert (cells <= mas.FAST_CELLS and warps <= mas.FAST_WARPS) or (
            cells == mas.WIDE_CELLS and warps <= mas.WIDE_WARPS)
        assert 1 <= chunk <= mas.CHUNK_ROWS
        assert chunk * warps * 32 <= mas.CHUNK_WORDS
    for t_x in (0, 32769):
        with pytest.raises(ValueError, match="kernel D"):
            mas.plan(t_x)


def test_cpu_call_counts_no_launch():
    neg_cent, mask = _case("ragged")
    before = mas.launches
    mas.maximum_path(torch.from_numpy(neg_cent), torch.from_numpy(mask))
    assert mas.launches == before
