"""Kernel D (monotonic alignment search) against the JAX package.

On the CPU the port's ``maximum_path`` runs its plain version, which must
be bit-identical (``assert_array_equal``) to JAX ``maximum_path`` (the
``lax.scan`` DP), to the Pallas kernel in interpret mode, and to the host
oracle ``maximum_path_numpy`` wherever a monotonic path exists: the
oracle's triangle loops leave cells uncomputed where x_len > y_len, so
there it differs from the full-grid DP that JAX, the kernel and the port
share. A step-by-step emulation of ``csrc/mas.cu`` (blocks, the
double-buffered rows, the score scratch, the one-thread backtrack) checks
the kernel's indexing against the plain version, which the card then
holds the kernel to (``tests/test_torch_cuda.py``, ``chip_smoke.py``).
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
    lengths = CASES[name]
    rng = np.random.default_rng(seed)
    t_y = max(y for y, _ in lengths)
    t_x = max(x for _, x in lengths)
    neg_cent = rng.standard_normal((len(lengths), t_y, t_x)) * 3
    if name == "ties":
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


def emulate_kernel(value, y_lens, x_lens, threads=32):
    """csrc/mas.cu step by step: one block per batch element, threads
    striding over x with the previous row in a double buffer, every row
    also stored to the score scratch, the path zeroed, then thread 0
    backtracking through the scratch."""
    b, t_y, t_x = value.shape
    neg = np.float32(-1e9)
    path = np.full((b, t_y, t_x), np.nan, np.float32)
    scratch = np.full((b, t_y, t_x), np.nan, np.float32)
    for blk in range(b):
        rows = np.empty((2, t_x), np.float32)
        prev, cur = 0, 1
        rows[prev] = neg
        for y in range(t_y):
            for tid in range(threads):
                for x in range(tid, t_x, threads):
                    stay = neg if x == y else rows[prev, x]
                    if x == 0:
                        advance = np.float32(0.0) if y == 0 else neg
                    else:
                        advance = rows[prev, x - 1]
                    s = np.float32(value[blk, y, x] + max(stay, advance))
                    rows[cur, x] = s
                    scratch[blk, y, x] = s
            prev, cur = cur, prev  # __syncthreads(), swap the buffers
        path[blk] = 0.0
        x = min(max(int(x_lens[blk]), 1), t_x) - 1
        for y in range(t_y - 1, -1, -1):
            inside = y < y_lens[blk]
            if inside:
                path[blk, y, x] = 1.0
            qp = scratch[blk, max(y - 1, 0)]
            advance = x != 0 and (x == y or qp[x] < qp[max(x - 1, 0)])
            if inside and y > 0 and advance:
                x -= 1
    return path


@pytest.mark.parametrize("name", ["ragged", "x_len_above_y_len", "ties"])
def test_kernel_emulation_matches_plain(name):
    neg_cent, mask = _case(name, seed=1)
    value, y_lens, x_lens = mas.lengths_and_value(torch.from_numpy(neg_cent),
                                                  torch.from_numpy(mask))
    want = mas.maximum_path_plain(value, y_lens, x_lens).numpy()
    got = emulate_kernel(value.numpy(), y_lens.numpy(), x_lens.numpy())
    np.testing.assert_array_equal(got, want)


def test_cpu_call_counts_no_launch():
    neg_cent, mask = _case("ragged")
    before = mas.launches
    mas.maximum_path(torch.from_numpy(neg_cent), torch.from_numpy(mask))
    assert mas.launches == before
