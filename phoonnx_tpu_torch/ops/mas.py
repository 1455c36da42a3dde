"""Kernel D: monotonic alignment search (MAS), the VITS training alignment.

PyTorch port of ``phoonnx_tpu/ops/mas.py`` (``maximum_path`` :37, the
``lax.scan`` dynamic program) whose Pallas kernel
``phoonnx_tpu/ops/mas_pallas.py`` (``_mas_kernel`` :36) becomes the
hand-written CUDA kernel ``csrc/mas.cu``.

:func:`maximum_path` counts the lengths and masks the scores as the JAX
function does, then launches the kernel for a CUDA tensor or runs
:func:`maximum_path_plain` for a CPU tensor. Both compute the JAX scan's
semantics bit for bit: a forward max-plus DP over spec frames on the full
``[T_y, T_x]`` grid (stay vs advance, the advance forced where x == y,
``-1e9`` as minus infinity), then a backtrack from ``x_len - 1`` that
stays on a tie. The kernel keeps one decision bit a cell instead of the
scores; :func:`plan` is its tiling rule (warps and cells a lane for a
row, rows of bits a backtrack chunk), shared with the C side, which
checks it. :func:`maximum_path_numpy` is a copy of the JAX package's host
oracle (the reference kernel's triangle loops), kept for the tests.
"""

import functools
from typing import Optional, Tuple

import numpy as np
import torch

from phoonnx_tpu_torch import cuda

Tensor = torch.Tensor

LIBRARY = "mas"
NEG_INF = -1e9

# ``launches``: the kernel's launches (one per maximum_path on the card),
# kept in ``cuda.LAUNCHES``. Read by callers that show a path went
# through the kernel.
__getattr__ = functools.partial(cuda.launch_count, __name__)

# The kernel's tiling limits (csrc/mas.cu): rows of up to FAST_WARPS
# warps of FAST_CELLS cells a lane, wider ones on WIDE_CELLS cells a lane
# on blocks of WIDE_WARPS; a backtrack chunk holds at most CHUNK_ROWS rows
# and CHUNK_WORDS words of decision bits. Up to FAST_CELLS cells a lane a
# row is split over as few warps as hold it: fewer cells a lane shorten a
# row's chain, more warps add a barrier a row and more bits to stage.
FAST_CELLS, FAST_WARPS = 4, 8
WIDE_CELLS, WIDE_WARPS = 32, 32
CHUNK_ROWS, CHUNK_WORDS = 128, 8192

# The phases the kernel's stamps time, in order, on block 0.
PHASES = ("forward", "backtrack", "path write")

# (y_len, x_len) per batch element of the shapes that reach each branch
# of the kernel's tiling, which the card tests and chip_smoke.py hold it
# to its plain version at: ragged with x_len > y_len; T_y above 256 and
# not a multiple of the ring (8 rows) or the backtrack chunk (128 rows
# at one warp); T_y of 1 and 2; T_x of 1, 31, 32 and 33; rows of 5
# warps; rows of 8 warps (T_x 1024, over 48 KB of shared memory, chunks
# of 32 rows); and rows of the 32-cell build (T_x above 1024) on 2 and 5
# warps, each path crossing its row's warps.
EDGES = [[(96, 40), (50, 17), (30, 33)], [(300, 64)], [(77, 40)],
         [(1, 5), (1, 1)], [(2, 2), (2, 7)], [(40, 1), (17, 1)],
         [(70, 31)], [(70, 32)], [(70, 33), (50, 20)],
         [(700, 600), (300, 550)], [(1100, 1024), (40, 700)],
         [(1300, 1025), (200, 300)], [(4200, 4100), (100, 2000)]]


def _ceil_div(a: int, b: int) -> int:
    return -(-a // b)


def plan(t_x: int) -> Tuple[int, int, int]:
    """(warps, cells, chunk) of kernel D for rows of ``t_x`` cells: the
    warps that carry a row, the cells each lane holds (thread g the cells
    ``g*cells .. g*cells + cells - 1``, whose decision bits are word g of
    the row's ``warps * 32``), and the rows of bits the backtrack stages
    at a time. Up to FAST_WARPS warps of at most FAST_CELLS cells a lane
    (T_x <= 1024), else the 32-cell build. Raises ValueError for a row no
    block holds."""
    if not 1 <= t_x <= WIDE_WARPS * 32 * WIDE_CELLS:
        raise ValueError(f"kernel D takes rows of 1 to "
                         f"{WIDE_WARPS * 32 * WIDE_CELLS} cells; got "
                         f"T_x={t_x}")
    if t_x <= FAST_WARPS * 32 * FAST_CELLS:
        warps = _ceil_div(t_x, 32 * FAST_CELLS)
        cells = _ceil_div(t_x, 32 * warps)
    else:
        warps, cells = _ceil_div(t_x, 32 * WIDE_CELLS), WIDE_CELLS
    chunk = max(1, min(CHUNK_ROWS, CHUNK_WORDS // (warps * 32)))
    return warps, cells, chunk


def lengths_and_value(neg_cent: Tensor, attn_mask: Tensor):
    """(value f32, y_lens int32, x_lens int32) as ``mas.py:74-79`` counts
    them: int32 sums of the mask's first column and first row, at least 1
    (a half-precision sum would quantize above 256), and the scores zeroed
    outside the mask."""
    y_lens = torch.clamp(
        torch.sum(attn_mask[:, :, 0].to(torch.int32), dim=1), min=1)
    x_lens = torch.clamp(
        torch.sum(attn_mask[:, 0, :].to(torch.int32), dim=1), min=1)
    value = torch.where(attn_mask > 0, neg_cent,
                        torch.zeros((), dtype=neg_cent.dtype,
                                    device=neg_cent.device)).float()
    return (value.contiguous(), y_lens.to(torch.int32).contiguous(),
            x_lens.to(torch.int32).contiguous())


def maximum_path(neg_cent: Tensor, attn_mask: Tensor) -> Tensor:
    """Best monotonic path; neg_cent / attn_mask [B, T_y, T_x] -> 0/1 path
    [B, T_y, T_x] in neg_cent's dtype, times the mask (``mas.py:112``)."""
    value, y_lens, x_lens = lengths_and_value(neg_cent, attn_mask)
    if value.is_cuda:
        path = launch(value, y_lens, x_lens)
    else:
        path = maximum_path_plain(value, y_lens, x_lens)
    return path.to(neg_cent.dtype) * attn_mask


def maximum_path_plain(value: Tensor, y_lens: Tensor,
                       x_lens: Tensor) -> Tensor:
    """The function kernel D computes, in plain PyTorch ops: a Python loop
    over T_y, vectorised over batch and T_x. value [B, T_y, T_x] f32,
    lengths [B] int32 -> path [B, T_y, T_x] f32."""
    b, t_y, t_x = value.shape
    dev = value.device
    neg = torch.full((), NEG_INF, dtype=torch.float32, device=dev)
    x_idx = torch.arange(t_x, device=dev)[None, :]
    q_prev = torch.full((b, t_x), NEG_INF, dtype=torch.float32, device=dev)
    q_all = torch.empty((t_y, b, t_x), dtype=torch.float32, device=dev)
    for y in range(t_y):
        stay = torch.where(x_idx == y, neg, q_prev)
        # x == 0 has no diagonal predecessor; its path starts at y == 0
        first = torch.full((b, 1), 0.0 if y == 0 else NEG_INF,
                           dtype=torch.float32, device=dev)
        advance = torch.cat([first, q_prev[:, :-1]], dim=1)
        q_prev = value[:, y, :] + torch.maximum(stay, advance)
        q_all[y] = q_prev

    y_lens = y_lens.long()
    x_cur = torch.clamp(x_lens.long(), 1, t_x) - 1
    path = torch.zeros((b, t_y, t_x), dtype=torch.float32, device=dev)
    for y in range(t_y - 1, -1, -1):
        inside = y < y_lens
        path[:, y, :] = ((x_idx == x_cur[:, None])
                         & inside[:, None]).to(torch.float32)
        q_prev = q_all[max(y - 1, 0)]
        q_stay = torch.gather(q_prev, 1, x_cur[:, None])[:, 0]
        q_diag = torch.gather(q_prev, 1,
                              torch.clamp(x_cur - 1, min=0)[:, None])[:, 0]
        advance = (x_cur != 0) & ((x_cur == y) | (q_stay < q_diag))
        x_cur = torch.where(inside & (y > 0) & advance, x_cur - 1, x_cur)
    return path


def phases() -> list:
    """The kernel's phases in order, as ``launch``'s stamps time them."""
    return list(PHASES)


def launch(value: Tensor, y_lens: Tensor, x_lens: Tensor,
           stamps: Optional[Tensor] = None) -> Tensor:
    """Kernel D on the card (no plain path). Allocates the path and the
    decision bits, ``[B, T_y, warps * 32]`` int32 with :func:`plan`'s
    warps (one bit a cell, a word a thread; no score scratch). With
    ``stamps`` (int64, ``len(phases()) + 1`` on the card) the
    kernel also writes the device clock (ns) at block 0's start and at
    the end of each phase."""
    b, t_y, t_x = value.shape
    dev = value.device
    cuda.require(value, "value", dev)
    cuda.require(y_lens, "y_lens", dev, torch.int32, (b,))
    cuda.require(x_lens, "x_lens", dev, torch.int32, (b,))
    if stamps is not None:
        cuda.require(stamps, "stamps", dev, torch.int64, (len(PHASES) + 1,))
    n_warps, cells, chunk = plan(t_x)
    path = torch.empty_like(value)
    bits = torch.empty((b, t_y, n_warps * 32), dtype=torch.int32,
                       device=dev)
    fn = cuda.function(LIBRARY, "mas_path",
                       [cuda.c_ptr] * 6 + [cuda.c_int] * 6 + [cuda.c_ptr])
    with torch.cuda.device(dev):
        status = fn(cuda.ptr(value), cuda.ptr(y_lens), cuda.ptr(x_lens),
                    cuda.ptr(path), cuda.ptr(bits), cuda.ptr(stamps), b, t_y,
                    t_x, n_warps, cells, chunk, cuda.stream_of(value))
    cuda.check(LIBRARY, status, "mas_path")
    cuda.count_launch(__name__)
    return path


def maximum_path_numpy(neg_cent: np.ndarray, attn_mask: np.ndarray
                       ) -> np.ndarray:
    """Oracle with the reference kernel's exact loops (core.pyx:7-42).

    Its triangle loops leave cells outside the reachable band uncomputed,
    so where x_len > y_len (no monotonic path exists) it differs from the
    full-grid DP above; everywhere else the two agree."""
    neg_cent = np.asarray(neg_cent, dtype=np.float32).copy()
    attn_mask = np.asarray(attn_mask)
    b = neg_cent.shape[0]
    path = np.zeros_like(neg_cent, dtype=np.float32)
    y_lens = attn_mask[:, :, 0].sum(1).astype(int)
    x_lens = attn_mask[:, 0, :].sum(1).astype(int)

    for i in range(b):
        value = neg_cent[i]
        t_y, t_x = max(y_lens[i], 1), max(x_lens[i], 1)
        for y in range(t_y):
            for x in range(max(0, t_x + y - t_y), min(t_x, y + 1)):
                v_cur = NEG_INF if x == y else value[y - 1, x]
                if x == 0:
                    v_prev = 0.0 if y == 0 else NEG_INF
                else:
                    v_prev = value[y - 1, x - 1]
                value[y, x] += max(v_prev, v_cur)
        index = t_x - 1
        for y in range(t_y - 1, -1, -1):
            path[i, y, index] = 1.0
            if index != 0 and (
                index == y or value[y - 1, index] < value[y - 1, index - 1]
            ):
                index -= 1
    return path
