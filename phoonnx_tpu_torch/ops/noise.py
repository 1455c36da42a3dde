"""Seeded standard normals: the synthesis engine's duration and prior noise.

No JAX counterpart: the JAX engine draws its noise with ``jax.random``.
The hand-written CUDA kernel ``csrc/noise.cu`` draws a dispatch's noise on
the card in one launch a draw, so the noise is made on the device and
never crosses from the host; :func:`normal_plain` computes the same
function in plain PyTorch, for a CPU engine and the tests.

The function: lane ``b`` of a draw at ``seed`` with ``tag`` is keyed by
the 64-bit ``seed + b``. Element ``e = t * channels + c`` of the lane is
word ``e % 4`` of Philox4x32-10 at the counter ``(e // 4 low 32 bits,
e // 4 high 32 bits, tag, 0)``, and Box-Muller turns a block's 4 words
into 4 normals in float32 (``csrc/noise.cu`` writes it out). Each element
depends only on (seed + b, tag, t, c), so

* a draw of n rows is the first n rows of any longer draw of the same
  width (fused mode and streaming draw before the frame count is known);
* lane b of a batch at ``seed`` is the one-lane draw at ``seed + b`` (an
  utterance gets the same noise alone as inside a batch);
* a bfloat16 draw is the float32 draw rounded once.

Rows ``t >= lengths[b]`` are 0.
"""

import ctypes
import functools
import math
from typing import Optional

import torch

from phoonnx_tpu_torch import cuda

Tensor = torch.Tensor

LIBRARY = "noise"

# the engine's draw tags: two draws of one seed are independent streams
DURATION, PRIOR = 0, 1

# Philox4x32-10's multipliers and key increments
M0, M1 = 0xD2511F53, 0xCD9E8D57
W0, W1 = 0x9E3779B9, 0xBB67AE85
ROUNDS = 10
MASK32 = 0xFFFFFFFF
MASK64 = (1 << 64) - 1

# ``launches`` and ``launches_bf16``: the kernel's launches (one a draw on
# the card) by the dtype it writes, kept in ``cuda.LAUNCHES``.
__getattr__ = functools.partial(cuda.launch_count, __name__)


def _mulhilo(a: int, b: Tensor):
    """(high, low) 32-bit halves of the 64-bit product of the constant
    ``a`` and ``b`` (int64 holding values below 2**32), in int64 without
    overflow: ``b`` is split into 16-bit halves."""
    lo_part = a * (b & 0xFFFF)                    # < 2**48
    hi_part = a * (b >> 16)                       # < 2**48
    mid = lo_part + ((hi_part & 0xFFFF) << 16)    # < 2**49
    return (hi_part >> 16) + (mid >> 32), mid & MASK32


def philox(ctr: Tensor, key: Tensor) -> Tensor:
    """Philox4x32-10 of counters ``ctr`` [..., 4] under keys ``key`` [...,
    2] (int64 holding 32-bit words; they broadcast): int64 [..., 4]. The
    words of the toolkit's ``curand_Philox4x32_10``, which the kernel
    calls."""
    c0, c1, c2, c3 = ctr.unbind(-1)
    k0, k1 = key.unbind(-1)
    for r in range(ROUNDS):
        if r:
            k0 = (k0 + W0) & MASK32
            k1 = (k1 + W1) & MASK32
        hi0, lo0 = _mulhilo(M0, c0)
        hi1, lo1 = _mulhilo(M1, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return torch.stack(torch.broadcast_tensors(c0, c1, c2, c3), -1)


def box_muller(words: Tensor) -> Tensor:
    """4 float32 standard normals from each block of 4 words ``words`` [...,
    4] (int64 holding 32-bit words), as the kernel computes them."""
    scale = torch.tensor(2.0 ** -24, dtype=torch.float32)
    u = ((words[..., 0::2] >> 8) + 1).to(torch.float32) * scale  # (0, 1]
    v = (words[..., 1::2] >> 8).to(torch.float32) * scale        # [0, 1)
    r = torch.sqrt(torch.log(u) * torch.tensor(-2.0))
    theta = v * torch.tensor(2.0 * math.pi, dtype=torch.float32)
    return torch.stack([r * torch.cos(theta), r * torch.sin(theta)],
                       -1).flatten(-2)


def _keys(seed: int, lanes: int) -> Tensor:
    """int64 [lanes, 2]: lane b's key, the words of ``seed + b`` mod
    2**64."""
    keys = [(seed + b) & MASK64 for b in range(lanes)]
    return torch.tensor([[k & MASK32, k >> 32] for k in keys],
                        dtype=torch.int64)


def _check(lanes: int, rows: int, channels: int, tag: int) -> None:
    if lanes < 1 or rows < 1 or channels < 1:
        raise ValueError(f"a draw of {lanes} lanes x {rows} rows x "
                         f"{channels} channels: each must be at least 1")
    if not 0 <= tag <= MASK32:
        raise ValueError(f"tag {tag} is not a 32-bit word")


def normal_plain(seed: int, lanes: int, rows: int, channels: int,
                 tag: int, lengths: Optional[Tensor] = None,
                 dtype: torch.dtype = torch.float32) -> Tensor:
    """The function the kernel computes, in plain PyTorch ops on the CPU:
    [lanes, rows, channels] in ``dtype``, rows ``t >= lengths[b]`` 0."""
    _check(lanes, rows, channels, tag)
    n = rows * channels
    block = torch.arange(-(-n // 4), dtype=torch.int64)
    ctr = torch.stack([block & MASK32, block >> 32,
                       torch.full_like(block, tag), torch.zeros_like(block)],
                      -1)
    words = philox(ctr[None], _keys(seed, lanes)[:, None])
    z = box_muller(words).flatten(1)[:, :n].view(lanes, rows, channels)
    if lengths is not None:
        valid = (torch.arange(rows)[None, :]
                 < lengths.to("cpu", torch.int64)[:, None])
        z = torch.where(valid[..., None], z, torch.zeros(()))
    return z.to(dtype)


def launch(seed: int, lanes: int, rows: int, channels: int, tag: int,
           device: torch.device, lengths: Optional[Tensor] = None,
           dtype: torch.dtype = torch.float32) -> Tensor:
    """The kernel on the card (no plain path), on the current stream:
    [lanes, rows, channels] in ``dtype`` (float32 or bfloat16) on
    ``device``; ``lengths`` None or int32 [lanes] on ``device``."""
    _check(lanes, rows, channels, tag)
    if dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"the noise kernel writes float32 or bfloat16, not "
                        f"{dtype}")
    out = torch.empty((lanes, rows, channels), dtype=dtype, device=device)
    dev = out.device
    if lengths is not None:
        cuda.require(lengths, "lengths", dev, torch.int32, (lanes,))
    fn = cuda.function(LIBRARY, "noise_normal",
                       [cuda.c_ptr, cuda.c_ptr, ctypes.c_uint64,
                        ctypes.c_uint32] + [cuda.c_int] * 4 + [cuda.c_ptr])
    with torch.cuda.device(dev):
        status = fn(cuda.ptr(out), cuda.ptr(lengths), seed & MASK64, tag,
                    lanes, rows, channels, int(dtype == torch.bfloat16),
                    cuda.stream_of(out))
    cuda.check(LIBRARY, status, "noise_normal")
    cuda.count_launch(__name__, dtype)
    return out


def normal(seed: int, lanes: int, rows: int, channels: int, tag: int,
           device: torch.device, lengths=None,
           dtype: torch.dtype = torch.float32) -> Tensor:
    """[lanes, rows, channels] standard normals in ``dtype`` on ``device``:
    lane b keyed by ``seed + b`` and ``tag``, rows ``t >= lengths[b]`` 0
    (``lengths``: None, a tensor or a sequence of ints). The kernel on a
    CUDA device, :func:`normal_plain` on the CPU."""
    device = torch.device(device)
    if lengths is not None:
        lengths = torch.as_tensor(lengths, dtype=torch.int32)
    if device.type != "cuda":
        return normal_plain(seed, lanes, rows, channels, tag, lengths, dtype)
    if lengths is not None:
        lengths = lengths.to(device, non_blocking=True).contiguous()
    return launch(seed, lanes, rows, channels, tag, device, lengths, dtype)

