"""Kernel C: a decoder stage's resblock group as a hand-written CUDA kernel.

Wrapper of ``csrc/fused_stage.cu``, which replaces the Pallas kernel
``phoonnx_tpu/models/vits/fused_stage.py`` (``_kernel`` :250,
``_compute_group`` :305, ``apply_group`` :417) at r = 1: Hopper has no
lanes to pack. It computes :func:`plain`: the mean over the stage's
residual branches of dilated convs with leaky ReLU, every activation and
the output rows masked to ``[0, valid)`` (so a padded batch decode equals
the exact-length decode on the valid span), optionally followed by the
generator's tail, leaky ReLU 0.01 -> conv_post -> tanh, as the epilogue.
The kernel multiplies on the tensor cores in error-compensated 3xTF32
and is bound by operations at that rate; its design note is at the top
of the CUDA sources (``fused_stage.cu``, ``tapconv.cuh``).
"""

import ctypes
import functools
from typing import Optional

import torch

from phoonnx_tpu_torch import cuda, tiling
from phoonnx_tpu_torch.models.vits import modules, nn

LIBRARY = "fused_stage"

# ``launches``: the kernel's launches (one per apply_group on the card),
# kept in ``cuda.LAUNCHES``. Read by callers that show a path went
# through the kernel.
__getattr__ = functools.partial(cuda.launch_count, __name__)


def build_group_spec(blocks, lrelu_slope: float, post=None):
    """Spec for one stage's resblock group.

    blocks: the stage's resblock param subtrees (modules.init_resblock1/2
    layout). post: optional (weight [1, C, K], bias or None, padding,
    slope) for the fused generator tail. The spec holds the stacked tap
    matrices ``W`` [n_taps, C, C] and biases ``b`` [n_convs, C], and the
    program the kernel walks: branches -> residual units -> convs, each
    conv as (first tap, n_taps, dilation, padding, bias index), flattened
    into ``program`` rows and their C array ``program_c``.
    """
    mats, biases, branches = [], [], []
    n_taps = 0
    for block in blocks:
        k = int(block["kernel_size"])
        if "convs1" in block:  # resblock1: (conv1 at d, conv2 at 1) units
            units_src = [((c1, int(d)), (c2, 1)) for c1, c2, d in zip(
                block["convs1"], block["convs2"], block["dilations"])]
        else:  # resblock2: single-conv units
            units_src = [((c, int(d)),)
                         for c, d in zip(block["convs"], block["dilations"])]
        units = []
        for unit_src in units_src:
            convs = []
            for conv, d in unit_src:
                weight = nn.resolve_weight(conv)
                bias = conv.get("bias")
                convs.append((n_taps, k, d, (k * d - d) // 2, len(biases)))
                mats.append(weight.permute(2, 1, 0))  # [K, I, O]
                biases.append(weight.new_zeros(weight.shape[0]) if bias is None
                              else bias)
                n_taps += k
            units.append(tuple(convs))
        branches.append(tuple(units))
    program = _program(branches)
    spec = {
        "W": torch.cat(mats, dim=0).contiguous(),
        "b": torch.stack(biases).contiguous(),
        "branches": tuple(branches),
        "program": program,
        "program_c": (ctypes.c_int * (8 * len(program)))(
            *[v for row in program for v in row]),
        "slope": float(lrelu_slope),
        "blocks": list(blocks),
    }
    if post is not None:
        pw, pb, ppad, pslope = post
        spec["postW"] = pw.permute(2, 1, 0).contiguous()  # [K, C, 1]
        spec["postB"] = (pw.new_zeros(1) if pb is None else pb).contiguous()
        spec["post_pad"] = int(ppad)
        spec["post_slope"] = float(pslope)
        spec["post_weight"] = pw
    return spec


def _program(branches):
    """Program rows for the kernel, one per conv in walk order:
    (w0, n_taps, dil, pad, bias_idx, branch, last_in_unit, last_unit)."""
    rows = []
    for bi, branch in enumerate(branches):
        for ui, unit in enumerate(branch):
            for ci, (w0, taps, d, pad, b_idx) in enumerate(unit):
                rows.append((w0, taps, d, pad, b_idx, bi,
                             int(ci == len(unit) - 1),
                             int(ui == len(branch) - 1)))
    return rows


def slope_in(value: float, dtype: torch.dtype) -> float:
    """A leaky-ReLU slope as the kernel multiplies by it: in bf16 the JAX
    kernel's ``slope * v`` is a bf16 product, its slope rounded to bf16."""
    return float(torch.tensor(value, dtype=dtype))


def _plain_rounded(spec, x: torch.Tensor, valid: torch.Tensor):
    """The JAX kernel's function on bf16 storage: every product and sum in
    float32 on bf16 values, rounded to bf16 where the kernel stores in
    ``x.dtype``: each activation, each conv output that is not the end of
    a unit, each residual sum, the branch sum and mean, and the audio."""
    dt = x.dtype

    def rnd(v):
        return v.to(dt).float()

    mask = nn.sequence_mask(valid, x.shape[1])[..., None].float()
    w, bias = spec["W"].float(), spec["b"].float()
    slope = slope_in(spec["slope"], dt)
    stage_in = x.float()
    acc = None
    for branch in spec["branches"]:
        cur = stage_in
        for unit in branch:
            src = cur
            for ci, (w0, taps, dil, pad, b_idx) in enumerate(unit):
                act = rnd(torch.maximum(src, slope * src)) * mask
                y = nn.conv1d(act, w[w0:w0 + taps].permute(2, 1, 0),
                              bias[b_idx], padding=pad, dilation=dil)
                if ci + 1 == len(unit):
                    cur = rnd(cur + rnd(y))
                else:
                    src = rnd(y)
        acc = cur if acc is None else rnd(acc + cur)
    out = rnd(acc / len(spec["branches"])) * mask
    if "postW" not in spec:
        return out.to(dt)
    post_slope = slope_in(spec["post_slope"], dt)
    act = rnd(torch.maximum(out, post_slope * out))
    y = nn.conv1d(act, spec["post_weight"].float(), spec["postB"].float(),
                  padding=spec["post_pad"])
    return torch.tanh(y).to(dt)


def plain(spec, x: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """The function the kernel computes, in plain PyTorch ops (in bf16,
    the JAX kernel's rounding points, :func:`_plain_rounded`)."""
    if x.dtype != torch.float32:
        return _plain_rounded(spec, x, valid)
    t = x.shape[1]
    mask = nn.sequence_mask(valid, t)[..., None].to(x.dtype)

    def mask_fn(v):
        return v * mask

    x = mask_fn(x)
    acc = None
    for block in spec["blocks"]:
        fn = modules.resblock1 if "convs1" in block else modules.resblock2
        out = fn(block, x, mask_fn=mask_fn)
        acc = out if acc is None else acc + out
    x = mask_fn(acc / len(spec["blocks"]))
    if "postW" not in spec:
        return x
    x = nn.leaky_relu(x, spec["post_slope"])
    x = nn.conv1d(x, spec["post_weight"], None, padding=spec["post_pad"])
    return torch.tanh(x + spec["postB"])


def apply_group(spec, x: torch.Tensor,
                valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean of the stage's resblocks over x [B, T, C], masked to ``valid``
    [B] time positions (default: the whole array). Returns [B, T, C], or
    the audio [B, T, 1] when the spec carries the generator tail."""
    if valid is None:
        valid = torch.full((x.shape[0],), x.shape[1], dtype=torch.int32,
                           device=x.device)
    valid = torch.clamp(valid.to(torch.int32), max=x.shape[1])
    if not x.is_cuda:
        return plain(spec, x, valid)
    return launch(spec, x, valid)


@functools.lru_cache(maxsize=None)
def _check_conv(channels: int, taps: int, dil: int) -> None:
    """Raise ValueError if no tile of the tap convolution takes the conv
    (the shared memory of its window and weights does not depend on the
    batch or the length)."""
    tiling.tap_tile(1, 1, channels, taps, dil, 1)


def launch(spec, x: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Kernel C on the card (no plain path); ``valid`` int32 [B], at most
    T (``apply_group`` clamps it)."""
    b, t, c = x.shape
    dev = x.device
    lib = cuda.library(LIBRARY, x.dtype)
    cuda.require(x, "x", dev, x.dtype)
    for name in ("W", "b"):
        cuda.require(spec[name], name, dev, x.dtype)
    if spec["W"].shape[1:] != (c, c):
        raise ValueError(f"x has {c} channels, the spec {spec['W'].shape[1]}")
    for _, taps, dil, *_ in spec["program"]:
        _check_conv(c, taps, dil)
    valid = valid.contiguous()
    cuda.require(valid, "valid", dev, dtype=torch.int32)
    max_units = max(len(br) for br in spec["branches"])
    multi_conv = any(len(u) > 1 for br in spec["branches"] for u in br)
    ping = torch.empty_like(x) if max_units > 1 else None
    pong = torch.empty_like(x) if max_units > 2 else None
    tmp = torch.empty_like(x) if multi_conv else None
    acc = torch.empty_like(x)
    has_post = "postW" in spec
    audio = torch.empty(b, t, 1, device=dev, dtype=x.dtype) \
        if has_post else None
    if has_post:
        cuda.require(spec["postW"], "postW", dev, x.dtype, shape=(
            spec["postW"].shape[0], c, 1))
        cuda.require(spec["postB"], "postB", dev, x.dtype, shape=(1,))
    fn = cuda.function(lib, "fused_stage_group",
                       [cuda.c_ptr] * 5 + [cuda.c_int] * 2 + [cuda.c_ptr] * 6
                       + [cuda.c_int] * 2 + [cuda.c_float, cuda.c_ptr]
                       + [cuda.c_int] * 3 + [cuda.c_float, cuda.c_ptr])
    with torch.cuda.device(dev):
        status = fn(cuda.ptr(x), cuda.ptr(valid), cuda.ptr(spec["W"]),
                    cuda.ptr(spec["b"]),
                    ctypes.cast(spec["program_c"], ctypes.c_void_p),
                    len(spec["program"]), len(spec["branches"]),
                    cuda.ptr(ping), cuda.ptr(pong), cuda.ptr(tmp),
                    cuda.ptr(acc),
                    cuda.ptr(spec.get("postW") if has_post else None),
                    cuda.ptr(spec.get("postB") if has_post else None),
                    spec["postW"].shape[0] if has_post else 0,
                    spec.get("post_pad", 0),
                    slope_in(spec.get("post_slope", 0.0), x.dtype),
                    cuda.ptr(audio), b, t, c, slope_in(spec["slope"], x.dtype),
                    cuda.stream_of(x))
    cuda.check(lib, status, "fused_stage_group")
    cuda.count_launch(__name__, x.dtype)
    return audio if has_post else acc
