"""Kernel A: the text-encoder layer stack as a hand-written CUDA kernel.

Wrapper of ``csrc/fused_encoder.cu``, which replaces the Pallas kernel
``phoonnx_tpu/models/vits/fused_encoder.py`` (``_kernel`` :195, ``apply``
:292). It computes ``attention.encoder_plain``: n_layers x [windowed
relative-position MHA + residual LayerNorm + conv FFN + residual
LayerNorm], output zeroed on padded rows, as ONE cooperative launch of
persistent blocks that walk the stack's phases; its design note is at the
top of the CUDA source, its work partition in ``tiling.py``.

:func:`build_spec` stacks the per-layer weights once (engine init);
:func:`apply` launches the kernel for a CUDA tensor and runs the plain
version for a CPU tensor. There is no other fallback: on the card the
kernel runs or the call raises.
"""

import ctypes
import functools
import math
from typing import Optional

import torch

from phoonnx_tpu_torch import cuda, tiling
from phoonnx_tpu_torch.models.vits import attention, nn

LIBRARY = "fused_encoder"
# csrc/fused_encoder.cu: MAX_H (LayerNorm row width), MAX_DK and the
# widest relative window whose table fits a 16-key slab buffer
MAX_CHANNELS = 256
MAX_HEAD_CHANNELS = 128
MAX_WINDOW = 7
# the phases of one layer, in the kernel's order
PHASES = ("qkv", "attention", "out_proj", "add_ln1", "ffn1", "ffn2",
          "add_ln2")

# ``launches``: the kernel's launches (one per apply on the card),
# kept in ``cuda.LAUNCHES``. Read by callers that show a path went
# through the kernel.
__getattr__ = functools.partial(cuda.launch_count, __name__)


def build_spec(enc_params):
    """Stacked-weight spec for ``attention.encoder`` params, or None.

    Supported = every layer has window relative attention with a shared
    (heads_share) table and identical shapes, which is what
    ``encoder.init_text_encoder`` builds for every VITS preset. The spec
    keeps the unstacked params as ``plain`` for the CPU path.
    """
    layers = enc_params.get("layers")
    if not layers:
        return None
    first = layers[0]["attn"]
    window = first.get("window_size")
    if window is None:
        return None
    n_heads = int(first["n_heads"])
    dk = int(first["k_channels"])
    h = n_heads * dk
    ffn_k = int(layers[0]["ffn"]["kernel_size"])

    w_qkv, b_qkv, w_o, b_o, rel_k, rel_v = [], [], [], [], [], []
    ln, w1, b1, w2, b2 = [], [], [], [], []
    for layer in layers:
        attn = layer["attn"]
        if attn.get("window_size") is None \
                or int(attn["window_size"]) != int(window) \
                or int(attn["n_heads"]) != n_heads \
                or int(attn["k_channels"]) != dk \
                or attn["emb_rel_k"].shape[0] != 1 \
                or int(layer["ffn"]["kernel_size"]) != ffn_k \
                or tuple(attn["conv_q"]["weight"].shape[:2]) != (h, h):
            return None
        w_qkv.append(torch.cat([attn[k]["weight"][:, :, 0].T
                                for k in ("conv_q", "conv_k", "conv_v")],
                               dim=1))
        b_qkv.append(torch.cat([attn[k]["bias"]
                                for k in ("conv_q", "conv_k", "conv_v")])[None])
        w_o.append(attn["conv_o"]["weight"][:, :, 0].T)
        b_o.append(attn["conv_o"]["bias"][None])
        rel_k.append(attn["emb_rel_k"][0])
        rel_v.append(attn["emb_rel_v"][0])
        ln.append(torch.stack([layer["norm_1"]["gamma"],
                               layer["norm_1"]["beta"],
                               layer["norm_2"]["gamma"],
                               layer["norm_2"]["beta"]]))
        f1, f2 = layer["ffn"]["conv_1"], layer["ffn"]["conv_2"]
        w1.append(f1["weight"].permute(2, 1, 0))  # [K, H, F]
        b1.append(f1["bias"][None])
        w2.append(f2["weight"].permute(2, 1, 0))  # [K, F, H]
        b2.append(f2["bias"][None])

    def stack(items):
        return torch.stack(items).contiguous()

    return {
        "n_layers": len(layers), "n_heads": n_heads, "dk": dk,
        "window": int(window), "ffn_k": ffn_k,
        "w_qkv": stack(w_qkv), "b_qkv": stack(b_qkv),
        "w_o": stack(w_o), "b_o": stack(b_o),
        "rel_k": stack(rel_k), "rel_v": stack(rel_v), "ln": stack(ln),
        "w_ffn1": stack(w1), "b_ffn1": stack(b1),
        "w_ffn2": stack(w2), "b_ffn2": stack(b2),
        "plain": enc_params,
    }


_WEIGHTS = ("w_qkv", "b_qkv", "w_o", "b_o", "rel_k", "rel_v", "ln",
            "w_ffn1", "b_ffn1", "w_ffn2", "b_ffn2")


def _plain_rounded(spec, x: torch.Tensor, x_mask: torch.Tensor):
    """The JAX kernel's function on bf16 storage (``fused_encoder.py``
    :204-285): the layer's running x in bf16, QKV, scores, softmax and the
    relative terms in float32, rounded to bf16 at the attention output,
    at each LayerNorm output and at the FFN hidden."""
    dt = x.dtype

    def rnd(v):
        return v.to(dt).float()

    b, t, h = x.shape
    heads, dk, window = spec["n_heads"], spec["dk"], spec["window"]
    k = spec["ffn_k"]
    w = {name: spec[name].float() for name in _WEIGHTS}
    mask = x_mask.float()
    keys = mask[:, None, None, :, 0] > 0  # [B, 1, 1, T]
    xf = x.float()

    def layer_norm(v, gamma, beta):
        return torch.nn.functional.layer_norm(v, (h,), gamma, beta, 1e-5)

    def conv(v, weight, bias):  # weight [K, Cin, Cout], "same" taps
        v = torch.nn.functional.pad(v, (0, 0, (k - 1) // 2, k // 2))
        return nn.conv1d(v, weight.permute(2, 1, 0), bias)

    for l in range(spec["n_layers"]):
        qkv = xf @ w["w_qkv"][l] + w["b_qkv"][l]
        q, kk, v = (qkv[..., i * h:(i + 1) * h].reshape(b, t, heads, dk)
                    .transpose(1, 2) for i in range(3))
        q = q * (1.0 / math.sqrt(dk))
        rel_k, rel_v = (attention._get_relative_embeddings(
            w[name][l][None], t, window) for name in ("rel_k", "rel_v"))
        scores = q @ kk.transpose(-1, -2) + attention._relative_to_absolute(
            q @ rel_k.transpose(-1, -2))
        p = torch.softmax(scores.masked_fill(~keys, -1e4), dim=-1)
        o = p @ v + attention._absolute_to_relative(p) @ rel_v
        attn = rnd(o.transpose(1, 2).reshape(b, t, h))
        ln = w["ln"][l]
        xf = rnd(layer_norm(xf + attn @ w["w_o"][l] + w["b_o"][l],
                            ln[0], ln[1]))
        h1 = conv(xf * mask, w["w_ffn1"][l], w["b_ffn1"][l, 0])
        h1 = rnd(torch.relu(h1) * mask)
        y = conv(h1, w["w_ffn2"][l], w["b_ffn2"][l, 0]) * mask
        xf = rnd(layer_norm(xf + y, ln[2], ln[3]))
    return (xf * mask).to(dt)


def plain(spec, x: torch.Tensor, x_mask: torch.Tensor) -> torch.Tensor:
    """The function the kernel computes, in plain PyTorch ops (in bf16,
    the JAX kernel's rounding points, :func:`_plain_rounded`)."""
    if x.dtype != torch.float32:
        return _plain_rounded(spec, x, x_mask)
    return attention.encoder_plain(spec["plain"], x, x_mask)


def apply(spec, x: torch.Tensor, x_mask: torch.Tensor) -> torch.Tensor:
    """Run the full encoder stack. x [B, T, H] (already masked), x_mask
    [B, T, 1] -> hidden [B, T, H] * mask."""
    if not x.is_cuda:
        return plain(spec, x, x_mask)
    return launch(spec, x, x_mask)


def phases(spec) -> list:
    """The kernel's phases in order, as ``launch``'s stamps time them."""
    return [f"{name} {layer}" for layer in range(spec["n_layers"])
            for name in PHASES]


def launch(spec, x: torch.Tensor, x_mask: torch.Tensor,
           stamps: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Kernel A on the card (no plain path): one cooperative launch. With
    ``stamps`` (int64, ``len(phases(spec)) + 1`` on the card) the kernel
    also writes the device clock (ns) at its start and at the end of
    each phase."""
    b, t, h = x.shape
    dev = x.device
    lib = cuda.library(LIBRARY, x.dtype)
    cuda.require(x, "x", dev, x.dtype)
    n_layers, n_heads, dk = spec["n_layers"], spec["n_heads"], spec["dk"]
    window, ffn_k = spec["window"], spec["ffn_k"]
    f = spec["w_ffn1"].shape[-1]
    if h != n_heads * dk:
        raise ValueError(f"x has {h} channels, the spec {n_heads * dk}")
    if (dk > MAX_HEAD_CHANNELS or dk % 4 or h > MAX_CHANNELS
            or window > MAX_WINDOW):
        raise ValueError(f"kernel A takes at most {MAX_CHANNELS} channels, "
                         f"{MAX_HEAD_CHANNELS} a head (a multiple of 4) and "
                         f"a window of {MAX_WINDOW}, not {h}, {dk} and "
                         f"{window}")
    for name in _WEIGHTS:
        cuda.require(spec[name], name, dev, x.dtype)
    smem = cuda.function(lib, "fused_encoder_smem_bytes",
                         [cuda.c_int] * 3, ctypes.c_longlong)(t, dk, window)
    if smem > 227 * 1024:
        raise ValueError(f"text length {t} needs {smem} B of shared memory "
                         f"in the attention kernel; the card grants 227 KB")
    plan = tiling.encoder_plan(b, t, h, f, ffn_k, tiling.grid_size(
        *cuda.occupancy(lib, "fused_encoder_occupancy", dev, t, dk,
                        window)))
    # summed in float32: a bf16 sum rounds lengths above 256
    lengths = x_mask[:, :, 0].sum(dim=1, dtype=torch.float32).to(
        torch.int32).contiguous()
    out = torch.empty_like(x)
    rows = b * t
    # xbuf, qkv, attn, part, hbuf: freed at return, reused only after the
    # kernel (the allocator orders reuse on this stream); counted in 4-byte
    # elements, which a bf16 xbuf, attn and hbuf fill half of
    _, bufs = cuda.scratch(dev, (rows * h, rows * 3 * h, rows * h,
                                 plan.parts * rows * h, rows * f))
    if stamps is not None:
        cuda.require(stamps, "stamps", dev, torch.int64,
                     (len(phases(spec)) + 1,))
    fn = cuda.function(lib, "fused_encoder_forward",
                       [cuda.c_ptr] * 20 + [cuda.c_int] * 13
                       + [cuda.c_float, cuda.c_ptr])
    with torch.cuda.device(dev):
        status = fn(cuda.ptr(x), cuda.ptr(lengths),
                    *[cuda.ptr(spec[name]) for name in _WEIGHTS],
                    *bufs, cuda.ptr(out), cuda.ptr(stamps),
                    b, t, h, f, n_layers, n_heads, window, ffn_k, *plan,
                    1.0 / math.sqrt(dk), cuda.stream_of(x))
    cuda.check(lib, status, "fused_encoder_forward")
    cuda.count_launch(__name__, x.dtype)
    return out
