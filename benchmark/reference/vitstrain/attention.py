"""Windowed relative-position multi-head attention + conv FFN.

PyTorch port of ``phoonnx_tpu/models/vits/attention.py`` (reference text
encoder attention, phoonnx_train/vits/attentions.py:161-427). Layout:
[B, T, C]. :func:`encoder_plain` is the plain version of kernel A
(``fused_encoder``); :func:`encoder` routes through the kernel when the
parameters carry its spec.
"""

import math
from typing import Optional

import torch
import torch.nn.functional as F

from reference.vitstrain import nn

Tensor = torch.Tensor


def init_multi_head_attention(generator, channels: int, out_channels: int,
                              n_heads: int, window_size: Optional[int] = 4,
                              heads_share: bool = True):
    k_channels = channels // n_heads

    def xavier_conv(out_ch, in_ch):
        # xavier_uniform on the [O, I, 1] kernel (attentions.py:207-209)
        bound = math.sqrt(6.0 / (out_ch + in_ch))
        weight = nn._uniform(generator, (out_ch, in_ch, 1), bound)
        return {"weight": weight, "bias": torch.zeros(out_ch)}

    params = {
        "n_heads": n_heads,
        "k_channels": k_channels,
        "window_size": window_size,
        "conv_q": xavier_conv(channels, channels),
        "conv_k": xavier_conv(channels, channels),
        "conv_v": xavier_conv(channels, channels),
        "conv_o": nn.init_conv(generator, out_channels, channels, 1),
    }
    if window_size is not None:
        n_heads_rel = 1 if heads_share else n_heads
        rel_std = k_channels ** -0.5
        shape = (n_heads_rel, 2 * window_size + 1, k_channels)
        params["emb_rel_k"] = rel_std * torch.randn(shape, generator=generator)
        params["emb_rel_v"] = rel_std * torch.randn(shape, generator=generator)
    return params


def _get_relative_embeddings(emb: Tensor, length: int,
                             window_size: int) -> Tensor:
    """Slice/pad the (2w+1) relative table to 2*length-1 entries."""
    pad_length = max(length - (window_size + 1), 0)
    start = max((window_size + 1) - length, 0)
    if pad_length > 0:
        emb = F.pad(emb, (0, 0, pad_length, pad_length))
    return emb[:, start:start + 2 * length - 1]


def _relative_to_absolute(x: Tensor) -> Tensor:
    """[B, H, L, 2L-1] -> [B, H, L, L] via the pad/reshape shuffle."""
    b, h, length, _ = x.shape
    x = F.pad(x, (0, 1))
    x_flat = x.reshape(b, h, length * 2 * length)
    x_flat = F.pad(x_flat, (0, length - 1))
    x_final = x_flat.reshape(b, h, length + 1, 2 * length - 1)
    return x_final[:, :, :length, length - 1:]


def _absolute_to_relative(x: Tensor) -> Tensor:
    """[B, H, L, L] -> [B, H, L, 2L-1]."""
    b, h, length, _ = x.shape
    x = F.pad(x, (0, length - 1))
    x_flat = x.reshape(b, h, length * length + length * (length - 1))
    x_flat = F.pad(x_flat, (length, 0))
    return x_flat.reshape(b, h, length, 2 * length)[:, :, :, 1:]


def multi_head_attention(params, x: Tensor, c: Tensor,
                         attn_mask: Optional[Tensor] = None,
                         p_dropout: float = 0.0,
                         generator: Optional[torch.Generator] = None,
                         deterministic: bool = True) -> Tensor:
    """Self/cross attention; x (queries) and c (keys/values) are [B, T, C].
    In training, dropout acts on the attention probabilities."""
    n_heads = params["n_heads"]
    k_channels = params["k_channels"]
    window_size = params["window_size"]

    q = nn.apply_conv(params["conv_q"], x)
    k = nn.apply_conv(params["conv_k"], c)
    v = nn.apply_conv(params["conv_v"], c)

    b, t_t, d = q.shape
    t_s = k.shape[1]
    q = q.reshape(b, t_t, n_heads, k_channels).transpose(1, 2)
    k = k.reshape(b, t_s, n_heads, k_channels).transpose(1, 2)
    v = v.reshape(b, t_s, n_heads, k_channels).transpose(1, 2)

    # scores, probabilities and outputs in f32 whatever the compute dtype,
    # as the JAX attention's einsums accumulate (preferred_element_type
    # f32; a product of two bf16 values is exact in f32)
    scale = 1.0 / math.sqrt(k_channels)
    qs = (q * scale).float()
    scores = torch.einsum("bhtd,bhsd->bhts", qs, k.float())
    if window_size is not None:
        assert t_s == t_t, "relative attention requires self-attention"
        rel_k = _get_relative_embeddings(params["emb_rel_k"], t_s,
                                         window_size)
        rel_k = rel_k.expand((n_heads,) + rel_k.shape[1:])
        rel_logits = torch.einsum("bhld,hmd->bhlm", qs, rel_k.float())
        scores = scores + _relative_to_absolute(rel_logits)
    if attn_mask is not None:
        scores = scores.masked_fill(attn_mask == 0, -1e4)
    p_attn = torch.softmax(scores, dim=-1)
    p_attn = nn.dropout(p_attn, p_dropout, generator, deterministic)

    output = torch.einsum("bhts,bhsd->bhtd", p_attn, v.float())
    if window_size is not None:
        rel_weights = _absolute_to_relative(p_attn)
        rel_v = _get_relative_embeddings(params["emb_rel_v"], t_s,
                                         window_size)
        rel_v = rel_v.expand((n_heads,) + rel_v.shape[1:])
        output = output + torch.einsum("bhlm,hmd->bhld", rel_weights,
                                       rel_v.float())
    output = output.transpose(1, 2).reshape(b, t_t, d).to(x.dtype)
    return nn.apply_conv(params["conv_o"], output)


# ---------------------------------------------------------------------------
# Conv feed-forward network (attentions.py:362-427)
# ---------------------------------------------------------------------------


def init_ffn(generator, in_channels: int, out_channels: int,
             filter_channels: int, kernel_size: int):
    return {
        "kernel_size": kernel_size,
        "conv_1": nn.init_conv(generator, filter_channels, in_channels,
                               kernel_size),
        "conv_2": nn.init_conv(generator, out_channels, filter_channels,
                               kernel_size),
    }


def _same_pad(x: Tensor, kernel_size: int) -> Tensor:
    if kernel_size == 1:
        return x
    return F.pad(x, (0, 0, (kernel_size - 1) // 2, kernel_size // 2))


def ffn(params, x: Tensor, x_mask: Tensor, p_dropout: float = 0.0,
        generator: Optional[torch.Generator] = None,
        deterministic: bool = True) -> Tensor:
    kernel_size = params["kernel_size"]
    h = nn.apply_conv(params["conv_1"], _same_pad(x * x_mask, kernel_size))
    h = torch.relu(h)
    h = nn.dropout(h, p_dropout, generator, deterministic)
    h = nn.apply_conv(params["conv_2"], _same_pad(h * x_mask, kernel_size))
    return h * x_mask


# ---------------------------------------------------------------------------
# Encoder stack (attentions.py:12-74)
# ---------------------------------------------------------------------------


def init_encoder(generator, hidden_channels: int, filter_channels: int,
                 n_heads: int, n_layers: int, kernel_size: int = 1,
                 window_size: int = 4):
    layers = []
    for _ in range(n_layers):
        layers.append({
            "attn": init_multi_head_attention(
                generator, hidden_channels, hidden_channels, n_heads,
                window_size=window_size),
            "norm_1": nn.init_layer_norm(hidden_channels),
            "ffn": init_ffn(generator, hidden_channels, hidden_channels,
                            filter_channels, kernel_size),
            "norm_2": nn.init_layer_norm(hidden_channels),
        })
    return {"layers": layers}


def encoder_plain(params, x: Tensor, x_mask: Tensor, p_dropout: float = 0.0,
                  generator: Optional[torch.Generator] = None,
                  deterministic: bool = True) -> Tensor:
    """The encoder stack in plain PyTorch ops: the plain version of
    kernel A, and the training encoder (dropout on the attention
    probabilities, inside the FFN and on both residual branches, as JAX
    ``attention.encoder``). x [B, T, H], x_mask [B, T, 1] -> hidden
    [B, T, H] * mask."""
    attn_mask = (x_mask[:, :, None, 0] * x_mask[:, None, :, 0])[:, None]
    drop = dict(p_dropout=p_dropout, generator=generator,
                deterministic=deterministic)
    x = x * x_mask
    for layer in params["layers"]:
        y = multi_head_attention(layer["attn"], x, x, attn_mask, **drop)
        y = nn.dropout(y, p_dropout, generator, deterministic)
        x = nn.layer_norm(layer["norm_1"], x + y)
        y = ffn(layer["ffn"], x, x_mask, **drop)
        y = nn.dropout(y, p_dropout, generator, deterministic)
        x = nn.layer_norm(layer["norm_2"], x + y)
    return x * x_mask


