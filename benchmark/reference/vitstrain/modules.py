"""VITS building blocks: DDSConv, WaveNet stack, resblocks, flow layers.

PyTorch port of ``phoonnx_tpu/models/vits/modules.py`` (reference blocks,
phoonnx_train/vits/modules.py). Activations are [B, T, C]; masks are
[B, T, 1]. Only the unpacked (one time position per row) forms are
ported: channel packing was a TPU lane device.
"""

import math
from typing import Optional

import torch
import torch.nn.functional as F

from reference.vitstrain import nn
from reference.vitstrain.transforms import (
    piecewise_rational_quadratic_transform,
)

Tensor = torch.Tensor


# ---------------------------------------------------------------------------
# DDSConv — dilated depth-separable conv stack (modules.py:81-129)
# ---------------------------------------------------------------------------


def init_dds_conv(generator, channels: int, kernel_size: int, n_layers: int):
    layers = []
    for _ in range(n_layers):
        layers.append({
            "sep": nn.init_conv(generator, channels, channels, kernel_size,
                                groups=channels),
            "pointwise": nn.init_conv(generator, channels, channels, 1),
            "norm1": nn.init_layer_norm(channels),
            "norm2": nn.init_layer_norm(channels),
        })
    return {"layers": layers, "kernel_size": kernel_size}


def dds_conv(params, x: Tensor, x_mask: Tensor,
             g: Optional[Tensor] = None, p_dropout: float = 0.0,
             generator: Optional[torch.Generator] = None,
             deterministic: bool = True) -> Tensor:
    kernel_size = params["kernel_size"]
    channels = x.shape[-1]
    if g is not None:
        x = x + g
    for i, layer in enumerate(params["layers"]):
        dilation = kernel_size ** i
        padding = (kernel_size * dilation - dilation) // 2
        y = nn.apply_conv(layer["sep"], x * x_mask, padding=padding,
                          dilation=dilation, groups=channels)
        y = nn.layer_norm(layer["norm1"], y)
        y = F.gelu(y)
        y = nn.apply_conv(layer["pointwise"], y)
        y = nn.layer_norm(layer["norm2"], y)
        y = F.gelu(y)
        y = nn.dropout(y, p_dropout, generator, deterministic)
        x = x + y
    return x * x_mask


# ---------------------------------------------------------------------------
# WN — gated dilated WaveNet stack (modules.py:132-209)
# ---------------------------------------------------------------------------


def init_wn(generator, hidden: int, kernel_size: int, dilation_rate: int,
            n_layers: int, gin_channels: int = 0):
    params = {"n_layers": n_layers, "kernel_size": kernel_size,
              "dilation_rate": dilation_rate, "hidden": hidden}
    in_layers, res_skip_layers = [], []
    for i in range(n_layers):
        in_layers.append(nn.init_wn_conv(generator, 2 * hidden, hidden,
                                         kernel_size))
        res_skip_ch = 2 * hidden if i < n_layers - 1 else hidden
        res_skip_layers.append(nn.init_wn_conv(generator, res_skip_ch,
                                               hidden, 1))
    params["in_layers"] = in_layers
    params["res_skip_layers"] = res_skip_layers
    if gin_channels:
        params["cond_layer"] = nn.init_wn_conv(
            generator, 2 * hidden * n_layers, gin_channels, 1)
    return params


def wn(params, x: Tensor, x_mask: Tensor, g: Optional[Tensor] = None,
       p_dropout: float = 0.0, generator: Optional[torch.Generator] = None,
       deterministic: bool = True) -> Tensor:
    hidden = params["hidden"]
    n_layers = params["n_layers"]
    kernel_size = params["kernel_size"]
    dilation_rate = params["dilation_rate"]

    output = torch.zeros_like(x)
    if g is not None:
        if "cond_layer" not in params:
            # silently dropping g would synthesize speaker-unconditioned
            # audio on an hparams/checkpoint mismatch
            raise ValueError(
                "WN received speaker conditioning but was initialized "
                "without gin_channels (hparams/checkpoint mismatch)")
        g_all = nn.apply_wn_conv(params["cond_layer"], g)
    else:
        g_all = None

    for i in range(n_layers):
        dilation = dilation_rate ** i
        padding = (kernel_size * dilation - dilation) // 2
        x_in = nn.apply_wn_conv(params["in_layers"][i], x, padding=padding,
                                dilation=dilation)
        if g_all is not None:
            g_l = g_all[..., i * 2 * hidden:(i + 1) * 2 * hidden]
        else:
            g_l = torch.zeros_like(x_in)
        acts = nn.gated_tanh_sigmoid(x_in, g_l, hidden)
        acts = nn.dropout(acts, p_dropout, generator, deterministic)
        res_skip = nn.apply_wn_conv(params["res_skip_layers"][i], acts)
        if i < n_layers - 1:
            x = (x + res_skip[..., :hidden]) * x_mask
            output = output + res_skip[..., hidden:]
        else:
            output = output + res_skip
    return output * x_mask


# ---------------------------------------------------------------------------
# HiFi-GAN residual blocks (modules.py:220-368)
# ---------------------------------------------------------------------------

LRELU_SLOPE = 0.1


def init_resblock1(generator, channels: int, kernel_size: int, dilations):
    convs1, convs2 = [], []
    for _ in dilations:
        convs1.append(nn.init_wn_conv(generator, channels, channels,
                                      kernel_size, std=0.01))
        convs2.append(nn.init_wn_conv(generator, channels, channels,
                                      kernel_size, std=0.01))
    return {"convs1": convs1, "convs2": convs2, "kernel_size": kernel_size,
            "dilations": tuple(dilations)}


def resblock1(params, x: Tensor, mask_fn=None) -> Tensor:
    """mask_fn: optional re-zeroing of padded time positions, applied to
    every conv OUTPUT so each conv's boundary taps read the zeros the
    exact-length decode's own padding would supply."""
    k = params["kernel_size"]
    for conv1, conv2, dilation in zip(
            params["convs1"], params["convs2"], params["dilations"]):
        xt = nn.leaky_relu(x, LRELU_SLOPE)
        xt = nn.apply_wn_conv(conv1, xt, dilation=dilation,
                              padding=(k * dilation - dilation) // 2)
        if mask_fn is not None:
            xt = mask_fn(xt)
        xt = nn.leaky_relu(xt, LRELU_SLOPE)
        xt = nn.apply_wn_conv(conv2, xt, padding=(k - 1) // 2)
        if mask_fn is not None:
            xt = mask_fn(xt)
        x = xt + x
    return x


def init_resblock2(generator, channels: int, kernel_size: int, dilations):
    convs = [nn.init_wn_conv(generator, channels, channels, kernel_size,
                             std=0.01) for _ in dilations]
    return {"convs": convs, "kernel_size": kernel_size,
            "dilations": tuple(dilations)}


def resblock2(params, x: Tensor, mask_fn=None) -> Tensor:
    """mask_fn: see :func:`resblock1`."""
    k = params["kernel_size"]
    for conv, dilation in zip(params["convs"], params["dilations"]):
        xt = nn.leaky_relu(x, LRELU_SLOPE)
        xt = nn.apply_wn_conv(conv, xt, dilation=dilation,
                              padding=(k * dilation - dilation) // 2)
        if mask_fn is not None:
            xt = mask_fn(xt)
        x = xt + x
    return x


# ---------------------------------------------------------------------------
# Flow primitives (modules.py:371-409)
# ---------------------------------------------------------------------------


def log_flow(x: Tensor, x_mask: Tensor, reverse: bool = False):
    if not reverse:
        y = torch.log(torch.clamp(x, min=1e-5)) * x_mask
        return y, torch.sum(-y, dim=(1, 2))
    return torch.exp(x) * x_mask


def flip_flow(x: Tensor, reverse: bool = False):
    """Flip the channel axis (invertible, zero logdet)."""
    y = torch.flip(x, dims=(-1,))
    if not reverse:
        return y, torch.zeros(x.shape[0], dtype=x.dtype, device=x.device)
    return y


def init_elementwise_affine(channels: int):
    return {"m": torch.zeros(channels), "logs": torch.zeros(channels)}


def elementwise_affine(params, x: Tensor, x_mask: Tensor, reverse=False):
    if not reverse:
        y = (params["m"] + torch.exp(params["logs"]) * x) * x_mask
        return y, torch.sum(params["logs"] * x_mask, dim=(1, 2))
    return (x - params["m"]) * torch.exp(-params["logs"]) * x_mask


# ---------------------------------------------------------------------------
# Residual coupling layer (modules.py:412-467)
# ---------------------------------------------------------------------------


def init_residual_coupling_layer(generator, channels: int, hidden: int,
                                 kernel_size: int, dilation_rate: int,
                                 n_layers: int, gin_channels: int = 0):
    half = channels // 2
    return {
        "half_channels": half,
        "pre": nn.init_conv(generator, hidden, half, 1),
        "enc": init_wn(generator, hidden, kernel_size, dilation_rate,
                       n_layers, gin_channels=gin_channels),
        "post": nn.init_zero_conv(half, hidden),  # mean_only
    }


def residual_coupling_layer(params, x: Tensor, x_mask: Tensor,
                            g: Optional[Tensor] = None, reverse=False):
    """Affine (mean-only) coupling with a WN inner network."""
    half = params["half_channels"]
    x0, x1 = x[..., :half], x[..., half:]
    h = nn.apply_conv(params["pre"], x0) * x_mask
    h = wn(params["enc"], h, x_mask, g=g)
    m = nn.apply_conv(params["post"], h) * x_mask
    if not reverse:
        x1 = (m + x1) * x_mask
        logdet = torch.zeros(x.shape[0], dtype=x.dtype, device=x.device)
        return torch.cat([x0, x1], dim=-1), logdet
    x1 = (x1 - m) * x_mask
    return torch.cat([x0, x1], dim=-1)


# ---------------------------------------------------------------------------
# ConvFlow — RQ-spline coupling for the SDP (modules.py:469-527)
# ---------------------------------------------------------------------------


def init_conv_flow(generator, in_channels: int, filter_channels: int,
                   kernel_size: int, n_layers: int, num_bins: int = 10,
                   tail_bound: float = 5.0):
    half = in_channels // 2
    return {
        "half_channels": half,
        "filter_channels": filter_channels,
        "num_bins": num_bins,
        "tail_bound": tail_bound,
        "pre": nn.init_conv(generator, filter_channels, half, 1),
        "convs": init_dds_conv(generator, filter_channels, kernel_size,
                               n_layers),
        "proj": nn.init_zero_conv(half * (num_bins * 3 - 1), filter_channels),
    }


def conv_flow(params, x: Tensor, x_mask: Tensor, g: Optional[Tensor] = None,
              reverse=False):
    half = params["half_channels"]
    num_bins = params["num_bins"]
    filter_channels = params["filter_channels"]

    x0, x1 = x[..., :half], x[..., half:]
    h = nn.apply_conv(params["pre"], x0)
    h = dds_conv(params["convs"], h, x_mask, g=g)
    h = nn.apply_conv(params["proj"], h) * x_mask

    b, t, _ = x0.shape
    h = h.reshape(b, t, half, num_bins * 3 - 1)
    scale = 1.0 / math.sqrt(filter_channels)
    unnorm_widths = h[..., :num_bins] * scale
    unnorm_heights = h[..., num_bins:2 * num_bins] * scale
    unnorm_derivs = h[..., 2 * num_bins:]

    x1, logabsdet = piecewise_rational_quadratic_transform(
        x1, unnorm_widths, unnorm_heights, unnorm_derivs,
        inverse=reverse, tails="linear",
        tail_bound=float(params["tail_bound"]))

    out = torch.cat([x0, x1], dim=-1) * x_mask
    logdet = torch.sum(logabsdet * x_mask, dim=(1, 2))
    if not reverse:
        return out, logdet
    return out
