"""Multi-period + multi-scale discriminators (training only).

PyTorch port of ``phoonnx_tpu/models/vits/discriminator.py`` (reference:
phoonnx_train/vits/models.py:378-519). Waveforms are [B, N]. A period
discriminator folds the waveform to frames x period and runs (k, 1) 2D
convs; the scale discriminator runs 1D convs, four of them grouped. The
convs run in PyTorch's channel-first layout; the feature maps are returned
in the JAX package's layout ([B, H, W, C] for the period discriminators,
[B, T, C] for the scale one) as views, so the two compare like with like.
"""

import math
from typing import List, Tuple

import torch
import torch.nn.functional as F

from reference.vitstrain import nn

Tensor = torch.Tensor

LRELU_SLOPE = 0.1
PERIODS = (2, 3, 5, 7, 11)


def _init_wn_conv2d(generator, out_ch, in_ch, kernel_hw):
    fan_in = in_ch * kernel_hw[0] * kernel_hw[1]
    bound = math.sqrt(1.0 / fan_in) * math.sqrt(3.0)
    v = nn._uniform(generator, (out_ch, in_ch) + tuple(kernel_hw), bound)
    g = torch.sqrt(torch.sum(v * v, dim=(1, 2, 3), keepdim=True))
    return {"weight_v": v, "weight_g": g, "bias": torch.zeros(out_ch)}


def init_discriminator_p(generator, period: int, kernel_size: int = 5,
                         stride: int = 3, channel_scale: int = 1):
    cs = channel_scale
    channels = [(1, 32 // cs), (32 // cs, 128 // cs),
                (128 // cs, 512 // cs), (512 // cs, 1024 // cs)]
    convs = [_init_wn_conv2d(generator, out_ch, in_ch, (kernel_size, 1))
             for in_ch, out_ch in channels]
    convs.append(_init_wn_conv2d(generator, 1024 // cs, 1024 // cs,
                                 (kernel_size, 1)))
    return {
        "period": period,
        "kernel_size": kernel_size,
        "stride": stride,
        "convs": convs,
        "conv_post": _init_wn_conv2d(generator, 1, 1024 // cs, (3, 1)),
    }


def discriminator_p(params, y: Tensor) -> Tuple[Tensor, List[Tensor]]:
    """y [B, N] -> (flattened logits, feature maps [B, H, W, C])."""
    period = params["period"]
    kernel_size = params["kernel_size"]
    stride = params["stride"]
    pad = (kernel_size - 1) // 2

    b, n = y.shape
    if n % period != 0:
        n_pad = period - (n % period)
        y = F.pad(y[:, None, :], (0, n_pad), mode="reflect")[:, 0, :]
        n += n_pad
    x = y.reshape(b, 1, n // period, period)  # [B, C=1, H=t/p, W=p]

    fmap = []
    for i, conv in enumerate(params["convs"]):
        s = (stride, 1) if i < len(params["convs"]) - 1 else (1, 1)
        x = F.conv2d(x, nn.resolve_weight(conv), conv["bias"], stride=s,
                     padding=(pad, 0))
        x = nn.leaky_relu(x, LRELU_SLOPE)
        fmap.append(x.permute(0, 2, 3, 1))
    post = params["conv_post"]
    x = F.conv2d(x, nn.resolve_weight(post), post["bias"], padding=(1, 0))
    fmap.append(x.permute(0, 2, 3, 1))
    return x.reshape(b, -1), fmap


def init_discriminator_s(generator, channel_scale: int = 1):
    cs = channel_scale
    specs = [  # (in, out, kernel, stride, groups, padding)
        (1, 16 // cs, 15, 1, 1, 7),
        (16 // cs, 64 // cs, 41, 4, 4, 20),
        (64 // cs, 256 // cs, 41, 4, 16 // cs if cs <= 4 else 4, 20),
        (256 // cs, 1024 // cs, 41, 4, 64 // cs, 20),
        (1024 // cs, 1024 // cs, 41, 4, 256 // cs, 20),
        (1024 // cs, 1024 // cs, 5, 1, 1, 2),
    ]
    convs = []
    for in_ch, out_ch, k, s, groups, p in specs:
        conv = nn.init_wn_conv(generator, out_ch, in_ch, k, groups=groups)
        conv.update(stride=s, groups=groups, padding=p)
        convs.append(conv)
    return {
        "convs": convs,
        "conv_post": nn.init_wn_conv(generator, 1, 1024 // cs, 3),
    }


def discriminator_s(params, y: Tensor) -> Tuple[Tensor, List[Tensor]]:
    """y [B, N] -> (flattened logits, feature maps [B, T, C])."""
    x = y[..., None]  # [B, N, 1]
    fmap = []
    for conv in params["convs"]:
        x = nn.conv1d(x, nn.resolve_weight(conv), conv.get("bias"),
                      stride=conv["stride"], padding=conv["padding"],
                      groups=conv["groups"])
        x = nn.leaky_relu(x, LRELU_SLOPE)
        fmap.append(x)
    x = nn.conv1d(x, nn.resolve_weight(params["conv_post"]),
                  params["conv_post"].get("bias"), padding=1)
    fmap.append(x)
    return x.reshape(x.shape[0], -1), fmap


def init_multi_period_discriminator(generator, periods=PERIODS,
                                    channel_scale: int = 1):
    """periods / channel_scale shrink it for tests; the defaults are the
    reference's (periods (2, 3, 5, 7, 11), channels up to 1024,
    models.py:495-519)."""
    return {
        "msd": init_discriminator_s(generator, channel_scale=channel_scale),
        "mpd": [init_discriminator_p(generator, p,
                                     channel_scale=channel_scale)
                for p in periods],
    }


def multi_period_discriminator(params, y: Tensor, y_hat: Tensor):
    """Every sub-discriminator on real and generated audio, both in ONE
    batched pass each (the convs are batch-independent, so splitting the
    outputs afterwards is exact). Returns (real logits, fake logits, real
    feature maps, fake feature maps), one entry per sub-discriminator."""
    b = y.shape[0]
    yy = torch.cat([y, y_hat], dim=0)
    y_d_rs, y_d_gs, fmap_rs, fmap_gs = [], [], [], []

    def split(out, fm):
        y_d_rs.append(out[:b])
        y_d_gs.append(out[b:])
        fmap_rs.append([m[:b] for m in fm])
        fmap_gs.append([m[b:] for m in fm])

    split(*discriminator_s(params["msd"], yy))
    for sub in params["mpd"]:
        split(*discriminator_p(sub, yy))
    return y_d_rs, y_d_gs, fmap_rs, fmap_gs
