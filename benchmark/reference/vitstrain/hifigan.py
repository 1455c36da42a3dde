"""HiFi-GAN generator (vocoder), the training decoder in plain PyTorch.

Reference: phoonnx_train/vits/models.py:299-375.
"""

from typing import Optional, Sequence

import torch

from reference.vitstrain import modules, nn

Tensor = torch.Tensor


def init_generator(generator, initial_channel: int, resblock: str,
                   resblock_kernel_sizes: Sequence[int],
                   resblock_dilation_sizes: Sequence[Sequence[int]],
                   upsample_rates: Sequence[int],
                   upsample_initial_channel: int,
                   upsample_kernel_sizes: Sequence[int],
                   gin_channels: int = 0):
    params = {
        "resblock_type": resblock,
        "num_kernels": len(resblock_kernel_sizes),
        "upsample_rates": tuple(upsample_rates),
        "upsample_kernel_sizes": tuple(upsample_kernel_sizes),
    }
    params["conv_pre"] = nn.init_conv(generator, upsample_initial_channel,
                                      initial_channel, 7)
    ups = []
    for i, kernel in enumerate(upsample_kernel_sizes):
        in_ch = upsample_initial_channel // (2 ** i)
        out_ch = upsample_initial_channel // (2 ** (i + 1))
        # torch ConvTranspose1d layout [I, O, K]; normal(0, 0.01) init
        v = 0.01 * torch.randn((in_ch, out_ch, kernel), generator=generator)
        g = torch.sqrt(torch.sum(v * v, dim=(1, 2), keepdim=True))
        ups.append({"weight_v": v, "weight_g": g,
                    "bias": torch.zeros(out_ch)})
    params["ups"] = ups
    init_fn = (modules.init_resblock1 if resblock == "1"
               else modules.init_resblock2)
    resblocks = []
    for i in range(len(ups)):
        ch = upsample_initial_channel // (2 ** (i + 1))
        for kernel, dilations in zip(resblock_kernel_sizes,
                                     resblock_dilation_sizes):
            resblocks.append(init_fn(generator, ch, kernel, dilations))
    params["resblocks"] = resblocks
    final_ch = upsample_initial_channel // (2 ** len(ups))
    params["conv_post"] = nn.init_conv(generator, 1, final_ch, 7, bias=False)
    if gin_channels:
        params["cond"] = nn.init_conv(generator, upsample_initial_channel,
                                      gin_channels, 1)
    return params


def upsample_stages_train(params, x: Tensor,
                          g: Optional[Tensor] = None) -> Tensor:
    """conv_pre, then per upsampling stage a leaky ReLU, the transposed
    conv and the mean of the stage's resblocks, in plain PyTorch ops
    (models.py:345-362): the part of the training decoder that the
    HiFi-GAN and iSTFT families share."""
    num_kernels = params["num_kernels"]
    resblock_fn = (modules.resblock1 if params["resblock_type"] == "1"
                   else modules.resblock2)
    x = nn.apply_conv(params["conv_pre"], x, padding=3)
    if g is not None:
        x = x + nn.apply_conv(params["cond"], g)
    for i, up in enumerate(params["ups"]):
        rate = params["upsample_rates"][i]
        kernel = params["upsample_kernel_sizes"][i]
        x = nn.leaky_relu(x, modules.LRELU_SLOPE)
        x = nn.conv_transpose1d(x, nn.resolve_weight(up), up.get("bias"),
                                stride=rate, padding=(kernel - rate) // 2)
        acc = None
        for j in range(num_kernels):
            out = resblock_fn(params["resblocks"][i * num_kernels + j], x)
            acc = out if acc is None else acc + out
        x = acc / num_kernels
    return x


def generator_train(params, x: Tensor, g: Optional[Tensor] = None) -> Tensor:
    """The decoder the training step differentiates: latent frames
    [B, T, C] -> waveform [B, T * prod(rates)], in plain PyTorch ops.

    This is the JAX semantics, not a fallback: the JAX training forward
    decodes a segment of whole frames with no frame lengths through the
    XLA path of ``hifigan.generator`` (no padding to mask, no kernel), and
    kernel C has no backward. The stages (:func:`upsample_stages_train`)
    are followed by leaky ReLU 0.01, conv_post and tanh
    (models.py:363-365).
    """
    x = nn.leaky_relu(upsample_stages_train(params, x, g), 0.01)
    x = nn.conv1d(x, params["conv_post"]["weight"],
                  params["conv_post"].get("bias"), padding=3)
    return torch.tanh(x)[..., 0]
