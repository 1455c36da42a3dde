"""HiFi-GAN generator (vocoder).

Reference: phoonnx_train/vits/models.py:299-375; PyTorch port of the
unpacked path of ``phoonnx_tpu/models/vits/hifigan.py``. Every stage's
resblock group runs through kernel C (``fused_stage``), the last one with
the generator tail (leaky ReLU 0.01 -> conv_post -> tanh) as its
epilogue.
"""

from typing import Optional, Sequence

import torch

from phoonnx_tpu_torch.models.vits import fused_stage, modules, nn

Tensor = torch.Tensor


def _bleed_extent(params) -> int:
    """Max right receptive-field extent (time positions past ``valid``)
    of any conv consuming a tail-zeroed tensor: the dilated resblock convs
    ((K-1)*d/2), the K=7 pre/post convs (3) and the transposed convs
    (ceil(p/s))."""
    extent = 3
    for block in params["resblocks"]:
        k = int(block["kernel_size"])
        for d in block["dilations"]:
            extent = max(extent, (k * int(d) - int(d)) // 2)
    for rate, kernel in zip(params["upsample_rates"],
                            params["upsample_kernel_sizes"]):
        padding = (kernel - rate) // 2
        extent = max(extent, -(-padding // rate))
    return extent


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


def build_stage_specs(params) -> tuple:
    """Kernel C specs, one per upsampling stage; the last carries the
    generator tail as its epilogue."""
    nk = params["num_kernels"]
    n_stages = len(params["ups"])
    specs = []
    for i in range(n_stages):
        post = None
        if i == n_stages - 1:
            post = (params["conv_post"]["weight"],
                    params["conv_post"].get("bias"), 3, 0.01)
        specs.append(fused_stage.build_group_spec(
            params["resblocks"][i * nk:(i + 1) * nk], modules.LRELU_SLOPE,
            post=post))
    return tuple(specs)


def upsample_stages(params, x: Tensor, g: Optional[Tensor],
                    frame_lengths: Optional[Tensor], build_specs):
    """conv_pre (plus the speaker term), then per upsampling stage a leaky
    ReLU, the transposed conv and the stage's resblock group through
    kernel C, masked to the valid span: the serving part that the HiFi-GAN
    and iSTFT generators share. Returns (x, valid [B], cum_up).

    frame_lengths: optional [B] true frame counts. When given, the bleed
    window past each element's valid length is zeroed after conv_pre, and
    kernel C masks every activation and output row of its stage to the
    valid span, so a padded decode equals the exact-length decode there
    (the reference slices z to the true length before ``dec``,
    models.py:721).

    The specs come from ``fused_stages``, which ``model.attach_fused_specs``
    fills. Parameters on the CPU without them get them from
    ``build_specs(params)`` here; on the GPU a missing spec raises, since
    the kernel needs its stacked weights on the card.
    """
    stages = params.get("fused_stages")
    if stages is None:
        if x.is_cuda:
            raise ValueError(
                "decoder parameters on the GPU carry no kernel C specs: "
                "attach them with model.attach_fused_specs")
        stages = build_specs(params)

    x = nn.apply_conv(params["conv_pre"], x, padding=3)
    if g is not None:
        x = x + nn.apply_conv(params["cond"], g)
    if frame_lengths is not None:
        valid = frame_lengths.to(torch.int32)
        x = nn.zero_time_tail(x, valid,
                              nn.bleed_window_rows(_bleed_extent(params)))
    else:
        valid = torch.full((x.shape[0],), x.shape[1], dtype=torch.int32,
                           device=x.device)

    cum_up = 1
    for i, up in enumerate(params["ups"]):
        rate = params["upsample_rates"][i]
        kernel = params["upsample_kernel_sizes"][i]
        cum_up *= rate
        x = nn.leaky_relu(x, modules.LRELU_SLOPE)
        x = nn.conv_transpose1d(x, nn.resolve_weight(up), up.get("bias"),
                                stride=rate, padding=(kernel - rate) // 2)
        x = fused_stage.apply_group(stages[i], x.contiguous(),
                                    valid=valid * cum_up)
    return x, valid, cum_up


def generator(params, x: Tensor, g: Optional[Tensor] = None,
              frame_lengths: Optional[Tensor] = None) -> Tensor:
    """Latent frames [B, T, C] -> waveform [B, T * prod(rates)].

    The stages of :func:`upsample_stages` (frame_lengths as there), the
    last one's kernel C call carrying the generator tail (leaky ReLU 0.01
    -> conv_post -> tanh, models.py:364) as its epilogue, which writes the
    audio [B, T, 1].
    """
    x, _, _ = upsample_stages(params, x, g, frame_lengths, build_stage_specs)
    return x[..., 0]


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
