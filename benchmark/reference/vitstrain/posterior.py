"""Posterior encoder and the coupling-flow stack.

Reference: phoonnx_train/vits/models.py:212-296. Synthesis runs the flow
in reverse (kernel B); training runs the posterior encoder and the flow
forward, in plain PyTorch ops as the JAX training forward does.
"""

from typing import Optional, Tuple

import torch

from reference.vitstrain import modules, nn

Tensor = torch.Tensor


def init_posterior_encoder(generator, in_channels: int, out_channels: int,
                           hidden_channels: int, kernel_size: int,
                           dilation_rate: int, n_layers: int,
                           gin_channels: int = 0):
    return {
        "out_channels": out_channels,
        "pre": nn.init_conv(generator, hidden_channels, in_channels, 1),
        "enc": modules.init_wn(generator, hidden_channels, kernel_size,
                               dilation_rate, n_layers,
                               gin_channels=gin_channels),
        "proj": nn.init_conv(generator, out_channels * 2, hidden_channels, 1),
    }


def posterior_encoder(params, y: Tensor, y_mask: Tensor, noise: Tensor,
                      g: Optional[Tensor] = None
                      ) -> Tuple[Tensor, Tensor, Tensor]:
    """spec [B, T, C_spec] -> (z sample, m_q, logs_q).

    ``noise`` [B, T, C_out] is the reparameterisation sample (explicit for
    reproducibility; torch.randn_like in the reference, models.py:295).
    """
    out_channels = params["out_channels"]
    h = nn.apply_conv(params["pre"], y) * y_mask
    h = modules.wn(params["enc"], h, y_mask, g=g)
    stats = nn.apply_conv(params["proj"], h) * y_mask
    m, logs = stats[..., :out_channels], stats[..., out_channels:]
    z = (m + noise * torch.exp(logs)) * y_mask
    return z, m, logs


def init_residual_coupling_block(generator, channels: int,
                                 hidden_channels: int, kernel_size: int,
                                 dilation_rate: int, n_layers: int,
                                 n_flows: int = 4, gin_channels: int = 0):
    return {"flows": [modules.init_residual_coupling_layer(
        generator, channels, hidden_channels, kernel_size, dilation_rate,
        n_layers, gin_channels=gin_channels) for _ in range(n_flows)]}


def coupling_flow_plain(params, x: Tensor, x_mask: Tensor,
                        g: Optional[Tensor] = None,
                        reverse: bool = False) -> Tensor:
    """n x (affine coupling + channel flip) in plain PyTorch ops
    (models.py:247-254); the reverse direction is the plain version of
    kernel B."""
    if not reverse:
        for layer in params["flows"]:
            x, _ = modules.residual_coupling_layer(layer, x, x_mask, g=g)
            x, _ = modules.flip_flow(x)
        return x
    for layer in reversed(params["flows"]):
        x = modules.flip_flow(x, reverse=True)
        x = modules.residual_coupling_layer(layer, x, x_mask, g=g,
                                            reverse=True)
    return x


