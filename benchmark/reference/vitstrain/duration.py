"""Duration models: the stochastic (flow-based) predictor, forward for the
training likelihood and in reverse for synthesis, and the deterministic
predictor.

Reference: phoonnx_train/vits/models.py:14-165. The SDP's noise (e_q in
training, z at synthesis) is an explicit argument so a run is
reproducible and verifiable against other runtimes.
"""

import math
from typing import Optional

import torch
import torch.nn.functional as F

from reference.vitstrain import modules, nn

Tensor = torch.Tensor


def init_stochastic_duration_predictor(generator, in_channels: int,
                                       filter_channels: int,
                                       kernel_size: int, n_flows: int = 4,
                                       gin_channels: int = 0):
    # the reference overrides filter_channels with in_channels
    # (models.py:25); keep that so checkpoints line up
    filter_channels = in_channels
    params = {"filter_channels": filter_channels}
    flows = [{"ea": modules.init_elementwise_affine(2)}]
    for _ in range(n_flows):
        flows.append({"cf": modules.init_conv_flow(
            generator, 2, filter_channels, kernel_size, n_layers=3)})
    params["flows"] = flows
    params["post_pre"] = nn.init_conv(generator, filter_channels, 1, 1)
    params["post_proj"] = nn.init_conv(generator, filter_channels,
                                       filter_channels, 1)
    params["post_convs"] = modules.init_dds_conv(generator, filter_channels,
                                                 kernel_size, n_layers=3)
    post_flows = [{"ea": modules.init_elementwise_affine(2)}]
    for _ in range(4):
        post_flows.append({"cf": modules.init_conv_flow(
            generator, 2, filter_channels, kernel_size, n_layers=3)})
    params["post_flows"] = post_flows
    params["pre"] = nn.init_conv(generator, filter_channels, in_channels, 1)
    params["proj"] = nn.init_conv(generator, filter_channels,
                                  filter_channels, 1)
    params["convs"] = modules.init_dds_conv(generator, filter_channels,
                                            kernel_size, n_layers=3)
    if gin_channels:
        params["cond"] = nn.init_conv(generator, filter_channels,
                                      gin_channels, 1)
    return params


def _condition(params, x: Tensor, x_mask: Tensor, g: Optional[Tensor],
               p_dropout: float = 0.0,
               generator: Optional[torch.Generator] = None,
               deterministic: bool = True) -> Tensor:
    """Shared conditioning trunk: pre -> (+cond g) -> DDSConv -> proj. No
    gradient flows back into x or g (the reference detaches both)."""
    x = nn.apply_conv(params["pre"], x.detach())
    if g is not None:
        x = x + nn.apply_conv(params["cond"], g.detach())
    x = modules.dds_conv(params["convs"], x, x_mask, p_dropout=p_dropout,
                         generator=generator, deterministic=deterministic)
    return nn.apply_conv(params["proj"], x) * x_mask


def sdp_nll(params, x: Tensor, x_mask: Tensor, w: Tensor, e_q: Tensor,
            g: Optional[Tensor] = None, p_dropout: float = 0.5,
            generator: Optional[torch.Generator] = None,
            deterministic: bool = True) -> Tensor:
    """Training-mode negative log-likelihood of durations ``w`` [B, T, 1].

    ``e_q`` [B, T, 2] is the posterior noise sample (torch.randn in the
    reference, models.py:80). Returns the per-example nll [B]. The DDSConv
    stacks regularise with dropout 0.5 in training, as in the reference
    (models.py:25).
    """
    drop = dict(p_dropout=p_dropout, generator=generator,
                deterministic=deterministic)
    x = _condition(params, x, x_mask, g, **drop)

    # variational posterior over (u, nu): a flow from e_q conditioned on
    # x + h_w
    h_w = nn.apply_conv(params["post_pre"], w)
    h_w = modules.dds_conv(params["post_convs"], h_w, x_mask, **drop)
    h_w = nn.apply_conv(params["post_proj"], h_w) * x_mask

    e_q = e_q * x_mask
    z_q = e_q
    logdet_tot_q = torch.zeros(x.shape[0], dtype=x.dtype, device=x.device)
    cond_q = x + h_w
    for flow in params["post_flows"]:
        if "ea" in flow:
            z_q, logdet = modules.elementwise_affine(flow["ea"], z_q, x_mask)
        else:
            z_q, logdet = modules.conv_flow(flow["cf"], z_q, x_mask, g=cond_q)
            logdet_tot_q = logdet_tot_q + logdet
            z_q, logdet = modules.flip_flow(z_q)
        logdet_tot_q = logdet_tot_q + logdet

    z_u, z1 = z_q[..., :1], z_q[..., 1:]
    u = torch.sigmoid(z_u) * x_mask
    z0 = (w - u) * x_mask
    logdet_tot_q = logdet_tot_q + torch.sum(
        (F.logsigmoid(z_u) + F.logsigmoid(-z_u)) * x_mask, dim=(1, 2))
    logq = (torch.sum(-0.5 * (math.log(2 * math.pi) + torch.square(e_q))
                      * x_mask, dim=(1, 2))
            - logdet_tot_q)

    # prior flow over (log w - u, nu)
    logdet_tot = torch.zeros(x.shape[0], dtype=x.dtype, device=x.device)
    z0, logdet = modules.log_flow(z0, x_mask)
    logdet_tot = logdet_tot + logdet
    z = torch.cat([z0, z1], dim=-1)
    for flow in params["flows"]:
        if "ea" in flow:
            z, logdet = modules.elementwise_affine(flow["ea"], z, x_mask)
            logdet_tot = logdet_tot + logdet
        else:
            z, logdet = modules.conv_flow(flow["cf"], z, x_mask, g=x)
            logdet_tot = logdet_tot + logdet
            z, logdet = modules.flip_flow(z)
            logdet_tot = logdet_tot + logdet
    nll = (torch.sum(0.5 * (math.log(2 * math.pi) + torch.square(z))
                     * x_mask, dim=(1, 2))
           - logdet_tot)
    return nll + logq


def sdp_reverse(params, x: Tensor, x_mask: Tensor, z: Tensor,
                g: Optional[Tensor] = None) -> Tensor:
    """Inference: sample log-durations from noise ``z`` [B, T, 2], already
    scaled by noise_w. Mirrors the reference's reversed flow list, which
    drops the first ConvFlow (models.py:109-110)."""
    x = _condition(params, x, x_mask, g)
    flows = params["flows"]
    for flow in reversed(flows[2:]):
        z = modules.flip_flow(z, reverse=True)
        z = modules.conv_flow(flow["cf"], z, x_mask, g=x, reverse=True)
    z = modules.flip_flow(z, reverse=True)
    z = modules.elementwise_affine(flows[0]["ea"], z, x_mask, reverse=True)
    return z[..., :1]


def init_duration_predictor(generator, in_channels: int,
                            filter_channels: int, kernel_size: int,
                            gin_channels: int = 0):
    params = {
        "kernel_size": kernel_size,
        "conv_1": nn.init_conv(generator, filter_channels, in_channels,
                               kernel_size),
        "norm_1": nn.init_layer_norm(filter_channels),
        "conv_2": nn.init_conv(generator, filter_channels, filter_channels,
                               kernel_size),
        "norm_2": nn.init_layer_norm(filter_channels),
        "proj": nn.init_conv(generator, 1, filter_channels, 1),
    }
    if gin_channels:
        params["cond"] = nn.init_conv(generator, in_channels, gin_channels, 1)
    return params


def duration_predictor(params, x: Tensor, x_mask: Tensor,
                       g: Optional[Tensor] = None, p_dropout: float = 0.0,
                       generator: Optional[torch.Generator] = None,
                       deterministic: bool = True) -> Tensor:
    """Deterministic log-duration head (models.py:120-165); no gradient
    flows back into x or g."""
    pad = params["kernel_size"] // 2
    x = x.detach()
    if g is not None:
        x = x + nn.apply_conv(params["cond"], g.detach())
    x = nn.apply_conv(params["conv_1"], x * x_mask, padding=pad)
    x = nn.layer_norm(params["norm_1"], torch.relu(x))
    x = nn.dropout(x, p_dropout, generator, deterministic)
    x = nn.apply_conv(params["conv_2"], x * x_mask, padding=pad)
    x = nn.layer_norm(params["norm_2"], torch.relu(x))
    x = nn.dropout(x, p_dropout, generator, deterministic)
    x = nn.apply_conv(params["proj"], x * x_mask)
    return x * x_mask
