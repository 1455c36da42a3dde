"""VITS text encoder (reference: phoonnx_train/vits/models.py:168-209)."""

import math
from typing import Optional, Tuple

import torch

from reference.vitstrain import attention, nn

Tensor = torch.Tensor


def init_text_encoder(generator, n_vocab: int, out_channels: int,
                      hidden_channels: int, filter_channels: int,
                      n_heads: int, n_layers: int, kernel_size: int):
    emb = hidden_channels ** -0.5 * torch.randn(
        (n_vocab, hidden_channels), generator=generator)
    return {
        "hidden_channels": hidden_channels,
        "out_channels": out_channels,
        "emb": {"weight": emb},
        "encoder": attention.init_encoder(
            generator, hidden_channels, filter_channels, n_heads, n_layers,
            kernel_size),
        "proj": nn.init_conv(generator, out_channels * 2, hidden_channels, 1),
    }


def text_encoder_train(params, x_ids: Tensor, x_mask: Tensor,
                       p_dropout: float = 0.0,
                       generator: Optional[torch.Generator] = None,
                       deterministic: bool = True
                       ) -> Tuple[Tensor, Tensor, Tensor]:
    """The training text encoder (JAX ``text_encoder`` with dropout): the
    plain, differentiable encoder stack. The JAX training forward runs the
    XLA encoder, never its kernel, and kernel A has no backward."""
    x = nn.embedding(params["emb"], x_ids) * math.sqrt(
        params["hidden_channels"])
    x = attention.encoder_plain(params["encoder"], x * x_mask, x_mask,
                                p_dropout=p_dropout, generator=generator,
                                deterministic=deterministic)
    return _stats(params, x, x_mask)


def _stats(params, x: Tensor, x_mask: Tensor):
    out_channels = params["out_channels"]
    stats = nn.apply_conv(params["proj"], x) * x_mask
    return x, stats[..., :out_channels], stats[..., out_channels:]
