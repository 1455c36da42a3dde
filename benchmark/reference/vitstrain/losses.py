"""VITS training losses (reference: phoonnx_train/vits/losses.py)."""

from typing import List, Optional, Tuple

import torch

Tensor = torch.Tensor


def feature_loss(fmap_r: List[List[Tensor]],
                 fmap_g: List[List[Tensor]]) -> Tensor:
    """L1 feature matching over all discriminator activations, x2."""
    loss = 0.0
    for disc_r, disc_g in zip(fmap_r, fmap_g):
        for feat_r, feat_g in zip(disc_r, disc_g):
            loss = loss + torch.mean(torch.abs(feat_r.detach() - feat_g))
    return loss * 2.0


def discriminator_loss(real_outputs: List[Tensor],
                       generated_outputs: List[Tensor]
                       ) -> Tuple[Tensor, List[Tensor], List[Tensor]]:
    """LSGAN discriminator loss: (1-D(y))^2 + D(y_hat)^2."""
    loss = 0.0
    r_losses, g_losses = [], []
    for real, generated in zip(real_outputs, generated_outputs):
        r_loss = torch.mean(torch.square(1.0 - real))
        g_loss = torch.mean(torch.square(generated))
        loss = loss + r_loss + g_loss
        r_losses.append(r_loss)
        g_losses.append(g_loss)
    return loss, r_losses, g_losses


def generator_loss(generated_outputs: List[Tensor]
                   ) -> Tuple[Tensor, List[Tensor]]:
    """LSGAN generator loss: (1-D(y_hat))^2."""
    loss = 0.0
    gen_losses = []
    for generated in generated_outputs:
        g_loss = torch.mean(torch.square(1.0 - generated))
        gen_losses.append(g_loss)
        loss = loss + g_loss
    return loss, gen_losses


def kl_loss(z_p: Tensor, logs_q: Tensor, m_p: Tensor, logs_p: Tensor,
            z_mask: Tensor, count: Optional[Tensor] = None) -> Tensor:
    """Masked KL(q||p) between posterior sample and aligned prior.

    All tensors [B, T, C] except z_mask [B, T, 1] (losses.py:43-58).
    ``count``: the denominator; None is this batch's frame count,
    ``sum(z_mask)`` (under data parallelism the step passes the global
    batch's count over the number of ranks).
    """
    kl = logs_p - logs_q - 0.5
    kl = kl + 0.5 * torch.square(z_p - m_p) * torch.exp(-2.0 * logs_p)
    return torch.sum(kl * z_mask) / (torch.sum(z_mask) if count is None
                                     else count)
