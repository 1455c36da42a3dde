"""The VITS GAN training step in float32: one generator and one
discriminator update, as the program's ``train/step.py`` computes it with
its defaults (no gradient accumulation, no recomputation, no data
parallelism): the training forward, the mel, KL, duration,
feature-matching and adversarial terms, the LSGAN discriminator loss on
the detached audio, and AdamW on each network. A frozen copy, rewired to
the frozen copies of the model's modules; the noise and dropout masks come
from the step's generator in the program's order of draws.
"""

from typing import Any, Dict, Iterator, List, NamedTuple, Tuple

import numpy as np
import torch

from reference.vitstrain import discriminator as disc
from reference.vitstrain import losses, stft
from reference.vitstrain import model as vits_model
from reference.vitstrain.model import VitsHParams

Tensor = torch.Tensor

# torch.optim.AdamW's default, which the reference uses
# (lightning.py:309-321 passes none)
WEIGHT_DECAY = 0.01

METRICS = ("loss_gen_all", "loss_disc_all", "loss_mel", "loss_kl",
           "loss_dur", "loss_fm")


class TrainConfig(NamedTuple):
    """Optimization hyperparameters (lightning.py:60-73)."""

    learning_rate: float = 2e-4
    betas: Tuple[float, float] = (0.8, 0.99)
    eps: float = 1e-9
    lr_decay: float = 0.999875  # per epoch
    steps_per_epoch: int = 1000
    c_mel: float = 45.0
    c_kl: float = 1.0


def keyed_leaves(tree: Any, prefix: str = "") -> Iterator[Tuple[str, Tensor]]:
    """(name, tensor) for every tensor of a parameter tree, named as
    ``jax.tree_util.keystr`` names the JAX package's leaves
    (``['enc_p']['encoder']['layers'][0]...``). Ints, strings, tuples and
    None are structure, not leaves, as the JAX package's static wrappers
    make them."""
    if isinstance(tree, dict):
        for key in sorted(tree):
            yield from keyed_leaves(tree[key], f"{prefix}[{key!r}]")
    elif isinstance(tree, list):
        for i, sub in enumerate(tree):
            yield from keyed_leaves(sub, f"{prefix}[{i}]")
    elif isinstance(tree, torch.Tensor):
        yield prefix, tree


def leaves(tree: Any) -> List[Tensor]:
    return [t for _, t in keyed_leaves(tree)]


class TrainState:
    """Generator and discriminator parameter trees (their tensors require
    grad), one AdamW optimizer for each, and the count of updates."""

    def __init__(self, params_g, params_d, opt_g: torch.optim.Optimizer,
                 opt_d: torch.optim.Optimizer, step: int = 0):
        self.params_g = params_g
        self.params_d = params_d
        self.opt_g = opt_g
        self.opt_d = opt_d
        self.step = step


def learning_rate(cfg: TrainConfig, step: int) -> float:
    """The reference's exponential per-epoch decay: a staircase on the
    update count (optax.exponential_decay with staircase=True)."""
    return cfg.learning_rate * cfg.lr_decay ** (step // cfg.steps_per_epoch)


def make_optimizer(cfg: TrainConfig, params: List[Tensor]
                   ) -> torch.optim.AdamW:
    """AdamW as the reference configures it; :func:`train_step` sets the
    scheduled rate before each update."""
    return torch.optim.AdamW(params, lr=cfg.learning_rate, betas=cfg.betas,
                             eps=cfg.eps, weight_decay=WEIGHT_DECAY)


def batch_to_device(batch: Dict[str, np.ndarray], device) -> Dict[str, Tensor]:
    """A loader batch (numpy) as tensors on ``device``: ids and speaker ids
    as int64 for indexing, lengths int32, spec and audio float32."""
    out = {}
    for key, value in batch.items():
        t = torch.as_tensor(np.asarray(value))
        if key in ("phoneme_ids", "sid"):
            t = t.long()
        out[key] = t.to(device, non_blocking=True)
    return out


def _mel(y: Tensor, hp: VitsHParams) -> Tensor:
    return stft.mel_spectrogram(y, hp.filter_length, hp.mel_channels,
                                hp.sample_rate, hp.hop_length, hp.win_length)


def generator_objective(params_g, params_d, batch: Dict[str, Tensor],
                        hp: VitsHParams, cfg: TrainConfig,
                        generator: torch.Generator):
    """(total generator loss, aux)."""
    out = vits_model.train_forward(
        params_g, hp, batch["phoneme_ids"], batch["phoneme_lengths"],
        batch["spec"], batch["spec_lengths"], sid=batch.get("sid"),
        deterministic=False, generator=generator)
    y_hat = out["audio"]
    y = vits_model.slice_audio_segments(
        batch["audio"], out["ids_slice"], hp.segment_size * hp.hop_length,
        hp.hop_length)
    mel_hat = _mel(y_hat, hp)
    # the mel target is the full utterance's spectrogram, frame-sliced
    mel_full = stft.spec_to_mel(batch["spec"], hp.sample_rate,
                                hp.filter_length, hp.mel_channels)
    mel_real = vits_model._slice_segments(mel_full, out["ids_slice"],
                                          hp.segment_size)
    loss_mel = torch.mean(torch.abs(mel_real - mel_hat)) * cfg.c_mel
    loss_kl = losses.kl_loss(
        *(out[k] for k in ("z_p", "logs_q", "m_p", "logs_p", "y_mask")),
        count=None) * cfg.c_kl
    # a sum over the batch, as the reference (lightning.py:253)
    loss_dur = torch.sum(out["l_length"])
    _, y_d_gs, fmap_rs, fmap_gs = disc.multi_period_discriminator(
        params_d, y, y_hat)
    loss_fm = losses.feature_loss(fmap_rs, fmap_gs)
    loss_gen, _ = losses.generator_loss(y_d_gs)
    total = loss_gen + loss_fm + loss_mel + loss_dur + loss_kl
    return total, {"y": y, "y_hat": y_hat}


def discriminator_objective(params_d, y: Tensor, y_hat: Tensor) -> Tensor:
    y_d_rs, y_d_gs, _, _ = disc.multi_period_discriminator(
        params_d, y.detach(), y_hat.detach())
    loss_d, _, _ = losses.discriminator_loss(y_d_rs, y_d_gs)
    return loss_d


def _update(opt: torch.optim.Optimizer, params: List[Tensor], grads,
            cfg: TrainConfig, step: int) -> None:
    for group in opt.param_groups:
        group["lr"] = learning_rate(cfg, step)
    for p, g in zip(params, grads):
        p.grad = g
    opt.step()
    opt.zero_grad(set_to_none=True)


def train_step(state: TrainState, batch: Dict[str, Tensor], hp: VitsHParams,
               cfg: TrainConfig, generator: torch.Generator
               ) -> Dict[str, float]:
    """One G+D update in place on ``state``; (generator loss,
    discriminator loss)."""
    total, aux = generator_objective(state.params_g, state.params_d, batch,
                                     hp, cfg, generator)
    grads_g = torch.autograd.grad(total, leaves(state.params_g))
    loss_d = discriminator_objective(state.params_d, aux["y"], aux["y_hat"])
    grads_d = torch.autograd.grad(loss_d, leaves(state.params_d))
    _update(state.opt_g, leaves(state.params_g), grads_g, cfg, state.step)
    _update(state.opt_d, leaves(state.params_d), grads_d, cfg, state.step)
    state.step += 1
    return {"loss_gen_all": float(total.detach()),
            "loss_disc_all": float(loss_d.detach())}
