"""VITS GAN training step: one generator and one discriminator update.

PyTorch port of ``phoonnx_tpu/train/step.py`` (the reference Lightning
module's two-optimizer alternation, phoonnx_train/vits/lightning.py:
196-280). The generator forward runs once; the discriminator update sees
the generated audio detached, as Lightning's second optimizer reuses the
cached y / y_hat. Gradients of the generator objective are taken with
respect to the generator's leaves only (it also runs the discriminator).

Float32 only. The JAX step's ``compute_dtype="bfloat16"``, ``remat`` and
``grad_accum`` have no counterpart here yet (ROADMAP.md, port queue item
7); ``mas_impl`` and ``data_axis_size`` were TPU policy and bookkeeping.
"""

from typing import Any, Dict, Iterator, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from phoonnx_tpu_torch.models.vits import discriminator as disc
from phoonnx_tpu_torch.models.vits import model as vits_model
from phoonnx_tpu_torch.models.vits.model import VitsHParams
from phoonnx_tpu_torch.ops import stft
from phoonnx_tpu_torch.train import losses

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
    grad_clip: Optional[float] = None
    disc_periods: Tuple[int, ...] = (2, 3, 5, 7, 11)
    disc_channel_scale: int = 1  # >1 shrinks the discriminator (tests)


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


def init_train_state(hp: VitsHParams, cfg: TrainConfig,
                     generator: Optional[torch.Generator] = None,
                     device="cpu") -> TrainState:
    """Random G and D from ``generator`` (made on the CPU, then moved)."""
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    params_g = vits_model.random_params(hp, generator)
    params_d = disc.init_multi_period_discriminator(
        generator, periods=cfg.disc_periods,
        channel_scale=cfg.disc_channel_scale)
    params_g = vits_model.params_to_device(params_g, device)
    params_d = vits_model.params_to_device(params_d, device)
    for tree in (params_g, params_d):
        for t in leaves(tree):
            t.requires_grad_(True)
    return TrainState(params_g, params_d,
                      make_optimizer(cfg, leaves(params_g)),
                      make_optimizer(cfg, leaves(params_d)))


def clip_by_global_norm(grads: List[Tensor], max_norm: float
                        ) -> List[Tensor]:
    """optax.clip_by_global_norm: unchanged below ``max_norm``, else
    ``g / norm * max_norm``. (torch's clip_grad_norm_ scales by
    ``max_norm / (norm + 1e-6)`` instead; this keeps the JAX rule.)"""
    norm = torch.sqrt(sum(torch.sum(torch.square(g)) for g in grads))
    keep = norm < max_norm
    return [torch.where(keep, g, g / norm * max_norm) for g in grads]


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
                        deterministic: bool,
                        generator: Optional[torch.Generator] = None,
                        noise: Optional[Dict[str, Tensor]] = None):
    """(total generator loss, aux): the training forward, the mel, KL,
    duration, feature-matching and adversarial terms (step.py:161-208).
    ``noise`` may inject ``post_noise``, ``e_q`` and ``slice_u`` into
    :func:`model.train_forward`."""
    out = vits_model.train_forward(
        params_g, hp, batch["phoneme_ids"], batch["phoneme_lengths"],
        batch["spec"], batch["spec_lengths"], sid=batch.get("sid"),
        deterministic=deterministic, generator=generator, **(noise or {}))
    y_hat = out["audio"]  # [B, segment_samples]
    y = vits_model.slice_audio_segments(
        batch["audio"], out["ids_slice"], hp.segment_size * hp.hop_length,
        hp.hop_length)

    mel_hat = _mel(y_hat, hp)
    # the mel TARGET is the full utterance's spectrogram, frame-sliced
    # (lightning.py:216-228), not the mel of the sliced waveform
    mel_full = stft.spec_to_mel(batch["spec"], hp.sample_rate,
                                hp.filter_length, hp.mel_channels)
    mel_real = vits_model._slice_segments(mel_full, out["ids_slice"],
                                          hp.segment_size)
    loss_mel = torch.mean(torch.abs(mel_real - mel_hat)) * cfg.c_mel
    loss_kl = losses.kl_loss(out["z_p"], out["logs_q"], out["m_p"],
                             out["logs_p"], out["y_mask"]) * cfg.c_kl
    # a SUM over the batch, as the reference (lightning.py:253)
    loss_dur = torch.sum(out["l_length"])

    _, y_d_gs, fmap_rs, fmap_gs = disc.multi_period_discriminator(
        params_d, y, y_hat)
    loss_fm = losses.feature_loss(fmap_rs, fmap_gs)
    loss_gen, _ = losses.generator_loss(y_d_gs)

    total = loss_gen + loss_fm + loss_mel + loss_dur + loss_kl
    aux = {"loss_gen_all": total, "loss_mel": loss_mel, "loss_kl": loss_kl,
           "loss_dur": loss_dur, "loss_fm": loss_fm, "loss_gen": loss_gen,
           "y": y, "y_hat": y_hat}
    return total, aux


def discriminator_objective(params_d, y: Tensor, y_hat: Tensor) -> Tensor:
    """LSGAN discriminator loss on real and (detached) generated audio."""
    y_d_rs, y_d_gs, _, _ = disc.multi_period_discriminator(
        params_d, y.detach(), y_hat.detach())
    loss_d, _, _ = losses.discriminator_loss(y_d_rs, y_d_gs)
    return loss_d


def _micro_grads(state: TrainState, batch: Dict[str, Tensor],
                 hp: VitsHParams, cfg: TrainConfig, eval_mode: bool,
                 generator: Optional[torch.Generator] = None,
                 noise: Optional[Dict[str, Tensor]] = None):
    """(grads_g, grads_d, metrics) for one batch, no update; the grads are
    None in eval mode (dropout off, no graph)."""
    with torch.set_grad_enabled(not eval_mode):
        total, aux = generator_objective(
            state.params_g, state.params_d, batch, hp, cfg,
            deterministic=eval_mode, generator=generator, noise=noise)
        grads_g = None
        if not eval_mode:
            grads_g = torch.autograd.grad(total, leaves(state.params_g))
        loss_d = discriminator_objective(state.params_d, aux["y"],
                                         aux["y_hat"])
        grads_d = None
        if not eval_mode:
            grads_d = torch.autograd.grad(loss_d, leaves(state.params_d))
    metrics = {key: aux[key].detach() for key in METRICS
               if key != "loss_disc_all"}
    metrics["loss_disc_all"] = loss_d.detach()
    return grads_g, grads_d, metrics


def _update(opt: torch.optim.Optimizer, params: List[Tensor],
            grads, cfg: TrainConfig, step: int) -> None:
    grads = list(grads)
    if cfg.grad_clip is not None:
        grads = clip_by_global_norm(grads, cfg.grad_clip)
    lr = learning_rate(cfg, step)
    for group in opt.param_groups:
        group["lr"] = lr
    for p, g in zip(params, grads):
        p.grad = g
    opt.step()
    opt.zero_grad(set_to_none=True)


def train_step(state: TrainState, batch: Dict[str, Tensor], hp: VitsHParams,
               cfg: TrainConfig, generator: Optional[torch.Generator] = None,
               eval_mode: bool = False,
               noise: Optional[Dict[str, Tensor]] = None
               ) -> Tuple[TrainState, Dict[str, Tensor]]:
    """One G+D update, in place on ``state``; returns (state, metrics).

    batch: phoneme_ids [B, T_x] int64, phoneme_lengths [B], spec
    [B, T_y, C], spec_lengths [B], audio [B, N] (N >= T_y * hop), sid [B]
    (optional), on the state's device (:func:`batch_to_device`).
    ``generator`` draws the noise and dropout masks. ``eval_mode=True``
    runs the losses with dropout off and leaves the state unchanged
    (validation, lightning.py:282-306). The metrics are 0-d tensors on the
    device (reading them waits for the step).
    """
    grads_g, grads_d, metrics = _micro_grads(
        state, batch, hp, cfg, eval_mode, generator=generator, noise=noise)
    if eval_mode:
        return state, metrics
    _update(state.opt_g, leaves(state.params_g), grads_g, cfg, state.step)
    _update(state.opt_d, leaves(state.params_d), grads_d, cfg, state.step)
    state.step += 1
    return state, metrics
