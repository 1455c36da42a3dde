"""VITS GAN training step: one generator and one discriminator update.

PyTorch port of ``phoonnx_tpu/train/step.py`` (the reference Lightning
module's two-optimizer alternation, phoonnx_train/vits/lightning.py:
196-280). The generator forward runs once; the discriminator update sees
the generated audio detached, as Lightning's second optimizer reuses the
cached y / y_hat. Gradients of the generator objective are taken with
respect to the generator's leaves only (it also runs the discriminator).

The JAX step's options (step.py:132-159, 247-289): ``compute_dtype=
"bfloat16"`` computes the forward and backward in bf16 against float32
master weights, with the mel and the losses in float32; ``grad_accum``
averages the gradients of that many micro-batches before one update of
each network; ``remat`` recomputes the generator forward in the backward
pass (``torch.utils.checkpoint``). ``mas_impl`` and ``data_axis_size``
were TPU policy and bookkeeping and have no counterpart.

Data parallelism (``mesh``, ``parallel/mesh.py``) computes the JAX step's
math under a mesh, which is the single-device step's on the global batch
and key (``tests/test_multidevice_equivalence.py``): each rank holds its
rows of the global batch (of each global micro-batch, under
``grad_accum``), draws its rows of the noise and dropout masks that one
process draws for the whole batch (``nn.RowWindow``), divides the KL and
the duration loss by the global batch's frame and token counts over the
number of ranks (:func:`denominators`), and averages its gradients and
metrics across ranks before the clip and the update.
"""

from typing import Any, Dict, Iterator, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from phoonnx_tpu_torch import observability
from phoonnx_tpu_torch.models.vits import discriminator as disc
from phoonnx_tpu_torch.models.vits import model as vits_model
from phoonnx_tpu_torch.models.vits import nn
from phoonnx_tpu_torch.models.vits.model import VitsHParams
from phoonnx_tpu_torch.ops import stft
from phoonnx_tpu_torch.parallel import mesh as dp
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
    remat: bool = False  # recompute the generator forward (saves memory)
    # "bfloat16": forward/backward in bf16 with f32 master weights,
    # optimizer state and losses (mixed precision); kernel D takes f32
    # scores (ops/mas.py casts them)
    compute_dtype: str = "float32"
    # >1: split the batch into this many micro-batches, average their
    # gradients, apply ONE update (activation memory scales with the
    # micro-batch). Every loss term is a batch mean except the duration
    # SUM the reference uses (lightning.py:253), which averages over
    # micro-batches here, as in the JAX step.
    grad_accum: int = 1


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


def compute_dtype(cfg: TrainConfig) -> torch.dtype:
    if cfg.compute_dtype not in ("float32", "bfloat16"):
        raise ValueError(f"compute_dtype {cfg.compute_dtype!r}: 'float32' "
                         "or 'bfloat16'")
    return torch.bfloat16 if cfg.compute_dtype == "bfloat16" else torch.float32


def _checkpointed_forward(forward, generator: Optional[torch.Generator]):
    """``forward`` under ``torch.utils.checkpoint``: its activations are
    recomputed in the backward pass. The checkpoint restores only the
    global RNGs for the recompute, and the training forward draws its
    noise and dropout masks from ``generator``; so every call of the
    wrapped function first resets ``generator`` to its state at the
    first call, and the recompute draws the masks the forward drew."""
    from torch.utils.checkpoint import checkpoint

    state = None if generator is None else generator.get_state()

    def run():
        if state is not None:
            generator.set_state(state)
        return forward()

    return checkpoint(run, use_reentrant=False)


def denominators(batch: Dict[str, Tensor], mesh: "dp.Mesh"
                 ) -> Tuple[Tensor, Tensor]:
    """(tokens, frames): the duration loss's and the KL's denominators
    under data parallelism, the global batch's token and frame counts (the
    masks' sums) over the number of ranks. Each rank's objective is then
    the number of ranks times its share of the global objective, and the
    mean of the ranks' gradients is the gradient one process takes on the
    whole batch. One ``all_reduce``; the counts need no gradient."""
    t_x, t_y = batch["phoneme_ids"].shape[1], batch["spec"].shape[1]
    local = torch.stack([
        torch.clamp(batch["phoneme_lengths"], max=t_x).sum(),
        torch.clamp(batch["spec_lengths"], max=t_y).sum()]).float()
    tokens, frames = dp.all_mean(mesh, [local])[0]
    return tokens, frames


def generator_objective(params_g, params_d, batch: Dict[str, Tensor],
                        hp: VitsHParams, cfg: TrainConfig,
                        deterministic: bool,
                        generator: Optional[torch.Generator] = None,
                        noise: Optional[Dict[str, Tensor]] = None,
                        mesh: Optional["dp.Mesh"] = None):
    """(total generator loss, aux): the training forward, the mel, KL,
    duration, feature-matching and adversarial terms (step.py:161-208).
    ``noise`` may inject ``post_noise``, ``e_q`` and ``slice_u`` into
    :func:`model.train_forward`. Under ``mesh`` the KL and the duration
    loss take the global :func:`denominators`.

    In bf16 (``cfg.compute_dtype``) the parameters and the batch are cast
    inside the objective, so the gradients land on the float32 leaves;
    the mel of the generated audio and every loss are float32. With
    ``cfg.remat`` the training forward is checkpointed."""
    dtype = compute_dtype(cfg)
    cast_batch = nn.cast_floating(batch, dtype)
    tokens = frames = None
    if mesh is not None:
        tokens, frames = denominators(batch, mesh)

    def forward():
        return vits_model.train_forward(
            nn.cast_floating(params_g, dtype), hp,
            cast_batch["phoneme_ids"], cast_batch["phoneme_lengths"],
            cast_batch["spec"], cast_batch["spec_lengths"],
            sid=cast_batch.get("sid"), deterministic=deterministic,
            generator=generator, token_count=tokens, **(noise or {}))

    if cfg.remat and torch.is_grad_enabled():
        out = _checkpointed_forward(forward, generator)
    else:
        out = forward()
    y_hat = out["audio"]  # [B, segment_samples], compute dtype
    y = vits_model.slice_audio_segments(
        batch["audio"], out["ids_slice"], hp.segment_size * hp.hop_length,
        hp.hop_length)

    # losses in f32 whatever the compute dtype
    mel_hat = _mel(y_hat.float(), hp)
    # the mel TARGET is the full utterance's spectrogram, frame-sliced
    # (lightning.py:216-228), not the mel of the sliced waveform
    mel_full = stft.spec_to_mel(batch["spec"].float(), hp.sample_rate,
                                hp.filter_length, hp.mel_channels)
    mel_real = vits_model._slice_segments(mel_full, out["ids_slice"],
                                          hp.segment_size)
    loss_mel = torch.mean(torch.abs(mel_real - mel_hat)) * cfg.c_mel
    loss_kl = losses.kl_loss(
        *(out[k].float() for k in ("z_p", "logs_q", "m_p", "logs_p",
                                   "y_mask")), count=frames) * cfg.c_kl
    # a SUM over the batch, as the reference (lightning.py:253)
    loss_dur = torch.sum(out["l_length"]).float()

    _, y_d_gs, fmap_rs, fmap_gs = disc.multi_period_discriminator(
        nn.cast_floating(params_d, dtype), y.to(dtype), y_hat)
    loss_fm = losses.feature_loss(nn.cast_floating(fmap_rs, torch.float32),
                                  nn.cast_floating(fmap_gs, torch.float32))
    loss_gen, _ = losses.generator_loss(
        nn.cast_floating(y_d_gs, torch.float32))

    total = loss_gen + loss_fm + loss_mel + loss_dur + loss_kl
    aux = {"loss_gen_all": total, "loss_mel": loss_mel, "loss_kl": loss_kl,
           "loss_dur": loss_dur, "loss_fm": loss_fm, "loss_gen": loss_gen,
           "y": y, "y_hat": y_hat}
    return total, aux


def discriminator_objective(params_d, y: Tensor, y_hat: Tensor,
                            dtype: torch.dtype = torch.float32) -> Tensor:
    """LSGAN discriminator loss on real and (detached) generated audio,
    computed in ``dtype``, the loss in float32."""
    y_d_rs, y_d_gs, _, _ = disc.multi_period_discriminator(
        nn.cast_floating(params_d, dtype), y.detach().to(dtype),
        y_hat.detach().to(dtype))
    loss_d, _, _ = losses.discriminator_loss(
        nn.cast_floating(y_d_rs, torch.float32),
        nn.cast_floating(y_d_gs, torch.float32))
    return loss_d


def _micro_grads(state: TrainState, batch: Dict[str, Tensor],
                 hp: VitsHParams, cfg: TrainConfig, eval_mode: bool,
                 generator: Optional[torch.Generator] = None,
                 noise: Optional[Dict[str, Tensor]] = None,
                 mesh: Optional["dp.Mesh"] = None):
    """(grads_g, grads_d, metrics) for one batch, no update; the grads are
    None in eval mode (dropout off, no graph). Under ``mesh`` they are
    this rank's, not yet averaged."""
    with torch.set_grad_enabled(not eval_mode):
        with observability.span("train.gen_forward"):
            total, aux = generator_objective(
                state.params_g, state.params_d, batch, hp, cfg,
                deterministic=eval_mode, generator=generator, noise=noise,
                mesh=mesh)
        grads_g = None
        if not eval_mode:
            with observability.span("train.gen_backward"):
                grads_g = torch.autograd.grad(total, leaves(state.params_g))
        with observability.span("train.disc"):
            loss_d = discriminator_objective(
                state.params_d, aux["y"], aux["y_hat"], compute_dtype(cfg))
            grads_d = None
            if not eval_mode:
                with observability.span("train.disc_backward"):
                    grads_d = torch.autograd.grad(loss_d,
                                                  leaves(state.params_d))
    metrics = {key: aux[key].detach() for key in METRICS
               if key != "loss_disc_all"}
    metrics["loss_disc_all"] = loss_d.detach()
    return grads_g, grads_d, metrics


def micro_generator(generator: Optional[torch.Generator], i: int
                    ) -> Optional[torch.Generator]:
    """The noise and dropout source of micro-batch ``i``: seeded from the
    step generator's seed and ``i``, so a pure function of the step, as
    the step generator is (``trainer.step_generator``). The JAX step folds
    ``i`` into the step's key (``fold_in(rng, i)``); the draws cannot be
    equal across the frameworks, the rule is the same."""
    if generator is None:
        return None
    return torch.Generator(device=generator.device).manual_seed(
        (generator.initial_seed() * 1_000_003 + i + 1) % (1 << 63))


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


def step_grads(state: TrainState, batch: Dict[str, Tensor],
               hp: VitsHParams, cfg: TrainConfig,
               generator: Optional[torch.Generator] = None,
               eval_mode: bool = False,
               noise: Optional[Dict[str, Tensor]] = None,
               mesh: Optional["dp.Mesh"] = None):
    """(grads_g, grads_d, metrics) of one step, no update: what
    :func:`train_step` applies (the grads are None in eval mode).

    ``cfg.grad_accum > 1`` splits the batch into that many micro-batches
    (micro-batch ``i`` draws from :func:`micro_generator`) and averages
    their gradients and metrics; a batch that does not divide raises, and
    so does injected ``noise``.

    ``mesh``: data parallelism. ``batch`` (and ``noise``) are this rank's
    rows of the global batch, laid out by ``parallel.shard_batch`` with
    the same ``grad_accum``; the draws are this rank's rows of one
    process's draws for the whole batch (``nn.RowWindow``), and the
    gradients and metrics are the means across ranks, the same bits on
    every rank.
    """
    accum = max(1, int(cfg.grad_accum)) if not eval_mode else 1
    b = batch["phoneme_ids"].shape[0]
    if b % accum:
        raise ValueError(
            f"batch size {b} is not divisible by grad_accum {accum}")
    if accum > 1 and noise is not None:
        raise ValueError("injected noise takes grad_accum 1")
    mb = b // accum
    grads_g = grads_d = metrics = None
    for i in range(accum):
        micro = batch if accum == 1 else {
            k: v[i * mb:(i + 1) * mb] for k, v in batch.items()}
        gen = generator if accum == 1 else micro_generator(generator, i)
        if mesh is not None and gen is not None:
            gen = nn.RowWindow(gen, mesh.rank * mb, mesh.size * mb)
        g_g, g_d, m = _micro_grads(state, micro, hp, cfg, eval_mode,
                                   generator=gen, noise=noise, mesh=mesh)
        if metrics is None:
            grads_g, grads_d, metrics = g_g, g_d, m
        else:
            grads_g = [a + c for a, c in zip(grads_g, g_g)]
            grads_d = [a + c for a, c in zip(grads_d, g_d)]
            metrics = {k: metrics[k] + m[k] for k in metrics}
    if accum > 1:
        scale = 1.0 / accum
        grads_g = [a * scale for a in grads_g]
        grads_d = [a * scale for a in grads_d]
        metrics = {k: v * scale for k, v in metrics.items()}
    if mesh is not None:
        keys = list(metrics)
        values = dp.all_mean(mesh, [torch.stack([metrics[k]
                                                 for k in keys])])[0]
        metrics = dict(zip(keys, values.unbind()))
        if not eval_mode:
            grads_g = dp.all_mean(mesh, grads_g)
            grads_d = dp.all_mean(mesh, grads_d)
    return grads_g, grads_d, metrics


def train_step(state: TrainState, batch: Dict[str, Tensor], hp: VitsHParams,
               cfg: TrainConfig, generator: Optional[torch.Generator] = None,
               eval_mode: bool = False,
               noise: Optional[Dict[str, Tensor]] = None,
               mesh: Optional["dp.Mesh"] = None
               ) -> Tuple[TrainState, Dict[str, Tensor]]:
    """One G+D update, in place on ``state``; returns (state, metrics).

    batch: phoneme_ids [B, T_x] int64, phoneme_lengths [B], spec
    [B, T_y, C], spec_lengths [B], audio [B, N] (N >= T_y * hop), sid [B]
    (optional), on the state's device (:func:`batch_to_device`).
    ``generator`` draws the noise and dropout masks. ``eval_mode=True``
    runs the losses with dropout off and leaves the state unchanged
    (validation, lightning.py:282-306). The metrics are 0-d tensors on the
    device (reading them waits for the step). ``grad_accum``, ``noise``
    and ``mesh`` as :func:`step_grads`; under ``mesh`` every rank applies
    the same averaged gradients, so the replicas stay equal.
    """
    # rows and padded frames from the shapes: the lengths would be a read
    # of the device
    spec = batch["spec"]
    with observability.span("train.step", rows=spec.shape[0],
                            frames=spec.shape[0] * spec.shape[1]):
        grads_g, grads_d, metrics = step_grads(state, batch, hp, cfg,
                                               generator, eval_mode, noise,
                                               mesh)
        if eval_mode:
            return state, metrics
        with observability.span("train.update"):
            _update(state.opt_g, leaves(state.params_g), grads_g, cfg,
                    state.step)
            _update(state.opt_d, leaves(state.params_d), grads_d, cfg,
                    state.step)
        state.step += 1
    return state, metrics
