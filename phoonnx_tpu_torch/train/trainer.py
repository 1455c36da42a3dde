"""Training CLI: VITS + GAN on one GPU with periodic checkpointing.

PyTorch port of ``phoonnx_tpu/train/trainer.py`` (reference
phoonnx_train/train.py + the Lightning module, vits/lightning.py):
quality presets, AdamW x2 with exponential decay, the G+D step, periodic
checkpoints, validation loss and resume.

Usage:
    python -m phoonnx_tpu_torch.train.trainer --dataset-dir out/ \\
        --quality medium --batch-size 16 --max-epochs 1000

It runs on the GPU by default and raises without one; ``--device cpu`` is
the caller's explicit choice. Not ported yet (ROADMAP.md, port queue item
7): data-parallel training, warm starts from single-speaker ONNX or torch
checkpoints, the held-out test-utterance audio, device traces, bf16,
gradient accumulation and rematerialisation. Multi-host meshes and XLA
layout choices were TPU-only.
"""

import argparse
import json
import logging
import time
from dataclasses import dataclass, field
from functools import partial
from pathlib import Path
from typing import List, Optional

import torch

from phoonnx_tpu_torch.infer.engine import resolve_device
from phoonnx_tpu_torch.models.vits.model import VitsHParams
from phoonnx_tpu_torch.train import checkpoint as ckpt
from phoonnx_tpu_torch.train.dataset import (BucketedLoader, Utterance,
                                             load_dataset, train_val_split)
from phoonnx_tpu_torch.train.step import (METRICS, TrainConfig, TrainState,
                                          batch_to_device, init_train_state,
                                          train_step)

LOG = logging.getLogger("trainer")

QUALITIES = ("micro", "x-low", "medium", "medium-istft", "medium-mb-istft",
             "high")


def build_hparams(config: dict, quality: str) -> VitsHParams:
    """Model hyperparameters from a dataset config.json + quality preset."""
    num_speakers = config.get("num_speakers", 1)
    return VitsHParams.preset(
        quality,
        n_vocab=config["num_symbols"],
        sample_rate=config.get("audio", {}).get("sample_rate", 22050),
        n_speakers=num_speakers,
        # Lightning defaults gin to 512 for multi-speaker (lightning.py:81-83)
        gin_channels=512 if num_speakers > 1 else 0,
    )


def step_generator(device, seed: int, step: int) -> torch.Generator:
    """The noise and dropout source of one step: a pure function of the
    global step, so a resumed run draws what the uninterrupted run would
    have."""
    return torch.Generator(device=device).manual_seed(
        seed * 1_000_003 + step)


def evaluate(state: TrainState, loader: BucketedLoader, hp: VitsHParams,
             cfg: TrainConfig, device, max_batches: int = 8,
             seed: int = 0) -> float:
    """Mean COMBINED (generator + discriminator) loss over validation
    batches, no updates: the reference's validation_step logs
    loss_gen_all + loss_disc_all (lightning.py:282-306)."""
    total, count = 0.0, 0
    for i, batch in enumerate(loader.epoch()):
        if i >= max_batches:
            break
        _, metrics = train_step(state, batch_to_device(batch, device), hp,
                                cfg, generator=step_generator(device, seed, i),
                                eval_mode=True)
        total += float(metrics["loss_gen_all"]) + float(
            metrics["loss_disc_all"])
        count += 1
    return total / max(count, 1)


@dataclass
class TrainRun:
    """What :func:`run_training` returns: the final state, one record per
    step (epoch, step, host ms of the step, the losses), the validation
    losses per epoch, the last checkpoint written and the held-out test
    utterances (neither trained nor validated on)."""

    state: TrainState
    hp: VitsHParams
    steps: List[dict] = field(default_factory=list)
    val_losses: List[float] = field(default_factory=list)
    checkpoint: Optional[str] = None
    test_utterances: List[Utterance] = field(default_factory=list)


def run_training(
    dataset_dir: str,
    quality: str = "medium",
    batch_size: int = 16,
    max_epochs: int = 1000,
    checkpoint_epochs: int = 1,
    validation_split: float = 0.1,
    num_test_examples: int = 5,
    max_phoneme_ids: Optional[int] = None,
    learning_rate: float = 2e-4,
    grad_clip: Optional[float] = None,
    disc_periods: tuple = (2, 3, 5, 7, 11),
    disc_channel_scale: int = 1,
    seed: int = 1234,
    resume_from_checkpoint: Optional[str] = None,
    log_every: int = 50,
    device: Optional[str] = "cuda",
) -> TrainRun:
    """Train on ``dataset_dir`` (``config.json`` + ``dataset.jsonl`` with
    cached ``.npy`` audio and spectrograms). Each step ends by reading its
    six losses to the host (one synchronisation per step), which gives
    the per-step record and its time."""
    dev = resolve_device(device)
    dataset_path = Path(dataset_dir)
    with open(dataset_path / "config.json", encoding="utf-8") as f:
        config = json.load(f)
    hp = build_hparams(config, quality)

    utterances = load_dataset([dataset_path / "dataset.jsonl"],
                              max_phoneme_ids=max_phoneme_ids)
    train_utts, val_utts, test_utts = train_val_split(
        utterances, validation_split, num_test_examples, seed=seed)
    LOG.info("train=%d val=%d on %s", len(train_utts), len(val_utts), dev)

    make_loader = partial(
        BucketedLoader, batch_size=batch_size,
        segment_size_frames=hp.segment_size, hop_length=hp.hop_length,
        is_multispeaker=hp.n_speakers > 1, seed=seed,
        spec_channels=hp.spec_channels)
    train_loader = make_loader(train_utts)
    val_loader = make_loader(val_utts) if val_utts else None

    cfg = TrainConfig(learning_rate=learning_rate,
                      steps_per_epoch=max(len(train_loader), 1),
                      grad_clip=grad_clip, disc_periods=tuple(disc_periods),
                      disc_channel_scale=disc_channel_scale)
    state = init_train_state(hp, cfg, torch.Generator().manual_seed(seed),
                             device=dev)
    ckpt_dir = dataset_path / "checkpoints"
    if resume_from_checkpoint:
        state = ckpt.restore(resume_from_checkpoint, state)
        LOG.info("Resumed from %s at step %d", resume_from_checkpoint,
                 state.step)

    run = TrainRun(state=state, hp=hp, test_utterances=test_utts)
    # checkpoints are written at epoch boundaries, so a restored step
    # lands on one; epoch-indexed shuffles and step-indexed generators make
    # the continuation the uninterrupted run
    start_epoch = state.step // max(len(train_loader), 1)
    for epoch in range(start_epoch, max_epochs):
        epoch_start = time.perf_counter()
        for batch in train_loader.epoch(prefetch=2, epoch_index=epoch):
            t0 = time.perf_counter()
            gen = step_generator(dev, seed + 1, state.step)
            state, metrics = train_step(state, batch_to_device(batch, dev),
                                        hp, cfg, generator=gen)
            values = torch.stack([metrics[k] for k in METRICS]).tolist()
            record = {"epoch": epoch, "step": state.step,
                      "ms": (time.perf_counter() - t0) * 1e3,
                      **dict(zip(METRICS, values))}
            run.steps.append(record)
            if state.step % log_every == 0:
                LOG.info("epoch %d step %d loss_g=%.3f loss_d=%.3f mel=%.3f "
                         "kl=%.3f dur=%.3f", epoch, state.step,
                         record["loss_gen_all"], record["loss_disc_all"],
                         record["loss_mel"], record["loss_kl"],
                         record["loss_dur"])
        LOG.info("epoch %d done in %.1fs", epoch,
                 time.perf_counter() - epoch_start)

        if val_loader is not None:
            val_loss = evaluate(state, val_loader, hp, cfg, dev)
            run.val_losses.append(val_loss)
            LOG.info("epoch %d val_loss=%.3f", epoch, val_loss)

        if (epoch + 1) % checkpoint_epochs == 0:
            run.checkpoint = ckpt.save(str(ckpt_dir), state, hp, config)
            LOG.info("saved checkpoint: %s", run.checkpoint)
    return run


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(
        description="Train a VITS voice with phoonnx_tpu_torch.")
    parser.add_argument("--dataset-dir", required=True)
    parser.add_argument("--quality", default="medium", choices=QUALITIES)
    parser.add_argument("--batch-size", default=16, type=int)
    parser.add_argument("--max-epochs", default=1000, type=int)
    parser.add_argument("--checkpoint-epochs", default=1, type=int)
    parser.add_argument("--validation-split", default=0.1, type=float)
    parser.add_argument("--num-test-examples", default=5, type=int)
    parser.add_argument("--max-phoneme-ids", default=None, type=int)
    parser.add_argument("--learning-rate", default=2e-4, type=float)
    parser.add_argument("--grad-clip", default=None, type=float)
    parser.add_argument("--seed", default=1234, type=int)
    parser.add_argument("--resume-from-checkpoint", default=None)
    parser.add_argument("--device", default="cuda",
                        help="torch device; 'cpu' runs the plain versions")
    parser.add_argument("--debug", action="store_true")
    args = vars(parser.parse_args(argv))
    debug = args.pop("debug")
    logging.basicConfig(level=logging.DEBUG if debug else logging.INFO)
    run_training(**args)


if __name__ == "__main__":
    main()
