"""Training CLI: VITS + GAN on one GPU with periodic checkpointing.

PyTorch port of ``phoonnx_tpu/train/trainer.py`` (reference
phoonnx_train/train.py + the Lightning module, vits/lightning.py):
quality presets, AdamW x2 with exponential decay, the G+D step (float32
or bf16 mixed precision, gradient accumulation, rematerialisation),
periodic checkpoints, validation loss, resume, single->multi-speaker warm
starts, the held-out test utterances' audio after each epoch and a
``torch.profiler`` trace of a few steps.

Usage:
    python -m phoonnx_tpu_torch.train.trainer --dataset-dir out/ \\
        --quality medium --batch-size 16 --max-epochs 1000

It runs on the GPU by default and raises without one; ``--device cpu`` is
the caller's explicit choice.

Data-parallel training (ROADMAP.md, port queue item 7; the JAX trainer's
mesh path, ``trainer.py:211-216, 271-479``), N processes a host, one GPU
each:

    python -m torch.distributed.run --nproc-per-node N \\
        -m phoonnx_tpu_torch.train.trainer --dataset-dir out/ \\
        --quality medium --batch-size 16

Each rank loads the same batches and keeps its rows of each
(``parallel/mesh.py``); the step averages the gradients across ranks, so
the run computes the single-process step on the global batch. Rank r
runs on ``cuda:LOCAL_RANK`` unless ``--device`` names one. The backend is
nccl on GPUs and gloo on the CPU; ranks that share one GPU need
``--backend gloo``. Rank 0 alone logs, writes the checkpoints, each
epoch's test audio and the ``--profile-dir`` trace. The MAS
implementation choice (``--mas-impl``), XLA layout choices
(``--auto-layouts``) and tensor-parallel meshes were TPU policy and have
no counterpart.

The training steps never launch kernels A, B or C (the training forward
runs their plain, differentiable versions); the test audio, which is
synthesis, does.
"""

import argparse
import json
import logging
import os
import time
import wave
from dataclasses import dataclass, field
from functools import partial
from pathlib import Path
from typing import List, Optional

import numpy as np
import torch

from phoonnx_tpu_torch.infer.engine import resolve_device
from phoonnx_tpu_torch.models.vits import model as vits_model
from phoonnx_tpu_torch.models.vits.model import VitsHParams
from phoonnx_tpu_torch.observability import (device_memory_stats,
                                              device_trace)
from phoonnx_tpu_torch.parallel import (all_mean, make_mesh, multihost,
                                        shard_batch, shard_train_state)
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
             seed: int = 0, mesh=None) -> float:
    """Mean COMBINED (generator + discriminator) loss over validation
    batches, no updates: the reference's validation_step logs
    loss_gen_all + loss_disc_all (lightning.py:282-306). Under ``mesh``
    each rank takes its rows and the losses are the global batch's, the
    same on every rank."""
    total, count = 0.0, 0
    for i, batch in enumerate(loader.epoch()):
        if i >= max_batches:
            break
        if mesh is not None:
            batch = shard_batch(mesh, batch)
        _, metrics = train_step(state, batch_to_device(batch, device), hp,
                                cfg, generator=step_generator(device, seed, i),
                                eval_mode=True, mesh=mesh)
        total += float(metrics["loss_gen_all"]) + float(
            metrics["loss_disc_all"])
        count += 1
    return total / max(count, 1)


def _detached(tree):
    if isinstance(tree, dict):
        return {k: _detached(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_detached(v) for v in tree]
    if isinstance(tree, torch.Tensor):
        return tree.detach()
    return tree


def write_test_audio(params_g, hp: VitsHParams, test_utts, out_dir
                     ) -> List[str]:
    """Synthesize the held-out test utterances with the current weights
    (reference validation_step, lightning.py:286-304) and write
    ``test_{i}.wav`` under ``out_dir``.

    ``model.infer`` under ``torch.no_grad()`` on the parameters' device
    (on the GPU through kernels A, B and C), with the reference's fixed
    scales (0.667/1.0/0.8), a fixed seed per utterance so successive
    epochs are comparable, and a budget of ``max(12 * len, segment_size)``
    frames; the audio is scaled to its peak (lightning.py:299-300).
    Failures are never fatal, as in JAX: each is logged and returned, one
    string per failed utterance, and nothing is retried elsewhere.
    """
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    errors: List[str] = []
    try:
        with torch.no_grad():
            params = vits_model.attach_fused_specs(_detached(params_g))
    except Exception as exc:
        LOG.exception("test-audio generation failed (continuing)")
        return [f"kernel specs: {exc!r}"]
    dev = params["enc_p"]["emb"]["weight"].device
    written = 0
    for idx, utt in enumerate(test_utts):
        try:
            ids = torch.as_tensor([utt.phoneme_ids], dtype=torch.long,
                                  device=dev)
            n_frames = max(len(utt.phoneme_ids) * 12, hp.segment_size)
            sid = (torch.as_tensor([utt.speaker_id], device=dev)
                   if utt.speaker_id is not None and hp.n_speakers > 1
                   else None)
            with torch.no_grad():
                audio, y_lengths, _ = vits_model.infer(
                    params, hp, ids,
                    torch.as_tensor([ids.shape[1]], dtype=torch.int32,
                                    device=dev),
                    max_frames=n_frames, noise_scale=0.667,
                    length_scale=1.0, noise_w=0.8, sid=sid,
                    generator=torch.Generator(device=dev).manual_seed(idx))
            n = int(y_lengths[0]) * hp.total_upsample
            wav = audio[0, :n].float().cpu().numpy()
            if wav.size == 0:
                # early-training weights can round every predicted
                # duration to zero frames — write a minimal silent file
                # rather than abort the whole epoch's test audio
                wav = np.zeros(hp.total_upsample, np.float32)
            # scale to make louder in [-1, 1] (lightning.py:299-300)
            wav = wav * (1.0 / max(0.01, float(np.abs(wav).max())))
            pcm = np.clip(wav * 32767.0, -32767.0, 32767.0).astype(np.int16)
            with wave.open(str(out_dir / f"test_{idx}.wav"), "wb") as f:
                f.setnchannels(1)
                f.setsampwidth(2)
                f.setframerate(hp.sample_rate)
                f.writeframes(pcm.tobytes())
            written += 1
        except Exception as exc:
            LOG.exception("test audio %d failed (continuing)", idx)
            errors.append(f"test_{idx}: {exc!r}")
    LOG.info("wrote %d test utterances to %s", written, out_dir)
    return errors


@dataclass
class TrainRun:
    """What :func:`run_training` returns: the final state, one record per
    step (epoch, step, host ms of the step, the losses), the validation
    losses per epoch, the last checkpoint written, the held-out test
    utterances (neither trained nor validated on), the test audio's
    directory per epoch and its failures (``"epoch N: test_i: error"``;
    a failure never stops the run)."""

    state: TrainState
    hp: VitsHParams
    steps: List[dict] = field(default_factory=list)
    val_losses: List[float] = field(default_factory=list)
    checkpoint: Optional[str] = None
    test_utterances: List[Utterance] = field(default_factory=list)
    test_audio_dirs: List[Path] = field(default_factory=list)
    test_audio_errors: List[str] = field(default_factory=list)


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
    remat: bool = False,
    compute_dtype: str = "float32",
    grad_accum: int = 1,
    profile_dir: Optional[str] = None,
    profile_steps: int = 5,
    disc_periods: tuple = (2, 3, 5, 7, 11),
    disc_channel_scale: int = 1,
    seed: int = 1234,
    resume_from_checkpoint: Optional[str] = None,
    resume_from_single_speaker: Optional[str] = None,
    log_every: int = 50,
    device: Optional[str] = None,
    backend: Optional[str] = None,
) -> TrainRun:
    """Train on ``dataset_dir`` (``config.json`` + ``dataset.jsonl`` with
    cached ``.npy`` audio and spectrograms). Each step ends by reading its
    six losses to the host (one synchronisation per step), which gives
    the per-step record and its time.

    ``resume_from_single_speaker``: an exported ``.onnx`` voice or a torch
    Lightning ``.ckpt`` whose generator warm-starts this model
    (``checkpoint.load_generator_warm_start``). ``profile_dir``: where a
    trace of ``profile_steps`` steps is written. After every epoch the
    held-out test utterances are synthesized under
    ``<dataset_dir>/test_audio/epoch_N/``.

    ``device``: None is the GPU (``cuda:LOCAL_RANK`` in a data-parallel
    launch); without one this raises. Under a launcher's environment
    (``parallel.multihost.initialize``) the run is data-parallel over its
    processes: ``backend`` None is nccl on a GPU, gloo on the CPU; ranks
    that share one GPU must name ``"gloo"``. A ``batch_size`` that does not
    split into the ranks' ``grad_accum`` micro-batches raises before the
    first step; rank 0 alone logs and writes checkpoints, test audio and
    the trace (another rank's run has no checkpoint and no test audio),
    and every rank returns once they are written."""
    if device is None and "LOCAL_RANK" in os.environ:
        device = f"cuda:{multihost.local_rank()}"
    dev = resolve_device(device)
    mesh = None
    if multihost.initialize(backend=backend or (
            "nccl" if dev.type == "cuda" else "gloo")):
        mesh = make_mesh(device=dev)
    ranks = mesh.size if mesh is not None else 1
    if batch_size % (ranks * max(1, grad_accum)):
        raise ValueError(
            f"batch size {batch_size} does not split into {ranks} rank(s) x "
            f"grad_accum {grad_accum} micro-batches of equal size")
    main_rank = mesh is None or mesh.rank == 0
    log = LOG.info if main_rank else LOG.debug
    dataset_path = Path(dataset_dir)
    with open(dataset_path / "config.json", encoding="utf-8") as f:
        config = json.load(f)
    hp = build_hparams(config, quality)

    utterances = load_dataset([dataset_path / "dataset.jsonl"],
                              max_phoneme_ids=max_phoneme_ids)
    train_utts, val_utts, test_utts = train_val_split(
        utterances, validation_split, num_test_examples, seed=seed)
    log("train=%d val=%d on %s, %d rank(s)", len(train_utts), len(val_utts),
        dev, ranks)

    make_loader = partial(
        BucketedLoader, batch_size=batch_size,
        segment_size_frames=hp.segment_size, hop_length=hp.hop_length,
        is_multispeaker=hp.n_speakers > 1, seed=seed,
        spec_channels=hp.spec_channels)
    train_loader = make_loader(train_utts)
    val_loader = make_loader(val_utts) if val_utts else None

    cfg = TrainConfig(learning_rate=learning_rate,
                      steps_per_epoch=max(len(train_loader), 1),
                      grad_clip=grad_clip, remat=remat,
                      compute_dtype=compute_dtype, grad_accum=grad_accum,
                      disc_periods=tuple(disc_periods),
                      disc_channel_scale=disc_channel_scale)
    state = init_train_state(hp, cfg, torch.Generator().manual_seed(seed),
                             device=dev)
    ckpt_dir = dataset_path / "checkpoints"
    if resume_from_checkpoint:
        state = ckpt.restore(resume_from_checkpoint, state)
        log("Resumed from %s at step %d", resume_from_checkpoint, state.step)
    elif resume_from_single_speaker:
        # Warm start: import generator weights, dropping speaker-conditioning
        # layers that do not exist in the single-speaker checkpoint
        # (phoonnx_train/train.py:131-144).
        ckpt.load_generator_warm_start(resume_from_single_speaker, hp,
                                       state.params_g)
        log("Warm-started generator from %s", resume_from_single_speaker)
    if mesh is not None:
        # every rank holds rank 0's parameters and moments (JAX
        # replicates the state over the mesh, trainer.py:297)
        shard_train_state(mesh, state)

    run = TrainRun(state=state, hp=hp, test_utterances=test_utts)
    if not main_rank:
        profile_dir = None
    profiling = None  # the open device_trace of profile_steps steps
    steps_this_run = 0  # the trace starts after two warm steps of this run
    # checkpoints are written at epoch boundaries, so a restored step
    # lands on one; epoch-indexed shuffles and step-indexed generators make
    # the continuation the uninterrupted run
    start_epoch = state.step // max(len(train_loader), 1)
    for epoch in range(start_epoch, max_epochs):
        epoch_start = time.perf_counter()
        for batch in train_loader.epoch(prefetch=2, epoch_index=epoch):
            if mesh is not None:
                batch = shard_batch(mesh, batch, grad_accum)
            if (profile_dir is not None and profiling is None
                    and steps_this_run >= 2):
                profiling = device_trace(profile_dir)
                profiling.__enter__()
                profile_end = steps_this_run + profile_steps
            t0 = time.perf_counter()
            gen = step_generator(dev, seed + 1, state.step)
            state, metrics = train_step(state, batch_to_device(batch, dev),
                                        hp, cfg, generator=gen, mesh=mesh)
            values = torch.stack([metrics[k] for k in METRICS]).tolist()
            record = {"epoch": epoch, "step": state.step,
                      "ms": (time.perf_counter() - t0) * 1e3,
                      **dict(zip(METRICS, values))}
            steps_this_run += 1
            if profiling is not None and steps_this_run >= profile_end:
                profiling.__exit__(None, None, None)
                profiling, profile_dir = None, None
            run.steps.append(record)
            if state.step % log_every == 0:
                log("epoch %d step %d loss_g=%.3f loss_d=%.3f mel=%.3f "
                    "kl=%.3f dur=%.3f", epoch, state.step,
                    record["loss_gen_all"], record["loss_disc_all"],
                    record["loss_mel"], record["loss_kl"], record["loss_dur"])
        # the step reads its losses to the host, so the clock read here
        # follows the epoch's device work
        log("epoch %d done in %.1fs", epoch, time.perf_counter() - epoch_start)
        if epoch == 0 and main_rank:
            memory = device_memory_stats()
            if memory:  # the peak after one epoch ~ the steady footprint
                LOG.info("device memory after first epoch: %s", memory)

        if val_loader is not None:
            val_loss = evaluate(state, val_loader, hp, cfg, dev, mesh=mesh)
            run.val_losses.append(val_loss)
            log("epoch %d val_loss=%.3f", epoch, val_loss)

        if test_utts and main_rank:
            # progress audio from the held-out test utterances after each
            # validation (the reference's validation_step generates these,
            # lightning.py:286-304); WAVs under <dataset>/test_audio/epoch_N/
            out = dataset_path / "test_audio" / f"epoch_{epoch}"
            run.test_audio_dirs.append(out)
            run.test_audio_errors += [
                f"epoch {epoch}: {err}"
                for err in write_test_audio(state.params_g, hp, test_utts,
                                            out)]

        if (epoch + 1) % checkpoint_epochs == 0 and main_rank:
            # the state is replicated: rank 0's copy is the global state
            run.checkpoint = ckpt.save(str(ckpt_dir), state, hp, config)
            log("saved checkpoint: %s", run.checkpoint)
    if profiling is not None:
        # the run ended before profile_steps completed: write the trace
        profiling.__exit__(None, None, None)
    if mesh is not None:
        # every rank returns once rank 0's last checkpoint is written, so
        # that a resume that follows reads a whole file
        all_mean(mesh, [torch.zeros(1, device=dev)])
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
    parser.add_argument("--remat", action="store_true",
                        help="Recompute generator activations in the "
                             "backward pass (saves device memory)")
    parser.add_argument("--compute-dtype", default="float32",
                        choices=["float32", "bfloat16"],
                        help="bfloat16: mixed-precision compute with f32 "
                             "master weights")
    parser.add_argument("--grad-accum", default=1, type=int,
                        help="Micro-batches per optimizer update: the "
                             "gradients of batch-size/N slices are averaged "
                             "before ONE update")
    parser.add_argument("--profile-dir", default=None,
                        help="Write a torch.profiler trace of a few steps "
                             "after two warm steps here")
    parser.add_argument("--profile-steps", default=5, type=int)
    parser.add_argument("--seed", default=1234, type=int)
    parser.add_argument("--resume-from-checkpoint", default=None)
    parser.add_argument("--resume-from-single-speaker-checkpoint",
                        dest="resume_from_single_speaker", default=None,
                        help="Warm-start the generator from an exported "
                             ".onnx voice or a torch Lightning .ckpt")
    parser.add_argument("--device", default=None,
                        help="torch device (default: the GPU, cuda:LOCAL_RANK "
                             "under torch.distributed.run); 'cpu' runs the "
                             "plain versions")
    parser.add_argument("--backend", default=None, choices=["nccl", "gloo"],
                        help="torch.distributed backend of a data-parallel "
                             "launch (default: nccl on GPUs, gloo on the "
                             "CPU; gloo for ranks that share one GPU)")
    parser.add_argument("--debug", action="store_true")
    args = vars(parser.parse_args(argv))
    debug = args.pop("debug")
    logging.basicConfig(level=logging.DEBUG if debug else logging.INFO)
    try:
        run_training(**args)
    finally:
        if torch.distributed.is_initialized():
            torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
