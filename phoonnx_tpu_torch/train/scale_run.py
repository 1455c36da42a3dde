"""The convergence run: a voice trained at scale, resumed mid-run, exported
and served.

PyTorch port of ``tools/train_scale_run.py`` (the JAX package's train-at-
scale run). It drives the training path end to end at a preset's full
width: a synthetic corpus -> ``run_preprocess`` on the run's device (the
preset's STFT) -> ``run_training`` for epochs ``0..resume_at-1`` (phase
A) -> a resume from phase A's last checkpoint to ``epochs`` (phase B)
-> ``run_export`` -> ``TTSVoice.load`` -> synthesis. The summary carries
every key of the JAX tool's (validation loss by epoch, epoch seconds,
the device-memory line, the loss curve, the export check) and the port's
own: the card, each phase's steps, step-time quartiles, the kernels'
launches by epoch and in the export check, and the exported voice in
bfloat16 against float32 (frame counts and log-durations of the held-out
and validation utterances).

Usage (on the GPU; these are the JAX run's settings):

    python -m phoonnx_tpu_torch.train.scale_run --workdir build/scale_run \\
        --utts 96 --epochs 20 --resume-at 10 --batch-size 16 \\
        --compute-dtype bfloat16 --grad-accum 2 [--summary-json out.json]

On the CPU, at a small size:

    python -m phoonnx_tpu_torch.train.scale_run --workdir /tmp/scale \\
        --device cpu --quality micro --utts 12 --clip-seconds 0.1 0.2 \\
        --epochs 2 --resume-at 1 --batch-size 2

The summary is printed as ``SCALE_RUN_SUMMARY {...}`` and written to
``--summary-json`` when given. A failed export, load or synthesis raises:
the run exits non-zero.
"""

import argparse
import json
import logging
import math
import re
import statistics
import subprocess
import time
import wave
from pathlib import Path
from typing import Callable, Dict, Optional, Sequence

import numpy as np
import torch

# the kernels whose launches the summary counts, by name: A, B, C and the
# engine's noise draws in float32 and bfloat16 (synthesis), D (the
# training steps)
KERNEL_MODULES = {"A": "phoonnx_tpu_torch.models.vits.fused_encoder",
                  "B": "phoonnx_tpu_torch.models.vits.fused_flow",
                  "C": "phoonnx_tpu_torch.models.vits.fused_stage",
                  "D": "phoonnx_tpu_torch.ops.mas",
                  "noise": "phoonnx_tpu_torch.ops.noise"}


def kernel_keys(dtype: torch.dtype = torch.float32) -> Dict[str, str]:
    """The kernels' ``cuda.LAUNCHES`` keys in their build for ``dtype`` (D
    has a float32 build only)."""
    from phoonnx_tpu_torch.cuda import launch_key

    return {name: launch_key(module, dtype)
            for name, module in KERNEL_MODULES.items()
            if dtype == torch.float32 or name != "D"}


def launch_counts(keys: Dict[str, str]) -> Dict[str, int]:
    from phoonnx_tpu_torch.cuda import LAUNCHES

    return {name: LAUNCHES[key] for name, key in keys.items()}


def _minus(after: Dict[str, int], before: Dict[str, int]) -> Dict[str, int]:
    return {name: after[name] - before[name] for name in after}


class _Capture(logging.Handler):
    """Collect the trainer's log lines for the summary (the JAX tool's
    expressions), and the kernels' launches between them: each epoch's
    steps end at its ``done`` line, its validation at its ``val_loss``
    line, its test audio at the ``wrote ... test utterances`` line."""

    def __init__(self, counts: Callable[[], Dict[str, int]] = dict):
        super().__init__()
        self.epoch_seconds = {}
        self.losses = {}   # step -> loss_g
        self.val = {}
        self.hbm = None
        self.checkpoints = []
        self.checkpoint_save_s = []
        self.counts = counts
        self.launches = {}  # epoch -> part -> kernel -> launches
        self.epoch = None
        self.mark()

    def mark(self) -> None:
        """Count launches from here (the start of a phase)."""
        self.last = self.counts()
        self.last_time = time.time()

    def _part(self, epoch: int, part: str) -> None:
        now = self.counts()
        self.launches.setdefault(epoch, {})[part] = _minus(now, self.last)
        self.last = now

    def emit(self, record):
        msg = record.getMessage()
        m = re.match(r"epoch (\d+) done in ([\d.]+)s", msg)
        if m:
            self.epoch = int(m.group(1))
            self.epoch_seconds[self.epoch] = float(m.group(2))
            self._part(self.epoch, "steps")
        m = re.match(r"epoch (\d+) step (\d+) loss_g=([\d.eE+-]+)", msg)
        if m:
            self.losses[int(m.group(2))] = float(m.group(3))
        m = re.match(r"epoch (\d+) val_loss=([\d.eE+-]+)", msg)
        if m:
            self.val[int(m.group(1))] = float(m.group(2))
            self._part(int(m.group(1)), "validation")
        if re.match(r"wrote \d+ test utterances", msg):
            self._part(self.epoch, "test_audio")
        if msg.startswith("device memory after first epoch"):
            self.hbm = msg.split(": ", 1)[-1]
        if msg.startswith("saved checkpoint"):
            self.checkpoints.append(msg.split(": ", 1)[-1])
            # the save is the work between the previous line and this one
            self.checkpoint_save_s.append(record.created - self.last_time)
        self.last_time = record.created


def build_corpus(root: Path, n_utts: int, sr: int = 22050,
                 seconds: Sequence[float] = (1.0, 3.0)) -> None:
    """Speech-shaped synthetic utterances: AM-modulated harmonic tones
    with per-utterance f0/duration so batches see realistic length
    variation (1.0-3.0 s at hop 256 -> 86-258 frames). The JAX tool's
    corpus: with its defaults the same bytes; ``seconds`` is the clip
    length range."""
    wav_dir = root / "wavs"
    wav_dir.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(0)
    words = ("the quick brown fox jumped over a lazy dog and ran far "
             "away to the green hills beyond town").split()
    lo, hi = seconds
    lines = []
    for i in range(n_utts):
        dur = lo + (hi - lo) * rng.random()
        t = np.arange(int(sr * dur)) / sr
        f0 = 120 + 80 * rng.random()
        env = 0.5 + 0.5 * np.sin(2 * math.pi * (2.5 + rng.random()) * t)
        audio = env * sum(
            a * np.sin(2 * math.pi * f0 * k * t + rng.random())
            for k, a in ((1, 0.5), (2, 0.25), (3, 0.12))
        )
        audio = (audio + 0.01 * rng.standard_normal(len(t))).astype(
            np.float32)
        pcm = (np.clip(audio, -1, 1) * 32767).astype(np.int16)
        with wave.open(str(wav_dir / f"utt{i}.wav"), "wb") as f:
            f.setnchannels(1)
            f.setsampwidth(2)
            f.setframerate(sr)
            f.writeframes(pcm.tobytes())
        n_words = 3 + int(rng.integers(0, 8))
        text = " ".join(rng.choice(words, n_words))
        lines.append(f"utt{i}|{text}")
    (root / "metadata.csv").write_text("\n".join(lines), encoding="utf-8")


def card_line(dev: torch.device) -> Optional[str]:
    """``nvidia-smi``'s name and power limit of ``dev`` (None on the CPU)."""
    if dev.type != "cuda":
        return None
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    out = subprocess.run(
        ["nvidia-smi", f"--id={index}", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip()


def quartiles(xs: Sequence[float]):
    """[q1, median, q3] of ``xs`` (None when empty)."""
    if not xs:
        return None
    if len(xs) == 1:
        return [round(xs[0], 3)] * 3
    return [round(v, 3) for v in statistics.quantiles(
        xs, n=4, method="inclusive")]


def dtype_check(model_path: Path, utterances, dev, seed: int = 0) -> dict:
    """The exported voice loaded in bfloat16 and in float32 on ``dev``:
    each utterance's frame count in both at ``seed`` (one request each),
    and the duration predictor's log-durations on the same noise (the
    engine's draw for a request of one at ``seed``), bf16 against
    float32 over the valid positions."""
    from phoonnx_tpu_torch import SynthesisConfig, TTSVoice
    from phoonnx_tpu_torch.models.vits import model as vits_model
    from phoonnx_tpu_torch.ops import noise

    voices = {dtype: TTSVoice.load(str(model_path), device=str(dev),
                                   dtype=dtype)
              for dtype in ("float32", "bfloat16")}
    hop = voices["float32"].engine.hp.total_upsample
    noise_w = voices["float32"].config.noise_w_scale
    rows, diffs = [], []
    for kind, utt in utterances:
        ids = list(utt.phoneme_ids)
        row = {"set": kind, "ids": len(ids)}
        logw = {}
        for dtype, voice in voices.items():
            engine = voice.engine
            row[f"frames_{dtype}"] = len(voice.phoneme_ids_to_audio(
                ids, SynthesisConfig(seed=seed))) // hop
            # the engine's duration noise for a request of one at seed
            dp_noise = noise.normal(seed, 1, len(ids), 2, noise.DURATION,
                                    engine.device, None, engine.dtype)
            with torch.inference_mode():
                logw[dtype] = vits_model.infer_log_durations(
                    engine.params, engine.hp,
                    torch.as_tensor([ids], device=engine.device),
                    torch.as_tensor([len(ids)], dtype=torch.int32,
                                    device=engine.device),
                    noise_w, dp_noise=dp_noise).cpu()
        diff = (logw["bfloat16"] - logw["float32"]).flatten()
        row["max_log_duration_err"] = float(diff.abs().max())
        row["mean_log_duration_err"] = float(diff.abs().mean())
        row["mean_signed_log_duration_err"] = float(diff.mean())
        diffs.append(diff)
        rows.append(row)
    rel = [abs(r["frames_bfloat16"] - r["frames_float32"])
           / max(r["frames_float32"], 1) for r in rows]
    diffs = torch.cat(diffs)
    return {
        "seed": seed, "noise_w": noise_w, "utterances": rows,
        "equal_frame_counts": sum(r["frames_bfloat16"] == r["frames_float32"]
                                  for r in rows),
        "max_rel_frame_diff": max(rel),
        "max_log_duration_err": float(diffs.abs().max()),
        "mean_log_duration_err": float(diffs.abs().mean()),
        # bf16 less float32: a bias moves every utterance's ceil()s one way
        "mean_signed_log_duration_err": float(diffs.mean()),
    }


def export_check(checkpoint, config_path, out_dir, quality: str,
                 dev) -> dict:
    """The run ends in a voice that loads and speaks: ``checkpoint``
    exported, loaded by ``TTSVoice.load`` on ``dev``, ids 1..23
    synthesized at seed 0 (the JAX tool's check). A failure raises."""
    from phoonnx_tpu_torch import SynthesisConfig, TTSVoice
    from phoonnx_tpu_torch.train.export import run_export

    model_path = run_export(checkpoint=str(checkpoint),
                            config_path=str(config_path),
                            output_dir=str(out_dir), quality=quality)
    voice = TTSVoice.load(str(model_path), device=str(dev))
    audio = voice.phoneme_ids_to_audio(
        list(range(1, 24)), SynthesisConfig(seed=0))
    rms = float(np.sqrt(np.mean(np.square(audio))))
    return {
        "exported_model": str(model_path),
        "synth_samples": int(len(audio)),
        "synth_rms": round(rms, 5),
        "audible": bool(rms > 1e-3 and np.isfinite(audio).all()),
    }


def run_scale(workdir, utts: int = 96, epochs: int = 12, resume_at: int = 6,
              batch_size: int = 16, quality: str = "medium",
              compute_dtype: str = "bfloat16", grad_accum: int = 2,
              checkpoint_epochs: int = 1, clip_seconds=(1.0, 3.0),
              device=None, **train_options) -> dict:
    """The convergence run (module docstring); returns its summary.

    ``checkpoint_epochs`` must divide ``resume_at`` and ``epochs``, so that
    phase B resumes where phase A ended and the export takes the last
    epoch's weights. ``train_options`` go to both ``run_training`` calls
    (e.g. a small discriminator for a CPU run). ``device`` None is the
    GPU, and raises without one."""
    from phoonnx_tpu_torch.infer.engine import resolve_device
    from phoonnx_tpu_torch.models.vits.model import VitsHParams
    from phoonnx_tpu_torch.observability import device_memory_stats
    from phoonnx_tpu_torch.train.dataset import load_dataset, train_val_split
    from phoonnx_tpu_torch.train.preprocess import run_preprocess
    from phoonnx_tpu_torch.train.trainer import run_training

    dev = resolve_device(device)
    if not 0 < resume_at < epochs:
        raise ValueError(f"resume_at {resume_at} is not inside 1..{epochs - 1}")
    if resume_at % checkpoint_epochs or epochs % checkpoint_epochs:
        raise ValueError(
            f"checkpoint_epochs {checkpoint_epochs} must divide resume_at "
            f"{resume_at} and epochs {epochs}")
    work = Path(workdir)
    corpus = work / "corpus"
    dataset = work / "dataset"
    hp = VitsHParams.preset(quality)

    if not (dataset / "dataset.jsonl").exists():
        print(f"building {utts}-utterance corpus ...", flush=True)
        build_corpus(corpus, utts, sr=hp.sample_rate, seconds=clip_seconds)
        run_preprocess(
            input_dir=str(corpus), output_dir=str(dataset),
            language="en", phoneme_type="graphemes", alphabet="unicode",
            sample_rate=hp.sample_rate, max_workers=4,
            single_speaker=True, cache_dir=str(work / "cache"),
            n_fft=hp.filter_length, hop_length=hp.hop_length,
            win_length=hp.win_length, device=str(dev),
        )

    keys = kernel_keys()
    cap = _Capture(lambda: launch_counts(keys))
    # the capture reads the trainer's INFO lines whatever the caller's
    # logging configuration
    trainer_log = logging.getLogger("trainer")
    level = trainer_log.level
    trainer_log.addHandler(cap)
    if trainer_log.getEffectiveLevel() > logging.INFO:
        trainer_log.setLevel(logging.INFO)
    common = dict(
        dataset_dir=str(dataset), quality=quality,
        batch_size=batch_size, checkpoint_epochs=checkpoint_epochs,
        validation_split=0.1, num_test_examples=2,
        compute_dtype=compute_dtype, grad_accum=grad_accum,
        log_every=1, seed=1234, device=str(dev), **train_options,
    )
    try:
        t0 = time.time()
        print(f"phase A: epochs 0..{resume_at - 1}", flush=True)
        cap.mark()
        run_a = run_training(max_epochs=resume_at, **common)
        print(f"phase B: resume from {run_a.checkpoint} -> epoch {epochs}",
              flush=True)
        run_a.state = None
        cap.mark()
        run_b = run_training(max_epochs=epochs,
                             resume_from_checkpoint=run_a.checkpoint,
                             **common)
        total_s = time.time() - t0
    finally:
        trainer_log.removeHandler(cap)
        trainer_log.setLevel(level)
    memory = device_memory_stats() if dev.type == "cuda" else {}
    run_b.state = None

    before = launch_counts(keys)
    exported = export_check(run_b.checkpoint, dataset / "config.json",
                            work / "exported", quality, dev)
    export_launches = _minus(launch_counts(keys), before)
    model_path = Path(exported["exported_model"])

    # the trained voice in bf16 against float32 on the held-out test and
    # the validation utterances (the trainer's split)
    _, val_utts, test_utts = train_val_split(
        load_dataset([dataset / "dataset.jsonl"]), 0.1, 2, seed=1234)
    keys_bf16 = kernel_keys(torch.bfloat16)
    before = launch_counts(keys), launch_counts(keys_bf16)
    dtypes = dtype_check(model_path, [("test", u) for u in test_utts]
                         + [("validation", u) for u in val_utts], dev)
    dtypes["launches"] = {
        "float32": _minus(launch_counts(keys), before[0]),
        "bfloat16": _minus(launch_counts(keys_bf16), before[1])}

    steps = sorted(cap.losses)
    epoch_ids = sorted(cap.epoch_seconds)
    # warm epochs exclude each phase's first epoch (the kernels' builds,
    # cuDNN's autotuning); phase B's first epoch index is resume_at
    warm_epochs = [e for e in epoch_ids if e not in (0, resume_at)]
    warm = [cap.epoch_seconds[e] for e in warm_epochs]
    first_loss = cap.losses[steps[0]]
    tail = [cap.losses[s] for s in steps[-5:]]
    records = run_a.steps + run_b.steps
    warm_ms = [r["ms"] for r in records if r["epoch"] in warm_epochs]
    summary = {
        "preset": quality,
        "batch_size": batch_size,
        "compute_dtype": compute_dtype,
        "grad_accum": grad_accum,
        "utterances": utts,
        "epochs": len(epoch_ids),
        "resumed_at_epoch": resume_at,
        "loss_g_first": round(first_loss, 2),
        "loss_g_last5_mean": round(float(np.mean(tail)), 2),
        "loss_decreasing": bool(np.mean(tail) < first_loss),
        "epoch_seconds": {e: round(cap.epoch_seconds[e], 2)
                          for e in epoch_ids},
        "warm_epoch_s_mean": round(float(np.mean(warm)), 2) if warm else None,
        "warm_epoch_s_max_over_min": round(
            float(max(warm) / min(warm)), 3) if warm else None,
        "val_loss": {e: round(v, 3) for e, v in sorted(cap.val.items())},
        "hbm": cap.hbm,
        "checkpoints_written": len(cap.checkpoints),
        "total_wall_s": round(total_s, 1),
        # the machine-readable loss CURVE (<=200 points, step->loss_g)
        "loss_curve": {
            str(s): round(cap.losses[s], 2)
            for s in steps[::max(1, len(steps) // 200)]},
        "export_check": exported,
        # the port's own keys
        "device": str(dev),
        "card": card_line(dev),
        "torch": torch.__version__,
        "checkpoint_epochs": checkpoint_epochs,
        "clip_seconds": list(clip_seconds),
        "phase_steps": {
            "A": [run_a.steps[0]["step"], run_a.steps[-1]["step"]],
            "B": [run_b.steps[0]["step"], run_b.steps[-1]["step"]]},
        "steps_per_epoch": len(run_b.steps) // (epochs - resume_at),
        "step_ms_quartiles_warm": quartiles(warm_ms),
        "step_ms_first_of_phase": [run_a.steps[0]["ms"],
                                   run_b.steps[0]["ms"]],
        "warm_steps_per_s": (round(len(warm_ms) / sum(warm), 3)
                             if warm else None),
        "peak_allocated_mib": (max(d["peak_bytes_in_use_mb"]
                                   for d in memory.values())
                               if memory else None),
        "checkpoint_mib": round(
            Path(run_b.checkpoint).stat().st_size / 2 ** 20, 1),
        "checkpoint_save_s": [round(s, 3) for s in cap.checkpoint_save_s],
        "launches_by_epoch": {e: cap.launches[e] for e in sorted(
            cap.launches)},
        "export_check_launches": export_launches,
        "test_audio_errors": run_a.test_audio_errors
        + run_b.test_audio_errors,
        # under the workdir
        "checkpoints": {
            "A": str(Path(run_a.checkpoint).relative_to(work.absolute())),
            "B": str(Path(run_b.checkpoint).relative_to(work.absolute()))},
        "bf16_vs_float32": dtypes,
    }
    return summary


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workdir", required=True)
    ap.add_argument("--utts", type=int, default=96)
    ap.add_argument("--epochs", type=int, default=12)
    ap.add_argument("--resume-at", type=int, default=6)
    ap.add_argument("--batch-size", type=int, default=16)
    ap.add_argument("--quality", default="medium")
    ap.add_argument("--compute-dtype", default="bfloat16")
    ap.add_argument("--grad-accum", type=int, default=2)
    ap.add_argument("--checkpoint-epochs", type=int, default=1,
                    help="save every N epochs; N divides --resume-at and "
                    "--epochs")
    ap.add_argument("--clip-seconds", type=float, nargs=2,
                    default=(1.0, 3.0), metavar=("MIN", "MAX"),
                    help="the corpus's clip length range")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the GPU); 'cpu' runs the "
                    "plain versions")
    ap.add_argument("--summary-json", default=None,
                    help="also write the summary to this path")
    args = ap.parse_args(argv)

    logging.basicConfig(level=logging.INFO)
    summary = run_scale(
        args.workdir, utts=args.utts, epochs=args.epochs,
        resume_at=args.resume_at, batch_size=args.batch_size,
        quality=args.quality, compute_dtype=args.compute_dtype,
        grad_accum=args.grad_accum, checkpoint_epochs=args.checkpoint_epochs,
        clip_seconds=tuple(args.clip_seconds), device=args.device)
    print("SCALE_RUN_SUMMARY " + json.dumps(summary), flush=True)
    if args.summary_json:
        Path(args.summary_json).write_text(json.dumps(summary, indent=1),
                                           encoding="utf-8")


if __name__ == "__main__":
    main()
