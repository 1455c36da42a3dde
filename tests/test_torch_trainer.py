"""The port's trainer end to end on the CPU, on a tiny synthetic dataset.

``run_training(device="cpu")`` at the ``micro`` preset, on a dataset dir
written by ``chip_smoke.write_dataset`` (the writer the card run uses, at
shorter lengths): two steps of one epoch write a checkpoint, log finite
losses and move the parameters. The split holds out the JAX trainer's 5
test utterances first, and each epoch writes their audio: one WAV each at
the voice's rate, scaled to its peak (a zero-frame utterance writes a
silent file). A bf16, grad-accum 2 run takes its steps and writes a
trace of one. The CLI takes the new options and still refuses the TPU
policy ones. Without a GPU the default device raises.
"""

import logging
import math
import wave

import numpy as np
import pytest
import torch

import chip_smoke
from phoonnx_tpu.train import dataset as jax_dataset
from phoonnx_tpu_torch.models.vits.model import VitsHParams
from phoonnx_tpu_torch.train import checkpoint, dataset as port_dataset
from phoonnx_tpu_torch.train import step, trainer

from tests.test_torch_train_forward import one_torch_thread  # noqa: F401

KW = dict(quality="micro", batch_size=2, max_epochs=1, validation_split=0.2,
          disc_periods=(2,), disc_channel_scale=4, log_every=1, seed=3,
          device="cpu")


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    # 11 utterances: 5 held out for tests, 2 validation, 4 train (2 steps)
    hp = VitsHParams.preset("micro", n_vocab=40)
    return chip_smoke.write_dataset(torch, tmp_path_factory.mktemp("data"),
                                    hp, 11, seed=1, seconds=(0.05, 0.12))


def test_run_training_on_cpu(dataset, caplog):
    with caplog.at_level(logging.INFO, logger="trainer"):
        run = trainer.run_training(str(dataset), **KW)
    assert [r["step"] for r in run.steps] == [1, 2]
    for record in run.steps:
        assert all(math.isfinite(record[k]) for k in step.METRICS), record
    assert any("loss_g=" in r.getMessage() for r in caplog.records)
    assert len(run.val_losses) == 1 and math.isfinite(run.val_losses[0])

    # one WAV per held-out utterance, at the voice's rate, peak-normalised
    assert run.test_audio_errors == []
    assert run.test_audio_dirs == [dataset / "test_audio" / "epoch_0"]
    for i, utt in enumerate(run.test_utterances):
        pcm, rate = read_wav(run.test_audio_dirs[0] / f"test_{i}.wav")
        assert rate == run.hp.sample_rate
        frames = max(len(utt.phoneme_ids) * 12, run.hp.segment_size)
        assert 0 < len(pcm) <= frames * run.hp.total_upsample
        assert len(pcm) % run.hp.total_upsample == 0
        # the peak scales to 1 within a float32 step, truncated to int16
        assert np.abs(pcm).max() >= 32766

    # the parameters moved from the seed's initialisation
    cfg = step.TrainConfig(disc_periods=(2,), disc_channel_scale=4)
    init = step.init_train_state(run.hp, cfg, torch.Generator().manual_seed(3))
    now = step.leaves(run.state.params_g) + step.leaves(run.state.params_d)
    before = step.leaves(init.params_g) + step.leaves(init.params_d)
    moved = sum(not torch.equal(a, b) for a, b in zip(now, before))
    assert moved > len(now) // 2, (moved, len(now))

    # the checkpoint holds the final state
    assert run.checkpoint.endswith("step_2.npz")
    assert checkpoint.latest_checkpoint(
        str(dataset / "checkpoints")) == run.checkpoint
    fresh = step.init_train_state(run.hp, cfg)
    checkpoint.restore(run.checkpoint, fresh)
    assert fresh.step == 2
    for a, b in zip(now, step.leaves(fresh.params_g)
                    + step.leaves(fresh.params_d)):
        assert torch.equal(a, b)


def test_split_holds_out_the_jax_test_utterances(dataset, monkeypatch):
    """run_training's split is train_val_split(..., 5, seed), the JAX
    trainer's default, and equals the JAX package's split of the same
    list."""
    seen = []

    def spy(*args, **kwargs):
        seen.append((args, kwargs))
        return port_dataset.train_val_split(*args, **kwargs)

    monkeypatch.setattr(trainer, "train_val_split", spy)
    run = trainer.run_training(str(dataset), **dict(KW, max_epochs=0))
    utts = port_dataset.load_dataset([dataset / "dataset.jsonl"])
    port = port_dataset.train_val_split(utts, 0.2, 5, seed=KW["seed"])
    jax = jax_dataset.train_val_split(utts, 0.2, 5, seed=KW["seed"])
    assert len(seen) == 1 and seen[0][0][2] == 5
    assert [len(part) for part in port] == [4, 2, 5]
    for ours, theirs in zip(port, jax):
        assert [u.audio_norm_path for u in ours] == [
            u.audio_norm_path for u in theirs]
    assert [u.audio_norm_path for u in run.test_utterances] == [
        u.audio_norm_path for u in port[2]]
    trainer.main(["--dataset-dir", str(dataset), "--quality", "micro",
                  "--max-epochs", "0", "--device", "cpu",
                  "--num-test-examples", "3"])
    assert seen[-1][0][2] == 3


def test_resume_continues_from_the_checkpoint(dataset):
    first = trainer.run_training(str(dataset), **KW)
    resumed = trainer.run_training(
        str(dataset), **dict(KW, max_epochs=2),
        resume_from_checkpoint=first.checkpoint)
    assert [r["step"] for r in resumed.steps] == [3, 4]
    assert resumed.checkpoint.endswith("step_4.npz")


def test_default_device_needs_a_gpu(dataset, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    kw = {k: v for k, v in KW.items() if k != "device"}
    with pytest.raises(RuntimeError, match="device='cpu'"):
        trainer.run_training(str(dataset), **kw)
    with pytest.raises(RuntimeError):
        trainer.main(["--dataset-dir", str(dataset), "--quality", "micro"])


def read_wav(path):
    with wave.open(str(path), "rb") as f:
        assert f.getnchannels() == 1 and f.getsampwidth() == 2
        return (np.frombuffer(f.readframes(f.getnframes()), np.int16),
                f.getframerate())


def test_zero_frames_write_silence(dataset, tmp_path, monkeypatch):
    """Early weights can round every duration to zero frames: the test
    audio is then a silent file of ``total_upsample`` samples; a failing
    utterance is recorded and the others are still written."""
    hp = VitsHParams.preset("micro", n_vocab=40)
    params = step.init_train_state(hp, step.TrainConfig(
        disc_periods=(2,), disc_channel_scale=4)).params_g
    utts = port_dataset.load_dataset([dataset / "dataset.jsonl"])[:3]
    calls = []

    def infer(params, hp, ids, lengths, max_frames, **kw):
        calls.append(kw["generator"].initial_seed())
        if len(calls) == 2:
            raise RuntimeError("no audio")
        return (torch.ones(1, max_frames * hp.total_upsample),
                torch.zeros(1, dtype=torch.int32), None)

    monkeypatch.setattr(trainer.vits_model, "infer", infer)
    errors = trainer.write_test_audio(params, hp, utts, tmp_path)
    assert calls == [0, 1, 2]  # a fixed seed per utterance
    assert len(errors) == 1 and "test_1" in errors[0]
    for i in (0, 2):
        pcm, _ = read_wav(tmp_path / f"test_{i}.wav")
        assert len(pcm) == hp.total_upsample and not pcm.any()
    assert not (tmp_path / "test_1.wav").exists()


def test_mixed_precision_accumulated_run(dataset, tmp_path):
    """bf16 + grad_accum 2 through the trainer: finite losses, float32
    masters, test audio, and a trace of the third step. (remat through
    the trainer runs in the card tests and ``chip_smoke.py``; its
    gradients are held in ``tests/test_torch_train_options.py``.)"""
    trace = tmp_path / "trace"
    run = trainer.run_training(
        str(dataset), **dict(KW, max_epochs=2), compute_dtype="bfloat16",
        grad_accum=2, profile_dir=str(trace), profile_steps=1)
    assert [r["step"] for r in run.steps] == [1, 2, 3, 4]
    for record in run.steps:
        assert all(math.isfinite(record[k]) for k in step.METRICS), record
    assert run.state.params_g["enc_p"]["emb"]["weight"].dtype == torch.float32
    assert run.test_audio_errors == [] and len(run.test_audio_dirs) == 2
    assert len(list((dataset / "test_audio" / "epoch_1").glob("*.wav"))) == 5
    traces = list(trace.glob("*.json"))
    assert len(traces) == 1 and traces[0].stat().st_size > 0


def test_cli_takes_only_ported_options(dataset, monkeypatch):
    """The port's CLI takes ``--remat``, ``--compute-dtype``,
    ``--grad-accum``, ``--profile-dir`` / ``--profile-steps`` and the
    single-speaker warm start, and refuses ``--mas-impl`` and
    ``--auto-layouts``, which were TPU policy."""
    trainer.main(["--dataset-dir", str(dataset), "--quality", "micro",
                  "--max-epochs", "0", "--device", "cpu"])
    seen = []
    monkeypatch.setattr(trainer, "run_training",
                        lambda **kw: seen.append(kw))
    trainer.main(["--dataset-dir", str(dataset), "--remat",
                  "--compute-dtype", "bfloat16", "--grad-accum", "2",
                  "--profile-dir", "x", "--profile-steps", "3",
                  "--resume-from-single-speaker-checkpoint", "v.onnx"])
    assert {k: seen[0][k] for k in (
        "remat", "compute_dtype", "grad_accum", "profile_dir",
        "profile_steps", "resume_from_single_speaker")} == {
        "remat": True, "compute_dtype": "bfloat16", "grad_accum": 2,
        "profile_dir": "x", "profile_steps": 3,
        "resume_from_single_speaker": "v.onnx"}
    for option in ("--mas-impl=scan", "--auto-layouts", "--no-auto-layouts",
                   "--compute-dtype=float16"):
        with pytest.raises(SystemExit):
            trainer.main(["--dataset-dir", str(dataset), option])
