"""The port's convergence run (``train/scale_run.py``) on the CPU.

(a) Its corpus is the JAX tool's (``tools/train_scale_run.py``), byte for
byte, with the JAX defaults. (b) A run resumed from its mid-run checkpoint
is the uninterrupted run: the same per-step losses, validation losses and
parameters, in float32 and in bf16 with ``grad_accum`` 2. (c) ``run_scale``
runs end to end at ``micro``; its summary holds every key of the JAX run's
``TRAINLOSS_r05.json``. (d) The trainer logs the device-memory line once,
after epoch 0, when the device reports memory, and never on the CPU.
"""

import importlib.util
import json
import logging
import math
import shutil
from pathlib import Path

import pytest
import torch

import chip_smoke
from phoonnx_tpu_torch.models.vits.model import VitsHParams
from phoonnx_tpu_torch.train import scale_run, step, trainer

from tests.test_torch_train_forward import one_torch_thread  # noqa: F401

ROOT = Path(__file__).resolve().parent.parent

KW = dict(quality="micro", batch_size=4, validation_split=0.2,
          num_test_examples=2, disc_periods=(2,), disc_channel_scale=4,
          log_every=1, seed=3, device="cpu")
SMALL = dict(disc_periods=(2,), disc_channel_scale=4)


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    # 11 utterances: 2 held out for tests, 2 validation, 7 train (2 steps)
    hp = VitsHParams.preset("micro", n_vocab=40)
    return chip_smoke.write_dataset(torch, tmp_path_factory.mktemp("data"),
                                    hp, 11, seed=1, seconds=(0.05, 0.12))


def copy_of(dataset: Path, tmp_path: Path, name: str) -> Path:
    """A dataset dir of its own (its checkpoints and test audio), reading
    the same cached audio and spectrograms."""
    out = tmp_path / name
    out.mkdir()
    for f in ("config.json", "dataset.jsonl"):
        shutil.copy(dataset / f, out / f)
    return out


def jax_tool():
    spec = importlib.util.spec_from_file_location(
        "train_scale_run", ROOT / "tools" / "train_scale_run.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_corpus_is_the_jax_tools(tmp_path):
    jax_tool().build_corpus(tmp_path / "jax", 4)
    scale_run.build_corpus(tmp_path / "port", 4)
    files = sorted(p.relative_to(tmp_path / "jax")
                   for p in (tmp_path / "jax").rglob("*") if p.is_file())
    assert [str(f) for f in files] == [
        "metadata.csv", "wavs/utt0.wav", "wavs/utt1.wav", "wavs/utt2.wav",
        "wavs/utt3.wav"]
    for f in files:
        assert (tmp_path / "port" / f).read_bytes() == (
            tmp_path / "jax" / f).read_bytes(), f
    ours = sorted(p.relative_to(tmp_path / "port")
                  for p in (tmp_path / "port").rglob("*") if p.is_file())
    assert ours == files


@pytest.mark.parametrize("options", [
    {}, dict(compute_dtype="bfloat16", grad_accum=2)],
    ids=["float32", "bf16_grad_accum2"])
def test_resume_is_the_uninterrupted_run(dataset, tmp_path, options):
    whole = trainer.run_training(
        str(copy_of(dataset, tmp_path, "whole")), max_epochs=2,
        **KW, **options)
    split = copy_of(dataset, tmp_path, "split")
    first = trainer.run_training(str(split), max_epochs=1, **KW, **options)
    second = trainer.run_training(
        str(split), max_epochs=2, resume_from_checkpoint=first.checkpoint,
        **KW, **options)

    assert [r["step"] for r in whole.steps] == [1, 2, 3, 4]
    resumed = first.steps + second.steps
    assert [r["step"] for r in resumed] == [1, 2, 3, 4]
    for a, b in zip(whole.steps, resumed):
        assert all(math.isfinite(a[k]) for k in step.METRICS), a
        assert {k: a[k] for k in step.METRICS} == {
            k: b[k] for k in step.METRICS}, a["step"]
    assert whole.val_losses == first.val_losses + second.val_losses
    assert len(whole.val_losses) == 2
    a, b = whole.state, second.state
    assert a.step == b.step == 4
    for tree_a, tree_b, opt_a, opt_b in ((a.params_g, b.params_g, a.opt_g,
                                          b.opt_g),
                                         (a.params_d, b.params_d, a.opt_d,
                                          b.opt_d)):
        leaves_a, leaves_b = step.leaves(tree_a), step.leaves(tree_b)
        assert len(leaves_a) == len(leaves_b) > 0
        for x, y in zip(leaves_a, leaves_b):
            assert torch.equal(x, y)
            for moment in ("exp_avg", "exp_avg_sq"):
                assert torch.equal(opt_a.state[x][moment],
                                   opt_b.state[y][moment])


def test_run_scale_end_to_end_on_the_cpu(tmp_path):
    summary = scale_run.run_scale(
        tmp_path / "work", utts=12, epochs=2, resume_at=1, batch_size=4,
        quality="micro", clip_seconds=(0.1, 0.2), device="cpu",
        **SMALL)
    jax_keys = json.loads((ROOT / "TRAINLOSS_r05.json").read_text())
    assert set(jax_keys) <= set(summary)
    # the summary is the JSON the tool writes
    summary = json.loads(json.dumps(summary))
    assert summary["epochs"] == 2 and summary["resumed_at_epoch"] == 1
    assert sorted(summary["val_loss"]) == ["0", "1"]
    assert all(math.isfinite(v) for v in summary["val_loss"].values())
    assert sorted(summary["epoch_seconds"]) == ["0", "1"]
    # no warm epoch: each phase's first is left out
    assert summary["warm_epoch_s_mean"] is None
    # 12 utterances: 2 held out, 1 validation, 9 train -> 3 steps an epoch
    assert summary["phase_steps"] == {"A": [1, 3], "B": [4, 6]}
    assert sorted(summary["loss_curve"], key=int) == [
        str(s) for s in range(1, 7)]
    assert summary["checkpoints_written"] == 2
    assert summary["checkpoints"] == {"A": "dataset/checkpoints/step_3.npz",
                                      "B": "dataset/checkpoints/step_6.npz"}
    for phase in "AB":
        assert (tmp_path / "work" / summary["checkpoints"][phase]).exists()
    export = summary["export_check"]
    assert Path(export["exported_model"]).exists()
    assert export["synth_samples"] > 0
    assert math.isfinite(export["synth_rms"]) and export["audible"]
    # the CPU reports no device memory, and launches no kernel
    assert summary["hbm"] is None and summary["card"] is None
    assert set(summary["launches_by_epoch"]) == {"0", "1"}
    for parts in summary["launches_by_epoch"].values():
        assert set(parts) == {"steps", "validation", "test_audio"}
        assert not any(n for p in parts.values() for n in p.values())
    assert summary["test_audio_errors"] == []
    dtypes = summary["bf16_vs_float32"]
    assert [r["set"] for r in dtypes["utterances"]] == [
        "test", "test", "validation"]
    for row in dtypes["utterances"]:
        assert row["frames_float32"] > 0 and row["frames_bfloat16"] > 0
        assert row["max_log_duration_err"] >= abs(
            row["mean_signed_log_duration_err"])
    assert 0 <= dtypes["max_rel_frame_diff"] < 1


def test_export_check_raises(tmp_path):
    """A failed export is an error of the run, not a field of its
    summary."""
    (tmp_path / "config.json").write_text(json.dumps({"num_symbols": 32}))
    with pytest.raises(FileNotFoundError):
        scale_run.export_check(tmp_path / "step_1.npz",
                               tmp_path / "config.json", tmp_path / "out",
                               "micro", torch.device("cpu"))


def test_run_scale_refuses_a_bad_plan(tmp_path, monkeypatch):
    with pytest.raises(ValueError, match="divide"):
        scale_run.run_scale(tmp_path, epochs=4, resume_at=3,
                            checkpoint_epochs=2, device="cpu")
    with pytest.raises(ValueError, match="resume_at"):
        scale_run.run_scale(tmp_path, epochs=4, resume_at=4, device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        scale_run.main(["--workdir", str(tmp_path)])
    assert not any(tmp_path.iterdir())


def test_capture_reads_the_trainer_lines():
    """The JAX tool's expressions over the trainer's lines, and the
    launches between them attributed to each epoch's parts."""
    counts = {"D": 0, "A": 0}
    cap = scale_run._Capture(lambda: dict(counts))
    log = logging.getLogger("test_capture")
    log.propagate = False
    log.setLevel(logging.INFO)
    log.addHandler(cap)
    try:
        counts["D"] = 3
        log.info("epoch %d step %d loss_g=%.3f loss_d=%.3f", 0, 1, 12.5, 3.0)
        log.info("epoch %d done in %.1fs", 0, 4.0)
        log.info("device memory after first epoch: %s", {"0": {"a": 1}})
        counts["D"] = 4
        log.info("epoch %d val_loss=%.3f", 0, 99.5)
        counts["A"] = 2
        log.info("wrote %d test utterances to %s", 2, "x")
        log.info("saved checkpoint: %s", "/c/step_1.npz")
    finally:
        log.removeHandler(cap)
    assert cap.epoch_seconds == {0: 4.0}
    assert cap.losses == {1: 12.5} and cap.val == {0: 99.5}
    assert cap.hbm == "{'0': {'a': 1}}"
    assert cap.checkpoints == ["/c/step_1.npz"]
    assert len(cap.checkpoint_save_s) == 1 and cap.checkpoint_save_s[0] >= 0
    assert cap.launches == {0: {"steps": {"D": 3, "A": 0},
                                "validation": {"D": 1, "A": 0},
                                "test_audio": {"D": 0, "A": 2}}}


def memory_lines(records):
    return [i for i, r in enumerate(records)
            if r.getMessage().startswith("device memory after first epoch")]


def test_trainer_logs_device_memory_after_epoch_0(dataset, tmp_path,
                                                  monkeypatch, caplog):
    stats = {"0": {"bytes_in_use_mb": 1.0, "peak_bytes_in_use_mb": 2.0,
                   "bytes_limit_mb": 3.0}}
    monkeypatch.setattr(trainer, "device_memory_stats", lambda: stats)
    with caplog.at_level(logging.INFO, logger="trainer"):
        trainer.run_training(str(copy_of(dataset, tmp_path, "mem")),
                             max_epochs=2, **KW)
    records = caplog.records
    lines = memory_lines(records)
    assert len(lines) == 1
    assert records[lines[0]].getMessage() == (
        f"device memory after first epoch: {stats}")
    done = [r.getMessage() for r in records[:lines[0]]
            if " done in " in r.getMessage()]
    assert len(done) == 1 and done[0].startswith("epoch 0 done in")
    # the JAX tool's capture reads the line
    cap = scale_run._Capture()
    cap.emit(records[lines[0]])
    assert cap.hbm == str(stats)


def test_trainer_logs_no_device_memory_on_the_cpu(dataset, tmp_path,
                                                  caplog):
    with caplog.at_level(logging.INFO, logger="trainer"):
        trainer.run_training(str(copy_of(dataset, tmp_path, "cpu")),
                             max_epochs=1, **KW)
    assert any(" done in " in r.getMessage() for r in caplog.records)
    assert memory_lines(caplog.records) == []
