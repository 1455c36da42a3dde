"""The port's training pipeline end to end on the CPU, with no JAX.

preprocess -> one micro training step -> checkpoint -> export (float32
and int8) -> ``TTSVoice.load`` -> synthesize: the port's counterpart of
``tests/test_train_pipeline.py:85``, on a corpus of four 16 kHz tone WAVs
and one 22050 Hz file (graphemes, one worker, ``device="cpu"``). Each
stage's parity with the JAX package is held in its own file
(``test_torch_preprocess.py``, ``test_torch_train_*.py``,
``test_torch_export.py``); this one shows that the stages fit together.
"""

import json
import math
from pathlib import Path

import numpy as np
import pytest
import torch

from phoonnx_tpu_torch import SynthesisConfig, TTSVoice
from phoonnx_tpu_torch.infer import VitsEngine
from phoonnx_tpu_torch.train import checkpoint, step
from phoonnx_tpu_torch.train.dataset import BucketedLoader, load_dataset
from phoonnx_tpu_torch.train.export import run_export
from phoonnx_tpu_torch.train.preprocess import run_preprocess
from phoonnx_tpu_torch.train.trainer import build_hparams

from tests.test_torch_preprocess import write_wav
from tests.test_torch_train_forward import one_torch_thread  # noqa: F401


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    root = tmp_path_factory.mktemp("corpus")
    (root / "wavs").mkdir()
    rng = np.random.default_rng(0)
    texts = ["hello world", "the quick brown fox", "a lazy dog",
             "goodbye now", "one more"]
    for i, text in enumerate(texts):
        sr = 22050 if i == 4 else 16000
        t = np.arange(int(sr * 0.5)) / sr
        write_wav(root / "wavs" / f"utt{i}.wav",
                  0.4 * np.sin(2 * math.pi * (150 + 40 * i) * t)
                  + 0.05 * rng.standard_normal(len(t)), sr)
    (root / "metadata.csv").write_text(
        "\n".join(f"utt{i}|{text}" for i, text in enumerate(texts)),
        encoding="utf-8")
    out = tmp_path_factory.mktemp("out") / "data" / "micro"
    run_preprocess(str(root), str(out), language="en",
                   phoneme_type="graphemes", alphabet="unicode",
                   sample_rate=16000, max_workers=1, single_speaker=True,
                   n_fft=128, hop_length=16, win_length=128, device="cpu")
    return out


def test_preprocess_train_export_load(dataset, tmp_path):
    config = json.loads((dataset / "config.json").read_text())
    assert config["num_speakers"] == 1 and config["audio"][
        "sample_rate"] == 16000
    hp = build_hparams(config, "micro")
    utts = load_dataset([dataset / "dataset.jsonl"])
    assert len(utts) == 5
    loader = BucketedLoader(utts, batch_size=2,
                            segment_size_frames=hp.segment_size,
                            hop_length=hp.hop_length, spec_pad_multiple=32,
                            spec_channels=hp.spec_channels)
    cfg = step.TrainConfig(steps_per_epoch=3, disc_periods=(2, 3),
                           disc_channel_scale=4)
    state = step.init_train_state(hp, cfg)
    batch = step.batch_to_device(next(iter(loader.epoch())), "cpu")
    state, metrics = step.train_step(state, batch, hp, cfg,
                                     generator=torch.Generator().manual_seed(1))
    assert all(math.isfinite(float(v)) for v in metrics.values())

    # checkpoint: the generator restores leaf for leaf
    ckpt = checkpoint.save(str(tmp_path / "ckpts"), state, hp, config)
    restored = checkpoint.restore_generator(ckpt, hp)
    for a, b in zip(step.leaves(restored), step.leaves(state.params_g)):
        assert torch.equal(a, b.detach())

    # export and reload through the public API
    model = run_export(ckpt, str(dataset / "config.json"),
                       str(tmp_path / "exported"), quality="micro",
                       generate_tokens=True, piper=True)
    name = Path(ckpt).name
    assert (model.parent / f"{name}.tokens.txt").exists()
    assert (model.parent / f"{name}.piper.json").exists()
    voice = TTSVoice.load(str(model), device="cpu")
    assert isinstance(voice.engine, VitsEngine)
    audio = voice.phoneme_ids_to_audio([1, 0, 5, 6, 7, 0, 2],
                                       SynthesisConfig(seed=0))
    assert audio.ndim == 1 and len(audio) > 0 and np.isfinite(audio).all()
    chunks = list(voice.synthesize("hello world", SynthesisConfig(seed=0)))
    assert chunks and all(np.isfinite(c.audio_float_array).all()
                          for c in chunks)

    # int8: smaller on disk, still the native engine, finite audio
    q_model = run_export(ckpt, str(dataset / "config.json"),
                         str(tmp_path / "int8"), quality="micro",
                         quantize=True)
    assert q_model.stat().st_size < model.stat().st_size * 0.6
    q_voice = TTSVoice.load(str(q_model), device="cpu")
    assert isinstance(q_voice.engine, VitsEngine)
    q_audio = q_voice.phoneme_ids_to_audio([1, 0, 5, 6, 7, 0, 2],
                                           SynthesisConfig(seed=0))
    assert np.isfinite(q_audio).all() and len(q_audio) > 0
