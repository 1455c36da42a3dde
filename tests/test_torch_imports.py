"""The port stands alone: no JAX, no ``phoonnx_tpu``, and the GPU by default.

(a) A fresh interpreter whose import system refuses ``jax``, ``jaxlib``
and ``phoonnx_tpu`` (but not ``phoonnx_tpu_torch``) imports every module
of the port, synthesizes, serves one seeded request through the batcher,
takes one training step, exports its checkpoint and serves the voice,
runs an exported voice graph on the ONNX graph engine, phonemizes Arabic with mantoq and decodes with a micro
ByT5 G2P, on the CPU. (b) The entry points default to
CUDA and raise without it; they never drop to the CPU on their own.
"""

import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent

_BLOCKED_RUN = r"""
import importlib, importlib.abc, pkgutil, sys

BLOCKED = ("jax", "jaxlib", "phoonnx_tpu")

class Refuse(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if any(name == b or name.startswith(b + ".") for b in BLOCKED):
            raise ImportError(f"the port must not import {name}")
        return None

sys.meta_path.insert(0, Refuse())

import phoonnx_tpu_torch
names = [m.name for m in pkgutil.walk_packages(
    phoonnx_tpu_torch.__path__, "phoonnx_tpu_torch.")]
for name in names:
    importlib.import_module(name)
assert len(names) >= 25, names
for trained in ("ops.mas", "ops.stft", "models.vits.discriminator",
                "train.losses", "train.step", "train.dataset",
                "train.checkpoint", "train.trainer", "ops.istft", "ops.pqmf",
                "models.vits.istft_decoder", "infer.graphs",
                "observability", "synthesize", "convert", "serve",
                "onnx.executor", "onnx.torch_lowering", "onnx.builder",
                "onnx.vits_graph", "infer.onnx_engine", "models.byt5",
                "onnx.aux_compile", "phonemizers.mul", "phonemizers.ar",
                "phonemizers.ko", "thirdparty.mantoq", "thirdparty.kog2p",
                "thirdparty.hangul2ipa", "thirdparty.tashkeel",
                "thirdparty.phonikud", "version", "quantize", "train.audio",
                "train.preprocess", "train.export", "train.scale_run"):
    assert "phoonnx_tpu_torch." + trained in names, trained

import torch
from phoonnx_tpu_torch.infer import VitsEngine
from phoonnx_tpu_torch.models.vits.model import VitsHParams, random_params

hp = VitsHParams.preset("micro", n_vocab=32)
engine = VitsEngine(random_params(hp, torch.Generator().manual_seed(0)), hp,
                    device="cpu")
audio = engine.synthesize_ids([1, 4, 5, 6, 2], seed=0)
assert audio.ndim == 1 and len(audio) % hp.total_upsample == 0
assert torch.isfinite(torch.from_numpy(audio)).all()
from phoonnx_tpu_torch.train import step
cfg = step.TrainConfig(disc_periods=(2,), disc_channel_scale=4)
state = step.init_train_state(hp, cfg)
rng = torch.Generator().manual_seed(1)
batch = {"phoneme_ids": torch.randint(1, 32, (2, 7), generator=rng),
         "phoneme_lengths": torch.tensor([7, 5], dtype=torch.int32),
         "spec": torch.rand(2, 24, hp.spec_channels, generator=rng),
         "spec_lengths": torch.tensor([24, 20], dtype=torch.int32),
         "audio": torch.rand(2, 24 * hp.hop_length, generator=rng) - 0.5}
state, metrics = step.train_step(state, batch, hp, cfg, generator=rng)
assert state.step == 1 and all(torch.isfinite(v) for v in metrics.values())
import json, tempfile
from phoonnx_tpu_torch.train import checkpoint, export
with tempfile.TemporaryDirectory() as tmp:
    with open(tmp + "/config.json", "w") as f:
        json.dump({"num_symbols": 32, "audio": {"sample_rate": 16000},
                   "phoneme_type": "raw", "alphabet": "unicode"}, f)
    ckpt = checkpoint.save(tmp, state, hp)
    voice = export.run_export(ckpt, tmp + "/config.json", tmp + "/out",
                              quality="micro")
    from phoonnx_tpu_torch import TTSVoice
    assert len(TTSVoice.load(str(voice), device="cpu").engine.synthesize_ids(
        [1, 4, 5, 6, 2], seed=0)) > 0
from phoonnx_tpu_torch.serve import DynamicBatcher
batcher = DynamicBatcher(engine, max_batch=2, autostart=False)
sub = batcher.submit([[1, 4, 5, 2], [1, 6, 2]], (0.667, 1.0, 0.8), seed=0)
batcher._drain_once()
assert len(sub.wait(timeout=60)) > 0
import tempfile
from phoonnx_tpu_torch.models.vits.load import params_to_flat
from phoonnx_tpu_torch.onnx.reader import read_onnx
from phoonnx_tpu_torch.onnx.vits_graph import export_vits_onnx
from phoonnx_tpu_torch.infer.onnx_engine import OnnxFallbackEngine
with tempfile.TemporaryDirectory() as tmp:
    export_vits_onnx(params_to_flat(random_params(
        hp, torch.Generator().manual_seed(0))), hp, tmp + "/v.onnx")
    graph_engine = OnnxFallbackEngine(read_onnx(tmp + "/v.onnx"),
                                      hp.sample_rate, device="cpu")
assert len(graph_engine.synthesize_ids([1, 4, 5, 6, 2], seed=0)) > 0
from phoonnx_tpu_torch.config import get_phonemizer
assert get_phonemizer("mantoq").phonemize_string("مرحبا 12", "ar")
from phoonnx_tpu_torch.models import byt5
t5 = byt5.T5Config(vocab_size=384, d_model=16, d_kv=8, d_ff=32, num_heads=2,
                   num_encoder_layers=1, num_decoder_layers=1)
g2p = byt5.ByT5Engine.from_flat(byt5.random_flat(t5), max_length=8,
                                device="cpu")
assert len(g2p.greedy_decode([10, 45, 99, 1])) <= 8
leaked = sorted(m for m in sys.modules
                if any(m == b or m.startswith(b + ".") for b in BLOCKED))
assert not leaked, leaked
print("OK", len(names))
"""


def test_port_imports_neither_jax_nor_the_jax_package():
    proc = subprocess.run([sys.executable, "-c", _BLOCKED_RUN], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.startswith("OK")


def test_source_names_no_jax_import():
    import re

    pattern = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|phoonnx_tpu)\b"
                         r"(?!_torch)", re.M)
    for path in (ROOT / "phoonnx_tpu_torch").rglob("*.py"):
        assert not pattern.search(path.read_text(encoding="utf-8")), path


def test_load_defaults_to_cuda_and_raises_without_it(monkeypatch, tmp_path):
    from phoonnx_tpu_torch import TTSVoice
    from phoonnx_tpu_torch.infer import VitsEngine
    from phoonnx_tpu_torch.infer.engine import resolve_device
    from phoonnx_tpu_torch.models.vits.model import VitsHParams, random_params

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    # the GPU check comes before any file is read
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TTSVoice.load(tmp_path / "missing.onnx", tmp_path / "missing.json")
    hp = VitsHParams.preset("micro", n_vocab=32)
    with pytest.raises(RuntimeError, match="CUDA"):
        VitsEngine(random_params(hp), hp)
    with pytest.raises(RuntimeError):
        resolve_device("cuda:0")
    assert resolve_device("cpu") == torch.device("cpu")


def test_cuda_device_turns_tf32_off(monkeypatch):
    from phoonnx_tpu_torch.infer.engine import resolve_device

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    assert resolve_device(None) == torch.device("cuda")
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False


def test_kernel_wrappers_refuse_bad_arguments():
    """On a tensor that is not on the CPU the wrappers launch or raise;
    the argument checks run before any build."""
    from phoonnx_tpu_torch import cuda

    dev = torch.device("cpu")
    with pytest.raises(TypeError, match="float32"):
        cuda.require(torch.zeros(2, dtype=torch.float64), "x", dev)
    with pytest.raises(ValueError, match="contiguous"):
        cuda.require(torch.zeros(4, 4).T, "x", dev)
    with pytest.raises(ValueError, match="shape"):
        cuda.require(torch.zeros(4), "x", dev, shape=(5,))
    with pytest.raises(ValueError, match="is on"):
        cuda.require(torch.zeros(4), "x", torch.device("meta"))
