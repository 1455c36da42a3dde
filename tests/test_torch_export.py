"""The port's export and quantization against the JAX package's, on the CPU.

A micro generator saved by the JAX package's ``checkpoint.save`` is
exported by both packages' ``run_export`` (the executable graph,
``--weights-only`` and ``--quantize``), and a checkpoint the port's own
``checkpoint.save`` wrote goes through the JAX exporter the same way:

* the same node list, graph inputs and outputs, and metadata;
* float initializers within 1e-6: the decoder's weight-norm fold is float32
  in both frameworks, summed in other orders (the other folds are the same
  numpy float64 code);
* the int8 tensors of the quantized graphs are equal, their scales within
  1e-6 of each other relatively; ``tokens.txt``, ``piper.json`` and the
  config beside the model are byte-equal.

``quantize_voice`` of both packages on one voice gives the same tensors,
and the port's export, loaded by ``TTSVoice.load(device="cpu")``,
synthesizes within 1e-5 of the peak of a ``VitsEngine`` over the
checkpoint's generator (same seed, equal length).

The JAX importers start from a ``random_params`` tree whose eager draws
compile ~80 programs (~22 s a process); a zero tree of the same structure
(``jax.eval_shape``, nothing compiled) stands in, as in
``tests/test_torch_phonemizers.py``, and only routed leaves are read.
"""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from phoonnx_tpu_torch.models.vits.model import VitsHParams
from phoonnx_tpu_torch.onnx.reader import read_onnx
from phoonnx_tpu_torch.train import checkpoint, export, step

from tests.test_torch_train_forward import jax_tree
from tests.test_torch_train_forward import one_torch_thread  # noqa: F401

FLOAT_ATOL = 1e-6
SCALE_RTOL = 1e-6
WAVE_TOL = 1e-5
SYMBOLS = ["_", "^", "$", " "] + list("abcdefghijklmnopqrst")
HP = VitsHParams.preset("micro", n_vocab=len(SYMBOLS))
DISC = dict(disc_periods=(2,), disc_channel_scale=4)


@pytest.fixture(scope="module")
def zero_skeletons():
    """JAX's ``random_params`` as a zero tree of its structure, in the
    modules that draw it for an import."""
    import jax

    from phoonnx_tpu.models.vits import load as jax_load
    from phoonnx_tpu.models.vits import model as jax_model

    draw = jax_model.random_params

    def skeleton(key, hp):
        shapes = jax.eval_shape(lambda k: draw(k, hp), key)
        return jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), shapes)

    with pytest.MonkeyPatch.context() as patch:
        patch.setattr(jax_model, "random_params", skeleton)
        patch.setattr(jax_load, "random_params", skeleton)
        yield


def write_config(path: Path) -> Path:
    config = {
        "dataset": "d", "audio": {"sample_rate": HP.sample_rate,
                                  "quality": "micro"},
        "lang_code": "en", "inference": {"noise_scale": 0.667,
                                         "length_scale": 1, "noise_w": 0.8},
        "alphabet": "unicode", "phoneme_type": "graphemes",
        "phonemizer_model": None,
        "phoneme_id_map": {s: i for i, s in enumerate(SYMBOLS)},
        "num_symbols": len(SYMBOLS), "num_speakers": 1,
        "speaker_id_map": {}, "pad": "_", "blank": "_", "bos": "^",
        "eos": "$",
    }
    path.write_text(json.dumps(config, ensure_ascii=False), encoding="utf-8")
    return path


def port_state(seed: int) -> step.TrainState:
    """A port train state whose flows' post layers are non-zero (a zero
    post is the identity), so every layer reaches the audio."""
    state = step.init_train_state(HP, step.TrainConfig(**DISC),
                                  torch.Generator().manual_seed(seed))
    gen = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():
        for flow in state.params_g["flow"]["flows"]:
            for key in ("weight", "bias"):
                flow["post"][key].copy_(0.05 * torch.randn(
                    flow["post"][key].shape, generator=gen))
    return state


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """(config, JAX-written checkpoint, port-written checkpoint)."""
    import jax.numpy as jnp

    from phoonnx_tpu.models.vits import model as jax_model
    from phoonnx_tpu.train import checkpoint as jax_checkpoint
    from phoonnx_tpu.train import step as jax_step

    root = tmp_path_factory.mktemp("ckpt")
    config = write_config(root / "config.json")
    state = port_state(3)
    flat = {f".params_g{name}": leaf.detach().numpy().copy()
            for name, leaf in step.keyed_leaves(state.params_g)}
    jg = jax_tree(lambda k: jax_model.random_params(k, HP), flat, ".params_g")
    jstate = jax_step.TrainState(params_g=jg, params_d={}, opt_g=(),
                                 opt_d=(), step=jnp.asarray(5, jnp.int32))
    jax_ckpt = jax_checkpoint.save(str(root / "jax"), jstate, HP)
    port_ckpt = checkpoint.save(str(root / "port"), port_state(4), HP)
    return config, Path(jax_ckpt), Path(port_ckpt)


def both_exports(ckpt: Path, config: Path, out: Path, **kw):
    from phoonnx_tpu.train.export import run_export as jax_export

    ours = export.run_export(str(ckpt), str(config), str(out / "port"),
                             quality="micro", generate_tokens=True,
                             piper=True, **kw)
    theirs = jax_export(str(ckpt), str(config), str(out / "jax"),
                        quality="micro", generate_tokens=True, piper=True,
                        **kw)
    return Path(ours), Path(theirs)


def node_key(node):
    attrs = []
    for name in sorted(node.attributes):
        value = node.attributes[name]
        if isinstance(value, np.ndarray):
            value = (value.dtype.str, value.shape, value.tobytes())
        attrs.append((name, repr(value) if not isinstance(value, tuple)
                      else value))
    return node.op_type, tuple(node.inputs), tuple(node.outputs), tuple(attrs)


def assert_same_voice(ours: Path, theirs: Path):
    a, b = read_onnx(str(ours)), read_onnx(str(theirs))
    assert [node_key(n) for n in a.nodes] == [node_key(n) for n in b.nodes]
    assert (a.inputs, a.outputs, a.opset) == (b.inputs, b.outputs, b.opset)
    assert a.metadata == b.metadata
    assert set(a.initializers) == set(b.initializers)
    worst = 0.0
    for name, want in b.initializers.items():
        got = a.initializers[name]
        assert got.dtype == want.dtype and got.shape == want.shape, name
        if name.endswith("_scale"):
            np.testing.assert_allclose(got, want, rtol=SCALE_RTOL, atol=0)
        elif np.issubdtype(want.dtype, np.floating):
            err = float(np.abs(got - want).max()) if want.size else 0.0
            worst = max(worst, err)
            assert err <= FLOAT_ATOL, (name, err)
        else:
            np.testing.assert_array_equal(got, want, err_msg=name)
    for suffix in (".json",):
        assert Path(str(ours) + suffix).read_bytes() == Path(
            str(theirs) + suffix).read_bytes()
    stem = ours.name[:-len(".onnx")]
    for side in ("tokens.txt", "piper.json"):
        assert (ours.parent / f"{stem}.{side}").read_bytes() == (
            theirs.parent / f"{stem}.{side}").read_bytes(), side
    return a, worst


@pytest.mark.parametrize("kw", [{}, {"executable_graph": False},
                                {"quantize": True}],
                         ids=["graph", "weights-only", "int8"])
def test_jax_checkpoint_exports_equal(files, zero_skeletons, tmp_path, kw):
    config, jax_ckpt, _ = files
    model, worst = assert_same_voice(*both_exports(jax_ckpt, config,
                                                   tmp_path, **kw))
    if kw.get("quantize"):
        assert any(v.dtype == np.int8 for v in model.initializers.values())
    print(f"{kw}: worst float initializer difference {worst:.2e}")


def test_port_checkpoint_exports_equal(files, zero_skeletons, tmp_path):
    """The reverse direction: the port's checkpoint through JAX's
    exporter, graph and int8."""
    config, _, port_ckpt = files
    assert_same_voice(*both_exports(port_ckpt, config, tmp_path / "f"))
    assert_same_voice(*both_exports(port_ckpt, config, tmp_path / "q",
                                    quantize=True))


def test_quantize_voice_matches_jax(files, zero_skeletons, tmp_path):
    from phoonnx_tpu.quantize import quantize_voice as jax_quantize
    from phoonnx_tpu_torch.quantize import main, quantize_voice

    config, jax_ckpt, _ = files
    voice = export.run_export(str(jax_ckpt), str(config), str(tmp_path),
                              quality="micro")
    quantize_voice(str(voice), str(tmp_path / "port.int8.onnx"))
    jax_quantize(str(voice), str(tmp_path / "jax.int8.onnx"))
    a = read_onnx(str(tmp_path / "port.int8.onnx"))
    b = read_onnx(str(tmp_path / "jax.int8.onnx"))
    assert a.metadata == b.metadata and set(a.initializers) == set(
        b.initializers)
    for name, want in b.initializers.items():
        np.testing.assert_array_equal(a.initializers[name], want,
                                      err_msg=name)
    assert Path(str(tmp_path / "port.int8.onnx") + ".json").read_bytes() == \
        Path(str(voice) + ".json").read_bytes()
    # the CLI; a foreign file is refused with a message, not a traceback
    assert main(["-m", str(voice), "-o", str(tmp_path / "cli.onnx")]) == 0
    foreign = tmp_path / "foreign.onnx"
    from phoonnx_tpu_torch.onnx.writer import write_onnx
    write_onnx(str(foreign), {"w": np.ones((4, 4), np.float32)},
               inputs=["x"], outputs=["y"], nodes=[("MatMul", ["x", "w"],
                                                    ["y"])])
    assert main(["-m", str(foreign), "-o", str(tmp_path / "f.onnx")]) == 1


def test_export_serves_like_the_checkpoint(files, tmp_path):
    from phoonnx_tpu_torch import TTSVoice
    from phoonnx_tpu_torch.infer import VitsEngine

    config, _, port_ckpt = files
    model = export.run_export(str(port_ckpt), str(config), str(tmp_path),
                              quality="micro")
    voice = TTSVoice.load(str(model), device="cpu")
    assert isinstance(voice.engine, VitsEngine)
    engine = VitsEngine(checkpoint.restore_generator(str(port_ckpt), HP), HP,
                        device="cpu")
    ids = [1, 4, 3, 9, 12, 3, 5, 17, 2]
    got = voice.engine.synthesize_ids(ids, seed=0)
    want = engine.synthesize_ids(ids, seed=0)
    assert got.shape == want.shape and len(want) > 0
    err = float(np.abs(got - want).max() / np.abs(want).max())
    assert err <= WAVE_TOL, err
    print(f"export vs checkpoint engine: {err:.2e} of the peak")
