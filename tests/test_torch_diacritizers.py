"""The port's tashkeel and phonikud diacritizers against the JAX package's.

Both run the same text handling; the port runs the model op by op on
``TorchGraphRunner`` (here on the CPU), padded to ``bucket_len`` buckets,
where the JAX package runs the JAX runner or the numpy interpreter. On the
models that ``tests/test_tashkeel_model.py``, ``tests/test_phonikud_model.py``
and ``tests/test_aux_compile.py`` build, every output must equal the JAX
diacritizer's: taskeen, hints, out-of-vocabulary characters, the phonikud
heads and prefix marks, chunking at ``CHAR_LIMIT``, the sidecar
vocabulary, and the identity without a model. A runner failure raises
(the JAX package degrades to its interpreter instead), and a model that
ignores its length input keeps running on the runner at exact lengths.

The last tests repair the port's fault of refusing ``add_diacritics``
for ``ar``/``he`` voices: without a model the text comes back unchanged,
as in JAX (an Arabic GRAPHEMES voice synthesizing JAX's audio is in
``tests/test_torch_phonemizers.py``, beside the other voices).
"""

import json
import logging
import shutil

import numpy as np
import pytest

from phoonnx_tpu.onnx import aux_compile as jax_aux
from phoonnx_tpu.thirdparty import phonikud as jax_phonikud
from phoonnx_tpu.thirdparty import tashkeel as jax_tashkeel
from phoonnx_tpu_torch.onnx import aux_compile
from phoonnx_tpu_torch.onnx.torch_lowering import TorchGraphRunner
from phoonnx_tpu_torch.onnx.writer import write_onnx
from phoonnx_tpu_torch.thirdparty import phonikud
from phoonnx_tpu_torch.thirdparty import tashkeel

from tests import test_aux_compile as aux_models
from tests import test_phonikud_model as pk_models
from tests.test_torch_train_forward import one_torch_thread  # noqa: F401

SUKOON = "ْ"
ARABIC = ["مرحبا", "كتب الولد درسا", "قرأ", "م" + SUKOON + "ر",
          "abc 123", "العدد ٣٤ و 12", "مَرْحَبًا بِالعالم"]


class Boom:
    def run(self, feeds, outputs=None):
        raise RuntimeError("runner failed")


def pair_tashkeel(model_dir):
    return (jax_tashkeel.TashkeelDiacritizer(model_dir),
            tashkeel.TashkeelDiacritizer(model_dir, device="cpu"))


@pytest.fixture(scope="module")
def fatha_dir(tmp_path_factory):
    """test_tashkeel_model.py's constant-fatha model beside the maps."""
    from tests.test_tashkeel_model import model_dir

    return model_dir.__wrapped__(tmp_path_factory)


@pytest.fixture(scope="module")
def lstm_dir(tmp_path_factory):
    return aux_models._masked_lstm_tashkeel_dir(tmp_path_factory)


@pytest.fixture(scope="module")
def ignoring_dir(tmp_path_factory):
    return aux_models._length_ignoring_tashkeel_dir(tmp_path_factory)


def test_bucket_ladder():
    assert aux_compile.AUX_LEN_BUCKETS == jax_aux.AUX_LEN_BUCKETS
    for n in (1, 15, 16, 17, 200, 500, 12288, 12289, 20000):
        assert aux_compile.bucket_len(n) == jax_aux.bucket_len(n)
    assert aux_compile.bucket_len(17) == 32


@pytest.mark.parametrize("threshold", [None, -1.0, 0.5])
@pytest.mark.parametrize("model", ["fatha", "lstm"])
def test_tashkeel_equals_jax(request, model, threshold):
    model_dir = request.getfixturevalue(f"{model}_dir")
    want_d, got_d = pair_tashkeel(model_dir)
    for text in ARABIC:
        assert got_d.diacritize(text, threshold) == \
            want_d.diacritize(text, threshold), text
    assert isinstance(got_d._runner, TorchGraphRunner)
    assert got_d._pad_ok and got_d._pad_checked


def test_tashkeel_bucketed_equals_exact(lstm_dir):
    """The padded run against exact lengths on the same runner."""
    padded = tashkeel.TashkeelDiacritizer(lstm_dir, device="cpu")
    exact = tashkeel.TashkeelDiacritizer(lstm_dir, device="cpu")
    exact._pad_ok = False
    for text in ARABIC:
        assert padded.diacritize(text, 0.5) == exact.diacritize(text, 0.5)


def test_tashkeel_length_ignoring_model_runs_exact(ignoring_dir, caplog):
    want_d, got_d = pair_tashkeel(ignoring_dir)
    with caplog.at_level(logging.WARNING):
        got = got_d.diacritize(ARABIC[1], taskeen_threshold=0.5)
    assert "length padding" in caplog.text
    runner = got_d._runner
    assert isinstance(runner, TorchGraphRunner) and not got_d._pad_ok
    assert got == want_d.diacritize(ARABIC[1], taskeen_threshold=0.5)
    assert got_d.diacritize(ARABIC[2], 0.5) == want_d.diacritize(ARABIC[2],
                                                                 0.5)
    assert got_d._runner is runner  # never the host interpreter


def test_tashkeel_runner_failure_raises(fatha_dir):
    d = tashkeel.TashkeelDiacritizer(fatha_dir, device="cpu")
    d._get_executor()
    d._runner = Boom()
    with pytest.raises(RuntimeError, match="runner failed"):
        d.diacritize("مرحبا")


def test_tashkeel_identity_without_model(tmp_path, caplog):
    for name in ("input_id_map.json", "target_id_map.json",
                 "hint_id_map.json"):
        shutil.copy(tashkeel.TASHKEEL_DIR / name, tmp_path / name)
    want_d, got_d = pair_tashkeel(tmp_path)
    with caplog.at_level(logging.WARNING):
        assert got_d.diacritize(ARABIC[1]) == want_d.diacritize(ARABIC[1]) \
            == ARABIC[1]
    assert "not found" in caplog.text


@pytest.fixture(scope="module")
def gather_model(tmp_path_factory):
    """test_phonikud_model.py's Gather-table model, vocabulary in its
    metadata."""
    return pk_models.model_path.__wrapped__(tmp_path_factory)


def pair_phonikud(path):
    return (jax_phonikud.PhonikudDiacritizer(model_path=path),
            phonikud.PhonikudDiacritizer(model_path=path, device="cpu"))


HEBREW = [pk_models.ALEF + pk_models.BET + pk_models.SHIN + pk_models.VAV,
          "abc " + pk_models.ALEF + "! 12", "hello world",
          pk_models.ALEF + pk_models.SHEVA + pk_models.BET
          + pk_models.DAGESH, "שלום עולם\n" + pk_models.BET * 3]


@pytest.fixture()
def no_download(monkeypatch):
    """Neither package may fetch the phonikud model."""
    def refuse(self):
        raise AssertionError("_download was reached")

    monkeypatch.setattr(jax_phonikud.PhonikudDiacritizer, "_download",
                        refuse)
    monkeypatch.setattr(phonikud.PhonikudDiacritizer, "_download", refuse)


def test_phonikud_equals_jax(gather_model, no_download):
    want_d, got_d = pair_phonikud(gather_model)
    for text in HEBREW:
        assert got_d.diacritize(text) == want_d.diacritize(text), text
    assert isinstance(got_d._runner, TorchGraphRunner)


def test_phonikud_prefix_marks(tmp_path, gather_model, no_download):
    """The third head's '|' prefix boundary (a copy with BET's bit set)."""
    from phoonnx_tpu_torch.onnx.reader import read_onnx

    model = read_onnx(gather_model)
    inits = dict(model.initializers)
    inits["add_table"] = np.array(inits["add_table"], np.float32)
    inits["add_table"][pk_models.VOCAB[pk_models.BET], 2] = 5.0
    path = tmp_path / "prefix.onnx"
    write_onnx(str(path), inits, metadata=dict(model.metadata),
               inputs=list(model.inputs), outputs=list(model.outputs),
               nodes=[(n.op_type, list(n.inputs), list(n.outputs))
                      for n in model.nodes])
    want_d, got_d = pair_phonikud(str(path))
    text = pk_models.BET + pk_models.ALEF
    assert got_d.diacritize(text) == want_d.diacritize(text)
    assert phonikud.PREFIX_SEP in got_d.diacritize(text)


def test_phonikud_chunks_at_char_limit(gather_model, no_download):
    a, b = pk_models.ALEF, pk_models.BET
    text = ((a + b) * (phonikud.CHAR_LIMIT // 2) + " ") * 2 + a
    want_d, got_d = pair_phonikud(gather_model)
    got = got_d.diacritize(text)
    assert got == want_d.diacritize(text)
    assert got.count(pk_models.PATAH) == text.count(a) + text.count(b)


def test_phonikud_sidecar_vocabulary(tmp_path, gather_model, no_download):
    from phoonnx_tpu_torch.onnx.reader import read_onnx

    model = read_onnx(gather_model)
    dst = tmp_path / "m.onnx"
    write_onnx(str(dst), dict(model.initializers), inputs=list(model.inputs),
               outputs=list(model.outputs),
               nodes=[(n.op_type, list(n.inputs), list(n.outputs))
                      for n in model.nodes])
    (tmp_path / "vocab.json").write_text(json.dumps(pk_models.VOCAB),
                                         encoding="utf-8")
    want_d, got_d = pair_phonikud(str(dst))
    assert got_d.diacritize(pk_models.ALEF) == want_d.diacritize(
        pk_models.ALEF)
    assert pk_models.PATAH in got_d.diacritize(pk_models.ALEF)


def test_phonikud_identity_without_vocab_or_model(tmp_path, monkeypatch):
    """No vocabulary, or no model (its download returns False on both
    sides): the text comes back unchanged, and no runner is built."""
    for cls in (jax_phonikud.PhonikudDiacritizer,
                phonikud.PhonikudDiacritizer):
        monkeypatch.setattr(cls, "_download", lambda self: False)
    path = tmp_path / "novocab.onnx"
    write_onnx(str(path), {"t": np.zeros((2, 2), np.float32)},
               inputs=["input_ids", "attention_mask"],
               outputs=["nikud_logits"],
               nodes=[("Gather", ["t", "input_ids"], ["nikud_logits"])])
    text = pk_models.ALEF + pk_models.BET
    for model_path in (str(path), str(tmp_path / "absent.onnx")):
        want_d, got_d = pair_phonikud(model_path)
        assert got_d.diacritize(text) == want_d.diacritize(text) == text
        assert got_d._runner is None


def test_phonikud_random_tables_bucketed(tmp_path, no_download):
    """test_aux_compile.py's random-table model: bucketed on the runner
    equals JAX's and the exact-length run."""
    path = aux_models.phonikud_model.__wrapped__(tmp_path)
    want_d, got_d = pair_phonikud(path)
    got = got_d.diacritize(aux_models.HEB)
    assert got == want_d.diacritize(aux_models.HEB)
    exact = phonikud.PhonikudDiacritizer(model_path=path, device="cpu")
    exact._load()
    exact._pad_ok = False
    assert exact.diacritize(aux_models.HEB) == got


def test_phonikud_runner_failure_raises(gather_model, no_download):
    d = phonikud.PhonikudDiacritizer(model_path=gather_model, device="cpu")
    d.diacritize(pk_models.ALEF)
    d._runner = Boom()
    with pytest.raises(RuntimeError, match="runner failed"):
        d.diacritize(pk_models.ALEF + pk_models.BET)


def test_diacritizers_need_a_device():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tashkeel.TashkeelDiacritizer()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        phonikud.PhonikudDiacritizer(model_path="absent.onnx")


# -- the ar/he add_diacritics repair ------------------------------------------


@pytest.fixture()
def no_phonikud_model(monkeypatch, tmp_path):
    """No phonikud model under HOME, and its download returns False on
    both sides (it is never attempted)."""
    monkeypatch.setenv("HOME", str(tmp_path))
    monkeypatch.setattr(jax_phonikud.PhonikudDiacritizer, "_download",
                        lambda self: False)
    monkeypatch.setattr(phonikud.PhonikudDiacritizer, "_download",
                        lambda self: False)


@pytest.mark.parametrize("lang,text", [("ar", "مرحبا بالعالم"),
                                       ("ar-EG", "كتب ١٢"),
                                       ("he", "שלום עולם"),
                                       ("en", "hello")])
def test_add_diacritics_without_models_is_identity(no_phonikud_model, lang,
                                                   text):
    from phoonnx_tpu.phonemizers.base import GraphemePhonemizer as JaxG
    from phoonnx_tpu_torch.phonemizers.base import GraphemePhonemizer

    port = GraphemePhonemizer()
    port.device = "cpu"
    want = JaxG().add_diacritics(text, lang)
    assert port.add_diacritics(text, lang) == want == text
