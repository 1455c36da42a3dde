"""The port's copies of the JAX package's host modules must not drift.

``phoonnx_tpu_torch`` imports nothing of ``phoonnx_tpu``: it keeps its own
copies of the JAX-free front-end, ONNX and training-data modules. Each copy must equal
its original once ``phoonnx_tpu.`` (and ``from phoonnx_tpu import``) is
rewritten to ``phoonnx_tpu_torch``. ``phonemizers/base.py``,
``phonemizers/mul.py``, the tashkeel and phonikud diacritizers and
``onnx/aux_compile.py`` are trimmed copies, checked member by member with
the members that differ named; ``onnx/executor.py`` is the original but
for its two convolution handlers, which call torch where the original
calls JAX. The training pipeline's host modules (``train/audio.py``,
``train/preprocess.py``, ``train/export.py``, ``quantize.py``) are checked
the same way, with the members they add named.
"""

import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
JAX_PKG = ROOT / "phoonnx_tpu"
PORT_PKG = ROOT / "phoonnx_tpu_torch"

VERBATIM = ["version.py", "config.py", "phoneme_ids.py", "util.py", "numbers.py",
            "dates.py", "sentences.py", "langtags.py", "onnx/wire.py",
            "onnx/reader.py", "onnx/writer.py", "onnx/dequant.py",
            "onnx/builder.py", "onnx/vits_graph.py", "train/dataset.py",
            "thirdparty/__init__.py", "thirdparty/bw2ipa.py",
            "thirdparty/arpa2ipa.py", "thirdparty/zh_num.py",
            "thirdparty/hangul2ipa.py", "thirdparty/mantoq/__init__.py",
            "thirdparty/mantoq/num2words.py",
            "thirdparty/mantoq/phonetise.py", "thirdparty/kog2p/__init__.py",
            "phonemizers/__init__.py", "phonemizers/ar.py",
            "phonemizers/ko.py", "phonemizers/he.py", "phonemizers/fa.py",
            "phonemizers/vi.py", "phonemizers/ja.py", "phonemizers/zh.py",
            "phonemizers/en.py", "phonemizers/gl.py", "phonemizers/mwl.py"]

# data files of the copies: the ipa table, the locales and the bundled
# front ends' tables
DATA_GLOBS = ["_ipa_table.json", "locale/**/*", "thirdparty/*.json",
              "thirdparty/ko_tables/*", "thirdparty/kog2p/rulebook.txt",
              "thirdparty/mantoq/*.json", "thirdparty/tashkeel/*.json"]


def _rewrite(text: str) -> str:
    return text.replace("phoonnx_tpu.", "phoonnx_tpu_torch.").replace(
        "from phoonnx_tpu import", "from phoonnx_tpu_torch import")


def _top_level(path: Path) -> dict:
    """Source of each top-level class/function/assignment, by name."""
    text = path.read_text(encoding="utf-8")
    out = {}
    for node in ast.parse(text).body:
        if isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            out[node.name] = ast.get_source_segment(text, node)
        elif isinstance(node, ast.Assign):
            for target in node.targets:
                if isinstance(target, ast.Name):
                    out[target.id] = ast.get_source_segment(text, node)
    return out


def _methods(class_src: str) -> dict:
    node = ast.parse(class_src).body[0]
    return {m.name: ast.get_source_segment(class_src, m) for m in node.body
            if isinstance(m, ast.FunctionDef)}


def _class_attrs(class_src: str) -> dict:
    """Source of each class-level assignment, by name."""
    node = ast.parse(class_src).body[0]
    return {target.id: ast.get_source_segment(class_src, m)
            for m in node.body if isinstance(m, ast.Assign)
            for target in m.targets if isinstance(target, ast.Name)}


def _same_but(rel: str, differ: dict, added=()):
    """Check a trimmed copy: every top-level member equals the original's
    but the classes of ``differ`` (class name -> the methods that
    differ); their other methods and their class attributes are the
    original's, but the class attributes named in ``added``, which only
    the copy has. Returns (original, copy) members by name."""
    original = _top_level(JAX_PKG / rel)
    copy = _top_level(PORT_PKG / rel)
    assert set(copy) == set(original), set(copy) ^ set(original)
    for name, src in original.items():
        if name not in differ:
            assert copy[name] == _rewrite(src), (rel, name)
            continue
        orig_m, copy_m = _methods(src), _methods(copy[name])
        assert set(copy_m) == set(orig_m), (rel, name)
        for m, m_src in orig_m.items():
            same = copy_m[m] == _rewrite(m_src)
            assert same == (m not in differ[name]), (rel, name, m)
        attrs = _class_attrs(copy[name])
        assert set(added) <= set(attrs), (rel, name, added)
        assert {k: v for k, v in attrs.items() if k not in added} == {
            k: _rewrite(v) for k, v in _class_attrs(src).items()}
    return original, copy


@pytest.mark.parametrize("rel", VERBATIM)
def test_verbatim_copy(rel):
    original = (JAX_PKG / rel).read_text(encoding="utf-8")
    copy = (PORT_PKG / rel).read_text(encoding="utf-8")
    assert copy == _rewrite(original), f"{rel} drifted from phoonnx_tpu/{rel}"


def test_data_files_copied():
    pairs = sorted(p.relative_to(JAX_PKG) for g in DATA_GLOBS
                   for p in JAX_PKG.glob(g) if p.is_file()
                   and "__pycache__" not in p.parts)
    assert len(pairs) >= 19
    for rel in pairs:
        assert (PORT_PKG / rel).read_bytes() == (JAX_PKG / rel).read_bytes(), rel


def test_config_copy():
    """Verbatim since the port has every phonemizer: ``get_phonemizer``
    builds the JAX package's full factory table."""
    original = _top_level(JAX_PKG / "config.py")
    copy = _top_level(PORT_PKG / "config.py")
    assert set(copy) == set(original)
    for name, src in original.items():
        assert copy[name] == _rewrite(src), name


def test_executor_copy():
    """Every top-level function, class and assignment of the numpy
    interpreter is the original's, but ``_op_conv`` and
    ``_op_conv_transpose`` (torch.nn.functional in place of jax.lax)."""
    original = _top_level(JAX_PKG / "onnx" / "executor.py")
    copy = _top_level(PORT_PKG / "onnx" / "executor.py")
    assert set(copy) == set(original)
    rewritten = {"_op_conv", "_op_conv_transpose"}
    for name, src in original.items():
        if name in rewritten:
            assert "jax" in src and "jax" not in copy[name], name
        else:
            assert copy[name] == _rewrite(src), name


@pytest.mark.parametrize("kind", ["raw", "unicode", "graphemes"])
def test_ported_phonemizers_match(kind):
    from phoonnx_tpu.config import get_phonemizer as jax_get
    from phoonnx_tpu_torch.config import PhonemeType, get_phonemizer

    text = "Hello world. How are you?"
    want = jax_get(kind).phonemize(text, "en")
    got = get_phonemizer(PhonemeType(kind)).phonemize(text, "en")
    assert got == want


@pytest.mark.parametrize("kind", ["espeak", "gruut", "byt5", "misaki"])
def test_other_phonemizers_raise(kind):
    """The port builds what JAX builds for these types (a wrapper whose
    package is absent raises at construction in both); an unknown name
    is a ValueError."""
    from phoonnx_tpu.config import get_phonemizer as jax_get
    from phoonnx_tpu_torch.config import get_phonemizer

    def built(get):
        try:
            return type(get(kind)).__name__
        except Exception as exc:
            return type(exc)

    assert built(get_phonemizer) == built(jax_get)
    with pytest.raises(ValueError):
        get_phonemizer("no-such-phonemizer")


def test_phonemizer_base_copy():
    """The kept classes are verbatim; BasePhonemizer adds one class
    attribute, ``device``, which its tashkeel and phonikud properties
    pass to the diacritizers they build."""
    original, copy = _same_but("phonemizers/base.py", {
        "BasePhonemizer": ("phonikud", "tashkeel")}, added=("device",))
    orig_m = _methods(original["BasePhonemizer"])
    copy_m = _methods(copy["BasePhonemizer"])
    for name in ("phonikud", "tashkeel"):
        assert copy_m[name] == _rewrite(orig_m[name]).replace(
            "Diacritizer()", "Diacritizer(device=self.device)"), name


@pytest.mark.parametrize("rel,differ", [
    ("phonemizers/mul.py", {"ByT5Phonemizer": ("engine",)}),
    ("thirdparty/tashkeel/__init__.py",
     {"TashkeelDiacritizer": ("__init__", "_get_executor", "_infer")}),
    ("thirdparty/phonikud/__init__.py",
     {"PhonikudDiacritizer": ("__init__", "_load", "_execute")}),
], ids=["mul", "tashkeel", "phonikud"])
def test_trimmed_copy(rel, differ):
    """Only the members that build or run a model differ: the engine or
    the runner on the phonemizer's or the diacritizer's device
    (``TorchGraphRunner``, no interpreter fallback)."""
    _same_but(rel, differ)


def test_aux_compile_copy():
    """The bucket ladder is verbatim; ``compiled_runner`` builds a
    ``TorchGraphRunner`` on a device, and the ``PHOONNX_AUX_COMPILE``
    opt-out has no counterpart."""
    original = _top_level(JAX_PKG / "onnx" / "aux_compile.py")
    copy = _top_level(PORT_PKG / "onnx" / "aux_compile.py")
    for name in ("AUX_LEN_BUCKETS", "bucket_len"):
        assert copy[name] == _rewrite(original[name]), name
    assert set(copy) == set(original) - {"aux_compile_enabled", "LOG"}
    assert "TorchGraphRunner" in copy["compiled_runner"]


@pytest.mark.parametrize("name", ["STATS_WINDOW", "SynthesisStats"])
def test_observability_copy(name):
    """The synthesis stats are verbatim; the profiler and memory hooks are
    rewritten for torch (``device_trace``, ``device_memory_stats``),
    ``enable_compilation_cache`` has no counterpart and ``timed``, which
    the port never called, is gone."""
    original = _top_level(JAX_PKG / "observability.py")
    copy = _top_level(PORT_PKG / "observability.py")
    assert copy[name] == _rewrite(original[name])
    assert "enable_compilation_cache" not in copy and "timed" not in copy
    assert {"device_trace", "device_memory_stats"} <= set(copy)


@pytest.mark.parametrize("rel,differ,added", [
    # the VAD model on a TorchGraphRunner with no degrade, and the cache
    # written in a host half (workers) and a device half (spectrogram)
    ("train/audio.py", {"SileroVoiceActivityDetector": ("__init__",
                                                        "speech_probs"),
                        "cache_norm_audio": None},
     {"cache_paths", "read_for_cache", "write_cache"}),
    # host-only workers, the card work in the parent, argparse
    ("train/preprocess.py", {"phonemize_worker": None,
                             "run_preprocess": None, "main": None}, set()),
    # the port's checkpoint reader, argparse
    ("train/export.py", {"run_export": None, "main": None}, set()),
    # ValueError for click's exception, argparse
    ("quantize.py", {"quantize_voice": None, "main": None}, set()),
], ids=["audio", "preprocess", "export", "quantize"])
def test_pipeline_copy(rel, differ, added):
    """Every other top-level member, and every other method of a class
    named in ``differ``, is the original's."""
    original = _top_level(JAX_PKG / rel)
    copy = _top_level(PORT_PKG / rel)
    assert set(copy) == set(original) | set(added), \
        set(copy) ^ (set(original) | set(added))
    for name, src in original.items():
        methods = differ.get(name, ())
        if name not in differ:
            assert copy[name] == _rewrite(src), (rel, name)
        elif methods is None:
            assert copy[name] != _rewrite(src), (rel, name)
        else:
            orig_m, copy_m = _methods(src), _methods(copy[name])
            assert set(copy_m) == set(orig_m), (rel, name)
            for m, m_src in orig_m.items():
                same = copy_m[m] == _rewrite(m_src)
                assert same == (m not in methods), (rel, name, m)
