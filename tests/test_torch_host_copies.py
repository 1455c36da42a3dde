"""The port's copies of the JAX package's host modules must not drift.

``phoonnx_tpu_torch`` imports nothing of ``phoonnx_tpu``: it keeps its own
copies of the JAX-free front-end, ONNX and training-data modules. Each copy must equal
its original once ``phoonnx_tpu.`` is rewritten to ``phoonnx_tpu_torch.``.
``config.py`` and ``phonemizers/base.py`` are trimmed copies, checked on
the classes and functions they keep; ``onnx/executor.py`` is the
original but for its two convolution handlers, which call torch where
the original calls JAX.
"""

import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
JAX_PKG = ROOT / "phoonnx_tpu"
PORT_PKG = ROOT / "phoonnx_tpu_torch"

VERBATIM = ["config.py", "phoneme_ids.py", "util.py", "numbers.py",
            "dates.py", "sentences.py", "langtags.py", "onnx/wire.py",
            "onnx/reader.py", "onnx/writer.py", "onnx/dequant.py",
            "onnx/builder.py", "onnx/vits_graph.py", "train/dataset.py"]
VERBATIM.remove("config.py")  # trimmed: see test_config_copy


def _rewrite(text: str) -> str:
    return text.replace("phoonnx_tpu.", "phoonnx_tpu_torch.")


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


@pytest.mark.parametrize("rel", VERBATIM)
def test_verbatim_copy(rel):
    original = (JAX_PKG / rel).read_text(encoding="utf-8")
    copy = (PORT_PKG / rel).read_text(encoding="utf-8")
    assert copy == _rewrite(original), f"{rel} drifted from phoonnx_tpu/{rel}"


def test_data_files_copied():
    pairs = [Path("_ipa_table.json")] + sorted(
        p.relative_to(JAX_PKG) for p in (JAX_PKG / "locale").rglob("*")
        if p.is_file())
    assert len(pairs) > 1
    for rel in pairs:
        assert (PORT_PKG / rel).read_bytes() == (JAX_PKG / rel).read_bytes(), rel


def test_config_copy():
    """Everything but ``get_phonemizer`` is verbatim; the port keeps the
    RAW, UNICODE and GRAPHEMES factories and refuses the rest."""
    original = _top_level(JAX_PKG / "config.py")
    copy = _top_level(PORT_PKG / "config.py")
    assert set(copy) == set(original)
    for name, src in original.items():
        if name != "get_phonemizer":
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
    from phoonnx_tpu_torch.config import get_phonemizer

    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        get_phonemizer(kind)
    with pytest.raises(ValueError):
        get_phonemizer("no-such-phonemizer")


def test_phonemizer_base_copy():
    """The kept classes are verbatim; only the he/ar diacritizer
    properties of BasePhonemizer are refused for now."""
    original = _top_level(JAX_PKG / "phonemizers" / "base.py")
    copy = _top_level(PORT_PKG / "phonemizers" / "base.py")
    kept = ["RawPhonemes", "GraphemePhonemizer", "UnicodeCodepointPhonemizer"]
    for name in kept + ["_LANG_SWITCH_FLAG", "_PUNCT_PATTERN"]:
        assert copy[name] == _rewrite(original[name]), name
    base_orig = _methods(original["BasePhonemizer"])
    base_copy = _methods(copy["BasePhonemizer"])
    assert set(base_copy) == set(base_orig)
    for name, src in base_orig.items():
        if name not in ("phonikud", "tashkeel"):
            assert base_copy[name] == _rewrite(src), name


@pytest.mark.parametrize("name", ["STATS_WINDOW", "SynthesisStats", "timed"])
def test_observability_copy(name):
    """The synthesis timers are verbatim; the profiler and memory hooks are
    rewritten for torch (``device_trace``, ``device_memory_stats``) and
    ``enable_compilation_cache`` has no counterpart."""
    original = _top_level(JAX_PKG / "observability.py")
    copy = _top_level(PORT_PKG / "observability.py")
    assert copy[name] == _rewrite(original[name])
    assert "enable_compilation_cache" not in copy
    assert {"device_trace", "device_memory_stats"} <= set(copy)
