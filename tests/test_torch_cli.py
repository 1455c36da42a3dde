"""The port's CLIs (python -m phoonnx_tpu_torch.synthesize / .convert).

The counterparts of tests/test_cli.py:53-178, on ``--device cpu`` and
calling ``main(argv)``: the voices are written with the port's own ONNX
writer from the port's random parameters.
"""

import dataclasses
import io
import json
import wave

import numpy as np
import pytest
import torch

from phoonnx_tpu_torch.convert import main as convert_main
from phoonnx_tpu_torch.models.vits.load import params_to_flat
from phoonnx_tpu_torch.models.vits.model import VitsHParams, random_params
from phoonnx_tpu_torch.onnx.writer import write_onnx
from phoonnx_tpu_torch.synthesize import main as synthesize_main

from tests.test_torch_train_forward import one_torch_thread  # noqa: F401

LETTERS = "abcdefghijklmnop"


def write_port_voice(path, hp, seed):
    """A voice (``path`` and ``path.json``) of random port parameters;
    RAW phonemes, the letters a-p."""
    params = random_params(hp, torch.Generator().manual_seed(seed))
    metadata = {"model_type": "vits", "sample_rate": str(hp.sample_rate)}
    inputs = ["input", "input_lengths", "scales"]
    if hp.n_speakers > 1:
        metadata["n_speakers"] = str(hp.n_speakers)
        inputs.append("sid")
    write_onnx(str(path), params_to_flat(params), metadata=metadata,
               inputs=inputs, outputs=["output"])
    id_map = {"_": 0, "^": 1, "$": 2, " ": 3}
    id_map.update({c: i + 4 for i, c in enumerate(LETTERS)})
    path.with_name(path.name + ".json").write_text(json.dumps({
        "phoneme_type": "raw", "lang_code": "en", "alphabet": "ipa",
        "phoneme_id_map": id_map, "num_symbols": len(id_map),
        "num_speakers": hp.n_speakers,
        "audio": {"sample_rate": hp.sample_rate},
        "inference": {"noise_scale": 0.667, "length_scale": 1.0,
                      "noise_w": 0.8},
    }), encoding="utf-8")
    return path


def write_tone(path, n, rate=16000, seed=0):
    rng = np.random.default_rng(seed)
    pcm = (0.2 * np.sin(2 * np.pi * 220 * np.arange(n) / rate)
           + 0.01 * rng.standard_normal(n))
    with wave.open(str(path), "wb") as f:
        f.setnchannels(1)
        f.setsampwidth(2)
        f.setframerate(rate)
        f.writeframes((pcm * 32767).astype(np.int16).tobytes())
    return path


@pytest.fixture(scope="module")
def voice_files(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_cli_voice")
    return write_port_voice(tmp / "model.onnx",
                            VitsHParams.preset("micro", n_vocab=20), 0)


@pytest.fixture(scope="module")
def multi_speaker_voice(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_cli_ms_voice")
    hp = dataclasses.replace(VitsHParams.preset("micro", n_vocab=20),
                             n_speakers=3, gin_channels=16)
    return write_port_voice(tmp / "ms.onnx", hp, 2)


def _check_wav(path, sample_rate=16000):
    with wave.open(str(path), "rb") as w:
        assert w.getframerate() == sample_rate
        n = w.getnframes()
        pcm = np.frombuffer(w.readframes(n), np.int16)
    assert n > 0 and np.abs(pcm).max() > 0
    return pcm


def test_cli_synthesize(voice_files, tmp_path, capsys):
    out = tmp_path / "out.wav"
    synthesize_main(["-m", str(voice_files), "-t", "[[abc def]]", "-o",
                     str(out), "--seed", "3", "--stats", "--device", "cpu"])
    _check_wav(out)
    assert "rtf" in capsys.readouterr().err


def test_cli_synthesize_stream_matches(voice_files, tmp_path):
    out_full = tmp_path / "full.wav"
    out_stream = tmp_path / "stream.wav"
    common = ["-m", str(voice_files), "-t", "[[abc def gah]]", "--seed", "5",
              "--no-normalize", "--device", "cpu"]
    synthesize_main(common + ["-o", str(out_full)])
    synthesize_main(common + ["-o", str(out_stream), "--stream"])
    full = _check_wav(out_full)
    stream = _check_wav(out_stream)
    assert len(full) == len(stream)
    np.testing.assert_allclose(stream, full, atol=2)


def test_cli_voice_conversion(multi_speaker_voice, tmp_path, capsys):
    src = write_tone(tmp_path / "src.wav", 8000)
    out = tmp_path / "converted.wav"
    common = ["-m", str(multi_speaker_voice), "-o", str(out), "--device",
              "cpu"]
    convert_main(common + ["-i", str(src), "--from-speaker", "0",
                           "--to-speaker", "2", "--seed", "1"])
    converted = _check_wav(out)
    # frames -> samples: the output is spec frames * hop, about the
    # input's length (the exact count depends on the STFT edge padding)
    assert len(converted) % 16 == 0
    assert abs(len(converted) - 8000) <= 256

    # a wrong sample rate is rejected cleanly
    bad = write_tone(tmp_path / "bad.wav", 100, rate=8000)
    with pytest.raises(SystemExit) as err:
        convert_main(common + ["-i", str(bad), "--from-speaker", "0",
                               "--to-speaker", "1"])
    assert err.value.code != 0 and "resample" in str(err.value.code)

    # an out-of-range speaker id would index another speaker's embedding
    with pytest.raises(SystemExit) as err:
        convert_main(common + ["-i", str(src), "--from-speaker", "0",
                               "--to-speaker", "999"])
    assert err.value.code != 0 and "out of range" in str(err.value.code)


def test_cli_stdin_input(voice_files, tmp_path, monkeypatch):
    out = tmp_path / "stdin.wav"
    monkeypatch.setattr("sys.stdin", io.StringIO("[[ab cd]]"))
    synthesize_main(["-m", str(voice_files), "-o", str(out), "--seed", "1",
                     "--device", "cpu"])
    _check_wav(out)


@pytest.mark.parametrize("stream", [False, True], ids=["whole", "stream"])
def test_cli_synthesize_empty_text_writes_valid_wav(voice_files, tmp_path,
                                                    stream):
    """A zero-chunk input must not crash Wave_write.close(): the headers
    are set upfront from the voice config."""
    out = tmp_path / "empty.wav"
    synthesize_main(["-m", str(voice_files), "-o", str(out), "-t", "   ",
                     "--device", "cpu"] + (["--stream"] if stream else []))
    with wave.open(str(out), "rb") as f:
        assert f.getnchannels() == 1
        assert f.getnframes() == 0


# --bf16 and --precision are ported: on the CPU a --precision of 'high'
# or 'highest' writes exactly the WAV of the default (TF32 changes only
# CUDA products), with or without --bf16; another value is refused
@pytest.mark.parametrize("flags", [["--bf16", "--precision", "high"],
                                   ["--precision", "highest"],
                                   ["--precision", "high"],
                                   ["--precision", "medium"]],
                         ids=["bf16", "precision", "high", "bad"])
def test_cli_refuses_what_is_not_ported(voice_files, tmp_path, flags):
    common = ["-m", str(voice_files), "-t", "[[ab cd]]", "--seed", "4",
              "--device", "cpu"]
    if flags[-1] == "medium":
        with pytest.raises(SystemExit) as err:
            synthesize_main(common + ["-o", str(tmp_path / "x.wav")] + flags)
        assert err.value.code != 0
        return
    bf16 = [f for f in flags if f == "--bf16"]
    synthesize_main(common + ["-o", str(tmp_path / "x.wav")] + flags)
    synthesize_main(common + ["-o", str(tmp_path / "ref.wav")] + bf16)
    np.testing.assert_array_equal(_check_wav(tmp_path / "x.wav"),
                                  _check_wav(tmp_path / "ref.wav"))


@pytest.mark.parametrize("stream", [False, True], ids=["whole", "stream"])
def test_cli_synthesize_bf16(voice_files, tmp_path, stream):
    """``--bf16`` on the CPU: the voice in bfloat16 writes a WAV within a
    few bf16 steps of the float32 one of the same seed (measured 48 and
    48 int16 steps, whole and streamed, on a peak of 6,322)."""
    outs = {}
    for flag in ([], ["--bf16"]):
        out = tmp_path / f"out{len(flag)}.wav"
        synthesize_main(["-m", str(voice_files), "-t", "[[abc def gah]]",
                         "-o", str(out), "--seed", "4", "--no-normalize",
                         "--device", "cpu"] + flag
                        + (["--stream"] if stream else []))
        outs[bool(flag)] = _check_wav(out).astype(np.int32)
    assert outs[True].shape == outs[False].shape
    assert np.abs(outs[True] - outs[False]).max() <= 5e-3 * 32767


def test_serve_cli_bf16(voice_files, monkeypatch):
    """``python -m phoonnx_tpu_torch.serve --bf16 --device cpu``: the
    server's voice is bfloat16 and answers a request (serve_forever
    replaced by one request, then a stop)."""
    import chip_smoke
    from phoonnx_tpu_torch import serve

    seen = {}

    def one_request(srv):
        srv.start()
        try:
            seen["dtype"] = srv.voice.engine.dtype
            seen["pcm"] = chip_smoke.serve_post(srv, {"text": "abc def",
                                                      "seed": 1})[0]
        finally:
            srv.stop()

    monkeypatch.setattr(serve.TTSServer, "serve_forever", one_request)
    serve.main(["--model", str(voice_files), "--port", "0", "--device",
                "cpu", "--bf16"])
    assert seen["dtype"] == torch.bfloat16
    assert seen["pcm"].size > 0 and np.abs(seen["pcm"]).max() > 0


def test_cli_defaults_to_the_gpu(voice_files, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        synthesize_main(["-m", str(voice_files), "-o",
                         str(tmp_path / "x.wav"), "-t", "[[ab]]"])
