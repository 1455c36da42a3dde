"""The reference against the program's plain path on the CPU, at the
port's micro widths: the same weights, ids and scales give the same audio.
Also the front end and the weights' layout against the program's."""

import json

import numpy as np
import pytest
import torch

from bench_micro import BENCH, micro_config
from harness import serve, traffic, weights
from reference import compare, frontend
from reference import vits as ref


@pytest.mark.parametrize("name", ["piper-medium", "piper-high"])
def test_layout_is_the_programs(name):
    """Every name and shape of the program's flat layout, at the
    configuration's own widths."""
    from phoonnx_tpu_torch.models.vits.load import params_to_flat
    from phoonnx_tpu_torch.models.vits.model import random_params

    cfg = json.loads((BENCH / "configs" / f"{name}.json").read_text())
    port = params_to_flat(random_params(serve.hparams(cfg),
                                        torch.Generator().manual_seed(0)))
    mine = {n: s for n, s, _, _ in weights.layout(cfg)}
    assert mine == {k: tuple(v.shape) for k, v in port.items()}


def test_weights_repeat_for_a_seed():
    leaves = weights.layout(micro_config())
    a = weights.make(leaves, 2 ** 33 + 1, "cpu")
    b = weights.make(leaves, 2 ** 33 + 1, "cpu")
    c = weights.make(leaves, 2 ** 33 + 2, "cpu")
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["enc_p.emb.weight"], c["enc_p.emb.weight"])


def test_front_end_is_the_programs():
    from phoonnx_tpu_torch.config import VoiceConfig
    from phoonnx_tpu_torch.voice import TTSVoice

    cfg = micro_config()
    voice = TTSVoice(engine=None, config=VoiceConfig.from_dict(
        serve.voice_config(cfg)))
    imap = serve.id_map(cfg)
    for text in traffic.lj_texts(json.loads(
            (BENCH / "traffic" / "lj-closed-64.json").read_text()), 4)[:8]:
        ph = voice.phonemize(text)
        assert len(ph) == 1
        assert voice.phonemes_to_ids(ph[0]) == frontend.text_to_ids(text,
                                                                    imap)


@pytest.mark.parametrize("seed", [1, 2 ** 31 + 3])
def test_reference_is_the_programs_plain_path(seed):
    cfg = micro_config()
    flat = weights.make(weights.layout(cfg), seed, "cpu")
    voice = serve.load_voice(cfg, flat, "cpu")
    w = ref.Weights(flat)
    texts = ["abcde fghij klmno", "the quick brown fox jumps over"]
    ids = [frontend.text_to_ids(t, serve.id_map(cfg)) for t in texts]
    scale = serve.length_scale(w, cfg, ids, 2.5)
    audio, frames = voice.engine.synthesize_batch(
        ids, noise_scale=0.0, length_scale=scale, noise_w=0.0, seed=0)
    hop = compare.hop(cfg)
    for row, n, u in zip(audio, frames, ids):
        got = row[:n * hop]
        with torch.no_grad():
            want = ref.synthesize(w, cfg, u, scale).numpy()
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
        v = compare.judge(w, cfg, u, scale, compare.pcm16(got))
        assert v.frames_ok and v.gap_lsb <= 1


def test_judge_catches_a_wrong_answer():
    cfg = micro_config()
    w = ref.Weights(weights.make(weights.layout(cfg), 7, "cpu"))
    u = frontend.text_to_ids("abcde fghij", serve.id_map(cfg))
    with torch.no_grad():
        good = compare.pcm16(ref.synthesize(w, cfg, u, 2.0).numpy())
    assert compare.judge(w, cfg, u, 2.0, good).gap_lsb == 0
    bad = good.copy()
    bad[len(bad) // 2] += 50
    assert compare.judge(w, cfg, u, 2.0, bad).gap_lsb == 50
    hop = compare.hop(cfg)
    assert not compare.judge(w, cfg, u, 2.0, good[:-hop]).frames_ok
