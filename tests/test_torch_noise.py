"""The engine's noise (``phoonnx_tpu_torch.ops.noise``), on the CPU.

The noise kernel's plain version against the properties the engine
relies on: a draw of n rows is the first n rows of a longer one, a lane
of a batch is the one-lane draw at its seed, two draws of one seed and
two neighbouring seeds are independent, masked rows are 0 and every value
is finite, the moments are a standard normal's, and a bfloat16 draw is the
float32 draw rounded. Then the CPU engine: one seed gives the same audio
through every mode, and ``synthesize_batch`` makes no host generator.
``tests/test_torch_cuda.py`` holds the kernel to the plain version on the
card.
"""

import math
from unittest import mock

import numpy as np
import pytest
import torch

from phoonnx_tpu_torch.infer import VitsEngine
from phoonnx_tpu_torch.models.vits.model import VitsHParams, random_params
from phoonnx_tpu_torch.ops import noise

# a large seed, past 2**32: the key's high word matters
SEED = 3_000_000_081 + 2 ** 32
N_SAMPLES = 10 ** 6

# Random123's known answers for Philox4x32-10 (counter, key, words)
KNOWN = [((0, 0, 0, 0), (0, 0),
          (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
         ((0xFFFFFFFF,) * 4, (0xFFFFFFFF,) * 2,
          (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
         ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344),
          (0xA4093822, 0x299F31D0),
          (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1))]


def test_philox_known_answers():
    ctr = torch.tensor([c for c, _, _ in KNOWN])
    key = torch.tensor([k for _, k, _ in KNOWN])
    assert noise.philox(ctr, key).tolist() == [list(w) for _, _, w in KNOWN]


@pytest.mark.parametrize(
    "channels,short,long",
    [(c, n, m) for c in (192, 96, 32)
     for n, m in ((1, 2), (5, 300), (37, 38), (128, 4096))]
    + [(c, 5, 11) for c in (3, 8, 20)])
def test_a_short_draw_is_a_prefix(channels, short, long):
    """Fused mode and streaming draw the prior before the frame count is
    known: a draw of n rows is the first n rows of any longer draw at the
    same width, for both tags."""
    for tag in (noise.DURATION, noise.PRIOR):
        a = noise.normal_plain(SEED + short, 1, short, channels, tag)
        b = noise.normal_plain(SEED + short, 1, long, channels, tag)
        assert a.shape == (1, short, channels)
        assert torch.equal(a, b[:, :short]), (tag, channels, short, long)


def test_alone_equals_in_a_batch():
    """Lane i of a batch at ``seed`` is the one-lane draw at ``seed + i``,
    also across the key's low word wrapping into its high word."""
    for seed in (SEED, 2 ** 32 - 2):
        batch = noise.normal_plain(seed, 5, 33, 192, noise.PRIOR)
        for i in range(5):
            assert torch.equal(batch[i], noise.normal_plain(
                seed + i, 1, 33, 192, noise.PRIOR)[0]), (seed, i)


def _corr(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.double().flatten(), b.double().flatten()
    a, b = a - a.mean(), b - b.mean()
    return float((a @ b) / (a.norm() * b.norm()))


def test_draws_are_independent():
    """The duration draw (the engine's width 2) and the prior draw (width
    192) of one seed, and the prior draws of two neighbouring seeds,
    differ and are uncorrelated: |r| under 5/sqrt(n) over n = 10**6
    samples."""
    n = N_SAMPLES
    duration = noise.normal_plain(SEED, 1, n // 2, 2, noise.DURATION)
    pair = noise.normal_plain(SEED, 2, -(-n // 192), 192,
                              noise.PRIOR).flatten(1)[:, :n]
    for a, b, what in ((duration.flatten(), pair[0], "tags"),
                       (pair[0], pair[1], "seeds")):
        assert a.numel() == b.numel() == n
        assert not torch.equal(a, b), what
        assert abs(_corr(a, b)) < 5 / math.sqrt(n), what


def test_masking_and_finiteness():
    """Rows past each lane's length are exactly 0, rows before it are the
    unmasked draw; at the extreme words 0 and 0xffffffff every normal is
    finite (u lies in (0, 1]), and no normal exceeds the radius of the
    least u, sqrt(2 * 24 * ln 2)."""
    lengths = torch.tensor([0, 3, 17, 40], dtype=torch.int32)
    full = noise.normal_plain(SEED, 4, 17, 20, noise.PRIOR)
    masked = noise.normal_plain(SEED, 4, 17, 20, noise.PRIOR, lengths)
    for b, n in enumerate(lengths.tolist()):
        n = min(n, 17)
        assert torch.equal(masked[b, :n], full[b, :n])
        assert torch.equal(masked[b, n:], torch.zeros_like(masked[b, n:]))
    # lengths as the engine may hand them: a list of ints
    assert torch.equal(noise.normal(SEED, 4, 17, 20, noise.PRIOR, "cpu",
                                    [0, 3, 17, 40]), masked)
    lo, hi = 0, 0xFFFFFFFF
    words = torch.tensor([[a, b, c, d] for a in (lo, hi) for b in (lo, hi)
                          for c in (lo, hi) for d in (lo, hi)])
    z = noise.box_muller(words)
    assert bool(torch.isfinite(z).all())
    radius = math.sqrt(2 * 24 * math.log(2))
    assert float(z.abs().max()) <= radius * (1 + 1e-6)
    assert float(z.abs().max()) > radius * (1 - 1e-6)  # u = 2**-24 reached
    # u = 1 (the largest word) gives the radius 0
    assert float(z[-1].abs().max()) == 0.0
    every = noise.normal_plain(SEED, 2, 4096, 192, noise.PRIOR)
    assert bool(torch.isfinite(every).all())


def test_moments_are_a_standard_normal():
    rows = -(-N_SAMPLES // 192)
    z = noise.normal_plain(SEED, 1, rows, 192, noise.PRIOR).double()
    n = z.numel()
    mean = float(z.mean())
    var = float(z.var())
    kurt = float(((z - mean) ** 4).mean()) / var ** 2
    assert abs(mean) < 5 / math.sqrt(n), mean
    assert abs(var - 1) < 0.01, var
    assert abs(kurt - 3) < 0.05, kurt


def test_bf16_is_the_f32_draw_rounded():
    lengths = torch.tensor([9, 30], dtype=torch.int32)
    f32 = noise.normal_plain(SEED, 2, 30, 192, noise.PRIOR, lengths)
    bf16 = noise.normal_plain(SEED, 2, 30, 192, noise.PRIOR, lengths,
                              torch.bfloat16)
    assert bf16.dtype == torch.bfloat16
    assert torch.equal(bf16, f32.to(torch.bfloat16))


def test_draws_refuse_empty_shapes():
    with pytest.raises(ValueError, match="at least 1"):
        noise.normal_plain(0, 1, 0, 192, noise.PRIOR)
    with pytest.raises(ValueError, match="32-bit"):
        noise.normal_plain(0, 1, 4, 192, 2 ** 32)


# -- the engine on the CPU ---------------------------------------------------

TEXT_BUCKETS = (16, 32)
FRAME_BUCKETS = (64, 128, 256)
BATCH = [[3, 7, 9, 11, 2, 5, 6, 8, 10], [4, 6, 8, 2, 9, 12, 14, 5, 3, 7, 1, 2]]
# the same noise decoded at other text and frame buckets (the bound of
# tests/test_torch_engine.py's fused against two-phase)
MODE_TOL = 1e-4


@pytest.fixture(scope="module")
def micro():
    hp = VitsHParams.preset("micro", n_vocab=20)
    params = random_params(hp, torch.Generator().manual_seed(0))
    return {mode: VitsEngine(params, hp, text_buckets=TEXT_BUCKETS,
                             frame_buckets=FRAME_BUCKETS, mode=mode,
                             device="cpu")
            for mode in ("two_phase", "fused")}


def _lanes(audio, frames, up):
    return [audio[i, :n * up] for i, n in enumerate(frames)]


def test_one_seed_gives_one_audio_in_every_mode(micro):
    """A seeded batch through two phases equals itself through
    ``synthesize_many``, fused mode, each utterance alone and each
    utterance streamed, lane i at ``seed + i``."""
    eng = micro["two_phase"]
    up = eng.hp.total_upsample
    audio, frames = eng.synthesize_batch(BATCH, seed=SEED)
    want = _lanes(audio, frames, up)
    assert all(np.abs(w).max() > 0 for w in want)
    fused, fused_frames = micro["fused"].synthesize_batch(BATCH, seed=SEED)
    assert fused_frames == frames
    many = eng.synthesize_many(BATCH, seed=SEED)
    for i, (utt, w) in enumerate(zip(BATCH, want)):
        alone = eng.synthesize_ids(utt, seed=SEED + i)
        stream = np.concatenate(list(eng.synthesize_ids_streaming(
            utt, chunk_frames=8, overlap_frames=8, seed=SEED + i)))
        for name, got in (("fused", fused[i, :len(w)]), ("many", many[i]),
                          ("alone", alone), ("stream", stream)):
            assert got.shape == w.shape, (name, i)
            err = float(np.abs(got - w).max())
            assert err <= MODE_TOL, (name, i, err)


def test_batch_inputs_draw_on_the_engine(micro):
    """``_batch_inputs`` hands back the lanes' seeds and the duration draw
    (masked past each utterance); ``_prior`` the prior draw of the same
    seeds; ``synthesize_batch`` constructs no ``torch.Generator``."""
    eng = micro["two_phase"]
    ids, lengths, _, dp_noise, seeds = eng._batch_inputs(BATCH, None, SEED)
    assert seeds == range(SEED, SEED + 2)
    assert torch.equal(dp_noise, noise.normal_plain(
        SEED, 2, ids.shape[1], 2, noise.DURATION, lengths))
    assert torch.equal(dp_noise[0, len(BATCH[0]):],
                       torch.zeros_like(dp_noise[0, len(BATCH[0]):]))
    prior = eng._prior(seeds, torch.tensor([5, 70], dtype=torch.int32), 64)
    assert torch.equal(prior, noise.normal_plain(
        SEED, 2, 64, eng.hp.inter_channels, noise.PRIOR,
        torch.tensor([5, 64])))
    with mock.patch("torch.Generator", wraps=torch.Generator) as gen:
        eng.synthesize_batch(BATCH, seed=SEED)
        micro["fused"].synthesize_batch(BATCH, seed=SEED)
    assert gen.call_count == 0


def test_bf16_engine_draws_the_f32_noise_rounded(micro):
    eng = micro["two_phase"]
    bf16 = VitsEngine(eng.params, eng.hp, text_buckets=TEXT_BUCKETS,
                      frame_buckets=FRAME_BUCKETS, dtype="bfloat16",
                      device="cpu")
    f32_in = eng._batch_inputs(BATCH, None, SEED)
    bf16_in = bf16._batch_inputs(BATCH, None, SEED)
    assert bf16_in[3].dtype == torch.bfloat16
    assert torch.equal(bf16_in[3], f32_in[3].to(torch.bfloat16))
    seeds, frames = f32_in[4], [17, 40]
    assert torch.equal(bf16._prior(seeds, frames, 64),
                       eng._prior(seeds, frames, 64).to(torch.bfloat16))


def test_zero_noise_scales_give_finite_audio(micro):
    """The benchmark's traffic sends noise_scale and noise_w 0: the draw
    is still made, and no infinite normal turns the audio into NaN."""
    for eng in micro.values():
        audio, frames = eng.synthesize_batch(BATCH, noise_scale=0.0,
                                             noise_w=0.0, seed=SEED)
        assert bool(np.isfinite(audio).all()) and min(frames) > 0
