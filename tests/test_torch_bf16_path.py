"""bf16 synthesis, the whole path: the port's ``model.infer`` and engine
in bfloat16 against the JAX package's on the CPU.

JAX ``infer`` runs as its engine serves bf16: every floating parameter
cast, kernels A, B and C attached (C at r = 1, what its CPU decoder runs)
in interpret mode (``FORCE_INTERPRET``). The port runs the kernels' bf16
plain versions (``tests/test_torch_bf16.py`` holds them one by one).
Weights and inputs as there: random parameters with weight norm folded in
float32, inputs from a seed with numpy. Then the engine in bf16 on the
CPU: its parameters, its distance from the float32 engine, fused against
two-phase, a stream against its request, and the int16 conversion.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from phoonnx_tpu.infer.engine import cast_floating as jax_cast
from phoonnx_tpu.models.vits import duration as jax_duration
from phoonnx_tpu.models.vits import fused_stage as jax_fused_stage
from phoonnx_tpu.models.vits import model as jax_model
from phoonnx_tpu.models.vits import transforms as jax_transforms
from phoonnx_tpu.models.vits import modules as jax_modules
from phoonnx_tpu_torch.infer import VitsEngine
from phoonnx_tpu_torch.infer.engine import to_pcm16
from phoonnx_tpu_torch.models.vits import model as port_model
from phoonnx_tpu_torch.models.vits import nn
from phoonnx_tpu_torch.models.vits import transforms as port_transforms

from tests.test_torch_bf16 import (BF, HP, JBF, _mask, as_np, bf,
                                   make_models)
# autouse: the JAX kernels in interpret mode
from tests.test_torch_bf16 import _interpret  # noqa: F401
from tests.test_torch_train_forward import one_torch_thread  # noqa: F401

# the bf16 path against JAX's on the valid waveform (peaks ~0.06-0.14): one or
# two bf16 steps at that magnitude; measured 8.5e-4 and 7.3e-4
PATH_TOL = 5e-3

@pytest.fixture(scope="module")
def models():
    """A single-speaker model."""
    return make_models(HP, 1)


# ---------------------------------------------------------------------------
# the whole path
# ---------------------------------------------------------------------------


def jax_kernel_params(jp, dtype, tail=True):
    """JAX params as its engine serves them in ``dtype``: cast, the
    encoder and flow specs attached, kernel C's specs at r = 1 (what the
    CPU decoder runs), with the HiFi-GAN generator's tail on the last
    stage (``tail``; an iSTFT decoder has none)."""
    params = jax_model.attach_fused_specs(jax_cast(jp, dtype))
    dec = dict(params["dec"])
    nk, n = dec["num_kernels"], len(dec["ups"])
    dec["fused_stages"] = tuple(
        jax_fused_stage.build_group_spec(
            dec["resblocks"][i * nk:(i + 1) * nk], 1, jax_modules.LRELU_SLOPE,
            post=(dec["conv_post"]["weight"], dec["conv_post"].get("bias"),
                  3, 0.01) if tail and i == n - 1 else None)
        for i in range(n))
    return dict(params, dec=dec)


_jax_infer = jax.jit(jax_model.infer, static_argnums=(1, 4))

# bf16 steps of logw a duration must keep from an integer so that ceil()
# agrees across runtimes: a step of logw (2^-8 of |logw|) moves
# w = exp(logw) by w |logw| 2^-8; the port's and JAX's bf16 durations
# were measured up to 2.0 such steps apart
DURATION_STEPS = 3


def check_infer_bf16(jp, tp, hp, thp, seed, lengths, t_x=15,
                     max_frames=160, monkeypatch=None):
    """Port ``model.infer`` in bf16 against JAX ``infer`` in bf16 with its
    kernels: equal frame counts, the valid waveform within PATH_TOL. With
    ``monkeypatch`` the port takes JAX's frames per text position (read
    from its alignment) in place of its own durations."""
    jparams = jax_kernel_params(jp, JBF, tail=hp.decoder_type != "istft")
    tparams = port_model.attach_fused_specs(nn.cast_floating(tp, BF))
    rng = np.random.default_rng(seed)
    b = len(lengths)
    ids = rng.integers(1, hp.n_vocab, (b, t_x)).astype(np.int32)
    lens = np.asarray(lengths, np.int32)
    dp_noise = rng.standard_normal((b, t_x, 2)).astype(np.float32)
    prior = rng.standard_normal((b, max_frames, hp.inter_channels)).astype(
        np.float32)
    scales = (0.667, 1.0, 0.8)
    j_audio, j_len, j_attn = _jax_infer(
        jparams, hp, jnp.asarray(ids), jnp.asarray(lens), max_frames,
        *scales, dp_noise=jnp.asarray(dp_noise),
        prior_noise=jnp.asarray(prior))
    ids_t, lens_t = torch.from_numpy(ids).long(), torch.from_numpy(lens)
    if monkeypatch is not None:
        # the alignment's columns sum to the frames of each text position
        # while no utterance reaches the frame budget
        assert np.all(np.asarray(j_len) < max_frames)
        w_ceil = torch.from_numpy(as_np(j_attn).sum(axis=1))
        monkeypatch.setattr(port_model, "_durations",
                            lambda *args, **kw: w_ceil)
    t_audio, t_len, _ = port_model.infer(
        tparams, thp, ids_t, lens_t, max_frames, *scales,
        dp_noise=torch.from_numpy(dp_noise), prior_noise=torch.from_numpy(
            prior))
    assert t_audio.dtype == BF
    if monkeypatch is None:
        # no duration within bf16 rounding of an integer (else ceil()
        # could flip between the runtimes and show as a length mismatch)
        mask = nn.sequence_mask(lens_t, t_x)[..., None].to(BF)
        x, _, _ = port_model.encoder.text_encoder(tparams["enc_p"], ids_t,
                                                  mask)
        logw = port_model.duration.sdp_reverse(
            tparams["dp"], x, mask, bf(dp_noise) * scales[2])
        logw = logw.float()[..., 0].numpy()
        w = np.exp(logw) * scales[1]
        step = np.maximum(w * np.abs(logw) * 2.0 ** -8, 1e-6)
        valid = mask[..., 0].float().numpy() > 0
        assert np.all((np.abs(w - np.round(w))
                       > DURATION_STEPS * step)[valid]), \
            "a duration lies within bf16 rounding of an integer: other inputs"

    np.testing.assert_array_equal(t_len.numpy(), np.asarray(j_len))
    hop = thp.total_upsample
    j_audio = as_np(j_audio)
    worst = 0.0
    for i, n in enumerate(np.asarray(j_len)):
        err = np.abs(as_np(t_audio)[i, :n * hop] - j_audio[i, :n * hop])
        assert err.max() <= PATH_TOL, (i, err.max())
        assert np.all(np.isfinite(as_np(t_audio)[i]))
        worst = max(worst, err.max())
    return worst


# inputs whose durations keep DURATION_STEPS from an integer (seeds 0-2
# come closer)
@pytest.mark.parametrize("seed,lengths", [(3, [15, 8, 11]), (4, [13, 15, 6])])
def test_infer_bf16_matches_jax(models, seed, lengths):
    jp, tp, thp = models
    check_infer_bf16(jp, tp, HP, thp, seed, lengths)


@pytest.fixture(scope="module")
def random_flows():
    """The single-speaker model with the duration predictor's flows random,
    as ``train_forward.make_models`` leaves them (a trained voice's are not
    zero)."""
    return make_models(HP, 1, fresh_flows=False)


_jax_sdp = jax.jit(jax_duration.sdp_reverse)

# the port's bf16 duration error against the float32 truth may be at most
# this many times JAX's (the same order: both round the same tensors to
# bf16, one step apart in places, which these flows amplify alike)
SDP_ROOM = 1.25


def test_sdp_bf16_random_flows_against_float32_truth(random_flows):
    """With random flows the duration predictor is ill-conditioned in bf16
    (``tests.test_torch_bf16.fresh_sdp``): the two frameworks' bf16
    log-durations part, so each is held against the float32 truth on the
    same bf16 weights and inputs, which JAX and the port agree on (the
    witness), and the port's error against JAX's over seeds 0-7."""
    jp, tp, _ = random_flows
    jdp, tdp = jax_cast(jp["dp"], JBF), nn.cast_floating(tp["dp"], BF)
    jdp32 = jax_cast(jdp, jnp.float32)
    tdp32 = nn.cast_floating(tdp, torch.float32)
    errs, witness = [], 0.0
    for seed in range(8):
        rng = np.random.default_rng(seed)
        lengths = rng.integers(5, 16, 3)
        ids = torch.from_numpy(rng.integers(1, HP.n_vocab, (3, 15)))
        z = as_np(bf(rng.standard_normal((3, 15, 2)).astype(np.float32)
                     * 0.8))
        mask = _mask(lengths, 15)
        x = port_model.encoder.text_encoder(tp["enc_p"], ids,
                                            torch.from_numpy(mask))[0]
        x = as_np(x.to(BF))
        truth = as_np(port_model.duration.sdp_reverse(
            tdp32, *map(torch.from_numpy, (x, mask, z))))[..., 0]
        j_truth = as_np(_jax_sdp(jdp32, *map(jnp.asarray, (x, mask, z))))
        # the witness: the float32 truth does not depend on the framework
        witness = max(witness, np.abs(j_truth[..., 0] - truth).max())
        assert witness <= 1e-4, witness
        got = as_np(port_model.duration.sdp_reverse(
            tdp, *map(bf, (x, mask, z))))[..., 0]
        want = as_np(_jax_sdp(jdp, *(jnp.asarray(a, JBF)
                                     for a in (x, mask, z))))[..., 0]
        valid = mask[..., 0] > 0

        def total(logw):
            return np.sum(np.exp(logw) * valid, axis=1)

        errs.append([np.abs(got - truth)[valid].mean(),
                     np.abs(want - truth)[valid].mean(),
                     np.max(np.abs(total(got) / total(truth) - 1)),
                     np.max(np.abs(total(want) / total(truth) - 1)),
                     np.abs(got - truth)[valid].max(),
                     np.abs(want - truth)[valid].max()])
    print(f"JAX's float32 log-durations against the port's: {witness:.2e}")
    print("seed, port / JAX against the float32 truth: mean and max "
          "|log-duration error|, largest relative error of an utterance's "
          "summed durations")
    for seed, e in enumerate(errs):
        print(f"{seed} mean {e[0]:.4f} / {e[1]:.4f} max {e[4]:.4f} / "
              f"{e[5]:.4f} total {e[2]:.4f} / {e[3]:.4f}")
    # means over the seeds of the mean log-duration error and of the
    # largest relative error of an utterance's summed durations; measured
    # port 0.0306 and 0.0643, JAX 0.0404 and 0.0661 (per seed: JAX 0.017-
    # 0.110 and 0.006-0.302, the port 0.018-0.050 and 0.019-0.128)
    port_logw, jax_logw, port_total, jax_total = np.mean(errs, axis=0)[:4]
    assert port_logw <= SDP_ROOM * jax_logw, (port_logw, jax_logw)
    assert port_total <= SDP_ROOM * jax_total, (port_total, jax_total)


def test_sdp_spline_bf16_matches_jax():
    """The duration predictor's inverse spline on bf16 inputs computes in
    float32 on both sides and rounds once: within one bf16 step of JAX's
    (measured 0). The random-flow test above cannot tell this apart from
    a spline in bf16 (one more rounding in an ill-conditioned chain), nor
    can the whole-path test, whose flows at 0 make the spline smooth."""
    rng = np.random.default_rng(5)
    bins = 10
    x = as_np(bf(rng.standard_normal((3, 15, 1)).astype(np.float32) * 2))
    h = as_np(bf(rng.standard_normal((3, 15, 1, 3 * bins - 1)).astype(
        np.float32) * 2))
    parts = (x, h[..., :bins], h[..., bins:2 * bins], h[..., 2 * bins:])
    kw = dict(inverse=True, tails="linear", tail_bound=5.0)
    want, want_det = (as_np(a) for a in
                      jax_transforms.piecewise_rational_quadratic_transform(
                          *(jnp.asarray(a, JBF) for a in parts), **kw))
    got, got_det = port_transforms.piecewise_rational_quadratic_transform(
        *map(bf, parts), **kw)
    assert got.dtype == got_det.dtype == BF
    for g, w in ((got, want), (got_det, want_det)):
        err = np.abs(as_np(g) - w).max() / max(1.0, np.abs(w).max())
        assert err <= 2.0 ** -8, err


@pytest.mark.parametrize("seed,lengths", [(0, [15, 8, 11]), (1, [13, 15, 6])])
def test_infer_bf16_random_flows_given_reference_durations(
        random_flows, monkeypatch, seed, lengths):
    """The rest of the path on the random-flow model, the port given JAX's
    frames per text position: equal frame counts and the waveform within
    PATH_TOL of JAX's bf16 (measured 6.1e-4 and 7.3e-4)."""
    jp, tp, thp = random_flows
    check_infer_bf16(jp, tp, HP, thp, seed, lengths, monkeypatch=monkeypatch)


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def engines(models):
    _, tp, thp = models
    return {dtype: VitsEngine(tp, thp, dtype=dtype, device="cpu",
                              text_buckets=(16, 32), frame_buckets=(64, 128,
                                                                    256))
            for dtype in ("float32", "bfloat16")}


UTTS = [[3, 7, 9, 11, 2, 5, 6, 8, 10, 4, 12, 13],
        [4, 6, 8, 2, 9, 12, 14, 5, 3, 7, 1, 2, 5, 8, 9, 10, 11, 12, 3, 4]]


def test_engine_parameters_are_bf16(engines):
    eng = engines["bfloat16"]
    assert eng.dtype == BF
    found = set()

    def walk(tree):
        if isinstance(tree, dict):
            for v in tree.values():
                walk(v)
        elif isinstance(tree, (list, tuple)):
            for v in tree:
                walk(v)
        elif isinstance(tree, torch.Tensor) and tree.is_floating_point():
            found.add(tree.dtype)

    walk(eng.params)
    assert found == {BF}
    assert eng._scales(0.667, 1.0, 0.8).dtype == BF


def test_engine_bf16_near_float32(engines):
    """One seed, both dtypes: the same noise (drawn in float32), the same
    frame counts, audio a few bf16 steps apart (measured 8.9e-4 on a
    peak of 0.06)."""
    audio = {d: e.synthesize_ids(UTTS[1], seed=5) for d, e in
             engines.items()}
    assert audio["bfloat16"].dtype == np.float32
    assert audio["bfloat16"].shape == audio["float32"].shape
    err = np.abs(audio["bfloat16"] - audio["float32"]).max()
    assert err <= 5e-3, err


# fused against two-phase and a stream against its request in bf16: the
# same plain ops on other frame buckets and windows, so float32 sums that
# land on another side of a bf16 rounding; measured 0 and 0
MODE_TOL = 5e-3


@pytest.mark.parametrize("batch", [1, 2])
def test_bf16_fused_equals_two_phase(engines, models, batch):
    _, tp, thp = models
    fused = VitsEngine(tp, thp, dtype="bfloat16", mode="fused",
                       device="cpu", text_buckets=(16, 32),
                       frame_buckets=(64, 128, 256))
    utts = UTTS[:batch]
    a, n_a = engines["bfloat16"].synthesize_batch(utts, seed=3)
    f, n_f = fused.synthesize_batch(utts, seed=3)
    assert n_a == n_f
    up = thp.total_upsample
    for i, n in enumerate(n_a):
        err = np.abs(a[i, :n * up] - f[i, :n * up]).max()
        assert err <= MODE_TOL, (i, err)


def test_bf16_stream_equals_request(engines):
    eng = engines["bfloat16"]
    whole = eng.synthesize_ids(UTTS[1], seed=9)
    parts = list(eng.synthesize_ids_streaming(UTTS[1], chunk_frames=8,
                                              overlap_frames=8, seed=9))
    stream = np.concatenate(parts)
    assert len(parts) > 1 and stream.shape == whole.shape
    assert np.abs(stream - whole).max() <= MODE_TOL


def test_pcm16_of_bf16_audio_goes_through_float32():
    """bf16 audio quantised in float32 (the port) equals the float32
    conversion of the same values; the JAX engine's ``_to_pcm16``
    multiplies in bf16, where samples above 0.5 come in steps of up to
    128 (``phoonnx_tpu/infer/engine.py:384-385``)."""
    audio = torch.linspace(-1.0, 1.0, 4001).to(BF)
    got = to_pcm16(audio)
    want = to_pcm16(audio.float())
    assert torch.equal(got, want)
    in_bf16 = torch.clamp(audio * 32767.0, -32767.0, 32767.0).to(
        torch.int16)
    assert not torch.equal(got, in_bf16)
    big = audio.float().abs() > 0.5
    assert (got.int() - in_bf16.int())[big].abs().max() > 1
