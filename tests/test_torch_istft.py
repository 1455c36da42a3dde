"""The port's iSTFT decoders against the JAX package's, on the CPU.

``ops/istft.py``, ``ops/pqmf.py`` and ``istft_decoder.istft_generator``
(one band and two) are held to the JAX functions on the same inputs, made
with numpy from seeds. The same weights reach both sides through
``params_to_flat`` -> the port's ``params_from_flat``. The JAX decoder runs
kernel C in interpret mode (``FORCE_INTERPRET``), as
tests/test_torch_fused_stage.py does; the port's wrapper on a CPU tensor
runs its plain version, the function the CUDA kernel is held to on the
card. Then ``model.infer`` at a micro iSTFT preset, the flat round trip and
one training step of each iSTFT family.

The weights are the port's ``random_params``, carried to a JAX tree by
keypath name (``tests.test_torch_train_forward.make_models``): building
the JAX tree by tracing costs a few seconds where eager JAX init costs
twenty on a fresh process.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from phoonnx_tpu.models.vits import fused_stage as jax_fused_stage
from phoonnx_tpu.models.vits import istft_decoder as jax_istft_decoder
from phoonnx_tpu.models.vits import model as jax_model
from phoonnx_tpu.models.vits import modules as jax_modules
from phoonnx_tpu.models.vits.model import VitsHParams
from phoonnx_tpu.ops import istft as jax_istft
from phoonnx_tpu.ops import pqmf as jax_pqmf
from phoonnx_tpu_torch.models.vits import fused_stage, istft_decoder
from phoonnx_tpu_torch.models.vits import model as port_model
from phoonnx_tpu_torch.models.vits.load import (infer_hparams_from_flat,
                                                params_to_flat)
from phoonnx_tpu_torch.ops import istft, pqmf
from phoonnx_tpu_torch.train import step

from tests.test_torch_infer import WAVE_TOL, port_hparams
from tests.test_torch_train_forward import make_models
from tests.test_torch_train_forward import one_torch_thread  # noqa: F401

# f32 on both sides, summed in other orders (a real inverse-DFT product
# against numpy's irfft, cuDNN-free CPU convs against XLA's): 1e-5.
TOL = 1e-5

# micro widths (stages of 16 and 8 channels) with the medium resblock
# group and two upsampling stages, as both iSTFT presets have
_MICRO = dict(n_vocab=40, decoder_type="istft", upsample_rates=(2, 2),
              upsample_kernel_sizes=(4, 4), istft_n_fft=16,
              resblock_kernel_sizes=(3, 5, 7),
              resblock_dilation_sizes=((1, 2), (2, 6), (3, 12)))
ISTFT_HP = VitsHParams.preset("micro", istft_hop=4, **_MICRO)
MB_HP = VitsHParams.preset("micro", istft_hop=2, istft_bands=2, **_MICRO)
HPS = {"istft": ISTFT_HP, "mb-istft": MB_HP}


def t(a):
    return torch.from_numpy(np.asarray(a))


# ---------------------------------------------------------------------------
# ops
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("lengths", [None, [37, 20, 5]])
def test_istft_matches_jax(lengths):
    rng = np.random.default_rng(0)
    mag = np.exp(rng.standard_normal((3, 37, 9))).astype(np.float32)
    # the phase head's range: DC and Nyquist get imaginary parts too
    phase = (np.pi * np.sin(rng.standard_normal((3, 37, 9)))).astype(
        np.float32)
    frame_lengths = None
    if lengths is not None:
        frame_lengths = np.asarray(lengths, np.int32)
        # the decoder zeroes the spectra past each element's frames
        keep = np.arange(37)[None, :] < frame_lengths[:, None]
        mag = mag * keep[..., None]
    want = np.asarray(jax_istft.istft(
        jnp.asarray(mag), jnp.asarray(phase), 16, 4, 16,
        None if lengths is None else jnp.asarray(frame_lengths)))
    got = istft.istft(t(mag), t(phase), 16, 4, 16,
                      None if lengths is None else t(frame_lengths)).numpy()
    assert got.shape == want.shape == (3, 36 * 4)
    np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL)


@pytest.mark.parametrize("n_bands", [2, 4, 8])
def test_pqmf_matches_jax(n_bands):
    ana, syn = pqmf.pqmf_filters(n_bands)
    j_ana, j_syn = jax_pqmf.pqmf_filters(n_bands)
    np.testing.assert_array_equal(ana, j_ana)
    np.testing.assert_array_equal(syn, j_syn)
    rng = np.random.default_rng(n_bands)
    x = rng.standard_normal((2, 40 * n_bands)).astype(np.float32)
    want = np.asarray(jax_pqmf.pqmf_analysis(jnp.asarray(x), ana, n_bands))
    got = pqmf.pqmf_analysis(t(x), ana, n_bands).numpy()
    assert got.shape == want.shape == (2, 40, n_bands)
    np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL)
    sub = rng.standard_normal((2, 40, n_bands)).astype(np.float32)
    want = np.asarray(jax_pqmf.pqmf_synthesis(jnp.asarray(sub), syn,
                                              n_bands))
    got = pqmf.pqmf_synthesis(t(sub), syn, n_bands).numpy()
    assert got.shape == want.shape == (2, 40 * n_bands)
    np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL)


@pytest.mark.parametrize("n_bands", [2, 4])
def test_pqmf_reconstructs(n_bands):
    """analysis -> synthesis gives the input back after taps // 2 samples,
    to the margin of tests/test_ops.py's JAX test."""
    ana, syn = pqmf.pqmf_filters(n_bands)
    x = np.random.default_rng(0).standard_normal(4096).astype(
        np.float32) * 0.3
    sub = pqmf.pqmf_analysis(t(x)[None], ana, n_bands)
    assert sub.shape == (1, 4096 // n_bands, n_bands)
    y = pqmf.pqmf_synthesis(sub, syn, n_bands).numpy()[0]
    assert y.shape == x.shape
    d = 31  # taps // 2 group delay
    assert np.abs(y[d:3500 + d] - x[:3500]).max() < 0.01


@pytest.mark.parametrize("n_bands", [2, 4])
def test_pqmf_synthesis_kernel_is_the_filters(n_bands):
    """The cached device kernel the decoder passes gives the same output
    as the numpy filters, and is built once."""
    cpu = torch.device("cpu")
    kernel = pqmf.synthesis_kernel(n_bands, cpu, torch.float32)
    assert pqmf.synthesis_kernel(n_bands, cpu, torch.float32) is kernel
    sub = t(np.random.default_rng(n_bands).standard_normal(
        (2, 40, n_bands)).astype(np.float32))
    _, syn = pqmf.pqmf_filters(n_bands)
    assert torch.equal(pqmf.pqmf_synthesis(sub, kernel, n_bands),
                       pqmf.pqmf_synthesis(sub, syn, n_bands))


def test_cached_constants_serve_training():
    """The iSTFT's and the PQMF bank's constants are built once a (size,
    device, dtype); built first in inference mode (a request), they still
    take part in a training step's backward."""
    cpu = torch.device("cpu")
    istft._constants.cache_clear()
    pqmf.synthesis_kernel.cache_clear()
    gen = torch.Generator().manual_seed(3)
    with torch.inference_mode():
        istft.istft(torch.rand(4, 10, 9, generator=gen),
                    torch.rand(4, 10, 9, generator=gen), 16, 4, 16)
        pqmf.synthesis_kernel(2, cpu, torch.float32)
    mag = torch.rand(4, 10, 9, generator=gen).requires_grad_()
    sub = istft.istft(mag, torch.rand(4, 10, 9, generator=gen), 16, 4, 16)
    audio = pqmf.pqmf_synthesis(
        sub.reshape(2, 2, -1).transpose(1, 2),
        pqmf.synthesis_kernel(2, cpu, torch.float32), 2)
    audio.square().sum().backward()
    assert torch.isfinite(mag.grad).all() and mag.grad.abs().sum() > 0
    assert istft._constants.cache_info().misses == 1
    assert pqmf.synthesis_kernel.cache_info().misses == 1


# ---------------------------------------------------------------------------
# the decoder
# ---------------------------------------------------------------------------


def detached(tree):
    """A parameter tree without autograd, for inference."""
    if isinstance(tree, dict):
        return {k: detached(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [detached(v) for v in tree]
    return tree.detach() if isinstance(tree, torch.Tensor) else tree


def both_models(family):
    """(JAX generator params, port generator params) with equal weights."""
    jg, _, tg, _, _ = make_models(HPS[family])
    return jg, detached(tg)


@pytest.fixture(scope="module")
def decoders():
    """{family: (JAX dec with kernel C specs at r = 1, port dec)}."""
    out = {}
    for name in HPS:
        jp, tp = both_models(name)
        jdec = dict(jp["dec"])
        nk = jdec["num_kernels"]
        jdec["fused_stages"] = tuple(
            jax_fused_stage.build_group_spec(
                jdec["resblocks"][i * nk:(i + 1) * nk], 1,
                jax_modules.LRELU_SLOPE)
            for i in range(len(jdec["ups"])))
        out[name] = (jdec, tp["dec"])
    return out


@pytest.fixture
def interpret():
    jax_fused_stage.FORCE_INTERPRET = True
    try:
        yield
    finally:
        jax_fused_stage.FORCE_INTERPRET = False


def _latents(seed, b, frames, channels):
    return (np.random.default_rng(seed).standard_normal(
        (b, frames, channels)) * 0.5).astype(np.float32)


@pytest.mark.parametrize("family", ["istft", "mb-istft"])
def test_generator_matches_jax_kernel(decoders, interpret, family):
    jdec, tdec = decoders[family]
    hp = HPS[family]
    z = _latents(1, 2, 24, hp.inter_channels)
    lengths = np.asarray([24, 15], np.int32)
    z[1, 15:] = 0.0
    # one compiled program: eager interpret mode takes 3x as long
    want = np.asarray(jax.jit(
        lambda z, n: jax_istft_decoder.istft_generator(
            jdec, z, frame_lengths=n))(jnp.asarray(z), jnp.asarray(lengths)))
    got = istft_decoder.istft_generator(tdec, t(z),
                                        frame_lengths=t(lengths)).numpy()
    up = hp.total_upsample
    assert got.shape == want.shape == (2, 24 * up)
    for i, n in enumerate(lengths):
        np.testing.assert_allclose(got[i, :n * up], want[i, :n * up],
                                   atol=TOL, rtol=TOL)


@pytest.mark.parametrize("family", ["istft", "mb-istft"])
def test_padded_batch_equals_exact_decodes(decoders, family):
    _, tdec = decoders[family]
    hp = HPS[family]
    up = hp.total_upsample
    z = _latents(2, 3, 30, hp.inter_channels)
    lengths = [30, 17, 6]
    for i, n in enumerate(lengths):
        z[i, n:] = 0.0  # the latents past an utterance are 0 (z * y_mask)
    z = t(z)
    padded = istft_decoder.istft_generator(
        tdec, z, frame_lengths=torch.tensor(lengths, dtype=torch.int32))
    for i, n in enumerate(lengths):
        alone = istft_decoder.istft_generator(tdec, z[i:i + 1, :n])
        assert alone.shape == (1, n * up)
        np.testing.assert_allclose(padded[i, :n * up].numpy(),
                                   alone[0].numpy(), atol=TOL, rtol=0)


def test_generator_specs_have_no_tail(decoders):
    _, tdec = decoders["istft"]
    specs = istft_decoder.build_stage_specs(tdec)
    assert len(specs) == len(tdec["ups"]) == 2
    assert not any("postW" in s for s in specs)
    assert [s["W"].shape[1] for s in specs] == [16, 8]


def test_cpu_decode_launches_no_kernel(decoders):
    _, tdec = decoders["mb-istft"]
    before = fused_stage.launches
    istft_decoder.istft_generator(tdec, t(_latents(3, 1, 8, 32)))
    assert fused_stage.launches == before


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------


_jax_infer = jax.jit(jax_model.infer, static_argnums=(1, 4))


@pytest.mark.parametrize("family", ["istft", "mb-istft"])
def test_infer_matches_jax(family):
    hp = HPS[family]
    jp, tp = both_models(family)
    thp = port_hparams(hp)
    tp = port_model.attach_fused_specs(tp)
    rng = np.random.default_rng(7)
    lengths, t_x, max_frames = [11, 6], 11, 96
    ids = rng.integers(1, hp.n_vocab, (2, t_x)).astype(np.int32)
    lens = np.asarray(lengths, np.int32)
    dp_noise = rng.standard_normal((2, t_x, 2)).astype(np.float32)
    prior = rng.standard_normal((2, max_frames, hp.inter_channels)).astype(
        np.float32)
    scales = (0.667, 1.0, 0.8)
    j_audio, j_len, _ = _jax_infer(
        jp, hp, jnp.asarray(ids), jnp.asarray(lens), max_frames, *scales,
        dp_noise=jnp.asarray(dp_noise), prior_noise=jnp.asarray(prior))
    t_audio, t_len, _ = port_model.infer(
        tp, thp, t(ids).long(), t(lens), max_frames, *scales,
        dp_noise=t(dp_noise), prior_noise=t(prior))
    np.testing.assert_array_equal(t_len.numpy(), np.asarray(j_len))
    assert t_audio.shape == j_audio.shape == (2, max_frames * 16)
    up = thp.total_upsample
    for i, n in enumerate(np.asarray(j_len)):
        err = np.abs(t_audio[i, :n * up].numpy()
                     - np.asarray(j_audio)[i, :n * up])
        assert err.max() < WAVE_TOL, (i, err.max())


@pytest.mark.parametrize("family,n_fft,bands", [("istft", 16, 1),
                                                ("mb-istft", 16, 2)])
def test_flat_round_trip_reads_the_decoder(family, n_fft, bands):
    hp = port_hparams(HPS[family])
    flat = params_to_flat(port_model.random_params(
        hp, torch.Generator().manual_seed(0)))
    assert flat["dec.conv_mag.weight"].shape[0] == bands * 9
    assert "dec.conv_post.weight" not in flat
    got = infer_hparams_from_flat(flat)
    assert (got.decoder_type, got.istft_n_fft, got.istft_bands) == (
        "istft", n_fft, bands)
    assert got.upsample_rates == hp.upsample_rates


@pytest.mark.parametrize("family", ["istft", "mb-istft"])
def test_one_train_step(family):
    """The counterparts of tests/test_train_pipeline.py's iSTFT and
    MB-iSTFT steps: finite losses, parameters moved, no kernel launched."""
    hp = port_hparams(HPS[family])
    assert hp.total_upsample == hp.hop_length
    cfg = step.TrainConfig(steps_per_epoch=3, disc_periods=(2,),
                           disc_channel_scale=4)
    state = step.init_train_state(hp, cfg, torch.Generator().manual_seed(0))
    before = [p.detach().clone() for p in step.leaves(state.params_g)]
    heads = {name: state.params_g["dec"][name]["weight"].detach().clone()
             for name in ("conv_mag", "conv_phase")}
    rng = np.random.default_rng(0)
    t_x, t_y = 8, 32
    batch = {
        "phoneme_ids": t(rng.integers(1, 40, (2, t_x))).long(),
        "phoneme_lengths": torch.tensor([8, 6], dtype=torch.int32),
        "spec": t((rng.standard_normal((2, t_y, hp.spec_channels)) ** 2
                   ).astype(np.float32)),
        "spec_lengths": torch.tensor([32, 28], dtype=torch.int32),
        "audio": t((rng.standard_normal((2, t_y * hp.hop_length)) * 0.1
                    ).astype(np.float32)),
    }
    launches = fused_stage.launches
    state, metrics = step.train_step(state, batch, hp, cfg,
                                     generator=torch.Generator().manual_seed(1))
    assert fused_stage.launches == launches
    assert all(np.isfinite(float(v)) for v in metrics.values())
    after = step.leaves(state.params_g)
    moved = sum(not torch.equal(a, b.detach()) for a, b in zip(before, after))
    assert moved > len(after) // 2
    for name, weight in heads.items():
        assert not torch.equal(state.params_g["dec"][name]["weight"].detach(),
                               weight), name
