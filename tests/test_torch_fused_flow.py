"""Kernel B (the inverse coupling flow) against the JAX package.

The JAX side runs its Pallas kernel in interpret mode (``FORCE_INTERPRET``,
as tests/test_fused_flow.py does) and its XLA reverse path; the port's
``apply`` on a CPU tensor runs its plain version. A step-by-step emulation
of the CUDA kernel's launch sequence over the stacked spec (flips folded
into the weights, the last WaveNet layer widened to the res/skip split)
checks the spec layout the card reads, which the plain version never
touches.
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from phoonnx_tpu.models.vits import fused_flow as jax_fused_flow
from phoonnx_tpu.models.vits import model as jax_model
from phoonnx_tpu.models.vits import posterior as jax_posterior
from phoonnx_tpu_torch.models.vits import fused_flow, posterior

from tests.test_torch_infer import port_params, randomize_flow_post
from tests.test_voice_e2e import SMALL_HP

# f32 on both sides; measured max-abs difference ~1e-6 through 4 couplings
# of 4 WaveNet layers each. Summation order differs, nothing more.
TOL = 1e-5
# Against JAX the error grows with the value: on [8-lengths3] one element
# of magnitude ~1.8 differs by 1.03e-5 abs / 5.7e-6 rel (f32 summation
# order through 4 couplings), so the JAX comparison also scales by
# magnitude.
RTOL = 1e-5


@pytest.fixture(autouse=True)
def _interpret():
    jax_fused_flow.FORCE_INTERPRET = True
    try:
        yield
    finally:
        jax_fused_flow.FORCE_INTERPRET = False


def _models(gin):
    hp = SMALL_HP if not gin else dataclasses.replace(
        SMALL_HP, n_speakers=3, gin_channels=gin)
    jp = randomize_flow_post(jax_model.random_params(jax.random.PRNGKey(1), hp))
    tp, _ = port_params(jp, hp)
    return jp, tp


@pytest.fixture(scope="module")
def flows():
    return {gin: _models(gin) for gin in (0, 8)}


def _inputs(seed, lengths, t, c, gin):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((len(lengths), t, c)).astype(np.float32)
    mask = (np.arange(t)[None, :] < np.asarray(lengths)[:, None])
    mask = mask[..., None].astype(np.float32)
    g = None
    if gin:
        g = rng.standard_normal((len(lengths), 1, gin)).astype(np.float32)
    return x * mask, mask, g


def emulate_kernel(spec, x, x_mask, g=None):
    """The phases of csrc/fused_flow.cu over the stacked spec."""
    b, t, c = x.shape
    half, hidden = spec["half"], spec["hidden"]
    k, rate = spec["kernel_size"], spec["dilation_rate"]
    mask = x_mask
    g_all = fused_flow._speaker_terms(spec, g, b)
    out = x.clone()

    def tapconv(a, w, bias, dil):  # a [B, T, Cin], w [K, Cin, N]
        taps = w.shape[0]
        pad = (taps * dil - dil) // 2
        ap = torch.nn.functional.pad(a, (0, 0, pad, pad))
        y = bias.clone().expand(b, t, -1)
        for j in range(taps):
            y = y + ap[:, j * dil:j * dil + t] @ w[j]
        return y

    for f in range(spec["n_flows"]):
        src, dst = (half, 0) if f % 2 == 0 else (0, half)
        h = tapconv(out[..., src:src + half], spec["w_pre"][f][None],
                    spec["b_pre"][f][0], 1) * mask
        skip = torch.zeros(b, t, hidden)
        for i in range(spec["n_layers"]):
            x_in = tapconv(h, spec["w_in"][f, i], spec["b_in"][f, i, 0],
                           rate ** i)
            if g_all is not None:
                x_in = x_in + g_all[:, f, i][:, None]
            # the spec interleaves the gate's halves: 2c tanh, 2c + 1 sigmoid
            acts = torch.tanh(x_in[..., 0::2]) \
                * torch.sigmoid(x_in[..., 1::2])
            rs = tapconv(acts, spec["w_rs"][f, i][None],
                         spec["b_rs"][f, i, 0], 1)
            h = (h + rs[..., :hidden]) * mask
            skip = skip + rs[..., hidden:]
        m = tapconv(skip * mask, spec["w_post"][f][None],
                    spec["b_post"][f][0], 1)
        out[..., dst:dst + half] = (out[..., dst:dst + half] - m) * mask
    return out


@pytest.mark.parametrize("gin,lengths", [(0, [40, 27]), (0, [13]),
                                         (8, [40, 33]), (8, [40, 40, 9])])
def test_reverse_matches_jax(flows, gin, lengths):
    jp, tp = flows[gin]
    x, mask, g = _inputs(len(lengths) + gin, lengths, 40,
                         SMALL_HP.inter_channels, gin)
    jg = None if g is None else jnp.asarray(g)
    tg = None if g is None else torch.from_numpy(g)
    want_xla = np.asarray(jax_posterior.coupling_flow(
        jp["flow"], jnp.asarray(x), jnp.asarray(mask), g=jg, reverse=True))
    jspec = jax_fused_flow.build_spec(jp["flow"])
    want_kernel = np.asarray(jax_fused_flow.apply(
        jspec, jnp.asarray(x), jnp.asarray(mask), g=jg))

    spec = fused_flow.build_spec(tp["flow"])
    got = fused_flow.apply(spec, torch.from_numpy(x), torch.from_numpy(mask),
                           g=tg).numpy()
    np.testing.assert_allclose(got, want_kernel, atol=TOL, rtol=RTOL)
    np.testing.assert_allclose(got, want_xla, atol=TOL, rtol=RTOL)
    # the routed entry point takes the same path
    routed = posterior.coupling_flow(
        dict(tp["flow"], fused_rev=spec), torch.from_numpy(x),
        torch.from_numpy(mask), g=tg, reverse=True).numpy()
    np.testing.assert_array_equal(routed, got)
    assert np.abs(got - x).max() > 1e-2  # the couplings are not identities


@pytest.mark.parametrize("gin", [0, 8])
def test_stacked_spec_emulation_matches_plain(flows, gin):
    _, tp = flows[gin]
    x, mask, g = _inputs(7, [40, 22], 40, SMALL_HP.inter_channels, gin)
    tg = None if g is None else torch.from_numpy(g)
    spec = fused_flow.build_spec(tp["flow"])
    want = fused_flow.plain(spec, torch.from_numpy(x), torch.from_numpy(mask),
                            g=tg)
    got = emulate_kernel(spec, torch.from_numpy(x), torch.from_numpy(mask),
                         g=tg)
    # measured max-abs 7.3e-6 here (gin 8; 6.8e-6 without g): 1.4x headroom
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=TOL, rtol=0)


def test_speaker_term_checks(flows):
    _, tp = flows[8]
    spec = fused_flow.build_spec(tp["flow"])
    with pytest.raises(ValueError, match="no g"):
        fused_flow._speaker_terms(spec, None, 1)
    _, tp0 = flows[0]
    spec0 = fused_flow.build_spec(tp0["flow"])
    with pytest.raises(ValueError, match="without gin"):
        fused_flow._speaker_terms(spec0, torch.zeros(1, 1, 8), 1)


def test_cpu_call_counts_no_launch(flows):
    _, tp = flows[0]
    spec = fused_flow.build_spec(tp["flow"])
    before = fused_flow.launches
    x, mask, _ = _inputs(0, [10], 10, SMALL_HP.inter_channels, 0)
    fused_flow.apply(spec, torch.from_numpy(x), torch.from_numpy(mask))
    assert fused_flow.launches == before
