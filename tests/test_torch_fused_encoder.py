"""Kernel A (the text-encoder stack) against the JAX package.

The JAX side runs its Pallas kernel in interpret mode (``FORCE_INTERPRET``,
as tests/test_fused_encoder.py does) and its XLA layer stack; the port's
``apply`` on a CPU tensor runs its plain version. A step-by-step emulation
of the CUDA kernel's launch sequence over the stacked spec (fused QKV
projection, banded relative terms, padded keys at -1e4) checks the spec
layout the card reads, which the plain version never touches.
"""

import dataclasses
import math

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from phoonnx_tpu.models.vits import attention as jax_attention
from phoonnx_tpu.models.vits import fused_encoder as jax_fused_encoder
from phoonnx_tpu.models.vits import model as jax_model
from phoonnx_tpu_torch.models.vits import attention, encoder, fused_encoder

from tests.test_torch_infer import port_params
from tests.test_voice_e2e import SMALL_HP

# f32 on both sides; measured max-abs difference ~1e-6 through 3 layers
# (softmax and LayerNorm summed in another order), nothing more.
TOL = 1e-5

HP = dataclasses.replace(SMALL_HP, n_layers=3)


@pytest.fixture(autouse=True)
def _interpret():
    jax_fused_encoder.FORCE_INTERPRET = True
    try:
        yield
    finally:
        jax_fused_encoder.FORCE_INTERPRET = False


@pytest.fixture(scope="module")
def encoders():
    jp = jax_model.random_params(jax.random.PRNGKey(2), HP)
    tp, _ = port_params(jp, HP)
    return jp["enc_p"], tp["enc_p"]


def _inputs(seed, lengths, t):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((len(lengths), t, HP.hidden_channels))
    mask = (np.arange(t)[None, :] < np.asarray(lengths)[:, None])
    return x.astype(np.float32), mask[..., None].astype(np.float32)


def emulate_kernel(spec, x, x_mask):
    """The phases of csrc/fused_encoder.cu over the stacked spec."""
    b, t, h = x.shape
    heads, dk, win = spec["n_heads"], spec["dk"], spec["window"]
    mask = x_mask
    lengths = x_mask[:, :, 0].sum(1).long()
    pos = torch.arange(t)
    rel = pos[None, :] - pos[:, None]  # key - query
    band = (rel.abs() <= win)
    keys_ok = pos[None, :] < lengths[:, None]  # [B, T]

    def ln(v, gamma, beta):
        mu = v.mean(-1, keepdim=True)
        var = ((v - mu) ** 2).mean(-1, keepdim=True)
        return (v - mu) / torch.sqrt(var + 1e-5) * gamma + beta

    def conv(a, w, bias):  # a [B, T, Cin], w [K, Cin, N]
        taps = w.shape[0]
        pad = (taps - 1) // 2
        ap = torch.nn.functional.pad(a, (0, 0, pad, taps - 1 - pad))
        return bias + sum(ap[:, j:j + t] @ w[j] for j in range(taps))

    xb = x.clone()
    for l in range(spec["n_layers"]):
        qkv = xb @ spec["w_qkv"][l] + spec["b_qkv"][l, 0]
        out = torch.zeros(b, t, h)
        for hd in range(heads):
            q = qkv[..., hd * dk:(hd + 1) * dk] / math.sqrt(dk)
            k = qkv[..., h + hd * dk:h + (hd + 1) * dk]
            v = qkv[..., 2 * h + hd * dk:2 * h + (hd + 1) * dk]
            rl = q @ spec["rel_k"][l].T  # [B, T, 2w+1]
            idx = (rel + win).clamp(0, 2 * win)
            s = q @ k.transpose(1, 2)
            s = s + torch.where(band, torch.gather(
                rl, 2, idx[None].expand(b, -1, -1)), torch.zeros(()))
            s = torch.where(keys_ok[:, None, :], s, torch.full((), -1e4))
            p = torch.softmax(s, -1)
            o = p @ v
            pb = torch.where(band, p, torch.zeros(()))
            for j in range(2 * win + 1):
                d = j - win
                sel = (rel == d).float()
                o = o + (pb * sel).sum(-1, keepdim=True) * spec["rel_v"][l, j]
            out[..., hd * dk:(hd + 1) * dk] = o
        y = out @ spec["w_o"][l] + spec["b_o"][l, 0]
        lnp = spec["ln"][l]
        xb = ln(xb + y, lnp[0], lnp[1])
        hdn = torch.relu(conv(xb * mask, spec["w_ffn1"][l],
                              spec["b_ffn1"][l, 0])) * mask
        y = conv(hdn, spec["w_ffn2"][l], spec["b_ffn2"][l, 0]) * mask
        xb = ln(xb + y, lnp[2], lnp[3])
    return xb * mask


@pytest.mark.parametrize("seed,lengths,t", [(0, [16, 11], 16), (1, [9], 9),
                                            (2, [20, 3, 14], 20)])
def test_encoder_matches_jax(encoders, seed, lengths, t):
    jenc, tenc = encoders
    x, mask = _inputs(seed, lengths, t)
    xm = x * mask
    want_xla = np.asarray(jax_attention.encoder(
        jenc["encoder"], jnp.asarray(xm), jnp.asarray(mask)))
    jspec = jax_fused_encoder.build_spec(jenc["encoder"])
    want_kernel = np.asarray(jax_fused_encoder.apply(
        jspec, jnp.asarray(xm), jnp.asarray(mask)))

    spec = fused_encoder.build_spec(tenc["encoder"])
    got = fused_encoder.apply(spec, torch.from_numpy(xm),
                              torch.from_numpy(mask)).numpy()
    np.testing.assert_allclose(got, want_kernel, atol=TOL, rtol=0)
    np.testing.assert_allclose(got, want_xla, atol=TOL, rtol=0)
    for i, n in enumerate(lengths):  # padded rows included, and zero
        assert np.all(got[i, n:] == 0.0)
    routed = attention.encoder(dict(tenc["encoder"], fused=spec),
                               torch.from_numpy(x), torch.from_numpy(mask))
    np.testing.assert_array_equal(routed.numpy(), got)


def test_stacked_spec_emulation_matches_plain(encoders):
    _, tenc = encoders
    x, mask = _inputs(5, [18, 7], 18)
    spec = fused_encoder.build_spec(tenc["encoder"])
    xm = torch.from_numpy(x * mask)
    want = fused_encoder.plain(spec, xm, torch.from_numpy(mask))
    got = emulate_kernel(spec, xm, torch.from_numpy(mask))
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=TOL, rtol=0)


def test_text_encoder_matches_jax(encoders):
    """The whole text encoder (embedding, stack, projection) with the spec."""
    from phoonnx_tpu.models.vits import encoder as jax_encoder
    from phoonnx_tpu_torch.models.vits import nn

    jenc, tenc = encoders
    rng = np.random.default_rng(6)
    ids = rng.integers(1, HP.n_vocab, (2, 13)).astype(np.int32)
    lens = np.asarray([13, 8], np.int32)
    jmask = (np.arange(13)[None] < lens[:, None])[..., None].astype(np.float32)
    want = jax_encoder.text_encoder(jenc, jnp.asarray(ids), jnp.asarray(jmask))
    tmask = nn.sequence_mask(torch.from_numpy(lens), 13)[..., None].float()
    tenc = dict(tenc, encoder=dict(
        tenc["encoder"], fused=fused_encoder.build_spec(tenc["encoder"])))
    got = encoder.text_encoder(tenc, torch.from_numpy(ids).long(), tmask)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=TOL, rtol=0)


def test_cpu_call_counts_no_launch(encoders):
    _, tenc = encoders
    spec = fused_encoder.build_spec(tenc["encoder"])
    x, mask = _inputs(0, [4], 4)
    before = fused_encoder.launches
    fused_encoder.apply(spec, torch.from_numpy(x), torch.from_numpy(mask))
    assert fused_encoder.launches == before
