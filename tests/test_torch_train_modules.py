"""The training modules of the port against the JAX package's, on the CPU.

Posterior encoder, the flows forward with their log-determinants, the
forward spline, the duration models, the discriminators, the losses, the
training text encoder and dropout. Weights, inputs and tolerances follow
``tests/test_torch_train_forward.py``, whose helpers build the models.
"""

import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from phoonnx_tpu.models.vits import discriminator as jax_disc
from phoonnx_tpu.models.vits import duration as jax_duration
from phoonnx_tpu.models.vits import modules as jax_modules
from phoonnx_tpu.models.vits import posterior as jax_posterior
from phoonnx_tpu.models.vits import transforms as jax_transforms
from phoonnx_tpu.train import losses as jax_losses
from phoonnx_tpu_torch.models.vits import discriminator, duration
from phoonnx_tpu_torch.models.vits import modules, nn, posterior, transforms
from phoonnx_tpu_torch.train import losses

from tests.test_torch_train_forward import (GIN_HP, SPLINE_LOGDET_ATOL,
                                            _mask, close, make_models, t)
from tests.test_torch_train_forward import one_torch_thread  # noqa: F401
from tests.test_voice_e2e import SMALL_HP


@pytest.fixture(scope="module")
def models():
    return make_models(SMALL_HP)


@pytest.mark.parametrize("gin", [0, 8])
def test_posterior_encoder_matches_jax(gin):
    hp = GIN_HP if gin else SMALL_HP
    jg, _, tg, _, _ = make_models(hp, seed=gin)
    rng = np.random.default_rng(1)
    spec = np.abs(rng.standard_normal((2, 24, hp.spec_channels))
                  ).astype(np.float32) * 0.3
    mask = _mask([24, 15], 24)
    noise = rng.standard_normal((2, 24, hp.inter_channels)).astype(np.float32)
    g = rng.standard_normal((2, 1, gin)).astype(np.float32) if gin else None
    want = jax_posterior.posterior_encoder(
        jg["enc_q"], jnp.asarray(spec), jnp.asarray(mask), jnp.asarray(noise),
        g=None if g is None else jnp.asarray(g))
    got = posterior.posterior_encoder(tg["enc_q"], t(spec), t(mask),
                                      t(noise), g=None if g is None else t(g))
    for a, b in zip(got, want):
        close(a, b)
    # the forward coupling flow of the same latents
    close(posterior.coupling_flow(tg["flow"], got[0], t(mask),
                                  g=None if g is None else t(g)),
          jax_posterior.coupling_flow(jg["flow"], want[0], jnp.asarray(mask),
                                      g=None if g is None else jnp.asarray(g)))


def test_flow_primitives_forward_logdet_match_jax(models):
    jg, _, tg, _, _ = models
    rng = np.random.default_rng(2)
    mask = _mask([20, 13], 20)
    x2 = rng.standard_normal((2, 20, 2)).astype(np.float32)
    cond = rng.standard_normal((2, 20, SMALL_HP.hidden_channels)
                               ).astype(np.float32)
    x32 = rng.standard_normal((2, 20, SMALL_HP.inter_channels)
                              ).astype(np.float32)
    pairs = [
        (modules.elementwise_affine(tg["dp"]["flows"][0]["ea"], t(x2),
                                    t(mask)),
         jax_modules.elementwise_affine(jg["dp"]["flows"][0]["ea"],
                                        jnp.asarray(x2), jnp.asarray(mask))),
        (modules.log_flow(t(np.abs(x2) + 0.1), t(mask)),
         jax_modules.log_flow(jnp.asarray(np.abs(x2) + 0.1),
                              jnp.asarray(mask))),
        (modules.conv_flow(tg["dp"]["flows"][1]["cf"], t(x2), t(mask),
                           g=t(cond)),
         jax_modules.conv_flow(jg["dp"]["flows"][1]["cf"], jnp.asarray(x2),
                               jnp.asarray(mask), g=jnp.asarray(cond))),
        (modules.residual_coupling_layer(tg["flow"]["flows"][0], t(x32),
                                         t(mask)),
         jax_modules.residual_coupling_layer(
             jg["flow"]["flows"][0], jnp.asarray(x32), jnp.asarray(mask))),
    ]
    for (y_t, ld_t), (y_j, ld_j) in pairs:
        close(y_t, y_j)
        close(ld_t, ld_j)
    # the splines do real work: some inputs move and the logdet is not 0
    y, logdet = pairs[2][0]
    assert (y - t(x2) * t(mask)).abs().max() > 1e-2
    assert logdet.abs().max() > 1e-2


def test_forward_spline_matches_jax():
    rng = np.random.default_rng(3)
    x = rng.uniform(-6, 6, (3, 50)).astype(np.float32)  # tails included
    w = rng.standard_normal((3, 50, 10)).astype(np.float32)
    h = rng.standard_normal((3, 50, 10)).astype(np.float32)
    d = rng.standard_normal((3, 50, 9)).astype(np.float32)
    for inverse in (False, True):
        y_t, ld_t = transforms.piecewise_rational_quadratic_transform(
            t(x), t(w), t(h), t(d), inverse=inverse, tails="linear",
            tail_bound=5.0)
        y_j, ld_j = jax_transforms.piecewise_rational_quadratic_transform(
            jnp.asarray(x), jnp.asarray(w), jnp.asarray(h), jnp.asarray(d),
            inverse=inverse, tails="linear", tail_bound=5.0)
        close(y_t, y_j)
        close(ld_t, ld_j, atol=SPLINE_LOGDET_ATOL)
    y_t, ld_t = transforms.rational_quadratic_spline(
        t(np.clip(x / 6 + 0.5, 0, 1)), t(w), t(h),
        t(np.concatenate([d, d[..., :2]], -1)))
    y_j, ld_j = jax_transforms.rational_quadratic_spline(
        jnp.asarray(np.clip(x / 6 + 0.5, 0, 1)), jnp.asarray(w),
        jnp.asarray(h), jnp.asarray(np.concatenate([d, d[..., :2]], -1)))
    close(y_t, y_j)
    close(ld_t, ld_j, atol=SPLINE_LOGDET_ATOL)


@pytest.mark.parametrize("use_sdp", [True, False])
def test_duration_models_match_jax(use_sdp):
    hp = dataclasses.replace(GIN_HP, use_sdp=use_sdp)
    jg, _, tg, _, _ = make_models(hp, seed=3)
    rng = np.random.default_rng(4)
    mask = _mask([14, 9, 4], 14)
    x = rng.standard_normal((3, 14, hp.hidden_channels)).astype(np.float32)
    g = rng.standard_normal((3, 1, hp.gin_channels)).astype(np.float32)
    if use_sdp:
        w = rng.integers(0, 6, (3, 14, 1)).astype(np.float32) * mask
        e_q = rng.standard_normal((3, 14, 2)).astype(np.float32)
        want = jax_duration.sdp_nll(jg["dp"], jnp.asarray(x),
                                    jnp.asarray(mask), jnp.asarray(w),
                                    jnp.asarray(e_q), g=jnp.asarray(g))
        got = duration.sdp_nll(tg["dp"], t(x), t(mask), t(w), t(e_q),
                               g=t(g))
    else:
        want = jax_duration.duration_predictor(
            jg["dp"], jnp.asarray(x), jnp.asarray(mask), g=jnp.asarray(g))
        got = duration.duration_predictor(tg["dp"], t(x), t(mask), g=t(g))
    close(got, want, rtol=1e-4)


def test_discriminator_matches_jax(models):
    _, jd, _, td, _ = models
    rng = np.random.default_rng(5)
    y = (0.3 * rng.standard_normal((2, 401))).astype(np.float32)
    y_hat = (0.3 * rng.standard_normal((2, 401))).astype(np.float32)
    want = jax_disc.multi_period_discriminator(jd, jnp.asarray(y),
                                               jnp.asarray(y_hat))
    got = discriminator.multi_period_discriminator(td, t(y), t(y_hat))
    for logits_t, logits_j in zip(got[0] + got[1], want[0] + want[1]):
        close(logits_t, logits_j)
    for maps_t, maps_j in zip(got[2] + got[3], want[2] + want[3]):
        assert len(maps_t) == len(maps_j)
        for a, b in zip(maps_t, maps_j):
            assert tuple(a.shape) == b.shape
            close(a, b)


def test_losses_match_jax():
    rng = np.random.default_rng(6)

    def arrays(*shapes):
        return [rng.standard_normal(s).astype(np.float32) for s in shapes]

    real, fake = arrays((2, 7), (2, 5)), arrays((2, 7), (2, 5))
    fr = [arrays((2, 4, 3), (2, 6)), arrays((2, 5, 2, 1))]
    fg = [arrays((2, 4, 3), (2, 6)), arrays((2, 5, 2, 1))]

    def tt(tree):
        return [tt(x) for x in tree] if isinstance(tree, list) else t(tree)

    def jj(tree):
        return ([jj(x) for x in tree] if isinstance(tree, list)
                else jnp.asarray(tree))

    close(losses.feature_loss(tt(fr), tt(fg)),
          jax_losses.feature_loss(jj(fr), jj(fg)))
    d_t, r_t, g_t = losses.discriminator_loss(tt(real), tt(fake))
    d_j, r_j, g_j = jax_losses.discriminator_loss(jj(real), jj(fake))
    for a, b in zip([d_t] + r_t + g_t, [d_j] + r_j + g_j):
        close(a, b)
    gen_t, each_t = losses.generator_loss(tt(fake))
    gen_j, each_j = jax_losses.generator_loss(jj(fake))
    for a, b in zip([gen_t] + each_t, [gen_j] + each_j):
        close(a, b)
    z_p, logs_q, m_p, logs_p = arrays(*[(2, 9, 4)] * 4)
    mask = _mask([9, 5], 9)
    close(losses.kl_loss(t(z_p), t(logs_q), t(m_p), t(logs_p), t(mask)),
          jax_losses.kl_loss(jnp.asarray(z_p), jnp.asarray(logs_q),
                             jnp.asarray(m_p), jnp.asarray(logs_p),
                             jnp.asarray(mask)))


def test_text_encoder_train_matches_jax(models):
    jg, _, tg, _, _ = models
    from phoonnx_tpu.models.vits import encoder as jax_encoder
    from phoonnx_tpu_torch.models.vits import encoder

    rng = np.random.default_rng(7)
    ids = rng.integers(1, SMALL_HP.n_vocab, (2, 11))
    mask = _mask([11, 6], 11)
    want = jax_encoder.text_encoder(jg["enc_p"], jnp.asarray(ids),
                                    jnp.asarray(mask))
    got = encoder.text_encoder_train(tg["enc_p"], t(ids).long(), t(mask),
                                     p_dropout=0.1, deterministic=True)
    for a, b in zip(got, want):
        close(a, b)


def test_dropout_keep_rate_and_scaling():
    x = torch.ones(200, 500)
    gen = torch.Generator().manual_seed(0)
    y = nn.dropout(x, 0.1, gen, deterministic=False)
    kept = y != 0
    assert abs(kept.float().mean().item() - 0.9) < 0.005  # 1e5 draws
    assert torch.equal(y[kept], torch.full_like(y[kept], 1 / 0.9))
    assert nn.dropout(x, 0.1, gen, deterministic=True) is x
    assert nn.dropout(x, 0.1, None, deterministic=False) is x
    assert nn.dropout(x, 0.0, gen, deterministic=False) is x
    # a seeded generator draws the same masks again
    again = nn.dropout(x, 0.1, torch.Generator().manual_seed(0), False)
    assert torch.equal(again, y)
