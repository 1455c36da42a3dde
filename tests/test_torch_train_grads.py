"""Gradients of the port's training step against ``jax.grad``, on the CPU.

The generator objective (``step.generator_objective``) and the
discriminator objective, differentiated with ``torch.autograd`` with
respect to each network's leaves, against ``jax.grad`` of the same loss
composition written here from the JAX functions
(``phoonnx_tpu/train/step.py:161-226``), with dropout off and JAX's own
noise, leaf by leaf under the JAX keypath names.

The whole objective runs with the deterministic duration predictor
(``use_sdp=False``), which keeps the JAX compile inside the file's time;
the stochastic one's gradient is held on its own in
``tests/test_torch_train_forward.py``.

The tolerances are stated at ``assert_grads_close``.
"""

import numpy as np
import jax
import jax.numpy as jnp
import torch

from phoonnx_tpu.models.vits import discriminator as jax_disc
from phoonnx_tpu.models.vits import model as jax_model
from phoonnx_tpu.models.vits.model import VitsHParams
from phoonnx_tpu.ops import stft as jax_stft
from phoonnx_tpu.train import losses as jax_losses
from phoonnx_tpu.train import step as jax_step
from phoonnx_tpu_torch.train import step

from tests.test_torch_train_forward import (DISC, assert_grads_close,
                                            jax_noise, make_batch,
                                            make_models)
from tests.test_torch_train_forward import one_torch_thread  # noqa: F401

HP = VitsHParams.preset("micro", n_vocab=24, use_sdp=False)
CFG = step.TrainConfig(**DISC)

def _jax_objectives(hp, cfg):
    seg_samples = hp.segment_size * hp.hop_length

    def g_loss(pg, pd, batch, key):
        out = jax_model.train_forward(
            pg, hp, key, batch["phoneme_ids"], batch["phoneme_lengths"],
            batch["spec"], batch["spec_lengths"], sid=batch.get("sid"),
            deterministic=True, mas_impl="scan")
        y_hat = out["audio"]
        y = jax_model.slice_audio_segments(batch["audio"], out["ids_slice"],
                                           seg_samples, hp.hop_length)
        mel_hat = jax_stft.mel_spectrogram(
            y_hat, hp.filter_length, hp.mel_channels, hp.sample_rate,
            hp.hop_length, hp.win_length)
        mel_full = jax_stft.spec_to_mel(batch["spec"], hp.sample_rate,
                                        hp.filter_length, hp.mel_channels)
        mel_real = jax_model._slice_segments(mel_full, out["ids_slice"],
                                             hp.segment_size)
        loss_mel = jnp.mean(jnp.abs(mel_real - mel_hat)) * cfg.c_mel
        loss_kl = jax_losses.kl_loss(out["z_p"], out["logs_q"], out["m_p"],
                                     out["logs_p"], out["y_mask"]) * cfg.c_kl
        loss_dur = jnp.sum(out["l_length"])
        _, y_d_gs, fmap_rs, fmap_gs = jax_disc.multi_period_discriminator(
            pd, y, y_hat)
        loss_fm = jax_losses.feature_loss(fmap_rs, fmap_gs)
        loss_gen, _ = jax_losses.generator_loss(y_d_gs)
        return loss_gen + loss_fm + loss_mel + loss_dur + loss_kl, (y, y_hat)

    def d_loss(pd, y, y_hat):
        y_d_rs, y_d_gs, _, _ = jax_disc.multi_period_discriminator(
            pd, jax.lax.stop_gradient(y), jax.lax.stop_gradient(y_hat))
        return jax_losses.discriminator_loss(y_d_rs, y_d_gs)[0]

    return g_loss, d_loss


def test_gradients_match_jax_grad():
    jg, jd, tg, td, thp = make_models(HP, seed=2)
    lengths = [(10, 40), (7, 33)]
    batch = make_batch(HP, 3, lengths, 10, 40)
    key = jax.random.PRNGKey(5)
    g_loss, d_loss = _jax_objectives(HP, jax_step.TrainConfig(**DISC))
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    (want_total, (y, y_hat)), want_gg = jax.jit(jax.value_and_grad(
        g_loss, has_aux=True))(jg, jd, jbatch, key)
    want_d, want_gd = jax.jit(jax.value_and_grad(d_loss))(jd, y, y_hat)

    tbatch = step.batch_to_device(batch, "cpu")
    total, aux = step.generator_objective(
        tg, td, tbatch, thp, CFG, deterministic=True,
        noise=jax_noise(key, HP, 2, 10, 40))
    grads_g = torch.autograd.grad(total, step.leaves(tg))
    loss_d = step.discriminator_objective(td, aux["y"], aux["y_hat"])
    grads_d = torch.autograd.grad(loss_d, step.leaves(td))
    np.testing.assert_allclose(total.item(), float(want_total), rtol=1e-5)
    np.testing.assert_allclose(loss_d.item(), float(want_d), rtol=1e-5)
    names_g = [n for n, _ in step.keyed_leaves(tg)]
    names_d = [n for n, _ in step.keyed_leaves(td)]
    worst_g, worst_sdp = assert_grads_close(names_g, grads_g, want_gg)
    worst_d, _ = assert_grads_close(names_d, grads_d, want_gd)
    print(f"worst relative gradient error: G {worst_g:.2e} (duration "
          f"predictor {worst_sdp:.2e}), D {worst_d:.2e}")
