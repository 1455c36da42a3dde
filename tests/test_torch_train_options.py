"""The port's training options against the JAX package's, on the CPU.

* **bf16** (``compute_dtype="bfloat16"``, micro with the deterministic
  duration predictor and the random flows of ``make_models``, ROADMAP
  §3): the port's bf16 objective and JAX's, against the float32 truth on
  the same bf16-rounded weights, JAX's own bf16 noise, dropout off, over
  eight batches. Both frameworks run on the truth's alignment, since a
  rounding can move a monotonic alignment by a frame, which changes the
  duration and KL terms by a step of their own. Every tensor the losses
  read (the prior and posterior statistics, ``z_p``, the generated audio,
  the durations' loss, the discriminator's logits and feature maps) is
  held to at most 1.25 times JAX's error against the truth, in RMS and in
  mean absolute error; the KL integrand, element by element, in mean
  absolute error: its squared error is one element's, where a logs_p one
  bf16 step off is amplified by exp(-2 logs_p) (x133) and (z_p - m_p)^2
  (x306) (measured: 1.9e6 of the port's 2.0e6 summed squares in one
  batch of eight come from one element; elsewhere the port's are the
  smaller). The six loss values, whose errors are signed sums of thousands
  of such element errors, are held to 2^-5 (eight bf16 steps) relative to
  the truth in every batch: the largest measured are the KL term's, 2.1e-2
  in the port (that one element's batch) and 1.2e-2 in JAX; the RMS
  errors of both frameworks are printed (``-s``). One bf16 step keeps
  float32 master weights and moves them.
* **grad_accum=2** equals the average of the two micro-batch gradients
  (each drawing from ``step.micro_generator``) followed by one update, as
  ``tests/test_train_step.py:231`` holds JAX's; an indivisible batch
  raises JAX's message.
* **remat** with dropout on gives gradients ``torch.equal`` to the step
  without it: the recompute redraws the forward's dropout masks from the
  restored generator. A checkpoint that does not restore it gives other
  gradients, which the test shows too.
* **warm start** from a single-speaker export and from a Lightning
  ``.ckpt`` built here, into a 2-speaker model: the loaded leaves equal
  JAX's ``load_generator_warm_start`` of the same file (a folded weight as
  its weight-norm pair, within 1e-6 of it), and the speaker-conditioning
  leaves keep their fresh initialization; the model then takes a step.
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from phoonnx_tpu.models.vits import discriminator as jax_disc
from phoonnx_tpu.models.vits import model as jax_model
from phoonnx_tpu.models.vits.model import VitsHParams
from phoonnx_tpu_torch.models.vits import model as port_model
from phoonnx_tpu_torch.models.vits import nn
from phoonnx_tpu_torch.train import checkpoint, step

from tests.test_torch_train_forward import DISC, make_batch, make_models
from tests.test_torch_train_forward import one_torch_thread  # noqa: F401

HP = VitsHParams.preset("micro", n_vocab=24, use_sdp=False)
BF16_RATIO = 1.25
LOSS_RTOL = 2.0 ** -5
WARM_RTOL = 1e-6
LENGTHS = [(10, 40), (7, 33)]
FORWARD_KEYS = ("z", "z_p", "m_q", "logs_q", "m_p", "logs_p", "audio",
                "l_length")


def _jcast(tree, dtype):
    return jax.tree.map(
        lambda a: a.astype(dtype)
        if jnp.issubdtype(jnp.asarray(a).dtype, jnp.floating) else a, tree)


def _flat(tree):
    """Tensors of a nested list in order."""
    if isinstance(tree, (list, tuple)):
        return [t for sub in tree for t in _flat(sub)]
    return [tree]


def _kl_terms(z_p, logs_q, m_p, logs_p, y_mask):
    """losses.kl_loss's integrand, element by element (numpy f32)."""
    return (logs_p - logs_q - 0.5 + 0.5 * (z_p - m_p) ** 2
            * np.exp(-2.0 * logs_p)) * y_mask


def test_bf16_objective_against_float32_truth(monkeypatch):
    from phoonnx_tpu_torch.models.vits import discriminator as disc
    from phoonnx_tpu_torch.ops import stft
    from phoonnx_tpu_torch.train import losses as loss_fns

    jg, jd, tg, td, thp = make_models(HP, seed=2)
    seg_samples = HP.segment_size * HP.hop_length
    # every run takes the alignment in `held`, the truth's
    held = {}
    monkeypatch.setattr(jax_model.mas, "maximum_path",
                        lambda nc, mask, impl=None:
                        held["attn"].astype(nc.dtype) * mask)
    plain_mas = port_model.mas.maximum_path
    monkeypatch.setattr(port_model.mas, "maximum_path",
                        lambda nc, mask: plain_mas(nc, mask)
                        if "attn" not in held else
                        torch.from_numpy(held["attn"]).to(nc.dtype) * mask)

    @jax.jit
    def jax_bf16(pg, pd, batch, key, attn):
        # the JAX step's bf16 objective (step.py:132-208): params and
        # batch cast inside, y from the f32 audio, discriminator in bf16
        held["attn"] = attn
        cb = _jcast(batch, jnp.bfloat16)
        out = jax_model.train_forward(
            _jcast(pg, jnp.bfloat16), HP, key, cb["phoneme_ids"],
            cb["phoneme_lengths"], cb["spec"], cb["spec_lengths"],
            deterministic=True, mas_impl="scan")
        y = jax_model.slice_audio_segments(batch["audio"], out["ids_slice"],
                                           seg_samples, HP.hop_length)
        disc_out = jax_disc.multi_period_discriminator(
            _jcast(pd, jnp.bfloat16), y.astype(jnp.bfloat16), out["audio"])
        return ({k: out[k] for k in FORWARD_KEYS + ("y_mask", "ids_slice")},
                disc_out)

    def jax_losses(out, disc_out, tb):
        """The JAX objective's six terms from its bf16 tensors, in f32
        (the JAX step casts them so, step.py:172-208), by the port's
        loss functions (held to JAX's in test_torch_train_grads.py)."""
        def f32(a):
            return torch.from_numpy(np.array(a.astype(jnp.float32)))

        t = {k: f32(v) if jnp.issubdtype(v.dtype, jnp.floating) else
             torch.from_numpy(np.array(v)) for k, v in out.items()}
        y_d_rs, y_d_gs, fmap_rs, fmap_gs = [
            [f32(a) for a in grp] if not isinstance(grp[0], list) else
            [[f32(a) for a in fm] for fm in grp] for grp in disc_out]
        mel_hat = step._mel(t["audio"], thp)
        mel_real = port_model._slice_segments(
            stft.spec_to_mel(tb["spec"], thp.sample_rate, thp.filter_length,
                             thp.mel_channels), t["ids_slice"],
            thp.segment_size)
        terms = {
            "loss_mel": torch.mean(torch.abs(mel_real - mel_hat)) * 45.0,
            "loss_kl": loss_fns.kl_loss(t["z_p"], t["logs_q"], t["m_p"],
                                      t["logs_p"], t["y_mask"]),
            "loss_dur": torch.sum(t["l_length"]),
            "loss_fm": loss_fns.feature_loss(fmap_rs, fmap_gs),
            "loss_gen": loss_fns.generator_loss(y_d_gs)[0],
            "loss_disc_all": loss_fns.discriminator_loss(y_d_rs,
                                                           y_d_gs)[0]}
        terms["loss_gen_all"] = sum(terms[k] for k in (
            "loss_mel", "loss_kl", "loss_dur", "loss_fm", "loss_gen"))
        return {k: float(v) for k, v in terms.items()}

    # the port's tensors are those its objective computes: the first
    # training forward and discriminator call of each objective, captured
    captured = {}
    forward, discriminate = (port_model.train_forward,
                             disc.multi_period_discriminator)
    monkeypatch.setattr(port_model, "train_forward", lambda *a, **kw:
                        captured.setdefault("out", forward(*a, **kw)))
    monkeypatch.setattr(disc, "multi_period_discriminator", lambda *a, **kw:
                        captured.setdefault("disc", discriminate(*a, **kw)))

    def port_run(pg, pd, tb, noise, cfg):
        captured.clear()
        with torch.no_grad():
            _, aux = step.generator_objective(
                pg, pd, tb, thp, cfg, deterministic=True, noise=noise)
            loss_d = step.discriminator_objective(
                pd, aux["y"], aux["y_hat"], step.compute_dtype(cfg))
        losses = {k: float(aux[k]) for k in step.METRICS
                  if k != "loss_disc_all"}
        losses["loss_disc_all"] = float(loss_d)
        out, (_, y_d_gs, _, fmap_gs) = captured["out"], captured["disc"]
        tensors = {k: out[k].float().numpy()
                   for k in FORWARD_KEYS + ("y_mask",)}
        return tensors, [t.float().numpy()
                         for t in _flat([y_d_gs, fmap_gs])], losses

    def rounded(tree):
        return nn.cast_floating(nn.cast_floating(tree, torch.bfloat16),
                                torch.float32)

    cfg16 = step.TrainConfig(**DISC, compute_dtype="bfloat16")
    cfg32 = step.TrainConfig(**DISC)
    sq = {"port": {}, "jax": {}}
    ab = {"port": {}, "jax": {}}
    loss_err = {"port": [], "jax": []}
    for seed in range(8):
        batch = make_batch(HP, 3 + seed, LENGTHS, 10, 40)
        key = jax.random.PRNGKey(5 + seed)
        _, k_post, _, k_slice, _ = jax.random.split(key, 5)
        # JAX's bf16 step draws its noise in bf16
        noise = {"post_noise": torch.from_numpy(np.array(jax.random.normal(
                     k_post, (2, 40, HP.inter_channels), jnp.bfloat16
                 ).astype(jnp.float32))),
                 "slice_u": torch.from_numpy(np.array(
                     jax.random.uniform(k_slice, (2,))))}
        tb = step.batch_to_device(batch, "cpu")
        held.pop("attn", None)
        with torch.no_grad():
            held["attn"] = forward(
                rounded(tg), thp, tb["phoneme_ids"], tb["phoneme_lengths"],
                tb["spec"], tb["spec_lengths"], deterministic=True,
                **noise)["attn"].numpy()
        truth_t, truth_d, truth_l = port_run(rounded(tg), rounded(td), tb,
                                             noise, cfg32)
        port_t, port_d, port_l = port_run(tg, td, tb, noise, cfg16)
        out, disc_out = jax_bf16(
            jg, jd, {k: jnp.asarray(v) for k, v in batch.items()}, key,
            jnp.asarray(held["attn"]))
        jax_t = {k: np.asarray(v.astype(jnp.float32)) for k, v in out.items()}
        # the generated audio's logits and feature maps, as the port's
        jax_d = [np.asarray(t.astype(jnp.float32))
                 for t in _flat([disc_out[1], disc_out[3]])]
        jax_l = jax_losses(out, disc_out, tb)
        for side, tensors, disc_vals, losses in (
                ("port", port_t, port_d, port_l),
                ("jax", jax_t, jax_d, jax_l)):
            names = ("z_p", "logs_q", "m_p", "logs_p", "y_mask")
            diffs = {k: tensors[k] - truth_t[k] for k in FORWARD_KEYS}
            diffs["discriminator"] = np.concatenate([
                (a - b.reshape(a.shape)).ravel()
                for a, b in zip(disc_vals, truth_d)])
            diffs["kl integrand"] = (
                _kl_terms(*[tensors[k] for k in names])
                - _kl_terms(*[truth_t[k] for k in names]))
            for k, d in diffs.items():
                sq[side][k] = sq[side].get(k, 0.0) + float(np.sum(d * d))
                ab[side][k] = ab[side].get(k, 0.0) + float(
                    np.sum(np.abs(d)))
            loss_err[side].append([abs(losses[k] - truth_l[k])
                                   / abs(truth_l[k]) for k in step.METRICS])
    rms = {k: (sq["port"][k] / sq["jax"][k]) ** 0.5 for k in sq["port"]}
    mean_abs = {k: ab["port"][k] / ab["jax"][k] for k in ab["port"]}
    print("bf16 error against the truth, port / JAX, RMS and mean abs: "
          + ", ".join(f"{k} {rms[k]:.2f} {mean_abs[k]:.2f}" for k in rms))
    errs = {side: np.asarray(v) for side, v in loss_err.items()}
    print("bf16 losses, RMS relative error port / JAX: " + ", ".join(
        f"{k} {a:.2e} / {b:.2e}" for k, a, b in zip(
            step.METRICS, np.sqrt((errs["port"] ** 2).mean(0)),
            np.sqrt((errs["jax"] ** 2).mean(0)))))
    for k in rms:
        assert mean_abs[k] <= BF16_RATIO, (k, mean_abs[k])
        assert k == "kl integrand" or rms[k] <= BF16_RATIO, (k, rms[k])
    assert (errs["port"] <= LOSS_RTOL).all(), errs["port"].max(0)
    assert (errs["jax"] <= LOSS_RTOL).all(), errs["jax"].max(0)

    # one bf16 step (the plain alignment search, nothing captured):
    # float32 masters that move
    monkeypatch.undo()
    state = step.init_train_state(thp, cfg16)
    before = [t.detach().clone() for t in step.leaves(state.params_g)]
    state, metrics = step.train_step(
        state, step.batch_to_device(make_batch(HP, 1, LENGTHS, 10, 40),
                                    "cpu"), thp, cfg16,
        generator=torch.Generator().manual_seed(0))
    assert all(torch.isfinite(v) for v in metrics.values())
    now = step.leaves(state.params_g)
    assert all(t.dtype == torch.float32 for t in now)
    assert sum(not torch.equal(a, b) for a, b in zip(now, before)) > \
        len(now) // 2
    assert all(s["exp_avg"].dtype == torch.float32
               for s in state.opt_g.state.values())


PORT_HP = VitsHParams.preset("micro", n_vocab=24)


@pytest.fixture(scope="module")
def port_hp():
    from tests.test_torch_infer import port_hparams

    return port_hparams(PORT_HP)


def test_grad_accum_matches_manual_average(port_hp):
    cfg = step.TrainConfig(**DISC, grad_accum=2)
    batch = step.batch_to_device(make_batch(
        PORT_HP, 4, [(10, 40), (7, 33), (9, 36), (6, 30)], 10, 40), "cpu")
    gen = torch.Generator().manual_seed(11)
    state = step.init_train_state(port_hp, cfg,
                                  torch.Generator().manual_seed(1))
    got, got_metrics = step.train_step(state, batch, port_hp, cfg,
                                       generator=gen)

    manual = step.init_train_state(port_hp, cfg,
                                   torch.Generator().manual_seed(1))
    halves = [{k: v[:2] for k, v in batch.items()},
              {k: v[2:] for k, v in batch.items()}]
    acc_g = acc_d = acc_m = None
    for i, half in enumerate(halves):
        g_g, g_d, m = step._micro_grads(
            manual, half, port_hp, cfg, False,
            generator=step.micro_generator(gen, i))
        if acc_g is None:
            acc_g, acc_d, acc_m = list(g_g), list(g_d), m
        else:
            acc_g = [a + b for a, b in zip(acc_g, g_g)]
            acc_d = [a + b for a, b in zip(acc_d, g_d)]
            acc_m = {k: acc_m[k] + m[k] for k in acc_m}
    step._update(manual.opt_g, step.leaves(manual.params_g),
                 [a * 0.5 for a in acc_g], cfg, 0)
    step._update(manual.opt_d, step.leaves(manual.params_d),
                 [a * 0.5 for a in acc_d], cfg, 0)
    for a, b in zip(step.leaves(got.params_g) + step.leaves(got.params_d),
                    step.leaves(manual.params_g)
                    + step.leaves(manual.params_d)):
        assert torch.equal(a, b)
    for k in step.METRICS:
        assert torch.equal(got_metrics[k], acc_m[k] * 0.5), k
    assert got.step == 1
    # the micro-batches draw from their own generators, a pure function of
    # the step generator's seed and the micro-batch's index
    assert step.micro_generator(gen, 0).initial_seed() != \
        step.micro_generator(gen, 1).initial_seed()
    assert step.micro_generator(torch.Generator().manual_seed(11),
                                1).initial_seed() == \
        step.micro_generator(gen, 1).initial_seed()

    odd = {k: v[:3] for k, v in batch.items()}
    with pytest.raises(ValueError,
                       match="batch size 3 is not divisible by grad_accum 2"):
        step.train_step(state, odd, port_hp, cfg, generator=gen)


def test_remat_gradients_equal_the_plain_step(port_hp, monkeypatch):
    """Dropout on (p 0.1 in the encoder, 0.5 in the duration predictor),
    the stochastic duration predictor, one generator per step."""
    batch = step.batch_to_device(make_batch(PORT_HP, 5, LENGTHS, 10, 40),
                                 "cpu")
    state = step.init_train_state(port_hp, step.TrainConfig(**DISC),
                                  torch.Generator().manual_seed(2))
    calls = []
    forward = port_model.train_forward

    def counted(*args, **kw):
        calls.append(1)
        return forward(*args, **kw)

    monkeypatch.setattr(port_model, "train_forward", counted)

    def grads(remat):
        cfg = step.TrainConfig(**DISC, remat=remat)
        g_g, g_d, _ = step._micro_grads(
            state, batch, port_hp, cfg, False,
            generator=torch.Generator().manual_seed(9))
        return list(g_g) + list(g_d)

    plain = grads(False)
    assert len(calls) == 1
    remat = grads(True)
    assert len(calls) == 3  # the forward, then its recompute
    assert all(torch.equal(a, b) for a, b in zip(plain, remat))

    # the fault this guards against: a checkpoint that restores only the
    # global RNGs recomputes with fresh dropout masks
    from torch.utils.checkpoint import checkpoint as torch_checkpoint

    monkeypatch.setattr(step, "_checkpointed_forward",
                        lambda fn, gen: torch_checkpoint(
                            fn, use_reentrant=False))
    redrawn = grads(True)
    assert not all(torch.equal(a, b) for a, b in zip(plain, redrawn))


@pytest.fixture(scope="module")
def zero_skeletons():
    """JAX's ``random_params`` as a zero tree of its structure (as in
    tests/test_torch_export.py): the import overwrites the routed leaves,
    and the eager draws would compile ~80 programs."""
    from phoonnx_tpu.models.vits import load as jax_load

    draw = jax_model.random_params

    def skeleton(key, hp):
        shapes = jax.eval_shape(lambda k: draw(k, hp), key)
        return jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), shapes)

    with pytest.MonkeyPatch.context() as patch:
        patch.setattr(jax_model, "random_params", skeleton)
        patch.setattr(jax_load, "random_params", skeleton)
        yield


def _single_speaker_sources(port_hp, tmp_path):
    """A single-speaker micro generator as an exported ONNX graph (the
    decoder folded) and as a Lightning ``.ckpt`` of its training leaves."""
    from phoonnx_tpu_torch.models.vits.load import params_to_flat
    from phoonnx_tpu_torch.onnx.vits_graph import export_vits_onnx
    from phoonnx_tpu_torch.train.export import fold_decoder_weight_norm

    params = port_model.random_params(port_hp,
                                      torch.Generator().manual_seed(21))
    with torch.no_grad():
        flat = params_to_flat(fold_decoder_weight_norm(params))
    onnx_path = tmp_path / "single.onnx"
    export_vits_onnx({k: np.asarray(v) for k, v in flat.items()}, port_hp,
                     str(onnx_path))
    state_dict = {"model_g." + k: torch.from_numpy(np.asarray(v).copy())
                  for k, v in params_to_flat(params).items()}
    state_dict["model_d.something.weight"] = torch.zeros(3)
    ckpt_path = tmp_path / "single.ckpt"
    torch.save({"state_dict": state_dict, "epoch": 7}, ckpt_path)
    return onnx_path, ckpt_path


@pytest.mark.parametrize("source", ["onnx", "ckpt"])
def test_warm_start_matches_jax(port_hp, zero_skeletons, tmp_path, source):
    from phoonnx_tpu.models.vits.load import params_to_flat as jax_to_flat
    from phoonnx_tpu.train.checkpoint import (
        load_generator_warm_start as jax_warm_start)
    from phoonnx_tpu_torch.models.vits.load import params_to_flat

    path = _single_speaker_sources(port_hp, tmp_path)[
        0 if source == "onnx" else 1]
    jhp = dataclasses.replace(PORT_HP, n_speakers=2, gin_channels=16)
    thp = dataclasses.replace(port_hp, n_speakers=2, gin_channels=16)
    cfg = step.TrainConfig(**DISC)
    state = step.init_train_state(thp, cfg, torch.Generator().manual_seed(4))
    fresh = {k: np.asarray(v).copy() for k, v in params_to_flat(
        checkpoint._cpu_copy(state.params_g)).items()}
    out = checkpoint.load_generator_warm_start(str(path), thp,
                                               state.params_g)
    assert out is state.params_g
    ours = params_to_flat(checkpoint._cpu_copy(state.params_g))
    theirs = {k: np.asarray(v) for k, v in jax_to_flat(
        jax_warm_start(str(path), jhp, None)).items()}
    loaded = {k for k in checkpoint.load_generator_flat(str(path))
              if not k.startswith(checkpoint._SPEAKER_COND_PREFIXES)
              and not k.startswith("emb_g.")}
    assert loaded
    folded = 0
    for name in sorted(loaded):
        if name not in theirs:
            continue  # an ONNX graph constant, routed nowhere
        if name in ours:
            np.testing.assert_array_equal(ours[name], theirs[name],
                                          err_msg=name)
        else:  # a folded weight: the port keeps its weight-norm pair
            base = name[:-len(".weight")]
            w = nn.weight_norm(torch.from_numpy(ours[base + ".weight_v"]),
                               torch.from_numpy(ours[base + ".weight_g"]))
            np.testing.assert_allclose(w.numpy(), theirs[name],
                                       rtol=WARM_RTOL, atol=1e-7)
            folded += 1
    assert (folded > 0) == (source == "onnx")
    # speaker conditioning keeps the fresh initialisation
    cond = [k for k in ours if k.startswith("emb_g.")
            or k.startswith(checkpoint._SPEAKER_COND_PREFIXES)]
    assert len(cond) >= 4
    for name in cond:
        np.testing.assert_array_equal(ours[name], fresh[name], err_msg=name)
    # the tree still fits its optimizer: a 2-speaker step
    batch = step.batch_to_device(make_batch(
        PORT_HP, 6, LENGTHS, 10, 40, n_speakers=2), "cpu")
    before = ours["enc_p.emb.weight"].copy()
    state, metrics = step.train_step(state, batch, thp, cfg,
                                     generator=torch.Generator().manual_seed(1))
    assert all(torch.isfinite(v) for v in metrics.values())
    assert not np.array_equal(
        state.params_g["enc_p"]["emb"]["weight"].detach().numpy(), before)
