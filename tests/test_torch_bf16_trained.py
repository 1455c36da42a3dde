"""bf16 durations of a TRAINED voice, in the port and in JAX.

ROADMAP §3: with random duration-predictor flows a bf16 step moves
log-durations far. A trained voice's flows are the case that matters: the
convergence run (``train/scale_run.py``) measures its exported voice in
bf16 against float32 on the card. This file holds the port's bf16 error on
a trained voice against JAX's on the same weights, ids and noise: a micro
voice trained by the port on the CPU for two epochs, exported, its ONNX
initializers imported by both packages. The witness is float32, where the
two packages agree; in bf16 the port's signed mean error (the bias that
moves every ceil() one way) and its largest error stay within
``SDP_ROOM`` of JAX's.

Over any exported voice (the convergence run's, for example), as a report:

    JAX_PLATFORMS=cpu python -m tests.test_torch_bf16_trained VOICE.onnx \\
        DATASET.jsonl [N_UTTERANCES]
"""

import json
import sys
from functools import partial

import numpy as np
import pytest
import torch

import chip_smoke
from phoonnx_tpu_torch.models.vits import load as port_load
from phoonnx_tpu_torch.models.vits import model as port_model
from phoonnx_tpu_torch.models.vits import nn as port_nn
from phoonnx_tpu_torch.models.vits.model import VitsHParams
from phoonnx_tpu_torch.onnx.reader import read_onnx
from phoonnx_tpu_torch.train import trainer
from phoonnx_tpu_torch.train.export import run_export

from tests.test_torch_train_forward import one_torch_thread  # noqa: F401

NOISE_W = 0.8
# as tests/test_torch_bf16_path.py: the port's bf16 error may be at most
# this many times JAX's
SDP_ROOM = 1.25


def jax_params(named, strict=True):
    """The JAX package's parameter tree of the exported initializers. Its
    import starts from a ``random_params`` tree that it overwrites leaf by
    leaf; a zero tree of the same structure (``jax.eval_shape``) takes its
    place, so nothing is compiled."""
    import jax

    from phoonnx_tpu.models.vits import load as jax_load

    draw = jax_load.random_params

    def skeleton(key, hp):
        shapes = jax.eval_shape(lambda k: draw(k, hp), key)
        return jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), shapes)

    with pytest.MonkeyPatch.context() as patch:
        patch.setattr(jax_load, "random_params", skeleton)
        return jax_load.params_from_flat(
            named, jax_load.infer_hparams_from_flat(named), strict=strict)


def _jax_logw(enc_p, dp, ids, lengths, noise):
    import jax.numpy as jnp

    from phoonnx_tpu.models.vits import duration, encoder, nn

    dtype = enc_p["emb"]["weight"].dtype
    mask = nn.sequence_mask(lengths, ids.shape[1])[..., None].astype(dtype)
    x, _, _ = encoder.text_encoder(enc_p, ids, mask)
    logw = duration.sdp_reverse(dp, x, mask, noise.astype(dtype)
                                * jnp.asarray(NOISE_W, dtype))
    return (logw.astype(jnp.float32) * mask.astype(jnp.float32))[..., 0]


def log_durations(named, utterances, seed=0, strict=True):
    """{(package, dtype): log-durations [B, T] float32} of ``utterances``
    (lists of ids) padded to one batch, on one draw of duration noise, and
    the lengths. ``strict``: every weight of both packages' trees comes
    from ``named``."""
    import jax
    import jax.numpy as jnp

    from phoonnx_tpu.infer.engine import cast_floating

    lengths = np.array([len(u) for u in utterances], np.int32)
    ids = np.zeros((len(utterances), lengths.max()), np.int64)
    for i, u in enumerate(utterances):
        ids[i, :len(u)] = u
    noise = np.random.default_rng(seed).standard_normal(
        (*ids.shape, 2)).astype(np.float32)
    hp = port_load.infer_hparams_from_flat(named)
    params = port_load.params_from_flat(named, hp, strict=strict)
    jp = jax_params(named, strict)
    jit = jax.jit(_jax_logw)
    out = {}
    for name, tdt, jdt in (("float32", torch.float32, jnp.float32),
                           ("bfloat16", torch.bfloat16, jnp.bfloat16)):
        p = port_nn.cast_floating(params, tdt)
        with torch.inference_mode():
            out["port", name] = port_model.infer_log_durations(
                p, hp, torch.from_numpy(ids), torch.from_numpy(lengths),
                NOISE_W, dp_noise=torch.from_numpy(noise).to(tdt)).numpy()
        cast = partial(cast_floating, dtype=jdt)
        out["jax", name] = np.asarray(jit(
            cast(jp["enc_p"]), cast(jp["dp"]), jnp.asarray(ids, jnp.int32),
            jnp.asarray(lengths), jnp.asarray(noise)))
    return out, lengths


def report(out, lengths):
    """Each package's bf16 less float32 log-durations over the valid
    positions: signed mean, mean and largest magnitude, and each
    utterance's frames (sum of ceil(exp(logw))) in both dtypes."""
    valid = np.arange(out["port", "float32"].shape[1]) < lengths[:, None]
    rows = {"witness": float(np.abs(out["port", "float32"]
                                    - out["jax", "float32"])[valid].max())}
    for pkg in ("port", "jax"):
        diff = (out[pkg, "bfloat16"] - out[pkg, "float32"])[valid]
        frames = {dtype: (np.ceil(np.exp(out[pkg, dtype])) * valid).sum(1)
                  for dtype in ("float32", "bfloat16")}
        rows[pkg] = {
            "signed_mean": float(diff.mean()),
            "mean": float(np.abs(diff).mean()),
            "max": float(np.abs(diff).max()),
            "frames_bf16_minus_float32": [
                int(b - f) for b, f in zip(frames["bfloat16"],
                                           frames["float32"])],
            "frames_float32": [int(f) for f in frames["float32"]]}
    return rows


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """A micro voice trained by the port on the CPU (11 tone utterances,
    two epochs), exported; its initializers and training utterances."""
    root = tmp_path_factory.mktemp("trained")
    hp = VitsHParams.preset("micro", n_vocab=40)
    data = chip_smoke.write_dataset(torch, root / "data", hp, 11, seed=1,
                                    seconds=(0.05, 0.12))
    run = trainer.run_training(
        str(data), quality="micro", batch_size=4, max_epochs=2,
        num_test_examples=0, disc_periods=(2,), disc_channel_scale=4,
        seed=5, device="cpu")
    voice = run_export(run.checkpoint, str(data / "config.json"),
                       str(root / "voice"), quality="micro",
                       executable_graph=False)
    utterances = [json.loads(line)["phoneme_ids"] for line in
                  (data / "dataset.jsonl").read_text().splitlines()]
    return read_onnx(str(voice)).initializers, utterances


def test_trained_voice_bf16_durations_against_jax(trained):
    named, utterances = trained
    rows = report(*log_durations(named, utterances))
    print(json.dumps(rows))
    # float32: the two packages compute the same log-durations
    assert rows["witness"] <= 1e-4, rows["witness"]
    port, jax_ = rows["port"], rows["jax"]
    assert port["max"] <= SDP_ROOM * jax_["max"], (port, jax_)
    assert port["mean"] <= SDP_ROOM * jax_["mean"], (port, jax_)
    # the bias of the bf16 log-durations (its sign is the voice's; -9.4e-4
    # in the port and -1.0e-3 in JAX on this one): the port's within
    # SDP_ROOM of JAX's, or a tenth of JAX's mean error where it is near 0
    room = max((SDP_ROOM - 1) * abs(jax_["signed_mean"]), 0.1 * jax_["mean"])
    assert abs(port["signed_mean"] - jax_["signed_mean"]) <= room, (
        port, jax_)


def main(argv):
    voice, dataset = argv[:2]
    n = int(argv[2]) if len(argv) > 2 else None
    utterances = [json.loads(line)["phoneme_ids"] for line in
                  open(dataset, encoding="utf-8").read().splitlines()][:n]
    # an executable export holds no posterior encoder (the durations do not
    # need one) and graph constants that are not weights
    named = read_onnx(voice).initializers
    print(json.dumps(report(*log_durations(named, utterances, strict=False)),
                     indent=1))


if __name__ == "__main__":
    main(sys.argv[1:])
