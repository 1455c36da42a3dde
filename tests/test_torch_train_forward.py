"""The port's training forward against the JAX package's, on the CPU.

``tests/test_torch_train_modules.py`` holds the modules it is built from,
with the helpers defined here.

The same weights reach both sides the way a checkpoint carries them: a
flat dict under the JAX keypath names (``.params_g['enc_p']...``) fills
the JAX trees (their structure from ``jax.eval_shape`` of the JAX
initialisers) and the port's, through ``checkpoint.trees_from_flat``.
The values come from the port's initialiser, with the zero-initialised
projections (the flows' ``post``, the SDP flows' ``proj``, the elementwise
affines) randomised so every coupling and spline does real work. Inputs
are made with numpy from a seed; the noise is JAX's own draw (the splits
of ``model.py:312``), injected into the port.
Everything runs in float32 with dropout off (``deterministic=True``);
dropout is checked for its keep rate and scaling only, since the two
frameworks draw different bits.

Tolerances: both sides are float32 and differ only in summation order.
Per-module outputs are held to 1e-5 absolute plus 1e-5 relative (the
measured differences are ~1e-6 relative); the whole training forward to
1e-4 relative of each output's scale, since the posterior sample goes
through exp(logs_q) and the flow couples four WaveNets (measured ~2e-6).
The spline's knots are differences of cumulative sums, which the two
frameworks round differently; with unit-scale random logits a narrow bin
carries that rounding relative to its width, and the log-determinant
differs by up to 8.3e-5 (inverse) and 1.4e-5 (forward) on values up to 7,
so it is held to 5e-5 of its scale.
"""

import dataclasses
import functools
import re

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from phoonnx_tpu.models.vits import discriminator as jax_disc
from phoonnx_tpu.models.vits import model as jax_model
from phoonnx_tpu_torch.models.vits import model
from phoonnx_tpu_torch.train import checkpoint
from phoonnx_tpu_torch.train.step import (TrainConfig, init_train_state,
                                          keyed_leaves)

from tests.test_torch_infer import port_hparams
from tests.test_voice_e2e import SMALL_HP

ATOL = RTOL = 1e-5
FORWARD_RTOL = 1e-4
SPLINE_LOGDET_ATOL = 5e-5
GRAD_RTOL = 1e-4
SDP_GRAD_RTOL = 1e-2
GRAD_FLOOR = 1.0

DISC = dict(disc_periods=(2, 3), disc_channel_scale=4)
GIN_HP = dataclasses.replace(SMALL_HP, n_speakers=3, gin_channels=8)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Run the module's torch ops on one thread. Training runs thousands of
    tiny ops, and under the parallel test run an OpenMP pool on every
    worker oversubscribes the cores, where each op's barrier waits on
    descheduled threads (a 0.2 ms conv measured at 7 ms). The previous
    count is restored for the worker's next module."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def jax_flat(tree, prefix: str) -> dict:
    """A JAX tree as its checkpoint flattens it: keypath name -> array."""
    return {prefix + jax.tree_util.keystr(path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


def jax_tree(init_fn, flat: dict, prefix: str):
    """The JAX tree ``init_fn(key)`` builds, its leaves taken from
    ``flat`` by keypath name."""
    shapes = jax.eval_shape(init_fn, jax.random.PRNGKey(0))
    paths, treedef = jax.tree_util.tree_flatten_with_path(shapes)
    leaves = []
    for path, shape in paths:
        value = flat[prefix + jax.tree_util.keystr(path)]
        assert value.shape == shape.shape, path
        leaves.append(jnp.asarray(value))
    return jax.tree_util.tree_unflatten(treedef, leaves)


_ZERO_INIT = re.compile(
    r"\['flow'\]\['flows'\]\[\d+\]\['post'\]|\['cf'\]\['proj'\]|\['ea'\]")


@functools.lru_cache(maxsize=None)
def make_models(hp, seed=0):
    """(JAX G, JAX D, port G, port D, port hparams) with equal weights."""
    thp = port_hparams(hp)
    cfg = TrainConfig(**DISC)
    state = init_train_state(thp, cfg, torch.Generator().manual_seed(seed))
    flat = {}
    for net, tree in (("g", state.params_g), ("d", state.params_d)):
        for name, leaf in keyed_leaves(tree):
            flat[f".params_{net}{name}"] = leaf.detach().numpy().copy()
    rng = np.random.default_rng(seed + 100)
    for name in sorted(flat):
        if _ZERO_INIT.search(name):
            flat[name] = (0.3 * rng.standard_normal(flat[name].shape)
                          ).astype(np.float32)
    jg = jax_tree(lambda k: jax_model.random_params(k, hp), flat,
                  ".params_g")
    jd = jax_tree(lambda k: jax_disc.init_multi_period_discriminator(
        k, periods=DISC["disc_periods"],
        channel_scale=DISC["disc_channel_scale"]), flat, ".params_d")
    tg, td = checkpoint.trees_from_flat(flat, thp, cfg)
    return jg, jd, tg, td, thp


@pytest.fixture(scope="module")
def models():
    return make_models(SMALL_HP)


def make_batch(hp, seed, lengths, t_x, t_y, n_speakers=1):
    """A loader-shaped batch: ids, lengths, a spectrogram and audio."""
    rng = np.random.default_rng(seed)
    b = len(lengths)
    ids = rng.integers(1, hp.n_vocab, (b, t_x)).astype(np.int32)
    x_len = np.asarray([x for x, _ in lengths], np.int32)
    y_len = np.asarray([y for _, y in lengths], np.int32)
    spec = (0.3 * np.abs(rng.standard_normal((b, t_y, hp.spec_channels)))
            ).astype(np.float32)
    spec *= np.arange(t_y)[None, :, None] < y_len[:, None, None]
    audio = (0.3 * rng.standard_normal((b, t_y * hp.hop_length))
             ).astype(np.float32)
    batch = {"phoneme_ids": ids, "phoneme_lengths": x_len, "spec": spec,
             "spec_lengths": y_len, "audio": audio}
    if n_speakers > 1:
        batch["sid"] = rng.integers(0, n_speakers, (b,)).astype(np.int32)
    return batch


def jax_noise(key, hp, b, t_x, t_y):
    """The noise JAX ``train_forward`` draws from ``key``, as port inputs."""
    _, k_post, k_sdp, k_slice, _ = jax.random.split(key, 5)
    return {
        "post_noise": torch.from_numpy(np.array(jax.random.normal(
            k_post, (b, t_y, hp.inter_channels)))),
        "e_q": torch.from_numpy(np.array(jax.random.normal(
            k_sdp, (b, t_x, 2)))),
        "slice_u": torch.from_numpy(np.array(jax.random.uniform(
            k_slice, (b,)))),
    }


def t(a):
    return torch.from_numpy(np.array(a))


def close(got, want, atol=ATOL, rtol=RTOL):
    """Equal to ``atol`` times the output's scale (at least 1) plus
    ``rtol``: float32 rounding grows with the magnitudes summed."""
    want = np.asarray(want)
    scale = max(1.0, float(np.abs(want).max())) if want.size else 1.0
    np.testing.assert_allclose(np.asarray(got.detach()), want,
                               atol=atol * scale, rtol=rtol)


def assert_grads_close(names, grads, want_tree):
    """Gradients leaf by leaf under the keypath names, float32 on both
    sides, relative to each leaf's largest entry, at least GRAD_FLOOR (an
    attention key bias's gradient is zero in exact arithmetic and holds
    6e-6 of rounding noise): GRAD_RTOL (measured worst 8.4e-6 elsewhere),
    and SDP_GRAD_RTOL for the stochastic duration predictor, whose splines
    take knots as differences of cumulative sums that the two frameworks
    round differently (measured 3.0e-4 on its likelihood alone, 2.5e-3
    inside the whole objective). Returns the worst relative error outside
    the duration predictor and inside it."""
    want = jax_flat(want_tree, "")
    assert set(names) == set(want)
    worst = {False: 0.0, True: 0.0}
    for name, g in zip(names, grads):
        w = want[name]
        sdp = name.startswith("['dp']")
        scale = max(float(np.abs(w).max()), GRAD_FLOOR)
        err = float(np.abs(g.numpy() - w).max())
        worst[sdp] = max(worst[sdp], err / scale)
        assert err <= (SDP_GRAD_RTOL if sdp else GRAD_RTOL) * scale, \
            (name, err, scale)
    return worst[False], worst[True]


def _mask(lengths, t_len):
    return (np.arange(t_len)[None, :] < np.asarray(lengths)[:, None]
            )[..., None].astype(np.float32)


@pytest.mark.parametrize("hp", [SMALL_HP, GIN_HP], ids=["no_gin", "gin"])
def test_train_forward_matches_jax(hp):
    jg, _, tg, _, thp = make_models(hp, seed=11)
    lengths = [(12, 64), (9, 50), (5, 33)]
    batch = make_batch(hp, 8, lengths, 12, 64, n_speakers=hp.n_speakers)
    key = jax.random.PRNGKey(3)
    sid = batch.get("sid")
    want = jax_model.train_forward(
        jg, hp, key, jnp.asarray(batch["phoneme_ids"]),
        jnp.asarray(batch["phoneme_lengths"]), jnp.asarray(batch["spec"]),
        jnp.asarray(batch["spec_lengths"]),
        sid=None if sid is None else jnp.asarray(sid), deterministic=True)
    got = model.train_forward(
        tg, thp, t(batch["phoneme_ids"]).long(), t(batch["phoneme_lengths"]),
        t(batch["spec"]), t(batch["spec_lengths"]),
        sid=None if sid is None else t(sid).long(), deterministic=True,
        **jax_noise(key, hp, 3, 12, 64))
    assert set(got) == set(want)
    # the alignment, the durations it implies and the slice offsets agree
    # exactly; everything else to float32 summation order
    np.testing.assert_array_equal(got["attn"].numpy(), np.asarray(want["attn"]))
    np.testing.assert_array_equal(got["ids_slice"].numpy(),
                                  np.asarray(want["ids_slice"]))
    for key_ in want:
        close(got[key_], want[key_], atol=FORWARD_RTOL, rtol=FORWARD_RTOL)
    assert got["audio"].shape == (3, hp.segment_size * hp.total_upsample)
    assert got["attn"].sum().item() == sum(y for _, y in lengths)
