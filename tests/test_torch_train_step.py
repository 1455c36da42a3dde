"""The port's training step against the JAX package's, on the CPU.

(The gradients of the step's objectives are held against ``jax.grad`` in
``tests/test_torch_train_grads.py``.)

* Updates: three AdamW updates with the staircase schedule on fixed
  gradients against optax, with and without global-norm clipping.
* Checkpoints: a JAX ``checkpoint.save`` of a train state restores into
  the port with equal parameters and optimizer moments; the port's own
  save and restore round-trip.
"""

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch

from phoonnx_tpu.models.vits.model import VitsHParams
from phoonnx_tpu.train import checkpoint as jax_checkpoint
from phoonnx_tpu.train import step as jax_step
from phoonnx_tpu_torch.train import checkpoint, step

from tests.test_torch_train_forward import DISC, jax_flat, make_models, t
from tests.test_torch_train_forward import one_torch_thread  # noqa: F401

HP = VitsHParams.preset("micro", n_vocab=24)
CFG = step.TrainConfig(**DISC)

# AdamW on equal gradients: the two frameworks order the same float32 ops
# differently (optax adds the decay to the update, torch scales the
# parameter first); measured max difference ~1e-8 on values ~1.
UPDATE_ATOL = 1e-6


def _fixed_grads(shapes, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


@pytest.mark.parametrize("grad_clip", [None, 3.0])
def test_three_updates_match_optax(grad_clip):
    shapes = [(4, 3), (5,), (2, 2, 2)]
    rng = np.random.default_rng(0)
    init = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    cfg_kw = dict(learning_rate=1e-2, lr_decay=0.5, steps_per_epoch=2,
                  grad_clip=grad_clip)
    optimizer = jax_step.make_optimizer(jax_step.TrainConfig(**cfg_kw))
    j_params = [jnp.asarray(p) for p in init]
    j_state = optimizer.init(j_params)
    cfg = step.TrainConfig(**cfg_kw)
    t_params = [t(p).requires_grad_(True) for p in init]
    opt = step.make_optimizer(cfg, t_params)
    clipped = 0
    for i in range(3):
        grads = _fixed_grads(shapes, 10 + i)
        if i == 1:
            grads = [0.1 * g for g in grads]  # below the clip norm
        norm = np.sqrt(sum(float(np.sum(g * g)) for g in grads))
        clipped += grad_clip is not None and norm >= grad_clip
        updates, j_state = optimizer.update([jnp.asarray(g) for g in grads],
                                            j_state, j_params)
        j_params = optax.apply_updates(j_params, updates)
        step._update(opt, t_params, [t(g) for g in grads], cfg, i)
        for a, b in zip(t_params, j_params):
            np.testing.assert_allclose(a.detach().numpy(), np.asarray(b),
                                       atol=UPDATE_ATOL, rtol=0)
    assert clipped == (2 if grad_clip is not None else 0)


def test_learning_rate_is_a_staircase():
    cfg = step.TrainConfig(learning_rate=1.0, lr_decay=0.5,
                           steps_per_epoch=3)
    assert [step.learning_rate(cfg, s) for s in range(7)] == [
        1.0, 1.0, 1.0, 0.5, 0.5, 0.5, 0.25]


def _jax_state(jg, jd, seed):
    """A JAX TrainState whose AdamW moments are random, as after one
    update (count 1), built without compiling an update."""
    optimizer = jax_step.make_optimizer(jax_step.TrainConfig(**DISC))
    rng = np.random.default_rng(seed)

    def moments(params, positive):
        return jax.tree.map(lambda p: jnp.asarray(np.abs(
            rng.standard_normal(p.shape)) if positive
            else rng.standard_normal(p.shape), p.dtype), params)

    states = []
    for params in (jg, jd):
        opt_state = optimizer.init(params)
        adam = opt_state[0][0]._replace(
            count=jnp.asarray(1, jnp.int32), mu=moments(params, False),
            nu=moments(params, True))
        states.append((opt_state[0][:0] + (adam,) + opt_state[0][1:],))
    return jax_step.TrainState(params_g=jg, params_d=jd, opt_g=states[0],
                               opt_d=states[1],
                               step=jnp.asarray(7, jnp.int32))


def test_jax_checkpoint_restores_into_the_port(tmp_path):
    jg, jd, _, _, thp = make_models(HP, seed=4)
    jstate = _jax_state(jg, jd, 0)
    path = jax_checkpoint.save(str(tmp_path / "jax"), jstate, HP)
    state = step.init_train_state(thp, CFG, torch.Generator().manual_seed(9))
    checkpoint.restore(path, state)
    assert state.step == 7
    stored = np.load(path)
    for net, tree, opt in (("g", state.params_g, state.opt_g),
                           ("d", state.params_d, state.opt_d)):
        adam = getattr(jstate, f"opt_{net}")[0][0]
        mu, nu = jax_flat(adam.mu, ""), jax_flat(adam.nu, "")
        for name, p in step.keyed_leaves(tree):
            np.testing.assert_array_equal(
                p.detach().numpy(), stored[f".params_{net}{name}"])
            np.testing.assert_array_equal(opt.state[p]["exp_avg"].numpy(),
                                          mu[name])
            np.testing.assert_array_equal(
                opt.state[p]["exp_avg_sq"].numpy(), nu[name])
            assert int(opt.state[p]["step"]) == 1

    # the port's own save restores into a fresh state, equal leaf by leaf
    again = checkpoint.save(str(tmp_path / "port"), state, thp)
    fresh = step.init_train_state(thp, CFG, torch.Generator().manual_seed(1))
    checkpoint.restore(again, fresh)
    assert fresh.step == 7
    for a, b in zip(step.leaves(state.params_g) + step.leaves(state.params_d),
                    step.leaves(fresh.params_g) + step.leaves(fresh.params_d)):
        assert torch.equal(a, b)
    for a, b in zip(step.leaves(state.params_d), step.leaves(fresh.params_d)):
        assert torch.equal(state.opt_d.state[a]["exp_avg_sq"],
                           fresh.opt_d.state[b]["exp_avg_sq"])
    assert checkpoint.latest_checkpoint(str(tmp_path / "port")) == again
    # the generator leaves sit where the JAX package's restore_generator
    # (and its exporter) reads them: the same names and shapes
    ours = np.load(again)
    theirs = jax_flat(jg, ".params_g")
    assert {k for k in ours.files if k.startswith(".params_g")} == set(theirs)
    for key, value in theirs.items():
        assert ours[key].shape == value.shape, key


def test_restore_refuses_a_mismatched_checkpoint(tmp_path):
    _, _, tg, td, thp = make_models(HP, seed=4)
    state = step.init_train_state(thp, CFG)
    path = checkpoint.save(str(tmp_path), state, thp)
    other = step.init_train_state(
        thp, step.TrainConfig(disc_periods=(2, 3, 5), disc_channel_scale=4))
    with pytest.raises(ValueError, match="missing leaf"):
        checkpoint.restore(path, other)
