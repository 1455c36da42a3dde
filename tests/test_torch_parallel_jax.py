"""The port's two-rank data-parallel step against the JAX package's step
on a two-device mesh, on the CPU.

Equal weights on both sides (``make_models``: the port's initialisation,
the zero-initialised projections randomised), dropout off on both sides
(the port without a generator, JAX's ``nn.dropout`` the identity for the
test), JAX's own noise (``jax_noise`` of the step's key) split by rows
into the two ranks, which run in spawned processes over gloo
(``tests/test_torch_parallel.py``'s ranks) while the parent compiles
JAX's ``_micro_grads`` over a ``make_mesh(n_data=2)`` mesh. The
tolerances are ``assert_grads_close``'s; the losses are held at
``LOSS_RTOL`` (``tests/test_multidevice_equivalence.py:50``).
"""

import numpy as np
import jax
import jax.numpy as jnp
import torch

from phoonnx_tpu.models.vits import nn as jax_nn
from phoonnx_tpu.models.vits.model import VitsHParams
from phoonnx_tpu.parallel import make_mesh, shard_batch, shard_train_state
from phoonnx_tpu.train import step as jax_step
from phoonnx_tpu_torch.train import step

from tests.test_torch_parallel import (LENGTHS, LOSS_RTOL, T_X, T_Y, WORLD,
                                       make_batch, random_weights, rank_main,
                                       run_cases, start_ranks, wait_ranks)
from tests.test_torch_infer import port_hparams
from tests.test_torch_train_forward import (DISC, assert_grads_close,
                                            jax_noise, make_models)
from tests.test_torch_train_forward import one_torch_thread  # noqa: F401

# the deterministic duration predictor, as tests/test_torch_train_grads.py:
# it keeps JAX's compile inside the file's time
HP = VitsHParams.preset("micro", n_vocab=24, use_sdp=False)
KEY = 5


def test_two_ranks_match_the_jax_mesh(tmp_path, monkeypatch):
    thp = port_hparams(HP)
    # make_models' weights, the port's side first so the ranks start early
    flat = random_weights(thp, step.TrainConfig(**DISC), seed=2)
    batch = make_batch(LENGTHS, 7)
    noise = {k: v.numpy() for k, v in jax_noise(
        jax.random.PRNGKey(KEY), HP, len(LENGTHS), T_X, T_Y).items()}
    procs = start_ranks(rank_main, WORLD, tmp_path, run_cases, {"jax": dict(
        batch=batch, noise=noise, seed=None, hp=thp, weights=flat)})
    jg, jd, tg, td, _ = make_models(HP, seed=2)
    assert all(np.array_equal(flat[f".params_g{n}"], t.detach().numpy())
               for n, t in step.keyed_leaves(tg))

    monkeypatch.setattr(jax_nn, "dropout",
                        lambda x, rate, rng, deterministic: x)
    cfg = jax_step.TrainConfig(**DISC)
    mesh = make_mesh(n_data=WORLD)
    state = shard_train_state(mesh, jax_step.TrainState(
        jg, jd, None, None, jnp.zeros((), jnp.int32)))
    want_g, want_d, want_m = jax.jit(
        lambda s, b, k: jax_step._micro_grads(s, b, k, HP, cfg,
                                              eval_mode=False))(
        state, shard_batch(mesh, {k: jnp.asarray(v)
                                  for k, v in batch.items()}),
        jax.random.PRNGKey(KEY))

    ranks = wait_ranks(procs, tmp_path)
    got = ranks[0]["jax"]
    for key in ("g", "d"):
        assert all(torch.equal(a, b) for a, b in zip(got[key],
                                                     ranks[1]["jax"][key]))
    worst_g, _ = assert_grads_close(
        [n for n, _ in step.keyed_leaves(tg)], got["g"], want_g)
    worst_d, _ = assert_grads_close(
        [n for n, _ in step.keyed_leaves(td)], got["d"], want_d)
    print(f"2 ranks vs the JAX mesh: worst relative gradient error G "
          f"{worst_g:.2e}, D {worst_d:.2e}")
    for k in step.METRICS:
        np.testing.assert_allclose(got["m"][k], float(want_m[k]),
                                   rtol=LOSS_RTOL, err_msg=k)
