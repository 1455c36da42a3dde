"""The stochastic duration predictor's training gradient against JAX.

``duration.sdp_nll`` (the SDP's likelihood of the aligned durations,
``phoonnx_tpu/models/vits/duration.py:75``), differentiated with respect
to the predictor's leaves with ``torch.autograd``, against ``jax.grad`` of
the JAX function on the same weights and inputs, leaf by leaf under the
JAX keypath names. Tolerances are stated at
``tests/test_torch_train_forward.py::assert_grads_close``.
"""

import numpy as np
import jax
import jax.numpy as jnp
import torch

from phoonnx_tpu.models.vits import duration as jax_duration
from phoonnx_tpu.models.vits.model import VitsHParams
from phoonnx_tpu_torch.models.vits import duration as port_duration
from phoonnx_tpu_torch.train import step

from tests.test_torch_train_forward import assert_grads_close, make_models
from tests.test_torch_train_forward import one_torch_thread  # noqa: F401


def test_sdp_nll_gradients_match_jax():
    """The SDP's likelihood, differentiated with respect to its leaves,
    against jax.grad (tolerances at assert_grads_close)."""
    hp = VitsHParams.preset("micro", n_vocab=24)
    jg, _, tg, _, _ = make_models(hp, seed=6)
    rng = np.random.default_rng(8)
    mask = (np.arange(10)[None, :] < np.asarray([10, 6])[:, None]
            )[..., None].astype(np.float32)
    x = rng.standard_normal((2, 10, hp.hidden_channels)).astype(np.float32)
    w = rng.integers(1, 6, (2, 10, 1)).astype(np.float32) * mask
    e_q = rng.standard_normal((2, 10, 2)).astype(np.float32)

    def nll(dp):
        return jnp.sum(jax_duration.sdp_nll(
            dp, jnp.asarray(x), jnp.asarray(mask), jnp.asarray(w),
            jnp.asarray(e_q)))

    want = jax.jit(jax.grad(nll))(jg["dp"])
    total = torch.sum(port_duration.sdp_nll(
        tg["dp"], torch.from_numpy(x), torch.from_numpy(mask),
        torch.from_numpy(w), torch.from_numpy(e_q)))
    names = [n for n, _ in step.keyed_leaves(tg["dp"])]
    grads = torch.autograd.grad(total, step.leaves(tg["dp"]))
    _, worst = assert_grads_close(["['dp']" + n for n in names], grads,
                                   {"dp": want})
    print(f"worst relative SDP gradient error: {worst:.2e}")
