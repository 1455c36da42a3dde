"""bf16 synthesis: the port's bfloat16 path against the JAX package's, on
the CPU.

The JAX engine serves in bf16 (``cast_floating`` of every parameter); its
kernels A, B and C keep float32 arithmetic inside and round to bf16 where
they store in the input's type. The port's bf16 plain versions
(``fused_encoder``, ``fused_flow``, ``fused_stage``) compute that function
with the same rounding points, and its CUDA kernels' bf16 builds are held
to them on the card (``tests/test_torch_cuda.py``, ``chip_smoke.py``).
Here each plain version is held to the JAX kernel in interpret mode
(``FORCE_INTERPRET``) and to the float32 truth;
``tests/test_torch_bf16_path.py`` holds the whole path (``model.infer``)
and the engine, ``tests/test_torch_bf16_istft.py`` the iSTFT voices.

Weights: random parameters (``tests.test_torch_train_forward.make_models``)
with weight norm folded in float32 on the JAX tree (an exported voice's
layout), carried to the port by ``params_to_flat`` -> ``params_from_flat``,
then cast to bf16 on each side by its own ``cast_floating``: both compute
on the same bf16 values. (Folding weight norm in bf16 on each side gives
weights one bf16 step apart, which is a difference of the two frameworks'
bf16 arithmetic, not of the kernels.)

Bounds: a bf16 plain version against the JAX kernel <= 2e-3 x max(1,
max|JAX|) (which the float32 function rounded once misses), and against
the float32 truth <= 2e-2 x max(1, max|truth|)
(``tests/test_fused_flow.py:133-134``); the path <= 5e-3 on the valid
waveform. The errors these tests measured stand beside each bound.
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from phoonnx_tpu.infer.engine import cast_floating as jax_cast
from phoonnx_tpu.models.vits import fused_encoder as jax_fused_encoder
from phoonnx_tpu.models.vits import fused_flow as jax_fused_flow
from phoonnx_tpu.models.vits import fused_stage as jax_fused_stage
from phoonnx_tpu.models.vits import modules as jax_modules
from phoonnx_tpu.models.vits import nn as jax_nn
from phoonnx_tpu_torch.models.vits import (fused_encoder, fused_flow,
                                           fused_stage, modules, nn)

from tests import test_torch_train_forward as train_forward
from tests.test_torch_infer import port_params
from tests.test_torch_train_forward import one_torch_thread  # noqa: F401
from tests.test_voice_e2e import SMALL_HP

BF = torch.bfloat16
JBF = jnp.bfloat16

# a bf16 plain version against the JAX kernel in bf16, scaled by
# max(1, max|JAX|); measured: A 0 and 0 (bit-equal), B 4.7e-4 (no g) and
# 0, C 0 and 0. For A and C (B rounds only its output) the float32
# function of the same bf16 weights and input, rounded once at the end,
# must lie further than this from the JAX kernel, so the bound holds the
# kernel's internal rounding points; measured A 5.0e-3 and 4.8e-3, C
# 3.9e-3 and 3.9e-3
KERNEL_TOL = 2e-3
# against the float32 truth, scaled by max(1, max|truth|) (the bound of
# tests/test_fused_flow.py:133-134); measured: A 4.4e-3 and 4.8e-3, B
# 8.7e-3 and 7.0e-3, C 4.6e-3 and 4.3e-3
TRUTH_TOL = 2e-2

_KERNELS = (jax_fused_encoder, jax_fused_flow, jax_fused_stage)


@pytest.fixture(autouse=True)
def _interpret():
    for mod in _KERNELS:
        mod.FORCE_INTERPRET = True
    try:
        yield
    finally:
        for mod in _KERNELS:
            mod.FORCE_INTERPRET = False


def fold_weight_norm(tree):
    """The JAX tree with every weight-normalised conv folded to its
    ``weight`` in float32, as an exported voice carries it."""
    if isinstance(tree, dict):
        out = {k: fold_weight_norm(v) for k, v in tree.items()
               if k not in ("weight_v", "weight_g")}
        if "weight_v" in tree:
            out["weight"] = jax_nn.resolve_weight(tree)
        return out
    if isinstance(tree, list):
        return [fold_weight_norm(v) for v in tree]
    return tree


def fresh_sdp(dp):
    """The stochastic duration predictor's flows as ``random_params``
    makes them: each ConvFlow's ``proj`` and each ElementwiseAffine at 0.

    With the random flows ``train_forward.make_models`` leaves there, the
    duration predictor is ill-conditioned in bf16: over seeds 0-7 the
    largest log-duration error against the float32 truth is 0.05-0.69 in
    the port and 0.07-1.16 in JAX, so the two frameworks' frame counts
    part. At these flows the two agree to a bf16 step.
    ``tests/test_torch_bf16_path.py`` holds the random flows against the
    float32 truth, and the rest of the path on them given the reference's
    durations; the whole-path comparison of durations, frame counts and
    waveform runs here."""
    def flow(f):
        if "cf" in f:
            return dict(f, cf=dict(f["cf"], proj=jax.tree.map(
                jnp.zeros_like, f["cf"]["proj"])))
        if "ea" in f:
            return dict(f, ea=jax.tree.map(jnp.zeros_like, f["ea"]))
        return f

    return dict(dp, flows=[flow(f) for f in dp["flows"]],
                post_flows=[flow(f) for f in dp["post_flows"]])


def make_models(hp, seed=0, fresh_flows=True):
    """(JAX params, port params, port hparams) of equal float32 weights,
    weight norm folded, the coupling flow's post convs random, the
    duration predictor's flows at their init (``fresh_flows``) or random
    (the JAX tree built by tracing: eager JAX init costs ~20 s a tree)."""
    jp = train_forward.make_models(hp, seed)[0]
    if fresh_flows:
        jp = dict(jp, dp=fresh_sdp(jp["dp"]))
    jp = fold_weight_norm(jp)
    tp, thp = port_params(jp, hp)
    return jp, tp, thp


HP = dataclasses.replace(SMALL_HP, resblock_kernel_sizes=(3, 5),
                         resblock_dilation_sizes=((1, 2), (2, 6)))
SPEAKERS_HP = dataclasses.replace(HP, n_speakers=3, gin_channels=8)


def without_speakers(flow):
    """A flow tree without its speaker conditioning (no WaveNet
    ``cond_layer``): the layout of a single-speaker voice's flow."""
    flows = [dict(f, enc={k: v for k, v in f["enc"].items()
                          if k != "cond_layer"}) for f in flow["flows"]]
    return dict(flow, flows=flows)


@pytest.fixture(scope="module")
def models():
    """A multi-speaker model (kernel B with g; without g on its flow
    stripped of the speaker term)."""
    return make_models(SPEAKERS_HP, 1)


def as_np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def check_bf16(got, want, truth, unrounded=None):
    """The port's bf16 output against the JAX kernel's bf16 and the float32
    truth, at the module's bounds; ``unrounded`` (the float32 function of
    the bf16 values rounded once) must miss KERNEL_TOL. Returns the two
    scaled errors."""
    got, want, truth = as_np(got), as_np(want), as_np(truth)
    assert got.shape == want.shape == truth.shape
    scale = max(1.0, np.abs(want).max())
    to_jax = np.abs(got - want).max() / scale
    to_truth = np.abs(got - truth).max() / max(1.0, np.abs(truth).max())
    assert to_jax <= KERNEL_TOL, to_jax
    assert to_truth <= TRUTH_TOL, to_truth
    if unrounded is not None:
        miss = np.abs(as_np(unrounded) - want).max() / scale
        assert miss > KERNEL_TOL, miss
    return to_jax, to_truth


def on_bf16_values(tree):
    """A float32 parameter tree of the bf16-rounded values."""
    return nn.cast_floating(nn.cast_floating(tree, BF), torch.float32)


def _mask(lengths, t):
    return (np.arange(t)[None, :] < np.asarray(lengths)[:, None])[
        ..., None].astype(np.float32)


def bf(a) -> torch.Tensor:
    return torch.from_numpy(np.asarray(a)).to(BF)


# ---------------------------------------------------------------------------
# the kernels' plain versions
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed,lengths,t", [(0, [19, 11], 19),
                                            (1, [7, 30, 22], 30)])
def test_encoder_bf16_matches_jax_kernel(models, seed, lengths, t):
    jp, tp, thp = models
    jspec = jax_fused_encoder.build_spec(jax_cast(jp["enc_p"]["encoder"],
                                                  JBF))
    tspec = fused_encoder.build_spec(nn.cast_floating(tp["enc_p"]["encoder"],
                                                      BF))
    spec32 = fused_encoder.build_spec(tp["enc_p"]["encoder"])
    mask = _mask(lengths, t)
    x = np.random.default_rng(seed).standard_normal(
        (len(lengths), t, thp.hidden_channels)).astype(np.float32) * mask
    x = as_np(bf(x))  # the bf16 values, so the truth sees the same input
    want = jax_fused_encoder.apply(jspec, jnp.asarray(x, JBF),
                                   jnp.asarray(mask, JBF))
    got = fused_encoder.apply(tspec, bf(x), bf(mask))
    assert got.dtype == BF
    truth = fused_encoder.apply(spec32, torch.from_numpy(x),
                                torch.from_numpy(mask))
    unrounded = fused_encoder.apply(
        fused_encoder.build_spec(on_bf16_values(tp["enc_p"]["encoder"])),
        torch.from_numpy(x), torch.from_numpy(mask)).to(BF)
    check_bf16(got, want, truth, unrounded)


@pytest.mark.parametrize("gin", [0, 8])
def test_flow_bf16_matches_jax_kernel(models, gin):
    jp, tp, thp = models
    jflow, tflow = jp["flow"], tp["flow"]
    if not gin:
        jflow, tflow = without_speakers(jflow), without_speakers(tflow)
    jspec = jax_fused_flow.build_spec(jax_cast(jflow, JBF))
    tspec = fused_flow.build_spec(nn.cast_floating(tflow, BF))
    spec32 = fused_flow.build_spec(tflow)
    assert ("cond_w" in tspec) == bool(gin)
    lengths, t = [40, 23], 40
    rng = np.random.default_rng(2 + gin)
    mask = _mask(lengths, t)
    x = rng.standard_normal((2, t, thp.inter_channels)).astype(
        np.float32) * mask
    x = as_np(bf(x))
    g = None
    if gin:
        g = as_np(bf(rng.standard_normal((2, 1, gin)).astype(np.float32)))
    want = jax_fused_flow.apply(
        jspec, jnp.asarray(x, JBF), jnp.asarray(mask, JBF),
        g=None if g is None else jnp.asarray(g, JBF))
    got = fused_flow.apply(tspec, bf(x), bf(mask),
                           g=None if g is None else bf(g))
    assert got.dtype == BF
    truth = fused_flow.apply(spec32, torch.from_numpy(x),
                             torch.from_numpy(mask),
                             g=None if g is None else torch.from_numpy(g))
    check_bf16(got, want, truth)


def _stage_specs(jp, tp, stage, post, dtype_j, dtype_t):
    jdec = jax_cast(jp["dec"], dtype_j)
    tdec = nn.cast_floating(tp["dec"], dtype_t)
    nk = jdec["num_kernels"]
    jpost = tpost = None
    if post:
        jpost = (jdec["conv_post"]["weight"], jdec["conv_post"].get("bias"),
                 3, 0.01)
        tpost = (tdec["conv_post"]["weight"], tdec["conv_post"].get("bias"),
                 3, 0.01)
    jspec = jax_fused_stage.build_group_spec(
        jdec["resblocks"][stage * nk:(stage + 1) * nk], 1,
        jax_modules.LRELU_SLOPE, post=jpost)
    tspec = fused_stage.build_group_spec(
        tdec["resblocks"][stage * nk:(stage + 1) * nk], modules.LRELU_SLOPE,
        post=tpost)
    return jspec, tspec


@pytest.mark.parametrize("stage,post,valid", [(0, False, [150, 97]),
                                              (1, True, [150, 61])])
def test_stage_bf16_matches_jax_kernel(models, stage, post, valid):
    jp, tp, _ = models
    jspec, tspec = _stage_specs(jp, tp, stage, post, JBF, BF)
    _, spec32 = _stage_specs(jp, tp, stage, post, jnp.float32,
                             torch.float32)
    c = tspec["W"].shape[1]
    x = as_np(bf((np.random.default_rng(stage).standard_normal(
        (2, 150, c)) * 0.5).astype(np.float32)))
    valid = np.asarray(valid, np.int32)
    want = jax_fused_stage.apply_group(jspec, jnp.asarray(x, JBF),
                                       valid=jnp.asarray(valid))
    got = fused_stage.apply_group(tspec, bf(x), valid=torch.from_numpy(valid))
    assert got.dtype == BF
    assert got.shape == ((2, 150, 1) if post else x.shape)
    truth = fused_stage.apply_group(spec32, torch.from_numpy(x),
                                    valid=torch.from_numpy(valid))
    _, spec_values = _stage_specs(jp, dict(tp, dec=on_bf16_values(tp["dec"])), stage, post,
                                  jnp.float32, torch.float32)
    unrounded = fused_stage.apply_group(
        spec_values, torch.from_numpy(x), valid=torch.from_numpy(valid))
    check_bf16(got, want, truth, unrounded.to(BF))
    if not post:
        for i, n in enumerate(valid):
            assert np.all(as_np(got)[i, n:] == 0.0)


def test_float32_plain_versions_unchanged(models):
    """The bf16 rounding points are the identity in float32: the rounded
    encoder and stage formulas on float32 tensors give the float32 plain
    versions (the general modules) to summation order."""
    _, tp, thp = models
    spec = fused_encoder.build_spec(tp["enc_p"]["encoder"])
    mask = torch.from_numpy(_mask([13, 9], 13))
    x = torch.randn(2, 13, thp.hidden_channels,
                    generator=torch.Generator().manual_seed(3)) * mask
    np.testing.assert_allclose(
        fused_encoder._plain_rounded(spec, x, mask).numpy(),
        fused_encoder.plain(spec, x, mask).numpy(), atol=1e-5, rtol=0)
    stage_spec = fused_stage.build_group_spec(
        tp["dec"]["resblocks"][:tp["dec"]["num_kernels"]],
        modules.LRELU_SLOPE)
    x = torch.randn(2, 40, stage_spec["W"].shape[1],
                    generator=torch.Generator().manual_seed(4)) * 0.5
    valid = torch.tensor([40, 25], dtype=torch.int32)
    np.testing.assert_allclose(
        fused_stage._plain_rounded(stage_spec, x, valid).numpy(),
        fused_stage.plain(stage_spec, x, valid).numpy(), atol=1e-5, rtol=0)
