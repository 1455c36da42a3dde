"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``: each test needs an NVIDIA GPU and ``nvcc`` and skips
without them (the CPU suite imports this file and skips every test). On
the machine with the card, which has no JAX for ``tests/conftest.py`` to
import, run them with::

    python -m pytest --noconftest tests/test_torch_cuda.py -q

The shapes are small; ``chip_smoke.py`` runs the same comparisons at the
medium preset's shapes and drives the whole synthesis path.
"""

import ctypes

import numpy as np
import pytest
import torch

from phoonnx_tpu_torch.models.vits import (attention, fused_encoder,
                                           fused_flow, fused_stage, hifigan,
                                           model, modules, posterior)
from phoonnx_tpu_torch.ops import mas

pytestmark = pytest.mark.cuda

# f32 on both sides: the kernels and the plain version (cuDNN / cuBLAS with
# TF32 off) sum in other orders; observed differences are ~1e-6.
TOL = 1e-4


@pytest.fixture(scope="module")
def device():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the kernels run only on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.fixture(scope="module")
def params(device):
    hp = model.VitsHParams.preset("medium", n_layers=2)
    p = model.random_params(hp, torch.Generator().manual_seed(0))
    gen = torch.Generator().manual_seed(1)
    for flow in p["flow"]["flows"]:  # zero post would make the flow identity
        for key in ("weight", "bias"):
            flow["post"][key] = 0.05 * torch.randn(flow["post"][key].shape,
                                                   generator=gen)
    return model.attach_fused_specs(model.params_to_device(p, device))


def _mask(lengths, t, device):
    pos = torch.arange(t, device=device)[None, :]
    return (pos < torch.tensor(lengths, device=device)[:, None])[..., None].float()


def test_encoder_kernel(device, params):
    spec = params["enc_p"]["encoder"]["fused"]
    mask = _mask([40, 23], 40, device)
    x = torch.randn(2, 40, 192, device=device) * mask
    before = fused_encoder.launches
    got = fused_encoder.apply(spec, x, mask)
    assert fused_encoder.launches == before + 1
    want = fused_encoder.plain(spec, x, mask)
    torch.cuda.synchronize()
    assert (got - want).abs().max().item() < TOL
    assert (got[1, 23:] == 0).all()


def test_flow_kernel(device, params):
    spec = params["flow"]["fused_rev"]
    mask = _mask([64, 37], 64, device)
    x = torch.randn(2, 64, 192, device=device) * mask
    got = fused_flow.apply(spec, x, mask)
    want = fused_flow.plain(spec, x, mask)
    torch.cuda.synchronize()
    assert (got - want).abs().max().item() < TOL
    assert (got - x).abs().max().item() > 1e-3


# ragged batches of 1 and 4; lengths no multiple of any tile (16 rows, 32
# columns, 16-deep slabs); T just above the attention window (4); T = 1024
@pytest.mark.parametrize("lengths", [[37], [509, 300, 77, 6], [5],
                                     [6, 6, 2, 1], [1024, 700],
                                     [128, 97, 64, 33], [3333]])
def test_encoder_kernel_shapes(device, params, lengths):
    """Kernel A, one cooperative launch per apply, against its plain
    version; padded rows exactly 0 and repeated calls bit-identical (its
    split-K parts are summed in a fixed order)."""
    spec = params["enc_p"]["encoder"]["fused"]
    t = max(lengths)
    mask = _mask(lengths, t, device)
    gen = torch.Generator(device=device).manual_seed(t)
    x = torch.randn(len(lengths), t, 192, device=device, generator=gen) * mask
    before = fused_encoder.launches
    got = fused_encoder.apply(spec, x, mask)
    assert fused_encoder.launches == before + 1
    again = fused_encoder.apply(spec, x, mask)
    assert fused_encoder.launches == before + 2
    want = fused_encoder.plain(spec, x, mask)
    torch.cuda.synchronize()
    assert (got - want).abs().max().item() < TOL
    assert torch.equal(got, again)
    for i, n in enumerate(lengths):
        assert (got[i, n:] == 0).all()


@pytest.fixture(scope="module")
def flow_g(device):
    """A multi-speaker flow of the medium widths (gin 256)."""
    gen = torch.Generator().manual_seed(3)
    flow = posterior.init_residual_coupling_block(gen, 192, 192, 5, 1, 4,
                                                  gin_channels=256)
    for f in flow["flows"]:
        for key in ("weight", "bias"):
            f["post"][key] = 0.05 * torch.randn(f["post"][key].shape,
                                                generator=gen)
    return fused_flow.build_spec(model.params_to_device(flow, device))


@pytest.mark.parametrize("lengths,gin", [([37], 0), ([509, 300, 77, 6], 0),
                                         ([1], 0), ([1, 1], 256),
                                         ([512, 300], 256),
                                         ([37, 20, 37, 5], 256)])
def test_flow_kernel_shapes(device, params, flow_g, lengths, gin):
    """Kernel B, one cooperative launch per apply, against its plain
    version, with and without the speaker term."""
    spec = flow_g if gin else params["flow"]["fused_rev"]
    t = max(lengths)
    mask = _mask(lengths, t, device)
    gen = torch.Generator(device=device).manual_seed(t + gin)
    x = torch.randn(len(lengths), t, 192, device=device, generator=gen) * mask
    g = (torch.randn(len(lengths), 1, gin, device=device, generator=gen)
         if gin else None)
    before = fused_flow.launches
    got = fused_flow.apply(spec, x, mask, g=g)
    assert fused_flow.launches == before + 1
    want = fused_flow.plain(spec, x, mask, g=g)
    torch.cuda.synchronize()
    assert (got - want).abs().max().item() < TOL
    assert (got - x).abs().max().item() > 1e-3


def test_encoder_refuses_long_text(device, params):
    """Past the 227 KB of shared memory a block may hold, kernel A raises
    the same error as before its redesign."""
    t = 3400
    mask = _mask([t], t, device)
    with pytest.raises(ValueError, match="227 KB"):
        fused_encoder.apply(params["enc_p"]["encoder"]["fused"],
                            torch.zeros(1, t, 192, device=device), mask)


@pytest.mark.parametrize("stage", [0, 1, 2])
def test_stage_kernel(device, params, stage):
    spec = params["dec"]["fused_stages"][stage]
    c = 128 // (2 ** stage)
    x = torch.randn(2, 300, c, device=device) * 0.5
    valid = torch.tensor([300, 171], dtype=torch.int32, device=device)
    got = fused_stage.apply_group(spec, x, valid=valid)
    want = fused_stage.plain(spec, x, valid)
    torch.cuda.synchronize()
    assert got.shape == want.shape
    assert (got - want).abs().max().item() < TOL


def test_kernels_refuse_other_dtypes(device, params):
    spec = params["dec"]["fused_stages"][0]
    x = torch.randn(1, 50, 128, device=device, dtype=torch.float16)
    with pytest.raises(TypeError, match="float32"):
        fused_stage.apply_group(spec, x)
    mask = _mask([8], 8, device)
    with pytest.raises(TypeError, match="float32"):
        fused_encoder.apply(params["enc_p"]["encoder"]["fused"],
                            torch.zeros(1, 8, 192, device=device,
                                        dtype=torch.float64), mask)


def test_resblock1_group_kernel(device):
    """resblock "1" (two-conv residual units) is not on the medium path,
    but the kernel takes it; hold it to its plain version too."""
    hp = model.VitsHParams.preset("high", n_layers=1)
    dec = model.params_to_device(
        model.random_params(hp, torch.Generator().manual_seed(2))["dec"],
        device)
    nk = dec["num_kernels"]
    spec = fused_stage.build_group_spec(dec["resblocks"][3 * nk:4 * nk],
                                        modules.LRELU_SLOPE)
    x = torch.randn(1, 257, 32, device=device) * 0.5
    valid = torch.tensor([200], dtype=torch.int32, device=device)
    got = fused_stage.apply_group(spec, x, valid=valid)
    want = fused_stage.plain(spec, x, valid)
    torch.cuda.synchronize()
    assert np.isfinite(got.cpu().numpy()).all()
    assert (got - want).abs().max().item() < TOL


def _mas_case(lengths, device, seed=5):
    b = len(lengths)
    t_y = max(y for y, _ in lengths)
    t_x = max(x for _, x in lengths)
    gen = torch.Generator(device=device).manual_seed(seed)
    neg_cent = torch.randn(b, t_y, t_x, device=device, generator=gen)
    neg_cent[0] = torch.round(neg_cent[0] * 2)
    mask = torch.zeros(b, t_y, t_x, device=device)
    for i, (y, x) in enumerate(lengths):
        mask[i, :y, :x] = 1
    return neg_cent, mask


@pytest.mark.parametrize("lengths", mas.EDGES)
def test_mas_kernel(device, lengths):
    """Kernel D is bit-identical to its plain version: ragged batches, an
    x_len above y_len, ties from integer scores, T_y above 256, and the
    edge shapes of its tiling."""
    neg_cent, mask = _mas_case(lengths, device)
    value, y_lens, x_lens = mas.lengths_and_value(neg_cent, mask)
    before = mas.launches
    got = mas.maximum_path(neg_cent, mask)
    assert mas.launches == before + 1
    want = mas.maximum_path_plain(value, y_lens, x_lens) * mask
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert torch.equal(mas.launch(value, y_lens, x_lens),
                       mas.maximum_path_plain(value, y_lens, x_lens))


@pytest.mark.parametrize("t_x", [64, 200, 320, 500, 1024, 1100])
def test_mas_kernel_warps(device, t_x):
    """Every split of a row that ``mas.plan`` picks gives the plain
    version's path, with the stamps in order: one warp, the named barrier
    between 2, 3, 4 and 8 warps, and the 32-cell build (T_x above 1024)."""
    neg_cent, mask = _mas_case([(400, t_x), (350, t_x - 20), (200, t_x)],
                               device)
    value, y_lens, x_lens = mas.lengths_and_value(neg_cent, mask)
    stamps = torch.zeros(len(mas.phases()) + 1, dtype=torch.int64,
                         device=device)
    got = mas.launch(value, y_lens, x_lens, stamps=stamps)
    torch.cuda.synchronize()
    assert torch.equal(got, mas.maximum_path_plain(value, y_lens, x_lens))
    assert bool((stamps.diff() >= 0).all()) and int(stamps[0]) > 0


def test_missing_specs_raise_on_the_card(device, params):
    """On the GPU the path runs the kernels or raises: parameters without
    their kernel specs do not run the plain versions there."""
    enc = {k: v for k, v in params["enc_p"]["encoder"].items()
           if k != "fused"}
    flow = {k: v for k, v in params["flow"].items() if k != "fused_rev"}
    dec = {k: v for k, v in params["dec"].items() if k != "fused_stages"}
    mask = _mask([8], 8, device)
    with pytest.raises(ValueError, match="kernel A"):
        attention.encoder(enc, torch.zeros(1, 8, 192, device=device), mask)
    with pytest.raises(ValueError, match="kernel B"):
        posterior.coupling_flow(flow, torch.zeros(1, 8, 192, device=device),
                                mask, reverse=True)
    with pytest.raises(ValueError, match="kernel C"):
        hifigan.generator(dec, torch.zeros(1, 8, 192, device=device))


# ---- kernel C's 3xTF32 tap convolution -------------------------------------


def _stage_spec(device, quality, stage, **overrides):
    hp = model.VitsHParams.preset(quality, n_layers=1, **overrides)
    dec = model.params_to_device(
        model.random_params(hp, torch.Generator().manual_seed(4))["dec"],
        device)
    nk = dec["num_kernels"]
    return fused_stage.build_group_spec(
        dec["resblocks"][stage * nk:(stage + 1) * nk], modules.LRELU_SLOPE)


def _hold_stage(spec, x, valid):
    got = fused_stage.apply_group(spec, x, valid=valid)
    want = fused_stage.plain(spec, x, valid)
    torch.cuda.synchronize()
    assert got.shape == want.shape
    assert bool(torch.isfinite(got).all())
    assert (got - want).abs().max().item() < TOL
    return got


def test_high_first_stage_kernel(device):
    """high's 256-channel first stage, resblock "1": kernels up to 11 at
    dilation 5, the widest window of the presets (BM + 50 rows)."""
    spec = _stage_spec(device, "high", 0)
    assert spec["W"].shape[1] == 256 and spec["W"].shape[0] == 126
    x = torch.randn(2, 517, 256, device=device) * 0.5
    valid = torch.tensor([517, 333], dtype=torch.int32, device=device)
    got = _hold_stage(spec, x, valid)
    assert (got[1, 333:] == 0).all()


# 20 and 13 channels (stage 0 of initial widths 40 and 26) and their
# second stages (10, 6): no multiple of 8 pads the reduction with zeros
# and guards the stores; 13 and 6 take 4-byte copies
@pytest.mark.parametrize("initial,stage", [(40, 0), (40, 1), (26, 0),
                                           (26, 1)])
def test_stage_kernel_odd_channels(device, initial, stage):
    spec = _stage_spec(device, "micro", stage,
                       upsample_initial_channel=initial,
                       resblock_kernel_sizes=(3, 7),
                       resblock_dilation_sizes=((1, 2), (3, 12)))
    c = initial // 2 ** (stage + 1)
    assert spec["W"].shape[1] == c
    x = torch.randn(2, 203, c, device=device) * 0.5
    _hold_stage(spec, x, torch.tensor([203, 97], dtype=torch.int32,
                                      device=device))


# T = 1, and T shorter than the largest halo of medium's stage 0 (k 7 at
# dilation 12: 72 rows) and of the tail
@pytest.mark.parametrize("t", [1, 5, 40, 71])
def test_stage_kernel_shorter_than_its_halo(device, params, t):
    for spec in (params["dec"]["fused_stages"][0],
                 params["dec"]["fused_stages"][2]):
        c = spec["W"].shape[1]
        x = torch.randn(2, t, c, device=device) * 0.5
        _hold_stage(spec, x, torch.tensor([t, max(t // 2, 1)],
                                          dtype=torch.int32, device=device))


def test_stage_kernel_repeats_bit_identical(device, params):
    """No split-K, no atomics: two calls on one input are equal bit for
    bit, with and without the tail."""
    for spec in params["dec"]["fused_stages"]:
        c = spec["W"].shape[1]
        x = torch.randn(1, 777, c, device=device) * 0.5
        valid = torch.tensor([700], dtype=torch.int32, device=device)
        first = fused_stage.apply_group(spec, x, valid)
        second = fused_stage.apply_group(spec, x, valid)
        torch.cuda.synchronize()
        assert torch.equal(first, second)


# ---- the iSTFT decoders: kernel C's second caller --------------------------


@pytest.mark.parametrize("quality,stage,frames", [
    ("medium-istft", 0, 8), ("medium-istft", 1, 64),
    ("medium-mb-istft", 0, 4), ("medium-mb-istft", 1, 16)])
def test_istft_stage_kernel(device, quality, stage, frames):
    """The iSTFT decoders' stages (no tail) at their rates for 57 frames,
    with ragged valid lengths."""
    spec = _stage_spec(device, quality, stage)
    assert "postW" not in spec
    c = 128 // 2 ** stage
    assert spec["W"].shape[1] == c
    t = 57 * frames
    x = torch.randn(2, t, c, device=device) * 0.5
    valid = torch.tensor([t, 31 * frames - 3], dtype=torch.int32,
                         device=device)
    before = fused_stage.launches
    got = _hold_stage(spec, x, valid)
    assert fused_stage.launches == before + 1
    assert (got[1, 31 * frames - 3:] == 0).all()


def test_istft_on_the_card_matches_the_cpu(device):
    """The inverse DFT product and the overlap-add on the card against the
    CPU, on phases that give the DC and Nyquist bins imaginary parts."""
    from phoonnx_tpu_torch.ops.istft import istft

    gen = torch.Generator().manual_seed(6)
    mag = torch.exp(torch.randn(3, 2049, 9, generator=gen))
    phase = torch.pi * torch.sin(torch.randn(3, 2049, 9, generator=gen))
    lengths = torch.tensor([2049, 1500, 7], dtype=torch.int32)
    mag = mag * (torch.arange(2049)[None, :] < lengths[:, None])[..., None]
    for fl in (None, lengths):
        want = istft(mag, phase, 16, 4, 16, fl)
        got = istft(mag.to(device), phase.to(device), 16, 4, 16,
                    None if fl is None else fl.to(device))
        torch.cuda.synchronize()
        assert got.shape == want.shape == (3, 2048 * 4)
        scale = want.abs().max().item()
        assert (got.cpu() - want).abs().max().item() <= 1e-5 * scale


def test_istft_decoder_without_specs_raises(device):
    from phoonnx_tpu_torch.models.vits import istft_decoder

    hp = model.VitsHParams.preset("medium-mb-istft", n_layers=1)
    dec = model.params_to_device(
        model.random_params(hp, torch.Generator().manual_seed(4))["dec"],
        device)
    with pytest.raises(ValueError, match="kernel C"):
        istft_decoder.istft_generator(dec, torch.zeros(1, 8, 192,
                                                       device=device))


@pytest.mark.parametrize("quality", ["medium-istft", "medium-mb-istft"])
def test_istft_decode_makes_no_host_sync(device, quality):
    """After a warm call, a padded decode (kernel C's stages, the heads,
    the iSTFT and the PQMF bank) copies no constant from host memory and
    makes no other host sync: the sync debug mode raises on one. The two
    calls agree to float32 rounding (cuDNN's transposed convs need not
    repeat bit for bit)."""
    hp = model.VitsHParams.preset(quality, n_layers=1)
    params = model.attach_fused_specs(model.params_to_device(
        model.random_params(hp, torch.Generator().manual_seed(5)), device))
    z = torch.randn(2, 40, hp.inter_channels, device=device)
    valid = torch.tensor([40, 13], dtype=torch.int32, device=device)
    with torch.inference_mode():
        want = model.decode_audio(params, hp, z, frame_lengths=valid)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            got = model.decode_audio(params, hp, z, frame_lengths=valid)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    torch.testing.assert_close(got, want)


# the published MB-iSTFT-VITS decoder (arXiv:2210.15975,
# configs/ljs_mb_istft_vits.json): resblock "1" stages at 4x and 16x from
# 512 channels, then the 4-band iSTFT head of the medium-mb-istft preset
MB_ISTFT = dict(resblock="1", resblock_kernel_sizes=(3, 7, 11),
                resblock_dilation_sizes=((1, 3, 5),) * 3,
                upsample_rates=(4, 4), upsample_initial_channel=512,
                upsample_kernel_sizes=(16, 16))


@pytest.mark.parametrize("stage,frames", [(0, 4), (1, 16)])
def test_mb_istft_published_stage_kernel(device, stage, frames):
    """Kernel C's no-tail caller at the published decoder's stages (256
    channels at 4x, 128 at 16x, kernels up to 11 at dilation 5) for 57
    frames, with ragged valid lengths."""
    spec = _stage_spec(device, "medium-mb-istft", stage, **MB_ISTFT)
    assert "postW" not in spec
    c = 256 >> stage
    assert spec["W"].shape[1] == c and spec["W"].shape[0] == 126
    t = 57 * frames
    x = torch.randn(3, t, c, device=device) * 0.5
    valid = torch.tensor([t, 31 * frames - 3, 1], dtype=torch.int32,
                         device=device)
    got = _hold_stage(spec, x, valid)
    assert (got[1, 31 * frames - 3:] == 0).all() and (got[2, 1:] == 0).all()


def test_mb_istft_16_lane_graphs_equal_eager(device):
    """The published decoder's two-phase programs at 16 lanes of ragged
    lengths: a replay of each graph equals an eager call of its program,
    phase 1 bit for bit, phase 2 to float32 rounding (``GRAPH_TOL``), as
    two eager calls of phase 2 agree: cuDNN's transposed convs (the
    upsampling, the overlap-add, the PQMF bank) need not repeat bit for
    bit."""
    from functools import partial

    from phoonnx_tpu_torch.infer import VitsEngine

    hp = model.VitsHParams.preset("medium-mb-istft", **MB_ISTFT)
    assert hp.total_upsample == 256
    engine = VitsEngine(
        model.random_params(hp, torch.Generator().manual_seed(8)), hp,
        text_buckets=(64,), frame_buckets=(512,))
    lengths = [60, 3, 41, 17, 64, 9, 33, 50, 28, 5, 44, 12, 58, 21, 37, 1]
    tokens, lens, sid, scales, dp_noise = _host_inputs(engine, lengths)
    assert _replay_vs_eager(engine, ("mb_phase1", 16, 64), engine._phase1,
                            tokens, lens, sid, scales, dp_noise) == 0.0
    m_p, logs_p, w_ceil, x_mask, g, frames = engine._phase1(
        *[a.to(engine.device) for a in (tokens, lens, sid, scales,
                                        dp_noise)])
    prior = torch.randn(16, 512, hp.inter_channels)
    phase2 = partial(engine._phase2, max_frames=512)
    err = _replay_vs_eager(engine, ("mb_phase2", 16, 64, 512), phase2, m_p,
                           logs_p, w_ceil, x_mask, g, scales, prior)
    args = (m_p, logs_p, w_ceil, x_mask, g, scales, prior.to(device))
    first, second = phase2(*args), phase2(*args)
    torch.cuda.synchronize()
    print(f"phase 2 at 16 lanes: replay - eager {err!r}, eager - eager "
          f"{_agree(first, second)!r}")
    assert err <= GRAPH_TOL
    audio, y_lengths = first
    assert audio.shape == (16, 512 * 256)
    assert bool(torch.isfinite(audio).all())


def test_tap_tile_matches_the_host_rule(device):
    """tapconv.cuh's tile choice is tiling.tap_tile: every preset conv
    and odd shapes, at this card's SM count and at 132."""
    from phoonnx_tpu_torch import cuda, tiling

    from tests.test_torch_tapconv_tiling import QUALITIES, distinct

    fn = cuda.function(fused_stage.LIBRARY, "fused_stage_tile",
                       [cuda.c_int] * 6 + [cuda.c_ptr])
    own = torch.cuda.get_device_properties(device).multi_processor_count
    shapes = {s for q in QUALITIES for s in distinct(q)}
    shapes |= {(1, 20, 7, 12), (1001, 13, 3, 1), (257, 48, 11, 5),
               (700, 100, 5, 2)}
    out = (cuda.c_int * 5)()
    for t, c, k, d in sorted(shapes):
        for batch in (1, 3):
            for sms in (own, 132):
                assert fn(batch, t, c, k, d, sms,
                          ctypes.cast(out, cuda.c_ptr)) == 0
                want = tiling.tap_tile(batch, t, c, k, d, sms)
                assert tuple(out) == tuple(want), (t, c, k, d, batch, sms)
    assert fn(1, 100, 64, 200, 20, own, ctypes.cast(out, cuda.c_ptr)) != 0
    spec = _stage_spec(device, "micro", 0, resblock_kernel_sizes=(200,),
                       resblock_dilation_sizes=((20,),))
    with pytest.raises(ValueError, match="shared memory"):
        fused_stage.apply_group(spec, torch.zeros(1, 50, 16, device=device))


def test_kernels_launch_on_the_tensors_device(device, params):
    """With two cards, every kernel runs on its tensors' card while
    another is current. The one-card chip run cannot show this."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two GPUs")
    other = torch.device("cuda", 1)
    moved = model.attach_fused_specs(model.params_to_device(
        {k: v for k, v in params.items()}, other))
    with torch.cuda.device(0):
        spec = moved["dec"]["fused_stages"][1]
        x = torch.randn(2, 300, 64, device=other) * 0.5
        _hold_stage(spec, x, torch.tensor([300, 100], dtype=torch.int32,
                                          device=other))
        mask = _mask([40, 23], 40, other)
        x = torch.randn(2, 40, 192, device=other) * mask
        enc = moved["enc_p"]["encoder"]["fused"]
        assert (fused_encoder.apply(enc, x, mask)
                - fused_encoder.plain(enc, x, mask)).abs().max() < TOL
        flow = moved["flow"]["fused_rev"]
        assert (fused_flow.apply(flow, x, mask)
                - fused_flow.plain(flow, x, mask)).abs().max() < TOL
        value = torch.randn(2, 30, 12, device=other)
        lens = torch.tensor([30, 20], dtype=torch.int32, device=other)
        xl = torch.tensor([12, 9], dtype=torch.int32, device=other)
        assert torch.equal(mas.launch(value, lens, xl),
                           mas.maximum_path_plain(value, lens, xl))
        torch.cuda.synchronize(other)


# ---------------------------------------------------------------------------
# the engine's programs as CUDA graphs
# ---------------------------------------------------------------------------

# a replay runs the kernels of the eager call in the same order; cuDNN may
# pick another algorithm for a plain op under capture, within rounding
GRAPH_TOL = 1e-6


def _tensors(out):
    return out if isinstance(out, tuple) else (out,)


def _agree(got, want):
    """Max-abs difference of two program outputs (tuples of tensors or
    None), which must have the same structure."""
    err = 0.0
    for g, w in zip(_tensors(got), _tensors(want), strict=True):
        assert (g is None) == (w is None)
        if g is not None:
            assert g.shape == w.shape and g.dtype == w.dtype
            err = max(err, (g.double() - w.double()).abs().max().item())
    return err


def _replay_vs_eager(engine, key, fn, *args):
    """Capture ``fn`` at ``key`` (the first call), replay it once under
    CUDA's sync debug mode 'error' (no host sync inside a replay), and
    return the max-abs difference of the replay from an eager call of the
    same program on the same inputs."""
    engine._run(key, fn, *args)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = engine._run(key, fn, *args)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    got = tuple(None if t is None else t.clone() for t in _tensors(got))
    dev_args = [a.to(engine.device) if isinstance(a, torch.Tensor) else a
                for a in args]
    want = fn(*dev_args)
    torch.cuda.synchronize()
    return _agree(got, want)


@pytest.fixture(scope="module")
def engine(device):
    from phoonnx_tpu_torch.infer import VitsEngine

    hp = model.VitsHParams.preset("medium", n_layers=2)
    p = model.random_params(hp, torch.Generator().manual_seed(6))
    return VitsEngine(p, hp, text_buckets=(32, 64), frame_buckets=(128, 256))


def _host_inputs(engine, lengths, scales=(0.667, 1.0, 0.8), seed=0):
    """Phase 1's inputs as the engine makes them: ids, lengths, sid and
    scales on the host, the duration noise drawn on the card (the lanes'
    seeds are left out)."""
    ids = [[4 + (7 * i + j) % 20 for j in range(n)]
           for i, n in enumerate(lengths)]
    tokens, lens, sid, dp_noise, _ = engine._batch_inputs(ids, None, seed)
    assert dp_noise.is_cuda
    return tokens, lens, sid, engine._scales(*scales), dp_noise


def test_cooperative_launch_is_captured(device, params):
    """Kernels A and B are cooperative launches of persistent blocks
    (persist.cuh): stream capture records them, and a replay equals the
    eager launch (the grid-barrier probe, then A and B)."""
    from phoonnx_tpu_torch import cuda as port_cuda

    probe = port_cuda.function("fused_flow", "phx_barrier_probe",
                               [port_cuda.c_int, port_cuda.c_int,
                                port_cuda.c_ptr])
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        status = probe(4, 8, torch.cuda.current_stream().cuda_stream)
    assert status == 0
    graph.replay()
    torch.cuda.synchronize()
    mask = _mask([40, 23], 40, device)
    x = torch.randn(2, 40, 192, device=device) * mask
    enc, flow = params["enc_p"]["encoder"]["fused"], params["flow"]["fused_rev"]

    def run():
        return fused_encoder.apply(enc, x, mask), fused_flow.apply(flow, x,
                                                                   mask)

    want = run()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        got = run()
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_programs_replay_equal_eager(engine):
    from functools import partial

    tokens, lens, sid, scales, dp_noise = _host_inputs(engine, [30, 17])
    assert _replay_vs_eager(engine, ("t_phase1", 2, 32), engine._phase1,
                            tokens, lens, sid, scales, dp_noise) <= GRAPH_TOL
    m_p, logs_p, w_ceil, x_mask, g, _ = engine._phase1(
        *[a.to(engine.device) for a in (tokens, lens, sid, scales,
                                        dp_noise)])
    prior = torch.randn(2, 256, 192)
    for name, fn in (("t_phase2", engine._phase2),
                     ("t_latents", engine._latents)):
        err = _replay_vs_eager(engine, (name, 2, 32, 256),
                               partial(fn, max_frames=256), m_p, logs_p,
                               w_ceil, x_mask, g, scales, prior)
        assert err <= GRAPH_TOL, name
    err = _replay_vs_eager(engine, ("t_fused", 2, 32, 256),
                           partial(engine._fused, max_frames=256), tokens,
                           lens, sid, scales, dp_noise, prior)
    assert err <= GRAPH_TOL
    one = _host_inputs(engine, [30])
    err = _replay_vs_eager(engine, ("t_first", 32, 64, 32),
                           partial(engine._first_chunk, window=128), *one,
                           torch.randn(1, 160, 192))
    assert err <= GRAPH_TOL
    z = torch.randn(1, 256, 192, device=engine.device)
    decode = partial(engine._decode_chunk, window=128, chunk=64)
    for start, offset in ((0, 0), (64, 32), (128, 64)):
        err = _replay_vs_eager(engine, ("t_decode", 1, 256, 64, 32), decode,
                               z, torch.tensor(start), torch.tensor(offset),
                               torch.tensor(200), None)
        assert err <= GRAPH_TOL, (start, offset)


def test_launch_counts_add_up_under_replay(engine):
    """A replay runs no Python: its graph adds the launches of its
    capture. Every request, first or replayed, counts one launch of A and
    of B and one of C a decoder stage."""
    ids = [5, 9, 11, 4, 7, 13, 6, 8, 10]
    counts = []
    for _ in range(3):
        before = (fused_encoder.launches, fused_flow.launches,
                  fused_stage.launches)
        engine.synthesize_ids(ids, seed=1)
        counts.append((fused_encoder.launches - before[0],
                       fused_flow.launches - before[1],
                       fused_stage.launches - before[2]))
    assert counts == [(1, 1, 3)] * 3


def test_graph_outputs_survive_other_replays(engine):
    """A replay returns fresh tensors: two streams of one first-chunk key
    pulled in turns (the second's first chunk replays the graph while the
    first stream holds its state) and two threads' requests of one key at
    once each equal the same call made alone."""
    import threading

    utts = [[4 + (7 * i) % 20 for i in range(n)] for n in (50, 45)]
    alone = [engine.synthesize_ids(u, seed=50 + i) for i, u in enumerate(utts)]
    streams = [engine.synthesize_ids_streaming(u, chunk_frames=16,
                                               overlap_frames=8, seed=50 + i)
               for i, u in enumerate(utts)]
    chunks = [[], []]
    live = [0, 1]
    while live:
        for i in list(live):
            chunk = next(streams[i], None)
            if chunk is None:
                live.remove(i)
            else:
                chunks[i].append(chunk)
    for i, want in enumerate(alone):
        assert len(chunks[i]) > 2
        got = np.concatenate(chunks[i])
        assert got.shape == want.shape
        assert np.abs(got - want).max() <= 1e-4

    got = [[], []]

    def requests(i):
        for _ in range(4):
            got[i].append(engine.synthesize_ids(utts[i], seed=50 + i))

    threads = [threading.Thread(target=requests, args=(i,)) for i in (0, 1)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    for outs, want in zip(got, alone):
        assert len(outs) == 4
        for out in outs:
            assert np.abs(out - want).max() <= GRAPH_TOL


def test_scales_are_graph_inputs(engine):
    """One fused graph replayed at two length scales and two noise scales:
    each replay equals the eager program at its scales."""
    from functools import partial

    fused = partial(engine._fused, max_frames=256)
    key = ("t_scales", 1, 32, 256)
    prior = torch.randn(1, 256, 192)
    outs = []
    for scales in ((0.667, 1.0, 0.8), (0.667, 1.5, 0.8), (0.2, 1.0, 0.8),
                   (0.2, 0.7, 0.3)):
        tokens, lens, sid, s, dp_noise = _host_inputs(engine, [25], scales)
        assert _replay_vs_eager(engine, key, fused, tokens, lens, sid, s,
                                dp_noise, prior) <= GRAPH_TOL, scales
        outs.append(engine._run(key, fused, tokens, lens, sid, s, dp_noise,
                                prior)[0].clone())
    # the scales reached the audio: no two replays gave the same
    assert all(not torch.equal(outs[0], o) for o in outs[1:])


def test_flow_kernel_gin512(device):
    """Kernel B with the speaker term at gin 512, the width of a
    multi-speaker voice the trainer builds (voice conversion and every
    multi-speaker request reach it)."""
    gen = torch.Generator().manual_seed(7)
    flow = posterior.init_residual_coupling_block(gen, 192, 192, 5, 1, 4,
                                                  gin_channels=512)
    for f in flow["flows"]:
        for key in ("weight", "bias"):
            f["post"][key] = 0.05 * torch.randn(f["post"][key].shape,
                                                generator=gen)
    spec = fused_flow.build_spec(model.params_to_device(flow, device))
    for lengths in ([172], [512, 300], [1]):
        t = max(lengths)
        mask = _mask(lengths, t, device)
        x = torch.randn(len(lengths), t, 192, device=device) * mask
        g = torch.randn(len(lengths), 1, 512, device=device)
        got = fused_flow.apply(spec, x, mask, g=g)
        want = fused_flow.plain(spec, x, mask, g=g)
        torch.cuda.synchronize()
        assert (got - want).abs().max().item() < TOL, lengths


def test_voice_conversion_graph_equals_eager(device):
    from functools import partial

    from phoonnx_tpu_torch.infer import VitsEngine

    hp = model.VitsHParams.preset("medium", n_layers=1, n_speakers=4,
                                  gin_channels=512)
    eng = VitsEngine(model.random_params(hp, torch.Generator().manual_seed(8)),
                     hp, frame_buckets=(128,))
    # on the card's spectrum, as voice_conversion computes it
    spec = torch.rand(1, 128, hp.spec_channels).to(device)
    # the noise as voice_conversion draws it, on the card: the later
    # call replays this graph with its own draw
    noise = eng._prior(range(0, 1), [100], 128)
    err = _replay_vs_eager(eng, ("vc", 1, 128), partial(eng._vc), spec,
                           torch.tensor([100], dtype=torch.int32),
                           torch.tensor([0]), torch.tensor([3]), noise)
    assert err <= GRAPH_TOL
    before = (fused_encoder.launches, fused_flow.launches)
    out = eng.voice_conversion(np.zeros(100 * 256, np.float32) + 0.1, 1, 2,
                               seed=0)
    assert np.isfinite(out).all() and len(out) % 256 == 0
    assert fused_encoder.launches == before[0]
    assert fused_flow.launches > before[1]


# ---------------------------------------------------------------------------
# the noise kernel (csrc/noise.cu, ops/noise.py)
# ---------------------------------------------------------------------------

# the kernel's normals against the plain version's, both float32: the
# card's logf and sincosf and the host's log, cos and sin differ by an ulp
# or two, times a radius of at most 5.77
NOISE_TOL = 2e-6
# a large seed, past 2**32: the key's high word matters
NOISE_SEED = 3_000_000_081 + 2 ** 32

# the toolkit's Philox4x32-10 on the same counters and keys
CURAND_PROBE = r"""
#include <curand_philox4x32_x.h>

__global__ void probe_kernel(const uint4* ctr, const uint2* key, uint4* out,
                             int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) out[i] = curand_Philox4x32_10(ctr[i], key[i]);
}

extern "C" int curand_words(const void* ctr, const void* key, void* out,
                            int n) {
  probe_kernel<<<(n + 255) / 256, 256>>>(static_cast<const uint4*>(ctr),
                                         static_cast<const uint2*>(key),
                                         static_cast<uint4*>(out), n);
  cudaError_t err = cudaGetLastError();
  if (err == cudaSuccess) err = cudaDeviceSynchronize();
  return static_cast<int>(err);
}
"""


def _words(n: int, seed: int):
    """(counters [n, 4], keys [n, 2]) of random 32-bit words in int64, the
    first rows at the extremes 0 and 0xffffffff."""
    rng = np.random.default_rng(seed)
    w = rng.integers(0, 2 ** 32, size=(n, 6), dtype=np.uint64).astype(
        np.int64)
    top = 0xFFFFFFFF
    w[:4] = [[0] * 6, [top] * 6, [0] * 4 + [top] * 2, [top] * 4 + [0] * 2]
    t = torch.from_numpy(w)
    return t[:, :4].contiguous(), t[:, 4:].contiguous()


def _u32_bits(words):
    """int64 words below 2**32 as int32 bit patterns."""
    return torch.where(words >= 2 ** 31, words - 2 ** 32, words).to(
        torch.int32)


def test_noise_philox_words_match_plain_and_curand(device, tmp_path):
    """The plain version's Philox words, the extreme words among the
    counters and keys, equal bit for bit the toolkit's
    ``curand_Philox4x32_10``, which the kernel calls, for the same counter
    and key."""
    import subprocess

    from phoonnx_tpu_torch import cuda as port_cuda
    from phoonnx_tpu_torch.ops import noise

    ctr, key = _words(4096, 1)
    src = tmp_path / "probe.cu"
    src.write_text(CURAND_PROBE)
    lib = tmp_path / "libprobe.so"
    built = subprocess.run([port_cuda._nvcc(), *port_cuda.NVCC_FLAGS, "-o",
                            str(lib), str(src)], capture_output=True,
                           text=True)
    assert built.returncode == 0, built.stdout + built.stderr
    probe = ctypes.CDLL(str(lib)).curand_words
    probe.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int]
    ctr32 = _u32_bits(ctr).to(device)
    key32 = _u32_bits(key).to(device)
    want = torch.empty(len(ctr), 4, dtype=torch.int32, device=device)
    torch.cuda.synchronize()
    assert probe(ctr32.data_ptr(), key32.data_ptr(), want.data_ptr(),
                 len(ctr)) == 0
    assert torch.equal(noise.philox(ctr, key),
                       want.cpu().to(torch.int64) & noise.MASK32)


@pytest.mark.parametrize("lanes,rows,channels",
                         [(16, 1024, 192), (4, 37, 2), (2, 11, 20),
                          (1, 5, 3)])
def test_noise_kernel_matches_plain(device, lanes, rows, channels):
    """One launch a draw, within NOISE_TOL of the plain version for both
    tags, rows past each lane's length exactly 0; the bfloat16 draw, counted
    as a launch of the bfloat16 build, is the kernel's float32 draw
    rounded. Shapes whose lane is not a multiple of 4 elements take the
    element-by-element stores."""
    from phoonnx_tpu_torch.ops import noise

    lengths = torch.tensor([[0, rows, rows // 2, rows + 9][i % 4]
                            for i in range(lanes)], dtype=torch.int32)
    for tag in (noise.DURATION, noise.PRIOR):
        for lens in (lengths, None):
            before = noise.launches
            got = noise.normal(NOISE_SEED, lanes, rows, channels, tag,
                               device, lens)
            assert noise.launches == before + 1
            assert got.is_cuda and got.dtype == torch.float32
            want = noise.normal_plain(NOISE_SEED, lanes, rows, channels,
                                      tag, lens)
            got = got.cpu()
            assert (got - want).abs().max().item() <= NOISE_TOL
            if lens is not None:
                for b, n in enumerate(lens.tolist()):
                    assert not got[b, min(n, rows):].any()
            before = (noise.launches, noise.launches_bf16)
            bf16 = noise.normal(NOISE_SEED, lanes, rows, channels, tag,
                                device, lens, torch.bfloat16)
            assert (noise.launches, noise.launches_bf16) == (
                before[0], before[1] + 1)
            assert torch.equal(bf16.cpu(), got.to(torch.bfloat16))


def test_noise_kernel_prefix_and_lanes(device):
    """On the card, bit for bit: a short draw is the start of a long one,
    and lane i of a batch is the one-lane draw at seed + i."""
    from phoonnx_tpu_torch.ops import noise

    for channels, short, long in ((192, 1, 2), (192, 37, 4096),
                                  (96, 5, 300), (20, 5, 11), (3, 5, 11)):
        a = noise.normal(NOISE_SEED, 1, short, channels, noise.PRIOR, device)
        b = noise.normal(NOISE_SEED, 1, long, channels, noise.PRIOR, device)
        assert torch.equal(a, b[:, :short]), (channels, short, long)
    batch = noise.normal(NOISE_SEED, 16, 100, 192, noise.PRIOR, device)
    for i in range(16):
        assert torch.equal(batch[i], noise.normal(
            NOISE_SEED + i, 1, 100, 192, noise.PRIOR, device)[0]), i


def test_two_phase_dispatch_draws_noise_twice(engine):
    """A graph-replayed two-phase dispatch draws its noise on the card:
    one launch for the duration noise, one for the prior, and the audio is
    finite at noise scales 0."""
    from phoonnx_tpu_torch.ops import noise

    ids = [[5, 9, 11, 4, 7, 13, 6, 8, 10], [4, 6, 8, 2, 9, 12, 14, 5]]
    # captures the keys
    engine.synthesize_batch(ids, noise_scale=0.0, noise_w=0.0,
                            seed=NOISE_SEED)
    replays = sum(engine.graphs.replays.values())
    for _ in range(2):
        before = noise.launches
        audio, frames = engine.synthesize_batch(ids, noise_scale=0.0,
                                                noise_w=0.0, seed=NOISE_SEED)
        assert noise.launches == before + 2
        assert np.isfinite(audio).all() and min(frames) > 0
    assert sum(engine.graphs.replays.values()) == replays + 4


# ---------------------------------------------------------------------------
# serving: 16 lanes, the HTTP server, replicas
# ---------------------------------------------------------------------------


def test_kernels_at_sixteen_lanes(device, params):
    """A, B and C at the largest batch the server dispatches, through
    ``chip_smoke.serve_kernels``: 16 ragged rows in text bucket 128 (A),
    at frame bucket 512 (B) and at 16 x 512 frames through the three
    medium stages (C), each within TOL of its plain version."""
    import chip_smoke

    errs = chip_smoke.serve_kernels(torch, params, 16, tag="card")
    assert sorted(errs) == ["A", "B", "C"]
    assert max(errs.values()) < TOL


def _served_voice(tmp_path, seed, device=None, dtype="float32"):
    """A medium voice (two encoder layers) written as ``chip_smoke.py``
    writes its voices and loaded on ``device`` in ``dtype``; RAW phonemes
    a-z."""
    import chip_smoke
    from phoonnx_tpu_torch import TTSVoice

    hp = model.VitsHParams.preset("medium", n_layers=2)
    p = model.random_params(hp, torch.Generator().manual_seed(seed))
    path, _ = chip_smoke.write_voice(torch, p, hp, tmp_path)
    return TTSVoice.load(str(path), device=device, dtype=dtype)


def test_server_answers_concurrent_requests(device, tmp_path):
    """A server on the card, through ``chip_smoke.served_held``: eight
    concurrent requests at noise 0, each within 4 LSB of the engine's own
    request (the padded-batch bound 1e-4 x 32767 plus truncation); a
    seeded request of three sentences against synthesize_batch in their
    order; the stream route within 1 LSB of the WAV route."""
    import chip_smoke
    from phoonnx_tpu_torch.serve import TTSServer

    voice = _served_voice(tmp_path, 9)
    srv = TTSServer(voice, port=0, max_batch=16, max_wait_ms=50.0)
    srv.start()
    try:
        chip_smoke.served_held(torch, srv, voice, 9, "card")
        assert srv.batcher.stats["max_batch_seen"] > 1
    finally:
        srv.stop()


def test_capture_out_of_memory_names_the_key(device):
    """A capture that runs out of device memory raises OutOfMemoryError
    naming its key and the pool, keeps no graph for it, and the engine's
    graphs, pool and lock go on working: another key still replays."""
    from phoonnx_tpu_torch.infer.graphs import Graphs

    device = torch.device("cuda", torch.cuda.current_device())
    graphs = Graphs(device)
    x = torch.arange(8.0, device=device)

    def small(t):
        return t * 2

    def large(t):  # 16 GiB, but only while the graph is captured
        if torch.cuda.is_current_stream_capturing():
            return t + torch.zeros(2 ** 32, device=t.device)[:8]
        return t + 1

    graphs.run(("small",), small, (x,))
    total = torch.cuda.get_device_properties(device).total_memory
    limit = (torch.cuda.memory_reserved(device) + 2 ** 30) / total
    torch.cuda.set_per_process_memory_fraction(limit, device)
    try:
        with pytest.raises(torch.OutOfMemoryError,
                           match=r"\('large', 1\).*graphs holding"):
            graphs.run(("large", 1), large, (x,))
    finally:
        torch.cuda.set_per_process_memory_fraction(1.0, device)
    assert ("large", 1) not in graphs.programs
    assert torch.equal(graphs.run(("small",), small, (x + 1,)), 2 * (x + 1))
    assert graphs.replays == {("small",): 1}
    assert torch.equal(graphs.run(("small", 4), small, (x[:4],)), 2 * x[:4])
    assert graphs.captures == 2  # the failed capture is not one


def test_replica_serves_on_the_second_card(device, tmp_path):
    """With two cards: ``replicate`` puts a second engine on cuda:1 with
    its own parameters and graphs, and a server of both answers a request
    there equal to the first card's. The one-card chip run cannot show
    this."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two GPUs")
    import chip_smoke
    from phoonnx_tpu_torch.serve import TTSServer

    voice = _served_voice(tmp_path, 10, device="cuda:0")
    first, second = voice.engine.replicate(["cuda:0", "cuda:1"])
    assert first is voice.engine
    assert second.device == torch.device("cuda", 1)
    assert second.params["flow"]["fused_rev"]["w_in"].device == second.device
    ids = [4, 9, 11, 5, 13, 7, 20, 8, 6]
    with torch.cuda.device(0):
        a = first.synthesize_ids(ids, seed=2)
        b = second.synthesize_ids(ids, seed=2)
    assert np.abs(a - b).max() <= GRAPH_TOL
    assert all(p.graph is not None for p in second.graphs.programs.values())

    srv = TTSServer(voice, port=0, max_batch=4, devices=["cuda:0",
                                                         "cuda:1"])
    srv.start()
    try:
        pool = srv.batcher
        assert [b.engine.device.index for b in pool.batchers] == [0, 1]
        body = {"text": "abcd efgh ijkl", "seed": 3}
        pcm = chip_smoke.serve_post(srv, body)[0]
        streams = [chip_smoke.serve_post(srv, dict(body, stream=True))[0]
                   for _ in range(2)]
        for s in streams:  # round-robin: one stream a card
            assert s.shape == pcm.shape
            assert np.abs(s.astype(np.int32) - pcm).max() <= 1
    finally:
        srv.stop()


# ---------------------------------------------------------------------------
# bf16: the kernels' bf16 builds (the engine's dtype="bfloat16")
# ---------------------------------------------------------------------------

# a bf16 kernel against its bf16 plain version: max-abs <= BF16_TOL x
# max(1, max|plain|) (chip_smoke.BF16_KERNEL_TOL): both round to bf16 at the
# TPU kernel's points and sum in float32 in other orders
BF16_TOL = 1e-2


@pytest.fixture(scope="module")
def params_bf16(device):
    """``params``' weights in bf16, as a bf16 engine holds them."""
    from phoonnx_tpu_torch.models.vits import nn

    hp = model.VitsHParams.preset("medium", n_layers=2)
    p = model.random_params(hp, torch.Generator().manual_seed(0))
    gen = torch.Generator().manual_seed(1)
    for flow in p["flow"]["flows"]:
        for key in ("weight", "bias"):
            flow["post"][key] = 0.05 * torch.randn(flow["post"][key].shape,
                                                   generator=gen)
    return model.attach_fused_specs(nn.cast_floating(
        model.params_to_device(p, device), torch.bfloat16))


def _hold_bf16(got, want):
    torch.cuda.synchronize()
    assert got.dtype == want.dtype == torch.bfloat16
    assert got.shape == want.shape
    assert bool(torch.isfinite(got).all())
    scale = max(1.0, want.float().abs().max().item())
    assert (got.float() - want.float()).abs().max().item() <= BF16_TOL * scale


# the f32 tests' edges: T 1 and 5 (at the window), 37, a ragged 1024, the
# longest text (3333)
@pytest.mark.parametrize("lengths", [[1], [5], [37], [1024, 700], [3333]])
def test_encoder_kernel_bf16(device, params_bf16, lengths):
    """Kernel A's bf16 build: one launch counted under its own name,
    against its bf16 plain version, padded rows 0, repeats bit-identical."""
    spec = params_bf16["enc_p"]["encoder"]["fused"]
    t = max(lengths)
    mask = _mask(lengths, t, device).to(torch.bfloat16)
    gen = torch.Generator(device=device).manual_seed(t)
    x = (torch.randn(len(lengths), t, 192, device=device, generator=gen)
         * mask).to(torch.bfloat16)
    before = (fused_encoder.launches, fused_encoder.launches_bf16)
    got = fused_encoder.apply(spec, x, mask)
    assert (fused_encoder.launches, fused_encoder.launches_bf16) == (
        before[0], before[1] + 1)
    again = fused_encoder.apply(spec, x, mask)
    _hold_bf16(got, fused_encoder.plain(spec, x, mask))
    assert torch.equal(got, again)
    for i, n in enumerate(lengths):
        assert (got[i, n:] == 0).all()


@pytest.mark.parametrize("lengths,gin", [([509, 300, 77, 6], 0), ([1], 0),
                                         ([37, 20, 37, 5], 256)])
def test_flow_kernel_bf16(device, params_bf16, flow_g, lengths, gin):
    """Kernel B's bf16 build, ragged, without and with the speaker term
    (gin 256, computed in float32 as the TPU kernel's wrapper does)."""
    from phoonnx_tpu_torch.models.vits import nn

    spec = params_bf16["flow"]["fused_rev"]
    if gin:
        spec = fused_flow.build_spec(nn.cast_floating(flow_g["plain"],
                                                      torch.bfloat16))
    t = max(lengths)
    mask = _mask(lengths, t, device).to(torch.bfloat16)
    gen = torch.Generator(device=device).manual_seed(t + gin)
    x = (torch.randn(len(lengths), t, 192, device=device, generator=gen)
         * mask).to(torch.bfloat16)
    g = (torch.randn(len(lengths), 1, gin, device=device, generator=gen)
         .to(torch.bfloat16) if gin else None)
    before = fused_flow.launches_bf16
    got = fused_flow.apply(spec, x, mask, g=g)
    assert fused_flow.launches_bf16 == before + 1
    _hold_bf16(got, fused_flow.plain(spec, x, mask, g=g))


@pytest.mark.parametrize("stage", [0, 1, 2])
def test_stage_kernel_bf16(device, params_bf16, stage):
    """Kernel C's bf16 build at medium's stages (the last with the
    generator's tail), ragged valid lengths."""
    spec = params_bf16["dec"]["fused_stages"][stage]
    c = 128 // (2 ** stage)
    x = (torch.randn(2, 300, c, device=device) * 0.5).to(torch.bfloat16)
    valid = torch.tensor([300, 171], dtype=torch.int32, device=device)
    before = fused_stage.launches_bf16
    got = fused_stage.apply_group(spec, x, valid=valid)
    assert fused_stage.launches_bf16 == before + 1
    _hold_bf16(got, fused_stage.plain(spec, x, valid))
    assert ("postW" in spec) == (got.shape[-1] == 1)
    if "postW" not in spec:
        assert (got[1, 171:] == 0).all()


def test_bf16_programs_replay_equal_eager(tmp_path, device):
    """A bf16 voice's programs, each graph replayed against the program
    called eagerly, ``torch.equal`` (``chip_smoke.graphs_vs_eager``)."""
    import chip_smoke

    voice = _served_voice(tmp_path, 11, dtype="bfloat16")
    assert voice.engine.dtype == torch.bfloat16
    ids = voice.phonemes_to_ids(voice.phonemize(
        chip_smoke.text_of(100, 3))[0])
    assert chip_smoke.graphs_vs_eager(torch, voice.engine, ids, 5,
                                      tag="card bf16") == 0.0


def test_bf16_server_answers_requests(device, tmp_path):
    """A bf16 voice behind the server, through ``chip_smoke.served_held``
    (served WAVs against the engine's own requests, the seeded request,
    the stream route)."""
    import chip_smoke
    from phoonnx_tpu_torch.serve import TTSServer

    voice = _served_voice(tmp_path, 12, dtype="bfloat16")
    srv = TTSServer(voice, port=0, max_batch=16, max_wait_ms=50.0)
    srv.start()
    try:
        chip_smoke.served_held(torch, srv, voice, 12, "card bf16")
    finally:
        srv.stop()


@pytest.mark.parametrize("quantize", [False, True], ids=["float32", "int8"])
def test_foreign_voice_runs_on_the_card(device, tmp_path, quantize):
    """A foreign voice (renamed initializers) on the ONNX graph engine
    with its runner on the card, through ``chip_smoke.onnx_voice_check``:
    no floating or data-sized value on the host, two seeded calls equal,
    the card within 1e-3 of the peak of the host interpreter on the same
    feeds; kernels A-D are not launched."""
    import chip_smoke
    from phoonnx_tpu_torch import TTSVoice

    hp = model.VitsHParams.preset("medium", n_layers=2)
    p = model.random_params(hp, torch.Generator().manual_seed(13))
    files = chip_smoke.write_foreign_voice(torch, p, hp, tmp_path,
                                           quantize=quantize)
    kernels = chip_smoke.all_kernels()
    chip_smoke.reset_launches(kernels)
    voice = TTSVoice.load(*map(str, files))
    chip_smoke.onnx_voice_check(torch, voice, "int8" if quantize
                                else "float32", 13, "card onnx")
    assert not any(chip_smoke.launch_counts(kernels).values())


def test_interpreter_on_the_card_is_refused(device, tmp_path):
    from phoonnx_tpu_torch.infer.onnx_engine import OnnxFallbackEngine
    from phoonnx_tpu_torch.onnx.writer import write_onnx
    from phoonnx_tpu_torch.onnx.reader import read_onnx

    path = tmp_path / "g.onnx"
    write_onnx(str(path), {}, inputs=["x"], outputs=["y"],
               nodes=[("Identity", ["x"], ["y"], {})])
    with pytest.raises(ValueError, match="compile=False"):
        OnnxFallbackEngine(read_onnx(str(path)), 16000, compile=False)


def test_precision_is_per_engine(device, tmp_path):
    """``chip_smoke.precision_phase`` on a two-layer medium voice: a
    default engine bit for bit the same beside "high" engines on another
    thread, "highest" equal to the default, both TF32 flags off after."""
    import chip_smoke

    hp = model.VitsHParams.preset("medium", n_layers=2)
    p = model.random_params(hp, torch.Generator().manual_seed(14))
    files = chip_smoke.write_voice(torch, p, hp, tmp_path)
    chip_smoke.precision_phase(torch, files, 14, tag="card precision")


def test_g2p_on_the_card(device):
    """``chip_smoke.g2p_phase`` at byt5-small's widths with 2 + 1 layers:
    the encoder, the teacher-forced logits and greedy decodes (16 words,
    one sentence) on the card against the CPU, float32 and bfloat16."""
    import chip_smoke

    widths = dict(chip_smoke.BYT5_SMALL, num_encoder_layers=2,
                  num_decoder_layers=1)
    chip_smoke.g2p_phase(torch, 16, chip_smoke.card_line(), widths=widths,
                         tag="card g2p")


def test_arabic_voice_on_the_card(device, tmp_path):
    """``chip_smoke.arabic_phase`` on a two-layer medium voice: the
    tashkeel runner on the card, diacritics and ids equal to the CPU's,
    kernels A, B and C launched, the waveform within PATH_TOL."""
    import chip_smoke

    hp = model.VitsHParams.preset("medium", n_layers=2)
    p = model.random_params(hp, torch.Generator().manual_seed(15))
    files = chip_smoke.write_voice(torch, p, hp, tmp_path)
    launches = chip_smoke.arabic_phase(torch, *files, 15, tmp_path,
                                       tag="card arabic")
    assert all(n > 0 for n in launches.values()), launches


def _fake_vad(path):
    """tests/test_vad_model.py's Silero-shaped graph: 20 * mean(|chunk|)."""
    from phoonnx_tpu_torch.onnx.writer import write_onnx

    write_onnx(str(path), initializers={"gain": np.asarray(20.0, np.float32)},
               inputs=["input", "sr", "h", "c"],
               outputs=["prob", "h_out", "c_out"],
               nodes=[("Abs", ["input"], ["absin"]),
                      ("ReduceMean", ["absin"], ["mean"]),
                      ("Mul", ["mean", "gain"], ["prob"]),
                      ("Identity", ["h"], ["h_out"]),
                      ("Identity", ["c"], ["c_out"])])
    return path


@pytest.mark.parametrize("vad", ["energy", "silero"])
def test_preprocess_on_the_card_matches_the_cpu(device, tmp_path,
                                                monkeypatch, vad):
    """``chip_smoke.preprocess_phase`` on a small corpus: the card's
    dataset against the CPU's (the same rows, trimmed audio equal,
    spectrograms within SPEC_TOL), with the energy VAD and with a Silero
    model on the card's graph runner."""
    import chip_smoke

    if vad == "silero":
        monkeypatch.setenv("PHOONNX_VAD_MODEL",
                           str(_fake_vad(tmp_path / "vad.onnx")))
    hp = model.VitsHParams.preset("medium")
    corpus = chip_smoke.write_corpus(tmp_path / "corpus", hp, 6, 3)
    chip_smoke.preprocess_phase(torch, corpus, tmp_path, hp.sample_rate,
                                device, tag=f"card preprocess {vad}",
                                max_workers=2)


def _micro_batch(hp, device, n=4):
    rng = np.random.default_rng(0)
    t_y = 40
    return {"phoneme_ids": torch.as_tensor(rng.integers(1, 32, (n, 10)),
                                           device=device),
            "phoneme_lengths": torch.tensor([10, 7, 9, 6][:n],
                                            dtype=torch.int32, device=device),
            "spec": torch.as_tensor(np.abs(rng.standard_normal(
                (n, t_y, hp.spec_channels))).astype(np.float32) * 0.3,
                device=device),
            "spec_lengths": torch.tensor([40, 33, 36, 30][:n],
                                         dtype=torch.int32, device=device),
            "audio": torch.as_tensor((0.3 * rng.standard_normal(
                (n, t_y * hp.hop_length))).astype(np.float32),
                device=device)}


def test_bf16_grad_accum_step_launches_mas(device):
    """A bf16 step of two micro-batches launches kernel D once a
    micro-batch, on f32 scores, and none of A, B, C or the noise
    kernel."""
    import chip_smoke
    from phoonnx_tpu_torch.train import step

    hp = model.VitsHParams.preset("micro", n_vocab=32)
    cfg = step.TrainConfig(disc_periods=(2,), disc_channel_scale=4,
                           compute_dtype="bfloat16", grad_accum=2)
    state = step.init_train_state(hp, cfg, device=device)
    kernels = chip_smoke.all_kernels()
    chip_smoke.reset_launches(kernels)
    state, metrics = step.train_step(
        state, _micro_batch(hp, device), hp, cfg,
        generator=torch.Generator(device=device).manual_seed(1))
    assert all(torch.isfinite(v) for v in metrics.values())
    assert chip_smoke.launch_counts(kernels) == {"A": 0, "B": 0, "C": 0,
                                                 "noise": 0, "D": 2}
    assert all(t.dtype == torch.float32 for t in step.leaves(state.params_g))


def test_remat_on_the_card(device, monkeypatch):
    """remat's gradients against the plain step's on the card: equal but
    for the order of cuDNN's weight-gradient sums, which two plain steps
    share (the bound is the plain step against itself, at least
    KERNEL_TOL relative); a checkpoint that redraws the dropout masks is
    far outside it. Kernel D runs twice under remat (the recompute)."""
    import chip_smoke
    from phoonnx_tpu_torch.train import step

    hp = model.VitsHParams.preset("micro", n_vocab=32)
    state = step.init_train_state(hp, step.TrainConfig(
        disc_periods=(2,), disc_channel_scale=4), device=device)
    batch = _micro_batch(hp, device, n=2)
    kernels = {"D": mas.__name__}

    def grads(remat):
        cfg = step.TrainConfig(disc_periods=(2,), disc_channel_scale=4,
                               remat=remat)
        chip_smoke.reset_launches(kernels)
        g_g, _, _ = step._micro_grads(
            state, batch, hp, cfg, False,
            generator=torch.Generator(device=device).manual_seed(9))
        return list(g_g), chip_smoke.launch_counts(kernels)["D"]

    def worst(a, b):
        return max(float((x - y).abs().max() / max(float(y.abs().max()),
                                                   1e-12))
                   for x, y in zip(a, b))

    plain, d_plain = grads(False)
    again, _ = grads(False)
    remat, d_remat = grads(True)
    tol = max(chip_smoke.KERNEL_TOL, 2 * worst(again, plain))
    err = worst(remat, plain)
    print(f"remat vs plain on the card {err:.3e}, plain vs plain "
          f"{worst(again, plain):.3e}")
    assert err <= tol and (d_plain, d_remat) == (1, 2)

    from torch.utils.checkpoint import checkpoint as torch_checkpoint

    monkeypatch.setattr(step, "_checkpointed_forward",
                        lambda fn, gen: torch_checkpoint(
                            fn, use_reentrant=False))
    redrawn, _ = grads(True)
    assert worst(redrawn, plain) > 10 * tol


def test_pipeline_on_the_card(device, tmp_path):
    """``chip_smoke.pipeline_phase`` at micro on a small corpus: every
    check of the chip run's pipeline phase (card vs CPU preprocessing,
    three epochs with their test audio and launch counts, the options'
    steps, both exports served through A, B, C and the noise kernel, the
    warm start). The test audio (``model.infer``, a torch generator's
    noise) launches A, B and C and no noise kernel."""
    import chip_smoke

    paths, d = chip_smoke.pipeline_phase(
        torch, tmp_path, 5, device, quality="micro", n_utts=14,
        seconds=(0.4, 1.2), batch_size=2, tag="card pipeline")
    assert d > 0 and all(counts[k] > 0 for counts in paths.values()
                         for k in "ABC"), paths
    assert all((counts["noise"] > 0) == (name != "pipeline test audio")
               for name, counts in paths.items()), paths


def _dp_rank(rank, world, port, out, backend, devices):
    """A rank of a data-parallel step on the card: the medium preset, a
    global batch of 4 (synthetic), its rows' averaged gradients; rank 0
    also takes one process's step on the whole batch and compares. A
    group that refuses its devices records the refusal."""
    import traceback

    import chip_smoke
    from phoonnx_tpu_torch.parallel import make_mesh, multihost, shard_batch
    from phoonnx_tpu_torch.train import step

    result = {}
    try:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        multihost.initialize(f"127.0.0.1:{port}", world, rank,
                             backend=backend)
        try:
            mesh = make_mesh(device=devices[rank])
        except ValueError as exc:
            result["refused"] = str(exc)
        else:
            dev = mesh.device
            hp = model.VitsHParams.preset("medium", n_vocab=40)
            cfg = step.TrainConfig()
            rng = np.random.default_rng(3)
            lengths = [(32, 128), (25, 101), (30, 117), (20, 90)]
            spec = np.abs(rng.standard_normal((4, 128, hp.spec_channels))
                          ).astype(np.float32) * 0.3
            batch = {
                "phoneme_ids": rng.integers(1, 40, (4, 32)).astype(np.int32),
                "phoneme_lengths": np.asarray([x for x, _ in lengths],
                                              np.int32),
                "spec": spec * (np.arange(128)[None, :, None] < np.asarray(
                    [y for _, y in lengths])[:, None, None]),
                "spec_lengths": np.asarray([y for _, y in lengths],
                                           np.int32),
                "audio": (0.3 * rng.standard_normal((4, 128 * 256))
                          ).astype(np.float32)}
            state = step.init_train_state(
                hp, cfg, torch.Generator().manual_seed(0), device=dev)

            def gen():
                return torch.Generator(device=dev).manual_seed(5)

            if rank == 0:
                g1, d1, m1 = step.step_grads(
                    state, step.batch_to_device(batch, dev), hp, cfg,
                    generator=gen())
            kernels = chip_smoke.all_kernels()
            chip_smoke.reset_launches(kernels)
            g2, d2, m2 = step.step_grads(
                state, step.batch_to_device(shard_batch(mesh, batch), dev),
                hp, cfg, generator=gen(), mesh=mesh)
            result["D"] = chip_smoke.launch_counts(kernels)["D"]
            result["equal"] = chip_smoke.equal_across(torch,
                                                      list(g2) + list(d2))
            if rank == 0:
                result["g"] = chip_smoke.leaf_rel_l2(torch, g1, g2)
                result["d"] = chip_smoke.leaf_rel_l2(torch, d1, d2)
                result["losses"] = {k: (float(m1[k]), float(m2[k]))
                                    for k in step.METRICS}
        torch.save(result, out / f"rank{rank}.pt")
    except BaseException:
        (out / f"rank{rank}.err").write_text(traceback.format_exc())
        raise
    finally:
        if torch.distributed.is_initialized():
            torch.distributed.destroy_process_group()


def _card_dp(out, backend, devices):
    from tests.test_torch_parallel import start_ranks, wait_ranks

    return wait_ranks(start_ranks(_dp_rank, len(devices), out, backend,
                                  devices), out, timeout=300)


def _assert_dp_step(ranks, label):
    """Both ranks averaged to the same bits and launched kernel D; rank
    0's gradients and losses within chip_smoke.py's bars of one
    process's."""
    import chip_smoke

    zero = ranks[0]
    assert all(r["equal"] and r["D"] == 1 for r in ranks), ranks
    print(f"{label}: grads_g median/max leaf rel-L2 {zero['g']}, grads_d "
          f"{zero['d']}")
    for key in ("g", "d"):
        median, worst = zero[key]
        assert median <= chip_smoke.DP_GRAD_MEDIAN, (key, median)
        assert worst <= chip_smoke.DP_GRAD_MAX, (key, worst)
    for k, (one, dp) in zero["losses"].items():
        assert dp == pytest.approx(one, rel=chip_smoke.DP_LOSS_RTOL), k


def test_two_ranks_share_the_card_over_gloo(device, tmp_path):
    """Two ranks on cuda:0 over gloo (its all_reduce and broadcast carry
    CUDA tensors): one medium step of a global batch of 4 against one
    process's on the card, kernel D launched in each rank."""
    _assert_dp_step(_card_dp(tmp_path, "gloo", ["cuda:0", "cuda:0"]),
                    "2 ranks on one card, gloo")


def test_nccl_refuses_ranks_that_share_a_card(device, tmp_path):
    """NCCL takes one device a rank: two ranks named onto cuda:0 raise,
    naming the ranks and the backend to use, before any NCCL collective
    (which would fail or hang)."""
    ranks = _card_dp(tmp_path, "nccl", ["cuda:0", "cuda:0"])
    for r in ranks:
        assert "ranks 0 and 1 share CUDA device" in r["refused"], r
        assert "backend='gloo'" in r["refused"]


def test_nccl_over_two_cards(device, tmp_path):
    """With two cards: the same step over NCCL, a rank a card. The
    one-card chip run cannot show this."""
    if torch.cuda.device_count() < 2:
        pytest.skip("NCCL data parallelism needs two GPUs (one a rank)")
    _assert_dp_step(_card_dp(tmp_path, "nccl", ["cuda:0", "cuda:1"]),
                    "2 ranks on two cards, nccl")


def test_capture_holds_the_collector_off(device):
    """A dead graph in a reference cycle goes when Python's cyclic
    collector next runs. A collection inside a capture destroyed such
    graphs there (a dropped engine's, a server phase before) and
    invalidated the capture. Here a captured graph becomes garbage in a
    young cycle inside a capture, with a collection due at every
    allocation: the capture holds the collector off and succeeds, and
    the cycle goes after it."""
    import gc
    import weakref

    from phoonnx_tpu_torch.infer.graphs import Graphs

    device = torch.device("cuda", torch.cuda.current_device())
    x = torch.arange(8.0, device=device)
    dead = Graphs(device)
    dead.run(("old",), lambda t: t * 2, (x,))
    assert dead.programs[("old",)].graph is not None
    gone = weakref.ref(dead)
    holder = [dead]
    del dead

    def busy(t):
        if torch.cuda.is_current_stream_capturing() and holder:
            cycle = [holder.pop()]
            cycle.append(cycle)
            del cycle  # garbage from here on, in the youngest generation
            junk = [[i] for i in range(2000)]  # collections fall due
            assert len(junk) == 2000
        return t + 1

    thresholds = gc.get_threshold()
    gc.set_threshold(1, 1, 1)
    try:
        live = Graphs(device)
        live.run(("new",), busy, (x,))
    finally:
        gc.set_threshold(*thresholds)
    assert gc.isenabled() and not holder
    assert torch.equal(live.run(("new",), busy, (x,)), x + 1)
    gc.collect()
    assert gone() is None
