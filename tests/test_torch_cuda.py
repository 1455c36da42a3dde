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
