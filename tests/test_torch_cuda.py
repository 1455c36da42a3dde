"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``: each test needs an NVIDIA GPU and ``nvcc`` and skips
without them (the CPU suite imports this file and skips every test). On
the machine with the card, which has no JAX for ``tests/conftest.py`` to
import, run them with::

    python -m pytest --noconftest tests/test_torch_cuda.py -q

The shapes are small; ``chip_smoke.py`` runs the same comparisons at the
medium preset's shapes and drives the whole synthesis path.
"""

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


@pytest.mark.parametrize("lengths", [[(96, 40), (50, 17), (30, 33)],
                                     [(300, 64)]])
def test_mas_kernel(device, lengths):
    """Kernel D is bit-identical to its plain version: ragged batches, an
    x_len above y_len, ties from integer scores, T_y above 256."""
    b = len(lengths)
    t_y = max(y for y, _ in lengths)
    t_x = max(x for _, x in lengths)
    gen = torch.Generator(device=device).manual_seed(5)
    neg_cent = torch.randn(b, t_y, t_x, device=device, generator=gen)
    neg_cent[0] = torch.round(neg_cent[0] * 2)
    mask = torch.zeros(b, t_y, t_x, device=device)
    for i, (y, x) in enumerate(lengths):
        mask[i, :y, :x] = 1
    value, y_lens, x_lens = mas.lengths_and_value(neg_cent, mask)
    before = mas.launches
    got = mas.maximum_path(neg_cent, mask)
    assert mas.launches == before + 1
    want = mas.maximum_path_plain(value, y_lens, x_lens) * mask
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert torch.equal(mas.launch(value, y_lens, x_lens),
                       mas.maximum_path_plain(value, y_lens, x_lens))


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
