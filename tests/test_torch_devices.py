"""Each kernel launch runs with its tensors' device current, on the CPU.

A wrapper hands the C side raw pointers and a stream; the C side queries
occupancy and launches on the CUDA runtime's current device. So every
wrapper must make the tensors' device current around its C calls, and
``cuda.occupancy`` must cache per device. These tests replace the C entry
points with fakes and ``torch.cuda.device`` with a recorder, and drive the
wrappers on meta tensors (shapes without storage), so no card is needed.
"""

import ctypes

import pytest
import torch

from phoonnx_tpu_torch import cuda
from phoonnx_tpu_torch.models.vits import (fused_encoder, fused_flow,
                                           fused_stage, model)
from phoonnx_tpu_torch.ops import mas


class DeviceRecorder:
    """Stands in for ``torch.cuda.device``: notes which device is current."""

    current = None

    def __init__(self, device):
        self.device = device

    def __enter__(self):
        self.prev = DeviceRecorder.current
        DeviceRecorder.current = self.device

    def __exit__(self, *exc):
        DeviceRecorder.current = self.prev


@pytest.fixture
def fake_c(monkeypatch):
    """Fake C entry points: each call is noted with the device current at
    the call; occupancy queries answer 2 blocks on 4 SMs."""
    calls = []

    def function(library, symbol, argtypes, restype=cuda.c_int):
        def fn(*args):
            calls.append((symbol, DeviceRecorder.current))
            if symbol.endswith("_occupancy"):
                out = ctypes.cast(args[-1], ctypes.POINTER(ctypes.c_int))
                out[0], out[1] = 2, 4
            return 0
        return fn

    DeviceRecorder.current = None
    monkeypatch.setattr(cuda, "function", function)
    monkeypatch.setattr(cuda, "_OCCUPANCY", {})
    monkeypatch.setattr(cuda, "stream_of", lambda t: 0)
    monkeypatch.setattr(torch.cuda, "device", DeviceRecorder)
    return calls


def test_occupancy_keys_on_the_given_device(fake_c):
    one, zero = torch.device("cuda", 1), torch.device("cuda", 0)
    assert cuda.occupancy("lib", "k_occupancy", one, 7) == (2, 4)
    assert fake_c == [("k_occupancy", one)]
    assert cuda.occupancy("lib", "k_occupancy", one, 7) == (2, 4)
    assert len(fake_c) == 1  # cached for device 1
    cuda.occupancy("lib", "k_occupancy", zero, 7)
    assert fake_c[-1] == ("k_occupancy", zero)  # device 0 asks again
    cuda.occupancy("lib", "k_occupancy", one, 8)
    assert len(fake_c) == 3  # other arguments, another query
    assert DeviceRecorder.current is None  # every guard was left


@pytest.fixture(scope="module")
def meta_params():
    hp = model.VitsHParams.preset("micro", n_vocab=32)
    params = model.random_params(hp, torch.Generator().manual_seed(0))
    return model.attach_fused_specs(
        model.params_to_device(params, torch.device("meta")))


def _launch_encoder(p, dev):
    spec = p["enc_p"]["encoder"]["fused"]
    h = spec["n_heads"] * spec["dk"]
    return fused_encoder.launch(spec, torch.empty(2, 9, h, device=dev),
                                torch.empty(2, 9, 1, device=dev))


def _launch_flow(p, dev):
    spec = p["flow"]["fused_rev"]
    return fused_flow.launch(spec,
                             torch.empty(1, 12, 2 * spec["half"], device=dev),
                             torch.empty(1, 12, 1, device=dev))


def _launch_stage(p, dev):
    spec = p["dec"]["fused_stages"][0]
    c = spec["W"].shape[1]
    return fused_stage.launch(spec, torch.empty(1, 20, c, device=dev),
                              torch.empty(1, dtype=torch.int32, device=dev))


def _launch_mas(p, dev):
    lens = torch.empty(2, dtype=torch.int32, device=dev)
    return mas.launch(torch.empty(2, 6, 4, device=dev), lens, lens)


@pytest.mark.parametrize("launch,entry", [
    (_launch_encoder, "fused_encoder_forward"),
    (_launch_flow, "fused_flow_reverse"),
    (_launch_stage, "fused_stage_group"),
    (_launch_mas, "mas_path"),
], ids=["A", "B", "C", "D"])
def test_wrappers_launch_under_the_tensor_device(fake_c, meta_params,
                                                 launch, entry):
    dev = torch.device("meta")
    launch(meta_params, dev)
    launched = [current for symbol, current in fake_c if symbol == entry]
    assert launched == [dev], fake_c
    # an occupancy query, where the kernel has one, ran on that device too
    for symbol, current in fake_c:
        if symbol.endswith("_occupancy"):
            assert current == dev, fake_c
    assert DeviceRecorder.current is None
