"""The benchmark's MB-iSTFT-VITS voice on the CPU: its plain reference
(``benchmark/reference/mb_istft.py``) against the port, the weights'
layout, the comparison that decides a run's ``correct``, and how the
harness finds the decoder head's operations in a device trace and reads
its two per-layer metrics.

The benchmark's modules are loaded by path, as its runner loads them,
with ``benchmark/`` on the path for their own imports (``reference``,
``harness``).
"""

import dataclasses
import importlib.util
import json
import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from phoonnx_tpu_torch import observability
from phoonnx_tpu_torch.models.vits.load import params_to_flat
from phoonnx_tpu_torch.models.vits.model import VitsHParams, random_params
from phoonnx_tpu_torch.ops.pqmf import pqmf_filters

BENCH = Path(__file__).resolve().parent.parent / "benchmark"
CONFIG = json.loads((BENCH / "configs" / "mb-istft-vits.json").read_text())
# the decoder family's keys, kept when the widths are cut to micro's
ISTFT_KEYS = ("decoder_type", "istft_n_fft", "istft_hop", "istft_bands")


def load(relative: str, name: str):
    """A module of the benchmark by its path."""
    if str(BENCH) not in sys.path:
        sys.path.insert(0, str(BENCH))
    spec = importlib.util.spec_from_file_location(name, BENCH / relative)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(scope="module")
def bench():
    return SimpleNamespace(
        ref=load("reference/mb_istft.py", "bench_mb_istft"),
        vits=load("reference/vits.py", "bench_ref_vits"),
        serve=load("harness/serve.py", "bench_serve"),
        istft=load("harness/serve_istft.py", "bench_serve_istft"),
        weights=load("harness/weights.py", "bench_weights"),
        frontend=load("reference/frontend.py", "bench_frontend"))


def small_config(resblock: str) -> dict:
    """The configuration at the port's micro widths, with its 4-band iSTFT
    head kept, and a resblock "1" or "2" group of two kernels; the
    magnitude head's bias raised so that the narrower voice peaks above
    0.1."""
    cfg = json.loads(json.dumps(CONFIG))
    for k, v in dataclasses.asdict(VitsHParams.preset("micro")).items():
        if k in cfg and k not in ISTFT_KEYS:
            cfg[k] = json.loads(json.dumps(v))
    cfg["init"]["mag_bias"] = 0.0
    cfg["resblock"] = resblock
    cfg["resblock_kernel_sizes"] = [3, 5]
    cfg["resblock_dilation_sizes"] = [[1, 3], [1, 2]] if resblock == "1" \
        else [[1, 2], [2, 3]]
    return cfg


def test_layout_is_the_programs(bench):
    """Every name and shape of the port's flat layout, at the
    configuration's own widths."""
    hp = bench.serve.hparams(CONFIG)
    assert (hp.decoder_type, hp.istft_bands, hp.total_upsample) == \
        ("istft", 4, 256)
    port = params_to_flat(random_params(hp, torch.Generator().manual_seed(0)))
    mine = {n: s for n, s, _, _ in bench.istft.layout(CONFIG)}
    assert mine == {k: tuple(v.shape) for k, v in port.items()}
    assert mine["dec.conv_mag.weight"] == (36, 128, 7)
    assert "dec.conv_post.weight" not in mine


def test_pqmf_filters_are_the_programs(bench):
    """The reference designs its synthesis bank on its own; it is the
    port's (ParallelWaveGAN's construction at the port's cutoff)."""
    mine = bench.ref.pqmf_synthesis_filters(4).numpy()
    np.testing.assert_allclose(mine, pqmf_filters(4)[1], rtol=0, atol=1e-7)


@pytest.mark.parametrize("resblock", ["1", "2"])
@pytest.mark.parametrize("seed", [5, 2 ** 31 + 11])
def test_reference_is_the_programs_plain_path(bench, resblock, seed):
    """The port's voice (a padded batch of two through its engine's plain
    path) against the reference, utterance by utterance."""
    cfg = small_config(resblock)
    flat = bench.weights.make(bench.istft.layout(cfg), seed, "cpu")
    voice = bench.serve.load_voice(cfg, flat, "cpu")
    w = bench.vits.Weights(flat)
    texts = ["abcde fghij klmno", "the quick brown fox jumps over"]
    ids = [bench.frontend.text_to_ids(t, bench.serve.id_map(cfg))
           for t in texts]
    scale = bench.serve.length_scale(w, cfg, ids, 2.5)
    audio, frames = voice.engine.synthesize_batch(
        ids, noise_scale=0.0, length_scale=scale, noise_w=0.0, seed=0)
    hop = bench.ref.hop(cfg)
    assert hop == voice.engine.hp.total_upsample == 256
    for row, n, u in zip(audio, frames, ids):
        got = row[:n * hop]
        with torch.no_grad():
            want = bench.ref.synthesize(w, cfg, u, scale).numpy()
        assert got.shape == want.shape
        assert np.abs(want).max() > 0.05  # a voice, not silence
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
        v = bench.ref.judge(w, cfg, u, scale, bench.ref.pcm16(got))
        assert v.frames_ok and v.gap_lsb <= 1
        assert v.peak == pytest.approx(float(np.abs(want).max()))


def _swap_bands(flat, bands):
    """The heads' output channels with the first two bands swapped."""
    out = dict(flat)
    for head in ("dec.conv_mag", "dec.conv_phase"):
        for leaf in ("weight", "bias"):
            t = flat[f"{head}.{leaf}"]
            per = t.shape[0] // bands
            order = torch.cat([torch.arange(per, 2 * per),
                               torch.arange(per),
                               torch.arange(2 * per, t.shape[0])])
            out[f"{head}.{leaf}"] = t[order]
    return out


def _flip_phase(flat, bands):
    """The phase head negated: every band's spectrum conjugated."""
    out = dict(flat)
    for leaf in ("weight", "bias"):
        out[f"dec.conv_phase.{leaf}"] = -flat[f"dec.conv_phase.{leaf}"]
    return out


@pytest.mark.parametrize("alter", [_swap_bands, _flip_phase])
def test_judge_refuses_an_altered_answer(bench, alter):
    """An answer of the right length made with two bands swapped, or the
    phases' signs flipped, reads far above the cell's limit; the
    reference's own answer reads 0, and one a frame short is of a wrong
    length."""
    cfg = small_config("1")
    flat = bench.weights.make(bench.istft.layout(cfg), 9, "cpu")
    w = bench.vits.Weights(flat)
    u = bench.frontend.text_to_ids("abcde fghij", bench.serve.id_map(cfg))
    ref = bench.ref
    with torch.no_grad():
        good = ref.pcm16(ref.synthesize(w, cfg, u, 2.0).numpy())
        bad = ref.pcm16(ref.synthesize(
            bench.vits.Weights(alter(flat, cfg["istft_bands"])), cfg, u,
            2.0).numpy())
    v = ref.judge(w, cfg, u, 2.0, good)
    assert v.frames_ok and v.gap_lsb == 0 and v.peak > 0.1
    v = ref.judge(w, cfg, u, 2.0, bad)
    assert v.frames_ok
    assert v.gap_per_peak > 20 * CONFIG["limits"]["wav_gap_per_peak"]
    assert not ref.judge(w, cfg, u, 2.0, good[:-ref.hop(cfg)]).frames_ok


# -- the head's operations in a device trace --------------------------------

C = ["tapconv_kernel", "post_kernel"]


def _replay(corr, t0):
    """A phase-2 replay's operations from t0 (µs): the flow, two stages of
    an upsampling dgrad and two tap convs each, then the head (its own
    dgrads among them)."""
    ops, t = [], t0
    names = (["flow_persistent"]
             + ["dgrad_engine", "tapconv_kernel_64", "tapconv_kernel_64"] * 2
             + ["elementwise", "gemm", "dgrad_engine", "dgrad_engine"])
    for name in names:
        ops.append((t, t + 10.0, name, corr))
        t += 12.0
    return ops


def test_head_is_what_follows_a_replays_last_kernel_c_op(bench):
    ops = (_replay(7, 0.0) + _replay(9, 1000.0)
           # a phase-1 replay, eager copies and an op of no recorded id
           + [(500.0, 520.0, "encoder_persistent", 8),
              (530.0, 540.0, "Memcpy DtoH", 31),
              (600.0, 610.0, "tapconv_kernel_64", 32),
              (700.0, 705.0, "elementwise", 0)])
    head, found = bench.istft.head_seconds(ops, C, (0.0, 1e6))
    assert found == 2  # the lone eager tap conv has no head
    assert head == pytest.approx(2 * 4 * 10e-6)
    # clipped to the window: the second replay's head starts at 1084 µs
    head, _ = bench.istft.head_seconds(ops, C, (0.0, 1095.0))
    assert head == pytest.approx(40e-6 + 10e-6)
    assert bench.istft.head_seconds(ops, ["nothing"], (0.0, 1e6)) == (0.0, 0)
    busy = bench.istft.busy_seconds(ops, (0.0, 1e6))
    assert busy == pytest.approx((2 * 11 * 10 + 20 + 10 + 10 + 5) * 1e-6)


class _Event:
    def __init__(self, name, start_us, dur_us, cpu, corr=0):
        self._name, self._cpu, self._corr = name, cpu, corr
        self._start, self._dur = int(start_us * 1e3), int(dur_us * 1e3)

    def name(self):
        return self._name

    def device_type(self):
        return (torch.autograd.DeviceType.CPU if self._cpu
                else torch.autograd.DeviceType.CUDA)

    def start_ns(self):
        return self._start

    def duration_ns(self):
        return self._dur

    def correlation_id(self):
        return self._corr


def test_device_ops_are_the_devices_and_the_window_the_hosts(bench):
    """The window is the host's ``bench.window`` range; a device event
    that mirrors a host range's name is no operation."""
    events = [_Event("bench.window", 100.0, 900.0, True),
              _Event("cudaGraphLaunch", 150.0, 5.0, True, 7),
              _Event("engine.step", 150.0, 50.0, True),
              _Event("engine.step", 160.0, 40.0, False, 7),
              _Event("tapconv_kernel_64", 170.0, 10.0, False, 7),
              _Event("dgrad_engine", 185.0, 10.0, False, 7)]
    window, ops = bench.istft.device_ops(events)
    assert window == (100.0, 1000.0)
    assert ops == [(170.0, 180.0, "tapconv_kernel_64", 7),
                   (185.0, 195.0, "dgrad_engine", 7)]


@pytest.fixture
def recorder(monkeypatch):
    rec = observability._Recorder()
    monkeypatch.setattr(observability, "_RECORDER", rec)
    return rec


def test_head_metrics_read_the_counters(bench, recorder):
    """Both per-layer metrics of the head, from a run's counters and the
    program's ``engine.phase2`` spans; nothing to read gives None."""
    from torch.profiler import ProfilerActivity, profile

    share = load("metrics/istft_head_share.thru.py", "bench_head_share").read
    roof = load("metrics/istft_head_roofline.thru.py",
                "bench_head_roofline").read
    flops = load("harness/flops_istft.py", "bench_flops_istft")
    peaks = {"tf32": 495e12, "bf16": 989e12, "bytes": 3.35e12}
    cell = SimpleNamespace(config=CONFIG)
    reqs = [(100, 300), (80, 250)]
    counters = {"requests": reqs, "istft_head_s": 0.002,
                "istft_busy_s": 0.04}
    reading = SimpleNamespace(cell=cell, counters=counters, peaks=peaks)
    assert share(reading) == pytest.approx(5.0)
    assert roof(reading) is None  # no engine.phase2 span yet
    with profile(activities=[ProfilerActivity.CPU]):
        for _ in range(3):
            with observability.span("engine.phase2", decoder="istft",
                                    bands=4):
                pass
    fl = sum(flops.head(CONFIG, f) for _, f in reqs)
    nb = (sum(flops.head_bytes(CONFIG, f) for _, f in reqs)
          + 3 * flops.head_weight_bytes(CONFIG))
    least = max(fl / 495e12, nb / 3.35e12)
    assert roof(reading) == pytest.approx(100 * least / 0.002)
    assert 0 < roof(reading) < 100
    empty = SimpleNamespace(cell=cell, counters={"requests": reqs},
                            peaks=peaks)
    assert share(empty) is None and roof(empty) is None


def test_head_flops_are_a_small_share_of_the_decoder(bench):
    """The head's operations a frame (the two heads dominate) beside the
    decoder's stages in ``flops.py``."""
    flops = load("harness/flops.py", "bench_flops")
    head = load("harness/flops_istft.py", "bench_flops_istft").head
    heads = 2 * 2.0 * 16 * 36 * 128 * 7  # 16 steps a frame
    assert heads < head(CONFIG, 1) < 1.05 * heads
    assert 0.01 < head(CONFIG, 1) / flops.decoder(CONFIG, 1) < 0.02
    assert head(CONFIG, 200) == pytest.approx(200 * head(CONFIG, 1),
                                              rel=0.01)
