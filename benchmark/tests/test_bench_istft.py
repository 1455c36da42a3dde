"""Whole runs of the MB-iSTFT-VITS serving cell at micro widths on the
CPU: the harness's last line, its faults, and its two head metrics.

On the CPU the profiler sees no device, so the traced run is given one: a
decoding replay's operations (kernel C's, then the head's) laid into the
window for each ``engine.phase2`` span of the run, and the card's peaks.
The head's metrics then read exactly those operations."""

import dataclasses
import json
import time

import numpy as np
import pytest
import torch

from bench_micro import BENCH, micro_cell
from harness import peaks, runner, serve, serve_istft

WORKLOAD = "mb-istft-vits.serve-lj-c64"
ISTFT_KEYS = ("decoder_type", "istft_n_fft", "istft_hop", "istft_bands")


def micro_istft_cell():
    """The cell at the port's micro widths, its 4-band iSTFT head kept,
    with texts of 0.5-1.5 s: the head's hop of 256 samples a frame makes
    16 times the audio of the micro HiFi-GAN voice's, and a run on a
    loaded CPU must still answer its whole sample in its window."""
    from phoonnx_tpu_torch.models.vits.model import VitsHParams

    cell = micro_cell(WORKLOAD, "mb-istft-vits", "lj-closed-64-istft")
    cfg = json.loads((BENCH / "configs" / "mb-istft-vits.json").read_text())
    for k, v in dataclasses.asdict(VitsHParams.preset("micro")).items():
        if k in cfg and k not in ISTFT_KEYS:
            cfg[k] = json.loads(json.dumps(v))
    cfg["init"]["mag_bias"] = 0.0  # the narrower voice peaks above 0.1
    mix = dict(cell.traffic)
    mix["texts"] = dict(mix["texts"], clip_s=[0.5, 1.0, 1.5])
    return runner.Cell(cell.name, 1, cfg, mix, cell.manifest)


def run_cell(trace=False, seed=2 ** 31 + 19):
    torch.set_num_threads(2)
    return runner.execute(micro_istft_cell(), seed, 2.0, trace,
                          torch.device("cpu"), time.perf_counter())


def test_a_sound_run_is_correct():
    res = run_cell()
    assert res["correct"] and res["attempted"] > 0 and res["failed"] == 0
    assert set(res["metrics"]) == {"setup_s", "audio_s_per_s"}
    assert all(v["value"] > 0 for v in res["metrics"].values())
    # a step of rounding at most, against a voice that peaks above 0.1
    assert res["checks"]["wav_gap_per_peak"]["value"] <= 10


def _samples_moved(load_voice):
    def load(cfg, flat, device):
        voice = load_voice(cfg, flat, device)
        synth = voice.engine.synthesize_batch

        def broken(*args, **kwargs):
            audio, frames = synth(*args, **kwargs)
            audio = np.array(audio)
            audio[:, 40:48] += 0.01  # about 330 16-bit steps
            return audio, frames

        voice.engine.synthesize_batch = broken
        return voice
    return load


def test_an_answer_altered_where_it_is_made_is_not_correct(monkeypatch):
    monkeypatch.setattr(serve, "load_voice", _samples_moved(serve.load_voice))
    res = run_cell()
    assert res["correct"] is False
    c = res["checks"]["wav_gap_per_peak"]
    assert c["value"] > c["limit"]


# each stand-in replay: a tap conv of kernel C, then the head's two
# operations (µs from the replay's start: start, end)
TAP = (0.0, 50.0)
HEAD = ((60.0, 80.0), (85.0, 100.0))


def test_a_traced_run_reads_the_head(monkeypatch):
    from phoonnx_tpu_torch import observability

    real = serve_istft.device_ops
    laid = {}

    def with_a_card(events):
        window, ops = real(events)
        n = observability.session()["spans"]["engine.phase2"]["count"]
        lo, hi = window
        step = (hi - lo) / (n + 1)
        for i in range(n):
            t0 = lo + (i + 1) * step
            corr = 10 ** 6 + i
            ops.append((t0 + TAP[0], t0 + TAP[1], "tapconv_kernel_64", corr))
            for a, b in HEAD:
                ops.append((t0 + a, t0 + b, "dgrad_engine", corr))
        laid["n"] = n
        return window, ops

    monkeypatch.setattr(serve_istft, "device_ops", with_a_card)
    monkeypatch.setitem(peaks.PEAKS, "cpu", peaks.PEAKS["H100"])
    res = run_cell(trace=True)
    assert res["correct"]
    got = {k: v["value"] for k, v in res["metrics"].items()}
    n = laid["n"]
    assert n > 0
    # the stand-in replays are all the device's work
    head = sum(b - a for a, b in HEAD)
    busy = TAP[1] - TAP[0] + head
    assert got["istft_head_share.thru"] == pytest.approx(100 * head / busy)
    assert 0 < got["istft_head_roofline.thru"] < 100
    # the readers of the program's spans read too; those of the device's
    # timeline (the kernels' rooflines, the idle share) find no device
    assert set(got) == {"istft_head_share.thru", "istft_head_roofline.thru",
                        "mfu.serve", "queue_ms.thru", "reassemble_ms.thru",
                        "frame_fill.thru", "prior_ms.thru",
                        "offcpu_share.thru"}
