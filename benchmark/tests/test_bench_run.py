"""Whole runs of the serving cells at micro widths on the CPU: the
harness's last line, its faults, and what it loads.

``runner.execute`` is the run without the look for a card; the program
runs its plain path on the CPU."""

import json
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from bench_micro import BENCH, micro_cell
from harness import runner, serve

# the closed loop of a cell of BENCHMARK.json, and the open loop (the knee
# sweep's mix, in no cell yet)
CELLS = {"piper-medium.serve-lj-c64": ("piper-medium", "lj-closed-64"),
         "piper-medium.serve-lj-open": ("piper-medium", "lj-open")}


def run_cell(workload: str, trace: bool = False, seed: int = 2 ** 31 + 9):
    torch.set_num_threads(2)
    cell = micro_cell(workload, *CELLS[workload])
    return runner.execute(cell, seed, 2.0, trace, torch.device("cpu"),
                          time.perf_counter())


@pytest.mark.parametrize("workload", CELLS)
def test_a_sound_run_is_correct(workload):
    res = run_cell(workload)
    assert list(res) == ["correct", "attempted", "failed", "metrics",
                         "device", "checks"]
    assert res["correct"] and res["attempted"] > 0 and res["failed"] == 0
    cell = micro_cell(workload, *CELLS[workload])
    e2e = {m["name"] for m in cell.manifest["end_to_end"]
           if runner.applies(m, cell)}
    assert set(res["metrics"]) == e2e
    assert all(v["value"] > 0 for v in res["metrics"].values())


def test_a_traced_run_reports_per_layer_metrics():
    res = run_cell("piper-medium.serve-lj-c64", trace=True)
    assert res["correct"]
    assert "breakdown" in res and res["device"]["window_s"] > 0
    # on the CPU no device metric has anything to read, nor a dispatch
    # count (no graphs)
    assert set(res["metrics"]) == {"dispatch_host_ms.thru"}


def _altered(voice_of, alter):
    def load(cfg, flat, device):
        voice = voice_of(cfg, flat, device)
        engine = voice.engine
        synth = engine.synthesize_batch

        def broken(*args, **kwargs):
            audio, frames = synth(*args, **kwargs)
            return alter(audio, frames)

        engine.synthesize_batch = broken
        return voice
    return load


def _samples_moved(audio, frames):
    audio = np.array(audio)
    audio[:, 40:48] += 0.01  # about 330 16-bit steps
    return audio, frames


def _frame_dropped(audio, frames):
    return audio, [max(1, n - 1) for n in frames]


@pytest.mark.parametrize("alter,check", [(_samples_moved, "wav_gap_lsb"),
                                         (_frame_dropped, "wrong_length")])
@pytest.mark.parametrize("workload", CELLS)
def test_an_answer_altered_where_it_is_made_is_not_correct(
        monkeypatch, workload, alter, check):
    monkeypatch.setattr(serve, "load_voice", _altered(serve.load_voice,
                                                      alter))
    res = run_cell(workload)
    assert res["correct"] is False
    c = res["checks"][check]
    assert c["value"] > c["limit"]


def test_run_refuses_without_a_card():
    proc = subprocess.run(
        [sys.executable, str(BENCH / "run.py"), "--workload", "piper-medium.serve-lj-c64",
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=BENCH.parent, capture_output=True, text=True, timeout=300)
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    assert proc.returncode != 0
    assert not any(line.startswith("{") for line in proc.stdout.splitlines())


BLOCK = """
import importlib.abc, sys
class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path, target=None):
        if name.split(".")[0] in {forbidden!r}:
            raise ImportError("blocked: " + name)
sys.meta_path.insert(0, Block())
sys.path[:0] = [{bench!r}, {root!r}, {tests!r}]
import time, torch
from harness import runner
from test_bench_run import run_cell
res = run_cell({workload!r})
loaded = sorted({{m.split(".")[0] for m in sys.modules}})
print(json.dumps({{"correct": res["correct"], "loaded": loaded}}))
"""


@pytest.mark.parametrize("workload", CELLS)
def test_a_run_loads_nothing_of_jax(workload):
    """Every module a run imports, the program's included, with JAX, jaxlib,
    flax and the JAX package blocked; the top-level names compared whole
    (``phoonnx_tpu_torch`` is not ``phoonnx_tpu``)."""
    code = "import json\n" + BLOCK.format(
        forbidden=set(runner.FORBIDDEN), bench=str(BENCH),
        root=str(BENCH.parent), tests=str(BENCH / "tests"),
        workload=workload)
    proc = subprocess.run([sys.executable, "-c", code], cwd=BENCH.parent,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["correct"]
    assert not set(out["loaded"]) & set(runner.FORBIDDEN)
    assert "phoonnx_tpu_torch" in out["loaded"]
