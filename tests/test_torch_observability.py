"""The port's spans and counters (``phoonnx_tpu_torch/observability.py``),
on the CPU.

Tracing is on exactly while a ``torch.profiler`` trace is open: spans on
any thread land in the session, with their parent, self time and CPU time;
a new trace starts a new session; ``device_trace`` writes the spans into
its Chrome trace beside the profiler's own events. The batcher's and the
training step's spans are checked at micro widths, and each per-layer
metric of the benchmark that reads the session is loaded by path, as the
benchmark's runner loads it, and read from a session and from an empty
one.
"""

import importlib.util
import json
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from phoonnx_tpu_torch import observability
from phoonnx_tpu_torch.infer import VitsEngine
from phoonnx_tpu_torch.models.vits.model import VitsHParams, random_params
from phoonnx_tpu_torch.serve import COUNTERS, DynamicBatcher
from phoonnx_tpu_torch.train import step

ROOT = Path(__file__).resolve().parent.parent
SCALES = (0.667, 1.0, 0.8)
TRAIN_PHASES = ("train.gen_forward", "train.gen_backward", "train.disc",
                "train.update")


@pytest.fixture
def recorder(monkeypatch):
    """A fresh recorder in place of the process's, so that no other test's
    session shows."""
    rec = observability._Recorder()
    monkeypatch.setattr(observability, "_RECORDER", rec)
    return rec


def tracing():
    return profile(activities=[ProfilerActivity.CPU])


def busy(seconds: float) -> None:
    end = time.monotonic() + seconds
    while time.monotonic() < end:
        pass


def test_spans_off_record_nothing(recorder):
    span = observability.span("off.span", lanes=3)
    assert span is observability.span("off.other")  # one shared no-op
    with span as s:
        s.set(frames=2)
    observability.count("off.counter")
    observability.record("off.queue", observability.stamp())
    assert observability.stamp() is None
    assert observability.session() == {"spans": {}, "counters": {}}
    assert observability.session_spans() == []


def test_worker_thread_spans_land_in_the_session(recorder):
    def work():
        with observability.span("w.outer", lanes=4, group_id=9) as outer:
            busy(0.004)
            with observability.span("w.inner"):
                time.sleep(0.01)  # off the CPU
            outer.set(frames=7)

    with tracing():
        worker = threading.Thread(target=work, name="worker")
        worker.start()
        worker.join(timeout=30)
        assert not worker.is_alive()
        observability.count("w.counter", 2)
        observability.count("w.counter")
    got = observability.session()
    outer, inner = got["spans"]["w.outer"], got["spans"]["w.inner"]
    assert outer["count"] == inner["count"] == 1
    assert got["counters"] == {"w.counter": 3}
    # identifiers are not summed; other numeric args are
    assert outer["args"] == {"lanes": 4, "frames": 7}
    # self time is the span less its child's
    assert outer["self_wall_ms"] == pytest.approx(
        outer["wall_ms"] - inner["wall_ms"], abs=1e-6)
    assert inner["wall_ms"] >= 10.0
    for s in (outer, inner):
        assert 0 <= s["self_cpu_ms"] <= s["cpu_ms"] <= s["wall_ms"]
    # the sleep is off the CPU
    assert inner["cpu_ms"] < 0.5 * inner["wall_ms"]
    assert observability.session("worker")["spans"].keys() == {
        "w.outer", "w.inner"}
    assert observability.session("MainThread")["spans"] == {}
    parents = {name: parent for _, _, name, thread, parent, _ in
               recorder.spans() if thread == "worker"}
    assert parents == {"w.outer": None, "w.inner": "w.outer"}
    spans = observability.session_spans("worker")
    assert sorted(name for *_, name in spans) == ["w.inner", "w.outer"]
    (a, b, _), = [s for s in spans if s[2] == "w.outer"]
    assert a < b <= time.monotonic()


def test_a_span_begun_with_the_trace_off_is_not_kept(recorder):
    with observability.span("early"):
        with tracing():
            with observability.span("inside"):
                pass
    assert set(observability.session()["spans"]) == {"inside"}


@pytest.mark.parametrize("ends_by", ["a read", "a span open at its close"])
def test_a_new_trace_starts_a_new_session(recorder, ends_by):
    with tracing():
        with observability.span("first"):
            pass
        observability.count("first.counter")
        straddle = observability.span("straddle")
        straddle.__enter__()
    straddle.__exit__(None, None, None)
    if ends_by == "a read":
        # a span open across the trace's close is not kept
        assert set(observability.session()["spans"]) == {"first"}
    with tracing():
        with observability.span("second"):
            pass
    got = observability.session()
    assert set(got["spans"]) == {"second"} and got["counters"] == {}


def test_cross_thread_span_carries_the_stamping_thread(recorder):
    stamps = {}

    def submit():
        stamps["s"] = observability.stamp()

    with tracing():
        handler = threading.Thread(target=submit, name="handler-1")
        handler.start()
        handler.join(timeout=30)
        time.sleep(0.003)
        observability.record("batcher.queue", stamps["s"], request_id=4,
                             group_id=1)
    q = observability.session("handler-1")["spans"]["batcher.queue"]
    assert q["count"] == 1 and q["wall_ms"] >= 3.0
    assert q["cpu_ms"] == 0 and q["args"] == {}


def test_device_trace_writes_the_spans_beside_the_profilers(recorder,
                                                            tmp_path):
    def work():
        with observability.span("worker.span", lanes=2):
            time.sleep(0.002)

    with observability.device_trace(str(tmp_path)):
        with observability.span("main.span"):
            with record_function("main.range"):
                time.sleep(0.005)
        worker = threading.Thread(target=work, name="worker")
        worker.start()
        worker.join(timeout=30)
    path, = tmp_path.glob("*.json")
    events = json.loads(path.read_text())["traceEvents"]
    rows = {e["tid"]: e["args"]["name"] for e in events
            if e.get("ph") == "M" and e.get("name") == "thread_name"}
    ours = {e["name"]: e for e in events if e.get("cat") == "phoonnx"}
    assert set(ours) == {"main.span", "worker.span"}
    assert rows[ours["main.span"]["tid"]] == "phoonnx spans: MainThread"
    assert rows[ours["worker.span"]["tid"]] == "phoonnx spans: worker"
    assert ours["worker.span"]["args"]["lanes"] == 2
    rng, = [e for e in events
            if e.get("ph") == "X" and e.get("name") == "main.range"]
    span = ours["main.span"]
    # one timeline: the span around the range lands within 1 ms of it
    assert abs(span["ts"] - rng["ts"]) < 1000
    assert abs(span["ts"] + span["dur"] - rng["ts"] - rng["dur"]) < 1000


def test_spans_are_placed_by_the_shortest_anchor(recorder, tmp_path):
    """Of the anchor ranges, the one that left soonest after its clock
    read places the spans: a first range that lingered 1.5 ms past its
    read would move every span by as much."""
    with tracing():
        with observability.span("main.span"):
            pass
    (start, *_), = recorder.spans()
    events = [{"ph": "X", "name": observability.ANCHOR, "pid": 1, "tid": 1,
               "ts": 1000.0, "dur": 2000.0},
              {"ph": "X", "name": observability.ANCHOR, "pid": 1, "tid": 1,
               "ts": 3100.0, "dur": 10.0}]
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": events}))
    # the reads: 1.5 ms before the first range's end, 5 µs before the
    # second's
    assert observability._span_rows(str(path), [1_500_000, 3_105_000]) == 1
    ours, = [e for e in json.loads(path.read_text())["traceEvents"]
             if e.get("cat") == "phoonnx"]
    assert ours["ts"] == pytest.approx(start / 1e3 + 5.0)


@pytest.fixture(scope="module")
def engine():
    hp = VitsHParams.preset("micro", n_vocab=20)
    return VitsEngine(random_params(hp, torch.Generator().manual_seed(0)),
                      hp, device="cpu")


def test_batcher_spans_match_its_counters(recorder, engine):
    batcher = DynamicBatcher(engine, max_batch=4, max_wait_ms=5.0)
    sentences = [[1, 5, 9, 3, 7][:n] for n in (2, 3, 4, 5)]
    with tracing():
        try:
            subs = [batcher.submit(sentences * k, SCALES)
                    for k in (1, 2, 3)]
            audio = [sub.wait(timeout=120) for sub in subs]
        finally:
            # the dispatcher closes its group's spans after the handlers
            # wake: stopping it inside the trace keeps them
            batcher.stop()
    stats = batcher.stats
    assert set(COUNTERS) | {"max_batch_seen", "batches"} == set(stats)
    assert stats["batches"] == stats["groups"]
    assert stats["requests"] == 3 and stats["lanes"] == 24
    assert stats["dispatches"] >= 6 and stats["dispatches"] >= \
        stats["groups"]
    got = observability.session("phoonnx-batcher")["spans"]
    dispatch = got["batcher.dispatch"]
    assert dispatch["count"] == stats["dispatches"]
    assert got["batcher.group"]["count"] == stats["groups"]
    assert got["batcher.reassemble"]["count"] == stats["groups"]
    up = engine.hp.total_upsample
    real = sum(len(a) // up for a in audio)
    assert dispatch["args"]["frames_real"] == real == stats["frames_real"]
    assert real <= dispatch["args"]["frames_decoded"] == \
        stats["frames_decoded"]
    # a dispatch's audio is its lanes at the frame bucket, pad included
    assert dispatch["args"]["samples_decoded"] == stats["samples_decoded"] \
        == up * stats["frames_decoded"]
    for key in ("lanes", "pad_lanes"):
        assert dispatch["args"][key] == stats[key]
    for name in ("engine.inputs", "engine.phase1", "engine.frames",
                 "engine.prior", "engine.phase2", "engine.fetch"):
        assert got[name]["count"] == stats["dispatches"], name
    # the decoding span names the decoder (its bands summed over the spans)
    assert got["engine.phase2"]["args"] == {"bands": stats["dispatches"]}
    decoders = {args["decoder"] for _, _, name, _, _, args in
                observability._RECORDER.spans() if name == "engine.phase2"}
    assert decoders == {"hifigan"}
    queue = observability.session()["spans"]["batcher.queue"]
    assert queue["count"] == 3 and "batcher.queue" not in got


def test_train_step_spans_its_four_phases(recorder):
    hp = VitsHParams.preset("micro", n_vocab=24)
    cfg = step.TrainConfig(disc_periods=(2, 3), disc_channel_scale=4)
    state = step.init_train_state(hp, cfg, torch.Generator().manual_seed(1))
    rng = np.random.default_rng(0)
    t_x, t_y = 10, 40
    batch = {"phoneme_ids": rng.integers(1, 24, (2, t_x)).astype(np.int32),
             "phoneme_lengths": np.asarray([10, 7], np.int32),
             "spec": (0.3 * np.abs(rng.standard_normal(
                 (2, t_y, hp.spec_channels)))).astype(np.float32),
             "spec_lengths": np.asarray([40, 33], np.int32),
             "audio": (0.3 * rng.standard_normal(
                 (2, t_y * hp.hop_length))).astype(np.float32)}
    with tracing():
        step.train_step(state, step.batch_to_device(batch, "cpu"), hp, cfg,
                        generator=torch.Generator().manual_seed(2))
    got = observability.session()["spans"]
    assert got["train.step"]["count"] == 1
    assert got["train.step"]["args"] == {"rows": 2, "frames": 2 * t_y}
    parents = {name: parent for *_, name, _, parent, _ in recorder.spans()}
    for name in TRAIN_PHASES:
        assert got[name]["count"] == 1
        assert parents[name] == "train.step"
    assert got["train.disc_backward"]["count"] == 1
    assert parents["train.disc_backward"] == "train.disc"
    children = sum(got[name]["wall_ms"] for name in TRAIN_PHASES)
    assert got["train.step"]["self_wall_ms"] == pytest.approx(
        got["train.step"]["wall_ms"] - children, abs=1e-6)


def load_metric(name: str):
    """A per-layer metric's reader, loaded by path as the benchmark's
    runner loads it."""
    path = ROOT / "benchmark" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "bench_metric_" + name.replace(".", "_"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def a_traced_window() -> None:
    """A dispatcher's and a training step's spans, at their names."""
    def dispatcher():
        with observability.span("batcher.group"):
            with observability.span("batcher.dispatch") as d:
                with observability.span("engine.prior"):
                    busy(0.002)
                with observability.span("engine.fetch"):
                    time.sleep(0.002)
                d.set(frames_real=30, frames_decoded=40)
            with observability.span("batcher.reassemble"):
                time.sleep(0.001)

    with tracing():
        stamp = observability.stamp()
        thread = threading.Thread(target=dispatcher, name="phoonnx-batcher")
        thread.start()
        thread.join(timeout=30)
        observability.record("batcher.queue", stamp, request_id=0,
                             group_id=0)
        with observability.span("train.step"):
            with observability.span("train.gen_forward"):
                busy(0.002)
            with observability.span("train.gen_backward"):
                time.sleep(0.002)
            with observability.span("train.update"):
                time.sleep(0.001)


METRICS = {"queue_ms.thru": (0, None), "reassemble_ms.thru": (1, None),
           "frame_fill.thru": (75, 75), "prior_ms.thru": (2, None),
           "offcpu_share.thru": (0, 100), "step_host_ms.train": (3, None),
           "offcpu_share.train": (0, 100)}


@pytest.mark.parametrize("name", sorted(METRICS))
def test_benchmark_metric_reads_the_session(recorder, name):
    read = load_metric(name)
    assert read(None) is None  # nothing recorded yet
    a_traced_window()
    value = read(None)
    low, high = METRICS[name]
    assert isinstance(value, float) and value >= low
    assert high is None or value <= high


@pytest.mark.parametrize("name, waits", [
    ("offcpu_share.thru", ("engine.frames", "engine.fetch")),
    ("offcpu_share.train", ("train.gen_backward", "train.disc_backward"))])
def test_offcpu_share_leaves_out_the_waits(recorder, name, waits):
    """An off-CPU share sums its thread's spans but for the waits it names:
    the card's in serving, autograd's thread's in training."""
    a_traced_window()
    prefix = "train." if name.endswith(".train") else ""
    thread = None if prefix else "phoonnx-batcher"
    spans = {k: s for k, s in observability.session(thread)["spans"].items()
             if k.startswith(prefix)}
    assert set(waits) & set(spans)  # the window has a wait to leave out
    kept = [s for k, s in spans.items() if k not in waits]
    wall = sum(s["self_wall_ms"] for s in kept)
    cpu = sum(s["self_cpu_ms"] for s in kept)
    assert load_metric(name)(None) == pytest.approx(100 * (1 - cpu / wall))
