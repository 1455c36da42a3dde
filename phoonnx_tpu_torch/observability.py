"""Observability: the port's spans and counters, synthesis stats, the
device trace and the device's memory.

PyTorch port of ``phoonnx_tpu/observability.py``. ``SynthesisStats`` is a
copy of the JAX package's (it uses no JAX;
``tests/test_torch_host_copies.py`` keeps it from drifting).
``device_trace`` wraps ``torch.profiler`` (CPU and CUDA activity) in
place of ``jax.profiler``, and ``device_memory_stats`` reads the caching
allocator's ``torch.cuda.memory_stats``.

Spans and counters (the port's own; the JAX package has none).
:func:`span` times a block at a layer boundary and :func:`count` adds to a
counter. Both are on exactly while a ``torch.profiler`` trace is open in
the process, whoever opened it: they read the profiler's module-level
flag, which every thread sees (the profiler's own per-thread state reads
off on threads it did not start from, so the dispatcher's spans could not
be ``record_function`` ranges). Off, a span costs that one read and
returns a shared no-op context: no clock is read and nothing is kept. On,
a span keeps its name, its start and end on ``time.monotonic_ns()``, its
thread's CPU time over it (``time.thread_time_ns()``), its thread's name,
its parent (the innermost span open on that thread) and its ``args``.

A session is what was recorded from the first span begun while a trace
was open, after one was seen closed, to the next such span: a span that
ends, a reader that reads, or :func:`device_trace` opening, with the
trace closed, ends it. A span is kept only if the trace was open at both
its ends (one open across the trace's close would hold the profiler's
stop, seconds of it). Its aggregates (:func:`session`) are exact; its
spans (:func:`session_spans`, :func:`device_trace`'s rows) are the last
``SPAN_BUFFER``. Self time is a span's time less the part its children
cover. Numeric args are summed, but for identifiers (keys ending in
``_id``), which tie the spans of one request together: a request's
``batcher.queue`` span carries its ``request_id`` and the ``group_id`` of
the group that served it.

The spans, at the layer boundaries only (``PERF.md`` §3 names the metric
each serves): ``batcher.queue`` (a request from ``submit`` to the start of
its group, on the submitting thread's row), ``batcher.group``,
``batcher.dispatch`` (its ``lanes``, ``pad_lanes``, ``frames_real``,
``frames_decoded`` and ``samples_decoded``), ``batcher.reassemble``
(``serve.py``); ``engine.inputs``, ``engine.phase1``, ``engine.frames``,
``engine.prior``, ``engine.phase2`` (``engine.fused`` in fused mode; both
carry the ``decoder`` family and its ``bands``), ``engine.fetch``
(``infer/engine.py``); ``graphs.capture`` (``infer/graphs.py``);
``train.step`` and its ``train.gen_forward``, ``train.gen_backward``,
``train.disc`` (its backward ``train.disc_backward``) and
``train.update`` (``train/step.py``).

``enable_compilation_cache`` has no counterpart: the port compiles no XLA
programs. Its CUDA graphs are captured anew in every process (at a key's
first call, or by ``VitsEngine.warmup``), and the kernels' nvcc builds
already persist in ``build/phoonnx_tpu_torch/<hash>/``.
"""

import contextlib
import json
import logging
import math
import os
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Deque, Dict, Iterator, List, Optional, Tuple

from torch.autograd import profiler as _torch_profiler

LOG = logging.getLogger(__name__)


# Percentile window: long-lived servers record every synthesis, so the
# history must be bounded (unbounded lists grow forever and summary()
# re-sorts the full history per /stats poll). Totals/RTF stay EXACT
# over the whole lifetime via running sums; percentiles cover the
# window.
STATS_WINDOW = 8192


@dataclass
class SynthesisStats:
    """Aggregated synthesis timing: exact lifetime totals + windowed
    percentiles (last ``STATS_WINDOW`` calls)."""

    latencies_s: Deque[float] = field(
        default_factory=lambda: deque(maxlen=STATS_WINDOW))
    audio_seconds: Deque[float] = field(
        default_factory=lambda: deque(maxlen=STATS_WINDOW))
    total_calls: int = 0
    total_latency_s: float = 0.0
    total_audio_s: float = 0.0

    def record(self, latency_s: float, audio_s: float) -> None:
        self.latencies_s.append(latency_s)
        self.audio_seconds.append(audio_s)
        self.total_calls += 1
        self.total_latency_s += latency_s
        self.total_audio_s += audio_s

    def _percentile(self, values, q: float) -> float:
        """Nearest-rank percentile: smallest value with at least q of the
        sample at or below it (int(q*n) is one rank too high whenever
        q*n lands on an integer — p90 of 10 samples must be the 9th
        value, not the maximum)."""
        if not values:
            return 0.0
        ordered = sorted(values)
        rank = max(math.ceil(q * len(ordered)), 1)
        return ordered[min(rank - 1, len(ordered) - 1)]

    @property
    def rtf(self) -> float:
        if self.total_audio_s <= 0:
            return 0.0
        return self.total_latency_s / self.total_audio_s

    def summary(self) -> Dict[str, float]:
        return {
            "count": self.total_calls,
            "rtf": round(self.rtf, 6),
            "audio_sec_per_sec": round(1.0 / self.rtf, 2) if self.rtf else 0.0,
            "p50_latency_ms": round(
                self._percentile(self.latencies_s, 0.50) * 1000, 2),
            "p90_latency_ms": round(
                self._percentile(self.latencies_s, 0.90) * 1000, 2),
            "p99_latency_ms": round(
                self._percentile(self.latencies_s, 0.99) * 1000, 2),
            "total_audio_s": round(self.total_audio_s, 2),
        }


# spans kept for session_spans() and device_trace's rows; the aggregates
# are exact whatever the count
SPAN_BUFFER = 1 << 17

# the record_function range that marks device_trace's opening: the
# program's spans are placed on the trace by the monotonic clock read in
# it, in the shortest of ANCHORS such ranges in a row
ANCHOR = "phoonnx.trace_anchor"
ANCHORS = 4


def _tracing() -> bool:
    return _torch_profiler._is_profiler_enabled


class _Off:
    """The shared no-op span of tracing off."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        return False

    def set(self, **args) -> None:
        pass


_OFF = _Off()


class _Span:
    __slots__ = ("rec", "name", "args", "parent", "session", "start", "cpu",
                 "child_wall", "child_cpu")

    def __init__(self, rec: "_Recorder", name: str, args: Dict[str, Any]):
        self.rec, self.name, self.args = rec, name, args

    def set(self, **args) -> None:
        """Add args known only inside the block."""
        self.args.update(args)

    def __enter__(self):
        self.rec.open(self)
        # the CPU clock's interval inside the wall clock's
        self.start = time.monotonic_ns()
        self.cpu = time.thread_time_ns()
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        cpu = time.thread_time_ns() - self.cpu
        self.rec.close(self, time.monotonic_ns(), cpu)
        return False


class _Stack(threading.local):
    def __init__(self):
        self.spans: List[_Span] = []


class _Recorder:
    """The process's spans and counters, by session."""

    def __init__(self, buffer: int = SPAN_BUFFER):
        self._lock = threading.Lock()
        self._stack = _Stack()
        self._ended = True  # no session open: the next span starts one
        self._session = 0
        self._aggs: Dict[Tuple[str, str], list] = {}
        self._counters: Dict[str, float] = {}
        self._spans: Deque[tuple] = deque(maxlen=buffer)

    def _current(self) -> int:
        """The open session's number, a fresh one if the last has ended
        (under the lock)."""
        if self._ended:
            self._ended = False
            self._session += 1
            self._aggs, self._counters = {}, {}
            self._spans = deque(maxlen=self._spans.maxlen)
        return self._session

    def end_session(self) -> None:
        with self._lock:
            self._ended = True

    def open(self, span: _Span) -> None:
        stack = self._stack.spans
        span.parent = stack[-1] if stack else None
        span.child_wall = span.child_cpu = 0
        with self._lock:
            span.session = self._current()
        stack.append(span)

    def close(self, span: _Span, end: int, cpu: int) -> None:
        self._stack.spans.remove(span)
        wall = end - span.start
        parent = span.parent
        if parent is not None:
            parent.child_wall += wall
            parent.child_cpu += cpu
        self._add(span.session, threading.current_thread().name, span.name,
                  span.start, end, wall, wall - span.child_wall, cpu,
                  cpu - span.child_cpu, span.args,
                  None if parent is None else parent.name)

    def _add(self, session, thread, name, start, end, wall, self_wall, cpu,
             self_cpu, args, parent) -> None:
        with self._lock:
            if not _tracing():
                # the trace closed while this span was open, and the span
                # holds the profiler's stop (seconds of its processing)
                self._ended = True
                return
            if session != self._session:
                return  # begun in a session that has ended
            agg = self._aggs.get((thread, name))
            if agg is None:
                agg = self._aggs[(thread, name)] = [0, 0, 0, 0, 0, {}]
            agg[0] += 1
            agg[1] += wall
            agg[2] += self_wall
            agg[3] += cpu
            agg[4] += self_cpu
            sums = agg[5]
            for k, v in args.items():
                if (isinstance(v, (int, float)) and not isinstance(v, bool)
                        and not k.endswith("_id")):
                    sums[k] = sums.get(k, 0) + v
            self._spans.append((start, end, name, thread, parent, args))

    def stamp(self) -> tuple:
        with self._lock:
            session = self._current()
        return time.monotonic_ns(), threading.current_thread().name, session

    def record(self, name: str, stamp: tuple, args: Dict[str, Any]) -> None:
        start, thread, session = stamp
        end = time.monotonic_ns()
        self._add(session, thread, name, start, end, end - start,
                  end - start, 0, 0, args, None)

    def count(self, name: str, n: float) -> None:
        with self._lock:
            self._current()
            self._counters[name] = self._counters.get(name, 0) + n

    def _reading(self) -> None:
        """A read with the trace closed ends the session (under the
        lock)."""
        if not _tracing():
            self._ended = True

    def session(self, thread: Optional[str] = None) -> Dict[str, Any]:
        with self._lock:
            self._reading()
            aggs = [(name, list(a[:5]), dict(a[5]))
                    for (thr, name), a in self._aggs.items()
                    if thread is None or thr == thread]
            counters = dict(self._counters)
        spans: Dict[str, Dict[str, Any]] = {}
        for name, nums, sums in aggs:
            out = spans.setdefault(name, {"count": 0, "wall_ms": 0.0,
                                          "self_wall_ms": 0.0, "cpu_ms": 0.0,
                                          "self_cpu_ms": 0.0, "args": {}})
            out["count"] += nums[0]
            for key, ns in zip(("wall_ms", "self_wall_ms", "cpu_ms",
                                "self_cpu_ms"), nums[1:]):
                out[key] += ns / 1e6
            for k, v in sums.items():
                out["args"][k] = out["args"].get(k, 0) + v
        return {"spans": spans, "counters": counters}

    def spans(self, thread: Optional[str] = None) -> List[tuple]:
        """The session's kept spans: (start_ns, end_ns, name, thread,
        parent, args)."""
        with self._lock:
            self._reading()
            return [s for s in self._spans
                    if thread is None or s[3] == thread]


_RECORDER = _Recorder()


def span(name: str, **args):
    """A context manager timing its block as ``name`` while a
    ``torch.profiler`` trace is open (the module docstring); ``args`` are
    kept with it, and ``.set(**args)`` on the value it gives adds more."""
    if not _torch_profiler._is_profiler_enabled:
        return _OFF
    return _Span(_RECORDER, name, args)


def count(name: str, n: float = 1) -> None:
    """Add ``n`` to the session's counter ``name`` while a trace is
    open."""
    if _torch_profiler._is_profiler_enabled:
        _RECORDER.count(name, n)


def stamp() -> Optional[tuple]:
    """The start of a span that another thread ends (:func:`record`), or
    None while no trace is open."""
    if not _torch_profiler._is_profiler_enabled:
        return None
    return _RECORDER.stamp()


def record(name: str, start: Optional[tuple], **args) -> None:
    """Keep the span ``name`` from ``start`` (a :func:`stamp`) to now, on
    the row of the thread that stamped it, with no CPU time: a wait that
    one thread begins and another ends (a request in the queue)."""
    if start is not None and _torch_profiler._is_profiler_enabled:
        _RECORDER.record(name, start, args)


def session(thread: Optional[str] = None) -> Dict[str, Any]:
    """The last session's aggregates, of the spans of threads named
    ``thread`` (all threads for None): ``{"spans": {name: {"count",
    "wall_ms", "self_wall_ms", "cpu_ms", "self_cpu_ms", "args": {key:
    sum}}}, "counters": {name: total}}``."""
    return _RECORDER.session(thread)


def session_spans(thread: Optional[str] = None
                  ) -> List[Tuple[float, float, str]]:
    """The last session's kept spans of threads named ``thread`` (all for
    None) as ``(start_s, end_s, name)`` on ``time.monotonic()``."""
    return [(a / 1e9, b / 1e9, name)
            for a, b, name, *_ in _RECORDER.spans(thread)]


def _span_rows(path: str, anchors_ns: List[int]) -> int:
    """Write the session's spans into the Chrome trace at ``path``, a row
    for each thread, placed by the end of the shortest ``ANCHOR`` range,
    the clock read just before it in ``anchors_ns`` (one a range, in
    order); the number of spans written. Of a range that ends long after
    its read (a process's first range takes up to milliseconds to leave,
    as to enter, and a thread may be preempted in it), the end is a worse
    mark, as the start is of one that is entered slowly: the shortest of
    the ranges misplaces the spans the least."""
    with open(path, encoding="utf-8") as f:
        trace = json.load(f)
    events = trace["traceEvents"]
    marks = sorted((e for e in events
                    if e.get("name") == ANCHOR and e.get("ph") == "X"),
                   key=lambda e: e["ts"])
    spans = _RECORDER.spans()
    if len(marks) != len(anchors_ns) or not spans:
        return 0
    mark, anchor_ns = min(zip(marks, anchors_ns),
                          key=lambda pair: pair[0]["dur"])
    shift_us = mark["ts"] + mark["dur"] - anchor_ns / 1e3
    pid = mark["pid"]
    rows: Dict[str, int] = {}
    for start, end, name, thread, parent, args in spans:
        if thread not in rows:
            # beyond any operating system's thread id
            tid = rows[thread] = (1 << 40) + len(rows)
            events.append({"ph": "M", "name": "thread_name", "pid": pid,
                           "tid": tid,
                           "args": {"name": f"phoonnx spans: {thread}"}})
        events.append({"ph": "X", "cat": "phoonnx", "name": name, "pid": pid,
                       "tid": rows[thread], "ts": start / 1e3 + shift_us,
                       "dur": (end - start) / 1e3,
                       "args": {**{k: v if isinstance(v, (int, float, str))
                                   else str(v) for k, v in args.items()},
                                "parent": parent}})
    with open(path, "w", encoding="utf-8") as f:
        json.dump(trace, f)
    return len(spans)


@contextlib.contextmanager
def device_trace(log_dir: str = "phoonnx_tpu_torch_trace") -> Iterator[None]:
    """torch.profiler trace (CPU and CUDA activity) around a block, written
    to ``log_dir`` as a Chrome trace (view with Perfetto or
    chrome://tracing), with the program's spans of the block as rows of
    their own on the same timeline."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        _RECORDER.end_session()  # the block's spans start a session
        anchors_ns = []
        for _ in range(ANCHORS):
            with record_function(ANCHOR):
                anchors_ns.append(time.monotonic_ns())
        try:
            yield
        finally:
            if torch.cuda.is_available():
                torch.cuda.synchronize()
    path = os.path.join(log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json")
    prof.export_chrome_trace(path)
    rows = _span_rows(path, anchors_ns)
    LOG.info("device trace written to %s (%d program spans)", path, rows)


def device_memory_stats() -> Dict[str, Dict[str, float]]:
    """Per-device memory of the caching allocator in MB (empty without a
    CUDA device): bytes in use, their peak, and the device's total, for
    the trainer's log line and the server's /stats route."""
    import torch

    out: Dict[str, Dict[str, float]] = {}
    if not torch.cuda.is_available():
        return out
    mb = 1024 * 1024
    for index in range(torch.cuda.device_count()):
        stats = torch.cuda.memory_stats(index)
        out[str(index)] = {
            "bytes_in_use_mb": round(
                stats.get("allocated_bytes.all.current", 0) / mb, 1),
            "peak_bytes_in_use_mb": round(
                stats.get("allocated_bytes.all.peak", 0) / mb, 1),
            "bytes_limit_mb": round(
                torch.cuda.get_device_properties(index).total_memory / mb,
                1),
        }
    return out
