"""Observability: synthesis timers, RTF stats, profiler hooks.

PyTorch port of ``phoonnx_tpu/observability.py``. ``SynthesisStats`` and
``timed`` are copies of the JAX package's (they use no JAX;
``tests/test_torch_host_copies.py`` keeps them from drifting).
``device_trace`` wraps ``torch.profiler`` (CPU and CUDA activity) in
place of ``jax.profiler``, and ``device_memory_stats`` reads the caching
allocator's ``torch.cuda.memory_stats``.

``enable_compilation_cache`` has no counterpart: the port compiles no XLA
programs. Its CUDA graphs are captured anew in every process (at a key's
first call, or by ``VitsEngine.warmup``), and the kernels' nvcc builds
already persist in ``build/phoonnx_tpu_torch/<hash>/``.
"""

import contextlib
import logging
import math
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Deque, Dict, Iterator

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


@contextlib.contextmanager
def timed(stats: SynthesisStats, audio_seconds_fn) -> Iterator[None]:
    """Time a synthesis call; audio_seconds_fn() -> seconds produced."""
    start = time.perf_counter()
    yield
    stats.record(time.perf_counter() - start, float(audio_seconds_fn()))


@contextlib.contextmanager
def device_trace(log_dir: str = "phoonnx_tpu_torch_trace") -> Iterator[None]:
    """torch.profiler trace (CPU and CUDA activity) around a block, written
    to ``log_dir`` as a Chrome trace (view with Perfetto or
    chrome://tracing)."""
    import os

    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        try:
            yield
        finally:
            if torch.cuda.is_available():
                torch.cuda.synchronize()
    path = os.path.join(log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json")
    prof.export_chrome_trace(path)
    LOG.info("device trace written to %s", path)


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
