"""The device's timeline over the measured window, from ``torch.profiler``.

:class:`Tracer` profiles the CPU and the card around a run's window and
marks the window itself with a ``bench.window`` range. :meth:`Tracer.read`
turns the profile into a :class:`Timeline`: the device's operations
clipped to the window, their union (busy time), the idle gaps between
them, each labelled with the innermost ``bench.*`` host span that was open
at the gap's middle (what the host was doing while the card waited), and
the operations' time by name.
"""

import contextlib
import re
import time
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional, Tuple

import torch

WINDOW = "bench.window"


def _start_end_us(ev) -> Tuple[float, float]:
    if hasattr(ev, "start_ns"):
        start = ev.start_ns() / 1e3
        return start, start + ev.duration_ns() / 1e3
    start = ev.start_us()
    return start, start + ev.duration_us()


def _union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[List[float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


@dataclass
class Timeline:
    window_s: float
    busy_s: float
    ops: Dict[str, float] = field(default_factory=dict)  # name -> seconds
    gaps: Dict[str, float] = field(default_factory=dict)  # label -> seconds

    @property
    def idle_share(self) -> Optional[float]:
        if self.window_s <= 0 or self.busy_s <= 0:
            return None
        return 1.0 - self.busy_s / self.window_s

    def seconds_of(self, patterns: Iterable[str]) -> float:
        """Device seconds of the operations whose names match a pattern."""
        regs = [re.compile(p) for p in patterns]
        return sum(s for name, s in self.ops.items()
                   if any(r.search(name) for r in regs))

    def breakdown(self, top: int = 10) -> dict:
        def head(d):
            return [[k, v] for k, v in sorted(d.items(),
                                              key=lambda kv: -kv[1])[:top]]
        return {"device_ops": head(self.ops), "idle_gaps": head(self.gaps)}


class Tracer:
    """``torch.profiler`` over the CPU and, where there is one, the card."""

    def __init__(self, device: torch.device):
        acts = [torch.profiler.ProfilerActivity.CPU]
        if device.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        self.prof = torch.profiler.profile(activities=acts)

    def start(self) -> None:
        self.prof.__enter__()

    def stop(self) -> None:
        self.prof.__exit__(None, None, None)

    @contextlib.contextmanager
    def window(self):
        with torch.profiler.record_function(WINDOW):
            self.anchor = time.monotonic()
            yield

    def read(self, host_spans=()) -> Timeline:
        """``host_spans``: ``(start, end, name)`` on ``time.monotonic()``."""
        events = list(self.prof.profiler.kineto_results.events())
        cpu = torch.autograd.DeviceType.CPU
        host_names = {ev.name() for ev in events if ev.device_type() == cpu}
        device = []
        lo = hi = None
        for ev in events:
            if ev.device_type() == cpu:
                if ev.name() == WINDOW:
                    lo, hi = _start_end_us(ev)
            elif ev.name() not in host_names:
                # operations only, not the host ranges (record_function, an
                # optimizer's step) that the profiler mirrors onto the
                # device's timeline under the same name
                device.append((_start_end_us(ev), ev.name()))
        if lo is None:
            return Timeline(0.0, 0.0)
        spans = [(((a - self.anchor) * 1e6 + lo, (b - self.anchor) * 1e6 + lo),
                  name) for a, b, name in host_spans]
        ops: Dict[str, float] = {}
        clipped = []
        for (a, b), name in device:
            a, b = max(a, lo), min(b, hi)
            if b > a:
                clipped.append((a, b))
                ops[name] = ops.get(name, 0.0) + (b - a) / 1e6
        busy = _union(clipped)
        gaps: Dict[str, float] = {}
        edges = [lo] + [x for iv in busy for x in iv] + [hi]
        # sweep the gaps' middles through the spans' opening and closing
        marks = sorted([(s, 1, i) for i, ((s, _), _) in enumerate(spans)]
                       + [(e, 0, i) for i, ((_, e), _) in enumerate(spans)])
        active, k = set(), 0
        for a, b in zip(edges[0::2], edges[1::2]):
            if b <= a:
                continue
            mid = (a + b) / 2
            while k < len(marks) and marks[k][0] <= mid:
                _, opens, i = marks[k]
                (active.add if opens else active.discard)(i)
                k += 1
            label = (min((spans[i][0][1] - spans[i][0][0], spans[i][1])
                         for i in active)[1] if active else "no host span open")
            gaps[label] = gaps.get(label, 0.0) + (b - a) / 1e6
        return Timeline((hi - lo) / 1e6,
                        sum(b - a for a, b in busy) / 1e6, ops, gaps)
