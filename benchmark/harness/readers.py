"""What the per-layer metrics' readers share (``metrics/<name>.py``).

Each returns None where the run has nothing to read, and the harness then
leaves the metric out of the result line.
"""

import statistics
from typing import Optional

from harness import flops
from harness import peaks as peaks_mod


def mean_of(reading, key: str) -> Optional[float]:
    values = reading.counters.get(key)
    return statistics.fmean(values) if values else None


def idle_share(reading) -> Optional[float]:
    """Per cent of the traced window in which no operation ran on the
    card."""
    tl = reading.timeline
    share = tl.idle_share if tl is not None else None
    return None if share is None else 100.0 * share


def mfu_serve(reading) -> Optional[float]:
    """Model FLOPs of the requests answered in the traced window over the
    window times the peak, per cent."""
    reqs = reading.counters.get("requests")
    if not reqs or reading.peaks is None:
        return None
    cfg = reading.cell.config
    total = sum(flops.infer(cfg, n_ids, frames) for n_ids, frames in reqs)
    peak = peaks_mod.flops_peak(reading.peaks, cfg["dtype"])
    return 100.0 * total / (reading.seconds * peak)


def roofline(reading, kernel: str, work) -> Optional[float]:
    """The least time of a kernel's work in the window (operations over
    the peak or bytes over the bandwidth, the larger) over the device time
    of the kernels that implement it, per cent. ``work(cfg, frames)`` ->
    (flops, activation bytes); the weights count once a dispatch."""
    reqs = reading.counters.get("requests")
    tl = reading.timeline
    if not reqs or tl is None or reading.peaks is None:
        return None
    spent = tl.seconds_of(reading.kernel_patterns(kernel))
    if spent <= 0:
        return None
    cfg = reading.cell.config
    fl = nb = 0.0
    for _, frames in reqs:
        f, b = work(cfg, frames)
        fl += f
        nb += b
    nb += reading.counters["dispatches"] * work(cfg, None)[1]
    least = flops.least_seconds(
        fl, nb, peaks_mod.flops_peak(reading.peaks, cfg["dtype"]),
        reading.peaks["bytes"])
    return 100.0 * least / spent


def flow_work(cfg, frames):
    if frames is None:
        return 0.0, flops.flow_weight_bytes(cfg)
    return flops.flow(cfg, frames), flops.flow_bytes(cfg, frames)


def stage_work(cfg, frames):
    if frames is None:
        return 0.0, flops.stage_group_weight_bytes(cfg)
    return flops.stage_group(cfg, frames), flops.stage_group_bytes(cfg,
                                                                   frames)


def mfu_train(reading) -> Optional[float]:
    """Model FLOPs of every step completed in the traced window, summed
    over its rows at their true lengths, over the window times the peak,
    per cent."""
    rows = reading.counters.get("rows")
    if not rows or reading.peaks is None:
        return None
    cfg = reading.cell.config
    periods = reading.counters["disc_periods"]
    total = sum(flops.train_step(cfg, n_ids, frames, periods)
                for n_ids, frames in rows)
    peak = peaks_mod.flops_peak(reading.peaks, cfg["dtype"])
    return 100.0 * total / (reading.counters["window_s"] * peak)
