"""The serving cells of a multi-band iSTFT voice (MB-iSTFT-VITS): the voice
behind the program's ``TTSServer``, loaded by a client process over
localhost, as ``serve.py`` runs a HiFi-GAN voice.

What differs from ``serve.py`` is added here, and the rest is
``serve.py``'s own code: :func:`layout` (the HiFi-GAN layout with the
spectral heads in place of ``conv_post``), :func:`prepare` (the weights of
that layout), and the comparison (:func:`judge_sample`), whose check is
``reference/mb_istft.py``'s widest gap over the reference's peak,
``wav_gap_per_peak``. ``serve._measure`` reads ``compare.hop`` from its
module, so it runs here with ``mb_istft``, whose ``hop`` is the decoder's
true samples a frame, standing in for ``compare`` (:func:`_standing_in`):
the counters' frame counts are taken at the true hop before any reader
sees them.

The head's device time. The decoder's last kernel-C launch ends the
stages; every operation of a phase-2 replay after it is the head's
(leaky ReLU, the magnitude and phase convs, ``exp``, ``sin``, the inverse
DFT, the overlap-add and the PQMF bank). Names cannot tell the head's
transposed convs (overlap-add, PQMF) from the upsampling's, both cuDNN
``dgrad``, so the head is found by place (:func:`head_seconds`): a CUDA
graph replay's operations share the correlation id of its launch, a
replay that holds a kernel-C operation is a decoding one, and its
operations that start after the end of its last kernel-C operation are
the head's. Their seconds inside the window, and the device's busy
seconds there, go into the counters (``istft_head_s``, ``istft_busy_s``).
"""

import contextlib
import gc
import json
import re
from typing import Iterable, List, Optional, Tuple

import torch

from harness import serve
from harness import traffic as tr
from harness import weights
from harness.runner import BENCH
from harness.trace import WINDOW, Tracer, _start_end_us, _union
from reference import frontend, mb_istft
from reference import vits as ref

# a device operation: (start_us, end_us, name, correlation id)
Op = Tuple[float, float, str, int]


def layout(cfg: dict, vits_init: bool = False) -> List[weights.Leaf]:
    """Every generator tensor of a single-speaker iSTFT VITS voice:
    ``weights.layout``'s, with ``dec.conv_post`` replaced by the heads
    ``dec.conv_mag`` and ``dec.conv_phase``, each ``bands * (n_fft / 2 +
    1)`` channels over the last stage's, kernel 7. The heads' weights are
    at ``init.head_std`` / sqrt(fan-in) and the magnitude head's bias has
    the mean ``init.mag_bias``: they set the voice's loudness, as
    ``init.decoder_weight_v_std`` does the stages'."""
    out = [leaf for leaf in weights.layout(cfg, vits_init)
           if not leaf[0].startswith("dec.conv_post")]
    ch = cfg["upsample_initial_channel"] >> len(cfg["upsample_rates"])
    bins = cfg["istft_bands"] * (cfg["istft_n_fft"] // 2 + 1)
    init = cfg["init"]
    share = 1.0 if vits_init else init["head_std"]
    for head in ("mag", "phase"):
        weights._conv(out, f"dec.conv_{head}", bins, ch, 7, share=share)
    if not vits_init:
        name, shape, _, std = out[-3]  # dec.conv_mag.bias
        out[-3] = (name, shape, init["mag_bias"], std)
    return out


def prepare(cell, seed: int, device, log):
    """``serve.prepare`` for this layout: the seed's weights (the
    reference's view of them), texts, ids, length scale and bodies."""
    cfg, mix = cell.config, cell.traffic
    w = ref.Weights(weights.make(layout(cfg), seed, device))
    texts = tr.lj_texts(mix, seed)
    imap = serve.id_map(cfg)
    ids = [frontend.text_to_ids(t, imap) for t in texts]
    scale = serve.length_scale(w, cfg, ids[:mix["calibration_texts"]],
                               mix["mean_duration"])
    log(f"length_scale {scale!r}: the reference's durations average "
        f"{mix['mean_duration']} frames before ceil over "
        f"{mix['calibration_texts']} texts")
    bodies = [{"text": t, "noise_scale": 0.0, "noise_w": 0.0,
               "length_scale": scale} for t in texts]
    return w, ids, scale, bodies


# -- the head's device time --------------------------------------------------


def device_ops(events) -> Tuple[Optional[Tuple[float, float]], List[Op]]:
    """The traced window (its ``bench.window`` range, in µs) and the
    device's operations among the profiler's events, as ``Tracer.read``
    tells them from the host's ranges."""
    cpu = torch.autograd.DeviceType.CPU
    host_names = {ev.name() for ev in events if ev.device_type() == cpu}
    window, ops = None, []
    for ev in events:
        if ev.device_type() == cpu:
            if ev.name() == WINDOW:
                window = _start_end_us(ev)
        elif ev.name() not in host_names:
            a, b = _start_end_us(ev)
            ops.append((a, b, ev.name(), ev.correlation_id()))
    return window, ops


def head_seconds(ops: Iterable[Op], c_patterns: Iterable[str],
                 window: Tuple[float, float]) -> Tuple[float, int]:
    """(seconds of the head's operations inside ``window``, decoding
    replays found): the operations of each correlation id that holds a
    kernel-C operation (a name matching ``c_patterns``) and that start at
    or after the end of its last one. A decoding replay is such an id
    with a head; id 0 (none recorded) is none."""
    regs = [re.compile(p) for p in c_patterns]
    replays = {}
    for op in ops:
        if op[3]:
            replays.setdefault(op[3], []).append(op)
    lo, hi = window
    seconds, found = 0.0, 0
    for group in replays.values():
        c_ends = [b for _, b, name, _ in group
                  if any(r.search(name) for r in regs)]
        if not c_ends:
            continue
        last = max(c_ends)
        head = [(a, b) for a, b, _, _ in group if a >= last]
        found += bool(head)
        seconds += sum(max(0.0, min(b, hi) - max(a, lo))
                       for a, b in head) / 1e6
    return seconds, found


def busy_seconds(ops: Iterable[Op], window: Tuple[float, float]) -> float:
    """The union of the operations inside ``window``, seconds
    (``Tracer.read``'s busy time)."""
    lo, hi = window
    clipped = [(max(a, lo), min(b, hi)) for a, b, _, _ in ops]
    return sum(b - a for a, b in _union([c for c in clipped
                                         if c[1] > c[0]])) / 1e6


class HeadTracer(Tracer):
    """``Tracer``, and the head's seconds of the window it read
    (``head``: (head seconds, busy seconds, decoding replays), or None
    without a window or a decoding replay); ``c_patterns`` name kernel
    C's operations."""

    def __init__(self, device, c_patterns: List[str]):
        super().__init__(device)
        self.c_patterns = c_patterns
        self.head = None

    def read(self, host_spans=()):
        timeline = super().read(host_spans)
        window, ops = device_ops(
            list(self.prof.profiler.kineto_results.events()))
        if window is not None:
            head, found = head_seconds(ops, self.c_patterns, window)
            if found:
                self.head = (head, busy_seconds(ops, window), found)
        return timeline


@contextlib.contextmanager
def _standing_in(tracers: list, c_patterns: List[str]):
    """``serve``'s module globals ``compare`` and ``Tracer`` replaced by
    ``mb_istft`` and a :class:`HeadTracer` (each kept in ``tracers``),
    restored after."""
    def tracer(device):
        tracers.append(HeadTracer(device, c_patterns))
        return tracers[-1]

    saved = serve.compare, serve.Tracer
    serve.compare, serve.Tracer = mb_istft, tracer
    try:
        yield
    finally:
        serve.compare, serve.Tracer = saved


def run(bench, seed: int, seconds: float, trace: bool, device, t0: float,
        log) -> dict:
    """``serve.run`` for this voice: its weights, ``serve.py``'s program,
    warm-up and window (the head's seconds read from the trace), then
    :func:`judge_sample`."""
    cfg, mix = bench.config, bench.traffic
    c_patterns = [p for f in sorted((BENCH / "kernels" / "C").glob("*.json"))
                  for p in json.loads(f.read_text())["patterns"]]
    w, ids, scale, bodies = prepare(bench, seed, device, log)
    prog = serve.Program(cfg, w.flat, device)
    loads: List[serve.Load] = []
    tracers: List[HeadTracer] = []
    try:
        serve.warm(prog, mix, ids, scale, bodies, seed, log, loads)
        with _standing_in(tracers, c_patterns):
            out, kept, records = serve._measure(
                prog, cfg, mix, ids, bodies, seed, seconds, trace, device,
                t0, log, loads)
    finally:
        for load in loads:
            load.close()
        prog.close()
    # the program is freed before the reference runs on the card
    del prog
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    head = tracers[-1].head if tracers else None
    if head is not None:
        out["counters"]["istft_head_s"] = head[0]
        out["counters"]["istft_busy_s"] = head[1]
        log(f"the head: {head[0]!r} s of {head[1]!r} busy s in {head[2]} "
            "decoding replays")
    elif trace:
        log("the head: no decoding replay found in the trace")
    out["checks"] = judge_sample(w, cfg, ids, scale, kept, mix, records,
                                 log)
    return out


def judge_sample(w, cfg, ids, scale, kept, mix, records, log) -> dict:
    """``serve.judge_sample`` with ``mb_istft.judge``: the sample's widest
    gap over the reference's peak, and the answers of a wrong length."""
    gaps, wrong, ties = [], 0, 0
    for idx, pcm in sorted(kept.items()):
        body = idx if mix["loop"] == "closed" else idx % len(ids)
        v = mb_istft.judge(w, cfg, ids[body], scale, pcm)
        ties += v.ties
        if v.frames_ok:
            gaps.append(v)
        else:
            wrong += 1
    log(f"judged {len(kept)} answers ({sum(len(p) for p in kept.values())} "
        f"samples) against the reference: gaps in 16-bit steps "
        f"{[v.gap_lsb for v in gaps]} at peaks "
        f"{[round(v.peak, 4) for v in gaps]}, {wrong} of a wrong length, "
        f"{ties} near ties")
    return {
        "wav_gap_per_peak": {
            "value": max((v.gap_per_peak for v in gaps), default=0.0),
            "limit": cfg["limits"]["wav_gap_per_peak"]},
        "wrong_length": {"value": wrong, "limit": 0},
        "answers_missing": {"value": mix["sample"]["requests"] - len(kept),
                            "limit": 0},
        "failed_requests": {"value": sum(1 for r in records if r[5] != 200),
                            "limit": 0},
    }


def control_readings(cell, seed: int, requests: int, device) -> dict:
    """``harness/control.py``'s readings for this voice: the reference
    with TF32 allowed in place of the program, its WAVs judged as a run
    judges the served ones, on a run's sample of requests."""
    cfg, mix = cell.config, cell.traffic
    w = ref.Weights(weights.make(layout(cfg), seed, device))
    texts = tr.lj_texts(mix, seed)
    ids = [frontend.text_to_ids(t, serve.id_map(cfg)) for t in texts]
    scale = serve.length_scale(w, cfg, ids[:mix["calibration_texts"]],
                               mix["mean_duration"])
    first = min(len(ids), mix["sample"].get("among_first", len(ids)))
    longest = max(range(first), key=lambda i: len(ids[i]))
    gaps, wrong = [], 0
    for i in tr.sample(first, requests, seed, longest):
        pcm = mb_istft.control_pcm(w, cfg, ids[i], scale)
        v = mb_istft.judge(w, cfg, ids[i], scale, pcm)
        if v.frames_ok:
            gaps.append(v)
        else:
            wrong += 1
    return {"seed": seed,
            "wav_gap_per_peak": max((v.gap_per_peak for v in gaps),
                                    default=None),
            "gaps_lsb": [v.gap_lsb for v in gaps],
            "peaks": [round(v.peak, 4) for v in gaps], "wrong_length": wrong}
