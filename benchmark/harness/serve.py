"""The serving cells: a voice behind the program's ``TTSServer``, loaded by
a client process over localhost.

Set-up: the weights on the card from the seed; the traffic's texts; the
length scale (from the reference's durations, so that the voice speaks the
mix's frames per id whatever the seed's weights); the voice through the
program's loading path (``params_from_flat`` -> ``VitsEngine`` ->
``TTSVoice``) behind ``TTSServer``; a warm-up of the cell's own shapes
(every text bucket's shortest and longest text at each lane count the
batcher pads to, then passes of the cell's traffic until one captures no
graph). Then the window, run by ``client.py``; then the comparison of a
sample of the window's answers with the reference.
"""

import base64
import dataclasses
import gc
import json
import math
import subprocess
import sys
import time
from pathlib import Path
from typing import Dict, List

import numpy as np
import torch

from harness import spans as spans_mod
from harness import traffic as tr
from harness import weights
from harness.trace import Tracer
from reference import compare, frontend
from reference import vits as ref

CLIENT = Path(__file__).with_name("client.py")
# the client process starts this long before the window opens
LEAD_S = 0.5
# answers are awaited this long after the window
DRAIN_S = 60.0


def id_map(cfg: dict) -> Dict[str, int]:
    out = {"_": 0, "^": 1, "$": 2, " ": 3}
    out.update({c: i + 4 for i, c in enumerate(cfg["voice"]["letters"])})
    return out


def voice_config(cfg: dict) -> dict:
    ids = id_map(cfg)
    return {"phoneme_type": cfg["voice"]["phoneme_type"],
            "lang_code": cfg["voice"]["lang_code"],
            "alphabet": cfg["voice"]["alphabet"],
            "phoneme_id_map": ids, "num_symbols": len(ids),
            "num_speakers": cfg["n_speakers"],
            "audio": {"sample_rate": cfg["sample_rate"]},
            "inference": {"noise_scale": 0.0, "length_scale": 1.0,
                          "noise_w": 0.0}}


def _tuples(v):
    return tuple(_tuples(x) for x in v) if isinstance(v, list) else v


def hparams(cfg: dict):
    from phoonnx_tpu_torch.models.vits.model import VitsHParams

    names = {f.name for f in dataclasses.fields(VitsHParams)}
    return VitsHParams(**{k: _tuples(v) for k, v in cfg.items()
                          if k in names})


def load_voice(cfg: dict, flat: Dict[str, torch.Tensor], device):
    """The voice through the program's loading path."""
    from phoonnx_tpu_torch.config import VoiceConfig
    from phoonnx_tpu_torch.infer.engine import VitsEngine
    from phoonnx_tpu_torch.models.vits.load import params_from_flat
    from phoonnx_tpu_torch.voice import TTSVoice

    hp = hparams(cfg)
    params = params_from_flat({k: v.cpu().numpy() for k, v in flat.items()},
                              hp, strict=False)
    engine = VitsEngine(params, hp, dtype=cfg["dtype"], device=device)
    return TTSVoice(engine=engine,
                    config=VoiceConfig.from_dict(voice_config(cfg)))


def length_scale(w: ref.Weights, cfg: dict, ids: List[List[int]],
                 mean_duration: float) -> float:
    """The scale at which the reference's durations average
    ``mean_duration`` frames before ``ceil`` over these utterances."""
    dev = w["enc_p.emb.weight"].device
    with torch.no_grad(), ref.precision(False):
        w_all = torch.cat([torch.exp(ref.log_w(w, cfg, i, dev))
                           for i in ids])
    return float(mean_duration / w_all.double().mean())


class Load:
    """One run of ``client.py``."""

    def __init__(self, server, mix: dict, bodies: List[dict], seconds: float,
                 seed: int, keep=()):
        self.job = {"host": server.address[0], "port": server.address[1],
                    "bodies": bodies, "seconds": seconds, "mode": mix["loop"],
                    "drain_s": DRAIN_S, "keep": list(keep)}
        if mix["loop"] == "closed":
            self.job["clients"] = mix["clients"]
        else:
            self.job["connections"] = mix["connections"]
            self.job["offsets"] = tr.poisson_offsets(mix["rate_per_s"],
                                                     seconds, seed)
        self.proc = subprocess.Popen(
            [sys.executable, str(CLIENT)], stdin=subprocess.PIPE,
            stdout=subprocess.PIPE, text=True)
        self.start = time.monotonic() + LEAD_S
        self.end = self.start + seconds
        self.job["start"] = self.start
        self.proc.stdin.write(json.dumps(self.job))
        self.proc.stdin.close()

    def wait_window(self) -> None:
        while time.monotonic() < self.end:
            time.sleep(min(0.05, max(0.0, self.end - time.monotonic())))

    def result(self):
        # the client ends on its own: it waits at most DRAIN_S past the
        # window for answers
        out = self.proc.stdout.read()
        self.proc.wait()
        if self.proc.returncode:
            raise RuntimeError(f"client exited {self.proc.returncode}")
        res = json.loads(out)
        kept = {int(k): np.frombuffer(base64.b64decode(v), np.int16)
                for k, v in res["kept"].items()}
        return res["records"], kept

    def close(self) -> None:
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait()


def _bucket(n: int, buckets) -> int:
    return next(b for b in buckets if n <= b)


def warm_grid(engine, ids: List[List[int]], scale: float,
              lanes: List[int]) -> None:
    """Each text bucket's shortest and longest utterance, alone in a batch
    of each lane count: every (lanes, text bucket, frame bucket) key that
    the batcher's length-sorted chunks reach."""
    groups: Dict[int, List[List[int]]] = {}
    for u in ids:
        groups.setdefault(_bucket(len(u), engine.text_buckets), []).append(u)
    for group in groups.values():
        group.sort(key=len)
        for u in {tuple(group[0]), tuple(group[-1])}:
            for n in lanes:
                engine.synthesize_batch([list(u)] * n, noise_scale=0.0,
                                        length_scale=scale, noise_w=0.0,
                                        seed=0)


class Program:
    """The system under test: the voice behind its server."""

    def __init__(self, cfg: dict, flat: Dict[str, torch.Tensor], device):
        from phoonnx_tpu_torch.serve import TTSServer

        self.voice = load_voice(cfg, flat, device)
        self.engine = self.voice.engine
        self.srv = TTSServer(self.voice, host="127.0.0.1", port=0,
                             max_batch=cfg["serve"]["max_batch"],
                             max_wait_ms=cfg["serve"]["max_wait_ms"])
        self.srv.start()

    def close(self) -> None:
        """Stop the server and drop every reference to the program."""
        if self.srv is not None:
            self.srv.stop()
        self.voice = self.engine = self.srv = None


def prepare(cell, seed: int, device, log):
    """The seed's weights (the reference's view of them), texts, ids,
    length scale and request bodies."""
    cfg, mix = cell.config, cell.traffic
    w = ref.Weights(weights.make(weights.layout(cfg), seed, device))
    texts = tr.lj_texts(mix, seed)
    imap = id_map(cfg)
    ids = [frontend.text_to_ids(t, imap) for t in texts]
    scale = length_scale(w, cfg, ids[:mix["calibration_texts"]],
                         mix["mean_duration"])
    log(f"length_scale {scale!r}: the reference's durations average "
        f"{mix['mean_duration']} frames before ceil over "
        f"{mix['calibration_texts']} texts")
    bodies = [{"text": t, "noise_scale": 0.0, "noise_w": 0.0,
               "length_scale": scale} for t in texts]
    return w, ids, scale, bodies


def warm(prog, mix: dict, ids, scale: float, bodies, seed: int, log,
         loads: List[Load]) -> None:
    """The cell's own shapes: the grid, then passes of its traffic until
    one captures no graph."""
    lanes = [1]
    while lanes[-1] < prog.srv.max_batch:
        lanes.append(lanes[-1] * 2)
    warm_grid(prog.engine, ids, scale, lanes)
    graphs = prog.engine.graphs
    for p in range(mix["warmup"]["max_passes"]):
        before = len(graphs.programs) if graphs else 0
        load = Load(prog.srv, mix, bodies, mix["warmup"]["pass_s"], seed + p)
        loads.append(load)
        load.wait_window()
        load.result()
        new = (len(graphs.programs) if graphs else 0) - before
        log(f"warm-up pass {p}: {new} graphs captured")
        if not new:
            break
    if prog.engine.device.type == "cuda":
        torch.cuda.synchronize(prog.engine.device)


def run(bench, seed: int, seconds: float, trace: bool, device, t0: float,
        log) -> dict:
    cfg, mix = bench.config, bench.traffic
    w, ids, scale, bodies = prepare(bench, seed, device, log)
    prog = Program(cfg, w.flat, device)
    loads: List[Load] = []
    try:
        warm(prog, mix, ids, scale, bodies, seed, log, loads)
        out, kept, records = _measure(prog, cfg, mix, ids, bodies, seed,
                                      seconds, trace, device, t0, log, loads)
    finally:
        for load in loads:
            load.close()
        prog.close()
    # the program is freed before the reference runs on the card
    del prog
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    out["checks"] = judge_sample(w, cfg, ids, scale, kept, mix, records, log)
    return out


def _measure(prog, cfg, mix, ids, bodies, seed, seconds, trace, device, t0,
             log, loads):
    spans = spans_mod.Spans()
    submitted: Dict[int, float] = {}
    queue_ms: List[float] = []
    engine, batcher = prog.engine, prog.srv.batcher
    if trace:
        submit = batcher.submit

        def timed_submit(*args, **kwargs):
            sub = submit(*args, **kwargs)
            if spans.on:
                submitted[id(sub)] = time.monotonic()
            return sub

        def group_start(group, *_):
            now = time.monotonic()
            for sub in group:
                t = submitted.pop(id(sub), None)
                if t is not None:
                    queue_ms.append((now - t) * 1e3)

        batcher.submit = timed_submit
        spans.wrap(batcher, "_synthesize_group", "group", before=group_start)
        for method, name in (("synthesize_batch", "synthesize_batch"),
                             ("_batch_inputs", "inputs"),
                             ("_prior", "prior_noise"), ("_run", "replay"),
                             ("_ready", "wait_device")):
            spans.wrap(engine, method, name)
    graphs = engine.graphs
    replays0 = dict(graphs.replays) if graphs else {}
    keys0 = set(graphs.programs) if graphs else set()

    if mix["loop"] == "closed":
        # among the first bodies of the cycle, which every run answers
        first = min(len(bodies), mix["sample"]["among_first"])
        longest = max(range(first), key=lambda i: len(ids[i]))
        keep = tr.sample(first, mix["sample"]["requests"], seed, longest)
    else:
        n_req = max(2, round(mix["rate_per_s"] * seconds))
        longest = max(range(n_req), key=lambda i: len(ids[i % len(ids)]))
        keep = tr.sample(n_req, mix["sample"]["requests"], seed, longest)

    tracer = Tracer(device) if trace else None
    if tracer:
        tracer.start()  # before the window's clock starts: it takes a while
    setup_s = time.perf_counter() - t0
    load = Load(prog.srv, mix, bodies, seconds, seed, keep=keep)
    loads.append(load)
    pause = load.start - time.monotonic()
    if pause > 0:
        time.sleep(pause)
    spans.on = True
    if tracer:
        with tracer.window():
            load.wait_window()
    else:
        load.wait_window()
    spans.on = False
    if tracer:
        tracer.stop()
    replays1 = dict(graphs.replays) if graphs else {}
    keys1 = set(graphs.programs) if graphs else set()
    records, kept = load.result()
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    timeline = tracer.read(spans.all()) if tracer else None
    spans.close()

    captured = sorted(keys1 - keys0, key=str)
    log(f"graphs captured in the window: {len(captured)} {captured}")
    start, end = load.start, load.end
    sr, hop = cfg["sample_rate"], compare.hop(cfg)
    ok = [r for r in records if r[5] == 200]
    done = [r for r in ok if start <= r[4] <= end]
    failed = len(records) - len(ok)
    out = {"attempted": len(records), "failed": failed, "setup_s": setup_s,
           "memory_peak_bytes": peak, "timeline": timeline}
    if mix["loop"] == "closed":
        out["audio_s_per_s"] = sum(r[6] for r in done) / sr / seconds
        slices = [sum(r[6] for r in done if k <= r[4] - start < k + 1) / sr
                  for k in range(int(seconds))]
        log(f"closed loop, {mix['clients']} clients: {len(records)} "
            f"requests sent in the window, {len(done)} answered in it, "
            f"{failed} failed; audio s answered by 1 s slice {slices}")
    else:
        lat = sorted((r[4] - r[2]) * 1e3 if r[5] == 200 else math.inf
                     for r in records)
        p95 = lat[min(len(lat) - 1, math.ceil(0.95 * len(lat)) - 1)]
        # a failed request sorts above every success; where it sets the
        # 95th percentile, the run's wait limit stands in for it
        out["latency_p95_ms"] = (p95 if math.isfinite(p95)
                                 else (seconds + DRAIN_S) * 1e3)
        sent = [r for r in records if r[3] is not None]
        late = tr.lateness_ms([r[2] for r in sent], [r[3] for r in sent])
        log(f"open loop at {mix['rate_per_s']} requests/s: {len(records)} "
            f"requests due in the window, {failed} failed; latency ms p50 "
            f"{lat[len(lat) // 2]!r} p95 {p95!r}; the generator sent late "
            f"by ms p50 {late['p50']!r} p99 {late['p99']!r} max "
            f"{late['max']!r}")

    # the per-layer readings of the traced window
    phase1 = sum(n - replays0.get(k, 0) for k, n in replays1.items()
                 if k[0] == "phase1") + sum(1 for k in captured
                                            if k[0] == "phase1")
    waits = spans.calls["wait_device"]
    host = [(b - a - sum(d - c for c, d in waits if a <= c < b)) * 1e3
            for a, b in spans.within("synthesize_batch", start, end)]
    out["counters"] = {
        "requests_done": len(done),
        "requests": [(len(ids[r[1]]), r[6] // hop) for r in done],
        "dispatches": phase1,
        "dispatch_host_ms": host,
        "queue_ms": queue_ms,
    }
    return out, kept, records


def judge_sample(w, cfg, ids, scale, kept, mix, records, log) -> dict:
    """The sample's widest gap and the answers of a wrong length."""
    gaps, wrong, ties = [], 0, 0
    for idx, pcm in sorted(kept.items()):
        body = idx if mix["loop"] == "closed" else idx % len(ids)
        v = compare.judge(w, cfg, ids[body], scale, pcm)
        ties += v.ties
        if v.frames_ok:
            gaps.append(v.gap_lsb)
        else:
            wrong += 1
    log(f"judged {len(kept)} answers ({sum(len(p) for p in kept.values())} "
        f"samples) against the reference: gaps {gaps}, {wrong} of a wrong "
        f"length, {ties} near ties")
    limits = cfg["limits"]
    return {
        "wav_gap_lsb": {"value": max(gaps) if gaps else 0,
                        "limit": limits["wav_gap_lsb"]},
        "wrong_length": {"value": wrong, "limit": 0},
        "answers_missing": {"value": mix["sample"]["requests"] - len(kept),
                            "limit": 0},
        "failed_requests": {"value": sum(1 for r in records if r[5] != 200),
                            "limit": 0},
    }
