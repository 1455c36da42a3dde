"""The knee of an open-loop cell: its traffic at each of several fixed
rates, one window each, in one process behind one warmed server.

    python3 benchmark/tools/knee.py --config piper-medium --traffic lj-open \\
        --seed 1 --seconds 10 --rates 80 90 100 110 120 130 140 150

prints one JSON line a rate: the requests due and answered, the latency
p50 and p95 (ms, from the due time; a failure sorts above every success),
how late the generator sent, and the backlog (requests due and not yet
answered) at each quarter of the window. The knee is the highest rate
whose backlog does not grow over the window. A card is needed.
"""

import argparse
import json
import math
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(BENCH), str(BENCH.parent)]

import torch  # noqa: E402

from harness import runner, serve, traffic  # noqa: E402


def summary(rate, records, start, seconds) -> dict:
    lat = sorted((r[4] - r[2]) * 1e3 if r[5] == 200 else math.inf
                 for r in records)
    sent = [r for r in records if r[3] is not None]
    backlog = []
    for q in (0.25, 0.5, 0.75, 1.0):
        t = start + q * seconds
        backlog.append(sum(1 for r in records if r[2] <= t and
                           (r[4] is None or r[4] > t)))
    return {"rate": rate, "due": len(records),
            "answered": sum(1 for r in records if r[5] == 200),
            "p50_ms": lat[len(lat) // 2],
            "p95_ms": lat[min(len(lat) - 1, math.ceil(0.95 * len(lat)) - 1)],
            "late_ms": traffic.lateness_ms([r[2] for r in sent],
                                           [r[3] for r in sent]),
            "backlog_at_quarters": backlog}


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", required=True)
    ap.add_argument("--traffic", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--rates", type=float, nargs="+", required=True)
    args = ap.parse_args()
    manifest = json.loads((runner.ROOT / "BENCHMARK.json").read_text())
    cell = runner.build_cell(
        f"{args.config}.{args.traffic}", f"benchmark/configs/{args.config}.json",
        args.traffic, 1, manifest)
    dev = torch.device("cuda")
    w, ids, scale, bodies = serve.prepare(cell, args.seed, dev, runner.log)
    prog = serve.Program(cell.config, w.flat, dev)
    loads = []
    try:
        serve.warm(prog, cell.traffic, ids, scale, bodies, args.seed,
                   runner.log, loads)
        for rate in args.rates:
            mix = dict(cell.traffic, rate_per_s=rate)
            load = serve.Load(prog.srv, mix, bodies, args.seconds, args.seed)
            loads.append(load)
            load.wait_window()
            records, _ = load.result()
            print(json.dumps(summary(rate, records, load.start,
                                     args.seconds)), flush=True)
    finally:
        for load in loads:
            load.close()
        prog.close()


if __name__ == "__main__":
    main()
