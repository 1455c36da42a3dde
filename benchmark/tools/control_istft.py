"""The readings of the multi-band iSTFT serving cell's control
(``harness/serve_istft.py`` ``control_readings``): the reference with TF32
allowed in cuBLAS and cuDNN, judged as a run judges the served audio.

    python3 benchmark/tools/control_istft.py \\
        --workload mb-istft-vits.serve-lj-c64 --seeds 1 2 3 [--requests 16]

prints one JSON line a seed: the widest gap and the answers of a wrong
length. A card is needed (TF32 exists only there).
"""

import argparse
import json
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(BENCH), str(BENCH.parent)]

import torch  # noqa: E402

from harness import runner  # noqa: E402
from harness.serve_istft import control_readings  # noqa: E402


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--requests", type=int, default=None)
    args = ap.parse_args()
    cell = runner.load_cell(args.workload)
    n = args.requests or cell.traffic["sample"]["requests"]
    for seed in args.seeds:
        print(json.dumps(control_readings(cell, seed, n,
                                          torch.device("cuda"))),
              flush=True)


if __name__ == "__main__":
    main()
