"""The readings the training cell's limits are set from: the program's own
runs (a short window each), the control (the reference with TF32 allowed
in cuBLAS and cuDNN, in the program's place) and the program with a
planted fault (each step on half of its batch, the mean taken over that
half).

    python3 benchmark/tools/train_checks.py --workload \\
        piper-medium.train-lj-b32 --seeds 1 2 3 [--fault] [--out FILE]

prints one JSON line a seed: the numbers compared, of the program and of
the control, or of the fault. With ``--out``, each seed's per-leaf norms
(the program's or the fault's, the reference's and the control's) are
appended to FILE as a JSON line. A card is needed.
"""

import argparse
import json
import shutil
import sys
import tempfile
import time
from pathlib import Path

BENCH = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(BENCH), str(BENCH.parent)]

import torch  # noqa: E402

from harness import runner, train  # noqa: E402


def numbers(got: dict, want: dict) -> dict:
    out = train.compare(got["losses"], got["grads1"], got["change"], want)
    out.pop("keep")
    return out


def control_steps(cell, seed: int, device) -> dict:
    """The control's first steps: the reference with TF32 allowed."""
    cfg, mix = cell.config, cell.traffic
    n = mix["train"]["checked_steps"]
    tmp = Path(tempfile.mkdtemp(prefix="bench-corpus-"))
    try:
        _, flat_g, flat_d, skel = train.prepare(cfg, mix, seed, tmp, device)
        return train.reference_steps(cfg, mix, seed, tmp, flat_g, flat_d,
                                     skel, device, n, allow_tf32=True)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def control(cell, seed: int, device) -> dict:
    """The control's numbers against the reference."""
    cfg, mix = cell.config, cell.traffic
    n = mix["train"]["checked_steps"]
    tmp = Path(tempfile.mkdtemp(prefix="bench-corpus-"))
    try:
        _, flat_g, flat_d, skel = train.prepare(cfg, mix, seed, tmp, device)
        want = train.reference_steps(cfg, mix, seed, tmp, flat_g, flat_d,
                                     skel, device, n)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return numbers(control_steps(cell, seed, device), want)


def program(cell, seed: int, device, fault: bool = False) -> dict:
    """A run of the cell with a short window, its step on half of each
    batch with ``fault``: its raw readings and the reference's."""
    from phoonnx_tpu_torch.train import step as prog_step

    whole = prog_step.train_step

    def half(state, batch, *args, **kwargs):
        rows = batch["phoneme_ids"].shape[0] // 2
        return whole(state, {k: v[:rows] for k, v in batch.items()}, *args,
                     **kwargs)

    if fault:
        prog_step.train_step = half
    try:
        out = train.run(cell, seed, 2.0, False, device, time.perf_counter(),
                        runner.log)
    finally:
        prog_step.train_step = whole
    return out["readings"]


def half_batch(cell, seed: int, device) -> dict:
    r = program(cell, seed, device, fault=True)
    return numbers(r["program"], r["reference"])


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--fault", action="store_true",
                    help="the half-batch fault in place of the program "
                    "and the control")
    ap.add_argument("--out", type=Path,
                    help="append each seed's per-leaf norms here")
    args = ap.parse_args()
    cell = runner.load_cell(args.workload)
    dev = torch.device("cuda")
    for seed in args.seeds:
        r = program(cell, seed, dev, fault=args.fault)
        want = r["reference"]
        line = {"seed": seed}
        if args.fault:
            line["fault"] = numbers(r["program"], want)
        else:
            r["control"] = control_steps(cell, seed, dev)
            line["program"] = numbers(r["program"], want)
            line["control"] = numbers(r["control"], want)
        print(json.dumps(line), flush=True)
        if args.out:
            with open(args.out, "a", encoding="utf-8") as f:
                f.write(json.dumps(dict(r, seed=seed, fault=args.fault))
                        + "\n")


if __name__ == "__main__":
    main()
