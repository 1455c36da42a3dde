"""One run of one cell: ``python3 benchmark/run.py --workload <cell> --seed
<n> --seconds <s> --trace <0|1>``.

The cell is found by name in ``BENCHMARK.json``; its configuration and its
traffic mix are data files, the mix names the module that runs it
(``harness/<name>.py``)
and each per-layer metric is a reader of its own (``metrics/<name>.py``).
The last line of standard output is the result; the numbers compared with
the reference, each beside its limit, are also the last lines of standard
error.
"""

import argparse
import importlib
import importlib.util
import json
import sys
from dataclasses import dataclass
from pathlib import Path
from typing import Any, Dict, Optional

BENCH = Path(__file__).resolve().parent.parent
ROOT = BENCH.parent
# top-level module names that must not be loaded in the process that
# prints the result (the JAX package and JAX itself)
FORBIDDEN = ("jax", "jaxlib", "flax", "phoonnx_tpu")


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    manifest: dict


def load_cell(name: str) -> Cell:
    """A cell of ``BENCHMARK.json`` by name."""
    manifest = json.loads((ROOT / "BENCHMARK.json").read_text())
    cell = next((w for w in manifest["workloads"] if w["name"] == name),
                None)
    if cell is None:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    conf = next(c for c in manifest["configs"] if c["name"] == cell["config"])
    return build_cell(name, conf["file"], cell["traffic"], cell["chips"],
                      manifest)


def build_cell(name: str, config_file: str, traffic: str, chips: int,
               manifest: dict) -> Cell:
    """A cell of a configuration file and a traffic mix by name, whether or
    not ``BENCHMARK.json`` lists the pair (the tools and tests run mixes it
    does not)."""
    config = json.loads((ROOT / config_file).read_text())
    mix = json.loads((BENCH / "traffic" / f"{traffic}.json").read_text())
    return Cell(name, chips, config, mix, manifest)


@dataclass
class Reading:
    """What a per-layer metric's reader reads."""
    cell: Cell
    seconds: float
    timeline: Any  # trace.Timeline or None
    counters: Dict[str, Any]
    peaks: Optional[dict]

    def kernel_patterns(self, kernel: str):
        """The name patterns of a kernel's implementations, from every
        ``kernels/<kernel>/*.json``."""
        out = []
        for f in sorted((BENCH / "kernels" / kernel).glob("*.json")):
            out += json.loads(f.read_text())["patterns"]
        return out


def read_metric(name: str, reading: Reading) -> Optional[float]:
    path = BENCH / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "bench_metric_" + name.replace(".", "_"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read(reading)


def applies(metric: dict, cell: Cell) -> bool:
    if "workloads" in metric:
        return cell.name in metric["workloads"]
    return True


def forbidden_modules():
    return sorted({m.split(".")[0] for m in sys.modules}
                  & set(FORBIDDEN))


def log(msg: str) -> None:
    print(msg, flush=True)


def execute(cell: Cell, seed: int, seconds: float, trace: bool, device,
            t0: float) -> dict:
    """Drive the cell and assemble the result (no chip check here)."""
    import torch

    from harness import peaks as peaks_mod

    runs = importlib.import_module(f"harness.{cell.traffic['harness']}")
    out = runs.run(cell, seed, seconds, trace, device, t0, log)
    if device.type == "cuda":
        kind = torch.cuda.get_device_name(device)
        dev = {"platform": "gpu", "kind": kind, "count": cell.chips,
               "memory_peak_bytes": out["memory_peak_bytes"]}
    else:
        kind = "cpu"
        dev = {"platform": "cpu", "kind": kind, "count": 1,
               "memory_peak_bytes": out["memory_peak_bytes"]}
    metrics: Dict[str, dict] = {}
    result = {"correct": all(c["value"] <= c["limit"]
                             for c in out["checks"].values()),
              "attempted": out["attempted"], "failed": out["failed"]}
    if not trace:
        for m in cell.manifest["end_to_end"]:
            if applies(m, cell):
                metrics[m["name"]] = {"value": out[m["name"]],
                                      "unit": m["unit"]}
    else:
        tl = out["timeline"]
        reading = Reading(cell, seconds, tl, out["counters"],
                          peaks_mod.of(kind))
        for m in cell.manifest["per_layer"]:
            if applies(m, cell):
                value = read_metric(m["name"], reading)
                if value is not None:
                    metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        dev["busy_s"] = tl.busy_s if tl else 0.0
        dev["window_s"] = tl.window_s if tl else 0.0
        if tl is not None:
            result["breakdown"] = tl.breakdown()
    result["metrics"] = metrics
    result["device"] = dev
    result["checks"] = out["checks"]
    return result


def card_line() -> None:
    import subprocess

    try:
        line = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as exc:
        line = f"nvidia-smi unavailable: {exc}"
    log(f"card: {line}")


def main(argv, t0: float) -> int:
    ap = argparse.ArgumentParser(prog="benchmark/run.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cell = load_cell(args.workload)

    import torch

    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"{cell.name} needs {cell.chips} CUDA device(s); "
              f"{torch.cuda.device_count()} available", file=sys.stderr)
        return 2
    card_line()
    result = execute(cell, args.seed, args.seconds, bool(args.trace),
                     torch.device("cuda", 0), t0)
    found = forbidden_modules()
    if found:
        print(f"modules loaded that the run must not load: {found}",
              file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0
