"""A cell of the benchmark at the port's ``micro`` widths, for the CPU
tests."""

import dataclasses
import json
from pathlib import Path

BENCH = Path(__file__).resolve().parent.parent


def micro_config(name: str = "piper-medium") -> dict:
    """A configuration file of the benchmark at the port's ``micro``
    widths: the CPU tests' stand-in for a real voice."""
    from phoonnx_tpu_torch.models.vits.model import VitsHParams

    cfg = json.loads((BENCH / "configs" / f"{name}.json").read_text())
    for k, v in dataclasses.asdict(VitsHParams.preset("micro")).items():
        if k in cfg:
            cfg[k] = json.loads(json.dumps(v))
    cfg["name"] = "micro"
    return cfg


def micro_cell(name: str, config: str, traffic: str):
    """A cell of a configuration at micro widths under a traffic mix cut to
    a few clients and texts."""
    from harness import runner

    manifest = json.loads((BENCH.parent / "BENCHMARK.json").read_text())
    cell = runner.build_cell(name, f"benchmark/configs/{config}.json",
                             traffic, 1, manifest)
    mix = dict(cell.traffic)
    mix["texts"] = dict(mix["texts"], n=24)
    mix["warmup"] = dict(mix["warmup"], pass_s=0.5)
    mix["sample"] = dict(mix["sample"], requests=3, among_first=6)
    if mix["loop"] == "closed":
        mix["clients"] = 4
    else:
        mix["rate_per_s"] = 15
        mix["connections"] = 8
    return runner.Cell(name, 1, micro_config(config), mix, manifest)
