"""The training cell at micro widths on the CPU: a sound run is correct
and matches the reference to the bit; a step that leaves the state
unchanged, and a step on half of its batch, are not correct."""

import time

import pytest
import torch

from bench_micro import micro_config
from harness import runner

WORKLOAD = "piper-medium.train-lj-b32"


def micro_train_cell():
    cell = runner.load_cell(WORKLOAD)
    mix = dict(cell.traffic)
    mix["texts"] = dict(mix["texts"], n=12, clip_s=[0.3, 0.6, 0.9])
    mix["train"] = dict(mix["train"], batch_size=4, disc_periods=[2])
    return runner.Cell(cell.name, 1, micro_config(), mix, cell.manifest)


def run_cell(trace=False):
    torch.set_num_threads(4)
    return runner.execute(micro_train_cell(), 2 ** 31 + 21, 1.0, trace,
                          torch.device("cpu"), time.perf_counter())


def test_a_sound_run_is_the_reference():
    res = run_cell()
    assert res["correct"] and res["attempted"] > 0 and res["failed"] == 0
    assert set(res["metrics"]) == {"setup_s", "train_audio_s_per_s"}
    # the same plain ops on the CPU: the same bits
    assert all(c["value"] == 0.0 for c in res["checks"].values())


def test_a_traced_run_reads_the_loader():
    res = run_cell(trace=True)
    assert res["correct"]
    assert set(res["metrics"]) == {"data_wait_ms.train"}


def _unchanged(state, batch, *args, **kwargs):
    return state, {"loss_gen_all": torch.tensor(1.0),
                   "loss_disc_all": torch.tensor(1.0)}


def _half(whole):
    def half(state, batch, *args, **kwargs):
        rows = batch["phoneme_ids"].shape[0] // 2
        return whole(state, {k: v[:rows] for k, v in batch.items()}, *args,
                     **kwargs)
    return half


@pytest.mark.parametrize("fault", ["unchanged", "half_batch"])
def test_a_broken_step_is_not_correct(monkeypatch, fault):
    from phoonnx_tpu_torch.train import step as prog_step

    broken = (_unchanged if fault == "unchanged"
              else _half(prog_step.train_step))
    monkeypatch.setattr(prog_step, "train_step", broken)
    res = run_cell()
    assert res["correct"] is False
    failing = [k for k, c in res["checks"].items() if c["value"] > c["limit"]]
    assert failing
    if fault == "unchanged":
        # the state left unchanged reads 1 by the median leaf's change
        assert res["checks"]["median_change_gap"]["value"] == 1.0
