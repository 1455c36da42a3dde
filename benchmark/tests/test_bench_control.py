"""The control fails the comparison: the reference computed with TF32
allowed, put in the program's place, at the cells' own widths and
traffic on three seeds (four requests each here; the readings in PERF.md
are of the run's sixteen). On the card only: TF32 exists there alone."""

import pytest

from harness import runner
from harness.control import readings


@pytest.mark.cuda
@pytest.mark.parametrize("workload", ["piper-medium.serve-lj-c64",
                                      "piper-high.serve-lj-c64"])
def test_the_control_is_not_correct(card, workload):
    cell = runner.load_cell(workload)
    limit = cell.config["limits"]["wav_gap_lsb"]
    for seed in (2 ** 31 + 101, 2 ** 31 + 102, 2 ** 31 + 103):
        r = readings(cell, seed, 4, card)
        assert r["wrong_length"] > 0 or r["wav_gap_lsb"] > limit, r


@pytest.mark.cuda
def test_the_training_control_is_not_correct(card):
    """The training cell's control at its widths and batch, on a corpus of
    64 utterances (the readings in PERF.md are of the cell's 256)."""
    import train_checks

    cell = runner.load_cell("piper-medium.train-lj-b32")
    cell.traffic = dict(cell.traffic, texts=dict(cell.traffic["texts"], n=64))
    limits = cell.config["limits"]
    for seed in (2 ** 31 + 201, 2 ** 31 + 202, 2 ** 31 + 203):
        r = train_checks.control(cell, seed, card)
        assert any(r[k] > limits[k] for k in ("loss_gap", "grad1_gap",
                                              "median_change_gap")), r
