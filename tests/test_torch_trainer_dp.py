"""The port's trainer on two ranks (data parallelism over gloo), on the CPU.

``run_training`` in two spawned processes that carry the environment
``torch.distributed.run`` gives its processes (``MASTER_ADDR``,
``MASTER_PORT``, ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``), one epoch at
the ``micro`` preset, global batch 4, on a dataset ``chip_smoke.
write_dataset`` writes (13 utterances: 5 held out for tests, 2
validation, 6 train, so two steps), while the parent runs the same epoch
in one process on a copy of the dataset. After the epoch the two ranks
hold equal parameters; rank 0 alone logged and wrote the checkpoint and
the test audio; the validation loss is the same on both ranks and within
``LOSS_RTOL`` of one process's; one process restores the checkpoint the
ranks wrote, and both ranks resume from it for a second epoch. A global
batch that does not split into the ranks (or, in one process, into
``grad_accum`` micro-batches) raises before any step.
"""

import logging
import os
import traceback
from pathlib import Path

import pytest
import torch
import torch.distributed as dist

import chip_smoke
from phoonnx_tpu_torch.models.vits.model import VitsHParams
from phoonnx_tpu_torch.train import checkpoint, step, trainer

from tests.test_torch_parallel import (LOSS_RTOL, WORLD, start_ranks,
                                       wait_ranks)
from tests.test_torch_parallel import one_torch_thread  # noqa: F401

KW = dict(quality="micro", batch_size=4, max_epochs=1, validation_split=0.2,
          disc_periods=(2,), disc_channel_scale=4, log_every=1, seed=3,
          device="cpu")
N_UTTS = 13


def write_dataset(out_dir: Path) -> Path:
    return chip_smoke.write_dataset(
        torch, out_dir, VitsHParams.preset("micro", n_vocab=40), N_UTTS,
        seed=1, seconds=(0.05, 0.12))


def counted_steps():
    """Count ``trainer.train_step``'s updates (validation's eval calls
    are not updates)."""
    calls = []
    update = trainer.train_step

    def counting(*args, **kw):
        if not kw.get("eval_mode"):
            calls.append(1)
        return update(*args, **kw)

    trainer.train_step = counting
    return calls


def trainer_rank(rank, world, port, out: Path, data: Path):
    """A rank as ``torch.distributed.run`` starts one: the launcher's
    environment, then ``run_training``. Saves what the rank saw."""
    os.environ.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                      RANK=str(rank), WORLD_SIZE=str(world),
                      LOCAL_RANK=str(rank))
    try:
        torch.set_num_threads(1)
        steps = counted_steps()
        records = []
        handler = logging.Handler(logging.INFO)
        handler.emit = records.append
        logging.getLogger("trainer").addHandler(handler)
        logging.getLogger("trainer").setLevel(logging.INFO)
        result = {}
        # 3 rows do not split into 2 ranks: raises before any step
        with pytest.raises(ValueError, match="does not split") as odd:
            trainer.run_training(str(data), **dict(KW, batch_size=3))
        result["odd"] = (str(odd.value), len(steps))
        run = trainer.run_training(str(data), **KW)
        state = run.state
        result.update(
            steps=[r["step"] for r in run.steps], updates=len(steps),
            val=run.val_losses, checkpoint=run.checkpoint,
            test_audio=[str(d) for d in run.test_audio_dirs],
            logged=sum(r.levelno >= logging.INFO for r in records),
            params=[t.detach().clone() for t in step.leaves(state.params_g)
                    + step.leaves(state.params_d)])
        # every rank resumes from the checkpoint rank 0 wrote
        resumed = trainer.run_training(
            str(data), **dict(KW, max_epochs=2),
            resume_from_checkpoint=str(data / "checkpoints" / "step_2.npz"))
        result["resumed"] = (
            [r["step"] for r in resumed.steps],
            [t.detach().clone() for t in step.leaves(resumed.state.params_g)
             + step.leaves(resumed.state.params_d)])
        torch.save(result, out / f"rank{rank}.pt")
    except BaseException:
        (out / f"rank{rank}.err").write_text(traceback.format_exc())
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(each rank's record, one process's run on a copy of the data)."""
    root = tmp_path_factory.mktemp("dp")
    data, copy = write_dataset(root / "ranks"), write_dataset(root / "one")
    procs = start_ranks(trainer_rank, WORLD, root, data)
    single = trainer.run_training(str(copy), **KW)
    return wait_ranks(procs, root), single, data


def test_ranks_end_the_epoch_equal(runs):
    ranks, single, _ = runs
    for result in ranks:
        assert result["steps"] == [1, 2] and result["updates"] == 2
    assert [r["step"] for r in single.steps] == [1, 2]
    assert all(torch.equal(a, b) for a, b in zip(ranks[0]["params"],
                                                 ranks[1]["params"]))
    # and they moved
    cfg = step.TrainConfig(disc_periods=(2,), disc_channel_scale=4)
    init = step.init_train_state(single.hp, cfg,
                                 torch.Generator().manual_seed(KW["seed"]))
    before = step.leaves(init.params_g) + step.leaves(init.params_d)
    moved = sum(not torch.equal(a, b) for a, b in zip(ranks[0]["params"],
                                                      before))
    assert moved > len(before) // 2


def test_only_rank_zero_writes_and_logs(runs):
    ranks, _, data = runs
    zero, one = ranks
    assert one["checkpoint"] is None and one["test_audio"] == []
    assert one["logged"] == 0 and zero["logged"] > 0
    assert zero["checkpoint"].endswith("step_2.npz")
    # the first epoch's and the resumed run's (its own test below)
    assert sorted(p.name for p in (data / "checkpoints").iterdir()) == [
        "step_2.json", "step_2.npz", "step_4.json", "step_4.npz"]
    assert zero["test_audio"] == [str(data / "test_audio" / "epoch_0")]
    for epoch in (0, 1):
        assert len(list((data / "test_audio" / f"epoch_{epoch}").glob(
            "*.wav"))) == 5


def test_validation_loss_is_global(runs):
    ranks, single, _ = runs
    zero, one = ranks
    assert len(zero["val"]) == 1 and zero["val"] == one["val"]
    print(f"validation loss: 2 ranks {zero['val'][0]!r}, one process "
          f"{single.val_losses[0]!r}")
    assert zero["val"][0] == pytest.approx(single.val_losses[0],
                                           rel=LOSS_RTOL)


def test_one_process_restores_the_checkpoint(runs):
    ranks, single, _ = runs
    fresh = step.init_train_state(single.hp, step.TrainConfig(
        disc_periods=(2,), disc_channel_scale=4))
    checkpoint.restore(ranks[0]["checkpoint"], fresh)
    assert fresh.step == 2
    assert all(torch.equal(a, b) for a, b in zip(
        step.leaves(fresh.params_g) + step.leaves(fresh.params_d),
        ranks[0]["params"]))


def test_every_rank_resumes_from_the_checkpoint(runs):
    """A second run on the two ranks resumes from the checkpoint rank 0
    wrote (the first run returned on every rank once it was written) and
    takes the next epoch's steps, the ranks equal after them."""
    ranks, _, _ = runs
    (steps0, params0), (steps1, params1) = (r["resumed"] for r in ranks)
    assert steps0 == steps1 == [3, 4]
    assert all(torch.equal(a, b) for a, b in zip(params0, params1))
    assert not all(torch.equal(a, b) for a, b in zip(params0,
                                                     ranks[0]["params"]))


def test_a_batch_that_does_not_split_raises_first(runs, tmp_path):
    for message, updates in (r["odd"] for r in runs[0]):
        assert "batch size 3 does not split into 2 rank(s)" in message
        assert updates == 0
    with pytest.raises(ValueError, match="grad_accum 2"):
        trainer.run_training(str(tmp_path / "absent"),
                             **dict(KW, batch_size=3), grad_accum=2)
