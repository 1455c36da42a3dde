"""Data-parallel training in the port (``phoonnx_tpu_torch/parallel``, the
step under a mesh) on the CPU, over gloo.

The guards of ``parallel/`` mirror ``tests/test_parallel_guards.py:8-28``
and the two-process smoke mirrors ``tests/_multihost_worker.py``. The
object held is the step's GRADIENTS and losses, as in
``tests/test_multidevice_equivalence.py``: two ranks, each on its rows of
one global batch, against one process on the whole batch from the same
seed, with dropout on (drawn from the step generator). The bars are that
test's (``:48-50``): the median leaf within ``GRAD_MEDIAN_RELL2``, every
leaf within ``GRAD_MAX_RELL2`` (relative L2, floored at 1e-6 of the
global gradient norm), the losses within ``LOSS_RTOL``. The same holds
with ``grad_accum=2``. In bf16 each rank rounds its own weight gradients
to bf16 before the mean (about 2^-8 relative), so the bar is the rule
``tests/test_torch_train_options.py`` holds bf16 to: the two-rank bf16
gradients are no farther from one process's float32 gradients,
leaf-median rel-L2, than ``BF16_RATIO`` times one process's bf16
gradients are. With ``remat`` the recompute redraws each rank's rows of
the masks, and the bars hold again. A one-rank group's step is
``torch.equal`` to the step without a mesh. Taking the KL's or the
duration loss's denominator per rank (ranks of different valid lengths)
fails the bars; the global one passes. ``tests/test_torch_parallel_jax.py`` holds the two ranks against
the JAX package's step on a two-device mesh.

The weights are the port's initialisation with the zero-initialised
projections randomised (as ``tests/test_torch_train_forward.py`` does),
so that every leaf has a gradient. The ranks are spawned processes on a
free port (this module imports no JAX, so they start quickly); one module
fixture runs every case in the same two ranks while the parent computes
the one process's side.
"""

import contextlib
import multiprocessing
import re
import socket
import time
import traceback
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist

import chip_smoke
from phoonnx_tpu_torch.models.vits.model import VitsHParams
from phoonnx_tpu_torch.parallel import (Mesh, batch_sharding, make_mesh,
                                        multihost, shard_batch,
                                        shard_train_state)
from phoonnx_tpu_torch.train import checkpoint, step

GRAD_MEDIAN_RELL2 = 1e-6
GRAD_MAX_RELL2 = 3e-2
LOSS_RTOL = 1e-5
BF16_RATIO = 1.25

HP = VitsHParams.preset("micro", n_vocab=24)
# bf16 with the deterministic duration predictor, as
# tests/test_torch_train_options.py: through the random spline flows of
# the stochastic one a bf16 rounding moves the gradients by O(1) (ROADMAP
# §3), which would leave no rounding for the bar to compare
BF16_HP = VitsHParams.preset("micro", n_vocab=24, use_sdp=False)
DISC = dict(disc_periods=(2, 3), disc_channel_scale=4)
ZERO_INIT = re.compile(
    r"\['flow'\]\['flows'\]\[\d+\]\['post'\]|\['cf'\]\['proj'\]|\['ea'\]")
WORLD = 2
T_X, T_Y = 10, 40
LENGTHS = [(10, 40), (7, 33), (9, 36), (6, 30)]
# grad_accum 2 takes a batch of 8, so that a rank's micro-batch holds two
# rows: the CPU's convolutions take another kernel at batch 1, whose
# rounding alone moves the median gradient leaf by ~4e-5
LENGTHS_8 = LENGTHS + [(8, 39), (5, 28), (10, 34), (7, 31)]
# rank 0 long, rank 1 short: per-rank and global denominators differ
SKEWED = [(10, 40), (9, 38), (4, 20), (3, 16)]
STEP_SEED = 11
INIT_SEED = 1


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch thread for the module's ops (the suite runs six workers,
    and OpenMP pools on every worker oversubscribe the cores); the
    previous count is restored after."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def make_batch(lengths, seed, t_x=T_X, t_y=T_Y):
    """A loader-shaped global batch (numpy): ids, lengths, a spectrogram
    and audio."""
    rng = np.random.default_rng(seed)
    b = len(lengths)
    x_len = np.asarray([x for x, _ in lengths], np.int32)
    y_len = np.asarray([y for _, y in lengths], np.int32)
    spec = (0.3 * np.abs(rng.standard_normal((b, t_y, HP.spec_channels)))
            ).astype(np.float32)
    spec *= np.arange(t_y)[None, :, None] < y_len[:, None, None]
    return {
        "phoneme_ids": rng.integers(1, HP.n_vocab, (b, t_x)).astype(np.int32),
        "phoneme_lengths": x_len, "spec": spec, "spec_lengths": y_len,
        "audio": (0.3 * rng.standard_normal((b, t_y * HP.hop_length))
                  ).astype(np.float32)}


def random_weights(hp, cfg, seed=INIT_SEED):
    """The port's initialisation from ``seed`` as flat weights (keypath
    names), the zero-initialised projections drawn from a normal of scale
    0.3 so that every coupling and spline does real work: the port's side
    of ``tests/test_torch_train_forward.make_models``, draw for draw."""
    state = step.init_train_state(hp, cfg, torch.Generator().manual_seed(seed))
    flat = {f".params_{net}{name}": leaf.detach().numpy().copy()
            for net, tree in (("g", state.params_g), ("d", state.params_d))
            for name, leaf in step.keyed_leaves(tree)}
    rng = np.random.default_rng(seed + 100)
    for name in sorted(flat):
        if ZERO_INIT.search(name):
            flat[name] = (0.3 * rng.standard_normal(flat[name].shape)
                          ).astype(np.float32)
    return flat


@contextlib.contextmanager
def held_alignment(attn):
    """The training forward's alignment search returns ``attn``, as
    ``tests/test_torch_train_options.py`` holds bf16: a rounding can move
    a monotonic alignment by a frame, which changes the duration and KL
    terms by a step of their own, and the bf16 bar is on rounding."""
    from phoonnx_tpu_torch.models.vits import model

    real = model.mas.maximum_path
    model.mas.maximum_path = lambda nc, mask: (
        torch.from_numpy(attn).to(nc.dtype) * mask)
    try:
        yield
    finally:
        model.mas.maximum_path = real


def trees_state(flat, hp, cfg):
    """A train state holding the flat weights ``flat``."""
    g, d = checkpoint.trees_from_flat(flat, hp, cfg)
    for t in step.leaves(g) + step.leaves(d):
        t.requires_grad_(True)
    return step.TrainState(g, d, step.make_optimizer(cfg, step.leaves(g)),
                           step.make_optimizer(cfg, step.leaves(d)))


# ---------------------------------------------------------------------------
# Ranks: spawned processes of one gloo group
# ---------------------------------------------------------------------------


def free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def start_ranks(target, world, out: Path, *args):
    """Start ``target(rank, world, port, out, *args)`` in ``world``
    spawned processes."""
    ctx = multiprocessing.get_context("spawn")
    port = free_port()
    procs = [ctx.Process(target=target, args=(rank, world, port, out) + args)
             for rank in range(world)]
    for proc in procs:
        proc.start()
    return procs


def wait_ranks(procs, out: Path, timeout=150.0):
    """Each rank's ``rank{r}.pt`` once all have exited; when one fails
    the others are stopped (they would wait at their next collective)."""
    deadline = time.monotonic() + timeout
    try:
        while any(p.is_alive() for p in procs):
            if any(p.exitcode not in (None, 0) for p in procs):
                break
            assert time.monotonic() < deadline, "ranks timed out"
            time.sleep(0.05)
    finally:
        for proc in procs:
            if proc.is_alive():
                proc.terminate()
            proc.join(10)
    for rank, proc in enumerate(procs):
        err = out / f"rank{rank}.err"
        assert proc.exitcode == 0, (
            err.read_text() if err.exists() else f"exit {proc.exitcode}")
    return [torch.load(out / f"rank{r}.pt", weights_only=False)
            for r in range(len(procs))]


def rank_main(rank, world, port, out: Path, body, *args):
    """A rank's process: one thread, the gloo group, ``body(mesh, *args)``
    saved as ``rank{r}.pt``; a failure's traceback as ``rank{r}.err``."""
    try:
        torch.set_num_threads(1)
        assert multihost.initialize(f"127.0.0.1:{port}", world, rank,
                                    backend="gloo") == (world > 1)
        result = body(make_mesh(device="cpu"), *args)
        torch.save(result, out / f"rank{rank}.pt")
    except BaseException:
        (out / f"rank{rank}.err").write_text(traceback.format_exc())
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def per_rank(which):
    """``step.denominators`` with the duration loss's ("dur") or the
    KL's ("kl") count taken over this rank's rows alone: the fault the
    global denominators prevent."""
    real = step.denominators

    def local(batch, mesh):
        tokens, frames = real(batch, mesh)
        t_x, t_y = batch["phoneme_ids"].shape[1], batch["spec"].shape[1]
        if which == "dur":
            return torch.clamp(batch["phoneme_lengths"], max=t_x
                               ).sum().float(), frames
        return tokens, torch.clamp(batch["spec_lengths"], max=t_y
                                   ).sum().float()

    return local


def run_case(mesh, case):
    """One step's averaged gradients and metrics on this rank's rows of
    ``case``'s global batch (and noise)."""
    cfg = step.TrainConfig(**DISC, **case.get("cfg", {}))
    hp = case.get("hp", HP)
    state = trees_state(case["weights"], hp, cfg)
    rows = batch_sharding(mesh, len(case["batch"]["spec"]), cfg.grad_accum)
    batch = step.batch_to_device({k: v[rows] for k, v in
                                  case["batch"].items()}, "cpu")
    noise = case.get("noise")
    if noise is not None:
        noise = {k: torch.from_numpy(v[rows]) for k, v in noise.items()}
    gen = (torch.Generator().manual_seed(case["seed"])
           if case.get("seed") is not None else None)
    real = step.denominators
    if case.get("per_rank"):
        step.denominators = per_rank(case["per_rank"])
    attn = case.get("attn")
    try:
        with (held_alignment(attn[rows]) if attn is not None
              else contextlib.nullcontext()):
            g_g, g_d, metrics = step.step_grads(state, batch, hp, cfg,
                                                generator=gen, noise=noise,
                                                mesh=mesh)
    finally:
        step.denominators = real
    return {"g": [t.detach() for t in g_g], "d": [t.detach() for t in g_d],
            "m": {k: float(v) for k, v in metrics.items()}}


def run_cases(mesh, cases):
    return {name: run_case(mesh, case) for name, case in cases.items()}


def smoke(mesh):
    """The two-process smoke of ``tests/_multihost_worker.py``: rows
    that assemble to the global batch, and state broadcast from rank 0
    (parameters and AdamW moments, which differ across ranks before)."""
    rows = multihost.process_batch_slice(8)
    assert rows == slice(4 * mesh.rank, 4 * mesh.rank + 4), rows
    full = torch.arange(8, dtype=torch.float32)
    total = full[rows].sum()
    dist.all_reduce(total)
    assert float(total) == float(full.sum())
    with pytest.raises(ValueError, match="never train"):
        multihost.process_batch_slice(3)
    cfg = step.TrainConfig(**DISC)
    state = step.init_train_state(
        HP, cfg, torch.Generator().manual_seed(100 + mesh.rank))
    batch = step.batch_to_device(make_batch(LENGTHS[:2], 3), "cpu")
    step.train_step(state, batch, HP, cfg,
                    generator=torch.Generator().manual_seed(mesh.rank))
    before = [t.detach().clone() for t in step.leaves(state.params_g)]
    shard_train_state(mesh, state)
    moments = [state.opt_g.state[p][k].clone()
               for p in step.leaves(state.params_g)
               for k in ("exp_avg", "exp_avg_sq", "step")]
    return {"rows": shard_batch(mesh, {"i": np.arange(8)}, 2)["i"],
            "before": before,
            "after": [t.detach().clone() for t in step.leaves(state.params_g)]
            + moments + [torch.tensor(state.step)]}


def rank_body(mesh, cases):
    return {"smoke": smoke(mesh), **run_cases(mesh, cases)}


# ---------------------------------------------------------------------------
# One process's side and the comparisons
# ---------------------------------------------------------------------------


def rel_l2(want, got):
    """(median, max) of the leaves' relative L2 distances, floored at
    1e-6 of the global norm of ``want`` (a leaf whose gradient is zero in
    exact arithmetic holds rounding noise alone)."""
    return chip_smoke.leaf_rel_l2(torch, want, got)


def bars_hold(want, got) -> bool:
    """The JAX equivalence test's bars on the gradients and losses."""
    for key in ("g", "d"):
        median, worst = rel_l2(want[key], got[key])
        if median > GRAD_MEDIAN_RELL2 or worst > GRAD_MAX_RELL2:
            return False
    return all(got["m"][k] == pytest.approx(want["m"][k], rel=LOSS_RTOL)
               for k in step.METRICS)


def one_process(case):
    """The case on one process, whole batch, no mesh: its gradients,
    metrics and its alignment (where it searched for one)."""
    from phoonnx_tpu_torch.models.vits import model

    cfg = step.TrainConfig(**DISC, **case.get("cfg", {}))
    hp = case.get("hp", HP)
    state = trees_state(case["weights"], hp, cfg)
    found = []
    search = model.mas.maximum_path
    model.mas.maximum_path = lambda nc, mask: found.append(
        search(nc, mask)) or found[-1]
    try:
        with (held_alignment(case["attn"]) if "attn" in case
              else contextlib.nullcontext()):
            g_g, g_d, metrics = step.step_grads(
                state, step.batch_to_device(case["batch"], "cpu"), hp, cfg,
                generator=torch.Generator().manual_seed(case["seed"]))
    finally:
        model.mas.maximum_path = search
    return {"g": list(g_g), "d": list(g_d),
            "attn": found[0].numpy() if found else None,
            "m": {k: float(v) for k, v in metrics.items()}}


CASES = {
    "float32": dict(batch=make_batch(LENGTHS, 5), seed=STEP_SEED),
    "grad_accum": dict(batch=make_batch(LENGTHS_8, 8), seed=STEP_SEED,
                       cfg=dict(grad_accum=2)),
    "bf16_truth": dict(batch=make_batch(LENGTHS, 5), seed=STEP_SEED,
                       hp=BF16_HP),
    "bfloat16": dict(batch=make_batch(LENGTHS, 5), seed=STEP_SEED,
                     hp=BF16_HP, cfg=dict(compute_dtype="bfloat16")),
    "skewed": dict(batch=make_batch(SKEWED, 6), seed=STEP_SEED),
    "remat": dict(batch=make_batch(LENGTHS, 5), seed=STEP_SEED,
                  cfg=dict(remat=True)),
    "per_rank_kl": dict(batch=make_batch(SKEWED, 6), seed=STEP_SEED,
                        per_rank="kl"),
    "per_rank_dur": dict(batch=make_batch(SKEWED, 6), seed=STEP_SEED,
                         per_rank="dur"),
}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(each rank's results, one process's results) of every case: the
    two ranks run in spawned processes while the parent runs one
    process's side."""
    out = tmp_path_factory.mktemp("ranks")
    cases = {name: dict(case, weights=random_weights(
        case.get("hp", HP), step.TrainConfig(**DISC)))
        for name, case in CASES.items()}
    # bf16 runs on the float32 truth's alignment
    single = {"bf16_truth": one_process(cases["bf16_truth"])}
    cases["bfloat16"]["attn"] = single["bf16_truth"]["attn"]
    del cases["bf16_truth"]
    procs = start_ranks(rank_main, WORLD, out, rank_body, cases)
    single.update({name: one_process(case) for name, case in cases.items()
                   if name not in single and not case.get("per_rank")})
    return wait_ranks(procs, out), single


@pytest.fixture(scope="module")
def ranks(runs):
    return runs[0]


@pytest.fixture(scope="module")
def single(runs):
    return runs[1]


def test_guards_without_a_group(monkeypatch):
    """An empty group, a group beside more processes than it spans, a
    partial explicit request and a partial launcher environment raise; a
    single process without the environment is a no-op."""
    for var in multihost.LAUNCH_ENV:
        monkeypatch.delenv(var, raising=False)
    with pytest.raises(ValueError, match="EMPTY"):
        make_mesh(n_data=0, device="cpu")
    with pytest.raises(ValueError, match="wants 2 ranks, have 1"):
        make_mesh(n_data=2, device="cpu")
    with pytest.raises(ValueError, match="coordinator_address"):
        multihost.initialize(num_processes=4, process_id=2)
    with pytest.raises(ValueError, match="num_processes, process_id"):
        multihost.initialize(coordinator_address="127.0.0.1:1")
    assert multihost.initialize() is False
    assert not dist.is_initialized()
    monkeypatch.setenv("RANK", "1")
    with pytest.raises(ValueError, match="partial launcher environment"):
        multihost.initialize()
    assert not dist.is_initialized()
    assert multihost.process_batch_slice(5) == slice(0, 5)
    assert make_mesh(device="cpu") == Mesh(1, 0, torch.device("cpu"))


def test_rows_of_each_micro_batch():
    """Rank r's rows are its share of each global micro-batch; a batch
    that does not split raises."""
    mesh = Mesh(size=2, rank=1, device=torch.device("cpu"))
    assert batch_sharding(mesh, 8).tolist() == [4, 5, 6, 7]
    assert batch_sharding(mesh, 8, grad_accum=2).tolist() == [2, 3, 6, 7]
    assert batch_sharding(Mesh(4, 3, torch.device("cpu")), 8, 2
                          ).tolist() == [3, 7]
    with pytest.raises(ValueError, match="never train"):
        batch_sharding(mesh, 6, grad_accum=2)
    with pytest.raises(ValueError, match="never train"):
        batch_sharding(mesh, 3)


def test_two_process_smoke(ranks):
    for rank, result in enumerate(ranks):
        assert result["smoke"]["rows"].tolist() == [2 * rank, 2 * rank + 1,
                                                    4 + 2 * rank,
                                                    5 + 2 * rank]
    zero, one = ranks[0]["smoke"], ranks[1]["smoke"]
    # the ranks' own states differ, and the broadcast makes them rank 0's
    assert not all(torch.equal(a, b) for a, b in zip(zero["before"],
                                                     one["before"]))
    assert all(torch.equal(a, b) for a, b in zip(zero["after"], one["after"]))
    assert all(torch.equal(a, b) for a, b in zip(zero["before"],
                                                 zero["after"]))


@pytest.mark.parametrize("name", ["float32", "grad_accum", "skewed",
                                  "remat"])
def test_two_ranks_match_one_process(ranks, single, name):
    """The averaged gradients are the same bits on both ranks and match
    one process's step on the global batch within the bars."""
    want, got = single[name], ranks[0][name]
    for key in ("g", "d"):
        assert all(torch.equal(a, b) for a, b in zip(got[key],
                                                     ranks[1][name][key]))
    assert got["m"] == ranks[1][name]["m"]
    for key in ("g", "d"):
        median, worst = rel_l2(want[key], got[key])
        print(f"{name} {key}: median leaf rel-L2 {median:.3e}, max "
              f"{worst:.3e}")
        assert median <= GRAD_MEDIAN_RELL2, (key, median)
        assert worst <= GRAD_MAX_RELL2, (key, worst)
    for k in step.METRICS:
        assert got["m"][k] == pytest.approx(want["m"][k], rel=LOSS_RTOL), k


def test_bf16_two_ranks_within_the_bf16_bar(ranks, single):
    truth, one = single["bf16_truth"], single["bfloat16"]
    got = ranks[0]["bfloat16"]
    for key in ("g", "d"):
        ref, _ = rel_l2(truth[key], one[key])
        dp, _ = rel_l2(truth[key], got[key])
        print(f"bf16 {key}: 2 ranks {dp:.3e}, one process {ref:.3e} from "
              "float32 (median leaf rel-L2)")
        assert 0 < dp <= BF16_RATIO * ref, (key, dp, ref)


def test_per_rank_denominators_fail_the_bars(ranks, single):
    """Ranks of different valid lengths: the global KL and duration
    denominators pass (``skewed`` above); either taken per rank fails."""
    want = single["skewed"]
    assert bars_hold(want, ranks[0]["skewed"])
    for name in ("per_rank_kl", "per_rank_dur"):
        assert not bars_hold(want, ranks[0][name]), name
        for key in ("g", "d"):
            median, worst = rel_l2(want[key], ranks[0][name][key])
            print(f"{name} {key}: median leaf rel-L2 {median:.3e}, max "
                  f"{worst:.3e}")


def test_one_rank_group_is_the_step():
    """A one-process group's step (window of the whole batch, denominators
    over one rank, means over one rank) is ``torch.equal`` to the step
    without a mesh, with and without micro-batches."""
    assert multihost.initialize(f"127.0.0.1:{free_port()}", 1, 0,
                                backend="gloo") is False
    try:
        mesh = make_mesh(device="cpu")
        for accum in (1, 2):
            cfg = step.TrainConfig(**DISC, grad_accum=accum)
            batch = step.batch_to_device(make_batch(LENGTHS, 5), "cpu")
            states, metrics = [], []
            for m in (None, mesh):
                state = step.init_train_state(
                    HP, cfg, torch.Generator().manual_seed(INIT_SEED))
                for i in range(2):
                    _, out = step.train_step(
                        state, batch, HP, cfg, mesh=m,
                        generator=torch.Generator().manual_seed(i))
                states.append(state)
                metrics.append(out)
            for a, b in zip(*(step.leaves(s.params_g) + step.leaves(s.params_d)
                              for s in states)):
                assert torch.equal(a, b)
            for k in step.METRICS:
                assert torch.equal(metrics[0][k], metrics[1][k]), k
    finally:
        dist.destroy_process_group()
