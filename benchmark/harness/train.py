"""The training cell: the program's ``train_step`` over its
``BucketedLoader``, as its trainer drives them, on a synthetic corpus.

Set-up: the corpus (LJ Speech's clip lengths and grapheme texts, tones as
audio, the benchmark's own spectrograms) written in the preprocessor's
on-disk format under a fresh directory of ``TMPDIR``; the generator's
weights from the seed through the program's loading path and the
discriminator's from the same draw; the state, with AdamW on each network;
the first epoch, unmeasured, whose first three steps are the ones the
reference follows. Then the window, which cycles epochs. After it, with the
program freed, the reference runs the same three steps from the same
weights, batches and draws, and the checks compare the losses, the first
gradients (from AdamW's first moment after one step) and the parameters'
change after three (by the median leaf).
"""

import gc
import json
import math
import shutil
import statistics
import tempfile
import time
from pathlib import Path
from typing import Dict, List

import numpy as np
import torch

from harness import serve, traffic, weights
from harness.spans import Spans
from harness.trace import Tracer
from reference import frontend
from reference.vitstrain import dataset as ref_data
from reference.vitstrain import discriminator as ref_disc
from reference.vitstrain import load as ref_load
from reference.vitstrain import step as ref_step
from reference.vitstrain import stft as ref_stft

# the reference's gradient under this share of the median leaf's is
# rounding: such leaves move under Adam by round-off alone
NEGLIGIBLE = 1e-3


def step_generator(device, seed: int, step: int) -> torch.Generator:
    """The noise and dropout source of one step (the trainer's rule)."""
    return torch.Generator(device=device).manual_seed(
        seed * 1_000_003 + step)


def write_corpus(cfg: dict, mix: dict, seed: int, root: Path,
                 device) -> List[dict]:
    """``mix["corpus"]["utterances"]`` utterances of LJ Speech's lengths:
    their texts and ids, harmonic tones under a syllable-rate envelope as
    audio, and the linear spectrograms, as ``.npy`` files and a
    ``dataset.jsonl``. Returns the jsonl's rows."""
    seconds, texts = traffic.lj_clips(mix["texts"], seed)
    sr, hop = cfg["sample_rate"], cfg["hop_length"]
    imap = serve.id_map(cfg)
    gen = torch.Generator(device=device).manual_seed(seed + 2)
    n_frames = [max(int(round(s * sr / hop)), 2 * len(t) + 4)
                for s, t in zip(seconds, texts)]
    longest = max(n_frames) * hop
    t = torch.arange(longest, device=device) / sr
    f0 = 100 + 120 * torch.rand(len(texts), 1, generator=gen, device=device)
    rate = 2.5 + 2 * torch.rand(len(texts), 1, generator=gen, device=device)
    env = 0.5 + 0.5 * torch.sin(2 * math.pi * rate * t)
    audio = env * sum(a * torch.sin(2 * math.pi * f0 * k * t)
                      for k, a in ((1, 0.5), (2, 0.25), (3, 0.12)))
    audio = audio + 0.01 * torch.randn(audio.shape, generator=gen,
                                       device=device)
    rows = []
    for i, (text, n) in enumerate(zip(texts, n_frames)):
        a = audio[i:i + 1, :n * hop]
        s = ref_stft.spectrogram(a, cfg["filter_length"], hop,
                                 cfg["win_length"])[0]
        a_path, s_path = root / f"{i}.audio.npy", root / f"{i}.spec.npy"
        np.save(a_path, a[0].cpu().numpy())
        np.save(s_path, s.cpu().numpy())
        rows.append({"phoneme_ids": frontend.text_to_ids(text, imap),
                     "audio_norm_path": str(a_path),
                     "audio_spec_path": str(s_path), "text": text})
    with open(root / "dataset.jsonl", "w", encoding="utf-8") as f:
        for row in rows:
            f.write(json.dumps(row) + "\n")
    return rows


def _tree(flat: Dict[str, torch.Tensor], skeleton):
    """``skeleton`` with every tensor leaf replaced by ``flat``'s value
    under its dotted path."""
    def walk(node, prefix):
        if isinstance(node, dict):
            return {k: walk(v, f"{prefix}{k}.") for k, v in node.items()}
        if isinstance(node, list):
            return [walk(v, f"{prefix}{i}.") for i, v in enumerate(node)]
        if isinstance(node, torch.Tensor):
            return flat[prefix[:-1]]
        return node
    return walk(skeleton, "")


def disc_layout(skeleton) -> List[weights.Leaf]:
    """The discriminator's tensors by dotted path, at the scales of its
    initialiser (a weight-normalised conv's direction at 1/sqrt(fan-in),
    its gain around the direction's norm, biases near zero)."""
    out: List[weights.Leaf] = []

    def walk(node, prefix):
        if isinstance(node, dict):
            if "weight_v" in node:
                v = node["weight_v"]
                fan = math.prod(v.shape[1:])
                out.append((prefix + "weight_v", tuple(v.shape), 0.0,
                            fan ** -0.5))
                out.append((prefix + "weight_g", tuple(node["weight_g"].shape),
                            1.0, 0.05))
                out.append((prefix + "bias", tuple(node["bias"].shape), 0.0,
                            (3 * fan) ** -0.5))
                return
            for k, sub in node.items():
                walk(sub, f"{prefix}{k}.")
        elif isinstance(node, list):
            for i, sub in enumerate(node):
                walk(sub, f"{prefix}{i}.")
    walk(skeleton, "")
    return out


def make_trees(cfg: dict, flat_g, flat_d, skeleton_d, params_from_flat,
               device):
    """Fresh leaf tensors (requiring grad) of both networks on the
    device: the generator through ``params_from_flat``, the discriminator
    on ``skeleton_d``'s layout."""
    hp = serve.hparams(cfg)
    g = params_from_flat({k: v.cpu().numpy() for k, v in flat_g.items()},
                         hp, strict=True)

    def to_dev(tree):
        if isinstance(tree, dict):
            return {k: to_dev(v) for k, v in tree.items()}
        if isinstance(tree, list):
            return [to_dev(v) for v in tree]
        if isinstance(tree, torch.Tensor):
            return tree.detach().to(device).clone().requires_grad_(True)
        return tree
    return to_dev(g), to_dev(_tree(flat_d, skeleton_d))


def changes(state, keyed_leaves, init: Dict[str, torch.Tensor]
            ) -> Dict[str, float]:
    """Per leaf, the norm of the parameters' change from ``init``."""
    out = {}
    for net, tree in (("g", state.params_g), ("d", state.params_d)):
        for name, p in keyed_leaves(tree):
            out[f"{net}{name}"] = float(torch.linalg.vector_norm(
                (p.detach() - init[f"{net}{name}"]).float()))
    return out


def first_grads(state, keyed_leaves, beta1: float) -> Dict[str, float]:
    """Per leaf, the norm of the first gradient as AdamW got it: its first
    moment after one step over (1 - beta1); 0 for a leaf it never
    stepped."""
    out = {}
    for net, tree, opt in (("g", state.params_g, state.opt_g),
                           ("d", state.params_d, state.opt_d)):
        for name, p in keyed_leaves(tree):
            m = opt.state.get(p, {}).get("exp_avg")
            out[f"{net}{name}"] = 0.0 if m is None else float(
                torch.linalg.vector_norm(m.float())) / (1.0 - beta1)
    return out


def leaf_gaps(got: Dict[str, float], want: Dict[str, float],
              keep) -> Dict[str, float]:
    """Per leaf, the gap of its norm from the reference's, over the
    reference's norm of that leaf or of the median leaf, the larger."""
    med = statistics.median(want[k] for k in keep)
    return {k: abs(got[k] - want[k]) / max(want[k], med) for k in keep}


def worst_leaf(got: Dict[str, float], want: Dict[str, float],
               keep) -> float:
    """The largest of ``leaf_gaps``."""
    return max(leaf_gaps(got, want, keep).values())


def prepare(cfg: dict, mix: dict, seed: int, tmp: Path, device):
    """The corpus under ``tmp`` and both networks' weights from the seed:
    (the corpus's rows, the generator's and the discriminator's flat
    weights, the discriminator's layout)."""
    rows = write_corpus(cfg, mix, seed, tmp, device)
    skeleton_d = ref_disc.init_multi_period_discriminator(
        torch.Generator().manual_seed(0),
        periods=tuple(mix["train"]["disc_periods"]))
    flat_g = weights.make(weights.layout(
        cfg, vits_init=mix["train"]["vits_init"]), seed, device)
    flat_d = weights.make(disc_layout(skeleton_d), seed + 1, device)
    return rows, flat_g, flat_d, skeleton_d


def run(cell, seed: int, seconds: float, trace: bool, device, t0: float,
        log) -> dict:
    cfg, mix = cell.config, cell.traffic
    tmp = Path(tempfile.mkdtemp(prefix="bench-corpus-"))
    try:
        return _run(cell, cfg, mix, seed, seconds, trace, device, t0, log,
                    tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _run(cell, cfg, mix, seed, seconds, trace, device, t0, log, tmp):
    from phoonnx_tpu_torch.infer.engine import resolve_device
    from phoonnx_tpu_torch.models.vits.load import params_from_flat
    from phoonnx_tpu_torch.train import step as prog_step
    from phoonnx_tpu_torch.train.dataset import BucketedLoader, load_dataset

    # the program's float32 contract, as its trainer sets it: no TF32 in
    # cuBLAS or cuDNN (PyTorch's default lets cuDNN use it)
    device = resolve_device(device)
    _, flat_g, flat_d, skeleton_d = prepare(cfg, mix, seed, tmp, device)
    hp = serve.hparams(cfg)
    tc = mix["train"]
    pcfg = prog_step.TrainConfig(disc_periods=tuple(tc["disc_periods"]))
    params_g, params_d = make_trees(cfg, flat_g, flat_d, skeleton_d,
                                    params_from_flat, device)
    state = prog_step.TrainState(
        params_g, params_d,
        prog_step.make_optimizer(pcfg, prog_step.leaves(params_g)),
        prog_step.make_optimizer(pcfg, prog_step.leaves(params_d)))
    loader = BucketedLoader(
        load_dataset([tmp / "dataset.jsonl"]), tc["batch_size"],
        hp.segment_size, hp.hop_length, seed=seed,
        spec_channels=hp.spec_channels)
    init = {f"g{k}": v.detach().clone()
            for k, v in prog_step.keyed_leaves(params_g)}
    init.update({f"d{k}": v.detach().clone()
                 for k, v in prog_step.keyed_leaves(params_d)})
    spans = Spans()

    def steps(epoch: int):
        """(batch, metrics) of each step of an epoch, timed while on."""
        it = loader.epoch(prefetch=2, epoch_index=epoch)
        try:
            while True:
                t_wait = time.monotonic()
                batch = next(it, None)
                if spans.on:
                    spans.calls["data"].append((t_wait, time.monotonic()))
                if batch is None:
                    return
                t_step = time.monotonic()
                gen = step_generator(device, seed, state.step)
                _, metrics = prog_step.train_step(
                    state, prog_step.batch_to_device(batch, device), hp,
                    pcfg, generator=gen)
                if spans.on:
                    spans.calls["step"].append((t_step, time.monotonic()))
                yield batch, metrics
        finally:
            it.close()  # stops the loader's prefetch thread

    # the first epoch, unmeasured; the reference follows its first steps
    n_check = tc["checked_steps"]
    losses, grads1, change = [], None, None
    for i, (_, m) in enumerate(steps(0)):
        if i < n_check:
            losses.append([float(m["loss_gen_all"]),
                           float(m["loss_disc_all"])])
        if i == 0:
            grads1 = first_grads(state, prog_step.keyed_leaves,
                                 pcfg.betas[0])
        if i == n_check - 1:
            change = changes(state, prog_step.keyed_leaves, init)
    del init
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    log(f"warm-up epoch: {len(loader)} steps of {tc['batch_size']}")

    tracer = Tracer(device) if trace else None
    if tracer:
        tracer.start()
    setup_s = time.perf_counter() - t0
    done_rows, step_losses = [], []
    epoch = 1
    window = tracer.window() if tracer else None
    spans.on = True
    start = time.monotonic()
    end = start + seconds
    if window:
        window.__enter__()
    while time.monotonic() < end:
        for batch, m in steps(epoch):
            done_rows += [(int(n), int(f)) for n, f in zip(
                batch["phoneme_lengths"], batch["spec_lengths"])]
            step_losses.append(m["loss_gen_all"].detach())
            if time.monotonic() >= end:
                break
        epoch += 1
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    stop = time.monotonic()
    spans.on = False
    if window:
        window.__exit__(None, None, None)
        tracer.stop()
    window_s = stop - start
    timeline = tracer.read(spans.all()) if tracer else None
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    failed = int((~torch.isfinite(torch.stack(step_losses))).sum()) \
        if step_losses else 0
    audio_s = sum(f for _, f in done_rows) * hp.hop_length / hp.sample_rate
    log(f"window: {len(step_losses)} steps of {tc['batch_size']} in "
        f"{window_s!r} s, {audio_s!r} s of audio, {failed} non-finite losses")
    waits = [b - a for a, b in spans.calls["data"] if start <= a < stop]
    out = {"attempted": len(step_losses), "failed": failed,
           "setup_s": setup_s, "memory_peak_bytes": peak,
           "train_audio_s_per_s": audio_s / window_s, "timeline": timeline,
           "counters": {"rows": done_rows, "window_s": window_s,
                        "data_wait_ms": [w * 1e3 for w in waits],
                        "disc_periods": pcfg.disc_periods}}

    # free the program before the reference runs on the card
    del state, params_g, params_d, loader
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    want = reference_steps(cfg, mix, seed, tmp, flat_g, flat_d, skeleton_d,
                           device, n_check)
    out["checks"] = judge(cfg, losses, grads1, change, want, log)
    # the raw readings, for the tools that set the limits
    out["readings"] = {"program": {"losses": losses, "grads1": grads1,
                                   "change": change}, "reference": want}
    return out


def reference_steps(cfg, mix, seed, tmp, flat_g, flat_d, skeleton_d, device,
                    n_check: int, allow_tf32: bool = False) -> dict:
    """The reference's first ``n_check`` steps from the same weights,
    batches and draws: its losses, first gradients and change."""
    from reference.vits import precision

    tc = mix["train"]
    hp = serve.hparams(cfg)
    rcfg = ref_step.TrainConfig()
    with precision(allow_tf32):
        params_g, params_d = make_trees(cfg, flat_g, flat_d, skeleton_d,
                                        ref_load.params_from_flat, device)
        state = ref_step.TrainState(
            params_g, params_d,
            ref_step.make_optimizer(rcfg, ref_step.leaves(params_g)),
            ref_step.make_optimizer(rcfg, ref_step.leaves(params_d)))
        loader = ref_data.BucketedLoader(
            ref_data.load_dataset([tmp / "dataset.jsonl"]),
            tc["batch_size"], hp.segment_size, hp.hop_length, seed=seed,
            spec_channels=hp.spec_channels)
        init = {f"g{k}": v.detach().clone()
                for k, v in ref_step.keyed_leaves(params_g)}
        init.update({f"d{k}": v.detach().clone()
                     for k, v in ref_step.keyed_leaves(params_d)})
        losses, grads1, change = [], None, None
        for i, batch in enumerate(loader.epoch(epoch_index=0)):
            if i == n_check:
                break
            m = ref_step.train_step(
                state, ref_step.batch_to_device(batch, device), hp, rcfg,
                step_generator(device, seed, i))
            losses.append([m["loss_gen_all"], m["loss_disc_all"]])
            if i == 0:
                grads1 = first_grads(state, ref_step.keyed_leaves,
                                     rcfg.betas[0])
        change = changes(state, ref_step.keyed_leaves, init)
    return {"losses": losses, "grads1": grads1, "change": change}


def compare(losses, grads1, change, want) -> Dict[str, float]:
    """The three numbers a training run is held to (``loss_gap``,
    ``grad1_gap``, ``median_change_gap``), and the worst leaf's change,
    which is logged and not held to a limit."""
    loss_gap = max(abs(a - b) / abs(b) for got, ref in zip(losses,
                                                           want["losses"])
                   for a, b in zip(got, ref))
    # leaves whose first gradient is nought in the reference (exactly 0
    # behind VITS's zero-initialised projections, or under a thousandth of
    # the median of the others) move by round-off alone: left out
    med = statistics.median(v for v in want["grads1"].values() if v > 0)
    keep = [k for k, v in want["grads1"].items() if v >= NEGLIGIBLE * med]
    # the change is held by the median leaf: a few leaves whose gradient is
    # mostly round-off yet above that share (the attention keys' biases,
    # the spline flows' projections) take AdamW's full step in a sign the
    # rounding picks, so the worst leaf's change swings from run to run
    moved = leaf_gaps(change, want["change"], keep)
    return {"loss_gap": loss_gap,
            "grad1_gap": worst_leaf(grads1, want["grads1"], keep),
            "median_change_gap": statistics.median_high(moved.values()),
            "worst_change_gap": max(moved.values()),
            "leaves_left_out": len(want["grads1"]) - len(keep),
            "keep": keep}


def worst_leaves(got: Dict[str, float], want: Dict[str, float], keep, n=3):
    gaps = leaf_gaps(got, want, keep)
    return [(k, gaps[k], got[k], want[k])
            for k in sorted(gaps, key=gaps.get, reverse=True)[:n]]


def judge(cfg, losses, grads1, change, want, log) -> dict:
    got = compare(losses, grads1, change, want)
    keep = got["keep"]
    log(f"worst leaves (name, gap, program, reference): first gradient "
        f"{worst_leaves(grads1, want['grads1'], keep)}; change "
        f"{worst_leaves(change, want['change'], keep)}")
    log(f"against the reference's first {len(losses)} steps: losses "
        f"{losses} vs {want['losses']}; worst leaf: first gradient "
        f"{got['grad1_gap']!r}, change {got['worst_change_gap']!r} "
        f"(median leaf {got['median_change_gap']!r}; "
        f"{got['leaves_left_out']} leaves with a negligible gradient "
        f"left out)")
    limits = cfg["limits"]
    return {k: {"value": got[k], "limit": limits[k]}
            for k in ("loss_gap", "grad1_gap", "median_change_gap")}
