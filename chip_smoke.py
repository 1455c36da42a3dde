#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (phoonnx_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--seed N] [--profile]

Run from the root of a checkout on a machine with an NVIDIA H100 (or
another sm_90a card) and the CUDA toolkit. The script

1. prints the card's name and power limit, turns TF32 off and builds every
   CUDA kernel of the port from ``phoonnx_tpu_torch/csrc`` (one ``nvcc``
   per source, all started together);
2. holds each kernel against its plain PyTorch version on the card at the
   shapes of its path (medium synthesis for A, B and C, and A on a ragged
   pair of 1024 and 700 ids; a medium training batch of 16 for D) and
   times both (median of CUDA-event timings after warm-up, over varied
   inputs), beside the kernel's bound: the larger of its float32
   operations over the card's SIMT peak and its bytes over the memory
   rate; counts, with torch.profiler, the device kernels inside one call
   of A and of B (each is one cooperative launch), and prints their time
   by phase with the cost of one grid barrier;
3. serving: writes a medium voice (random weights from ``--seed``) with
   the port's ONNX writer, loads it with ``TTSVoice.load`` on the default
   device and answers three single requests and one ragged batch of four,
   checking finite audio of ``frames * 256`` samples, that the batch
   equals the single decodes on each utterance's span, that kernels A, B
   and C were launched on that path, and that the path agrees with the
   plain PyTorch versions run on the host's CPU;
4. training: writes a synthetic LJSpeech-style dataset (per-phoneme tones,
   1.5 to 8 s, spectrograms from the port's STFT) and runs
   ``run_training(quality="medium", batch_size=16, max_epochs=1)`` on the
   card, printing each step's time, losses and kernel D time, checking
   finite losses, changed parameters, that kernel D was launched and A, B,
   C were not, and that the checkpoint restores to equal tensors; then
   the micro overfit recipe of the JAX package's tests (250 steps on two
   learnable utterances) held to that test's margins;
5. prints one ``{"kernels": [...]}`` line and, last, one
   ``{"ok": true, "device": {...}}`` line.

It exits non-zero, with no result line, when there is no CUDA device, when
the port is not beside it, or when any check fails.
"""

import argparse
import json
import math
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent

# NVIDIA H100 SXM data sheet (dense, no sparsity): float32 outside the
# tensor cores, and HBM3 bandwidth.
PEAK_F32_FLOPS = 67e12
PEAK_BYTES = 3.35e12

# max-abs difference allowed between a kernel and its plain version: both
# are float32 (TF32 off) and sum in other orders; a wrong op shows as 1e-2+.
KERNEL_TOL = 1e-4
# batch vs single decode of one utterance, both through the kernels
BATCH_TOL = 1e-4
# whole path (encoder -> flow -> decoder) through the kernels against the
# plain versions, on the valid span of the waveform (ARCHITECTURE.md:86-89)
PATH_TOL = 1e-3

NO_LIBRARY = ("no single PyTorch call computes this function (it is a chain "
              "of convs, products and masks)")
NO_LIBRARY_MAS = ("no single PyTorch call computes this function (a max-plus "
                  "dynamic program over the frames and its backtrack)")

# the medium training shape of kernel D: batch 16, spec frames padded to a
# multiple of 64, phonemes to a multiple of 32 (train/dataset.py)
MAS_SHAPE = (16, 832, 320)


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    if out.returncode != 0:
        fail(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# timing and bounds
# ---------------------------------------------------------------------------


WARMUP, REPS = 3, 15


def median_ms(torch, fn, inputs) -> float:
    """Median CUDA-event time of fn over a cycle of distinct inputs."""
    for i in range(WARMUP):
        fn(*inputs[i % len(inputs)])
    torch.cuda.synchronize()
    times = []
    for i in range(REPS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        args = inputs[i % len(inputs)]
        start.record()
        fn(*args)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def bound(flops: float, nbytes: float):
    t_ops = flops / PEAK_F32_FLOPS * 1e3
    t_mem = nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_mem else (t_mem, "bytes")


def tensor_bytes(tree) -> int:
    import torch

    if isinstance(tree, torch.Tensor):
        return tree.numel() * tree.element_size()
    if isinstance(tree, dict):
        return sum(tensor_bytes(v) for k, v in tree.items()
                   if k not in ("plain", "blocks", "post_weight"))
    if isinstance(tree, (list, tuple)):
        return sum(tensor_bytes(v) for v in tree)
    return 0


def encoder_flops(spec, lengths, hidden, filt) -> float:
    heads, dk = spec["n_heads"], spec["dk"]
    nrel, k = 2 * spec["window"] + 1, spec["ffn_k"]
    per_layer = 0.0
    for n in lengths:
        per_layer += 2 * n * hidden * 3 * hidden + 2 * n * hidden * hidden
        per_layer += heads * (2 * 2 * n * n * dk + 2 * 2 * n * nrel * dk)
        per_layer += 2 * 2 * n * k * hidden * filt
    return per_layer * spec["n_layers"]


def flow_flops(spec, lengths) -> float:
    half, hid, k = spec["half"], spec["hidden"], spec["kernel_size"]
    layers = spec["n_layers"]
    rows = float(sum(lengths))
    per_flow = 2 * rows * half * hid * 2  # pre and post
    per_flow += layers * 2 * rows * k * hid * 2 * hid
    per_flow += (layers - 1) * 2 * rows * hid * 2 * hid + 2 * rows * hid * hid
    return per_flow * spec["n_flows"]


def stage_flops(spec, valid, channels) -> float:
    rows = float(sum(valid))
    flops = 2 * rows * spec["W"].shape[0] * channels * channels
    if "postW" in spec:
        flops += 2 * rows * spec["postW"].shape[0] * channels
    return flops


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------


def kernel_phases(torch, params, flow_g_params, seed, dev):
    """Each kernel against its plain version at the medium shapes."""
    from phoonnx_tpu_torch.models.vits import (fused_encoder, fused_flow,
                                               fused_stage)

    gen = torch.Generator(device=dev).manual_seed(seed)
    results = {}

    def mask_of(lengths, t):
        pos = torch.arange(t, device=dev)[None, :]
        lens = torch.tensor(lengths, device=dev)[:, None]
        return (pos < lens)[..., None].float()

    def compare(name, kernel_fn, plain_fn, inputs, flops, nbytes, case):
        got = kernel_fn(*inputs[0])
        want = plain_fn(*inputs[0])
        torch.cuda.synchronize()
        check(got.shape == want.shape,
              f"{name} {case}: shape {tuple(got.shape)} vs "
              f"{tuple(want.shape)}")
        check(bool(torch.isfinite(got).all()), f"{name} {case}: non-finite")
        err = (got - want).abs().max().item()
        k_ms = median_ms(torch, kernel_fn, inputs)
        p_ms = median_ms(torch, plain_fn, inputs)
        b_ms, b_by = bound(flops, nbytes)
        print(f"kernel {name} {case}: max_abs_err={err:.3e} "
              f"kernel_ms={k_ms:.4f} plain_ms={p_ms:.4f} "
              f"bound_ms={b_ms:.5f} ({b_by}) flops={flops:.4e} "
              f"bytes={nbytes:.4e}", flush=True)
        check(err <= KERNEL_TOL,
              f"{name} {case}: kernel vs plain max-abs {err:.3e} > "
              f"{KERNEL_TOL}")
        return {"max_abs_err": err, "ms": k_ms, "plain_ms": p_ms,
                "bound_ms": b_ms, "bound_by": b_by, "flops": flops,
                "bytes": nbytes}

    # --- A: the text-encoder stack, T_x = 128, and a long ragged pair ---
    enc_spec = params["enc_p"]["encoder"]["fused"]
    hid = enc_spec["n_heads"] * enc_spec["dk"]
    filt = enc_spec["w_ffn1"].shape[-1]
    for lengths in ([128], [128, 97, 64, 33], [1024, 700]):
        t_x = max(lengths)
        mask = mask_of(lengths, t_x)
        inputs = [(torch.randn(len(lengths), t_x, hid, device=dev,
                               generator=gen) * mask, mask)
                  for _ in range(4)]
        nbytes = (2 * len(lengths) * t_x * hid * 4 + tensor_bytes(enc_spec)
                  + 4 * len(lengths))
        res = compare("A", lambda x, m: fused_encoder.apply(enc_spec, x, m),
                      lambda x, m: fused_encoder.plain(enc_spec, x, m),
                      inputs, encoder_flops(enc_spec, lengths, hid, filt),
                      nbytes, f"B={len(lengths)} T_x={t_x} lengths={lengths}")
        results.setdefault("A", res)
        if lengths == [128]:
            results["A"]["device_kernels"] = kernels_in_call(
                torch, lambda: fused_encoder.apply(enc_spec, *inputs[0]),
                "A", "encoder_persistent")
            phase_times(torch, fused_encoder, enc_spec, inputs[0], "A")

    # --- B: the inverse flow, T_y = 512, without and with g ---
    for spec, lengths, gin in ((params["flow"]["fused_rev"], [512], 0),
                               (flow_g_params["fused_rev"], [512, 300],
                                flow_g_params["gin"])):
        mask = mask_of(lengths, 512)
        c = 2 * spec["half"]
        inputs = []
        for _ in range(4):
            x = torch.randn(len(lengths), 512, c, device=dev,
                            generator=gen) * mask
            g = None if not gin else torch.randn(
                len(lengths), 1, gin, device=dev, generator=gen)
            inputs.append((x, mask, g))
        nbytes = (2 * len(lengths) * 512 * c * 4 + tensor_bytes(spec)
                  + (len(lengths) * gin * 4))
        res = compare("B",
                      lambda x, m, g, s=spec: fused_flow.apply(s, x, m, g=g),
                      lambda x, m, g, s=spec: fused_flow.plain(s, x, m, g=g),
                      inputs, flow_flops(spec, lengths), nbytes,
                      f"B={len(lengths)} T_y=512 g={'yes' if gin else 'no'}")
        results.setdefault("B", res)
        if not gin:
            results["B"]["device_kernels"] = kernels_in_call(
                torch, lambda s=spec: fused_flow.apply(s, *inputs[0]), "B",
                "flow_persistent")
            phase_times(torch, fused_flow, spec, inputs[0], "B")

    # --- C: the three decoder stages at 512 frames, last with its tail ---
    frames = 512
    stages = params["dec"]["fused_stages"]
    rates = params["dec"]["upsample_rates"]
    for batch_frames in ([frames], [512, 400, 256, 130]):
        total = None
        cum = 1
        for i, spec in enumerate(stages):
            cum *= rates[i]
            ch = spec["W"].shape[1]
            t = frames * cum
            valid = [n * cum for n in batch_frames]
            vt = torch.tensor(valid, dtype=torch.int32, device=dev)
            inputs = [(torch.randn(len(valid), t, ch, device=dev,
                                   generator=gen) * 0.5, vt)
                      for _ in range(3)]
            out_ch = 1 if "postW" in spec else ch
            nbytes = (len(valid) * t * (ch + out_ch) * 4 + tensor_bytes(spec)
                      + 4 * len(valid))
            res = compare(
                "C", lambda x, v, s=spec: fused_stage.apply_group(s, x, v),
                lambda x, v, s=spec: fused_stage.plain(s, x, v), inputs,
                stage_flops(spec, valid, ch), nbytes,
                f"stage {i} B={len(valid)} [{t}, {ch}] valid={valid}"
                + (" +post" if "postW" in spec else ""))
            if total is None:
                total = dict(res)
            else:
                total["max_abs_err"] = max(total["max_abs_err"],
                                           res["max_abs_err"])
                for key in ("ms", "plain_ms", "flops", "bytes"):
                    total[key] += res[key]
        if "C" not in results:
            # the three stage launches of one 512-frame request
            total["bound_ms"], total["bound_by"] = bound(total["flops"],
                                                         total["bytes"])
            results["C"] = total
    return results


def write_voice(torch, params, hp, out_dir: Path):
    from phoonnx_tpu_torch.models.vits.load import params_to_flat
    from phoonnx_tpu_torch.onnx.writer import write_onnx

    out_dir.mkdir(parents=True, exist_ok=True)
    model_path = out_dir / "medium.onnx"
    write_onnx(str(model_path), params_to_flat(params),
               metadata={"model_type": "vits",
                         "sample_rate": str(hp.sample_rate)},
               inputs=["input", "input_lengths", "scales"],
               outputs=["output"])
    letters = "abcdefghijklmnopqrstuvwxyz"
    id_map = {"_": 0, "^": 1, "$": 2, " ": 3}
    id_map.update({c: i + 4 for i, c in enumerate(letters)})
    config = {
        "phoneme_type": "raw", "lang_code": "en", "alphabet": "ipa",
        "phoneme_id_map": id_map, "num_symbols": len(id_map),
        "num_speakers": 1, "audio": {"sample_rate": hp.sample_rate},
        "inference": {"noise_scale": 0.667, "length_scale": 1.0,
                      "noise_w": 0.8},
    }
    config_path = out_dir / "medium.onnx.json"
    config_path.write_text(json.dumps(config), encoding="utf-8")
    return model_path, config_path


def text_of(n_letters: int, offset: int) -> str:
    """A RAW-phoneme 'sentence': letters in words of 5, no punctuation."""
    letters = "abcdefghijklmnopqrstuvwxyz"
    chars = [letters[(offset + 7 * i) % 26] for i in range(n_letters)]
    words = ["".join(chars[i:i + 5]) for i in range(0, n_letters, 5)]
    return " ".join(words)


def main_path(torch, model_path, config_path, seed):
    """The port's serving path as a user drives it, on the default device."""
    from phoonnx_tpu_torch import SynthesisConfig, TTSVoice
    from phoonnx_tpu_torch.models.vits import (fused_encoder, fused_flow,
                                               fused_stage)

    kernels = {"A": fused_encoder, "B": fused_flow, "C": fused_stage}
    for mod in kernels.values():
        mod.launches = 0

    t0 = time.perf_counter()
    voice = TTSVoice.load(str(model_path), str(config_path))
    print(f"main: TTSVoice.load {time.perf_counter() - t0:.3f} s on "
          f"{voice.engine.device}", flush=True)
    check(voice.engine.device.type == "cuda", "the voice is not on the GPU")
    hop = voice.engine.hp.total_upsample
    check(hop == 256, f"total upsample {hop} != 256")

    def cfg(s):
        return SynthesisConfig(seed=s, normalize_audio=False)

    def ids_of(text):  # one sentence of RAW phonemes -> ids
        return voice.phonemes_to_ids(voice.phonemize(text)[0])

    requests = []
    for target, offset in ((30, 1), (100, 2), (250, 3)):
        text = text_of(max(4, target * 2 // 5), offset)
        ids = len(ids_of(text))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        chunks = list(voice.synthesize(text, cfg(seed + target)))
        ms = (time.perf_counter() - t0) * 1e3
        check(len(chunks) == 1, f"{len(chunks)} chunks for one sentence")
        audio = chunks[0].audio_float_array
        check(audio.dtype.name == "float32", "audio is not float32")
        check(len(audio) > 0 and len(audio) % hop == 0,
              f"audio length {len(audio)} is not frames x {hop}")
        check(bool(torch.isfinite(torch.from_numpy(audio)).all()),
              "non-finite audio")
        frames = len(audio) // hop
        print(f"main: single request ids={ids} frames={frames} "
              f"samples={len(audio)} ms={ms:.3f}", flush=True)
        requests.append({"ids": ids, "frames": frames, "ms": ms})

    texts = [text_of(n, 5 + i) for i, n in enumerate((60, 20, 41, 9))]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    outs = voice.synthesize_batch(texts, cfg(seed))
    batch_ms = (time.perf_counter() - t0) * 1e3
    worst = 0.0
    for i, (text, out) in enumerate(zip(texts, outs)):
        check(len(out) > 0 and len(out) % hop == 0,
              f"batch member {i}: length {len(out)} is not frames x {hop}")
        ids = ids_of(text)
        single = voice.phoneme_ids_to_audio(ids, cfg(seed + i))
        check(len(single) == len(out),
              f"batch member {i}: {len(out)} samples vs {len(single)} alone")
        err = float(abs(single - out).max())
        worst = max(worst, err)
        print(f"main: batch member {i} ids={len(ids)} "
              f"frames={len(out) // hop} max_abs_vs_single={err:.3e}",
              flush=True)
    print(f"main: batch of {len(texts)} ms={batch_ms:.3f} "
          f"max_abs_vs_single={worst:.3e}", flush=True)
    # the engine's own frame counts against the voice's trimmed audio
    padded, frames = voice.engine.synthesize_batch(
        [ids_of(t) for t in texts], seed=seed)
    check(padded.shape == (len(texts), max(frames) * hop),
          f"padded batch shape {padded.shape} vs frames {frames}")
    check([len(o) for o in outs] == [n * hop for n in frames],
          f"trimmed lengths {[len(o) for o in outs]} vs frames {frames}")
    check(worst <= BATCH_TOL,
          f"padded batch differs from single decodes by {worst:.3e}")

    launches = {k: mod.launches for k, mod in kernels.items()}
    print(f"main: launches {launches}", flush=True)
    for name, n in launches.items():
        check(n > 0, f"kernel {name} was not launched on the main path")
    return voice, launches, requests


def path_vs_plain(torch, voice, seed):
    """One ragged batch through model.infer's two phases with the kernels
    on the card, and on the same noise through the plain versions on the
    host's CPU (the parameters without kernel specs, as the model code runs
    them there)."""
    from phoonnx_tpu_torch.models.vits import model as vits_model

    engine = voice.engine
    hp = engine.hp
    dev = engine.device
    cpu = torch.device("cpu")
    plain = dict(engine.params)
    plain["enc_p"] = dict(plain["enc_p"], encoder={
        k: v for k, v in plain["enc_p"]["encoder"].items() if k != "fused"})
    plain["flow"] = {k: v for k, v in plain["flow"].items()
                     if k != "fused_rev"}
    plain["dec"] = {k: v for k, v in plain["dec"].items()
                    if k != "fused_stages"}
    plain = vits_model.params_to_device(plain, cpu)
    gen = torch.Generator().manual_seed(seed)
    lengths = [101, 64]
    ids = torch.randint(4, 30, (2, 101), generator=gen)
    lens = torch.tensor(lengths, dtype=torch.int32)
    dp_noise = torch.randn(2, 101, 2, generator=gen)
    with torch.inference_mode():
        outs = []
        for p, d in ((engine.params, dev), (plain, cpu)):
            outs.append(vits_model.infer_durations(
                p, hp, ids.to(d), lens.to(d), 1.0, 0.8,
                dp_noise=dp_noise.to(d)))
        (m_k, l_k, w_k, mask_k, _), (m_p, l_p, _, _, _) = outs
        enc_err = max((m_k.cpu() - m_p).abs().max().item(),
                      (l_k.cpu() - l_p).abs().max().item())
        frames = int(torch.clamp(w_k.sum(-1), min=1).max().item())
        frames = min(frames, 4096)
        prior = torch.randn(2, frames, hp.inter_channels, generator=gen)
        audio = []
        for p, d in ((engine.params, dev), (plain, cpu)):
            audio.append(vits_model.infer_decode(
                p, hp, m_k.to(d), l_k.to(d), w_k.to(d), mask_k.to(d),
                frames, 0.667, prior_noise=prior.to(d)))
        torch.cuda.synchronize()
    (a_k, y_k), (a_p, y_p) = audio
    a_k, y_k = a_k.cpu(), y_k.cpu()
    check(bool((y_k == y_p).all()), "frame counts differ")
    wave_err = 0.0
    for i, n in enumerate(y_k.tolist()):
        span = n * hp.total_upsample
        wave_err = max(wave_err,
                       (a_k[i, :span] - a_p[i, :span]).abs().max().item())
    print(f"path: kernels on the card vs plain versions on the CPU: prior "
          f"stats max_abs={enc_err:.3e}, waveform max_abs on the valid "
          f"span={wave_err:.3e} (frames {y_k.tolist()})", flush=True)
    check(enc_err <= KERNEL_TOL, f"encoder path differs by {enc_err:.3e}")
    check(wave_err <= PATH_TOL, f"waveform differs by {wave_err:.3e}")


def kernels_in_call(torch, fn, label, kernel_name):
    """The device work torch.profiler sees inside one call of fn: print
    each kernel, memcpy and memset by name and count, and check that the
    port's kernel ran exactly once with no copy or fill on the device.
    Returns the number of device operations."""
    from collections import Counter

    from torch.profiler import ProfilerActivity, profile

    fn()  # warm: the first call loads the library
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    names = Counter(evt.name for evt in prof.events()
                    if str(evt.device_type).endswith("CUDA")
                    and not getattr(evt, "is_user_annotation", False))
    total = sum(names.values())
    own = sum(n for name, n in names.items() if kernel_name in name)
    copies = sum(n for name, n in names.items()
                 if name.startswith(("Memcpy", "Memset")))
    print(f"profile: kernel {label}, one call: {total} device operations, "
          f"{own} of them {kernel_name}, {copies} memcpy/memset: "
          + "; ".join(f"{n} x {name[:70]}" for name, n in names.items()),
          flush=True)
    check(own == 1, f"kernel {label}: {own} launches of {kernel_name} in "
          f"one call ({total} device operations seen)")
    check(copies == 0, f"kernel {label}: {copies} memcpy/memset in one call")
    return total


def phase_times(torch, module, spec, args, label, reps=5):
    """Device time of each phase inside one launch of a persistent kernel
    (A or B), from the device clock its block 0 reads after each grid
    barrier (median over reps launches), summed by kind of phase; and the
    cost of one grid barrier of the same grid, from a kernel of barriers
    alone."""
    from phoonnx_tpu_torch import cuda as port_cuda
    from phoonnx_tpu_torch import tiling

    names = module.phases(spec)
    stamps = torch.zeros(len(names) + 1, dtype=torch.int64, device="cuda")
    runs = []
    for _ in range(reps + 1):
        module.launch(spec, *args, stamps=stamps)
        torch.cuda.synchronize()
        runs.append(stamps.diff().cpu().tolist())
    per_phase = [statistics.median(r[i] for r in runs[1:]) / 1e6
                 for i in range(len(names))]
    kinds = {}
    for name, ms in zip(names, per_phase):
        kind = name.split(" ")[0]
        kinds[kind] = kinds.get(kind, 0.0) + ms
    query = (("fused_encoder_occupancy", args[0].shape[1], spec["dk"],
              spec["window"]) if module.LIBRARY == "fused_encoder"
             else ("fused_flow_occupancy",))
    grid = tiling.grid_size(*port_cuda.occupancy(module.LIBRARY, *query))
    probe = port_cuda.function(module.LIBRARY, "phx_barrier_probe",
                               [port_cuda.c_int, port_cuda.c_int,
                                port_cuda.c_ptr])
    stream = torch.cuda.current_stream().cuda_stream
    n = 1000
    port_cuda.check(module.LIBRARY, probe(n, grid, stream), "barrier probe")
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    port_cuda.check(module.LIBRARY, probe(n, grid, stream), "barrier probe")
    end.record()
    end.synchronize()
    barrier_us = start.elapsed_time(end) * 1e3 / n
    print(f"phases: kernel {label}: {len(names)} phases, {sum(per_phase):.4f} "
          f"ms from the first block's start to the last barrier, grid "
          f"{grid} blocks; one grid barrier {barrier_us:.3f} us alone; by "
          "kind: " + ", ".join(f"{k} {v:.4f} ms" for k, v in kinds.items()),
          flush=True)
    return {"phases_ms": kinds, "barrier_us": barrier_us, "grid": grid}


def device_profile(torch, fn, label, top=20):
    """Run fn once under torch.profiler; print its wall time, the device's
    busy time and idle share, and the device time of the top kernels.
    Returns (wall_us, busy_us, rows of (device_us, count, name))."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    rows = []
    for evt in prof.key_averages():
        # device-side kernels only: an aten op's entry, or a user
        # annotation's range on the device (Optimizer.step), repeats the
        # device time of the kernels inside it
        if (not str(evt.device_type).endswith("CUDA")
                or getattr(evt, "is_user_annotation", False)):
            continue
        dev_us = getattr(evt, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(evt, "self_cuda_time_total", 0.0)
        if dev_us > 0:
            rows.append((dev_us, evt.count, evt.key))
    rows.sort(reverse=True)
    busy_us = sum(r[0] for r in rows)
    print(f"profile: {label}: wall {wall_us / 1e3:.3f} ms, device busy "
          f"{busy_us / 1e3:.3f} ms, idle share {1 - busy_us / wall_us:.3f}",
          flush=True)
    if not rows:
        print("profile: the profiler recorded no device time", flush=True)
    for dev_us, count, key in rows[:top]:
        print(f"profile: {dev_us / 1e3:9.4f} ms  x{count:<5d} {key[:110]}",
              flush=True)
    return wall_us, busy_us, rows


def profile_request(torch, voice, seed):
    """Device time by kernel over one ~250-id request, and the device's
    idle share of the request's wall time."""
    from phoonnx_tpu_torch import SynthesisConfig

    text = text_of(100, 3)
    cfg = SynthesisConfig(seed=seed, normalize_audio=False)
    list(voice.synthesize(text, cfg))  # warm
    n_ids = len(voice.phonemes_to_ids(voice.phonemize(text)[0]))
    device_profile(torch, lambda: list(voice.synthesize(text, cfg)),
                   f"one request of {n_ids} ids")


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------


def tone_audio(ids, frames_per_id: int, hop: int, sr: int) -> np.ndarray:
    """Each phoneme id a fixed two-harmonic tone of ``frames_per_id``
    frames, concatenated (the recipe of tests/test_overfit_tiny.py:59)."""
    n = len(ids) * frames_per_id * hop
    t = np.arange(n) / sr
    audio = np.zeros(n, np.float32)
    for k, pid in enumerate(ids):
        s, e = k * frames_per_id * hop, (k + 1) * frames_per_id * hop
        f0 = 100.0 + 40.0 * pid
        audio[s:e] = (0.35 * np.sin(2 * np.pi * f0 * t[s:e])
                      + 0.15 * np.sin(2 * np.pi * 2 * f0 * t[s:e]))
    return audio


def write_dataset(torch, out_dir: Path, hp, n_utts: int, seed: int,
                  seconds=(1.5, 8.0), n_symbols: int = 40) -> Path:
    """A synthetic LJSpeech-style dataset dir: ``config.json``,
    ``dataset.jsonl`` and per-utterance ``.npy`` audio and channel-last
    spectrograms (the port's STFT), utterances of per-phoneme tones with
    lengths drawn from ``seconds``."""
    from phoonnx_tpu_torch.ops import stft

    rng = np.random.default_rng(seed)
    if out_dir.exists():
        shutil.rmtree(out_dir)
    (out_dir / "cache").mkdir(parents=True)
    config = {"num_symbols": n_symbols, "num_speakers": 1,
              "audio": {"sample_rate": hp.sample_rate}}
    (out_dir / "config.json").write_text(json.dumps(config),
                                         encoding="utf-8")
    lines = []
    for i in range(n_utts):
        frames = int(rng.uniform(*seconds) * hp.sample_rate / hp.hop_length)
        frames_per_id = int(rng.integers(4, 9))
        ids = rng.integers(1, n_symbols, max(2, frames // frames_per_id))
        audio = tone_audio(ids, frames_per_id, hp.hop_length, hp.sample_rate)
        spec = stft.spectrogram(torch.from_numpy(audio)[None],
                                hp.filter_length, hp.hop_length,
                                hp.win_length)[0].numpy()
        audio_path = out_dir / "cache" / f"{i}.audio.npy"
        spec_path = out_dir / "cache" / f"{i}.spec.npy"
        np.save(audio_path, audio)
        np.save(spec_path, spec)
        lines.append(json.dumps({"phoneme_ids": [int(x) for x in ids],
                                 "audio_norm_path": str(audio_path),
                                 "audio_spec_path": str(spec_path)}))
    (out_dir / "dataset.jsonl").write_text("\n".join(lines) + "\n",
                                           encoding="utf-8")
    return out_dir


def mas_inputs(torch, dev, seed, variants=3):
    """Kernel D's inputs at the medium training shape: ragged lengths,
    one element with x_len > y_len, one with integer scores (ties)."""
    from phoonnx_tpu_torch.ops import mas

    b, t_y, t_x = MAS_SHAPE
    gen = torch.Generator(device=dev).manual_seed(seed)
    mask = torch.zeros(MAS_SHAPE, device=dev)
    for i in range(b):
        y, x = t_y - 37 * i, t_x - 17 * i
        if i == 3:
            y, x = 200, t_x  # more phonemes than frames
        mask[i, :y, :x] = 1
    inputs = []
    for _ in range(variants):
        neg_cent = torch.randn(MAS_SHAPE, device=dev, generator=gen) * 3
        neg_cent[1] = torch.round(neg_cent[1])
        inputs.append(mas.lengths_and_value(neg_cent, mask))
    return inputs


def mas_phase(torch, dev, seed):
    """Kernel D against its plain version, bit for bit, at [16, 832, 320]."""
    from phoonnx_tpu_torch.ops import mas

    inputs = mas_inputs(torch, dev, seed)
    for value, y_lens, x_lens in inputs:
        got = mas.launch(value, y_lens, x_lens)
        want = mas.maximum_path_plain(value, y_lens, x_lens)
        torch.cuda.synchronize()
        check(torch.equal(got, want), "kernel D differs from its plain "
              f"version in {int((got != want).sum())} cells")
        rows = got.sum(dim=2)
        check(bool(((rows == 1) | (rows == 0)).all()),
              "kernel D marked more than one phoneme in a frame")
    k_ms = median_ms(torch, mas.launch, inputs)
    p_ms = median_ms(torch, mas.maximum_path_plain, inputs)
    b, t_y, t_x = MAS_SHAPE
    flops = 2.0 * b * t_y * t_x  # an add and a max per cell, full grid
    nbytes = 2.0 * b * t_y * t_x * 4 + 2 * b * 4  # scores in, path out
    b_ms, b_by = bound(flops, nbytes)
    print(f"kernel D B={b} T_y={t_y} T_x={t_x}: torch.equal to plain, "
          f"max_abs_err=0 kernel_ms={k_ms:.4f} plain_ms={p_ms:.4f} "
          f"bound_ms={b_ms:.5f} ({b_by}) flops={flops:.4e} "
          f"bytes={nbytes:.4e}", flush=True)
    return {"max_abs_err": 0.0, "ms": k_ms, "plain_ms": p_ms,
            "bound_ms": b_ms, "bound_by": b_by}


def params_of(state):
    from phoonnx_tpu_torch.train import step

    return step.leaves(state.params_g) + step.leaves(state.params_d)


def training_phase(torch, root: Path, seed: int, profile: bool):
    """The port's training path as a user drives it: run_training on a
    synthetic dataset at the medium preset, batch 16, one epoch."""
    from phoonnx_tpu_torch.models.vits import (fused_encoder, fused_flow,
                                               fused_stage)
    from phoonnx_tpu_torch.models.vits.model import VitsHParams
    from phoonnx_tpu_torch.ops import mas
    from phoonnx_tpu_torch.train import checkpoint, step
    from phoonnx_tpu_torch.train.trainer import run_training

    hp = VitsHParams.preset("medium")
    t0 = time.perf_counter()
    data = write_dataset(torch, root / "build" / "chip_smoke" / "dataset",
                         hp, 40, seed)
    print(f"train: wrote 40 utterances in {time.perf_counter() - t0:.1f} s",
          flush=True)

    # kernel D's time inside each step, from CUDA events around its launch
    events = []
    launch = mas.launch

    def timed_launch(*args):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = launch(*args)
        end.record()
        events.append((start, end, tuple(args[0].shape)))
        return out

    mas.launch = timed_launch
    others = {"A": fused_encoder, "B": fused_flow, "C": fused_stage}
    try:
        for mod in (mas, *others.values()):
            mod.launches = 0
        t0 = time.perf_counter()
        run = run_training(str(data), quality="medium", batch_size=16,
                           max_epochs=1, seed=seed, log_every=1)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = mas.launches
        other_launches = {k: m.launches for k, m in others.items()}
    finally:
        mas.launch = launch
    print(f"train: run_training wall {wall:.3f} s, {len(run.steps)} steps, "
          f"kernel D launches {launches}, kernels A/B/C launches "
          f"{other_launches}", flush=True)
    check(launches > 0, "kernel D was not launched on the training path")
    check(not any(other_launches.values()),
          "the training path reached an inference kernel")
    check(len(run.steps) > 0, "no training step ran")
    check(len(events) == launches, "kernel D launches and timings disagree")

    mas_ms = [s.elapsed_time(e) for s, e, _ in events]
    for record, ms, (_, _, shape) in zip(run.steps, mas_ms, events):
        losses = " ".join(f"{k}={record[k]:.4f}" for k in step.METRICS)
        print(f"train: step {record['step']} ms={record['ms']:.3f} {losses} "
              f"kernel_D_ms={ms:.4f} mas_shape={list(shape)}", flush=True)
        check(all(math.isfinite(record[k]) for k in step.METRICS),
              f"non-finite loss at step {record['step']}")
    step_ms = [r["ms"] for r in run.steps]
    steady = step_ms[1:] or step_ms
    d_steady = mas_ms[1:len(step_ms)] or mas_ms[:1]
    print(f"train: step ms first={step_ms[0]:.3f} steady median="
          f"{statistics.median(steady):.3f}; kernel D median "
          f"{statistics.median(d_steady):.4f} ms = "
          f"{statistics.median(d_steady) / statistics.median(steady):.5f} "
          f"of a steady step; validation {run.val_losses}", flush=True)

    # the parameters moved away from the seed's initialisation
    cfg = step.TrainConfig()
    init = step.init_train_state(run.hp, cfg,
                                 torch.Generator().manual_seed(seed))
    moved = sum(not torch.equal(a.detach().cpu(), b.detach())
                for a, b in zip(params_of(run.state), params_of(init)))
    total = len(params_of(init))
    print(f"train: {moved} of {total} parameter tensors changed", flush=True)
    check(moved > total // 2, f"only {moved} of {total} parameters changed")

    # the checkpoint restores to equal tensors
    check(run.checkpoint is not None and Path(run.checkpoint).exists(),
          "no checkpoint written")
    fresh = step.init_train_state(run.hp, cfg,
                                  torch.Generator().manual_seed(seed + 1),
                                  device=torch.device("cuda"))
    checkpoint.restore(run.checkpoint, fresh)
    check(fresh.step == run.state.step, "restored step differs")
    for a, b in zip(params_of(run.state), params_of(fresh)):
        check(torch.equal(a, b), "a restored parameter differs")
    for opt_a, opt_b, tree_a, tree_b in (
            (run.state.opt_g, fresh.opt_g, run.state.params_g,
             fresh.params_g),
            (run.state.opt_d, fresh.opt_d, run.state.params_d,
             fresh.params_d)):
        for a, b in zip(step.leaves(tree_a), step.leaves(tree_b)):
            check(torch.equal(opt_a.state[a]["exp_avg_sq"],
                              opt_b.state[b]["exp_avg_sq"]),
                  "a restored optimizer moment differs")
    print(f"train: checkpoint {Path(run.checkpoint).name} restores "
          f"{total} parameter tensors and their moments equal", flush=True)

    if profile:
        profile_train_step(torch, run, data, seed)
    return launches, {"step_ms": step_ms, "mas_ms": mas_ms}


def profile_train_step(torch, run, data: Path, seed: int):
    """One more medium training step under the profiler: the card's idle
    share of the step and kernel D's share of its device time."""
    from phoonnx_tpu_torch.train.dataset import BucketedLoader, load_dataset
    from phoonnx_tpu_torch.train.step import (TrainConfig, batch_to_device,
                                              train_step)
    from phoonnx_tpu_torch.train.trainer import step_generator

    hp = run.hp
    utts = load_dataset([data / "dataset.jsonl"])
    loader = BucketedLoader(utts, batch_size=16,
                            segment_size_frames=hp.segment_size,
                            hop_length=hp.hop_length, seed=seed,
                            spec_channels=hp.spec_channels)
    batch = batch_to_device(next(iter(loader.epoch(epoch_index=0))), "cuda")
    cfg = TrainConfig()
    dev = torch.device("cuda")

    def one_step():
        train_step(run.state, batch, hp, cfg,
                   generator=step_generator(dev, seed, run.state.step))

    one_step()  # warm at this shape
    _, busy_us, rows = device_profile(
        torch, one_step,
        f"one medium training step, batch 16, spec {batch['spec'].shape[1]} "
        f"frames, {batch['phoneme_ids'].shape[1]} phonemes")
    d_us = sum(us for us, _, key in rows if "mas_kernel" in key)
    print(f"profile: kernel D {d_us / 1e3:.4f} ms = "
          f"{d_us / max(busy_us, 1e-9):.5f} of the step's device time",
          flush=True)


# the micro overfit recipe of tests/test_overfit_tiny.py, copied
OVERFIT_STEPS = 250


def learnable_batch(torch, hp, batch=2, t_x=12, t_y=48):
    """Two deterministic, learnable utterances: each phoneme id a fixed
    tone, the spectrogram the training STFT of that audio."""
    from phoonnx_tpu_torch.ops import stft

    rng = np.random.default_rng(3)
    ids = rng.integers(1, hp.n_vocab, (batch, t_x))
    audio = np.stack([tone_audio(row, t_y // t_x, hp.hop_length,
                                 hp.sample_rate) for row in ids])
    spec = stft.spectrogram(torch.from_numpy(audio), hp.filter_length,
                            hp.hop_length, hp.win_length)
    return {
        "phoneme_ids": ids.astype(np.int64),
        "phoneme_lengths": np.full((batch,), t_x, np.int32),
        "spec": spec[:, :t_y].numpy(),
        "spec_lengths": np.full((batch,), min(t_y, spec.shape[1]), np.int32),
        "audio": audio,
    }


def overfit_phase(torch, dev, seed: int):
    """250 steps on two learnable utterances (micro widths), held to the
    margins of tests/test_overfit_tiny.py:117-123."""
    from phoonnx_tpu_torch.models.vits.model import VitsHParams
    from phoonnx_tpu_torch.train.step import (TrainConfig, batch_to_device,
                                              init_train_state, train_step)
    from phoonnx_tpu_torch.train.trainer import step_generator

    hp = VitsHParams.preset("micro", n_vocab=40)
    cfg = TrainConfig(learning_rate=2e-4, steps_per_epoch=10 ** 6,
                      disc_periods=(2, 3), disc_channel_scale=4)
    state = init_train_state(hp, cfg, torch.Generator().manual_seed(seed),
                             device=dev)
    batch = batch_to_device(learnable_batch(torch, hp), dev)
    keys = ("loss_mel", "loss_gen_all", "loss_dur", "loss_disc_all")
    series = {k: [] for k in keys}
    t0 = time.perf_counter()
    for i in range(OVERFIT_STEPS):
        state, m = train_step(state, batch, hp, cfg,
                              generator=step_generator(dev, 7, i))
        for k, v in zip(keys, torch.stack([m[k] for k in keys]).tolist()):
            series[k].append(v)
        if i % 25 == 0 or i == OVERFIT_STEPS - 1:
            print(f"overfit: step {i} " + " ".join(
                f"{k}={series[k][-1]:.4f}" for k in keys), flush=True)
    wall = time.perf_counter() - t0
    for k in keys:
        check(all(math.isfinite(v) for v in series[k]),
              f"overfit: {k} went non-finite")
    first = {k: statistics.mean(series[k][:20]) for k in keys}
    last = {k: statistics.mean(series[k][-20:]) for k in keys}
    tail = series["loss_disc_all"][-50:]
    print(f"overfit: {OVERFIT_STEPS} steps in {wall:.1f} s; means of the "
          f"first/last 20 steps: mel {first['loss_mel']:.4f} -> "
          f"{last['loss_mel']:.4f}, gen_all {first['loss_gen_all']:.4f} -> "
          f"{last['loss_gen_all']:.4f}, dur {first['loss_dur']:.4f} -> "
          f"{last['loss_dur']:.4f}; disc over the last 50 in "
          f"[{min(tail):.4f}, {max(tail):.4f}]", flush=True)
    check(last["loss_mel"] < 0.65 * first["loss_mel"],
          "overfit: mel loss did not fall below 0.65x its start")
    check(last["loss_gen_all"] < 0.30 * first["loss_gen_all"],
          "overfit: generator loss did not fall below 0.30x its start")
    check(last["loss_dur"] < 0.95 * first["loss_dur"],
          "overfit: duration loss did not fall below 0.95x its start")
    check(1e-3 < min(tail) and max(tail) < 20.0,
          "overfit: discriminator left its healthy band")


def medium_params(torch, seed):
    from phoonnx_tpu_torch.models.vits import model as vits_model, posterior

    hp = vits_model.VitsHParams.preset("medium")
    gen = torch.Generator().manual_seed(seed)

    def randomize_post(flow_params):
        # the flow's post convs start at zero, which makes every coupling
        # the identity; small random values make kernel B do real work
        for flow in flow_params["flows"]:
            for key in ("weight", "bias"):
                flow["post"][key] = 0.05 * torch.randn(
                    flow["post"][key].shape, generator=gen)
        return flow_params

    params = vits_model.random_params(hp, gen)
    randomize_post(params["flow"])
    # a multi-speaker flow of the same widths for kernel B's g input
    gin = 256
    flow_g = randomize_post(posterior.init_residual_coupling_block(
        gen, hp.inter_channels, hp.hidden_channels, 5, 1, 4,
        gin_channels=gin))
    return hp, params, flow_g, gin


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--profile", action="store_true",
                        help="also print a torch.profiler breakdown of one "
                        "~250-id request and of one medium training step")
    args = parser.parse_args()
    start = time.perf_counter()

    import torch

    if not torch.cuda.is_available():
        fail("no CUDA device: this script measures the port on the GPU")
    if not (ROOT / "phoonnx_tpu_torch" / "csrc").is_dir():
        fail(f"phoonnx_tpu_torch/csrc is not beside {Path(__file__).name}: "
             "run it from a checkout of the repository")
    sys.path.insert(0, str(ROOT))

    card = card_line()
    print(card, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from phoonnx_tpu_torch import cuda as port_cuda
    from phoonnx_tpu_torch.models.vits import model as vits_model

    build_s = port_cuda.build()
    print(f"build: {len(port_cuda.LIBRARIES)} libraries from "
          f"phoonnx_tpu_torch/csrc in {build_s:.1f} s", flush=True)

    dev = torch.device("cuda")
    hp, params, flow_g, gin = medium_params(torch, args.seed)
    on_card = vits_model.attach_fused_specs(
        vits_model.params_to_device(params, dev))
    from phoonnx_tpu_torch.models.vits import fused_flow

    flow_g_params = {"fused_rev": fused_flow.build_spec(
        vits_model.params_to_device(flow_g, dev)), "gin": gin}
    results = kernel_phases(torch, on_card, flow_g_params, args.seed, dev)
    del on_card
    results["D"] = mas_phase(torch, dev, args.seed)

    # serving: kernels A, B and C
    model_path, config_path = write_voice(
        torch, params, hp, ROOT / "build" / "chip_smoke")
    voice, launches, _ = main_path(torch, model_path, config_path, args.seed)
    path_vs_plain(torch, voice, args.seed + 1)
    if args.profile:
        profile_request(torch, voice, args.seed + 2)
    del voice

    # training: kernel D
    launches["D"], _ = training_phase(torch, ROOT, args.seed, args.profile)
    overfit_phase(torch, dev, args.seed)

    jax_dir = "phoonnx_tpu/models/vits"
    sources = {"A": ("fused_encoder", f"{jax_dir}/fused_encoder.py:195"),
               "B": ("fused_flow", f"{jax_dir}/fused_flow.py:217"),
               "C": ("fused_stage", f"{jax_dir}/fused_stage.py:250"),
               "D": ("mas", "phoonnx_tpu/ops/mas_pallas.py:36")}
    line = []
    for name, (lib, replaces) in sources.items():
        res = results[name]
        reason = NO_LIBRARY_MAS if name == "D" else NO_LIBRARY
        print(f"library_ms {name}: null, {reason}", flush=True)
        line.append({"name": f"{name}:{lib}", "route": "cuda",
                     "source": f"phoonnx_tpu_torch/csrc/{lib}.cu",
                     "replaces": replaces, "launches": launches[name],
                     "max_abs_err": res["max_abs_err"], "ms": res["ms"],
                     "plain_ms": res["plain_ms"],
                     "bound_ms": res["bound_ms"],
                     "bound_by": res["bound_by"], "library_ms": None})
    print(f"total: {time.perf_counter() - start:.1f} s", flush=True)
    print(json.dumps({"kernels": line}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
