#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (phoonnx_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--seed N] [--profile] [--parent DIR]

Run from the root of a checkout on a machine with an NVIDIA H100 (or
another sm_90a card) and the CUDA toolkit. The script

1. prints the card's name and power limit, turns TF32 off and builds every
   CUDA kernel of the port from ``phoonnx_tpu_torch/csrc`` (one ``nvcc``
   per source, all started together);
2. holds each kernel against its plain PyTorch version on the card at the
   shapes of its path (medium synthesis for A, B and C, A on a ragged
   pair of 1024 and 700 ids, C also at the high preset's 256-channel
   first stage; a medium training batch of 16 for D) and times both
   (median of CUDA-event timings after warm-up, over varied inputs),
   beside the kernel's bound: the larger of its operations over the
   card's peak for them (float32 SIMT for A, B and D; three TF32 passes
   a product for C, which runs 3xTF32 on the tensor cores, with its f32
   bound beside it) and its bytes over the memory rate; counts, with
   torch.profiler, the device kernels inside one call of A and of B
   (each is one cooperative launch), and prints their time by phase
   with the cost of one grid barrier; profiles kernel C conv by conv
   (``conv:`` lines: each tap conv's (C, k, dilation), device time,
   FLOPs and TFLOP/s beside one cuDNN ``conv1d`` of the same shape, a
   yardstick the port never calls); holds kernel D bit for bit at the
   edge shapes of its tiling (``ops/mas.EDGES``) and at the medium
   training shape, counts its device kernels in one call and prints its
   phases from device-clock stamps (``phases: kernel D``: forward,
   backtrack, path write, and ns a row); and with ``--parent DIR``
   (another checkout, e.g. the parent commit unpacked by ``git
   archive``) builds that checkout's kernels C and D and prints their
   times beside, C's three stages and D in turn (parent, this, this,
   parent), D through the parent's own wrapper and held ``torch.equal``
   to the parent's; holds the noise kernel (``csrc/noise.cu``, which
   draws the engine's noise) against its plain version at 16 lanes x
   1,024 rows x 192 channels and times it beside its bytes' bound
   (``kernel noise`` line); captures with ``torch.cuda.graph`` a cooperative
   launch (the grid-barrier probe, kernels A and B) and a plain ctypes
   launch (kernel C) and replays each against an eager launch
   (``graph:`` lines);
3. serving, where the engine runs every program as a CUDA graph per
   bucket key: writes a medium voice (random weights from ``--seed``)
   with the port's ONNX writer, loads it with ``TTSVoice.load`` on the
   default device and answers three single requests (each twice: the
   first call captures its keys' graphs) and one ragged batch of four,
   checking finite audio of ``frames * 256`` samples, that the batch
   equals the single decodes on each utterance's span, that kernels A, B
   and C were launched on that path, and that the path agrees with the
   plain PyTorch versions run on the host's CPU; replays each program's
   graph (phase 1, phase 2, latents, fused, first chunk, decode chunk)
   against the program called eagerly, under CUDA's sync debug mode
   'error', and one fused graph at two length and two noise scales
   (``graph:`` lines); times the ~241-id request through the graphs
   against the same programs called eagerly (``request:`` lines: 41 runs
   in turns with quartiles, the host's time by item, the noise kernel's
   two launches, device busy and idle share from the profiler); streams it at chunk 128 and overlap 32
   (``stream:`` lines: the stream against the monolithic request, the
   time to the first chunk, of the stream and of the monolithic
   request); holds fused mode against two-phase, ``synthesize_many``
   against its fused calls and the int16 fetch against float32, prints
   the memory of one phase-2 graph by frame bucket and what ``warmup()``
   captures and holds (``surface:`` lines), holds two streams of one key
   interleaved chunk by chunk and two threads' requests of one key made
   at once against the same calls made alone (``reentrant:`` lines), and
   prints each graph's pool (``medium: graph`` lines); serves a fresh
   load of the medium voice with ``TTSServer(port=0, max_batch=16,
   max_wait_ms=10)`` (``serve:`` lines): ``warmup()`` at 1-16 lanes with
   its graphs and pool, eight concurrent requests at noise 0 each within
   4 int16 steps of ``synthesize_ids``, a seeded request of three
   sentences against ``synthesize_batch`` of them in their own order,
   the stream route within one step of the WAV route, one seeded
   request of n short sentences for n = 1, 2, 4, 8, 16 (a group of n
   lanes), closed-loop load at 1, 16 and 64 client threads (requests/s,
   audio s per wall s,
   latency p50/p90/p99, batches and lanes, the dispatcher's host time by
   item, graph replays and captures by lane count, one level profiled
   for the device's busy and idle share; counted from 0: A, B and C must
   launch, graphs must replay at 1, 2, 4, 8 and 16 lanes, 16 lanes must
   be seen at 64 clients), one client beside a direct request, the pool
   after the load and its largest capture, and A, B and C against their
   plain versions at 16 lanes; bfloat16 synthesis (``bf16:`` lines): the
   medium voice loaded with ``dtype="bfloat16"`` through the bf16 builds
   of A, B and C (each also held against its bf16 plain version at B=1
   and at 16 lanes, ``kernel A bf16`` lines, the bound at the bf16
   tensor-core rate): the serving path's requests and batch, every
   program's graph ``torch.equal`` to eager at the 31-, 97- and 241-id
   requests' buckets, the card against the plain bf16 path on the CPU,
   the float32 voice of the same seed beside it (frame counts, max-abs,
   SNR, the 241-id request timed in turns, graph pools), a stream, and a
   bf16 server (``bf16 serve:``: requests held to its engine, the
   16-client window beside the float32 one); then the same
   serving checks for a ``medium-istft`` and a ``medium-mb-istft`` voice
   (``istft:`` lines), with kernel C held against its plain version at
   their stage shapes for 512 frames and the card's inverse STFT against
   the CPU's; voice
   conversion on a medium voice of 4 speakers at gin 512 (``vc:``
   lines: a 20 s and a 2 s input timed, the 2 s one against the CPU's
   plain path, its graph against eager, its launches, a request as
   speaker 2); and the two CLIs,
   ``python -m phoonnx_tpu_torch.synthesize`` (whole and ``--stream``)
   and ``python -m phoonnx_tpu_torch.convert``, as three processes
   started together (``cli:`` lines); foreign voices (``onnx:`` lines):
   the medium weights exported as an ONNX graph by the port's
   ``onnx/vits_graph.py`` with every initializer renamed, in float32 and
   int8 QDQ, loaded by ``TTSVoice.load`` onto the ONNX graph engine
   (``OnnxFallbackEngine``, its ``TorchGraphRunner`` on the card): each
   node's output place (no floating or data-sized value on the host; the
   host nodes and host reads by op), two seeded calls equal, the card's
   58-id waveform against the port's numpy interpreter on the host within
   1e-3 of the peak (the durations' distance to an integer printed if the
   lengths differ), the 58- and 241-id requests of both and of the native
   voice of the same weights timed in turns with their device kernels,
   busy time and idle share, seeded requests through ``TTSServer`` within
   one int16 step of the engine, and no launch of A-D in the phase; then
   the engines' matmul precision (``precision:`` lines): a default
   engine bit for bit the same before, beside and after a ``"high"``
   engine of the same voice capturing and replaying on another thread,
   ``"highest"`` equal to the default, both TF32 flags off after, and
   ``"high"`` against the default with both request times; the text
   front end (``frontend:`` and its phases' lines): ``g2p:``, the ByT5
   G2P engine at byt5-small widths (12 + 4 layers, d_model 1472, random
   weights in HF naming from ``--seed``) in float32 and bfloat16, its
   encoder and teacher-forced logits against the same port code on the
   host's CPU, greedy decodes of 16 words of 12 bytes and of a 100-byte
   sentence against the CPU's under the near-tie rule
   (:func:`near_tie_split`), and the batch decode's ms, words/s,
   tokens/s, device kernels a decode step, host reads and idle share;
   ``arabic:``, a mantoq voice of the medium weights whose phonemizer
   carries a tashkeel model of ``tools/bench_aux.py``'s geometry (built
   with the port's GraphBuilder): diacritics and ids against the CPU's,
   the runner's placement and device kernels, A, B and C launched, the
   waveform against the CPU's; ``korean:``, a KoG2P voice's ids and
   launches; ``hebrew:``, the phonikud diacritizer with
   ``tests/test_phonikud_model.py``'s Gather-table model against the
   CPU's, its download refused; ``byt5 voice:``, a voice whose G2P is an
   initializers-only ONNX of the ``g2p:`` weights, its ids against the
   CPU's, A, B and C launched and the G2P's share of a request;
   ``memory:`` lines give the allocator's reserved and allocated memory
   after each phase;
4. training: writes a synthetic LJSpeech-style dataset (45 utterances of
   per-phoneme tones, 1.5 to 8 s, spectrograms from the port's STFT; 5
   held out for tests, 4 validation, 36 train) and runs
   ``run_training(quality=..., batch_size=16, max_epochs=1)`` on the
   card at ``medium`` and at ``medium-mb-istft``, printing each step's
   time, losses and kernel D time, checking finite losses, changed
   parameters, that kernel D was launched in the epoch, that the steps
   and validation launched none of A, B, C while the epoch's test audio
   (``write_test_audio``, 5 held-out utterances) launched them once an
   utterance (C once a decoder stage) and wrote every WAV with no failure
   recorded, and that the checkpoint restores to equal tensors; then the
   micro overfit recipe of the JAX package's tests (250 steps on two
   learnable utterances) held to that test's margins; then data-parallel
   training (``dp:`` lines): two ranks in processes of their own on the
   card over gloo (NCCL takes a card a rank), medium, the dataset's first
   global batch of 16, 8 rows a rank: the first step's averaged
   gradients and losses against one process's step on the same batch
   and seed (median leaf rel-L2 <= 1e-5, every leaf <= 3e-2, losses
   within 1e-5), each rank's step ms and ``all_reduce`` ms and MiB
   beside one process's, then one epoch of ``run_training`` on the two
   ranks: parameters ``torch.equal`` across ranks, equal validation
   losses, kernel D launched in both ranks (the counts come back from
   the processes), A, B and C in rank 0's test audio only; then the training
   pipeline (``pipeline:`` lines) at ``medium``, batch 16: a raw LJ
   Speech-style corpus (``metadata.csv`` and 22050 Hz WAVs of the same 45
   tone utterances, grapheme texts) preprocessed by ``run_preprocess`` on
   the card and on the CPU (seconds of each; the same rows, trimmed audio
   equal, spectrograms within 1e-5 of their peak); three epochs of
   ``run_training`` on it (float32; resumed in bf16 with grad_accum 2;
   resumed with remat), each checked as above; one batch stepped from one
   seed in float32, bf16, grad_accum 2 and remat (first-step losses side
   by side, step ms, peak memory); the last checkpoint exported in
   float32 and int8, each served by ``TTSVoice.load`` on the card (the
   241-id request timed, A, B, C launched), the float32 one within 1e-3
   of the peak of a ``VitsEngine`` over the checkpoint's generator at
   equal length; and a 4-speaker warm start from the float32 export
   taking one step; then the convergence run (``converge:`` lines,
   ``train/scale_run.run_scale``, the port of tools/train_scale_run.py):
   the JAX run's 96-utterance synthetic corpus preprocessed on the card,
   medium, batch 16, bf16, grad_accum 2, 8 epochs with a resume from the
   epoch-4 checkpoint (the JAX run: 20 resumed at 10), each epoch's
   seconds, validation loss and launches; a strictly falling validation
   loss, phase B's first step phase A's last + 1, D in every epoch's
   steps, none of A, B, C in the steps or validation and each of them in
   every epoch's test audio; the last checkpoint exported and served by
   ``TTSVoice.load`` on the card (audible, A, B, C launched), and the
   exported voice in bf16 against float32 on the held-out and validation
   utterances (frame counts, log-durations; recorded, not bounded);
5. prints each path's launch counts (every path counted from 0), one
   ``{"kernels": [...]}`` line whose launches sum the serving paths (A, B,
   C, the server's load, the front end's voices, the training runs' test
   audio and the exported voices included; a graph replay adds the
   launches of its capture; the bf16 builds ``A:fused_encoder_bf16`` etc.
   those of the bf16 paths) and the training runs (D: the two epochs, the
   pipeline's epochs, option steps and warm start, both data-parallel
   ranks' epoch, the convergence run), and, last, one
   ``{"ok": true, "device": {...}}`` line.

It exits non-zero, with no result line, when there is no CUDA device, when
the port is not beside it, or when any check fails.
"""

import argparse
import contextlib
import ctypes
import json
import math
import multiprocessing
import os
import shutil
import socket
import statistics
import subprocess
import sys
import time
import traceback
from functools import partial
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent

# NVIDIA H100 SXM data sheet (dense, no sparsity): float32 outside the
# tensor cores, TF32 on them, and HBM3 bandwidth.
PEAK_F32_FLOPS = 67e12
PEAK_TF32_FLOPS = 495e12
PEAK_BYTES = 3.35e12
# kernel C multiplies on the tensor cores in 3xTF32: three TF32 products
# (hi*hi + hi*lo + lo*hi) for each float32 one
TF32_PASSES = 3
# bfloat16 synthesis: the H100 SXM's dense bf16 tensor-core rate bounds the
# bf16 kernels (their bytes at 2 a value); kernel C's bf16 build takes one
# TF32 pass a product, whose bound is printed beside
PEAK_BF16_FLOPS = 989e12

# max-abs difference allowed between a kernel and its plain version: both
# are float32 (TF32 off) and sum in other orders; a wrong op shows as 1e-2+.
KERNEL_TOL = 1e-4
# batch vs single decode of one utterance, both through the kernels
BATCH_TOL = 1e-4
# whole path (encoder -> flow -> decoder) through the kernels against the
# plain versions, on the valid span of the waveform (ARCHITECTURE.md:86-89)
PATH_TOL = 1e-3

# a bf16 kernel against its plain version on the card: max-abs <=
# BF16_KERNEL_TOL x max(1, max|plain|). Both round to bf16 at the same
# points and sum in float32 in other orders, so they differ where such a
# sum lands on the other side of a bf16 rounding (2^-8 relative a step).
BF16_KERNEL_TOL = 1e-2
# the bf16 path on the card against the plain bf16 path on the host's
# CPU, on the valid waveform (peaks ~0.1-0.3 with random weights)
BF16_PATH_TOL = 5e-3
# a bf16 request's frame count against the float32 request's: the share
# of its frames whose durations may take the other ceil() (bf16_vs_f32)
BF16_FRAME_SHARE = 0.01

NO_LIBRARY = ("no single PyTorch call computes this function (it is a chain "
              "of convs, products and masks)")
NO_LIBRARY_NOISE = ("no single PyTorch call computes this function "
                    "(Philox4x32-10 keyed by each lane's seed, Box-Muller; "
                    "torch.randn on the card draws another stream)")
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


def bound(flops: float, nbytes: float, rate: float = PEAK_F32_FLOPS):
    """(ms, what bounds it): the larger of the operations at ``rate`` and
    the bytes at the memory rate."""
    t_ops = flops / rate * 1e3
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


def compare_kernel(torch, name, kernel_fn, plain_fn, inputs, flops, nbytes,
                   case, tf32=False, unrounded_fn=None):
    """The kernel against its plain version; a 3xTF32 kernel (tf32)
    is bounded at that rate, with its f32 SIMT bound beside it. On bf16
    inputs the kernel is its bf16 build: the bound is at the bf16
    tensor-core rate (kernel C's one-pass TF32 bound beside it) and the
    tolerance BF16_KERNEL_TOL scaled by the plain output's magnitude.
    ``unrounded_fn`` is the float32 function of the same bf16 values,
    rounded once: the kernel's mean distance from its plain version must
    be below half its mean distance from that, so that a kernel without
    the internal rounding points fails."""
    bf16 = inputs[0][0].dtype == torch.bfloat16
    got = kernel_fn(*inputs[0])
    want = plain_fn(*inputs[0])
    torch.cuda.synchronize()
    check(got.shape == want.shape and got.dtype == want.dtype,
          f"{name} {case}: {tuple(got.shape)} {got.dtype} vs "
          f"{tuple(want.shape)} {want.dtype}")
    check(bool(torch.isfinite(got).all()), f"{name} {case}: non-finite")
    err = (got.float() - want.float()).abs().max().item()
    tol = (BF16_KERNEL_TOL * max(1.0, want.float().abs().max().item())
           if bf16 else KERNEL_TOL)
    unrounded = ""
    if unrounded_fn is not None:
        miss = (got.float() - unrounded_fn(*inputs[0]).float()).abs()
        near = (got.float() - want.float()).abs().mean().item()
        far = miss.mean().item()
        unrounded = (f" unrounded_err={miss.max().item():.3e} (mean "
                     f"{far:.3e}, the plain version's {near:.3e})")
        check(near < 0.5 * far,
              f"{name} {case}: the kernel's mean distance from its plain "
              f"version {near:.3e} is not below half its distance from "
              f"the float32 function rounded once {far:.3e}")
    k_ms = median_ms(torch, kernel_fn, inputs)
    p_ms = median_ms(torch, plain_fn, inputs)
    f32_ms, f32_by = bound(flops, nbytes)
    if bf16:
        b_ms, b_by = bound(flops, nbytes, PEAK_BF16_FLOPS)
        tf_ms, tf_by = bound(flops, nbytes, PEAK_TF32_FLOPS)
        also = (f" (bf16 at {PEAK_BF16_FLOPS / 1e12:.0f} TFLOP/s, {b_by})"
                + (f" bound_tf32_1pass_ms={tf_ms:.5f} ({tf_by})" if tf32
                   else ""))
    else:
        b_ms, b_by = (bound(TF32_PASSES * flops, nbytes, PEAK_TF32_FLOPS)
                      if tf32 else (f32_ms, f32_by))
        also = (f" (3xTF32 at {PEAK_TF32_FLOPS / 1e12:.0f} TFLOP/s) "
                f"bound_f32_ms={f32_ms:.5f} ({f32_by})" if tf32 else
                f" ({b_by})")
    print(f"kernel {name}{' bf16' if bf16 else ''} {case}: "
          f"max_abs_err={err:.3e} (bound {tol:.3e}){unrounded} "
          f"kernel_ms={k_ms:.4f} plain_ms={p_ms:.4f} "
          f"bound_ms={b_ms:.5f}{also} flops={flops:.4e} "
          f"bytes={nbytes:.4e}", flush=True)
    check(err <= tol,
          f"{name} {case}: kernel vs plain max-abs {err:.3e} > {tol:.3e}")
    return {"max_abs_err": err, "ms": k_ms, "plain_ms": p_ms,
            "bound_ms": b_ms, "bound_by": b_by, "bound_f32_ms": f32_ms,
            "flops": flops, "bytes": nbytes, "bf16": bf16}


def compare_stages(torch, stages, rates, batch_frames, gen, dev,
                   label="", unrounded=None):
    """Kernel C against its plain version on each decoder stage of a
    request of ``batch_frames`` latent frames (padded to the longest);
    returns the sums over the stages (ms, plain ms, FLOPs, bytes) and the
    largest error. ``unrounded``: the stages' float32 specs of the same
    bf16 values, for :func:`compare_kernel`'s reading."""
    from phoonnx_tpu_torch.models.vits import fused_stage

    frames = max(batch_frames)
    total = None
    cum = 1
    for i, spec in enumerate(stages):
        cum *= rates[i]
        ch = spec["W"].shape[1]
        dtype = spec["W"].dtype
        t = frames * cum
        valid = [n * cum for n in batch_frames]
        vt = torch.tensor(valid, dtype=torch.int32, device=dev)
        inputs = [((torch.randn(len(valid), t, ch, device=dev,
                                generator=gen) * 0.5).to(dtype), vt)
                  for _ in range(3)]
        out_ch = 1 if "postW" in spec else ch
        nbytes = (len(valid) * t * (ch + out_ch) * spec["W"].element_size()
                  + tensor_bytes(spec) + 4 * len(valid))
        res = compare_kernel(
            torch, "C", lambda x, v, s=spec: fused_stage.apply_group(s, x, v),
            lambda x, v, s=spec: fused_stage.plain(s, x, v), inputs,
            stage_flops(spec, valid, ch), nbytes,
            f"{label}stage {i} B={len(valid)} [{t}, {ch}] valid={valid}"
            + (" +post" if "postW" in spec else ""), tf32=True,
            unrounded_fn=None if unrounded is None else (
                lambda x, v, s=unrounded[i]: fused_stage.plain(
                    s, x.float(), v).to(x.dtype)))
        if total is None:
            total = dict(res)
        else:
            total["max_abs_err"] = max(total["max_abs_err"],
                                       res["max_abs_err"])
            for key in ("ms", "plain_ms", "flops", "bytes"):
                total[key] += res[key]
    return total


def stage_total_line(total, what):
    """Bound kernel C's summed stages at the 3xTF32 rate (f32 beside), or
    for its bf16 build at the bf16 rate (one TF32 pass beside), and print
    them."""
    flops, nbytes = total["flops"], total["bytes"]
    if total["bf16"]:
        total["bound_ms"], total["bound_by"] = bound(flops, nbytes,
                                                     PEAK_BF16_FLOPS)
        beside = bound(flops, nbytes, PEAK_TF32_FLOPS)[0]
        rates = f"bf16, {total['bound_by']}) bound_tf32_1pass_ms={beside:.5f}"
    else:
        total["bound_ms"], total["bound_by"] = bound(
            TF32_PASSES * flops, nbytes, PEAK_TF32_FLOPS)
        beside = total["bound_f32_ms"] = bound(flops, nbytes)[0]
        rates = f"3xTF32, {total['bound_by']}) bound_f32_ms={beside:.5f}"
    print(f"kernel C {what}: kernel_ms={total['ms']:.4f} plain_ms="
          f"{total['plain_ms']:.4f} bound_ms={total['bound_ms']:.5f} "
          f"({rates} max_abs_err={total['max_abs_err']:.3e}", flush=True)


def kernel_phases(torch, params, flow_g_params, high_stage0, seed, dev):
    """Each kernel against its plain version at the medium shapes, and
    kernel C also at the high preset's first stage (``high_stage0``)."""
    from phoonnx_tpu_torch.models.vits import (fused_encoder, fused_flow,
                                               fused_stage)

    gen = torch.Generator(device=dev).manual_seed(seed)
    results = {}

    def mask_of(lengths, t):
        pos = torch.arange(t, device=dev)[None, :]
        lens = torch.tensor(lengths, device=dev)[:, None]
        return (pos < lens)[..., None].float()

    compare = partial(compare_kernel, torch)

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

    # --- B: the inverse flow, T_y = 512, without and with g (gin 256);
    # and at gin 512, a multi-speaker voice's width, on the frame bucket of
    # a 2 s voice conversion ---
    for spec, lengths, gin, t_y in (
            (params["flow"]["fused_rev"], [512], 0, 512),
            (flow_g_params[256], [512, 300], 256, 512),
            (flow_g_params[512], [173], 512, 256)):
        mask = mask_of(lengths, t_y)
        c = 2 * spec["half"]
        inputs = []
        for _ in range(4):
            x = torch.randn(len(lengths), t_y, c, device=dev,
                            generator=gen) * mask
            g = None if not gin else torch.randn(
                len(lengths), 1, gin, device=dev, generator=gen)
            inputs.append((x, mask, g))
        nbytes = (2 * len(lengths) * t_y * c * 4 + tensor_bytes(spec)
                  + (len(lengths) * gin * 4))
        res = compare("B",
                      lambda x, m, g, s=spec: fused_flow.apply(s, x, m, g=g),
                      lambda x, m, g, s=spec: fused_flow.plain(s, x, m, g=g),
                      inputs, flow_flops(spec, lengths), nbytes,
                      f"B={len(lengths)} T_y={t_y} lengths={lengths} "
                      f"g={'gin ' + str(gin) if gin else 'no'}")
        results.setdefault("B", res)
        results["B"]["max_abs_err"] = max(results["B"]["max_abs_err"],
                                          res["max_abs_err"])
        if not gin:
            results["B"]["device_kernels"] = kernels_in_call(
                torch, lambda s=spec: fused_flow.apply(s, *inputs[0]), "B",
                "flow_persistent")
            phase_times(torch, fused_flow, spec, inputs[0], "B")

    # --- C: the three decoder stages at 512 frames, last with its tail ---
    stages = params["dec"]["fused_stages"]
    rates = params["dec"]["upsample_rates"]
    for batch_frames in ([512], [512, 400, 256, 130]):
        total = compare_stages(torch, stages, rates, batch_frames, gen, dev)
        if "C" not in results:
            # the three stage launches of one 512-frame request
            stage_total_line(total, "3 stages B=1 512 frames")
            results["C"] = total
        else:
            results["C"]["max_abs_err"] = max(results["C"]["max_abs_err"],
                                              total["max_abs_err"])

    # --- C at high's widest window: 256 channels, resblock "1" (k up to
    # 11 at dilation 5), 512 frames ---
    spec = high_stage0
    ch = spec["W"].shape[1]
    t = 512 * 8
    valid = [t, t - 1001]
    vt = torch.tensor(valid, dtype=torch.int32, device=dev)
    inputs = [(torch.randn(2, t, ch, device=dev, generator=gen) * 0.5, vt)
              for _ in range(2)]
    nbytes = 2 * t * 2 * ch * 4 + tensor_bytes(spec) + 8
    res = compare("C", lambda x, v: fused_stage.apply_group(spec, x, v),
                  lambda x, v: fused_stage.plain(spec, x, v), inputs,
                  stage_flops(spec, valid, ch), nbytes,
                  f"high stage 0 B=2 [{t}, {ch}] valid={valid}", tf32=True)
    results["C"]["max_abs_err"] = max(results["C"]["max_abs_err"],
                                      res["max_abs_err"])
    return results


@contextlib.contextmanager
def stage_library(port_cuda, fn):
    """Route kernel C's wrapper to another build of ``fused_stage_group``
    (``fn``, same C interface) inside the block; ``None`` keeps the
    port's own."""
    key = ("fused_stage", "fused_stage_group")
    own = port_cuda._FUNCS[key]
    if fn is not None:
        port_cuda._FUNCS[key] = fn
    try:
        yield
    finally:
        port_cuda._FUNCS[key] = own


def build_parent(port_cuda, parent: Path, name: str):
    """Start nvcc on another checkout's ``csrc/<name>.cu`` (the parent
    commit's kernel), with the port's flags, beside the port's own build;
    returns a function that waits for it and loads the library."""
    src = parent / "phoonnx_tpu_torch" / "csrc" / f"{name}.cu"
    if not src.is_file():
        fail(f"--parent: {src} does not exist")
    out = ROOT / "build" / "chip_smoke" / "parent" / f"lib{name}.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    proc = subprocess.Popen([port_cuda._nvcc(), *port_cuda.NVCC_FLAGS, "-o",
                             str(out), str(src)], stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT)

    def load():
        log, _ = proc.communicate()
        check(proc.returncode == 0, f"--parent: nvcc failed on {name}:\n"
              + log.decode(errors="replace"))
        return ctypes.CDLL(str(out))

    return load


def parent_stage(port_cuda, lib):
    """The parent's ``fused_stage_group``, typed as the port's."""
    fn = lib.fused_stage_group
    fn.argtypes = port_cuda._FUNCS[
        ("fused_stage", "fused_stage_group")].argtypes
    fn.restype = ctypes.c_int
    return fn


class ParentCuda:
    """The port's ``cuda`` module with its C entry points taken from
    another checkout's build (``lib``), each typed as that checkout's own
    wrapper declares it."""

    def __init__(self, port_cuda, lib):
        self._port = port_cuda
        self._lib = lib

    def __getattr__(self, name):
        return getattr(self._port, name)

    def function(self, library, symbol, argtypes, restype=ctypes.c_int):
        fn = getattr(self._lib, symbol)
        fn.argtypes = list(argtypes)
        fn.restype = restype
        return fn


def parent_mas(port_cuda, parent: Path, lib):
    """The parent checkout's kernel D as a function of (value, y_lens,
    x_lens): that checkout's own ``ops/mas.py`` ``launch``, calling its
    build of ``csrc/mas.cu`` (``lib``), so the call follows whatever C
    interface the parent has."""
    import importlib.util

    src = parent / "phoonnx_tpu_torch" / "ops" / "mas.py"
    spec = importlib.util.spec_from_file_location("parent_ops_mas", src)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    module.cuda = ParentCuda(port_cuda, lib)
    return module.launch


def stage_conv_profile(torch, port_cuda, stages, rates, dev, seed,
                       parent=None, frames=512, reps=5):
    """Kernel C conv by conv: torch.profiler around ``reps`` calls of
    ``apply_group`` for each stage at B=1 and ``frames`` frames; for each
    tap conv its (C, k, dilation), median device time, FLOPs 2*T*k*C^2
    and TFLOP/s, beside one cuDNN ``conv1d`` of the same shape (a
    yardstick only: the port never calls it) and, with ``parent`` (the
    parent commit's ``fused_stage_group``), the parent kernel's time. The
    tail kernel's time follows each last stage. With ``parent`` the three
    stages are also timed whole, in the order parent, port, port,
    parent."""
    import torch.nn.functional as F
    from torch.profiler import ProfilerActivity, profile

    from phoonnx_tpu_torch.models.vits import fused_stage

    gen = torch.Generator(device=dev).manual_seed(seed)
    builds = [("port", None)] + ([("parent", parent)] if parent else [])
    rows, cum, calls = [], 1, []
    for i, spec in enumerate(stages):
        cum *= rates[i]
        t, ch = frames * cum, spec["W"].shape[1]
        x = torch.randn(1, t, ch, device=dev, generator=gen) * 0.5
        valid = torch.tensor([t], dtype=torch.int32, device=dev)
        calls.append((spec, x, valid))
        per_call = len(spec["program"]) + ("postW" in spec)
        times = {}
        for label, fn in builds:
            # the profiler now and then returns a session without its
            # device records: such a session is taken again, twice at most
            for attempt in range(3):
                with stage_library(port_cuda, fn):
                    fused_stage.apply_group(spec, x, valid)  # warm
                    torch.cuda.synchronize()
                    with profile(activities=[ProfilerActivity.CPU,
                                             ProfilerActivity.CUDA]) as prof:
                        for _ in range(reps):
                            fused_stage.apply_group(spec, x, valid)
                        torch.cuda.synchronize()
                evts = sorted((e for e in prof.events()
                               if str(e.device_type).endswith("CUDA")
                               and ("tapconv" in e.name
                                    or "post_kernel" in e.name)),
                              key=lambda e: e.time_range.start)
                if len(evts) == reps * per_call:
                    break
                print(f"conv: stage {i} ({label}): the profiler saw "
                      f"{len(evts)} kernel C device kernels in {reps} "
                      f"calls, not {reps * per_call}; profiling again",
                      flush=True)
            check(len(evts) == reps * per_call,
                  f"stage {i} ({label}): {len(evts)} kernel C device "
                  f"kernels in {reps} calls, expected {reps * per_call}")
            times[label] = [statistics.median(
                evts[r * per_call + j].time_range.elapsed_us()
                for r in range(reps)) for j in range(per_call)]
        xin = x.transpose(1, 2).contiguous()  # cuDNN's [B, C, T]
        for j, (w0, k, dil, pad, b_idx, *_) in enumerate(spec["program"]):
            flops = 2.0 * t * k * ch * ch
            weight = spec["W"][w0:w0 + k].permute(2, 1, 0).contiguous()
            bias = spec["b"][b_idx]
            cudnn_ms = median_ms(torch, lambda a, w=weight, b=bias, p=pad,
                                 d=dil: F.conv1d(a, w, b, padding=p,
                                                 dilation=d), [(xin,)])
            row = {"stage": i, "conv": j, "C": ch, "k": k, "dil": dil,
                   "flops": flops, "us": times["port"][j],
                   "cudnn_us": cudnn_ms * 1e3}
            line = (f"conv: stage {i} conv {j} C={ch} k={k} dil={dil} "
                    f"T={t}: kernel_us={row['us']:.2f} "
                    f"tflops={flops / row['us'] / 1e6:.2f} "
                    f"flops={flops:.4e} cudnn_us={row['cudnn_us']:.2f} "
                    f"cudnn_tflops={flops / row['cudnn_us'] / 1e6:.2f}")
            if parent:
                row["parent_us"] = times["parent"][j]
                line += (f" parent_us={row['parent_us']:.2f} parent_tflops="
                         f"{flops / row['parent_us'] / 1e6:.2f}")
            print(line, flush=True)
            rows.append(row)
        if "postW" in spec:
            print(f"conv: stage {i} tail (lrelu, conv_post k="
                  f"{spec['postW'].shape[0]}, tanh) T={t}: kernel_us="
                  f"{times['port'][-1]:.2f}" + (
                      f" parent_us={times['parent'][-1]:.2f}" if parent
                      else ""), flush=True)
    total = sum(r["us"] for r in rows)
    print(f"conv: {len(rows)} tap convs {total:.2f} us of device time, "
          f"{sum(r['flops'] for r in rows) / total / 1e6:.2f} TFLOP/s; "
          f"cuDNN {sum(r['cudnn_us'] for r in rows):.2f} us" + (
              f"; parent {sum(r['parent_us'] for r in rows):.2f} us"
              if parent else ""), flush=True)
    if parent:
        def three_stages():
            for spec, x, valid in calls:
                fused_stage.apply_group(spec, x, valid)

        order = []
        for label, fn in (builds[1], builds[0], builds[0], builds[1]):
            with stage_library(port_cuda, fn):
                order.append((label, median_ms(torch, three_stages, [()])))
        print("conv: kernel C 3 stages B=1 512 frames, apply_group ms in "
              "turn: " + ", ".join(f"{label} {ms:.4f}"
                                   for label, ms in order), flush=True)
        # the float32 build's arithmetic against the parent's: equal outputs
        outs = {}
        for label, fn in builds[:2]:
            with stage_library(port_cuda, fn):
                outs[label] = [fused_stage.apply_group(spec, x, valid)
                               for spec, x, valid in calls]
        (a_label, a_out), (b_label, b_out) = outs.items()
        same = all(torch.equal(u, v) for u, v in zip(a_out, b_out))
        print(f"conv: kernel C float32 output, {a_label} vs {b_label}, 3 "
              f"stages: torch.equal={same}", flush=True)
        check(same, f"kernel C's float32 output differs from {b_label}'s")


def write_voice(torch, params, hp, out_dir: Path, name: str = "medium"):
    from phoonnx_tpu_torch.models.vits.load import params_to_flat
    from phoonnx_tpu_torch.onnx.writer import write_onnx

    out_dir.mkdir(parents=True, exist_ok=True)
    model_path = out_dir / f"{name}.onnx"
    metadata = {"model_type": "vits", "sample_rate": str(hp.sample_rate)}
    inputs = ["input", "input_lengths", "scales"]
    if hp.n_speakers > 1:
        metadata["n_speakers"] = str(hp.n_speakers)
        inputs.append("sid")
    write_onnx(str(model_path), params_to_flat(params), metadata=metadata,
               inputs=inputs, outputs=["output"])
    letters = "abcdefghijklmnopqrstuvwxyz"
    id_map = {"_": 0, "^": 1, "$": 2, " ": 3}
    id_map.update({c: i + 4 for i, c in enumerate(letters)})
    config = {
        "phoneme_type": "raw", "lang_code": "en", "alphabet": "ipa",
        "phoneme_id_map": id_map, "num_symbols": len(id_map),
        "num_speakers": hp.n_speakers,
        "audio": {"sample_rate": hp.sample_rate},
        "inference": {"noise_scale": 0.667, "length_scale": 1.0,
                      "noise_w": 0.8},
    }
    config_path = out_dir / f"{name}.onnx.json"
    config_path.write_text(json.dumps(config), encoding="utf-8")
    return model_path, config_path


def write_foreign_voice(torch, params, hp, out_dir: Path,
                        name: str = "foreign", quantize: bool = False):
    """A voice in no layout the weight importer knows: the port's
    executable VITS graph (``onnx/vits_graph.py``, int8 QDQ weights with
    ``quantize``) with every initializer renamed ``foreign/...``, as a
    coqui-VITS or mimic3 export would name them; the config as
    :func:`write_voice`'s. ``TTSVoice.load`` runs it on the ONNX graph
    engine."""
    from phoonnx_tpu_torch.models.vits.load import params_to_flat
    from phoonnx_tpu_torch.onnx.reader import read_onnx
    from phoonnx_tpu_torch.onnx.vits_graph import export_vits_onnx
    from phoonnx_tpu_torch.onnx.writer import write_onnx

    model_path, config_path = write_voice(torch, params, hp, out_dir, name)
    export_vits_onnx(params_to_flat(params), hp, str(model_path),
                     metadata={"model_type": "vits",
                               "sample_rate": str(hp.sample_rate)},
                     quantize=quantize)
    model = read_onnx(str(model_path))
    rename = {k: f"foreign/{k}" for k in model.initializers}
    io_names = set(model.inputs) | set(model.outputs)

    def remap(n):
        return n if n in io_names else rename.get(n, n)

    nodes = [(n.op_type, [remap(i) for i in n.inputs],
              [remap(o) for o in n.outputs], n.attributes)
             for n in model.nodes]
    write_onnx(str(model_path),
               {rename[k]: v for k, v in model.initializers.items()},
               metadata=dict(model.metadata), inputs=model.inputs,
               outputs=model.outputs, nodes=nodes, opset=model.opset)
    return model_path, config_path


def text_of(n_letters: int, offset: int) -> str:
    """A RAW-phoneme 'sentence': letters in words of 5, no punctuation."""
    letters = "abcdefghijklmnopqrstuvwxyz"
    chars = [letters[(offset + 7 * i) % 26] for i in range(n_letters)]
    words = ["".join(chars[i:i + 5]) for i in range(0, n_letters, 5)]
    return " ".join(words)


# the synthesis kernels: A, B, C and the engine's noise draws
SYNTH = ("A", "B", "C", "noise")


def serving_kernels(dtype: str = "float32"):
    """The kernels of the serving path (SYNTH), by name: their keys in
    ``cuda.LAUNCHES`` for the build the engine's ``dtype`` runs."""
    import torch

    from phoonnx_tpu_torch import cuda as port_cuda
    from phoonnx_tpu_torch.models.vits import (fused_encoder, fused_flow,
                                               fused_stage)
    from phoonnx_tpu_torch.ops import noise

    mods = {"A": fused_encoder, "B": fused_flow, "C": fused_stage,
            "noise": noise}
    return {name: port_cuda.launch_key(mod.__name__, getattr(torch, dtype))
            for name, mod in mods.items()}


def reset_launches(kernels) -> None:
    """Set to 0 the counts of ``kernels`` (names to ``cuda.LAUNCHES``
    keys)."""
    from phoonnx_tpu_torch import cuda as port_cuda

    for key in kernels.values():
        port_cuda.LAUNCHES[key] = 0


def launch_counts(kernels):
    """Each kernel's launches since :func:`reset_launches`."""
    from phoonnx_tpu_torch import cuda as port_cuda

    return {name: port_cuda.LAUNCHES[key] for name, key in kernels.items()}


def report_launches(launches, tag: str, path: str):
    """Print a path's launch counts; each kernel must have been launched
    on the path."""
    print(f"{tag}: launches on the {path} {launches}", flush=True)
    for name, n in launches.items():
        check(n > 0, f"kernel {name} was not launched on the {path}")
    return launches


def read_launches(kernels, tag: str, path: str):
    """The launch counts since :func:`reset_launches`, printed and
    checked as :func:`report_launches` does."""
    return report_launches(launch_counts(kernels), tag, path)


def main_path(torch, model_path, config_path, seed, tag="main",
              dtype="float32", batch_tol=None):
    """The port's serving path as a user drives it, on the default device,
    with the voice loaded in ``dtype``. Returns (voice, launches,
    requests)."""
    from phoonnx_tpu_torch import SynthesisConfig, TTSVoice

    batch_tol = BATCH_TOL if batch_tol is None else batch_tol
    kernels = serving_kernels(dtype)
    reset_launches(kernels)

    t0 = time.perf_counter()
    voice = TTSVoice.load(str(model_path), str(config_path), dtype=dtype)
    print(f"{tag}: TTSVoice.load {time.perf_counter() - t0:.3f} s on "
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
        graphs = len(voice.engine.graphs.programs)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        chunks = list(voice.synthesize(text, cfg(seed + target)))
        ms = (time.perf_counter() - t0) * 1e3
        graphs = len(voice.engine.graphs.programs) - graphs
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        list(voice.synthesize(text, cfg(seed + target)))
        warm_ms = (time.perf_counter() - t0) * 1e3
        check(len(chunks) == 1, f"{len(chunks)} chunks for one sentence")
        audio = chunks[0].audio_float_array
        check(audio.dtype.name == "float32", "audio is not float32")
        check(len(audio) > 0 and len(audio) % hop == 0,
              f"audio length {len(audio)} is not frames x {hop}")
        check(bool(torch.isfinite(torch.from_numpy(audio)).all()),
              "non-finite audio")
        frames = len(audio) // hop
        print(f"{tag}: single request ids={ids} frames={frames} "
              f"samples={len(audio)} ms={ms:.3f} (graphs captured in it: "
              f"{graphs}) again ms={warm_ms:.3f}", flush=True)
        requests.append({"ids": ids, "frames": frames, "ms": ms,
                         "warm_ms": warm_ms})

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
        print(f"{tag}: batch member {i} ids={len(ids)} "
              f"frames={len(out) // hop} max_abs_vs_single={err:.3e}",
              flush=True)
    print(f"{tag}: batch of {len(texts)} ms={batch_ms:.3f} "
          f"max_abs_vs_single={worst:.3e}", flush=True)
    # the engine's own frame counts against the voice's trimmed audio
    padded, frames = voice.engine.synthesize_batch(
        [ids_of(t) for t in texts], seed=seed)
    bucket = voice.engine._frame_bucket_clamped(max(frames))
    check(padded.shape == (len(texts), bucket * hop),
          f"padded batch shape {padded.shape} vs frames {frames} (frame "
          f"bucket {bucket})")
    check([len(o) for o in outs] == [n * hop for n in frames],
          f"trimmed lengths {[len(o) for o in outs]} vs frames {frames}")
    check(worst <= batch_tol,
          f"padded batch differs from single decodes by {worst:.3e}")

    launches = read_launches(kernels, tag, "serving path")
    return voice, launches, requests


def path_vs_plain(torch, voice, seed, tag="path", stats_tol=KERNEL_TOL,
                  wave_tol=PATH_TOL):
    """One ragged batch through model.infer's two phases with the kernels
    on the card, and on the same noise through the plain versions on the
    host's CPU (float32: the parameters without kernel specs, as the model
    code runs them there; bf16: with their specs, whose wrappers run each
    kernel's plain version with the kernel's rounding points). Returns the
    waveform's max-abs difference."""
    from phoonnx_tpu_torch.models.vits import model as vits_model

    engine = voice.engine
    hp = engine.hp
    dev = engine.device
    cpu = torch.device("cpu")
    plain = vits_model.params_to_device(
        vits_model.detach_fused_specs(engine.params), cpu)
    if engine.dtype != torch.float32:
        plain = vits_model.attach_fused_specs(plain)
    gen = torch.Generator().manual_seed(seed)
    lengths = [101, 64]
    ids = torch.randint(4, 30, (2, 101), generator=gen)
    lens = torch.tensor(lengths, dtype=torch.int32)
    dp_noise = torch.randn(2, 101, 2, generator=gen).to(engine.dtype)
    with torch.inference_mode():
        outs = []
        for p, d in ((engine.params, dev), (plain, cpu)):
            outs.append(vits_model.infer_durations(
                p, hp, ids.to(d), lens.to(d), 1.0, 0.8,
                dp_noise=dp_noise.to(d)))
        (m_k, l_k, w_k, mask_k, _), (m_p, l_p, _, _, _) = outs
        enc_err = max((m_k.cpu() - m_p).float().abs().max().item(),
                      (l_k.cpu() - l_p).float().abs().max().item())
        frames = int(torch.clamp(w_k.sum(-1), min=1).max().item())
        frames = min(frames, 4096)
        prior = torch.randn(2, frames, hp.inter_channels, generator=gen)
        prior = prior.to(engine.dtype)
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
        wave_err = max(wave_err, (a_k[i, :span] - a_p[i, :span]).float()
                       .abs().max().item())
    print(f"{tag}: kernels on the card vs plain versions on the CPU: prior "
          f"stats max_abs={enc_err:.3e}, waveform max_abs on the valid "
          f"span={wave_err:.3e} (frames {y_k.tolist()})", flush=True)
    if engine.dtype != torch.float32:  # bf16: scaled by the magnitude
        stats_tol *= max(1.0, m_p.float().abs().max().item(),
                         l_p.float().abs().max().item())
    check(enc_err <= stats_tol, f"{tag}: encoder path differs by "
          f"{enc_err:.3e} (bound {stats_tol:.3e})")
    check(wave_err <= wave_tol, f"{tag}: waveform differs by "
          f"{wave_err:.3e} (bound {wave_tol:.3e})")
    return wave_err


# the streamed request: chunks of 128 latent frames with 32 of context on
# each side (the engine's defaults)
STREAM_CHUNK, STREAM_OVERLAP = 128, 32
# host-clock times of one request spread by ~30 % from run to run, and
# some voices' runs are bimodal: enough runs in turns that the quartiles
# of two timings separate where they differ by ~15 %
STREAM_RUNS = 41


def quartiles(xs):
    """(first quartile, median, third quartile) of xs."""
    q1, q2, q3 = statistics.quantiles(xs, n=4, method="inclusive")
    return q1, q2, q3


def compare_times(name, xs, ref_name, ref):
    """One line: the ratio of two timings' medians, their quartiles and
    whether the quartile ranges separate (only then does the ratio tell
    which is faster)."""
    (a1, a2, a3), (b1, b2, b3) = quartiles(xs), quartiles(ref)
    separated = a3 < b1 or b3 < a1
    return (f"{name}/{ref_name} {a2 / b2:.3f} (quartiles {name} "
            f"{a1:.3f}/{a2:.3f}/{a3:.3f}, {ref_name} {b1:.3f}/{b2:.3f}/"
            f"{b3:.3f}; {'separated' if separated else 'overlapping'})")


def stream_phase(torch, voice, seed, tag="stream", tol=None):
    """The ~241-id request of the serving path, streamed: the concatenated
    chunks against the monolithic request with the same seed, and the
    time to the first chunk, of the whole stream and of the monolithic
    request (host clock, STREAM_RUNS of each in turns, their quartiles).
    Returns the launches of the streamed calls alone: the counts are
    zeroed just before each streamed call and read just after it, so the
    monolithic requests timed beside them are not counted. Each stream
    must launch kernel C once a stage for every chunk."""
    from phoonnx_tpu_torch import SynthesisConfig
    from phoonnx_tpu_torch.infer.engine import FLOW_CONTEXT

    kernels = serving_kernels(voice.engine.dtype_str)
    tol = BATCH_TOL if tol is None else tol
    text = text_of(100, 3)
    cfg = SynthesisConfig(seed=seed, normalize_audio=False)
    n_ids = len(voice.phonemes_to_ids(voice.phonemize(text)[0]))
    n_stages = len(voice.engine.params["dec"]["ups"])
    launches = dict.fromkeys(kernels, 0)

    def monolithic():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        chunks = list(voice.synthesize(text, cfg))
        return chunks[0].audio_float_array, (time.perf_counter() - t0) * 1e3

    def streamed():
        torch.cuda.synchronize()
        reset_launches(kernels)
        t0 = time.perf_counter()
        parts, first_ms = [], None
        for chunk in voice.synthesize_streaming(
                text, cfg, chunk_frames=STREAM_CHUNK,
                overlap_frames=STREAM_OVERLAP):
            if first_ms is None:
                first_ms = (time.perf_counter() - t0) * 1e3
            parts.append(chunk.audio_float_array)
        total_ms = (time.perf_counter() - t0) * 1e3
        counts = launch_counts(kernels)
        check(counts["C"] == len(parts) * n_stages,
              f"{tag}: kernel C launched {counts['C']} times for "
              f"{len(parts)} chunks of {n_stages} stages")
        for k, n in counts.items():
            launches[k] += n
        return parts, first_ms, total_ms

    streamed()  # warm the window shapes
    mono_ms, first_ms, stream_ms = [], [], []
    for _ in range(STREAM_RUNS):
        whole, ms = monolithic()
        mono_ms.append(ms)
        parts, first, total = streamed()
        first_ms.append(first)
        stream_ms.append(total)
    hop = voice.engine.hp.total_upsample
    frames = len(whole) // hop
    window = STREAM_CHUNK + 2 * STREAM_OVERLAP
    check(frames > window + FLOW_CONTEXT,
          f"{tag}: {frames} frames do not reach past the first window and "
          "its flow context: the windowed decode would not run")
    stream = np.concatenate(parts)
    check(stream.shape == whole.shape,
          f"{tag}: {stream.shape} streamed samples vs {whole.shape}")
    check(bool(np.isfinite(stream).all()), f"{tag}: non-finite audio")
    err = float(np.abs(stream - whole).max())
    print(f"{tag}: ids={n_ids} frames={frames} chunks={len(parts)} "
          f"(chunk {STREAM_CHUNK}, overlap {STREAM_OVERLAP}) "
          f"first_chunk_ms={statistics.median(first_ms):.3f} "
          f"stream_ms={statistics.median(stream_ms):.3f} "
          f"monolithic_ms={statistics.median(mono_ms):.3f} (medians of "
          f"{STREAM_RUNS} in turns) max_abs_vs_monolithic={err:.3e}",
          flush=True)
    print(f"{tag}: " + compare_times("first", first_ms, "monolithic",
                                     mono_ms), flush=True)
    print(f"{tag}: " + compare_times("stream", stream_ms, "monolithic",
                                     mono_ms), flush=True)
    check(err <= tol,
          f"{tag}: the stream differs from the monolithic request by "
          f"{err:.3e} (bound {tol:.3e})")
    return report_launches(
        launches, tag, f"streaming path ({STREAM_RUNS + 1} streams, each "
        "counted from 0; monolithic requests not counted)"), mono_ms


# relative bound of the card's inverse STFT against the CPU's: both are
# float32 products and convs (TF32 off) summed in other orders
ISTFT_TOL = 1e-5


def istft_card_vs_cpu(torch, hp, seed, tag):
    """``ops/istft.istft`` on the card against the CPU at the decoder's
    shape for 512 latent frames (bands folded into the batch), with and
    without frame lengths, on phases that give the DC and Nyquist bins
    imaginary parts (which an inverse real FFT must drop)."""
    from phoonnx_tpu_torch.ops.istft import istft

    frames = 512
    for rate in hp.upsample_rates:
        frames *= rate
    frames += 1  # the decoder's silent pad frame
    b = 2 * hp.istft_bands
    n_freqs = hp.istft_n_fft // 2 + 1
    gen = torch.Generator().manual_seed(seed)
    mag = torch.exp(torch.randn(b, frames, n_freqs, generator=gen))
    phase = math.pi * torch.sin(torch.randn(b, frames, n_freqs,
                                            generator=gen))
    lengths = torch.tensor([frames, frames // 3 + 1] * hp.istft_bands,
                           dtype=torch.int32)
    mag = mag * (torch.arange(frames)[None, :]
                 < lengths[:, None])[..., None]
    args = (hp.istft_n_fft, hp.istft_hop, hp.istft_n_fft)
    for fl in (None, lengths):
        want = istft(mag, phase, *args, fl)
        got = istft(mag.cuda(), phase.cuda(), *args,
                    None if fl is None else fl.cuda())
        torch.cuda.synchronize()
        check(got.shape == want.shape,
              f"{tag}: istft shape {tuple(got.shape)} vs {tuple(want.shape)}")
        scale = want.abs().max().item()
        err = (got.cpu() - want).abs().max().item()
        print(f"{tag}: istft on the card vs the CPU, [{b}, {frames}, "
              f"{n_freqs}] frame_lengths={'no' if fl is None else 'yes'}: "
              f"max_abs={err:.3e} of max {scale:.3e}", flush=True)
        check(err <= ISTFT_TOL * scale,
              f"{tag}: istft on the card differs by {err:.3e} (max "
              f"{scale:.3e})")


def decode_without_sync(torch, engine, tag):
    """A padded decode of a stream's window (kernel C's stages, the heads,
    the iSTFT and the PQMF bank) after a warm call makes no host sync,
    such as a copy of a constant from host memory: CUDA's sync debug mode
    raises on one."""
    from phoonnx_tpu_torch.models.vits import model as vits_model

    window = STREAM_CHUNK + 2 * STREAM_OVERLAP
    gen = torch.Generator(device="cuda").manual_seed(0)
    z = torch.randn(2, window, engine.hp.inter_channels, generator=gen,
                    device="cuda")
    valid = torch.tensor([window, window // 3], dtype=torch.int32,
                         device="cuda")
    with torch.inference_mode():
        vits_model.decode_audio(engine.params, engine.hp, z,
                                frame_lengths=valid)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            vits_model.decode_audio(engine.params, engine.hp, z,
                                    frame_lengths=valid)
        except RuntimeError as err:
            fail(f"{tag}: a window's decode synchronizes the host: {err}")
        finally:
            torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
    print(f"{tag}: a padded window decode [2, {window}] made no host sync "
          "(sync debug mode 'error')", flush=True)


def istft_phase(torch, quality, seed, root: Path, medium_ms=None):
    """An iSTFT voice (``quality``: medium-istft or medium-mb-istft) as a
    user serves it: written with the port's ONNX writer, loaded with
    ``TTSVoice.load`` on the default device, three single requests and a
    ragged batch of four, the path against the plain versions on the
    CPU, one streamed request; then kernel C on its stages at B=1 and 512
    frames against its plain version, and the card's iSTFT against the
    CPU's. Returns (kernel C's stage totals, launches by path)."""
    hp, params = model_params(torch, quality, seed)
    tag = f"istft {quality}"
    model_path, config_path = write_voice(
        torch, params, hp, root / "build" / "chip_smoke", name=quality)
    voice, served, _ = main_path(torch, model_path, config_path, seed, tag)
    got = voice.engine.hp
    print(f"{tag}: decoder_type={got.decoder_type} istft_n_fft="
          f"{got.istft_n_fft} istft_hop={got.istft_hop} istft_bands="
          f"{got.istft_bands} upsample_rates={got.upsample_rates} "
          f"total_upsample={got.total_upsample}", flush=True)
    check((got.decoder_type, got.istft_bands, got.total_upsample)
          == ("istft", hp.istft_bands, 256),
          f"{tag}: the loaded voice is not the {quality} decoder")
    path_vs_plain(torch, voice, seed + 1, tag)
    streamed, mono_ms = stream_phase(torch, voice, seed + 2, tag)
    if medium_ms:
        print(f"{tag}: " + compare_times(
            "monolithic", mono_ms, "medium's", medium_ms)
            + " (the 241-id request; the medium voice's runs from its "
            "stream phase, earlier in this call)", flush=True)

    dec = voice.engine.params["dec"]
    gen = torch.Generator(device="cuda").manual_seed(seed)
    total = compare_stages(torch, dec["fused_stages"], dec["upsample_rates"],
                           [512], gen, torch.device("cuda"), f"{quality} ")
    stage_total_line(total, f"{quality} {len(dec['fused_stages'])} stages "
                     "B=1 512 frames")
    istft_card_vs_cpu(torch, got, seed + 3, tag)
    decode_without_sync(torch, voice.engine, tag)
    return total, {f"{quality} serving path": served,
                   f"{quality} streaming path": streamed}


def kernels_in_call(torch, fn, label, kernel_name):
    """The device work torch.profiler sees inside one call of fn: print
    each kernel, memcpy and memset by name and count, and check that the
    port's kernel ran exactly once with no copy or fill on the device.
    Returns the number of device operations."""
    from collections import Counter

    from torch.profiler import ProfilerActivity, profile

    fn()  # warm: the first call loads the library
    torch.cuda.synchronize()
    for attempt in range(3):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        names = Counter(evt.name for evt in prof.events()
                        if str(evt.device_type).endswith("CUDA")
                        and not getattr(evt, "is_user_annotation", False))
        total = sum(names.values())
        if total:
            break
        # a session can come back without its device records (seen on
        # the H100 after several sessions in one process)
        print(f"profile: kernel {label}: the profiler saw no device "
              "operation in the call; profiling again", flush=True)
        time.sleep(1.0)
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
    grid = tiling.grid_size(*port_cuda.occupancy(
        module.LIBRARY, query[0], args[0].device, *query[1:]))
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


def near_tie_split(want, got, ref_logits, tol, eos_id, label):
    """Greedy tokens ``got`` against the reference's ``want`` (pre-EOS
    lists) under the near-tie rule. ``ref_logits`` [T, V] are the
    reference's logits teacher-forced on its own tokens; where a step's
    top-2 gap is below ``tol`` the other side's rounding may pick the
    other token and the decodes split from there. The tokens (EOS
    included) must agree up to the first such step; a split before it
    fails. Prints both steps and returns (first near tie, first
    difference or None)."""
    ref_logits = np.asarray(ref_logits, np.float32)
    top2 = np.sort(ref_logits, axis=-1)[:, -2:]
    small = np.flatnonzero(top2[:, 1] - top2[:, 0] < tol)
    tie = int(small[0]) if small.size else len(ref_logits)
    w, g = list(want) + [eos_id], list(got) + [eos_id]
    diff = next((i for i in range(min(len(w), len(g), len(ref_logits)))
                 if w[i] != g[i]), None)
    print(f"{label}: {len(want)} vs {len(got)} tokens, first near tie "
          f"(top-2 gap < {tol:.3g}) at step {tie}, first difference at "
          f"step {diff}", flush=True)
    check(diff is None or diff >= tie,
          f"{label}: the decodes split at step {diff}, before the first "
          f"near tie at step {tie}")
    return tie, diff


# ---------------------------------------------------------------------------
# foreign voices: the ONNX graph engine on the card
# ---------------------------------------------------------------------------

# the card's seeded waveform against the port's numpy interpreter on the
# host, as a share of the peak: the port's end-to-end bound
# (ARCHITECTURE.md:86-89)
ONNX_TOL = 1e-3
ONNX_RUNS = 11
ONNX_IDS = (58, 241)


def all_kernels():
    """A, B, C, the noise kernel (float32 builds) and D, by name: their
    ``LAUNCHES`` keys."""
    kernels = serving_kernels()
    kernels["D"] = "phoonnx_tpu_torch.ops.mas"
    return kernels


def ids_of(voice, n_ids: int, offset: int):
    """Exactly ``n_ids`` phoneme ids of a RAW text."""
    ids = voice.phonemes_to_ids(voice.phonemize(text_of_ids(n_ids + 8,
                                                            offset))[0])
    check(len(ids) >= n_ids, f"a text of {len(ids)} ids, {n_ids} wanted")
    return ids[:n_ids - 1] + ids[-1:]


def onnx_feeds(ids):
    """The fallback engine's feeds of a request at the default scales: ids
    padded to its bucket."""
    from phoonnx_tpu_torch.infer.onnx_engine import _bucket_len

    n = len(ids)
    return {"input": np.asarray([ids + [0] * (_bucket_len(n) - n)],
                                np.int64),
            "input_lengths": np.asarray([n], np.int64),
            "scales": np.asarray((0.667, 1.0, 0.8), np.float32)}


def duration_distance(engine, feeds, seed, tag):
    """Print, for each ``Ceil`` of the graph (durations to frames), the
    distance of its input to the nearest integer on the card and on the
    host, and where the two ceilings differ."""
    for node in engine.runner.model.nodes:
        if node.op_type != "Ceil":
            continue
        vals = []
        for run in (engine.runner.run, engine.executor.run):
            engine._reseed(seed)
            vals.append(np.asarray(run(feeds, outputs=[node.inputs[0]])[0],
                                   np.float64).reshape(-1))
        card, host = vals
        dist = np.abs(card - np.round(card))
        print(f"{tag}: Ceil {node.name}: {len(card)} values, nearest "
              f"integer distance min {dist.min():.3e} on the card; ceilings "
              f"differ at {np.flatnonzero(np.ceil(card) != np.ceil(host))}",
              flush=True)


def first_difference(engine, feeds, seed):
    """The first node whose output differs between two seeded runs on the
    card, as (op type, node name)."""
    names = [o for n in engine.runner.model.nodes for o in n.outputs if o]
    runs = []
    for _ in range(2):
        engine._reseed(seed)
        runs.append(engine.runner.run(feeds, outputs=names))
    owner = {o: n for n in engine.runner.model.nodes for o in n.outputs}
    for name, a, b in zip(names, *runs):
        if not np.array_equal(a, b, equal_nan=True):
            return owner[name].op_type, owner[name].name
    return None


def onnx_voice_check(torch, voice, kind, seed, tag):
    """One foreign voice on the card: the graph engine with its runner on
    CUDA; each node's output place (no floating or data-sized value on
    the host); two seeded calls equal; the card's 58-id waveform against
    the host interpreter on the same feeds and seed."""
    from phoonnx_tpu_torch.infer.onnx_engine import OnnxFallbackEngine

    engine = voice.engine
    check(isinstance(engine, OnnxFallbackEngine)
          and engine.runner.device.type == "cuda",
          f"{tag}: the {kind} foreign voice loaded to "
          f"{type(engine).__name__} on "
          f"{getattr(getattr(engine, 'runner', None), 'device', None)}")
    ids = ids_of(voice, ONNX_IDS[0], 5)
    feeds = onnx_feeds(ids)
    a = engine.synthesize_ids(ids, seed=seed)
    stats = engine.runner.last_run
    ids_numel = feeds["input"].size
    bad = [h for h in stats.host_outputs
           if np.dtype(h[2]).kind not in "biu" or h[3] > ids_numel]
    print(f"{tag}: {kind}: {stats.nodes} nodes, outputs by place "
          f"{dict(stats.outputs)}, host nodes by op {dict(stats.host_nodes)}"
          f", host reads of device values by op {dict(stats.reads)}, "
          f"host-to-device copies {stats.uploads} (the noise draws and "
          "small integer inputs)", flush=True)
    check(not bad, f"{tag}: {kind}: floating or data-sized values on the "
          f"host: {bad[:5]}")
    b = engine.synthesize_ids(ids, seed=seed)
    if not np.array_equal(a, b):
        fail(f"{tag}: {kind}: two seeded calls on the card differ, first "
             f"at {first_difference(engine, feeds, seed)}")
    engine._reseed(seed)
    t0 = time.perf_counter()
    want = np.asarray(engine.executor.run(feeds)[0], np.float32).reshape(-1)
    host_s = time.perf_counter() - t0
    if a.shape != want.shape:
        duration_distance(engine, feeds, seed, tag)
        fail(f"{tag}: {kind}: the card gave {a.shape} samples, the host "
             f"interpreter {want.shape}")
    peak = float(np.abs(want).max())
    err = float(np.abs(a - want).max())
    print(f"{tag}: {kind}: card vs host interpreter, {len(ids)} ids, seed "
          f"{seed}: {len(a)} samples each, max_abs {err:.3e} of peak "
          f"{peak:.4f} ({err / peak:.3e}, bound {ONNX_TOL:g}); host "
          f"interpreter {host_s:.2f} s", flush=True)
    check(np.isfinite(a).all() and err <= ONNX_TOL * peak,
          f"{tag}: {kind}: card vs host {err:.3e} of peak {peak:.4f}")
    return a


def onnx_timings(torch, voices, native, seed, tag):
    """The 58- and 241-id requests of each foreign voice and of the
    native voice of the same weights, ONNX_RUNS in turns (host clock
    around a call that returns audio on the host), with each one's device
    kernels, busy time and idle share from one profiled request."""
    for n_ids in ONNX_IDS:
        ids = ids_of(native, n_ids, 7)
        engines = dict(voices, native=native)
        times = {k: [] for k in engines}
        for v in engines.values():  # the native engine captures its graphs
            v.engine.synthesize_ids(ids, seed=seed)
        for _ in range(ONNX_RUNS):
            for k, v in engines.items():
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                v.engine.synthesize_ids(ids, seed=seed)
                times[k].append((time.perf_counter() - t0) * 1e3)
        for k, v in engines.items():
            q = quartiles(times[k])
            wall_us, busy_us, rows = device_profile(
                torch, partial(v.engine.synthesize_ids, ids, seed=seed),
                f"{tag} {k}: one request of {len(ids)} ids", top=0)
            extra = ""
            if k != "native":
                st = v.engine.runner.last_run
                extra = (f", {st.nodes} nodes, "
                         f"{sum(st.reads.values())} host reads")
            print(f"{tag}: {k} {len(ids)} ids: request ms median "
                  f"{q[1]:.3f} (quartiles {q[0]:.3f}-{q[2]:.3f}, "
                  f"{ONNX_RUNS} runs in turns), "
                  f"{sum(r[1] for r in rows)} device kernels, device busy "
                  f"{busy_us / 1e3:.3f} ms of {wall_us / 1e3:.3f}, idle share "
                  f"{1 - busy_us / wall_us:.3f}{extra}", flush=True)


def onnx_served(torch, voice, seed, tag):
    """A few seeded requests through TTSServer over the foreign voice,
    each held to the engine's own call within one int16 step."""
    from phoonnx_tpu_torch.serve import TTSServer

    srv = TTSServer(voice, port=0, max_batch=16, max_wait_ms=5.0)
    srv.start()
    try:
        for i, n_ids in enumerate((20, 58, 120)):
            text = text_of_ids(n_ids, 11 + i)
            ids = voice.phonemes_to_ids(voice.phonemize(text)[0])
            got, ms = serve_post(srv, {"text": text, "seed": seed + i})
            want = pcm16(voice.engine.synthesize_ids(ids, seed=seed + i))
            steps = (lsb(got, want) if got.shape == want.shape
                     else None)
            print(f"{tag}: served {len(ids)} ids in {ms:.1f} ms, "
                  f"{len(got)} samples, {steps} int16 steps from the "
                  "engine", flush=True)
            check(steps is not None and steps <= STREAM_LSB,
                  f"{tag}: served request of {len(ids)} ids: "
                  f"{got.shape} vs {want.shape}, {steps} steps")
    finally:
        srv.stop()


def onnx_phase(torch, params, hp, native_files, seed, root: Path,
               tag="onnx"):
    """Foreign voices (the medium weights in the port's exported graph,
    every initializer renamed; float32 and int8 QDQ) through
    ``TTSVoice.load`` on the default device: the ONNX graph engine on the
    card, none of kernels A-D launched."""
    from phoonnx_tpu_torch import TTSVoice

    t_start = time.perf_counter()
    out = root / "build" / "chip_smoke"
    files = {"float32": write_foreign_voice(torch, params, hp, out),
             "int8": write_foreign_voice(torch, params, hp, out,
                                         "foreign_q8", quantize=True)}
    kernels = all_kernels()
    reset_launches(kernels)
    voices = {}
    for kind, (model_path, config_path) in files.items():
        t0 = time.perf_counter()
        voices[kind] = TTSVoice.load(str(model_path), str(config_path))
        print(f"{tag}: {kind}: {model_path.stat().st_size / 2 ** 20:.1f} MiB"
              f", {len(voices[kind].engine.runner.model.nodes)} nodes, "
              f"loaded in {time.perf_counter() - t0:.2f} s", flush=True)
        onnx_voice_check(torch, voices[kind], kind, seed, tag)
    native = TTSVoice.load(*map(str, native_files))
    counts = launch_counts(kernels)
    check(not any(counts.values()),
          f"{tag}: the graph engine launched kernels {counts}")
    onnx_timings(torch, voices, native, seed, tag)
    reset_launches(kernels)
    onnx_served(torch, voices["float32"], seed, tag)
    counts = launch_counts(kernels)
    print(f"{tag}: launches of A-D in the served requests {counts}",
          flush=True)
    check(not any(counts.values()),
          f"{tag}: the served foreign voice launched kernels {counts}")
    print(f"{tag}: the phase took {time.perf_counter() - t_start:.1f} s",
          flush=True)


def precision_phase(torch, native_files, seed, tag="precision"):
    """matmul_precision per engine: a default engine's outputs, bit for
    bit, before and after a "high" engine of the same voice captures and
    replays on another thread; a fresh default engine capturing beside a
    fresh "high" one gives the same; both TF32 flags off afterwards;
    "highest" equal to the default; "high" against the default and both
    engines' request ms."""
    import threading

    from phoonnx_tpu_torch import TTSVoice

    def load(prec=None):
        return TTSVoice.load(*map(str, native_files),
                             matmul_precision=prec).engine

    voice = TTSVoice.load(*map(str, native_files))
    default = voice.engine
    ids = ids_of(voice, 97, 3)
    ref = default.synthesize_ids(ids, seed=seed)

    def in_pair(fn_a, fn_b):
        out, errors = {}, []
        start = threading.Barrier(2)

        def run(key, fn):
            try:
                start.wait(timeout=60)
                out[key] = fn()
            except Exception as exc:  # reported below
                errors.append(exc)

        threads = [threading.Thread(target=run, args=("a", fn_a)),
                   threading.Thread(target=run, args=("b", fn_b))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
            check(not t.is_alive(), f"{tag}: a thread did not finish")
        check(not errors, f"{tag}: {errors}")
        return out["a"], out["b"]

    high = load("high")
    during, high_out = in_pair(
        lambda: [default.synthesize_ids(ids, seed=seed) for _ in range(3)],
        lambda: [high.synthesize_ids(ids, seed=seed) for _ in range(3)])
    after = default.synthesize_ids(ids, seed=seed)
    check(all(np.array_equal(x, ref) for x in during + [after]),
          f"{tag}: the default engine's output moved beside a high engine")
    fresh, fresh_high = load(), load("high")
    got, _ = in_pair(lambda: fresh.synthesize_ids(ids, seed=seed),
                     lambda: fresh_high.synthesize_ids(ids, seed=seed))
    check(np.array_equal(got, ref),
          f"{tag}: a default engine captured beside a high one differs")
    flags = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    check(flags == (False, False), f"{tag}: TF32 flags left at {flags}")
    highest = load("highest").synthesize_ids(ids, seed=seed)
    check(np.array_equal(highest, ref), f"{tag}: highest differs from "
          f"the default by {np.abs(highest - ref).max():.3e}")
    h = high_out[-1]
    diff = (float(np.abs(h - ref).max()) if h.shape == ref.shape
            else None)
    times = {"default": [], "high": []}
    for _ in range(ONNX_RUNS):
        for k, e in (("default", default), ("high", high)):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            e.synthesize_ids(ids, seed=seed)
            times[k].append((time.perf_counter() - t0) * 1e3)
    print(f"{tag}: {len(ids)} ids: default and highest equal bit for bit "
          f"(before, beside and after a high engine on another thread, and "
          f"a default engine captured beside a high one); high vs default: "
          f"{len(h)} vs {len(ref)} samples, max_abs "
          + (f"{diff:.3e}" if diff is not None else "n/a (lengths differ)")
          + f"; request ms median default "
          f"{statistics.median(times['default']):.3f}, high "
          f"{statistics.median(times['high']):.3f} ({ONNX_RUNS} in turns); "
          f"flags after {flags}", flush=True)


# ---------------------------------------------------------------------------
# the engine's programs as CUDA graphs
# ---------------------------------------------------------------------------

# a replay runs the kernels of the eager call in the same order; a plain op
# may take another cuDNN or cuBLAS algorithm under capture, within rounding
GRAPH_TOL = 1e-6


def as_tuple(out):
    return out if isinstance(out, tuple) else (out,)


def max_diff(torch, got, want):
    """(max-abs difference, torch.equal) of two program outputs: tuples
    of tensors or None of the same structure."""
    err, equal = 0.0, True
    for g, w in zip(as_tuple(got), as_tuple(want), strict=True):
        check((g is None) == (w is None), "program outputs differ in form")
        if g is None:
            continue
        check(g.shape == w.shape and g.dtype == w.dtype,
              f"program output {tuple(g.shape)} {g.dtype} vs "
              f"{tuple(w.shape)} {w.dtype}")
        err = max(err, (g.double() - w.double()).abs().max().item())
        equal = equal and torch.equal(g, w)
    return err, equal


@contextlib.contextmanager
def launch_counts_kept(kernels):
    """Keep the launch counts across a block that captures kernels: a
    capture records launches without running them."""
    from phoonnx_tpu_torch import cuda as port_cuda

    kept = launch_counts(kernels)
    try:
        yield
    finally:
        for name, key in kernels.items():
            port_cuda.LAUNCHES[key] = kept[name]


def graph_probe(torch, params, seed, dev):
    """Each kind of launch the engine's programs make, captured with
    torch.cuda.graph and replayed: the grid-barrier probe and kernels A
    and B (cooperative launches of persistent blocks, csrc/persist.cuh)
    and kernel C (a plain ctypes launch), each against an eager launch on
    the same inputs."""
    from phoonnx_tpu_torch import cuda as port_cuda
    from phoonnx_tpu_torch.models.vits import (fused_encoder, fused_flow,
                                               fused_stage)

    probe = port_cuda.function("fused_flow", "phx_barrier_probe",
                               [port_cuda.c_int, port_cuda.c_int,
                                port_cuda.c_ptr])
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        status = probe(16, 132, torch.cuda.current_stream().cuda_stream)
    check(status == 0, f"graph: capturing the barrier probe returned "
          f"{status}")
    graph.replay()
    torch.cuda.synchronize()
    print("graph: a cooperative launch (phx_barrier_probe, 132 blocks, 16 "
          "grid barriers) captured and replayed", flush=True)

    gen = torch.Generator(device=dev).manual_seed(seed)
    mask = (torch.arange(128, device=dev) < 101).float()[None, :, None]
    x = torch.randn(1, 128, 192, device=dev, generator=gen) * mask
    z_mask = (torch.arange(512, device=dev) < 400).float()[None, :, None]
    z = torch.randn(1, 512, 192, device=dev, generator=gen) * z_mask
    stage = params["dec"]["fused_stages"][1]
    xc = torch.randn(1, 4096, stage["W"].shape[1], device=dev,
                     generator=gen) * 0.5
    valid = torch.tensor([3001], dtype=torch.int32, device=dev)
    enc = params["enc_p"]["encoder"]["fused"]
    flow = params["flow"]["fused_rev"]
    cases = (("A", "cooperative",
              lambda: fused_encoder.apply(enc, x, mask)),
             ("B", "cooperative", lambda: fused_flow.apply(flow, z, z_mask)),
             ("C", "ctypes", lambda: fused_stage.apply_group(stage, xc,
                                                             valid)))
    with launch_counts_kept(serving_kernels()):
        for name, kind, fn in cases:
            want = fn()
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph):
                got = fn()
            graph.replay()
            torch.cuda.synchronize()
            err, equal = max_diff(torch, got, want)
            print(f"graph: kernel {name} ({kind} launch) captured and "
                  f"replayed: torch.equal to the eager launch {equal}, "
                  f"max_abs={err:.3e}", flush=True)
            check(err <= GRAPH_TOL, f"graph: kernel {name} replay differs "
                  f"from its eager launch by {err:.3e}")


def replay_vs_eager(torch, engine, key, fn, args):
    """(max-abs, torch.equal) of a replay of the engine's graph at ``key``
    (captured here if it is new) against the same program called eagerly
    on the same inputs. The replay runs under CUDA's sync debug mode
    'error': no host sync inside a replayed program."""
    engine._run(key, fn, *args)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = engine._run(key, fn, *args)
    except RuntimeError as err:
        fail(f"graph: a replay of {key} synchronizes the host: {err}")
    finally:
        torch.cuda.set_sync_debug_mode(0)
    got = tuple(None if t is None else t.clone() for t in as_tuple(got))
    want = fn(*[a.to(engine.device) if isinstance(a, torch.Tensor) else a
                for a in args])
    torch.cuda.synchronize()
    return max_diff(torch, got, want)


def graphs_vs_eager(torch, engine, ids, seed, tag="graph"):
    """Every serving program of the engine at the buckets of ``ids`` (one
    utterance), its graph replayed against the program called eagerly:
    phase 1, phase 2, latents, fused, first chunk and decode chunk (three
    window positions on one graph); then one fused graph replayed at two
    length scales and two noise scales, each against eager: the scales
    are inputs of the graph, not baked into it. Every replay must be
    ``torch.equal`` to eager."""
    from phoonnx_tpu_torch.infer.engine import FLOW_CONTEXT

    dev = engine.device
    tokens, lens, sid, dp_noise, seeds = engine._batch_inputs([ids], [0],
                                                              seed)
    t_bucket = tokens.shape[1]
    scales = engine._scales(0.667, 1.0, 0.8)
    host1 = (tokens, lens, sid, scales, dp_noise)
    m_p, logs_p, w_ceil, x_mask, g, frames = engine._phase1(
        *[a.to(dev) for a in host1])
    n = int(frames.max())
    f_bucket = engine._frame_bucket_clamped(n)
    # the noise as the engine draws it, on the card: the graphs' inputs
    # are the tensors the engine's own calls hand them
    prior = engine._prior(seeds, frames, f_bucket)
    phase2_in = (m_p, logs_p, w_ceil, x_mask, g, scales, prior)
    fused_bucket = engine._fused_bucket(t_bucket)
    fused_prior = engine._prior(seeds, None, fused_bucket)
    window = STREAM_CHUNK + 2 * STREAM_OVERLAP
    z, _ = engine._latents(*[a.to(dev) if a is not None else None
                             for a in phase2_in], max_frames=f_bucket)
    programs = [
        ("phase1", ("phase1", 1, t_bucket), engine._phase1, host1),
        ("phase2", ("phase2", 1, t_bucket, f_bucket),
         partial(engine._phase2, max_frames=f_bucket), phase2_in),
        ("latents", ("latents", 1, t_bucket, f_bucket),
         partial(engine._latents, max_frames=f_bucket), phase2_in),
        ("fused", ("fused", 1, t_bucket, fused_bucket),
         partial(engine._fused, max_frames=fused_bucket),
         host1 + (fused_prior,)),
        ("first_chunk", ("first_chunk", t_bucket, STREAM_CHUNK,
                         STREAM_OVERLAP),
         partial(engine._first_chunk, window=window),
         host1 + (engine._prior(seeds, None, window + FLOW_CONTEXT),)),
    ]
    decode_key = ("decode_chunk", 1, f_bucket, STREAM_CHUNK, STREAM_OVERLAP)
    decode = partial(engine._decode_chunk, window=window, chunk=STREAM_CHUNK)
    # a frame bucket shorter than the window has no windowed decode
    starts = (0, (f_bucket - window) // 2, f_bucket - window) \
        if f_bucket >= window else ()
    for start in starts:
        programs.append((f"decode_chunk start={start}", decode_key, decode,
                         (z, torch.tensor(start), torch.tensor(STREAM_OVERLAP),
                          torch.tensor(n), g)))
    worst = 0.0
    for name, key, fn, args in programs:
        err, equal = replay_vs_eager(torch, engine, key, fn, args)
        worst = max(worst, err)
        print(f"{tag}: {name} key={key} replay vs eager max_abs={err:.3e} "
              f"torch.equal={equal}", flush=True)
        check(equal,
              f"{tag}: {name} replay differs from eager by {err:.3e}")

    key = ("fused", 1, t_bucket, fused_bucket)
    fused = partial(engine._fused, max_frames=fused_bucket)
    outs = []
    for noise_scale, length_scale in ((0.667, 1.0), (0.667, 1.25),
                                      (0.3, 1.0), (0.3, 1.25)):
        s = engine._scales(noise_scale, length_scale, 0.8)
        args = (tokens, lens, sid, s, dp_noise, fused_prior)
        err, equal = replay_vs_eager(torch, engine, key, fused, args)
        outs.append(engine._run(key, fused, *args)[0].clone())
        print(f"{tag}: scales noise_scale={noise_scale} length_scale="
              f"{length_scale} on one fused graph {key}: replay vs eager "
              f"max_abs={err:.3e} torch.equal={equal}", flush=True)
        check(equal,
              f"{tag}: the fused graph at scales "
              f"({noise_scale}, {length_scale}) differs from eager by "
              f"{err:.3e}")
    check(all(not torch.equal(outs[0], o) for o in outs[1:]),
          f"{tag}: two scales gave the same audio: a scale is baked in")
    return worst


def eager_request(torch, engine, ids, seed):
    """``engine.synthesize_ids(ids, seed=seed)`` in two phases through the
    same programs called eagerly on the card, as the port ran before its
    graphs: the inputs copied to the card, phase 1, the host's read of the
    frame count, the prior noise (drawn on the card), phase 2, the
    fetch."""
    dev = engine.device
    tokens, lens, sid, dp_noise, seeds = engine._batch_inputs([ids], [0],
                                                              seed)
    scales = engine._scales(0.667, 1.0, 0.8)
    host = [t.pin_memory().to(dev, non_blocking=True)
            for t in (tokens, lens, sid, scales)] + [dp_noise]
    m_p, logs_p, w_ceil, x_mask, g, frames = engine._phase1(*host)
    f_bucket = engine._frame_bucket_clamped(int(frames.max()))
    prior = engine._prior(seeds, frames, f_bucket)
    audio, y_lengths = engine._phase2(m_p, logs_p, w_ceil, x_mask, g,
                                      host[3], prior, max_frames=f_bucket)
    audio, y_lengths = audio.cpu().numpy(), y_lengths.cpu()
    return audio[0, :int(y_lengths[0]) * engine.hp.total_upsample]


class HostClock:
    """Host time spent inside some of an engine's methods, and their calls,
    by name, while ``on``: wraps them on the instance, unwraps on
    ``close``."""

    def __init__(self, engine, names):
        self.engine = engine
        self.on = False
        self.ms = dict.fromkeys(names, 0.0)
        self.calls = dict.fromkeys(names, 0)
        for name in names:
            setattr(engine, name, self._timed(name, getattr(engine, name)))

    def _timed(self, name, fn):
        def run(*args, **kwargs):
            t0 = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                if self.on:
                    self.ms[name] += (time.perf_counter() - t0) * 1e3
                    self.calls[name] += 1
        return run

    def reset(self):
        self.ms = dict.fromkeys(self.ms, 0.0)
        self.calls = dict.fromkeys(self.calls, 0)

    def close(self):
        for name in self.ms:
            delattr(self.engine, name)


def request_phase(torch, voice, seed, profile, tag="request"):
    """The ~241-id request of the serving path: the engine's two-phase
    graphs against the same programs called eagerly, STREAM_RUNS of each
    in turns (host clock, quartiles); their device-busy time and the
    device's idle share from one profiled call each; and the host's time
    by item inside the graphed calls."""
    engine = voice.engine
    text = text_of(100, 3)
    ids = voice.phonemes_to_ids(voice.phonemize(text)[0])

    clock = None

    def graphed():
        torch.cuda.synchronize()
        if clock is not None:
            clock.on = True
        t0 = time.perf_counter()
        out = engine.synthesize_ids(ids, seed=seed)
        ms = (time.perf_counter() - t0) * 1e3
        if clock is not None:
            clock.on = False
        return out, ms

    def eager():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = eager_request(torch, engine, ids, seed)
        return out, (time.perf_counter() - t0) * 1e3

    from phoonnx_tpu_torch.ops import noise

    a, _ = graphed()
    b, _ = eager()
    err = float(np.abs(a - b).max())
    check(a.shape == b.shape and err <= GRAPH_TOL,
          f"{tag}: graphs vs eager programs {a.shape} {b.shape} max_abs "
          f"{err:.3e}")
    before = noise.launches
    graphed()
    drawn = noise.launches - before
    print(f"{tag}: noise kernel launches in one graphed request: {drawn} "
          "(the duration noise and the prior)", flush=True)
    check(drawn == 2, f"{tag}: {drawn} noise launches in one request")
    items = ("_batch_inputs", "_prior", "_run", "_ready")
    clock = HostClock(engine, items)
    g_ms, e_ms = [], []
    try:
        for _ in range(STREAM_RUNS):
            e_ms.append(eager()[1])
            g_ms.append(graphed()[1])
    finally:
        clock.close()
    frames = len(a) // engine.hp.total_upsample
    print(f"{tag}: ids={len(ids)} frames={frames} frame bucket "
          f"{engine._frame_bucket_clamped(frames)}: graphs_ms="
          f"{statistics.median(g_ms):.3f} eager_ms="
          f"{statistics.median(e_ms):.3f} (medians of {STREAM_RUNS} in "
          f"turns) max_abs_graphs_vs_eager={err:.3e}", flush=True)
    print(f"{tag}: " + compare_times("graphs", g_ms, "eager", e_ms),
          flush=True)
    per = {k: v / STREAM_RUNS for k, v in clock.ms.items()}
    print(f"{tag}: host ms a graphed request, by item (means of "
          f"{STREAM_RUNS}): ids and duration noise "
          f"{per['_batch_inputs']:.3f}, prior noise draw {per['_prior']:.3f}"
          f", input staging and replays {per['_run']:.3f}, waits for the "
          f"device (the phase boundary's frame count and the audio fetch) "
          f"{per['_ready']:.3f}, the rest "
          f"{statistics.mean(g_ms) - sum(per.values()):.3f} of a mean "
          f"{statistics.mean(g_ms):.3f}", flush=True)
    top = 20 if profile else 0
    for name, fn in (("graphs", graphed), ("eager", eager)):
        wall_us, busy_us, _ = device_profile(
            torch, fn, f"{tag} {name}: one request of {len(ids)} ids",
            top=top)
    return {"graphs_ms": g_ms, "eager_ms": e_ms}


def surface_phase(torch, voice, seed, tag="surface"):
    """The rest of the engine's surface on the medium voice: fused mode
    against two-phase on each utterance's valid span (same seed, the
    budget not reached), synthesize_many of four utterances against their
    own fused calls, the int16 fetch against float32, and warmup() of a
    fresh engine with the graphs it captures and the memory they hold."""
    from phoonnx_tpu_torch.infer import VitsEngine
    from phoonnx_tpu_torch.infer.engine import _bucket_for

    engine = voice.engine
    up = engine.hp.total_upsample
    fused = VitsEngine(engine.params, engine.hp, mode="fused")
    utts = [voice.phonemes_to_ids(voice.phonemize(text_of(n, k))[0])
            for k, n in enumerate((40, 100, 16, 70))]
    worst = 0.0
    for i, ids in enumerate(utts):
        two = engine.synthesize_ids(ids, seed=seed + i)
        one, frames = fused.synthesize_batch([ids], seed=seed + i)
        t_bucket = _bucket_for(len(ids), engine.text_buckets)
        budget = fused._fused_bucket(t_bucket)
        check(frames[0] < budget, f"{tag}: fused budget {budget} reached")
        check(len(two) == frames[0] * up, f"{tag}: fused frames "
              f"{frames[0]} vs two-phase {len(two) // up}")
        err = float(np.abs(one[0, :len(two)] - two).max())
        worst = max(worst, err)
        print(f"{tag}: fused vs two-phase ids={len(ids)} frames={frames[0]} "
              f"(fused budget {budget}) max_abs={err:.3e}", flush=True)
    check(worst <= BATCH_TOL, f"{tag}: fused differs from two-phase by "
          f"{worst:.3e}")

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    many = fused.synthesize_many(utts, seed=seed)
    many_ms = (time.perf_counter() - t0) * 1e3
    worst = 0.0
    for i, (ids, out) in enumerate(zip(utts, many)):
        want = fused.synthesize_ids(ids, seed=seed + i)
        check(out.shape == want.shape, f"{tag}: synthesize_many member {i} "
              f"{out.shape} vs {want.shape}")
        worst = max(worst, float(np.abs(out - want).max()))
    print(f"{tag}: synthesize_many of {len(utts)} in {many_ms:.3f} ms, "
          f"each against its own fused synthesize_ids(seed=base+i): "
          f"max_abs={worst:.3e}", flush=True)
    check(worst <= GRAPH_TOL, f"{tag}: synthesize_many differs by {worst:.3e}")

    pcm = VitsEngine(engine.params, engine.hp, fetch_pcm16=True)
    ids = utts[1]
    a = engine.synthesize_ids(ids, seed=seed)
    for name, b in (("request", pcm.synthesize_ids(ids, seed=seed)),
                    ("stream", np.concatenate(list(
                        pcm.synthesize_ids_streaming(ids, seed=seed))))):
        err = (float(np.abs(a - b).max()) if a.shape == b.shape
               else float("inf"))
        print(f"{tag}: fetch_pcm16 {name} vs float32 max_abs={err:.3e} "
              f"(bound {1 / 32767 + 1e-6:.3e})", flush=True)
        check(err <= 1 / 32767 + 1e-6,
              f"{tag}: the int16 fetch of a {name} differs by {err:.3e}")

    bucket_memory(torch, engine, utts[1], seed, tag)

    fresh = VitsEngine(engine.params, engine.hp)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fresh.warmup()
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    # a capture empties the allocator's cache first, so the device's
    # reserved memory before and after differ by more than the graphs
    print(f"{tag}: warmup() at batch 1, text buckets "
          f"{list(fresh.text_buckets[:3])}: {len(fresh.graphs.programs)} "
          f"graphs in {warm_s:.3f} s, their pools "
          f"{fresh.graphs.pool_bytes / 2 ** 20:.1f} MiB", flush=True)
    memory_line(torch, f"{tag} warmup()")
    del fresh, pcm, fused
    memory_line(torch, f"{tag} (after warmup's engine is dropped)")


def reentrant_phase(torch, voice, seed, tag="reentrant"):
    """One engine used by several callers at the same graph keys: two
    streams of one key interleaved chunk by chunk (the second's first
    chunk replays the first-chunk graph while the first stream is paused
    after its own), and two threads making two-phase requests of one key
    at once; each result against the same call made alone."""
    import threading

    engine = voice.engine
    utts = [voice.phonemes_to_ids(voice.phonemize(text_of(n, k))[0])
            for k, n in ((3, 100), (5, 90))]
    alone = [engine.synthesize_ids(ids, seed=seed + i)
             for i, ids in enumerate(utts)]
    streams = [engine.synthesize_ids_streaming(
        ids, chunk_frames=STREAM_CHUNK, overlap_frames=STREAM_OVERLAP,
        seed=seed + i) for i, ids in enumerate(utts)]
    chunks = [[], []]
    live = [0, 1]
    while live:
        for i in list(live):
            chunk = next(streams[i], None)
            if chunk is None:
                live.remove(i)
            else:
                chunks[i].append(chunk)
    errs = []
    for i, want in enumerate(alone):
        got = np.concatenate(chunks[i])
        errs.append(float(np.abs(got - want).max()) if got.shape ==
                    want.shape else float("inf"))
    print(f"{tag}: two streams of ids {[len(u) for u in utts]} at the key "
          f"of one text bucket, interleaved chunk by chunk ("
          f"{[len(c) for c in chunks]} chunks): max_abs vs each alone "
          f"{', '.join(f'{e:.3e}' for e in errs)}", flush=True)
    check(max(errs) <= BATCH_TOL, f"{tag}: an interleaved stream differs "
          f"from its request by {max(errs):.3e}")

    rounds = 5
    got = [[None] * rounds for _ in utts]

    def requests(i):
        for r in range(rounds):
            got[i][r] = engine.synthesize_ids(utts[i], seed=seed + i)

    threads = [threading.Thread(target=requests, args=(i,))
               for i in range(len(utts))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    err = max(float(np.abs(g - want).max()) if g.shape == want.shape
              else float("inf") for outs, want in zip(got, alone)
              for g in outs)
    print(f"{tag}: {len(threads)} threads x {rounds} two-phase requests at "
          f"one key at once: max_abs vs each alone {err:.3e}", flush=True)
    check(err <= GRAPH_TOL, f"{tag}: a request made beside another thread's "
          f"differs by {err:.3e}")


def bucket_memory(torch, engine, ids, seed, tag):
    """The memory one batch-1 phase-2 graph holds alone, at frame buckets
    from 256 to 4,096: each captured by a fresh engine (a pool of its
    own) on the phase-1 outputs of ``ids``."""
    from phoonnx_tpu_torch.infer import VitsEngine

    dev = engine.device
    tokens, lens, sid, dp_noise, _ = engine._batch_inputs([ids], [0], seed)
    scales = engine._scales(0.667, 1.0, 0.8)
    m_p, logs_p, w_ceil, x_mask, g, _ = engine._phase1(
        *[a.to(dev) for a in (tokens, lens, sid, scales, dp_noise)])
    gen = torch.Generator().manual_seed(seed)
    sizes = []
    for f_bucket in (256, 512, 1024, 2048, 4096):
        fresh = VitsEngine(engine.params, engine.hp)
        fresh._run(("phase2", 1, tokens.shape[1], f_bucket),
                   partial(fresh._phase2, max_frames=f_bucket), m_p, logs_p,
                   w_ceil, x_mask, g, scales,
                   torch.randn(1, f_bucket, engine.hp.inter_channels,
                               generator=gen))
        sizes.append(f"{f_bucket}: {fresh.graphs.pool_bytes / 2 ** 20:.1f}")
        del fresh
    print(f"{tag}: one batch-1 phase-2 graph alone, pool MiB by frame "
          f"bucket: {', '.join(sizes)}", flush=True)


def memory_line(torch, after):
    print(f"memory: after {after}: reserved "
          f"{torch.cuda.memory_reserved() / 2 ** 20:.1f} MiB, allocated "
          f"{torch.cuda.memory_allocated() / 2 ** 20:.1f} MiB", flush=True)


def graph_memory(engine, tag):
    """Each captured graph of an engine and the memory its capture added
    to the engine's pool (one for all its graphs; a later capture reuses
    what an earlier one freed)."""
    for key, program in sorted(engine.graphs.programs.items(),
                               key=lambda kv: str(kv[0])):
        print(f"{tag}: graph {key} pool +{program.pool_bytes / 2 ** 20:.1f} "
              f"MiB", flush=True)
    print(f"{tag}: {len(engine.graphs.programs)} graphs, pools "
          f"{engine.graphs.pool_bytes / 2 ** 20:.1f} MiB", flush=True)



# ---------------------------------------------------------------------------
# the HTTP server with dynamic batching
# ---------------------------------------------------------------------------

# int16 steps allowed between a served WAV and the engine's own request of
# the same ids: the padded-batch bound (BATCH_TOL x 32767 = 3.3) plus one
# step of truncation; a stream against the WAV route: one step
SERVE_LSB = 4
STREAM_LSB = 1
# the same in bf16. A served batch's float32 sums land on the other side
# of a bf16 rounding than the engine's own request in places, and one bf16
# step of audio is 4 int16 steps at a magnitude of 0.016-0.031 and 32 at
# 0.125-0.25. Measured on the H100 (the 8 requests of served_held): 8 and
# 12 against the engine's request, 2 between the stream and WAV routes;
# the bounds give each four times its largest reading
BF16_SERVE_LSB = 48
BF16_STREAM_LSB = 8
# The load's traffic: a request is one utterance whose length follows LJ
# Speech 1.1's published statistics (keithito.com/LJ-Speech-Dataset: 13,100
# clips of 1.11-10.10 s, mean 6.57 s, 1,308,678 characters in all). Its
# duration is drawn from the triangular distribution with that minimum,
# mean and maximum (mode 3 x 6.57 - 1.11 - 10.10 = 8.50 s), its text has
# the corpus's characters per second of audio (15.2), and the voice's
# length_scale is set so that its audio per character is the corpus's.
LJ_CLIP_S = (1.11, 6.57, 10.10)
LJ_CHARS_PER_S = 1308678 / 13100 / 6.57
LJ_CALIBRATION_TEXTS = 32
# closed loop: client threads a level; each level runs SERVE_WARM_S
# unmeasured (its first graph captures), then SERVE_WINDOW_S measured, read
# in slices of SERVE_SLICE_S for the spread; one more level is profiled
SERVE_CLIENTS = (1, 16, 64)
SERVE_WARM_S, SERVE_WINDOW_S, SERVE_SLICE_S = 2.0, 10.0, 1.0
SERVE_PROFILE_S = 3.0
SERVE_LANES = (1, 2, 4, 8, 16)
SINGLE_RUNS = 21


def text_of_ids(n_ids: int, offset: int) -> str:
    """A one-sentence RAW text of about ``n_ids`` ids (2.4 a letter with
    the blanks and word spaces)."""
    return text_of(max(4, round(n_ids / 2.4)), offset)


def text_of_chars(n_chars: float, offset: int) -> str:
    """A one-sentence RAW text of about ``n_chars`` characters (words of
    5 letters and a space)."""
    return text_of(max(4, round(n_chars * 5 / 6)), offset)


def serve_post(srv, body):
    """POST /synthesize: (int16 PCM, latency ms), failing on any status
    but 200."""
    import http.client
    import io
    import wave

    t0 = time.perf_counter()
    conn = http.client.HTTPConnection(*srv.address, timeout=600)
    try:
        conn.request("POST", "/synthesize", body=json.dumps(body),
                     headers={"Content-Type": "application/json"})
        resp = conn.getresponse()
        data = resp.read()
    finally:
        conn.close()
    ms = (time.perf_counter() - t0) * 1e3
    if resp.status != 200:
        raise RuntimeError(f"HTTP {resp.status}: {data[:300]!r}")
    if body.get("stream"):
        return np.frombuffer(data, np.int16), ms
    with wave.open(io.BytesIO(data), "rb") as w:
        return np.frombuffer(w.readframes(w.getnframes()), np.int16), ms


def pcm16(audio):
    """The WAV route's int16 of float audio."""
    return np.clip(audio * 32767.0, -32767.0, 32767.0).astype(np.int16)


def lsb(got, want) -> int:
    return int(np.abs(got.astype(np.int32) - want.astype(np.int32)).max())


def in_threads(fn, n_threads: int):
    """Run fn(i) on n_threads threads at once; raise the first error."""
    import threading

    errors = []

    def run(i):
        try:
            fn(i)
        except Exception as exc:  # reported below, the run fails
            errors.append(exc)

    threads = [threading.Thread(target=run, args=(i,))
               for i in range(n_threads)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    check(not any(t.is_alive() for t in threads), "a client thread hung")
    if errors:
        fail(f"a client failed: {errors[0]!r}")


def served_held(torch, srv, voice, seed, tag):
    """Requests through the server held against the engine: eight
    concurrent requests of 20-240 ids at noise 0 against synthesize_ids;
    a seeded request of three sentences (out of length order) against
    synthesize_batch of the sentences in their own order with the same
    seed; the stream route against the WAV route."""
    from phoonnx_tpu_torch import SynthesisConfig

    engine = voice.engine
    up = engine.hp.total_upsample
    f32 = engine.dtype == torch.float32
    bound = SERVE_LSB if f32 else BF16_SERVE_LSB
    stream_bound = STREAM_LSB if f32 else BF16_STREAM_LSB

    def ids_of(text):  # the server's own ids of a text
        return srv._prepare(voice, text, SynthesisConfig())

    targets = np.linspace(20, 240, 8).round().astype(int).tolist()
    texts = [text_of_ids(n, k) for k, n in enumerate(targets)]
    got = [None] * len(texts)

    def hit(i):
        got[i] = serve_post(srv, {"text": texts[i], "noise_scale": 0.0,
                                  "noise_w": 0.0})[0]

    before = srv.batcher.stats["groups"]
    in_threads(hit, len(texts))
    worst = 0
    lengths = []
    for text, pcm in zip(texts, got):
        ids, = ids_of(text)
        lengths.append(len(ids))
        want = pcm16(engine.synthesize_ids(ids, noise_scale=0.0,
                                           noise_w=0.0))
        check(pcm.shape == want.shape, f"{tag}: a served WAV of {len(ids)} "
              f"ids has {pcm.shape[0]} samples, the engine's {want.shape[0]}")
        worst = max(worst, lsb(pcm, want))
    print(f"{tag}: 8 concurrent requests of {lengths} ids at noise 0 in "
          f"{srv.batcher.stats['groups'] - before} group(s): max "
          f"{worst} LSB from synthesize_ids (bound {bound})", flush=True)
    check(worst <= bound, f"{tag}: a served request differs from the "
          f"engine's by {worst} LSB")

    sentences = [text_of_ids(n, 11 + k)
                 for k, n in enumerate((180, 30, 90))]
    body = {"text": ". ".join(sentences), "seed": seed}
    pcm, _ = serve_post(srv, body)
    ids = ids_of(body["text"])
    lens = [len(i) for i in ids]
    check(len(ids) == 3 and lens != sorted(lens),
          f"{tag}: the seeded text phonemizes to sentences of {lens} ids")
    audio, frames = engine.synthesize_batch(ids, seed=seed)
    want = pcm16(np.concatenate([audio[i, :n * up]
                                 for i, n in enumerate(frames)]))
    check(pcm.shape == want.shape, f"{tag}: seeded request {pcm.shape} vs "
          f"synthesize_batch {want.shape}")
    err = lsb(pcm, want)
    print(f"{tag}: a seeded request of 3 sentences ({lens} ids, out of "
          f"length order): max {err} LSB from synthesize_batch of "
          f"them in their order, seed {seed} (bound {bound})",
          flush=True)
    check(err <= bound, f"{tag}: the seeded request differs from "
          f"synthesize_batch in its own order by {err} LSB: sorted or "
          "batched with others")

    body = {"text": text_of_ids(240, 5), "seed": seed + 1}
    wav, _ = serve_post(srv, body)
    stream, _ = serve_post(srv, dict(body, stream=True))
    check(stream.shape == wav.shape, f"{tag}: stream {stream.shape} vs WAV "
          f"{wav.shape}")
    err = lsb(stream, wav)
    print(f"{tag}: the stream route vs the WAV route, {wav.shape[0]} "
          f"samples: max {err} LSB (bound {stream_bound})", flush=True)
    check(err <= stream_bound, f"{tag}: the stream differs from the WAV by "
          f"{err} LSB")


def serve_kernels(torch, params, seed, tag="serve"):
    """A, B and C against their plain versions at 16 lanes, in the
    parameters' dtype (float32, or bf16 for their bf16 builds): 16 ragged
    rows in text bucket 128, 16 rows at frame bucket 512, the three medium
    stages at 16 x 512 frames. Returns the largest error of each."""
    from phoonnx_tpu_torch.models.vits import fused_encoder, fused_flow

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)
    rng = np.random.default_rng(seed)
    text = [128] + rng.integers(8, 129, 15).tolist()
    frames = [512] + rng.integers(40, 513, 15).tolist()
    errs = {}

    def mask_of(lengths, t):
        pos = torch.arange(t, device=dev)[None, :]
        return (pos < torch.tensor(lengths, device=dev)[:, None])[
            ..., None].float()

    enc = params["enc_p"]["encoder"]["fused"]
    dtype = enc["w_qkv"].dtype  # the parameters' (float32 or bf16)
    size = enc["w_qkv"].element_size()
    hid = enc["n_heads"] * enc["dk"]
    mask = mask_of(text, 128).to(dtype)
    inputs = [((torch.randn(16, 128, hid, device=dev, generator=gen)
                * mask).to(dtype), mask) for _ in range(3)]
    errs["A"] = compare_kernel(
        torch, "A", lambda x, m: fused_encoder.apply(enc, x, m),
        lambda x, m: fused_encoder.plain(enc, x, m), inputs,
        encoder_flops(enc, text, hid, enc["w_ffn1"].shape[-1]),
        2 * 16 * 128 * hid * size + tensor_bytes(enc) + 64,
        f"{tag} B=16 T_x=128 lengths={text}")["max_abs_err"]

    flow = params["flow"]["fused_rev"]
    c = 2 * flow["half"]
    mask = mask_of(frames, 512).to(dtype)
    inputs = [((torch.randn(16, 512, c, device=dev, generator=gen)
                * mask).to(dtype), mask) for _ in range(3)]
    errs["B"] = compare_kernel(
        torch, "B", lambda x, m: fused_flow.apply(flow, x, m),
        lambda x, m: fused_flow.plain(flow, x, m), inputs,
        flow_flops(flow, frames),
        2 * 16 * 512 * c * size + tensor_bytes(flow),
        f"{tag} B=16 T_y=512 lengths={frames}")["max_abs_err"]

    total = compare_stages(torch, params["dec"]["fused_stages"],
                           params["dec"]["upsample_rates"], frames, gen,
                           dev, f"{tag} ")
    stage_total_line(total, "3 stages B=16 512 frames")
    errs["C"] = total["max_abs_err"]
    return errs


def lane_sweep(srv, seed, tag):
    """One seeded request of n short sentences (about 25 ids, text bucket
    32, which warmup() covers) for each lane count n: a solo group of n
    lanes, so every lane count replays its phase-1 graph. Prints the
    request's latency (host clock, the second of two) by lane count."""
    line = []
    for n in SERVE_LANES:
        body = {"text": ". ".join(text_of_ids(24, k) for k in range(n)),
                "seed": seed}
        serve_post(srv, body)
        pcm, ms = serve_post(srv, body)
        line.append(f"{n}: {ms:.3f} ms ({len(pcm)} samples)")
    print(f"{tag}: one seeded request of n sentences of ~25 ids, by n: "
          + ", ".join(line), flush=True)


def lj_texts(seed: int, n: int):
    """n one-sentence texts whose lengths follow LJ Speech's clip
    statistics (LJ_CLIP_S, LJ_CHARS_PER_S)."""
    lo, mean, hi = LJ_CLIP_S
    rng = np.random.default_rng(seed)
    seconds = rng.triangular(lo, 3 * mean - lo - hi, hi, size=n)
    return [text_of_chars(s * LJ_CHARS_PER_S, int(rng.integers(0, 26)))
            for s in seconds]


def lj_length_scale(srv, voice, seed, tag):
    """The length_scale at which this voice speaks LJ Speech's characters
    per second: the audio of LJ_CALIBRATION_TEXTS texts of the mix at the
    voice's own scales, in batches of 16, against the corpus's rate."""
    from phoonnx_tpu_torch import SynthesisConfig

    engine = voice.engine
    texts = lj_texts(seed, LJ_CALIBRATION_TEXTS)
    ids = [srv._prepare(voice, t, SynthesisConfig()) for t in texts]
    check(all(len(i) == 1 for i in ids), f"{tag}: a load text is not one "
          "sentence")
    ids = [i[0] for i in ids]
    inf = voice.config
    frames = 0
    for start in range(0, len(ids), 16):
        frames += sum(engine.synthesize_batch(
            ids[start:start + 16], noise_scale=inf.noise_scale,
            length_scale=inf.length_scale, noise_w=inf.noise_w_scale,
            seed=seed + start)[1])
    seconds = frames * engine.hp.total_upsample / inf.sample_rate
    chars = sum(len(t) for t in texts)
    scale = inf.length_scale * (chars / LJ_CHARS_PER_S) / seconds
    print(f"{tag}: the voice speaks {chars / seconds:.3f} characters a "
          f"second at length_scale {inf.length_scale} over {len(texts)} "
          f"texts of the mix ({chars} characters, {sum(map(len, ids))} "
          f"ids); LJ Speech {LJ_CHARS_PER_S:.3f}: the load runs at "
          f"length_scale {scale:.4f}", flush=True)
    return scale


def run_window(srv, bodies, clients: int, rate: int, seconds: float):
    """Closed loop for ``seconds``: ``clients`` threads post the bodies in
    turn, each request after its last one's answer, and start none after
    the window. Returns (wall s to the last answer, [(answer s, latency
    ms, audio s)])."""
    import itertools
    import threading

    lock = threading.Lock()
    todo = itertools.cycle(bodies)
    done = []
    t0 = time.perf_counter()
    end = t0 + seconds

    def client(_):
        while True:
            with lock:
                if time.perf_counter() >= end:
                    return
                body = next(todo)
            pcm, ms = serve_post(srv, body)
            with lock:
                done.append((time.perf_counter() - t0, ms, len(pcm) / rate))

    in_threads(client, clients)
    return time.perf_counter() - t0, done


def replays_by_lanes(replays):
    """{lane count: replays} of the phase-1 and phase-2 graphs in a count
    of replays by key."""
    out = {}
    for key, n in replays.items():
        if key[0] in ("phase1", "phase2"):
            out[key[1]] = out.get(key[1], 0) + n
    return dict(sorted(out.items()))


def serve_load(torch, srv, voice, seed, scale, tag, levels=SERVE_CLIENTS):
    """The load levels (client counts), each a window of SERVE_WINDOW_S
    after SERVE_WARM_S unmeasured: throughput with its quartiles over
    slices, latency percentiles, batches and lanes, the dispatcher's host
    time by item, the graph keys replayed and captured; then one profiled
    level (16 clients) for the device's busy and idle share. Returns the
    audio seconds per wall second of each slice, by level."""
    from collections import Counter

    engine = voice.engine
    graphs = engine.graphs
    rate = voice.config.sample_rate
    bodies = [{"text": t, "length_scale": scale}
              for t in lj_texts(seed, 512)]
    items = ("_batch_inputs", "_prior", "_run", "_ready",
             "synthesize_batch")
    clock = HostClock(engine, items)
    group_clock = HostClock(srv.batcher, ("_synthesize_group",))
    slices_by_level = {}
    try:
        for clients in levels:
            run_window(srv, bodies, clients, rate, SERVE_WARM_S)
            for c in (clock, group_clock):
                c.reset()
            replays0, keys0 = Counter(graphs.replays), set(graphs.programs)
            stats0 = dict(srv.batcher.stats)
            clock.on = group_clock.on = True
            try:
                wall, done = run_window(srv, bodies, clients, rate,
                                        SERVE_WINDOW_S)
            finally:
                clock.on = group_clock.on = False
            stats = srv.batcher.stats
            groups = stats["groups"] - stats0["groups"]
            replays = Counter(graphs.replays) - replays0
            captured = sorted(set(graphs.programs) - keys0, key=str)
            phase1 = [k for k in list(replays.elements()) + captured
                      if k[0] == "phase1"]
            d = clock.calls["synthesize_batch"]
            check(d == len(phase1), f"{tag}: {d} dispatches ran "
                  f"{len(phase1)} phase-1 graphs")
            n = len(done)
            audio = sum(a for _, _, a in done)
            slices = [sum(a for t, _, a in done
                          if k * SERVE_SLICE_S <= t < (k + 1) * SERVE_SLICE_S)
                      / SERVE_SLICE_S
                      for k in range(int(SERVE_WINDOW_S / SERVE_SLICE_S))]
            slices_by_level[clients] = slices
            q1, q2, q3 = quartiles(slices)
            p50, p90, p99 = np.percentile([ms for _, ms, _ in done],
                                          [50, 90, 99])
            print(f"{tag}: {clients} client(s), {SERVE_WINDOW_S:.0f} s "
                  f"window: {n} requests, {n / wall:.2f} requests/s, "
                  f"{audio / wall:.2f} audio s per wall s ({audio:.2f} s of "
                  f"audio in {wall:.3f} s; by {SERVE_SLICE_S:.0f} s slice "
                  f"quartiles {q1:.2f}/{q2:.2f}/{q3:.2f}); latency ms p50 "
                  f"{p50:.3f} p90 {p90:.3f} p99 {p99:.3f}; audio a request "
                  f"{audio / n:.3f} s (LJ Speech {LJ_CLIP_S[1]})",
                  flush=True)
            print(f"{tag}: {clients} client(s): {groups} batches (scale "
                  f"groups), {d} device dispatches, lanes a dispatch "
                  f"{sum(k[1] for k in phase1) / d:.2f} padded / "
                  f"{n / d:.2f} real, max_batch_seen "
                  f"{stats['max_batch_seen']}", flush=True)
            ms = clock.ms
            rest = (ms["synthesize_batch"] - ms["_batch_inputs"]
                    - ms["_prior"] - ms["_run"] - ms["_ready"])
            reassembly = (group_clock.ms["_synthesize_group"]
                          - ms["synthesize_batch"])
            print(f"{tag}: {clients} client(s): dispatcher host ms a "
                  f"dispatch (means of {d}): ids and duration "
                  f"noise {ms['_batch_inputs'] / d:.3f}, prior draw "
                  f"{ms['_prior'] / d:.3f}, staging and replays "
                  f"{ms['_run'] / d:.3f}, waits for the device "
                  f"{ms['_ready'] / d:.3f}, the rest of synthesize_batch "
                  f"{rest / d:.3f}, reassembly {reassembly / d:.3f}; "
                  f"synthesize_batch {ms['synthesize_batch'] / d:.3f}",
                  flush=True)
            by_lanes = replays_by_lanes(replays)
            print(f"{tag}: {clients} client(s): graph replays by lane count "
                  f"{by_lanes}; graphs captured in the window "
                  f"{len(captured)} {captured}", flush=True)
            if clients == SERVE_CLIENTS[-1]:
                check(stats["max_batch_seen"] == 16 and by_lanes.get(16),
                      f"{tag}: no 16-lane dispatch at {clients} clients")
        clients = SERVE_CLIENTS[1]
        device_profile(torch, lambda: run_window(srv, bodies, clients, rate,
                                                 SERVE_PROFILE_S),
                       f"{tag} {clients} clients, {SERVE_PROFILE_S:.0f} s",
                       top=12)
    finally:
        group_clock.close()
        clock.close()
    return slices_by_level


def single_client(torch, srv, voice, seed, scale, tag):
    """One client's request through the server beside voice.synthesize of
    the same text, SINGLE_RUNS of each in turns: an utterance of LJ
    Speech's mean clip length at the load's length_scale."""
    from phoonnx_tpu_torch import SynthesisConfig

    text = text_of_chars(LJ_CLIP_S[1] * LJ_CHARS_PER_S, 9)
    cfg = SynthesisConfig(seed=seed, normalize_audio=False,
                          length_scale=scale)
    body = {"text": text, "seed": seed, "length_scale": scale}
    direct_ms, served_ms = [], []
    for _ in range(SINGLE_RUNS + 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        want = pcm16(np.concatenate([c.audio_float_array for c in
                                     voice.synthesize(text, cfg)]))
        direct_ms.append((time.perf_counter() - t0) * 1e3)
        pcm, ms = serve_post(srv, body)
        served_ms.append(ms)
    check(pcm.shape == want.shape and lsb(pcm, want) <= SERVE_LSB,
          f"{tag}: the single client's WAV differs from voice.synthesize")
    direct_ms, served_ms = direct_ms[1:], served_ms[1:]
    print(f"{tag}: single client, {len(text)} characters, {len(want)} "
          f"samples: served_ms {statistics.median(served_ms):.3f} direct "
          f"voice.synthesize_ms {statistics.median(direct_ms):.3f} (medians "
          f"of {SINGLE_RUNS} in turns; the server waits max_wait_ms "
          f"{srv.batcher.max_wait * 1e3:.0f} for more lanes)", flush=True)
    print(f"{tag}: " + compare_times("served", served_ms, "direct",
                                     direct_ms), flush=True)


def serve_phase(torch, voice, seed, tag="serve"):
    """The medium voice behind ``TTSServer(port=0, max_batch=16,
    max_wait_ms=10)`` on 127.0.0.1: warmup() with its graphs and pool; the
    served requests held to the engine; the load's length_scale; a sweep
    of one request at each lane count and the load levels (counted from 0
    just before them and read just after: A, B and C must each launch,
    and a graph of each lane count replay); one client beside a direct
    request; each graph's pool. Returns the counted launches and the
    load: {"scale": its length_scale, "slices": serve_load's result}."""
    from collections import Counter

    from phoonnx_tpu_torch.serve import TTSServer

    engine = voice.engine
    t_phase = time.perf_counter()
    srv = TTSServer(voice, port=0, max_batch=16, max_wait_ms=10)
    srv.start()
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        srv.warmup()
        torch.cuda.synchronize()
        warm_s = time.perf_counter() - t0
        keys = sorted(engine.graphs.programs, key=str)
        print(f"{tag}: warmup() in {warm_s:.3f} s: {len(keys)} graphs, "
              f"pool {engine.graphs.pool_bytes / 2 ** 20:.1f} MiB; keys "
              f"{keys}", flush=True)
        memory_line(torch, f"{tag} warmup()")

        served_held(torch, srv, voice, seed, tag)
        scale = lj_length_scale(srv, voice, seed + 3, tag)
        kernels = serving_kernels()
        reset_launches(kernels)
        replays0 = Counter(engine.graphs.replays)
        lane_sweep(srv, seed + 1, tag)
        load = {"scale": scale, "slices": serve_load(
            torch, srv, voice, seed + 1, scale, tag)}
        launches = read_launches(kernels, tag, "dynamic-batching server "
                                 "path (the lane sweep and the load levels)")
        replayed = replays_by_lanes(Counter(engine.graphs.replays)
                                    - replays0)
        print(f"{tag}: graph keys the served requests replayed, by lane "
              f"count {replayed}", flush=True)
        missing = [n for n in SERVE_LANES if not replayed.get(n)]
        check(not missing, f"{tag}: no graph replayed at {missing} lanes")

        single_client(torch, srv, voice, seed + 2, scale, tag)
    finally:
        srv.stop()
    biggest = max(engine.graphs.programs.items(),
                  key=lambda kv: kv[1].pool_bytes)
    print(f"{tag}: after the load {len(engine.graphs.programs)} graphs, "
          f"pool {engine.graphs.pool_bytes / 2 ** 20:.1f} MiB; the largest "
          f"capture {biggest[0]} +{biggest[1].pool_bytes / 2 ** 20:.1f} MiB",
          flush=True)
    memory_line(torch, f"{tag} load")
    print(f"{tag}: the phase took {time.perf_counter() - t_phase:.1f} s",
          flush=True)
    return launches, load


# ---------------------------------------------------------------------------
# bfloat16 synthesis: the engine's dtype="bfloat16" through the bf16 builds
# of kernels A, B and C
# ---------------------------------------------------------------------------


def bf16_params(torch, params, dev):
    """The medium parameters as a bf16 engine holds them: on the card,
    every floating tensor cast to bf16, the kernel specs built from
    those."""
    from phoonnx_tpu_torch.models.vits import model as vits_model
    from phoonnx_tpu_torch.models.vits import nn

    return vits_model.attach_fused_specs(nn.cast_floating(
        vits_model.params_to_device(params, dev), torch.bfloat16))


def bf16_kernel_phase(torch, params, seed, dev):
    """Kernels A, B and C in bf16 against their bf16 plain versions at
    B=1: A at T_x 128, B at T_y 512, C's three stages at 512 frames; the
    device operations in one call of A and of B (their bf16 builds take
    bf16 tensors with no cast around the launch). Returns the results by
    kernel, as kernel_phases does."""
    from phoonnx_tpu_torch.models.vits import fused_encoder, fused_flow
    from phoonnx_tpu_torch.models.vits import model as vits_model
    from phoonnx_tpu_torch.models.vits import nn

    gen = torch.Generator(device=dev).manual_seed(seed)
    bf = torch.bfloat16
    results = {}
    # the float32 specs of the same bf16 values
    values = vits_model.attach_fused_specs(nn.cast_floating(
        vits_model.detach_fused_specs(params), torch.float32))

    def mask_of(n, t):
        return (torch.arange(t, device=dev) < n)[None, :, None].to(bf)

    enc = params["enc_p"]["encoder"]["fused"]
    hid = enc["n_heads"] * enc["dk"]
    mask = mask_of(128, 128)
    inputs = [((torch.randn(1, 128, hid, device=dev, generator=gen))
               .to(bf), mask) for _ in range(4)]
    results["A"] = compare_kernel(
        torch, "A", lambda x, m: fused_encoder.apply(enc, x, m),
        lambda x, m: fused_encoder.plain(enc, x, m), inputs,
        encoder_flops(enc, [128], hid, enc["w_ffn1"].shape[-1]),
        2 * 128 * hid * 2 + tensor_bytes(enc) + 4,
        "B=1 T_x=128")
    results["A"]["device_kernels"] = kernels_in_call(
        torch, lambda: fused_encoder.apply(enc, *inputs[0]), "A bf16",
        "encoder_persistent")
    # through six layers a bf16 rounding that a float32 sum in another
    # order flips spreads to most of the output, so the rounding points
    # are held on one layer, where it stays a rare single step
    one, one_values = (fused_encoder.build_spec(dict(
        p["plain"], layers=p["plain"]["layers"][:1]))
        for p in (enc, values["enc_p"]["encoder"]["fused"]))
    compare_kernel(
        torch, "A", lambda x, m: fused_encoder.apply(one, x, m),
        lambda x, m: fused_encoder.plain(one, x, m), inputs,
        encoder_flops(one, [128], hid, one["w_ffn1"].shape[-1]),
        2 * 128 * hid * 2 + tensor_bytes(one) + 4, "B=1 T_x=128 one layer",
        unrounded_fn=lambda x, m: fused_encoder.plain(
            one_values, x.float(), m.float()).to(bf))

    flow = params["flow"]["fused_rev"]
    c = 2 * flow["half"]
    mask = mask_of(512, 512)
    inputs = [((torch.randn(1, 512, c, device=dev, generator=gen))
               .to(bf), mask) for _ in range(4)]
    results["B"] = compare_kernel(
        torch, "B", lambda x, m: fused_flow.apply(flow, x, m),
        lambda x, m: fused_flow.plain(flow, x, m), inputs,
        flow_flops(flow, [512]), 2 * 512 * c * 2 + tensor_bytes(flow),
        "B=1 T_y=512")
    results["B"]["device_kernels"] = kernels_in_call(
        torch, lambda: fused_flow.apply(flow, *inputs[0]), "B bf16",
        "flow_persistent")

    total = compare_stages(torch, params["dec"]["fused_stages"],
                           params["dec"]["upsample_rates"], [512], gen, dev,
                           unrounded=values["dec"]["fused_stages"])
    stage_total_line(total, "bf16 3 stages B=1 512 frames")
    results["C"] = total
    return results


def snr_db(want, got) -> float:
    """10 log10 of the signal's energy over the difference's."""
    noise = float(np.sum((got.astype(np.float64) - want) ** 2))
    signal = float(np.sum(want.astype(np.float64) ** 2))
    return math.inf if noise == 0 else 10 * math.log10(signal / noise)


def bf16_vs_f32(torch, voice, f32, seed, tag="bf16"):
    """The bf16 voice against the float32 voice of the same weights and
    seed: the 31-, 97- and 241-id requests (frame counts, and max-abs and
    SNR where the counts are equal), the 241-id request timed in turns
    (STREAM_RUNS of each, quartiles), and the graph pools of the keys both
    engines captured.

    The frame counts need not be equal: a duration within a bf16 step of
    an integer takes the other ceil() in bf16 (each such duration moves
    the count by one frame and shifts the audio after it). They must
    agree to within BF16_FRAME_SHARE of the frames, and at least one
    request must have equal counts, so that its audio is compared."""
    from phoonnx_tpu_torch import SynthesisConfig

    hop = voice.engine.hp.total_upsample
    compared = 0
    for target, offset in ((30, 1), (100, 2), (250, 3)):
        text = text_of(max(4, target * 2 // 5), offset)
        cfg = SynthesisConfig(seed=seed + target, normalize_audio=False)
        got = voice.phoneme_ids_to_audio(
            voice.phonemes_to_ids(voice.phonemize(text)[0]), cfg)
        want = f32.phoneme_ids_to_audio(
            f32.phonemes_to_ids(f32.phonemize(text)[0]), cfg)
        frames = (len(got) // hop, len(want) // hop)
        check(abs(frames[0] - frames[1]) <= BF16_FRAME_SHARE * frames[1],
              f"{tag}: {frames[0]} frames in bf16, {frames[1]} in float32")
        if frames[0] != frames[1]:
            print(f"{tag}: vs float32, {frames[0]} frames in bf16 and "
                  f"{frames[1]} in float32 (a duration's ceil() differs): "
                  "audio not compared", flush=True)
            continue
        compared += 1
        print(f"{tag}: vs float32, {frames[1]} frames both: max_abs="
              f"{float(np.abs(got - want).max()):.3e} snr_db="
              f"{snr_db(want, got):.2f} (peak {float(np.abs(want).max()):.3f})",
              flush=True)
    check(compared > 0, f"{tag}: no request had the float32 frame count")

    text = text_of(100, 3)
    ids = voice.phonemes_to_ids(voice.phonemize(text)[0])

    def timed(v):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        v.engine.synthesize_ids(ids, seed=seed)
        return (time.perf_counter() - t0) * 1e3

    timed(voice), timed(f32)
    b_ms, f_ms = [], []
    for _ in range(STREAM_RUNS):
        f_ms.append(timed(f32))
        b_ms.append(timed(voice))
    print(f"{tag}: the {len(ids)}-id request, bf16_ms="
          f"{statistics.median(b_ms):.3f} f32_ms={statistics.median(f_ms):.3f}"
          f" (medians of {STREAM_RUNS} in turns)", flush=True)
    print(f"{tag}: " + compare_times("bf16", b_ms, "f32", f_ms), flush=True)
    both = set(voice.engine.graphs.programs) & set(f32.engine.graphs.programs)
    mib = [sum(e.graphs.programs[k].pool_bytes for k in both) / 2 ** 20
           for e in (voice.engine, f32.engine)]
    print(f"{tag}: graph pools of the {len(both)} keys both engines "
          f"captured: bf16 {mib[0]:.1f} MiB, float32 {mib[1]:.1f} MiB",
          flush=True)
    graph_memory(voice.engine, f"{tag} medium")


def bf16_voice_phase(torch, model_path, config_path, seed, tag="bf16"):
    """The medium voice loaded with dtype="bfloat16" on the default
    device: the serving path (main_path), every program's graph against
    eager (torch.equal) at the 31-, 97- and 241-id requests' buckets, the
    card against the plain bf16 path on the host's CPU, the float32 voice
    beside it, one streamed request. Returns the launches of the serving
    and the streaming paths."""
    from phoonnx_tpu_torch import TTSVoice

    paths = {}
    voice, paths[f"{tag} medium serving path"], _ = main_path(
        torch, model_path, config_path, seed, tag=tag, dtype="bfloat16",
        batch_tol=BF16_PATH_TOL)
    engine = voice.engine
    dtypes = set()

    def walk(tree):
        if isinstance(tree, dict):
            for v in tree.values():
                walk(v)
        elif isinstance(tree, (list, tuple)):
            for v in tree:
                walk(v)
        elif isinstance(tree, torch.Tensor) and tree.is_floating_point():
            dtypes.add(tree.dtype)

    walk(engine.params)
    check(dtypes == {torch.bfloat16},
          f"{tag}: the engine's floating parameters are {dtypes}")
    for target, offset in ((30, 1), (100, 2), (250, 3)):
        ids = voice.phonemes_to_ids(voice.phonemize(
            text_of(max(4, target * 2 // 5), offset))[0])
        graphs_vs_eager(torch, engine, ids, seed + target,
                        tag=f"{tag} graph {len(ids)} ids")
    path_vs_plain(torch, voice, seed + 1, tag=f"{tag} path",
                  stats_tol=BF16_KERNEL_TOL, wave_tol=BF16_PATH_TOL)
    f32 = TTSVoice.load(str(model_path), str(config_path))
    bf16_vs_f32(torch, voice, f32, seed + 2, tag)
    del f32
    paths[f"{tag} medium streaming path"], _ = stream_phase(
        torch, voice, seed + 3, tag=f"{tag} stream", tol=BF16_PATH_TOL)
    return paths


def bf16_serve_phase(torch, model_path, config_path, seed, f32_load,
                     tag="bf16 serve"):
    """A bf16 medium voice behind ``TTSServer(port=0, max_batch=16,
    max_wait_ms=10)``: warmup(), the served requests held to the engine,
    and one window at 16 clients of the float32 server's load (same texts
    and length_scale) beside the float32 window. Returns the window's
    launches."""
    from phoonnx_tpu_torch import TTSVoice
    from phoonnx_tpu_torch.serve import TTSServer

    voice = TTSVoice.load(str(model_path), str(config_path),
                          dtype="bfloat16")
    srv = TTSServer(voice, port=0, max_batch=16, max_wait_ms=10)
    srv.start()
    try:
        srv.warmup()
        print(f"{tag}: warmup() {len(voice.engine.graphs.programs)} graphs, "
              f"pool {voice.engine.graphs.pool_bytes / 2 ** 20:.1f} MiB",
              flush=True)
        served_held(torch, srv, voice, seed, tag)
        kernels = serving_kernels("bfloat16")
        reset_launches(kernels)
        clients = SERVE_CLIENTS[1]
        slices = serve_load(torch, srv, voice, seed + 1, f32_load["scale"],
                            tag, levels=(clients,))[clients]
        launches = read_launches(kernels, tag, f"bf16 dynamic-batching "
                                 f"server path ({clients}-client window)")
        print(f"{tag}: {clients} clients, audio s per wall s by slice: "
              + compare_times("bf16", slices, "f32",
                              f32_load["slices"][clients]), flush=True)
    finally:
        srv.stop()
    return launches


# the voice-conversion voice: medium widths, the speaker embedding width a
# multi-speaker voice trained by the trainer has (gin 512)
VC_SPEAKERS, VC_GIN = 4, 512
VC_SECONDS = 2.0
# a long input: the spectrogram's cost grows with it
VC_LONG_SECONDS = 20.0


def tone_wave(hp, seconds, seed):
    rng = np.random.default_rng(seed)
    n = int(seconds * hp.sample_rate)
    t = np.arange(n) / hp.sample_rate
    return (0.3 * np.sin(2 * np.pi * 180 * t) * np.sin(2 * np.pi * 3 * t)
            + 0.01 * rng.standard_normal(n)).astype(np.float32)


def vc_phase(torch, seed, root: Path, tag="vc"):
    """Voice conversion on a medium voice of 4 speakers at gin 512,
    written with the port's ONNX writer and loaded on the default device:
    a 2 s input converted by TTSVoice.voice_conversion, against the CPU's
    plain path on the same seed; its graph against the program called
    eagerly; the path's launches (B and C, and no A); and one synthesis
    request as speaker 2 (the speaker term in B at gin 512). Returns
    (the voice's files, the launches of the conversion)."""
    from phoonnx_tpu_torch import SynthesisConfig, TTSVoice
    from phoonnx_tpu_torch.infer import VitsEngine
    from phoonnx_tpu_torch.infer.engine import _bucket_for
    from phoonnx_tpu_torch.models.vits import model as vits_model
    from phoonnx_tpu_torch.ops.stft import spectrogram

    hp = vits_model.VitsHParams.preset("medium", n_speakers=VC_SPEAKERS,
                                       gin_channels=VC_GIN)
    gen = torch.Generator().manual_seed(seed + 11)
    params = vits_model.random_params(hp, gen)
    randomize_post(params["flow"], gen)
    files = write_voice(torch, params, hp, root / "build" / "chip_smoke",
                        name="medium-ms")
    voice = TTSVoice.load(*map(str, files))
    engine = voice.engine
    check(engine.hp.n_speakers == VC_SPEAKERS
          and engine.hp.gin_channels == VC_GIN,
          f"{tag}: loaded {engine.hp.n_speakers} speakers at gin "
          f"{engine.hp.gin_channels}")
    kernels = serving_kernels()
    for seconds in (VC_LONG_SECONDS, VC_SECONDS):
        audio = tone_wave(hp, seconds, seed)
        voice.voice_conversion(audio, 0, 3, seed=seed)  # capture
        times = []
        for _ in range(5):
            reset_launches(kernels)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = voice.voice_conversion(audio, 0, 3, seed=seed)
            times.append((time.perf_counter() - t0) * 1e3)
            counts = launch_counts(kernels)
        print(f"{tag}: {seconds} s input, {len(out)} samples out: median "
              f"{statistics.median(times):.3f} ms of 5 (quartiles "
              f"{'/'.join(f'{q:.3f}' for q in quartiles(times))})",
              flush=True)
    n_fft = (hp.spec_channels - 1) * 2
    n_frames = spectrogram(torch.from_numpy(audio)[None], n_fft,
                           hp.total_upsample, n_fft).shape[1]
    check(len(out) == n_frames * hp.total_upsample,
          f"{tag}: {len(out)} samples for {n_frames} frames")
    check(bool(np.isfinite(out).all()) and float(np.abs(out).max()) > 0,
          f"{tag}: converted audio is not finite and non-silent")
    plain = VitsEngine(params, hp, device="cpu").voice_conversion(
        audio, 0, 3, seed=seed)
    err = float(np.abs(out - plain).max())
    f_bucket = _bucket_for(n_frames, engine.frame_buckets)
    print(f"{tag}: {VC_SECONDS} s input, {n_frames} frames (frame bucket "
          f"{f_bucket}), speaker 0 -> 3: {len(out)} samples, median "
          f"{statistics.median(times):.3f} ms of 5; card vs the CPU's plain "
          f"path max_abs={err:.3e}", flush=True)
    check(err <= PATH_TOL, f"{tag}: the card differs from the CPU's plain "
          f"path by {err:.3e}")
    print(f"{tag}: launches of one conversion {counts}", flush=True)
    check(counts["A"] == 0, f"{tag}: voice conversion launched kernel A")
    check(counts["B"] > 0 and counts["C"] > 0,
          f"{tag}: voice conversion did not launch kernels B and C")

    gen = torch.Generator().manual_seed(seed)
    # the engine computes the spectrum on the card, as its graph takes it
    spec = torch.rand(1, f_bucket, hp.spec_channels,
                      generator=gen).to(engine.device)
    err, equal = replay_vs_eager(
        torch, engine, ("vc", 1, f_bucket), engine._vc,
        (spec, torch.tensor([n_frames], dtype=torch.int32),
         torch.tensor([1]), torch.tensor([2]),
         engine._prior(range(seed, seed + 1), [n_frames], f_bucket)))
    print(f"graph: vc key=('vc', 1, {f_bucket}) replay vs eager "
          f"max_abs={err:.3e} torch.equal={equal}", flush=True)
    check(err <= GRAPH_TOL, f"{tag}: the vc replay differs from eager by "
          f"{err:.3e}")

    cfg = SynthesisConfig(seed=seed, speaker_id=2, normalize_audio=False)
    text = text_of(100, 4)
    chunks = list(voice.synthesize(text, cfg))
    check(len(chunks) == 1 and np.isfinite(
        chunks[0].audio_float_array).all(),
          f"{tag}: the multi-speaker request failed")
    whole = chunks[0].audio_float_array
    stream = np.concatenate([c.audio_float_array for c in
                             voice.synthesize_streaming(text, cfg)])
    err = float(np.abs(stream - whole).max()) if (
        stream.shape == whole.shape) else float("inf")
    print(f"{tag}: a request as speaker 2: {len(whole)} samples; streamed "
          f"vs whole max_abs={err:.3e}", flush=True)
    check(err <= BATCH_TOL, f"{tag}: the speaker-2 stream differs from the "
          f"request by {err:.3e}")
    graph_memory(engine, tag)
    return files, counts


def write_wav(path: Path, audio, rate: int) -> Path:
    import wave

    pcm = (np.clip(audio, -1, 1) * 32767).astype(np.int16)
    with wave.open(str(path), "wb") as f:
        f.setnchannels(1)
        f.setsampwidth(2)
        f.setframerate(rate)
        f.writeframes(pcm.tobytes())
    return path


def cli_phase(medium_files, ms_files, seed, root: Path, tag="cli"):
    """The two CLIs as a user runs them, as subprocesses started together
    on the card: ``python -m phoonnx_tpu_torch.synthesize`` (whole and
    ``--stream``) on the medium voice and ``python -m
    phoonnx_tpu_torch.convert`` on the 4-speaker voice; each must exit 0
    and write a valid, non-silent WAV."""
    import os
    import wave

    from phoonnx_tpu_torch.models.vits.model import VitsHParams

    out = root / "build" / "chip_smoke" / "cli"
    out.mkdir(parents=True, exist_ok=True)
    rate = VitsHParams.preset("medium").sample_rate
    src = write_wav(out / "source.wav", tone_wave(
        VitsHParams.preset("medium"), VC_SECONDS, seed + 1), rate)
    text = text_of(60, 2)
    synth = [sys.executable, "-m", "phoonnx_tpu_torch.synthesize", "-m",
             str(medium_files[0]), "-c", str(medium_files[1]), "-t", text,
             "--seed", str(seed), "--stats"]
    runs = {
        "synthesize": synth + ["-o", str(out / "whole.wav")],
        "synthesize --stream": synth + ["-o", str(out / "stream.wav"),
                                        "--stream"],
        "convert": [sys.executable, "-m", "phoonnx_tpu_torch.convert", "-m",
                    str(ms_files[0]), "-c", str(ms_files[1]), "-i", str(src),
                    "-o", str(out / "converted.wav"), "--from-speaker", "0",
                    "--to-speaker", "3", "--seed", str(seed)],
    }
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    t0 = time.perf_counter()
    procs = {name: subprocess.Popen(cmd, cwd=str(ROOT), env=env,
                                    stdout=subprocess.PIPE,
                                    stderr=subprocess.STDOUT)
             for name, cmd in runs.items()}
    try:
        outputs = {name: proc.communicate(timeout=400)[0].decode(
            errors="replace") for name, proc in procs.items()}
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    wall = time.perf_counter() - t0
    for name, proc in procs.items():
        check(proc.returncode == 0, f"{tag}: {name} exited "
              f"{proc.returncode}:\n{outputs[name][-3000:]}")
        path = Path(runs[name][runs[name].index("-o") + 1])
        with wave.open(str(path), "rb") as f:
            frames = f.getnframes()
            got_rate = f.getframerate()
            pcm = np.frombuffer(f.readframes(frames), np.int16)
        check(got_rate == rate and frames > 0 and np.abs(pcm).max() > 0,
              f"{tag}: {name} wrote {frames} frames at {got_rate} Hz")
        print(f"{tag}: python -m {runs[name][2]}"
              f"{' --stream' if '--stream' in runs[name] else ''} exit 0, "
              f"{frames} samples at {got_rate} Hz", flush=True)
    print(f"{tag}: three CLI processes together in {wall:.1f} s", flush=True)


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


def tone_utterances(hp, n_utts: int, seed: int, seconds, n_symbols: int):
    """(phoneme ids, audio) of ``n_utts`` utterances of per-phoneme tones,
    lengths drawn from ``seconds``."""
    rng = np.random.default_rng(seed)
    for _ in range(n_utts):
        frames = int(rng.uniform(*seconds) * hp.sample_rate / hp.hop_length)
        frames_per_id = int(rng.integers(4, 9))
        ids = rng.integers(1, n_symbols, max(2, frames // frames_per_id))
        yield ids, tone_audio(ids, frames_per_id, hp.hop_length,
                              hp.sample_rate)


def write_dataset(torch, out_dir: Path, hp, n_utts: int, seed: int,
                  seconds=(1.5, 8.0), n_symbols: int = 40) -> Path:
    """A synthetic LJSpeech-style dataset dir: ``config.json``,
    ``dataset.jsonl`` and per-utterance ``.npy`` audio and channel-last
    spectrograms (the port's STFT), utterances of per-phoneme tones with
    lengths drawn from ``seconds``."""
    from phoonnx_tpu_torch.ops import stft

    if out_dir.exists():
        shutil.rmtree(out_dir)
    (out_dir / "cache").mkdir(parents=True)
    config = {"num_symbols": n_symbols, "num_speakers": 1,
              "audio": {"sample_rate": hp.sample_rate}}
    (out_dir / "config.json").write_text(json.dumps(config),
                                         encoding="utf-8")
    lines = []
    for i, (ids, audio) in enumerate(tone_utterances(hp, n_utts, seed,
                                                     seconds, n_symbols)):
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


def mas_case(torch, dev, gen, lengths):
    """Kernel D's inputs for (y_len, x_len) pairs, integer scores (ties)
    in the first element."""
    from phoonnx_tpu_torch.ops import mas

    t_y = max(y for y, _ in lengths)
    t_x = max(x for _, x in lengths)
    neg_cent = torch.randn(len(lengths), t_y, t_x, device=dev, generator=gen)
    neg_cent[0] = torch.round(neg_cent[0] * 2)
    mask = torch.zeros_like(neg_cent)
    for i, (y, x) in enumerate(lengths):
        mask[i, :y, :x] = 1
    return mas.lengths_and_value(neg_cent, mask)


def mas_equal(torch, label, got, want):
    torch.cuda.synchronize()
    check(torch.equal(got, want), f"kernel D {label} differs from its plain "
          f"version in {int((got != want).sum())} cells")


def mas_phase(torch, dev, seed, parent=None):
    """Kernel D against its plain version, bit for bit, at the edge shapes
    of its tiling and at [16, 832, 320]; the device kernels in one call,
    its phases and, with ``parent`` (the parent checkout's kernel D), the
    parent's time in turn."""
    from phoonnx_tpu_torch.ops import mas

    gen = torch.Generator(device=dev).manual_seed(seed + 7)
    for lengths in mas.EDGES:
        value, y_lens, x_lens = mas_case(torch, dev, gen, lengths)
        mas_equal(torch, f"at {lengths}", mas.launch(value, y_lens, x_lens),
                  mas.maximum_path_plain(value, y_lens, x_lens))
    print(f"kernel D: torch.equal to plain at {len(mas.EDGES)} edge shapes "
          f"{mas.EDGES}", flush=True)

    inputs = mas_inputs(torch, dev, seed)
    b, t_y, t_x = MAS_SHAPE
    for value, y_lens, x_lens in inputs:
        got = mas.launch(value, y_lens, x_lens)
        mas_equal(torch, f"at {list(MAS_SHAPE)}", got,
                  mas.maximum_path_plain(value, y_lens, x_lens))
        rows = got.sum(dim=2)
        check(bool(((rows == 1) | (rows == 0)).all()),
              "kernel D marked more than one phoneme in a frame")
    per_call = kernels_in_call(torch, lambda: mas.launch(*inputs[0]), "D",
                               "mas_kernel")
    k_ms = median_ms(torch, mas.launch, inputs)
    p_ms = median_ms(torch, mas.maximum_path_plain, inputs)

    names = mas.phases()
    stamps = torch.zeros(len(names) + 1, dtype=torch.int64, device=dev)
    runs = []
    for _ in range(REPS + 1):
        mas.launch(*inputs[0], stamps=stamps)
        torch.cuda.synchronize()
        runs.append(stamps.diff().cpu().tolist())
    per_phase = [statistics.median(r[i] for r in runs[1:]) / 1e6
                 for i in range(len(names))]
    rows0 = int(inputs[0][1][0])
    warps, cells, chunk = mas.plan(t_x)
    print(f"phases: kernel D: block 0 ({rows0} rows, {warps} warp(s) of "
          f"{cells} cells, chunks of {chunk} rows), "
          + ", ".join(f"{n} {ms:.4f} ms" for n, ms in zip(names, per_phase))
          + f"; forward {per_phase[0] * 1e6 / rows0:.1f} ns a row, backtrack "
          f"{per_phase[1] * 1e6 / rows0:.1f} ns a row", flush=True)

    if parent is not None:
        for value, y_lens, x_lens in inputs:
            mas_equal(torch, "against the parent's kernel",
                      mas.launch(value, y_lens, x_lens),
                      parent(value, y_lens, x_lens))
        turns = [("parent", parent), ("this", mas.launch),
                 ("this", mas.launch), ("parent", parent)]
        times = [(who, median_ms(torch, fn, inputs)) for who, fn in turns]
        print("kernel D in turn: " + ", ".join(
            f"{who} {ms:.4f} ms" for who, ms in times), flush=True)

    flops = 2.0 * b * t_y * t_x  # an add and a max per cell, full grid
    nbytes = 2.0 * b * t_y * t_x * 4 + 2 * b * 4  # scores in, path out
    b_ms, b_by = bound(flops, nbytes)
    print(f"kernel D B={b} T_y={t_y} T_x={t_x}: torch.equal to plain, "
          f"max_abs_err=0 kernel_ms={k_ms:.4f} plain_ms={p_ms:.4f} "
          f"bound_ms={b_ms:.5f} ({b_by}) flops={flops:.4e} "
          f"bytes={nbytes:.4e} device_ops_per_call={per_call}", flush=True)
    return {"max_abs_err": 0.0, "ms": k_ms, "plain_ms": p_ms,
            "bound_ms": b_ms, "bound_by": b_by}


# the engine's largest prior draw: 16 lanes at frame bucket 1,024 of the
# medium voice's 192 channels
NOISE_SHAPE = (16, 1024, 192)
# the kernel's normals against the plain version's (float32 both; the
# card's logf / sincosf and the CPU's log / cos / sin differ by an ulp or
# two, times a radius of at most 5.77)
NOISE_TOL = 2e-6
NOISE_LOOP = 200


def noise_phase(torch, dev, seed):
    """The noise kernel at NOISE_SHAPE against its plain version, both
    draws of the engine (ragged lengths, one lane masked whole), a short
    draw as the start of the long one and each lane as the one-lane draw
    at its seed, bf16 as the float32 draw rounded; the device kernels in
    one call; its time (CUDA events: one launch from Python, and a graph
    of NOISE_LOOP launches) against its bytes at the memory rate; the
    launches it counted."""
    from phoonnx_tpu_torch.ops import noise

    lanes, rows, channels = NOISE_SHAPE
    big = seed + 2 ** 32 + 81
    lengths = torch.tensor([(rows * (i + 3)) // (lanes + 2) for i in
                            range(lanes - 1)] + [0], dtype=torch.int32)
    lens = lengths.to(dev)
    before = (noise.launches, noise.launches_bf16)
    err = 0.0
    for tag in (noise.DURATION, noise.PRIOR):
        got = noise.launch(big, lanes, rows, channels, tag, dev, lens)
        want = noise.normal_plain(big, lanes, rows, channels, tag, lengths)
        got_cpu = got.cpu()
        err = max(err, (got_cpu - want).abs().max().item())
        zeros = all(not got_cpu[b, n:].any()
                    for b, n in enumerate(lengths.tolist()))
        check(zeros, f"kernel noise: tag {tag}: a masked row is not 0")
        bf16 = noise.launch(big, lanes, rows, channels, tag, dev, lens,
                            torch.bfloat16)
        check(torch.equal(bf16, got.to(torch.bfloat16)),
              f"kernel noise: tag {tag}: bf16 is not the float32 draw "
              "rounded")
    check(err <= NOISE_TOL, f"kernel noise: {err:.3e} from its plain "
          f"version (bound {NOISE_TOL:g})")
    whole = noise.launch(big, lanes, rows, channels, noise.PRIOR, dev)
    short = noise.launch(big, lanes, 37, channels, noise.PRIOR, dev)
    check(torch.equal(short, whole[:, :37]),
          "kernel noise: a short draw is not the start of the long one")
    for b in (1, lanes - 1):
        check(torch.equal(whole[b], noise.launch(big + b, 1, rows, channels,
                                                 noise.PRIOR, dev)[0]),
              f"kernel noise: lane {b} is not the one-lane draw at its seed")
    counted = (noise.launches - before[0], noise.launches_bf16 - before[1])
    check(counted == (6, 2), f"kernel noise: {counted} launches (float32, "
          "bfloat16) counted for (6, 2)")

    def draw(s):
        return noise.launch(s, lanes, rows, channels, noise.PRIOR, dev, lens)

    per_call = kernels_in_call(torch, lambda: draw(big), "noise",
                               "normal_kernel")
    k_ms = median_ms(torch, draw, [(big + i,) for i in range(4)])
    # the device alone: NOISE_LOOP launches captured in one graph and
    # replayed (a launch from Python takes longer on the host than the
    # kernel on the card, so a loop of launches times the host)
    graph = torch.cuda.CUDAGraph()
    with launch_counts_kept({"noise": noise.__name__}), \
            torch.cuda.graph(graph):
        for i in range(NOISE_LOOP):
            draw(big + i)
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    graph.replay()
    end.record()
    end.synchronize()
    graph_ms = start.elapsed_time(end) / NOISE_LOOP
    del graph
    t0 = time.perf_counter()
    noise.normal_plain(big, lanes, rows, channels, noise.PRIOR, lengths)
    p_ms = (time.perf_counter() - t0) * 1e3
    nbytes = lanes * rows * channels * 4.0 + lanes * 4
    b_ms, b_by = bound(0.0, nbytes)
    print(f"kernel noise {lanes}x{rows}x{channels}: max_abs_err={err:.3e} "
          f"(bound {NOISE_TOL:g}) kernel_ms={k_ms:.5f} (one launch from "
          f"Python) graph_ms={graph_ms:.5f} (a launch of {NOISE_LOOP} in one "
          f"graph) plain_ms={p_ms:.3f} (the host's CPU) "
          f"bound_ms={b_ms:.5f} ({b_by}) bytes={nbytes:.4e} "
          f"device_ops_per_call={per_call} launches_counted={counted} "
          "(float32, bfloat16)",
          flush=True)
    return {"max_abs_err": err, "ms": graph_ms, "plain_ms": p_ms,
            "bound_ms": b_ms, "bound_by": b_by}


def params_of(state):
    from phoonnx_tpu_torch.train import step

    return step.leaves(state.params_g) + step.leaves(state.params_d)


# ---------------------------------------------------------------------------
# the text front end on the card: ByT5 G2P, diacritizers, bundled G2P
# ---------------------------------------------------------------------------

# byt5-small's widths (google/byt5-small's config.json), as
# tools/bench_byt5.py sets them
BYT5_SMALL = {"vocab_size": 384, "d_model": 1472, "d_kv": 64, "d_ff": 3584,
              "num_heads": 6, "num_encoder_layers": 12,
              "num_decoder_layers": 4}
# tools/bench_byt5.py's decode: a Charsiu-style batch of 16 words of 12
# bytes, 32 decode steps; and one 100-byte sentence
G2P_WORDS, G2P_WORD_BYTES, G2P_STEPS, G2P_SENTENCE = 16, 12, 32, 100
# the card against the same port code on the host's CPU, max-abs over the
# peak: float32 (TF32 off) sums in other orders (2e-6 read on the H100);
# bf16 rounds at the same points, but a sum can land on the other side of
# a rounding (2^-8 a step; 3e-4 read). A wrong op differs by 1e-1 and more.
G2P_TOL = {"float32": 1e-4, "bfloat16": 1e-2}
# a decode split is allowed at a step whose reference top-2 gap is below
# this many times the two decodes' measured logit difference
TIE_MARGIN = 4.0
G2P_RUNS = 7
# the voices' id maps: every printable ASCII character (Buckwalter, and
# the bytes a G2P emits), the pad/bos/eos and space ids first
ASCII_IDS = {"_": 0, "^": 1, "$": 2, " ": 3}
ASCII_IDS.update({chr(c): i + 4 for i, c in enumerate(
    c for c in range(33, 127) if chr(c) not in ASCII_IDS)})
ARABIC_TEXTS = ("مرحبا بالعالم", "ذهب الطالب إلى المدرسة",
                "كتب الولد 12 درسا في 2024")
KOREAN_TEXT = "안녕하세요 韓國 사람입니다"
# tools/bench_aux.py's tashkeel geometry: char and hint embeddings of
# 128, two bidirectional LSTM layers of 256, a per-character head
TASHKEEL_EMB, TASHKEEL_HIDDEN, TASHKEEL_LAYERS = 128, 256, 2


def byt5_words(rng, n_words: int, n_bytes: int):
    """Byte ids as the phonemizers make them (printable bytes + 3) with
    EOS, as tools/bench_byt5.py draws them."""
    return [[int(b) + 3 for b in rng.integers(35, 125, n_bytes)] + [1]
            for _ in range(n_words)]


def rel_err(got, want) -> float:
    """max |got - want| over max(1, max |want|), on the host."""
    got, want = got.float().cpu(), want.float().cpu()
    return float((got - want).abs().max() / max(1.0, want.abs().max()))


def g2p_compare(torch, card, cpu, batch, tol, tag):
    """One batch on the card and on the CPU engine of the same weights:
    the encoder output and the decoder's logits teacher-forced on the
    CPU's tokens (max-abs over the peak, each within ``tol``); the
    card engine's greedy tokens against the CPU's under the near-tie
    rule, whose reference gaps are the CPU decode's own logits, step by
    step, and whose tolerance is TIE_MARGIN times the two decodes'
    largest logit difference over the steps both ran on the same tokens.
    The inputs are padded as the engines pad them."""
    from phoonnx_tpu_torch.infer.engine import _prec_scope
    from phoonnx_tpu_torch.models import byt5

    cfg = cpu.cfg
    lanes = len(batch)
    check(lanes & (lanes - 1) == 0, f"{tag}: {lanes} rows, not a power of 2")
    bucket = next(b for b in cpu.input_buckets
                  if max(map(len, batch)) <= b)
    budget = cpu._decode_for(bucket).keywords["max_length"]
    ids = np.zeros((lanes, bucket), np.int64)
    for row, utt in enumerate(batch):
        ids[row, :len(utt)] = utt
    ids_t = torch.from_numpy(ids)
    mask_t = (ids_t > 0).long()
    decodes = {}
    for name, eng in (("cpu", cpu), ("card", card)):
        st = {}
        with _prec_scope(None), torch.inference_mode():
            toks, lens = byt5.greedy_decode(
                eng.params, cfg, ids_t.to(eng.device),
                mask_t.to(eng.device), max_length=budget, stats=st,
                keep_logits=True)
        toks, lens = toks.cpu(), lens.cpu()
        decodes[name] = ([toks[r, :int(lens[r])].tolist()
                          for r in range(lanes)], st["logits"].float().cpu())
    (want, ref), (got, card_logits) = decodes["cpu"], decodes["card"]
    check(card.greedy_decode_batch(batch) == got,
          f"{tag}: the engine's decode differs from greedy_decode's")
    steps = ref.shape[0]
    teacher = np.zeros((lanes, steps), np.int64)
    prefix_err = 0.0
    for row, (w, g) in enumerate(zip(want, got)):
        w_ext, g_ext = w + [cfg.eos_id], g + [cfg.eos_id]
        k = min(len(w_ext), steps)
        teacher[row, 1:k] = w_ext[:k - 1]
        same = next((i for i in range(min(len(w_ext), len(g_ext)))
                     if w_ext[i] != g_ext[i]), min(len(w_ext), len(g_ext)))
        n = min(same + 1, steps, card_logits.shape[0])
        prefix_err = max(prefix_err, float(
            (card_logits[:n, row] - ref[:n, row]).abs().max()))
    outs = []
    with torch.inference_mode():
        for eng in (cpu, card):
            dev = eng.device
            enc = byt5.encode(eng.params, cfg, ids_t.to(dev), mask_t.to(dev))
            outs.append((enc, byt5._decoder_logits_full(
                eng.params, cfg, torch.from_numpy(teacher).to(dev), enc,
                mask_t.to(dev))))
    (enc_p, log_p), (enc_k, log_k) = outs
    enc_err = rel_err(enc_k, enc_p)
    log_err = rel_err(log_k, log_p)
    print(f"{tag}: {lanes} x {bucket} bytes, {steps} steps: card vs CPU "
          f"encoder max-abs/peak {enc_err:.3e}, teacher-forced logits "
          f"{log_err:.3e} (bound {tol:g}); the decodes' logits on their "
          f"common tokens max-abs {prefix_err:.3e} of a peak "
          f"{float(ref.abs().max()):.3f}", flush=True)
    check(enc_err <= tol and log_err <= tol,
          f"{tag}: the card's encoder or logits differ from the CPU's")
    tie_tol = TIE_MARGIN * prefix_err
    ties, splits = [], 0
    for row, (w, g) in enumerate(zip(want, got)):
        n = min(len(w) + 1, steps)
        tie, diff = near_tie_split(w, g, ref[:n, row].numpy(), tie_tol,
                                   cfg.eos_id, f"{tag}: row {row}")
        ties.append(tie)
        splits += diff is not None
    print(f"{tag}: tokens and lengths card vs CPU: {lanes - splits} of "
          f"{lanes} rows equal, {splits} split after a near tie; first "
          f"near tie by row {ties}", flush=True)
    return want


def g2p_timing(torch, card, seed, card_name, tag):
    """The card's batch decode of 16 words: median ms of G2P_RUNS calls on
    varied words, words/s, tokens/s, the device kernels of one decode
    (the encoder's apart) per decode step, host reads, and the idle
    share of one profiled call."""
    from phoonnx_tpu_torch.models import byt5

    rng = np.random.default_rng(seed + 100)
    batches = [byt5_words(rng, G2P_WORDS, G2P_WORD_BYTES)
               for _ in range(G2P_RUNS + 1)]
    card.greedy_decode_batch(batches[-1])
    times = []
    for batch in batches[:-1]:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        card.greedy_decode_batch(batch)
        times.append((time.perf_counter() - t0) * 1e3)
    q = quartiles(times)
    steps, reads = card.last_decode["steps"], card.last_decode["reads"]
    wall_us, busy_us, rows = device_profile(
        torch, partial(card.greedy_decode_batch, batches[0]),
        f"{tag}: one batch decode", top=0)
    kernels = sum(r[1] for r in rows)
    ids = torch.zeros((G2P_WORDS, 32), dtype=torch.long, device=card.device)
    ids[:, :G2P_WORD_BYTES] = 40

    def encode():
        with torch.inference_mode():
            byt5.encode(card.params, card.cfg, ids, (ids > 0).long())

    _, _, enc_rows = device_profile(torch, encode, f"{tag}: the encoder",
                                    top=0)
    enc_kernels = sum(r[1] for r in enc_rows)
    per_step = (kernels - enc_kernels) / steps
    # the least time: the weights read once and their products (2 flops a
    # weight a token: the encoder's over the padded input, the decoder's
    # and the head's over the steps; the embedding is a gather) at the
    # peak of the weights' dtype
    p = card.params
    elem = p["shared"]["weight"].element_size()
    enc_w = tensor_bytes(p["encoder"]) / elem
    dec_w = (tensor_bytes(p["decoder"]) + tensor_bytes(p.get("lm_head", {}))
             ) / elem
    flops = 2 * G2P_WORDS * (enc_w * ids.shape[1] + dec_w * steps)
    least_ms, least_by = bound(
        flops, tensor_bytes(p), PEAK_F32_FLOPS if elem == 4
        else PEAK_BF16_FLOPS)
    print(f"{tag}: batch of {G2P_WORDS} words x {G2P_WORD_BYTES} bytes, "
          f"{steps} steps: ms median {q[1]:.3f} (quartiles {q[0]:.3f}-"
          f"{q[2]:.3f}, {G2P_RUNS} runs), {G2P_WORDS / q[1] * 1e3:.1f} "
          f"words/s, {G2P_WORDS * steps / q[1] * 1e3:.1f} tokens/s, "
          f"{kernels} device kernels a decode ({enc_kernels} the encoder's, "
          f"{per_step:.1f} a decode step), {reads} host reads a decode, "
          f"device busy {busy_us / 1e3:.3f} ms of {wall_us / 1e3:.3f}, idle "
          f"share {1 - busy_us / wall_us:.3f}; least time {least_ms:.3f} ms "
          f"({least_by}, {flops / 1e9:.1f} GFLOP) [{card_name}]", flush=True)
    return {"ms": q[1], "kernels_per_step": per_step, "reads": reads}


def g2p_phase(torch, seed, card_name, widths=BYT5_SMALL, tag="g2p"):
    """ByT5Engine at byt5-small widths with random weights (HF naming,
    from ``seed``), float32 and bfloat16: the card against the port's CPU
    path (encoder, teacher-forced logits, greedy decode of the word batch
    and of the sentence), then the card's batch decode timed. Returns the
    weights by name."""
    from phoonnx_tpu_torch.models import byt5

    t0 = time.perf_counter()
    cfg = byt5.T5Config(**widths)
    named = byt5.random_flat(cfg, seed)
    print(f"{tag}: {sum(v.size for v in named.values()) / 1e6:.1f} M "
          f"parameters ({cfg.num_encoder_layers} + {cfg.num_decoder_layers} "
          f"layers, d_model {cfg.d_model}, d_ff {cfg.d_ff}) drawn in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    rng = np.random.default_rng(seed)
    words = byt5_words(rng, G2P_WORDS, G2P_WORD_BYTES)
    sentence = byt5_words(rng, 1, G2P_SENTENCE)
    for dtype in ("float32", "bfloat16"):
        kw = {"max_length": G2P_STEPS, "dtype": dtype}
        card = byt5.ByT5Engine.from_flat(named, **kw)
        cpu = byt5.ByT5Engine.from_flat(named, device="cpu", **kw)
        check(card.device.type == "cuda", f"{tag}: the engine is not on "
              "the GPU")
        sub = f"{tag} {dtype}"
        g2p_compare(torch, card, cpu, words, G2P_TOL[dtype],
                    f"{sub} words")
        g2p_compare(torch, card, cpu, sentence, G2P_TOL[dtype],
                    f"{sub} sentence")
        g2p_timing(torch, card, seed, card_name, sub)
        del card, cpu
    print(f"{tag}: the phase took {time.perf_counter() - t0:.1f} s",
          flush=True)
    return named


def front_voice(config_path: Path, name: str, phoneme_type: str, lang: str,
                id_map, phonemizer_model=None) -> Path:
    """A config beside ``config_path``'s voice (the same weights) with
    another front end."""
    cfg = json.loads(config_path.read_text(encoding="utf-8"))
    cfg.update(phoneme_type=phoneme_type, lang_code=lang, alphabet="ipa",
               phoneme_id_map=id_map, num_symbols=len(id_map),
               phonemizer_model=phonemizer_model)
    out = config_path.parent / f"{name}.onnx.json"
    out.write_text(json.dumps(cfg), encoding="utf-8")
    return out


def write_tashkeel(out_dir: Path, seed: int) -> Path:
    """A libtashkeel-contract model of tools/bench_aux.py's geometry
    (char and hint embeddings, a 2-layer biLSTM masked by
    ``input_lengths``, a head over target_id_map.json; outputs the
    argmax ids and the max logit), built with the port's GraphBuilder
    beside the three id maps."""
    from phoonnx_tpu_torch.onnx.builder import GraphBuilder
    from phoonnx_tpu_torch.onnx.writer import write_onnx
    from phoonnx_tpu_torch.thirdparty import tashkeel

    out_dir.mkdir(parents=True, exist_ok=True)
    maps = {}
    for name in ("input_id_map", "target_id_map", "hint_id_map"):
        shutil.copy(tashkeel.TASHKEEL_DIR / f"{name}.json", out_dir)
        maps[name] = json.loads((tashkeel.TASHKEEL_DIR / f"{name}.json")
                                .read_text(encoding="utf-8"))
    rng = np.random.default_rng(seed)

    def rand(shape, std):
        return (rng.standard_normal(shape) * std).astype(np.float32)

    b = GraphBuilder()
    emb = TASHKEEL_EMB
    emb_c = b.init("emb_c", rand((len(maps["input_id_map"]), emb), 0.1))
    emb_d = b.init("emb_d", rand((len(maps["hint_id_map"]), emb), 0.1))
    e = b.add(b.n("Gather", [emb_c, "char_inputs"], axis=0),
              b.n("Gather", [emb_d, "diac_inputs"], axis=0))  # [1, T, E]
    x = b.transpose(e, [1, 0, 2])  # [T, 1, E]
    hidden, inp = TASHKEEL_HIDDEN, emb
    for layer in range(TASHKEEL_LAYERS):
        w = b.init(f"w{layer}", rand((2, 4 * hidden, inp), 0.05))
        r = b.init(f"r{layer}", rand((2, 4 * hidden, hidden), 0.05))
        y = b.n("LSTM", [x, w, r, "", "input_lengths"], n_out=3,
                hidden_size=hidden, direction="bidirectional")[0]
        x = b.reshape(b.transpose(y, [0, 2, 1, 3]), [0, 1, -1])  # [T,1,2H]
        inp = 2 * hidden
    n_cls = len(maps["target_id_map"])
    scores = b.squeeze(b.matmul(x, b.init("proj", rand((inp, n_cls), 1.0))),
                       [1])  # [T, C]
    target = b.unsqueeze(b.n("ArgMax", [scores], axis=1, keepdims=0), [0])
    logits = b.unsqueeze(b.reduce_max(scores, [1], keepdims=0), [0])
    write_onnx(str(out_dir / "model.onnx"), b.initializers,
               inputs=["char_inputs", "diac_inputs", "input_lengths"],
               outputs=[target, logits], nodes=b.nodes)
    return out_dir


def front_launches(torch, voice, texts, seed, tag, path):
    """Synthesize ``texts`` with the voice on the card, A, B and C counted
    from 0; each must launch. Returns (launches, audio of each text)."""
    from phoonnx_tpu_torch import SynthesisConfig

    kernels = serving_kernels()
    reset_launches(kernels)
    audio = []
    for i, text in enumerate(texts):
        chunks = list(voice.synthesize(text, SynthesisConfig(
            seed=seed + i, noise_scale=0.0, noise_w_scale=0.0,
            normalize_audio=False)))
        check(len(chunks) > 0, f"{tag}: no audio for {text!r}")
        wave = np.concatenate([c.audio_float_array for c in chunks])
        hop = voice.engine.hp.total_upsample
        check(bool(np.isfinite(wave).all()) and len(wave) % hop == 0,
              f"{tag}: {len(wave)} samples, finite "
              f"{bool(np.isfinite(wave).all())}")
        audio.append(wave)
    return read_launches(kernels, tag, path), audio


def runner_places(stats, tag, what):
    """A runner's run: every host value is a small integer (shape
    arithmetic)."""
    bad = [h for h in stats.host_outputs
           if np.dtype(h[2]).kind not in "biu" or h[3] > 8]
    print(f"{tag}: {what}: {stats.nodes} nodes, outputs by place "
          f"{dict(stats.outputs)}, host nodes {dict(stats.host_nodes)}, "
          f"host reads {dict(stats.reads)}", flush=True)
    check(not bad, f"{tag}: {what}: values beyond shape arithmetic on the "
          f"host: {bad[:5]}")


def arabic_phase(torch, model_path, config_path, seed, root: Path,
                 tag="arabic"):
    """A mantoq voice (lang "ar") on the card with a tashkeel model of
    tools/bench_aux.py's geometry on its phonemizer: the diacritized text
    and the ids card vs CPU for three sentences (one with digits), the
    runner's placement and device kernels, A, B and C launched, and the
    sentence with digits within PATH_TOL of the CPU port's audio."""
    from phoonnx_tpu_torch import SynthesisConfig, TTSVoice
    from phoonnx_tpu_torch.thirdparty.tashkeel import TashkeelDiacritizer

    t_start = time.perf_counter()
    model_dir = write_tashkeel(root / "build" / "chip_smoke" / "tashkeel",
                               seed)
    cfg_path = front_voice(config_path, "arabic", "mantoq", "ar", ASCII_IDS)
    voices = {}
    for dev in (None, "cpu"):
        v = TTSVoice.load(str(model_path), str(cfg_path), device=dev)
        v.phonemizer._tashkeel = TashkeelDiacritizer(model_dir, device=dev)
        voices["card" if dev is None else "cpu"] = v
    card, cpu = voices["card"], voices["cpu"]
    check(card.phonemizer.tashkeel.device.type == "cuda",
          f"{tag}: the diacritizer is not on the GPU")
    for text in ARABIC_TEXTS:
        got = card.phonemizer.add_diacritics(text, "ar")
        want = cpu.phonemizer.add_diacritics(text, "ar")
        ids_k = [card.phonemes_to_ids(p) for p in card.phonemize(got)]
        ids_p = [cpu.phonemes_to_ids(p) for p in cpu.phonemize(want)]
        runner_places(card.phonemizer.tashkeel._runner.last_run, tag,
                      f"{len(text)} chars")
        d = card.phonemizer.tashkeel
        times = []
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            d.diacritize(text, card.phonemizer.taskeen_threshold)
            times.append((time.perf_counter() - t0) * 1e3)
        wall_us, busy_us, rows = device_profile(
            torch, partial(d.diacritize, text,
                           card.phonemizer.taskeen_threshold),
            f"{tag}: one diacritization", top=0)
        kernels = sum(r[1] for r in rows)
        print(f"{tag}: {text!r}: diacritized {got!r}; equal to the CPU's "
              f"{got == want}, ids {sum(map(len, ids_k))} equal "
              f"{ids_k == ids_p}; diacritizer ms median "
              f"{statistics.median(times):.3f} (5 runs), {kernels} device "
              f"kernels, busy {busy_us / 1e3:.3f} ms of "
              f"{wall_us / 1e3:.3f}, idle share "
              f"{1 - busy_us / wall_us:.3f}", flush=True)
        check(got == want and ids_k == ids_p,
              f"{tag}: {text!r}: the card's diacritics or ids differ")
        check(got != text and kernels > 0,
              f"{tag}: {text!r}: no diacritics or no device kernel")
    launches, audio = front_launches(torch, card, ARABIC_TEXTS, seed, tag,
                                     "Arabic (mantoq, tashkeel) path")
    ref = np.concatenate([c.audio_float_array for c in cpu.synthesize(
        ARABIC_TEXTS[2], SynthesisConfig(
            seed=seed + 2, noise_scale=0.0, noise_w_scale=0.0,
            normalize_audio=False))])
    check(ref.shape == audio[2].shape,
          f"{tag}: {audio[2].shape} samples on the card, {ref.shape} on "
          "the CPU")
    err = float(np.abs(audio[2] - ref).max())
    print(f"{tag}: {ARABIC_TEXTS[2]!r}: card vs CPU waveform max-abs "
          f"{err:.3e} (bound {PATH_TOL:g}); the phase took "
          f"{time.perf_counter() - t_start:.1f} s", flush=True)
    check(err <= PATH_TOL, f"{tag}: the waveform differs by {err:.3e}")
    return launches


def korean_phase(torch, model_path, config_path, seed, tag="korean"):
    """A KoG2P voice (IPA) on the card: one request, its ids equal to the
    CPU front end's, A, B and C launched."""
    from phoonnx_tpu_torch import TTSVoice
    from phoonnx_tpu_torch.config import Alphabet, get_phonemizer

    ipa = get_phonemizer("kog2p", Alphabet.IPA).phonemize(KOREAN_TEXT, "ko")
    id_map = dict(ASCII_IDS)
    for c in sorted({c for sent in ipa for c in sent}):
        id_map.setdefault(c, len(id_map))
    cfg_path = front_voice(config_path, "korean", "kog2p", "ko", id_map)
    card = TTSVoice.load(str(model_path), str(cfg_path))
    host = TTSVoice(engine=None, config=card.config)  # the front end alone
    ids_k = [card.phonemes_to_ids(p) for p in card.phonemize(KOREAN_TEXT)]
    ids_p = [host.phonemes_to_ids(p) for p in host.phonemize(KOREAN_TEXT)]
    print(f"{tag}: {KOREAN_TEXT!r} -> {''.join(ipa[0])!r}, "
          f"{sum(map(len, ids_k))} ids, equal to the CPU's "
          f"{ids_k == ids_p}", flush=True)
    check(ids_k == ids_p and sum(map(len, ids_k)) > 20,
          f"{tag}: the ids differ or are too few")
    return front_launches(torch, card, [KOREAN_TEXT], seed, tag,
                          "Korean (kog2p) path")[0]


# tests/test_phonikud_model.py's model: per-character Gather tables over
# an 8-entry vocabulary held in the ONNX metadata
HEBREW_VOCAB = {"[PAD]": 0, "[UNK]": 1, "[CLS]": 2, "[SEP]": 3,
                "א": 4, "ב": 5, "ש": 6, "ו": 7}
HEBREW_TEXTS = ("אבשו", "abc א! 12", "שלום עולם\nבבב",
                "אב" * 150 + " ו")


def write_phonikud(out_dir: Path) -> Path:
    """tests/test_phonikud_model.py's Gather-table model (ALEF patah and
    hatama, BET dagesh+patah, SHIN sin dot, sheva and vocal shva, VAV
    mater lectionis)."""
    from phoonnx_tpu_torch.onnx.writer import write_onnx
    from phoonnx_tpu_torch.thirdparty.phonikud import NIKUD_CLASSES

    def one_hot(rows, n_cls):
        table = np.full((len(rows), n_cls), -5.0, np.float32)
        table[np.arange(len(rows)), rows] = 5.0
        return table

    v = HEBREW_VOCAB
    nikud = [0] * len(v)
    nikud[v["א"]] = NIKUD_CLASSES.index(chr(0x05B7))
    nikud[v["ב"]] = NIKUD_CLASSES.index("ּ" + chr(0x05B7))
    nikud[v["ש"]] = NIKUD_CLASSES.index(chr(0x05B0))
    nikud[v["ו"]] = 1  # mater lectionis
    shin = [0] * len(v)
    shin[v["ש"]] = 1
    add = np.full((len(v), 3), -5.0, np.float32)
    add[v["א"], 0] = add[v["ש"], 1] = 5.0
    out_dir.mkdir(parents=True, exist_ok=True)
    path = out_dir / "phonikud.onnx"
    write_onnx(str(path), {"nikud_table": one_hot(nikud, len(NIKUD_CLASSES)),
                           "shin_table": one_hot(shin, 2), "add_table": add},
               metadata={"vocab": json.dumps(v)},
               inputs=["input_ids", "attention_mask"],
               outputs=["nikud_logits", "shin_logits", "additional_logits"],
               nodes=[("Gather", ["nikud_table", "input_ids"],
                       ["nikud_logits"]),
                      ("Gather", ["shin_table", "input_ids"],
                       ["shin_logits"]),
                      ("Gather", ["add_table", "input_ids"],
                       ["additional_logits"])])
    return path


def hebrew_phase(torch, root: Path, tag="hebrew"):
    """PhonikudDiacritizer on the card with the Gather-table model: each
    text's output equal to the CPU's, device kernels > 0, and
    ``_download`` never reached."""
    from phoonnx_tpu_torch.thirdparty.phonikud import PhonikudDiacritizer

    path = write_phonikud(root / "build" / "chip_smoke" / "phonikud")

    def refuse(self):
        fail(f"{tag}: PhonikudDiacritizer._download was reached")

    kept = PhonikudDiacritizer._download
    PhonikudDiacritizer._download = refuse
    try:
        card = PhonikudDiacritizer(model_path=str(path))
        cpu = PhonikudDiacritizer(model_path=str(path), device="cpu")
        for text in HEBREW_TEXTS:
            got, want = card.diacritize(text), cpu.diacritize(text)
            check(got == want, f"{tag}: {text[:20]!r}: card {got[:40]!r} "
                  f"vs CPU {want[:40]!r}")
        check(card._runner.device.type == "cuda",
              f"{tag}: the runner is not on the GPU")
        runner_places(card._runner.last_run, tag, "the last text")
        _, busy_us, rows = device_profile(
            torch, partial(card.diacritize, HEBREW_TEXTS[0]),
            f"{tag}: one diacritization", top=0)
        kernels = sum(r[1] for r in rows)
        print(f"{tag}: {len(HEBREW_TEXTS)} texts equal to the CPU's, e.g. "
              f"{HEBREW_TEXTS[0]!r} -> {card.diacritize(HEBREW_TEXTS[0])!r}"
              f"; {kernels} device kernels a call", flush=True)
        check(kernels > 0, f"{tag}: no device kernel")
    finally:
        PhonikudDiacritizer._download = kept


def byt5_voice_phase(torch, model_path, config_path, named, seed, root: Path,
                     tag="byt5 voice"):
    """The medium voice with phoneme_type "byt5" over an initializers-only
    ONNX of the g2p weights: TTSVoice.load -> synthesize with the G2P on
    the card, its ids equal to the CPU's, A, B and C launched, and the
    share of a request spent in the G2P."""
    from phoonnx_tpu_torch import SynthesisConfig, TTSVoice
    from phoonnx_tpu_torch.models import byt5
    from phoonnx_tpu_torch.onnx.writer import write_onnx
    from phoonnx_tpu_torch.phonemizers.mul import ByT5Phonemizer

    t_start = time.perf_counter()
    # 20 bytes with the language tag: input bucket 32, a 128-step budget
    text = "hello there"
    g2p_path = root / "build" / "chip_smoke" / "g2p.onnx"
    cfg_path = front_voice(config_path, "byt5", "byt5", "en-US", ASCII_IDS,
                           str(g2p_path))

    def load():
        write_onnx(str(g2p_path), named)
        voice = TTSVoice.load(str(model_path), str(cfg_path))
        ids = [voice.phonemes_to_ids(p) for p in voice.phonemize(text)]
        return voice, ids

    voice, ids = load()
    if sum(map(len, ids)) < 20:
        # random weights emit bytes that are rarely printable UTF-8: scale
        # lm_head's rows of the map's letters (byte + 3) so the G2P
        # spells some
        print(f"{tag}: {sum(map(len, ids))} ids from random weights; "
              "lm_head biased toward the map's letters", flush=True)
        named = dict(named)
        head = named["lm_head.weight"].copy()
        head[[ord(c) + 3 for c in "abcdefghijklmnopqrstuvwxyz"]] *= 3.0
        named["lm_head.weight"] = head
        voice, ids = load()
    engine = voice.phonemizer.engine
    check(engine.device.type == "cuda", f"{tag}: the G2P is not on the GPU")
    cpu = ByT5Phonemizer(str(g2p_path))
    cpu.device = "cpu"
    cpu._engine = byt5.ByT5Engine.from_flat(named, device="cpu")
    host = TTSVoice(engine=None, config=voice.config, phonemizer=cpu)
    want = [host.phonemes_to_ids(p) for p in host.phonemize(text)]
    print(f"{tag}: {text!r} -> {sum(map(len, ids))} ids, equal to the "
          f"CPU's {ids == want}; G2P {engine.cfg.num_encoder_layers} + "
          f"{engine.cfg.num_decoder_layers} layers, {engine.last_decode}",
          flush=True)
    check(ids == want and sum(map(len, ids)) >= 20,
          f"{tag}: the ids differ from the CPU's or are too few")
    launches, _ = front_launches(torch, voice, [text], seed, tag,
                                 "ByT5 G2P voice path")
    # the G2P's share of a request: its decodes timed inside synthesize
    # (each returns host lists, so it ends synchronised)
    cfg = SynthesisConfig(seed=seed, noise_scale=0.0, noise_w_scale=0.0)
    decode = engine.greedy_decode_batch
    inside = []

    def timed_decode(batch_ids):
        t0 = time.perf_counter()
        out = decode(batch_ids)
        inside[-1] += time.perf_counter() - t0
        return out

    engine.greedy_decode_batch = timed_decode
    shares, total_ms = [], []
    try:
        for _ in range(5):
            inside.append(0.0)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            list(voice.synthesize(text, cfg))
            total = time.perf_counter() - t0
            total_ms.append(total * 1e3)
            shares.append(inside[-1] / total)
    finally:
        del engine.greedy_decode_batch
    print(f"{tag}: request ms median {statistics.median(total_ms):.3f}, "
          f"the G2P's share {statistics.median(shares):.3f} (5 runs); the "
          f"phase took {time.perf_counter() - t_start:.1f} s", flush=True)
    return launches


def frontend_phase(torch, model_path, config_path, seed, root: Path,
                   card_name):
    """The text front end on the card: the ByT5 G2P at byt5-small widths,
    an Arabic voice with its diacritizer, a Korean voice, the Hebrew
    diacritizer, and a voice whose G2P is the ByT5 model. Returns the
    launches of A, B and C on the voices' paths."""
    t_start = time.perf_counter()
    named = g2p_phase(torch, seed, card_name)
    memory_line(torch, "the G2P phase")
    paths = {
        "Arabic (mantoq, tashkeel) path": arabic_phase(
            torch, model_path, config_path, seed, root),
        "Korean (kog2p) path": korean_phase(torch, model_path, config_path,
                                            seed),
    }
    hebrew_phase(torch, root)
    paths["ByT5 G2P voice path"] = byt5_voice_phase(
        torch, model_path, config_path, named, seed, root)
    memory_line(torch, "the front end's phases")
    print(f"frontend: the phases took {time.perf_counter() - t_start:.1f} s",
          flush=True)
    return paths


def training_dataset(torch, root: Path, seed: int) -> Path:
    """The synthetic dataset of the training phases: 45 utterances, 5 held
    out for tests (run_training's default), 4 validation, 36 train; its
    hop and STFT are those of every 22050 Hz preset."""
    from phoonnx_tpu_torch.models.vits.model import VitsHParams

    t0 = time.perf_counter()
    data = write_dataset(torch, root / "build" / "chip_smoke" / "dataset",
                         VitsHParams.preset("medium"), 45, seed)
    print(f"train: wrote 45 utterances in {time.perf_counter() - t0:.1f} s",
          flush=True)
    return data


def training_phase(torch, data: Path, seed: int, profile: bool,
                   quality: str = "medium"):
    """The port's training path as a user drives it: run_training on the
    synthetic dataset at ``quality``, batch 16, one epoch. Returns kernel
    D's launches and the step and kernel D times."""
    from phoonnx_tpu_torch.ops import mas
    from phoonnx_tpu_torch.train import checkpoint, step
    from phoonnx_tpu_torch.train.trainer import run_training

    tag = "train" if quality == "medium" else f"train {quality}"

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
    kernels = all_kernels()
    try:
        reset_launches(kernels)
        t0 = time.perf_counter()
        with TestAudioCounts(kernels) as audio:
            run = run_training(str(data), quality=quality, batch_size=16,
                               max_epochs=1, seed=seed, log_every=1)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        total = launch_counts(kernels)
    finally:
        mas.launch = launch
    launches = total["D"]
    steps = {k: total[k] - audio.inside[k] for k in kernels}
    print(f"{tag}: run_training wall {wall:.3f} s, {len(run.steps)} steps, "
          f"kernel D launches {launches}; in the steps and validation "
          f"{steps}, in the test audio {audio.inside}", flush=True)
    check(launches > 0, "kernel D was not launched on the training path")
    check_test_audio(run, audio, total, tag)
    check(len(run.steps) > 0, "no training step ran")
    # D's launches in the test audio are none: the timings are the steps'
    check(len(events) == steps["D"], "kernel D launches and timings disagree")

    mas_ms = [s.elapsed_time(e) for s, e, _ in events]
    for record, ms, (_, _, shape) in zip(run.steps, mas_ms, events):
        losses = " ".join(f"{k}={record[k]:.4f}" for k in step.METRICS)
        print(f"{tag}: step {record['step']} ms={record['ms']:.3f} {losses} "
              f"kernel_D_ms={ms:.4f} mas_shape={list(shape)}", flush=True)
        check(all(math.isfinite(record[k]) for k in step.METRICS),
              f"non-finite loss at step {record['step']}")
    step_ms = [r["ms"] for r in run.steps]
    steady = step_ms[1:] or step_ms
    d_steady = mas_ms[1:len(step_ms)] or mas_ms[:1]
    print(f"{tag}: step ms first={step_ms[0]:.3f} steady median="
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
    print(f"{tag}: {moved} of {total} parameter tensors changed", flush=True)
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
    print(f"{tag}: checkpoint {Path(run.checkpoint).name} restores "
          f"{total} parameter tensors and their moments equal", flush=True)

    if profile:
        profile_train_step(torch, run, data, seed)
    return launches, {"step_ms": step_ms, "mas_ms": mas_ms,
                      "test_audio": {k: audio.inside[k] for k in SYNTH}}


class TestAudioCounts:
    """Counts the launches of ``kernels`` inside ``trainer.write_test_audio``
    (``inside``) and, at each of its calls, the counts reached before it
    (``at_calls``: one a trained epoch, after its steps and validation)."""

    def __init__(self, kernels):
        self.kernels = kernels
        self.inside = {name: 0 for name in kernels}
        self.at_calls = []

    def __enter__(self):
        from phoonnx_tpu_torch.train import trainer

        self.trainer, self.write = trainer, trainer.write_test_audio

        def counted(*args, **kw):
            before = launch_counts(self.kernels)
            self.at_calls.append(before)
            try:
                return self.write(*args, **kw)
            finally:
                after = launch_counts(self.kernels)
                for name in self.inside:
                    self.inside[name] += after[name] - before[name]

        trainer.write_test_audio = counted
        return self

    def __exit__(self, *exc):
        self.trainer.write_test_audio = self.write
        return False


def check_test_audio(run, audio, total, tag):
    """A training run's steps and validation launched none of SYNTH
    (``total`` less what the test audio launched); its test audio
    launched A, B and C for every held-out utterance of every epoch (one A
    and one B an utterance, one C a decoder stage) and no noise kernel
    (``model.infer`` draws from a torch generator), wrote a WAV for each
    and recorded no failure; D was launched in every epoch."""
    steps = {name: total[name] - audio.inside[name] for name in SYNTH}
    check(not any(steps.values()),
          f"{tag}: the training steps reached an inference kernel {steps}")
    previous = 0
    for out, counts in zip(run.test_audio_dirs, audio.at_calls):
        check(counts["D"] > previous,
              f"{tag}: kernel D was not launched before {out.name}'s audio")
        previous = counts["D"]
    check(not run.test_audio_errors,
          f"{tag}: test audio failed: {run.test_audio_errors}")
    epochs, n_test = len(run.test_audio_dirs), len(run.test_utterances)
    check(epochs == len(audio.at_calls) and epochs > 0,
          f"{tag}: {epochs} test-audio directories for "
          f"{len(audio.at_calls)} epochs")
    want = {"A": n_test * epochs, "B": n_test * epochs,
            "C": n_test * len(run.hp.upsample_rates) * epochs, "noise": 0}
    got = {name: audio.inside[name] for name in SYNTH}
    check(got == want, f"{tag}: test audio launched {got}, wanted {want}")
    for out in run.test_audio_dirs:
        wavs = sorted(out.glob("test_*.wav"))
        check(len(wavs) == n_test, f"{tag}: {len(wavs)} test WAVs in {out}")
    print(f"{tag}: test audio: {epochs} epoch(s) x {n_test} WAVs, launches "
          f"{got}; the steps and validation launched {steps}",
          flush=True)


def profile_train_step(torch, run, data: Path, seed: int):
    """One more medium training step under the profiler: the card's idle
    share of the step and kernel D's share of its device time."""
    from phoonnx_tpu_torch.train.step import (TrainConfig, batch_to_device,
                                              train_step)
    from phoonnx_tpu_torch.train.trainer import step_generator

    hp = run.hp
    batch = batch_to_device(first_batch(data, hp, seed), "cuda")
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


# ---------------------------------------------------------------------------
# data-parallel training: two ranks on the one card, over gloo
# ---------------------------------------------------------------------------

DP_WORLD = 2
# the two ranks' averaged first-step gradients against one process's on
# the same global batch and seed: tests/test_multidevice_equivalence.py's
# bars, the median at 1e-5 rather than 1e-6 because cuDNN takes other
# float32 algorithms at batch 8 than at 16; the losses at rel 1e-5
DP_GRAD_MEDIAN = 1e-5
DP_GRAD_MAX = 3e-2
DP_LOSS_RTOL = 1e-5
DP_TIMED_STEPS = 3
DP_TIMEOUT_S = 600


def leaf_rel_l2(torch, want, got):
    """(median, max) over leaves of ||got - want|| / ||want||, the
    denominator floored at 1e-6 of the global norm of ``want``."""
    norms = [float(torch.linalg.vector_norm(w.double())) for w in want]
    floor = 1e-6 * (math.sqrt(sum(n * n for n in norms)) + 1e-12)
    rel = sorted(float(torch.linalg.vector_norm((g - w).double()))
                 / max(n, floor) for w, g, n in zip(want, got, norms))
    return rel[len(rel) // 2], rel[-1]


def first_batch(data: Path, hp, seed: int):
    """The dataset's first batch of 16 (numpy), epoch 0's shuffle."""
    from phoonnx_tpu_torch.train.dataset import BucketedLoader, load_dataset

    loader = BucketedLoader(load_dataset([data / "dataset.jsonl"]),
                            batch_size=16, segment_size_frames=hp.segment_size,
                            hop_length=hp.hop_length, seed=seed,
                            spec_channels=hp.spec_channels)
    return next(iter(loader.epoch(epoch_index=0)))


def equal_across(torch, tensors) -> bool:
    """Every rank holds rank 0's bits of ``tensors``: rank 0's flat copy
    is broadcast, each rank compares, the verdicts meet in an
    ``all_reduce`` (MIN)."""
    import torch.distributed as dist

    with torch.no_grad():
        flat = torch.cat([t.detach().reshape(-1) for t in tensors])
        ref = flat.clone()
        dist.broadcast(ref, 0)
        ok = torch.tensor([float(torch.equal(ref, flat))],
                          device=flat.device)
        dist.all_reduce(ok, op=dist.ReduceOp.MIN)
    return bool(ok.item())


def timed_steps(torch, state, batch, hp, cfg, dev, seed, mesh, n):
    """Host ms of ``n`` training steps (each ending in a synchronise), and
    under ``mesh`` each step's ms and MiB in ``parallel.mesh.all_mean``
    (the gradient, metric and denominator means)."""
    from phoonnx_tpu_torch.parallel import mesh as dp
    from phoonnx_tpu_torch.train import step
    from phoonnx_tpu_torch.train.trainer import step_generator

    mean = dp.all_mean
    spent = {"ms": 0.0, "bytes": 0}

    def timed_mean(group, tensors):
        sync(torch, dev)
        t0 = time.perf_counter()
        out = mean(group, tensors)
        sync(torch, dev)
        spent["ms"] += (time.perf_counter() - t0) * 1e3
        spent["bytes"] += sum(t.numel() * t.element_size() for t in tensors)
        return out

    dp.all_mean = timed_mean
    rows = []
    try:
        for i in range(n):
            spent.update(ms=0.0, bytes=0)
            sync(torch, dev)
            t0 = time.perf_counter()
            step.train_step(state, batch, hp, cfg, mesh=mesh,
                            generator=step_generator(dev, seed, i + 1))
            sync(torch, dev)
            rows.append(((time.perf_counter() - t0) * 1e3, spent["ms"],
                         spent["bytes"] / 2 ** 20))
    finally:
        dp.all_mean = mean
    return rows


def dp_rank_work(torch, rank: int, data: Path, data_dp: Path, seed: int,
                 device: str, quality: str):
    """One rank's checks and timings (see :func:`dp_phase`)."""
    from phoonnx_tpu_torch.infer.engine import resolve_device
    from phoonnx_tpu_torch.parallel import make_mesh, multihost, shard_batch
    from phoonnx_tpu_torch.train import step
    from phoonnx_tpu_torch.train.trainer import run_training, step_generator

    dev = resolve_device(device)  # TF32 off on the card
    check(multihost.initialize(backend="gloo"),
          "the launcher's environment formed no process group")
    mesh = make_mesh(device=dev)
    hp = step_hparams(data, quality)
    cfg = step.TrainConfig()
    batch = first_batch(data, hp, seed)
    rows = shard_batch(mesh, batch)
    state = step.init_train_state(hp, cfg, torch.Generator().manual_seed(seed),
                                  device=dev)
    result = {"rank": rank, "rows": int(len(rows["spec"])),
              "shape": list(batch["spec"].shape[:2]) + [
                  int(batch["phoneme_ids"].shape[1])]}

    # check 1: the first step's averaged gradients against one process's
    if rank == 0:
        g1, d1, m1 = step.step_grads(state, step.batch_to_device(batch, dev),
                                     hp, cfg,
                                     generator=step_generator(dev, seed, 0))
    g2, d2, m2 = step.step_grads(state, step.batch_to_device(rows, dev), hp,
                                 cfg, generator=step_generator(dev, seed, 0),
                                 mesh=mesh)
    result["grads_equal"] = equal_across(torch, list(g2) + list(d2))
    if rank == 0:
        result["check1"] = {
            "g": leaf_rel_l2(torch, g1, g2), "d": leaf_rel_l2(torch, d1, d2),
            "losses": {k: (float(m1[k]), float(m2[k])) for k in step.METRICS}}
        del g1, d1
    del g2, d2

    # each rank's step, then (rank 0) one process's step on the batch
    result["dp_steps"] = timed_steps(torch, state, step.batch_to_device(
        rows, dev), hp, cfg, dev, seed, mesh, DP_TIMED_STEPS)
    if rank == 0:
        result["single_steps"] = [ms for ms, _, _ in timed_steps(
            torch, state, step.batch_to_device(batch, dev), hp, cfg, dev,
            seed, None, DP_TIMED_STEPS)]
    del state
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    # check 2: one epoch of run_training on the two ranks, the launches
    # counted from 0 in each rank
    kernels = all_kernels()
    reset_launches(kernels)
    t0 = time.perf_counter()
    with TestAudioCounts(kernels) as audio:
        run = run_training(str(data_dp), quality=quality, batch_size=16,
                           max_epochs=1, seed=seed, log_every=1,
                           device=device, backend="gloo")
    sync(torch, dev)
    result["epoch"] = {
        "wall_s": time.perf_counter() - t0,
        "launches": launch_counts(kernels), "test_audio": audio.inside,
        "steps": [{k: r[k] for k in ("step", "ms", "loss_gen_all",
                                     "loss_disc_all")} for r in run.steps],
        "val": run.val_losses, "checkpoint": run.checkpoint,
        "test_audio_dirs": [str(d) for d in run.test_audio_dirs],
        "test_audio_errors": run.test_audio_errors,
        "n_test": len(run.test_utterances),
        "stages": len(run.hp.upsample_rates),
        "params_equal": equal_across(torch, params_of(run.state))}
    return result


def dp_rank(rank: int, world: int, port: int, out: Path, data: Path,
            data_dp: Path, seed: int, device: str, quality: str) -> None:
    """A rank of the dp phase in its own process, with the environment
    ``torch.distributed.run`` gives one; writes ``rank{r}.json`` (or the
    traceback to ``rank{r}.err``)."""
    import torch
    import torch.distributed as dist

    os.environ.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                      RANK=str(rank), WORLD_SIZE=str(world),
                      LOCAL_RANK=str(rank))
    # each rank its share of the host's cores (torch.distributed.run gives
    # its processes one thread each): OpenMP pools of every rank on every
    # core slow the host's ops many times over
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    try:
        result = dp_rank_work(torch, rank, data, data_dp, seed, device,
                              quality)
        (out / f"rank{rank}.json").write_text(json.dumps(result))
    except BaseException:
        (out / f"rank{rank}.err").write_text(traceback.format_exc())
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def run_ranks(target, world: int, out: Path, *args,
              timeout: float = DP_TIMEOUT_S):
    """``target(rank, world, port, out, *args)`` in ``world`` spawned
    processes; stops the others when one fails (they would wait at their
    next collective) and fails with its traceback. Returns each rank's
    ``rank{r}.json``."""
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=target, args=(rank, world, port, out) + args)
             for rank in range(world)]
    for proc in procs:
        proc.start()
    deadline = time.monotonic() + timeout
    try:
        while any(p.is_alive() for p in procs):
            if any(p.exitcode not in (None, 0) for p in procs):
                break
            check(time.monotonic() < deadline, f"ranks ran over {timeout} s")
            time.sleep(0.1)
    finally:
        for proc in procs:
            if proc.is_alive():
                proc.terminate()
            proc.join(30)
            if proc.is_alive():
                proc.kill()
                proc.join()
    for rank, proc in enumerate(procs):
        err = out / f"rank{rank}.err"
        check(proc.exitcode == 0, f"rank {rank} exited {proc.exitcode}: "
              + (err.read_text() if err.exists() else "no traceback"))
    return [json.loads((out / f"rank{r}.json").read_text())
            for r in range(world)]


def dp_phase(torch, data: Path, seed: int, card: str, device: str = "cuda:0",
             quality: str = "medium", tag: str = "dp"):
    """Data-parallel training on the one card: two ranks in processes of
    their own on ``device``, over gloo (NCCL takes one card a rank), at
    ``quality``, a global batch of 16 from the training phase's dataset
    (8 rows a rank). Check 1: the first step's averaged gradients and
    losses against one process's step on the same batch and seed, at the
    DP_* bars. Each rank's step ms, the ``all_reduce`` ms and MiB a step,
    beside one process's batch-16 step. Check 2: one epoch of
    ``run_training`` on the two ranks: the parameters ``torch.equal``
    across ranks after it, kernel D launched in both ranks (the counts
    come back from the processes), rank 0's test audio launching A, B and
    C as a one-process epoch does, rank 1 writing none. Returns each
    kernel's launches in the epoch, summed over the ranks."""
    from phoonnx_tpu_torch.train import step

    t_phase = time.perf_counter()
    out = ROOT / "build" / "chip_smoke" / "dp"
    if out.exists():
        shutil.rmtree(out)
    # the epoch's dataset: the same utterances (the cached arrays are read
    # where they are), its own checkpoints and test audio
    data_dp = out / "dataset"
    data_dp.mkdir(parents=True)
    for name in ("config.json", "dataset.jsonl"):
        shutil.copy(data / name, data_dp / name)
    ranks = run_ranks(dp_rank, DP_WORLD, out, data, data_dp, seed, device,
                      quality)
    zero, one = ranks
    b, t_y, t_x = zero["shape"]
    print(f"{tag}: {DP_WORLD} ranks on {device} over gloo, {zero['rows']} "
          f"rows each of a global batch of {b} ({t_y} frames, {t_x} "
          f"phonemes); {card}", flush=True)

    c1 = zero["check1"]
    deltas = {k: (dp_v - one_v) / abs(one_v) if one_v else dp_v - one_v
              for k, (one_v, dp_v) in c1["losses"].items()}
    print(f"{tag}: check 1, first step vs one process: grads_g median leaf "
          f"rel-L2 {c1['g'][0]:.3e}, max {c1['g'][1]:.3e}; grads_d median "
          f"{c1['d'][0]:.3e}, max {c1['d'][1]:.3e}; loss deltas (relative) "
          + ", ".join(f"{k} {v:.2e}" for k, v in deltas.items())
          + f"; bars median <= {DP_GRAD_MEDIAN}, max <= {DP_GRAD_MAX}, "
          f"losses <= {DP_LOSS_RTOL}; {card}", flush=True)
    for key in ("g", "d"):
        check(c1[key][0] <= DP_GRAD_MEDIAN,
              f"{tag}: grads_{key} median leaf rel-L2 {c1[key][0]:.3e}")
        check(c1[key][1] <= DP_GRAD_MAX,
              f"{tag}: grads_{key} max leaf rel-L2 {c1[key][1]:.3e}")
    for k, v in deltas.items():
        check(abs(v) <= DP_LOSS_RTOL, f"{tag}: {k} differs by {v:.3e}")
    check(zero["grads_equal"] and one["grads_equal"],
          f"{tag}: the ranks' averaged gradients differ")

    for r in ranks:
        rows = r["dp_steps"]
        print(f"{tag}: rank {r['rank']} step ms "
              + " ".join(f"{ms:.3f}" for ms, _, _ in rows)
              + "; all_reduce ms a step "
              + " ".join(f"{ms:.3f}" for _, ms, _ in rows)
              + f", {rows[-1][2]:.1f} MiB a step; {card}", flush=True)
    print(f"{tag}: one process, batch {b}, step ms "
          + " ".join(f"{ms:.3f}" for ms in zero["single_steps"])
          + f"; {card}", flush=True)

    epochs = [r["epoch"] for r in ranks]
    for r, ep in zip(ranks, epochs):
        print(f"{tag}: rank {r['rank']} epoch: {len(ep['steps'])} steps "
              f"in {ep['wall_s']:.1f} s, step ms "
              + " ".join(f"{s['ms']:.1f}" for s in ep["steps"])
              + f", validation {ep['val']}, launches {ep['launches']}, "
              f"in the test audio {ep['test_audio']}, checkpoint "
              f"{Path(ep['checkpoint']).name if ep['checkpoint'] else None}"
              f"; {card}", flush=True)
        check(len(ep["steps"]) > 0, f"{tag}: rank {r['rank']} took no step")
        check(all(math.isfinite(s[k]) for s in ep["steps"]
                  for k in ("loss_gen_all", "loss_disc_all")),
              f"{tag}: non-finite loss on rank {r['rank']}")
        check(ep["launches"]["D"] > 0,
              f"{tag}: kernel D was not launched in rank {r['rank']}")
        check(ep["params_equal"], f"{tag}: parameters differ across ranks")
    check(epochs[0]["val"] == epochs[1]["val"],
          f"{tag}: validation losses differ {epochs[0]['val']} "
          f"{epochs[1]['val']}")
    check([s["step"] for s in epochs[0]["steps"]]
          == [s["step"] for s in epochs[1]["steps"]],
          f"{tag}: the ranks took other steps")
    ep0, ep1 = epochs
    want = {"A": ep0["n_test"], "B": ep0["n_test"],
            "C": ep0["n_test"] * ep0["stages"], "noise": 0}
    check(ep0["test_audio"] == {**want, "D": 0},
          f"{tag}: rank 0's test audio launched {ep0['test_audio']}, "
          f"wanted {want}")
    check(not ep0["test_audio_errors"] and len(ep0["test_audio_dirs"]) == 1,
          f"{tag}: rank 0's test audio {ep0['test_audio_dirs']} "
          f"{ep0['test_audio_errors']}")
    wavs = sorted(Path(ep0["test_audio_dirs"][0]).glob("test_*.wav"))
    check(len(wavs) == ep0["n_test"], f"{tag}: {len(wavs)} test WAVs")
    check(all(ep0["launches"][k] == want[k] for k in SYNTH),
          f"{tag}: rank 0's steps launched A/B/C {ep0['launches']}")
    check(not any(ep1["launches"][k] for k in SYNTH)
          and not ep1["test_audio_dirs"] and ep1["checkpoint"] is None,
          f"{tag}: rank 1 wrote test audio or a checkpoint")
    check(ep0["checkpoint"] is not None and Path(ep0["checkpoint"]).exists(),
          f"{tag}: rank 0 wrote no checkpoint")
    fresh = step.init_train_state(
        step_hparams(data, quality), step.TrainConfig(),
        torch.Generator().manual_seed(seed + 1))
    from phoonnx_tpu_torch.train import checkpoint

    checkpoint.restore(ep0["checkpoint"], fresh)
    check(fresh.step == ep0["steps"][-1]["step"],
          f"{tag}: the checkpoint restores step {fresh.step}")
    launches = {k: ep0["launches"][k] + ep1["launches"][k]
                for k in (*SYNTH, "D")}
    print(f"{tag}: parameters torch.equal across ranks after the epoch; "
          f"validation loss equal on both ranks; launches summed {launches};"
          f" the phase took {time.perf_counter() - t_phase:.1f} s; {card}",
          flush=True)
    return launches


def step_hparams(data: Path, quality: str):
    """The hparams ``run_training`` builds for ``data`` at ``quality``."""
    from phoonnx_tpu_torch.train.trainer import build_hparams

    return build_hparams(json.loads((data / "config.json").read_text()),
                         quality)


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


# ---------------------------------------------------------------------------
# the training pipeline: preprocess -> train -> checkpoint -> export -> serve
# ---------------------------------------------------------------------------

# spectrograms of the card against the CPU's, max-abs over the peak: both
# float32 STFTs of the same trimmed audio, summed in other orders
SPEC_TOL = 1e-5
PIPELINE_IDS = 241
PIPELINE_RUNS = 5
LETTERS = "abcdefghijklmnopqrstuvwxyz"


def sync(torch, dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize()


def write_corpus(out_dir: Path, hp, n_utts: int, seed: int,
                 seconds=(1.5, 8.0), n_symbols: int = 40) -> Path:
    """A raw LJ Speech-style corpus: ``metadata.csv`` and 16-bit WAVs at
    ``hp.sample_rate`` of the tone utterances :func:`write_dataset` makes
    from the same seed, each between 0.25 s of faint noise, with one letter
    a phoneme id as its text (a space every six)."""
    pad_rng = np.random.default_rng(seed + 1)
    if out_dir.exists():
        shutil.rmtree(out_dir)
    (out_dir / "wavs").mkdir(parents=True)
    pad = int(0.25 * hp.sample_rate)
    lines = []
    for i, (ids, audio) in enumerate(tone_utterances(hp, n_utts, seed,
                                                     seconds, n_symbols)):
        audio = np.concatenate([
            0.002 * pad_rng.standard_normal(pad), audio,
            0.002 * pad_rng.standard_normal(pad)]).astype(np.float32)
        write_wav(out_dir / "wavs" / f"utt{i:03d}.wav", audio,
                  hp.sample_rate)
        letters = [LETTERS[(int(x) - 1) % len(LETTERS)] for x in ids]
        words = ["".join(letters[j:j + 6]) for j in range(0, len(letters),
                                                           6)]
        lines.append(f"utt{i:03d}|{' '.join(words)}")
    (out_dir / "metadata.csv").write_text("\n".join(lines) + "\n",
                                          encoding="utf-8")
    return out_dir


def preprocess_phase(torch, corpus: Path, root: Path, sample_rate: int,
                     dev, tag="pipeline", **kw) -> Path:
    """``run_preprocess`` of ``corpus`` on ``dev`` and on the CPU, each
    with a cache of its own: the same rows, the trimmed audio equal and
    the spectrograms within SPEC_TOL of their peak. Returns the device's
    dataset directory."""
    from phoonnx_tpu_torch.train.preprocess import run_preprocess

    kw = dict(language="en", phoneme_type="graphemes", alphabet="unicode",
              sample_rate=sample_rate, single_speaker=True, **kw)
    dirs, seconds = {}, {}
    for side, device in (("card", dev), ("cpu", torch.device("cpu"))):
        out = root / side / "dataset"
        if out.exists():
            shutil.rmtree(out)
        t0 = time.perf_counter()
        run_preprocess(str(corpus), str(out), device=str(device), **kw)
        sync(torch, dev)
        seconds[side] = time.perf_counter() - t0
        dirs[side] = out
    rows = {side: [json.loads(line) for line in (d / "dataset.jsonl")
                   .read_text(encoding="utf-8").splitlines()]
            for side, d in dirs.items()}
    n_wavs = len((corpus / "metadata.csv").read_text().splitlines())
    check(len(rows["card"]) == len(rows["cpu"]) == n_wavs,
          f"{tag}: {len(rows['card'])} and {len(rows['cpu'])} rows for "
          f"{n_wavs} files")
    worst, samples = 0.0, 0
    for a, b in zip(rows["card"], rows["cpu"]):
        check(a["audio_path"] == b["audio_path"]
              and a["phoneme_ids"] == b["phoneme_ids"],
              f"{tag}: rows differ at {a['audio_path']}")
        audio_a, audio_b = (np.load(a["audio_norm_path"]),
                            np.load(b["audio_norm_path"]))
        check(np.array_equal(audio_a, audio_b),
              f"{tag}: trimmed audio differs for {a['audio_path']}")
        samples += len(audio_a)
        spec_a, spec_b = (np.load(a["audio_spec_path"]),
                          np.load(b["audio_spec_path"]))
        check(spec_a.shape == spec_b.shape,
              f"{tag}: spectrogram shapes {spec_a.shape} {spec_b.shape}")
        worst = max(worst, float(np.abs(spec_a - spec_b).max()
                                 / np.abs(spec_b).max()))
    print(f"{tag}: preprocess {n_wavs} files ({samples / sample_rate:.1f} s "
          f"trimmed at {sample_rate} Hz): {seconds['card']:.3f} s on "
          f"{dev}, {seconds['cpu']:.3f} s on the CPU; trimmed audio equal, "
          f"spectrograms max-abs/peak {worst:.3e} (tol {SPEC_TOL})",
          flush=True)
    check(worst <= SPEC_TOL, f"{tag}: spectrograms differ by {worst:.3e}")
    return dirs["card"]


def pipeline_epochs(torch, data: Path, seed: int, dev, quality="medium",
                    batch_size=16, tag="pipeline"):
    """Three epochs of ``run_training`` on ``data`` as a user drives them:
    float32; resumed from its checkpoint in bf16 with grad_accum 2; resumed
    again with remat. Each epoch writes its test audio. Returns (the runs,
    D's launches, A/B/C's launches in the test audio)."""
    from phoonnx_tpu_torch.train import step
    from phoonnx_tpu_torch.train.trainer import run_training

    kernels = all_kernels()
    runs, d_launches = [], 0
    audio_launches = {name: 0 for name in SYNTH}
    options = (("float32", {}),
               ("bf16 grad_accum 2", dict(compute_dtype="bfloat16",
                                          grad_accum=2)),
               ("remat", dict(remat=True)))
    for label, kw in options:
        resume = runs[-1].checkpoint if runs else None
        reset_launches(kernels)
        t0 = time.perf_counter()
        with TestAudioCounts(kernels) as audio:
            run = run_training(str(data), quality=quality,
                               batch_size=batch_size,
                               max_epochs=len(runs) + 1, seed=seed,
                               log_every=1, resume_from_checkpoint=resume,
                               device=str(dev), **kw)
        sync(torch, dev)
        wall = time.perf_counter() - t0
        total = launch_counts(kernels)
        name = f"{tag} {label}"
        check(run.steps and all(r["epoch"] == len(runs) for r in run.steps),
              f"{name}: no step of epoch {len(runs)}")
        for record in run.steps:
            check(all(math.isfinite(record[k]) for k in step.METRICS),
                  f"{name}: non-finite loss at step {record['step']}")
        step_ms = [r["ms"] for r in run.steps]
        print(f"{name}: epoch {len(runs)} wall {wall:.3f} s, steps "
              f"{[r['step'] for r in run.steps]} ms "
              f"{[round(ms, 3) for ms in step_ms]}; losses of the last "
              + " ".join(f"{k}={run.steps[-1][k]:.4f}" for k in step.METRICS)
              + f"; validation {run.val_losses}; D launches {total['D']}",
              flush=True)
        check_test_audio(run, audio, total, name)
        d_launches += total["D"]
        for k in audio_launches:
            audio_launches[k] += audio.inside[k]
        runs.append(run)
    return runs, d_launches, audio_launches


def option_steps(torch, run, data: Path, seed: int, dev, batch_size=16,
                 tag="pipeline"):
    """One batch of ``data`` and one seed, a fresh state each: a step in
    float32, bf16, grad_accum 2 and remat, then three more timed; the
    first step's losses side by side and each step's peak memory. Returns
    D's launches."""
    from phoonnx_tpu_torch.ops import mas
    from phoonnx_tpu_torch.train.dataset import BucketedLoader, load_dataset
    from phoonnx_tpu_torch.train.step import (METRICS, TrainConfig,
                                              batch_to_device,
                                              init_train_state, train_step)
    from phoonnx_tpu_torch.train.trainer import step_generator

    hp = run.hp
    loader = BucketedLoader(load_dataset([data / "dataset.jsonl"]),
                            batch_size=batch_size,
                            segment_size_frames=hp.segment_size,
                            hop_length=hp.hop_length, seed=seed,
                            spec_channels=hp.spec_channels)
    batch = batch_to_device(next(iter(loader.epoch(epoch_index=0))), dev)
    kernels = {"D": mas.__name__}
    reset_launches(kernels)
    first = {}
    for label, kw in (("float32", {}), ("bf16", dict(
            compute_dtype="bfloat16")), ("grad_accum 2", dict(grad_accum=2)),
            ("remat", dict(remat=True))):
        cfg = TrainConfig(**kw)
        state = init_train_state(hp, cfg, torch.Generator().manual_seed(seed),
                                 device=dev)
        sync(torch, dev)
        if dev.type == "cuda":
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated() if dev.type == "cuda" else 0
        d0 = launch_counts(kernels)["D"]
        times, losses = [], None
        for i in range(4):
            sync(torch, dev)
            t0 = time.perf_counter()
            state, m = train_step(state, batch, hp, cfg,
                                  generator=step_generator(dev, seed, i))
            values = torch.stack([m[k] for k in METRICS]).tolist()
            times.append((time.perf_counter() - t0) * 1e3)
            losses = losses or dict(zip(METRICS, values))
        peak = (torch.cuda.max_memory_allocated() - base
                if dev.type == "cuda" else 0)
        first[label] = losses
        check(all(math.isfinite(v) for v in losses.values()),
              f"{tag}: {label}: non-finite loss {losses}")
        print(f"{tag}: step {label}: batch {tuple(batch['spec'].shape)} "
              f"first ms {times[0]:.3f}, next three median "
              f"{statistics.median(times[1:]):.3f} ms; peak allocated over "
              f"the state {peak / 2 ** 20:.1f} MiB; D launches "
              f"{launch_counts(kernels)['D'] - d0} in 4 steps; first step "
              + " ".join(f"{k}={v:.5f}" for k, v in losses.items()),
              flush=True)
        del state
    worst = max(abs(first["remat"][k] - first["float32"][k])
                / max(abs(first["float32"][k]), 1e-12) for k in METRICS)
    print(f"{tag}: remat vs float32 first-step losses, largest relative "
          f"difference {worst:.3e}", flush=True)
    # the same forward on the same inputs (remat changes the backward)
    check(worst <= KERNEL_TOL, f"{tag}: remat moved the losses by {worst}")
    return launch_counts(kernels)["D"]


def export_phase(torch, run, data: Path, root: Path, seed: int, dev,
                 quality="medium", tag="pipeline"):
    """The last checkpoint exported in float32 and int8; each loaded by
    ``TTSVoice.load`` on ``dev`` serves the 241-id request (timed), the
    float32 one within PATH_TOL of the peak of a ``VitsEngine`` over the
    checkpoint's generator at equal length. Returns (the float32 export,
    A/B/C's launches by voice)."""
    from phoonnx_tpu_torch import TTSVoice
    from phoonnx_tpu_torch.infer import VitsEngine
    from phoonnx_tpu_torch.train.checkpoint import restore_generator
    from phoonnx_tpu_torch.train.export import run_export

    ckpt = run.checkpoint
    kernels = serving_kernels()
    paths, exports, launches = {}, {}, {}
    for label, quantize in (("float32", False), ("int8", True)):
        t0 = time.perf_counter()
        paths[label] = run_export(ckpt, str(data / "config.json"),
                                  str(root / "export" / label),
                                  quality=quality, generate_tokens=True,
                                  piper=True, quantize=quantize)
        exports[label] = time.perf_counter() - t0
    sizes = {k: p.stat().st_size / 2 ** 20 for k, p in paths.items()}
    print(f"{tag}: export of {Path(ckpt).name}: float32 "
          f"{exports['float32']:.3f} s ({sizes['float32']:.1f} MiB), int8 "
          f"{exports['int8']:.3f} s ({sizes['int8']:.1f} MiB)", flush=True)
    check(sizes["int8"] < 0.6 * sizes["float32"],
          f"{tag}: the int8 export is not smaller")
    audio = {}
    for label, path in paths.items():
        reset_launches(kernels)
        voice = TTSVoice.load(str(path), device=str(dev))
        check(type(voice.engine).__name__ == "VitsEngine",
              f"{tag}: the {label} export loaded onto "
              f"{type(voice.engine).__name__}")
        ids = ids_of(voice, PIPELINE_IDS, 7)
        out = voice.engine.synthesize_ids(ids, seed=seed)
        times = []
        for _ in range(PIPELINE_RUNS):
            sync(torch, dev)
            t0 = time.perf_counter()
            voice.engine.synthesize_ids(ids, seed=seed)
            sync(torch, dev)
            times.append((time.perf_counter() - t0) * 1e3)
        launches[f"pipeline {label} export path"] = launch_counts(kernels)
        check(len(out) > 0 and bool(np.isfinite(out).all()),
              f"{tag}: the {label} export's audio is empty or not finite")
        print(f"{tag}: {label} export serves {len(ids)} ids -> "
              f"{len(out)} samples; request ms median "
              f"{statistics.median(times):.3f} of {PIPELINE_RUNS} "
              f"{[round(t, 3) for t in times]}; launches "
              f"{launches[f'pipeline {label} export path']}", flush=True)
        audio[label] = (ids, out)
        del voice
    ids, got = audio["float32"]
    engine = VitsEngine(restore_generator(ckpt, run.hp), run.hp,
                        device=str(dev))
    want = engine.synthesize_ids(ids, seed=seed)
    check(len(got) == len(want),
          f"{tag}: the export gives {len(got)} samples, the checkpoint "
          f"{len(want)}")
    err = float(np.abs(got - want).max() / np.abs(want).max())
    print(f"{tag}: float32 export vs the checkpoint's engine: "
          f"{len(got)} samples each, max-abs/peak {err:.3e} (tol "
          f"{PATH_TOL})", flush=True)
    check(err <= PATH_TOL, f"{tag}: the export differs by {err:.3e}")
    return paths["float32"], launches


def warm_start_phase(torch, export_path: Path, data: Path, seed: int, dev,
                     quality="medium", n_speakers=4, batch_size=16,
                     tag="pipeline"):
    """A ``n_speakers`` model warm-started from the float32 export takes
    one step: the loaded leaves are the export's, the speaker embedding
    keeps its fresh initialisation. Returns D's launches."""
    from phoonnx_tpu_torch.ops import mas
    from phoonnx_tpu_torch.onnx.reader import read_onnx
    from phoonnx_tpu_torch.train.checkpoint import load_generator_warm_start
    from phoonnx_tpu_torch.train.dataset import BucketedLoader, load_dataset
    from phoonnx_tpu_torch.train.step import (METRICS, TrainConfig,
                                              batch_to_device,
                                              init_train_state, train_step)
    from phoonnx_tpu_torch.train.trainer import build_hparams, step_generator

    config = json.loads((data / "config.json").read_text(encoding="utf-8"))
    hp = build_hparams(dict(config, num_speakers=n_speakers), quality)
    cfg = TrainConfig()
    state = init_train_state(hp, cfg, torch.Generator().manual_seed(seed),
                             device=dev)
    emb_g = state.params_g["emb_g"]["weight"].detach().clone()
    t0 = time.perf_counter()
    load_generator_warm_start(str(export_path), hp, state.params_g)
    load_s = time.perf_counter() - t0
    check(torch.equal(state.params_g["emb_g"]["weight"], emb_g),
          f"{tag}: the warm start changed the speaker embedding")
    want = read_onnx(str(export_path)).initializers["enc_p.emb.weight"]
    check(np.array_equal(state.params_g["enc_p"]["emb"]["weight"].detach()
                         .cpu().numpy(), want),
          f"{tag}: the warm start did not load the text embedding")
    loader = BucketedLoader(load_dataset([data / "dataset.jsonl"]),
                            batch_size=batch_size,
                            segment_size_frames=hp.segment_size,
                            hop_length=hp.hop_length, seed=seed,
                            spec_channels=hp.spec_channels)
    batch = batch_to_device(next(iter(loader.epoch(epoch_index=1))), dev)
    b = batch["phoneme_ids"].shape[0]
    batch["sid"] = torch.arange(b, device=dev) % n_speakers
    kernels = {"D": mas.__name__}
    reset_launches(kernels)
    t0 = time.perf_counter()
    state, m = train_step(state, batch, hp, cfg,
                          generator=step_generator(dev, seed, 0))
    values = dict(zip(METRICS, torch.stack([m[k] for k in METRICS]).tolist()))
    ms = (time.perf_counter() - t0) * 1e3
    check(all(math.isfinite(v) for v in values.values()),
          f"{tag}: warm-started step gave {values}")
    d = launch_counts(kernels)["D"]
    check(d > 0, f"{tag}: kernel D was not launched in the warm-started step")
    print(f"{tag}: {n_speakers}-speaker warm start (gin "
          f"{hp.gin_channels}) from {export_path.name} in {load_s:.3f} s; "
          f"one step {ms:.3f} ms, D launches {d}, "
          + " ".join(f"{k}={v:.4f}" for k, v in values.items()), flush=True)
    return d


def pipeline_phase(torch, root: Path, seed: int, dev, quality="medium",
                   n_utts=45, seconds=(1.5, 8.0), batch_size=16,
                   tag="pipeline"):
    """The port's training pipeline as a user drives it: a raw corpus,
    preprocessed on ``dev`` (held against the CPU), three epochs (float32;
    bf16 with grad_accum 2; remat) each with its test audio, the options'
    steps side by side, the export in float32 and int8 served by
    ``TTSVoice.load``, and a multi-speaker warm start from the export.
    Returns (A/B/C's launches by path, D's launches)."""
    from phoonnx_tpu_torch.models.vits.model import VitsHParams

    t_phase = time.perf_counter()
    hp = VitsHParams.preset(quality)
    corpus = write_corpus(root / "corpus", hp, n_utts, seed, seconds)
    data = preprocess_phase(torch, corpus, root, hp.sample_rate, dev,
                            tag=tag, n_fft=hp.filter_length,
                            hop_length=hp.hop_length,
                            win_length=hp.win_length)
    runs, d_epochs, audio = pipeline_epochs(torch, data, seed, dev, quality,
                                            batch_size, tag)
    d_steps = option_steps(torch, runs[-1], data, seed, dev, batch_size,
                           tag)
    export, paths = export_phase(torch, runs[-1], data, root, seed, dev,
                                 quality, tag)
    d_warm = warm_start_phase(torch, export, data, seed, dev, quality,
                              batch_size=batch_size, tag=tag)
    paths["pipeline test audio"] = audio
    print(f"{tag}: the phase took {time.perf_counter() - t_phase:.1f} s",
          flush=True)
    return paths, d_epochs + d_steps + d_warm


# ---------------------------------------------------------------------------
# the convergence run: train/scale_run.py at medium width, bf16, grad_accum 2
# ---------------------------------------------------------------------------

# the JAX run's corpus, batch, dtype and accumulation (TRAINLOSS_r05.json) at
# a smaller depth: 8 epochs resumed at 4 (the JAX run: 20 resumed at 10).
# A medium checkpoint holds G, D and both Adam moments (~0.84 GB), so one
# is written a phase: at epoch 4, where phase B resumes, and at epoch 8.
CONVERGE = dict(utts=96, epochs=8, resume_at=4, batch_size=16,
                quality="medium", compute_dtype="bfloat16", grad_accum=2,
                checkpoint_epochs=4)


def converge_phase(torch, root: Path, card: str, tag="converge", **kw):
    """``scale_run.run_scale`` on the card as a user drives it: the
    synthetic corpus preprocessed on the card, phase A, a resume from its
    checkpoint, phase B, the export served by ``TTSVoice.load``, and the
    exported voice in bf16 against float32. Checks a strictly falling
    validation loss, phase B's steps continuing phase A's, D in every
    epoch's steps, no A, B or C in the steps or validation, A, B and C in
    every epoch's test audio (one A and one B a held-out utterance, one C a
    decoder stage) and in the export check, and an audible export.
    Superseded checkpoints are removed. Returns (A/B/C's float32 launches
    by path, the bf16 voice's launches, D's launches)."""
    from phoonnx_tpu_torch.models.vits.model import VitsHParams
    from phoonnx_tpu_torch.train.scale_run import run_scale

    device = kw.pop("device", "cuda")
    settings = dict(CONVERGE, **kw)
    work = root / "build" / "chip_smoke" / "converge"
    if work.exists():
        shutil.rmtree(work)
    kernels, kernels_bf16 = all_kernels(), serving_kernels("bfloat16")
    reset_launches(kernels)
    reset_launches(kernels_bf16)
    if torch.cuda.is_available():
        # the summary's peak is the phase's, not an earlier phase's
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with TestAudioCounts(kernels) as audio:
        s = run_scale(work, device=device, **settings)
    wall = time.perf_counter() - t0
    total, total_bf16 = launch_counts(kernels), launch_counts(kernels_bf16)
    tag = f"{tag} on {card}"
    epochs = settings["epochs"]
    print(f"{tag}: {s['preset']}, {s['utterances']} utterances, batch "
          f"{s['batch_size']}, {s['compute_dtype']}, grad_accum "
          f"{s['grad_accum']}, {epochs} epochs resumed at "
          f"{s['resumed_at_epoch']}: {wall:.1f} s (training "
          f"{s['total_wall_s']} s); steps A {s['phase_steps']['A']} B "
          f"{s['phase_steps']['B']}", flush=True)
    stages = len(VitsHParams.preset(s["preset"]).upsample_rates)
    n_test = 2
    want_audio = {"A": n_test, "B": n_test, "C": n_test * stages, "D": 0,
                  "noise": 0}
    vals = [s["val_loss"][e] for e in range(epochs)]
    for e in range(epochs):
        parts = s["launches_by_epoch"][e]
        print(f"{tag}: epoch {e} {s['epoch_seconds'][e]} s, val_loss "
              f"{vals[e]}, launches in the steps {parts['steps']}, "
              f"validation {parts['validation']}, test audio "
              f"{parts['test_audio']}", flush=True)
        check(parts["steps"]["D"] > 0,
              f"{tag}: kernel D was not launched in epoch {e}'s steps")
        for part in ("steps", "validation"):
            reached = {k: parts[part][k] for k in SYNTH if parts[part][k]}
            check(not reached, f"{tag}: epoch {e}'s {part} reached an "
                  f"inference kernel {reached}")
        check(parts["test_audio"] == want_audio,
              f"{tag}: epoch {e}'s test audio launched "
              f"{parts['test_audio']}, wanted {want_audio}")
    check(len(vals) == epochs and all(b < a for a, b in zip(vals, vals[1:])),
          f"{tag}: the validation loss did not fall strictly: {vals}")
    check(s["phase_steps"]["B"][0] == s["phase_steps"]["A"][1] + 1,
          f"{tag}: phase B's steps {s['phase_steps']['B']} do not continue "
          f"phase A's {s['phase_steps']['A']}")
    check(not s["test_audio_errors"],
          f"{tag}: test audio failed: {s['test_audio_errors']}")
    check(len(audio.at_calls) == epochs
          and all(audio.inside[k] == epochs * want_audio[k] for k in SYNTH),
          f"{tag}: the test audio's own counts {audio.inside} over "
          f"{len(audio.at_calls)} calls")
    export = s["export_check"]
    exp_launches = s["export_check_launches"]
    print(f"{tag}: export {Path(export['exported_model']).name}: "
          f"{export['synth_samples']} samples, rms {export['synth_rms']}, "
          f"audible {export['audible']}; launches {exp_launches}", flush=True)
    check(export["audible"], f"{tag}: the exported voice is not audible")
    report_launches({k: exp_launches[k] for k in SYNTH}, tag,
                    "exported voice (TTSVoice.load)")
    dtypes = s["bf16_vs_float32"]
    for row in dtypes["utterances"]:
        print(f"{tag}: bf16 vs float32, {row['set']} utterance of "
              f"{row['ids']} ids: frames {row['frames_bfloat16']} / "
              f"{row['frames_float32']}, log-duration error max "
              f"{row['max_log_duration_err']:.4f} mean "
              f"{row['mean_log_duration_err']:.4f} signed "
              f"{row['mean_signed_log_duration_err']:+.4f}", flush=True)
    print(f"{tag}: bf16 vs float32 over {len(dtypes['utterances'])} "
          f"utterances: equal frame counts {dtypes['equal_frame_counts']}, "
          f"largest relative frame difference "
          f"{dtypes['max_rel_frame_diff']:.4f}, log-duration error max "
          f"{dtypes['max_log_duration_err']:.4f} mean "
          f"{dtypes['mean_log_duration_err']:.4f} signed "
          f"{dtypes['mean_signed_log_duration_err']:+.4f} (recorded, not "
          "bounded)",
          flush=True)
    # every launch of the phase is one the summary attributes
    parts = [p for e in range(epochs)
             for p in s["launches_by_epoch"][e].values()]
    parts += [exp_launches, dtypes["launches"]["float32"]]
    attributed = {k: sum(p[k] for p in parts) for k in kernels}
    check(attributed == total,
          f"{tag}: launches {total}, the summary attributes {attributed}")
    check(dtypes["launches"]["bfloat16"] == total_bf16,
          f"{tag}: bf16 launches {total_bf16}, the summary's "
          f"{dtypes['launches']['bfloat16']}")
    print(f"{tag}: device memory after the first epoch {s['hbm']}; peak "
          f"allocated {s['peak_allocated_mib']} MiB; warm step ms "
          f"quartiles {s['step_ms_quartiles_warm']}, "
          f"{s['warm_steps_per_s']} steps/s, warm epoch mean "
          f"{s['warm_epoch_s_mean']} s; checkpoint {s['checkpoint_mib']} "
          f"MiB, saved in {s['checkpoint_save_s']} s", flush=True)
    # phase A's checkpoint is superseded by phase B's, which was exported
    last = work / s["checkpoints"]["B"]
    for path in last.parent.glob("step_*"):
        if path.name.split(".")[0] != last.stem:
            path.unlink()
    paths = {"converge test audio": {k: audio.inside[k] for k in SYNTH},
             "converge export check": {k: exp_launches[k] for k in SYNTH},
             "converge float32 voice (bf16 check)": {
                 k: dtypes["launches"]["float32"][k] for k in SYNTH}}
    paths_bf16 = {"converge bf16 voice (bf16 check)": report_launches(
        total_bf16, tag, "bf16 voice of the trained weights")}
    return paths, paths_bf16, total["D"]


def high_stage0(torch, seed, dev):
    """Kernel C's spec for the high preset's first stage (256 channels,
    resblock "1": kernels 3, 7, 11 at dilations 1, 3, 5), on ``dev``."""
    from phoonnx_tpu_torch.models.vits import fused_stage, model, modules

    hp = model.VitsHParams.preset("high", n_layers=1)
    dec = model.random_params(hp, torch.Generator().manual_seed(seed + 7))[
        "dec"]
    nk = dec["num_kernels"]
    return fused_stage.build_group_spec(
        model.params_to_device(dec["resblocks"][:nk], dev),
        modules.LRELU_SLOPE)


def model_params(torch, quality, seed):
    """(hparams, random params) of a preset, the flow's post convs made
    non-zero."""
    from phoonnx_tpu_torch.models.vits import model as vits_model

    hp = vits_model.VitsHParams.preset(quality)
    gen = torch.Generator().manual_seed(seed)
    params = vits_model.random_params(hp, gen)
    randomize_post(params["flow"], gen)
    return hp, params


def randomize_post(flow_params, gen):
    """The flow's post convs start at zero, which makes every coupling the
    identity; small random values make kernel B do real work."""
    import torch

    for flow in flow_params["flows"]:
        for key in ("weight", "bias"):
            flow["post"][key] = 0.05 * torch.randn(flow["post"][key].shape,
                                                   generator=gen)
    return flow_params


def medium_params(torch, seed):
    """(hparams, params, {gin: a multi-speaker flow of the same widths})
    of the medium preset: the flows feed kernel B's speaker term at gin
    256 and at 512, the width of a multi-speaker voice."""
    from phoonnx_tpu_torch.models.vits import posterior

    hp, params = model_params(torch, "medium", seed)
    gen = torch.Generator().manual_seed(seed + 1)
    flows = {gin: randomize_post(posterior.init_residual_coupling_block(
        gen, hp.inter_channels, hp.hidden_channels, 5, 1, 4,
        gin_channels=gin), gen) for gin in (256, 512)}
    return hp, params, flows


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--profile", action="store_true",
                        help="also print a torch.profiler breakdown of one "
                        "~250-id request and of one medium training step")
    parser.add_argument("--parent", type=Path, default=None,
                        help="root of another checkout (the parent commit): "
                        "build its kernels C and D and time them beside "
                        "this one's (C conv by conv and its three stages "
                        "whole, D at the medium training shape)")
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

    parents = {name: build_parent(port_cuda, args.parent, name)
               for name in ("fused_stage", "mas")} if args.parent else {}
    build_s = port_cuda.build()
    print(f"build: {len(port_cuda.LIBRARIES)} libraries from "
          f"phoonnx_tpu_torch/csrc in {build_s:.1f} s", flush=True)
    # the parent's builds end before anything is measured: a profiler
    # session taken while nvcc runs beside it can lose its device records
    parents = {name: load() for name, load in parents.items()}

    dev = torch.device("cuda")
    hp, params, flows = medium_params(torch, args.seed)
    on_card = vits_model.attach_fused_specs(
        vits_model.params_to_device(params, dev))
    from phoonnx_tpu_torch.models.vits import fused_flow

    flow_g_params = {gin: fused_flow.build_spec(
        vits_model.params_to_device(flow, dev))
        for gin, flow in flows.items()}
    results = kernel_phases(torch, on_card, flow_g_params,
                            high_stage0(torch, args.seed, dev), args.seed,
                            dev)
    graph_probe(torch, on_card, args.seed, dev)
    stage_conv_profile(torch, port_cuda, on_card["dec"]["fused_stages"],
                       on_card["dec"]["upsample_rates"], dev, args.seed,
                       parent=parent_stage(port_cuda, parents["fused_stage"])
                       if parents else None)
    del on_card
    results["D"] = mas_phase(
        torch, dev, args.seed,
        parent=parent_mas(port_cuda, args.parent, parents["mas"])
        if parents else None)
    results["noise"] = noise_phase(torch, dev, args.seed)
    # the bf16 builds of A, B and C, at B=1 and at 16 lanes
    t_bf16 = time.perf_counter()
    on_card = bf16_params(torch, params, dev)
    results_bf16 = bf16_kernel_phase(torch, on_card, args.seed + 11, dev)
    for name, err in serve_kernels(torch, on_card, args.seed + 12).items():
        results_bf16[name]["max_abs_err"] = max(
            results_bf16[name]["max_abs_err"], err)
    del on_card
    bf16_s = time.perf_counter() - t_bf16

    # serving: kernels A, B and C, on the medium voice (whole and
    # streamed) and the two iSTFT voices; each path's launches are counted
    # from 0 and printed
    paths = {}
    model_path, config_path = write_voice(
        torch, params, hp, ROOT / "build" / "chip_smoke")
    voice, paths["medium serving path"], _ = main_path(
        torch, model_path, config_path, args.seed)
    memory_line(torch, "the medium serving path")
    path_vs_plain(torch, voice, args.seed + 1)
    graphs_vs_eager(torch, voice.engine, voice.phonemes_to_ids(
        voice.phonemize(text_of(100, 3))[0]), args.seed + 2)
    request_phase(torch, voice, args.seed + 2, args.profile)
    paths["medium streaming path"], medium_ms = stream_phase(
        torch, voice, args.seed + 3)
    surface_phase(torch, voice, args.seed + 4)
    reentrant_phase(torch, voice, args.seed + 5)
    graph_memory(voice.engine, "medium")
    memory_line(torch, "the medium voice's phases")
    del voice
    # the HTTP server with dynamic batching, on a fresh load of the medium
    # voice (a pool of its own); then A, B and C at its 16 lanes
    from phoonnx_tpu_torch import TTSVoice

    served = TTSVoice.load(str(model_path), str(config_path))
    paths["medium dynamic-batching server path"], f32_load = serve_phase(
        torch, served, args.seed + 6)
    for name, err in serve_kernels(torch, served.engine.params,
                                   args.seed + 7).items():
        results[name]["max_abs_err"] = max(results[name]["max_abs_err"],
                                           err)
    del served
    # bf16 synthesis: the medium voice loaded with dtype="bfloat16", and a
    # bf16 server under the float32 server's load
    t_bf16 = time.perf_counter()
    paths_bf16 = bf16_voice_phase(torch, model_path, config_path,
                                  args.seed + 13)
    paths_bf16["bf16 medium dynamic-batching server path"] = \
        bf16_serve_phase(torch, model_path, config_path, args.seed + 6,
                         f32_load)
    bf16_s += time.perf_counter() - t_bf16
    print(f"bf16: the bf16 phases took {bf16_s:.1f} s", flush=True)
    memory_line(torch, "the bf16 phases")
    for quality in ("medium-istft", "medium-mb-istft"):
        stages, served = istft_phase(torch, quality, args.seed, ROOT,
                                     medium_ms)
        paths.update(served)
        results["C"]["max_abs_err"] = max(results["C"]["max_abs_err"],
                                          stages["max_abs_err"])
        memory_line(torch, f"the {quality} voice's phases")

    # voice conversion (kernels B and C) and the two CLIs
    ms_files, paths["medium 4-speaker voice conversion path"] = vc_phase(
        torch, args.seed, ROOT)
    memory_line(torch, "voice conversion")
    cli_phase((model_path, config_path), ms_files, args.seed, ROOT)

    # foreign voices on the ONNX graph engine (no kernel of A-D), and the
    # engines' matmul precision
    onnx_phase(torch, params, hp, (model_path, config_path), args.seed + 14,
               ROOT)
    memory_line(torch, "the foreign voices")
    precision_phase(torch, (model_path, config_path), args.seed + 15)

    # the text front end on the card (the ByT5 G2P, the diacritizers, the
    # bundled G2P), feeding kernels A, B and C
    paths.update(frontend_phase(torch, model_path, config_path,
                                args.seed + 16, ROOT, card))
    memory_line(torch, "the front end")

    # training: kernel D in the steps, at medium and on the MB-iSTFT
    # decoder; A, B and C in each epoch's test audio
    data = training_dataset(torch, ROOT, args.seed)
    d_medium, medium_run = training_phase(torch, data, args.seed,
                                          args.profile)
    d_mb, mb_run = training_phase(torch, data, args.seed, False,
                                  quality="medium-mb-istft")
    paths["train medium test audio"] = medium_run["test_audio"]
    paths["train medium-mb-istft test audio"] = mb_run["test_audio"]
    overfit_phase(torch, dev, args.seed)
    memory_line(torch, "training")
    # data-parallel training: two ranks on the card over gloo; kernel D in
    # both ranks' steps, A, B and C in rank 0's test audio
    dp_launches = dp_phase(torch, data, args.seed, card)
    paths["dp rank 0 test audio"] = {k: dp_launches[k] for k in SYNTH}

    # the training pipeline: preprocess, three epochs, export, serve;
    # each of its lines names the card and its power limit
    pipeline_paths, d_pipeline = pipeline_phase(
        torch, ROOT / "build" / "chip_smoke" / "pipeline", args.seed, dev,
        tag=f"pipeline on {card}")
    paths.update(pipeline_paths)
    memory_line(torch, "the pipeline")

    # the convergence run (train/scale_run.py): medium, bf16, grad_accum 2,
    # a mid-run resume, the export served, its bf16 voice against float32
    converge_paths, converge_bf16, d_converge = converge_phase(
        torch, ROOT, card)
    paths.update(converge_paths)
    paths_bf16.update(converge_bf16)
    memory_line(torch, "the convergence run")

    launches = {name: sum(counts[name] for counts in paths.values())
                for name in SYNTH}
    launches["D"] = (d_medium + d_mb + d_pipeline + dp_launches["D"]
                     + d_converge)
    launches_bf16 = {name: sum(counts[name] for counts in paths_bf16.values())
                     for name in SYNTH}
    for path, counts in {**paths, **paths_bf16}.items():
        print(f"launches: {path} {counts}", flush=True)
    print(f"launches: bf16 builds summed {launches_bf16}", flush=True)
    print(f"launches: training medium D={d_medium}, training "
          f"medium-mb-istft D={d_mb}, pipeline D={d_pipeline}, "
          f"data-parallel epoch D={dp_launches['D']} (both ranks), "
          f"convergence run D={d_converge}; summed {launches}", flush=True)

    jax_dir = "phoonnx_tpu/models/vits"
    sources = {"A": ("fused_encoder", f"{jax_dir}/fused_encoder.py:195"),
               "B": ("fused_flow", f"{jax_dir}/fused_flow.py:217"),
               "C": ("fused_stage", f"{jax_dir}/fused_stage.py:250"),
               "D": ("mas", "phoonnx_tpu/ops/mas_pallas.py:36")}
    line = []
    builds = [(name, lib, replaces, results[name], launches[name], "")
              for name, (lib, replaces) in sources.items()]
    builds += [(name, lib, replaces, results_bf16[name], launches_bf16[name],
                "_bf16") for name, (lib, replaces) in sources.items()
               if name in results_bf16]
    # the noise kernel replaces no TPU kernel (jax.random drew the noise)
    builds.append(("noise", "noise", None, results["noise"],
                   launches["noise"], ""))
    for name, lib, replaces, res, n, suffix in builds:
        reason = {"D": NO_LIBRARY_MAS, "noise": NO_LIBRARY_NOISE}.get(
            name, NO_LIBRARY)
        print(f"library_ms {name}{suffix}: null, {reason}", flush=True)
        line.append({"name": f"{name}:{lib}{suffix}", "route": "cuda",
                     "source": f"phoonnx_tpu_torch/csrc/{lib}.cu",
                     "replaces": replaces, "launches": n,
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
