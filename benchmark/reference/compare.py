"""The comparison that decides a serving run's ``correct``.

A served WAV is judged against the reference's synthesis of the same text
with the same weights and scales (noise 0). First its length: the frame
count the served audio has must be the reference's, where a duration
that the reference puts within :data:`TIE` of a frame boundary may fall
either way (``ceil`` turns a rounding difference there into a frame).
Then its samples: the widest gap, in 16-bit steps, between the served
PCM and the reference's audio quantised as the WAV route quantises it.
"""

import itertools
from dataclasses import dataclass
from typing import List, Sequence, Tuple

import numpy as np
import torch

from reference import vits

# a duration (frames before ceil) this close to a whole number, relative
# to it, may round either way
TIE = 1e-4
# at most this many near ties are tried both ways (2**MAX_TIES syntheses)
MAX_TIES = 4


@dataclass
class Verdict:
    frames_ok: bool  # the served length is one the reference can give
    gap_lsb: int  # widest sample gap in 16-bit steps (0 if not frames_ok)
    ties: int  # durations within TIE of a boundary


def pcm16(audio: np.ndarray) -> np.ndarray:
    """The WAV route's quantisation (clip, scale, truncate)."""
    return np.clip(audio * 32767.0, -32767.0, 32767.0).astype(np.int16)


def hop(cfg: dict) -> int:
    return int(np.prod(cfg["upsample_rates"]))


def candidates(w_scaled: torch.Tensor,
               total: int) -> Tuple[List[torch.Tensor], int]:
    """Frame counts per id whose sum is ``total``: the ceil of the scaled
    durations, with near ties taken either way."""
    base = torch.ceil(w_scaled)
    frac = (w_scaled.double() - torch.round(w_scaled.double())).abs()
    near = torch.nonzero(frac < TIE * torch.clamp(w_scaled.double().abs(),
                                                  min=1.0))[:, 0].tolist()
    near = near[:MAX_TIES]
    out = []
    for flips in itertools.product((False, True), repeat=len(near)):
        frames = base.clone()
        for i, flip in zip(near, flips):
            if flip:
                # just above a whole number: ceil went up, the other way is
                # down; just below: the other way is up
                up = w_scaled[i] < torch.round(w_scaled[i])
                frames[i] += 1 if up else -1
        if int(frames.sum()) == total:
            out.append(frames)
    return out, len(near)


def judge(w: vits.Weights, cfg: dict, ids: Sequence[int],
          length_scale: float, served: np.ndarray) -> Verdict:
    """``served``: the WAV's int16 samples. The reference runs in float32
    with TF32 off."""
    dev = w["enc_p.emb.weight"].device
    with torch.no_grad(), vits.precision(False):
        # the scaled durations in float32, as a float32 voice computes them
        w_scaled = torch.exp(vits.log_w(w, cfg, ids, dev)) * length_scale
        h = hop(cfg)
        if len(served) % h:
            return Verdict(False, 0, 0)
        cands, ties = candidates(w_scaled.cpu(), len(served) // h)
        best = None
        for frames in cands:
            audio = vits.synthesize(w, cfg, ids, length_scale,
                                    frames=frames.to(dev))
            want = pcm16(audio.float().cpu().numpy())
            gap = int(np.abs(want.astype(np.int32)
                             - served.astype(np.int32)).max())
            best = gap if best is None else min(best, gap)
    if best is None:
        return Verdict(False, 0, ties)
    return Verdict(True, best, ties)


def control_pcm(w: vits.Weights, cfg: dict, ids: Sequence[int],
                length_scale: float) -> np.ndarray:
    """The control's WAV: the reference itself with TF32 allowed in cuBLAS
    and cuDNN, the nearest precision below the configuration's float32."""
    with torch.no_grad(), vits.precision(True):
        return pcm16(vits.synthesize(w, cfg, ids, length_scale)
                     .float().cpu().numpy())
