"""Traffic made from a mix's data file and the seed.

Every seed gets the same set of sizes and the same set of gaps between
arrivals, in its own order, so that two seeds ask for the same work:

* texts (:func:`lj_texts`): one-sentence texts of raw letters whose
  lengths follow LJ Speech 1.1's published clip statistics
  (keithito.com/LJ-Speech-Dataset: 13,100 clips of 1.11-10.10 s, mean
  6.57 s, 1,308,678 characters). A clip's duration is a quantile of the
  triangular distribution with that minimum, mean and maximum (mode
  3 x 6.57 - 1.11 - 10.10 = 8.50 s), and its text has the corpus's 15.205
  characters a second. The seed orders the durations and picks each
  text's letters;
* arrivals (:func:`poisson_offsets`): the quantiles of the exponential
  gap at the mix's rate, ordered by the seed, scaled to the window.
"""

import math
from typing import List, Tuple

import numpy as np

LETTERS = "abcdefghijklmnopqrstuvwxyz"


def text_of(n_letters: int, offset: int) -> str:
    """Letters in words of 5 separated by spaces, no punctuation."""
    chars = [LETTERS[(offset + 7 * i) % 26] for i in range(n_letters)]
    return " ".join("".join(chars[i:i + 5]) for i in range(0, n_letters, 5))


def text_of_chars(n_chars: float, offset: int) -> str:
    """A text of about ``n_chars`` characters (5 letters and a space a
    word)."""
    return text_of(max(4, round(n_chars * 5 / 6)), offset)


def triangular_quantiles(lo: float, mean: float, hi: float,
                         n: int) -> np.ndarray:
    """The n mid-quantiles of the triangular distribution of that minimum,
    mean and maximum."""
    mode = 3 * mean - lo - hi
    u = (np.arange(n) + 0.5) / n
    cut = (mode - lo) / (hi - lo)
    left = lo + np.sqrt(u * (hi - lo) * (mode - lo))
    right = hi - np.sqrt((1 - u) * (hi - lo) * (hi - mode))
    return np.where(u < cut, left, right)


def lj_clips(spec: dict, seed: int) -> Tuple[np.ndarray, List[str]]:
    """``spec["n"]`` clip durations (s) and their texts, in the seed's
    order."""
    lo, mean, hi = spec["clip_s"]
    seconds = triangular_quantiles(lo, mean, hi, spec["n"])
    rng = np.random.default_rng(seed)
    seconds = seconds[rng.permutation(spec["n"])]
    offsets = rng.integers(0, 26, size=spec["n"])
    return seconds, [text_of_chars(s * spec["chars_per_s"], int(o))
                     for s, o in zip(seconds, offsets)]


def lj_texts(mix: dict, seed: int) -> List[str]:
    """The mix's ``texts.n`` texts, in the seed's order."""
    return lj_clips(mix["texts"], seed)[1]


def poisson_offsets(rate: float, seconds: float, seed: int) -> List[float]:
    """Arrival offsets in [0, seconds): ``round(rate * seconds)`` arrivals,
    the first at 0, their gaps the exponential distribution's
    mid-quantiles in the seed's order, scaled so that the last gap ends at
    the window's end."""
    n = max(2, round(rate * seconds))
    gaps = -np.log(1.0 - (np.arange(n) + 0.5) / n) / rate
    gaps = gaps[np.random.default_rng(seed).permutation(n)]
    times = np.cumsum(gaps) * (seconds / gaps.sum())
    return [0.0] + [float(t) for t in times[:-1]]


def sample(n_bodies: int, k: int, seed: int, longest: int) -> List[int]:
    """``k`` body indices drawn from the seed, the longest among them."""
    rng = np.random.default_rng(seed + 1)
    picked = rng.choice(n_bodies, size=min(k, n_bodies), replace=False)
    picked = [int(i) for i in picked if i != longest][:k - 1]
    return sorted(picked + [longest])


def lateness_ms(due: List[float], sent: List[float]) -> dict:
    """How late the generator sent: the median, 99th percentile and max of
    send minus due time, in ms."""
    late = np.maximum(np.asarray(sent) - np.asarray(due), 0.0) * 1e3
    if not len(late):
        return {"p50": math.nan, "p99": math.nan, "max": math.nan}
    p50, p99 = np.percentile(late, [50, 99])
    return {"p50": float(p50), "p99": float(p99), "max": float(late.max())}
