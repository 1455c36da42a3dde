"""The traffic generators: the same traffic for one seed, the same sizes
and gaps for every seed."""

import json

import numpy as np

from bench_micro import BENCH
from harness import traffic

MIX = json.loads((BENCH / "traffic" / "lj-closed-64.json").read_text())


def test_texts_repeat_for_a_seed():
    assert traffic.lj_texts(MIX, 2 ** 33 + 7) == traffic.lj_texts(
        MIX, 2 ** 33 + 7)


def test_every_seed_gets_the_same_sizes_in_its_own_order():
    a = traffic.lj_texts(MIX, 1)
    b = traffic.lj_texts(MIX, 2 ** 31 + 11)
    assert a != b
    assert sorted(map(len, a)) == sorted(map(len, b))
    assert len(a) == MIX["texts"]["n"]


def test_texts_follow_lj_speech():
    texts = traffic.lj_texts(MIX, 5)
    chars = np.array([len(t) for t in texts])
    lo, mean, hi = MIX["texts"]["clip_s"]
    rate = MIX["texts"]["chars_per_s"]
    assert abs(chars.mean() / rate - mean) < 0.1
    assert chars.min() >= lo * rate - 6 and chars.max() <= hi * rate + 6
    assert set("".join(texts)) <= set(traffic.LETTERS + " ")


def test_arrivals_repeat_and_fill_the_window():
    a = traffic.poisson_offsets(130, 20.0, 9)
    assert a == traffic.poisson_offsets(130, 20.0, 9)
    b = traffic.poisson_offsets(130, 20.0, 10)
    assert a != b and len(a) == len(b) == 2600
    assert a[0] == 0.0 and all(x < y for x, y in zip(a, a[1:]))
    assert a[-1] < 20.0
    gaps = np.diff(a)
    assert abs(gaps.mean() - 1 / 130) < 1e-4
    # exponential gaps: the standard deviation is the mean
    assert abs(gaps.std() / gaps.mean() - 1) < 0.05


def test_sample_holds_the_longest():
    s = traffic.sample(128, 16, 3, longest=77)
    assert 77 in s and len(s) == len(set(s)) == 16
    assert s == traffic.sample(128, 16, 3, longest=77)


def test_lateness():
    late = traffic.lateness_ms([0.0, 1.0, 2.0], [0.0, 1.002, 2.010])
    assert abs(late["max"] - 10.0) < 1e-6 and abs(late["p50"] - 2.0) < 1e-6
