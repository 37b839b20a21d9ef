"""The traffic generator: deterministic per seed, the stated
distributions, the same sizes for every seed in another order."""
import math

import numpy as np
import pytest

from perfbench import traffic

MIX = {"loop": "open", "rate_rps": 6.0, "preroll_s": 4,
       "prompt": {"dist": "loguniform", "min": 1024, "max": 3840},
       "output": {"dist": "uniform", "min": 16, "max": 64}}
BIG = 2**31 + 977


def test_open_loop_is_deterministic_per_seed():
    a = traffic.open_loop(MIX, BIG, 30, 1000)
    b = traffic.open_loop(MIX, BIG, 30, 1000)
    c = traffic.open_loop(MIX, BIG + 1, 30, 1000)
    assert [(s.due, s.prompt, s.max_new) for s in a] == \
        [(s.due, s.prompt, s.max_new) for s in b]
    assert [s.prompt for s in a] != [s.prompt for s in c]


@pytest.mark.parametrize("seed", [0, 5, BIG])
def test_open_loop_window_holds_the_same_work_for_every_seed(seed):
    specs = traffic.open_loop(MIX, seed, 30, 1000)
    win = [s for s in specs if 0 <= s.due < 30]
    pre = [s for s in specs if s.due < 0]
    assert len(win) == round(6.0 * 30) and len(pre) == round(6.0 * 4)
    ref = traffic.open_loop(MIX, 1, 30, 1000)
    ref_win = [s for s in ref if 0 <= s.due < 30]
    assert sorted(len(s.prompt) for s in win) == \
        sorted(len(s.prompt) for s in ref_win)
    assert sorted(s.max_new for s in win) == \
        sorted(s.max_new for s in ref_win)
    dues = [s.due for s in specs]
    assert dues == sorted(dues) and min(dues) >= -4 - 1e-9
    assert max(s.due for s in win) < 30


def test_open_loop_rate_and_lengths_follow_the_mix():
    specs = traffic.open_loop(MIX, 3, 200, 1000)
    win = [s for s in specs if s.due >= 0]
    gaps = np.diff([s.due for s in win])
    assert abs(gaps.mean() - 1 / 6.0) < 0.01
    # exponential gaps: the coefficient of variation is 1
    assert abs(gaps.std() / gaps.mean() - 1.0) < 0.1
    P = np.array([len(s.prompt) for s in win])
    assert P.min() >= 1024 and P.max() <= 3840
    # log-uniform: the median is the geometric mean of the ends
    assert abs(np.median(P) / math.sqrt(1024 * 3841) - 1) < 0.03
    out = np.array([s.max_new for s in win])
    assert out.min() == 16 and out.max() == 64
    assert abs(out.mean() - 40) < 0.5
    ids = np.concatenate([s.prompt for s in win])
    assert ids.min() >= 0 and ids.max() < 1000


def test_quantiles_span_the_range_evenly():
    q = traffic.quantiles({"dist": "uniform", "min": 256, "max": 1024}, 256)
    step = (1024 + 1 - 256) / 256
    assert 256 <= q.min() <= 256 + step and 1024 - step <= q.max() <= 1024
    assert list(q) == sorted(q)
    assert abs(q.mean() - (256 + 1024) / 2) < 1
    with pytest.raises(ValueError):
        traffic.quantiles({"dist": "zipf", "min": 1, "max": 2}, 4)


def test_closed_stream_blocks_hold_the_same_sizes():
    mix = {"prompt": {"dist": "uniform", "min": 64, "max": 512},
           "output": {"dist": "uniform", "min": 256, "max": 1024}}
    s1, s2 = traffic.ClosedStream(mix, BIG, 5000), \
        traffic.ClosedStream(mix, 7, 5000)
    a = [s1.next() for _ in range(traffic.BLOCK)]
    b = [s2.next() for _ in range(traffic.BLOCK)]
    assert sorted(len(s.prompt) for s in a) == \
        sorted(len(s.prompt) for s in b)
    assert sorted(s.max_new for s in a) == sorted(s.max_new for s in b)
    assert [s.index for s in a] == list(range(traffic.BLOCK))
    again = traffic.ClosedStream(mix, BIG, 5000)
    assert [s.prompt for s in a] == \
        [again.next().prompt for _ in range(traffic.BLOCK)]


def test_closed_first_requests_are_cut_to_every_stage():
    mix = {"prompt": {"dist": "uniform", "min": 64, "max": 512},
           "output": {"dist": "uniform", "min": 256, "max": 1024}}
    first = traffic.ClosedStream(mix, 3, 5000).first(128)
    full = traffic.ClosedStream(mix, 3, 5000)
    whole = [full.next().max_new for _ in range(128)]
    cut = [s.max_new for s in first]
    assert all(1 <= c <= w for c, w in zip(cut, whole))
    assert min(cut) < 20 and max(cut) > 900
