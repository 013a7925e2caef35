"""The metric arithmetic: rates and tails over every frame, the idle
share from a union of intervals, the spread of a set of runs."""
import statistics
from types import SimpleNamespace

import pytest

from gdbench import stats
from gdbench.metrics import device_idle, frame_p95_s, msamples_per_s


def test_rate_counts_every_frame_over_the_whole_window():
    rec = SimpleNamespace(samples_per_frame=1_048_576, frames=7,
                          window_s=2.0)
    assert msamples_per_s.read(rec) == pytest.approx(7 * 1_048_576 / 2e6)


def test_p95_is_over_all_frames_not_medians_of_chunks():
    walls = ([0.1] * 9 + [1.0]) * 10      # one slow frame in every ten
    assert frame_p95_s.read(SimpleNamespace(walls=walls)) == 1.0
    chunk_medians = [statistics.median(walls[i:i + 10])
                     for i in range(0, 100, 10)]
    assert stats.percentile(chunk_medians, 95) == 0.1
    assert stats.percentile(list(range(1, 101)), 95) == 95
    assert stats.percentile([3.0], 95) == 3.0


def test_union_of_overlapping_intervals():
    iv = [(0, 10), (5, 15), (20, 30), (25, 26), (40, 41)]
    assert stats.union_length(iv) == 15 + 10 + 1
    assert stats.union_length([]) == 0
    gaps = stats.gaps(iv)
    assert sorted(g for g, _ in gaps) == [5, 10]


def test_idle_share_reads_the_union_not_the_sum():
    tr = dict(busy_s=stats.union_length([(0, 6), (3, 8)]), window_s=10.0)
    assert device_idle.read(SimpleNamespace(trace=tr)) == pytest.approx(20.0)
    assert device_idle.read(SimpleNamespace(trace=None)) is None
