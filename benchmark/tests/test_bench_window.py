"""The window's rate and 90th percentile over synthetic iteration times."""

import statistics

import pytest

from benchmark import window


def test_rate_is_every_env_step_over_the_whole_window():
    walls = [0.2] * 100
    assert window.rate(64 * 8192, len(walls), sum(walls)) == pytest.approx(64 * 8192 / 0.2)


def test_a_planted_stall_moves_the_rate_and_the_p90():
    steady = [0.19 + 0.001 * (i % 5) for i in range(120)]
    stalled = list(steady)
    for i in range(0, 120, 8):   # 15 of 120 iterations stall 50 ms
        stalled[i] += 0.05
    r0 = window.rate(524288, len(steady), sum(steady))
    r1 = window.rate(524288, len(stalled), sum(stalled))
    assert r1 < r0 * 0.97
    assert window.percentile(stalled, 90) > window.percentile(steady, 90) + 0.04
    assert statistics.median(stalled) == pytest.approx(statistics.median(steady))


def test_percentile_is_numpys_linear_one():
    xs = [float(i) for i in range(1, 101)]
    assert window.percentile(xs, 90) == pytest.approx(90.1)
    assert window.percentile([3.0], 90) == 3.0


def test_slowest_rank_of_each_iteration():
    assert window.slowest([[1.0, 2.0, 3.0], [1.5, 1.0, 3.5]]) == [1.5, 2.0, 3.5]

