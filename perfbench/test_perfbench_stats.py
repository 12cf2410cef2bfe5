"""Percentiles and the window's arithmetic: a censored request moves the tail, a rate
counts all the work over all the time, the device's busy time is a union."""
import pytest

from perfbench import stats


def test_percentile_interpolates_between_ranks():
    assert stats.percentile([], 90) is None
    assert stats.percentile([5.0], 90) == 5.0
    assert stats.percentile(list(range(11)), 90) == pytest.approx(9.0)
    assert stats.percentile([1, 2, 3, 4], 50) == pytest.approx(2.5)


def test_a_request_without_a_first_token_counts_its_wait_so_far():
    due = [0.0, 1.0, 2.0, 9.0, 12.0]
    first = [0.5, 1.2, None, None, 12.1]
    got = stats.ttfts(due, first, 0.0, 10.0)
    assert got == pytest.approx([0.5, 0.2, 8.0, 1.0])   # due after the close: not counted
    served = stats.ttfts(due, [0.5, 1.2, 2.1, 9.1, 12.1], 0.0, 10.0)
    assert stats.percentile(got, 90) > stats.percentile(served, 90)


def test_a_first_token_after_the_close_is_censored_at_the_close():
    assert stats.ttfts([9.0], [11.0], 0.0, 10.0) == pytest.approx([1.0])


def test_tpot_takes_the_tokens_inside_the_window():
    times = [[-1.0, 0.5, 1.0, 1.5], [2.0], [9.0, 9.4, 10.5]]
    assert stats.tpots(times, 0.0, 10.0) == pytest.approx([0.5, 0.4])
    assert stats.tokens_in(times, 0.0, 10.0) == 6


def test_a_rate_is_all_the_work_over_all_the_time():
    steps = [(0.0, 1.0), (1.0, 3.0), (3.0, 3.5)]
    assert stats.rate_over_steps(steps, 100.0) == pytest.approx(300.0 / 3.5)
    assert stats.rate_over_steps([], 100.0) is None


def test_union_of_kernel_intervals():
    iv = [(0, 4), (2, 6), (8, 9), (8.5, 8.7), (12, 20)]
    assert stats.union_length(iv, 0, 10) == pytest.approx(7.0)
    assert stats.union_length(iv, 3, 15) == pytest.approx(3.0 + 1.0 + 3.0)
    assert stats.union_length([], 0, 10) == 0.0
    assert stats.gaps(iv, 0, 10) == [(6, 8), (9, 10)]
    assert stats.gaps([(1, 2)], 0, 3) == [(0, 1), (2, 3)]
