"""The end-to-end arithmetic on synthetic timestamps."""
import pytest

from perfbench import window


def test_jobs_rate_counts_all_scans_over_the_whole_span():
    jobs = [(10.0, 20.0, 4), (20.0, 30.0, 4), (30.0, 42.0, 4)]
    assert window.jobs_rate(jobs) == pytest.approx(12 / 32)


def test_steady_steps():
    bounds = [1.0 + 0.25 * i for i in range(101)]
    assert window.steps_rate(bounds, 2) == pytest.approx(8.0)
    assert window.percentile(window.step_times(bounds), 90) == \
        pytest.approx(0.25)


def test_a_stall_moves_the_rate_and_the_tail():
    steady = [0.25] * 150
    stalled = list(steady)
    for i in range(100, 120):           # 20 slow steps: a stall of 5 s
        stalled[i] = 0.5
    for durs, rate, p90 in ((steady, 8.0, 0.25), (stalled, None, None)):
        bounds = [0.0]
        for d in durs:
            bounds.append(bounds[-1] + d)
        r = window.steps_rate(bounds, 2)
        p = window.percentile(window.step_times(bounds), 90)
        if rate is not None:
            assert r == pytest.approx(rate) and p == pytest.approx(p90)
        else:
            assert r == pytest.approx(300 / 42.5)
            assert p == pytest.approx(0.5)


def test_a_stalled_job_moves_the_scan_rate():
    steady = [(0.0, 10.0, 4), (10.0, 20.0, 4), (20.0, 30.0, 4)]
    stalled = [(0.0, 10.0, 4), (10.0, 25.0, 4), (25.0, 35.0, 4)]
    assert window.jobs_rate(stalled) < window.jobs_rate(steady)


def test_too_few_boundaries():
    with pytest.raises(ValueError):
        window.steps_rate([1.0], 2)
