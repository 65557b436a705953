"""The end-to-end arithmetic over synthetic event logs."""

import pytest

from perfbench.e2e import Log, end_to_end
from perfbench.spec import percentile


def _steady(log, t0, t1, dt, rids):
    """Every ``dt`` seconds one token for each of ``rids``."""
    t = t0
    while t < t1:
        for r in rids:
            log.emit(r, 1, t)
        log.steps.append((t - dt / 2, t, len(rids)))
        t += dt


def test_rate_is_taken_over_the_whole_window():
    log = Log()
    _steady(log, 0.0, 10.0, 0.5, [1, 2])
    whole = end_to_end(log, 0.0, 10.0)
    assert whole["out_tok_s"] == pytest.approx(4.0)
    # a stall of half the window halves the rate: no time is left out
    log2 = Log()
    _steady(log2, 0.0, 5.0, 0.5, [1, 2])
    assert end_to_end(log2, 0.0, 10.0)["out_tok_s"] == pytest.approx(2.0)


def test_ttft_counts_from_due_and_a_stall_moves_the_p95():
    def run(stall):
        log = Log()
        for r in range(100):
            log.due[r] = r * 0.1
            # served 20 ms after due, except those due in the stall
            first = r * 0.1 + 0.02
            if stall and 3.0 <= r * 0.1 < 4.0:
                first = 4.0 + 0.02
            log.emit(r, 1, first)
        return end_to_end(log, 0.0, 10.0)
    calm, stalled = run(False), run(True)
    assert calm["ttft_p95_ms"] == pytest.approx(20.0, abs=1e-6)
    assert stalled["ttft_p95_ms"] > 500.0
    assert calm["attempted"] == stalled["attempted"] == 100


def test_tpot_counts_requests_finished_in_the_window_and_failures_count():
    log = Log()
    log.due.update({1: 0.0, 2: 0.0, 3: 9.5})
    for i in range(11):                  # 1: tokens 0.1 s apart, done at 1.0
        log.emit(1, 7, 0.0 + 0.1 * i)
    log.done[1] = 1.0
    for i in range(5):                   # 2: done at 12.0, past the window
        log.emit(2, 7, 8.0 + i)
    log.done[2] = 12.0
    out = end_to_end(log, 0.0, 10.0)     # 3: due, never served
    assert out["tpot_n"] == 1
    assert out["tpot_p95_ms"] == pytest.approx(100.0)
    assert out["attempted"] == 3 and out["failed"] == 1


def test_percentile_is_nearest_rank():
    v = list(range(1, 101))
    assert percentile(v, 95) == 95
    assert percentile(v, 50) == 50
    assert percentile([3.0], 95) == 3.0
