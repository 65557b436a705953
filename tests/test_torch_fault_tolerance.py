"""The port's fault-tolerance runtime against the JAX package's tests.

Every case of ``tests/test_fault_tolerance.py`` (the backoff budget, the
re-queue hook, heartbeats, stragglers) and the executor, heartbeat and
straggler cases of ``tests/test_substrates.py``, run on
``repro_torch.runtime.fault_tolerance`` with the same assertions, plus
the policy's validation and JSON round trip and the executor's timing of
a step (a CUDA step is timed to the end of its device work: the
executor synchronizes the devices of the step's output).
"""

import time

import pytest
import torch

from repro_torch.runtime.fault_tolerance import (Heartbeat, ResilientExecutor,
                                                 RetryPolicy,
                                                 StragglerDetector,
                                                 TransientError)
from torch_tune_cache import port_tune_cache  # noqa: F401 (autouse)


# ----------------------------------------------------------------------
# RetryPolicy backoff budget
# ----------------------------------------------------------------------
def test_total_delay_sums_per_attempt_backoff():
    p = RetryPolicy(max_retries=3, backoff_base_s=1.0, backoff_factor=2.0,
                    max_backoff_s=30.0)
    # attempts 1..3 sleep 1, 2, 4 seconds
    assert p.total_delay_s() == pytest.approx(1.0 + 2.0 + 4.0)


def test_total_delay_respects_cap_and_zero_base():
    capped = RetryPolicy(max_retries=4, backoff_base_s=1.0,
                         backoff_factor=10.0, max_backoff_s=5.0)
    # 1, 5(cap of 10), 5(100), 5(1000)
    assert capped.total_delay_s() == pytest.approx(16.0)
    assert RetryPolicy(max_retries=5).total_delay_s() == 0.0


# ----------------------------------------------------------------------
# ResilientExecutor re-queue hook
# ----------------------------------------------------------------------
def _always_fail(step):
    raise TransientError("wedged")


def test_requeue_hook_receives_payload_on_exhaustion():
    got = []
    ex = ResilientExecutor(lambda s, *a: s, max_retries=2,
                           failure_hook=_always_fail,
                           requeue_fn=got.append)
    with pytest.raises(TransientError):
        ex.run_step(0, None, payload={"rid": 7})
    assert got == [{"rid": 7}]        # handed back exactly once
    assert ex.exhausted_total == 1
    assert ex.retries_total == 3      # initial + 2 retries all burned


def test_requeue_hook_not_called_when_retry_succeeds():
    calls = {"n": 0}

    def flaky(step):
        calls["n"] += 1
        if calls["n"] == 1:
            raise TransientError("blip")

    got = []
    ex = ResilientExecutor(lambda s, *a: s, max_retries=2,
                           failure_hook=flaky, requeue_fn=got.append)
    ex.run_step(0, 1, payload="work")
    assert got == []
    assert ex.exhausted_total == 0


def test_restart_path_takes_precedence_over_requeue():
    restored = {"n": 0}

    def fail_until_restored(step):
        if restored["n"] == 0:
            raise TransientError("dead host")

    def restore():
        restored["n"] += 1
        return 100

    got = []
    ex = ResilientExecutor(lambda s, *a: s + 1, max_retries=1,
                           restore_fn=restore,
                           failure_hook=fail_until_restored,
                           requeue_fn=got.append)
    assert ex.run_step(0, 0, payload="work") == 101
    assert ex.restarts_total == 1
    assert got == [] and ex.exhausted_total == 0


def test_exhaustion_without_hook_still_raises_and_counts():
    ex = ResilientExecutor(lambda s, *a: s, max_retries=1,
                           failure_hook=_always_fail,
                           policy=RetryPolicy(max_retries=1,
                                              restart_on_exhaustion=False))
    with pytest.raises(TransientError):
        ex.run_step(0, None)
    assert ex.exhausted_total == 1


# ----------------------------------------------------------------------
# Heartbeat
# ----------------------------------------------------------------------
def test_heartbeat_roundtrip_and_staleness(tmp_path):
    hb = Heartbeat(str(tmp_path), host_id=3)
    assert hb.last() is None          # never beat: no file yet
    assert hb.stale(timeout_s=1e9)    # ...and "stale" by convention
    hb.beat(11)
    last = hb.last()
    assert last["step"] == 11 and last["t"] > 0
    assert not hb.stale(timeout_s=60)
    assert hb.stale(timeout_s=0)


def test_heartbeat_files_are_per_host(tmp_path):
    a = Heartbeat(str(tmp_path), host_id=0)
    b = Heartbeat(str(tmp_path), host_id=1)
    a.beat(5)
    assert b.last() is None           # host 1 never beat
    assert a.last()["step"] == 5
    b.beat(9)
    assert a.last()["step"] == 5      # unchanged by host 1's beat


# ----------------------------------------------------------------------
# StragglerDetector
# ----------------------------------------------------------------------
def test_straggler_ewma_and_fleet_median():
    d = StragglerDetector(alpha=0.5, factor=2.0)
    d.observe(0, 1.0)
    d.observe(0, 3.0)                 # ewma: 0.5*3 + 0.5*1 = 2.0
    assert d.fleet_ewma() == pytest.approx(2.0)
    d.observe(1, 1.0)
    d.observe(2, 1.0)
    assert d.fleet_ewma() == pytest.approx(1.0)   # median of {2,1,1}


def test_straggler_flagging_and_rebalance():
    d = StragglerDetector(alpha=1.0, factor=2.0)
    assert d.stragglers() == [] and d.rebalance_weights() == {}
    for h in range(3):
        d.observe(h, 1.0)
    d.observe(2, 5.0)                 # host 2 now 5x the fleet median
    assert d.stragglers() == [2]
    w = d.rebalance_weights()
    assert sum(w.values()) == pytest.approx(1.0)
    assert w[2] < w[0] == w[1]        # slow host gets the smallest share


def test_executor_retries_transient():
    calls = {"n": 0}

    def flaky(step):
        calls["n"] += 1
        if calls["n"] <= 2:
            raise TransientError("preempted")

    ex = ResilientExecutor(lambda s, *a: s + 1, max_retries=3,
                           failure_hook=flaky)
    out = ex.run_step(0, torch.tensor(41))
    assert int(out) == 42
    assert ex.retries_total == 2


def test_executor_restart_after_exhausted_retries():
    restored = {"n": 0}

    def always_fail_then_ok(step):
        if restored["n"] == 0:
            raise TransientError("dead host")

    def restore():
        restored["n"] += 1
        return torch.tensor(100)

    ex = ResilientExecutor(lambda s, *a: s + 1, max_retries=2,
                           restore_fn=restore,
                           failure_hook=always_fail_then_ok)
    out = ex.run_step(0, torch.tensor(0))
    assert int(out) == 101          # restarted from checkpointed state
    assert ex.restarts_total == 1


def test_straggler_detector_flags_the_slow_host():
    d = StragglerDetector(alpha=1.0, factor=2.0)
    for h in range(4):
        d.observe(h, 1.0)
    d.observe(3, 10.0)  # host 3 goes slow
    assert d.stragglers() == [3]
    w = d.rebalance_weights()
    assert w[3] < w[0]  # slow host gets less work


def test_heartbeat_beat_and_stale(tmp_path):
    hb = Heartbeat(str(tmp_path), host_id=0)
    hb.beat(7)
    assert hb.last()["step"] == 7
    assert not hb.stale(timeout_s=60)
    assert hb.stale(timeout_s=0)


# ----------------------------------------------------------------------
# the port's own
# ----------------------------------------------------------------------
@pytest.mark.parametrize("bad", [dict(max_retries=-1),
                                 dict(backoff_base_s=-1.0),
                                 dict(backoff_factor=0.5),
                                 dict(backoff_base_s=2.0, max_backoff_s=1.0)])
def test_policy_validation_refuses(bad):
    with pytest.raises(ValueError):
        ResilientExecutor(lambda s, *a: s, policy=RetryPolicy(**bad))


def test_policy_json_roundtrip_and_backoff_sleeps():
    p = RetryPolicy(max_retries=2, backoff_base_s=0.01, backoff_factor=3.0,
                    max_backoff_s=0.02, restart_on_exhaustion=False)
    assert RetryPolicy.from_json({**p.to_json(), "unknown": 1}) == p
    assert [p.delay_s(i) for i in (1, 2, 3)] == [0.01, 0.02, 0.02]
    calls = {"n": 0}

    def twice(step):
        calls["n"] += 1
        if calls["n"] <= 2:
            raise TransientError("blip")

    ex = ResilientExecutor(lambda s, *a: s, policy=p, failure_hook=twice)
    t0 = time.monotonic()
    assert ex.run_step(0, 5) == 5
    assert time.monotonic() - t0 >= 0.03 and ex.retries_total == 2


def test_executor_times_steps_and_beats(tmp_path):
    d = StragglerDetector(alpha=1.0)
    hb = Heartbeat(str(tmp_path))

    def slow(state, x):
        time.sleep(0.02)
        return {"s": state["s"] + x}, torch.ones(2)

    ex = ResilientExecutor(slow, detector=d, heartbeat=hb)
    out, m = ex.run_step(4, {"s": torch.zeros(2)}, torch.ones(2))
    assert torch.equal(out["s"], torch.ones(2))
    assert d.fleet_ewma() >= 0.02
    assert hb.last()["step"] == 4
