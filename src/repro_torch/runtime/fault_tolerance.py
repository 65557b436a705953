"""Fault tolerance: retrying executor, heartbeats, stragglers (the port
of ``repro.runtime.fault_tolerance``).

  * ``ResilientExecutor`` — wraps the train step: transient failures
    (preemption, a flaky host) are retried; persistent failures trigger
    checkpoint-restart via the caller's restore_fn, or hand the step's
    payload to a re-queue hook.  Injectable failure hooks make this
    testable.
  * heartbeat files — one per host per step; an external watchdog (or
    the test) can detect a wedged host by mtime.
  * ``StragglerDetector`` — EWMA of step wall-time; hosts slower than
    `factor`x the fleet EWMA are flagged for microbatch rebalancing /
    replacement.

  * ``elastic_restore`` — the latest checkpoint restored onto a
    different mesh of ranks (after losing a pod, restore onto fewer):
    checkpoints hold global arrays, so the parameters are placed by the
    rules of the new mesh and everything else replicated.
"""

from __future__ import annotations

import dataclasses
import json
import os
import time
from typing import Any, Callable

import torch

from repro_torch.runtime import sharding as shard_rules
from repro_torch.tree import leaves, tree_map

__all__ = ["ResilientExecutor", "StragglerDetector", "Heartbeat",
           "RetryPolicy", "TransientError", "elastic_restore"]


def _block_until_ready(out: Any) -> None:
    """Wait for the device work behind ``out``: synchronize every CUDA
    device a tensor leaf of ``out`` lives on (a CPU result is ready when
    it is returned)."""
    devices = {x.device for x in leaves(out)
               if isinstance(x, torch.Tensor) and x.is_cuda}
    for d in devices:
        torch.cuda.synchronize(d)


class TransientError(RuntimeError):
    """Failure class that is retried in place (preemption, link flap)."""


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Typed retry/backoff policy of a :class:`ResilientExecutor`.

    Exists as a first-class artifact so a serving replica's (plan,
    fault policy) pair can be checked statically —
    ``repro_torch.analyze.lint_plan(plan, policy=...)`` — before the
    replica takes traffic: an ill-formed backoff schedule or a restart policy
    over an empty auto plan (every restart re-tunes) is caught at
    deploy time, not mid-incident.

    ``max_retries`` in-place retries per step; between attempt ``i``
    and ``i+1`` the executor sleeps ``backoff_base_s *
    backoff_factor**(i-1)`` seconds, capped at ``max_backoff_s`` (the
    default base of 0 keeps historical immediate-retry behavior).
    When retries are exhausted, ``restart_on_exhaustion`` selects
    checkpoint-restart via the executor's ``restore_fn`` (else the
    failure propagates).
    """

    max_retries: int = 3
    backoff_base_s: float = 0.0
    backoff_factor: float = 2.0
    max_backoff_s: float = 30.0
    restart_on_exhaustion: bool = True

    def validate(self) -> None:
        if self.max_retries < 0:
            raise ValueError(f"max_retries must be >= 0, "
                             f"got {self.max_retries}")
        if self.backoff_base_s < 0.0:
            raise ValueError(f"backoff_base_s must be >= 0, "
                             f"got {self.backoff_base_s}")
        if self.backoff_factor < 1.0:
            raise ValueError(f"backoff_factor must be >= 1, "
                             f"got {self.backoff_factor}")
        if self.max_backoff_s < self.backoff_base_s:
            raise ValueError(
                f"max_backoff_s ({self.max_backoff_s}) must be >= "
                f"backoff_base_s ({self.backoff_base_s})")

    def delay_s(self, attempt: int) -> float:
        """Sleep before retry ``attempt`` (1-based)."""
        if self.backoff_base_s <= 0.0:
            return 0.0
        return min(self.backoff_base_s
                   * self.backoff_factor ** max(attempt - 1, 0),
                   self.max_backoff_s)

    def total_delay_s(self) -> float:
        """Worst-case total backoff a payload can accumulate before the
        policy gives up: the sum of every per-attempt delay.  The
        serving router's admission-to-failure latency bound —
        analyzer rule ZS-F004 requires this to stay below the
        request timeout, so a re-queued request can still finish."""
        return sum(self.delay_s(i) for i in range(1, self.max_retries + 1))

    def to_json(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_json(cls, d: dict) -> "RetryPolicy":
        known = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in known})


class Heartbeat:
    def __init__(self, directory: str, host_id: int = 0):
        self.path = os.path.join(directory, f"heartbeat_{host_id}.json")
        os.makedirs(directory, exist_ok=True)

    def beat(self, step: int) -> None:
        tmp = self.path + ".tmp"
        with open(tmp, "w") as f:
            json.dump({"step": step, "t": time.time()}, f)
        os.replace(tmp, self.path)

    def last(self) -> dict | None:
        try:
            with open(self.path) as f:
                return json.load(f)
        except FileNotFoundError:
            return None

    def stale(self, timeout_s: float) -> bool:
        hb = self.last()
        return hb is None or (time.time() - hb["t"]) > timeout_s


@dataclasses.dataclass
class StragglerDetector:
    """Per-host EWMA step-time tracking with a slowness factor flag."""
    alpha: float = 0.2
    factor: float = 2.0
    _ewma: dict[int, float] = dataclasses.field(default_factory=dict)

    def observe(self, host_id: int, step_time_s: float) -> None:
        prev = self._ewma.get(host_id)
        self._ewma[host_id] = (step_time_s if prev is None
                               else self.alpha * step_time_s
                               + (1 - self.alpha) * prev)

    def fleet_ewma(self) -> float:
        if not self._ewma:
            return 0.0
        vals = sorted(self._ewma.values())
        return vals[len(vals) // 2]  # median of per-host EWMAs

    def stragglers(self) -> list[int]:
        base = self.fleet_ewma()
        if base <= 0:
            return []
        return [h for h, v in self._ewma.items() if v > self.factor * base]

    def rebalance_weights(self) -> dict[int, float]:
        """Suggested relative microbatch share per host (inverse speed)."""
        if not self._ewma:
            return {}
        inv = {h: 1.0 / max(v, 1e-9) for h, v in self._ewma.items()}
        total = sum(inv.values())
        return {h: v / total for h, v in inv.items()}


class ResilientExecutor:
    """Run steps with retry + checkpoint-restart semantics.

    A step's time runs from its call to the end of its device work: the
    executor synchronizes each CUDA device the step's output lives on,
    as the JAX one blocks until the output is ready, so the straggler
    detector times the device and not the launches.

    Two recovery paths when in-place retries exhaust:

    * **restart** (training) — ``restore_fn`` + the policy's
      ``restart_on_exhaustion`` reload the latest checkpoint and keep
      stepping in place.
    * **re-queue** (serving) — ``requeue_fn`` hands the step's
      ``payload`` (whatever unit of work the caller threads through
      ``run_step(..., payload=...)``, e.g. a replica's in-flight
      requests) back to the caller *before* the failure propagates, so
      a higher-level scheduler can reassign the work to a survivor.
      The executor stays generic: it never inspects the payload.
    """

    def __init__(self, step_fn: Callable, *, max_retries: int = 3,
                 policy: RetryPolicy | None = None,
                 restore_fn: Callable[[], Any] | None = None,
                 heartbeat: Heartbeat | None = None,
                 detector: StragglerDetector | None = None,
                 host_id: int = 0,
                 failure_hook: Callable[[int], None] | None = None,
                 requeue_fn: Callable[[Any], None] | None = None):
        if policy is None:
            policy = RetryPolicy(max_retries=max_retries)
        policy.validate()
        self.policy = policy
        self.step_fn = step_fn
        self.max_retries = policy.max_retries
        self.restore_fn = restore_fn
        self.heartbeat = heartbeat
        self.detector = detector
        self.host_id = host_id
        self.failure_hook = failure_hook  # test injection point
        self.requeue_fn = requeue_fn      # exhaustion re-queue hook
        self.retries_total = 0
        self.restarts_total = 0
        self.exhausted_total = 0

    def run_step(self, step: int, state, *args, payload: Any = None):
        attempt = 0
        while True:
            try:
                if self.failure_hook is not None:
                    self.failure_hook(step)   # may raise TransientError
                t0 = time.monotonic()
                out = self.step_fn(state, *args)
                _block_until_ready(out)
                dt = time.monotonic() - t0
                if self.detector is not None:
                    self.detector.observe(self.host_id, dt)
                if self.heartbeat is not None:
                    self.heartbeat.beat(step)
                return out
            except TransientError:
                attempt += 1
                self.retries_total += 1
                if attempt <= self.max_retries:
                    delay = self.policy.delay_s(attempt)
                    if delay > 0.0:
                        time.sleep(delay)
                    continue
                if self.restore_fn is not None and \
                        self.policy.restart_on_exhaustion:
                    state = self.restore_fn()   # checkpoint restart
                    self.restarts_total += 1
                    attempt = 0
                    continue
                # exhausted with no restart path: hand the payload back
                # to the caller (serving re-queue), then propagate
                self.exhausted_total += 1
                if self.requeue_fn is not None:
                    self.requeue_fn(payload)
                raise


def elastic_restore(ckpt, template_state: Any, new_mesh, *,
                    params_path: str = "params") -> tuple[Any, int]:
    """Restore the latest checkpoint of ``ckpt`` (a
    :class:`~repro_torch.checkpoint.Checkpointer`) onto ``new_mesh``, a
    mesh over the ranks of the current world: ``template_state`` holds
    the logical (global) shapes, the ``params_path`` subtree is placed by
    the parameter rules of ``new_mesh`` and every other leaf replicated.
    Returns (state, step)."""
    from repro_torch.runtime.ranks import device_mesh
    shardings = tree_map(lambda _: shard_rules.replicated(new_mesh),
                         template_state)
    if isinstance(template_state, dict) and params_path in template_state:
        shardings = dict(shardings)
        shardings[params_path] = shard_rules.param_shardings(
            new_mesh, template_state[params_path])
    return ckpt.restore(template_state, shardings=shardings,
                        device_mesh=device_mesh(new_mesh))
