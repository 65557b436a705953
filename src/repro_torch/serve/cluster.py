"""Sharded decode and a data-parallel replica router with fault-tolerant
re-queue (the port of ``repro.serve.cluster``).

The engine (:mod:`repro_torch.serve.engine`) keeps one slot pool's
decode batch full; this module keeps a *fleet* full.  Two independent
layers:

**Sharded decode** (:class:`ShardedEngine`): one engine whose params and
KV cache are laid out over a device mesh by the sharding rules
(:func:`repro_torch.runtime.sharding.param_shardings` /
:func:`~repro_torch.runtime.sharding.cache_shardings`).  On a one-device
mesh it computes and keeps the specs, places params and cache on the
mesh's device and serves exactly as :class:`ServeEngine` does, so its
tokens are the plain engine's.  Over a mesh of ranks
(:func:`repro_torch.runtime.ranks.init_ranks`, one process a rank, where
JAX runs one process over its devices) the params and cache are placed
as DTensors by the specs (:func:`~repro_torch.runtime.sharding.place`,
JAX's ``device_put``) and ``ctx`` carries the mesh, so the model's
activation constraints engage; every rank runs the same host control
flow on logits gathered whole, so every rank admits, samples and
retires alike.

**Replica router** (:class:`Router`): N data-parallel engine replicas
(in-process) behind one submit/step/run surface.

* *Load-aware admission*: each request goes to the replica with the most
  net free capacity (``free_slots - queue_depth``), ties broken by the
  lowest page-pool occupancy, then the lowest replica id.
* *Determinism regardless of placement*: a request's default sample
  chain is ``fold_in(PRNGKey(engine.seed), rid)`` (the engine's
  contract), so equal-seed replicas produce the same tokens wherever a
  request lands; the router requires equal seeds at construction and
  ``Router(validate=True)`` also requires every replica to run the same
  plan (``Plan.fingerprint()``, rule ZS-L009: kernel configs select
  reduction orders).  On the card no kernel reads which rows are live:
  the paged-attention split count reads the shapes only and the matmul's
  split-k partials sum in split order, so a replayed request's tokens do
  not depend on its co-tenants.
* *Fault path*: a replica is marked dead when its step exceeds
  ``step_timeout_s`` (:class:`ReplicaTimeout`), when its in-place
  transient retries run out (the
  :class:`~repro_torch.runtime.fault_tolerance.ResilientExecutor`
  re-queue hook), or when its heartbeat goes stale.  Its in-flight
  requests re-queue onto survivors, at the front of the queue, in
  admission order, under the fleet :class:`RetryPolicy` (a per-request
  attempt budget and backoff; rule ZS-F004 bounds the worst-case total
  backoff below the request timeout).
* *At-most-once token emission*: the router records every token it has
  streamed a request; a re-queued request *replays* its streamed prefix
  on the survivor (the same tokens, by the determinism contract; checked,
  a mismatch raises) without emitting it again, so ``on_token``
  consumers see no duplicate and no gap.

Backoff fast-forward: when every alive replica is idle and every queued
request is still held by its backoff, the delays are cleared and
admission proceeds at once (backoff protects a busy fleet; it must not
stall an idle one or a fake-clock test).

:class:`ReplicaTimeout` is not a
:class:`~repro_torch.runtime.fault_tolerance.TransientError`: a timed-out
step has already advanced the engine (its events exist but are
discarded), so an in-place retry would lose those tokens.  The router
kills the replica and replays the request instead, which regenerates the
lost suffix exactly.

A dead replica's engine, with its cache and its CUDA graphs, stays
allocated as long as the router holds it.
"""

from __future__ import annotations

import collections
import dataclasses
from typing import Callable, Sequence

import torch.distributed as dist

import torch

from repro_torch import obs
from repro_torch.quant.tensor import QTensor
from repro_torch.runtime import sharding as shard_rules
from repro_torch.runtime.fault_tolerance import (Heartbeat, ResilientExecutor,
                                                 RetryPolicy)
from repro_torch.runtime.ranks import device_mesh
from repro_torch.serve import engine as engine_mod
from repro_torch.serve.engine import ServeEngine
from repro_torch.serve.request import GenerationResult, Request
from repro_torch.serve.stats import EngineStats
from repro_torch.tree import leaves

__all__ = ["Router", "ShardedEngine", "ReplicaTimeout", "RequeueExhausted",
           "Replica", "place_in_turn"]


class ReplicaTimeout(RuntimeError):
    """A replica's engine step exceeded its wall-clock budget.

    A plain ``RuntimeError``, never retried in place (module docstring):
    the step already changed the engine, so only kill-and-replay keeps
    the token stream whole.
    """


class RequeueExhausted(RuntimeError):
    """A request died with its replica more times than the fleet
    :class:`RetryPolicy` allows.  Fatal for the run, never treated as one
    more replica failure (that would drop the request)."""


@dataclasses.dataclass
class _RoutedRequest:
    """Router-side lifecycle state of one request."""
    request: Request
    attempts: int = 0        # completed re-queues (0: first life)
    not_before: float = 0.0  # earliest re-admission clock (backoff)


@dataclasses.dataclass
class Replica:
    """One engine replica plus its fault-tolerance wrapper."""
    rid: int
    engine: ServeEngine
    executor: ResilientExecutor
    alive: bool = True
    # rid -> routed request, in admission order (the order re-queue
    # replays on death)
    inflight: dict[int, _RoutedRequest] = dataclasses.field(
        default_factory=dict)


def _place(tree, device: torch.device):
    """``tree`` (dicts, lists, tuples; tensor and QTensor leaves) with
    every tensor on ``device`` (a tensor already there is kept as it is,
    so a K-major view keeps its layout)."""
    if isinstance(tree, dict):
        return {k: _place(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_place(v, device) for v in tree)
    if isinstance(tree, QTensor):
        return QTensor(_place(tree.data, device), _place(tree.scale, device),
                       tree.fmt, tree.w8a8)
    return tree if tree.device == device else tree.to(device)


def place_in_turn(make, mesh):
    """The params tree ``make()`` returns, placed across the ranks of
    ``mesh`` by the parameter rules: each rank in turn draws the global
    tree, keeps its shards and frees the rest, and the ranks wait for one
    another at a barrier, so that ranks sharing one card never hold more
    than one global tree at once.  ``make`` must draw the same tree on
    every rank (a seeded init)."""
    dm = device_mesh(mesh)
    placed = None
    for r in range(mesh.size):
        if dist.get_rank() == r:
            tree = make()
            placed = shard_rules.place(
                tree, shard_rules.param_shardings(mesh, tree), dm)
            del tree
            if mesh.device.type == "cuda":
                torch.cuda.empty_cache()
        dist.barrier()
    return placed


def _gathered(fn):
    """A model entry point run across ranks (``sharding.across_ranks``):
    plain operands (tokens, lengths, positions, a request's frontend
    embeddings) take part as replicated, an operation DTensor cannot plan
    runs replicated and counted (``ReplicateOnGap``), and the logits come
    back whole on every rank, so every rank samples the same tokens."""
    def call(*args, **kwargs):
        with shard_rules.across_ranks():
            logits, cache = fn(*args, **kwargs)
        return shard_rules.unplace(logits), cache
    return call


class ShardedEngine(ServeEngine):
    """A :class:`ServeEngine` over a device mesh (module docstring).

    ``param_specs`` and ``cache_specs`` hold the sharding rules' specs of
    the params (the port's per-layer tree) and of the cache over
    ``mesh``.  Scope: the contiguous per-slot cache only; the paged
    pool's ``(num_pages, page_size, ...)`` leaves are outside
    ``cache_shardings``' shape vocabulary, so ``page_size`` is refused,
    as in the JAX package.

    Over a mesh of ranks ``params`` is the global tree (every rank's
    alike; each keeps its shards) or one already placed
    (:func:`place_in_turn`).  Every family serves across ranks, in bf16,
    fp32 and W8A8 (a QTensor's codes and scales placed by the rules'
    children 0 and 1), the cache of each placed by ``cache_shardings``
    and written slot by slot on each leaf's batch axis
    (``sharding.write_slot``).  Neither a decode block nor a prefill is
    captured in a CUDA graph across ranks (``captures`` stays empty): a
    graph cannot capture the host side of a gloo collective, and ranks
    sharing a card run gloo."""

    def __init__(self, model, params, ctx, *, mesh, **kwargs):
        if kwargs.get("page_size") is not None:
            raise ValueError(
                "ShardedEngine does not support page_size: the page "
                "pool's (num_pages, page_size, ...) layout is outside "
                "cache_shardings' shape vocabulary")
        if kwargs.get("device") is not None:
            raise ValueError("ShardedEngine runs on its mesh's device; "
                             "pass no device")
        self.mesh = mesh
        if mesh.size == 1:
            device = torch.device(mesh.devices.flat[0])
            self.param_specs = shard_rules.param_shardings(mesh, params)
            super().__init__(model, _place(params, device), ctx,
                             device=device, **kwargs)
            self.cache_specs = shard_rules.cache_shardings(mesh, self.cache)
            return
        if mesh.ranks is None:
            raise NotImplementedError(
                f"ShardedEngine over {mesh!r}: the port runs a mesh of "
                f"more than one device as one process a rank; call "
                f"runtime.ranks.init_ranks() first (e.g. under torchrun)")
        dm = device_mesh(mesh)
        if not any(shard_rules.is_dtensor(x) for x in leaves(params)):
            params = shard_rules.place(
                params, shard_rules.param_shardings(mesh, params), dm)
        self.param_specs = shard_rules.param_shardings(mesh, params)
        model = dataclasses.replace(model, prefill=_gathered(model.prefill),
                                    decode=_gathered(model.decode))
        ctx = dataclasses.replace(ctx, mesh=mesh)
        super().__init__(model, params, ctx, device=mesh.device, **kwargs)
        self.cache_specs = shard_rules.cache_shardings(mesh, self.cache)
        # pos stays a plain tensor, alike on every rank (replicated)
        self.cache = {**shard_rules.place(
            {k: v for k, v in self.cache.items() if k != "pos"},
            {k: v for k, v in self.cache_specs.items() if k != "pos"}, dm),
            "pos": self.cache["pos"]}

    def _capture(self, greedy_only: bool) -> None:
        if self.mesh.size == 1:
            super()._capture(greedy_only)
        # across ranks every dispatch runs the block eagerly (class
        # docstring)

    def _capture_prefill(self, key: tuple) -> None:
        if self.mesh.size == 1:
            super()._capture_prefill(key)
        # across ranks every prefill and chunk runs eagerly

    def _prefill_cache(self) -> dict | None:
        # across ranks, where nothing is captured, a prefill returns a
        # fresh cache (the SSM states come back placed, as the install
        # takes them)
        return super()._prefill_cache() if self.mesh.size == 1 else None

    def _install(self, req, slot: int, cache1, n_prompt: int) -> None:
        if self.mesh.size == 1:
            return super()._install(req, slot, cache1, n_prompt)
        for name, bax in self._axes.items():
            shard_rules.write_slot(self.cache[name], cache1[name], bax, slot)
        self.cache["pos"][slot] = cache1["pos"][0]


class Router:
    """Front N in-process engine replicas (see the module docstring).

    Parameters
    ----------
    engines : the replica engines, distinct instances sharing ``seed``
        and ``eos_id`` (the placement-independence contract); each gets
        its ``stats.replica_id`` stamped.  Each runs on its own engine's
        device.
    policy : fleet :class:`RetryPolicy`, for both a replica executor's
        in-place transient retries and the router's per-request re-queue
        budget and backoff.  Default: ``RetryPolicy(restart_on_exhaustion
        =False)`` (there is no checkpoint to restart a serving replica
        from).
    validate : run :func:`repro_torch.analyze.lint_cluster` over the
        replica plans and the (policy, request timeout) pair: divergent
        plan fingerprints (ZS-L009) or an unbounded re-queue backoff
        (ZS-F004) raise ``ValueError`` before any request is admitted.
    request_timeout_s : the deadline ZS-F004 checks the policy's
        worst-case total backoff against (validation only).
    step_timeout_s : per-replica step budget; a step exceeding it raises
        :class:`ReplicaTimeout`, which kills the replica and re-queues its
        requests.  It reads the engine's slowest admission prefill or
        decode dispatch of the step, so set it well above a variant's
        first dispatch on the card, which runs eagerly and captures the
        CUDA graph.
    heartbeat_dir / heartbeat_timeout_s : when set, each replica's
        executor writes a heartbeat file after every successful step and
        the router marks a replica dead when its heartbeat (with work in
        flight) goes stale.
    """

    def __init__(self, engines: Sequence[ServeEngine], *,
                 policy: RetryPolicy | None = None,
                 validate: bool = False,
                 request_timeout_s: float | None = None,
                 step_timeout_s: float | None = None,
                 heartbeat_dir: str | None = None,
                 heartbeat_timeout_s: float | None = None):
        engines = list(engines)
        if not engines:
            raise ValueError("Router needs at least one replica engine")
        if len({id(e) for e in engines}) != len(engines):
            raise ValueError("each replica needs its own engine instance")
        if len({e.seed for e in engines}) > 1 \
                or len({e.eos_id for e in engines}) > 1:
            raise ValueError(
                "replica engines must share seed and eos_id: a request's "
                "default sample chain is fold_in(PRNGKey(engine.seed), "
                "rid), so unequal seeds make tokens placement-dependent")
        if policy is None:
            policy = RetryPolicy(restart_on_exhaustion=False)
        policy.validate()
        self.policy = policy
        self.step_timeout_s = step_timeout_s
        self.request_timeout_s = request_timeout_s
        self.heartbeat_timeout_s = heartbeat_timeout_s

        self.replicas: list[Replica] = []
        for i, eng in enumerate(engines):
            eng.stats.replica_id = i
            rep = Replica(rid=i, engine=eng, executor=None)  # type: ignore
            rep.executor = ResilientExecutor(
                self._checked_step(rep), policy=policy,
                heartbeat=(Heartbeat(heartbeat_dir, host_id=i)
                           if heartbeat_dir is not None else None),
                host_id=i, requeue_fn=self._on_exhausted)
            self.replicas.append(rep)

        if validate:
            self._validate_cluster()

        self._queue: collections.deque[_RoutedRequest] = collections.deque()
        self._results: dict[int, GenerationResult] = {}
        self._live: set[int] = set()        # submitted, result not yet out
        self._tokens: dict[int, list[int]] = {}   # rid -> emitted history
        self._life_pos: dict[int, int] = {}  # rid -> cursor in this life
        self._steps = 0
        self.deaths = 0
        self.requeues = 0

    # ------------------------------------------------------------------
    def _validate_cluster(self) -> None:
        from repro_torch.analyze import lint_cluster
        report = lint_cluster(
            [rep.engine.plan for rep in self.replicas],
            policy=self.policy, request_timeout_s=self.request_timeout_s)
        if report.errors:
            raise ValueError(
                "Router(validate=True): cluster configuration failed "
                "static analysis:\n"
                + "\n".join(d.format() for d in report.errors))

    # ------------------------------------------------------------------
    def _checked_step(self, rep: Replica) -> Callable:
        """The replica's executor step_fn: one engine step under the
        step-timeout budget.  A timeout discards the step's events on
        purpose: replay regenerates them (module docstring)."""
        def step_fn(_state):
            events = rep.engine.step()
            if self.step_timeout_s is not None:
                worst = max(rep.engine._last_prefill_s,
                            rep.engine._last_dispatch_s)
                if worst > self.step_timeout_s:
                    raise ReplicaTimeout(
                        f"replica {rep.rid}: step took {worst:.3f}s "
                        f"(> step_timeout_s={self.step_timeout_s})")
            return events
        return step_fn

    def _on_exhausted(self, rep: Replica) -> None:
        """ResilientExecutor re-queue hook: in-place retries exhausted
        with no restart path; the replica fails and its in-flight
        requests re-queue before the error propagates."""
        self._mark_dead(rep, reason="retries exhausted")

    def _mark_dead(self, rep: Replica, *, reason: str) -> None:
        if not rep.alive:
            return
        rep.alive = False
        self.deaths += 1
        obs.event("cluster.replica_dead", replica=rep.rid, reason=reason,
                  inflight=len(rep.inflight))
        # re-queue ahead of newer pending work, in admission order
        # (appendleft over the reversed list)
        for rr in reversed(list(rep.inflight.values())):
            self._requeue(rr)
        rep.inflight.clear()

    def _requeue(self, rr: _RoutedRequest) -> None:
        rr.attempts += 1
        if rr.attempts > self.policy.max_retries:
            raise RequeueExhausted(
                f"request {rr.request.rid}: re-queue budget exhausted "
                f"({rr.attempts - 1} replays under RetryPolicy("
                f"max_retries={self.policy.max_retries}))")
        rr.not_before = engine_mod._now() + self.policy.delay_s(rr.attempts)
        self._life_pos[rr.request.rid] = 0    # replay from the start
        self.requeues += 1
        self._queue.appendleft(rr)
        obs.event("cluster.requeue", rid=rr.request.rid,
                  attempt=rr.attempts)

    # ------------------------------------------------------------------
    def submit(self, request: Request) -> None:
        """Queue a request for placement at the next step."""
        if request.rid in self._live or request.rid in self._results:
            raise ValueError(f"duplicate request id {request.rid}")
        self._live.add(request.rid)
        self._queue.append(_RoutedRequest(request))

    def kill(self, replica: int) -> None:
        """Fail a replica on purpose (tests, the launcher's fault
        injection): marked dead, its in-flight requests re-queued onto
        the survivors."""
        self._mark_dead(self.replicas[replica], reason="killed")

    @property
    def idle(self) -> bool:
        return (not self._queue
                and all(not rep.inflight for rep in self.replicas))

    @property
    def results(self) -> dict[int, GenerationResult]:
        """Finished results so far (for manual steppers; :meth:`run`
        returns the same mapping)."""
        return dict(self._results)

    # ------------------------------------------------------------------
    def _placement_key(self, rep: Replica):
        """max() key: the emptiest pool first: net free capacity, then
        fewest pages in use, then lowest replica id."""
        eng = rep.engine
        return (eng.free_slots - eng.queue_depth,
                -eng.pages_in_use_now, -rep.rid)

    def _dispatch_pending(self) -> None:
        alive = [rep for rep in self.replicas if rep.alive]
        if not alive or not self._queue:
            return
        now = engine_mod._now()
        if all(rep.engine.idle for rep in alive) \
                and all(rr.not_before > now for rr in self._queue):
            # backoff fast-forward (module docstring)
            for rr in self._queue:
                rr.not_before = now
        held: collections.deque[_RoutedRequest] = collections.deque()
        while self._queue:
            rr = self._queue.popleft()
            if rr.not_before > now:
                held.append(rr)
                continue
            rep = max(alive, key=self._placement_key)
            rep.engine.submit(rr.request)
            rep.inflight[rr.request.rid] = rr
            obs.event("cluster.place", rid=rr.request.rid,
                      replica=rep.rid, attempt=rr.attempts)
        self._queue = held

    # ------------------------------------------------------------------
    def _filter_events(self, rep: Replica,
                       events: list[tuple[int, int]]
                       ) -> list[tuple[int, int]]:
        """At-most-once emission: pass new tokens through; suppress a
        re-queued request's replayed prefix after checking that it
        matches what was already streamed."""
        out: list[tuple[int, int]] = []
        for rid, tok in events:
            hist = self._tokens.setdefault(rid, [])
            pos = self._life_pos.get(rid, 0)
            if pos < len(hist):
                if hist[pos] != tok:
                    raise RuntimeError(
                        f"request {rid}: replica {rep.rid} replayed "
                        f"token {tok} at position {pos} where the first "
                        f"emission produced {hist[pos]} — the "
                        f"placement-determinism contract is broken")
            else:
                hist.append(tok)
                out.append((rid, tok))
            self._life_pos[rid] = pos + 1
        return out

    def _collect_results(self, rep: Replica) -> None:
        for rid, res in rep.engine.pop_results().items():
            rep.inflight.pop(rid, None)
            res.replica = rep.rid
            self._tokens.pop(rid, None)
            self._life_pos.pop(rid, None)
            self._live.discard(rid)
            self._results[rid] = res

    # ------------------------------------------------------------------
    def step(self) -> list[tuple[int, int]]:
        """One fleet step: heartbeat checks, placement, then one engine
        step a live, non-idle replica.  Returns the streamed (rid, token)
        events (deduplicated) in emission order."""
        self._steps += 1
        self._check_heartbeats()
        alive = [rep for rep in self.replicas if rep.alive]
        if not alive:
            if self._queue:
                raise RuntimeError(
                    f"no alive replicas remain; {len(self._queue)} "
                    f"request(s) outstanding")
            return []
        self._dispatch_pending()
        events: list[tuple[int, int]] = []
        for rep in alive:
            if not rep.alive or rep.engine.idle:
                continue
            try:
                evs = rep.executor.run_step(self._steps, None, payload=rep)
            except RequeueExhausted:
                raise          # fatal: a request is out of budget
            except Exception as e:
                # _on_exhausted already ran for exhausted transients;
                # ReplicaTimeout and everything else lands here
                self._mark_dead(rep, reason=repr(e))
                continue
            events.extend(self._filter_events(rep, evs))
            self._collect_results(rep)
        return events

    def _check_heartbeats(self) -> None:
        if self.heartbeat_timeout_s is None:
            return
        for rep in self.replicas:
            hb = rep.executor.heartbeat
            # a replica that never beat yet is starting, not stale: only
            # a lost heartbeat with work at risk kills it
            if (rep.alive and rep.inflight and hb is not None
                    and hb.last() is not None
                    and hb.stale(self.heartbeat_timeout_s)):
                self._mark_dead(rep, reason="heartbeat lost")

    # ------------------------------------------------------------------
    def run(self, requests: Sequence[Request] = (), *,
            on_token: Callable[[int, int], None] | None = None
            ) -> dict[int, GenerationResult]:
        """Drive the fleet until every submitted request has finished (or
        raise: no survivors left, or a request's re-queue budget
        exhausted)."""
        for r in requests:
            self.submit(r)
        while not self.idle:
            for rid, tok in self.step():
                if on_token is not None:
                    on_token(rid, tok)
        return dict(self._results)

    # ------------------------------------------------------------------
    def stats(self) -> EngineStats:
        """Fleet-aggregate :class:`EngineStats` (:meth:`EngineStats.merge`
        over the replicas)."""
        return EngineStats.merge([rep.engine.stats
                                  for rep in self.replicas])

    def snapshot(self) -> dict:
        """Fleet snapshot: the merged stats, per-replica snapshots, and
        the router's own lifecycle counters."""
        out = self.stats().snapshot()
        out["per_replica"] = [rep.engine.stats.snapshot()
                              for rep in self.replicas]
        out["router"] = {
            "replicas": len(self.replicas),
            "alive": sum(1 for rep in self.replicas if rep.alive),
            "deaths": self.deaths,
            "requeues": self.requeues,
            "steps": self._steps,
        }
        return out
