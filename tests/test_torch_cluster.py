"""The port's cluster serving (``repro_torch.serve.cluster``) against the
JAX package's.

``Router`` fronts N equal-seed engine replicas and must produce exactly
the tokens one engine produces, greedy and seeded-sampled, at K = 1 and
4: for reduced gemma-7b and olmoe-1b-7b against JAX's ``Router`` on the
same converted weights, for mamba2, zamba2 and seamless against the
port's single engine.  A replica dying mid-stream (the kill API, a step
timeout on a fake clock, a lost heartbeat) re-queues its work onto the
survivors, which replay it token for token with no duplicate and no gap
in the stream; the re-queue budget, no survivors and the construction
refusals raise JAX's exception types with JAX's messages, and the
``cluster.*`` events carry JAX's fields.  ``ShardedEngine`` on a
one-device mesh gives the plain engine's tokens, keeps the sharding
rules' specs, refuses a paged cache as JAX does and refuses a mesh of
more than one device.  ``serve_batch(replicas=3, kill_replica=0,
mesh="1x1")`` gives JAX's generated tokens and cluster counts.  The test
marked ``gpu`` routes on the card and skips without one.
"""

import dataclasses
import functools
import json
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.launch import serve as j_serve
from repro.models import Ctx as JCtx
from repro.models import build_model as j_build_model
from repro.plan import Plan as JPlan
from repro.runtime.fault_tolerance import RetryPolicy as JRetryPolicy
from repro.serve import Request as JRequest
from repro.serve import Router as JRouter
from repro.serve import ServeEngine as JServeEngine
from repro.serve.cluster import RequeueExhausted as JRequeueExhausted
from repro_torch import obs
from repro_torch.configs import get_config
from repro_torch.interop import params_from_numpy
from repro_torch.kernels import launches
from repro_torch.launch import serve as port_serve
from repro_torch.launch.mesh import Mesh, make_mesh_compat
from repro_torch.models import Ctx, build_model
from repro_torch.plan import Plan
from repro_torch.runtime import sharding
from repro_torch.runtime.fault_tolerance import RetryPolicy, TransientError
from repro_torch.serve import (ReplicaTimeout, RequeueExhausted, Request,
                               Router, ServeEngine, ShardedEngine)
from repro_torch.serve import engine as engine_mod
from torch_tune_cache import port_tune_cache  # noqa: F401 (autouse)

CTX = Ctx(plan="auto", dtype=torch.float32)
J_CTX = JCtx(plan="jnp", dtype=jnp.float32)
ENC_LEN = 12  # encdec source frames a request
# the families whose Router is held against JAX's Router; the others
# against the port's single engine
AGAINST_JAX = ("gemma-7b", "olmoe-1b-7b")


@functools.lru_cache(maxsize=None)
def _pair(arch):
    """(JAX model, JAX params, port model, the port's converted params)."""
    jm = j_build_model(j_get_config(arch, reduced=True))
    jp = jm.init(jax.random.PRNGKey(0), dtype=jnp.float32)
    m = build_model(get_config(arch, reduced=True))
    return jm, jp, m, params_from_numpy(jax.tree.map(np.asarray, jp),
                                        m.cfg, device="cpu")


@functools.lru_cache(maxsize=None)
def _port(arch):
    """(port model, params drawn by the port from seed 0) on the CPU."""
    m = build_model(get_config(arch, reduced=True))
    return m, m.init(seed=0, dtype=torch.float32, device="cpu")


def _prompts(vocab, lens):
    return [list(np.random.default_rng(i).integers(0, vocab, n))
            for i, n in enumerate(lens)]


def _requests(cfg, lens, max_new, frames=None, cls=Request):
    """Mixed trace, as JAX's test: even rids greedy, odd rids sampled (rid
    3 with its own seed, the rest on the engine's fold_in(seed, rid)
    chain)."""
    reqs = []
    for i, (p, n) in enumerate(zip(_prompts(cfg.vocab_size, lens),
                                   max_new)):
        kw = {}
        if i % 2:
            kw = dict(temperature=0.8, top_k=8, top_p=0.9)
            if i == 3:
                kw["seed"] = 123
        if frames is not None:
            kw["frontend_embeds"] = frames[i]
        reqs.append(cls(rid=i, prompt=p, max_new_tokens=n, **kw))
    return reqs


def _engine_kw(cfg):
    """(engine kwargs, request frames) of a family.  MoE routing is
    batch-global, so parity needs the same batch composition: one slot
    an engine makes every batch a single request on both sides."""
    ekw = {"num_slots": 1 if cfg.family == "moe" else 2, "max_len": 32}
    frames = None
    if cfg.family == "encdec":
        ekw["cache_kwargs"] = {"enc_len": ENC_LEN}
        frames = (np.random.default_rng(7).standard_normal(
            (6, ENC_LEN, cfg.d_model)) * 0.1).astype(np.float32)
    return ekw, frames


def _engines(m, params, n, **kw):
    kw.setdefault("num_slots", 2)
    kw.setdefault("max_len", 32)
    return [ServeEngine(m, params, CTX, device="cpu", **kw)
            for _ in range(n)]


def _stream_checker():
    streamed = {}

    def on_token(rid, tok):
        streamed.setdefault(rid, []).append(tok)
    return streamed, on_token


def _same_error(port_fn, jax_fn, port_exc, jax_exc, match=None):
    """Both raise; the exception types carry the same name and, unless
    ``match`` is given (the messages hold framework-specific parts),
    the messages are equal."""
    with pytest.raises(port_exc) as got:
        port_fn()
    with pytest.raises(jax_exc) as want:
        jax_fn()
    assert type(got.value).__name__ == type(want.value).__name__
    if match is None:
        assert str(got.value) == str(want.value)
    else:
        assert match in str(got.value) and match in str(want.value)


# ----------------------------------------------------------------------
# five-family parity: N replicas == one engine
# ----------------------------------------------------------------------
@pytest.mark.parametrize("K", [1, 4])
@pytest.mark.parametrize("arch", ["gemma-7b", "olmoe-1b-7b", "mamba2-130m",
                                  "zamba2-2.7b", "seamless-m4t-large-v2"])
def test_router_matches_single_engine(arch, K):
    lens, max_new = (5, 11, 3, 8, 6, 9), (6, 3, 5, 7, 4, 6)
    if arch in AGAINST_JAX:
        jm, jp, m, params = _pair(arch)
    else:
        m, params = _port(arch)
    ekw, frames = _engine_kw(m.cfg)
    router = Router(_engines(m, params, 3, steps_per_dispatch=K, **ekw))
    streamed, on_token = _stream_checker()
    results = router.run(_requests(m.cfg, lens, max_new, frames),
                         on_token=on_token)
    if arch in AGAINST_JAX:
        want = JRouter([JServeEngine(jm, jp, J_CTX, steps_per_dispatch=K,
                                     **ekw) for _ in range(2)]).run(
            _requests(m.cfg, lens, max_new, frames, cls=JRequest))
    else:
        want = ServeEngine(m, params, CTX, device="cpu",
                           steps_per_dispatch=K, **ekw).run(
            _requests(m.cfg, lens, max_new, frames))
    for i in range(6):
        assert results[i].tokens == want[i].tokens, (
            f"request {i} placement-dependent: {results[i].tokens} != "
            f"{want[i].tokens}")
        assert streamed[i] == results[i].tokens   # no duplicate, no gap
    assert len({results[i].replica for i in range(6)}) > 1
    snap = router.snapshot()
    assert [p["replica_id"] for p in snap["per_replica"]] == [0, 1, 2]
    fleet = router.stats()
    assert fleet.admitted == fleet.retired == 6 and fleet.replica_id is None
    assert fleet.admitted == sum(p["admitted"] for p in snap["per_replica"])
    assert snap["router"]["deaths"] == 0 and snap["router"]["requeues"] == 0


# ----------------------------------------------------------------------
# load-aware placement
# ----------------------------------------------------------------------
def test_placement_fills_emptiest_pool_first():
    m, params = _port("gemma-7b")
    router = Router(_engines(m, params, 3))
    results = router.run(_requests(m.cfg, (5,) * 6, [4] * 6))
    # 6 equal requests over 3 x 2 slots: round robin, two a replica,
    # and the first request of a fresh fleet lands on replica 0
    assert sorted(results[i].replica for i in range(6)) == [0, 0, 1, 1, 2, 2]
    assert results[0].replica == 0


def test_placement_breaks_slot_ties_by_page_occupancy():
    m, params = _port("gemma-7b")
    prompts = _prompts(m.cfg.vocab_size, (8, 8))
    engines = _engines(m, params, 2, page_size=4)
    router = Router(engines)
    # warm replica 0's prefix cache: the retired request's pages stay
    # held by the cache, so its pool reads busier at equal slots
    engines[0].run([Request(rid=90, prompt=prompts[0], max_new_tokens=2)])
    assert engines[0].pages_in_use_now > 0
    assert engines[0].free_slots == engines[1].free_slots
    router.submit(Request(rid=0, prompt=prompts[1], max_new_tokens=8))
    router.step()
    assert not router.replicas[0].inflight
    assert 0 in router.replicas[1].inflight


# ----------------------------------------------------------------------
# fault paths: kill, step timeout, heartbeat loss
# ----------------------------------------------------------------------
def _drive(router, reqs, fault_at, fault):
    """Step the router by hand, calling ``fault`` after step
    ``fault_at``; returns (results, streamed)."""
    for r in reqs:
        router.submit(r)
    streamed, on_token = _stream_checker()
    steps = 0
    while not router.idle:
        for rid, tok in router.step():
            on_token(rid, tok)
        steps += 1
        if steps == fault_at:
            fault()
    return router.results, streamed


def _cluster_events(records):
    return [{k: v for k, v in r.items() if k != "t"} for r in records
            if r["name"].startswith("cluster.")]


def test_kill_midstream_replays_without_duplicates():
    """Against JAX's Router on the same weights and the same kill: equal
    tokens, counts and ``cluster.*`` events (names and fields)."""
    jm, jp, m, params = _pair("gemma-7b")
    lens, max_new = (5, 11, 3, 8), (8, 8, 8, 8)
    router = Router(_engines(m, params, 2))
    with obs.capture() as sink:
        results, streamed = _drive(router,
                                   _requests(m.cfg, lens, max_new), 2,
                                   lambda: router.kill(0))
    jrouter = JRouter([JServeEngine(jm, jp, J_CTX, num_slots=2, max_len=32)
                       for _ in range(2)])
    from repro import obs as jobs
    with jobs.capture() as jsink:
        want, _ = _drive(jrouter, _requests(m.cfg, lens, max_new,
                                            cls=JRequest), 2,
                         lambda: jrouter.kill(0))
    for i in range(4):
        assert results[i].tokens == want[i].tokens
        assert streamed[i] == results[i].tokens
        assert results[i].replica == want[i].replica == 1
    assert router.deaths == jrouter.deaths == 1
    assert router.requeues == jrouter.requeues == 2   # replica 0's slots
    assert router.snapshot()["router"] == jrouter.snapshot()["router"]
    got = _cluster_events(sink.records)
    assert got == _cluster_events(jsink.records)
    assert {e["name"] for e in got} == {"cluster.place", "cluster.requeue",
                                        "cluster.replica_dead"}


def test_step_timeout_kills_and_replays(monkeypatch):
    """A replica whose decode block exceeds step_timeout_s dies
    (ReplicaTimeout, not a TransientError: the step already advanced the
    engine) and its requests replay on the survivor, token for token.
    The fake clock moves only inside replica 0's decode block (the
    engine's ``_decode_block``, which the CUDA graph replays on the
    card)."""
    assert not issubclass(ReplicaTimeout, TransientError)
    m, params = _port("gemma-7b")
    lens, max_new = (5, 11, 3, 8), (6, 6, 6, 6)
    want = _engines(m, params, 1)[0].run(_requests(m.cfg, lens, max_new))

    class FakeClock:
        t = 0.0

        def __call__(self):
            return self.t
    clock = FakeClock()
    monkeypatch.setattr(engine_mod, "_now", clock)
    engines = _engines(m, params, 2)
    fn = engines[0]._decode_block

    def slow(*args, **kw):
        clock.t += 10.0
        return fn(*args, **kw)
    engines[0]._decode_block = slow

    router = Router(engines, step_timeout_s=1.0)
    streamed, on_token = _stream_checker()
    with obs.capture() as sink:
        results = router.run(_requests(m.cfg, lens, max_new),
                             on_token=on_token)
    for i in range(4):
        assert results[i].tokens == want[i].tokens
        assert streamed[i] == results[i].tokens
        assert results[i].replica == 1
    assert router.deaths == 1 and not router.replicas[0].alive
    dead = [e for e in sink.records if e["name"] == "cluster.replica_dead"]
    assert dead[0]["reason"] == repr(ReplicaTimeout(
        "replica 0: step took 10.000s (> step_timeout_s=1.0)"))


def test_heartbeat_loss_kills_and_replays():
    m, params = _port("gemma-7b")
    lens, max_new = (5, 11), (6, 6)
    want = _engines(m, params, 1, num_slots=1)[0].run(
        _requests(m.cfg, lens, max_new))
    engines = _engines(m, params, 2, num_slots=1)
    with tempfile.TemporaryDirectory() as hb_dir:
        router = Router(engines, heartbeat_dir=hb_dir,
                        heartbeat_timeout_s=60.0)

        def lose_heartbeat():
            # rewind replica 0's heartbeat far past the timeout
            path = router.replicas[0].executor.heartbeat.path
            with open(path) as f:
                hb = json.load(f)
            hb["t"] -= 1000.0
            with open(path, "w") as f:
                json.dump(hb, f)
        with obs.capture() as sink:
            results, streamed = _drive(
                router, _requests(m.cfg, lens, max_new), 2, lose_heartbeat)
    for i in range(2):
        assert results[i].tokens == want[i].tokens
        assert streamed[i] == results[i].tokens
    assert router.deaths == 1 and not router.replicas[0].alive
    dead = [e for e in sink.records if e["name"] == "cluster.replica_dead"]
    assert [(e["replica"], e["reason"]) for e in dead] == [
        (0, "heartbeat lost")]


def test_fresh_replica_not_killed_before_first_beat():
    """A replica that never beat is starting, not stale: with a heartbeat
    timeout set, admission and the first step succeed although no
    heartbeat file exists at dispatch time."""
    m, params = _port("gemma-7b")
    with tempfile.TemporaryDirectory() as hb_dir:
        router = Router(_engines(m, params, 1), heartbeat_dir=hb_dir,
                        heartbeat_timeout_s=1e-9)
        router.submit(Request(rid=0,
                              prompt=_prompts(m.cfg.vocab_size, (5,))[0],
                              max_new_tokens=2))
        router.step()
    assert router.replicas[0].alive
    assert router.replicas[0].inflight or router.results


# ----------------------------------------------------------------------
# budget exhaustion and no survivors, against JAX's errors
# ----------------------------------------------------------------------
def _one_request(cfg, cls):
    return cls(rid=0, prompt=_prompts(cfg.vocab_size, (5,))[0],
               max_new_tokens=20)


def test_requeue_budget_exhaustion_is_fatal():
    jm, jp, m, params = _pair("gemma-7b")
    router = Router(_engines(m, params, 2, num_slots=1),
                    policy=RetryPolicy(max_retries=1,
                                       restart_on_exhaustion=False))
    jrouter = JRouter([JServeEngine(jm, jp, J_CTX, num_slots=1, max_len=32)
                       for _ in range(2)],
                      policy=JRetryPolicy(max_retries=1,
                                          restart_on_exhaustion=False))
    for r, cls in ((router, Request), (jrouter, JRequest)):
        r.submit(_one_request(m.cfg, cls))
        r.step()
        r.kill(0)      # the first replay: within the budget of 1
        r.step()       # placed again, on replica 1
    _same_error(lambda: router.kill(1), lambda: jrouter.kill(1),
                RequeueExhausted, JRequeueExhausted)


def test_no_surviving_replicas_raises():
    jm, jp, m, params = _pair("gemma-7b")
    router = Router(_engines(m, params, 1, num_slots=1))
    jrouter = JRouter([JServeEngine(jm, jp, J_CTX, num_slots=1,
                                    max_len=32)])
    for r, cls in ((router, Request), (jrouter, JRequest)):
        r.submit(_one_request(m.cfg, cls))
        r.step()
        r.kill(0)
    _same_error(router.step, jrouter.step, RuntimeError, RuntimeError)
    with pytest.raises(RuntimeError, match="no alive replicas"):
        router.step()


# ----------------------------------------------------------------------
# construction contracts and static validation
# ----------------------------------------------------------------------
def test_router_rejects_mismatched_or_shared_engines():
    jm, jp, m, params = _pair("gemma-7b")
    eng = _engines(m, params, 1, num_slots=1)[0]
    jeng = JServeEngine(jm, jp, J_CTX, num_slots=1, max_len=32)
    _same_error(lambda: Router([eng, eng]), lambda: JRouter([jeng, jeng]),
                ValueError, ValueError)
    other = ServeEngine(m, params, CTX, device="cpu", num_slots=1,
                        max_len=32, seed=1)
    jother = JServeEngine(jm, jp, J_CTX, num_slots=1, max_len=32, seed=1)
    _same_error(lambda: Router([eng, other]), lambda: JRouter([jeng, jother]),
                ValueError, ValueError)
    _same_error(lambda: Router([]), lambda: JRouter([]), ValueError,
                ValueError)


def test_router_rejects_duplicate_rid():
    jm, jp, m, params = _pair("gemma-7b")
    router = Router(_engines(m, params, 1, num_slots=1))
    jrouter = JRouter([JServeEngine(jm, jp, J_CTX, num_slots=1,
                                    max_len=32)])
    router.submit(_one_request(m.cfg, Request))
    jrouter.submit(_one_request(m.cfg, JRequest))
    _same_error(lambda: router.submit(_one_request(m.cfg, Request)),
                lambda: jrouter.submit(_one_request(m.cfg, JRequest)),
                ValueError, ValueError)


def test_validate_rejects_divergent_plans():
    """ZS-L009 at construction: replicas running different plans would
    give placement-dependent tokens.  JAX's pair of backends ("jnp",
    "interpret") is the port's ("torch", "auto")."""
    jm, jp, m, params = _pair("gemma-7b")
    engines = [ServeEngine(m, params, CTX, device="cpu", num_slots=1,
                           max_len=32, plan=Plan(backend=b))
               for b in ("torch", "auto")]
    jengines = [JServeEngine(jm, jp, J_CTX, num_slots=1, max_len=32,
                             plan=JPlan(backend=b))
                for b in ("jnp", "interpret")]
    _same_error(lambda: Router(engines, validate=True),
                lambda: JRouter(jengines, validate=True), ValueError,
                ValueError, match="ZS-L009")
    # the same plan object on every replica passes
    Router(_engines(m, params, 2, num_slots=1), validate=True)


def test_validate_rejects_unbounded_requeue_backoff():
    """ZS-F004 at construction: the policy's worst-case total backoff
    must stay below the request timeout."""
    jm, jp, m, params = _pair("gemma-7b")
    engines = _engines(m, params, 1, num_slots=1)
    jengines = [JServeEngine(jm, jp, J_CTX, num_slots=1, max_len=32)]
    kw = dict(max_retries=3, backoff_base_s=10.0,
              restart_on_exhaustion=False)
    _same_error(
        lambda: Router(engines, validate=True, policy=RetryPolicy(**kw),
                       request_timeout_s=5.0),
        lambda: JRouter(jengines, validate=True, policy=JRetryPolicy(**kw),
                        request_timeout_s=5.0), ValueError, ValueError)
    Router(engines, validate=True, request_timeout_s=5.0,
           policy=RetryPolicy(max_retries=3, backoff_base_s=0.1,
                              restart_on_exhaustion=False))


# ----------------------------------------------------------------------
# ShardedEngine
# ----------------------------------------------------------------------
def test_sharded_engine_single_device_parity():
    m, params = _port("gemma-7b")
    lens, max_new = (5, 11, 3, 8), (6, 3, 5, 7)
    want = _engines(m, params, 1)[0].run(_requests(m.cfg, lens, max_new))
    mesh = make_mesh_compat((1, 1), ("data", "model"), device="cpu")
    sharded = ShardedEngine(m, params, CTX, mesh=mesh, num_slots=2,
                            max_len=32)
    results = sharded.run(_requests(m.cfg, lens, max_new))
    for i in range(4):
        assert results[i].tokens == want[i].tokens
    # the specs it keeps are the sharding rules' over its mesh
    assert sharded.mesh is mesh and sharded.device == torch.device("cpu")
    specs = sharding.param_shardings(mesh, params)
    assert sharded.param_specs["layers"][0]["attn"]["wq"]["w"] == \
        specs["layers"][0]["attn"]["wq"]["w"]
    assert set(sharded.cache_specs) == set(sharded.cache)


def test_sharded_engine_rejects_paged_cache():
    jm, jp, m, params = _pair("gemma-7b")
    mesh = make_mesh_compat((1, 1), ("data", "model"), device="cpu")
    from repro.launch.mesh import make_mesh_compat as j_make_mesh
    from repro.serve.cluster import ShardedEngine as JShardedEngine
    jmesh = j_make_mesh((1, 1), ("data", "model"))
    _same_error(
        lambda: ShardedEngine(m, params, CTX, mesh=mesh, max_len=32,
                              page_size=4),
        lambda: JShardedEngine(jm, jp, J_CTX, mesh=jmesh, max_len=32,
                               page_size=4), ValueError, ValueError)


def test_sharded_engine_refuses_more_than_one_device():
    """The port places params across ranks, one process a rank: a mesh
    of two devices in one process (no process group) raises instead of
    replicating where JAX shards."""
    m, params = _port("gemma-7b")
    devs = np.empty((1, 2), dtype=object)
    devs[0, 0] = devs[0, 1] = torch.device("cpu")
    with pytest.raises(NotImplementedError, match="init_ranks"):
        ShardedEngine(m, params, CTX, mesh=Mesh(devs, ("data", "model")),
                      max_len=32)
    mesh = make_mesh_compat((1, 1), ("data", "model"), device="cpu")
    with pytest.raises(ValueError, match="its mesh's device"):
        ShardedEngine(m, params, CTX, mesh=mesh, max_len=32, device="cpu")


# ----------------------------------------------------------------------
# the launcher, against JAX's serve_batch
# ----------------------------------------------------------------------
def test_serve_batch_replicas_kill_and_mesh_match_jax(monkeypatch):
    """``serve_batch(replicas=3, kill_replica=0, mesh="1x1")`` against
    JAX's with the same arguments.  The port's launcher is given JAX's
    weights (converted) and JAX's requests (the two launchers draw them
    from different generators)."""
    kw = dict(batch=6, prompt_len=8, gen_len=8, mixed=True, num_slots=2,
              steps_per_dispatch=2, replicas=3, kill_replica=0,
              mesh="1x1")
    want = j_serve.serve_batch("gemma-7b", **kw)
    jm, jp, m, params = _pair("gemma-7b")
    jreqs = j_serve._make_requests(j_get_config("gemma-7b", reduced=True),
                                   jax.random.PRNGKey(0), 6, 8, 8, True)

    class Bundle:
        def __init__(self, model):
            self.model = model

        def __getattr__(self, name):
            return getattr(self.model, name)

        def init(self, **_):
            return params
    monkeypatch.setattr(port_serve, "build_model",
                        lambda cfg: Bundle(build_model(cfg)))
    monkeypatch.setattr(port_serve, "make_requests", lambda *a, **k: [
        Request(rid=r.rid, prompt=list(r.prompt),
                max_new_tokens=r.max_new_tokens) for r in jreqs])
    out = port_serve.serve_batch("gemma-7b", device="cpu", **kw)
    np.testing.assert_array_equal(out["generated"],
                                  np.asarray(want["generated"]))
    assert out["cluster"] == want["cluster"]
    assert out["cluster"]["deaths"] == 1 and out["cluster"]["requeues"] > 0
    for k in ("admitted", "retired", "dispatches", "decode_steps"):
        assert out["stats"][k] == want["stats"][k], k
    assert [p["replica_id"] for p in out["stats"]["per_replica"]] == [0, 1, 2]


def test_serve_batch_kill_that_never_fires_raises():
    kw = dict(batch=2, prompt_len=4, gen_len=2, num_slots=2, replicas=2,
              kill_replica=1, kill_at_step=50)
    _same_error(
        lambda: port_serve.serve_batch("gemma-7b", device="cpu", **kw),
        lambda: j_serve.serve_batch("gemma-7b", **kw), RuntimeError,
        RuntimeError, match="never fired")


# ----------------------------------------------------------------------
# the device rule
# ----------------------------------------------------------------------
def test_cluster_entry_points_take_the_card_unless_asked_for_the_cpu():
    """``make_mesh_compat`` (and so ``ShardedEngine``'s mesh and the
    launcher's ``--mesh``) defaults to the card and raises without one;
    a shape beyond the devices present raises ValueError, as
    ``jax.make_mesh``; ``Router`` serves on its engines' devices."""
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make_mesh_compat((1, 1), ("data", "model"))
        with pytest.raises(RuntimeError, match="no CUDA device"):
            port_serve.serve_batch("gemma-7b", replicas=2)
    with pytest.raises(ValueError, match="must be >= the product"):
        make_mesh_compat((1, 2), ("data", "model"), device="cpu")
    mesh = make_mesh_compat((1, 1), ("data", "model"), device="cpu")
    assert mesh.shape == {"data": 1, "model": 1}
    assert list(mesh.devices.flat) == [torch.device("cpu")]
    m, params = _port("gemma-7b")
    router = Router(_engines(m, params, 2, num_slots=1))
    assert {rep.engine.device for rep in router.replicas} == {
        torch.device("cpu")}


# ----------------------------------------------------------------------
# on the card (skips here)
# ----------------------------------------------------------------------
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the replicas decode through "
                    "their CUDA graphs only on the card")
    return torch.device("cuda")


@pytest.mark.gpu
def test_router_on_card_matches_single_engine(cuda):
    """Phase 5p (a) of chip_smoke.py at the reduced size: two contiguous
    replicas at K = 4 give the single engine's greedy tokens through the
    kernels and each replica's CUDA graph, with a clean stream, work on
    both replicas and launches on the path."""
    m = build_model(get_config("gemma-7b", reduced=True))
    params = m.init(seed=0, device=cuda)
    reqs = [Request(rid=i, prompt=p, max_new_tokens=n) for i, (p, n) in
            enumerate(zip(_prompts(256, (8, 4, 2, 6) * 2), [8] * 8))]

    def engine():
        return ServeEngine(m, params, CTX, device=cuda, num_slots=2,
                           max_len=32, steps_per_dispatch=4)
    want = engine().run([dataclasses.replace(r) for r in reqs])
    before = launches.snapshot()
    router = Router([engine(), engine()])
    streamed, on_token = _stream_checker()
    got = router.run(reqs, on_token=on_token)
    torch.cuda.synchronize()
    ran = launches.since(before)
    assert {i: r.tokens for i, r in got.items()} == {
        i: r.tokens for i, r in want.items()}
    assert streamed == {i: r.tokens for i, r in got.items()}
    assert {r.replica for r in got.values()} == {0, 1}
    assert router.stats().admitted == router.stats().retired == 8
    assert ran.get("zero_stall_matmul", 0) > 0
    assert ran.get("flash_attention", 0) > 0
    # each replica's decode graph, beside its prefill graphs
    assert all([c["variant"] for c in rep.engine.captures
                if not c["variant"].startswith("prefill")] == ["greedy"]
               for rep in router.replicas)
