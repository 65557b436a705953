"""The train step and the lock-step oracle's decode as compiled programs.

On the card ``compile_train_step`` runs the train step as one CUDA graph
a batch shape, the first step of a shape eager, as JAX jits
``make_train_step`` with the state donated; ``lockstep_generate`` runs
its first decode step eagerly, then captures one step and replays it,
as JAX jits its decode with the cache donated.  On the CPU the same
static-buffer bodies run eagerly.  Here, on reduced configs in fp32 with
inputs from numpy seeds (S 16, B 4):

* the compiled step over 5 steps against JAX's jitted step, the loss
  within 1e-5 and the gradient norm within 1e-4 relative
  (``tests/test_torch_train.py``'s lockstep tolerances), on gemma-7b,
  olmoe-1b-7b and mamba2-130m;
* the compiled step bit-equal to the eager ``make_train_step`` over 3
  steps (parameters, moments, step, residuals, metrics) with
  microbatches and int8 and top-k compression;
* two batch shapes keep two programs; a state that is not the one held
  (a restore) is copied in; ``train_loop`` with an injected failure
  that exhausts its retries and restores gives the eager loop's losses;
* under ``ctx.mesh`` the eager step runs and nothing is held;
* the step's body on the meta device, where a host read of a device
  value raises;
* ``lockstep_generate`` gives a plain loop of ``Model.decode`` calls'
  tokens for a dense, an SSM and an encdec config.

The ``gpu`` cases skip here: the graphed step against the eager step on
the card (bit-equal, or no further from the eager step than two eager
runs are from each other), one capture a batch key, the restore path,
the graphed oracle against the plain loop for every family it serves,
and no capture across ranks.  They import no JAX.
"""

import functools

import numpy as np
import pytest
import torch

import torch_ranks
from repro_torch import graphs
from repro_torch.configs import RunConfig, get_config
from repro_torch.data import make_pipeline
from repro_torch.kernels import launches
from repro_torch.launch import train as T
from repro_torch.launch.mesh import Mesh
from repro_torch.models import Ctx, build_model
from repro_torch.optim import init_opt_state
from repro_torch.optim.compression import init_residuals
from repro_torch.runtime.fault_tolerance import TransientError
from repro_torch.serve import lockstep_generate
from repro_torch.tree import flatten, leaves, tree_map
from torch_tune_cache import port_tune_cache  # noqa: F401 (autouse)

S, B = 16, 4
LOSS_REL, NORM_REL = 1e-5, 1e-4
CTX = Ctx(plan="torch", dtype=torch.float32)
KW = dict(seq_len=S, global_batch=B, lr=3e-3, warmup_steps=2,
          total_steps=10, dtype="float32")
S_ENC = 12                  # an encdec request's source frames


@functools.lru_cache(maxsize=None)
def _jax_pair(arch):
    """JAX's reduced model and fp32 params, and the port's model."""
    import jax
    import jax.numpy as jnp
    from repro.configs import get_config as j_get_config
    from repro.models import build_model as j_build_model
    jm = j_build_model(j_get_config(arch, reduced=True))
    jp = jm.init(jax.random.PRNGKey(0), dtype=jnp.float32)
    cfg = get_config(arch, reduced=True)
    return jm, jp, build_model(cfg), cfg


def _state(model, device="cpu", scheme="none"):
    params = model.init(seed=0, dtype=torch.float32, device=device)
    return (params, init_opt_state(params),
            init_residuals(params) if scheme != "none" else {})


def _copy(state):
    return tree_map(lambda t: t.clone(), state)


def _assert_bit_equal(got, want, what):
    g, gdef = flatten(got)
    w, wdef = flatten(want)
    assert gdef == wdef, what
    for i, (a, b) in enumerate(zip(g, w)):
        assert torch.equal(a, b), (what, i)


def _batches(cfg, n, seq=S):
    pipe = make_pipeline(cfg.vocab_size, seq, B, seed=0)
    return [pipe.torch_batch(i, "cpu") for i in range(n)]


# ----------------------------------------------------------------------
# the compiled step against JAX's jitted step
# ----------------------------------------------------------------------
@pytest.mark.parametrize("arch", ["gemma-7b", "olmoe-1b-7b", "mamba2-130m"])
def test_compiled_step_equals_jax_jitted_step_over_five_steps(arch):
    import jax
    import jax.numpy as jnp
    from repro.configs import RunConfig as JRunConfig
    from repro.data import make_pipeline as j_make_pipeline
    from repro.launch.train import make_train_step as j_make_train_step
    from repro.models import Ctx as JCtx
    from repro.optim import init_opt_state as j_init_opt_state
    from repro_torch.interop import params_from_numpy
    jm, jp, m, cfg = _jax_pair(arch)
    jstep = jax.jit(j_make_train_step(
        jm, JCtx(plan="jnp", dtype=jnp.float32), JRunConfig(**KW)))
    step = T.compile_train_step(m, CTX, RunConfig(**KW))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), cfg, device="cpu")
    state, jstate = (tp, init_opt_state(tp), {}), (jp, j_init_opt_state(jp),
                                                   {})
    jpipe = j_make_pipeline(cfg.vocab_size, S, B, seed=0)
    for i, tb in enumerate(_batches(cfg, 5)):
        *jstate, jmet = jstep(*jstate, jax.tree.map(jnp.asarray,
                                                     jpipe.batch(i)))
        *state, met = step(*state, tb)
        assert float(met["loss"]) == pytest.approx(float(jmet["loss"]),
                                                   rel=LOSS_REL), i
        assert float(met["grad_norm"]) == pytest.approx(
            float(jmet["grad_norm"]), rel=NORM_REL), i
        assert float(met["lr"]) == pytest.approx(float(jmet["lr"]),
                                                 rel=1e-6), i
    assert state[0] is tp and int(state[1].step) == 5
    assert len(step.batches) == 1 and step.captures == []


# ----------------------------------------------------------------------
# the compiled step against the eager step, bit for bit
# ----------------------------------------------------------------------
@pytest.mark.parametrize("mb,scheme", [(1, "none"), (2, "none"),
                                       (1, "int8"), (1, "topk"),
                                       (2, "int8")])
def test_compiled_step_is_bit_equal_to_the_eager_step(mb, scheme):
    cfg = get_config("gemma-7b", reduced=True)
    m = build_model(cfg)
    run = RunConfig(microbatches=mb, grad_compression=scheme, **KW)
    eager, compiled = T.make_train_step(m, CTX, run), \
        T.compile_train_step(m, CTX, run)
    want = _state(m, scheme=scheme)
    got = _copy(want)
    for tb in _batches(cfg, 3):
        *want, wmet = eager(*want, tb)
        *got, gmet = compiled(*got, tb)
        _assert_bit_equal(gmet, wmet, "metrics")
    _assert_bit_equal(got, want, "state")


def test_two_batch_shapes_keep_two_programs():
    cfg = get_config("mamba2-130m", reduced=True)
    m = build_model(cfg)
    run = RunConfig(**KW)
    eager, compiled = T.make_train_step(m, CTX, run), \
        T.compile_train_step(m, CTX, run)
    want = _state(m)
    got = _copy(want)
    long, short = _batches(cfg, 2), _batches(cfg, 2, seq=8)
    for tb in (long[0], short[0], long[1], short[1]):
        *want, wmet = eager(*want, tb)
        *got, gmet = compiled(*got, tb)
        _assert_bit_equal(gmet, wmet, "metrics")
    _assert_bit_equal(got, want, "state")
    assert sorted(k[1][1] for k in compiled.batches) == [(B, 8), (B, S)]


def test_a_state_that_is_not_the_held_one_is_copied_in():
    """A call with other state tensors (a restore) copies them into the
    held state and returns that: the caller's tensors are left as they
    were, and the step is the eager step from the given state."""
    cfg = get_config("gemma-7b", reduced=True)
    m = build_model(cfg)
    run = RunConfig(grad_compression="int8", **KW)
    eager, compiled = T.make_train_step(m, CTX, run), \
        T.compile_train_step(m, CTX, run)
    b0, b1, b2 = _batches(cfg, 3)
    held = _state(m, scheme="int8")
    *held, _ = compiled(*held, b0)
    held_leaves = leaves(held)
    restored = _state(m, scheme="int8")         # the state before step 0
    given = _copy(restored)
    *got, met = compiled(*restored, b1)
    assert all(a is b for a, b in zip(leaves(got), held_leaves))
    _assert_bit_equal(restored, given, "the caller's tensors")
    *want, wmet = eager(*_copy(given), b1)
    _assert_bit_equal(got, want, "state")
    _assert_bit_equal(met, wmet, "metrics")
    *got, met = compiled(*got, b2)
    *want, wmet = eager(*want, b2)
    _assert_bit_equal(got, want, "state")
    with pytest.raises(ValueError, match="structure"):
        compiled(*_state(m), b2)


def _loop_run(tmp_path, **kw):
    return RunConfig(seq_len=32, global_batch=4, lr=3e-3, warmup_steps=2,
                     total_steps=10, ckpt_dir=str(tmp_path), ckpt_every=1,
                     dtype="float32", **kw)


def _restored_loop(tmp_path, device):
    """``train_loop`` of reduced mamba2-130m whose step 6 fails more
    often than the executor retries, so that it restores the checkpoint
    of step 5 -> its output."""
    fails = {6: 4}

    def hook(step):
        if fails.get(step):
            fails[step] -= 1
            raise TransientError("injected preemption")

    return T.train_loop("mamba2-130m", _loop_run(tmp_path / "restored"),
                        failure_hook=hook, log_every=1000, device=device)


def test_train_loop_with_a_restore_gives_the_eager_loop_losses(
        tmp_path, monkeypatch):
    out = _restored_loop(tmp_path, "cpu")
    assert out["executor"].restarts_total == 1
    assert out["executor"].retries_total == 4
    monkeypatch.setattr(T, "compile_train_step", T.make_train_step)
    eager = T.train_loop("mamba2-130m", _loop_run(tmp_path / "eager"),
                         log_every=1000, device="cpu")
    assert out["losses"] == eager["losses"]
    _assert_bit_equal(out["state"], eager["state"], "final state")


def test_under_a_mesh_the_eager_step_runs_and_nothing_is_held():
    cfg = get_config("gemma-7b", reduced=True)
    m = build_model(cfg)
    mesh = Mesh(np.full((1, 1), torch.device("cpu"), dtype=object),
                ("data", "model"))
    ctx = Ctx(plan="torch", dtype=torch.float32, mesh=mesh)
    run = RunConfig(microbatches=2, **KW)
    eager, compiled = T.make_train_step(m, ctx, run), \
        T.compile_train_step(m, ctx, run)
    want = _state(m)
    got = _copy(want)
    tb = _batches(cfg, 1)[0]
    *want, wmet = eager(*want, tb)
    *got, gmet = compiled(*got, tb)
    _assert_bit_equal(gmet, wmet, "metrics")
    _assert_bit_equal(got, want, "state")
    assert compiled.batches == {} and compiled.programs == {}


@pytest.mark.parametrize("arch,mb,scheme", [
    ("gemma-7b", 2, "int8"), ("olmoe-1b-7b", 1, "topk"),
    ("mamba2-130m", 1, "none"), ("zamba2-2.7b", 1, "none")])
def test_the_step_body_reads_no_device_value_on_the_host(arch, mb, scheme):
    """On the meta device a host read of a tensor's value raises, so the
    body a capture records holds none (a capture would fail on one)."""
    cfg = get_config(arch, reduced=True)
    m = build_model(cfg)
    step = T.compile_train_step(
        m, CTX, RunConfig(microbatches=mb, grad_compression=scheme, **KW))
    batch = {k: torch.zeros((B, S), dtype=torch.long, device="meta")
             for k in ("tokens", "targets")}
    *state, met = step(*_state(m, "meta", scheme), batch)
    assert met["loss"].device.type == "meta"
    assert len(step.batches) == 1


def test_tree_walks_leave_no_reference_cycle():
    """``flatten`` and ``unflatten`` hold no leaf once they return, with
    the collector off (as it is during a capture)."""
    import gc
    import weakref
    from repro_torch.tree import unflatten
    x = torch.ones(3)
    ref = weakref.ref(x)
    collecting = gc.isenabled()
    gc.disable()
    try:
        ls, treedef = flatten({"a": [x, (x,)], "b": {"c": x}})
        unflatten(treedef, ls)
        del ls, x
        assert ref() is None
    finally:
        if collecting:
            gc.enable()


def test_a_step_leaves_no_tensor_to_the_collector():
    """An eager step's gradients are freed when it returns, not at the
    next collection: a graph's capture follows the step with the
    collector off, and they would stay alive beside the graph's own
    (reduced gemma-7b without remat, whose checkpoint frames are cyclic
    by design)."""
    import dataclasses
    import gc
    cfg = dataclasses.replace(get_config("gemma-7b", reduced=True),
                              remat="none")
    m = build_model(cfg)
    state = _state(m, scheme="int8")
    tb = _batches(cfg, 1)[0]
    step = T.make_train_step(m, CTX, RunConfig(microbatches=2,
                                               grad_compression="int8",
                                               **KW))
    held = {t.untyped_storage().data_ptr()
            for t in leaves(state) + list(tb.values())}
    collecting = gc.isenabled()
    gc.collect()
    # what is alive before the step is not the step's: the tensors other
    # test modules of this process keep in their caches, held here so
    # that no storage of theirs is freed and its address reused
    before = [o for o in gc.get_objects() if isinstance(o, torch.Tensor)]
    held |= {t.untyped_storage().data_ptr() for t in before}
    gc.disable()
    try:
        *state, met = step(*state, tb)
        held |= {t.untyped_storage().data_ptr()
                 for t in leaves(state) + leaves(met)}
        left = [o.shape for o in gc.get_objects()
                if isinstance(o, torch.Tensor)
                and o.untyped_storage().data_ptr() not in held]
        assert left == []
    finally:
        if collecting:
            gc.enable()


# ----------------------------------------------------------------------
# the lock-step oracle
# ----------------------------------------------------------------------
def _frontend(cfg, n_rows, seed=7):
    if cfg.family == "vlm":
        n = cfg.frontend_tokens
    elif cfg.family == "encdec":
        n = S_ENC
    else:
        return None
    return (np.random.default_rng(seed).standard_normal(
        (n_rows, n, cfg.d_model)) * 0.1).astype(np.float32)


def _oracle_case(cfg):
    lens, new = (5, 11, 3, 8), (6, 3, 5, 7)
    prompts = [[int(t) for t in np.random.default_rng(i).integers(
        1, cfg.vocab_size, n)] for i, n in enumerate(lens)]
    front = _frontend(cfg, len(lens))
    max_len = max(lens) + max(new) + (
        cfg.frontend_tokens if cfg.family == "vlm" else 0)
    return prompts, list(new), max_len, front


def _plain_oracle(model, params, ctx, prompts, max_new, *, max_len,
                  frontend_embeds, device):
    """The oracle's loop of ``Model.decode`` calls, every step eager."""
    B_, lens = len(prompts), [len(p) for p in prompts]
    toks = torch.zeros((B_, max(lens)), dtype=torch.long)
    for i, p in enumerate(prompts):
        toks[i, :lens[i]] = torch.tensor(p)
    batch = {"tokens": toks.to(device),
             "lengths": torch.tensor(lens, dtype=torch.int32, device=device)}
    if frontend_embeds is not None:
        batch["frontend_embeds"] = torch.as_tensor(frontend_embeds).to(
            device)
    logits, cache = model.prefill(params, batch, ctx, max_len)
    tok = torch.argmax(logits[:, -1].float(), dim=-1)
    outs = [[int(t)] for t in tok.cpu().tolist()]
    for _ in range(max(max_new) - 1):
        logits, cache = model.decode(params, cache, tok[:, None], ctx)
        tok = torch.argmax(logits[:, -1].float(), dim=-1)
        for i, t in enumerate(tok.cpu().tolist()):
            if len(outs[i]) < max_new[i]:
                outs[i].append(int(t))
    return outs


def _oracles(arch, device):
    cfg = get_config(arch, reduced=True)
    m = build_model(cfg)
    params = m.init(seed=0, dtype=torch.float32, device=device)
    ctx = Ctx(plan="auto", dtype=torch.float32)
    prompts, new, max_len, front = _oracle_case(cfg)
    kw = dict(max_len=max_len, frontend_embeds=front, device=device)
    plain = _plain_oracle(m, params, ctx, prompts, new, **kw)
    before = launches.snapshot()
    got = lockstep_generate(m, params, ctx, prompts, new, **kw)
    if device == "cuda":
        torch.cuda.synchronize()
    return got, plain, launches.since(before)


@pytest.mark.parametrize("arch", ["gemma-7b", "mamba2-130m",
                                  "seamless-m4t-large-v2"])
def test_lockstep_generate_equals_the_plain_loop(arch):
    got, plain, _ = _oracles(arch, "cpu")
    assert got == plain
    assert [len(t) for t in got] == [6, 3, 5, 7]


# ----------------------------------------------------------------------
# on the card (skips here)
# ----------------------------------------------------------------------
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the train step and the oracle "
                    "capture their programs only on the card")
    return torch.device("cuda")


def _distance(a, b) -> float:
    """The largest elementwise distance between two trees of tensors."""
    return max((float((x.double() - y.double()).abs().max())
                for x, y in zip(leaves(a), leaves(b))), default=0.0)


def _train_steps(m, cfg, step, n=5):
    """``n`` steps of ``step`` from the state drawn from seed 0 -> (the
    final state, the losses)."""
    state = _state(m, "cuda")
    losses = []
    for tb in _batches(cfg, n):
        *state, met = step(*state, {k: v.cuda() for k, v in tb.items()})
        losses.append(met["loss"].clone())
    torch.cuda.synchronize()
    return state, torch.stack(losses)


def determinism_gate(graph, eager, again) -> tuple[float, float]:
    """(the graph's distance from the eager run, the eager run's from a
    second eager run); the graph passes if bit-equal to the eager run,
    or no further from it than the second eager run is."""
    dg, de = _distance(graph, eager), _distance(again, eager)
    assert dg == 0.0 or dg <= de, (dg, de)
    return dg, de


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["gemma-7b", "olmoe-1b-7b", "mamba2-130m",
                                  "zamba2-2.7b"])
def test_graphed_train_step_against_the_eager_step_on_card(cuda, arch):
    cfg = get_config(arch, reduced=True)
    m = build_model(cfg)
    run = RunConfig(**KW)
    eager = _train_steps(m, cfg, T.make_train_step(m, CTX, run))
    again = _train_steps(m, cfg, T.make_train_step(m, CTX, run))
    compiled = T.compile_train_step(m, CTX, run)
    graph = _train_steps(m, cfg, compiled)
    determinism_gate(graph, eager, again)
    assert [c["variant"] for c in compiled.captures] == [
        f"train_step:targets{(B, S)},tokens{(B, S)}"]
    assert compiled.captures[0]["pool_bytes"] > 0


@pytest.mark.gpu
def test_one_capture_a_batch_key_on_card(cuda):
    cfg = get_config("gemma-7b", reduced=True)
    m = build_model(cfg)
    step = T.compile_train_step(m, CTX, RunConfig(**KW))
    state = _state(m, "cuda")
    long, short = _batches(cfg, 3), _batches(cfg, 3, seq=8)
    before = launches.snapshot()
    for pair in zip(long, short):
        for tb in pair:
            *state, _ = step(*state, {k: v.cuda() for k, v in tb.items()})
    torch.cuda.synchronize()
    assert len(step.captures) == 2 and len(step.programs) == 2
    assert int(state[1].step) == 6
    assert launches.since(before) == {}       # the plain path: no kernel


@pytest.mark.gpu
def test_restore_through_the_graph_on_card(cuda, tmp_path, monkeypatch):
    out = _restored_loop(tmp_path, "cuda")
    assert out["executor"].restarts_total == 1
    monkeypatch.setattr(T, "compile_train_step", T.make_train_step)
    eager = T.train_loop("mamba2-130m", _loop_run(tmp_path / "eager"),
                         log_every=1000, device="cuda")
    again = T.train_loop("mamba2-130m", _loop_run(tmp_path / "again"),
                         log_every=1000, device="cuda")
    determinism_gate([torch.tensor(out["losses"])],
                     [torch.tensor(eager["losses"])],
                     [torch.tensor(again["losses"])])


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["gemma-7b", "olmoe-1b-7b", "llava-next-34b",
                                  "seamless-m4t-large-v2", "mamba2-130m",
                                  "zamba2-2.7b"])
def test_graphed_oracle_equals_the_eager_oracle_on_card(cuda, arch,
                                                        monkeypatch):
    made = []
    real = graphs.capture

    def spy(*args, **kw):
        made.append(args[2])
        return real(*args, **kw)

    monkeypatch.setattr(graphs, "capture", spy)
    got, plain, counts = _oracles(arch, "cuda")
    assert got == plain
    assert made == ["lockstep_decode"]
    # a replay adds the launches it captured: kernel 1 runs every
    # projection of the prefill and of each of the 6 decode steps
    assert counts.get("zero_stall_matmul", 0) > 0


@pytest.mark.gpu
def test_no_train_step_is_captured_across_ranks(cuda, tmp_path):
    outs = torch_ranks.world(torch_ranks.compiled_train_across_ranks, 2,
                             tmp_path, device=None, timeout=300)
    assert all(o["captures"] == [] and o["batches"] == 0 for o in outs)
    assert outs[0]["losses"] == outs[1]["losses"]
