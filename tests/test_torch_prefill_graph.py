"""Prefill as compiled programs: the engine's static-buffer prefill and
chunk bodies against a fresh ``Model.prefill``, ``prefill_chunk`` and
the JAX package.

On the card ``ServeEngine`` runs each admission's prefill as one CUDA
graph a prompt bucket and frontend shape, and each chunk of a chunked
admission as one graph a chunk shape, over static buffers, as the JAX
engine jits ``prefill`` and ``prefill_chunk`` once a shape; on the CPU
the same bodies run eagerly on the same buffers.  Every program writes
its cache into one batch-1 buffer of the engine's, so no graph holds a
cache of its own.  Here, on reduced configs of every family with inputs
from numpy seeds:

* the prefill body, run twice in one bucket with the longer prompt
  first (after a prompt of a larger bucket), gives a fresh
  ``Model.prefill``'s logits and cache bit for bit (the buffers are
  rewritten whole) and JAX's jitted prefill within 1e-4;
* every prefill and chunk program writes the engine's one batch-1
  cache;
* ``prefill_chunk`` with a tensor offset ((1,) or (B,)) gives the int
  offset's bits, and JAX's ``prefill_chunk`` jitted with a traced
  offset within 1e-4, a last chunk that overruns ``max_len`` included
  (the port writes only the rows that fit; JAX clamps, so it is held on
  a stripe long enough for no clamp);
* two chunked admissions in flight at once, handing the chunk stripe
  to each other, give JAX's tokens;
* the bodies run on the meta device on the plain path, where a host read
  of a device value raises.

The ``gpu`` cases skip here: graph against eager bit for bit, the
launches of a replay, the graphs' memory (no cache a graph), a capture
that fails raising (in a process of its own, since a failed capture
spoils its process's CUDA state), no capture across ranks and a capture
on a one-device mesh.  They hold the card against
the port's own eager path and import no JAX: the JAX package is
imported only inside the CPU cases.
"""

import functools
import gc

import numpy as np
import pytest
import torch

import torch_ranks
from repro_torch.configs import get_config
from repro_torch.interop import params_from_numpy
from repro_torch.kernels import launches
from repro_torch.models import Ctx, build_model
from repro_torch.serve import Request, ServeEngine
from torch_tune_cache import port_tune_cache  # noqa: F401 (autouse)

TOL = 1e-4
MAX_LEN = 32
S_ENC = 12                  # an encdec request's source frames
CTX = Ctx(plan="auto", dtype=torch.float32)
ARCHS = ["gemma-7b", "olmoe-1b-7b", "llava-next-34b",
         "seamless-m4t-large-v2", "mamba2-130m", "zamba2-2.7b"]


def _j_ctx():
    import jax.numpy as jnp
    from repro.models import Ctx as JCtx
    return JCtx(plan="jnp", dtype=jnp.float32)


@functools.lru_cache(maxsize=None)
def _pair(arch):
    """JAX's reduced model and fp32 params, and the port's on the same
    (converted) weights."""
    import jax
    import jax.numpy as jnp
    from repro.configs import get_config as j_get_config
    from repro.models import build_model as j_build_model
    cfg = get_config(arch, reduced=True)
    jm, m = j_build_model(j_get_config(arch, reduced=True)), build_model(cfg)
    jp = jm.init(jax.random.PRNGKey(0), dtype=jnp.float32)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), cfg, device="cpu")
    return jm, jp, m, tp, cfg


def _frontend(cfg, seed):
    """A request's (P, d) vlm patches or (S_ENC, d) encdec frames."""
    if cfg.family == "vlm":
        n = cfg.frontend_tokens
    elif cfg.family == "encdec":
        n = S_ENC
    else:
        return None
    return (np.random.default_rng(seed).standard_normal((n, cfg.d_model))
            * 0.1).astype(np.float32)


def _prompt(vocab, n, seed):
    return [int(t) for t in
            np.random.default_rng(seed).integers(1, vocab, n)]


def _engine_kw(cfg) -> dict:
    return ({"cache_kwargs": {"enc_len": S_ENC}}
            if cfg.family == "encdec" else {})


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), atol=tol,
                               rtol=tol)


def _spy_bodies(eng) -> list:
    """Record each prefill program's outputs (cloned) as it runs."""
    got = []
    real = eng._prefill_program

    def spy(key):
        logits, cache = real(key)
        got.append((key, logits.clone(),
                    {k: v.clone() for k, v in cache.items()}))
        return logits, cache

    eng._prefill_program = spy
    return got


# ----------------------------------------------------------------------
# the prefill program
# ----------------------------------------------------------------------
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_body_longer_then_shorter_prompt_is_a_fresh_prefill(arch):
    """A 14-token prompt, then a 10-token one in the same 16-token bucket
    through the engine's static buffers, after a 20-token prompt (the
    32-token bucket, or 24 after a vlm's 8-position prefix) has filled
    more rows of the batch-1 cache: each equals a fresh ``Model.prefill`` of
    its own zero-padded batch bit for bit (so no token of the longer
    prompt is left in the buffer's tail, where its K/V would land in the
    cache past ``pos`` and the SSM and hybrid conv window would read it,
    and no row of the earlier cache is left past the bucket), and JAX's
    jitted prefill within 1e-4."""
    import jax
    import jax.numpy as jnp
    jm, jp, m, tp, cfg = _pair(arch)
    eng = ServeEngine(m, tp, CTX, num_slots=2, max_len=MAX_LEN,
                      device="cpu", **_engine_kw(cfg))
    got = _spy_bodies(eng)
    reqs = [Request(rid=i, prompt=_prompt(cfg.vocab_size, n, 10 + i),
                    max_new_tokens=4, frontend_embeds=_frontend(cfg, 20 + i))
            for i, n in enumerate((20, 14, 10))]
    for slot, r in enumerate(reqs):
        eng._admit(r, slot % 2)
    assert got[0][0][1] > 16
    got, reqs = got[1:], reqs[1:]
    assert [g[0][:2] for g in got] == [("prefill", 16)] * 2
    assert got[0][0] == got[1][0]                 # one program, one bucket
    j_ctx = _j_ctx()
    j_prefill = jax.jit(lambda p, b: jm.prefill(p, b, j_ctx, MAX_LEN))
    for r, (_, logits, cache) in zip(reqs, got):
        n = len(r.prompt)
        toks = np.zeros((1, 16), np.int64)
        toks[0, :n] = r.prompt
        batch = {"tokens": torch.from_numpy(toks),
                 "lengths": torch.tensor([n], dtype=torch.int32)}
        jbatch = {"tokens": jnp.asarray(toks, jnp.int32),
                  "lengths": jnp.asarray([n], jnp.int32)}
        if r.frontend_embeds is not None:
            batch["frontend_embeds"] = torch.from_numpy(r.frontend_embeds)[
                None]
            jbatch["frontend_embeds"] = jnp.asarray(r.frontend_embeds)[None]
        want_l, want_c = m.prefill(tp, batch, CTX, MAX_LEN)
        assert torch.equal(logits, want_l)
        assert cache.keys() == want_c.keys()
        for name, t in cache.items():
            assert torch.equal(t, want_c[name]), name
        jl, jc = j_prefill(jp, jbatch)
        _close(logits, jl)
        for name, t in cache.items():
            assert t.shape == np.shape(jc[name]), name
            _close(t, jc[name])


# ----------------------------------------------------------------------
# the chunk program
# ----------------------------------------------------------------------
def _chunked(m, tp, toks, C, max_len, offset_of):
    """Feed (B, n) prompts through ``prefill_chunk`` in chunks of C with
    offsets made by ``offset_of(int)`` -> (each chunk's logits, stripe)."""
    B, n = toks.shape
    cache = m.init_cache(B, max_len, torch.float32, device="cpu")
    outs = []
    for off in range(0, n, C):
        end = min(off + C, n)
        chunk = torch.zeros((B, C), dtype=torch.long)
        chunk[:, :end - off] = toks[:, off:end]
        logits, cache = m.prefill_chunk(
            tp, chunk, CTX, cache=cache, offset=offset_of(off),
            lengths=torch.full((B,), end, dtype=torch.int32))
        outs.append(logits)
    return outs, cache


@pytest.mark.parametrize("n", [20, 26], ids=["fits", "overruns"])
def test_prefill_chunk_tensor_offset_is_the_int_offset_and_jax(n):
    """Chunks of 12 at max_len 32: a 20-token prompt's last chunk fits,
    a 26-token one's starts at 24 and its padding would run to 36.  The
    (1,) and (B,) int32 offsets give the int offset's bits; JAX's
    ``prefill_chunk``, jitted with the offset traced, gives the same
    logits and stripe rows within 1e-4, on a stripe of 48 rows where the
    port's would overrun (JAX clamps the write start, the reference
    fault the port does not keep)."""
    import jax
    import jax.numpy as jnp
    jm, jp, m, tp, cfg = _pair("gemma-7b")
    B, C = 2, 12
    toks = torch.from_numpy(np.random.default_rng(7).integers(
        1, cfg.vocab_size, (B, n)))
    base, base_c = _chunked(m, tp, toks, C, MAX_LEN, int)
    for offset_of in (
            lambda o: torch.tensor([o], dtype=torch.int32),
            lambda o: torch.full((B,), o, dtype=torch.int32)):
        outs, cache = _chunked(m, tp, toks, C, MAX_LEN, offset_of)
        for a, b in zip(outs, base):
            assert torch.equal(a, b)
        for name in ("k", "v", "pos"):
            assert torch.equal(cache[name], base_c[name]), name
    j_len = MAX_LEN if -(-n // C) * C <= MAX_LEN else 48
    j_ctx = _j_ctx()
    j_chunk = jax.jit(lambda p, t, c, off, lens: jm.prefill_chunk(
        p, t, j_ctx, cache=c, offset=off, lengths=lens))
    jc = {k: v for k, v in jm.init_cache(B, j_len, jnp.float32).items()
          if k != "pos"}
    jtoks = np.asarray(toks)
    for i, off in enumerate(range(0, n, C)):
        end = min(off + C, n)
        chunk = np.zeros((B, C), np.int32)
        chunk[:, :end - off] = jtoks[:, off:end]
        jl, jc = j_chunk(jp, jnp.asarray(chunk), jc, jnp.int32(off),
                         jnp.full((B,), end, jnp.int32))
        jc = {k: v for k, v in jc.items() if k != "pos"}
        _close(base[i], jl)
    for name in ("k", "v"):
        _close(base_c[name], np.asarray(jc[name])[:, :, :MAX_LEN])


def test_prefill_chunk_takes_a_row_offset_each():
    """A (B,) offset with a different start a row: each row is its own
    batch-1 chunk at its own int offset, a row whose window would pass
    ``max_len`` (30 + 12 > 32) included."""
    _, _, m, tp, cfg = _pair("gemma-7b")
    C, offs, ends = 12, (4, 30), (16, 32)
    rng = np.random.default_rng(9)
    toks = torch.from_numpy(rng.integers(1, cfg.vocab_size, (2, C)))
    stripe = m.init_cache(2, MAX_LEN, torch.float32, device="cpu")
    for name in ("k", "v"):
        stripe[name].copy_(torch.from_numpy(
            rng.standard_normal(stripe[name].shape).astype(np.float32)))
    ones = [{k: v[:, b:b + 1].clone() for k, v in stripe.items()
             if k != "pos"} for b in range(2)]
    logits, got = m.prefill_chunk(
        tp, toks, CTX, cache=stripe,
        offset=torch.tensor(offs, dtype=torch.int32),
        lengths=torch.tensor(ends, dtype=torch.int32))
    for b in range(2):
        want_l, want = m.prefill_chunk(
            tp, toks[b:b + 1], CTX, cache=ones[b], offset=offs[b],
            lengths=torch.tensor([ends[b]], dtype=torch.int32))
        _close(logits[b:b + 1], want_l.numpy(), 1e-5)
        for name in ("k", "v"):
            _close(got[name][:, b:b + 1], want[name].numpy(), 1e-5)
    # row 1 wrote rows 30 and 31 only; rows before its offset kept theirs
    assert torch.equal(got["k"][:, 1, :30], ones[1]["k"][:, 0, :30])


@pytest.mark.parametrize("mode", [{}, {"page_size": 4}],
                         ids=["contiguous", "paged"])
def test_interleaved_chunked_admissions_give_jax_tokens(mode):
    """Two long prompts chunked 4 tokens a step in two slots at once,
    handing the engine's one chunk stripe to each other at every chunk
    (the rows of the one that leaves it saved, the other's restored),
    then two more: JAX's lock-step tokens, every chunk counted, one
    chunk program."""
    from repro.serve import lockstep_generate as j_lockstep
    jm, jp, m, tp, cfg = _pair("gemma-7b")
    lens, max_new = (23, 18, 9, 14), [4, 6, 3, 5]
    prompts = [_prompt(cfg.vocab_size, n, 30 + i)
               for i, n in enumerate(lens)]
    oracle = j_lockstep(jm, jp, _j_ctx(), prompts, max_new, max_len=MAX_LEN)
    eng = ServeEngine(m, tp, CTX, num_slots=2, max_len=MAX_LEN,
                      steps_per_dispatch=2, prefill_chunk=4, device="cpu",
                      **mode)
    in_flight, handoffs = [], []
    real, take = eng._advance_chunk, eng._take_stripe

    def spy(slot):
        in_flight.append(len(eng._chunking))
        return real(slot)

    def taking(slot):
        if None not in (eng._stripe_slot, slot) and eng._stripe_slot != slot:
            handoffs.append((eng._stripe_slot, slot))
        return take(slot)

    eng._advance_chunk, eng._take_stripe = spy, taking
    res = eng.run([Request(rid=i, prompt=p, max_new_tokens=k)
                   for i, (p, k) in enumerate(zip(prompts, max_new))])
    assert [res[i].tokens for i in range(4)] == oracle
    assert max(in_flight) == 2
    assert eng.stats.prefill_chunks == sum(-(-n // 4) for n in lens)
    assert len(handoffs) >= 2
    assert {k for k in eng._pf_in if k[0] == "chunk"} == {("chunk",)}


@pytest.mark.parametrize("arch", ["gemma-7b", "seamless-m4t-large-v2",
                                  "zamba2-2.7b"])
def test_every_program_writes_the_engines_one_batch1_cache(arch):
    """Admissions at three buckets and, where the family chunks, a chunk
    return caches whose every leaf but ``pos`` is the engine's one
    batch-1 buffer (its storage, not a copy), so that on the card no
    graph keeps a ``max_len`` cache of its own alive."""
    _, _, m, tp, cfg = _pair(arch)
    chunk = 8 if m.prefill_chunk is not None else None
    eng = ServeEngine(m, tp, CTX, num_slots=2, max_len=MAX_LEN,
                      device="cpu", prefill_chunk=chunk, **_engine_kw(cfg))
    caches = []
    real = eng._prefill_program

    def spy(key):
        logits, cache = real(key)
        caches.append((key, cache))
        return logits, cache

    eng._prefill_program = spy
    for i, n in enumerate((5, 12, 20)):
        eng._admit(Request(rid=i, prompt=_prompt(cfg.vocab_size, n, 60 + i),
                           max_new_tokens=2,
                           frontend_embeds=_frontend(cfg, 70 + i)), i % 2)
    if chunk is not None:
        req = Request(rid=3, prompt=_prompt(cfg.vocab_size, 12, 63),
                      max_new_tokens=2)
        eng._start_chunking(req, 0, 0.0, 0.0)
        eng._advance_chunk(0)
    assert len({k for k, _ in caches}) == 3 + (chunk is not None)
    buf = eng._batch1(CTX.dtype)
    assert list(eng._b1) == [CTX.dtype]
    for _, cache in caches:
        assert cache.keys() - {"pos"} == buf.keys()
        for name, t in buf.items():
            assert cache[name].data_ptr() == t.data_ptr(), name


# ----------------------------------------------------------------------
# no host read inside a body
# ----------------------------------------------------------------------
@pytest.mark.parametrize("arch", ARCHS)
def test_bodies_read_no_device_value_on_the_host(arch):
    """The prefill body of every family, and the chunk body of the
    families that chunk, on an engine on the meta device on the plain
    path: a host read of a device value (``int(t)``, ``.item()``,
    ``bool(t)``) raises there, so a body that runs here can be captured
    without one."""
    with pytest.raises(RuntimeError):
        int(torch.zeros((1,), dtype=torch.int32, device="meta"))
    cfg = get_config(arch, reduced=True)
    m = build_model(cfg)
    chunk = 4 if m.prefill_chunk is not None else None
    eng = ServeEngine(m, m.init(seed=0, device="meta"),
                      Ctx(plan="torch", dtype=torch.float32), num_slots=2,
                      max_len=MAX_LEN, device="meta", prefill_chunk=chunk,
                      **_engine_kw(cfg))
    req = Request(rid=0, prompt=_prompt(cfg.vocab_size, 10, 1),
                  max_new_tokens=4, frontend_embeds=_frontend(cfg, 2))
    logits, cache = eng._prefill_program(eng._load_prefill(req))
    assert logits.device.type == "meta"
    assert logits.shape == (1, 1, cfg.vocab_size)
    assert set(cache) == set(eng._axes) | {"pos"}
    if chunk is not None:
        req = Request(rid=1, prompt=_prompt(cfg.vocab_size, 10, 3),
                      max_new_tokens=4)
        eng._start_chunking(req, 1, 0.0, 0.0)
        logits, cache = eng._prefill_program(
            eng._load_chunk(req.prompt[8:], 8))
        assert logits.shape == (1, 1, cfg.vocab_size)
        assert cache["k"].device.type == "meta"


# ----------------------------------------------------------------------
# on the card (skips here)
# ----------------------------------------------------------------------
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the engine captures its "
                    "programs only on the card")
    return torch.device("cuda")


def _card_requests(cfg, lens=(14, 10, 5, 12, 3, 9)):
    return [Request(rid=i, prompt=_prompt(cfg.vocab_size, n, 40 + i),
                    max_new_tokens=4, frontend_embeds=_frontend(cfg, 50 + i))
            for i, n in enumerate(lens)]


def _card_run(m, params, cfg, *, eager, **kw):
    """Serve the card requests -> (tokens, each request's first-prefill
    logits, the launches run, the engine); ``eager`` stubs the private
    hook so that no prefill or chunk program is captured."""
    eng = ServeEngine(m, params, CTX, device="cuda", num_slots=2,
                      max_len=MAX_LEN, steps_per_dispatch=4,
                      **_engine_kw(cfg), **kw)
    if eager:
        eng._capture_prefill = lambda key: None
    first = {}
    real = eng._first_token

    def spy(req, slot, logits):
        first[req.rid] = logits.clone()
        return real(req, slot, logits)

    eng._first_token = spy
    before = launches.snapshot()
    res = eng.run(_card_requests(cfg))
    torch.cuda.synchronize()
    return ({i: r.tokens for i, r in res.items()}, first,
            launches.since(before), eng)


def _prefill_variants(eng) -> list[str]:
    return [c["variant"] for c in eng.captures
            if c["variant"].startswith("prefill")]


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_graph_equals_eager_prefill_on_card(cuda, arch):
    cfg = get_config(arch, reduced=True)
    m = build_model(cfg)
    params = m.init(seed=0, device=cuda)
    eager = _card_run(m, params, cfg, eager=True)
    graph = _card_run(m, params, cfg, eager=False)
    assert graph[0] == eager[0]
    for rid, logits in eager[1].items():
        assert torch.equal(graph[1][rid], logits), rid
    assert graph[2] == eager[2]
    assert not _prefill_variants(eager[3])
    # buckets 16, 8 and 16 again: every later admission replays
    assert len(_prefill_variants(graph[3])) == len(graph[3]._pf_in) == 2


@pytest.mark.gpu
@pytest.mark.parametrize("mode", [{}, {"page_size": 4}],
                         ids=["contiguous", "paged"])
def test_chunk_graphs_equal_eager_chunks_on_card(cuda, mode):
    cfg = get_config("gemma-7b", reduced=True)
    m = build_model(cfg)
    params = m.init(seed=0, device=cuda)
    eager = _card_run(m, params, cfg, eager=True, prefill_chunk=4, **mode)
    graph = _card_run(m, params, cfg, eager=False, prefill_chunk=4, **mode)
    assert graph[0] == eager[0]
    for rid, logits in eager[1].items():
        assert torch.equal(graph[1][rid], logits), rid
    assert graph[2] == eager[2]
    assert graph[3].stats.prefill_chunks == eager[3].stats.prefill_chunks
    assert [v for v in _prefill_variants(graph[3])
            if v.startswith("prefill_chunk")] == ["prefill_chunk:4"]


@pytest.mark.gpu
def test_a_replay_adds_the_captured_launches_once(cuda):
    cfg = get_config("gemma-7b", reduced=True)
    m = build_model(cfg)
    eng = ServeEngine(m, m.init(seed=0, device=cuda), CTX, device=cuda,
                      num_slots=2, max_len=MAX_LEN)
    reqs = _card_requests(cfg)
    eng._admit(reqs[0], 0)                      # eager, then the capture
    key = eng._load_prefill(reqs[1])
    counts = eng._pf_graphs[key][2]
    assert counts.get("zero_stall_matmul", 0) > 0
    assert counts.get("flash_attention", 0) > 0
    before = launches.snapshot()
    eng._admit(reqs[1], 1)                      # the same bucket: a replay
    torch.cuda.synchronize()
    assert launches.since(before) == counts


@pytest.mark.gpu
def test_sharded_engine_on_one_device_captures_prefill(cuda):
    from repro_torch.launch.mesh import make_mesh_compat
    from repro_torch.serve import ShardedEngine
    cfg = get_config("gemma-7b", reduced=True)
    m = build_model(cfg)
    mesh = make_mesh_compat((1, 1), ("data", "model"), device="cuda")
    eng = ShardedEngine(m, m.init(seed=0, device=cuda), CTX, mesh=mesh,
                        num_slots=2, max_len=MAX_LEN, steps_per_dispatch=4)
    eng.run(_card_requests(cfg))
    assert _prefill_variants(eng) == ["prefill:16", "prefill:8"]


@pytest.mark.gpu
def test_the_collector_is_off_inside_a_capture(cuda):
    """A collection inside a capture could collect a dead engine (a
    reference cycle) and destroy its graphs, which invalidates the
    capture: the engine turns the collector off while it captures and
    back on after."""
    cfg = get_config("gemma-7b", reduced=True)
    m = build_model(cfg)
    eng = ServeEngine(m, m.init(seed=0, device=cuda), CTX, device=cuda,
                      num_slots=2, max_len=MAX_LEN)
    seen = []
    real = eng._prefill_program

    def body(key):
        if torch.cuda.is_current_stream_capturing():
            seen.append(gc.isenabled())
        return real(key)

    eng._prefill_program = body
    assert gc.isenabled()
    eng._admit(_card_requests(cfg)[0], 0)
    assert seen == [False] and gc.isenabled()


@pytest.mark.gpu
def test_no_prefill_is_captured_across_ranks(cuda, tmp_path):
    outs = torch_ranks.world(torch_ranks.prefill_across_ranks, 2, tmp_path,
                             "cuda", device=None, timeout=300)
    assert all(o["captures"] == [] for o in outs)
    assert outs[0]["tokens"] == outs[1]["tokens"]


@pytest.mark.gpu
def test_prefill_graphs_hold_no_cache_of_their_own(cuda):
    """Graphs at three buckets (and a chunk's) keep no ``max_len`` cache
    alive: after the first capture, the memory allocated grows by less
    than one batch-1 cache, the size every graph held when each wrote a
    cache of its own."""
    cfg = get_config("gemma-7b", reduced=True)
    m = build_model(cfg)
    eng = ServeEngine(m, m.init(seed=0, device=cuda), CTX, device=cuda,
                      num_slots=2, max_len=2048, prefill_chunk=16)
    one = sum(t.numel() * t.element_size()
              for t in eng._batch1(CTX.dtype).values())
    reqs = [Request(rid=i, prompt=_prompt(cfg.vocab_size, n, 80 + i),
                    max_new_tokens=2) for i, n in enumerate((5, 12, 40))]
    eng._admit(reqs[0], 0)
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    eng._admit(reqs[1], 1)
    eng._start_chunking(reqs[2], 0, 0.0, 0.0)
    for _ in range(3):
        eng._advance_chunk(0)
    torch.cuda.synchronize()
    assert len(_prefill_variants(eng)) == 3
    assert torch.cuda.memory_allocated() - before < one


@pytest.mark.gpu
def test_a_failed_prefill_capture_raises(cuda, tmp_path):
    """A body that reads a device value on the host runs eagerly at the
    key's first use and cannot be captured: the admission raises (no
    eager fallback).  In a process of its own: the failed capture
    leaves that process's CUDA state unusable."""
    out = torch_ranks.world(torch_ranks.failed_prefill_capture, 1,
                            tmp_path, device=None, timeout=300)
    assert out == [{"raised": True, "graphs": 0}]
