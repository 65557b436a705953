"""Paged serving and chunked prefill in the port, against the JAX package.

The same numpy inputs go through ``repro.kernels.ops.paged_attention``
(the Pallas kernel in interpret mode) and the port's
``ops.paged_attention``, whose "auto" backend on this CPU runs the
kernel wrapper's plain version: 2e-5 in fp32, 2e-2 in bf16, for one and
four query heads per kv head, two page sizes, a row parked on the trash
page, a row with no valid column and a row whose length runs past its
table.  On the plain path, paged decode attention is bitwise equal to
contiguous decode.  The paged engine, with and without chunked prefill,
with a shared system prompt and with an oversubscribed pool, must give
the greedy tokens of JAX ``lockstep_generate`` on the same converted
weights (both reduced configs, fp32, both backends, K = 1 and 4).  The
test marked ``gpu`` launches the CUDA kernel and skips without a card.
"""

import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.kernels import ops as jops
from repro.models import Ctx as JCtx
from repro.models import build_model as j_build_model
from repro.plan import KernelConfig as JKernelConfig
from repro.serve import lockstep_generate as j_lockstep
from repro_torch.configs import get_config
from repro_torch.interop import params_from_numpy, tensor_from_numpy
from repro_torch.kernels import ops
from repro_torch.kernels.paged_attention import paged_attention
from repro_torch.kernels.paged_attention import smem_bytes as pa_smem
from repro_torch.kernels.ref import paged_attention_ref
from repro_torch.models import Ctx, build_model
from repro_torch.models import layers as L
from repro_torch.serve import (TRASH_PAGE, OutOfPages, Request,
                               ServeEngine)
from torch_tune_cache import port_tune_cache  # noqa: F401 (autouse)

FP32_TOL, BF16_TOL = 2e-5, 2e-2
J_INTERP = JKernelConfig(backend="interpret")
J_CTX = JCtx(plan="jnp", dtype=jnp.float32)
ARCHS = ["gemma-7b", "deepseek-coder-33b"]
MAX_NEW = [6, 3, 5, 7]


def _prompts(vocab, lens=(5, 11, 3, 8)):
    return [list(np.random.default_rng(i).integers(0, vocab, n))
            for i, n in enumerate(lens)]


@functools.lru_cache(maxsize=None)
def _pair(arch):
    jcfg = j_get_config(arch, reduced=True)
    cfg = get_config(arch, reduced=True)
    jm, m = j_build_model(jcfg), build_model(cfg)
    jp = jm.init(jax.random.PRNGKey(0), dtype=jnp.float32)
    return jm, jp, m, params_from_numpy(jax.tree.map(np.asarray, jp), cfg,
                                        device="cpu")


@functools.lru_cache(maxsize=None)
def _oracle(arch, lens=(5, 11, 3, 8), max_new=tuple(MAX_NEW), max_len=32,
            prefix=()):
    jm, jp, _, _ = _pair(arch)
    prompts = [list(prefix) + p for p in _prompts(256, lens)]
    return prompts, j_lockstep(jm, jp, J_CTX, prompts, list(max_new),
                               max_len=max_len)


def _run(engine, prompts, max_new):
    res = engine.run([Request(rid=i, prompt=p, max_new_tokens=n)
                      for i, (p, n) in enumerate(zip(prompts, max_new))])
    return [res[i].tokens for i in range(len(prompts))]


# ----------------------------------------------------------------------
# ops.paged_attention against the Pallas kernel in interpret mode
# ----------------------------------------------------------------------
def _paged_inputs(rng, *, rep, ps, B=4, KV=2, D=16, T=4):
    """Pools with random contents on every page (the trash page too),
    scattered page ids, row 1 with kv_len 0, row 2 parked on the trash
    page, row 3 with kv_len past its table's T*ps."""
    P = B * T + 1
    q = rng.standard_normal((B, KV * rep, D)).astype(np.float32)
    kp = rng.standard_normal((P, ps, KV, D)).astype(np.float32)
    vp = rng.standard_normal((P, ps, KV, D)).astype(np.float32)
    table = (1 + rng.permutation(P - 1)[:B * T]).reshape(B, T)
    table[2] = TRASH_PAGE
    table = table.astype(np.int32)
    kv_lens = np.array([T * ps - 3, 0, ps + 1, T * ps + 7], np.int32)
    return q, kp, vp, table, kv_lens


@pytest.mark.parametrize("ps", [4, 8])
@pytest.mark.parametrize("rep", [1, 4])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_paged_attention_matches_jax_interpret(rng, dtype, rep, ps):
    q, kp, vp, table, kv_lens = _paged_inputs(rng, rep=rep, ps=ps)
    jd = jnp.float32 if dtype == "float32" else jnp.bfloat16
    jq, jk, jv = (jnp.asarray(x, jd) for x in (q, kp, vp))
    want = jops.paged_attention(jq, jk, jv, jnp.asarray(table),
                                kv_lens=jnp.asarray(kv_lens),
                                config=J_INTERP)
    before = paged_attention.launches
    got = ops.paged_attention(
        *(tensor_from_numpy(np.asarray(x), device="cpu")
          for x in (jq, jk, jv)),
        torch.from_numpy(table), kv_lens=torch.from_numpy(kv_lens),
        config="auto")
    assert paged_attention.launches == before     # plain version on the CPU
    assert got.dtype == getattr(torch, dtype) and got.shape == q.shape
    tol = FP32_TOL if dtype == "float32" else BF16_TOL
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), atol=tol,
                               rtol=tol)
    assert bool((got[1] == 0).all())              # kv_len 0: exact zeros


def test_paged_attention_torch_backend_matches_jax_reference(rng):
    """The port's "torch" backend against JAX "jnp" on rows that see at
    least one column (the JAX reference averages a row with kv_len 0
    uniformly; the port's plain version zeroes it, as both kernels do)."""
    q, kp, vp, table, kv_lens = _paged_inputs(rng, rep=4, ps=4)
    kv_lens[1] = 2
    want = jops.paged_attention(*(jnp.asarray(x) for x in (q, kp, vp)),
                                jnp.asarray(table),
                                kv_lens=jnp.asarray(kv_lens),
                                config=JKernelConfig(backend="jnp"))
    got = ops.paged_attention(*(torch.from_numpy(x) for x in (q, kp, vp)),
                              torch.from_numpy(table),
                              kv_lens=torch.from_numpy(kv_lens),
                              config="torch")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=FP32_TOL,
                               rtol=FP32_TOL)


def test_paged_wrapper_validates_before_launch():
    q, kp = torch.zeros(2, 4, 8), torch.zeros(5, 4, 2, 8)
    table, lens = torch.zeros(2, 3, dtype=torch.int32), torch.ones(
        2, dtype=torch.int32)
    with pytest.raises(ValueError, match="multiple of kv heads"):
        paged_attention(torch.zeros(2, 3, 8), kp, kp, table, kv_lens=lens)
    with pytest.raises(ValueError, match="page_table"):
        paged_attention(q, kp, kp, table[:1], kv_lens=lens)
    with pytest.raises(ValueError, match="pools"):
        paged_attention(q, kp, kp[:, :2], table, kv_lens=lens)
    # one D = 256 bf16 page of 16 rows at rep 8 fits; 64-row fp32 does not
    assert pa_smem(256, 16, 8, 2) < 232448 < pa_smem(256, 64, 8, 4)


# ----------------------------------------------------------------------
# the plain paged decode path is the contiguous one
# ----------------------------------------------------------------------
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("arch", ARCHS)
def test_attention_decode_paged_torch_is_bitwise_contiguous(arch, dtype):
    cfg = get_config(arch, reduced=True)
    p = build_model(cfg).init(seed=0, dtype=dtype, device="cpu")
    lp = p["layers"][0]["attn"]
    B, ps, T = 3, 4, 6
    KV, hd = cfg.n_kv_heads, cfg.resolved_head_dim
    g = torch.Generator().manual_seed(0)
    x = torch.randn(B, 1, cfg.d_model, generator=g).to(dtype)
    cont = {n: torch.randn(B, T * ps, KV, hd, generator=g).to(dtype)
            for n in ("k", "v")}
    pos = torch.tensor([0, 9, T * ps - 1], dtype=torch.int32)
    table = (1 + torch.randperm(B * T, generator=g)).reshape(B, T).to(
        torch.int32)
    pool = {n: torch.zeros(B * T + 1, ps, KV, hd, dtype=dtype)
            for n in ("k", "v")}
    for n in ("k", "v"):
        pool[n][table.long()] = cont[n].reshape(B, T, ps, KV, hd)
    for backend in ("torch", "auto"):
        ctx = Ctx(plan=backend, dtype=dtype)
        c = {n: t.clone() for n, t in cont.items()}
        pl = {n: t.clone() for n, t in pool.items()}
        want, _ = L.attention_decode(lp, x, cfg, ctx, cache=c, pos=pos)
        got, out = L.attention_decode_paged(lp, x, cfg, ctx, cache=pl,
                                            page_table=table, pos=pos)
        assert out["k"] is pl["k"]                     # updated in place
        for n in ("k", "v"):      # the new token landed in its page
            for b in range(B):
                j, o = divmod(int(pos[b]), ps)
                assert torch.equal(pl[n][table[b, j], o], c[n][b, pos[b]])
        if backend == "torch":
            assert torch.equal(got, want)
        else:
            tol = FP32_TOL if dtype == torch.float32 else BF16_TOL
            torch.testing.assert_close(got.float(), want.float(), atol=tol,
                                       rtol=tol)


def test_scatter_paged_clips_into_the_last_table_entry():
    pool = torch.zeros(4, 2, 1, 1)
    table = torch.tensor([[2, 3], [0, 0]], dtype=torch.int32)
    new = torch.tensor([5.0, 7.0]).reshape(2, 1, 1, 1)
    L._scatter_paged(pool, new, table, torch.tensor([9, 1]))
    assert pool[3, 1, 0, 0] == 5.0       # pos 9 past T*ps=4 -> page 3
    assert pool[0, 1, 0, 0] == 7.0       # a parked row writes the trash
    assert pool.sum() == 12.0


# ----------------------------------------------------------------------
# the paged engine against JAX lockstep_generate
# ----------------------------------------------------------------------
@pytest.mark.parametrize("mode", [{"page_size": 4},
                                  {"page_size": 4, "prefill_chunk": 4}])
@pytest.mark.parametrize("K", [1, 4])
@pytest.mark.parametrize("backend", ["auto", "torch"])
@pytest.mark.parametrize("arch", ARCHS)
def test_paged_engine_matches_jax_lockstep(arch, backend, K, mode):
    _, _, m, tp = _pair(arch)
    prompts, oracle = _oracle(arch)
    engine = ServeEngine(m, tp, Ctx(plan=backend, dtype=torch.float32),
                         num_slots=2, max_len=32, steps_per_dispatch=K,
                         device="cpu", **mode)
    assert _run(engine, prompts, MAX_NEW) == oracle
    s = engine.stats
    assert s.admitted == s.retired == 4 and s.pages_in_use > 0
    # prompts of 5, 11, 3 and 8 tokens in chunks of 4: 2 + 3 + 2 chunks
    assert s.prefill_chunks == (7 if "prefill_chunk" in mode else 0)
    assert s.prefill_tokens == sum(map(len, prompts))
    # only the published prefix pages stay allocated, and every table
    # row is back on the trash page
    assert engine.pages_in_use_now == len(engine._prefix.pages)
    engine._prefix.clear()
    assert engine.pages_in_use_now == 0
    assert bool((engine.cache["page_table"] == TRASH_PAGE).all())


def test_router_hooks_match_jax_at_every_step():
    """``free_slots`` (a slot parked on a chunked admission is not free),
    ``queue_depth``, ``pages_in_use_now`` and ``pop_results`` against the
    JAX engine's after each step of a paged run with chunked prefill:
    five requests on two slots, so some queue while others chunk."""
    from repro.serve import Request as JRequest
    from repro.serve import ServeEngine as JServeEngine
    jm, jp, m, tp = _pair("gemma-7b")
    prompts = _prompts(256, (5, 11, 3, 8, 9))
    kw = dict(num_slots=2, max_len=32, steps_per_dispatch=2, page_size=4,
              prefill_chunk=4)
    eng = ServeEngine(m, tp, Ctx(plan="auto", dtype=torch.float32),
                      device="cpu", **kw)
    jeng = JServeEngine(jm, jp, J_CTX, **kw)
    for e, cls in ((eng, Request), (jeng, JRequest)):
        for i, p in enumerate(prompts):
            e.submit(cls(rid=i, prompt=p, max_new_tokens=4 + i % 3))

    def hooks(e):
        return (e.free_slots, e.queue_depth, e.pages_in_use_now,
                sorted(e._chunking))
    assert hooks(eng) == hooks(jeng) == (2, 5, 0, [])
    got, want, parked = {}, {}, 0
    while not (eng.idle and jeng.idle):
        eng.step()
        jeng.step()
        assert hooks(eng) == hooks(jeng)
        parked += bool(eng._chunking)
        popped, jpopped = eng.pop_results(), jeng.pop_results()
        assert sorted(popped) == sorted(jpopped)
        got.update({i: r.tokens for i, r in popped.items()})
        want.update({i: r.tokens for i, r in jpopped.items()})
        assert eng.pop_results() == {}
    assert parked > 0 and got == want and sorted(got) == list(range(5))
    # a popped rid is no longer live: it may be submitted again
    eng.submit(Request(rid=0, prompt=prompts[0], max_new_tokens=2))
    assert eng.queue_depth == 1


def test_chunked_prefill_whose_last_chunk_overruns_max_len():
    """A 26-token prompt in chunks of 12 at max_len 32: the last chunk
    starts at 24 and its padding would run to 36.  Only the rows that
    fit are written, so the tokens are still the oracle's."""
    _, _, m, tp = _pair("gemma-7b")
    prompts, oracle = _oracle("gemma-7b", lens=(26, 11, 20, 8))
    for mode in ({"prefill_chunk": 12}, {"prefill_chunk": 12,
                                         "page_size": 4}):
        engine = ServeEngine(m, tp, Ctx(plan="auto", dtype=torch.float32),
                             num_slots=2, max_len=32, steps_per_dispatch=4,
                             device="cpu", **mode)
        assert _run(engine, prompts, MAX_NEW) == oracle
        assert engine.stats.prefill_chunks == 3 + 2


@pytest.mark.parametrize("arch", ARCHS)
def test_prefix_sharing_is_copy_on_write_and_matches(arch):
    """Two requests behind one 16-token system prompt: the second maps the
    first's 4 prefix pages into its table, neither's decode writes them,
    and both still give the oracle's tokens."""
    _, _, m, tp = _pair(arch)
    sys_prompt = tuple(range(10, 26))
    prompts, oracle = _oracle(arch, lens=(2, 3), max_new=(4, 3),
                              prefix=sys_prompt)
    engine = ServeEngine(m, tp, Ctx(plan="auto", dtype=torch.float32),
                         num_slots=2, max_len=32, steps_per_dispatch=4,
                         page_size=4, device="cpu")
    snaps = []
    real = engine._decode_block

    def spy(*a, **kw):
        if not snaps:       # both admitted, no decode write yet
            shared = engine._slot_pages[0][:4]
            assert engine._slot_pages[1][:4] == shared
            snaps.append((shared, {n: engine.cache[n][:, shared].clone()
                                   for n in ("k", "v")}))
        return real(*a, **kw)

    engine._decode_block = spy
    assert _run(engine, prompts, [4, 3]) == oracle
    shared, before = snaps[0]
    for n, t in before.items():
        assert torch.equal(engine.cache[n][:, shared], t)
    per_req = [math.ceil((len(p) + k) / 4) for p, k in zip(prompts, (4, 3))]
    assert engine.stats.pages_shared == 4
    assert engine.stats.pages_in_use == per_req[0] + per_req[1] - 4


@pytest.mark.parametrize("K", [1, 4])
def test_oversubscribed_pool_requeues_and_still_matches(K):
    """13 pages of working set in 9 usable: admission evicts cold prefix
    entries, requeues, and resumes once a decode retires."""
    _, _, m, tp = _pair("deepseek-coder-33b")
    prompts, oracle = _oracle("deepseek-coder-33b")
    engine = ServeEngine(m, tp, Ctx(plan="auto", dtype=torch.float32),
                         num_slots=4, max_len=32, steps_per_dispatch=K,
                         page_size=4, num_pages=10, prefill_chunk=6,
                         device="cpu")
    assert _run(engine, prompts, MAX_NEW) == oracle
    s = engine.stats
    assert s.pages_in_use <= 9 and s.admitted == s.retired == 4
    assert s.max_concurrent < 4            # the pool, not the slots, capped


def test_exhausted_pool_with_nothing_active_raises():
    _, _, m, tp = _pair("gemma-7b")
    for chunk in (None, 2):
        engine = ServeEngine(m, tp, Ctx(plan="auto", dtype=torch.float32),
                             num_slots=1, max_len=8, page_size=4, num_pages=2,
                             prefill_chunk=chunk, device="cpu")
        engine.submit(Request(rid=0, prompt=[1, 2, 3], max_new_tokens=4))
        with pytest.raises(OutOfPages):
            engine.run()


def test_paged_engine_validates_geometry_and_capacity():
    _, _, m, tp = _pair("gemma-7b")
    ctx = Ctx(plan="auto", dtype=torch.float32)
    with pytest.raises(ValueError, match="must be >= 1 and divide max_len"):
        ServeEngine(m, tp, ctx, max_len=32, page_size=5, device="cpu")
    with pytest.raises(ValueError, match="prefill_chunk must be >= 1"):
        ServeEngine(m, tp, ctx, max_len=32, prefill_chunk=0, device="cpu")
    engine = ServeEngine(m, tp, ctx, num_slots=2, max_len=16, page_size=4,
                         device="cpu")
    assert engine.cache["k"].shape == (2, 2 * 4 + 1, 4, 4, 32)
    assert engine.cache["page_table"].shape == (2, 4)
    with pytest.raises(ValueError, match=r"page-table capacity 16 "
                                         r"\(4 pages x 4 tokens/page\)"):
        engine.submit(Request(rid=0, prompt=list(range(20)),
                              max_new_tokens=1))
    with pytest.raises(ValueError, match="exceeds max_len"):
        engine.submit(Request(rid=1, prompt=list(range(10)),
                              max_new_tokens=10))


# ----------------------------------------------------------------------
# every family's cache through one engine, and the prefix-sharing rule
# ----------------------------------------------------------------------
FAMILY_ARCHS = ["gemma-7b", "olmoe-1b-7b", "mamba2-130m", "zamba2-2.7b"]


@functools.lru_cache(maxsize=None)
def _family_pair(arch):
    jcfg = j_get_config(arch, reduced=True)
    cfg = get_config(arch, reduced=True)
    jm, m = j_build_model(jcfg), build_model(cfg)
    jp = jm.init(jax.random.PRNGKey(0), dtype=jnp.float32)
    return jm, jp, m, params_from_numpy(jax.tree.map(np.asarray, jp), cfg,
                                        device="cpu")


@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_cache_leaf_batch_axes_match_jax(arch):
    """Each leaf's batch axis, probed from two batch sizes: dense and MoE
    K/V and the SSM state lead with their layers, the hybrid's state
    with (groups, attn_every) and its K/V with the groups."""
    from repro.serve import ServeEngine as JServeEngine
    jm, jp, m, tp = _family_pair(arch)
    jeng = JServeEngine(jm, jp, J_CTX, num_slots=2, max_len=16)
    eng = ServeEngine(m, tp, Ctx(plan="auto", dtype=torch.float32),
                      num_slots=2, max_len=16, device="cpu")
    want = {k: v for k, v in jeng._axes.items() if k != "pos"}
    assert eng._axes == want
    assert eng._axes == {"gemma-7b": {"k": 1, "v": 1},
                         "olmoe-1b-7b": {"k": 1, "v": 1},
                         "mamba2-130m": {"conv": 1, "ssm": 1},
                         "zamba2-2.7b": {"conv": 2, "ssm": 2, "k": 1,
                                         "v": 1}}[arch]


@pytest.mark.parametrize("K", [1, 4])
def test_pure_ssm_paged_degrades_to_contiguous(K):
    """mamba2 has no leaf that grows with max_len: asked for pages, the
    engine runs contiguous, with zero page gauges and the oracle's
    tokens, as the JAX engine does."""
    jm, jp, m, tp = _family_pair("mamba2-130m")
    prompts = _prompts(256)
    oracle = j_lockstep(jm, jp, J_CTX, prompts, MAX_NEW, max_len=32)
    engine = ServeEngine(m, tp, Ctx(plan="auto", dtype=torch.float32),
                         num_slots=2, max_len=32, steps_per_dispatch=K,
                         page_size=4, device="cpu")
    assert not engine._pages_active and "page_table" not in engine.cache
    assert engine.cache["ssm"].dtype == torch.float32
    assert _run(engine, prompts, MAX_NEW) == oracle
    s = engine.stats
    assert (s.pages_in_use, s.pages_shared, engine.pages_in_use_now) == \
        (0, 0, 0)


def _shared_prefix_run(arch, prefix, tails, max_new=3, K=1):
    """The port's and the JAX paged engine (2 slots, 4-token pages) on
    prompts ``prefix + tail``: (port engine, its tokens, for each
    admission whether every page it was given held its own prefill K/V
    right after the install, JAX engine, its tokens)."""
    from repro.serve import Request as JRequest
    from repro.serve import ServeEngine as JServeEngine
    jm, jp, m, tp = _family_pair(arch)
    prompts = [list(prefix) + list(t) for t in tails]
    kw = dict(num_slots=2, max_len=48, steps_per_dispatch=K, page_size=4)
    jeng = JServeEngine(jm, jp, J_CTX, **kw)
    jres = jeng.run([JRequest(rid=i, prompt=p, max_new_tokens=max_new)
                     for i, p in enumerate(prompts)])
    eng = ServeEngine(m, tp, Ctx(plan="auto", dtype=torch.float32),
                      device="cpu", **kw)
    installed = []
    real = eng._install

    def spy(req, slot, cache1, n_prompt):
        real(req, slot, cache1, n_prompt)
        n, ps = len(req.prompt), eng._geom.page_size
        own = [torch.equal(eng.cache[name][:, page, :rows],
                           cache1[name][:, 0, j * ps:j * ps + rows])
               for j, page in enumerate(eng._slot_pages[slot][:-(-n // ps)])
               for rows in [min(ps, n - j * ps)] for name in ("k", "v")]
        installed.append(all(own))

    eng._install = spy
    res = eng.run([Request(rid=i, prompt=p, max_new_tokens=max_new)
                   for i, p in enumerate(prompts)])
    return (eng, [res[i].tokens for i in range(len(prompts))], installed,
            jeng, [[int(t) for t in jres[i].tokens]
                   for i in range(len(prompts))])


def test_moe_admissions_share_no_prefix_page():
    """MoE expert capacity depends on the whole prompt, so a prefix's K/V
    depend on the rest of it: olmoe prompts of 9 to 32 tokens behind one
    8-token prefix share no page (as in the JAX engine), and each
    installed page holds the request's own prefill K/V."""
    tails = [np.random.default_rng(20 + i).integers(0, 256, n).tolist()
             for i, n in enumerate((1, 24, 10, 17))]
    prefix = np.random.default_rng(19).integers(0, 256, 8).tolist()
    eng, toks, installed, jeng, jtoks = _shared_prefix_run(
        "olmoe-1b-7b", prefix, tails)
    assert eng.stats.pages_shared == jeng.stats.pages_shared == 0
    assert toks == jtoks
    assert len(eng._prefix.pages) == 0          # nothing was published
    assert installed == [True] * 4


@pytest.mark.parametrize("arch", ["gemma-7b", "zamba2-2.7b"])
def test_dense_and_hybrid_still_share_prefix_pages(arch):
    """Four prompts behind one 16-token system prompt: the dense and the
    hybrid family map the published prefix pages, as many as the JAX
    engine does, and give its tokens."""
    tails = [np.random.default_rng(30 + i).integers(0, 256, n).tolist()
             for i, n in enumerate((3, 9, 5, 12))]
    eng, toks, installed, jeng, jtoks = _shared_prefix_run(
        arch, list(range(10, 26)), tails, K=4)
    assert eng.stats.pages_shared == jeng.stats.pages_shared >= 4
    assert toks == jtoks


# ----------------------------------------------------------------------
# on the card (skips here)
# ----------------------------------------------------------------------
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    return torch.device("cuda")


@pytest.mark.gpu
def test_paged_kernel_matches_plain_on_card(cuda, rng):
    for dtype, rep, ps in ((torch.float32, 4, 4), (torch.bfloat16, 1, 8)):
        q, kp, vp, table, kv_lens = (torch.from_numpy(x).to(cuda) for x in
                                     _paged_inputs(rng, rep=rep, ps=ps))
        q, kp, vp = q.to(dtype), kp.to(dtype), vp.to(dtype)
        before = paged_attention.launches
        got = paged_attention(q, kp, vp, table, kv_lens=kv_lens)
        assert paged_attention.launches == before + 1
        want = paged_attention_ref(q, kp, vp, table, kv_lens=kv_lens)
        tol = FP32_TOL if dtype == torch.float32 else BF16_TOL
        torch.testing.assert_close(got.float(), want.float(), atol=tol,
                                   rtol=tol)
        assert bool((got[1] == 0).all())
