"""The port's hybrid family (zamba2) against the JAX package's, on shared weights.

JAX initialises the reduced zamba2-2.7b config; ``params_from_numpy``
converts its ``(n_groups, attn_every, ...)`` mamba layers into groups of
layer dicts and its shared block as a plain tree.  The forward logits,
prefill (ragged lengths) logits, conv and ssm state and shared-block
K/V, then decode steps on the contiguous cache and on a page pool, are
held within 1e-4 of JAX (fp32, summed in another order), on both of the
port's backends.  The ``ServeEngine`` gives the JAX ``ServeEngine``'s
tokens at the same slots and K (1 and 4), contiguous and paged, greedy
and seeded-sampled requests, and in W8A8; the block a CUDA graph
captures, run eagerly here, leaves the tokens, ``pos`` and conv and ssm
state of a plain loop of ``Model.decode`` calls.  Inputs come from
numpy seeds.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.models import Ctx as JCtx
from repro.models import build_model as j_build_model
from repro.plan import Plan
from repro.serve import Request as JRequest
from repro.serve import ServeEngine as JServeEngine
from repro_torch.configs import get_config
from repro_torch.interop import params_from_numpy
from repro_torch.models import Ctx, build_model
from repro_torch.plan import KernelConfig
from repro_torch.quant import QTensor
from repro_torch.serve import Request, ServeEngine, sampling
from torch_tune_cache import port_tune_cache  # noqa: F401 (autouse)

TOL = 1e-4
ARCH = "zamba2-2.7b"
J_CTX = JCtx(plan="jnp", dtype=jnp.float32)
CTX = Ctx(plan="auto", dtype=torch.float32)
MAX_NEW = [6, 3, 5, 7]
KNOBS = dict(temperature=0.9, top_k=20, top_p=0.95)


@functools.lru_cache(maxsize=None)
def _pair(quantized=False):
    jcfg = j_get_config(ARCH, reduced=True)
    cfg = get_config(ARCH, reduced=True)
    jm, m = j_build_model(jcfg), build_model(cfg)
    jp = jm.init(jax.random.PRNGKey(0), dtype=jnp.float32)
    if quantized:
        jp = jm.quantize_weights(jp)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), cfg, device="cpu")
    return jm, jp, m, tp, cfg


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), atol=tol,
                               rtol=tol)


def _prompts(vocab, lens=(5, 11, 3, 8)):
    return [[int(t) for t in np.random.default_rng(i).integers(0, vocab, n)]
            for i, n in enumerate(lens)]


# ----------------------------------------------------------------------
# parameters and the model
# ----------------------------------------------------------------------
def test_params_from_numpy_groups_layers_and_keeps_shared():
    jm, jp, m, tp, cfg = _pair()
    ng, ae = cfg.n_layers // cfg.attn_every, cfg.attn_every
    assert len(tp["layers"]) == ng and all(len(g) == ae
                                           for g in tp["layers"])
    for g in range(ng):
        for i in range(ae):
            _close(tp["layers"][g][i]["mamba"]["conv_w"],
                   jp["layers"]["mamba"]["conv_w"][g, i], tol=0)
    _close(tp["shared"]["pre_proj"]["w"], jp["shared"]["pre_proj"]["w"],
           tol=0)
    _close(tp["shared"]["attn"]["wq"]["w"], jp["shared"]["attn"]["wq"]["w"],
           tol=0)
    # the port's own init has the same tree and shapes
    own = m.init(seed=0, device="cpu")

    def shapes(tree, drop=0):
        return {jax.tree_util.keystr(k): tuple(v.shape)[drop:]
                for k, v in jax.tree_util.tree_leaves_with_path(tree)}
    assert shapes(own["layers"][0][0]) == shapes(jp["layers"], drop=2)
    assert shapes(own["shared"]) == shapes(jp["shared"])
    assert m.prefill_chunk is None
    bad = jax.tree.map(np.asarray, jp)
    bad["layers"]["norm"]["scale"] = bad["layers"]["norm"]["scale"][:, :1]
    with pytest.raises(ValueError, match="attn_every"):
        params_from_numpy(bad, cfg, device="cpu")


def test_forward_logits_match_jax():
    jm, jp, m, tp, cfg = _pair()
    toks = np.random.default_rng(3).integers(0, cfg.vocab_size, (2, 7))
    want = jm.prefill_logits(jp, {"tokens": jnp.asarray(toks, jnp.int32)},
                             J_CTX)
    for backend in ("auto", "torch"):
        got = m.prefill_logits(tp, {"tokens": torch.from_numpy(toks)},
                               Ctx(plan=backend, dtype=torch.float32))
        assert got.shape == (2, 1, cfg.vocab_size)
        _close(got, want)


def _prefill_both(jm, jp, m, tp, cfg, ctx, max_len=16):
    rng = np.random.default_rng(1)
    toks = rng.integers(0, cfg.vocab_size, (3, 11)).astype(np.int32)
    lens = np.array([11, 6, 1], np.int32)
    jl, jc = jm.prefill(jp, {"tokens": jnp.asarray(toks),
                             "lengths": jnp.asarray(lens)}, J_CTX, max_len)
    tl, tc = m.prefill(tp, {"tokens": torch.from_numpy(toks).long(),
                            "lengths": torch.from_numpy(lens)}, ctx, max_len)
    return rng, lens, (jl, jc), (tl, tc)


@pytest.mark.parametrize("backend", ["auto", "torch"])
def test_prefill_and_contiguous_decode_match_jax(backend):
    jm, jp, m, tp, cfg = _pair()
    ctx = Ctx(plan=backend, dtype=torch.float32)
    rng, lens, (jl, jc), (tl, tc) = _prefill_both(jm, jp, m, tp, cfg, ctx)
    _close(tl, jl)
    for name in ("conv", "ssm", "k", "v"):
        assert tuple(tc[name].shape) == jc[name].shape, name
        _close(tc[name], jc[name])
    assert tc["pos"].tolist() == lens.tolist()
    leaves = {n: tc[n] for n in ("conv", "ssm", "k", "v")}
    step = rng.integers(0, cfg.vocab_size, (3, 3, 1)).astype(np.int32)
    for s in range(3):
        jl, jc = jm.decode(jp, jc, jnp.asarray(step[s]), J_CTX)
        tl, tc = m.decode(tp, tc, torch.from_numpy(step[s]).long(), ctx)
        _close(tl, jl)
    for name, t in leaves.items():
        assert tc[name] is t                         # updated in place
        _close(t, jc[name])


@pytest.mark.parametrize("backend", ["auto", "torch"])
def test_paged_decode_matches_jax(backend):
    """The shared block's K/V scattered into a pool through a scattered
    page table (row 2's tail on the trash page): paged decode gives
    JAX's paged decode logits, and the new tokens land in the pool."""
    jm, jp, m, tp, cfg = _pair()
    ctx = Ctx(plan=backend, dtype=torch.float32)
    rng, lens, (_, jc), (_, tc) = _prefill_both(jm, jp, m, tp, cfg, ctx)
    B, ps, T = 3, 4, 4
    table = (1 + rng.permutation(B * T)).reshape(B, T).astype(np.int32)
    table[2, 1:] = 0
    jpaged = dict(jc)
    tpaged = dict(tc)
    for name in ("k", "v"):
        c = np.asarray(jc[name])                     # (ng, B, 16, KV, D)
        pool = np.zeros((c.shape[0], B * T + 1, ps) + c.shape[3:],
                        np.float32)
        for b in range(B):
            for j in range(T):
                pool[:, table[b, j]] = c[:, b, j * ps:(j + 1) * ps]
        jpaged[name] = jnp.asarray(pool)
        tpaged[name] = torch.from_numpy(pool.copy())
    jpaged["page_table"] = jnp.asarray(table)
    tpaged["page_table"] = torch.from_numpy(table)
    pools = {n: tpaged[n] for n in ("k", "v")}
    step = rng.integers(0, cfg.vocab_size, (2, 3, 1)).astype(np.int32)
    for s in range(2):
        jl, jpaged = jm.decode(jp, jpaged, jnp.asarray(step[s]), J_CTX)
        tl, tpaged = m.decode(tp, tpaged, torch.from_numpy(step[s]).long(),
                              ctx)
        _close(tl, jl)
    assert torch.equal(tpaged["page_table"], torch.from_numpy(table))
    for name, t in pools.items():
        assert tpaged[name] is t
        _close(t, jpaged[name])
    for name in ("conv", "ssm"):
        _close(tpaged[name], jpaged[name])


# ----------------------------------------------------------------------
# the engine against the JAX engine
# ----------------------------------------------------------------------
def _requests(cls, prompts, max_new=MAX_NEW):
    """rids 0 and 1 greedy, 2 and 3 sampled with their own seeds: the
    first dispatches run the greedy-only block, the later ones the
    sampled one."""
    return [cls(rid=i, prompt=p, max_new_tokens=n,
                **({} if i < 2 else dict(seed=10 + i, **KNOBS)))
            for i, (p, n) in enumerate(zip(prompts, max_new))]


@pytest.mark.parametrize("mode", [{}, {"page_size": 4}],
                         ids=["contiguous", "paged"])
@pytest.mark.parametrize("K", [1, 4])
def test_engine_matches_jax_engine(K, mode):
    jm, jp, m, tp, cfg = _pair()
    prompts = _prompts(cfg.vocab_size)
    kw = dict(num_slots=2, max_len=32, steps_per_dispatch=K, seed=5, **mode)
    jeng = JServeEngine(jm, jp, J_CTX, **kw)
    want = jeng.run(_requests(JRequest, prompts))
    eng = ServeEngine(m, tp, CTX, device="cpu", **kw)
    got = eng.run(_requests(Request, prompts))
    assert {i: r.tokens for i, r in got.items()} == \
        {i: [int(t) for t in r.tokens] for i, r in want.items()}
    assert all(len(got[i].tokens) == MAX_NEW[i] for i in range(4))
    s, js = eng.stats, jeng.stats
    assert (s.pages_in_use, s.pages_shared) == (js.pages_in_use,
                                                js.pages_shared)
    if mode:
        assert s.pages_in_use > 0 and eng._pages_active
        # the conv and ssm state stay per slot, in fp32
        assert eng.cache["conv"].shape[2] == 2
        assert eng.cache["ssm"].dtype == torch.float32


@pytest.mark.parametrize("K", [1, 4])
def test_w8a8_engine_matches_jax_engine(K):
    jm, jp, m, tp, cfg = _pair(quantized=True)
    shared = tp["shared"]
    assert shared["pre_proj"]["w"].w8a8 and shared["attn"]["wq"]["w"].w8a8
    assert not tp["layers"][0][0]["mamba"]["in_proj"]["w"].w8a8
    prompts = _prompts(cfg.vocab_size)
    kw = dict(num_slots=2, max_len=32, steps_per_dispatch=K)
    jeng = JServeEngine(jm, jp, JCtx(plan=Plan(backend="jnp", quant="int8"),
                                     dtype=jnp.float32), **kw)
    want = jeng.run([JRequest(rid=i, prompt=p, max_new_tokens=n)
                     for i, (p, n) in enumerate(zip(prompts, MAX_NEW))])
    eng = ServeEngine(m, tp, Ctx(plan=KernelConfig(quant="int8"),
                                 dtype=torch.float32), device="cpu", **kw)
    got = eng.run([Request(rid=i, prompt=p, max_new_tokens=n)
                   for i, (p, n) in enumerate(zip(prompts, MAX_NEW))])
    assert {i: r.tokens for i, r in got.items()} == \
        {i: [int(t) for t in r.tokens] for i, r in want.items()}


def test_quantize_weights_keeps_ssm_leaves():
    _, _, m, tp, _ = _pair()
    q = m.quantize_weights(tp)
    layer = q["layers"][1][0]["mamba"]
    assert isinstance(layer["in_proj"]["w"], QTensor)
    assert not layer["in_proj"]["w"].w8a8
    for k in ("conv_w", "A_log", "D", "dt_bias"):
        assert torch.equal(layer[k], tp["layers"][1][0]["mamba"][k])
    assert q["shared"]["mlp"]["wi"]["w"].w8a8


# ----------------------------------------------------------------------
# the block a CUDA graph captures, against a plain loop
# ----------------------------------------------------------------------
def _loop(eng, tok, done, budget, *, greedy_only):
    """The engine's block as a plain loop of ``Model.decode`` calls over
    a copy of the engine's state: (tokens, cache)."""
    cache = {k: v.clone() for k, v in eng.cache.items()}
    keys = eng._keys.clone()
    tok, done = torch.from_numpy(tok).long(), torch.from_numpy(done)
    budget = torch.from_numpy(budget)
    temp, topk, topp = (torch.from_numpy(x) for x in
                        (eng._temp, eng._topk, eng._topp))
    out = []
    for _ in range(eng.steps_per_dispatch):
        logits, cache = eng.model.decode(eng.params, cache, tok[:, None],
                                         eng.ctx)
        if greedy_only:
            nxt = sampling.greedy(logits[:, -1])
        else:
            keys2, nxt = sampling.sample(logits[:, -1], keys, temp, topk,
                                         topp)
            keys = torch.where(done[:, None], keys, keys2)
        nxt = torch.where(done, tok, nxt.long())
        budget = budget - (~done).to(torch.int32)
        done = done | (budget <= 0)
        tok = nxt
        out.append(nxt)
    return torch.stack(out, dim=1), cache


@pytest.mark.parametrize("greedy_only", [True, False])
@pytest.mark.parametrize("mode", [{}, {"page_size": 4}],
                         ids=["contiguous", "paged"])
def test_block_equals_plain_loop(mode, greedy_only):
    _, _, m, tp, _ = _pair()
    eng = ServeEngine(m, tp, CTX, device="cpu", num_slots=3, max_len=32,
                      steps_per_dispatch=4, **mode)
    temp = 0.0 if greedy_only else 0.9
    for slot, p in enumerate(_prompts(256, (5, 9, 4))):
        eng._admit(Request(rid=slot, prompt=p, max_new_tokens=8, seed=slot,
                           temperature=temp, top_k=20, top_p=0.95), slot)
    tok = np.array([3, 200, 17], np.int32)
    done = np.array([False, True, False])     # slot 1 is frozen
    budget = np.array([2, 0, 9], np.int32)    # slot 0 runs out mid-block
    want_tile, want = _loop(eng, tok, done, budget, greedy_only=greedy_only)
    state = {n: eng.cache[n] for n in ("conv", "ssm")}
    tile = eng._decode_block(tok, done, budget, greedy_only=greedy_only)
    assert torch.equal(tile, want_tile)
    assert torch.equal(eng.cache["pos"], want["pos"])
    for name, t in state.items():
        assert eng.cache[name] is t            # nothing is copied back
        assert torch.equal(t, want[name])
