"""The port's vision-language family (llava) against the JAX package's, on shared weights.

JAX initialises the reduced llava-next-34b config (a dense tree);
``params_from_numpy`` converts it.  A request's ``(P, d)`` patch
embeddings are prepended to its prompt: the forward logits (text
positions only), prefill (ragged lengths, every cache leaf, ``pos =
lengths + P``) and decode steps are held within 1e-4 of JAX (fp32) on
both of the port's backends.  The ``ServeEngine`` gives the JAX
``ServeEngine``'s tokens at the same slots and K (1 and 4), contiguous
and paged, greedy and seeded-sampled requests in one run; a ``max_len``
of exactly prompt + P + generation is served (the prefix eats into the
prompt bucket); a request with a frontend publishes and maps no prefix
page while a text-only one shares, and it is never chunked, as in JAX.
Inputs come from numpy seeds.
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
from repro.serve import Request as JRequest
from repro.serve import ServeEngine as JServeEngine
from repro.serve import lockstep_generate as j_lockstep
from repro_torch.configs import get_config
from repro_torch.interop import params_from_numpy
from repro_torch.models import Ctx, build_model
from repro_torch.serve import Request, ServeEngine, lockstep_generate
from torch_tune_cache import port_tune_cache  # noqa: F401 (autouse)

TOL = 1e-4
ARCH = "llava-next-34b"
J_CTX = JCtx(plan="jnp", dtype=jnp.float32)
CTX = Ctx(plan="auto", dtype=torch.float32)
MAX_NEW = [6, 3, 5, 7]
KNOBS = dict(temperature=0.9, top_k=20, top_p=0.95)


@functools.lru_cache(maxsize=None)
def _pair():
    jcfg = j_get_config(ARCH, reduced=True)
    cfg = get_config(ARCH, reduced=True)
    jm, m = j_build_model(jcfg), build_model(cfg)
    jp = jm.init(jax.random.PRNGKey(0), dtype=jnp.float32)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), cfg, device="cpu")
    return jm, jp, m, tp, cfg


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), atol=tol,
                               rtol=tol)


def _patches(cfg, B, seed=4):
    return (np.random.default_rng(seed).standard_normal(
        (B, cfg.frontend_tokens, cfg.d_model)) * 0.1).astype(np.float32)


def _prompts(vocab, lens=(5, 11, 3, 8)):
    return [[int(t) for t in np.random.default_rng(i).integers(0, vocab, n)]
            for i, n in enumerate(lens)]


# ----------------------------------------------------------------------
# the model
# ----------------------------------------------------------------------
@pytest.mark.parametrize("backend", ["auto", "torch"])
def test_forward_logits_match_jax(backend):
    jm, jp, m, tp, cfg = _pair()
    ctx = Ctx(plan=backend, dtype=torch.float32)
    toks = np.random.default_rng(3).integers(0, cfg.vocab_size, (2, 7))
    fe = _patches(cfg, 2)
    jb = {"tokens": jnp.asarray(toks, jnp.int32),
          "frontend_embeds": jnp.asarray(fe)}
    tb = {"tokens": torch.from_numpy(toks),
          "frontend_embeds": torch.from_numpy(fe)}
    got = m.prefill_logits(tp, tb, ctx)
    assert got.shape == (2, 1, cfg.vocab_size)
    _close(got, jm.prefill_logits(jp, jb, J_CTX))
    from repro.models import transformer as jt
    from repro_torch.models import transformer
    want = jt.forward(jp, jb["tokens"], j_get_config(ARCH, reduced=True),
                      J_CTX, frontend_embeds=jb["frontend_embeds"])
    got = transformer.forward(tp, tb["tokens"], cfg, ctx,
                              frontend_embeds=tb["frontend_embeds"])
    assert got.shape == (2, 7, cfg.vocab_size)       # text positions only
    _close(got, want)


@pytest.mark.parametrize("backend", ["auto", "torch"])
def test_prefill_and_decode_match_jax(backend):
    jm, jp, m, tp, cfg = _pair()
    ctx = Ctx(plan=backend, dtype=torch.float32)
    rng = np.random.default_rng(1)
    toks = rng.integers(0, cfg.vocab_size, (3, 11)).astype(np.int32)
    lens = np.array([11, 6, 1], np.int32)
    fe = _patches(cfg, 3)
    max_len = 11 + cfg.frontend_tokens + 5
    jl, jc = jm.prefill(jp, {"tokens": jnp.asarray(toks),
                             "lengths": jnp.asarray(lens),
                             "frontend_embeds": jnp.asarray(fe)},
                        J_CTX, max_len)
    tl, tc = m.prefill(tp, {"tokens": torch.from_numpy(toks).long(),
                            "lengths": torch.from_numpy(lens),
                            "frontend_embeds": torch.from_numpy(fe)},
                       ctx, max_len)
    _close(tl, jl)
    for name in ("k", "v"):
        assert tuple(tc[name].shape) == jc[name].shape, name
        _close(tc[name], jc[name])
    assert tc["pos"].tolist() == (lens + cfg.frontend_tokens).tolist()
    step = rng.integers(0, cfg.vocab_size, (3, 3, 1)).astype(np.int32)
    for s in range(3):
        jl, jc = jm.decode(jp, jc, jnp.asarray(step[s]), J_CTX)
        tl, tc = m.decode(tp, tc, torch.from_numpy(step[s]).long(), ctx)
        _close(tl, jl)
    _close(tc["k"], jc["k"])


# ----------------------------------------------------------------------
# the engine against the JAX engine
# ----------------------------------------------------------------------
def _requests(cls, prompts, fe, max_new=MAX_NEW, sampled=True):
    return [cls(rid=i, prompt=p, max_new_tokens=n,
                frontend_embeds=None if fe is None else fe[i],
                **({} if i < 2 or not sampled else dict(seed=10 + i,
                                                        **KNOBS)))
            for i, (p, n) in enumerate(zip(prompts, max_new))]


@pytest.mark.parametrize("mode", [{}, {"page_size": 4}],
                         ids=["contiguous", "paged"])
@pytest.mark.parametrize("K", [1, 4])
def test_engine_matches_jax_engine(K, mode):
    jm, jp, m, tp, cfg = _pair()
    prompts = _prompts(cfg.vocab_size)
    fe = _patches(cfg, 4)
    kw = dict(num_slots=2, max_len=32, steps_per_dispatch=K, seed=5, **mode)
    jeng = JServeEngine(jm, jp, J_CTX, **kw)
    want = jeng.run(_requests(JRequest, prompts, fe))
    eng = ServeEngine(m, tp, CTX, device="cpu", **kw)
    got = eng.run(_requests(Request, prompts, fe))
    assert {i: r.tokens for i, r in got.items()} == \
        {i: [int(t) for t in r.tokens] for i, r in want.items()}
    s, js = eng.stats, jeng.stats
    assert (s.pages_in_use, s.pages_shared) == (js.pages_in_use,
                                                js.pages_shared)
    greedy = lockstep_generate(m, tp, CTX, prompts[:2], MAX_NEW[:2],
                               max_len=32, frontend_embeds=fe[:2],
                               device="cpu")
    assert [got[i].tokens for i in range(2)] == greedy == [
        [int(t) for t in w] for w in j_lockstep(
            jm, jp, J_CTX, prompts[:2], MAX_NEW[:2], max_len=32,
            frontend_embeds=fe[:2])]


@pytest.mark.parametrize("mode", [{}, {"page_size": 4}],
                         ids=["contiguous", "paged"])
def test_engine_vlm_tight_max_len(mode):
    """A max_len of exactly prompt + frontend + generation: the prompt's
    bucket is clamped to max_len - P = 28 (unclamped it would pad the
    24-token prompt to 32, and 32 + P passes the cache), as in the JAX
    engine."""
    jm, jp, m, tp, cfg = _pair()
    prompt_len, gen = 24, 4
    max_len = prompt_len + cfg.frontend_tokens + gen
    fe = _patches(cfg, 2)
    prompts = _prompts(cfg.vocab_size, lens=(prompt_len, 13))[:2]
    eng = ServeEngine(m, tp, CTX, device="cpu", num_slots=2, max_len=max_len,
                      **mode)
    got = eng.run(_requests(Request, prompts, fe, [gen, gen],
                            sampled=False))
    want = j_lockstep(jm, jp, J_CTX, prompts, gen, max_len=max_len,
                      frontend_embeds=fe)
    assert [got[i].tokens for i in range(2)] == [[int(t) for t in w]
                                                 for w in want]
    limit = max_len - cfg.frontend_tokens
    assert eng._bucket(prompt_len, limit) == limit < 32
    with pytest.raises(ValueError, match="exceeds max_len"):
        eng.submit(Request(rid=9, prompt=[1] * prompt_len,
                           max_new_tokens=gen + 1, frontend_embeds=fe[0]))


def test_frontend_requests_share_no_prefix_page():
    """Four requests behind one 8-token prefix, paged with 4-token
    pages: with frontends no page is published or mapped twice; text
    only, the prefix pages are shared; both as in the JAX engine."""
    jm, jp, m, tp, cfg = _pair()
    rng = np.random.default_rng(7)
    prefix = [int(t) for t in rng.integers(0, cfg.vocab_size, 8)]
    prompts = [prefix + [int(t) for t in rng.integers(0, cfg.vocab_size, n)]
               for n in (4, 6, 3, 5)]
    fe = _patches(cfg, 4)
    kw = dict(num_slots=2, max_len=32, steps_per_dispatch=2, page_size=4)
    for front in (fe, None):
        eng = ServeEngine(m, tp, CTX, device="cpu", **kw)
        got = eng.run(_requests(Request, prompts, front, sampled=False))
        jeng = JServeEngine(jm, jp, J_CTX, **kw)
        want = jeng.run(_requests(JRequest, prompts, front, sampled=False))
        assert {i: r.tokens for i, r in got.items()} == \
            {i: [int(t) for t in r.tokens] for i, r in want.items()}
        assert eng.stats.pages_shared == jeng.stats.pages_shared
        if front is None:
            assert eng.stats.pages_shared > 0 and len(eng._prefix) > 0
        else:
            assert eng.stats.pages_shared == 0 and len(eng._prefix) == 0


def test_frontend_request_is_never_chunked():
    """With prefill_chunk set, a request with a frontend is admitted in
    one prefill and a long text-only one in chunks; tokens as the JAX
    engine's."""
    jm, jp, m, tp, cfg = _pair()
    prompts = _prompts(cfg.vocab_size, (11, 12))
    fe = _patches(cfg, 2)

    def reqs(cls):
        return [cls(rid=0, prompt=prompts[0], max_new_tokens=4,
                    frontend_embeds=fe[0]),
                cls(rid=1, prompt=prompts[1], max_new_tokens=4)]

    kw = dict(num_slots=2, max_len=32, page_size=4, prefill_chunk=4)
    eng = ServeEngine(m, tp, CTX, device="cpu", **kw)
    assert not eng._chunkable(reqs(Request)[0])
    assert eng._chunkable(reqs(Request)[1])
    got = eng.run(reqs(Request))
    want = JServeEngine(jm, jp, J_CTX, **kw).run(reqs(JRequest))
    assert {i: r.tokens for i, r in got.items()} == \
        {i: [int(t) for t in r.tokens] for i, r in want.items()}
    assert eng.stats.prefill_chunks == 3          # 12 tokens, chunks of 4


def test_serve_batch_vlm_on_cpu():
    from repro_torch.launch.serve import make_requests, serve_batch
    cfg = get_config(ARCH, reduced=True)
    out = serve_batch(ARCH, batch=4, prompt_len=8, gen_len=4, num_slots=2,
                      mixed=True, device="cpu", page_size=4)
    assert out["generated"].shape == (4, 4)
    assert (out["generated"] >= 0).all()
    assert out["stats"]["pages_shared"] == 0
    reqs = make_requests(cfg, 0, 4, 8, 4, True, device="cpu")
    assert all(tuple(r.frontend_embeds.shape) == (cfg.frontend_tokens,
                                                  cfg.d_model) for r in reqs)
