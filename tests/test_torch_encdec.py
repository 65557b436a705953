"""The port's encoder-decoder family (seamless) against the JAX package's, on shared weights.

JAX initialises the reduced seamless-m4t-large-v2 config;
``params_from_numpy`` unstacks its ``encoder`` and ``decoder`` stacks
into lists of layer dicts.  ``encode``, the teacher-forced ``forward``,
``prefill`` (ragged lengths; every cache leaf, the cross-attention K/V
included) and decode steps are held within 1e-4 of JAX (fp32, summed in
another order) on both of the port's backends; the plain gelu MLP
(``mlp_type="mlp"``) within 2e-5 of ``jax.nn.gelu``'s.  The
``ServeEngine`` gives the JAX ``ServeEngine``'s tokens at the same slots
and K (1 and 4), contiguous and paged with ``enc_len``, greedy and
seeded-sampled requests in one run, and the greedy ones equal both
lock-step oracles; paged encdec without ``enc_len`` raises, as in JAX.
The block a CUDA graph captures, run eagerly here, leaves a plain loop
of ``Model.decode`` calls' tokens and caches.  Inputs come from numpy
seeds.
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
from repro.models import encdec as j_encdec
from repro.models import layers as JL
from repro.serve import Request as JRequest
from repro.serve import ServeEngine as JServeEngine
from repro.serve import lockstep_generate as j_lockstep
from repro_torch.configs import get_config
from repro_torch.interop import params_from_numpy
from repro_torch.models import Ctx, build_model, encdec
from repro_torch.models import layers as L
from repro_torch.serve import Request, ServeEngine, lockstep_generate
from torch_tune_cache import port_tune_cache  # noqa: F401 (autouse)

TOL = 1e-4
FP32_TOL = 2e-5
ARCH = "seamless-m4t-large-v2"
J_CTX = JCtx(plan="jnp", dtype=jnp.float32)
CTX = Ctx(plan="auto", dtype=torch.float32)
S_ENC = 12
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


def _frames(cfg, B, S=S_ENC, seed=4):
    return (np.random.default_rng(seed).standard_normal(
        (B, S, cfg.d_model)) * 0.1).astype(np.float32)


def _prompts(vocab, lens=(5, 11, 3, 8)):
    return [[int(t) for t in np.random.default_rng(i).integers(0, vocab, n)]
            for i, n in enumerate(lens)]


# ----------------------------------------------------------------------
# parameters and the model
# ----------------------------------------------------------------------
def test_params_from_numpy_unstacks_encoder_and_decoder():
    jm, jp, m, tp, cfg = _pair()
    assert len(tp["encoder"]) == cfg.encoder_layers
    assert len(tp["decoder"]) == cfg.decoder_layers
    for i in range(cfg.decoder_layers):
        _close(tp["decoder"][i]["cross_attn"]["wk"]["w"],
               jp["decoder"]["cross_attn"]["wk"]["w"][i], tol=0)
        _close(tp["encoder"][i]["mlp"]["wi"]["w"],
               jp["encoder"]["mlp"]["wi"]["w"][i], tol=0)
    _close(tp["enc_norm"]["scale"], jp["enc_norm"]["scale"], tol=0)
    # the untied head keeps JAX's (d, V) values, stored K-major
    head = tp["embed"]["lm_head"]
    _close(head, jp["embed"]["lm_head"], tol=0)
    assert head.t().is_contiguous()
    own = m.init(seed=0, device="cpu")

    def shapes(tree, drop=0):
        return {jax.tree_util.keystr(k): tuple(v.shape)[drop:]
                for k, v in jax.tree_util.tree_leaves_with_path(tree)}
    for name in ("encoder", "decoder"):
        assert shapes(own[name][0]) == shapes(jp[name], drop=1)
    assert "wg" not in own["encoder"][0]["mlp"]       # the plain gelu MLP
    assert own["embed"]["lm_head"].t().is_contiguous()
    assert m.prefill_chunk is None
    bad = jax.tree.map(np.asarray, jp)
    bad["decoder"]["mlp_norm"]["scale"] = \
        bad["decoder"]["mlp_norm"]["scale"][:1]
    with pytest.raises(ValueError, match="decoder_layers"):
        params_from_numpy(bad, cfg, device="cpu")


def test_gelu_mlp_matches_jax():
    """``mlp_type="mlp"``: wi, the tanh-approximated gelu of
    ``jax.nn.gelu``, then wo."""
    jm, jp, m, tp, cfg = _pair()
    x = np.random.default_rng(2).standard_normal(
        (2, 5, cfg.d_model)).astype(np.float32)
    jlp = jax.tree.map(lambda a: a[0], jp["encoder"]["mlp"])
    want = JL.mlp(jlp, jnp.asarray(x), j_get_config(ARCH, reduced=True),
                  J_CTX)
    for backend in ("auto", "torch"):
        got = L.mlp(tp["encoder"][0]["mlp"], torch.from_numpy(x), cfg,
                    Ctx(plan=backend, dtype=torch.float32))
        _close(got, want, tol=FP32_TOL)


@pytest.mark.parametrize("backend", ["auto", "torch"])
def test_encode_and_forward_match_jax(backend):
    jm, jp, m, tp, cfg = _pair()
    jcfg = j_get_config(ARCH, reduced=True)
    ctx = Ctx(plan=backend, dtype=torch.float32)
    frames = _frames(cfg, 2)
    _close(encdec.encode(tp, torch.from_numpy(frames), cfg, ctx),
           j_encdec.encode(jp, jnp.asarray(frames), jcfg, J_CTX))
    toks = np.random.default_rng(3).integers(0, cfg.vocab_size, (2, 7))
    want = j_encdec.forward(jp, jnp.asarray(toks, jnp.int32),
                            jnp.asarray(frames), jcfg, J_CTX)
    got = encdec.forward(tp, torch.from_numpy(toks), torch.from_numpy(frames),
                         cfg, ctx)
    assert got.shape == (2, 7, cfg.vocab_size)
    _close(got, want)
    last = m.prefill_logits(tp, {"tokens": torch.from_numpy(toks),
                                 "frontend_embeds": torch.from_numpy(frames)},
                            ctx)
    _close(last, np.asarray(want)[:, -1:])


@pytest.mark.parametrize("backend", ["auto", "torch"])
def test_prefill_and_decode_match_jax(backend):
    jm, jp, m, tp, cfg = _pair()
    ctx = Ctx(plan=backend, dtype=torch.float32)
    rng = np.random.default_rng(1)
    toks = rng.integers(0, cfg.vocab_size, (3, 11)).astype(np.int32)
    lens = np.array([11, 6, 1], np.int32)
    frames = _frames(cfg, 3)
    jl, jc = jm.prefill(jp, {"tokens": jnp.asarray(toks),
                             "lengths": jnp.asarray(lens),
                             "frontend_embeds": jnp.asarray(frames)},
                        J_CTX, 16)
    tl, tc = m.prefill(tp, {"tokens": torch.from_numpy(toks).long(),
                            "lengths": torch.from_numpy(lens),
                            "frontend_embeds": torch.from_numpy(frames)},
                       ctx, 16)
    _close(tl, jl)
    for name in ("k", "v", "cross_k", "cross_v"):
        assert tuple(tc[name].shape) == jc[name].shape, name
        _close(tc[name], jc[name])
    assert tc["pos"].tolist() == lens.tolist()
    leaves = {n: tc[n] for n in ("k", "v")}
    step = rng.integers(0, cfg.vocab_size, (3, 3, 1)).astype(np.int32)
    for s in range(3):
        jl, jc = jm.decode(jp, jc, jnp.asarray(step[s]), J_CTX)
        tl, tc = m.decode(tp, tc, torch.from_numpy(step[s]).long(), ctx)
        _close(tl, jl)
    for name, t in leaves.items():
        assert tc[name] is t                         # updated in place
        _close(t, jc[name])


def test_init_cache_sizes_the_cross_kv_by_enc_len():
    _, _, m, _, cfg = _pair()
    c = m.init_cache(2, 16, torch.float32, device="cpu", enc_len=5)
    hd = cfg.resolved_head_dim
    assert tuple(c["k"].shape) == (cfg.decoder_layers, 2, 16,
                                   cfg.n_kv_heads, hd)
    assert tuple(c["cross_k"].shape) == (cfg.decoder_layers, 2, 5,
                                         cfg.n_kv_heads, hd)
    assert m.init_cache(2, 16, device="cpu")["cross_v"].shape[2] == 16


# ----------------------------------------------------------------------
# the engine against the JAX engine
# ----------------------------------------------------------------------
def _requests(cls, prompts, frames, max_new=MAX_NEW, sampled=True):
    """rids 0 and 1 greedy, 2 and 3 (with ``sampled``) sampled with their
    own seeds; every request carries its own S_ENC source frames."""
    return [cls(rid=i, prompt=p, max_new_tokens=n, frontend_embeds=frames[i],
                **({} if i < 2 or not sampled else dict(seed=10 + i,
                                                        **KNOBS)))
            for i, (p, n) in enumerate(zip(prompts, max_new))]


@pytest.mark.parametrize("mode", [{}, {"page_size": 4}],
                         ids=["contiguous", "paged"])
@pytest.mark.parametrize("K", [1, 4])
def test_engine_matches_jax_engine(K, mode):
    jm, jp, m, tp, cfg = _pair()
    prompts = _prompts(cfg.vocab_size)
    frames = _frames(cfg, 4)
    kw = dict(num_slots=2, max_len=32, steps_per_dispatch=K, seed=5,
              cache_kwargs={"enc_len": S_ENC}, **mode)
    jeng = JServeEngine(jm, jp, J_CTX, **kw)
    want = jeng.run(_requests(JRequest, prompts, frames))
    eng = ServeEngine(m, tp, CTX, device="cpu", **kw)
    got = eng.run(_requests(Request, prompts, frames))
    assert {i: r.tokens for i, r in got.items()} == \
        {i: [int(t) for t in r.tokens] for i, r in want.items()}
    assert all(len(got[i].tokens) == MAX_NEW[i] for i in range(4))
    s, js = eng.stats, jeng.stats
    assert (s.pages_in_use, s.pages_shared) == (js.pages_in_use,
                                                js.pages_shared)
    # the source frames fill the cross K/V, not the prompt's budget
    assert s.prefill_tokens == sum(map(len, prompts))
    if mode:
        # only the self-attention K/V page; the cross K/V stay per slot
        assert eng._paged == {"k", "v"} and s.pages_shared == 0
        assert eng.cache["cross_k"].shape[1:3] == (2, S_ENC)


@pytest.mark.parametrize("K", [1, 4])
def test_engine_matches_lockstep_oracles(K):
    jm, jp, m, tp, cfg = _pair()
    prompts = _prompts(cfg.vocab_size)
    frames = _frames(cfg, 4)
    want = j_lockstep(jm, jp, J_CTX, prompts, MAX_NEW, max_len=32,
                      frontend_embeds=frames)
    mine = lockstep_generate(m, tp, CTX, prompts, MAX_NEW, max_len=32,
                             frontend_embeds=frames, device="cpu")
    assert mine == [[int(t) for t in w] for w in want]
    eng = ServeEngine(m, tp, CTX, device="cpu", num_slots=2, max_len=32,
                      steps_per_dispatch=K, page_size=8,
                      cache_kwargs={"enc_len": S_ENC})
    got = eng.run(_requests(Request, prompts, frames, sampled=False))
    assert [got[i].tokens for i in range(4)] == mine


def test_paged_encdec_requires_enc_len():
    _, _, m, tp, _ = _pair()
    with pytest.raises(ValueError, match="explicit enc_len"):
        ServeEngine(m, tp, CTX, device="cpu", num_slots=2, max_len=32,
                    page_size=4)
    # as in the JAX package, the encdec cache takes no quantize_kv
    with pytest.raises(TypeError, match="quantize_kv"):
        ServeEngine(m, tp, CTX, device="cpu", num_slots=2, max_len=32,
                    cache_kwargs={"quantize_kv": True})


@pytest.mark.parametrize("mode", [{}, {"page_size": 4}],
                         ids=["contiguous", "paged"])
def test_block_equals_plain_loop(mode):
    """The block a CUDA graph captures, run eagerly: its tokens, ``pos``
    and self and cross K/V are those of a plain loop of decode calls;
    the cross K/V are read, never written."""
    _, _, m, tp, cfg = _pair()
    eng = ServeEngine(m, tp, CTX, device="cpu", num_slots=3, max_len=32,
                      steps_per_dispatch=4,
                      cache_kwargs={"enc_len": S_ENC}, **mode)
    frames = _frames(cfg, 3)
    for slot, p in enumerate(_prompts(cfg.vocab_size, (5, 9, 4))):
        eng._admit(Request(rid=slot, prompt=p, max_new_tokens=8,
                           frontend_embeds=frames[slot]), slot)
    cache = {k: v.clone() for k, v in eng.cache.items()}
    tok = torch.tensor([3, 200, 17])
    done = torch.tensor([False, True, False])
    out = []
    for _ in range(4):
        logits, cache = m.decode(tp, cache, tok[:, None], CTX)
        tok = torch.where(done, tok, logits[:, -1].argmax(-1))
        out.append(tok)
    cross = eng.cache["cross_k"].clone()
    tile = eng._decode_block(np.array([3, 200, 17], np.int32),
                             np.array([False, True, False]),
                             np.array([9, 0, 9], np.int32), greedy_only=True)
    assert torch.equal(tile, torch.stack(out, dim=1))
    assert torch.equal(eng.cache["pos"], cache["pos"])
    assert torch.equal(eng.cache["cross_k"], cross)
    for name in ("k", "v"):
        assert torch.equal(eng.cache[name], cache[name])


def test_serve_batch_encdec_on_cpu():
    from repro_torch.launch.serve import make_requests, serve_batch
    out = serve_batch(ARCH, batch=4, prompt_len=8, gen_len=4, num_slots=2,
                      mixed=True, device="cpu", page_size=4)
    assert out["generated"].shape == (4, 4)
    assert (out["generated"] >= 0).all()
    assert out["stats"]["pages_in_use"] > 0
    cfg = get_config(ARCH, reduced=True)
    reqs = make_requests(cfg, 0, 4, 8, 4, True, device="cpu")
    # each request's frames are its own: prompt_len of them, from (seed, i)
    assert all(tuple(r.frontend_embeds.shape) == (8, cfg.d_model)
               for r in reqs)
    assert not torch.equal(reqs[0].frontend_embeds, reqs[1].frontend_embeds)
    again = make_requests(cfg, 0, 4, 8, 4, True, device="cpu")
    assert torch.equal(reqs[3].frontend_embeds, again[3].frontend_embeds)
