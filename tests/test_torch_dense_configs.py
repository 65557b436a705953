"""The port's registry, and the last two dense configs (qwen1.5-32b with QKV bias, mistral-large-123b), against the JAX package.

Every registered config, full and reduced, equals the JAX package's
field by field (``remat`` included) with the same ``param_count()``,
and the port registers what JAX registers.  On the reduced qwen1.5-32b (biased wq/wk/wv) and
mistral-large-123b (8 heads over 2 kv heads) configs, prefill and decode
logits are held within 1e-4 of JAX (fp32) on both of the port's
backends, and the ``ServeEngine`` gives the JAX ``ServeEngine``'s tokens
at the same slots and K (1 and 4), contiguous and paged; qwen also in
W8A8, its biases added after the int8 product.  Inputs come from numpy
seeds.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.configs import list_configs as j_list_configs
from repro.models import Ctx as JCtx
from repro.models import build_model as j_build_model
from repro.plan import Plan
from repro.serve import Request as JRequest
from repro.serve import ServeEngine as JServeEngine
from repro_torch.configs import get_config, list_configs
from repro_torch.interop import params_from_numpy
from repro_torch.models import Ctx, build_model
from repro_torch.plan import KernelConfig
from repro_torch.quant import QTensor
from repro_torch.serve import Request, ServeEngine
from torch_tune_cache import port_tune_cache  # noqa: F401 (autouse)

TOL = 1e-4
ARCHS = ["qwen1.5-32b", "mistral-large-123b"]
J_CTX = JCtx(plan="jnp", dtype=jnp.float32)
CTX = Ctx(plan="auto", dtype=torch.float32)
MAX_NEW = [6, 3, 5, 7]


@functools.lru_cache(maxsize=None)
def _pair(arch, quantized=False):
    jcfg = j_get_config(arch, reduced=True)
    cfg = get_config(arch, reduced=True)
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
# the registry
# ----------------------------------------------------------------------
def test_registry_equals_jax():
    assert list_configs() == j_list_configs()


@pytest.mark.parametrize("arch", j_list_configs())
@pytest.mark.parametrize("reduced", [False, True], ids=["full", "reduced"])
def test_config_fields_and_param_count_equal_jax(arch, reduced):
    mine = get_config(arch, reduced=reduced)
    theirs = j_get_config(arch, reduced=reduced)
    fields = {f.name for f in dataclasses.fields(mine)}
    assert fields == {f.name for f in dataclasses.fields(theirs)}
    for f in sorted(fields):
        assert getattr(mine, f) == getattr(theirs, f), f
    assert mine.resolved_head_dim == theirs.resolved_head_dim
    assert mine.param_count() == theirs.param_count()


def test_own_init_has_the_qkv_bias_leaves():
    """qwen's wq, wk and wv carry a zero ``b`` leaf (JAX's init), wo and
    the MLP none; the port's own tree has JAX's leaves and shapes."""
    _, jp, m, _, cfg = _pair("qwen1.5-32b")
    own = m.init(seed=0, device="cpu")
    attn = own["layers"][0]["attn"]
    for w in ("wq", "wk", "wv"):
        assert torch.equal(attn[w]["b"], torch.zeros(attn[w]["w"].shape[1]))
    assert "b" not in attn["wo"] and "b" not in own["layers"][0]["mlp"]["wi"]

    def shapes(tree, drop=0):
        return {jax.tree_util.keystr(k): tuple(v.shape)[drop:]
                for k, v in jax.tree_util.tree_leaves_with_path(tree)}
    assert shapes(own["layers"][0]) == shapes(jp["layers"], drop=1)
    assert own["embed"]["lm_head"].t().is_contiguous()


# ----------------------------------------------------------------------
# the models
# ----------------------------------------------------------------------
def _biased(jp, seed=5):
    """JAX's params with random nonzero QKV biases (its init zeroes them,
    which would leave the bias path untested)."""
    rng = np.random.default_rng(seed)
    jp = jax.tree.map(lambda a: a, jp)
    attn = dict(jp["layers"]["attn"])
    for w in ("wq", "wk", "wv"):
        b = attn[w]["b"]
        attn[w] = {**attn[w], "b": jnp.asarray(
            rng.standard_normal(b.shape).astype(np.float32) * 0.1)}
    return {**jp, "layers": {**jp["layers"], "attn": attn}}


@pytest.mark.parametrize("backend", ["auto", "torch"])
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_jax(arch, backend):
    jm, jp, m, tp, cfg = _pair(arch)
    if cfg.qkv_bias:
        jp = _biased(jp)
        tp = params_from_numpy(jax.tree.map(np.asarray, jp), cfg,
                               device="cpu")
        assert float(tp["layers"][1]["attn"]["wk"]["b"].abs().sum()) > 0
    ctx = Ctx(plan=backend, dtype=torch.float32)
    rng = np.random.default_rng(1)
    toks = rng.integers(0, cfg.vocab_size, (3, 11)).astype(np.int32)
    lens = np.array([11, 6, 1], np.int32)
    _close(m.prefill_logits(tp, {"tokens": torch.from_numpy(toks).long()},
                            ctx),
           jm.prefill_logits(jp, {"tokens": jnp.asarray(toks)}, J_CTX))
    jl, jc = jm.prefill(jp, {"tokens": jnp.asarray(toks),
                             "lengths": jnp.asarray(lens)}, J_CTX, 16)
    tl, tc = m.prefill(tp, {"tokens": torch.from_numpy(toks).long(),
                            "lengths": torch.from_numpy(lens)}, ctx, 16)
    _close(tl, jl)
    for name in ("k", "v"):
        _close(tc[name], jc[name])
    step = rng.integers(0, cfg.vocab_size, (3, 3, 1)).astype(np.int32)
    for s in range(3):
        jl, jc = jm.decode(jp, jc, jnp.asarray(step[s]), J_CTX)
        tl, tc = m.decode(tp, tc, torch.from_numpy(step[s]).long(), ctx)
        _close(tl, jl)


@pytest.mark.parametrize("mode", [{}, {"page_size": 4}],
                         ids=["contiguous", "paged"])
@pytest.mark.parametrize("K", [1, 4])
@pytest.mark.parametrize("arch", ARCHS)
def test_engine_matches_jax_engine(arch, K, mode):
    jm, jp, m, tp, cfg = _pair(arch)
    prompts = _prompts(cfg.vocab_size)
    kw = dict(num_slots=2, max_len=32, steps_per_dispatch=K, **mode)
    want = JServeEngine(jm, jp, J_CTX, **kw).run(
        [JRequest(rid=i, prompt=p, max_new_tokens=n)
         for i, (p, n) in enumerate(zip(prompts, MAX_NEW))])
    got = ServeEngine(m, tp, CTX, device="cpu", **kw).run(
        [Request(rid=i, prompt=p, max_new_tokens=n)
         for i, (p, n) in enumerate(zip(prompts, MAX_NEW))])
    assert {i: r.tokens for i, r in got.items()} == \
        {i: [int(t) for t in r.tokens] for i, r in want.items()}


@pytest.mark.parametrize("K", [1, 4])
def test_qwen_w8a8_engine_matches_jax_engine(K):
    """W8A8 qwen: wq/wk/wv are int8 QTensors with a full-precision bias
    beside them; logits within 1e-4 and tokens equal to the JAX
    engine's under ``quant="int8"``."""
    jm, jp, m, tp, cfg = _pair("qwen1.5-32b", quantized=True)
    wq = tp["layers"][0]["attn"]["wq"]
    assert isinstance(wq["w"], QTensor) and wq["w"].w8a8
    assert not isinstance(wq["b"], QTensor)
    jctx = JCtx(plan=Plan(backend="jnp", quant="int8"), dtype=jnp.float32)
    ctx = Ctx(plan=KernelConfig(quant="int8"), dtype=torch.float32)
    toks = np.random.default_rng(2).integers(0, cfg.vocab_size, (2, 9))
    _close(m.prefill_logits(tp, {"tokens": torch.from_numpy(toks)}, ctx),
           jm.prefill_logits(jp, {"tokens": jnp.asarray(toks, jnp.int32)},
                             jctx))
    prompts = _prompts(cfg.vocab_size)
    kw = dict(num_slots=2, max_len=32, steps_per_dispatch=K)
    want = JServeEngine(jm, jp, jctx, **kw).run(
        [JRequest(rid=i, prompt=p, max_new_tokens=n)
         for i, (p, n) in enumerate(zip(prompts, MAX_NEW))])
    got = ServeEngine(m, tp, ctx, device="cpu", **kw).run(
        [Request(rid=i, prompt=p, max_new_tokens=n)
         for i, (p, n) in enumerate(zip(prompts, MAX_NEW))])
    assert {i: r.tokens for i, r in got.items()} == \
        {i: [int(t) for t in r.tokens] for i, r in want.items()}
