"""The port's int8 KV cache and forward loss against the JAX package's.

JAX initialises each reduced config; ``params_from_numpy`` converts it.
The int8 cache (``init_cache(quantize_kv=True)``, decode through
``attention_decode_quantized``) is run token by token beside JAX's
``decode_step`` on reduced qwen1.5-32b (dense, QKV bias), olmoe-1b-7b
(MoE) and llava-next-34b (vlm) in fp32: at every step the int8 codes
equal JAX's except where the value sits on a rounding boundary (``|t /
scale|`` within 1e-6 relative of a .5, where the two fp32 products may
fall either side: those differ by one), the scales agree within 2e-6
relative (the k and v they are the absmax of differ by a few fp32 ulps
after several layers: 1.08e-6 at most on llava), the logits within
1e-4 of the largest magnitude and the
greedy argmax exactly; and the quantized cache is held against the
port's own fp32 cache with JAX's gate (``tests/test_models.py``: rel <
5%, argmax equal).  The engine refuses the cache (the reference engine
cannot serve it).  ``cross_entropy`` and every family's ``Model.loss``
match JAX in fp32 within 1e-5 relative.  Inputs come from numpy seeds.
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
from repro.models import layers as JL
from repro_torch.configs import get_config
from repro_torch.interop import params_from_numpy
from repro_torch.models import Ctx, build_model
from repro_torch.models import layers as L
from repro_torch.serve import ServeEngine
from torch_tune_cache import port_tune_cache  # noqa: F401 (autouse)

J_CTX = JCtx(plan="jnp", dtype=jnp.float32)
STEPS, B = 12, 2
SCALE_TOL = 2e-6
LOSS_TOL = 1e-5


@functools.lru_cache(maxsize=None)
def _pair(arch):
    jcfg, cfg = j_get_config(arch, reduced=True), get_config(arch,
                                                             reduced=True)
    jm, m = j_build_model(jcfg), build_model(cfg)
    jp = jm.init(jax.random.PRNGKey(0), dtype=jnp.float32)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), cfg, device="cpu")
    return jm, jp, m, tp, cfg


def _tokens(cfg, steps=STEPS, seed=2):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size,
                                                (B, steps))


# ----------------------------------------------------------------------
# the quantizer
# ----------------------------------------------------------------------
def test_quantize_kv_matches_the_reference_rule():
    """absmax / 127 + 1e-8 in fp32, round half to even, clip to 127:
    bit-equal to the JAX formula, ties included."""
    rng = np.random.default_rng(0)
    t = rng.standard_normal((3, 1, 4, 16)).astype(np.float32)
    t[0, 0, 0, :4] = [127.0, 0.5, 1.5, -2.5]          # exact ties
    jt = jnp.asarray(t)
    scale = (jnp.max(jnp.abs(jt), axis=-1, keepdims=True)
             .astype(jnp.float32) / 127.0 + 1e-8)
    want = jnp.clip(jnp.round(jt / scale), -127, 127).astype(jnp.int8)
    codes, s = L._quantize_kv(torch.from_numpy(t), torch.float32)
    assert codes.dtype == torch.int8
    np.testing.assert_array_equal(codes.numpy(), np.asarray(want))
    np.testing.assert_array_equal(s.numpy(), np.asarray(scale))


def test_init_cache_quantize_kv_leaves_match_jax():
    jm, _, m, _, cfg = _pair("qwen1.5-32b")
    jc = jm.init_cache(B, 8, jnp.float32, quantize_kv=True)
    c = m.init_cache(B, 8, torch.float32, device="cpu", quantize_kv=True)
    assert set(c) == set(jc)
    for name in jc:
        assert tuple(c[name].shape) == jc[name].shape, name
        assert str(c[name].dtype).removeprefix("torch.") == \
            str(jc[name].dtype), name


# ----------------------------------------------------------------------
# decode lockstep against JAX
# ----------------------------------------------------------------------
def _near_half(ratio: np.ndarray) -> np.ndarray:
    """|t / scale| within 1e-6 relative of a .5 rounding boundary."""
    a = np.abs(ratio.astype(np.float64))
    return np.abs(a - np.floor(a) - 0.5) <= 1e-6 * np.maximum(a, 1.0)


@pytest.mark.parametrize("arch", ["qwen1.5-32b", "olmoe-1b-7b",
                                  "llava-next-34b"])
def test_int8_cache_decode_matches_jax_lockstep(arch, monkeypatch):
    jm, jp, m, tp, cfg = _pair(arch)
    ctx = Ctx(plan="auto", dtype=torch.float32)
    toks = _tokens(cfg)
    jc = jm.init_cache(B, STEPS, jnp.float32, quantize_kv=True)
    c = m.init_cache(B, STEPS, torch.float32, device="cpu",
                     quantize_kv=True)
    # the values each layer quantizes, in call order (k then v a layer)
    seen = []
    real = L._quantize_kv

    def spy(t, dtype):
        seen.append(t.detach().clone())
        return real(t, dtype)

    monkeypatch.setattr(L, "_quantize_kv", spy)
    for s in range(STEPS):
        tok = toks[:, s:s + 1]
        jl, jc = jm.decode(jp, jc, jnp.asarray(tok, jnp.int32), J_CTX)
        seen.clear()
        lg, c = m.decode(tp, c, torch.as_tensor(tok), ctx)
        jl = np.asarray(jl)
        np.testing.assert_allclose(lg.numpy(), jl, rtol=0,
                                   atol=1e-4 * np.abs(jl).max())
        assert (lg.numpy().argmax(-1) == jl.argmax(-1)).all(), s
        for name in ("k_scale", "v_scale"):
            np.testing.assert_allclose(c[name][:, :, :s + 1].numpy(),
                                       np.asarray(jc[name])[:, :, :s + 1],
                                       rtol=SCALE_TOL, atol=0)
        for layer in range(cfg.n_layers):
            for j, name in enumerate(("k", "v")):
                got = c[name][layer, :, s].numpy().astype(np.int32)
                want = np.asarray(jc[name])[layer, :, s].astype(np.int32)
                t = seen[2 * layer + j][:, 0].numpy()
                ratio = t / c[name + "_scale"][layer, :, s].numpy()
                diff = got != want
                assert (np.abs(got - want) <= 1).all(), (s, layer, name)
                assert _near_half(ratio[diff]).all(), (s, layer, name)


@pytest.mark.parametrize("arch", ["qwen1.5-32b", "olmoe-1b-7b",
                                  "llava-next-34b"])
def test_int8_cache_within_the_reference_gate_of_fp32(arch):
    """JAX's own gate (tests/test_models.py): the int8 cache's logits
    within 5% of the fp32 cache's largest, the same argmax."""
    _, _, m, tp, cfg = _pair(arch)
    ctx = Ctx(plan="auto", dtype=torch.float32)
    toks = torch.as_tensor(_tokens(cfg, seed=5))
    cf = m.init_cache(B, STEPS, torch.float32, device="cpu")
    cq = m.init_cache(B, STEPS, torch.float32, device="cpu",
                      quantize_kv=True)
    for s in range(STEPS):
        lf, cf = m.decode(tp, cf, toks[:, s:s + 1], ctx)
        lq, cq = m.decode(tp, cq, toks[:, s:s + 1], ctx)
    lf, lq = lf.numpy(), lq.numpy()
    assert np.abs(lf - lq).max() / (np.abs(lf).max() + 1e-9) < 0.05
    assert (lf.argmax(-1) == lq.argmax(-1)).all()
    assert cq["k"].dtype == torch.int8 and int(cq["pos"]) == STEPS


def test_engine_refuses_the_int8_cache():
    """Paged: the JAX engine's error.  Contiguous: the reference engine
    cannot install the cache (its prefill returns no scale leaves), and
    the refusal says so."""
    _, _, m, tp, _ = _pair("qwen1.5-32b")
    ctx = Ctx(plan="auto", dtype=torch.float32)
    kw = dict(device="cpu", num_slots=2, max_len=16,
              cache_kwargs={"quantize_kv": True})
    with pytest.raises(ValueError, match="paged serving does not support "
                                         "quantize_kv"):
        ServeEngine(m, tp, ctx, page_size=4, **kw)
    with pytest.raises(ValueError, match="engine.py:659"):
        ServeEngine(m, tp, ctx, **kw)


@pytest.mark.parametrize("arch", ["mamba2-130m", "zamba2-2.7b"])
def test_ssm_families_take_no_quantize_kv(arch):
    """As in the JAX package, only the transformer cache takes it."""
    jm, _, m, _, _ = _pair(arch)
    with pytest.raises(TypeError):
        jm.init_cache(B, 8, jnp.float32, quantize_kv=True)
    with pytest.raises(TypeError):
        m.init_cache(B, 8, torch.float32, device="cpu", quantize_kv=True)


# ----------------------------------------------------------------------
# the loss
# ----------------------------------------------------------------------
@pytest.mark.parametrize("masked", [False, True], ids=["mean", "masked"])
def test_cross_entropy_matches_jax(masked):
    rng = np.random.default_rng(7)
    logits = (rng.standard_normal((2, 5, 33)) * 3).astype(np.float32)
    targets = rng.integers(0, 33, (2, 5))
    mask = (rng.random((2, 5)) > 0.4).astype(np.float32) if masked else None
    want = JL.cross_entropy(jnp.asarray(logits), jnp.asarray(targets),
                            None if mask is None else jnp.asarray(mask))
    got = L.cross_entropy(torch.from_numpy(logits), torch.from_numpy(targets),
                          None if mask is None else torch.from_numpy(mask))
    assert got.dtype == torch.float32 and got.dim() == 0
    np.testing.assert_allclose(float(got), float(want), rtol=LOSS_TOL)
    if masked:      # an all-zero mask divides by one, not zero
        zero = np.zeros_like(mask)
        assert float(L.cross_entropy(torch.from_numpy(logits),
                                     torch.from_numpy(targets),
                                     torch.from_numpy(zero))) == 0.0


@pytest.mark.parametrize("arch", ["gemma-7b", "olmoe-1b-7b", "mamba2-130m",
                                  "zamba2-2.7b", "seamless-m4t-large-v2",
                                  "llava-next-34b"])
@pytest.mark.parametrize("backend", ["auto", "torch"])
def test_model_loss_matches_jax(arch, backend):
    """Every family's forward objective (MoE with its aux term) on
    shared weights and batch."""
    jm, jp, m, tp, cfg = _pair(arch)
    rng = np.random.default_rng(11)
    toks = rng.integers(0, cfg.vocab_size, (2, 8))
    tgts = rng.integers(0, cfg.vocab_size, (2, 8))
    jb = {"tokens": jnp.asarray(toks, jnp.int32),
          "targets": jnp.asarray(tgts, jnp.int32)}
    if cfg.family == "encdec" or cfg.frontend:
        n = 8 if cfg.family == "encdec" else cfg.frontend_tokens
        fe = (rng.standard_normal((2, n, cfg.d_model)) * 0.1).astype(
            np.float32)
        jb["frontend_embeds"] = jnp.asarray(fe)
    want = float(jm.loss(jp, jb, J_CTX))
    tb = {k: torch.as_tensor(np.asarray(v)) for k, v in jb.items()}
    got = m.loss(tp, tb, Ctx(plan=backend, dtype=torch.float32))
    np.testing.assert_allclose(float(got), want, rtol=LOSS_TOL)
