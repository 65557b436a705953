"""The port's dense decoder against the JAX package's, on shared weights.

JAX initialises the smoke configs; ``params_from_numpy`` converts the
parameters; prefill logits and caches, then four ``decode_step``
logits, must match JAX ``Ctx(plan="jnp", dtype=float32)`` within 1e-4
(fp32, summed in another order over two layers), on both of the port's
backends.  One config is also held against the Pallas kernels in
interpret mode.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.models import Ctx as JCtx
from repro.models import build_model as j_build_model
from repro.plan import KernelConfig as JKernelConfig
from repro_torch.configs import ModelConfig, get_config, list_configs
from repro_torch.interop import params_from_numpy, tensor_from_numpy
from repro_torch.models import Ctx, build_model
from repro_torch.models import layers as L
from repro_torch.models import transformer

TOL = 1e-4
ARCHS = ["gemma-7b", "deepseek-coder-33b"]
J_CTX = JCtx(plan="jnp", dtype=jnp.float32)


def _pair(arch):
    jcfg = j_get_config(arch, reduced=True)
    cfg = get_config(arch, reduced=True)
    jm, m = j_build_model(jcfg), build_model(cfg)
    jp = jm.init(jax.random.PRNGKey(0), dtype=jnp.float32)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), cfg, device="cpu")
    return jm, jp, m, tp, cfg


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               atol=tol, rtol=tol)


@pytest.mark.parametrize("arch", ARCHS)
def test_configs_match_jax(arch):
    for reduced in (True, False):
        mine = get_config(arch, reduced=reduced)
        theirs = j_get_config(arch, reduced=reduced)
        for f in ("name", "family", "n_layers", "d_model", "n_heads",
                  "n_kv_heads", "d_ff", "vocab_size", "resolved_head_dim",
                  "mlp_type", "rope_theta", "norm_eps",
                  "tie_embeddings"):
            assert getattr(mine, f) == getattr(theirs, f), f
        assert mine.param_count() == theirs.param_count()
    assert list_configs() == sorted(ARCHS)


def test_gemma_full_size_is_what_one_card_holds():
    n = get_config("gemma-7b").param_count()
    assert 8.5e9 < n < 8.6e9          # 17.1 GB in bf16


@pytest.mark.parametrize("arch", ARCHS)
def test_params_from_numpy_unstacks_layers(arch):
    jm, jp, m, tp, cfg = _pair(arch)
    assert len(tp["layers"]) == cfg.n_layers
    for i in range(cfg.n_layers):
        _close(tp["layers"][i]["attn"]["wq"]["w"],
               jp["layers"]["attn"]["wq"]["w"][i], tol=0)
    _close(tp["embed"]["tokens"], jp["embed"]["tokens"], tol=0)
    # the port's own init has the same tree and shapes
    own = transformer.init_params(cfg, seed=0, device="cpu")

    def shapes(tree, drop=0):
        return {jax.tree_util.keystr(k): tuple(v.shape)[drop:]
                for k, v in jax.tree_util.tree_leaves_with_path(tree)}
    assert shapes(own["layers"][0]) == shapes(jp["layers"], drop=1)
    assert own["embed"]["tokens"].shape == jp["embed"]["tokens"].shape


def test_bf16_converts_bit_exactly():
    x = jnp.asarray(np.random.default_rng(0).standard_normal((5, 7)),
                    jnp.bfloat16)
    t = tensor_from_numpy(np.asarray(x), device="cpu")
    assert t.dtype == torch.bfloat16
    assert np.array_equal(t.view(torch.int16).numpy(),
                          np.asarray(x).view(np.int16))


@pytest.mark.parametrize("backend", ["auto", "torch"])
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_jax(arch, backend):
    jm, jp, m, tp, cfg = _pair(arch)
    rng = np.random.default_rng(1)
    toks = rng.integers(0, cfg.vocab_size, (3, 11)).astype(np.int32)
    lens = np.array([11, 6, 1], np.int32)
    jl, jc = jm.prefill(jp, {"tokens": jnp.asarray(toks),
                             "lengths": jnp.asarray(lens)}, J_CTX, 16)
    ctx = Ctx(plan=backend, dtype=torch.float32)
    tl, tc = m.prefill(tp, {"tokens": torch.from_numpy(toks).long(),
                            "lengths": torch.from_numpy(lens)}, ctx, 16)
    _close(tl, jl)
    _close(tc["k"], jc["k"])
    _close(tc["v"], jc["v"])
    assert tc["pos"].tolist() == lens.tolist()
    step = rng.integers(0, cfg.vocab_size, (4, 3, 1)).astype(np.int32)
    for s in range(4):
        jl, jc = jm.decode(jp, jc, jnp.asarray(step[s]), J_CTX)
        tl, tc = m.decode(tp, tc, torch.from_numpy(step[s]).long(), ctx)
        _close(tl, jl)
    _close(tc["k"], jc["k"])


def test_prefill_matches_jax_interpret_kernels():
    jm, jp, m, tp, cfg = _pair("gemma-7b")
    toks = np.random.default_rng(2).integers(0, cfg.vocab_size, (2, 9))
    lens = np.array([9, 4], np.int32)
    jctx = JCtx(plan=JKernelConfig(backend="interpret", bm=8, bn=8, bk=8,
                                   bq=8, bkv=8), dtype=jnp.float32)
    jl, jc = jm.prefill(jp, {"tokens": jnp.asarray(toks, jnp.int32),
                             "lengths": jnp.asarray(lens)}, jctx, 12)
    tl, tc = m.prefill(tp, {"tokens": torch.from_numpy(toks),
                            "lengths": torch.from_numpy(lens)},
                       Ctx(plan="auto", dtype=torch.float32), 12)
    _close(tl, jl)
    _close(tc["k"], jc["k"])


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_logits_match_jax_forward(arch):
    jm, jp, m, tp, cfg = _pair(arch)
    toks = np.random.default_rng(3).integers(0, cfg.vocab_size, (2, 7))
    want = jm.prefill_logits(jp, {"tokens": jnp.asarray(toks, jnp.int32)},
                             J_CTX)
    for backend in ("auto", "torch"):
        got = m.prefill_logits(tp, {"tokens": torch.from_numpy(toks)},
                               Ctx(plan=backend, dtype=torch.float32))
        assert got.shape == (2, 1, cfg.vocab_size)
        _close(got, want)


def test_scatter_at_is_in_place_per_row_and_clamped():
    c = torch.zeros(3, 8, 2, 4)
    out = L._scatter_at(c, torch.ones(3, 1, 2, 4),
                        torch.tensor([1, 5, 9], dtype=torch.int32))
    assert out is c
    for b, p in enumerate([1, 5, 7]):         # 9 clamps to the last row
        assert bool((c[b, p] == 1).all())
    assert float(c.sum()) == 3 * 8


def test_bf16_model_runs_in_compute_dtype():
    cfg = get_config("gemma-7b", reduced=True)
    m = build_model(cfg)
    params = m.init(seed=0, dtype=torch.bfloat16, device="cpu")
    assert params["layers"][0]["mlp"]["wi"]["w"].dtype == torch.bfloat16
    logits, cache = m.prefill(params, {"tokens": torch.tensor([[1, 2, 3]])},
                              Ctx(plan="auto", dtype=torch.bfloat16), 8)
    assert logits.dtype == torch.float32 and cache["k"].dtype == torch.bfloat16
    assert bool(torch.isfinite(logits).all())


@pytest.mark.parametrize("family", ["moe", "ssm", "hybrid", "encdec", "vlm"])
def test_other_families_name_their_roadmap_item(family):
    cfg = ModelConfig(name="x", family=family, n_layers=1, d_model=8,
                      n_heads=2, n_kv_heads=2, d_ff=16, vocab_size=32)
    with pytest.raises(NotImplementedError, match="ROADMAP.md queue 1 item"):
        build_model(cfg)
