"""The bias of ``layers.linear``: the port adds a ``b`` leaf as JAX does.

JAX's ``linear`` adds ``p["b"]``, cast to the compute dtype, after the
product (``repro.models.layers.linear``), and ``init_linear(bias=True)``
makes that leaf with zeros.  The same numpy weights and biases go
through JAX's ``linear`` and the port's, one layer and a whole reduced
model whose projections carry nonzero biases; ``params_from_numpy``
must carry each ``b`` leaf through.  fp32 results are held within 2e-5
(one layer) and 1e-4 (two layers, summed in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.models import Ctx as JCtx
from repro.models import build_model as j_build_model
from repro.models import layers as JL
from repro.plan import KernelConfig as JKernelConfig
from repro.quant import quantize as j_quantize
from repro_torch.configs import get_config
from repro_torch.interop import params_from_numpy, tensor_from_numpy
from repro_torch.models import Ctx, build_model
from repro_torch.models import layers as L
from repro_torch.models import transformer
from repro_torch.plan import KernelConfig
from repro_torch.quant import quantize
from torch_tune_cache import port_tune_cache  # noqa: F401 (autouse)

FP32_TOL, MODEL_TOL = 2e-5, 1e-4
J_CTX = JCtx(plan="jnp", dtype=jnp.float32)


def _linear_params(rng, d_in, d_out, lead=()):
    w = rng.standard_normal(lead + (d_in, d_out)).astype(np.float32)
    b = rng.standard_normal(lead + (d_out,)).astype(np.float32)
    return w * d_in ** -0.5, b


@pytest.mark.parametrize("backend", ["auto", "torch"])
@pytest.mark.parametrize("x_shape", [(5, 24), (2, 3, 24)])
def test_linear_adds_its_bias_as_jax_does(rng, backend, x_shape):
    """A nonzero bias, fp32: the port's linear equals JAX's within 2e-5
    (without the bias it would be off by the bias itself)."""
    w, b = _linear_params(rng, 24, 40)
    x = rng.standard_normal(x_shape).astype(np.float32)
    want = JL.linear({"w": jnp.asarray(w), "b": jnp.asarray(b)},
                     jnp.asarray(x), J_CTX)
    got = L.linear({"w": tensor_from_numpy(w, "cpu"),
                    "b": tensor_from_numpy(b, "cpu")},
                   tensor_from_numpy(x, "cpu"),
                   Ctx(plan=backend, dtype=torch.float32))
    assert got.shape == tuple(want.shape) == x_shape[:-1] + (40,)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=FP32_TOL, rtol=FP32_TOL)
    assert np.abs(np.asarray(want) - np.asarray(
        JL.linear({"w": jnp.asarray(w)}, jnp.asarray(x), J_CTX))).max() > 0.1


def test_linear_casts_the_bias_to_the_compute_dtype(rng):
    """An fp32 bias under a bf16 context is cast before the add, so the
    output keeps the compute dtype, and matches JAX's bf16 result."""
    w, b = _linear_params(rng, 16, 8)
    x = rng.standard_normal((4, 16)).astype(np.float32)
    jctx = JCtx(plan="jnp", dtype=jnp.bfloat16)
    want = JL.linear({"w": jnp.asarray(w), "b": jnp.asarray(b)},
                     jnp.asarray(x, jnp.bfloat16), jctx)
    got = L.linear({"w": torch.from_numpy(w), "b": torch.from_numpy(b)},
                   torch.from_numpy(x).bfloat16(),
                   Ctx(plan="torch", dtype=torch.bfloat16))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), atol=2e-2,
                               rtol=2e-2)


def test_quantized_linear_adds_its_bias(rng):
    """A W8A8 int8 weight with a bias: the bias is added after the fused
    dequantising epilogue, as JAX does on its quantized path."""
    w, b = _linear_params(rng, 32, 24)
    x = rng.standard_normal((4, 32)).astype(np.float32)
    want = JL.linear({"w": j_quantize(jnp.asarray(w)), "b": jnp.asarray(b)},
                     jnp.asarray(x),
                     JCtx(plan=JKernelConfig(backend="jnp", quant="int8"),
                          dtype=jnp.float32))
    got = L.linear({"w": quantize(torch.from_numpy(w)),
                    "b": torch.from_numpy(b)}, torch.from_numpy(x),
                   Ctx(plan=KernelConfig(backend="torch", quant="int8"),
                       dtype=torch.float32))
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=FP32_TOL, rtol=FP32_TOL)


@pytest.mark.parametrize("bias", [False, True])
def test_init_linear_has_jax_tree_and_zero_bias(bias):
    """The port's init_linear makes JAX's leaves: ``w`` (d_in, d_out) and,
    with ``bias``, a zero ``b`` (d_out,)."""
    g = torch.Generator().manual_seed(0)
    own = transformer.init_linear(g, 12, 20, bias=bias)
    theirs = JL.init_linear(jax.random.PRNGKey(0), 12, 20, bias=bias)
    assert {k: tuple(v.shape) for k, v in own.items()} == \
        {k: tuple(v.shape) for k, v in theirs.items()}
    if bias:
        assert own["b"].dtype == torch.float32
        assert not own["b"].any()


@pytest.mark.parametrize("arch", ["gemma-7b", "deepseek-coder-33b"])
def test_model_with_biased_projections_matches_jax(arch):
    """Nonzero biases on every attention and MLP projection of a reduced
    model: ``params_from_numpy`` carries each ``b`` leaf through, and the
    port's prefill logits and first decode step equal JAX's within 1e-4."""
    jcfg, cfg = j_get_config(arch, reduced=True), get_config(arch,
                                                             reduced=True)
    jm, m = j_build_model(jcfg), build_model(cfg)
    jp = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(0),
                                          dtype=jnp.float32))
    rng = np.random.default_rng(7)
    for block in ("attn", "mlp"):
        for name, lin in jp["layers"][block].items():
            lin["b"] = rng.standard_normal(
                lin["w"].shape[:1] + lin["w"].shape[-1:]).astype(np.float32)
    tp = params_from_numpy(jp, cfg, device="cpu")
    for i in range(cfg.n_layers):
        for block in ("attn", "mlp"):
            for name, lin in tp["layers"][i][block].items():
                np.testing.assert_array_equal(
                    lin["b"].numpy(), jp["layers"][block][name]["b"][i])
    toks = rng.integers(0, cfg.vocab_size, (2, 7)).astype(np.int32)
    lens = np.array([7, 4], np.int32)
    jparams = jax.tree.map(jnp.asarray, jp)
    jl, jc = jm.prefill(jparams, {"tokens": jnp.asarray(toks),
                                  "lengths": jnp.asarray(lens)}, J_CTX, 12)
    ctx = Ctx(plan="auto", dtype=torch.float32)
    tl, tc = m.prefill(tp, {"tokens": torch.from_numpy(toks).long(),
                            "lengths": torch.from_numpy(lens)}, ctx, 12)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=MODEL_TOL,
                               rtol=MODEL_TOL)
    step = rng.integers(0, cfg.vocab_size, (2, 1)).astype(np.int32)
    jl, _ = jm.decode(jparams, jc, jnp.asarray(step), J_CTX)
    tl, _ = m.decode(tp, tc, torch.from_numpy(step).long(), ctx)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=MODEL_TOL,
                               rtol=MODEL_TOL)
