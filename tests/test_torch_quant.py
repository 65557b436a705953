"""The port's int8 / fp8 quantization and W8A8 kernels against the JAX package.

Same numpy inputs through ``repro.quant`` / ``repro.kernels.ops`` (JAX)
and ``repro_torch.quant`` / ``repro_torch.kernels.ops``.  Codes, scales
and the fp32 outputs of the quantized matmuls are held bit for bit: the
int32 contraction is exact and the epilogue rounds in the same order in
both.  On this CPU the port's "auto" backend runs each kernel wrapper's
plain version and is held against the Pallas kernels in interpret mode.
W8A8 model logits are held within 1e-4 (fp32, summed in another order
over two layers; a per-row activation code can flip when its fp32 input
differs in the last bit, which moves a logit by about 1e-6).  The
kernels themselves are held on the card in ``test_torch_kernels.py``.
"""

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
from repro.quant import QTensor as JQTensor
from repro.quant import quantize as j_quantize
from repro.quant import quantize_rows as j_quantize_rows
from repro.quant import quantize_tree as j_quantize_tree
from repro_torch.configs import get_config
from repro_torch.interop import params_from_numpy
from repro_torch.kernels import ops
from repro_torch.kernels import zero_stall_matmul as zsm_mod
from repro_torch.kernels.quantized_matmul import (
    quantized_grouped_zero_stall_matmul, quantized_zero_stall_matmul)
from repro_torch.kernels.ref import (quantized_grouped_matmul_ref,
                                     quantized_matmul_ref)
from repro_torch.models import Ctx, build_model
from repro_torch.models import layers as L
from repro_torch.plan import KernelConfig
from repro_torch.quant import QTensor, quantize, quantize_rows, quantize_tree
from torch_tune_cache import port_tune_cache  # noqa: F401 (autouse)

TOL = 1e-4
J_INTERP = JKernelConfig(backend="interpret", bm=8, bn=8, bk=8)
J_JNP = JKernelConfig(backend="jnp")
W8A8_ARCHS = ["gemma-7b", "deepseek-coder-33b", "olmoe-1b-7b",
              "granite-moe-1b-a400m"]


def _codes(q):
    """A QTensor's codes as a comparable numpy array (fp8 as its bits)."""
    data = q.data
    if isinstance(q, QTensor):
        data = data.contiguous()
        return (data.view(torch.uint8) if q.fmt == "fp8" else data).numpy()
    data = np.asarray(data)
    return data.view(np.uint8) if q.fmt == "fp8" else data


def _pair(arch, quantized=True):
    jcfg = j_get_config(arch, reduced=True)
    cfg = get_config(arch, reduced=True)
    jm, m = j_build_model(jcfg), build_model(cfg)
    jp = jm.init(jax.random.PRNGKey(0), dtype=jnp.float32)
    if quantized:
        jp = jm.quantize_weights(jp)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), cfg, device="cpu")
    return jm, jp, m, tp, cfg


# ----------------------------------------------------------------------
# QTensor
# ----------------------------------------------------------------------
@pytest.mark.parametrize("fmt", ["int8", "fp8"])
@pytest.mark.parametrize("shape", [(24, 10), (3, 16, 12)])
def test_quantize_codes_and_scales_bit_equal_jax(rng, fmt, shape):
    w = rng.standard_normal(shape).astype(np.float32)
    w[..., 3] = 0.0                        # an all-zero channel
    want = j_quantize(jnp.asarray(w), fmt=fmt)
    got = quantize(torch.from_numpy(w), fmt=fmt)
    assert got.fmt == fmt and got.w8a8 and got.shape == shape
    np.testing.assert_array_equal(_codes(got), _codes(want))
    np.testing.assert_array_equal(got.scale.numpy(), np.asarray(want.scale))
    assert float(got.scale[..., 0, 3].min()) == 1.0
    assert not got.data[..., 3].any()
    # K-major storage: the transposed view of a contiguous (..., N, K)
    assert got.data.mT.is_contiguous()
    np.testing.assert_array_equal(got.dequantize().numpy(),
                                  np.asarray(want.dequantize()))
    assert got.dequantize().is_contiguous()


def test_quantize_rows_bit_equal_jax_with_zero_padding_rows(rng):
    x = rng.standard_normal((13, 24)).astype(np.float32) * 3
    x[5] = 0.0
    x[11:] = 0.0
    want_q, want_s = j_quantize_rows(jnp.asarray(x))
    got_q, got_s = quantize_rows(torch.from_numpy(x))
    assert got_q.dtype == torch.int8 and got_s.shape == (13, 1)
    np.testing.assert_array_equal(got_q.numpy(), np.asarray(want_q))
    np.testing.assert_array_equal(got_s.numpy(), np.asarray(want_s))
    assert not got_q[[5, 11, 12]].any()
    assert bool((got_s[[5, 11, 12]] == 1.0).all())


def test_quantize_rounds_half_to_even():
    w = torch.tensor([[127.0], [2.5], [-0.5], [1.5]])
    q = quantize(w)
    assert float(q.scale) == 1.0
    assert q.data[:, 0].tolist() == [127, 2, 0, 2]


@pytest.mark.parametrize("arch", W8A8_ARCHS)
@pytest.mark.parametrize("fmt", ["int8", "fp8"])
def test_quantize_tree_picks_the_same_leaves_as_jax(arch, fmt):
    _, jp, _, tp, cfg = _pair(arch, quantized=False)
    want = jax.tree_util.tree_flatten_with_path(
        j_quantize_tree(jp, fmt=fmt), is_leaf=lambda x: isinstance(
            x, JQTensor))[0]
    want = {jax.tree_util.keystr(k): (v.fmt, v.w8a8)
            for k, v in want if isinstance(v, JQTensor)}
    got = {}

    def walk(node, path):
        if isinstance(node, QTensor):
            got[path] = (node.fmt, node.w8a8)
        elif isinstance(node, dict):
            for k, v in node.items():
                walk(v, f"{path}['{k}']")
        elif isinstance(node, list):      # the port's per-layer list
            walk(node[0], path)

    walk(quantize_tree(tp, fmt=fmt), "")
    assert got == want and len(got) >= 7
    # idempotent, and the embedding and norms stay plain tensors
    again = quantize_tree(quantize_tree(tp, fmt=fmt), fmt=fmt)
    assert isinstance(again["embed"]["tokens"], torch.Tensor)
    assert isinstance(again["layers"][0]["attn_norm"]["scale"], torch.Tensor)


@pytest.mark.parametrize("arch", ["gemma-7b", "olmoe-1b-7b"])
def test_params_from_numpy_carries_qtensors(arch):
    _, jp, _, tp, cfg = _pair(arch)
    mlp = tp["layers"][1]["mlp"]
    w = mlp["wi"] if cfg.family == "moe" else mlp["wi"]["w"]
    jw = jp["layers"]["mlp"]["wi"]
    jw = jw if cfg.family == "moe" else jw["w"]
    assert isinstance(w, QTensor) and w.fmt == "int8" and w.w8a8
    assert w.data.mT.is_contiguous()
    np.testing.assert_array_equal(w.data.numpy(), np.asarray(jw.data)[1])
    np.testing.assert_array_equal(w.scale.numpy(), np.asarray(jw.scale)[1])


def test_params_from_numpy_carries_fp8_codes():
    jcfg = j_get_config("gemma-7b", reduced=True)
    jm = j_build_model(jcfg)
    jp = jm.quantize_weights(jm.init(jax.random.PRNGKey(0),
                                     dtype=jnp.float32), fmt="fp8")
    tp = params_from_numpy(jax.tree.map(np.asarray, jp),
                           get_config("gemma-7b", reduced=True),
                           device="cpu")
    w = tp["layers"][0]["attn"]["wq"]["w"]
    assert w.fmt == "fp8" and w.data.dtype == torch.float8_e4m3fn
    np.testing.assert_array_equal(
        _codes(w), np.asarray(jp["layers"]["attn"]["wq"]["w"].data)[0]
        .view(np.uint8))


# ----------------------------------------------------------------------
# the quantized ops against the Pallas kernels (interpret) and jnp
# ----------------------------------------------------------------------
@pytest.mark.parametrize("backend", ["auto", "torch"])
@pytest.mark.parametrize("out", ["float32", "bfloat16"])
@pytest.mark.parametrize("mkn", [(13, 21, 9), (16, 24, 16), (1, 64, 40)])
def test_quantized_matmul_bit_equal_jax(rng, mkn, out, backend):
    M, K, N = mkn
    x = rng.standard_normal((M, K)).astype(np.float32)
    w = rng.standard_normal((K, N)).astype(np.float32)
    want = jops.quantized_matmul(
        jnp.asarray(x), j_quantize(jnp.asarray(w)),
        config=J_INTERP if backend == "auto" else J_JNP,
        out_dtype=getattr(jnp, out))
    got = ops.quantized_matmul(torch.from_numpy(x),
                               quantize(torch.from_numpy(w)),
                               config=backend, out_dtype=getattr(torch, out))
    assert got.dtype == getattr(torch, out) and got.shape == (M, N)
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want.astype(jnp.float32)))


@pytest.mark.parametrize("backend", ["auto", "torch"])
@pytest.mark.parametrize("gmkn", [(3, 5, 16, 12), (4, 1, 24, 8)])
def test_quantized_grouped_matmul_bit_equal_jax(rng, gmkn, backend):
    G, M, K, N = gmkn
    x = rng.standard_normal((G, M, K)).astype(np.float32)
    x[1] = 0.0                                   # an empty expert buffer
    w = rng.standard_normal((G, K, N)).astype(np.float32)
    want = jops.quantized_grouped_matmul(
        jnp.asarray(x), j_quantize(jnp.asarray(w)),
        config=J_INTERP if backend == "auto" else J_JNP)
    got = ops.quantized_grouped_matmul(torch.from_numpy(x),
                                       quantize(torch.from_numpy(w)),
                                       config=backend)
    assert got.dtype == torch.float32 and got.shape == (G, M, N)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_quantized_ops_out_dtype_priority(rng):
    x = torch.from_numpy(rng.standard_normal((4, 16)).astype(np.float32))
    qw = quantize(torch.from_numpy(rng.standard_normal((16, 8))
                                   .astype(np.float32)))
    assert ops.quantized_matmul(x, qw).dtype == torch.float32
    cfg = KernelConfig(out_dtype="bfloat16")
    assert ops.quantized_matmul(x, qw, config=cfg).dtype == torch.bfloat16
    assert ops.quantized_matmul(x, qw, config=cfg,
                                out_dtype=torch.float32).dtype == \
        torch.float32
    with pytest.raises(TypeError, match="QTensor"):
        ops.quantized_matmul(x, qw.dequantize())


@pytest.mark.parametrize("grouped", [False, True])
def test_fp8_takes_the_dequantize_route_as_jax(rng, grouped):
    shape = (3, 16, 8) if grouped else (16, 8)
    xs = (3, 5, 16) if grouped else (5, 16)
    x = rng.standard_normal(xs).astype(np.float32)
    w = rng.standard_normal(shape).astype(np.float32)
    jfn = jops.quantized_grouped_matmul if grouped else jops.quantized_matmul
    fn = ops.quantized_grouped_matmul if grouped else ops.quantized_matmul
    want = jfn(jnp.asarray(x), j_quantize(jnp.asarray(w), fmt="fp8"),
               config=J_INTERP)
    got = fn(torch.from_numpy(x), quantize(torch.from_numpy(w), fmt="fp8"))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5,
                               rtol=2e-5)


# ----------------------------------------------------------------------
# the wrappers' checks, before any launch
# ----------------------------------------------------------------------
def test_quantized_wrappers_validate_before_launch():
    a = torch.zeros(4, 16, dtype=torch.int8)
    b = torch.zeros(16, 8, dtype=torch.int8)
    sa, sb = torch.ones(4, 1), torch.ones(1, 8)
    with pytest.raises(ValueError, match="int8"):
        quantized_zero_stall_matmul(a.float(), b, sa, sb)
    with pytest.raises(ValueError, match="contraction"):
        quantized_zero_stall_matmul(a, b[:8], sa, sb)
    with pytest.raises(ValueError, match="scale shapes"):
        quantized_zero_stall_matmul(a, b, sa.reshape(1, 4), sb)
    with pytest.raises(ValueError, match="fp32"):
        quantized_zero_stall_matmul(a, b, sa.double(), sb)
    with pytest.raises(ValueError, match="out_dtype"):
        quantized_zero_stall_matmul(a, b, sa, sb, out_dtype=torch.float16)
    with pytest.raises(ValueError, match="grid_order"):
        quantized_zero_stall_matmul(a, b, sa, sb, grid_order="kji")
    ga, gb = a[None].expand(3, 4, 16), b[None].expand(3, 16, 8)
    gsa, gsb = sa[None].expand(3, 4, 1), sb[None].expand(3, 1, 8)
    with pytest.raises(ValueError, match="group/contraction"):
        quantized_grouped_zero_stall_matmul(ga, gb[:2], gsa, gsb)
    with pytest.raises(ValueError, match="scale shapes"):
        quantized_grouped_zero_stall_matmul(ga, gb, sa, gsb)
    with pytest.raises(ValueError, match="3-D"):
        quantized_grouped_zero_stall_matmul(a, b, sa, sb)
    with pytest.raises(ValueError, match="slots"):
        quantized_grouped_zero_stall_matmul(ga, gb, gsa, gsb,
                                            variant="single", slots=2)
    # on the CPU the wrappers run their plain versions, no launch
    before = (quantized_zero_stall_matmul.launches,
              quantized_grouped_zero_stall_matmul.launches)
    torch.testing.assert_close(quantized_zero_stall_matmul(a, b, sa, sb),
                               quantized_matmul_ref(a, b, sa, sb))
    torch.testing.assert_close(
        quantized_grouped_zero_stall_matmul(ga, gb, gsa, gsb),
        quantized_grouped_matmul_ref(ga, gb, gsa, gsb))
    assert before == (quantized_zero_stall_matmul.launches,
                      quantized_grouped_zero_stall_matmul.launches)


def test_int8_shared_memory_budget():
    """int8 tiles take half the shared memory of bf16: 128^3 at 2 slots
    is about 74 KB (K-major B), and bk = 256 fits too.  The default k
    tile is 256 bytes: 256 codes for one product and for the grouped
    product (the TMA ring's stage of a bf16 product)."""
    need = zsm_mod.smem_bytes(128, 128, 128, 2, torch.int8, trans_b=True)
    assert need == 2 * (128 + 128) * (128 + 16) == 73728
    zsm_mod._check_config(128, 128, 256, 2, torch.int8, True)
    with pytest.raises(ValueError, match="shared memory"):
        zsm_mod._check_config(128, 128, 512, 3, torch.int8, True)
    with pytest.raises(ValueError, match="multiple of 32"):
        zsm_mod._check_config(128, 128, 16, 2, torch.int8, True)
    assert KernelConfig().matmul_kwargs(torch.int8)["bk"] == 256
    assert KernelConfig().matmul_kwargs(torch.int8, grouped=True)["bk"] == 256


def test_kernel_config_quant_is_validated():
    assert KernelConfig().quant is None
    assert KernelConfig(quant="int8").quant == "int8"
    KernelConfig(quant="fp8")
    with pytest.raises(ValueError, match="quant"):
        KernelConfig(quant="int4")


def test_linear_dispatches_on_plan_quant(rng):
    x = torch.from_numpy(rng.standard_normal((2, 3, 16)).astype(np.float32))
    qw = quantize(torch.from_numpy(rng.standard_normal((16, 8))
                                   .astype(np.float32)))
    q_ctx = Ctx(plan=KernelConfig(quant="int8"), dtype=torch.float32)
    plain_ctx = Ctx(plan="auto", dtype=torch.float32)
    got = L.linear({"w": qw}, x, q_ctx)
    want = ops.quantized_matmul(x.reshape(6, 16), qw).reshape(2, 3, 8)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    deq = L.linear({"w": qw}, x, plain_ctx)
    torch.testing.assert_close(deq, L.linear({"w": qw.dequantize()}, x,
                                             plain_ctx), rtol=0, atol=0)
    w8a16 = QTensor(qw.data, qw.scale, "int8", w8a8=False)
    torch.testing.assert_close(L.linear({"w": w8a16}, x, q_ctx), deq,
                               rtol=0, atol=0)


# ----------------------------------------------------------------------
# W8A8 models and the engine
# ----------------------------------------------------------------------
@pytest.mark.parametrize("arch", W8A8_ARCHS)
def test_w8a8_logits_match_jax(arch):
    jm, jp, m, tp, cfg = _pair(arch)
    tokens = np.random.default_rng(7).integers(0, cfg.vocab_size, (2, 8))
    lengths = np.array([8, 5], np.int32)
    j_ctx = JCtx(plan=JKernelConfig(backend="jnp", quant="int8"),
                 dtype=jnp.float32)
    jl, jc = jm.prefill(jp, {"tokens": jnp.asarray(tokens),
                             "lengths": jnp.asarray(lengths)}, j_ctx, 12)
    jd, _ = jm.decode(jp, jc, jnp.asarray(tokens[:, :1]), j_ctx)
    for backend in ("auto", "torch"):
        ctx = Ctx(plan=KernelConfig(backend=backend, quant="int8"),
                  dtype=torch.float32)
        tl, tc = m.prefill(tp, {"tokens": torch.from_numpy(tokens),
                                "lengths": torch.from_numpy(lengths)},
                           ctx, 12)
        td, _ = m.decode(tp, tc, torch.from_numpy(tokens[:, :1]), ctx)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=TOL,
                                   rtol=TOL)
        np.testing.assert_allclose(td.numpy(), np.asarray(jd), atol=TOL,
                                   rtol=TOL)


@pytest.mark.parametrize("K", [1, 4])
def test_w8a8_engine_matches_jax_lockstep(K):
    """The engine takes quantized params unchanged: greedy W8A8 serving is
    token for token JAX's lock-step oracle on the same quantized
    params."""
    from repro.plan import Plan
    from repro.serve import lockstep_generate as j_lockstep
    from repro_torch.serve import Request, ServeEngine
    jm, jp, m, tp, cfg = _pair("gemma-7b")
    prompts = [list(np.random.default_rng(i).integers(0, cfg.vocab_size, n))
               for i, n in enumerate((5, 11, 3, 8))]
    max_new = [6, 3, 5, 4]
    oracle = j_lockstep(jm, jp, JCtx(plan=Plan(backend="jnp", quant="int8"),
                                     dtype=jnp.float32),
                        prompts, max_new, max_len=32)
    engine = ServeEngine(m, tp, Ctx(plan=KernelConfig(quant="int8"),
                                    dtype=torch.float32),
                         num_slots=2, max_len=32, steps_per_dispatch=K,
                         device="cpu")
    res = engine.run([Request(rid=i, prompt=[int(t) for t in p],
                              max_new_tokens=n)
                      for i, (p, n) in enumerate(zip(prompts, max_new))])
    for i in range(4):
        assert res[i].tokens == [int(t) for t in oracle[i]]
