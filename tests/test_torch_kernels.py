"""The port's kernel entry points against the JAX package's.

The same numpy inputs go through ``repro.kernels.ops`` (JAX) and
``repro_torch.kernels.ops`` (PyTorch).  On this CPU the port's "auto"
backend runs each kernel wrapper's plain version (the wrapper takes it
because the tensors lie on the CPU) and is held against the Pallas
kernels in interpret mode with small tiles; the port's "torch" backend
is held against JAX's "jnp" backend.  Tolerances are those of
``tests/test_kernels.py``: 2e-5 for fp32, 2e-2 for bf16.  Tests marked
``gpu`` launch the CUDA kernels and skip without a card.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.plan import KernelConfig as JKernelConfig
from repro.plan.config import resolve_slots as j_resolve_slots
from repro_torch.interop import tensor_from_numpy
from repro_torch.kernels import ops
from repro_torch.kernels import zero_stall_matmul as zsm_mod
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.flash_attention import smem_bytes as fa_smem
from repro_torch.kernels.ref import flash_attention_ref, matmul_ref
from repro_torch.kernels.zero_stall_matmul import zero_stall_matmul
from repro_torch.plan import KernelConfig, resolve_slots

FP32_TOL, BF16_TOL = 2e-5, 2e-2
J_INTERP_MM = JKernelConfig(backend="interpret", bm=8, bn=8, bk=8)
J_INTERP_ATTN = JKernelConfig(backend="interpret", bq=8, bkv=8)
T_AUTO_ATTN = KernelConfig(bq=8, bkv=8)


@pytest.fixture(autouse=True)
def _reset_port_fallbacks():
    """The port's warn-once fallback state is process-global: start and
    leave every test with it cleared."""
    ops.reset_fallback_warnings()
    yield
    ops.reset_fallback_warnings()


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    return torch.device("cuda")


def _np(x):
    return np.asarray(x, np.float32)


def _t(x):
    return tensor_from_numpy(np.asarray(x), device="cpu")


# ----------------------------------------------------------------------
# matmul
# ----------------------------------------------------------------------
@pytest.mark.parametrize("backend", ["auto", "torch"])
@pytest.mark.parametrize("mkn", [(13, 21, 9), (16, 16, 16), (24, 40, 16),
                                 (5, 64, 3)])
def test_matmul_fp32_matches_jax(rng, mkn, backend):
    M, K, N = mkn
    a = rng.standard_normal((M, K)).astype(np.float32)
    b = rng.standard_normal((K, N)).astype(np.float32)
    jcfg = J_INTERP_MM if backend == "auto" else JKernelConfig(backend="jnp")
    want = jops.matmul(jnp.asarray(a), jnp.asarray(b), config=jcfg)
    got = ops.matmul(torch.from_numpy(a), torch.from_numpy(b),
                     config=KernelConfig(backend=backend, bm=8, bn=8, bk=8))
    assert got.dtype == torch.float32 and got.shape == (M, N)
    np.testing.assert_allclose(got.numpy(), _np(want), atol=FP32_TOL,
                               rtol=FP32_TOL)


@pytest.mark.parametrize("backend", ["auto", "torch"])
@pytest.mark.parametrize("out", [None, "float32"])
def test_matmul_bf16_out_dtype_matches_jax(rng, backend, out):
    a = rng.standard_normal((12, 40)).astype(np.float32)
    b = rng.standard_normal((40, 24)).astype(np.float32)
    ja, jb = jnp.asarray(a, jnp.bfloat16), jnp.asarray(b, jnp.bfloat16)
    jcfg = J_INTERP_MM if backend == "auto" else JKernelConfig(backend="jnp")
    want = jops.matmul(ja, jb, config=jcfg,
                       out_dtype=None if out is None else jnp.float32)
    # the port's priority: argument > config field > input dtype
    cfg = KernelConfig(backend=backend, out_dtype=out)
    got = ops.matmul(_t(ja), _t(jb), config=cfg)
    assert got.dtype == (torch.bfloat16 if out is None else torch.float32)
    np.testing.assert_allclose(got.float().numpy(), _np(want),
                               atol=BF16_TOL, rtol=BF16_TOL)
    forced = ops.matmul(_t(ja), _t(jb), config=cfg, out_dtype=torch.bfloat16)
    assert forced.dtype == torch.bfloat16


def test_matmul_transposed_b_is_the_tied_head(rng):
    a = rng.standard_normal((3, 16)).astype(np.float32)
    table = rng.standard_normal((50, 16)).astype(np.float32)
    want = jops.matmul(jnp.asarray(a), jnp.asarray(table).T,
                       config=J_INTERP_MM, out_dtype=jnp.float32)
    for backend in ("auto", "torch"):
        got = ops.matmul(torch.from_numpy(a), torch.from_numpy(table),
                         config=backend, out_dtype=torch.float32,
                         trans_b=True)
        np.testing.assert_allclose(got.numpy(), _np(want), atol=FP32_TOL)


def test_cpu_wrappers_run_plain_version_and_count_no_launch(rng):
    a = torch.from_numpy(rng.standard_normal((9, 7)).astype(np.float32))
    b = torch.from_numpy(rng.standard_normal((7, 5)).astype(np.float32))
    before = zero_stall_matmul.launches
    for slots, order in ((1, "ijk"), (2, "jik"), (3, "ijk")):
        got = zero_stall_matmul(a, b, slots=slots, grid_order=order,
                                variant="single" if slots == 1 else "dobu")
        torch.testing.assert_close(got, matmul_ref(a, b))
    q = torch.randn(1, 2, 6, 8)
    before_fa = flash_attention.launches
    flash_attention(q, q, q)
    assert zero_stall_matmul.launches == before
    assert flash_attention.launches == before_fa


def test_matmul_wrapper_validates_before_launch():
    a = torch.zeros(4, 6)
    with pytest.raises(ValueError, match="contraction"):
        zero_stall_matmul(a, torch.zeros(5, 3))
    with pytest.raises(ValueError, match="grid_order"):
        zero_stall_matmul(a, torch.zeros(6, 3), grid_order="kji")
    with pytest.raises(ValueError, match="slots"):
        zero_stall_matmul(a, torch.zeros(6, 3), variant="single", slots=2)


def test_shared_memory_budget():
    """The default bf16 tile at slots=2 fits a Hopper block; the same
    tile in fp32 does not (hence bk=64 as the fp32 default)."""
    bf16 = zsm_mod.smem_bytes(128, 128, 128, 2, torch.bfloat16)
    assert 128 * 1024 < bf16 <= zsm_mod.SMEM_LIMIT
    with pytest.raises(ValueError, match="shared memory"):
        zsm_mod._check_config(128, 128, 128, 2, torch.float32, False)
    zsm_mod._check_config(128, 128, KernelConfig().resolved_bk(torch.float32),
                          2, torch.float32, False)
    zsm_mod._check_config(128, 128, 128, 3, torch.bfloat16, True)
    with pytest.raises(ValueError, match="multiples of 32"):
        zsm_mod._check_config(8, 8, 8, 2, torch.bfloat16, False)
    assert fa_smem(256, 32, 32) <= 232448 < fa_smem(256, 128, 128)


# ----------------------------------------------------------------------
# attention
# ----------------------------------------------------------------------
def _qkv(rng, B=2, H=2, S=40, D=16, T=None):
    T = T or S
    return (rng.standard_normal((B, H, S, D)).astype(np.float32),
            rng.standard_normal((B, H, T, D)).astype(np.float32),
            rng.standard_normal((B, H, T, D)).astype(np.float32))


_ATTN_CASES = {
    "causal": dict(causal=True),
    "non_causal": dict(causal=False),
    "lengths": dict(causal=True, q_lens=[37, 5], kv_lens=[37, 5]),
    "lengths_non_causal": dict(causal=False, q_lens=[40, 11],
                               kv_lens=[29, 40]),
    "offsets": dict(causal=True, q_offsets=[3, 9], q_lens=[43, 30],
                    kv_lens=[40, 40]),
    "fully_masked_rows": dict(causal=True, q_lens=[40, 40], kv_lens=[0, 17]),
}


@pytest.mark.parametrize("backend", ["auto", "torch"])
@pytest.mark.parametrize("case", sorted(_ATTN_CASES))
def test_attention_matches_jax(rng, case, backend):
    q, k, v = _qkv(rng)
    kw = _ATTN_CASES[case]
    jkw = {n: (jnp.asarray(x, jnp.int32) if isinstance(x, list) else x)
           for n, x in kw.items()}
    tkw = {n: (torch.tensor(x, dtype=torch.int32) if isinstance(x, list)
               else x) for n, x in kw.items()}
    jcfg = J_INTERP_ATTN if backend == "auto" else JKernelConfig(backend="jnp")
    want = jops.attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                          config=jcfg, **jkw)
    cfg = T_AUTO_ATTN if backend == "auto" else "torch"
    got = ops.attention(torch.from_numpy(q), torch.from_numpy(k),
                        torch.from_numpy(v), config=cfg, **tkw)
    np.testing.assert_allclose(got.numpy(), _np(want), atol=FP32_TOL,
                               rtol=FP32_TOL)
    if case == "fully_masked_rows":
        assert bool((got[0] == 0).all())
    assert ops.fallback_counts() == {}


def test_attention_bf16_matches_jax(rng):
    q, k, v = _qkv(rng, S=24)
    lens = [24, 13]
    jq, jk, jv = (jnp.asarray(x, jnp.bfloat16) for x in (q, k, v))
    want = jops.attention(jq, jk, jv, config=J_INTERP_ATTN,
                          q_lens=jnp.asarray(lens), kv_lens=jnp.asarray(lens))
    got = ops.attention(_t(jq), _t(jk), _t(jv), config=T_AUTO_ATTN,
                        q_lens=torch.tensor(lens), kv_lens=torch.tensor(lens))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), _np(want), atol=BF16_TOL,
                               rtol=BF16_TOL)


def test_attention_causal_unaligned_counts_warns_and_matches_reference(
        rng, monkeypatch):
    """Sq < Skv without lengths: counted and warned about, then run by the
    kernel end-aligned, which is the reference's end-aligned mask."""
    q, k, v = _qkv(rng, B=1, H=1, S=16, D=8, T=32)
    want = jref.flash_attention_ref(jnp.asarray(q), jnp.asarray(k),
                                    jnp.asarray(v), causal=True)
    seen = []

    def spy(*a, **kw):
        seen.append({n: kw[n].tolist() for n in ("q_offsets", "q_lens",
                                                   "kv_lens")})
        return flash_attention(*a, **kw)

    monkeypatch.setattr(ops, "_flash", spy)
    with pytest.warns(RuntimeWarning, match="end-aligned"):
        got = ops.attention(torch.from_numpy(q), torch.from_numpy(k),
                            torch.from_numpy(v), causal=True,
                            config=T_AUTO_ATTN)
    assert seen == [{"q_offsets": [16], "q_lens": [32], "kv_lens": [32]}]
    assert ops.fallback_counts() == {"attention_causal_unaligned": 1}
    np.testing.assert_allclose(got.numpy(), _np(want), atol=FP32_TOL)
    ops.reset_fallback_warnings()
    assert ops.fallback_counts() == {}


def test_attention_causal_more_queries_than_keys_runs_the_reference(rng):
    """Sq > Skv without lengths: rows that see no key are averaged
    uniformly by the reference; on a CPU tensor the reference runs."""
    q, k, v = _qkv(rng, B=1, H=2, S=24, D=8, T=16)
    want = jref.flash_attention_ref(jnp.asarray(q), jnp.asarray(k),
                                    jnp.asarray(v), causal=True)
    with pytest.warns(RuntimeWarning, match="falling back"):
        got = ops.attention(torch.from_numpy(q), torch.from_numpy(k),
                            torch.from_numpy(v), causal=True,
                            config=T_AUTO_ATTN)
    assert ops.fallback_counts() == {"attention_causal_unaligned": 1}
    np.testing.assert_allclose(got.numpy(), _np(want), atol=FP32_TOL)


def test_attention_causal_unaligned_strict_raises(rng):
    q, k, v = (torch.from_numpy(x) for x in _qkv(rng, B=1, H=1, S=16, D=8,
                                                 T=32))
    with ops.strict_fallbacks():
        with pytest.raises(ops.FallbackError, match="causal"):
            ops.attention(q, k, v, causal=True, config=T_AUTO_ATTN)
    with pytest.raises(ops.FallbackError):
        ops.attention(q, k, v, causal=True, config=T_AUTO_ATTN, strict=True)
    with ops.strict_fallbacks(allow=("attention_causal_unaligned",)):
        with pytest.warns(RuntimeWarning, match="end-aligned"):
            ops.attention(q, k, v, causal=True, config=T_AUTO_ATTN)
    assert not ops._STRICT["on"]
    assert ops.fallback_counts()["attention_causal_unaligned"] == 3


# ----------------------------------------------------------------------
# plan vocabulary
# ----------------------------------------------------------------------
@pytest.mark.parametrize("variant", ["dobu", "single"])
@pytest.mark.parametrize("slots", [None, 0, 1, 2, 3, 8])
def test_resolve_slots_matches_jax(variant, slots):
    try:
        want = j_resolve_slots(variant, slots)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            resolve_slots(variant, slots)
        assert str(got.value) == str(e)
    else:
        assert resolve_slots(variant, slots) == want


def test_kernel_config_validates():
    with pytest.raises(ValueError, match="backend"):
        KernelConfig(backend="pallas")
    with pytest.raises(ValueError, match="grid_order"):
        KernelConfig(grid_order="kij")
    with pytest.raises(ValueError, match="slots"):
        KernelConfig(variant="dobu", slots=1)
    with pytest.raises(ValueError, match="dtype"):
        KernelConfig(out_dtype="int4")
    assert KernelConfig(out_dtype=torch.float32).out_dtype == "float32"
    assert KernelConfig().resolved_bk(torch.bfloat16) == 128
    assert KernelConfig(bm=16).matmul_kwargs(torch.float32)["bk"] == 64
    with pytest.raises(ValueError, match="config"):
        ops.as_config((8, 8, 8))


# ----------------------------------------------------------------------
# on the card (skip here)
# ----------------------------------------------------------------------
@pytest.mark.gpu
@pytest.mark.parametrize("slots", [1, 2, 3])
@pytest.mark.parametrize("grid_order", ["ijk", "jik"])
def test_matmul_kernel_matches_plain_on_card(cuda, slots, grid_order):
    g = torch.Generator(device=cuda).manual_seed(0)
    a = torch.randn(37, 45, device=cuda, generator=g)
    b = torch.randn(45, 29, device=cuda, generator=g)
    got = zero_stall_matmul(a, b, bm=16, bn=16, bk=8, slots=slots,
                            grid_order=grid_order,
                            variant="single" if slots == 1 else "dobu")
    torch.testing.assert_close(got, matmul_ref(a, b), atol=FP32_TOL,
                               rtol=FP32_TOL)
    ab, bb = a.bfloat16(), b.bfloat16()
    got = zero_stall_matmul(ab, bb, bm=32, bn=32, bk=16, slots=slots,
                            grid_order=grid_order,
                            variant="single" if slots == 1 else "dobu")
    want = matmul_ref(ab, bb)
    assert (got.float() - want.float()).abs().max() <= \
        BF16_TOL * want.float().abs().max()


@pytest.mark.gpu
def test_flash_kernel_matches_plain_on_card(cuda):
    g = torch.Generator(device=cuda).manual_seed(0)
    q, k, v = (torch.randn(2, 2, 40, 32, device=cuda, generator=g)
               for _ in range(3))
    lens = torch.tensor([37, 0], dtype=torch.int32, device=cuda)
    got = flash_attention(q, k, v, q_lens=lens, kv_lens=lens)
    want = flash_attention_ref(q, k, v, q_lens=lens, kv_lens=lens,
                               q_offsets=torch.zeros_like(lens))
    torch.testing.assert_close(got, want, atol=FP32_TOL, rtol=FP32_TOL)
    assert bool((got[1] == 0).all())


@pytest.mark.gpu
def test_attention_causal_unaligned_on_card(cuda):
    """Sq < Skv runs the kernel end-aligned; Sq > Skv raises on the card."""
    g = torch.Generator(device=cuda).manual_seed(0)
    q = torch.randn(1, 2, 24, 32, device=cuda, generator=g)
    k, v = (torch.randn(1, 2, 40, 32, device=cuda, generator=g)
            for _ in range(2))
    before = flash_attention.launches
    with pytest.warns(RuntimeWarning, match="end-aligned"):
        got = ops.attention(q, k, v, causal=True)
    assert flash_attention.launches == before + 1
    torch.testing.assert_close(got, flash_attention_ref(q, k, v, causal=True),
                               atol=FP32_TOL, rtol=FP32_TOL)
    with pytest.raises(ValueError, match="see no key"):
        ops.attention(k, q, q, causal=True)
