"""The port's MoE family against the JAX package's, on shared weights.

JAX initialises the reduced olmoe-1b-7b and granite-moe-1b-a400m
configs; ``params_from_numpy`` converts the parameters (router and
``(n_layers, E, d, f)`` expert banks).  The grouped matmul is held
within 2e-5 (fp32) of the Pallas kernel in interpret mode and of the
jnp path; routing is held exactly (same experts, ranks, slots, kept
assignments and gates) on the same logits, ties and padding included;
the MoE layer and the model logits (prefill with lengths, then decode)
within 1e-4 (fp32, summed in another order over two layers); engine
greedy tokens exactly, against the JAX engine at the same slots, K and
requests, since routing is batch-global and so is parity.
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
from repro.models import moe as jmoe
from repro.plan import KernelConfig as JKernelConfig
from repro_torch.configs import get_config
from repro_torch.interop import params_from_numpy
from repro_torch.kernels import ops
from repro_torch.kernels.grouped_matmul import grouped_zero_stall_matmul
from repro_torch.kernels.ref import grouped_matmul_ref
from repro_torch.models import Ctx, build_model, moe
from repro_torch.plan import KernelConfig
from repro_torch.serve import Request, ServeEngine
from torch_tune_cache import port_tune_cache  # noqa: F401 (autouse)

TOL = 1e-4
FP32_TOL, BF16_TOL = 2e-5, 2e-2
MOE_ARCHS = ["olmoe-1b-7b", "granite-moe-1b-a400m"]
J_CTX = JCtx(plan="jnp", dtype=jnp.float32)


def _pair(arch):
    jcfg = j_get_config(arch, reduced=True)
    cfg = get_config(arch, reduced=True)
    jm, m = j_build_model(jcfg), build_model(cfg)
    jp = jm.init(jax.random.PRNGKey(0), dtype=jnp.float32)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), cfg, device="cpu")
    return jm, jp, m, tp, cfg


@pytest.fixture(scope="module", params=MOE_ARCHS)
def pair(request):
    return _pair(request.param)


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), atol=tol,
                               rtol=tol)


# ----------------------------------------------------------------------
# configs and parameters
# ----------------------------------------------------------------------
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_configs_match_jax(arch):
    for reduced in (True, False):
        mine = get_config(arch, reduced=reduced)
        theirs = j_get_config(arch, reduced=reduced)
        for f in ("name", "family", "n_layers", "d_model", "n_heads",
                  "n_kv_heads", "d_ff", "vocab_size", "resolved_head_dim",
                  "mlp_type", "rope_theta", "norm_eps", "tie_embeddings",
                  "n_experts", "experts_per_token", "capacity_factor"):
            assert getattr(mine, f) == getattr(theirs, f), f
        assert mine.param_count() == theirs.param_count()


def test_olmoe_full_size_is_what_one_card_holds():
    n = get_config("olmoe-1b-7b").param_count()
    assert 6.9e9 < n < 7.0e9          # 13.8 GB in bf16, 7 GB in int8


def test_params_from_numpy_unstacks_expert_banks(pair):
    jm, jp, m, tp, cfg = pair
    E, d, f = cfg.n_experts, cfg.d_model, cfg.d_ff
    mlp = tp["layers"][1]["mlp"]
    assert mlp["router"].shape == (d, E)
    assert mlp["wi"].shape == mlp["wg"].shape == (E, d, f)
    assert mlp["wo"].shape == (E, f, d)
    _close(mlp["wo"], jp["layers"]["mlp"]["wo"][1], tol=0)
    _close(mlp["router"], jp["layers"]["mlp"]["router"][1], tol=0)
    # the port's own init has the same tree and shapes
    own = m.init(seed=0, device="cpu")
    assert {k: tuple(v.shape) for k, v in own["layers"][0]["mlp"].items()} \
        == {k: tuple(v.shape) for k, v in mlp.items()}


@pytest.mark.parametrize("arch", MOE_ARCHS + ["gemma-7b"])
def test_params_from_numpy_takes_bf16_trees(arch):
    jcfg, cfg = j_get_config(arch, reduced=True), get_config(arch,
                                                             reduced=True)
    jp = j_build_model(jcfg).init(jax.random.PRNGKey(0), dtype=jnp.bfloat16)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), cfg, device="cpu")
    bits = lambda a: np.asarray(a).view(np.int16)
    for path, leaf in jax.tree_util.tree_leaves_with_path(jp["layers"]):
        keys = [k.key for k in path]
        for i in range(cfg.n_layers):
            got = tp["layers"][i]
            for k in keys:
                got = got[k]
            assert got.dtype == torch.bfloat16
            assert np.array_equal(got.view(torch.int16).numpy(),
                                  bits(leaf[i]))
    assert np.array_equal(tp["embed"]["tokens"].view(torch.int16).numpy(),
                          bits(jp["embed"]["tokens"]))


# ----------------------------------------------------------------------
# grouped matmul
# ----------------------------------------------------------------------
@pytest.mark.parametrize("backend", ["auto", "torch"])
@pytest.mark.parametrize("gmkn", [(3, 5, 16, 12), (4, 1, 24, 8),
                                  (2, 13, 21, 9)])
def test_grouped_matmul_matches_jax(rng, gmkn, backend):
    G, M, K, N = gmkn
    a = rng.standard_normal((G, M, K)).astype(np.float32)
    b = rng.standard_normal((G, K, N)).astype(np.float32)
    jcfg = (JKernelConfig(backend="interpret", bm=8, bn=8, bk=8)
            if backend == "auto" else JKernelConfig(backend="jnp"))
    want = jops.grouped_matmul(jnp.asarray(a), jnp.asarray(b), config=jcfg)
    got = ops.grouped_matmul(torch.from_numpy(a), torch.from_numpy(b),
                             config=KernelConfig(backend=backend, bm=8,
                                                 bn=8, bk=8))
    assert got.dtype == torch.float32 and got.shape == (G, M, N)
    _close(got, want, tol=FP32_TOL)


def test_grouped_matmul_bf16_and_out_dtype_match_jax(rng):
    a = rng.standard_normal((3, 7, 32)).astype(np.float32)
    b = rng.standard_normal((3, 32, 16)).astype(np.float32)
    ja, jb = jnp.asarray(a, jnp.bfloat16), jnp.asarray(b, jnp.bfloat16)
    ta = torch.from_numpy(a).bfloat16()
    tb = torch.from_numpy(b).bfloat16()
    for out_j, out_t in ((None, None), (jnp.float32, torch.float32)):
        want = jops.grouped_matmul(ja, jb, config=JKernelConfig(
            backend="jnp"), out_dtype=out_j)
        got = ops.grouped_matmul(ta, tb, out_dtype=out_t)
        assert got.dtype == (out_t or torch.bfloat16)
        want = np.asarray(want.astype(jnp.float32))
        err = np.abs(got.float().numpy() - want).max()
        assert err <= BF16_TOL * np.abs(want).max()
    cfg = KernelConfig(out_dtype="float32")
    assert ops.grouped_matmul(ta, tb, config=cfg).dtype == torch.float32


def test_grouped_wrapper_validates_and_counts_no_cpu_launch(rng):
    a = torch.zeros(2, 4, 6)
    with pytest.raises(ValueError, match="group/contraction"):
        grouped_zero_stall_matmul(a, torch.zeros(2, 5, 3))
    with pytest.raises(ValueError, match="group/contraction"):
        grouped_zero_stall_matmul(a, torch.zeros(3, 6, 3))
    with pytest.raises(ValueError, match="3-D"):
        grouped_zero_stall_matmul(a[0], torch.zeros(6, 3))
    with pytest.raises(ValueError, match="fp32 or both bf16"):
        grouped_zero_stall_matmul(a, torch.zeros(2, 6, 3).bfloat16())
    with pytest.raises(ValueError, match="out_dtype"):
        grouped_zero_stall_matmul(a, torch.zeros(2, 6, 3),
                                  out_dtype=torch.int8)
    with pytest.raises(ValueError, match="slots"):
        grouped_zero_stall_matmul(a, torch.zeros(2, 6, 3), variant="single",
                                  slots=3)
    x = torch.from_numpy(rng.standard_normal((2, 4, 6)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((2, 6, 3)).astype(np.float32))
    before = grouped_zero_stall_matmul.launches
    got = grouped_zero_stall_matmul(x, w)
    torch.testing.assert_close(got, grouped_matmul_ref(x, w))
    assert grouped_zero_stall_matmul.launches == before


# ----------------------------------------------------------------------
# routing
# ----------------------------------------------------------------------
def _route_both(logits, k, capacity, E, valid=None):
    want = jmoe.router_assignments(
        jnp.asarray(logits), k, capacity, E,
        token_valid=None if valid is None else jnp.asarray(valid))
    got = moe.router_assignments(
        torch.from_numpy(logits), k, capacity, E,
        token_valid=None if valid is None else torch.from_numpy(valid))
    return [np.asarray(w) for w in want], [g.numpy() for g in got]


@pytest.mark.parametrize("case", ["random", "ties", "padding", "overflow"])
def test_router_assignments_equal_jax(rng, case):
    T, E, k = 12, 8, 2
    logits = rng.standard_normal((T, E)).astype(np.float32)
    valid, capacity = None, 4
    if case == "ties":
        logits[:6] = 0.0                            # uniform probabilities
        logits[6:9] = np.array([1, 1, 0.5, 1, 0, 0, 0, 0], np.float32)
        capacity = T * k                            # no rank overflows
    elif case == "padding":
        valid = np.arange(T) < 7
    elif case == "overflow":
        logits[:, 3] += 10.0                        # everyone wants expert 3
        capacity = 2
    want, got = _route_both(logits, k, capacity, E, valid)
    w_slot, w_gates, w_keep, w_tok, w_aux = want
    g_slot, g_gates, g_keep, g_tok, g_aux = got
    np.testing.assert_array_equal(g_keep, w_keep)
    np.testing.assert_array_equal(g_tok, w_tok)
    np.testing.assert_array_equal(g_slot[g_keep], w_slot[w_keep])
    # the chosen experts and ranks, dropped assignments included
    np.testing.assert_array_equal(g_slot, w_slot)
    np.testing.assert_allclose(g_gates, w_gates, rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(g_aux, w_aux, rtol=1e-6)
    if case == "ties":
        # lax.top_k order: the lowest expert index first among equals
        assert (g_slot[:18] // capacity).tolist() == [0, 1] * 6 + [0, 1] * 3
    if case == "padding":
        assert not g_keep[14:].any()
    if case == "overflow":
        assert (~g_keep).sum() > 0


@pytest.mark.parametrize("masked", [False, True])
def test_moe_mlp_matches_jax(pair, masked, rng):
    jm, jp, m, tp, cfg = pair
    x = rng.standard_normal((2, 6, cfg.d_model)).astype(np.float32)
    mask = None
    if masked:
        mask = np.arange(6)[None, :] < np.array([[6], [3]])
    jlp = jax.tree.map(lambda a: a[0], jp["layers"]["mlp"])
    want, want_aux = jmoe.moe_mlp(
        jlp, jnp.asarray(x), j_get_config(cfg.name.removesuffix("-smoke"),
                                          reduced=True), J_CTX,
        return_aux=True,
        token_mask=None if mask is None else jnp.asarray(mask))
    for backend in ("auto", "torch"):
        got, aux = moe.moe_mlp(
            tp["layers"][0]["mlp"], torch.from_numpy(x), cfg,
            Ctx(plan=backend, dtype=torch.float32), return_aux=True,
            token_mask=None if mask is None else torch.from_numpy(mask))
        _close(got, want)
        _close(aux, want_aux)
        if masked:
            assert not got[1, 3:].any()


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_mlp_bf16_matches_jax(arch, rng):
    """bf16 weights and activations: the port's combine sums a token's k
    contributions in fp32 and rounds once, JAX's scatter-add may round
    after each add, and the two libraries round other bf16 ops in their
    own order, so the layer is held within 2e-2 of the largest magnitude
    (bf16), not bit for bit."""
    jcfg, cfg = j_get_config(arch, reduced=True), get_config(arch,
                                                             reduced=True)
    jp = j_build_model(jcfg).init(jax.random.PRNGKey(0), dtype=jnp.bfloat16)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), cfg, device="cpu")
    x = rng.standard_normal((2, 16, cfg.d_model)).astype(np.float32)
    jlp = jax.tree.map(lambda a: a[0], jp["layers"]["mlp"])
    want = np.asarray(jmoe.moe_mlp(jlp, jnp.asarray(x, jnp.bfloat16), jcfg,
                                   JCtx(plan="jnp", dtype=jnp.bfloat16)),
                      np.float32)
    for backend in ("auto", "torch"):
        got = moe.moe_mlp(tp["layers"][0]["mlp"],
                          torch.from_numpy(x).bfloat16(), cfg,
                          Ctx(plan=backend, dtype=torch.bfloat16))
        assert got.dtype == torch.bfloat16
        err = np.abs(got.float().numpy() - want).max()
        assert err <= BF16_TOL * np.abs(want).max()


# ----------------------------------------------------------------------
# the model
# ----------------------------------------------------------------------
@pytest.mark.parametrize("backend", ["auto", "torch"])
def test_moe_prefill_and_decode_match_jax(pair, backend):
    jm, jp, m, tp, cfg = pair
    tokens = np.random.default_rng(3).integers(0, cfg.vocab_size, (2, 8))
    lengths = np.array([8, 5], np.int32)
    jl, jc = jm.prefill(jp, {"tokens": jnp.asarray(tokens),
                             "lengths": jnp.asarray(lengths)}, J_CTX, 12)
    ctx = Ctx(plan=backend, dtype=torch.float32)
    tl, tc = m.prefill(tp, {"tokens": torch.from_numpy(tokens),
                            "lengths": torch.from_numpy(lengths)}, ctx, 12)
    _close(tl, jl)
    _close(tc["k"], jc["k"])
    _close(tc["pos"], jc["pos"], tol=0)
    jlg = jm.prefill_logits(jp, {"tokens": jnp.asarray(tokens)}, J_CTX)
    _close(m.prefill_logits(tp, {"tokens": torch.from_numpy(tokens)}, ctx),
           jlg)
    tok = tokens[:, :1]
    for _ in range(3):
        jd, jc = jm.decode(jp, jc, jnp.asarray(tok), J_CTX)
        td, tc = m.decode(tp, tc, torch.from_numpy(tok), ctx)
        _close(td, jd)
        tok = np.asarray(jd).argmax(-1)


def test_moe_model_has_no_prefill_chunk_and_quantizes():
    m = build_model(get_config("olmoe-1b-7b", reduced=True))
    assert m.prefill_chunk is None
    assert build_model(get_config("gemma-7b", reduced=True)).prefill_chunk \
        is not None
    from repro_torch.quant import QTensor
    q = m.quantize_weights(m.init(seed=0, device="cpu"))
    mlp = q["layers"][0]["mlp"]
    assert all(isinstance(mlp[k], QTensor) for k in ("wi", "wg", "wo"))
    assert isinstance(mlp["router"], torch.Tensor)


# ----------------------------------------------------------------------
# the engine
# ----------------------------------------------------------------------
@pytest.mark.parametrize("K", [1, 4])
def test_moe_engine_matches_jax_engine(K):
    from repro.serve import Request as JRequest
    from repro.serve import ServeEngine as JServeEngine
    jm, jp, m, tp, cfg = _pair("olmoe-1b-7b")
    prompts = [np.random.default_rng(i).integers(0, cfg.vocab_size, n)
               for i, n in enumerate((5, 11, 3, 8))]
    max_new = [6, 3, 5, 4]
    jeng = JServeEngine(jm, jp, J_CTX, num_slots=2, max_len=32,
                        steps_per_dispatch=K)
    want = jeng.run([JRequest(rid=i, prompt=[int(t) for t in p],
                              max_new_tokens=n)
                     for i, (p, n) in enumerate(zip(prompts, max_new))])
    eng = ServeEngine(m, tp, Ctx(plan="auto", dtype=torch.float32),
                      num_slots=2, max_len=32, steps_per_dispatch=K,
                      device="cpu")
    got = eng.run([Request(rid=i, prompt=[int(t) for t in p],
                           max_new_tokens=n)
                   for i, (p, n) in enumerate(zip(prompts, max_new))])
    for i in range(4):
        assert got[i].tokens == [int(t) for t in want[i].tokens]
        assert len(got[i].tokens) == max_new[i]


def test_engine_refuses_prefill_chunk_for_moe():
    m = build_model(get_config("olmoe-1b-7b", reduced=True))
    tp = m.init(seed=0, device="cpu")
    with pytest.raises(ValueError, match="does not support chunked prefill"):
        ServeEngine(m, tp, Ctx(plan="auto", dtype=torch.float32),
                    num_slots=2, max_len=16, prefill_chunk=4, device="cpu")
    # paging alone is fine: decode routes through the same experts
    eng = ServeEngine(m, tp, Ctx(plan="auto", dtype=torch.float32),
                      num_slots=2, max_len=16, page_size=4, device="cpu")
    res = eng.run([Request(rid=0, prompt=[1, 2, 3], max_new_tokens=3)])
    assert len(res[0].tokens) == 3


def test_serve_batch_serves_moe_on_cpu():
    from repro_torch.launch.serve import main, serve_batch
    out = serve_batch("granite-moe-1b-a400m", batch=3, prompt_len=8,
                      gen_len=4, mixed=True, steps_per_dispatch=4,
                      device="cpu")
    assert out["generated"].shape == (3, 4) and (out["generated"] >= 0).all()
    main(["--arch", "olmoe-1b-7b", "--device", "cpu", "--batch", "2",
          "--prompt-len", "8", "--gen-len", "3"])
