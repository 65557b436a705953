"""The port's SSM family (mamba2) against the JAX package's, on shared inputs.

The chunked SSD (:func:`repro_torch.models.ssm.ssd_chunked`) is held
within 2e-5 (fp32, the kernel tolerance) of JAX's ``ssd_chunked`` and of
the port's sequential ``ssd_scan_ref`` at the shapes
``tests/test_ssd.py`` draws, with and without an initial state.  The
block functions (causal conv, ``mamba_forward``, ragged
``mamba_prefill``, ``mamba_decode``) take JAX-initialised block params;
the reduced mamba2-130m model takes JAX-initialised params through
``params_from_numpy``: prefill logits and states, then four decode
steps, within 1e-4 (fp32, summed in another order over two layers), on
both of the port's backends.  The engine's greedy tokens equal JAX
``lockstep_generate``'s.  Inputs come from numpy seeds.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.models import Ctx as JCtx
from repro.models import build_model as j_build_model
from repro.models import ssm as jssm
from repro.quant import QTensor as JQTensor
from repro.quant import quantize_tree as j_quantize_tree
from repro.serve import lockstep_generate as j_lockstep
from repro_torch.configs import get_config
from repro_torch.interop import params_from_numpy, tensor_from_numpy
from repro_torch.kernels.ref import ssd_scan_ref
from repro_torch.models import Ctx, build_model, ssm
from repro_torch.quant import QTensor, quantize_tree
from repro_torch.serve import Request, ServeEngine
from torch_tune_cache import port_tune_cache  # noqa: F401 (autouse)

KERNEL_TOL = 2e-5       # fp32, tests/test_kernels.py's tolerance
TOL = 1e-4              # whole models, as tests/test_torch_models.py
J_CTX = JCtx(plan="jnp", dtype=jnp.float32)
CTX = Ctx(plan="auto", dtype=torch.float32)
ARCH = "mamba2-130m"


def _t(x) -> torch.Tensor:
    return tensor_from_numpy(np.asarray(x), device="cpu")


def _tree(p):
    return jax.tree.map(_t, p)


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), atol=tol,
                               rtol=tol)


def _ssd_inputs(rng, b, s, h, p, n):
    x = rng.standard_normal((b, s, h, p)).astype(np.float32)
    a_log = (-np.abs(rng.standard_normal((b, s, h))) * 0.5).astype(np.float32)
    bb = rng.standard_normal((b, s, h, n)).astype(np.float32)
    cc = rng.standard_normal((b, s, h, n)).astype(np.float32)
    return x, a_log, bb, cc


# ----------------------------------------------------------------------
# chunked SSD
# ----------------------------------------------------------------------
@pytest.mark.parametrize("with_h0", [False, True])
@pytest.mark.parametrize("b,s,h,p,n,chunk", [
    (1, 8, 1, 2, 3, 4), (2, 16, 3, 4, 5, 8), (3, 32, 2, 2, 3, 4),
    (1, 32, 3, 4, 5, 8), (2, 8, 2, 4, 3, 8), (3, 16, 1, 2, 5, 4)])
def test_ssd_chunked_matches_jax_and_scan_ref(b, s, h, p, n, chunk,
                                              with_h0):
    rng = np.random.default_rng(b * 100 + s + h)
    x, a_log, bb, cc = _ssd_inputs(rng, b, s, h, p, n)
    h0 = (rng.standard_normal((b, h, n, p)).astype(np.float32)
          if with_h0 else None)
    jy, jh = jssm.ssd_chunked(*(jnp.asarray(v) for v in (x, a_log, bb, cc)),
                              chunk=chunk,
                              h0=None if h0 is None else jnp.asarray(h0))
    args = [torch.from_numpy(v) for v in (x, a_log, bb, cc)]
    y, hf = ssm.ssd_chunked(*args, chunk=chunk,
                            h0=None if h0 is None else torch.from_numpy(h0))
    assert y.shape == (b, s, h, p) and hf.shape == (b, h, n, p)
    _close(y, jy, KERNEL_TOL)
    _close(hf, jh, KERNEL_TOL)
    for bi in range(b):
        for hi in range(h):
            yr, hr = ssd_scan_ref(*(a[bi, :, hi] for a in args),
                                  h0=None if h0 is None
                                  else torch.from_numpy(h0[bi, hi]))
            torch.testing.assert_close(y[bi, :, hi], yr, atol=KERNEL_TOL,
                                       rtol=KERNEL_TOL)
            torch.testing.assert_close(hf[bi, hi], hr, atol=KERNEL_TOL,
                                       rtol=KERNEL_TOL)


def test_ssd_chunked_refuses_a_ragged_grid():
    x = torch.zeros(1, 12, 1, 2)
    with pytest.raises(ValueError, match="not divisible by chunk"):
        ssm.ssd_chunked(x, torch.zeros(1, 12, 1), torch.zeros(1, 12, 1, 3),
                        torch.zeros(1, 12, 1, 3), chunk=8)


# ----------------------------------------------------------------------
# the mamba2 block
# ----------------------------------------------------------------------
@pytest.fixture(scope="module")
def block():
    """JAX-initialised block params of the reduced config, and the
    port's copy of them."""
    jcfg = j_get_config(ARCH, reduced=True)
    jp = jssm.init_mamba(jax.random.PRNGKey(3), jcfg, jnp.float32)
    return jcfg, jp, get_config(ARCH, reduced=True), _tree(jp)


def test_causal_conv_matches_jax(rng, block):
    jcfg, jp, cfg, tp = block
    xbc = rng.standard_normal((2, 9, jp["conv_w"].shape[1])).astype(
        np.float32)
    b = rng.standard_normal(jp["conv_b"].shape).astype(np.float32)
    want = jssm._causal_conv(jnp.asarray(xbc), jp["conv_w"], jnp.asarray(b))
    got = ssm._causal_conv(torch.from_numpy(xbc), tp["conv_w"],
                           torch.from_numpy(b))
    _close(got, want, KERNEL_TOL)


@pytest.mark.parametrize("backend", ["auto", "torch"])
def test_mamba_forward_matches_jax(rng, block, backend):
    jcfg, jp, cfg, tp = block
    u = (rng.standard_normal((2, 16, cfg.d_model)) * 0.3).astype(np.float32)
    want = jssm.mamba_forward(jp, jnp.asarray(u), jcfg, J_CTX, chunk=8)
    got = ssm.mamba_forward(tp, torch.from_numpy(u), cfg,
                            Ctx(plan=backend, dtype=torch.float32), chunk=8)
    _close(got, want)


def test_mamba_prefill_ragged_matches_jax(rng, block):
    jcfg, jp, cfg, tp = block
    u = (rng.standard_normal((3, 16, cfg.d_model)) * 0.3).astype(np.float32)
    lens = np.array([16, 5, 2], np.int32)
    jy, jst = jssm.mamba_prefill(jp, jnp.asarray(u), jcfg, J_CTX,
                                 lengths=jnp.asarray(lens), chunk=8)
    y, st = ssm.mamba_prefill(tp, torch.from_numpy(u), cfg, CTX,
                              lengths=torch.from_numpy(lens), chunk=8)
    _close(y, jy)
    for name in ("conv", "ssm"):
        assert st[name].dtype == torch.float32
        _close(st[name], jst[name])
    # a 2-token prompt's window starts with a zero row (before the prompt)
    assert bool((st["conv"][2, 0] == 0).all())


def test_mamba_decode_matches_jax_and_updates_in_place(rng, block):
    jcfg, jp, cfg, tp = block
    B = 2
    jstate = jssm.init_ssm_state(jcfg, B, jnp.float32)
    state = ssm.init_ssm_state(cfg, B, torch.float32)
    conv, ssm_state = state["conv"], state["ssm"]
    for t in range(4):
        u = (rng.standard_normal((B, 1, cfg.d_model)) * 0.3).astype(
            np.float32)
        jy, jstate = jssm.mamba_decode(jp, jnp.asarray(u), jcfg, J_CTX,
                                       jstate)
        y, state = ssm.mamba_decode(tp, torch.from_numpy(u), cfg, CTX, state)
        _close(y, jy)
    assert state["conv"] is conv and state["ssm"] is ssm_state
    _close(state["conv"], jstate["conv"])
    _close(state["ssm"], jstate["ssm"])


# ----------------------------------------------------------------------
# configs, params and the model
# ----------------------------------------------------------------------
FIELDS = ("name", "family", "n_layers", "d_model", "n_heads", "n_kv_heads",
          "d_ff", "vocab_size", "resolved_head_dim", "mlp_type", "rope_theta",
          "norm_eps", "tie_embeddings", "ssm_state", "ssm_head_dim",
          "ssm_expand", "ssm_groups", "conv_kernel", "attn_every", "d_inner",
          "ssm_heads", "attention_free")


@pytest.mark.parametrize("reduced", [True, False])
@pytest.mark.parametrize("arch", ["mamba2-130m", "zamba2-2.7b"])
def test_configs_and_param_count_match_jax(arch, reduced):
    mine = get_config(arch, reduced=reduced)
    theirs = j_get_config(arch, reduced=reduced)
    for f in FIELDS:
        assert getattr(mine, f) == getattr(theirs, f), f
    assert mine.param_count() == theirs.param_count()


def test_full_sizes_are_what_one_card_holds():
    assert 1.28e8 < get_config("mamba2-130m").param_count() < 1.30e8
    # zamba2-2.7b as the JAX config defines it: 4.7 GB in bf16
    assert 2.35e9 < get_config("zamba2-2.7b").param_count() < 2.36e9


@pytest.fixture(scope="module")
def pair():
    jcfg = j_get_config(ARCH, reduced=True)
    cfg = get_config(ARCH, reduced=True)
    jm, m = j_build_model(jcfg), build_model(cfg)
    jp = jm.init(jax.random.PRNGKey(0), dtype=jnp.float32)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), cfg, device="cpu")
    return jm, jp, m, tp, cfg


def test_params_from_numpy_unstacks_mamba_layers(pair):
    jm, jp, m, tp, cfg = pair
    assert len(tp["layers"]) == cfg.n_layers
    for i in range(cfg.n_layers):
        _close(tp["layers"][i]["mamba"]["in_proj"]["w"],
               jp["layers"]["mamba"]["in_proj"]["w"][i], tol=0)
    own = m.init(seed=0, device="cpu")

    def shapes(tree, drop=0):
        return {jax.tree_util.keystr(k): tuple(v.shape)[drop:]
                for k, v in jax.tree_util.tree_leaves_with_path(tree)}
    assert shapes(own["layers"][0]) == shapes(jp["layers"], drop=1)
    assert m.prefill_chunk is None
    bad = jax.tree.map(np.asarray, jp)
    bad["layers"]["norm"]["scale"] = bad["layers"]["norm"]["scale"][:1]
    with pytest.raises(ValueError, match="does not lead with n_layers"):
        params_from_numpy(bad, cfg, device="cpu")


@pytest.mark.parametrize("backend", ["auto", "torch"])
def test_mamba2_prefill_and_decode_match_jax(pair, backend):
    jm, jp, m, tp, cfg = pair
    rng = np.random.default_rng(1)
    toks = rng.integers(0, cfg.vocab_size, (3, 11)).astype(np.int32)
    lens = np.array([11, 6, 1], np.int32)
    jl, jc = jm.prefill(jp, {"tokens": jnp.asarray(toks),
                             "lengths": jnp.asarray(lens)}, J_CTX, 16)
    ctx = Ctx(plan=backend, dtype=torch.float32)
    tl, tc = m.prefill(tp, {"tokens": torch.from_numpy(toks).long(),
                            "lengths": torch.from_numpy(lens)}, ctx, 16)
    _close(tl, jl)
    for name in ("conv", "ssm"):
        _close(tc[name], jc[name])
    assert tc["pos"].tolist() == lens.tolist()
    state = {n: tc[n] for n in ("conv", "ssm")}
    step = rng.integers(0, cfg.vocab_size, (4, 3, 1)).astype(np.int32)
    for s in range(4):
        jl, jc = jm.decode(jp, jc, jnp.asarray(step[s]), J_CTX)
        tl, tc = m.decode(tp, tc, torch.from_numpy(step[s]).long(), ctx)
        _close(tl, jl)
    assert all(tc[n] is state[n] for n in state)     # updated in place
    for name in ("conv", "ssm"):
        _close(tc[name], jc[name])
    assert tc["pos"].tolist() == (lens + 4).tolist()


def test_mamba2_prefill_logits_match_jax(pair):
    jm, jp, m, tp, cfg = pair
    toks = np.random.default_rng(3).integers(0, cfg.vocab_size, (2, 7))
    want = jm.prefill_logits(jp, {"tokens": jnp.asarray(toks, jnp.int32)},
                             J_CTX)
    for backend in ("auto", "torch"):
        got = m.prefill_logits(tp, {"tokens": torch.from_numpy(toks)},
                               Ctx(plan=backend, dtype=torch.float32))
        assert got.shape == (2, 1, cfg.vocab_size)
        _close(got, want)


def test_quantize_tree_keeps_ssm_leaves_and_marks_w8a16(pair):
    """The SSM projections are W8A16, as JAX marks them; conv_w, A_log, D,
    dt_bias and the norms keep full precision."""
    jm, jp, m, tp, cfg = pair
    want = jax.tree_util.tree_flatten_with_path(
        j_quantize_tree(jp), is_leaf=lambda x: isinstance(x, JQTensor))[0]
    want = {jax.tree_util.keystr(k): v.w8a8 for k, v in want
            if isinstance(v, JQTensor)}
    q = quantize_tree(tp)
    layer = q["layers"][0]["mamba"]
    got = {f"['layers']['mamba']['{k}']['w']": layer[k]["w"].w8a8
           for k in ("in_proj", "out_proj")}
    assert got == want == {k: False for k in got}
    for k in ("conv_w", "conv_b", "A_log", "D", "dt_bias"):
        assert isinstance(layer[k], torch.Tensor) and not isinstance(
            layer[k], QTensor)
        assert torch.equal(layer[k], tp["layers"][0]["mamba"][k])
    assert isinstance(layer["norm"]["scale"], torch.Tensor)


@pytest.mark.parametrize("K", [1, 4])
def test_mamba2_engine_matches_jax_lockstep(pair, K):
    jm, jp, m, tp, cfg = pair
    prompts = [list(np.random.default_rng(i).integers(0, cfg.vocab_size, n))
               for i, n in enumerate((5, 11, 3, 8))]
    max_new = [6, 3, 5, 7]
    oracle = j_lockstep(jm, jp, J_CTX, prompts, max_new, max_len=32)
    engine = ServeEngine(m, tp, CTX, num_slots=2, max_len=32,
                         steps_per_dispatch=K, device="cpu")
    res = engine.run([Request(rid=i, prompt=p, max_new_tokens=n)
                      for i, (p, n) in enumerate(zip(prompts, max_new))])
    assert [res[i].tokens for i in range(4)] == [
        [int(t) for t in o] for o in oracle]
