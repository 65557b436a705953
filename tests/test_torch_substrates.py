"""The port's training substrates against the JAX package's.

The data pipeline's batches are bit-equal to JAX's (several seeds,
steps and hosts); ``make_schedule``, ``global_norm`` and
``clip_by_global_norm`` agree within 1e-6 relative; ``adamw_update`` on
the same gradient trees (JAX's, converted) gives JAX's params, mu, nu,
step, grad norm and lr within 1e-6 relative to each leaf's largest
magnitude, with fp32 and bf16 moments (bf16 moments: within one bf16
rounding of JAX's, since an fp32 difference of an ulp can round either
way); the in-place update equals the functional one bit for bit; the
int8 codes and scales, the top-k values and indices (on distinct
magnitudes: ``lax.top_k`` and ``torch.topk`` may order ties
differently) and error feedback are bit-equal to JAX's, over the
stacked layers as JAX compresses its stacked leaves.  The checkpointer
runs the JAX package's protocol cases (``tests/test_substrates.py``)
plus a bf16 leaf round trip and a ``.tmp`` directory that ``steps()``
ignores, and ``params_to_numpy`` inverts ``params_from_numpy`` exactly
on every reduced config.  Inputs come from numpy seeds.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import RunConfig as JRunConfig
from repro.configs import get_config as j_get_config
from repro.configs import list_configs as j_list_configs
from repro.data import make_pipeline as j_make_pipeline
from repro.models import build_model as j_build_model
from repro.optim import adamw_update as j_adamw_update
from repro.optim import clip_by_global_norm as j_clip
from repro.optim import global_norm as j_global_norm
from repro.optim import init_opt_state as j_init_opt_state
from repro.optim import make_schedule as j_make_schedule
from repro.optim import compression as jc
from repro_torch.checkpoint import Checkpointer
from repro_torch.configs import RunConfig, get_config
from repro_torch.data import make_pipeline
from repro_torch.interop import params_from_numpy, params_to_numpy
from repro_torch.optim import (OptState, adamw_update, adamw_update_,
                               clip_by_global_norm, global_norm,
                               init_opt_state, make_schedule)
from repro_torch.optim import compression as tc
from repro_torch.tree import flatten, leaves, stacked_groups, tree_map
from torch_tune_cache import port_tune_cache  # noqa: F401 (autouse)

REL = 1e-6


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _close(got, want, rel=REL):
    """Every element within ``rel`` of the leaf's largest magnitude."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rel * max(np.max(np.abs(want)), 1e-30))


# ----------------------------------------------------------------------
# data
# ----------------------------------------------------------------------
@pytest.mark.parametrize("seed,step,n_hosts,host_id", [
    (0, 0, 1, 0), (7, 5, 1, 0), (3, 11, 2, 0), (3, 11, 2, 1), (12, 2, 4, 3)])
def test_batches_bit_equal_to_jax(seed, step, n_hosts, host_id):
    want = j_make_pipeline(256, 32, 8, seed=seed, n_hosts=n_hosts,
                           host_id=host_id).batch(step)
    pipe = make_pipeline(256, 32, 8, seed=seed, n_hosts=n_hosts,
                         host_id=host_id)
    got = pipe.batch(step)
    for k in ("tokens", "targets"):
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k])
    t = pipe.torch_batch(step, "cpu")
    for k in ("tokens", "targets"):
        assert t[k].dtype == torch.int64 and t[k].device.type == "cpu"
        np.testing.assert_array_equal(t[k].numpy(), want[k])


def test_data_deterministic_restartable_and_shifted():
    p1, p2 = make_pipeline(256, 32, 8, seed=7), make_pipeline(256, 32, 8,
                                                              seed=7)
    b1 = p1.batch(step=5)
    np.testing.assert_array_equal(b1["tokens"], p2.batch(5)["tokens"])
    assert not np.array_equal(b1["tokens"], p1.batch(6)["tokens"])
    np.testing.assert_array_equal(b1["tokens"][:, 1:], b1["targets"][:, :-1])
    a = make_pipeline(256, 32, 8, seed=7, n_hosts=2, host_id=0).batch(3)
    b = make_pipeline(256, 32, 8, seed=7, n_hosts=2, host_id=1).batch(3)
    assert a["tokens"].shape == (4, 32)
    assert not np.array_equal(a["tokens"], b["tokens"])
    with pytest.raises(ValueError, match="n_hosts"):
        make_pipeline(256, 32, 8, n_hosts=3)


def test_torch_batch_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        make_pipeline(256, 8, 2).torch_batch(0)


# ----------------------------------------------------------------------
# schedule, norms
# ----------------------------------------------------------------------
@pytest.mark.parametrize("warmup,total", [(10, 100), (1, 7), (0, 5),
                                          (5, 5)])
def test_schedule_equals_jax(warmup, total):
    kw = dict(lr=1e-3, warmup_steps=warmup, total_steps=total)
    js, ts = j_make_schedule(JRunConfig(**kw)), make_schedule(RunConfig(**kw))
    for step in range(total + 2):
        want = float(js(jnp.asarray(step, jnp.int32)))
        got = ts(torch.tensor(step, dtype=torch.int32))
        assert got.dtype == torch.float32
        assert float(got) == pytest.approx(want, rel=REL, abs=1e-12), step


def _grad_tree(seed, scale=1.0):
    """A tree of the port's shape (a layer list) and JAX's stacked one."""
    rng = np.random.default_rng(seed)
    layers = [{"w": rng.standard_normal((6, 5)).astype(np.float32) * scale,
               "b": rng.standard_normal(5).astype(np.float32) * scale}
              for _ in range(3)]
    emb = rng.standard_normal((7, 4)).astype(np.float32) * scale
    port = {"embed": torch.from_numpy(emb),
            "layers": [{k: torch.from_numpy(v) for k, v in lp.items()}
                       for lp in layers]}
    jx = {"embed": jnp.asarray(emb),
          "layers": {k: jnp.asarray(np.stack([lp[k] for lp in layers]))
                     for k in ("w", "b")}}
    return port, jx


def _as_jax_layout(tree):
    return {"embed": tree["embed"].numpy(),
            "layers": {k: np.stack([lp[k].numpy() for lp in tree["layers"]])
                       for k in ("w", "b")}}


@pytest.mark.parametrize("scale", [0.01, 100.0])
def test_global_norm_and_clip_equal_jax(scale):
    port, jx = _grad_tree(1, scale)
    assert float(global_norm(port)) == pytest.approx(float(j_global_norm(jx)),
                                                     rel=REL)
    got, norm = clip_by_global_norm(port, 1.0)
    want, jnorm = j_clip(jx, 1.0)
    assert float(norm) == pytest.approx(float(jnorm), rel=REL)
    for g, w in zip(jax.tree.leaves(_as_jax_layout(got)),
                    jax.tree.leaves(_np(want))):
        _close(g, w)
    if scale > 1:
        assert float(global_norm(got)) == pytest.approx(1.0, rel=1e-5)


# ----------------------------------------------------------------------
# AdamW
# ----------------------------------------------------------------------
def _model_pair(arch="gemma-7b"):
    jcfg, cfg = j_get_config(arch, reduced=True), get_config(arch,
                                                             reduced=True)
    jp = j_build_model(jcfg).init(jax.random.PRNGKey(0), dtype=jnp.float32)
    return jp, params_from_numpy(_np(jp), cfg, device="cpu"), cfg


@pytest.mark.parametrize("moments", ["float32", "bfloat16"])
def test_adamw_update_on_jax_gradients_equals_jax(moments):
    """Three AdamW steps of the port and of JAX on the same gradient
    trees (JAX's, converted), from the same reduced gemma-7b params."""
    jp, tp, cfg = _model_pair()
    kw = dict(lr=3e-3, warmup_steps=2, total_steps=10)
    jrun, run = JRunConfig(**kw), RunConfig(**kw)
    jopt = j_init_opt_state(jp, moments_dtype=getattr(jnp, moments))
    opt = init_opt_state(tp, moments_dtype=getattr(torch, moments))
    rng = np.random.default_rng(5)
    for step in range(3):
        jg = jax.tree.map(
            lambda x: jnp.asarray(rng.standard_normal(x.shape) * 0.05,
                                  jnp.float32), jp)
        tg = params_from_numpy(_np(jg), cfg, device="cpu")
        jp, jopt, jm = j_adamw_update(jp, jg, jopt, jrun)
        tp, opt, m = adamw_update(tp, tg, opt, run)
        assert int(opt.step) == int(jopt.step) == step + 1
        assert float(m["grad_norm"]) == pytest.approx(
            float(jm["grad_norm"]), rel=REL)
        assert float(m["lr"]) == pytest.approx(float(jm["lr"]), rel=REL)
        # bf16 moments round an fp32 value that may differ by an ulp:
        # one bf16 rounding (2^-8 relative) either way
        mrel = REL if moments == "float32" else 2.0 ** -8
        for tree, jtree, rel in ((tp, jp, REL), (opt.mu, jopt.mu, mrel),
                                 (opt.nu, jopt.nu, mrel)):
            got = params_to_numpy(tree, cfg)
            for (path, w), g in zip(
                    jax.tree_util.tree_leaves_with_path(_np(jtree)),
                    jax.tree.leaves(got)):
                assert g.dtype == w.dtype, path
                _close(g.astype(np.float32), w.astype(np.float32), rel)


def test_inplace_update_equals_functional_bit_for_bit():
    _, tp, _ = _model_pair()
    run = RunConfig(lr=1e-2, warmup_steps=1, total_steps=5,
                    weight_decay=0.1, grad_clip=0.5)
    gen = torch.Generator().manual_seed(3)

    def grads():
        return tree_map(lambda p: torch.randn(p.shape, generator=gen), tp)

    fp, fopt = tp, init_opt_state(tp)
    ip, iopt = tree_map(torch.clone, tp), init_opt_state(tp)
    for _ in range(3):
        g = grads()
        before = tree_map(torch.clone, fp), tree_map(torch.clone, g)
        fp, fopt, fm = adamw_update(fp, g, fopt, run)
        # the functional form leaves its arguments as they were
        for a, b in zip(leaves(before[1]), leaves(g)):
            assert torch.equal(a, b)
        im = adamw_update_(ip, g, iopt, run)
        for a, b in zip(leaves((fp, fopt)), leaves((ip, iopt))):
            assert torch.equal(a, b)
        assert torch.equal(fm["grad_norm"], im["grad_norm"])
        assert torch.equal(fm["lr"], im["lr"])
    assert isinstance(iopt, OptState) and int(iopt.step) == 3


def test_adamw_minimizes_quadratic():
    run = RunConfig(lr=0.05, warmup_steps=1, total_steps=200,
                    weight_decay=0.0, grad_clip=1e9)
    target = torch.tensor([1.0, -2.0, 3.0])
    params = {"w": torch.zeros(3)}
    state = init_opt_state(params)
    for _ in range(200):
        w = params["w"].detach().requires_grad_()
        g, = torch.autograd.grad(torch.sum((w - target) ** 2), w)
        adamw_update_(params, {"w": g}, state, run)
    torch.testing.assert_close(params["w"], target, atol=0.05, rtol=0)


# ----------------------------------------------------------------------
# compression
# ----------------------------------------------------------------------
@pytest.mark.parametrize("n", [1, 7, 200, 4099])
def test_int8_codes_bit_equal_to_jax(n):
    rng = np.random.default_rng(n)
    x = rng.standard_normal(n).astype(np.float32)
    x[: min(n, 3)] = [0.5, -1.5, 2.5][: min(n, 3)]      # ties at n == 1..3
    jq, js = jc.compress_int8(jnp.asarray(x))
    q, s = tc.compress_int8(torch.from_numpy(x))
    assert q.dtype == torch.int8
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    np.testing.assert_array_equal(tc.decompress_int8(q, s).numpy(),
                                  np.asarray(jc.decompress_int8(jq, js)))
    err = torch.abs(tc.decompress_int8(q, s) - torch.from_numpy(x))
    assert float(err.max()) <= float(s) * 0.5 + 1e-6


def test_topk_equals_jax_on_distinct_magnitudes():
    rng = np.random.default_rng(0)
    x = (rng.permutation(240).astype(np.float32) + 1.0) * 0.01
    x *= np.where(rng.random(240) < 0.5, -1.0, 1.0).astype(np.float32)
    x = x.reshape(12, 20)
    jv, ji = jc.compress_topk(jnp.asarray(x), frac=0.1)
    v, i = tc.compress_topk(torch.from_numpy(x), frac=0.1)
    np.testing.assert_array_equal(v.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(
        tc.decompress_topk(v, i, (12, 20), torch.float32).numpy(),
        np.asarray(jc.decompress_topk(jv, ji, (12, 20), jnp.float32)))
    y = tc.decompress_topk(*tc.compress_topk(
        torch.tensor([0.1, -5.0, 0.01, 3.0]), frac=0.5), (4,), torch.float32)
    assert y.tolist() == [0.0, -5.0, 0.0, 3.0]


def test_stacked_groups_are_jax_leaves():
    port, _ = _grad_tree(0)
    ls = leaves(port)
    groups = stacked_groups(port)
    # embed; layers' b (3 layers); layers' w (3 layers), in list order
    assert groups == [[0], [1, 3, 5], [2, 4, 6]]
    assert all(ls[i].shape == (5,) for i in groups[1])
    hyb = {"layers": [[{"a": 0}, {"a": 1}], [{"a": 2}, {"a": 3}]], "s": 9}
    assert stacked_groups(hyb) == [[0, 1, 2, 3], [4]]


@pytest.mark.parametrize("scheme", ["int8", "topk"])
def test_error_feedback_equals_jax(scheme):
    """Four steps of error feedback on a layer-list tree against JAX on
    the stacked tree: the sent gradients and residuals bit-equal (the
    magnitudes are distinct, so top-k chooses as JAX does)."""
    rng = np.random.default_rng(1)
    port, jx = _grad_tree(2)
    res, jres = tc.init_residuals(port), jc.init_residuals(jx)
    for _ in range(4):
        flat = (rng.permutation(30 * 3 + 5 * 3 + 28).astype(np.float32)
                + 1.0) * 1e-3
        flat *= np.where(rng.random(flat.size) < 0.5, -1, 1).astype(
            np.float32)
        port["embed"] = torch.from_numpy(flat[:28].reshape(7, 4).copy())
        ws = flat[28:118].reshape(3, 6, 5)
        bs = flat[118:].reshape(3, 5)
        for li, lp in enumerate(port["layers"]):
            lp["w"], lp["b"] = torch.from_numpy(ws[li]), torch.from_numpy(bs[li])
        jx = {"embed": jnp.asarray(flat[:28].reshape(7, 4)),
              "layers": {"w": jnp.asarray(ws), "b": jnp.asarray(bs)}}
        sent, res = tc.apply_error_feedback(port, res, scheme=scheme,
                                            topk_frac=0.2)
        jsent, jres = jc.apply_error_feedback(jx, jres, scheme=scheme,
                                              topk_frac=0.2)
        for got, want in ((sent, jsent), (res, jres)):
            for g, w in zip(jax.tree.leaves(_as_jax_layout(got)),
                            jax.tree.leaves(_np(want))):
                np.testing.assert_array_equal(g, w)
    same, r = tc.apply_error_feedback(port, res, scheme="none")
    assert same is port and r is res
    with pytest.raises(ValueError):
        tc.apply_error_feedback(port, res, scheme="fp4")


def test_error_feedback_preserves_signal():
    rng = np.random.default_rng(0)
    seq = [{"w": torch.from_numpy(rng.standard_normal(32).astype(np.float32)
                                  * 0.1)} for _ in range(50)]
    res = tc.init_residuals(seq[0])
    total_true, total_sent = np.zeros(32), np.zeros(32)
    for g in seq:
        sent, res = tc.apply_error_feedback(g, res, scheme="int8")
        total_true += g["w"].numpy()
        total_sent += sent["w"].numpy()
    diff = np.abs(total_true - (total_sent + res["w"].numpy()))
    assert diff.max() < 1e-4


# ----------------------------------------------------------------------
# checkpointing
# ----------------------------------------------------------------------
def test_checkpoint_roundtrip(tmp_path):
    ck = Checkpointer(str(tmp_path), keep=2)
    tree = {"a": torch.arange(6).reshape(2, 3), "b": {"c": torch.ones(4)},
            "l": [torch.zeros(2), torch.full((3,), 2.0)]}
    ck.save(3, tree, blocking=True)
    got, step = ck.restore(tree, device="cpu")
    assert step == 3
    for a, b in zip(leaves(got), leaves(tree)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    spec = json.load(open(tmp_path / "step_0000000003" / "manifest.json"))
    assert spec["n_leaves"] == 4 and spec["step"] == 3
    assert spec["dtypes"] == ["int64", "float32", "float32", "float32"]


def test_checkpoint_keep_k_and_async(tmp_path):
    ck = Checkpointer(str(tmp_path), keep=2)
    tree = {"w": torch.ones(8)}
    for s in (1, 2, 3, 4):
        ck.save(s, tree)
    ck.wait()
    assert ck.steps() == [3, 4] and ck.latest_step() == 4
    assert not any(n.endswith(".tmp") for n in os.listdir(tmp_path))


def test_checkpoint_shape_mismatch_raises(tmp_path):
    ck = Checkpointer(str(tmp_path))
    ck.save(0, {"w": torch.ones(8)}, blocking=True)
    with pytest.raises(ValueError, match="mismatch"):
        ck.restore({"w": torch.ones(9)}, device="cpu")


def test_checkpoint_snapshot_is_taken_at_save(tmp_path):
    """The train loop updates its tensors in place after a save: the
    saved values are those at the save, on the CPU too."""
    ck = Checkpointer(str(tmp_path))
    w = torch.zeros(4)
    ck.save(0, {"w": w})
    w.add_(1.0)
    got, _ = ck.restore({"w": w}, device="cpu")
    assert torch.equal(got["w"], torch.zeros(4))


def test_checkpoint_bf16_optstate_and_tmp_dirs(tmp_path):
    ck = Checkpointer(str(tmp_path))
    x = torch.tensor([1.0, -2.5, 3.14159, 1e-3]).to(torch.bfloat16)
    state = {"p": [x, x * 2],
             "opt": OptState(mu={"w": x.float()}, nu={"w": x.float() ** 2},
                             step=torch.tensor(7, dtype=torch.int32))}
    ck.save(5, state, blocking=True)
    # a half-written checkpoint is never seen
    os.makedirs(tmp_path / "step_0000000009.tmp")
    assert ck.steps() == [5]
    got, step = ck.restore(state, device="cpu")
    assert step == 5 and isinstance(got["opt"], OptState)
    for a, b in zip(leaves(got), leaves(state)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert flatten(got)[1] == flatten(state)[1]
    with pytest.raises(FileNotFoundError):
        Checkpointer(str(tmp_path / "empty")).restore(state, device="cpu")


def test_checkpoint_restore_defaults_to_the_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    ck = Checkpointer(str(tmp_path))
    ck.save(0, {"w": torch.ones(2)}, blocking=True)
    with pytest.raises(RuntimeError, match="CUDA"):
        ck.restore({"w": torch.ones(2)})


def test_failed_async_write_surfaces_on_wait(tmp_path):
    """A write that fails on the background thread raises at the next
    wait (here: a file where the step's tmp directory goes)."""
    ck = Checkpointer(str(tmp_path))
    (tmp_path / "step_0000000002.tmp").write_text("not a directory")
    ck.save(2, {"w": torch.ones(2)})
    with pytest.raises(RuntimeError, match="async checkpoint"):
        ck.wait()
    assert ck.steps() == []
    ck.wait()                       # the error is reported once


# ----------------------------------------------------------------------
# interop
# ----------------------------------------------------------------------
@pytest.mark.parametrize("arch", j_list_configs())
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_params_to_numpy_inverts_params_from_numpy(arch, dtype):
    jcfg, cfg = j_get_config(arch, reduced=True), get_config(arch,
                                                             reduced=True)
    want = _np(j_build_model(jcfg).init(jax.random.PRNGKey(1),
                                        dtype=getattr(jnp, dtype)))
    got = params_to_numpy(params_from_numpy(want, cfg, device="cpu"), cfg)
    assert jax.tree.structure(got) == jax.tree.structure(want)
    for (path, w), g in zip(jax.tree_util.tree_leaves_with_path(want),
                            jax.tree.leaves(got)):
        assert g.dtype == w.dtype and g.shape == w.shape, path
        assert (np.ascontiguousarray(g).tobytes()
                == np.ascontiguousarray(w).tobytes()), path
