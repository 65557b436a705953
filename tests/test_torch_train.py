"""The port's train step and train loop against the JAX package's.

JAX initialises each reduced config; ``params_from_numpy`` converts it,
and ``params_to_numpy`` brings the port's trees back to JAX's stacked
layout, so every comparison is leaf by leaf.  In fp32 on the CPU:

* the loss within 1e-5 relative and every gradient leaf within 2e-5 of
  its largest magnitude (``tests/test_kernels.py``'s fp32 tolerance),
  on reduced gemma-7b, qwen1.5-32b (QKV bias), olmoe-1b-7b (the aux
  loss), mamba2-130m and zamba2-2.7b;
* one ``make_train_step`` against JAX's (``microbatches`` 1 and 2,
  ``grad_compression`` none, int8 and top-k): loss and grad norm within
  1e-5 relative; mu = (1 - b1) g and nu = (1 - b2) g^2 within the
  gradients' tolerance (2e-5 and 4e-5 of the leaf's largest), plus, for
  int8, one code of the leaf (an element at a rounding boundary may take
  the next code: max / 127 on mu, 2 / 127 + 1 / 127^2 on nu); top-k
  the same, except that where a stacked leaf's k-th and (k+1)-th
  magnitudes lie within that tolerance the two may select different
  entries (each such entry 0 on one side and at the k-th magnitude on
  the other).  Updated parameters within 2 lr: at the first step
  AdamW's update is g / (|g| + 1e-8) + wd p, whose first term is within
  (-1, 1), so a gradient element at noise level (whose sign may differ)
  moves its parameter by at most 2 lr, and every other by far less;
* a 5-step lockstep of both steps, each fed by its own pipeline: the
  batches bit-equal and every step's loss within 1e-5 relative;
* ``remat`` none, dots and full give bit-equal gradients, and the
  policy saves what JAX's does (``mm`` outputs under dots, nothing
  under full);
* JAX's five ``tests/test_e2e_train.py`` cases on the port's
  ``train_loop(device="cpu")`` with the same assertions; seamless
  refusing as JAX does; ``train_loop()`` raising without a CUDA device.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro.configs import RunConfig as JRunConfig
from repro.configs import get_config as j_get_config
from repro.data import make_pipeline as j_make_pipeline
from repro.launch.train import make_train_step as j_make_train_step
from repro.launch.train import train_loop as j_train_loop
from repro.models import Ctx as JCtx
from repro.models import build_model as j_build_model
from repro.optim import init_opt_state as j_init_opt_state
from repro.optim.compression import init_residuals as j_init_residuals
from repro_torch.configs import RunConfig, get_config
from repro_torch.data import make_pipeline
from repro_torch.interop import params_from_numpy, params_to_numpy
from repro_torch.launch import train as T
from repro_torch.models import Ctx, build_model
from repro_torch.models.transformer import remat
from repro_torch.optim import init_opt_state
from repro_torch.optim.compression import init_residuals
from repro_torch.runtime.fault_tolerance import TransientError
from repro_torch.tree import flatten, unflatten
from torch_tune_cache import port_tune_cache  # noqa: F401 (autouse)

ARCHS = ["gemma-7b", "qwen1.5-32b", "olmoe-1b-7b", "mamba2-130m",
         "zamba2-2.7b"]
S, B = 16, 4
LOSS_REL, GRAD_TOL = 1e-5, 2e-5
J_CTX = JCtx(plan="jnp", dtype=jnp.float32)
CTX = Ctx(plan="torch", dtype=torch.float32)
KW = dict(seq_len=S, global_batch=B, lr=3e-3, warmup_steps=2,
          total_steps=10, dtype="float32")


@functools.lru_cache(maxsize=None)
def _pair(arch):
    jcfg, cfg = j_get_config(arch, reduced=True), get_config(arch,
                                                             reduced=True)
    jm = j_build_model(jcfg)
    jp = jm.init(jax.random.PRNGKey(0), dtype=jnp.float32)
    return jm, jp, build_model(cfg), cfg


def _port_params(arch):
    """A fresh conversion of JAX's params (the step updates in place)."""
    _, jp, _, cfg = _pair(arch)
    return params_from_numpy(jax.tree.map(np.asarray, jp), cfg, device="cpu")


def _leaves(tree_np):
    return jax.tree_util.tree_leaves_with_path(tree_np)


def _within(got, want, atol_of, what):
    """Leaf by leaf: |got - want| <= atol_of(want leaf)."""
    got_l = jax.tree.leaves(got)
    want_l = _leaves(jax.tree.map(np.asarray, want))
    assert len(got_l) == len(want_l)
    for g, (path, w) in zip(got_l, want_l):
        assert g.shape == w.shape, (what, path)
        err = np.max(np.abs(g.astype(np.float64) - w), initial=0.0)
        assert err <= atol_of(w), (what, jax.tree_util.keystr(path), err,
                                   atol_of(w))


def _rel_max(rel):
    return lambda w: rel * np.max(np.abs(w), initial=0.0)


def _grads(m, params, batch):
    ps, treedef = flatten(params)
    xs = [p.detach().requires_grad_() for p in ps]
    loss = m.loss(unflatten(treedef, xs), batch, CTX)
    return loss.item(), unflatten(treedef,
                                  list(torch.autograd.grad(loss, xs)))


def _batch(cfg, step=0):
    b = make_pipeline(cfg.vocab_size, S, B, seed=0)
    return b.batch(step), b.torch_batch(step, "cpu")


# ----------------------------------------------------------------------
# loss and gradients
# ----------------------------------------------------------------------
@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_gradients_equal_jax(arch):
    jm, jp, m, cfg = _pair(arch)
    nb, tb = _batch(cfg)
    jl, jg = jax.value_and_grad(
        lambda p: jm.loss(p, jax.tree.map(jnp.asarray, nb), J_CTX))(jp)
    loss, g = _grads(m, _port_params(arch), tb)
    assert loss == pytest.approx(float(jl), rel=LOSS_REL)
    _within(params_to_numpy(g, cfg), jg, _rel_max(GRAD_TOL), "grads")


# ----------------------------------------------------------------------
# the train step
# ----------------------------------------------------------------------
STEP_CASES = ([(a, 1, "none") for a in ARCHS]
              + [(a, 2, "none") for a in ARCHS]
              + [(a, 1, "int8") for a in ARCHS]
              + [(a, 1, "topk") for a in ARCHS]
              + [("qwen1.5-32b", 2, "int8")])


def _topk_within(got, want, rel, what):
    """Leaf by leaf within ``rel`` of the largest magnitude, except at the
    top-k selection's boundary: where the k-th and (k+1)-th magnitudes
    lie within the gradients' tolerance of each other, the two may select
    different entries, so an entry may be 0 on one side and, on the
    other, within twice the tolerance of the smallest selected
    magnitude."""
    for g, (path, w) in zip(jax.tree.leaves(got),
                            _leaves(jax.tree.map(np.asarray, want))):
        tol = rel * np.max(np.abs(w))
        bad = np.abs(g - w) > tol
        if not bad.any():
            continue
        kth = np.min(np.abs(w[w != 0]))
        swapped = (np.minimum(np.abs(g), np.abs(w)) == 0) & (
            np.abs(np.maximum(np.abs(g), np.abs(w)) - kth) <= 2 * tol)
        assert swapped[bad].all(), (what, jax.tree_util.keystr(path))


@pytest.mark.parametrize("arch,mb,scheme", STEP_CASES)
def test_train_step_equals_jax(arch, mb, scheme):
    jm, jp, m, cfg = _pair(arch)
    jrun = JRunConfig(microbatches=mb, grad_compression=scheme, **KW)
    run = RunConfig(microbatches=mb, grad_compression=scheme, **KW)
    nb, tb = _batch(cfg)
    jstep = j_make_train_step(jm, J_CTX, jrun)
    # JAX's top-k decompression takes a concrete size: it runs eagerly
    jstep = jstep if scheme == "topk" else jax.jit(jstep)
    jres = j_init_residuals(jp) if scheme != "none" else {}
    jp2, jopt, _, jmet = jstep(jp, j_init_opt_state(jp), jres,
                               jax.tree.map(jnp.asarray, nb))
    tp = _port_params(arch)
    res = init_residuals(tp) if scheme != "none" else {}
    p2, opt, _, met = T.make_train_step(m, CTX, run)(
        tp, init_opt_state(tp), res, tb)
    assert p2 is tp                         # updated in place
    assert float(met["loss"]) == pytest.approx(float(jmet["loss"]),
                                               rel=LOSS_REL)
    assert float(met["grad_norm"]) == pytest.approx(
        float(jmet["grad_norm"]), rel=LOSS_REL)
    assert float(met["lr"]) == pytest.approx(float(jmet["lr"]), rel=1e-6)
    assert int(opt.step) == int(jopt.step) == 1
    mu, nu = params_to_numpy(opt.mu, cfg), params_to_numpy(opt.nu, cfg)
    if scheme == "topk":
        _topk_within(mu, jopt.mu, GRAD_TOL, "mu")
        _topk_within(nu, jopt.nu, 2 * GRAD_TOL, "nu")
    else:
        q = 1 / 127 if scheme == "int8" else 0.0
        _within(mu, jopt.mu, _rel_max(GRAD_TOL + q), "mu")
        _within(nu, jopt.nu, _rel_max(2 * GRAD_TOL + 2 * q + q * q), "nu")
    lr = float(jmet["lr"])
    _within(params_to_numpy(p2, cfg), jp2,
            lambda w: 2 * lr + 1e-6 * np.max(np.abs(w)), "params")


@pytest.mark.parametrize("arch", ["gemma-7b", "mamba2-130m"])
def test_five_steps_lockstep_with_jax(arch):
    jm, jp, m, cfg = _pair(arch)
    jrun, run = JRunConfig(**KW), RunConfig(**KW)
    jpipe = j_make_pipeline(cfg.vocab_size, S, B, seed=0)
    pipe = make_pipeline(cfg.vocab_size, S, B, seed=0)
    jstep = jax.jit(j_make_train_step(jm, J_CTX, jrun))
    step = T.make_train_step(m, CTX, run)
    jopt, jr = j_init_opt_state(jp), {}
    tp = _port_params(arch)
    opt, r = init_opt_state(tp), {}
    for i in range(5):
        jb, tb = jpipe.batch(i), pipe.torch_batch(i, "cpu")
        for k in jb:
            np.testing.assert_array_equal(tb[k].numpy(), jb[k])
        jp, jopt, jr, jmet = jstep(jp, jopt, jr,
                                   jax.tree.map(jnp.asarray, jb))
        tp, opt, r, met = step(tp, opt, r, tb)
        assert float(met["loss"]) == pytest.approx(float(jmet["loss"]),
                                                   rel=LOSS_REL), i
        assert float(met["grad_norm"]) == pytest.approx(
            float(jmet["grad_norm"]), rel=1e-4), i


def test_microbatches_split_the_batch_in_order():
    """microbatches=2 computes what two half batches give: the mean of
    their losses and gradients."""
    _, _, m, cfg = _pair("gemma-7b")
    _, tb = _batch(cfg)
    halves = [{k: v[i * 2:(i + 1) * 2] for k, v in tb.items()}
              for i in range(2)]
    base = _port_params("gemma-7b")
    want = [_grads(m, base, h) for h in halves]
    run = RunConfig(microbatches=2, **KW)
    tp = _port_params("gemma-7b")
    opt = init_opt_state(tp)
    _, opt, _, met = T.make_train_step(m, CTX, run)(tp, opt, {}, tb)
    assert float(met["loss"]) == pytest.approx(
        want[0][0] / 2 + want[1][0] / 2, rel=1e-6)
    mean = [a / 2 + b / 2 for a, b in zip(flatten(want[0][1])[0],
                                          flatten(want[1][1])[0])]
    norm = float(torch.sqrt(sum(torch.sum(x.double() ** 2) for x in mean)))
    assert float(met["grad_norm"]) == pytest.approx(norm, rel=1e-6)


# ----------------------------------------------------------------------
# remat
# ----------------------------------------------------------------------
class _Count(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.n = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.n[func] = self.n.get(func, 0) + 1
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("arch", ARCHS + ["seamless-m4t-large-v2"])
def test_remat_modes_give_bit_equal_gradients(arch):
    base = get_config(arch, reduced=True)
    params = build_model(base).init(seed=0, device="cpu")
    _, tb = _batch(base)
    if base.family == "encdec":
        tb["frontend_embeds"] = torch.randn(
            B, 8, base.d_model, generator=torch.Generator().manual_seed(0))
    got = {}
    for mode in ("none", "dots", "full"):
        m = build_model(dataclasses.replace(base, remat=mode))
        with _Count() as c:
            loss, g = _grads(m, params, tb)
        got[mode] = (loss, flatten(g)[0], c.n)
    for mode in ("dots", "full"):
        assert got[mode][0] == got["none"][0]
        for a, b in zip(got[mode][1], got["none"][1]):
            assert torch.equal(a, b), mode
    mm, rsqrt = torch.ops.aten.mm.default, torch.ops.aten.rsqrt.default
    n = {mode: got[mode][2] for mode in got}
    # dots keeps every mm output and recomputes the norms; full keeps
    # nothing and recomputes both
    assert n["none"][mm] == n["dots"][mm] < n["full"][mm]
    assert n["none"][rsqrt] < n["dots"][rsqrt] == n["full"][rsqrt]


def test_remat_applies_only_when_autograd_records():
    cfg = get_config("gemma-7b", reduced=True)     # remat "dots"
    assert cfg.remat == "dots"
    assert get_config("gemma-7b").remat == "full"

    def body(x, lp):
        return x

    plain = {"w": torch.ones(2)}
    assert remat(body, cfg, [plain]) is body
    assert remat(body, dataclasses.replace(cfg, remat="none"),
                 [{"w": torch.ones(2, requires_grad=True)}]) is body
    rec = [{"w": torch.ones(2, requires_grad=True)}]
    assert remat(body, cfg, rec) is not body
    with torch.no_grad():
        assert remat(body, cfg, rec) is body
    with pytest.raises(ValueError, match="remat"):
        remat(body, dataclasses.replace(cfg, remat="some"), rec)


# ----------------------------------------------------------------------
# the train loop: JAX's end-to-end cases
# ----------------------------------------------------------------------
def _run(tmp_path, steps=40, arch="mamba2-130m", **kw):
    run = RunConfig(seq_len=64, global_batch=4, lr=3e-3,
                    warmup_steps=4, total_steps=steps,
                    ckpt_dir=str(tmp_path), ckpt_every=steps // 2,
                    dtype="float32", **kw)
    return T.train_loop(arch, run, reduced=True, log_every=1000,
                        device="cpu")


def test_loss_decreases(tmp_path):
    out = _run(tmp_path)
    first = np.mean(out["losses"][:5])
    last = np.mean(out["losses"][-5:])
    assert last < first - 0.05, (first, last)


def test_resume_from_checkpoint(tmp_path):
    out1 = _run(tmp_path, steps=20)
    # run 1 writes its final checkpoint at step 19; run 2 resumes at 20
    # and continues the deterministic data stream to step 29
    out2 = _run(tmp_path, steps=30)
    assert len(out2["losses"]) == 30 - 20
    assert out2["final_loss"] < out1["losses"][0]


def test_resume_replays_the_unbroken_run(tmp_path):
    """A run that lost its last checkpoints resumes from the latest one
    left and gives the unbroken run's losses, bit for bit on the CPU."""
    import shutil
    unbroken = _run(tmp_path, steps=30)    # checkpoints at 15 and 29
    shutil.rmtree(tmp_path / "step_0000000029")
    resumed = _run(tmp_path, steps=30)
    assert resumed["losses"] == unbroken["losses"][16:]


def test_training_survives_injected_failures(tmp_path):
    fail_at = {7, 13}

    def hook(step):
        if step in fail_at:
            fail_at.discard(step)
            raise TransientError("injected preemption")

    run = RunConfig(seq_len=64, global_batch=4, lr=3e-3, warmup_steps=4,
                    total_steps=20, ckpt_dir=str(tmp_path), ckpt_every=5,
                    dtype="float32")
    out = T.train_loop("mamba2-130m", run, reduced=True, failure_hook=hook,
                       log_every=1000, device="cpu")
    assert out["executor"].retries_total == 2
    assert len(out["losses"]) == 20
    assert np.isfinite(out["final_loss"])


def test_grad_accumulation_matches_plain(tmp_path):
    """microbatches=2 must train comparably (same loss trajectory
    within tolerance at equal token budget)."""
    o1 = _run(tmp_path / "a", steps=15)
    o2 = _run(tmp_path / "b", steps=15, microbatches=2)
    assert abs(o1["losses"][0] - o2["losses"][0]) < 1e-3
    assert abs(o1["final_loss"] - o2["final_loss"]) < 0.15


def test_compressed_training_converges(tmp_path):
    out = _run(tmp_path, steps=30, grad_compression="int8")
    assert np.mean(out["losses"][-5:]) < np.mean(out["losses"][:5])


def test_seamless_refuses_as_jax_does(tmp_path):
    """The encdec loss reads the batch's source frames, which the token
    pipeline does not make: both train loops raise KeyError."""
    kw = dict(seq_len=8, global_batch=2, total_steps=1, dtype="float32")
    with pytest.raises(KeyError, match="frontend_embeds"):
        j_train_loop("seamless-m4t-large-v2",
                     JRunConfig(ckpt_dir=str(tmp_path / "j"), **kw),
                     log_every=1000)
    with pytest.raises(KeyError, match="frontend_embeds"):
        T.train_loop("seamless-m4t-large-v2",
                     RunConfig(ckpt_dir=str(tmp_path / "t"), **kw),
                     log_every=1000, device="cpu")


def test_train_loop_defaults_to_the_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        T.train_loop("mamba2-130m", RunConfig(ckpt_dir=str(tmp_path)))


def test_layers_cut_and_cli(tmp_path, capsys):
    T.main(["--arch", "gemma-7b", "--device", "cpu", "--steps", "2",
            "--seq-len", "8", "--global-batch", "2", "--layers", "1",
            "--compression", "int8", "--ckpt-dir", str(tmp_path)])
    out = capsys.readouterr().out
    assert "final loss:" in out and "retries=0" in out
    run = RunConfig(seq_len=8, global_batch=2, total_steps=1,
                    ckpt_dir=str(tmp_path / "z"), dtype="float32")
    with pytest.raises(ValueError, match="n_layers"):
        T.train_loop("zamba2-2.7b", run, device="cpu", n_layers=1)
    out = T.train_loop("gemma-7b", run, device="cpu", n_layers=1,
                       log_every=1000)
    assert len(out["state"]["params"]["layers"]) == 1
