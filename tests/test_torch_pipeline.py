"""Pipeline parallelism, the train step, the train loop and the elastic
restore across ranks on the CPU: worlds of ``gloo`` ranks
(``tests/torch_ranks.py``), held against JAX and against the port on one
rank.

* ``pp_loss_fn`` on (2, 2) ('pod', 'data'), reduced gemma-7b, B 4, S 16,
  two microbatches (JAX's ``test_pipeline_parallel_parity``): the loss
  within 1e-4 of JAX's ``model.loss`` (JAX's own tolerance) and within
  1e-5 of the port's one-rank loss, every gradient within 1e-5 of
  ``jax.grad`` of JAX's ``model.loss`` and of the one-rank gradient;
  ``split_layers_for_stages`` refuses a stage count that does not divide
  the layers, as JAX's asserts.
* the train step on (2, 2), reduced olmoe-1b-7b and gemma-7b (the cell of
  JAX's ``test_real_execution_under_mesh``) from JAX's init, five steps:
  losses within 1e-5 relative of JAX's train step
  (``tests/test_torch_train.py``'s tolerance) and within 1e-5 of the
  port's one-rank step, and falling; the MoE dispatch and combine
  replicated, counted; int8 and top-k gradient compression on DTensor
  gradients held to JAX's and the one-rank step the same way;
  ``train_loop`` under four ranks gives the one-rank run's losses and,
  its last checkpoint removed, resumes from the one before with them.
* ``elastic_restore``: a one-rank checkpoint restored across four ranks,
  a save on (2, 2) at step 10 restored in a two-rank world onto (1, 2)
  (step 10, the leaves equal, each shard of JAX's spec on (1, 2)), and
  the four-rank checkpoint restored by one process.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp
from jax.sharding import AbstractMesh

from repro.configs import RunConfig as JRunConfig
from repro.configs import get_config as j_get_config
from repro.launch.train import make_train_step as j_make_train_step
from repro.models import Ctx as JCtx
from repro.models import build_model as j_build_model
from repro.optim import init_opt_state as j_init_opt_state
from repro.optim.compression import init_residuals as j_init_residuals
from repro.runtime import sharding as jshard
from repro.runtime.pipeline_parallel import \
    split_layers_for_stages as j_split
import torch_ranks
from repro_torch.checkpoint import Checkpointer
from repro_torch.configs import get_config
from repro_torch.interop import params_from_numpy
from repro_torch.launch.train import train_loop
from repro_torch.models import build_model
from repro_torch.runtime import split_layers_for_stages
from repro_torch.tree import flatten, leaves
from torch_tune_cache import port_tune_cache  # noqa: F401 (autouse)


J_CTX = JCtx(plan="jnp", dtype=jnp.float32)
LOSS_REL = 1e-5          # tests/test_torch_train.py's, port against JAX


class _JaxMesh(AbstractMesh):
    """An abstract mesh that also answers ``devices`` (all JAX's rules
    read of it is the shape)."""

    @property
    def devices(self):
        return np.empty(self.axis_sizes, dtype=object)


def test_pp_loss_and_gradients_match_jax_and_one_rank(tmp_path):
    cfg = j_get_config("gemma-7b", reduced=True)
    jm = j_build_model(cfg)
    jp = jm.init(jax.random.PRNGKey(0), dtype=jnp.float32)
    rng = np.random.default_rng(1)
    tokens = rng.integers(0, cfg.vocab_size, (4, 16)).astype(np.int32)
    targets = rng.integers(0, cfg.vocab_size, (4, 16)).astype(np.int32)
    jloss, jgrads = jax.value_and_grad(jm.loss)(
        jp, {"tokens": jnp.asarray(tokens), "targets": jnp.asarray(targets)},
        J_CTX)
    jloss = float(jloss)
    # JAX's gradients in the port's layout, leaf for leaf with pp_grads'
    jgrads = [g.numpy() for g in flatten(params_from_numpy(
        jax.tree.map(np.asarray, jgrads), cfg, device="cpu"))[0]]
    flat = torch_ranks._flat(jax.tree.map(np.asarray, jp))
    flat.update({"batch/tokens": tokens.astype(np.int64),
                 "batch/targets": targets.astype(np.int64)})
    npz = tmp_path / "pp.npz"
    np.savez(npz, **flat)
    loss1, grads1 = torch_ranks.pp_grads(0, None, str(npz))
    assert abs(loss1 - jloss) < 1e-5
    assert len(grads1) == len(jgrads)
    outs = torch_ranks.world(torch_ranks.pp_grads, 4, tmp_path, str(npz))
    for loss, grads in outs:
        assert abs(loss - jloss) < 1e-4        # JAX's own tolerance
        assert abs(loss - loss1) < 1e-5
        for g, want, jwant in zip(grads, grads1, jgrads):
            if g is not None:
                np.testing.assert_allclose(g, want, rtol=0, atol=1e-5)
                np.testing.assert_allclose(g, jwant, rtol=0, atol=1e-5)
    # every gradient is held by the ranks of its stage
    assert all(any(o[1][i] is not None for o in outs)
               for i in range(len(grads1)))
    # a stage's layers live on its ranks only
    assert all(any(g is None for g in o[1]) for o in outs)


def test_split_layers_refuses_an_indivisible_stage_count():
    layers = list(range(6))
    assert split_layers_for_stages(layers, 3) == [[0, 1], [2, 3], [4, 5]]
    with pytest.raises(ValueError, match="6 layers not divisible by 4"):
        split_layers_for_stages(layers, 4)
    with pytest.raises(AssertionError, match="6 layers not divisible by 4"):
        j_split({"w": jnp.zeros((6, 2))}, 4)


def _jax_init(arch, tmp_path):
    """JAX's model and fp32 init of the reduced ``arch``, and the init
    saved for the ranks."""
    jm = j_build_model(j_get_config(arch, reduced=True))
    jp = jm.init(jax.random.PRNGKey(0), dtype=jnp.float32)
    npz = tmp_path / f"{arch}.npz"
    np.savez(npz, **torch_ranks._flat(jax.tree.map(np.asarray, jp)))
    return jm, jp, str(npz)


def _jax_losses(jm, jp, compression="none"):
    """The losses of five steps of JAX's train step on
    ``torch_ranks.train_batch`` under ``torch_ranks.train_steps``' run
    config."""
    step = j_make_train_step(jm, J_CTX, JRunConfig(
        seq_len=16, global_batch=4, lr=1e-3, grad_compression=compression))
    # JAX's top-k decompression takes a concrete size: it runs eagerly
    step = step if compression == "topk" else jax.jit(step)
    batch = {k: jnp.asarray(v.numpy(), dtype=jnp.int32) for k, v in
             torch_ranks.train_batch(jm.cfg.vocab_size).items()}
    opt = j_init_opt_state(jp)
    res = j_init_residuals(jp) if compression != "none" else {}
    losses = []
    for _ in range(5):
        jp, opt, res, met = step(jp, opt, res, batch)
        losses.append(float(met["loss"]))
    return losses


@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "gemma-7b"])
def test_train_step_across_ranks_matches_one_rank(arch, tmp_path):
    jm, jp, npz = _jax_init(arch, tmp_path)
    jlosses = _jax_losses(jm, jp)
    one = torch_ranks.train_steps(0, None, npz, arch)
    outs = torch_ranks.world(torch_ranks.train_steps, 4, tmp_path, npz, arch)
    for o in outs:
        np.testing.assert_allclose(o["losses"], jlosses, rtol=LOSS_REL,
                                   atol=0)
        np.testing.assert_allclose(o["losses"], one["losses"], rtol=0,
                                   atol=1e-5)
        assert o["losses"][-1] < o["losses"][0]
    moe = {k: v for k, v in outs[0]["replicated"].items() if "moe." in k}
    assert bool(moe) == (arch == "olmoe-1b-7b"), outs[0]["replicated"]


def test_compressed_train_step_across_ranks_matches_one_rank(tmp_path):
    """int8 and top-k error feedback on DTensor gradients: the int8 scale
    reduced over the shards, the top-k picked from the whole tensor (it
    is global, as JAX's)."""
    schemes = ("int8", "topk")
    jm, jp, npz = _jax_init("gemma-7b", tmp_path)
    jlosses = {c: _jax_losses(jm, jp, c) for c in schemes}
    one = {c: torch_ranks.train_steps(0, None, npz, "gemma-7b", c)["losses"]
           for c in schemes}
    outs = torch_ranks.world(torch_ranks.train_steps_compressed, 4, tmp_path,
                             npz, schemes)
    for o in outs:
        for c in schemes:
            np.testing.assert_allclose(o[c], jlosses[c], rtol=LOSS_REL,
                                       atol=0)
            np.testing.assert_allclose(o[c], one[c], rtol=0, atol=1e-5)


def test_train_loop_across_ranks_resumes_from_its_checkpoint(tmp_path):
    one = train_loop("gemma-7b", torch_ranks.loop_run(tmp_path / "one", 9),
                     log_every=1000, device="cpu")["losses"]
    # checkpoints at steps 3, 6 and 8; without 8's the loop resumes at 7
    outs = torch_ranks.world(torch_ranks.train_loop_twice, 4, tmp_path,
                             str(tmp_path / "ranks"), 9)
    for first, resumed in outs:
        np.testing.assert_allclose(first, one, rtol=0, atol=1e-5)
        np.testing.assert_allclose(resumed, one[7:], rtol=0, atol=1e-5)


def test_elastic_restore_across_worlds(tmp_path):
    model = build_model(get_config("gemma-7b", reduced=True))
    params = model.init(seed=0, dtype=torch.float32, device="cpu")
    Checkpointer(str(tmp_path / "one"), keep=1).save(
        3, {"params": params}, blocking=True)
    big = torch_ranks.world(torch_ranks.elastic_save, 4, tmp_path,
                            str(tmp_path / "one"), str(tmp_path / "big"))
    assert all(o == {"step": 3, "equal": True} for o in big)
    small = torch_ranks.world(torch_ranks.elastic_restore_small, 2, tmp_path,
                              str(tmp_path / "big"))
    # each shard has the shape of JAX's spec on (1, 2)
    jp = jax.eval_shape(lambda: j_build_model(j_get_config(
        "gemma-7b", reduced=True)).init(jax.random.PRNGKey(0),
                                        dtype=jnp.float32))
    specs = jshard.param_shardings(_JaxMesh((1, 2), ("data", "model")), jp)
    sizes = {"data": 1, "model": 2}
    want = {}
    for (path, leaf), (_, sh) in zip(
            jax.tree_util.tree_flatten_with_path(jp)[0],
            jax.tree_util.tree_flatten_with_path(
                specs, is_leaf=lambda x: hasattr(x, "spec"))[0]):
        spec = tuple(sh.spec) + (None,) * (len(leaf.shape) - len(sh.spec))
        want["/".join(str(k.key) for k in path)] = tuple(
            d // (sizes[a] if a else 1) for d, a in zip(leaf.shape, spec))
    assert sorted(o["coord"] for o in small) == [(0, 0), (0, 1)]
    for o in small:
        assert o["step"] == 10 and o["equal"]
        assert o["local_shapes"] == want
    # and one process restores what four ranks saved
    state, step = Checkpointer(str(tmp_path / "big"), keep=1).restore(
        {"params": params}, device="cpu")
    assert step == 10
    assert all(torch.equal(a, b) for a, b in zip(leaves(state["params"]),
                                                 leaves(params)))
