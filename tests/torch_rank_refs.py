"""The references a multi-rank serving test holds its world against:
JAX's unsharded ``ServeEngine`` and the port's one-rank engine on JAX's
params (imported by the test modules, never by the ranks, which import
no JAX)."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import get_config as j_get_config
from repro.models import Ctx as JCtx
from repro.models import build_model as j_build_model
from repro.plan import KernelConfig as JKernelConfig
from repro.serve import Request as JRequest
from repro.serve import ServeEngine as JServeEngine
import torch_ranks
from repro_torch.configs import get_config
from repro_torch.interop import params_from_numpy
from repro_torch.models import Ctx, build_model
from repro_torch.plan import KernelConfig
from repro_torch.serve import ServeEngine

SHAPES = [(1, 4), (2, 2)]


def serve_references(arch: str, quant: bool, tmp_path) -> dict:
    """JAX's reduced ``arch`` params (PRNGKey 0, fp32) saved for the
    ranks, and the tokens of JAX's unsharded ``ServeEngine`` and of the
    port's one-rank engine on them (W8A8 with ``quant``) for
    ``torch_ranks.family_requests``."""
    jm = j_build_model(j_get_config(arch, reduced=True))
    jp = jm.init(jax.random.PRNGKey(0), dtype=jnp.float32)
    npz = tmp_path / "params.npz"
    np.savez(npz, **torch_ranks._flat(jax.tree.map(np.asarray, jp)))
    cfg = get_config(arch, reduced=True)
    m = build_model(cfg)
    tp = params_from_numpy(torch_ranks._unflat(dict(np.load(npz))), cfg,
                           device="cpu")
    if quant:
        jp, tp = jm.quantize_weights(jp), m.quantize_weights(tp)
    jctx = JCtx(plan=JKernelConfig(backend="jnp", quant="int8") if quant
                else "jnp", dtype=jnp.float32)
    ctx = Ctx(plan=KernelConfig(quant="int8") if quant else "auto",
              dtype=torch.float32)
    kw = torch_ranks.family_engine_kw(cfg)
    reqs = torch_ranks.family_requests(cfg)
    jres = JServeEngine(jm, jp, jctx, **kw).run([
        JRequest(rid=r.rid, prompt=r.prompt, max_new_tokens=r.max_new_tokens,
                 frontend_embeds=r.frontend_embeds) for r in reqs])
    one = ServeEngine(m, tp, ctx, device="cpu", **kw).run(reqs)
    return {"npz": str(npz),
            "jax": {i: [int(t) for t in r.tokens] for i, r in jres.items()},
            "one": {i: r.tokens for i, r in one.items()}}


def check_world(outs, ref, *, replicated=(), required=()) -> None:
    """Every rank of the world, on each mesh of ``SHAPES``: the one-rank
    engine's tokens (which are JAX's), some param and cache leaf sharded,
    no capture; of the operations replicated for want of a DTensor plan
    (``ReplicateOnGap`` and the MoE layer's own, counted in ``obs``) none
    outside ``replicated``, and each of ``required`` on every mesh."""
    assert ref["one"] == ref["jax"]
    assert all(len(t) == n for t, n in zip(
        (ref["one"][i] for i in range(4)), torch_ranks.MAX_NEW))
    assert len(outs) == 4
    for o in outs:
        assert sorted(o) == SHAPES
        for shape in SHAPES:
            got = o[shape]
            assert got["tokens"] == ref["one"], shape
            assert got["sharded"] > 0 and got["cache_sharded"] > 0
            assert got["captures"] == []
            assert set(got["replicated"]) <= {
                f"dryrun.redistribute_for_op.{r}" for r in replicated}, \
                got["replicated"]
            for r in required:
                assert got["replicated"][f"dryrun.redistribute_for_op.{r}"]
