"""``Ctx.mesh`` in the port's models (``repro_torch.models.layers``)
against the JAX package's.

``_merged_head_plan`` reads only the mesh's shape, so it is held equal to
JAX's for every registered config at the single-pod (16, 16), multi-pod
(2, 16, 16), (2, 4) and (1, 3) meshes.  The merged-head attention it
selects pads the query heads and repeats the KV heads; on plain CPU
tensors the port runs it under a (2, 4) mesh record and is held within
2e-5 (fp32) of JAX's ``jnp`` path under a real (2, 4) mesh of 8 host
devices (a subprocess), causal, bidirectional and ragged.  The pad
changes which KV head a query head reads (JAX takes the repeat factor
from the padded count), so that form is not the grouped form's function
but that of the padded model's grouped form; the test holds both.  On plain
tensors the constraints return their input, and ``Ctx.with_plan`` keeps
the mesh.  The sharding helpers map JAX's partition specs to DTensor
placements and shard shapes.
"""

import dataclasses
import json
import os
import subprocess
import sys
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.configs import list_configs
from repro.models import layers as jL
from repro_torch.configs import get_config
from repro_torch.launch.mesh import Mesh
from repro_torch.models import Ctx
from repro_torch.models import layers as L
from repro_torch.runtime import sharding
from torch_tune_cache import port_tune_cache  # noqa: F401 (autouse)

ROOT = Path(__file__).resolve().parents[1]
MESHES = {(16, 16): ("data", "model"), (2, 16, 16): ("pod", "data", "model"),
          (2, 4): ("data", "model"), (1, 3): ("data", "model")}


def _mesh(shape) -> Mesh:
    return Mesh(np.full(shape, torch.device("meta"), dtype=object),
                MESHES[shape])


def _jax_ctx(shape):
    """What JAX's ``_merged_head_plan`` reads of its ctx: the mesh's axis
    names and device array shape."""
    mesh = types.SimpleNamespace(axis_names=MESHES[shape],
                                 devices=np.empty(shape, dtype=object))
    return types.SimpleNamespace(mesh=mesh)


@pytest.mark.parametrize("shape", list(MESHES), ids=str)
@pytest.mark.parametrize("arch", list_configs())
def test_merged_head_plan_matches_jax(arch, shape):
    jc, pc = j_get_config(arch), get_config(arch)
    assert (pc.n_heads, pc.n_kv_heads) == (jc.n_heads, jc.n_kv_heads)
    want = jL._merged_head_plan(jc.n_heads, jc.n_kv_heads, _jax_ctx(shape))
    got = L._merged_head_plan(pc.n_heads, pc.n_kv_heads,
                              Ctx(plan="torch", mesh=_mesh(shape)))
    assert got == want


def test_merged_head_plan_of_the_production_meshes():
    """The reference's cases: deepseek and llava pad 56 heads to 64 on
    the single pod, qwen (40 -> 80) keeps the grouped form, multi-pod
    meshes always do."""
    single, multi = _mesh((16, 16)), _mesh((2, 16, 16))
    for arch, want in (("deepseek-coder-33b", 8), ("llava-next-34b", 8),
                       ("qwen1.5-32b", None), ("gemma-7b", None)):
        cfg = get_config(arch)
        assert L._merged_head_plan(cfg.n_heads, cfg.n_kv_heads,
                                   Ctx(mesh=single)) == want
        assert L._merged_head_plan(cfg.n_heads, cfg.n_kv_heads,
                                   Ctx(mesh=multi)) is None


def test_constraints_return_plain_tensors_unchanged():
    ctx = Ctx(plan="torch", mesh=_mesh((2, 4)))
    x = torch.randn(2, 8, 16)
    t = torch.randn(2, 8, 4, 4)
    assert L.shard_seq(x, ctx) is x
    assert L.shard_act(x, ctx) is x
    assert L._head_shard(t, ctx) is t
    assert L._seq_shard4(t, ctx) is t
    w = torch.randn(16, 8)
    assert sharding.gather_fsdp(w) is w
    assert sharding.gather_inner(x) is x
    assert sharding.constrain(x, sharding.P("data", "model", None)) is x
    assert Ctx(plan="torch", mesh=ctx.mesh).with_plan("auto").mesh \
        is ctx.mesh
    assert Ctx().mesh is None


def test_placements_and_shard_shape_follow_jax_specs():
    from torch.distributed.tensor import Replicate, Shard
    mesh = _mesh((2, 16, 16))
    P = sharding.P
    names = mesh.axis_names
    assert sharding.placements(P(("pod", "data"), "model", None), names) \
        == [Shard(0), Shard(0), Shard(1)]
    assert sharding.placements(P(None, "data"), names) \
        == [Replicate(), Shard(1), Replicate()]
    assert sharding.placements(P(), names) == [Replicate()] * 3
    sh = sharding.NamedSharding(mesh, P(("pod", "data"), "model", None))
    assert sharding.shard_shape(sh, (256, 4096, 3072)) == (8, 256, 3072)
    assert sharding.shard_shape(sharding.NamedSharding(mesh, P()),
                                (5, 7)) == (5, 7)


_JAX_ATTENTION = """
import json, sys
import jax, jax.numpy as jnp, numpy as np
from repro.configs import get_config
from repro.launch.mesh import make_mesh_compat
from repro.models import Ctx
from repro.models import layers as L
import dataclasses
args = json.loads(sys.argv[1])
cfg = dataclasses.replace(get_config("deepseek-coder-33b", reduced=True),
                          **args["cfg"])
data = np.load(args["data"])
p = {k: {"w": jnp.asarray(data[k])} for k in ("wq", "wk", "wv", "wo")}
mesh = make_mesh_compat((2, 4), ("data", "model"))
ctx = Ctx(plan="jnp", dtype=jnp.float32, mesh=mesh)
assert L._merged_head_plan(cfg.n_heads, cfg.n_kv_heads, ctx) == 2
x = jnp.asarray(data["x"])
B, S, _ = x.shape
pos = jnp.broadcast_to(jnp.arange(S)[None], (B, S))
out = {}
with mesh:
    for name, causal, lengths in (("causal", True, None),
                                  ("bidirectional", False, None),
                                  ("ragged", True, data["lengths"])):
        ln = None if lengths is None else jnp.asarray(lengths)
        f = jax.jit(lambda x, p, ln: L.attention(
            p, x, cfg, ctx, positions=pos, causal=causal, lengths=ln))
        out[name] = np.asarray(f(x, p, ln))
np.savez(args["out"], **out)
print("done")
"""


def test_merged_head_attention_matches_jax_under_a_mesh(tmp_path):
    """14 heads over 2 KV heads on a 4-way 'model' axis: pad 2 (16
    heads), the merged-head path in both packages."""
    fields = {"n_heads": 14, "n_kv_heads": 2, "head_dim": 8}
    cfg = dataclasses.replace(get_config("deepseek-coder-33b", reduced=True),
                              **fields)
    rng = np.random.default_rng(0)
    d, hd = cfg.d_model, cfg.head_dim
    data = {"wq": rng.standard_normal((d, 14 * hd), np.float32) * 0.2,
            "wk": rng.standard_normal((d, 2 * hd), np.float32) * 0.2,
            "wv": rng.standard_normal((d, 2 * hd), np.float32) * 0.2,
            "wo": rng.standard_normal((14 * hd, d), np.float32) * 0.2,
            "x": rng.standard_normal((2, 8, d), np.float32),
            "lengths": np.array([8, 5], np.int32)}
    np.savez(tmp_path / "data.npz", **data)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8")
    args = {"cfg": fields, "data": str(tmp_path / "data.npz"),
            "out": str(tmp_path / "jax.npz")}
    run = subprocess.run([sys.executable, "-c", _JAX_ATTENTION,
                          json.dumps(args)], env=env, capture_output=True,
                         text=True, timeout=300)
    assert run.returncode == 0, run.stderr[-3000:]
    want = np.load(tmp_path / "jax.npz")

    ctx = Ctx(plan="torch", dtype=torch.float32, mesh=_mesh((2, 4)))
    assert L._merged_head_plan(cfg.n_heads, cfg.n_kv_heads, ctx) == 2
    p = {k: {"w": torch.from_numpy(data[k])} for k in ("wq", "wk", "wv",
                                                       "wo")}
    x = torch.from_numpy(data["x"])
    pos = torch.arange(8)[None].expand(2, 8)
    for name, causal, lengths in (("causal", True, None),
                                  ("bidirectional", False, None),
                                  ("ragged", True, data["lengths"])):
        ln = None if lengths is None else torch.from_numpy(lengths)
        got = L.attention(p, x, cfg, ctx, positions=pos, causal=causal,
                          lengths=ln).numpy()
        assert got.shape == want[name].shape
        np.testing.assert_allclose(got, want[name], atol=2e-5, rtol=0,
                                   err_msg=name)
    # The reference's pad moves query heads to other KV heads: the repeat
    # factor comes from the padded count (16 // 2 = 8, head h reads KV
    # head h // 8) where the grouped form reads h // 7.  So the merged
    # form is not the grouped form's function; the port keeps JAX's.
    grouped = L.attention(p, x, cfg, Ctx(plan="torch", dtype=torch.float32),
                          positions=pos).numpy()
    assert np.abs(grouped - want["causal"]).max() > 1e-2
    k8 = dataclasses.replace(cfg, n_heads=16)
    p8 = dict(p, wq={"w": torch.cat([p["wq"]["w"], torch.zeros(d, 2 * hd)],
                                    1)},
              wo={"w": torch.cat([p["wo"]["w"], torch.zeros(2 * hd, d)])})
    padded = L.attention(p8, x, k8, Ctx(plan="torch", dtype=torch.float32),
                         positions=pos).numpy()
    np.testing.assert_allclose(padded, want["causal"], atol=2e-5, rtol=0)
