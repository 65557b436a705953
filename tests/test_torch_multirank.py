"""The port across ranks on the CPU: worlds of four ``gloo`` ranks, one
process a rank, each with its own file store under ``tmp_path`` and its
own timeout (``tests/torch_ranks.py``), held against JAX, whose
counterparts run in a subprocess with four host devices as JAX's
``tests/test_distributed.py`` does.

* ``sharding.place``: reduced gemma-7b and zamba2-2.7b params (JAX's
  init) on (2, 2): each rank's local shards equal, bit for bit, the
  ``addressable_shards`` entry of the JAX device at the same mesh
  coordinate under JAX's ``param_shardings``; the caches of JAX's
  ``test_cache_shardings_dp_only_mesh`` place with some batch dim
  sharded.
* ``ShardedEngine`` on (1, 4) and (2, 2), reduced gemma-7b in fp32 on the
  plain path, the requests of JAX's ``test_sharded_engine_8_device_parity``:
  tokens equal to JAX's unsharded ``ServeEngine`` and the port's one-rank
  engine on every rank, params sharded for real, no decode graph;
  ``page_size`` across ranks refused, W8A8 and MoE engines serving.
* the kernels' entry points on DTensor operands (the plain versions on
  the CPU): column-, row- and batch-sharded products and attention
  through ``map_heads`` against the global product.
* the launcher under ``torch.distributed.run`` with ``--mesh 1x4``: the
  one-rank launcher's tokens; ``--mesh 2x4`` over four ranks raises.
* mesh rules: a mesh of eight over four ranks raises; without a process
  group every mesh is as before.
"""

import contextlib
import io
import os
import pkgutil
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.models import Ctx as JCtx
from repro.models import build_model as j_build_model
from repro.serve import Request as JRequest
from repro.serve import ServeEngine as JServeEngine
import repro_torch
import torch_ranks
from repro_torch.configs import get_config
from repro_torch.interop import params_from_numpy
from repro_torch.launch import mesh as port_mesh
from repro_torch.launch import serve as port_serve
from repro_torch.models import Ctx, build_model
from repro_torch.runtime import ranks
from repro_torch.serve import ServeEngine
from torch_tune_cache import port_tune_cache  # noqa: F401 (autouse)

ROOT = Path(__file__).resolve().parents[1]
SRC = str(ROOT / "src")
ARCHS = ("gemma-7b", "zamba2-2.7b")

_JAX_SHARDS = """
import sys
import jax, jax.numpy as jnp, numpy as np
from repro.configs import get_config
from repro.launch.mesh import make_mesh_compat
from repro.models import build_model
from repro.runtime import sharding as shr

assert jax.device_count() == 4
mesh = make_mesh_compat((2, 2), ("data", "model"))
for arch, path in zip(sys.argv[1::2], sys.argv[2::2]):
    params = build_model(get_config(arch, reduced=True)).init(
        jax.random.PRNGKey(0), dtype=jnp.float32)
    placed = jax.device_put(params, shr.param_shardings(mesh, params))
    out = {}
    for p, leaf in jax.tree_util.tree_flatten_with_path(placed)[0]:
        name = "/".join(str(k.key) for k in p)
        out["global|" + name] = np.asarray(leaf)
        for sh in leaf.addressable_shards:
            c = np.argwhere(mesh.devices == sh.device)[0]
            out[f"{c[0]},{c[1]}|" + name] = np.asarray(sh.data)
    np.savez(path, **out)
print("OK")
"""


def _jax_env() -> dict:
    return dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu",
                XLA_FLAGS="--xla_force_host_platform_device_count=4")


def _npz(flat: dict, path) -> str:
    np.savez(path, **flat)
    return str(path)


def test_place_takes_the_shard_of_jaxs_device_at_each_coordinate(tmp_path):
    args = []
    for arch in ARCHS:
        args += [arch, str(tmp_path / f"{arch}.jax.npz")]
    out = subprocess.run([sys.executable, "-c", _JAX_SHARDS, *args],
                         env=_jax_env(), capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    jax_shards = {arch: dict(np.load(tmp_path / f"{arch}.jax.npz"))
                  for arch in ARCHS}
    globals_ = {arch: _npz({k.split("|", 1)[1]: v for k, v in js.items()
                            if k.startswith("global|")},
                           tmp_path / f"{arch}.params.npz")
                for arch, js in jax_shards.items()}
    outs = torch_ranks.world(torch_ranks.place_params, 4, tmp_path,
                             list(globals_.items()))
    assert sorted(o["coord"] for o in outs) == [(0, 0), (0, 1), (1, 0),
                                                (1, 1)]
    for o in outs:
        c = "{},{}".format(*o["coord"])
        for arch in ARCHS:
            got = o["arch"][arch]
            assert got["global_equal"]
            want = {k.split("|", 1)[1]: v for k, v in
                    jax_shards[arch].items() if k.startswith(c + "|")}
            assert sorted(got["shards"]) == sorted(want), arch
            for name, shard in got["shards"].items():
                np.testing.assert_array_equal(shard, want[name],
                                              err_msg=f"{arch} {name} {c}")
            # the rules shard for real: some local shard is smaller
            assert any(shard.shape != jax_shards[arch]["global|" + name].shape
                       for name, shard in got["shards"].items())
        assert all(n > 0 for n in o["cache_sharded"].values()), \
            o["cache_sharded"]
        assert o["eight"] is not None and "needs 8 ranks" in o["eight"]


# ----------------------------------------------------------------------
# ShardedEngine across ranks
# ----------------------------------------------------------------------
@pytest.fixture(scope="module")
def gemma(tmp_path_factory):
    """JAX's reduced gemma-7b params (numpy, saved for the ranks), the
    tokens of JAX's unsharded ServeEngine and of the port's one-rank
    engine on them."""
    cfg = j_get_config("gemma-7b", reduced=True)
    jm = j_build_model(cfg)
    jp = jm.init(jax.random.PRNGKey(0), dtype=jnp.float32)
    reqs = torch_ranks.requests(cfg.vocab_size)
    jres = JServeEngine(jm, jp, JCtx(plan="jnp", dtype=jnp.float32),
                        **torch_ranks.ENGINE_KW).run(
        [JRequest(rid=r.rid, prompt=r.prompt,
                  max_new_tokens=r.max_new_tokens) for r in reqs])
    flat = torch_ranks._flat(jax.tree.map(np.asarray, jp))
    path = _npz(flat, tmp_path_factory.mktemp("gemma") / "params.npz")
    pcfg = get_config("gemma-7b", reduced=True)
    pm = build_model(pcfg)
    params = params_from_numpy(torch_ranks._unflat(dict(np.load(path))), pcfg,
                               device="cpu")
    one = ServeEngine(pm, params, Ctx(plan="torch", dtype=torch.float32),
                      device="cpu", **torch_ranks.ENGINE_KW).run(
        torch_ranks.requests(pcfg.vocab_size))
    return {"npz": path, "jax": {i: list(r.tokens) for i, r in jres.items()},
            "one": {i: r.tokens for i, r in one.items()}}


@pytest.mark.parametrize("shape", [(1, 4), (2, 2)])
def test_sharded_engine_matches_jax_and_one_rank(gemma, shape, tmp_path):
    assert gemma["one"] == gemma["jax"]
    outs = torch_ranks.world(torch_ranks.sharded_engine, 4, tmp_path,
                             shape, gemma["npz"], "torch")
    for o in outs:
        assert o["tokens"] == gemma["jax"]
        assert o["sharded"] > 0
        assert o["captures"] == []
        refused = {what: (kind, msg) for what, kind, msg in o["refused"]}
        assert set(refused) == {"page_size"}
        assert refused["page_size"][0] == "ValueError"
        # W8A8 and MoE now serve across ranks (their tokens against one
        # rank: test_torch_multirank_quant_moe.py)
        assert set(o["served"]) == {"w8a8", "moe"}
        assert all(len(t) == torch_ranks.MAX_NEW[0]
                   for t in o["served"].values())


def test_kernel_entry_points_on_local_shards(tmp_path):
    """The kernels' entry points on DTensors run each rank's shards (the
    plain versions here; the kernels themselves in
    ``test_torch_multirank_card.py``) and wrap them back with DTensor's
    own placements."""
    outs = torch_ranks.world(torch_ranks.ops_on_shards, 2, tmp_path, "cpu")
    for o in outs:
        tol = 1e-5 * o["scale"]     # fp32: the row split's partial sums
        assert o["column"][0] <= tol and o["column"][1] == ["R", "S(1)"]
        assert o["row"][0] <= tol and o["row"][1] == ["R", "P(sum)"]
        assert o["batch"][0] <= tol and o["batch"][1] == ["S(0)", "R"]
        assert o["attention"][0] <= 1e-6
        assert o["attention"][1] == ["R", "S(2)"]


# ----------------------------------------------------------------------
# the launcher under torch.distributed.run
# ----------------------------------------------------------------------
LAUNCH = ["--arch", "gemma-7b", "--batch", "4", "--prompt-len", "16",
          "--gen-len", "8", "--mixed", "--device", "cpu"]


def _torchrun(tmp_path, *args):
    env = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1",
               REPRO_TORCH_TUNE_CACHE=str(tmp_path / "tune.json"))
    return subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "4", "-m", "repro_torch.launch.serve", *args],
        env=env, capture_output=True, text=True, timeout=240)


def test_launcher_across_four_ranks_gives_the_one_rank_tokens(tmp_path):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        port_serve.main(LAUNCH + ["--mesh", "1x1"])
    one = [ln for ln in buf.getvalue().splitlines()
           if ln.startswith("generated digest:")]
    assert len(one) == 1
    out = _torchrun(tmp_path, *LAUNCH, "--mesh", "1x4")
    assert out.returncode == 0, out.stderr[-3000:]
    got = [ln for ln in out.stdout.splitlines()
           if ln.startswith("generated digest:")]
    assert got == one       # rank 0 alone prints
    bad = _torchrun(tmp_path, *LAUNCH, "--mesh", "2x4")
    assert bad.returncode != 0
    assert "mesh of shape (2, 4) needs 8 ranks; the world has 4" in bad.stderr


# ----------------------------------------------------------------------
# mesh rules without a process group
# ----------------------------------------------------------------------
def test_without_a_process_group_meshes_are_as_before():
    assert ranks.world() is None
    mesh = port_mesh.make_mesh_compat((1, 1), ("data", "model"),
                                      device="cpu")
    assert mesh.ranks is None and mesh.device is None
    assert list(mesh.devices.flat) == [torch.device("cpu")]
    with pytest.raises(ValueError, match="must be >= the product"):
        port_mesh.make_mesh_compat((1, 2), ("data", "model"), device="cpu")
    with pytest.raises(ValueError, match="spans no ranks"):
        ranks.device_mesh(mesh)
    meta = port_mesh.make_mesh_compat((2, 16, 16), ("pod", "data", "model"),
                                      device="meta")
    assert meta.size == 512 and meta.ranks is None
    # the import guard (test_torch_serve.py) walks the new modules too
    names = {m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                                   "repro_torch.")}
    assert {"repro_torch.runtime.pipeline_parallel",
            "repro_torch.runtime.ranks", "repro_torch.launch.mesh"} <= names
