"""The port's sharding rules (``repro_torch.runtime.sharding``) against the
JAX package's (``repro.runtime.sharding``), spec for spec.

Pure shape logic, so it is held at the production meshes although the
card has one device: (16, 16) and (2, 16, 16), and (1, 8) and (8, 1).
JAX's functions read only ``mesh.axis_names`` and ``mesh.devices.shape``
and wrap specs in ``NamedSharding``; the JAX side gets an
``AbstractMesh`` that also answers ``devices`` (an empty array of the
mesh's shape), the port side its own :class:`Mesh` over placeholder
devices.  For every leaf of every registered config at full size
(shapes from JAX ``eval_shape`` and from the port's init on the meta
device), the port's spec of the per-layer tensor, behind the stacked
layer axes JAX holds, equals JAX's; ``spec_for_param`` equals JAX's at
JAX's own paths and shapes.  ``cache_shardings`` (every family's
reduced cache, the int8 KV cache's scale leaves, the long-context
sequence rule) and ``batch_shardings`` give JAX's specs.  Exactly equal
everywhere.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh

from repro.configs import get_config as j_get_config
from repro.configs import list_configs
from repro.models import build_model as j_build_model
from repro.runtime import sharding as jshard
from repro_torch.configs import get_config
from repro_torch.launch.mesh import Mesh, make_mesh_compat
from repro_torch.models import build_model
from repro_torch.quant.tensor import QTensor
from repro_torch.runtime import sharding
from torch_tune_cache import port_tune_cache  # noqa: F401 (autouse)

MESHES = {(16, 16): ("data", "model"), (2, 16, 16): ("pod", "data", "model"),
          (1, 8): ("data", "model"), (8, 1): ("data", "model")}


class _JaxMesh(AbstractMesh):
    """An abstract mesh that also answers ``devices`` (all JAX's rules
    read of it is the shape)."""

    @property
    def devices(self):
        return np.empty(self.axis_sizes, dtype=object)


def _meshes(shape):
    axes = MESHES[shape]
    port = Mesh(np.full(shape, torch.device("meta"), dtype=object), axes)
    return _JaxMesh(shape, axes), port


def _port_leaves(tree, path=(), lead=()):
    """(JAX's path, stacked layer dims, leaf) of the port's tree: list
    positions leave the path and become leading dims, a QTensor's codes
    and scales are children 0 and 1, as in the rules."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _port_leaves(tree[k], path + (k,), lead)
    elif isinstance(tree, list):
        for v in tree:
            yield from _port_leaves(v, path, lead + (len(tree),))
    elif isinstance(tree, QTensor):
        yield from _port_leaves(tree.data, path + (0,), lead)
        yield from _port_leaves(tree.scale, path + (1,), lead)
    else:
        yield sharding.path_str(path), lead, tree


@functools.lru_cache(maxsize=None)
def _full_trees(arch):
    """(JAX's leaves {path: shape}, the port's meta params) at full size."""
    jm = j_build_model(j_get_config(arch))
    shapes = jax.eval_shape(
        lambda: jm.init(jax.random.PRNGKey(0), dtype=jnp.bfloat16))
    flat, _ = jax.tree_util.tree_flatten_with_path(shapes)
    jleaves = {jshard.path_str(p): tuple(x.shape) for p, x in flat}
    params = build_model(get_config(arch)).init(
        seed=0, dtype=torch.bfloat16, device="meta")
    return jleaves, params


@pytest.mark.parametrize("shape", list(MESHES), ids=lambda s: "x".join(
    map(str, s)))
@pytest.mark.parametrize("arch", list_configs())
def test_param_specs_equal_jax_at_full_size(arch, shape):
    jmesh, mesh = _meshes(shape)
    jleaves, params = _full_trees(arch)
    specs = sharding.param_shardings(mesh, params)
    seen, leads = {}, {}
    for (path, lead, leaf), (spath, slead, spec) in zip(
            _port_leaves(params), _port_leaves(specs)):
        assert (path, lead) == (spath, slead)
        assert isinstance(spec, sharding.NamedSharding) and spec.mesh is mesh
        assert lead + tuple(leaf.shape) == jleaves[path], path
        seen.setdefault(path, set()).add(spec.spec)
        leads[path] = len(lead)
    assert set(seen) == set(jleaves)
    for path, jshape in jleaves.items():
        want = tuple(jshard.spec_for_param(jmesh, path, jshape))
        assert tuple(sharding.spec_for_param(mesh, path, jshape)) == want
        # every per-layer tensor of a stacked leaf holds the same spec:
        # JAX's without the stacked layer dims
        n_lead = leads[path]
        assert seen[path] == {sharding.P(*want[n_lead:])}, path
        assert all(a is None for a in want[:n_lead])


def test_param_specs_shard_where_they_fit():
    """The rules do shard at the production mesh (the equality above is
    not one of all-replicated trees), and replicate what does not divide
    (seamless's vocab 256206 on a 16-way 'model' axis)."""
    _, mesh = _meshes((16, 16))
    specs = sharding.param_shardings(mesh, _full_trees("gemma-7b")[1])
    assert specs["layers"][0]["attn"]["wq"]["w"].spec == ("data", "model")
    assert specs["layers"][5]["mlp"]["wo"]["w"].spec == ("model", "data")
    assert specs["embed"]["tokens"].spec == ("model", "data")
    assert specs["final_norm"]["scale"].spec == (None,)
    seamless = sharding.param_shardings(
        mesh, _full_trees("seamless-m4t-large-v2")[1])
    assert seamless["embed"]["tokens"].spec == (None, "data")


def test_quantized_leaves_follow_jax_paths():
    """A QTensor is JAX's pytree of children 0 (codes) and 1 (scales): its
    paths end in /0 and /1, which no rule names, so both replicate, as
    in JAX."""
    jmesh, mesh = _meshes((1, 8))
    m = build_model(get_config("gemma-7b", reduced=True))
    q = m.quantize_weights(m.init(seed=0, device="cpu"))
    specs = sharding.param_shardings(mesh, q)
    wq = specs["layers"][0]["attn"]["wq"]["w"]
    assert isinstance(wq, QTensor)
    assert wq.data.spec == wq.scale.spec == sharding.P()
    for path, lead, leaf in _port_leaves(q):
        if path.endswith(("/0", "/1")):
            assert tuple(jshard.spec_for_param(
                jmesh, path, lead + tuple(leaf.shape))) == ()


def _j_cache(arch, B, kw):
    jm = j_build_model(j_get_config(arch, reduced=True))
    return jax.eval_shape(lambda: jm.init_cache(B, 32, jnp.float32, **kw))


@pytest.mark.parametrize("threshold", [65536, 32])
@pytest.mark.parametrize("shape", list(MESHES), ids=lambda s: "x".join(
    map(str, s)))
@pytest.mark.parametrize("B", [16, 3])
def test_cache_specs_equal_jax(B, shape, threshold):
    """Every family's reduced cache at a batch that the DP axes divide and
    one they do not; ``threshold`` 32 (the cache's length) takes the
    sequence-parallel branch.  qwen's int8 KV cache adds the scale
    leaves."""
    jmesh, mesh = _meshes(shape)
    cases = [(a, {"enc_len": 12} if "seamless" in a else {})
             for a in list_configs()] + [("qwen1.5-32b",
                                          {"quantize_kv": True})]
    for arch, kw in cases:
        jcache = _j_cache(arch, B, kw)
        cache = build_model(get_config(arch, reduced=True)).init_cache(
            B, 32, torch.float32, device="meta", **kw)
        want = jshard.cache_shardings(jmesh, jcache,
                                      seq_axis_threshold=threshold)
        got = sharding.cache_shardings(mesh, cache,
                                       seq_axis_threshold=threshold)
        assert set(got) == set(want), arch
        for name in want:
            assert tuple(got[name].spec) == tuple(want[name].spec), \
                (arch, name)


@pytest.mark.parametrize("shape", list(MESHES), ids=lambda s: "x".join(
    map(str, s)))
def test_batch_specs_equal_jax(shape):
    jmesh, mesh = _meshes(shape)
    for B in (32, 16, 3):
        batch = {"tokens": torch.empty((B, 8), device="meta"),
                 "lengths": torch.empty((B,), device="meta"),
                 "step": torch.empty((), device="meta")}
        jbatch = {k: jax.ShapeDtypeStruct(tuple(v.shape), jnp.int32)
                  for k, v in batch.items()}
        want = jshard.batch_shardings(jmesh, jbatch)
        got = sharding.batch_shardings(mesh, batch)
        for k in batch:
            assert tuple(got[k].spec) == tuple(want[k].spec), (B, k)
    assert tuple(sharding.replicated(mesh).spec) == tuple(
        jshard.replicated(jmesh).spec) == ()
    assert sharding.batch_axes(mesh) == jshard.batch_axes(jmesh)


def test_partition_spec_normalises_like_jax():
    from jax.sharding import PartitionSpec as JP
    for entries in [(("data",), None), (("pod", "data"), "model"), (),
                    (None, None), ("model",)]:
        assert tuple(sharding.P(*entries)) == tuple(JP(*entries))


def test_mesh_helpers_match_jax_on_one_device():
    """``make_mesh_compat`` and ``make_host_mesh`` on the CPU's one device,
    and the production meshes' refusal there, as JAX's on its one CPU
    device."""
    from repro.launch import mesh as jmesh_mod
    from repro_torch.launch import mesh as mesh_mod
    mesh = make_mesh_compat((1, 1), ("data", "model"), device="cpu")
    jm = jmesh_mod.make_mesh_compat((1, 1), ("data", "model"))
    assert mesh.axis_names == jm.axis_names
    assert mesh.devices.shape == jm.devices.shape
    assert dict(mesh.shape) == dict(jm.shape)
    host = mesh_mod.make_host_mesh(device="cpu")
    assert host.devices.shape == jmesh_mod.make_host_mesh().devices.shape
    for multi_pod in (False, True):
        with pytest.raises(ValueError) as got:
            mesh_mod.make_production_mesh(multi_pod=multi_pod, device="cpu")
        with pytest.raises(ValueError) as want:
            jmesh_mod.make_production_mesh(multi_pod=multi_pod)
        assert str(got.value) == str(want.value)
