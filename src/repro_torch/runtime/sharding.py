"""Logical-axis sharding rules -> partition specs (DP/FSDP/TP/EP/SP), the
port of ``repro.runtime.sharding``.

Mesh axes: ('pod', 'data', 'model') multi-pod or ('data', 'model')
single-pod (:mod:`repro_torch.launch.mesh`).  Parallelism mapping:

  batch               -> ('pod', 'data')     data parallel across pods
  d_model dim of W    -> 'data'              FSDP / ZeRO-3 weight shard
  heads*hd / d_ff / V -> 'model'             tensor parallel
  MoE expert dim      -> 'model'             expert parallel
  long-context S dim  -> 'data'              sequence parallel (caches)

Rules are path-pattern based over the parameter tree, with a
divisibility guard: an axis is applied only when the dim divides evenly
by the axis size (e.g. vocab 49155 or 40 KV heads on a 16-way axis fall
back to replication or another dim).

Pure shape logic: every function reads only ``mesh.axis_names`` and
``mesh.devices.shape`` and the leaves' shapes, so the specs at the
production meshes are computed (and held against the JAX package's) on
any host.  :class:`P` and :class:`NamedSharding` are the port's own
records of ``jax.sharding.PartitionSpec`` and ``NamedSharding``: one
entry a dimension, None (replicated), an axis name or a tuple of axis
names (a one-name tuple normalises to the name, as in JAX).  Placing a
tensor by them across devices waits for DTensor and the multi-device
slice; :class:`repro_torch.serve.ShardedEngine` computes them on its
one-device mesh and keeps them.

The port keeps a model's layers as lists of per-layer dicts where JAX
stacks them along leading axes.  :func:`param_shardings` therefore
names each leaf by JAX's path (list positions left out), computes the
spec of the stacked leaf JAX holds, and gives the per-layer tensor that
spec without its leading stack dims, which the rules never shard (it
raises if one would be).
"""

from __future__ import annotations

import re
from typing import Any

import torch

from repro_torch.quant.tensor import QTensor
from repro_torch.tree import tree_map

__all__ = ["P", "NamedSharding", "param_shardings", "batch_shardings",
           "cache_shardings", "batch_axes", "spec_for_param", "path_str",
           "replicated"]


class P(tuple):
    """A partition spec: one entry a dimension (None, an axis name or a
    tuple of axis names); ``P()`` replicates."""

    def __new__(cls, *entries):
        return super().__new__(cls, (e[0] if isinstance(e, tuple)
                                     and len(e) == 1 else e
                                     for e in entries))

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


class NamedSharding:
    """A spec over a mesh (the record ``jax.sharding.NamedSharding``
    is)."""

    def __init__(self, mesh, spec: P):
        self.mesh = mesh
        self.spec = P(*spec)

    def __eq__(self, other) -> bool:
        return (isinstance(other, NamedSharding) and other.mesh is self.mesh
                and other.spec == self.spec)

    def __repr__(self) -> str:
        return f"NamedSharding({self.spec!r})"


def batch_axes(mesh):
    """Mesh axes carrying data parallelism ('pod' included if present)."""
    names = mesh.axis_names
    return tuple(a for a in ("pod", "data") if a in names) or (None,)


def replicated(mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def path_str(path) -> str:
    """A leaf's path (dict keys, sequence positions) as 'a/b/0/c'."""
    return "/".join(str(k) for k in path)


# (pattern, spec-for-trailing-dims); first match wins.  Specs are given
# for the *parameter's own* dims; stacked layer/group leading dims are
# detected by rank surplus and padded with None on the left.
_PARAM_RULES: list[tuple[str, tuple]] = [
    (r"embed/tokens$",        ("model", "data")),   # (V, d)
    (r"embed/lm_head$",       ("data", "model")),   # (d, V)
    (r"router$",              ("data", None)),      # (d, E)
    (r"(wi|wg)$",             ("model", "data", None)),  # MoE (E, d, f): EP
    (r"wo$",                  ("model", "data", None)),  # MoE (E, f, d): EP
    (r"attn/w[qkv]/w$",       ("data", "model")),   # (d, H*hd) TP
    (r"attn/w[qkv]/b$",       ("model",)),
    (r"attn/wo/w$",           ("model", "data")),   # (H*hd, d)
    (r"attn/wo/b$",           (None,)),
    (r"mlp/(wi|wg)/w$",       ("data", "model")),   # (d, f) TP
    (r"mlp/wo/w$",            ("model", "data")),   # (f, d)
    (r"pre_proj/w$",          ("data", "model")),   # (2d, d) zamba shared
    (r"in_proj/w$",           ("data", "model")),   # mamba (d, ...)
    (r"out_proj/w$",          ("model", "data")),   # mamba (di, d)
    (r"conv_w$",              (None, "model")),     # (ck, conv_dim)
    (r"conv_b$",              ("model",)),
    (r"(A_log|D|dt_bias)$",   (None,)),             # tiny per-head vectors
    (r"(scale|norm/scale)$",  (None,)),
    (r".*/b$",                (None,)),
]


def _sizes(mesh) -> dict[str, int]:
    return dict(zip(mesh.axis_names, mesh.devices.shape))


def _apply_axes(mesh, shape, spec: tuple) -> P:
    """Pad spec to rank; drop axes that don't fit the dim."""
    rank = len(shape)
    spec = tuple(spec)
    if len(spec) < rank:  # stacked layer/group leading dims
        spec = (None,) * (rank - len(spec)) + spec
    elif len(spec) > rank:
        spec = spec[len(spec) - rank:]
    sizes = _sizes(mesh)
    out = []
    for dim, ax in zip(shape, spec):
        # a shard must divide its dim exactly (JAX refuses uneven dims)
        if ax is None or ax not in sizes or dim % sizes[ax] != 0:
            out.append(None)
        else:
            out.append(ax)
    return P(*out)


def spec_for_param(mesh, path: str, shape) -> P:
    for pattern, spec in _PARAM_RULES:
        if re.search(pattern, path):
            # MoE expert weights are 3D; the rank adaptation of
            # _apply_axes handles both them and the dense weights
            return _apply_axes(mesh, shape, spec)
    return P()  # replicate by default (small/unknown leaves)


def param_shardings(mesh, tree: Any) -> Any:
    """A :class:`NamedSharding` a leaf of the port's parameter tree (a
    QTensor's codes and scales apart, as JAX's ``QTensor`` pytree
    children ``0`` and ``1``), by JAX's path and stacked shape (module
    docstring)."""
    def walk(x, path: tuple, lead: tuple):
        if isinstance(x, dict):
            return {k: walk(v, path + (k,), lead) for k, v in x.items()}
        if isinstance(x, list):
            return [walk(v, path, lead + (len(x),)) for v in x]
        if isinstance(x, tuple):
            return tuple(walk(v, path + (i,), lead) for i, v in enumerate(x))
        if isinstance(x, QTensor):
            return QTensor(walk(x.data, path + (0,), lead),
                           walk(x.scale, path + (1,), lead), x.fmt, x.w8a8)
        spec = spec_for_param(mesh, path_str(path),
                              lead + tuple(x.shape))
        if len(spec) and any(a is not None for a in spec[:len(lead)]):
            raise ValueError(
                f"{path_str(path)}: spec {spec} shards a stacked layer "
                f"axis, which the port's per-layer tensors cannot hold")
        return NamedSharding(mesh, P(*spec[len(lead):]))

    return walk(tree, (), ())


def _fits(dim: int, mesh, axes) -> bool:
    size = 1
    for a in axes:
        if a is not None and a in mesh.axis_names:
            size *= mesh.devices.shape[mesh.axis_names.index(a)]
    return size > 1 and dim % size == 0


def batch_shardings(mesh, batch: Any) -> Any:
    """Shard the leading (batch) dim over ('pod', 'data') when it fits."""
    dp = batch_axes(mesh)

    def one(leaf):
        if leaf.ndim == 0:
            return replicated(mesh)
        if _fits(leaf.shape[0], mesh, dp):
            return NamedSharding(mesh, P(dp, *([None] * (leaf.ndim - 1))))
        return replicated(mesh)

    return tree_map(one, batch)


def cache_shardings(mesh, cache: Any, *, seq_axis_threshold: int = 65536
                    ) -> Any:
    """Decode-cache shardings.

    KV caches (..., B, S, KV, hd): batch over the DP axes when divisible;
    heads over 'model'; for long-context single-sequence decode (B
    unshardable, S >= threshold) the sequence dim shards over 'data'
    (sequence parallelism).
    """
    dp = batch_axes(mesh)
    # a DP-only (or pod/stage) mesh has no 'model' axis: every
    # TP-shardable dim replicates (model_size 0 never divides: the
    # `has_model and` guards short-circuit first)
    has_model = "model" in mesh.axis_names
    model_size = (mesh.devices.shape[mesh.axis_names.index("model")]
                  if has_model else 0)

    def one(name: str, leaf: torch.Tensor) -> NamedSharding:
        if leaf.ndim == 0 or name.endswith("pos"):
            return replicated(mesh)
        if name.endswith(("k", "v", "cross_k", "cross_v",
                          "k_scale", "v_scale")):
            # (L?, B, S, KV, hd|1): the int8-KV scale leaves shard like KV
            spec = [None] * leaf.ndim
            b_ax, s_ax, kv_ax = leaf.ndim - 4, leaf.ndim - 3, leaf.ndim - 2
            if _fits(leaf.shape[b_ax], mesh, dp):
                spec[b_ax] = dp
            elif leaf.shape[s_ax] >= seq_axis_threshold \
                    and "data" in mesh.axis_names:
                spec[s_ax] = "data"   # SP for long-context caches
            if has_model and leaf.shape[kv_ax] % model_size == 0:
                spec[kv_ax] = "model"
            elif has_model and leaf.shape[s_ax] % model_size == 0 \
                    and spec[s_ax] is None:
                # GQA with fewer KV heads than the TP width: shard the
                # cache sequence over 'model' instead (flash-decode style
                # partial softmax)
                spec[s_ax] = "model"
            return NamedSharding(mesh, P(*spec))
        if name.endswith("conv"):     # (L?, B, ck-1, conv_dim)
            spec = [None] * leaf.ndim
            if _fits(leaf.shape[-3], mesh, dp):
                spec[-3] = dp
            spec[-1] = ("model" if has_model
                        and leaf.shape[-1] % model_size == 0 else None)
            return NamedSharding(mesh, P(*spec))
        if name.endswith("ssm"):      # (L?, B, H, N, P)
            spec = [None] * leaf.ndim
            if _fits(leaf.shape[-4], mesh, dp):
                spec[-4] = dp
            if has_model and leaf.shape[-3] % model_size == 0:
                spec[-3] = "model"
            return NamedSharding(mesh, P(*spec))
        return replicated(mesh)

    def walk(x, path: tuple):
        if isinstance(x, dict):
            return {k: walk(v, path + (k,)) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return type(x)(walk(v, path + (i,)) for i, v in enumerate(x))
        return one(path_str(path), x)

    return walk(cache, ())
