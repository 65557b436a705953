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
names (a one-name tuple normalises to the name, as in JAX).
:class:`repro_torch.serve.ShardedEngine` computes them on its one-device
mesh and keeps them.

Placement (DTensor, over a ``torch.distributed.DeviceMesh`` whose
dimension names are the mesh's axis names): :func:`placements` turns a
spec into DTensor placements, :func:`shard_shape` gives the shard one
rank holds, :func:`place` builds DTensors from the shard each rank
takes of a global tensor (``meta`` shards for the dry run,
:mod:`repro_torch.launch.dryrun`; real ones across ranks) and
:func:`unplace` gathers them back, :func:`constrain` is JAX's
``with_sharding_constraint`` as a redistribution, and
:func:`gather_fsdp` gathers a weight's FSDP shard at its use.  On a
plain tensor :func:`constrain` and :func:`gather_fsdp` return their
input, so with no mesh nothing changes.  :class:`ReplicateOnGap` runs
an operation DTensor cannot plan again on replicated operands, counted
(the dry run and real runs across ranks share it).

The port keeps a model's layers as lists of per-layer dicts where JAX
stacks them along leading axes.  :func:`param_shardings` therefore
names each leaf by JAX's path (list positions left out), computes the
spec of the stacked leaf JAX holds, and gives the per-layer tensor that
spec without its leading stack dims, which the rules never shard (it
raises if one would be).
"""

from __future__ import annotations

import contextlib
import math
import re
from typing import Any

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_map as pytree_map

from repro_torch.quant.tensor import QTensor
from repro_torch.tree import tree_map

__all__ = ["P", "NamedSharding", "param_shardings", "batch_shardings",
           "cache_shardings", "batch_axes", "spec_for_param", "path_str",
           "replicated", "shard_shape", "placements", "place", "constrain",
           "gather_fsdp", "is_dtensor", "replicate_for_op", "from_replicated",
           "gather_inner", "gather_dims", "split_columns", "split_contraction",
           "like", "constrain_tree", "map_heads", "map_shards", "write_row",
           "write_slot", "write_layers", "microbatch", "label_logits",
           "unplace", "ReplicateOnGap", "reduce_partial", "across_ranks"]


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


# ----------------------------------------------------------------------
# placement (DTensor)
# ----------------------------------------------------------------------
def _entry_names(entry) -> tuple:
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


def shard_shape(sharding: NamedSharding, shape) -> tuple[int, ...]:
    """The shape of the shard rank 0 holds (``NamedSharding.shard_shape``):
    each dim divided by the product of its axes' sizes, rounded up (the
    first shard of an uneven dim, DTensor's ``chunk`` layout; the rules
    shard only dims that divide)."""
    sizes = _sizes(sharding.mesh)
    spec = tuple(sharding.spec) + (None,) * (len(shape) - len(sharding.spec))
    return tuple(-(-int(d) // math.prod(sizes[a] for a in _entry_names(e)))
                 for d, e in zip(shape, spec))


def placements(spec, mesh_dim_names) -> list:
    """DTensor placements of ``spec`` over a device mesh with dimension
    names ``mesh_dim_names``: ``Shard(i)`` on each mesh dim that tensor
    dim i names (a dim sharded over several axes takes them in mesh
    order, JAX's major-to-minor), ``Replicate()`` on the others."""
    from torch.distributed.tensor import Replicate, Shard
    out = []
    for name in mesh_dim_names:
        dims = [i for i, e in enumerate(spec) if name in _entry_names(e)]
        out.append(Shard(dims[0]) if dims else Replicate())
    return out


def is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def place(tree: Any, shardings: Any, device_mesh) -> Any:
    """DTensors over ``device_mesh`` for each leaf of ``tree`` (global
    tensors) by the :class:`NamedSharding` at the same place in
    ``shardings``, each built with ``DTensor.from_local`` from the shard
    this rank holds: a ``meta`` leaf gives a ``meta`` shard of
    :func:`shard_shape` (the dry run: shapes, no data); a real leaf is
    sliced at this rank's coordinate in the mesh (not its rank number,
    so a shard is the one JAX's device at that coordinate holds) and
    the slice copied, contiguous, to the mesh's device, so the global
    tensor can be freed.  A :class:`QTensor` leaf's codes and scales are
    placed by its two specs, the codes' shards K-major as QTensor keeps
    them (the int8 kernels read B so)."""
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor._utils import (
        compute_local_shape_and_global_offset)
    names = device_mesh.mesh_dim_names
    dev = (torch.device("cpu") if device_mesh.device_type == "cpu" else
           torch.device("cuda", torch.cuda.current_device()))

    def one(x, sh, k_major=False):
        pl = placements(sh.spec, names)
        if x.device.type == "meta":
            local = torch.empty(shard_shape(sh, x.shape), dtype=x.dtype,
                                device="meta")
            return DTensor.from_local(local, device_mesh, pl,
                                      run_check=False, shape=x.shape,
                                      stride=x.stride())
        shape, off = compute_local_shape_and_global_offset(x.shape,
                                                           device_mesh, pl)
        local = x[tuple(slice(o, o + n) for o, n in zip(off, shape))]
        if k_major:
            local = local.mT.to(dev, memory_format=torch.contiguous_format,
                                copy=True).mT
        else:
            local = local.to(dev, memory_format=torch.contiguous_format,
                             copy=True)
        return DTensor.from_local(local, device_mesh, pl, run_check=False,
                                  shape=x.shape,
                                  stride=torch.empty(x.shape,
                                                     device="meta").stride())

    def walk(x, sh):
        if isinstance(x, QTensor):
            return QTensor(one(x.data, sh.data, k_major=True),
                           one(x.scale, sh.scale), x.fmt, x.w8a8)
        if isinstance(x, dict):
            return {k: walk(v, sh[k]) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            kids = [walk(v, s) for v, s in zip(x, sh)]
            return (kids if isinstance(x, list) else
                    type(x)(*kids) if hasattr(x, "_fields") else tuple(kids))
        return one(x, sh)

    return walk(tree, shardings)


def unplace(tree: Any) -> Any:
    """:func:`place`'s inverse: every DTensor leaf of ``tree`` gathered
    into its global tensor (``full_tensor()``, a collective every rank
    of its mesh joins), other leaves as they are."""
    return tree_map(lambda x: x.full_tensor() if is_dtensor(x) else x, tree)


def constrain(x: torch.Tensor, spec) -> torch.Tensor:
    """JAX's ``with_sharding_constraint(x, NamedSharding(mesh, spec))``:
    a DTensor is redistributed to ``spec``'s placements over its own
    device mesh (axes the spec leaves out replicate, as in JAX); a plain
    tensor is returned as it is."""
    if type(x) is torch.Tensor or not is_dtensor(x):
        return x
    return x.redistribute(x.device_mesh,
                          placements(P(*spec), x.device_mesh.mesh_dim_names))


def gather_fsdp(w: torch.Tensor) -> torch.Tensor:
    """A weight at its use: a DTensor sharded over ``data`` (JAX's FSDP
    shard of a weight's ``d_model`` dim) is all-gathered over ``data``,
    its other placements kept, as ``torch.distributed.fsdp`` gathers a
    parameter before its use.  GSPMD makes the same choice from the
    activations' constraints; DTensor, left to itself, would gather the
    batch-sharded activation instead.  A plain tensor is returned as it
    is."""
    if type(w) is torch.Tensor or not is_dtensor(w):
        return w
    from torch.distributed.tensor import Replicate
    names = w.device_mesh.mesh_dim_names
    if "data" not in names:
        return w
    i = names.index("data")
    pl = list(w.placements)
    if pl[i].is_replicate():
        return w
    pl[i] = Replicate()
    return w.redistribute(w.device_mesh, pl)


def split_contraction(x: torch.Tensor, w: torch.Tensor):
    """The operands of a product ``x (..., K) @ w (..., K, N)`` whose
    weight is FSDP-sharded over ``data`` on its contraction dim K (an
    expert bank): where ``x`` is replicated over ``data`` (the MoE
    dispatch buffer), it is sliced along K to match (a local slice, no
    communication) and ``w`` stays sharded, so the product is a partial
    sum over ``data`` that the next constraint reduces, as GSPMD
    partitions it.  Gathering ``w`` instead would have every rank of
    ``data`` repeat the same products.  Any other DTensor weight is
    gathered (:func:`gather_fsdp`); plain tensors are returned as they
    are."""
    if type(w) is torch.Tensor or not is_dtensor(w):
        return x, w
    names = w.device_mesh.mesh_dim_names
    if "data" not in names or not is_dtensor(x):
        return x, gather_fsdp(w)
    from torch.distributed.tensor import Shard
    i = names.index("data")
    pw, px = w.placements[i], x.placements[i]
    if pw.is_shard() and pw.dim == w.ndim - 2 and px.is_replicate():
        pl = list(x.placements)
        pl[i] = Shard(x.ndim - 1)
        return x.redistribute(x.device_mesh, pl), w
    return x, gather_fsdp(w)


def split_columns(w: torch.Tensor, x: torch.Tensor,
                  dim: int) -> torch.Tensor:
    """The weight ``w`` of a product with the input ``x``, ``w``'s dim
    ``dim`` holding the product's output columns: where ``dim`` is
    sharded nowhere, it is split over each mesh axis on which both ``w``
    and ``x`` are replicated (a local slice, uneven where the axis does
    not divide the columns: the rules leave such a dim unsharded, as
    mamba2's 3352-wide projection over a 16-way 'model'), so each rank of
    the axis computes its own columns, as GSPMD partitions the product
    with padding, rather than all of them as every other rank.  A plain
    tensor is returned as it is."""
    if type(w) is torch.Tensor or not is_dtensor(w):
        return w
    from torch.distributed.tensor import Shard
    dim %= w.ndim
    if any(p.is_shard() and p.dim == dim for p in w.placements):
        return w
    pl = list(w.placements)
    for i, p in enumerate(pl):
        px = x.placements[i] if is_dtensor(x) else p
        if p.is_replicate() and px.is_replicate() \
                and w.shape[dim] >= w.device_mesh.size(i):
            pl[i] = Shard(dim)
            break       # one axis: no nested shards of one dim
    if pl == list(w.placements):
        return w
    return w.redistribute(w.device_mesh, pl)


def replicate_for_op(op: str, *xs: torch.Tensor) -> list[torch.Tensor]:
    """The local tensors of ``xs`` (DTensors) replicated over their whole
    device mesh, for an operation DTensor has no sharding strategy for
    (the MoE layer's sort-based dispatch and combine).  Each
    redistribution is counted in ``obs`` as
    ``dryrun.redistribute_for_op.<op>``, so a replication is never
    silent.  Run the operation on the results and wrap its output with
    :func:`from_replicated`."""
    from torch.distributed.tensor import Replicate
    from repro_torch import obs
    out = []
    for x in xs:
        n = x.device_mesh.ndim
        if any(not p.is_replicate() for p in x.placements):
            obs.counter_inc(f"dryrun.redistribute_for_op.{op}")
        out.append(x.redistribute(x.device_mesh, [Replicate()] * n)
                   .to_local())
    return out


def from_replicated(local: torch.Tensor, device_mesh) -> torch.Tensor:
    """A DTensor replicated over ``device_mesh`` from a local tensor every
    rank holds alike (:func:`replicate_for_op`'s counterpart)."""
    from torch.distributed.tensor import DTensor, Replicate
    return DTensor.from_local(local, device_mesh,
                              [Replicate()] * device_mesh.ndim,
                              run_check=False)


def gather_dims(x: torch.Tensor, dims) -> torch.Tensor:
    """``x`` with every shard of the tensor dims ``dims`` all-gathered (its
    other placements kept): where GSPMD reshards a dim it cannot slice or
    split along its shards, DTensor would carry an uneven or strided
    shard on.  A plain tensor is returned as it is."""
    if type(x) is torch.Tensor or not is_dtensor(x):
        return x
    from torch.distributed.tensor import Replicate
    dims = {d % x.ndim for d in dims}
    pl = [Replicate() if p.is_shard() and p.dim in dims else p
          for p in x.placements]
    if pl == list(x.placements):
        return x
    return x.redistribute(x.device_mesh, pl)


def reduce_partial(x: torch.Tensor) -> torch.Tensor:
    """``x`` with every pending partial sum all-reduced (its shards kept);
    a plain tensor is returned as it is."""
    if type(x) is torch.Tensor or not is_dtensor(x):
        return x
    from torch.distributed.tensor import Replicate
    pl = [Replicate() if p.is_partial() else p for p in x.placements]
    if pl == list(x.placements):
        return x
    return x.redistribute(x.device_mesh, pl)


def gather_inner(x: torch.Tensor) -> torch.Tensor:
    """``x`` (..., d), the input of a product, with every shard of its
    inner dims (neither the leading nor the last) all-gathered, so that
    ``reshape(-1, d)`` folds onto a shard of the leading (batch) dim: the
    all-gather of the sequence before a tensor-parallel product in
    Megatron's sequence parallelism, which GSPMD inserts at the same
    place.  A pending partial sum (a row-parallel product's output that
    no constraint reduced, as in one-token decode) is all-reduced first,
    as GSPMD reduces it at its use; DTensor would instead replicate the
    weight and run the product on every partial, repeating its work on
    each rank of the axis."""
    if type(x) is torch.Tensor or not is_dtensor(x):
        return x
    from torch.distributed.tensor import Replicate, Shard
    mesh = x.device_mesh
    pl = [Replicate() if p.is_partial() else p for p in x.placements]
    # the batch split over the DP axes it is replicated on (a local
    # slice), so no two ranks of those axes repeat one product
    dp = [i for i, a in enumerate(mesh.mesh_dim_names)
          if a in ("pod", "data") and pl[i].is_replicate()
          and mesh.size(i) > 1]
    if dp and x.shape[0] % math.prod(mesh.size(i) for i in dp) == 0:
        for i in dp:
            pl[i] = Shard(0)
    if pl != list(x.placements):
        x = x.redistribute(mesh, pl)
    if x.ndim <= 2:
        return x
    return gather_dims(x, range(1, x.ndim - 1))


def like(x: torch.Tensor, ref: torch.Tensor, *,
         reduced: int | None = None) -> torch.Tensor:
    """``x`` redistributed to the placements of the DTensor ``ref`` (a
    new decode state held in its cache's layout, as JAX's donated cache
    keeps its sharding), or with ``reduced``, ``x`` being ``ref`` reduced
    over its last dim ``reduced``, to ``ref``'s placements with that
    dim's shards replicated.  DTensor, left to itself, shards a
    replicated dim over any mesh axis a tensor leaves free, and carries
    that layout on; a plain tensor is returned as it is."""
    if type(x) is torch.Tensor or not is_dtensor(x):
        return x
    from torch.distributed.tensor import Replicate
    pl = list(ref.placements)
    if reduced is not None:
        reduced %= ref.ndim
        pl = [Replicate() if p.is_shard() and p.dim == reduced else p
              for p in pl]
    if list(x.placements) == pl:
        return x
    return x.redistribute(ref.device_mesh, pl)


def constrain_tree(tree: Any, shardings: Any) -> Any:
    """:func:`constrain` over each leaf of ``tree`` by the
    :class:`NamedSharding` at the same place in ``shardings``."""
    return tree_map(lambda x, sh: constrain(x, sh.spec), tree, shardings)


def map_shards(fn, xs, heads, out_heads):
    """``fn(*xs)`` run on each rank's shards of operands independent
    across their batch (dim 0) and their heads (dim ``heads[i]`` of
    ``xs[i]``, None for an operand without one; an operand may be None):
    the batch is sharded over each DP axis ('pod', 'data') that divides
    it, the heads over 'model' where every operand's head count divides,
    and every other shard is gathered; ``fn`` runs on the local tensors
    and each result is wrapped back with its batch at dim 0 and its heads
    at ``out_heads`` (an int for one result, a tuple for several).  This
    is what GSPMD makes of head-parallel attention and of the SSD scan:
    it slices a replicated batch rather than repeat the work on every
    rank of 'data'.  DTensor's own strategies never slice a replicated
    operand, and would propagate through each einsum's flattened batch
    dims, at a cost that grows past minutes on a three-axis mesh.  On
    plain tensors it is ``fn(*xs)``."""
    ref = next((x for x in xs if x is not None and is_dtensor(x)), None)
    if ref is None:
        return fn(*xs)
    from torch.distributed.tensor import DTensor, Replicate, Shard
    mesh = ref.device_mesh
    axes, nb = [], 1
    for i, name in enumerate(mesh.mesh_dim_names):
        n = mesh.size(i)
        if n == 1:
            axes.append(None)
        elif name in ("pod", "data") and ref.shape[0] % (nb * n) == 0:
            axes.append("batch")
            nb *= n
        elif name == "model" and all(
                x.shape[h] % n == 0 for x, h in zip(xs, heads)
                if x is not None and h is not None):
            axes.append("heads")
        else:
            axes.append(None)

    def pl(h):
        return [Shard(0) if ax == "batch"
                else Shard(h) if ax == "heads" and h is not None
                else Replicate() for ax in axes]

    def local(x, h):
        if x is None:
            return None
        if not is_dtensor(x):
            x = from_replicated(x, mesh)
        return x.redistribute(mesh, pl(h)).to_local()

    out = fn(*(local(x, h) for x, h in zip(xs, heads)))
    if isinstance(out_heads, int):
        return DTensor.from_local(out, mesh, pl(out_heads), run_check=False)
    return tuple(DTensor.from_local(o, mesh, pl(h), run_check=False)
                 for o, h in zip(out, out_heads))


def map_heads(fn, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              *rows) -> torch.Tensor:
    """``fn(q, k, v, *rows)`` of attention operands q (B, S, H, D) and
    k, v (B, T, KV, D), plus per-row operands ``rows`` ((B,) or None),
    run on each rank's batch and head shards (:func:`map_shards`); its
    result is (B, S, H, ...).  On plain tensors it is
    ``fn(q, k, v, *rows)``."""
    return map_shards(fn, (q, k, v, *rows), (2, 2, 2) + (None,) * len(rows),
                      2)


def write_row(c: torch.Tensor, new: torch.Tensor,
              pos: torch.Tensor) -> torch.Tensor:
    """``c[:, pos] = new[:, 0]`` in place for a DTensor cache ``c`` (B, S,
    ...) and a scalar position, or ``c[b, pos[b]] = new[b, 0]`` for (B,)
    positions: each rank writes into its own shard, a row only where its
    sequence range holds the row's position (DTensor's in-place index ops
    refuse a sharded cache or mislabel its placements).  Returns ``c``."""
    from torch.distributed.tensor import Replicate
    from torch.distributed.tensor._utils import (
        compute_local_shape_and_global_offset)
    mesh, pl = c.device_mesh, list(c.placements)
    new_pl = [p if p.is_shard() and p.dim != 1 else Replicate() for p in pl]
    if not is_dtensor(new):
        new = from_replicated(new, mesh)
    nl = new.redistribute(mesh, new_pl).to_local().to(c.dtype)
    shape, off = compute_local_shape_and_global_offset(c.shape, mesh, pl)
    cl = c.to_local()
    p = pos.full_tensor() if is_dtensor(pos) else pos
    if p.dim() == 0:
        lp = p - off[1]
        inside = (lp >= 0) & (lp < cl.shape[1])
        idx = lp.clamp(0, cl.shape[1] - 1).reshape(1)
        cl.index_copy_(1, idx, torch.where(inside, nl,
                                           cl.index_select(1, idx)))
        return c
    rows = torch.arange(shape[0], device=cl.device)
    lp = p[off[0]:off[0] + shape[0]].to(cl.device).long() - off[1]
    inside = (lp >= 0) & (lp < cl.shape[1])
    idx = lp.clamp(0, cl.shape[1] - 1)
    keep = inside.reshape(-1, *([1] * (cl.dim() - 2)))
    cl[rows, idx] = torch.where(keep, nl[:, 0], cl[rows, idx])
    return c


def write_slot(dst: torch.Tensor, src: torch.Tensor, axis: int,
               slot: int) -> None:
    """``dst.select(axis, slot).copy_(src.select(axis, 0))`` for a DTensor
    ``dst`` (a cache placed across ranks) and a batch-1 ``src`` (plain or
    DTensor): ``src`` is brought to ``dst``'s placements on every dim but
    ``axis``, and each rank writes the slot only if its shard of
    ``axis`` holds it (an in-place write into a DTensor view of a sharded
    dim would land in a copy)."""
    from torch.distributed.tensor import Replicate
    from torch.distributed.tensor._utils import (
        compute_local_shape_and_global_offset)
    mesh, pl = dst.device_mesh, list(dst.placements)
    src_pl = [p if p.is_shard() and p.dim != axis else Replicate()
              for p in pl]
    if not is_dtensor(src):
        src = from_replicated(src, mesh)
    sl = src.redistribute(mesh, src_pl).to_local()
    shape, off = compute_local_shape_and_global_offset(dst.shape, mesh, pl)
    local = slot - off[axis]
    if 0 <= local < shape[axis]:
        dst.to_local().select(axis, local).copy_(sl.select(axis, 0))


def write_layers(cache: dict, state: dict, idx: tuple) -> None:
    """After a layer's decode updated ``state`` in place (``{name:
    cache[name][idx]}``, ``idx`` the layer's indices over the leading
    stacked dims of each leaf), make each DTensor leaf of ``cache`` hold
    it: where a leaf's stacked dims are sharded (JAX's rules shard the
    mamba ``conv`` state's leading dims, whose name ends like a KV
    leaf's), ``cache[name][idx]`` is a gathered copy, not a view, and the
    in-place update never reached the cache.  Each rank writes the layer
    into its own shard where that holds ``idx``.  Plain leaves were
    updated through their views: nothing to do."""
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor._utils import (
        compute_local_shape_and_global_offset)
    n = len(idx)
    for name, src in state.items():
        dst = cache[name]
        if type(dst) is torch.Tensor or not is_dtensor(dst):
            continue
        mesh, pl = dst.device_mesh, list(dst.placements)
        if not any(p.is_shard() and p.dim < n for p in pl):
            continue        # the state was a view of the local shard
        src_pl = [Shard(p.dim - n) if p.is_shard() and p.dim >= n
                  else Replicate() for p in pl]
        if not is_dtensor(src):
            src = from_replicated(src, mesh)
        sl = src.redistribute(mesh, src_pl).to_local()
        shape, off = compute_local_shape_and_global_offset(dst.shape, mesh,
                                                           pl)
        local = tuple(i - o for i, o in zip(idx, off))
        if all(0 <= i < m for i, m in zip(local, shape)):
            dst.to_local()[local].copy_(sl)


def microbatch(x: torch.Tensor, n: int, i: int) -> torch.Tensor:
    """Slice ``i`` of ``n`` equal slices of ``x``'s leading dim, JAX's
    ``x.reshape(n, B // n, ...)[i]``.  A DTensor whose batch shards do
    not divide a slice's rows has its batch gathered first (GSPMD
    reshards such a dim; DTensor would plan an invalid local view)."""
    if type(x) is not torch.Tensor and is_dtensor(x):
        k = math.prod(x.device_mesh.size(j)
                      for j, p in enumerate(x.placements)
                      if p.is_shard() and p.dim == 0)
        if (x.shape[0] // n) % k:
            x = gather_dims(x, (0,))
    return x.reshape(n, x.shape[0] // n, *x.shape[1:])[i]


def label_logits(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """``logits[b, s, targets[b, s]]`` of a DTensor ``logits`` (B, S, V)
    whose vocabulary may be sharded, as Megatron's vocabulary-parallel
    cross entropy reads it: each rank builds the one-hot of its own
    vocabulary shard from its rows' labels and contracts it with its
    local logits, and the partial sums are all-reduced.  Nothing of (B,
    S, V) is gathered (a one-hot broadcast from the labels, left to
    DTensor, may come out whole on every rank)."""
    from torch.distributed.tensor import DTensor, Replicate
    from torch.distributed.tensor._utils import (
        compute_local_shape_and_global_offset)
    mesh, pl = logits.device_mesh, list(logits.placements)
    rows = [p if p.is_shard() and p.dim == 0 else Replicate() for p in pl]
    if not is_dtensor(targets):
        targets = from_replicated(targets, mesh)
    t = targets.redistribute(mesh, rows).to_local().to(torch.long)
    _, off = compute_local_shape_and_global_offset(logits.shape, mesh, pl)
    v_local = logits.to_local().shape[-1]
    vocab = torch.arange(off[2], off[2] + v_local, device=t.device)
    onehot = DTensor.from_local((t[..., None] == vocab).to(logits.dtype),
                                mesh, pl, run_check=False,
                                shape=logits.shape, stride=logits.stride())
    # the one-hot contraction of the plain path and the reference
    return like(torch.einsum("bsv,bsv->bs", logits, onehot), logits,
                reduced=-1)


# DTensor's words for an operation it cannot plan: its propagator's
# failure (a view it cannot split over uneven or nested shards, a
# transition it cannot run), an operator with no strategy, and a local
# view its chosen plan leaves unreadable
_GAPS = ("Sharding propagation failed", "does not have a sharding strategy",
         "is invalid for input of size")


def _runs_globally(func, args, kwargs) -> bool:
    """Whether ``func`` runs on plain meta tensors of its operands' global
    shapes and strides, outside every dispatch mode (nothing counted): a
    shape fault of the program fails there too; a fault of DTensor's plan
    does not."""
    from torch.utils._python_dispatch import _disable_current_modes

    def meta(x):
        # a DTensor's shape and stride are its global ones
        if isinstance(x, torch.Tensor):
            return torch.empty_strided(x.shape, x.stride(), dtype=x.dtype,
                                       device="meta")
        return x
    try:
        with _disable_current_modes():
            func(*pytree_map(meta, args), **pytree_map(meta, kwargs))
    except Exception:
        return False
    return True


class ReplicateOnGap(TorchDispatchMode):
    """Runs a DTensor operation again where DTensor cannot plan it: first
    on operands with every shard but the leading (batch) dim's
    replicated, then, if that fails too, on operands replicated over
    their whole mesh.  Each replicated operand counts as
    ``dryrun.redistribute_for_op.<op>`` (the dry run's name, kept for
    real runs across ranks, which share this mode).  Only an error in
    DTensor's words (``_GAPS``) for an operation that runs at its
    operands' global shapes is retried; any other error stands, as does
    one of an in-place operation (its result would land in a copy)."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor, Replicate
        from repro_torch import obs
        kwargs = kwargs or {}
        if not any(issubclass(t, DTensor) for t in types):
            return func(*args, **kwargs)
        try:
            return func(*args, **kwargs)
        except (RuntimeError, NotImplementedError) as e:
            mutates = any(a.alias_info is not None and a.alias_info.is_write
                          for a in func._schema.arguments)
            if mutates or not any(m in str(e) for m in _GAPS) \
                    or not _runs_globally(func, args, kwargs):
                raise
            err = e
        name = func.__name__
        for keep_batch in (True, False):
            def rep(x):
                if not isinstance(x, DTensor):
                    return x
                pl = [p if keep_batch and p.is_shard() and p.dim == 0
                      else Replicate() for p in x.placements]
                if pl == list(x.placements):
                    return x
                obs.counter_inc(f"dryrun.redistribute_for_op.{name}")
                return x.redistribute(x.device_mesh, pl)
            try:
                return func(*pytree_map(rep, args), **pytree_map(rep, kwargs))
            except (RuntimeError, NotImplementedError) as e:
                err = e
        raise err


@contextlib.contextmanager
def across_ranks(enable: bool = True):
    """The modes a step on DTensors across ranks runs under (a no-op with
    ``enable`` False): plain tensors the step makes (positions, masks)
    take part as replicated, as constants do under GSPMD, and
    :class:`ReplicateOnGap` replicates, counted, what DTensor cannot
    plan."""
    if not enable:
        yield
        return
    from torch.distributed.tensor.experimental import implicit_replication
    with implicit_replication(), ReplicateOnGap():
        yield
