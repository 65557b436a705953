"""Trees of tensors: nested dicts, lists and tuples with tensor leaves.

The port's stand-in for ``jax.tree`` over the trees it trains:
parameters (dicts of per-layer lists), optimizer state
(:class:`~repro_torch.optim.OptState`, a NamedTuple: mu, nu, step) and
train states.  The order of the leaves is JAX's: a dict by sorted key, a
list or tuple in order.  A ``treedef`` is a plain nested tuple, so two
trees have the same structure when their treedefs are equal.
"""

from __future__ import annotations

from typing import Any, Callable

__all__ = ["flatten", "unflatten", "leaves", "tree_map", "stacked_groups"]


# The walks are module-level functions, not recursive closures: a closure
# that calls itself is a reference cycle, which would keep every leaf it
# saw (a step's gradients) alive until the garbage collector runs, and
# the collector is off while a CUDA graph is captured.
def _flatten(x: Any, out: list) -> Any:
    if isinstance(x, dict):
        keys = tuple(sorted(x))
        return (dict, keys), tuple(_flatten(x[k], out) for k in keys)
    if isinstance(x, (list, tuple)):
        return (type(x), len(x)), tuple(_flatten(v, out) for v in x)
    out.append(x)
    return None


def flatten(tree: Any) -> tuple[list, Any]:
    """(leaves, treedef): every leaf of ``tree`` in order, and its
    structure (None for a leaf)."""
    out: list = []
    return out, _flatten(tree, out)


def _build(d: Any, it) -> Any:
    if d is None:
        return next(it)
    (kind, meta), subs = d
    kids = [_build(s, it) for s in subs]
    if kind is dict:
        return dict(zip(meta, kids))
    if kind is list:
        return kids
    if kind is tuple:
        return tuple(kids)
    return kind(*kids)          # a NamedTuple


def unflatten(treedef: Any, leaves: list) -> Any:
    """The tree of structure ``treedef`` holding ``leaves`` in order."""
    it = iter(leaves)
    out = _build(treedef, it)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree has")
    return out


def leaves(tree: Any) -> list:
    return flatten(tree)[0]


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """``fn`` over the leaves of ``tree`` and of each tree in ``rest``,
    which must have ``tree``'s structure."""
    ls, treedef = flatten(tree)
    others = []
    for t in rest:
        lt, dt = flatten(t)
        if dt != treedef:
            raise ValueError("tree structures differ")
        others.append(lt)
    return unflatten(treedef, [fn(*xs) for xs in zip(ls, *others)])


def stacked_groups(tree: Any) -> list[list[int]]:
    """The leaves of ``tree`` that JAX holds as one stacked array: indices
    into ``flatten(tree)[0]`` grouped by the leaf's path with the
    positions in lists left out (a list is a stack of layers), each group
    in list order, which is the stacked array's leading-axis order."""
    groups: dict[tuple, list[int]] = {}
    count = 0

    def walk(x, path):
        nonlocal count
        if isinstance(x, dict):
            for k in sorted(x):
                walk(x[k], path + (k,))
        elif isinstance(x, list):
            for v in x:
                walk(v, path)
        elif isinstance(x, tuple):
            for i, v in enumerate(x):
                walk(v, path + (i,))
        else:
            groups.setdefault(path, []).append(count)
            count += 1

    walk(tree, ())
    return list(groups.values())
