"""Cost extraction from an eager program's trace (the port's counterpart
of ``repro.core.hlo_costs``).

JAX's dry run reads FLOPs, bytes and collective bytes out of the
compiled HLO text.  The port has no HLO: it runs the program eagerly
(on ``meta`` tensors, sharded or not) under :class:`CostCounter`, a
``TorchDispatchMode`` that sees every aten op one rank executes, and
accumulates

  * dot FLOPs        2*M*N*K of ``mm``, ``addmm``, ``bmm``, ``baddbmm``
                     (what ``einsum``, ``matmul`` and ``linear`` lower
                     to) and the two products of each fused attention op;
                     a product whose contraction is 1 (an outer product)
                     counts none, as XLA rewrites such a dot into a
                     multiply before ``hlo_costs`` reads it
  * op bytes         result + operand sizes of every materializing op,
                     views and the like skipped (JAX's ``_SKIP_BYTES_OPS``
                     read as aten ops)
  * collective bytes the functional collectives DTensor issues, weighted
                     as JAX weights them: an all-reduce moves 2x its
                     input (ring RS + AG), an all-gather its gathered
                     output, reduce-scatter, all-to-all and permute
                     their input
  * memory           the counterpart of ``memory_analysis()``: argument,
                     output and donated ("alias") bytes, and the peak of
                     the bytes the program allocated and still held
                     ("temp"), outputs left out.

Only the local ops of one rank count.  Under DTensor a dispatch mode
sees each operator twice more than it runs: the DTensor-level call at
global shapes, and the sharding propagator's run on fake tensors at
global shapes.  Both are passed through uncounted, so what counts is
what rank 0 executes on its shards, and a module total is that times
the chip count, JAX's convention (per-device HLO x chips).

JAX's ``n_while`` and ``max_trip`` are dropped: an eager program unrolls
its loops, so every iteration is traced and there is no trip count to
correct.  Where a loop's iterations all cost the same and tracing each
would take long (the chunked attention's 32 x 32 block steps a layer of
a 32k prefill), the program traces one and counts it with
:func:`counted_times`, as ``hlo_costs`` counts a scan body once times
its trip count.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import math
import weakref
from collections import defaultdict

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

__all__ = ["TraceCosts", "CostCounter", "trace_costs", "tensor_bytes",
           "local_tensor", "argument_bytes", "counted_times"]

aten = torch.ops.aten

# (op, result + operand traffic weight is 1; collective traffic weight)
_COLLECTIVE_W = {
    "all-reduce": 2.0, "all-gather": 1.0, "reduce-scatter": 1.0,
    "all-to-all": 1.0, "collective-permute": 1.0,
}
# functional collectives (``torch.ops._c10d_functional``) by JAX's names
_COLLECTIVE_OPS = {
    "all_reduce": "all-reduce",
    "all_reduce_": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "all_reduce_coalesced_": "all-reduce",
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_out": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
}
# ops whose result or operands are no HBM traffic: views, aliases and
# allocations (JAX's parameter / bitcast / reshape / broadcast / iota)
_SKIP_BYTES_OPS = frozenset({
    "view", "_unsafe_view", "expand", "t", "transpose", "permute",
    "as_strided", "alias", "detach", "slice", "select", "unsqueeze",
    "squeeze", "split", "split_with_sizes", "chunk", "unbind", "narrow",
    "empty", "empty_like", "empty_strided", "new_empty",
    "new_empty_strided", "lift_fresh", "arange", "scalar_tensor",
    "wait_tensor", "_wrap_tensor_autograd",
})
# ops that hand their input back under a new wrapper
_REWRAPS = frozenset({"wait_tensor", "_wrap_tensor_autograd"})
_PRODUCTS = {
    aten.mm.default: (0, 1), aten.bmm.default: (0, 1),
    aten.addmm.default: (1, 2), aten.baddbmm.default: (1, 2),
}
_ATTENTION = frozenset({
    "_scaled_dot_product_flash_attention",
    "_scaled_dot_product_flash_attention_for_cpu",
    "_scaled_dot_product_efficient_attention",
    "_scaled_dot_product_cudnn_attention",
})
_DTYPE_NAMES = {
    torch.bool: "pred", torch.int8: "s8", torch.uint8: "u8",
    torch.int16: "s16", torch.float16: "f16", torch.bfloat16: "bf16",
    torch.int32: "s32", torch.float32: "f32", torch.int64: "s64",
    torch.float64: "f64",
}


# how many times each op traced now counts (counted_times), innermost last
_TIMES = [1]


@contextlib.contextmanager
def counted_times(n: int):
    """Inside, every op a :class:`CostCounter` counts (FLOPs, bytes,
    collectives) counts ``n`` times, nested contexts multiplying: one
    traced iteration of a loop whose ``n`` iterations cost alike.  The
    memory it allocates counts once, as a loop's buffers are reused."""
    _TIMES.append(_TIMES[-1] * int(n))
    try:
        yield
    finally:
        _TIMES.pop()


@dataclasses.dataclass
class TraceCosts:
    """One rank's costs of a traced program (``HloCosts`` without the
    loop fields) and its memory by kind (bytes)."""
    flops: float
    bytes: float
    collective_bytes: float
    collective_by_kind: dict[str, float]
    collective_count: dict[str, int]
    dot_flops_by_shape: dict[str, float] = dataclasses.field(
        default_factory=dict)
    memory: dict[str, int] = dataclasses.field(default_factory=dict)


def local_tensor(t: torch.Tensor) -> torch.Tensor:
    """The tensor one rank holds: a DTensor's local shard, else ``t``."""
    return getattr(t, "_local_tensor", t)


def tensor_bytes(t: torch.Tensor) -> int:
    """Bytes of the tensor one rank holds."""
    t = local_tensor(t)
    return t.numel() * t.element_size()


def _storage_key(t: torch.Tensor) -> int:
    return local_tensor(t).untyped_storage()._cdata


def _tensors(tree) -> list[torch.Tensor]:
    return [x for x in tree_flatten(tree)[0] if isinstance(x, torch.Tensor)]


@functools.cache
def _classes():
    from torch._subclasses.fake_tensor import FakeTensor
    from torch.distributed.tensor import DTensor
    return DTensor, FakeTensor


def _shape_name(t: torch.Tensor) -> str:
    dims = ",".join(str(d) for d in t.shape)
    return f"{_DTYPE_NAMES.get(t.dtype, str(t.dtype))}[{dims}]"


class CostCounter(TorchDispatchMode):
    """Counts FLOPs, bytes, collectives and live memory of the local ops
    run inside it (module docstring).  ``costs()`` returns them."""

    def __init__(self):
        super().__init__()
        self.flops = 0.0
        self.bytes = 0.0
        self.coll_bytes: dict[str, float] = defaultdict(float)
        self.coll_count: dict[str, int] = defaultdict(int)
        self.dot_by_shape: dict[str, float] = defaultdict(float)
        # allocation log for the memory peak: (+/- bytes, token)
        self._log: list[tuple[int, int]] = []
        self._tokens: dict[int, int] = {}       # id(tensor) -> token
        self._next = 0

    # -- memory ---------------------------------------------------------
    def _alloc(self, t: torch.Tensor) -> None:
        n = t.numel() * t.element_size()
        if n == 0:
            return
        tok = self._next
        self._next += 1
        self._log.append((n, tok))
        self._tokens[id(t)] = tok
        log, tokens, key = self._log, self._tokens, id(t)

        def free():
            log.append((-n, tok))
            if tokens.get(key) == tok:
                del tokens[key]
        weakref.finalize(t, free)

    def peak_bytes(self, exclude=()) -> int:
        """The peak of live allocated bytes over the trace, the tensors
        in ``exclude`` (outputs) left out."""
        skip = {self._tokens[id(local_tensor(t))] for t in exclude
                if id(local_tensor(t)) in self._tokens}
        live = peak = 0
        for n, tok in self._log:
            if tok in skip:
                continue
            live += n
            peak = max(peak, live)
        return peak

    # -- dispatch -------------------------------------------------------
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        dtensor, fake = _classes()
        if any(issubclass(t, dtensor) for t in types):
            # a DTensor-level call: DTensor runs it on the local shards,
            # which come back through this mode
            return NotImplemented
        out = func(*args, **kwargs)
        outs = _tensors(out)
        if any(issubclass(t, fake) for t in types) or \
                any(isinstance(t, fake) for t in outs):
            return out          # the sharding propagator's shape run
        name = func.__name__.split(".")[0]
        ns = func.namespace
        ins = _tensors((args, kwargs))
        times = _TIMES[-1]
        if ns == "_c10d_functional" and name in _COLLECTIVE_OPS:
            kind = _COLLECTIVE_OPS[name]
            ib = sum(tensor_bytes(t) for t in ins)
            ob = sum(tensor_bytes(t) for t in outs)
            moved = ob if kind == "all-gather" else ib
            self.coll_bytes[kind] += _COLLECTIVE_W[kind] * moved * times
            self.coll_count[kind] += times
            self.bytes += (ib + ob) * times
        elif func in _PRODUCTS or name in _ATTENTION:
            fl = self._product_flops(func, name, args) * times
            self.flops += fl
            self.dot_by_shape[_shape_name(outs[0])] += fl
            self.bytes += sum(tensor_bytes(t) for t in ins + outs) * times
        elif name not in _SKIP_BYTES_OPS:
            self.bytes += sum(tensor_bytes(t) for t in ins + outs) * times
        if not func.is_view and not _aliases(func) \
                and name not in _REWRAPS:
            # an output that is storage of an input (a wrapper returned
            # as it came, a collective's wait) is no allocation
            held = {_storage_key(t) for t in ins}
            for t in outs:
                if _storage_key(t) not in held:
                    self._alloc(t)
        return out

    @staticmethod
    def _product_flops(func, name: str, args) -> float:
        if name in _ATTENTION:
            q, k, v = args[0], args[1], args[2]     # (B, H, S|T, D)
            lead = math.prod(q.shape[:-2])
            S, T = q.shape[-2], k.shape[-2]
            return 2.0 * lead * S * T * (q.shape[-1] + v.shape[-1])
        i, j = _PRODUCTS[func]
        a, b = args[i], args[j]
        batch = a.shape[0] if a.dim() == 3 else 1
        M, K = a.shape[-2], a.shape[-1]
        if K == 1:
            return 0.0      # an outer product: XLA makes it a multiply
        return 2.0 * batch * M * K * b.shape[-1]

    def costs(self, memory: dict | None = None) -> TraceCosts:
        return TraceCosts(
            flops=self.flops, bytes=self.bytes,
            collective_bytes=sum(self.coll_bytes.values()),
            collective_by_kind=dict(self.coll_bytes),
            collective_count=dict(self.coll_count),
            dot_flops_by_shape=dict(self.dot_by_shape),
            memory=dict(memory or {}))


def _aliases(func) -> bool:
    """The op returns (part of) an input: in place, out= or a view."""
    return any(r.alias_info is not None for r in func._schema.returns)


def argument_bytes(args) -> int:
    """Bytes one rank holds of the tensors in ``args`` (each storage
    once)."""
    return sum(tensor_bytes(t) for t in
               {_storage_key(t): t for t in _tensors(args)}.values())


def trace_costs(fn, *args, donate: tuple[int, ...] = (), inner=None):
    """Run ``fn(*args)`` under a :class:`CostCounter` (and inside it the
    dispatch mode ``inner``, if given) and return ``(output,
    TraceCosts)``, with ``memory``:

    * ``argument``: bytes of the tensors of ``args`` one rank holds;
    * ``output``: bytes of the tensors of the output;
    * ``alias``: output bytes that are storage of the arguments at
      positions ``donate`` (JAX's donated buffers, updated in place);
    * ``temp``: the peak of bytes the program allocated and held, its
      outputs left out.
    """
    donated = {_storage_key(t) for i in donate for t in _tensors(args[i])}
    with CostCounter() as cc, (inner or contextlib.nullcontext()):
        out = fn(*args)
    out_tensors = _tensors(out)
    seen: set[int] = set()
    out_bytes = alias = 0
    for t in out_tensors:
        key = _storage_key(t)
        if key in seen:
            continue
        seen.add(key)
        out_bytes += tensor_bytes(t)
        if key in donated:
            alias += tensor_bytes(t)
    memory = {"argument": argument_bytes(args), "output": out_bytes,
              "alias": alias, "temp": cc.peak_bytes(exclude=out_tensors)}
    return out, cc.costs(memory)
