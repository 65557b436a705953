"""Program lint: prove a program stays on the kernel path.

The port of ``repro.analyze.program_lint``.  The JAX package walks the
jaxpr of a traced program; the port runs the program under a
:class:`torch.utils._python_dispatch.TorchDispatchMode` that sees every
ATen operator it issues, on meta tensors on the CPU (shapes only, as
JAX's abstract eval) or on CUDA tensors on the card.  Each operator is
attributed to the innermost frame outside PyTorch and the analyzer (the
``repro_torch`` line that issued it; the JAX package's user frame) as
``file:line in function``, so the allowlist keeps the JAX package's
semantics: path substrings and ``"in <function>"``.
On the meta device an ``ops`` entry point on the kernel backend issues
no product at all (it returns an empty result of the kernel's shape,
as a ``pallas_call`` is opaque to the jaxpr walk), so only the products
a kernel does not run are seen.  It flags:

* ``ZS-P001`` — an ``aten.mm`` / ``bmm`` / ``addmm`` / ``baddbmm`` /
  ``matmul`` of at least ``min_flops`` outside the allowlist (a silent
  fallback product);
* ``ZS-P002`` — a host sync inside the program: ``.item()``
  (``aten._local_scalar_dense``) or a device-to-host copy;
* ``ZS-P003`` — on the quantized path, a product fed by an int8 ->
  float conversion through elementwise and layout glue (W8A8 defeated
  by an upcast; the taint follows the ops JAX's does).

Known-intentional sites are allowlisted by source location
(:data:`DEFAULT_ALLOW`); every lint records how often each entry
sanctioned a product (``report.meta["allow_hits"]``), and
:func:`check_allowlist` turns entries that matched nothing across a
full-family sweep into ``ZS-P004`` warnings.
"""

from __future__ import annotations

import functools
import math
import os
import sys
from typing import Callable

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.analyze.diagnostics import Diagnostic, Report

__all__ = ["lint_program", "check_allowlist", "merge_allow_hits",
           "DEFAULT_ALLOW"]

#: Source-location substrings whose products are sanctioned.
#: ``repro_torch/kernels/`` is the dispatch layer itself (its plain
#: versions are the deliberate ``"torch"`` backend); the model-side
#: entries are the paper-intentional non-GEMM contractions.
DEFAULT_ALLOW = (
    "repro_torch/kernels/",        # ops.* dispatch + its plain versions
    "repro_torch/models/ssm.py",   # SSD chunked recurrence (bandwidth-bound)
    "in attention_decode",         # O(1) per-token attention vs the cache
    "in _gqa_full",                # backend-dispatched attention: routes
                                   # to ops.attention on "auto"; its
                                   # einsums ARE the plain backend
    "repro_torch/models/moe.py",   # router logits (tokens x n_experts)
    "in cross_entropy",            # loss: one-hot contraction, not a GEMM
)

_MATMULS = ("mm", "bmm", "addmm", "baddbmm", "matmul")
# the elementwise and layout glue a dequantize runs through (JAX's mul,
# add, sub, broadcast_in_dim, transpose, reshape, convert_element_type,
# squeeze, slice)
_GLUE = ("mul", "add", "sub", "expand", "broadcast_to", "permute",
         "transpose", "t", "view", "_unsafe_view", "reshape", "_to_copy",
         "squeeze", "unsqueeze", "slice", "clone")
_INT_DTYPES = (torch.int8, torch.uint8)

# frames that are not the program's: PyTorch's own and the analyzer's
_SKIP = (os.path.dirname(os.path.realpath(torch.__file__)) + os.sep,
         os.path.dirname(os.path.realpath(__file__)) + os.sep)


@functools.lru_cache(maxsize=None)
def _skipped(filename: str) -> bool:
    return os.path.realpath(filename).startswith(_SKIP)


def _source() -> str:
    """``file:line in function`` of the innermost frame outside PyTorch
    and the analyzer: the ``repro_torch`` line that issued the operator
    (or a caller's own, as the JAX package's user frame)."""
    frame = sys._getframe(1)
    while frame is not None:
        name = frame.f_code.co_filename
        if not _skipped(name):
            return f"{name}:{frame.f_lineno} in {frame.f_code.co_name}"
        frame = frame.f_back
    return "<unknown>"


def _mm_flops(name: str, args) -> float:
    """FLOPs of one product from its operand shapes."""
    try:
        a, b = (args[1], args[2]) if name in ("addmm", "baddbmm") \
            else (args[0], args[1])
        if name == "matmul":
            a_s, b_s = tuple(a.shape), tuple(b.shape)
            batch = math.prod(torch.broadcast_shapes(a_s[:-2], b_s[:-2]))
            return 2.0 * batch * a_s[-2] * a_s[-1] * b_s[-1]
        return 2.0 * math.prod(a.shape) * b.shape[-1]
    except Exception:
        return float("inf")     # un-analyzable: never silently below cut


def _tensors(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)


class _Lint(TorchDispatchMode):
    """Observe every ATen call of the program and lint it."""

    def __init__(self, *, allow, min_flops, quant, hits):
        super().__init__()
        self.allow, self.min_flops, self.quant = allow, min_flops, quant
        self.hits = hits
        self.diags: list[Diagnostic] = []
        # values dequantized from int8 storage, and what glue made of
        # them, by id (the tensors are kept, so no id is reused)
        self.tainted: dict[int, torch.Tensor] = {}

    def _is_tainted(self, args) -> bool:
        return any(id(t) in self.tainted for t in _tensors(args))

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        name = func.overloadpacket.__name__
        if name == "_local_scalar_dense" or self._d2h(name, args, kwargs):
            self.diags.append(Diagnostic(
                rule="ZS-P002", severity="error", where=_source(),
                message=f"host sync point inside the program: "
                        f"aten.{name}",
                hint="keep host interaction out of the block — the fused "
                     "K-step dispatch must sync only at its boundary"))
            if name == "_local_scalar_dense" and args[0].is_meta:
                return 0        # a meta tensor has no value to read
        if name in _MATMULS:
            self._product(name, args)
        out = func(*args, **kwargs)
        if name == "_to_copy" and args[0].dtype in _INT_DTYPES and \
                isinstance(out, torch.Tensor) and out.is_floating_point():
            self.tainted[id(out)] = out
        elif name in _GLUE and self._is_tainted((args, kwargs)):
            for t in _tensors(out):
                self.tainted[id(t)] = t
        return out

    @staticmethod
    def _d2h(name, args, kwargs) -> bool:
        """A copy from a CUDA tensor into host memory."""
        if name == "_to_copy":
            dev = kwargs.get("device")
            return (args[0].device.type == "cuda" and dev is not None
                    and torch.device(dev).type == "cpu")
        if name == "copy_":
            return args[0].device.type == "cpu" and \
                args[1].device.type == "cuda"
        return False

    def _product(self, name, args) -> None:
        src = _source()
        matched = [a for a in self.allow if a in src]
        for a in matched:
            self.hits[a] += 1
        flops = _mm_flops(name, args)
        if not matched and flops >= self.min_flops:
            self.diags.append(Diagnostic(
                rule="ZS-P001", severity="error", where=src,
                message=f"matmul ({flops:.0f} flops) issued outside the "
                        f"zero-stall kernels (aten.{name})",
                hint="route it through repro_torch.kernels.ops (matmul / "
                     "grouped_matmul / attention), or allowlist the site "
                     "in repro_torch.analyze.program_lint"))
        if self.quant and flops >= self.min_flops and \
                self._is_tainted(args):
            self.diags.append(Diagnostic(
                rule="ZS-P003", severity="warning", where=src,
                message="int8 weights are dequantized into a "
                        "full-precision matmul on the quantized path",
                hint="route through ops.quantized_matmul (W8A8, int32 "
                     "accumulate) instead of dequantizing ahead of the "
                     "kernel"))


def lint_program(target: Callable, *args,
                 allow: tuple[str, ...] = DEFAULT_ALLOW,
                 min_flops: float = 0.0, quant: bool = False,
                 **kwargs) -> Report:
    """Lint a program for fallback matmuls, host syncs, fp32 upcasts.

    ``target`` is called with ``*args``/``**kwargs`` under the lint's
    dispatch mode: meta tensors trace shapes only (no FLOPs run), CUDA
    tensors run the program on the card.  ``allow`` is the sanctioned-
    site list (substring match against ``file:line in function``);
    ``min_flops`` ignores glue contractions below the cut; ``quant``
    additionally arms the dequant-upcast rule (``ZS-P003``).  The
    report's ``meta["result"]`` holds what ``target`` returned.
    """
    hits = {a: 0 for a in allow}
    mode = _Lint(allow=tuple(allow), min_flops=float(min_flops),
                 quant=quant, hits=hits)
    with mode:
        result = target(*args, **kwargs)
    report = Report(mode.diags)
    report.meta["allow_hits"] = hits
    report.meta["result"] = result
    return report


def merge_allow_hits(*hit_maps: dict) -> dict:
    """Sum per-entry allowlist hit counts across several lints."""
    out: dict[str, int] = {}
    for hm in hit_maps:
        for entry, n in (hm or {}).items():
            out[entry] = out.get(entry, 0) + int(n)
    return out


def check_allowlist(hits: dict, *, allow: tuple[str, ...] = DEFAULT_ALLOW,
                    where: str = "program-lint") -> Report:
    """Flag allowlist entries that sanctioned nothing (``ZS-P004``).

    ``hits`` is a (merged) ``allow_hits`` map from :func:`lint_program`
    runs.  Only meaningful over a sweep that exercises every model
    family: a single-arch run legitimately leaves other families'
    entries unmatched, so the driver arms this check only for
    full-family sweeps.  Stale entries are warnings: each one is a
    sanctioned site that no longer exists, silently widening what a
    future fallback may hide behind.
    """
    report = Report()
    for entry in allow:
        if hits.get(entry, 0) == 0:
            report.add(Diagnostic(
                rule="ZS-P004", severity="warning", where=where,
                message=f"allowlist entry {entry!r} matched no "
                        f"product site across the sweep (stale)",
                hint="remove the entry from DEFAULT_ALLOW, or restore "
                     "the sanctioned site it used to cover"))
    report.meta["allow_hits"] = dict(hits)
    return report
