"""Kernel schedule contracts and launch geometry (the port of ``repro.kernels.meta``).

A kernel *declares* its zero-stall schedule where nothing can read it off
the compiled code: which launch axes it has, whether it streams its
operands through its own N-slot ring (the matmul families: TMA copies
into shared-memory stages guarded by mbarriers) or leaves operand
movement to a fixed pipeline (the attention families), and how many
slots an instantiation runs.  Each kernel wrapper registers a
:class:`ScheduleContract` here at import time under the JAX package's
family name, and names each launch with :func:`kernel_name`, so the
static verifier (:mod:`repro_torch.analyze.kernel_lint`) can match what a
launch does against what its family declares.

The port's kernels are CUDA C++, so there is no kernel IR to trace.  What
the verifier reads instead is the :class:`Launch`: the geometry a wrapper
hands to its C entry (grid, tiles, ring depth, k splits, the persistent
walk, page splits), computed by the wrapper module's ``plan_launch``,
built by its ``launch_geometry`` and recorded, while :func:`record_launches` is open, at every launch on
the card and at every ``ops`` call on the meta device (a plan's trace,
shapes only).  ``grid_rank`` counts the axes of the CUDA launch grid,
``(blockIdx.x, blockIdx.y)``, which every kernel of the port has two of.

The JAX package's contract API (:class:`ScheduleContract`,
:func:`register_family`, :func:`kernel_name`, :func:`contract_for`,
:func:`registered_families`) is copied unchanged.
"""

from __future__ import annotations

import contextlib
import dataclasses
import re
from typing import Any, Callable, Iterator, Mapping

__all__ = ["ScheduleContract", "register_family", "kernel_name",
           "contract_for", "registered_families", "Launch",
           "record_launches", "note"]


@dataclasses.dataclass(frozen=True)
class ScheduleContract:
    """Declared schedule of one kernel family.

    ``family``: the name prefix shared by every instantiation.
    ``grid_rank``: expected number of grid axes.
    ``managed_dma``: True when the kernel body issues explicit copies
    into an N-slot revolving buffer (the matmul families); False when
    operand movement is a fixed pipeline the kernel does not schedule
    slot by slot (the attention families).
    ``sequential_axes``: ``"all"`` when every step of the walk must run
    in order because copy/accumulator state is carried across steps;
    ``"last"`` when only the innermost streaming axis must.
    ``slots``/``grid_order``: filled per-instantiation by
    :func:`contract_for` from the kernel name (None on the family
    template).
    """

    family: str
    grid_rank: int
    managed_dma: bool
    sequential_axes: str = "all"
    slots: int | None = None
    grid_order: str | None = None


_REGISTRY: dict[str, ScheduleContract] = {}

# instantiation suffix: "_s{slots}" then optionally "_{grid_order}"
_SUFFIX = re.compile(r"^(?:_s(?P<slots>\d+))?(?:_(?P<order>[a-z]{3}))?$")


def register_family(family: str, *, grid_rank: int, managed_dma: bool,
                    sequential_axes: str = "all") -> ScheduleContract:
    """Declare one kernel family's schedule contract (import-time)."""
    if sequential_axes not in ("all", "last"):
        raise ValueError(f"sequential_axes must be 'all' or 'last', "
                         f"got {sequential_axes!r}")
    contract = ScheduleContract(family=family, grid_rank=grid_rank,
                                managed_dma=managed_dma,
                                sequential_axes=sequential_axes)
    _REGISTRY[family] = contract
    return contract


def kernel_name(family: str, *, slots: int | None = None,
                grid_order: str | None = None) -> str:
    """Build the canonical (parseable) kernel instantiation name."""
    if family not in _REGISTRY:
        raise ValueError(f"unregistered kernel family: {family!r}")
    name = family
    if slots is not None:
        name += f"_s{int(slots)}"
    if grid_order is not None:
        name += f"_{grid_order}"
    return name


def contract_for(name: str) -> ScheduleContract | None:
    """Resolve a kernel instantiation name to its instantiated contract.

    Longest-prefix match over the registered families, then the
    ``_s{slots}_{order}`` suffix is parsed back into the contract.
    Returns None for kernels this repo does not govern.
    """
    for family in sorted(_REGISTRY, key=len, reverse=True):
        if name == family or name.startswith(family + "_"):
            m = _SUFFIX.match(name[len(family):])
            if m is None:
                continue
            slots = m.group("slots")
            return dataclasses.replace(
                _REGISTRY[family],
                slots=int(slots) if slots is not None else None,
                grid_order=m.group("order"))
    return None


def registered_families() -> tuple[str, ...]:
    """Registered family prefixes (sorted, for reporting)."""
    return tuple(sorted(_REGISTRY))


# ----------------------------------------------------------------------
# launch geometry
# ----------------------------------------------------------------------
@dataclasses.dataclass(frozen=True, eq=False)
class Launch:
    """One launch as its wrapper hands it to the C entry.

    ``name``: :func:`kernel_name` of the instantiation; ``design``: the
    wrapper's design (``"sm90"`` / ``"ring"`` for the matmuls,
    ``"tensor_core"`` / ``"cuda_core"`` for flash attention,
    ``"split_kv"`` for paged attention); ``grid``: ``(gridDim.x,
    gridDim.y)`` of the main launch; ``params``: the integers the wrapper
    passes (the keys each ``launch_geometry`` documents); ``buffers``:
    ``(role, operand, first byte, end byte)`` storage ranges, role
    ``"in"``, ``"out"`` or ``"ws"`` (split workspace), known on the card
    only; ``lens``: concrete per-sequence lengths of an attention launch
    (``q_lens``, ``kv_lens``, ``q_offsets`` lists; None where the
    default extents apply or the values are not readable, as on the
    meta device).
    """

    name: str
    design: str
    grid: tuple[int, int]
    params: Mapping[str, Any]
    buffers: tuple = ()
    lens: Mapping[str, Any] | None = None

    @property
    def family(self) -> str:
        c = self.contract
        return c.family if c is not None else self.name

    @property
    def contract(self) -> ScheduleContract | None:
        return contract_for(self.name)

    def replace(self, **changes) -> "Launch":
        """A copy with fields changed; ``params=`` entries are merged
        into the existing params (the verifier's mutation tests)."""
        if "params" in changes:
            changes["params"] = {**self.params, **changes["params"]}
        return dataclasses.replace(self, **changes)


_SINKS: list[list[Launch]] = []


@contextlib.contextmanager
def record_launches() -> Iterator[list[Launch]]:
    """Collect every :class:`Launch` the kernel wrappers (on the card)
    and the ``ops`` entry points (on the meta device) make inside the
    block, in order."""
    sink: list[Launch] = []
    _SINKS.append(sink)
    try:
        yield sink
    finally:
        _SINKS.remove(sink)


def note(launch: Launch | Callable[[], Launch], *, ins=(), outs=(),
         ws=(), lens: Mapping[str, Any] | None = None) -> None:
    """Record ``launch`` (or the Launch a zero-argument callable makes,
    built only while recording) in every open recorder; with none open
    it returns at once, so a launch pays one list check and the cost of
    building its arguments.  ``ins``, ``outs`` and ``ws`` are
    ``(operand, tensor)`` pairs whose storage byte ranges the record
    carries; a None tensor is left out.  ``lens`` are the launch's
    per-sequence length tensors: each is copied here (on its device, no
    host sync), so the record holds their values at the launch even if
    the caller updates them in place later."""
    if not _SINKS:
        return
    if callable(launch):
        launch = launch()
    ranges = tuple(_buffer_range(role, name, t)
                   for role, pairs in (("in", ins), ("out", outs),
                                       ("ws", ws))
                   for name, t in pairs if t is not None)
    if ranges:
        launch = launch.replace(buffers=launch.buffers + ranges)
    if lens is not None:
        launch = launch.replace(lens={k: None if v is None else v.clone()
                                      for k, v in lens.items()})
    for sink in _SINKS:
        sink.append(launch)


def _buffer_range(role: str, operand: str, t) -> tuple:
    """``(role, operand, first byte, end byte)`` of tensor ``t``'s
    storage on the card."""
    start = t.data_ptr()
    return (role, operand, start, start + t.numel() * t.element_size())
