"""Zero-overhead loop-nest (ZONL) IR (the port's copy of ``repro.core.loopnest``).

The paper generalizes Snitch's FREP hardware loop to arbitrary
perfectly/imperfectly nested loop nests, executed by a sequencer (ring
buffer + nest controller + single-cycle starting/ending-loop detectors)
at one useful instruction per cycle with zero control overhead.

On Hopper the analogous sequencer is the kernel's own loop over k
stages inside a block (and, for the grouped kernels, the persistent
walk over output tiles): the loop is set up once per launch and runs
without the host.  This module provides:

  * ``LoopNest`` — an explicit IR for (im)perfectly nested loops over a
    straight-line instruction body.
  * ``unrolled_trace`` — reference semantics (full expansion).
  * ``sequencer_trace`` — a behavioural model of the paper's FREP
    sequencer (Fig. 2): a pointer machine that issues one instruction
    per cycle and resolves loops starting/ending on the same
    instruction in a single step.  Property tests assert it matches
    ``unrolled_trace`` exactly (the paper's zero-overhead claim).
  * ``issue_cycles`` — cycle counts with/without ZONL (pre-ZONL Snitch
    runs only *leaf* loops in hardware; every outer-loop iteration
    costs ``outer_overhead`` cycles of loop management).
  * ``as_pallas_grid`` — the trip counts of a perfect nest prefix (the
    grid tuple of the JAX package's kernels; kept under that name so
    the two copies stay one interface).
"""

from __future__ import annotations

import dataclasses
from typing import Iterator

__all__ = ["Loop", "LoopNest", "matmul_nest"]


@dataclasses.dataclass(frozen=True)
class Loop:
    """One loop of a nest.

    Instructions are numbered 0..num_insts-1 in program order; the loop
    repeats the (inclusive) range [start, end] ``trips`` times.
    """

    trips: int
    start: int
    end: int
    name: str = ""

    def __post_init__(self):
        if self.trips < 1:
            raise ValueError(f"loop {self.name!r}: trips must be >= 1")
        if self.start > self.end or self.start < 0:
            raise ValueError(f"loop {self.name!r}: bad body range")

    @property
    def body_len(self) -> int:
        return self.end - self.start + 1


@dataclasses.dataclass(frozen=True)
class LoopNest:
    """A linear nest: loops[i+1] is strictly nested inside loops[i].

    "Perfect" nests share start/end across levels; "imperfect" nests
    have pre/post instructions at outer levels.  Instructions outside
    loops[0] are straight-line prologue/epilogue.
    """

    num_insts: int
    loops: tuple[Loop, ...]

    def __post_init__(self):
        prev = None
        for lp in self.loops:
            if lp.end >= self.num_insts:
                raise ValueError("loop body exceeds program")
            if prev is not None and not (prev.start <= lp.start and lp.end <= prev.end):
                raise ValueError("loops must be properly nested (outer->inner)")
            prev = lp

    # ------------------------------------------------------------------
    # Reference semantics
    # ------------------------------------------------------------------
    def unrolled_trace(self) -> list[int]:
        """Fully expanded instruction issue order (the ground truth)."""

        def emit(level: int, lo: int, hi: int, out: list[int]) -> None:
            # Execute instruction range [lo, hi] at nesting depth `level`
            # (children of loops[level-1] are loops[level:]).
            pc = lo
            while pc <= hi:
                if level < len(self.loops) and self.loops[level].start == pc:
                    lp = self.loops[level]
                    for _ in range(lp.trips):
                        emit(level + 1, lp.start, lp.end, out)
                    pc = lp.end + 1
                else:
                    out.append(pc)
                    pc += 1

        out: list[int] = []
        emit(0, 0, self.num_insts - 1, out)
        return out

    @property
    def total_issued(self) -> int:
        """Issued-instruction count (closed form, no expansion)."""
        # Work inside-out: instructions exclusive to level i execute
        # prod(trips[0..i]) times.
        total = 0
        mult = 1
        for i, lp in enumerate(self.loops):
            mult *= lp.trips
            inner = self.loops[i + 1] if i + 1 < len(self.loops) else None
            own = lp.body_len - (inner.body_len if inner is not None else 0)
            total += own * mult
        outside = self.num_insts - (self.loops[0].body_len if self.loops else 0)
        total += outside
        return total

    # ------------------------------------------------------------------
    # FREP sequencer behavioural model (paper Fig. 2)
    # ------------------------------------------------------------------
    def sequencer_trace(self, max_cycles: int | None = None) -> list[int]:
        """Pointer-machine model of the generalized FREP sequencer.

        One instruction is issued per cycle from the ring buffer; after
        each issue the nest controller resolves — in a single step —
        all loops that end on this instruction (trailing detector) and
        rewinds to the innermost non-ending loop, mirroring the paper's
        ending-loops detector.  Entering loops is implicit in the read
        pointer reaching a loop base (starting-loops detector).
        """
        iter_cnt = [0] * len(self.loops)
        trace: list[int] = []
        pc = 0
        limit = max_cycles if max_cycles is not None else self.total_issued + 1
        while pc < self.num_insts:
            if len(trace) > limit:
                raise RuntimeError("sequencer exceeded zero-overhead cycle bound")
            trace.append(pc)  # issue (1 cycle)
            # --- ending-loops detection (single combinational step) ---
            # Scan from the innermost active loop outwards: a loop whose
            # last body instruction is pc and whose inner loops are all
            # in their last iteration either rewinds (not last iter) or
            # exits (last iter), in which case the next-outer loop is
            # considered ("outermost ending loop" cascade).
            rewind_to: int | None = None
            for i in range(len(self.loops) - 1, -1, -1):
                lp = self.loops[i]
                if not (lp.start <= pc <= lp.end):
                    continue  # pc not inside this loop
                if lp.end != pc:
                    break  # innermost loop containing pc doesn't end here
                if iter_cnt[i] + 1 < lp.trips:
                    iter_cnt[i] += 1
                    # reset children
                    for j in range(i + 1, len(self.loops)):
                        iter_cnt[j] = 0
                    rewind_to = lp.start
                    break
                # last iteration: this loop exits; cascade outward
                iter_cnt[i] = 0
                rewind_to = None
            pc = rewind_to if rewind_to is not None else pc + 1
        return trace

    # ------------------------------------------------------------------
    # Cycle accounting
    # ------------------------------------------------------------------
    def issue_cycles(self, *, zonl: bool, outer_overhead: int = 10) -> int:
        """Cycles to issue the nest.

        zonl=True: the whole nest runs in the sequencer — cycles equal
        issued instructions (the paper's zero-overhead property).

        zonl=False (baseline Snitch): only *leaf* (innermost) loops run
        under single-level FREP; each iteration of every non-leaf loop
        costs ``outer_overhead`` extra cycles (2 management instructions
        + taken-branch refetch + address bookkeeping on the single-issue
        core; the paper says "2 instructions ... possibly more on
        pipelined processors").
        """
        cycles = self.total_issued
        if zonl:
            return cycles
        mult = 1
        for i, lp in enumerate(self.loops):
            is_leaf = i == len(self.loops) - 1
            if not is_leaf:
                # this loop body executes mult * trips times
                cycles += outer_overhead * mult * lp.trips
            mult *= lp.trips
        return cycles

    def overhead_fraction(self, *, outer_overhead: int = 10) -> float:
        base = self.issue_cycles(zonl=False, outer_overhead=outer_overhead)
        return 1.0 - self.total_issued / base

    # ------------------------------------------------------------------
    # Trip counts (the grid of the JAX package's kernels)
    # ------------------------------------------------------------------
    def as_pallas_grid(self) -> tuple[int, ...]:
        """Grid tuple for a perfect prefix of the nest.

        The grid sequencer plays the role of the FREP nest controller:
        it iterates the loop nest with zero instruction overhead.  Only
        the loop *structure* (trip counts) is needed.
        """
        return tuple(lp.trips for lp in self.loops)

    def iter_space(self) -> Iterator[tuple[int, ...]]:
        """Iterate the grid index space in sequencer order (outer->inner)."""

        def rec(i: int, prefix: tuple[int, ...]) -> Iterator[tuple[int, ...]]:
            if i == len(self.loops):
                yield prefix
                return
            for t in range(self.loops[i].trips):
                yield from rec(i + 1, prefix + (t,))

        return rec(0, ())


def matmul_nest(
    m_tiles: int, n_tiles: int, k_tiles: int, *, body: int = 1, names=("m", "n", "k")
) -> LoopNest:
    """The canonical matmul tile nest (perfect, 3 levels, `body` insts)."""
    return LoopNest(
        num_insts=body,
        loops=(
            Loop(trips=m_tiles, start=0, end=body - 1, name=names[0]),
            Loop(trips=n_tiles, start=0, end=body - 1, name=names[1]),
            Loop(trips=k_tiles, start=0, end=body - 1, name=names[2]),
        ),
    )
