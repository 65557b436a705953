"""Dobu revolving-buffer schedules (the port's copy of ``repro.core.pipeline``).

The paper's zero-conflict memory subsystem works because double
buffering statically separates producer (DMA) and consumer (cores)
into different hyperbanks.  On Hopper the analogue is the N-stage
shared-memory ring of the matmul kernels: while the consumer warpgroup
runs ``wgmma`` on stage ``t % N``, the producer warp's TMA copies fill
a stage no in-flight step touches, each stage guarded by a full/empty
mbarrier pair.  This module holds those schedules as plain Python, the
same as the JAX package's, so the invariant ("producer and consumer
never touch the same slot in the same step") is stated once for both.

Two schedules live here:

* :class:`DobuSchedule` — the paper's exact 2(+)-slot scheme with a
  single outstanding prefetch (step t fetches step t+1).
* :class:`RevolvingSchedule` — the depth-N generalization the kernels
  implement since the N-slot refactor: a prologue fills every slot,
  then step t (t >= 1) prefetches step ``t + N - 1`` into slot
  ``(t-1) % N`` — the slot drained one step earlier.  ``slots=1``
  degenerates to the serialized ("single"/conflicted) baseline.
  :mod:`repro_torch.tune` searches over N.
"""

from __future__ import annotations

import dataclasses
from typing import Iterator

__all__ = ["DobuSchedule", "RevolvingSchedule", "Phase"]


@dataclasses.dataclass(frozen=True)
class Phase:
    step: int              # compute step index (grid step)
    compute_slot: int      # slot holding this step's operands ("hyperbank" A)
    prefetch_step: int | None  # step whose operands are DMA'd now (None = none)
    prefetch_slot: int | None  # slot being filled ("hyperbank" B)


@dataclasses.dataclass(frozen=True)
class DobuSchedule:
    """Steady-state schedule for `steps` tiles over `slots` buffers."""

    steps: int
    slots: int = 2

    def __post_init__(self):
        if self.slots < 2:
            raise ValueError("dobu needs >= 2 slots (one per 'hyperbank')")
        if self.steps < 1:
            raise ValueError("steps must be >= 1")

    def slot_of(self, step: int) -> int:
        return step % self.slots

    def phases(self) -> Iterator[Phase]:
        for t in range(self.steps):
            nxt = t + 1 if t + 1 < self.steps else None
            yield Phase(
                step=t,
                compute_slot=self.slot_of(t),
                prefetch_step=nxt,
                prefetch_slot=None if nxt is None else self.slot_of(nxt),
            )

    def conflict_free(self) -> bool:
        """The Dobu invariant (what the hyperbanks guarantee in silicon)."""
        return all(
            ph.prefetch_slot is None or ph.prefetch_slot != ph.compute_slot
            for ph in self.phases()
        )


@dataclasses.dataclass(frozen=True)
class RevolvingSchedule:
    """Depth-N revolving-buffer schedule (the N-slot kernels' contract).

    Mirrors the rings of ``zero_stall_matmul`` and
    ``grouped_zero_stall_matmul``:

      * step 0 issues DMAs for steps ``0 .. min(slots, steps)-1``
        (prologue — every slot primed);
      * step t >= 1 issues the DMA for step ``t + slots - 1`` into slot
        ``(t + slots - 1) % slots == (t - 1) % slots``;
      * step t computes from slot ``t % slots``.

    ``slots=1`` is the serialized baseline: the "prefetch" for step
    t+1 reuses the only slot and must wait for step t's compute —
    modeled here as a prefetch into the compute slot (a conflict, by
    design: that is the Base32fc analogue).
    """

    steps: int
    slots: int = 2

    def __post_init__(self):
        if self.slots < 1:
            raise ValueError("revolving buffer needs >= 1 slot")
        if self.steps < 1:
            raise ValueError("steps must be >= 1")

    def slot_of(self, step: int) -> int:
        return step % self.slots

    def prologue_steps(self) -> list[int]:
        """Steps whose DMAs are issued before any compute."""
        return list(range(min(self.slots, self.steps)))

    def phases(self) -> Iterator[Phase]:
        look = self.slots - 1 if self.slots > 1 else 1
        for t in range(self.steps):
            if t == 0 and self.slots > 1:
                nxt = None          # prologue already primed every slot
            else:
                nxt = t + look if t + look < self.steps else None
            yield Phase(
                step=t,
                compute_slot=self.slot_of(t),
                prefetch_step=nxt,
                prefetch_slot=None if nxt is None else self.slot_of(nxt),
            )

    def timeline(self) -> dict:
        """Canonical event timeline the kernels must realize.

        Returns ``{"prologue": [(step, slot), ...], "phases":
        [(t, compute_slot, prefetch_step, prefetch_slot), ...]}``: the
        reference an observed copy/compute trace of a ring is held
        against.  The prologue lists the steps primed before any
        compute; each phase names the slot step t computes from and the
        step/slot its concurrent prefetch targets (None when the
        schedule issues none).
        """
        return {
            "prologue": [(s, self.slot_of(s))
                         for s in self.prologue_steps()],
            "phases": [(ph.step, ph.compute_slot, ph.prefetch_step,
                        ph.prefetch_slot) for ph in self.phases()],
        }

    def live_slots(self, t: int) -> set[int]:
        """Slots still holding un-consumed operands when step t issues
        its prefetch: this step's own slot plus the slots primed for
        steps ``t+1 .. t+slots-2`` by earlier issue phases (clipped)."""
        hi = min(t + self.slots - 1, self.steps) if self.slots > 1 else t + 1
        return {self.slot_of(s) for s in range(t, hi)}

    def conflict_free(self) -> bool:
        """Depth-N Dobu invariant: no prefetch lands in a live slot.

        "Live" at step t = the compute slot plus every already-primed,
        not-yet-consumed step (the prefetch's own target step is not
        yet primed, so it is not in the set).  True for all
        ``slots >= 2``; False for ``slots == 1`` (the serialized
        baseline *is* the conflict).
        """
        return all(
            ph.prefetch_slot is None
            or ph.prefetch_slot not in self.live_slots(ph.step)
            for ph in self.phases()
        )
