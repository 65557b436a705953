"""Schedule hazard checker: prove a config's revolving buffer is safe.

The port of ``repro.analyze.hazards``.  The paper's zero-stall claim is
*structural*: the N-slot revolving buffer never lets a copy write a slot
whose operands a compute step still needs, and the ZONL sequencer issues
the tile nest with zero control overhead.  Both are properties of the
schedule, not the data, so this module proves them by symbolic execution
instead of observing them in benchmarks.

:func:`simulate_schedule` replays the slot protocol of the port's rings
(prologue primes slots ``0..N-1``, step ``t >= 1`` prefetches step
``t+N-1`` into slot ``(t-1) % N``: the TMA producer of the sm90 design
and the cp.async ring alike) against an *independent* resident-slot
machine; :func:`check_config` runs the full per-config battery:
schedule simulation, cross-check against
``core.pipeline.RevolvingSchedule.conflict_free()``, the bank-level Dobu
mapping, the Snitch silicon's conflict-freedom, the ZONL
sequencer-vs-unrolled trace equivalence and the shared-memory budget.
All of it is the JAX package's logic, rule for rule, except
``ZS-S004``: the footprint is the port kernel's own shared-memory
formula for the design its wrapper picks
(:func:`repro_torch.kernels.zero_stall_matmul.smem_footprint`, flash
attention's ``smem_bytes``, paged attention's ``smem_bytes``) and the
budget is :attr:`HopperParams.smem_per_block`, in place of VMEM.  The
rule is one error threshold: on Hopper a block's shared memory holds
only the kernel's own stages and barriers, so the share the tuner
stages is the whole block (the tuner's legality is the kernels'
``SMEM_LIMIT``, equal to ``smem_per_block``) and there is no separate
warning tier, as the TPU's VMEM fraction had.
"""

from __future__ import annotations

import math

from repro_torch.analyze.diagnostics import Diagnostic
from repro_torch.core.cyclemodel import SNITCH_CONFIGS, HopperParams
from repro_torch.core.loopnest import matmul_nest
from repro_torch.core.pipeline import RevolvingSchedule
from repro_torch.kernels.zero_stall_matmul import smem_footprint

__all__ = ["simulate_schedule", "check_config", "check_paged",
           "bank_access_pattern"]

#: Grid sizes above this are spot-checked by closed form only (the
#: sequencer trace is O(total issued instructions)).
_SEQ_TRACE_CAP = 4096


def _overlap_of(variant: str | None, slots: int) -> bool:
    """Does the schedule issue copies concurrently with compute?

    The kernels overlap whenever they run the revolving buffer
    (``variant="dobu"`` / ``slots >= 2``); the serialized baseline
    (``variant="single"``) waits for compute before reusing its slot.
    A *mutated* config claiming "dobu" with one slot is exactly the
    hazard this checker exists to reject.
    """
    if variant is not None:
        return variant == "dobu"
    return slots >= 2


def simulate_schedule(steps: int, slots: int, *,
                      overlap: bool | None = None,
                      where: str = "schedule") -> list[Diagnostic]:
    """Symbolically execute the revolving-buffer slot protocol.

    Maintains ``resident[slot] = step`` (whose operands the slot
    holds) and a consumed set; every copy issue is hazard-checked
    against the slots still live, every compute checked against the
    slot's resident step.  Emits:

    * ``ZS-S001`` (error)  — a copy targets a slot holding operands a
      step still needs (slot-reuse hazard: the paper's stall).
    * ``ZS-S002`` (info)   — serialized single-buffer schedule (safe
      but stalls by design: the Base32fc baseline).
    * ``ZS-S003`` (error)  — compute consumes a slot that was never
      primed with its operands (schedule underflow).
    """
    if steps < 1 or slots < 1:
        return [Diagnostic(
            rule="ZS-S003", severity="error", where=where,
            message=f"degenerate schedule (steps={steps}, slots={slots})",
            hint="steps and slots must both be >= 1")]
    if overlap is None:
        overlap = slots >= 2
    diags: list[Diagnostic] = []
    resident: dict[int, int] = {}   # slot -> step whose operands it holds
    consumed: set[int] = set()

    def dma(step: int, during_compute: int | None) -> None:
        slot = step % slots
        held = resident.get(slot)
        live = (held is not None and held not in consumed
                and (during_compute is None or held >= during_compute))
        if during_compute is not None and held == during_compute:
            live = True             # a copy racing the step being computed
        if live:
            diags.append(Diagnostic(
                rule="ZS-S001", severity="error", where=where,
                message=(f"prefetch of step {step} overwrites slot {slot} "
                         f"while step {held}'s operands are still being "
                         f"consumed (copy/compute slot-reuse hazard)"),
                hint="use slots >= 2 (variant='dobu') or serialize the "
                     "copy (variant='single')"))
        resident[slot] = step

    # prologue: prime every slot before compute starts (revolving
    # buffer), or just step 0 (serialized / mutated single-slot)
    primed = min(slots, steps) if overlap else 1
    for s in range(primed):
        dma(s, during_compute=None)

    for t in range(steps):
        # concurrent prefetch issued while step t computes
        if overlap:
            look = slots - 1 if slots > 1 else 1
            nxt = t + look if (t > 0 or slots == 1) else None
            if nxt is not None and nxt < steps and nxt >= primed:
                dma(nxt, during_compute=t)
        # compute consumes slot t % slots
        slot = t % slots
        if resident.get(slot) != t:
            holds = ("nothing" if slot not in resident
                     else f"step {resident[slot]}")
            diags.append(Diagnostic(
                rule="ZS-S003", severity="error", where=where,
                message=(f"step {t} computes from slot {slot} which holds "
                         f"{holds} (operands never primed)"),
                hint="the prologue must prime steps 0..slots-1 before "
                     "compute starts"))
        consumed.add(t)
        if not overlap and t + 1 < steps:
            # serialized: the next copy waits for this compute — safe,
            # but every step pays the full transfer latency
            dma(t + 1, during_compute=None)

    if not overlap and steps > 1 and not any(
            d.rule == "ZS-S002" for d in diags):
        diags.append(Diagnostic(
            rule="ZS-S002", severity="info", where=where,
            message=f"serialized single-buffer schedule: {steps} steps "
                    f"each stall on their own copy (the conflicted "
                    f"baseline)",
            hint="use slots >= 2 to overlap copies with compute"))
    return diags


def bank_access_pattern(slots: int, steps: int
                        ) -> list[tuple[set[int], set[int]]]:
    """Per-step (compute banks, copy banks) under the Dobu mapping.

    Each slot's A/B staging buffers map to their own bank pair
    ``{2s, 2s+1}`` (on Hopper, each ring stage is its own region of
    shared memory with its own mbarrier pair) and the accumulator lives
    in a dedicated bank ``2*slots`` (the consumer's registers).
    Disjointness of the two sets at every step is the structural
    bank-conflict-freedom the Dobu interconnect provides in silicon.
    """
    sched = RevolvingSchedule(steps=steps, slots=slots)
    acc_bank = 2 * slots
    pattern = []
    for ph in sched.phases():
        compute = {2 * ph.compute_slot, 2 * ph.compute_slot + 1, acc_bank}
        dma = (set() if ph.prefetch_slot is None
               else {2 * ph.prefetch_slot, 2 * ph.prefetch_slot + 1})
        pattern.append((compute, dma))
    return pattern


def _budget(fp: int, what: str, where: str, params: HopperParams,
            hint: str) -> list[Diagnostic]:
    """``ZS-S004`` for a block footprint of ``fp`` bytes: an error above
    a block's shared memory."""
    budget = params.smem_per_block
    if fp > budget:
        return [Diagnostic(
            rule="ZS-S004", severity="error", where=where,
            message=f"{what} needs {fp} B of shared memory; a block has "
                    f"{budget} B",
            hint=hint)]
    return []


def _resolved_bk(cfg, key) -> int:
    bk = getattr(cfg, "bk", None)
    if bk is None and hasattr(cfg, "resolved_bk"):
        bk = cfg.resolved_bk(key.dtype if key is not None else "bfloat16")
    return int(bk)


def check_config(cfg, key=None, *, params: HopperParams | None = None,
                 steps: int | None = None) -> list[Diagnostic]:
    """Full static battery for one kernel config (duck-typed).

    ``cfg`` needs ``bm/bn/bk`` and ``slots`` (or ``resolved_slots``)
    and optionally ``variant``: a :class:`repro_torch.plan.KernelConfig`
    (``bk=None`` resolves for the key's dtype), a
    :class:`repro_torch.tune.Candidate` or any stand-in works.  ``key``
    (an :class:`repro_torch.plan.OpKey` or None) supplies the problem
    shape and operand width; without it a single-tile bf16 grid is
    assumed.

    Beyond :func:`simulate_schedule`, emits:

    * ``ZS-S004`` (error) — the block's shared memory over
      ``params.smem_per_block``;
    * ``ZS-S005`` (error) — model divergence: the symbolic executor
      and ``RevolvingSchedule.conflict_free()`` disagree, or the
      bank-level Dobu mapping finds an overlap the slot-level model
      missed;
    * ``ZS-S007`` (error) — the ZONL sequencer trace diverges from the
      unrolled reference for this grid (zero-overhead bound violated).
    """
    params = params or HopperParams()
    variant = getattr(cfg, "variant", None)
    slots = getattr(cfg, "slots", None)
    if slots is None:
        slots = getattr(cfg, "resolved_slots", None)
    if slots is None:
        slots = 2 if variant == "dobu" else 1
    slots = int(slots)
    if key is not None and getattr(key, "op", None) == "attention":
        return _check_attention_config(cfg, key, params=params)
    bm, bn = int(cfg.bm), int(cfg.bn)
    bk = _resolved_bk(cfg, key)
    where = (key.to_str() if hasattr(key, "to_str")
             else f"config(bm={bm},bn={bn},bk={bk},slots={slots})")
    overlap = _overlap_of(variant, slots)

    # grid size: per-shape when a key is given; without one, simulate
    # a steady-state grid long enough to exercise slot wraparound (a
    # 1-step schedule has nothing to prefetch and hides reuse hazards)
    if steps is None:
        if key is not None:
            gm = math.ceil(key.M / bm)
            gn = math.ceil(key.N / bn)
            gk = math.ceil(key.K / bk)
            steps = max(1, gm * gn * gk)
        else:
            gm = gn = gk = 1
            steps = max(4, 2 * slots + 2)
    else:
        gm, gn, gk = steps, 1, 1
    sim_steps = min(int(steps), 64)         # wraparound needs ~2N steps
    sim_steps = max(sim_steps, min(int(steps), 2 * slots + 2))

    diags = simulate_schedule(sim_steps, slots, overlap=overlap, where=where)

    # cross-check: symbolic executor vs the closed-form schedule model
    # (and its bank-level projection) must agree on conflict-freedom
    sim_clean = not any(d.rule == "ZS-S001" for d in diags)
    model_clean = RevolvingSchedule(steps=sim_steps, slots=slots,
                                    ).conflict_free() if overlap else True
    banks_clean = all(not (comp & dma) for comp, dma
                      in bank_access_pattern(max(slots, 1), sim_steps)
                      ) if slots >= 2 else not overlap
    if overlap and (sim_clean != model_clean or
                    (slots >= 2 and sim_clean != banks_clean)):
        diags.append(Diagnostic(
            rule="ZS-S005", severity="error", where=where,
            message=(f"model divergence: symbolic execution says "
                     f"{'clean' if sim_clean else 'hazardous'}, "
                     f"RevolvingSchedule.conflict_free() says "
                     f"{model_clean}, bank mapping says {banks_clean}"),
            hint="core/pipeline.py and the kernels' rings must implement "
                 "the same slot protocol"))
    # silicon sanity: the paper's own configurations agree — the
    # overlapped schedule maps to a conflict-free Dobu config, the
    # serialized baseline to the conflicted 32-bank crossbar
    snitch = SNITCH_CONFIGS["zonl48dobu" if slots >= 2 else "base32fc"]
    if overlap and slots >= 2 and sim_clean != snitch.conflict_free:
        diags.append(Diagnostic(
            rule="ZS-S005", severity="error", where=where,
            message="Dobu silicon mapping disagrees with the schedule "
                    "simulation",
            hint="check SNITCH_CONFIGS conflict_free against the slot "
                 "protocol"))

    # shared memory of one block vs the Hopper budget
    if key is not None:
        M, N, K, eb = key.M, key.N, key.K, key.dtype_bytes
    else:
        M, N, K, eb = bm, bn, bk, 2
    design, fp = smem_footprint(M, N, K, bm, bn, bk, max(slots, 1),
                                eb if eb in (1, 2, 4) else 2)
    diags.extend(_budget(fp, f"the {design} ring's {max(slots, 1)} stages",
                         where, params, "shrink bk or slots"))

    # ZONL property: the sequencer issues the tile nest with zero
    # overhead — trace equivalence for small grids, closed form always
    nest = matmul_nest(gm, gn, gk)
    if nest.total_issued <= _SEQ_TRACE_CAP:
        try:
            seq = nest.sequencer_trace(max_cycles=nest.total_issued)
            if seq != nest.unrolled_trace():
                raise RuntimeError("sequencer trace diverged from the "
                                   "unrolled reference")
        except RuntimeError as e:
            diags.append(Diagnostic(
                rule="ZS-S007", severity="error", where=where,
                message=f"grid ({gm},{gn},{gk}): {e}",
                hint="the tile nest no longer satisfies the "
                     "zero-overhead sequencer bound"))

    # a hazardous schedule repeats its hazard every step — report each
    # (rule, severity) once per config, keeping the first occurrence
    seen: set[tuple[str, str]] = set()
    deduped = []
    for d in diags:
        if (d.rule, d.severity) not in seen:
            seen.add((d.rule, d.severity))
            deduped.append(d)
    return deduped


def _check_attention_config(cfg, key, *, params: HopperParams
                            ) -> list[Diagnostic]:
    """Attention configs: flash attention's block footprint at the tiles
    the call runs (its two-stage pipeline has no slot protocol to
    reject; the footprint can still blow shared memory)."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.plan.config import dtype_from_name
    dtype = dtype_from_name(key.dtype)
    bq, bkv = fa.fit_tiles(dtype, key.M, key.K, int(getattr(cfg, "bq", 32)),
                           int(getattr(cfg, "bkv", 32)))
    fp = fa.smem_bytes(int(key.N), bq, bkv, dtype)
    return _budget(fp, f"the flash working set ({bq} x {bkv} tiles)",
                   key.to_str(), params, "shrink bq/bkv")


def check_paged(head_dim: int, page_size: int, rep: int, dtype_bytes: int,
                *, where: str = "paged_attention",
                params: HopperParams | None = None) -> list[Diagnostic]:
    """``ZS-S004`` for paged attention: the block footprint
    (``paged_attention.smem_bytes``) at the ring the wrapper runs for a
    split of several pages (:func:`paged_stages`), against the budget."""
    from repro_torch.kernels import paged_attention as pa
    stages = pa.paged_stages(2, head_dim, page_size, rep, dtype_bytes)
    fp = pa.smem_bytes(head_dim, page_size, rep, dtype_bytes, stages)
    return _budget(fp, f"the paged ring of {stages} pages", where,
                   params or HopperParams(), "shrink page_size")
