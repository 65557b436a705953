"""Kernel launch verification: prove the Hopper kernels' launches realize
the zero-stall schedule the config layer models.

The port of ``repro.analyze.kernel_lint``.  The JAX package traces each
``pallas_call`` and replays its kernel IR.  The port's kernels are CUDA
C++, so there is no IR to trace: the "IR" is the launch geometry each
wrapper hands to its C entry, a :class:`~repro_torch.kernels.meta.Launch`
that the wrapper module's ``launch_geometry`` builds from the integers
its ``plan_launch`` gives the wrapper to launch from, and that
:func:`~repro_torch.kernels.meta.record_launches` collects (at real launches on the card, at ``ops`` calls on the meta
device).  :func:`trace_kernel_irs` records an entry point's launches.

Two verification modes, selected by the family's declared
:class:`~repro_torch.kernels.meta.ScheduleContract`:

* **managed DMA** (the four matmul families): each block's ring is
  replayed from the geometry, as both rings of the port run it (the TMA
  producer of ``csrc/zero_stall_sm90.cuh`` and the cp.async ring of
  ``csrc/zero_stall_ring.cuh``): the block's uses of the ring are its
  tiles' k stages in walk order; use u lands in stage ``clock(u) mod
  slots`` (the clock is the block's use count, which runs on across the
  tiles of a persistent walk) and waits on the stage's mbarrier at parity
  ``(clock(u) // slots) & 1``; the producer keeps ``lookahead = slots -
  1`` uses in flight beyond the one computed (issued before compute from
  step 1 on), or, at ``lookahead = 0``, issues the next use after the
  compute (the serialized baseline).  The replay is diffed against
  :meth:`repro_torch.core.pipeline.RevolvingSchedule.timeline`, the
  hazard simulation and the declared contract; the walk is checked for
  coverage, contiguity and split order; the launch's storage ranges for
  aliasing.
* **fixed pipeline** (the attention families): flash attention's kv-tile
  walk (with its tile skipping) and paged attention's page splits are
  checked to cover each key below ``kv_len`` exactly once, and no output
  window to be revisited.

Rules (catalog in ``analyze.RULES``):

* ``ZS-K001`` — launch/config schedule divergence: the replayed ring
  does not match the contract, ``RevolvingSchedule`` or the hazard
  simulation, or an attention walk leaves a needed key uncovered;
* ``ZS-K002`` — a copy lands in a stage a compute step still reads
  (WAR on the replayed ring);
* ``ZS-K003`` — bank conflict in the derived access pattern under the
  Dobu mapping;
* ``ZS-K004`` — an output tile's accumulation is not one contiguous run
  per split, a tile or split is walked twice, a window is revisited, or
  partials are summed out of split order;
* ``ZS-K005`` — an output or the split workspace overlaps a live input
  (storage ranges, known on the card).
"""

from __future__ import annotations

import itertools
import math
from typing import Callable, Iterable

from repro_torch.analyze.diagnostics import Diagnostic, Report
from repro_torch.analyze.hazards import bank_access_pattern, simulate_schedule
from repro_torch.core.pipeline import RevolvingSchedule
from repro_torch.kernels.meta import Launch, record_launches

__all__ = ["KernelIR", "trace_kernel_irs", "lint_kernel_ir", "lint_kernels",
           "KERNEL_FAMILIES"]

#: the port's kernel "IR": one launch's geometry
KernelIR = Launch

#: sweep families understood by :func:`lint_kernels`
KERNEL_FAMILIES = ("zero_stall", "grouped", "quantized", "attention")

#: (tile, k stage) pairs and attention blocks above this are not
#: enumerated for coverage (diagnosed, not silent)
_COVER_CAP = 1 << 21


def trace_kernel_irs(fn: Callable, *args, **kwargs) -> list[Launch]:
    """Run an entry point (on meta tensors: shapes only; on the card:
    the real launches) and return every launch it made."""
    with record_launches() as launches:
        fn(*args, **kwargs)
    return list(launches)


def _err(report: Report, rule: str, where: str, message: str,
         hint: str = "") -> None:
    report.add(Diagnostic(rule=rule, severity="error", where=where,
                          message=message, hint=hint))


# ----------------------------------------------------------------------
# contract
# ----------------------------------------------------------------------
def _check_contract(launch: Launch, report: Report, where: str) -> None:
    c = launch.contract
    if c is None:
        _err(report, "ZS-K001", where,
             f"launch {launch.name!r} names no registered kernel family")
        return
    if len(launch.grid) != c.grid_rank:
        _err(report, "ZS-K001", where,
             f"launch grid rank {len(launch.grid)} != declared "
             f"{c.grid_rank}")
    slots = launch.params.get("slots")
    if c.slots is not None and slots is not None and c.slots != slots:
        _err(report, "ZS-K001", where,
             f"kernel name declares {c.slots} slot(s) but the launch's "
             f"ring holds {slots}")
    order = c.grid_order
    jik = launch.params.get("jik")
    if order is not None and jik is not None and int(order == "jik") != jik:
        _err(report, "ZS-K001", where,
             f"kernel name declares grid order {order!r} but the launch "
             f"rasterises {'jik' if jik else 'ijk'}")


# ----------------------------------------------------------------------
# managed DMA: the matmul rings
# ----------------------------------------------------------------------
def _blocks(launch: Launch) -> Iterable[tuple[int, int]]:
    return itertools.product(range(launch.grid[0]), range(launch.grid[1]))


def _block_walk(launch: Launch, bx: int, by: int) -> list[tuple[int, int]]:
    """The (output tile, k stage) uses of block (bx, by)'s ring, in the
    order the block runs them."""
    p = launch.params
    if launch.design == "sm90":
        tiles = range(bx, p["tiles"], launch.grid[0])
        k0 = by * p["per"]
        ks = range(k0, min(k0 + p["per"], p["steps"]))
    else:
        tiles = [by * p["gm"] * p["gn"] + bx]
        ks = range(p["steps"])
    if p.get("k_inner", 1):
        return [(t, k) for t in tiles for k in ks]
    return [(t, k) for k in ks for t in tiles]


def _replay(walk: list[tuple[int, int]], slots: int, lookahead: int,
            clock: str) -> dict:
    """Replay one block's ring: for each use its stage and parity, the
    prologue's issues, and per step the issue made around its compute
    (``(use, stage, before_compute)`` or None)."""
    n = len(walk)
    if clock == "tile":        # a per-tile clock (a mutation's)
        tick, seen = [], {}
        for tile, _ in walk:
            tick.append(seen.get(tile, 0))
            seen[tile] = tick[-1] + 1
    else:                      # the kernels': the block's use count
        tick = list(range(n))
    stage = [c % slots for c in tick]
    parity = [(c // slots) & 1 for c in tick]
    prologue = list(range(min(n, lookahead + 1)))
    issues = []
    for t in range(n):
        if lookahead >= 1:
            u = t + lookahead if t >= 1 else None
            issues.append(None if u is None or u >= n else (u, True))
        else:
            issues.append((t + 1, False) if t + 1 < n else None)
    return {"n": n, "stage": stage, "parity": parity,
            "prologue": prologue, "issues": issues}


def _check_ring(rp: dict, slots: int, report: Report, where: str) -> None:
    n, stage, parity = rp["n"], rp["stage"], rp["parity"]
    hazards = 0
    resident: dict[int, int] = {}       # stage -> use it holds
    consumed: set[int] = set()

    def land(u: int, during: int | None, what: str) -> None:
        nonlocal hazards
        s = stage[u]
        held = resident.get(s)
        if during is not None and stage[during] == s:
            hazards += 1
            _err(report, "ZS-K002", where,
                 f"step {during} computes from slot {s} while a copy "
                 f"({what}, use {u}) is in flight into the same slot",
                 "prefetch must target the slot drained one step "
                 "earlier, never the live compute slot")
        elif held is not None and held not in consumed:
            hazards += 1
            _err(report, "ZS-K002", where,
                 f"{what} of use {u} overwrites slot {s} still holding "
                 f"the unconsumed use {held}",
                 "increase slot depth or delay the prefetch")
        resident[s] = u

    for u in rp["prologue"]:
        land(u, None, "the prologue's copy")
    acc_bank = 2 * slots
    model = bank_access_pattern(slots, n) if slots > 1 else []
    for t in range(n):
        issue = rp["issues"][t]
        if issue is not None and issue[1]:
            land(issue[0], t, f"step {t}'s prefetch")
        if resident.get(stage[t]) != t:
            _err(report, "ZS-K001", where,
                 f"step {t} computes from slot {stage[t]}, which holds "
                 f"use {resident.get(stage[t])} (operands never primed)")
        consumed.add(t)
        # ZS-K003: the compute stage's banks against the copy's
        comp = {2 * stage[t], 2 * stage[t] + 1, acc_bank}
        dma = ({2 * stage[issue[0]], 2 * stage[issue[0]] + 1}
               if issue is not None and issue[1] and t > 0 else set())
        if comp & dma:
            _err(report, "ZS-K003", where,
                 f"step {t}: concurrent copy and compute touch banks "
                 f"{sorted(comp & dma)} under the Dobu mapping",
                 "slot s maps to banks {2s, 2s+1}; producer and consumer "
                 "slots must differ")
        elif slots > 1 and 0 < t < len(model):
            want_c, want_d = model[t]
            if comp != set(want_c) or (dma and dma != set(want_d)):
                _err(report, "ZS-K001", where,
                     f"step {t}: derived bank pattern ({sorted(comp)} / "
                     f"{sorted(dma)}) diverges from the Dobu model "
                     f"({sorted(want_c)} / {sorted(want_d)})")
        if issue is not None and not issue[1]:
            land(issue[0], None, f"step {t}'s serialized copy")

    # the mbarrier phase of a slot must flip at every reuse: a repeated
    # parity lets a wait pass on the slot's previous fill
    last: dict[int, int] = {}
    for u in range(n):
        s = stage[u]
        if s in last and last[s] == parity[u]:
            _err(report, "ZS-K001", where,
                 f"use {u} waits on slot {s} at parity {parity[u]}, the "
                 f"parity of its previous fill: the wait would pass on "
                 f"stale data",
                 "the ring's clock must be the block's use count")
            break
        last[s] = parity[u]
    rp["hazards"] = hazards


def _diff_timeline(rp: dict, slots: int, report: Report,
                   where: str) -> None:
    """Diff the replayed prologue and phases against the canonical
    schedule of a block's ring."""
    n = rp["n"]
    tl = RevolvingSchedule(steps=n, slots=slots).timeline()
    prologue = sorted((u, rp["stage"][u]) for u in rp["prologue"])
    want = sorted(set(tl["prologue"]))
    if prologue != want:
        _err(report, "ZS-K001", where,
             f"prologue primes {prologue} (use, slot) but the schedule "
             f"model expects {want}")
    for t, want_cs, want_ps, want_pslot in tl["phases"]:
        if rp["stage"][t] != want_cs:
            _err(report, "ZS-K001", where,
                 f"step {t} computes from slot {rp['stage'][t]}; the "
                 f"schedule model assigns slot {want_cs}")
        issue = rp["issues"][t]
        if want_ps is None:
            if issue is not None:
                _err(report, "ZS-K001", where,
                     f"step {t} issues a prefetch; the schedule model "
                     f"expects none here")
            continue
        if issue is None:
            _err(report, "ZS-K001", where,
                 f"step {t} issues no prefetch; the schedule model "
                 f"expects use {want_ps} into slot {want_pslot}")
            continue
        u, before = issue
        if rp["stage"][u] != want_pslot:
            _err(report, "ZS-K001", where,
                 f"step {t} prefetches into slot {rp['stage'][u]}; the "
                 f"schedule model expects slot {want_pslot}")
        if u != want_ps:
            _err(report, "ZS-K001", where,
                 f"step {t}'s prefetch is use {u}; the schedule model "
                 f"expects look-ahead to use {want_ps}")
        if slots > 1 and not before:
            _err(report, "ZS-K001", where,
                 f"step {t} issues its prefetch after compute "
                 f"(serialized); an overlap schedule with {slots} slots "
                 f"must prefetch concurrently")


def _check_walk(launch: Launch, walks: dict, report: Report,
                where: str) -> None:
    """ZS-K004: every (tile, k stage) once across the launch, each
    tile's stages one increasing contiguous run in each block, one block
    a (tile, split), the split partials summed in split order."""
    p = launch.params
    if p["tiles"] * p["steps"] > _COVER_CAP:
        report.meta.setdefault("uncovered", []).append(where)
        return
    seen: dict[tuple[int, int], tuple[int, int]] = {}
    owner: dict[tuple[int, int], tuple[int, int]] = {}
    for blk, walk in walks.items():
        runs: dict[int, list[int]] = {}
        prev = None
        for i, (tile, k) in enumerate(walk):
            if tile != prev and tile in runs:
                _err(report, "ZS-K004", where,
                     f"block {blk} returns to output tile {tile} at use "
                     f"{i} after leaving it — the accumulation run is "
                     f"split and the tile re-read",
                     "keep the k loop innermost in the block's walk")
                return
            runs.setdefault(tile, []).append(k)
            prev = tile
            if (tile, k) in seen:
                _err(report, "ZS-K004", where,
                     f"tile {tile}'s k stage {k} is accumulated by blocks "
                     f"{seen[(tile, k)]} and {blk}")
                return
            seen[(tile, k)] = blk
        for tile, ks in runs.items():
            if ks != list(range(ks[0], ks[0] + len(ks))):
                _err(report, "ZS-K004", where,
                     f"block {blk} walks tile {tile}'s k stages out of "
                     f"order ({ks[:6]}...)")
                return
            split = ks[0] // p["per"]
            if owner.setdefault((tile, split), blk) != blk:
                _err(report, "ZS-K004", where,
                     f"tile {tile}'s split {split} is walked by blocks "
                     f"{owner[(tile, split)]} and {blk}")
                return
    missing = p["tiles"] * p["steps"] - len(seen)
    if missing:
        _err(report, "ZS-K004", where,
             f"{missing} (tile, k stage) pairs are never accumulated")
    if tuple(p.get("reduce_order", ())) != tuple(range(p["splits"])):
        _err(report, "ZS-K004", where,
             f"split-k partials are summed in order "
             f"{tuple(p['reduce_order'])}, not split order")


def _analyze_managed(launch: Launch, report: Report, where: str) -> None:
    p = launch.params
    slots, lookahead = p["slots"], p["lookahead"]
    clock = p.get("clock", "block")
    walks = {blk: _block_walk(launch, *blk) for blk in _blocks(launch)}
    _check_walk(launch, walks, report, where)
    replayed: set = set()
    hazards = 0
    for walk in walks.values():
        if not walk:
            continue
        # blocks whose walks have the same shape replay the same ring
        shape = (len(walk), tuple(k for _, k in walk) if clock == "tile"
                 else None)
        if shape in replayed:
            continue
        replayed.add(shape)
        rp = _replay(walk, slots, lookahead, clock)
        _check_ring(rp, slots, report, where)
        _diff_timeline(rp, slots, report, where)
        hazards += rp["hazards"]
        overlap = any(i is not None and i[1]
                      for t, i in enumerate(rp["issues"]) if t > 0)
        sim = [d for d in simulate_schedule(rp["n"], slots, overlap=overlap,
                                            where=where)
               if d.severity == "error"]
        if bool(sim) != bool(rp["hazards"]):
            _err(report, "ZS-K001", where,
                 f"replayed ring and simulate_schedule disagree: the "
                 f"simulation {'finds' if sim else 'finds no'} hazards, "
                 f"the replay {'does' if rp['hazards'] else 'does not'}")
    report.meta["ring_hazards"] = hazards


# ----------------------------------------------------------------------
# storage aliasing (all families)
# ----------------------------------------------------------------------
def _check_aliases(launch: Launch, report: Report, where: str) -> None:
    """ZS-K005: no output or workspace byte range overlaps an input's
    (or each other's)."""
    live = [(n, a, b) for role, n, a, b in launch.buffers
            if role == "in" and b > a]
    written = [(n, a, b) for role, n, a, b in launch.buffers
               if role in ("out", "ws") and b > a]
    for i, (wn, wa, wb) in enumerate(written):
        for rn, ra, rb in live + written[i + 1:]:
            if wa < rb and ra < wb:
                _err(report, "ZS-K005", where,
                     f"{wn} [{wa:#x}, {wb:#x}) overlaps {rn} "
                     f"[{ra:#x}, {rb:#x}) — the launch's writes land on "
                     f"a buffer it still reads",
                     "give outputs and the split workspace their own "
                     "storage")


# ----------------------------------------------------------------------
# attention: flash kv walk, paged splits
# ----------------------------------------------------------------------
def _values(x, n: int, default) -> list[int]:
    if x is None:
        return [default] * n
    if hasattr(x, "tolist"):
        x = x.tolist()
    return [int(v) for v in x]


def _check_flash(launch: Launch, report: Report, where: str) -> None:
    from repro_torch.kernels.flash_attention import kv_tiles
    p = launch.params
    B, H, Sq, Skv = p["B"], p["H"], p["Sq"], p["Skv"]
    bq, bkv, causal = p["bq"], p["bkv"], bool(p["causal"])
    lens = launch.lens or {}
    q_offs = _values(lens.get("q_offsets"), B, 0)
    q_lens = _values(lens.get("q_lens"), B, None)
    q_lens = [q_offs[b] + Sq if v is None else v for b, v in
              enumerate(q_lens)]
    kv_lens = _values(lens.get("kv_lens"), B, Skv)
    if launch.grid != (-(-Sq // bq), B * H):
        _err(report, "ZS-K004", where,
             f"grid {launch.grid} does not give each (b * h, q tile of "
             f"{bq} rows) one block over {Sq} rows (want "
             f"{(-(-Sq // bq), B * H)}): an output window is revisited "
             f"or left unwritten")
        return
    if B * launch.grid[0] > _COVER_CAP:
        report.meta.setdefault("uncovered", []).append(where)
        return
    for b in range(B):          # heads of a sequence walk alike
        kv_lim = min(Skv, kv_lens[b])
        for x in range(launch.grid[0]):
            q0 = x * bq
            n = kv_tiles(q0, Sq=Sq, Skv=Skv, bq=bq, bkv=bkv, causal=causal,
                         q_len=q_lens[b], kv_len=kv_lens[b],
                         q_off=q_offs[b], design=launch.design)
            last = min(q0 + bq, Sq, q_lens[b] - q_offs[b]) - 1
            if last < q0 or kv_lim <= 0:
                need = 0
            else:
                need = (min(kv_lim, q_offs[b] + last + 1) if causal
                        else kv_lim)
            if min(n * bkv, Skv) < need:
                _err(report, "ZS-K001", where,
                     f"sequence {b}, q tile {x}: the kv walk covers keys "
                     f"[0, {min(n * bkv, Skv)}) but its valid rows need "
                     f"[0, {need}) — keys below kv_len are skipped",
                     "a skipped kv tile must lie wholly past kv_len or "
                     "the causal frontier of the tile's last row")
                return


def _check_paged(launch: Launch, report: Report, where: str) -> None:
    p = launch.params
    B, KV, T, ps = p["B"], p["KV"], p["T"], p["ps"]
    rep, rows, chunks = p["rep"], p["rows"], p["row_chunks"]
    splits, per = p["splits"], p["per"]
    if launch.grid != (B * KV * chunks, splits):
        _err(report, "ZS-K001", where,
             f"grid {launch.grid} is not (B * KV * row_chunks, splits) = "
             f"{(B * KV * chunks, splits)}")
    cover = [0] * rep
    for c in range(chunks):
        for r in range(c * rows, min(c * rows + rows, rep)):
            cover[r] += 1
    if any(v != 1 for v in cover):
        _err(report, "ZS-K004", where,
             f"row chunks of {rows} rows cover the {rep} query rows of a "
             f"kv head {cover} times: an output row is written twice or "
             f"never")
    kv_lens = _values((launch.lens or {}).get("kv_lens"), B, T * ps)
    for b in range(B):
        n_pages = 0 if kv_lens[b] <= 0 else min(T, -(-kv_lens[b] // ps))
        walked = [0] * n_pages
        for z in range(splits):
            for pg in range(z * per, min(z * per + per, n_pages)):
                walked[pg] += 1
        if any(v != 1 for v in walked):
            _err(report, "ZS-K001", where,
                 f"sequence {b}: the splits of {per} pages walk its "
                 f"{n_pages} valid pages {walked} times — a key below "
                 f"kv_len is read twice or never",
                 "splits * per must cover the table, ranges disjoint")
            return
    if tuple(p.get("reduce_order", ())) != tuple(range(splits)):
        _err(report, "ZS-K004", where,
             f"the combine folds the splits in order "
             f"{tuple(p['reduce_order'])}, not split order")


# ----------------------------------------------------------------------
# entry points
# ----------------------------------------------------------------------
def lint_kernel_ir(ir: Launch, *, where: str | None = None) -> Report:
    """Verify one recorded launch."""
    report = Report()
    where = where or ir.name
    _check_contract(ir, report, where)
    _check_aliases(ir, report, where)
    c = ir.contract
    if c is not None and c.managed_dma:
        _analyze_managed(ir, report, where)
    elif c is not None and c.family == "flash_attention":
        _check_flash(ir, report, where)
    elif c is not None and c.family == "paged_attention":
        _check_paged(ir, report, where)
    report.meta.update({"kernel": ir.name, "design": ir.design,
                        "grid": list(ir.grid),
                        "blocks": math.prod(ir.grid)})
    return report


def _sweeps(families, space):
    """(family, thunk making launches on the meta device, lengths to
    attach) for every feasible candidate of ``space``."""
    import torch

    from repro_torch.kernels import ops
    from repro_torch.plan import KernelConfig
    from repro_torch.quant.tensor import QTensor
    from repro_torch.tune.space import Problem

    meta = torch.device("meta")

    def mm(M, N, K, dtype):
        return (torch.empty((M, K), dtype=dtype, device=meta),
                torch.empty((K, N), dtype=dtype, device=meta))

    def q8(shape_w, shape_s):
        # K-major codes: the transposed view of an (..., N, K) buffer
        data = torch.empty(shape_w[:-2] + (shape_w[-1], shape_w[-2]),
                           dtype=torch.int8, device=meta).mT
        return QTensor(data, torch.empty(shape_s, device=meta), fmt="int8")

    def cands(op, M, N, K, eb, G=1):
        return space.candidates(Problem(op, M, N, K, dtype_bytes=eb,
                                        groups=G))

    if "zero_stall" in families:
        for (M, N, K), dtype, eb in (((32, 256, 512), torch.bfloat16, 2),
                                     ((24, 80, 100), torch.float32, 4)):
            a, b = mm(M, N, K, dtype)
            for c in cands("matmul", M, N, K, eb):
                yield "zero_stall", (lambda a=a, b=b, c=c: ops.matmul(
                    a, b, config=KernelConfig.from_candidate(c))), None
    if "grouped" in families:
        for (G, M, N, K), dtype, eb in (((64, 16, 1024, 512),
                                         torch.bfloat16, 2),
                                        ((3, 24, 80, 100), torch.float32, 4)):
            a = torch.empty((G, M, K), dtype=dtype, device=meta)
            b = torch.empty((G, K, N), dtype=dtype, device=meta)
            for c in cands("grouped_matmul", M, N, K, eb, G):
                yield "grouped", (lambda a=a, b=b, c=c: ops.grouped_matmul(
                    a, b, config=KernelConfig.from_candidate(c))), None
    if "quantized" in families:
        for M, N, K in ((32, 256, 512), (24, 80, 200)):
            x = torch.empty((M, K), device=meta)
            qw = q8((K, N), (1, N))
            for c in cands("matmul", M, N, K, 1):
                yield "quantized", (lambda x=x, qw=qw, c=c:
                                    ops.quantized_matmul(
                                        x, qw, config=KernelConfig
                                        .from_candidate(c))), None
        G, M, N, K = 64, 16, 1024, 512
        x = torch.empty((G, M, K), device=meta)
        qw = q8((G, K, N), (G, 1, N))
        for c in cands("grouped_matmul", M, N, K, 1, G):
            yield "quantized", (lambda x=x, qw=qw, c=c:
                                ops.quantized_grouped_matmul(
                                    x, qw, config=KernelConfig
                                    .from_candidate(c))), None
    if "attention" in families:
        B, H, S, D = 2, 2, 80, 64
        ragged = {"q_lens": [S, 37], "kv_lens": [S, 37],
                  "q_offsets": [0, 0]}
        for dtype, eb in ((torch.bfloat16, 2), (torch.float32, 4)):
            q = torch.empty((B, H, S, D), dtype=dtype, device=meta)
            lens = torch.full((B,), S, dtype=torch.int32, device=meta)
            for bq, bkv in space.attention_candidates(
                    s_q=S, s_kv=S, head_dim=D, dtype_bytes=eb):
                for causal in (True, False):
                    yield "attention", (
                        lambda q=q, lens=lens, t=(bq, bkv), causal=causal:
                        ops.attention(q, q, q, config=t, causal=causal,
                                      q_lens=lens, kv_lens=lens)), ragged
        # paged decode over ragged lengths (one short of a page, a
        # single key, the whole table)
        B, H, KV, D, ps, T = 4, 8, 2, 128, 16, 8
        for dtype in (torch.bfloat16, torch.float32):
            q = torch.empty((B, H, D), dtype=dtype, device=meta)
            pool = torch.empty((B * T + 1, ps, KV, D), dtype=dtype,
                               device=meta)
            table = torch.empty((B, T), dtype=torch.int32, device=meta)
            kv = torch.empty((B,), dtype=torch.int32, device=meta)
            yield "attention", (lambda q=q, pool=pool, table=table, kv=kv:
                                ops.paged_attention(q, pool, pool, table,
                                                    kv_lens=kv)), \
                {"kv_lens": [ps - 1, 1, T * ps, 3 * ps + 5]}


def lint_kernels(families=None, *, space=None) -> Report:
    """Sweep the kernel families across a tuning space and verify every
    launch.

    Runs the public ``ops`` entry points on the meta device (so the
    verifier sees the geometry the wrappers would launch) for every
    feasible candidate of ``space`` (default: the port's
    :data:`~repro_torch.tune.space.DEFAULT_SPACE`), both designs of each
    family (bf16 / int8 on the TMA ring, fp32 and ragged int8 on the
    cp.async ring, bf16 and fp32 flash, paged attention over ragged
    lengths), runs :func:`lint_kernel_ir` on each launch, and returns
    one deduplicated :class:`Report` whose ``meta`` carries
    ``kernels_verified`` / ``families`` / ``zs_k_errors``.
    """
    from repro_torch.tune.space import DEFAULT_SPACE

    space = space or DEFAULT_SPACE
    picks = tuple(families or KERNEL_FAMILIES)
    unknown = set(picks) - set(KERNEL_FAMILIES)
    if unknown:
        raise ValueError(f"unknown kernel families: {sorted(unknown)}; "
                         f"expected a subset of {KERNEL_FAMILIES}")
    report = Report()
    verified = 0
    per_family: dict = {}
    for family, thunk, lens in _sweeps(picks, space):
        for ir in trace_kernel_irs(thunk):
            if lens is not None:
                ir = ir.replace(lens=lens)
            report.extend(lint_kernel_ir(ir))
            verified += 1
            per_family[family] = per_family.get(family, 0) + 1
    out = report.dedupe()
    out.meta.update({
        "kernels_verified": verified,
        "families": dict(sorted(per_family.items())),
        "zs_k_errors": sum(d.count for d in out.errors
                           if d.rule.startswith("ZS-K")),
    })
    return out
