"""Kernel-level utilization accounting: which configs ran, what the
Hopper model predicted for them, and what the card measured.

The port's counterpart of ``repro.obs.kernel_watch``.  Every
``repro_torch.kernels.ops`` entry point reports its resolved execution
configuration here when observability is on: op, mathematical shape,
dtype, backend and the concrete :class:`~repro_torch.plan.KernelConfig`.

``count``: the port runs eagerly, so a record counts Python dispatches
of an entry point (each layer's call, each step's), where the JAX
package counts traced call sites once per compiled program.  A CUDA
graph's capture runs the entry points once and its replays call none,
so a captured call site counts once, at its capture, however often the
graph replays (``kernels/launches.py`` counts the launches replays run).

:func:`utilization_table` joins, per record:

* ``predicted_s`` / ``predicted_util``: the
  :class:`~repro_torch.core.cyclemodel.HopperPipelineModel` price of the
  recorded configuration;
* ``measured_s`` / ``measured_util``: the same op and config replayed
  alone on the card (:func:`measure_recorded`), timed with CUDA events
  over a CUDA graph of many calls whose operands cycle past L2.  It
  needs a CUDA device and raises without one.

Utilization is the least time the card could take for the work (the
larger of its unique bytes over the HBM rate and its operations over
the type's peak, data-sheet figures) over the predicted or measured
time: the roofline share.  The JAX package's table divides ideal MXU
time instead; at decode the products are bound by bytes, so on the H100
the roofline share is the measure that says how far a kernel is from
the card's limit.
"""

from __future__ import annotations

import contextlib
import dataclasses

from repro_torch.obs import trace as _trace
from repro_torch.plan.config import KernelConfig, dtype_bytes, dtype_name

__all__ = ["OpRecord", "record_dispatch", "recorded_ops", "reset_records",
           "utilization_table", "measure_recorded"]


@dataclasses.dataclass
class OpRecord:
    """One (op, shape, dtype, backend, config) dispatch signature."""

    op: str
    M: int
    N: int
    K: int
    groups: int
    batch_heads: int
    dtype: str
    backend: str
    config: KernelConfig | None
    count: int = 0

    @property
    def key(self) -> tuple:
        return (self.op, self.M, self.N, self.K, self.groups,
                self.batch_heads, self.dtype, self.backend, self.config)

    @property
    def config_str(self) -> str:
        c = self.config
        if c is None:
            return "default"
        if self.op == "attention":
            return f"{c.bq}x{c.bkv}"
        return (f"{c.bm}x{c.bn}x{c.resolved_bk(self.dtype)}"
                f"/s{c.resolved_slots}/{c.grid_order}")


_RECORDS: dict[tuple, OpRecord] = {}
_SUSPENDED = 0


@contextlib.contextmanager
def _suspended():
    """Mask recording (the measurement replay calls the kernels itself)."""
    global _SUSPENDED
    _SUSPENDED += 1
    try:
        yield
    finally:
        _SUSPENDED -= 1


def record_dispatch(op: str, *, M: int, N: int, K: int, dtype,
                    backend: str, config: KernelConfig | None = None,
                    groups: int = 1, batch_heads: int = 1) -> None:
    """Record one ``ops`` dispatch (callers gate on ``obs.enabled()``)."""
    if _SUSPENDED:
        return
    rec = OpRecord(op=op, M=int(M), N=int(N), K=int(K), groups=int(groups),
                   batch_heads=int(batch_heads), dtype=dtype_name(dtype),
                   backend=backend, config=config)
    hit = _RECORDS.setdefault(rec.key, rec)
    hit.count += 1


def recorded_ops() -> list[OpRecord]:
    """All dispatch records, in first-seen order."""
    return list(_RECORDS.values())


def reset_records() -> None:
    _RECORDS.clear()


# ----------------------------------------------------------------------
# predicted column
# ----------------------------------------------------------------------
def _priced(rec: OpRecord) -> tuple[KernelConfig, int]:
    """The config a record is priced at (a record without one, from the
    plain backend or paged attention, at ``KernelConfig()``) and its
    operand width."""
    return rec.config or KernelConfig(), dtype_bytes(rec.dtype)


def _predicted(rec: OpRecord, model=None):
    """The Hopper model's :class:`KernelEstimate` of one record."""
    from repro_torch.core.cyclemodel import HopperPipelineModel
    model = model or HopperPipelineModel()
    cfg, eb = _priced(rec)
    if rec.op == "attention":
        from repro_torch.kernels.flash_attention import fit_tiles
        from repro_torch.plan.config import dtype_from_name
        bq, bkv = fit_tiles(dtype_from_name(rec.dtype), rec.M, rec.K,
                            cfg.bq, cfg.bkv)
        return model.attention(bq, bkv, s_q=rec.M, s_kv=rec.K,
                               head_dim=rec.N, dtype_bytes=eb,
                               batch_heads=rec.batch_heads)
    return model.matmul(rec.M, rec.N, rec.K, cfg.bm, cfg.bn,
                        cfg.resolved_bk(rec.dtype), dtype_bytes=eb,
                        slots=cfg.resolved_slots, groups=rec.groups,
                        out_bytes=2 if eb == 1 else eb)


# ----------------------------------------------------------------------
# measured column
# ----------------------------------------------------------------------
def measure_recorded(records=None, *, calls: int = 20, repeats: int = 3
                     ) -> dict[tuple, float]:
    """Time each record's op and config alone on the card (CUDA events
    over a CUDA graph of ``calls`` launches, operands cycled past L2; the
    best of ``repeats`` replays).  Recording is suspended during the
    replay so measurement does not observe itself.  Returns
    {record.key: seconds}.  Raises without a CUDA device."""
    from repro_torch.tune.oracle import MeasuredOracle
    from repro_torch.tune.space import Candidate, Problem
    oracle = MeasuredOracle(calls=calls, repeats=repeats)
    out: dict[tuple, float] = {}
    with _suspended():
        for rec in (recorded_ops() if records is None else records):
            cfg, eb = _priced(rec)
            if rec.op == "attention":
                from repro_torch.kernels.flash_attention import fit_tiles
                from repro_torch.plan.config import dtype_from_name
                bq, bkv = fit_tiles(dtype_from_name(rec.dtype), rec.M,
                                    rec.K, cfg.bq, cfg.bkv)
                secs = oracle.estimate_attention(
                    bq, bkv, s_q=rec.M, s_kv=rec.K, head_dim=rec.N,
                    dtype_bytes=eb, batch_heads=rec.batch_heads)
            else:
                cand = Candidate(cfg.bm, cfg.bn, cfg.resolved_bk(rec.dtype),
                                 cfg.resolved_slots, cfg.grid_order)
                secs = oracle.estimate(cand, Problem(
                    rec.op, rec.M, rec.N, rec.K, dtype_bytes=eb,
                    groups=rec.groups))
            out[rec.key] = secs
            _trace.event("obs.measure_op", op=rec.op, M=rec.M, N=rec.N,
                         K=rec.K, config=rec.config_str, seconds=secs)
    return out


# ----------------------------------------------------------------------
# the table
# ----------------------------------------------------------------------
def utilization_table(*, measure: bool = False, calls: int = 20,
                      repeats: int = 3, model=None) -> list[dict]:
    """Per-op predicted-vs-measured utilization rows (dicts).

    Columns: op, M, N, K, groups, batch_heads, dtype, backend, config,
    count, bound_s, predicted_s, predicted_util, and, with
    ``measure=True`` (on the card), measured_s / measured_util.
    """
    measured = (measure_recorded(calls=calls, repeats=repeats)
                if measure else {})
    rows = []
    for rec in recorded_ops():
        est = _predicted(rec, model=model)
        row = {
            "op": rec.op, "M": rec.M, "N": rec.N, "K": rec.K,
            "groups": rec.groups, "batch_heads": rec.batch_heads,
            "dtype": rec.dtype, "backend": rec.backend,
            "config": rec.config_str, "count": rec.count,
            "bound_s": est.bound_s, "predicted_s": est.total_s,
            "predicted_util": est.utilization,
            "measured_s": None, "measured_util": None,
        }
        m = measured.get(rec.key)
        if m is not None:
            row["measured_s"] = m
            row["measured_util"] = est.bound_s / m
        rows.append(row)
    return rows
