"""Plan linter: validate a `repro_torch.plan.Plan` artifact before it runs.

The port of ``repro.analyze.plan_lint``.  A Plan is a shippable
execution schedule (``--plan`` on the serve CLI); a replica loading one
must be able to trust it without running it.  :func:`lint_plan` checks
every entry against the rules below and, through
:func:`repro_torch.analyze.hazards.check_config`, against the full
schedule-hazard battery, so ``ServeEngine(plan=..., validate=True)``
rejects a hazardous or int8-unsafe plan at load time.

Optionally pass the replica's retry policy to lint the (plan, fault
policy) *pair*; the policy rules are duck-typed (``max_retries``,
``backoff_base_s``, ``backoff_factor``, ``max_backoff_s``,
``restart_on_exhaustion``, ``total_delay_s()``), as in the JAX package.

The rules are the JAX package's; ``ZS-L003``'s alignment is the Hopper
kernels' (:data:`HOPPER_ALIGN`) in place of the TPU's (8, 128) lanes.
"""

from __future__ import annotations

import math

from repro_torch.analyze.diagnostics import Diagnostic, Report
from repro_torch.analyze.hazards import check_config, check_paged
from repro_torch.core.cyclemodel import HopperParams
from repro_torch.kernels.zero_stall_matmul import smem_footprint
from repro_torch.plan.config import KernelConfig, OpKey, dtype_bytes

__all__ = ["lint_plan", "lint_page_geometry", "lint_cluster",
           "HOPPER_ALIGN"]

#: The granule of each matmul dim the Hopper kernels pad to, by design.
#: sm90: M rows to 8 (the narrowest wgmma N side it instantiates), N to
#: 64 (the wgmma M side: a weight tile is bn in {64, 128} rows), K to one
#: 128-byte TMA box.  The cp.async ring: its warp tiles, 8 x 8 threads'
#: tiles and 16 bytes of k in fp32, 32 x 32 warp tiles and 32 bytes of k
#: (one mma) on the tensor cores.  The plain backend pads nothing (the
#: JAX package's ``"jnp"`` alignment of 1).
HOPPER_ALIGN = {"sm90": (8, 64, 128), "ring_fp32": (8, 8, 16),
                "ring_tc": (32, 32, 32)}

#: A decode-hot matmul: the bucketed M of a few-token decode step.
_DECODE_HOT_M = 16

#: Accepted accumulator-safe out_dtypes for int8 entries.
_INT8_SAFE_OUT = ("int32", "float32", "bfloat16", "float16")


def _pad(dim: int, align: int) -> int:
    return max(align, int(math.ceil(dim / align)) * align)


def _tiles(key: OpKey, cfg: KernelConfig) -> tuple:
    """(name, tile the kernel runs, dim, alignment) of the three matmul
    dims: the sm90 design runs ``sm90_rows(M, bm)`` rows of A, the ring
    bm; the k tile for ``bk=None`` is the dtype's."""
    from repro_torch.kernels import zero_stall_matmul as zs
    eb = key.dtype_bytes if key.dtype_bytes in (1, 2, 4) else 2
    bk = cfg.resolved_bk(key.dtype)
    design, _ = smem_footprint(key.M, key.N, key.K, cfg.bm, cfg.bn, bk,
                               cfg.resolved_slots, eb)
    rows = zs.sm90_rows(key.M, cfg.bm) if design == "sm90" else cfg.bm
    am, an, ak = HOPPER_ALIGN[design if design == "sm90" else
                              "ring_fp32" if eb == 4 else "ring_tc"]
    return (("bm", rows, key.M, am), ("bn", cfg.bn, key.N, an),
            ("bk", bk, key.K, max(1, ak // eb)))


def _lint_entry(key: OpKey, cfg: KernelConfig, plan,
                params: HopperParams) -> list[Diagnostic]:
    where = key.to_str()
    diags: list[Diagnostic] = []

    # ZS-L001: the OpKey itself must be resolvable (op vocabulary is
    # enforced by OpKey; dims are not)
    if min(key.M, key.N, key.K, key.groups) < 1:
        diags.append(Diagnostic(
            rule="ZS-L001", severity="error", where=where,
            message=f"OpKey has non-positive dims "
                    f"(M={key.M}, N={key.N}, K={key.K}, g={key.groups})",
            hint="plan entries must name real call-site shapes"))
        return diags            # dims below would divide by garbage

    # ZS-L002: entry backend must not contradict the plan backend
    if (cfg.backend != "auto" and plan.backend != "auto"
            and cfg.backend != plan.backend):
        diags.append(Diagnostic(
            rule="ZS-L002", severity="error", where=where,
            message=f"entry backend {cfg.backend!r} contradicts plan "
                    f"backend {plan.backend!r}",
            hint="stamp entries with backend='auto' and let the plan "
                 "decide"))

    backend = cfg.backend if cfg.backend != "auto" else plan.backend
    if key.op in ("matmul", "grouped_matmul"):
        # ZS-L003: a tile larger than the padded bucket dim is pure
        # zero-padding work (the plain backend pads nothing)
        for name, tile, dim, align in _tiles(key, cfg):
            align = 1 if backend == "torch" else align
            if tile > _pad(dim, align):
                diags.append(Diagnostic(
                    rule="ZS-L003", severity="warning", where=where,
                    message=f"{name}={tile} exceeds the padded bucket dim "
                            f"{_pad(dim, align)} — the tile is pure "
                            f"zero-padding",
                    hint=f"shrink {name} to <= {_pad(dim, align)}"))
        # ZS-L006: hot decode GEMMs must run the revolving buffer
        if key.M <= _DECODE_HOT_M and cfg.resolved_slots < 2:
            diags.append(Diagnostic(
                rule="ZS-L006", severity="warning", where=where,
                message=f"decode-hot matmul (bucketed M={key.M}) runs the "
                        f"serialized single-buffer schedule "
                        f"(slots={cfg.resolved_slots})",
                hint="use slots >= 2 on the decode path — it is "
                     "bandwidth-bound and pays the full copy latency "
                     "per step otherwise"))

    # ZS-L004/ZS-L005: out_dtype safety
    if cfg.out_dtype is not None:
        if key.dtype == "int8" or cfg.quant == "int8":
            if cfg.out_dtype == "int8":
                diags.append(Diagnostic(
                    rule="ZS-L004", severity="error", where=where,
                    message="int8 entry accumulates into an int8 output "
                            "— the int32 accumulator contract is violated",
                    hint=f"use out_dtype in {_INT8_SAFE_OUT} (the kernel "
                         f"accumulates in exact int32 and dequantizes in "
                         f"its epilogue)"))
        else:
            try:
                out_bytes = dtype_bytes(cfg.out_dtype)
            except Exception:
                out_bytes = None
            if out_bytes is None or ("int" in cfg.out_dtype
                                     and key.dtype not in ("int8",)):
                diags.append(Diagnostic(
                    rule="ZS-L005", severity="error", where=where,
                    message=f"out_dtype {cfg.out_dtype!r} is not a safe "
                            f"output type for {key.dtype} operands",
                    hint="use a float out_dtype (or None for the operand "
                         "dtype)"))
            elif out_bytes < dtype_bytes(key.dtype):
                diags.append(Diagnostic(
                    rule="ZS-L005", severity="warning", where=where,
                    message=f"out_dtype {cfg.out_dtype!r} narrows the "
                            f"{key.dtype} operand dtype — precision is "
                            f"dropped at the kernel boundary",
                    hint="narrow after the residual add, not in the "
                         "kernel epilogue, unless this is intentional"))

    # ZS-L007: entry quant mode must agree with the plan's
    if cfg.quant is not None and cfg.quant != plan.quant:
        diags.append(Diagnostic(
            rule="ZS-L007", severity="warning", where=where,
            message=f"entry quant={cfg.quant!r} disagrees with plan "
                    f"quant={plan.quant!r}",
            hint="stamp quant on the plan, not on individual entries"))

    # layer-1 battery: schedule hazards, shared memory, ZONL bound
    diags.extend(check_config(cfg, key, params=params))
    return diags


def _lint_policy(plan, policy) -> list[Diagnostic]:
    """The (plan, fault policy) pair rules (``ZS-Fxxx``)."""
    diags: list[Diagnostic] = []
    where = f"RetryPolicy(max_retries={policy.max_retries})"
    if policy.max_retries < 1:
        diags.append(Diagnostic(
            rule="ZS-F001", severity="warning", where=where,
            message="max_retries < 1: every transient failure escalates "
                    "straight to checkpoint-restart",
            hint="allow at least one in-place retry"))
    if (policy.backoff_factor < 1.0 or policy.backoff_base_s < 0.0
            or policy.max_backoff_s < policy.backoff_base_s):
        diags.append(Diagnostic(
            rule="ZS-F002", severity="error",
            where=f"RetryPolicy(backoff_base_s={policy.backoff_base_s}, "
                  f"backoff_factor={policy.backoff_factor}, "
                  f"max_backoff_s={policy.max_backoff_s})",
            message="backoff schedule is ill-formed (factor < 1, "
                    "negative base, or cap below base)",
            hint="factor >= 1, base >= 0, max_backoff_s >= base"))
    if (policy.restart_on_exhaustion and plan.default == "auto"
            and len(plan.entries) == 0):
        diags.append(Diagnostic(
            rule="ZS-F003", severity="warning",
            where="Plan(default='auto', entries=0)",
            message="restart-on-exhaustion with an empty auto plan: every "
                    "replica restart re-runs the tuner before serving",
            hint="ship a traced plan (trace_model / --plan trace) so "
                 "restarts resolve configs by lookup"))
    return diags


def lint_page_geometry(page_size: int, table_len: int, *,
                       max_len: int | None = None, plan=None,
                       head_dim: int | None = None, rep: int | None = None,
                       dtype_bytes: int | None = None) -> Report:
    """Validate a paged-KV geometry against a plan's attention tiling.

    Rules:

    * ``ZS-L008`` (error) — ``page_size`` must tile every attention
      entry's KV block (``bkv % page_size == 0``; the plan default and
      the ``KernelConfig`` default when no plan is given), so a KV tile
      is always a whole number of pages.
    * ``ZS-S008`` (error) — the per-slot table capacity
      (``table_len * page_size`` tokens) must cover ``max_len``;
      a shorter table silently truncates long requests' KV.
    * ``ZS-S004`` — with ``head_dim``, ``rep`` (query heads a kv head)
      and ``dtype_bytes`` given: the paged-attention block's shared
      memory against the Hopper budget
      (:func:`~repro_torch.analyze.hazards.check_paged`).

    ``ServeEngine(page_size=..., validate=True)`` runs this at load
    time and raises on errors.
    """
    report = Report()
    where = f"PageGeometry(page_size={page_size}, table_len={table_len})"
    bkvs: dict[str, int] = {}
    if plan is not None:
        default = getattr(plan, "default", None)
        if isinstance(default, KernelConfig):
            bkvs["Plan.default"] = default.bkv
        for key, cfg in sorted(plan.entries.items()):
            if key.op == "attention":
                bkvs[key.to_str()] = cfg.bkv
    if not bkvs:
        bkvs["KernelConfig() default"] = KernelConfig().bkv
    for src, bkv in bkvs.items():
        if page_size < 1 or bkv % page_size:
            report.add(Diagnostic(
                rule="ZS-L008", severity="error",
                where=f"{where} vs {src}",
                message=f"page_size {page_size} does not tile the "
                        f"attention KV block (bkv={bkv})",
                hint="pick page_size with bkv % page_size == 0 so a KV "
                     "tile is always a whole number of pages"))
    if max_len is not None and table_len * page_size < max_len:
        report.add(Diagnostic(
            rule="ZS-S008", severity="error", where=where,
            message=f"page-table capacity {table_len * page_size} tokens "
                    f"({table_len} pages x {page_size}) is below "
                    f"max_len {max_len}",
            hint="size table_len to ceil(max_len / page_size)"))
    if None not in (head_dim, rep, dtype_bytes) and page_size >= 1:
        report.extend(check_paged(head_dim, page_size, rep, dtype_bytes,
                                  where=where))
    return report


def lint_cluster(plans, *, policy=None,
                 request_timeout_s: float | None = None) -> Report:
    """Validate a replica fleet's (plans, fault policy) configuration.

    Rules:

    * ``ZS-L009`` (error) — every replica must execute the *same* plan:
      all ``Plan.fingerprint()``s equal.  Replicas with divergent plans
      produce placement-dependent numerics (different kernel configs →
      different reduction orders), silently breaking a router's
      determinism contract.
    * ``ZS-F004`` (error) — the fault policy's worst-case total
      re-queue backoff (``policy.total_delay_s()``) must stay below the
      request timeout; otherwise a request re-queued off a dead replica
      can exhaust its deadline sleeping.

    ``policy``/``request_timeout_s`` are optional: ZS-F004 only fires
    when both are given (no timeout means no deadline to bound).
    """
    report = Report()
    plans = list(plans)
    # engines running a builtin backend string instead of a typed Plan
    # still have an identity to compare
    prints = [p.fingerprint() if hasattr(p, "fingerprint")
              else f"builtin:{p!r}" for p in plans]
    if len(set(prints)) > 1:
        listing = ", ".join(f"replica {i}: {fp}"
                            for i, fp in enumerate(prints))
        report.add(Diagnostic(
            rule="ZS-L009", severity="error",
            where=f"cluster({len(plans)} replicas)",
            message=f"replica plans diverge ({listing})",
            hint="ship ONE saved plan artifact to every replica "
                 "(--plan path); divergent kernel configs make tokens "
                 "placement-dependent"))
    if policy is not None and request_timeout_s is not None:
        total = policy.total_delay_s()
        if total >= request_timeout_s:
            report.add(Diagnostic(
                rule="ZS-F004", severity="error",
                where=f"RetryPolicy(max_retries={policy.max_retries}, "
                      f"backoff_base_s={policy.backoff_base_s}, "
                      f"backoff_factor={policy.backoff_factor})",
                message=f"worst-case re-queue backoff "
                        f"({total:.1f}s) reaches the request timeout "
                        f"({request_timeout_s:.1f}s)",
                hint="lower max_retries/backoff so total_delay_s() < "
                     "request timeout — a re-queued request must still "
                     "have time to finish on a survivor"))
    return report


def lint_plan(plan, *, policy=None, params: HopperParams | None = None
              ) -> Report:
    """Validate a complete :class:`repro_torch.plan.Plan` artifact.

    Rules ``ZS-L001..L007`` per entry (see module source), the full
    per-config hazard battery (``ZS-Sxxx``), and, when ``policy`` (a
    retry policy, duck-typed) is given, the replica plan + fault policy
    pair rules (``ZS-Fxxx``).
    """
    params = params or HopperParams()
    report = Report()
    for key, cfg in sorted(plan.entries.items()):
        report.extend(_lint_entry(key, cfg, plan, params))
    if policy is not None:
        report.extend(_lint_policy(plan, policy))
    return report
