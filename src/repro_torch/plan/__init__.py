"""Typed execution plans (the port of ``repro.plan``).

The paper's zero-overhead loop nests work because the loop and tile
configuration is programmed once, ahead of the hot loop.  This package
is the software analogue: the execution configuration of every kernel
call is a validated, serializable artifact.

* :class:`KernelConfig`: one validated execution configuration (backend,
  matmul tiles ``bm/bn/bk``, ring ``variant``/``slots``, ``grid_order``,
  attention tiles ``bq/bkv``, quantized-execution mode, output dtype).
* :class:`OpKey`: the signature of one kernel call site, ``(op, M, N, K,
  groups, dtype)``, shape-bucketed as the tune cache is.
* :class:`Plan`: a JSON-serializable ``OpKey -> KernelConfig`` table plus
  the plan-wide backend, quant mode and default policy, in the JAX
  package's schema.

Every ``ops`` entry point takes one ``config`` argument with the
vocabulary ``KernelConfig | Plan | "auto" | (bm, bn, bk) | (bq, bkv) |
None``; model code threads a plan through ``Ctx(plan=...)``.
:func:`trace_model` runs a model's prefill and decode on the meta device
and returns a Plan with every kernel config resolved ahead of time:

    plan = trace_model(model, [batch_shapes], ctx, max_len=128)
    plan.save("gemma.plan.json")
    engine = ServeEngine(model, params, ctx, plan=plan)
"""

from repro_torch.plan.config import (BACKENDS, UNSET, KernelConfig, OpKey,
                                     dtype_from_name, dtype_name,
                                     resolve_slots)
from repro_torch.plan.plan import Plan, as_plan, config_backend, resolve
from repro_torch.plan.trace import trace_model

__all__ = ["BACKENDS", "UNSET", "KernelConfig", "OpKey", "Plan", "as_plan",
           "config_backend", "resolve", "trace_model", "dtype_from_name",
           "dtype_name", "resolve_slots"]
