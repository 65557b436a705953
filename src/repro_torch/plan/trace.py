"""Ahead-of-time plan resolution on the meta device.

The port's counterpart of ``repro.plan.trace``.  ``trace_model`` runs a
model's prefill, decode and (``"train"``) loss entry points on tensors
of PyTorch's ``meta`` device (shapes only: no data, no operations, no
memory; the counterpart of ``jax.eval_shape``) with an auto-resolving
:class:`~repro_torch.plan.Plan` threaded through the ``Ctx``.  Every
``ops`` call the model makes resolves its
:class:`~repro_torch.plan.KernelConfig` during the trace (through
:mod:`repro_torch.tune` for the ``"auto"`` policy) and memoizes it into
the plan, so the returned Plan covers every kernel config of those call
shapes: at run time resolution is a dict lookup and the tuner is never
consulted.  The kernels' call sites resolve on every device alike, so a
plan traced on the CPU is the plan the card runs.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Mapping, Sequence

import torch

from repro_torch.plan.plan import Plan, as_plan

__all__ = ["trace_model"]

_META = torch.device("meta")


def _to_meta(tree):
    """``tree`` (nested dicts, lists and tuples of tensors and
    QTensors) with every tensor on the meta device, strides kept."""
    from repro_torch.quant.tensor import QTensor
    if isinstance(tree, torch.Tensor):
        return tree.to(_META)
    if isinstance(tree, QTensor):
        return QTensor(_to_meta(tree.data), _to_meta(tree.scale),
                       fmt=tree.fmt, w8a8=tree.w8a8)
    if isinstance(tree, dict):
        return {k: _to_meta(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_meta(v) for v in tree)
    return tree


def _as_meta(spec) -> torch.Tensor:
    """Shape tuple (int32 assumed) / (shape, dtype) pair / tensor -> an
    empty meta tensor."""
    if isinstance(spec, torch.Tensor):
        return torch.empty_like(spec, device=_META)
    if isinstance(spec, tuple) and len(spec) == 2 \
            and isinstance(spec[0], (tuple, list)):
        return torch.empty(tuple(spec[0]), dtype=spec[1], device=_META)
    return torch.empty(tuple(spec), dtype=torch.int32, device=_META)


def trace_model(model, batch_shapes: Sequence[Mapping[str, Any]], ctx, *,
                max_len: int | None = None,
                modes: Sequence[str] = ("prefill", "decode"),
                decode_batch: int | None = None,
                cache_dtype: torch.dtype = torch.float32,
                cache_kwargs: Mapping[str, Any] | None = None,
                params=None) -> Plan:
    """Resolve every kernel config of a model's call shapes into a Plan.

    Parameters
    ----------
    model, ctx : a ``build_model`` bundle and the execution context the
        plan is for (``ctx.plan`` supplies backend, quant mode and
        default policy; its entry table is copied, then extended).
    batch_shapes : batch dicts of shapes, each value a shape tuple
        (int32 assumed), a ``(shape, dtype)`` pair or a tensor; one
        prefill trace per dict (e.g. one per serving bucket).
    max_len : cache capacity (required).
    modes : any of ``"prefill"``, ``"decode"`` and ``"train"`` (the
        forward of ``model.loss`` on each batch, ``targets`` defaulting
        to ``tokens``, as in the JAX package).
    decode_batch : decode batch width (e.g. ``ServeEngine.num_slots``);
        defaults to the largest batch dim in ``batch_shapes``.
    params : the params to trace with (moved to the meta device, no copy
        of their data); defaults to ``model.init`` on the meta device,
        quantized per ``ctx.plan.quant``.

    Returns the extended Plan, JSON-serializable through ``Plan.save``.
    """
    plan = as_plan(ctx.plan).copy()
    ctx = dataclasses.replace(ctx, plan=plan)
    unknown = set(modes) - {"prefill", "decode", "train"}
    if unknown:
        raise ValueError(f"trace_model: unknown modes {sorted(unknown)}")
    if max_len is None and ("prefill" in modes or "decode" in modes):
        raise ValueError("trace_model: max_len is required for the "
                         "'prefill'/'decode' modes")
    batches = [{k: _as_meta(v) for k, v in bs.items()} for bs in batch_shapes]
    if params is None:
        params = model.init(seed=0, dtype=torch.float32, device=_META)
        if plan.quant is not None:
            params = model.quantize_weights(params, fmt=plan.quant)
    else:
        params = _to_meta(params)

    for batch in batches:
        if "prefill" in modes:
            model.prefill(params, batch, ctx, max_len)
        if "train" in modes:
            # forward only: the port runs no backward pass, and the
            # reference traces no backward product through ops.* either
            train_batch = dict(batch)
            train_batch.setdefault("targets", train_batch["tokens"])
            model.loss(params, train_batch, ctx)
    if "decode" in modes:
        if decode_batch is None:
            decode_batch = max((b["tokens"].shape[0] for b in batches
                                if "tokens" in b), default=1)
        cache = model.init_cache(decode_batch, max_len, cache_dtype,
                                 device=_META, **dict(cache_kwargs or {}))
        cache["pos"] = torch.zeros((decode_batch,), dtype=torch.int32,
                                   device=_META)
        tokens = torch.zeros((decode_batch, 1), dtype=torch.int32,
                             device=_META)
        model.decode(params, cache, tokens, ctx)
    return plan
