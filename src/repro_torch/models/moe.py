"""Mixture-of-Experts layer: top-k router, capacity, grouped experts.

The port of ``repro.models.moe``.  Dispatch is sort-based with a static
per-expert capacity C: assignments are ranked within their expert by a
stable sort, ranks past C are dropped (Switch/GShard semantics), and the
expert FFNs run as one grouped zero-stall matmul over the (E, C, d)
buffers (:func:`repro_torch.kernels.ops.grouped_matmul`, or its int8
counterpart for W8A8 banks).

Three departures from the JAX code:

* top-k is a stable descending sort, lowest expert index first among
  equal probabilities, which is ``jax.lax.top_k``'s tie rule
  (``torch.topk`` breaks ties otherwise); the result is the same;
* the combine sums each token's k contributions with ``view(T, k,
  d).sum(1)`` (``tok_ids = arange(T * k) // k``), not a scatter-add,
  whose CUDA atomics would make bf16 sums depend on the order of the
  run.  It is deterministic and equal in fp32 up to summation order; in
  bf16 it accumulates the k terms in fp32 and rounds once, where a
  scatter-add may round after each add, so bf16 outputs can differ from
  the JAX package's in the last bits;
* under a mesh the routing, the dispatch and the combine run on
  tensors replicated over the mesh
  (:func:`repro_torch.runtime.sharding.replicate_for_op`, counted in
  ``obs``): DTensor has no sharding strategy for the sort-based
  dispatch, where GSPMD partitions it as it can.  The expert-parallel
  constraint on the (E, C, d) buffers is the reference's.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch import obs
from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models.layers import Ctx, Params
from repro_torch.quant.tensor import QTensor
from repro_torch.runtime.sharding import (P, constrain, from_replicated,
                                          gather_fsdp, is_dtensor,
                                          replicate_for_op,
                                          split_contraction)

__all__ = ["init_moe_mlp", "moe_mlp", "router_assignments"]


def _expert_matmul(x: torch.Tensor, w, ctx: Ctx) -> torch.Tensor:
    """(E, C, d) @ an expert bank through the grouped zero-stall engine.

    As ``layers.linear``: an int8 W8A8 QTensor bank runs the int8
    grouped kernel under ``ctx.plan.quant == "int8"``, any other QTensor
    dequantizes onto the standard grouped kernel."""
    if isinstance(w, QTensor):
        if ctx.plan.quant == "int8" and w.fmt == "int8" and w.w8a8:
            return ops.quantized_grouped_matmul(x, w, config=ctx.plan,
                                                out_dtype=ctx.dtype)
        w = w.dequantize(ctx.dtype)
    else:
        x, w = split_contraction(x, w)
        w = w.to(ctx.dtype)
    return ops.grouped_matmul(x, w, config=ctx.plan, out_dtype=ctx.dtype)


def _ep_constraint(t: torch.Tensor, ctx: Ctx, spec: tuple) -> torch.Tensor:
    """Expert-parallel sharding constraint (no-op without a mesh, or
    where a named axis does not divide its dim): pins the experts of the
    (E, C, d) buffers to the 'model' axis."""
    if ctx.mesh is None or "model" not in ctx.mesh.axis_names:
        return t
    sizes = dict(zip(ctx.mesh.axis_names, ctx.mesh.devices.shape))
    ok = all(a is None or (a in sizes and t.shape[i] % sizes[a] == 0)
             for i, a in enumerate(spec))
    if not ok:
        return t
    return constrain(t, P(*spec))


def init_moe_mlp(g: torch.Generator, cfg: ModelConfig, dtype,
                 device) -> Params:
    """Router (d, E) and expert banks (E, d, f) / (E, f, d) drawn from
    ``g``: normal * d^-0.5 (``wo``: * f^-0.5), as the JAX init; each
    tensor is drawn in fp32 and stored in ``dtype``."""
    E, d, f = cfg.n_experts, cfg.d_model, cfg.d_ff

    def normal(shape, scale):
        w = torch.empty(shape, dtype=torch.float32, device=device)
        w.normal_(0.0, 1.0, generator=g)
        return (w * scale).to(dtype)

    p = {"router": normal((d, E), d ** -0.5),
         "wi": normal((E, d, f), d ** -0.5),
         "wo": normal((E, f, d), f ** -0.5)}
    if cfg.mlp_type in ("swiglu", "geglu"):
        p["wg"] = normal((E, d, f), d ** -0.5)
    return p


def router_assignments(logits: torch.Tensor, k: int, capacity: int,
                       n_experts: int,
                       token_valid: torch.Tensor | None = None):
    """Top-k routing with capacity.

    logits: (T, E) fp32.  Returns (slot (T*k,), gates (T*k,), keep
    (T*k,), tok_ids (T*k,), aux_loss scalar).  ``slot = e * C + rank``
    for kept assignments (callers mask the rest with ``keep``).  Invalid
    (padding) tokens of ``token_valid`` ((T,) bool) are dropped and rank
    after every valid token of their expert, so they never take a
    capacity slot a real token would have had.
    """
    T, E = logits.shape
    probs = torch.softmax(logits, dim=-1)
    # lax.top_k's tie rule: the lowest index first among equal values
    gate_vals, expert_idx = torch.sort(probs, dim=-1, descending=True,
                                       stable=True)
    gate_vals, expert_idx = gate_vals[:, :k], expert_idx[:, :k]
    gate_vals = gate_vals / gate_vals.sum(dim=-1, keepdim=True)

    flat_e = expert_idx.reshape(-1)                          # (T*k,)
    tok_ids = torch.arange(T * k, device=logits.device) // k
    if token_valid is not None:
        invalid = ~token_valid[tok_ids]
        # sort key groups by expert (factor 2), invalid after valid
        sort_key = flat_e * 2 + invalid.to(flat_e.dtype)
    else:
        invalid = None
        sort_key = flat_e
    order = torch.argsort(sort_key, stable=True)
    sorted_e = flat_e[order]
    # a scatter-add of ones, not bincount, whose output size would make
    # the host wait for the card
    counts = torch.zeros(E, dtype=flat_e.dtype, device=logits.device)
    counts.scatter_add_(0, flat_e, torch.ones_like(flat_e))
    starts = torch.cumsum(counts, 0) - counts
    ranks = torch.empty_like(flat_e)
    ranks[order] = torch.arange(T * k, device=logits.device) \
        - starts[sorted_e]
    keep = ranks < capacity
    if invalid is not None:
        keep &= ~invalid
    slot = flat_e * capacity + ranks

    # load-balancing auxiliary loss (Switch): E * sum(f_e * p_e)
    frac_tokens = counts.to(torch.float32) / (T * k)
    aux = E * torch.sum(frac_tokens * probs.mean(dim=0))
    return slot, gate_vals.reshape(-1), keep, tok_ids, aux


def moe_mlp(p: Params, x: torch.Tensor, cfg: ModelConfig, ctx: Ctx, *,
            return_aux: bool = False,
            token_mask: torch.Tensor | None = None):
    """x: (B, S, d) -> (B, S, d) through the top-k experts.

    ``token_mask`` ((B, S) bool, ragged serving batches): padding tokens
    neither take expert capacity nor contribute output.  The capacity is
    ``max(1, int(capacity_factor * k * B * S / E))``, so it depends on
    the batch composition, as in the JAX package.

    Its regions (:func:`repro_torch.obs.region`): ``moe.route`` (the
    router's product and :func:`router_assignments`), ``moe.dispatch``
    (the buffers' scatter), ``moe.experts`` (the three grouped products
    and the activation) and ``moe.combine``."""
    B, S, d = x.shape
    T = B * S
    E, k = cfg.n_experts, cfg.experts_per_token
    C = max(1, int(cfg.capacity_factor * k * T / E))
    xf = x.reshape(T, d)

    with obs.region("moe.route"):
        # the router product is a plain matmul in the JAX package too
        logits = xf.to(torch.float32) @ gather_fsdp(p["router"]).to(
            torch.float32)
        valid = None if token_mask is None else token_mask.reshape(T)
        mesh = xf.device_mesh if is_dtensor(xf) else None
        if mesh is not None:
            xf, logits = replicate_for_op("moe.dispatch", xf, logits)
            if is_dtensor(valid):
                valid, = replicate_for_op("moe.dispatch", valid)
        slot, gates, keep, tok_ids, aux = router_assignments(
            logits, k, C, E, token_valid=valid)

    with obs.region("moe.dispatch"):
        # (E*C, d) buffers; dropped assignments go to a dump row
        dump = E * C
        slot_safe = torch.where(keep, slot, dump)
        buf = torch.zeros((E * C + 1, d), dtype=ctx.dtype, device=xf.device)
        buf[slot_safe] = xf[tok_ids].to(ctx.dtype)
        buf = buf[:-1].reshape(E, C, d)
        if mesh is not None:
            buf = from_replicated(buf, mesh)
        buf = _ep_constraint(buf, ctx, ("model", None, None))

    with obs.region("moe.experts"):
        # expert FFN through the grouped zero-stall engine
        # (quantized-aware)
        h = _expert_matmul(buf, p["wi"], ctx)
        h = _ep_constraint(h, ctx, ("model", None, None))
        if "wg" in p:
            g = _expert_matmul(buf, p["wg"], ctx)
            # jax.nn.gelu defaults to the tanh approximation
            act = F.silu(g) if cfg.mlp_type == "swiglu" \
                else F.gelu(g, approximate="tanh")
            h = act * h
        else:
            h = F.gelu(h, approximate="tanh")
        y = _expert_matmul(h, p["wo"], ctx)
        y = _ep_constraint(y, ctx, ("model", None, None))

    with obs.region("moe.combine"):
        # out[tok] = sum over its k assignments of gate * y[e, rank]
        y_flat = y.reshape(E * C, d)
        if mesh is not None:
            y_flat, = replicate_for_op("moe.combine", y_flat)
        contrib = (y_flat[torch.where(keep, slot, 0)]
                   * (gates * keep).to(ctx.dtype)[:, None])
        out = contrib.view(T, k, d).sum(dim=1).reshape(B, S, d)
        if mesh is not None:
            out, aux = from_replicated(out, mesh), from_replicated(aux, mesh)
    if return_aux:
        return out, aux
    return out
