"""Gradient compression with error feedback (the port of
``repro.optim.compression``).

Two standard schemes, both with error feedback so compression noise is
carried to the next step instead of lost:

  * int8 — per-tensor symmetric quantization (4x traffic cut vs fp32);
  * topk — magnitude sparsification keeping a fraction of entries.

The train step compresses the residual-corrected gradients, applies the
decompressed values and keeps the compression error as the next step's
residual.  A tensor is compressed as JAX's leaf: the port's per-layer
leaves of one parameter are stacked first
(:func:`repro_torch.tree.stacked_groups`), so an int8 scale and a top-k
selection span all layers, as over JAX's stacked array.  On one card nothing crosses a slow link; the step computes
what a multi-pod all-reduce would send, as the JAX package's does
without a mesh.
"""

from __future__ import annotations

import math
from typing import Any

import torch

from repro_torch.runtime.sharding import from_replicated, is_dtensor
from repro_torch.tree import flatten, stacked_groups, tree_map, unflatten

__all__ = ["init_residuals", "compress_int8", "decompress_int8",
           "compress_topk", "decompress_topk", "apply_error_feedback"]

Params = Any


def init_residuals(grads: Params) -> Params:
    return tree_map(lambda g: torch.zeros_like(g, dtype=torch.float32),
                    grads)


# --- int8 ------------------------------------------------------------
def compress_int8(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(codes, scale): scale = max|x| / 127 + 1e-12, codes rounded half
    to even and clipped to +-127, as JAX's."""
    scale = torch.max(torch.abs(x)) / 127.0 + 1e-12
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def decompress_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


# --- top-k -----------------------------------------------------------
def compress_topk(x: torch.Tensor, frac: float = 0.05
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """Returns (values, flat indices); k = max(1, frac * size)."""
    flat = x.reshape(-1)
    k = max(1, int(frac * flat.numel()))
    _, idx = torch.topk(torch.abs(flat), k)
    return flat[idx], idx


def decompress_topk(vals: torch.Tensor, idx: torch.Tensor, shape, dtype
                    ) -> torch.Tensor:
    flat = torch.zeros((math.prod(shape),), dtype=dtype, device=vals.device)
    flat[idx] = vals.to(dtype)
    return flat.reshape(shape)


# --- error feedback --------------------------------------------------
def apply_error_feedback(grads: Params, residuals: Params, *,
                         scheme: str = "int8", topk_frac: float = 0.05
                         ) -> tuple[Params, Params]:
    """(compressed-then-decompressed grads, new residuals).

    The returned grads are the values that would cross the slow links;
    residuals carry the compression error to the next step.
    """
    if scheme == "none":
        return grads, residuals

    gs, treedef = flatten(grads)
    rs, rdef = flatten(residuals)
    if rdef != treedef:
        raise ValueError("residuals do not have the gradients' structure")
    new_g, new_r = list(gs), list(rs)
    for idx in stacked_groups(grads):
        corrected = torch.stack([gs[i].to(torch.float32) + rs[i]
                                 for i in idx])
        if scheme == "int8":
            approx = decompress_int8(*compress_int8(corrected))
        elif scheme == "topk" and is_dtensor(corrected):
            # a DTensor across ranks: the top-k is global, so every rank
            # picks it from the whole tensor and keeps its own shard
            whole = corrected.full_tensor()
            v, i = compress_topk(whole, topk_frac)
            mesh = corrected.device_mesh
            approx = from_replicated(
                decompress_topk(v, i, whole.shape, torch.float32),
                mesh).redistribute(mesh, corrected.placements)
        elif scheme == "topk":
            v, i = compress_topk(corrected, topk_frac)
            approx = decompress_topk(v, i, corrected.shape, torch.float32)
        else:
            raise ValueError(scheme)
        res = corrected - approx
        for j, i in enumerate(idx):
            new_g[i], new_r[i] = approx[j].to(gs[i].dtype), res[j]
    return unflatten(treedef, new_g), unflatten(treedef, new_r)
