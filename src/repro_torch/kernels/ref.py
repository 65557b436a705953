"""Plain PyTorch versions of the kernels (the correctness ground truth).

Each function computes what its kernel computes, in the working dtype
conventions of the JAX package's ``repro.kernels.ref``: fp32
accumulation, the result cast to the requested dtype.
"""

from __future__ import annotations

import torch

__all__ = ["matmul_ref", "flash_attention_ref", "NEG_INF"]

NEG_INF = -1e30


def matmul_ref(a: torch.Tensor, b: torch.Tensor,
               out_dtype: torch.dtype | None = None) -> torch.Tensor:
    """C = A @ B with fp32 accumulation, cast to ``out_dtype`` (default:
    A's dtype).  The operands are upcast to fp32 first, so the product
    of two bf16 values is exact and only the sum order and the final
    cast round."""
    out_dtype = out_dtype or a.dtype
    c = torch.matmul(a.to(torch.float32), b.to(torch.float32))
    return c.to(out_dtype)


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool = True, scale: float | None = None,
                        q_lens: torch.Tensor | None = None,
                        kv_lens: torch.Tensor | None = None,
                        q_offsets: torch.Tensor | None = None
                        ) -> torch.Tensor:
    """q,k,v: (B, H, S, D) -> (B, H, S, D). Numerically-stable softmax.

    With ``q_lens``/``kv_lens`` ((B,) valid lengths), positions are
    absolute indices (query row i == sequence position i, shifted to
    ``q_offsets[b] + i`` when offsets are given), masked scores are
    -1e30 and fully-masked query rows return exact zeros.  Without any
    length operand the causal mask is end-aligned (the ``k=T-S`` tril
    offset), as in the JAX reference.
    """
    S, T = q.shape[-2], k.shape[-2]
    scale = scale if scale is not None else q.shape[-1] ** -0.5
    logits = torch.einsum("bhsd,bhtd->bhst", q.to(torch.float32),
                          k.to(torch.float32)) * scale
    if q_lens is None and kv_lens is None and q_offsets is None:
        if causal:
            mask = torch.ones((S, T), dtype=torch.bool,
                              device=q.device).tril(T - S)
            logits = logits.masked_fill(~mask, float("-inf"))
        probs = torch.softmax(logits, dim=-1)
        return torch.einsum("bhst,bhtd->bhsd", probs.to(v.dtype), v)
    rows = torch.arange(S, device=q.device)[None, :, None]       # (1, S, 1)
    if q_offsets is not None:
        rows = rows + q_offsets.to(q.device)[:, None, None]
    cols = torch.arange(T, device=q.device)[None, None, :]       # (1, 1, T)
    if causal:
        mask = rows >= cols
    else:
        mask = torch.ones((1, S, T), dtype=torch.bool, device=q.device)
    if q_lens is not None:
        mask = mask & (rows < q_lens.to(q.device)[:, None, None])
    if kv_lens is not None:
        mask = mask & (cols < kv_lens.to(q.device)[:, None, None])
    mask = mask[:, None]                                         # (B|1,1,S,T)
    logits = torch.where(mask, logits, NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhst,bhtd->bhsd", probs.to(v.dtype), v)
    row_valid = mask.any(dim=-1, keepdim=True)
    return torch.where(row_valid, out, torch.zeros((), dtype=out.dtype,
                                                   device=out.device))
