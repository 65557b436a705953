"""Plain PyTorch versions of the kernels (the correctness ground truth).

Each function computes what its kernel computes, in the working dtype
conventions of the JAX package's ``repro.kernels.ref``: fp32
accumulation, the result cast to the requested dtype.
"""

from __future__ import annotations

import torch

__all__ = ["matmul_ref", "grouped_matmul_ref", "quantized_matmul_ref",
           "quantized_grouped_matmul_ref", "flash_attention_ref",
           "paged_attention_ref", "ssd_scan_ref", "NEG_INF"]

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


def grouped_matmul_ref(a: torch.Tensor, b: torch.Tensor,
                       out_dtype: torch.dtype | None = None) -> torch.Tensor:
    """a: (G, M, K), b: (G, K, N) -> (G, M, N) per-group matmul, with
    fp32 accumulation as :func:`matmul_ref`."""
    out_dtype = out_dtype or a.dtype
    c = torch.matmul(a.to(torch.float32), b.to(torch.float32))
    return c.to(out_dtype)


def _int_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The exact int32 product of int8 codes, (..., M, K) @ (..., K, N).

    On the CPU it is an integer matmul.  CUDA has no integer matmul
    outside ``torch._int_mm`` (a library kernel with shape limits), so on
    the card the codes go through fp64, which is exact here: every
    product is at most 127^2 and every partial sum at most K * 127^2,
    far below 2^53."""
    if a.device.type == "cpu":
        return torch.matmul(a.to(torch.int32), b.to(torch.int32))
    return torch.matmul(a.to(torch.float64),
                        b.to(torch.float64)).to(torch.int32)


def quantized_matmul_ref(a_q: torch.Tensor, b_q: torch.Tensor,
                         a_scale: torch.Tensor, b_scale: torch.Tensor,
                         out_dtype: torch.dtype | None = None
                         ) -> torch.Tensor:
    """The int8 zero-stall matmul in the kernel's order: the exact int32
    contraction of the codes, then ``(float(acc) * a_scale) * b_scale`` in
    fp32, then one cast to ``out_dtype`` (default fp32).  a_q (M, K),
    b_q (K, N) int8; a_scale (M, 1), b_scale (1, N) fp32."""
    acc = _int_matmul(a_q, b_q)
    c = acc.to(torch.float32) * a_scale.to(torch.float32) \
        * b_scale.to(torch.float32)
    return c.to(out_dtype or torch.float32)


def quantized_grouped_matmul_ref(a_q: torch.Tensor, b_q: torch.Tensor,
                                 a_scale: torch.Tensor, b_scale: torch.Tensor,
                                 out_dtype: torch.dtype | None = None
                                 ) -> torch.Tensor:
    """(G, M, K) x (G, K, N) int8 codes -> (G, M, N) with per-group
    (G, M, 1) and (G, 1, N) scales, as :func:`quantized_matmul_ref`."""
    return quantized_matmul_ref(a_q, b_q, a_scale, b_scale, out_dtype)


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


def paged_attention_ref(q: torch.Tensor, k_pool: torch.Tensor,
                        v_pool: torch.Tensor, page_table: torch.Tensor, *,
                        kv_lens: torch.Tensor,
                        scale: float | None = None) -> torch.Tensor:
    """Decode attention over a paged KV pool.

    q: (B, H, D), one query per sequence (its last position);
    k_pool/v_pool: (P, ps, KV, D); page_table: (B, T) int32 logical ->
    physical page id; kv_lens: (B,) valid kv positions (cache pos + 1).
    ``H = KV * rep`` query heads share each kv head.  The table is
    gathered into a (B, T*ps, KV, D) view, scores are fp32, columns
    ``>= kv_len`` (trash-page gathers included) are -1e30, and the
    output takes q's dtype.  A row with ``kv_len <= 0`` sees no column
    and is exact zeros, as in the kernels (the JAX reference would
    average it uniformly; the engine never asks for it: kv_len >= 1).
    """
    B, H, D = q.shape
    ps, KV = k_pool.shape[1], k_pool.shape[2]
    T = page_table.shape[1]
    rep = H // KV
    scale = scale if scale is not None else D ** -0.5
    pt = page_table.to(torch.long)
    k = k_pool[pt].reshape(B, T * ps, KV, D)
    v = v_pool[pt].reshape(B, T * ps, KV, D)
    qr = q.reshape(B, KV, rep, D)
    s = torch.einsum("bkrd,btkd->bkrt", qr.to(torch.float32),
                     k.to(torch.float32)) * scale
    kv_lens = kv_lens.to(q.device)
    valid = torch.arange(T * ps, device=q.device)[None, :] < kv_lens[:, None]
    s = torch.where(valid[:, None, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkrt,btkd->bkrd", p.to(v.dtype), v)
    out = torch.where((kv_lens > 0)[:, None, None, None], out,
                      torch.zeros((), dtype=out.dtype, device=out.device))
    return out.reshape(B, H, D).to(q.dtype)


def ssd_scan_ref(x: torch.Tensor, a_log: torch.Tensor, b: torch.Tensor,
                 c: torch.Tensor, *, h0: torch.Tensor | None = None
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """Mamba2 SSD reference: the sequential recurrence (the ground truth
    of :func:`repro_torch.models.ssm.ssd_chunked`; no kernel stands
    behind it, as none stands behind the JAX package's).

    One head: x (S, P) inputs (dt already folded in), a_log (S,) per-step
    log decays (a_t = exp(a_log_t) in (0, 1]), b and c (S, N), h0 (N, P)
    the initial state.  Returns (y (S, P) in x's dtype, h_final (N, P)
    fp32) with h_t = a_t h_{t-1} + b_t^T x_t and y_t = c_t h_t.
    """
    S, P = x.shape
    N = b.shape[-1]
    h = (torch.zeros((N, P), dtype=torch.float32, device=x.device)
         if h0 is None else h0.to(torch.float32))
    ys = []
    for t in range(S):
        h = torch.exp(a_log[t].to(torch.float32)) * h + torch.outer(
            b[t].to(torch.float32), x[t].to(torch.float32))
        ys.append((c[t].to(torch.float32) @ h).to(x.dtype))
    return torch.stack(ys) if ys else x.new_zeros((0, P)), h
