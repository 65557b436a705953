"""Paged decode attention: the wrapper of ``csrc/paged_attention.cu``.

One decode query per sequence, q (B, H, D), against a shared page pool
(P, ps, KV, D) through an int32 page table (B, T) and valid lengths
``kv_lens`` (B,); grouped-query heads ride the rows of one block per
(b, kv head).  Columns at or past ``kv_len`` are masked, pages past it
are skipped, the page walk never leaves the table, and a row with
``kv_len <= 0`` is exact zeros (see the header note of the CUDA source
for its design and bound).  Replaces the Pallas TPU kernel
``repro.kernels.paged_attention.paged_attention``.

On a CUDA tensor the wrapper launches the kernel or raises; on a CPU
tensor it runs the plain version
:func:`repro_torch.kernels.ref.paged_attention_ref`.
``paged_attention.launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import paged_attention_ref

__all__ = ["paged_attention", "smem_bytes", "SMEM_LIMIT"]

SMEM_LIMIT = 232448
# q, k_pool, v_pool, o, page_table, kv_lens, B, KV, T, ps, D, rep, scale,
# bf16, stream
_ARGTYPES = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 \
    + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]


def smem_bytes(D: int, ps: int, rep: int, elt: int) -> int:
    """Shared memory of one block (the same formula as the CUDA source):
    two stages of a K and a V page, then the fp32 per-row state."""
    return 4 * ps * D * elt + 4 * (2 * rep * D + rep * ps + 3 * rep)


def paged_attention(q: torch.Tensor, k_pool: torch.Tensor,
                    v_pool: torch.Tensor, page_table: torch.Tensor, *,
                    kv_lens: torch.Tensor,
                    scale: float | None = None) -> torch.Tensor:
    """q (B, H, D), pools (P, ps, KV, D), page_table (B, T) int32,
    kv_lens (B,) -> (B, H, D) in q's dtype; ``scale`` defaults to
    ``D ** -0.5``.  Every page id must lie in ``[0, P)``."""
    if q.dim() != 3 or k_pool.dim() != 4 or k_pool.shape != v_pool.shape:
        raise ValueError(f"paged_attention: q (B,H,D) and pools (P,ps,KV,D) "
                         f"expected, got {tuple(q.shape)}, "
                         f"{tuple(k_pool.shape)}, {tuple(v_pool.shape)}")
    B, H, D = q.shape
    _, ps, KV, Dk = k_pool.shape
    if Dk != D or H % KV:
        raise ValueError(f"paged_attention: q {tuple(q.shape)} does not fit "
                         f"pools {tuple(k_pool.shape)} (head dim, or q heads "
                         f"not a multiple of kv heads)")
    if page_table.dim() != 2 or page_table.shape[0] != B \
            or tuple(kv_lens.shape) != (B,):
        raise ValueError(f"paged_attention: page_table (B, T) and kv_lens "
                         f"(B,) expected for B={B}, got "
                         f"{tuple(page_table.shape)}, {tuple(kv_lens.shape)}")
    T = page_table.shape[1]
    rep = H // KV
    scale = scale if scale is not None else D ** -0.5
    if all(t.device.type == "cpu" for t in (q, k_pool, v_pool)):
        return paged_attention_ref(q, k_pool, v_pool, page_table,
                                   kv_lens=kv_lens, scale=scale)
    dev = q.device
    if dev.type != "cuda" or any(t.device != dev for t in
                                 (k_pool, v_pool, page_table, kv_lens)):
        raise ValueError(f"paged_attention: q, pools, page_table and kv_lens "
                         f"on {q.device}, {k_pool.device}, {v_pool.device}, "
                         f"{page_table.device}, {kv_lens.device}; the kernel "
                         f"needs one CUDA device")
    if q.dtype not in (torch.float32, torch.bfloat16) or \
            k_pool.dtype != q.dtype or v_pool.dtype != q.dtype:
        raise ValueError(f"paged_attention: q and pools must all be fp32 or "
                         f"all bf16, got {q.dtype}, {k_pool.dtype}, "
                         f"{v_pool.dtype}")
    if page_table.dtype != torch.int32 or kv_lens.dtype != torch.int32:
        raise ValueError(f"paged_attention: page_table and kv_lens must be "
                         f"int32, got {page_table.dtype}, {kv_lens.dtype}")
    if not all(t.is_contiguous() for t in
               (q, k_pool, v_pool, page_table, kv_lens)):
        raise ValueError("paged_attention: q, pools, page_table and kv_lens "
                         "must be contiguous")
    elt = q.element_size()
    if (D * elt) % 16 or k_pool.data_ptr() % 16 or v_pool.data_ptr() % 16:
        raise ValueError(f"paged_attention: the kernel copies pool rows in "
                         f"16-byte pieces; head dim {D} x {elt} bytes must be "
                         f"a multiple of 16 and the pools 16-byte aligned")
    need = smem_bytes(D, ps, rep, elt)
    if need > SMEM_LIMIT:
        raise ValueError(
            f"paged_attention: page size {ps} at head dim {D} and {rep} "
            f"query heads per kv head needs {need} bytes of shared memory, "
            f"over the {SMEM_LIMIT} a Hopper block can have")
    o = torch.empty_like(q)
    if B == 0:
        return o
    fn = _build.bind("paged_attention", _ARGTYPES)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with _build.on_device(dev):
        code = fn(q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
                  o.data_ptr(), page_table.data_ptr(), kv_lens.data_ptr(),
                  B, KV, T, ps, D, rep, float(scale),
                  int(q.dtype == torch.bfloat16), stream)
    _build.check("paged_attention", code)
    paged_attention.launches += 1
    return o


paged_attention.launches = 0
