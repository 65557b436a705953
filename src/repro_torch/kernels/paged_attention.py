"""Paged decode attention: the wrapper of ``csrc/paged_attention.cu``.

One decode query per sequence, q (B, H, D), against a shared page pool
(P, ps, KV, D) through an int32 page table (B, T) and valid lengths
``kv_lens`` (B,); the grouped-query heads of one kv head are the rows of
one block.  Columns at or past ``kv_len`` are masked, pages past it are
skipped, the page walk never leaves the table, and a row with
``kv_len <= 0`` is exact zeros.  Replaces the Pallas TPU kernel
``repro.kernels.paged_attention.paged_attention``.

The kernel splits the page axis (split-KV): :func:`paged_splits` cuts
the T logical pages into contiguous ranges from B, KV, T and the SM
count alone, never from ``kv_lens`` (they live on the card: reading them
would sync the host in every layer and break CUDA-graph capture); each
block streams its range through a ring of :func:`paged_stages` pages and
keeps q and its accumulator in registers (:func:`paged_rows` query rows a
block), and a second launch combines the splits.  The pages arrive by
bulk copies of the TMA engine, one a K or V row.  See the header note of
the CUDA source for the design and its bound.

On a CUDA tensor the wrapper launches the kernel or raises; on a CPU
tensor it runs the plain version
:func:`repro_torch.kernels.ref.paged_attention_ref`.
``paged_attention.launches`` counts calls that launched the kernel (one
a call, the combine pass included).
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import meta as _meta
from repro_torch.kernels.ref import paged_attention_ref
from repro_torch.kernels.zero_stall_matmul import H100_SMS, sms_of

__all__ = ["paged_attention", "paged_splits", "paged_stages", "paged_rows",
           "smem_bytes", "plan_launch", "launch_geometry", "SMEM_LIMIT",
           "MAX_ROW_BYTES"]

# grid_rank counts the axes of the CUDA launch grid of the split pass:
# (B * KV * row chunks, page splits); the page walk runs inside a block
_meta.register_family("paged_attention", grid_rank=2, managed_dma=False,
                      sequential_axes="last")

SMEM_LIMIT = 232448
MAX_ROW_BYTES = 1024         # a head's row: at most two 16-byte vectors a lane
_WARPS = 4                   # warps of a block
_LANE_FLOATS = 64            # q (or accumulator) floats a lane may hold
# q, k_pool, v_pool, o, page_table, kv_lens, workspace, B, KV, T, ps, D,
# rep, rows, splits, per, stages, scale, bf16, stream
_ARGTYPES = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 10 \
    + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]


def paged_splits(B: int, KV: int, T: int, sms: int) -> tuple[int, int]:
    """(splits, pages a split) of the page axis: about two blocks an SM
    over the B * KV rows, at most one split a page, none empty of table
    pages.  It reads no ``kv_lens``: a split past a row's length is
    skipped on the card."""
    if T <= 0:
        return 1, 1
    want = max(1, min(T, -(-2 * sms // max(1, B * KV))))
    per = -(-T // want)
    return -(-T // per), per


def paged_rows(rep: int, D: int, elt: int) -> int:
    """Query rows a block holds (1, 2, 4 or 8): all ``rep`` rows of a kv
    head up to 8, fewer when a lane's share of q would pass 64 floats
    (rep > 8 takes several blocks a kv head)."""
    vec = 16 // elt
    lane = -(-(D * elt // 16) // 32) * vec     # floats of a row a lane
    rows = 1
    while rows < min(rep, 8) and 2 * rows * lane <= _LANE_FLOATS:
        rows *= 2
    return rows


def smem_bytes(D: int, ps: int, rep: int, elt: int, stages: int = 2) -> int:
    """Shared memory of one block (the same formula as the CUDA source):
    a ring of ``stages`` K and V pages, or, if larger, the four warps'
    fp32 (acc, m, l) of the block's query rows, which the merge writes
    over the ring; then room for four 8-byte mbarriers."""
    ring = stages * 2 * ps * D * elt
    merge = _WARPS * paged_rows(rep, D, elt) * (D + 2) * 4
    return max(ring, merge) + 32


def paged_stages(per: int, D: int, ps: int, rep: int, elt: int) -> int:
    """Pages of the ring: two windows of W pages, W = 2 (a window's keys
    in one pass) unless a split has one page or shared memory runs out,
    then W = 1."""
    if per >= 2 and smem_bytes(D, ps, rep, elt, 4) <= SMEM_LIMIT:
        return 4
    return 2


def plan_launch(B: int, KV: int, T: int, rep: int, D: int, ps: int, *,
                elt: int, sms: int) -> tuple[int, int, int, int]:
    """(splits, per, rows, stages) of :func:`paged_attention` over a
    (B, T) page table of ``ps``-token pages, ``elt``-byte elements:
    :func:`paged_splits` over ``sms`` SMs, :func:`paged_rows` query rows
    a block, a ring of :func:`paged_stages` pages.  The wrapper launches
    from these integers and :func:`launch_geometry` records them."""
    splits, per = paged_splits(B, KV, T, sms)
    return (splits, per, paged_rows(rep, D, elt),
            paged_stages(per, D, ps, rep, elt))


def launch_geometry(B: int, H: int, D: int, KV: int, T: int, ps: int, *,
                    elt: int, sms: int = H100_SMS) -> _meta.Launch:
    """The launch of :func:`paged_attention` at :func:`plan_launch`'s
    geometry: ``row_chunks`` blocks a kv head, the split pass's grid
    (B * KV * row_chunks, splits), and the combine pass folding the
    splits in ``reduce_order``.  Params: ``B, H, D, KV, T, ps, rep, rows,
    row_chunks, splits, per, stages, reduce_order``."""
    rep = H // KV
    splits, per, rows, stages = plan_launch(B, KV, T, rep, D, ps, elt=elt,
                                            sms=sms)
    chunks = -(-rep // rows)
    return _meta.Launch(
        name=_meta.kernel_name("paged_attention"), design="split_kv",
        grid=(B * KV * chunks, splits),
        params=dict(B=B, H=H, D=D, KV=KV, T=T, ps=ps, rep=rep, rows=rows,
                    row_chunks=chunks, splits=splits, per=per,
                    stages=stages, reduce_order=tuple(range(splits))))


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
    if D * elt > MAX_ROW_BYTES:
        raise ValueError(f"paged_attention: head dim {D} x {elt} bytes is "
                         f"over the {MAX_ROW_BYTES} bytes a row the kernel "
                         f"keeps in registers")
    need = smem_bytes(D, ps, rep, elt)
    if need > SMEM_LIMIT:
        raise ValueError(
            f"paged_attention: page size {ps} at head dim {D} and {rep} "
            f"query heads per kv head needs {need} bytes of shared memory, "
            f"over the {SMEM_LIMIT} a Hopper block can have")
    o = torch.empty_like(q)
    if B == 0:
        return o
    sms = sms_of(dev)
    splits, per, rows, stages = plan_launch(B, KV, T, rep, D, ps, elt=elt,
                                            sms=sms)
    ws = (torch.empty(B * KV * splits * rep * (D + 2), dtype=torch.float32,
                      device=dev) if splits > 1 else None)
    _meta.note(lambda: launch_geometry(B, H, D, KV, T, ps, elt=elt, sms=sms),
               lens={"kv_lens": kv_lens},
               ins=(("q", q), ("k_pool", k_pool), ("v_pool", v_pool),
                    ("page_table", page_table), ("kv_lens", kv_lens)),
               outs=(("o", o),), ws=(("ws", ws),))
    fn = _build.bind("paged_attention", _ARGTYPES)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with _build.on_device(dev):
        code = fn(q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
                  o.data_ptr(), page_table.data_ptr(), kv_lens.data_ptr(),
                  None if ws is None else ws.data_ptr(), B, KV, T, ps, D,
                  rep, rows, splits, per, stages, float(scale),
                  int(q.dtype == torch.bfloat16), stream)
    _build.check("paged_attention", code)
    paged_attention.launches += 1
    return o


paged_attention.launches = 0
