"""Grouped zero-stall matmul: C_g = A_g @ B_g for G groups (the MoE
expert FFNs).  Replaces the Pallas TPU kernel
``repro.kernels.grouped_matmul.grouped_zero_stall_matmul``.

The design follows the rule of
:func:`~repro_torch.kernels.zero_stall_matmul.select_design`:

- ``"sm90"`` (``csrc/zero_stall_sm90.cu``): bf16 operands whose rows TMA
  can address (K % 8 == 0, N % 8 == 0, 16-byte aligned bases).  The TMA
  + wgmma ring of the plain product with rank-3 tensor maps over (G,
  rows, columns), launched persistent: :func:`grouped_blocks` blocks
  (about one per SM) each walk the output tiles ``b, b + blocks, ...`` of
  the g-major (g, i, j) order (:func:`grouped_walk`) and run one ring
  across their tiles and experts, so the ring never drains between
  tiles, as the Pallas kernel's ring runs across group boundaries.
- ``"ring"`` (``csrc/zero_stall_matmul.cu`` over
  ``zero_stall_ring.cuh``): fp32 and ragged bf16, one cp.async ring a
  block, one grid axis over the groups.

On a CUDA tensor the wrapper launches its design's kernel or raises; on
a CPU tensor it runs the plain version
:func:`repro_torch.kernels.ref.grouped_matmul_ref`.  Ragged shapes are
masked inside the kernels, so no operand is padded.
``grouped_zero_stall_matmul.launches`` counts kernel launches and
``.launches_by_design`` splits them by design.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import meta as _meta
from repro_torch.kernels.ref import grouped_matmul_ref
from repro_torch.kernels.zero_stall_matmul import (H100_SMS, _ARGTYPES,
                                                   _check_config,
                                                   _check_sm90_config,
                                                   _vec_ok, matmul_launch,
                                                   select_design, sm90_rows,
                                                   sms_of)
from repro_torch.plan.config import resolve_slots

__all__ = ["grouped_zero_stall_matmul", "grouped_blocks", "grouped_walk",
           "plan_launch", "launch_geometry", "MAX_GROUPS"]

# grid_rank counts the axes of the CUDA launch grid: (persistent blocks,
# 1) on the sm90 design, (a group's output tiles, groups) on the ring
_meta.register_family("grouped_zero_stall_matmul", grid_rank=2,
                      managed_dma=True, sequential_axes="all")

MAX_GROUPS = 65535           # gridDim.y of the ring's launch
_DTYPES = (torch.float32, torch.bfloat16)
# a, b, c, G, M, N, K, rows, bn, bk, slots, fp32 out, blocks, stream
_SM90_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 10 \
    + [ctypes.c_void_p]


def grouped_blocks(G: int, M: int, N: int, rows: int, bn: int,
                   sms: int) -> int:
    """Blocks of the persistent sm90 launch: one per SM, or one per
    output tile when the G * ceil(M / rows) * ceil(N / bn) tiles are
    fewer."""
    return max(1, min(sms, G * -(-M // rows) * -(-N // bn)))


def grouped_walk(G: int, M: int, N: int, rows: int, bn: int,
                 sms: int) -> list[list[tuple[int, int, int]]]:
    """The output tiles (g, i, j) that each block of the persistent sm90
    launch walks, in order: block b takes tiles b, b + blocks, ... of
    the g-major, then i, then j order, as the kernel's ``locate`` does."""
    gm, gn = -(-M // rows), -(-N // bn)
    blocks = grouped_blocks(G, M, N, rows, bn, sms)
    return [[(t // (gm * gn), t % (gm * gn) // gn, t % gn)
             for t in range(b, G * gm * gn, blocks)] for b in range(blocks)]


def plan_launch(G: int, M: int, N: int, *, dtype: torch.dtype, K: int,
                bm: int, bn: int, trans_b: bool, sms: int, a_ptr: int = 0,
                b_ptr: int = 0) -> tuple[str, int, int]:
    """(design, rows, blocks) of a grouped product: on the sm90 design
    :func:`grouped_blocks` persistent blocks over ``sms`` SMs, each
    walking its tiles with one ring (no split); on the ring design one
    block a tile and group.  The wrappers launch from these integers and
    :func:`launch_geometry` records them."""
    design = select_design(dtype, K, N, trans_b, a_ptr, b_ptr)
    if design == "sm90":
        rows = sm90_rows(M, bm)
        return design, rows, grouped_blocks(G, M, N, rows, bn, sms)
    return design, bm, G * -(-M // bm) * -(-N // bn)


def grouped_launch(family: str, design: str, *, G: int, M: int, N: int,
                   K: int, rows: int, bn: int, bk: int, slots: int,
                   blocks: int) -> _meta.Launch:
    """The :class:`~repro_torch.kernels.meta.Launch` of a grouped product
    (see :func:`~repro_torch.kernels.zero_stall_matmul.matmul_launch`
    for the params)."""
    return matmul_launch(family, design, G=G, M=M, N=N, K=K, rows=rows,
                         bn=bn, bk=bk, slots=slots, grid_order=None,
                         splits=1, per=max(1, -(-K // bk)), blocks=blocks)


def launch_geometry(G: int, M: int, N: int, K: int, *, dtype: torch.dtype,
                    bm: int = 128, bn: int = 128, bk: int = 128,
                    variant: str = "dobu", slots: int | None = None,
                    trans_b: bool = False, sms: int = H100_SMS,
                    a_ptr: int = 0, b_ptr: int = 0,
                    family: str = "grouped_zero_stall_matmul"
                    ) -> _meta.Launch:
    """The launch of a grouped product, bf16/fp32 or (``family``
    ``"quantized_grouped_zero_stall_matmul"``, ``trans_b``) int8, at
    :func:`plan_launch`'s geometry."""
    design, rows, blocks = plan_launch(G, M, N, dtype=dtype, K=K, bm=bm,
                                       bn=bn, trans_b=trans_b, sms=sms,
                                       a_ptr=a_ptr, b_ptr=b_ptr)
    return grouped_launch(family, design, G=G, M=M, N=N, K=K, rows=rows,
                          bn=bn, bk=bk, slots=resolve_slots(variant, slots),
                          blocks=blocks)


def grouped_zero_stall_matmul(a: torch.Tensor, b: torch.Tensor, *,
                              bm: int = 128, bn: int = 128, bk: int = 128,
                              variant: str = "dobu",
                              slots: int | None = None,
                              out_dtype: torch.dtype | None = None
                              ) -> torch.Tensor:
    """C (G, M, N) = A (G, M, K) @ B (G, K, N) per group.

    ``slots`` sets the ring depth (None -> 2 for "dobu", 1 for
    "single").  The result has ``out_dtype`` (default: A's).  The design
    follows :func:`~repro_torch.kernels.zero_stall_matmul.select_design`;
    tiles that design cannot take raise ``ValueError``.
    """
    if a.dim() != 3 or b.dim() != 3:
        raise ValueError(f"grouped_zero_stall_matmul: 3-D operands expected, "
                         f"got {tuple(a.shape)} and {tuple(b.shape)}")
    G, M, K = a.shape
    G2, K2, N = b.shape
    if G != G2 or K != K2:
        raise ValueError(f"group/contraction mismatch: {tuple(a.shape)} @ "
                         f"{tuple(b.shape)}")
    if a.dtype not in _DTYPES or b.dtype != a.dtype:
        raise ValueError(f"grouped_zero_stall_matmul: inputs must both be "
                         f"fp32 or both bf16, got {a.dtype} and {b.dtype}")
    out_dtype = out_dtype or a.dtype
    if out_dtype not in _DTYPES:
        raise ValueError(f"grouped_zero_stall_matmul: out_dtype must be fp32 "
                         f"or bf16, got {out_dtype}")
    slots = resolve_slots(variant, slots)
    if a.device.type == "cpu" and b.device.type == "cpu":
        return grouped_matmul_ref(a, b, out_dtype)
    if a.device.type != "cuda" or b.device != a.device:
        raise ValueError(f"grouped_zero_stall_matmul: operands on {a.device} "
                         f"and {b.device}; the kernel needs both on one CUDA "
                         f"device")
    if not (a.is_contiguous() and b.is_contiguous()):
        raise ValueError("grouped_zero_stall_matmul: operands must be "
                         "contiguous")
    if G > MAX_GROUPS or max(M * K, K * N, M * N) >= 2 ** 31:
        raise ValueError(f"grouped_zero_stall_matmul: at most {MAX_GROUPS} "
                         f"groups of int32-indexable size, got "
                         f"{(G, M, K, N)}")
    kind, rows, blocks = plan_launch(G, M, N, dtype=a.dtype, K=K, bm=bm,
                                     bn=bn, trans_b=False,
                                     sms=sms_of(a.device),
                                     a_ptr=a.data_ptr(), b_ptr=b.data_ptr())
    if kind == "sm90":
        _check_sm90_config(M, bm, bn, bk, slots,
                           kernel="grouped_zero_stall_matmul")
    else:
        _check_config(bm, bn, bk, slots, a.dtype, False,
                      "grouped_zero_stall_matmul")
    c = torch.empty((G, M, N), dtype=out_dtype, device=a.device)
    if c.numel() == 0:
        return c
    if K == 0:
        return c.zero_()
    stream = torch.cuda.current_stream(a.device).cuda_stream
    out_f32 = int(out_dtype == torch.float32)
    _meta.note(lambda: grouped_launch(
        "grouped_zero_stall_matmul", kind, G=G, M=M, N=N, K=K, rows=rows,
        bn=bn, bk=bk, slots=slots, blocks=blocks),
        ins=(("a", a), ("b", b)), outs=(("c", c),))
    if kind == "sm90":
        fn = _build.bind("grouped_zero_stall_matmul_sm90", _SM90_ARGTYPES,
                         "zero_stall_sm90")
        with _build.on_device(a.device):
            code = fn(a.data_ptr(), b.data_ptr(), c.data_ptr(), G, M, N, K,
                      rows, bn, bk, slots, out_f32, blocks, stream)
        _build.check("zero_stall_sm90", code)
    else:
        fn = _build.bind("zero_stall_matmul", _ARGTYPES)
        with _build.on_device(a.device):
            code = fn(a.data_ptr(), b.data_ptr(), c.data_ptr(), G, M, N, K,
                      bm, bn, bk, slots, 0, int(a.dtype == torch.bfloat16),
                      out_f32, 0, int(_vec_ok(a, b, K, N, False)), stream)
        _build.check("zero_stall_matmul", code)
    grouped_zero_stall_matmul.launches += 1
    grouped_zero_stall_matmul.launches_by_design[kind] += 1
    return c


grouped_zero_stall_matmul.launches = 0
grouped_zero_stall_matmul.launches_by_design = {"sm90": 0, "ring": 0}
