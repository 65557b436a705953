"""Int8 zero-stall matmuls: the wrappers of the int8 kernels.

``quantized_zero_stall_matmul`` computes C = (A_q @ B_q) * a_scale *
b_scale for int8 codes with an exact int32 accumulator and a fused
dequantising epilogue; ``quantized_grouped_zero_stall_matmul`` does the
same per group (the W8A8 MoE expert FFNs).  They replace the Pallas TPU
kernels of ``repro.kernels.quantized_matmul``.

Both pick their design by the rule of
:func:`~repro_torch.kernels.zero_stall_matmul.select_design`: codes whose
rows TMA can address (K % 16 == 0, 16-byte aligned bases) run
``"sm90"``, the TMA + wgmma ring of ``csrc/quantized_sm90.cu`` (int8
wgmma with swap AB; int32 split-k for one product, see
:func:`split_plan`; the persistent walk of
:func:`~repro_torch.kernels.grouped_matmul.grouped_blocks` blocks over
the experts' tiles for the grouped one); other shapes run ``"ring"``,
the cp.async ring of ``csrc/quantized_matmul.cu``.  The choice is made
by shape: a failed build or launch raises.  The header notes of the
CUDA sources give each schedule, its bound on the H100 and what the
design does about it.

B is given with the JAX package's logical (..., K, N) shape, but on the
card it must be the transposed view of a contiguous (..., N, K) buffer
(``b.mT.is_contiguous()``), the K-major layout the port's
:class:`~repro_torch.quant.QTensor` stores: int8 wgmma and the int8
tensor-core fragments of the ring read K-major operands only.  On a CPU
tensor the wrappers run the plain versions in
:mod:`repro_torch.kernels.ref`, which take any layout.  ``.launches`` on
each wrapper counts kernel launches, and ``.launches_by_design`` splits
them by design.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import grouped_matmul as _grouped
from repro_torch.kernels import meta as _meta
from repro_torch.kernels import zero_stall_matmul as _zs
from repro_torch.kernels.grouped_matmul import MAX_GROUPS
from repro_torch.kernels.ref import (quantized_grouped_matmul_ref,
                                     quantized_matmul_ref)
from repro_torch.kernels.zero_stall_matmul import (_check_config,
                                                   _check_sm90_config,
                                                   _vec_ok, sms_of)
from repro_torch.plan.config import resolve_slots

__all__ = ["quantized_zero_stall_matmul",
           "quantized_grouped_zero_stall_matmul", "launch_geometry",
           "grouped_launch_geometry"]

# grid_rank counts the axes of the CUDA launch grid, as for the bf16
# products: (output tiles, k splits) or (persistent blocks, 1) on sm90,
# (a group's output tiles, groups) on the ring
_meta.register_family("quantized_zero_stall_matmul", grid_rank=2,
                      managed_dma=True, sequential_axes="all")
_meta.register_family("quantized_grouped_zero_stall_matmul", grid_rank=2,
                      managed_dma=True, sequential_axes="all")


def launch_geometry(M: int, N: int, K: int, **kw) -> _meta.Launch:
    """The launch of :func:`quantized_zero_stall_matmul`: the plain
    product's geometry
    (:func:`~repro_torch.kernels.zero_stall_matmul.launch_geometry`) on
    K-major int8 codes; ``kw`` as there, less the dtype."""
    return _zs.launch_geometry(M, N, K, dtype=torch.int8, trans_b=True,
                               family="quantized_zero_stall_matmul", **kw)


def grouped_launch_geometry(G: int, M: int, N: int, K: int,
                            **kw) -> _meta.Launch:
    """The launch of :func:`quantized_grouped_zero_stall_matmul`: the
    grouped product's geometry
    (:func:`~repro_torch.kernels.grouped_matmul.launch_geometry`) on
    K-major int8 codes."""
    return _grouped.launch_geometry(
        G, M, N, K, dtype=torch.int8, trans_b=True,
        family="quantized_grouped_zero_stall_matmul", **kw)

_OUT_DTYPES = (torch.float32, torch.bfloat16)
# a, b, a_scale, b_scale, c, then ten ints (M, N, K, bm, bn, bk, slots,
# jik, fp32 out, vec; grouped: G, M, N, K, bm, bn, bk, slots, fp32 out,
# vec), then the stream
_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 10 + [ctypes.c_void_p]
# a, b, a_scale, b_scale, c, workspace, M, N, K, rows, bn, bk, slots, jik,
# fp32 out, splits, steps per split, stream
_SM90_ARGTYPES = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 11 \
    + [ctypes.c_void_p]
# a, b, a_scale, b_scale, c, G, M, N, K, rows, bn, bk, slots, fp32 out,
# blocks, stream
_GROUPED_SM90_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 10 \
    + [ctypes.c_void_p]


def _check_operands(kernel: str, a, b, a_scale, b_scale, out_dtype):
    """Shapes and dtypes of (…, M, K) @ (…, K, N) int8 codes with (…, M, 1)
    and (…, 1, N) fp32 scales; returns (lead, M, K, N)."""
    lead, (M, K) = tuple(a.shape[:-2]), a.shape[-2:]
    K2, N = b.shape[-2:]
    if tuple(b.shape[:-2]) != lead or K != K2:
        raise ValueError(f"{kernel}: group/contraction mismatch: "
                         f"{tuple(a.shape)} @ {tuple(b.shape)}")
    if a.dtype != torch.int8 or b.dtype != torch.int8:
        raise ValueError(f"{kernel}: operands must be int8, got {a.dtype} "
                         f"and {b.dtype}")
    if (tuple(a_scale.shape) != lead + (M, 1)
            or tuple(b_scale.shape) != lead + (1, N)):
        raise ValueError(f"{kernel}: scale shapes {tuple(a_scale.shape)} and "
                         f"{tuple(b_scale.shape)} must be {lead + (M, 1)} "
                         f"and {lead + (1, N)}")
    if a_scale.dtype != torch.float32 or b_scale.dtype != torch.float32:
        raise ValueError(f"{kernel}: scales must be fp32, got "
                         f"{a_scale.dtype} and {b_scale.dtype}")
    if out_dtype not in _OUT_DTYPES:
        raise ValueError(f"{kernel}: out_dtype must be fp32 or bf16, got "
                         f"{out_dtype}")
    return lead, M, K, N


def _check_card(kernel: str, a, b, a_scale, b_scale) -> None:
    """What the kernel needs beyond the math: one CUDA device, contiguous
    A and scales, K-major B."""
    ops = (a, b, a_scale, b_scale)
    if a.device.type != "cuda" or any(t.device != a.device for t in ops):
        raise ValueError(f"{kernel}: operands on "
                         f"{sorted({str(t.device) for t in ops})}; the kernel "
                         f"needs all on one CUDA device")
    if not (a.is_contiguous() and a_scale.is_contiguous()
            and b_scale.is_contiguous()):
        raise ValueError(f"{kernel}: A and the scales must be contiguous")
    if not b.mT.is_contiguous():
        raise ValueError(f"{kernel}: B must be K-major, the transposed view "
                         f"of a contiguous (..., N, K) buffer (as QTensor "
                         f"stores its codes)")


def quantized_zero_stall_matmul(a: torch.Tensor, b: torch.Tensor,
                                a_scale: torch.Tensor, b_scale: torch.Tensor,
                                *, bm: int = 128, bn: int = 128,
                                bk: int = 128, variant: str = "dobu",
                                slots: int | None = None,
                                grid_order: str = "ijk",
                                out_dtype: torch.dtype = torch.float32
                                ) -> torch.Tensor:
    """C = (a @ b) * a_scale * b_scale with the zero-stall schedule.

    a: (M, K) int8 codes; b: (K, N) int8 codes (K-major on the card);
    a_scale (M, 1) and b_scale (1, N) fp32.  ``slots``/``variant`` set the
    ring depth, ``grid_order`` the rasterisation ("ijk" or "jik").  The
    design follows :func:`~repro_torch.kernels.zero_stall_matmul.select_design`;
    tiles that design cannot take raise ``ValueError``.
    """
    kernel = "quantized_zero_stall_matmul"
    if a.dim() != 2 or b.dim() != 2:
        raise ValueError(f"{kernel}: 2-D operands expected, got "
                         f"{tuple(a.shape)} and {tuple(b.shape)}")
    _, M, K, N = _check_operands(kernel, a, b, a_scale, b_scale, out_dtype)
    if grid_order not in ("ijk", "jik"):
        raise ValueError(f"grid_order must be 'ijk' or 'jik', "
                         f"got {grid_order!r}")
    slots = resolve_slots(variant, slots)
    if all(t.device.type == "cpu" for t in (a, b, a_scale, b_scale)):
        return quantized_matmul_ref(a, b, a_scale, b_scale, out_dtype)
    _check_card(kernel, a, b, a_scale, b_scale)
    if max(M, N, K) >= 2 ** 31:
        raise ValueError(f"{kernel}: dimensions must fit in int32")
    kind, rows, splits, per = _zs.plan_launch(
        M, N, K, dtype=torch.int8, bm=bm, bn=bn, bk=bk, trans_b=True,
        sms=sms_of(a.device), a_ptr=a.data_ptr(), b_ptr=b.data_ptr())
    if kind == "sm90":
        _check_sm90_config(M, bm, bn, bk, slots, torch.int8, kernel)
    else:
        _check_config(bm, bn, bk, slots, torch.int8, True, kernel)
    c = torch.empty((M, N), dtype=out_dtype, device=a.device)
    if M == 0 or N == 0:
        return c
    if K == 0:
        return c.zero_()
    stream = torch.cuda.current_stream(a.device).cuda_stream
    jik, out_f32 = int(grid_order == "jik"), int(out_dtype == torch.float32)
    ws = (torch.empty((splits, M, N), dtype=torch.int32, device=a.device)
          if splits > 1 else None)
    _meta.note(lambda: _zs.matmul_launch(
        kernel, kind, G=1, M=M, N=N, K=K, rows=rows, bn=bn, bk=bk,
        slots=slots, grid_order=grid_order, splits=splits, per=per,
        blocks=-(-M // rows) * -(-N // bn)),
        ins=(("a", a), ("b", b), ("a_scale", a_scale), ("b_scale", b_scale)),
        outs=(("c", c),), ws=(("ws", ws),))
    if kind == "sm90":
        fn = _build.bind("quantized_zero_stall_matmul_sm90", _SM90_ARGTYPES,
                         "quantized_sm90")
        with _build.on_device(a.device):
            code = fn(a.data_ptr(), b.data_ptr(), a_scale.data_ptr(),
                      b_scale.data_ptr(), c.data_ptr(),
                      None if ws is None else ws.data_ptr(), M, N, K,
                      rows, bn, bk, slots, jik, out_f32, splits, per,
                      stream)
        _build.check("quantized_sm90", code)
    else:
        fn = _build.bind(kernel, _ARGTYPES, source="quantized_matmul")
        with _build.on_device(a.device):
            code = fn(a.data_ptr(), b.data_ptr(), a_scale.data_ptr(),
                      b_scale.data_ptr(), c.data_ptr(), M, N, K, bm, bn, bk,
                      slots, jik, out_f32, int(_vec_ok(a, b, K, N, True)),
                      stream)
        _build.check("quantized_matmul", code)
    quantized_zero_stall_matmul.launches += 1
    quantized_zero_stall_matmul.launches_by_design[kind] += 1
    return c


def quantized_grouped_zero_stall_matmul(a: torch.Tensor, b: torch.Tensor,
                                        a_scale: torch.Tensor,
                                        b_scale: torch.Tensor, *,
                                        bm: int = 128, bn: int = 128,
                                        bk: int = 128, variant: str = "dobu",
                                        slots: int | None = None,
                                        out_dtype: torch.dtype = torch.float32
                                        ) -> torch.Tensor:
    """Per-group int8 matmul: a (G, M, K), b (G, K, N) int8 codes (K-major
    on the card), a_scale (G, M, 1), b_scale (G, 1, N) fp32 ->
    (G, M, N).  The design follows
    :func:`~repro_torch.kernels.zero_stall_matmul.select_design`; tiles
    that design cannot take raise ``ValueError``."""
    kernel = "quantized_grouped_zero_stall_matmul"
    if a.dim() != 3 or b.dim() != 3:
        raise ValueError(f"{kernel}: 3-D operands expected, got "
                         f"{tuple(a.shape)} and {tuple(b.shape)}")
    (G,), M, K, N = _check_operands(kernel, a, b, a_scale, b_scale,
                                    out_dtype)
    slots = resolve_slots(variant, slots)
    if all(t.device.type == "cpu" for t in (a, b, a_scale, b_scale)):
        return quantized_grouped_matmul_ref(a, b, a_scale, b_scale,
                                            out_dtype)
    _check_card(kernel, a, b, a_scale, b_scale)
    if G > MAX_GROUPS or max(M * K, K * N, M * N) >= 2 ** 31:
        raise ValueError(f"{kernel}: at most {MAX_GROUPS} groups of "
                         f"int32-indexable size, got {(G, M, K, N)}")
    kind, rows, blocks = _grouped.plan_launch(
        G, M, N, dtype=torch.int8, K=K, bm=bm, bn=bn, trans_b=True,
        sms=sms_of(a.device), a_ptr=a.data_ptr(), b_ptr=b.data_ptr())
    if kind == "sm90":
        _check_sm90_config(M, bm, bn, bk, slots, torch.int8, kernel)
    else:
        _check_config(bm, bn, bk, slots, torch.int8, True, kernel)
    c = torch.empty((G, M, N), dtype=out_dtype, device=a.device)
    if c.numel() == 0:
        return c
    if K == 0:
        return c.zero_()
    stream = torch.cuda.current_stream(a.device).cuda_stream
    out_f32 = int(out_dtype == torch.float32)
    _meta.note(lambda: _grouped.grouped_launch(
        kernel, kind, G=G, M=M, N=N, K=K, rows=rows, bn=bn, bk=bk,
        slots=slots, blocks=blocks),
        ins=(("a", a), ("b", b), ("a_scale", a_scale), ("b_scale", b_scale)),
        outs=(("c", c),))
    if kind == "sm90":
        fn = _build.bind("quantized_grouped_zero_stall_matmul_sm90",
                         _GROUPED_SM90_ARGTYPES, "quantized_sm90")
        with _build.on_device(a.device):
            code = fn(a.data_ptr(), b.data_ptr(), a_scale.data_ptr(),
                      b_scale.data_ptr(), c.data_ptr(), G, M, N, K,
                      rows, bn, bk, slots, out_f32, blocks, stream)
        _build.check("quantized_sm90", code)
    else:
        fn = _build.bind(kernel, _ARGTYPES, source="quantized_matmul")
        with _build.on_device(a.device):
            code = fn(a.data_ptr(), b.data_ptr(), a_scale.data_ptr(),
                      b_scale.data_ptr(), c.data_ptr(), G, M, N, K, bm, bn,
                      bk, slots, out_f32, int(_vec_ok(a, b, K, N, True)),
                      stream)
        _build.check("quantized_matmul", code)
    quantized_grouped_zero_stall_matmul.launches += 1
    quantized_grouped_zero_stall_matmul.launches_by_design[kind] += 1
    return c


quantized_zero_stall_matmul.launches = 0
quantized_zero_stall_matmul.launches_by_design = {"sm90": 0, "ring": 0}
quantized_grouped_zero_stall_matmul.launches = 0
quantized_grouped_zero_stall_matmul.launches_by_design = {"sm90": 0,
                                                          "ring": 0}
