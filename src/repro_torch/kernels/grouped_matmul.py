"""Grouped zero-stall matmul: the wrapper of ``csrc/zero_stall_matmul.cu``
launched over G groups.

C_g = A_g @ B_g for every group g (the MoE expert FFNs) through the
N-slot revolving buffer of ``csrc/zero_stall_ring.cuh``, one grid axis
over the groups (see the header notes of the CUDA sources for the
schedule, its bound on the H100 and what the design does about it).
Replaces the Pallas TPU kernel
``repro.kernels.grouped_matmul.grouped_zero_stall_matmul``.

On a CUDA tensor the wrapper launches the kernel or raises; on a CPU
tensor it runs the plain version
:func:`repro_torch.kernels.ref.grouped_matmul_ref`.  Ragged shapes are
masked inside the kernel, so no operand is padded.
``grouped_zero_stall_matmul.launches`` counts kernel launches.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import grouped_matmul_ref
from repro_torch.kernels.zero_stall_matmul import (_ARGTYPES, _check_config,
                                                   _vec_ok)
from repro_torch.plan.config import resolve_slots

__all__ = ["grouped_zero_stall_matmul", "MAX_GROUPS"]

MAX_GROUPS = 65535           # gridDim.y
_DTYPES = (torch.float32, torch.bfloat16)


def grouped_zero_stall_matmul(a: torch.Tensor, b: torch.Tensor, *,
                              bm: int = 128, bn: int = 128, bk: int = 128,
                              variant: str = "dobu",
                              slots: int | None = None,
                              out_dtype: torch.dtype | None = None
                              ) -> torch.Tensor:
    """C (G, M, N) = A (G, M, K) @ B (G, K, N) per group.

    ``slots`` sets the ring depth (None -> 2 for "dobu", 1 for
    "single").  The result has ``out_dtype`` (default: A's).
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
    _check_config(bm, bn, bk, slots, a.dtype, False,
                  "grouped_zero_stall_matmul")
    c = torch.empty((G, M, N), dtype=out_dtype, device=a.device)
    if c.numel() == 0:
        return c
    if K == 0:
        return c.zero_()
    fn = _build.bind("zero_stall_matmul", _ARGTYPES)
    stream = torch.cuda.current_stream(a.device).cuda_stream
    with _build.on_device(a.device):
        code = fn(a.data_ptr(), b.data_ptr(), c.data_ptr(), G, M, N, K, bm,
                  bn, bk, slots, 0, int(a.dtype == torch.bfloat16),
                  int(out_dtype == torch.float32), 0,
                  int(_vec_ok(a, b, K, N, False)), stream)
    _build.check("zero_stall_matmul", code)
    grouped_zero_stall_matmul.launches += 1
    return c


grouped_zero_stall_matmul.launches = 0
