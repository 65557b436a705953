"""Zero-stall matmul: the wrapper of ``csrc/zero_stall_matmul.cu`` (G = 1).

C = A @ B through the N-slot shared-memory revolving buffer (see the
header notes of the CUDA sources for the schedule, its bound on the H100
and what the design does about it).  Replaces the Pallas TPU kernel
``repro.kernels.zero_stall_matmul.zero_stall_matmul``.

On a CUDA tensor the wrapper launches the kernel or raises; on a CPU
tensor it runs the plain version :func:`repro_torch.kernels.ref.matmul_ref`.
Ragged shapes are masked inside the kernel, so no operand is padded.
``zero_stall_matmul.launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import matmul_ref
from repro_torch.plan.config import resolve_slots

__all__ = ["zero_stall_matmul", "smem_bytes", "SMEM_LIMIT", "MAX_THREADS"]

SMEM_LIMIT = 232448          # bytes of shared memory one Hopper block may use
MAX_THREADS = 512            # the kernel's __launch_bounds__
_IN_DTYPES = (torch.float32, torch.bfloat16)
_OUT_DTYPES = (torch.float32, torch.bfloat16)
# a, b, c, G, M, N, K, bm, bn, bk, slots, jik, bf16, fp32 out, trans_b,
# vec, stream: the C entry shared with the grouped wrapper
_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 13 + [ctypes.c_void_p]


def smem_bytes(bm: int, bn: int, bk: int, slots: int, dtype: torch.dtype,
               trans_b: bool = False) -> int:
    """Shared memory of one block: ``slots`` (A, B) tile pairs of
    ``dtype`` elements, each row padded by 16 bytes (the same formula as
    ``csrc/zero_stall_ring.cuh``)."""
    size = torch.empty((), dtype=dtype).element_size()
    pad = 16 // size
    a = bm * (bk + pad)
    b = bn * (bk + pad) if trans_b else bk * (bn + pad)
    return slots * (a + b) * size


def _threads(bm: int, bn: int, dtype: torch.dtype) -> int:
    if dtype == torch.float32:
        return (bm // 8) * (bn // 8)
    return (bm // 32) * (bn // 32) * 32


def _check_config(bm, bn, bk, slots, dtype, trans_b,
                  kernel: str = "zero_stall_matmul") -> None:
    """Raise on tiles the ring kernel of ``dtype`` cannot take: the
    tensor-core types (bf16, int8) need 32 x 32 warp tiles and a k tile of
    whole 32-byte mma steps; every tile must fit the thread and
    shared-memory limits of a Hopper block."""
    if dtype == torch.float32:
        if bm % 8 or bn % 8 or bk % 4:
            raise ValueError(
                f"{kernel} (fp32): tiles must have bm, bn multiples of 8 "
                f"and bk a multiple of 4, got {(bm, bn, bk)}")
    else:
        kstep = 32 // torch.empty((), dtype=dtype).element_size()
        if bm % 32 or bn % 32 or bk % kstep:
            raise ValueError(
                f"{kernel} ({str(dtype).removeprefix('torch.')}): tiles must "
                f"have bm, bn multiples of 32 and bk a multiple of {kstep}, "
                f"got {(bm, bn, bk)}")
    threads = _threads(bm, bn, dtype)
    if threads > MAX_THREADS:
        raise ValueError(
            f"{kernel}: tile {bm}x{bn} needs {threads} threads, "
            f"more than the kernel's {MAX_THREADS}")
    need = smem_bytes(bm, bn, bk, slots, dtype, trans_b)
    if need > SMEM_LIMIT:
        raise ValueError(
            f"{kernel}: tiles {(bm, bn, bk)} at slots={slots} in "
            f"{dtype} need {need} bytes of shared memory, over the "
            f"{SMEM_LIMIT} a Hopper block can have (lower bk or slots)")


def _vec_ok(a: torch.Tensor, b: torch.Tensor, K: int, N: int,
            trans_b: bool) -> bool:
    """Whether the 16-byte cp.async loader may read A and B (and, for a
    grouped product, every group's slice of them)."""
    v = 16 // a.element_size()
    aligned = a.data_ptr() % 16 == 0 and b.data_ptr() % 16 == 0
    return aligned and K % v == 0 and (trans_b or N % v == 0)


def zero_stall_matmul(a: torch.Tensor, b: torch.Tensor, *, bm: int = 128,
                      bn: int = 128, bk: int = 128, variant: str = "dobu",
                      slots: int | None = None, grid_order: str = "ijk",
                      out_dtype: torch.dtype | None = None,
                      trans_b: bool = False) -> torch.Tensor:
    """C = A @ B with the zero-stall tile schedule.

    A: (M, K); B: (K, N), or (N, K) with ``trans_b`` (then C = A @ B.T).
    ``slots`` sets the ring depth (None -> 2 for "dobu", 1 for
    "single"); ``grid_order`` the rasterisation ("ijk" rows outer,
    "jik" columns outer).  The result has ``out_dtype`` (default: A's).
    """
    if a.dim() != 2 or b.dim() != 2:
        raise ValueError(f"zero_stall_matmul: 2-D operands expected, got "
                         f"{tuple(a.shape)} and {tuple(b.shape)}")
    M, K = a.shape
    N, K2 = (b.shape if trans_b else (b.shape[1], b.shape[0]))
    if K != K2:
        raise ValueError(f"contraction mismatch: {tuple(a.shape)} @ "
                         f"{tuple(b.shape)} (trans_b={trans_b})")
    if grid_order not in ("ijk", "jik"):
        raise ValueError(f"grid_order must be 'ijk' or 'jik', "
                         f"got {grid_order!r}")
    slots = resolve_slots(variant, slots)
    out_dtype = out_dtype or a.dtype
    if a.device.type == "cpu" and b.device.type == "cpu":
        return matmul_ref(a, b.t() if trans_b else b, out_dtype)
    if a.device.type != "cuda" or b.device != a.device:
        raise ValueError(f"zero_stall_matmul: operands on {a.device} and "
                         f"{b.device}; the kernel needs both on one CUDA "
                         f"device")
    if a.dtype not in _IN_DTYPES or b.dtype != a.dtype:
        raise ValueError(f"zero_stall_matmul: inputs must both be fp32 or "
                         f"both bf16, got {a.dtype} and {b.dtype}")
    if out_dtype not in _OUT_DTYPES:
        raise ValueError(f"zero_stall_matmul: out_dtype must be fp32 or "
                         f"bf16, got {out_dtype}")
    if not (a.is_contiguous() and b.is_contiguous()):
        raise ValueError("zero_stall_matmul: operands must be contiguous "
                         "row-major (pass trans_b=True for a (N, K) B)")
    if max(M, N, K) >= 2 ** 31:
        raise ValueError("zero_stall_matmul: dimensions must fit in int32")
    _check_config(bm, bn, bk, slots, a.dtype, trans_b)
    c = torch.empty((M, N), dtype=out_dtype, device=a.device)
    if M == 0 or N == 0:
        return c
    if K == 0:
        return c.zero_()
    fn = _build.bind("zero_stall_matmul", _ARGTYPES)
    stream = torch.cuda.current_stream(a.device).cuda_stream
    with _build.on_device(a.device):
        code = fn(a.data_ptr(), b.data_ptr(), c.data_ptr(), 1, M, N, K, bm,
                  bn, bk, slots, int(grid_order == "jik"),
                  int(a.dtype == torch.bfloat16),
                  int(out_dtype == torch.float32), int(trans_b),
                  int(_vec_ok(a, b, K, N, trans_b)), stream)
    _build.check("zero_stall_matmul", code)
    zero_stall_matmul.launches += 1
    return c


zero_stall_matmul.launches = 0
