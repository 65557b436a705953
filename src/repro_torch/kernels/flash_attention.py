"""Masked flash attention: the wrapper of ``csrc/flash_attention.cu``.

(B, H, Sq, D) attention with per-sequence valid lengths and query
offsets, causal masking in absolute positions, an online softmax over
kv tiles and exact zeros for fully-masked rows (see the header note of
the CUDA source for its design and bound).  Replaces the Pallas TPU
kernel ``repro.kernels.flash_attention.flash_attention``.

On a CUDA tensor the wrapper launches the kernel or raises; on a CPU
tensor it runs the plain version
:func:`repro_torch.kernels.ref.flash_attention_ref` with the same
length operands.  Ragged Sq / Skv are masked inside the kernel.
``flash_attention.launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import flash_attention_ref

__all__ = ["flash_attention", "smem_bytes", "SMEM_LIMIT"]

SMEM_LIMIT = 232448
# q, k, v, o, q_lens, kv_lens, q_offsets, B, H, Sq, Skv, D, bq, bkv, scale,
# causal, bf16, stream
_ARGTYPES = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 7 \
    + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]


def smem_bytes(D: int, bq: int, bkv: int) -> int:
    """Shared memory of one block (the same formula as the CUDA source)."""
    ldd = D + 1
    return 4 * (bq * ldd + bkv * ldd + bkv * D + bq * D + bq * bkv + 3 * bq)


def _lens(x: torch.Tensor | None, default: torch.Tensor) -> torch.Tensor:
    if x is None:
        return default
    return x.to(device=default.device, dtype=torch.int32).contiguous()


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    q_lens: torch.Tensor | None = None,
                    kv_lens: torch.Tensor | None = None,
                    q_offsets: torch.Tensor | None = None,
                    bq: int = 32, bkv: int = 32, causal: bool = True,
                    scale: float | None = None) -> torch.Tensor:
    """q (B, H, Sq, D), k/v (B, H, Skv, D) -> (B, H, Sq, D) in q's dtype.

    ``q_offsets`` defaults to zeros, ``q_lens`` to ``q_offsets + Sq``
    (all rows valid, in absolute positions) and ``kv_lens`` to ``Skv``,
    as in the Pallas kernel.
    """
    if q.dim() != 4 or k.shape != v.shape or k.dim() != 4:
        raise ValueError(f"flash_attention: q (B,H,Sq,D) and k, v (B,H,Skv,D) "
                         f"expected, got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    B, H, Sq, D = q.shape
    Skv = k.shape[2]
    if k.shape[:2] != (B, H) or k.shape[3] != D:
        raise ValueError(f"flash_attention: k/v {tuple(k.shape)} do not match "
                         f"q {tuple(q.shape)}")
    scale = scale if scale is not None else D ** -0.5
    q_offsets = _lens(q_offsets, torch.zeros((B,), dtype=torch.int32,
                                             device=q.device))
    q_lens = _lens(q_lens, q_offsets + Sq)
    kv_lens = _lens(kv_lens, torch.full((B,), Skv, dtype=torch.int32,
                                        device=q.device))
    if q.device.type == "cpu" and k.device.type == "cpu":
        return flash_attention_ref(q, k, v, causal=causal, scale=scale,
                                   q_lens=q_lens, kv_lens=kv_lens,
                                   q_offsets=q_offsets)
    if q.device.type != "cuda" or k.device != q.device or v.device != q.device:
        raise ValueError(f"flash_attention: q, k, v on {q.device}, {k.device}, "
                         f"{v.device}; the kernel needs one CUDA device")
    if q.dtype not in (torch.float32, torch.bfloat16) or \
            k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"flash_attention: q, k, v must all be fp32 or all "
                         f"bf16, got {q.dtype}, {k.dtype}, {v.dtype}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash_attention: q, k, v must be contiguous")
    if bq < 1 or bkv < 1:
        raise ValueError(f"flash_attention: tiles must be positive, got "
                         f"{(bq, bkv)}")
    need = smem_bytes(D, bq, bkv)
    if need > SMEM_LIMIT:
        raise ValueError(
            f"flash_attention: tiles (bq, bkv)={(bq, bkv)} at head dim {D} "
            f"need {need} bytes of shared memory, over the {SMEM_LIMIT} a "
            f"Hopper block can have")
    if B * H > 65535:
        raise ValueError(f"flash_attention: B*H={B * H} exceeds the grid's "
                         f"65535")
    o = torch.empty_like(q)
    if Sq == 0:
        return o
    fn = _build.bind("flash_attention", _ARGTYPES)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with _build.on_device(q.device):
        code = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                  q_lens.data_ptr(), kv_lens.data_ptr(), q_offsets.data_ptr(),
                  B, H, Sq, Skv, D, bq, bkv, float(scale), int(causal),
                  int(q.dtype == torch.bfloat16), stream)
    _build.check("flash_attention", code)
    flash_attention.launches += 1
    return o


flash_attention.launches = 0
