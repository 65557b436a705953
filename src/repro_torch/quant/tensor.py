"""QTensor: per-channel symmetric quantized weights (port of ``repro.quant.tensor``).

A :class:`QTensor` holds a weight's narrow codes (int8, or simulated
fp8 e4m3) and the fp32 per-channel scales that map them back to real
values.  The rules are the JAX package's, bit for bit:

* symmetric per output channel: for a weight laid out ``(..., d_in,
  d_out)`` the scale is the absmax over the contraction axis divided by
  the format's largest code, shape ``(..., 1, d_out)``; an all-zero
  channel gets a unit scale;
* int8 codes are ``clip(round(w / scale), -127, 127)`` with rounding half
  to even (``torch.round``, as ``jnp.round``); fp8 codes are ``w / scale``
  cast to ``torch.float8_e4m3fn`` (the storage rounding is real, the
  compute dequantizes onto the standard kernels);
* activations are quantized per row at run time (:func:`quantize_rows`);
* :func:`quantize_tree` quantizes every ``{"w": ...}`` linear weight and
  every MoE expert bank of rank >= 3 under ``wi``/``wg``/``wo``, and
  marks the SSM ``in_proj``/``out_proj`` weights W8A16.

One departure, in layout only: the codes keep JAX's logical ``(...,
d_in, d_out)`` shape but are stored K-major, as the transposed view of a
contiguous ``(..., d_out, d_in)`` buffer, because the int8 kernels'
tensor-core fragments of B cannot be loaded transposed
(``csrc/zero_stall_ring.cuh``).  The layout is fixed once, at
quantization (or in :mod:`repro_torch.interop`), never per call.
"""

from __future__ import annotations

from typing import Any

import torch

__all__ = ["QTensor", "quantize", "quantize_rows", "quantize_tree",
           "INT8_MAX", "FP8_MAX"]

INT8_MAX = 127.0          # symmetric: -127..127 (never -128)
FP8_MAX = 448.0           # float8_e4m3 largest finite magnitude
_FP8_DTYPE = torch.float8_e4m3fn
_FORMATS = ("int8", "fp8")


def k_major(codes: torch.Tensor) -> torch.Tensor:
    """The same logical (..., K, N) tensor stored as the transposed view
    of a contiguous (..., N, K) buffer (a copy unless it already is)."""
    return codes.mT.contiguous().mT


class QTensor:
    """Quantized weight: int8/fp8 ``data`` plus fp32 per-channel ``scale``.

    ``data``: the codes, of the original weight's (logical) shape,
    stored K-major (see the module docstring).  ``scale``: fp32, the
    shape of ``data`` with the contraction axis (-2) reduced to 1; the
    real value is about ``data * scale``.  ``w8a8=False`` keeps the
    weight's activations at full precision (W8A16: dequantize on the fly).
    """

    def __init__(self, data: torch.Tensor, scale: torch.Tensor,
                 fmt: str = "int8", w8a8: bool = True):
        if fmt not in _FORMATS:
            raise ValueError(f"fmt must be 'int8' or 'fp8', got {fmt!r}")
        self.data = data
        self.scale = scale
        self.fmt = fmt
        self.w8a8 = w8a8

    @property
    def shape(self) -> tuple[int, ...]:
        return tuple(self.data.shape)

    @property
    def ndim(self) -> int:
        return self.data.dim()

    def dequantize(self, dtype: torch.dtype | None = None) -> torch.Tensor:
        """The real-valued weight in ``dtype`` (default fp32), contiguous
        row-major like a plain weight."""
        w = self.data.to(torch.float32) * self.scale.to(torch.float32)
        return w.to(dtype or torch.float32).contiguous()

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return (f"QTensor(fmt={self.fmt!r}, shape={self.shape}, "
                f"scale_shape={tuple(self.scale.shape)})")


def _absmax_scale(w: torch.Tensor, dim: int, qmax: float) -> torch.Tensor:
    amax = torch.amax(torch.abs(w.to(torch.float32)), dim=dim, keepdim=True)
    scale = amax / qmax
    # all-zero channels (padding, unused experts) quantize to zeros with
    # a unit scale instead of dividing by zero
    return torch.where(scale == 0.0, torch.ones_like(scale), scale)


def _int8_codes(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    q = torch.round(x.to(torch.float32) / scale)
    return torch.clamp(q, -INT8_MAX, INT8_MAX).to(torch.int8)


def quantize(w: torch.Tensor, *, fmt: str = "int8", axis: int = -2,
             w8a8: bool = True) -> QTensor:
    """Per-channel symmetric quantization of a weight; ``axis`` is the
    contraction axis the scale reduces over (-2 for the repo's
    ``(..., d_in, d_out)`` layout).  Leading axes (MoE experts) are
    kept, each slice with its own scales."""
    if fmt == "int8":
        scale = _absmax_scale(w, axis, INT8_MAX)
        return QTensor(k_major(_int8_codes(w, scale)), scale, "int8", w8a8)
    if fmt == "fp8":
        scale = _absmax_scale(w, axis, FP8_MAX)
        q = (w.to(torch.float32) / scale).to(_FP8_DTYPE)
        return QTensor(k_major(q), scale, "fp8", w8a8)
    raise ValueError(f"fmt must be 'int8' or 'fp8', got {fmt!r}")


def quantize_rows(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Dynamic per-row int8 quantization of an activation ``(..., M, K)``.

    Returns ``(codes int8, scale fp32 (..., M, 1))``, both contiguous.
    Padding rows are exact zeros, so they get zero codes and add exact
    zeros to the integer contraction."""
    scale = _absmax_scale(x, -1, INT8_MAX)
    return _int8_codes(x, scale), scale


#: params-dict keys holding raw (non-dict) MoE expert weight banks
_EXPERT_KEYS = ("wi", "wg", "wo")

#: linear layers whose activations stay full precision (W8A16): the SSM
#: projections, whose recurrence amplifies activation-quantization noise
_W8A16_KEYS = ("in_proj", "out_proj")


def quantize_tree(params: Any, *, fmt: str = "int8") -> Any:
    """Quantize every matmul weight of a params tree.

    A ``{"w": ...}`` dict is a linear layer: its ``w`` is quantized
    (W8A16 under ``in_proj``/``out_proj``).  A raw ``wi``/``wg``/``wo``
    tensor of rank >= 3 is an MoE expert bank, quantized per expert.
    Everything else (embeddings, norms, routers) keeps full precision.
    Lists (the port's per-layer params) are walked element by element;
    already-quantized leaves pass through.
    """
    def walk(node, parent_key=None):
        if isinstance(node, list):
            return [walk(v, parent_key) for v in node]
        if not isinstance(node, dict):
            return node
        out = {}
        for key, val in node.items():
            if isinstance(val, (dict, list)):
                out[key] = walk(val, key)
            elif isinstance(val, QTensor):
                out[key] = val
            elif key == "w" and getattr(val, "ndim", 0) >= 2:
                out[key] = quantize(val, fmt=fmt,
                                    w8a8=parent_key not in _W8A16_KEYS)
            elif key in _EXPERT_KEYS and getattr(val, "ndim", 0) >= 3:
                out[key] = quantize(val, fmt=fmt)
            else:
                out[key] = val
        return out

    return walk(params)
