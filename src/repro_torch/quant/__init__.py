"""Quantized zero-stall execution (port of ``repro.quant``).

:class:`QTensor` weights (int8 or simulated fp8 codes plus fp32
per-channel scales) come from ``Model.quantize_weights(params)``; a
``Ctx(plan=KernelConfig(quant="int8"))`` runs them on the W8A8 kernels
(:mod:`repro_torch.kernels.quantized_matmul`), any other plan
dequantizes them onto the standard kernels.  The serving engine takes
quantized params unchanged.
"""

from repro_torch.quant.tensor import (FP8_MAX, INT8_MAX, QTensor, quantize,
                                      quantize_rows, quantize_tree)

__all__ = ["QTensor", "quantize", "quantize_rows", "quantize_tree",
           "INT8_MAX", "FP8_MAX"]
