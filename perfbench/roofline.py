"""The yardstick: the H100's peaks, the operations and bytes of the
products a step runs, and the device-busy union.

Copied here so that a change to the port cannot move it:

* the roofline arithmetic of ``src/repro_torch/obs/kernel_watch.py``: a
  call's least time is the larger of its unique bytes over the HBM rate
  and its operations over the data-sheet peak (each input byte read
  once, each output byte written once);
* the model FLOPs of ``src/repro_torch/core/roofline.py::model_flops``
  (2 N a served token), with the attention products added
  (:meth:`perfbench.spec.ModelSpec.token_flops`);
* the busy union of ``chip_smoke.py::device_busy``: the device is busy
  where any of its events (kernels, copies) runs.

The work is counted from the products' shapes at the rows a step needed
(the live slots of a decode step, the prompt's tokens of a prefill),
whatever the program pads them to, so a share cannot pass 100% by
counting padding.
"""

from __future__ import annotations

from perfbench.spec import ModelSpec

__all__ = ["PEAK_BF16", "HBM_BW", "least_time", "matmul",
           "step_products", "flash_prefill", "busy_union"]

# NVIDIA H100 SXM data sheet, dense rates at the 700 W limit
PEAK_BF16 = 989e12          # FLOP/s, bf16 tensor cores
HBM_BW = 3.35e12            # bytes/s, HBM3


def least_time(flops: float, nbytes: float) -> float:
    return max(flops / PEAK_BF16, nbytes / HBM_BW)


def matmul(M: int, K: int, N: int, out_bytes: int = 2) -> tuple:
    """(FLOPs, bytes) of a bf16 (M, K) @ (K, N) product."""
    return 2.0 * M * K * N, 2.0 * (M * K + K * N) + out_bytes * M * N


def step_products(spec: ModelSpec, rows: int, *, prefill: bool) -> list:
    """(FLOPs, bytes) of every product a pass of ``rows`` tokens runs on
    the zero-stall kernels: the projections, the MLP or the expert banks
    (each bank read whole; its rows the tokens' ``k`` assignments), and
    the head (fp32 out; a prefill's on its last row only).  The router's
    fp32 product is a plain one and not counted."""
    d, hd, f = spec.d_model, spec.head_dim, spec.d_ff
    H, KV = spec.n_heads, spec.n_kv_heads
    layer = [matmul(rows, d, H * hd), matmul(rows, d, KV * hd),
             matmul(rows, d, KV * hd), matmul(rows, H * hd, d)]
    if spec.family == "moe":
        E, a = spec.n_experts, rows * spec.experts_per_token
        for k_in, n_out in ((d, f), (d, f), (f, d)):
            layer.append((2.0 * a * k_in * n_out,
                          2.0 * (a * k_in + E * k_in * n_out + a * n_out)))
    else:
        layer += [matmul(rows, d, f), matmul(rows, d, f), matmul(rows, f, d)]
    head = matmul(1 if prefill else rows, d, spec.vocab, out_bytes=4)
    return layer * spec.n_layers + [head]


def flash_prefill(spec: ModelSpec, rows: int) -> tuple:
    """(FLOPs, bytes) of a prefill's causal attention over ``rows`` prompt
    tokens in every layer: the score and value products over the causal
    half, and q, k, v and o read or written once at every query head (the
    kernel's operands: K and V repeated to the query heads)."""
    H, hd = spec.n_heads, spec.head_dim
    flops = 4.0 * H * hd * rows * (rows + 1) / 2
    nbytes = 4.0 * H * rows * hd * 2
    return spec.n_layers * flops, spec.n_layers * nbytes


def busy_union(intervals) -> float:
    """Seconds covered by the union of (start, end) intervals."""
    busy, end = 0.0, float("-inf")
    for a, b in sorted(intervals):
        if b > end:
            busy += b - max(a, end)
            end = b
    return busy
