"""Masked flash attention: the wrapper of ``csrc/flash_attention.cu``.

(B, H, Sq, D) attention with per-sequence valid lengths and query
offsets, causal masking in absolute positions, an online softmax over
kv tiles and exact zeros for fully-masked rows (see the header note of
the CUDA source for its designs and bound).  Replaces the Pallas TPU
kernel ``repro.kernels.flash_attention.flash_attention``.

The design follows the dtype (:func:`design`): bf16 runs on the tensor
cores (``mma.sync`` with register accumulators; head dims
:data:`TC_HEAD_DIMS`, q and kv tiles of 16, 32 or 64 rows, bkv * D <=
8192), fp32 on the CUDA cores (full fp32, any tile that fits shared
memory).  On a CUDA tensor the wrapper launches the kernel or raises;
on a CPU tensor it runs the plain version
:func:`repro_torch.kernels.ref.flash_attention_ref` with the same
length operands.  Ragged Sq / Skv are masked inside the kernel.
``flash_attention.launches`` counts kernel launches and
``flash_attention.launches_by_design`` splits them by design.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import meta as _meta
from repro_torch.kernels.ref import flash_attention_ref

__all__ = ["flash_attention", "smem_bytes", "design", "fit_tiles",
           "check_tc_tiles", "launch_geometry", "kv_tiles", "SMEM_LIMIT",
           "TC_HEAD_DIMS", "TC_TILES"]

# grid_rank counts the axes of the CUDA launch grid: (q tiles, B * H);
# the kv walk runs inside a block, so only that loop carries state
_meta.register_family("flash_attention", grid_rank=2, managed_dma=False,
                      sequential_axes="last")

SMEM_LIMIT = 232448
TC_HEAD_DIMS = (16, 32, 64, 80, 128, 256)  # instantiated bf16 head dims
TC_TILES = (16, 32, 64)                 # bf16 q and kv tile sizes
_TC_REGS = 8192                         # bkv * D: a warp's score and
#                                         output registers at D = 256
# q, k, v, o, q_lens, kv_lens, q_offsets, B, H, Sq, Skv, D, bq, bkv, scale,
# causal, bf16, stream
_ARGTYPES = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 7 \
    + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]


def design(dtype: torch.dtype) -> str:
    """The kernel design that runs inputs of ``dtype``: "tensor_core"
    for bf16, "cuda_core" for fp32."""
    return "tensor_core" if dtype == torch.bfloat16 else "cuda_core"


def smem_bytes(D: int, bq: int, bkv: int,
               dtype: torch.dtype = torch.float32) -> int:
    """Shared memory of one block, the same formulas as the CUDA source:
    bf16 holds Q and two stages of K and V as bf16 rows padded by 16
    bytes; fp32 holds q, k, v, the scores and the output accumulator as
    fp32."""
    if design(dtype) == "tensor_core":
        return 2 * (D + 8) * (bq + 4 * bkv)
    ldd = D + 1
    return 4 * (bq * ldd + bkv * ldd + bkv * D + bq * D + bq * bkv + 3 * bq)


def fit_tiles(dtype: torch.dtype, Sq: int, Skv: int, bq: int,
              bkv: int) -> tuple[int, int]:
    """The (bq, bkv) a call over Sq queries and Skv keys runs at when
    the configuration asks for (bq, bkv): no tile longer than its
    sequence, and for the tensor-core design whole 16-row mma steps (a
    short sequence takes one tile, masked past its end)."""
    if design(dtype) == "tensor_core":
        return min(bq, -(-Sq // 16) * 16), min(bkv, -(-Skv // 16) * 16)
    return min(bq, Sq), min(bkv, Skv)


def check_tc_tiles(D: int, bq: int, bkv: int) -> None:
    """Raise on a head dim or tiles the bf16 tensor-core design does not
    take (the instantiations of ``csrc/flash_attention.cu``)."""
    if D not in TC_HEAD_DIMS:
        raise ValueError(f"flash_attention (bf16): head dim {D} is not "
                         f"instantiated; the tensor-core kernel takes D in "
                         f"{TC_HEAD_DIMS}")
    if bq not in TC_TILES or bkv not in TC_TILES:
        raise ValueError(f"flash_attention (bf16): tiles (bq, bkv)="
                         f"{(bq, bkv)} must each be one of {TC_TILES}")
    if bkv * D > _TC_REGS:
        raise ValueError(f"flash_attention (bf16): bkv={bkv} at head dim "
                         f"{D} exceeds the register budget bkv * D <= "
                         f"{_TC_REGS}")


def kv_tiles(q0: int, *, Sq: int, Skv: int, bq: int, bkv: int,
             causal: bool, q_len: int, kv_len: int, q_off: int,
             design: str = "tensor_core") -> int:
    """The kv tiles (0, 1, ...) the block of query rows q0 .. q0 + bq - 1
    walks, the rule of ``csrc/flash_attention.cu``: none when the block's
    first row lies at or past ``q_len``; else up to min(Skv, kv_len),
    causal: up to the frontier of the block's last row (the tensor-core
    design counts the rows that exist, the CUDA-core one all bq)."""
    kv_end = min(Skv, kv_len)
    if causal:
        rows = min(bq, Sq - q0) if design == "tensor_core" else bq
        kv_end = min(kv_end, q_off + q0 + rows)
    if q_off + q0 >= q_len:
        kv_end = 0
    return -(-kv_end // bkv) if kv_end > 0 else 0


def launch_geometry(B: int, H: int, Sq: int, Skv: int, D: int, *,
                    dtype: torch.dtype, bq: int, bkv: int,
                    causal: bool = True) -> _meta.Launch:
    """The launch of :func:`flash_attention`: one block a (q tile of bq
    rows, b * h), grid (ceil(Sq / bq), B * H), each walking
    :func:`kv_tiles` kv tiles of bkv keys through a two-stage copy
    pipeline.  Params: ``B, H, Sq, Skv, D, bq, bkv, causal``."""
    return _meta.Launch(
        name=_meta.kernel_name("flash_attention"), design=design(dtype),
        grid=(-(-Sq // bq), B * H),
        params=dict(B=B, H=H, Sq=Sq, Skv=Skv, D=D, bq=bq, bkv=bkv,
                    causal=int(causal)))


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
    kind = design(q.dtype)
    if kind == "tensor_core":
        check_tc_tiles(D, bq, bkv)
        if any(t.data_ptr() % 16 for t in (q, k, v)):
            raise ValueError("flash_attention (bf16): q, k, v must start on "
                             "16-byte boundaries (16-byte cp.async)")
    need = smem_bytes(D, bq, bkv, q.dtype)
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
    _meta.note(lambda: launch_geometry(B, H, Sq, Skv, D, dtype=q.dtype, bq=bq,
                                       bkv=bkv, causal=causal),
        lens={"q_lens": q_lens, "kv_lens": kv_lens, "q_offsets": q_offsets},
        ins=(("q", q), ("k", k), ("v", v), ("q_lens", q_lens),
             ("kv_lens", kv_lens), ("q_offsets", q_offsets)),
        outs=(("o", o),))
    fn = _build.bind("flash_attention", _ARGTYPES)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with _build.on_device(q.device):
        code = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                  q_lens.data_ptr(), kv_lens.data_ptr(), q_offsets.data_ptr(),
                  B, H, Sq, Skv, D, bq, bkv, float(scale), int(causal),
                  int(q.dtype == torch.bfloat16), stream)
    _build.check("flash_attention", code)
    flash_attention.launches += 1
    flash_attention.launches_by_design[kind] += 1
    return o


flash_attention.launches = 0
flash_attention.launches_by_design = {"tensor_core": 0, "cuda_core": 0}
