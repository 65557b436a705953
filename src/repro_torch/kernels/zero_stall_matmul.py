"""Zero-stall matmul (G = 1): the wrapper of two designs.

C = A @ B through an N-slot shared-memory revolving buffer.  Replaces
the Pallas TPU kernel ``repro.kernels.zero_stall_matmul.zero_stall_matmul``.
One rule picks the design (:func:`select_design`), for this product and
for the grouped and int8 wrappers alike:

- ``"sm90"`` (``csrc/zero_stall_sm90.cu`` over ``zero_stall_sm90.cuh``):
  tensor-core operands (bf16 here) whose rows TMA can address (16-byte
  multiples from 16-byte aligned bases: K % 8 == 0, N % 8 == 0 for a
  row-major B).  A TMA-filled ring with one full/empty mbarrier pair per
  stage, a producer warp and a consumer warpgroup running ``wgmma``.  It
  computes C^T = B^T A^T ("swap AB"): the weight's N side fills wgmma's
  64 rows and the M rows of A are the instruction's N side.  The tile
  parameters keep their meaning: a block owns at most bm x bn outputs,
  namely ``min(bm, next power of two of max(M, 8))`` rows of A (bm a
  power of two in 8..128) by bn (64 or 128) columns; a stage holds bk
  of k (a multiple of 128 bytes, at most 512: bk 64..256 in bf16);
  ``slots`` is the stage count.  When the output tiles are fewer than
  the SMs the k stages are split over blocks (:func:`split_plan`) and
  the partials summed in a fixed order, so a call gives the same bits
  every time.
- ``"ring"`` (``csrc/zero_stall_matmul.cu`` over ``zero_stall_ring.cuh``):
  fp32 and bf16 shapes TMA cannot address.  A cp.async ring with
  mma.sync (bf16) or fp32 FMA, one block per bm x bn tile; ragged edges
  are masked in the kernel.

On a CUDA tensor the wrapper launches its design's kernel or raises;
on a CPU tensor it runs the plain version
:func:`repro_torch.kernels.ref.matmul_ref`.  No operand is padded.
``zero_stall_matmul.launches`` counts kernel launches and
``zero_stall_matmul.launches_by_design`` splits them by design.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import meta as _meta
from repro_torch.kernels.ref import matmul_ref
from repro_torch.plan.config import dtype_name, resolve_slots

__all__ = ["zero_stall_matmul", "smem_bytes", "sm90_smem_bytes",
           "select_design", "sm90_rows", "split_plan", "smem_footprint",
           "plan_launch", "launch_geometry", "matmul_launch", "sms_of",
           "SMEM_LIMIT", "MAX_THREADS", "SM90_DTYPES", "H100_SMS"]

# grid_rank counts the axes of the CUDA launch grid: (output tiles, k
# splits) on the sm90 design, (output tiles, groups) on the ring design
_meta.register_family("zero_stall_matmul", grid_rank=2, managed_dma=True,
                      sequential_axes="all")

SMEM_LIMIT = 232448          # bytes of shared memory one Hopper block may use
MAX_THREADS = 512            # the kernel's __launch_bounds__
_IN_DTYPES = (torch.float32, torch.bfloat16)
_OUT_DTYPES = (torch.float32, torch.bfloat16)
# a, b, c, G, M, N, K, bm, bn, bk, slots, jik, bf16, fp32 out, trans_b,
# vec, stream: the C entry shared with the grouped wrapper
_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 13 + [ctypes.c_void_p]
# a, b, c, workspace, M, N, K, rows, bn, bk, slots, jik, fp32 out,
# trans_b, splits, steps per split, stream
_SM90_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 12 \
    + [ctypes.c_void_p]
SM90_DTYPES = (torch.bfloat16, torch.int8)    # wgmma types of the design
SM90_ROWS = (8, 16, 32, 64, 128)    # rows of A a block may own
SM90_BN = (64, 128)                 # columns of C a block may own
H100_SMS = 132               # an H100 SXM's SMs: a launch planned off the card


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


def select_design(dtype: torch.dtype, K: int, N: int, trans_b: bool,
                  a_ptr: int = 0, b_ptr: int = 0) -> str:
    """The design that runs a product, plain, grouped or int8, by one
    rule: a tensor-core type of wgmma (bf16, int8) with TMA-legal rows
    (contiguous rows of 16-byte multiples from 16-byte aligned bases:
    K % 8 == 0 in bf16 and K % 16 == 0 in int8, and N the same unless B
    is (N, K); a group's slice starts on such a row) -> "sm90"; fp32 and
    other shapes -> "ring"."""
    size = dtype.itemsize
    legal = ((K * size) % 16 == 0 and (trans_b or (N * size) % 16 == 0)
             and a_ptr % 16 == 0 and b_ptr % 16 == 0)
    return "sm90" if dtype in SM90_DTYPES and legal else "ring"


def sm90_rows(M: int, bm: int) -> int:
    """Rows of A one sm90 block owns: the smallest instantiated wgmma
    width that holds M, at most bm."""
    rows = 8
    while rows < min(M, bm):
        rows *= 2
    return min(rows, bm)


def sm90_smem_bytes(rows: int, bn: int, bk: int, slots: int,
                    element_size: int = 2) -> int:
    """Shared memory of one sm90 block (the formula of
    ``csrc/zero_stall_sm90.cuh``): ``slots`` stages of a bn x bk weight
    tile and a rows x bk activation tile of ``element_size``-byte
    elements (2: bf16, 1: int8), 16 bytes of mbarriers a stage, and 1024
    bytes to align the stages to the swizzle atom."""
    return 1024 + slots * ((bn + rows) * bk * element_size + 16)


def smem_footprint(M: int, N: int, K: int, bm: int, bn: int, bk: int,
                   slots: int, element_size: int) -> tuple[str, int]:
    """(design, shared-memory bytes of one block) of a product with these
    tiles: the design :func:`select_design` picks at aligned bases (int8
    codes K-major, other types with a (K, N) B, as the wrappers take
    them) and that design's own formula (:func:`sm90_smem_bytes` at
    :func:`sm90_rows`, or :func:`smem_bytes`)."""
    dtype = {1: torch.int8, 2: torch.bfloat16, 4: torch.float32}[element_size]
    trans_b = element_size == 1
    design = select_design(dtype, K, N, trans_b)
    if design == "sm90":
        return design, sm90_smem_bytes(sm90_rows(M, bm), bn, bk, slots,
                                       element_size)
    return design, smem_bytes(bm, bn, bk, slots, dtype, trans_b)


def _check_sm90_config(M: int, bm: int, bn: int, bk: int, slots: int,
                       dtype: torch.dtype = torch.bfloat16,
                       kernel: str = "zero_stall_matmul") -> None:
    """Raise on tiles the sm90 design cannot take: a stage of bk is a
    whole number of 128-byte TMA boxes, at most four."""
    size = dtype.itemsize
    box = 128 // size
    if bm not in SM90_ROWS or bn not in SM90_BN or bk % box or \
            not box <= bk <= 4 * box:
        raise ValueError(
            f"{kernel} ({dtype_name(dtype)}, sm90): tiles must have bm in "
            f"{SM90_ROWS}, bn in {SM90_BN} and bk a multiple of {box} up to "
            f"{4 * box}, got {(bm, bn, bk)}")
    need = sm90_smem_bytes(sm90_rows(M, bm), bn, bk, slots, size)
    if need > SMEM_LIMIT:
        raise ValueError(
            f"{kernel} ({dtype_name(dtype)}, sm90): tiles {(bm, bn, bk)} at "
            f"slots={slots} with M={M} need {need} bytes of shared memory, "
            f"over the {SMEM_LIMIT} a Hopper block can have (lower bk or "
            f"slots)")


def split_plan(M: int, N: int, K: int, bm: int, bn: int, bk: int,
               sms: int) -> tuple[int, int]:
    """(splits, k stages a split) of an sm90 product: when the output
    tiles are fewer than the ``sms`` SMs, the ceil(K / bk) stages are cut
    into at most sms // tiles ranges of whole stages, none empty, so
    that the blocks come as near the SM count as whole stages allow
    without a second wave; otherwise one split of all stages.  bk counts
    elements of the product's type (bf16 or int8)."""
    rows = sm90_rows(M, bm)
    tiles = -(-M // rows) * -(-N // bn)
    steps = max(1, -(-K // bk))
    want = max(1, min(steps, sms // max(tiles, 1)))
    per = -(-steps // want)
    return -(-steps // per), per


@functools.cache
def _sm_count(index: int) -> int:
    """Streaming multiprocessors of CUDA device ``index``, read once."""
    return torch.cuda.get_device_properties(index).multi_processor_count


def sms_of(device: torch.device) -> int:
    """The SMs a launch on ``device`` is planned for: a CUDA device's
    own; for the meta device (a plan's trace) the current CUDA device's,
    else an H100 SXM's :data:`H100_SMS`."""
    if device.type == "cuda":
        return _sm_count(device.index)
    if torch.cuda.is_available():
        return _sm_count(torch.cuda.current_device())
    return H100_SMS


def matmul_launch(family: str, design: str, *, G: int, M: int, N: int,
                  K: int, rows: int, bn: int, bk: int, slots: int,
                  grid_order: str | None, splits: int, per: int,
                  blocks: int) -> _meta.Launch:
    """The :class:`~repro_torch.kernels.meta.Launch` of one product of
    the four matmul wrappers.  Its params: ``G, M, N, K``; ``rows`` the
    rows of A a block owns (the sm90 wgmma width, the ring's bm);
    ``bn, bk``; ``slots`` the ring depth; ``jik``; ``gm, gn`` a group's
    row and column tiles, ``tiles`` all of them; ``steps`` the k stages
    of a tile; ``splits`` and ``per`` (stages a split); ``lookahead`` the
    stages the producer keeps in flight beyond the one computed (slots -
    1 in both rings: the TMA producer refills a stage once its last use
    is released, the cp.async ring issues step t + slots - 1 at step t);
    ``k_inner`` 1 (a block runs a tile's k stages before its next tile);
    ``reduce_order`` the order split-k partials are summed in.  The sm90
    grid is (``blocks``, splits): block x walks tiles x, x + blocks, ...
    (one tile unless persistent); the ring's is (tiles of a group, G)."""
    gm, gn = -(-M // rows), -(-N // bn)
    grid = (blocks, splits) if design == "sm90" else (gm * gn, G)
    name = _meta.kernel_name(family, slots=slots, grid_order=grid_order)
    return _meta.Launch(name=name, design=design, grid=grid, params=dict(
        G=G, M=M, N=N, K=K, rows=rows, bn=bn, bk=bk, slots=slots,
        jik=int(grid_order == "jik"), gm=gm, gn=gn, tiles=G * gm * gn,
        steps=max(1, -(-K // bk)), splits=splits, per=per,
        lookahead=slots - 1, k_inner=1, reduce_order=tuple(range(splits))))


def plan_launch(M: int, N: int, K: int, *, dtype: torch.dtype, bm: int,
                bk: int, bn: int, trans_b: bool, sms: int, a_ptr: int = 0,
                b_ptr: int = 0) -> tuple[str, int, int, int]:
    """(design, rows, splits, per) of a plain (G = 1) product: the design
    of :func:`select_design`; on sm90 the rows of :func:`sm90_rows` and
    the k splits of :func:`split_plan` over ``sms`` SMs, one block a
    tile; the ring runs bm x bn tiles with every k stage.  The wrappers
    launch from these integers and :func:`launch_geometry` records them."""
    design = select_design(dtype, K, N, trans_b, a_ptr, b_ptr)
    if design == "sm90":
        return (design, sm90_rows(M, bm),
                *split_plan(M, N, K, bm, bn, bk, sms))
    return design, bm, 1, max(1, -(-K // bk))


def launch_geometry(M: int, N: int, K: int, *, dtype: torch.dtype,
                    bm: int = 128, bn: int = 128, bk: int = 128,
                    variant: str = "dobu", slots: int | None = None,
                    grid_order: str = "ijk", trans_b: bool = False,
                    sms: int = H100_SMS, a_ptr: int = 0, b_ptr: int = 0,
                    family: str = "zero_stall_matmul") -> _meta.Launch:
    """The launch of a plain (G = 1) product, bf16/fp32 or (``family``
    ``"quantized_zero_stall_matmul"``) int8, at :func:`plan_launch`'s
    geometry."""
    design, rows, splits, per = plan_launch(
        M, N, K, dtype=dtype, bm=bm, bn=bn, bk=bk, trans_b=trans_b, sms=sms,
        a_ptr=a_ptr, b_ptr=b_ptr)
    return matmul_launch(family, design, G=1, M=M, N=N, K=K, rows=rows,
                         bn=bn, bk=bk, slots=resolve_slots(variant, slots),
                         grid_order=grid_order, splits=splits, per=per,
                         blocks=-(-M // rows) * -(-N // bn))


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
    The design follows :func:`select_design`; tiles that design cannot
    take raise ``ValueError``.
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
    kind, rows, splits, per = plan_launch(
        M, N, K, dtype=a.dtype, bm=bm, bn=bn, bk=bk, trans_b=trans_b,
        sms=sms_of(a.device), a_ptr=a.data_ptr(), b_ptr=b.data_ptr())
    if kind == "sm90":
        _check_sm90_config(M, bm, bn, bk, slots)
    else:
        _check_config(bm, bn, bk, slots, a.dtype, trans_b)
    c = torch.empty((M, N), dtype=out_dtype, device=a.device)
    if M == 0 or N == 0:
        return c
    if K == 0:
        return c.zero_()
    stream = torch.cuda.current_stream(a.device).cuda_stream
    jik = int(grid_order == "jik")
    ws = (torch.empty((splits, M, N), dtype=torch.float32, device=a.device)
          if splits > 1 else None)
    _meta.note(lambda: matmul_launch(
        "zero_stall_matmul", kind, G=1, M=M, N=N, K=K, rows=rows, bn=bn,
        bk=bk, slots=slots, grid_order=grid_order, splits=splits, per=per,
        blocks=-(-M // rows) * -(-N // bn)),
        ins=(("a", a), ("b", b)), outs=(("c", c),), ws=(("ws", ws),))
    if kind == "sm90":
        fn = _build.bind("zero_stall_matmul_sm90", _SM90_ARGTYPES,
                         "zero_stall_sm90")
        with _build.on_device(a.device):
            code = fn(a.data_ptr(), b.data_ptr(), c.data_ptr(),
                      None if ws is None else ws.data_ptr(), M, N, K,
                      rows, bn, bk, slots, jik,
                      int(out_dtype == torch.float32), int(trans_b), splits,
                      per, stream)
        _build.check("zero_stall_sm90", code)
    else:
        fn = _build.bind("zero_stall_matmul", _ARGTYPES)
        with _build.on_device(a.device):
            code = fn(a.data_ptr(), b.data_ptr(), c.data_ptr(), 1, M, N, K,
                      bm, bn, bk, slots, jik, int(a.dtype == torch.bfloat16),
                      int(out_dtype == torch.float32), int(trans_b),
                      int(_vec_ok(a, b, K, N, trans_b)), stream)
        _build.check("zero_stall_matmul", code)
    zero_stall_matmul.launches += 1
    zero_stall_matmul.launches_by_design[kind] += 1
    return c


zero_stall_matmul.launches = 0
zero_stall_matmul.launches_by_design = {"sm90": 0, "ring": 0}
