"""`KernelConfig`: one validated execution configuration of the kernels.

The port's counterpart of ``repro.plan.config``.  ``backend`` is
``"auto"`` (the hand-written CUDA kernel on a CUDA tensor, its plain
PyTorch version on a CPU tensor) or ``"torch"`` (the plain version on
any device, the counterpart of the JAX package's ``"jnp"``).  Plans,
tracing and the tuner come in later slices.
"""

from __future__ import annotations

import dataclasses

import torch

__all__ = ["BACKENDS", "KernelConfig", "resolve_slots", "dtype_name",
           "dtype_from_name"]

BACKENDS = ("auto", "torch")
_QUANTS = (None, "int8", "fp8")
_VARIANTS = ("dobu", "single")
_GRID_ORDERS = ("ijk", "jik")
_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


def dtype_name(dtype) -> str:
    """Canonical dtype name ('float32', 'bfloat16', ...)."""
    if isinstance(dtype, str):
        return dtype
    return str(dtype).removeprefix("torch.")


def dtype_from_name(name: str) -> torch.dtype:
    if name not in _DTYPES:
        raise ValueError(f"unsupported dtype name {name!r}; "
                         f"have {sorted(_DTYPES)}")
    return _DTYPES[name]


def resolve_slots(variant: str, slots: int | None) -> int:
    """Buffer depth from the (variant, slots) pair; slots wins if given.

    ``variant`` is the paper's two-point vocabulary ("dobu" = 2-slot
    revolving buffer, "single" = serialized); ``slots`` generalizes it.
    Contradictory combinations are rejected rather than guessed.  The
    ONE place the rules live: the kernels
    (``kernels.zero_stall_matmul``) and :class:`KernelConfig`
    validation both delegate here.
    """
    if slots is None:
        return 2 if variant == "dobu" else 1
    if slots < 1:
        raise ValueError(f"slots must be >= 1, got {slots}")
    if variant == "single" and slots != 1:
        raise ValueError(f"variant='single' means slots=1, got slots={slots}")
    if variant == "dobu" and slots < 2:
        raise ValueError("variant='dobu' needs slots >= 2 "
                         "(use variant='single' for the serialized baseline)")
    return slots


@dataclasses.dataclass(frozen=True)
class KernelConfig:
    """One complete execution configuration, resolved ahead of time.

    ``bm/bn/bk`` are the matmul tiles; ``bk=None`` takes 256 bytes of k
    a stage: 64 for fp32 inputs (a 128-deep fp32 ring at ``slots=2``
    needs more shared memory than a Hopper block has), 128 for bf16 and
    256 for int8, plain or grouped, so an int8 stage of the TMA ring
    carries the bytes of a bf16 one.  ``variant``/
    ``slots`` set the revolving-buffer depth, ``grid_order`` the
    rasterisation of output tiles over thread blocks, ``bq/bkv`` the
    flash-attention tiles (32 x 32 by default: at head_dim 256 a 128 x
    128 tile would need 394 KB of shared memory), ``quant`` the
    quantized execution mode (``"int8"`` runs QTensor int8 weights on
    the W8A8 kernels; ``None`` or ``"fp8"`` dequantizes QTensor weights
    onto the standard kernels), ``out_dtype`` an optional output dtype
    name.
    """

    backend: str = "auto"
    bm: int = 128
    bn: int = 128
    bk: int | None = None
    variant: str = "dobu"
    slots: int | None = None
    grid_order: str = "ijk"
    bq: int = 32
    bkv: int = 32
    quant: str | None = None
    out_dtype: str | None = None

    def __post_init__(self):
        if self.backend not in BACKENDS:
            raise ValueError(
                f"KernelConfig.backend must be one of {BACKENDS}, "
                f"got {self.backend!r}")
        for name in ("bm", "bn", "bk", "bq", "bkv"):
            v = getattr(self, name)
            if name == "bk" and v is None:
                continue
            if not isinstance(v, int) or isinstance(v, bool) or v < 1:
                raise ValueError(
                    f"KernelConfig.{name} must be a positive integer, "
                    f"got {v!r}")
        if self.variant not in _VARIANTS:
            raise ValueError(
                f"KernelConfig.variant must be one of {_VARIANTS}, "
                f"got {self.variant!r}")
        if self.slots is not None and (not isinstance(self.slots, int)
                                       or isinstance(self.slots, bool)):
            raise ValueError(
                f"KernelConfig.slots must be an integer >= 1 or None, "
                f"got {self.slots!r}")
        try:
            resolve_slots(self.variant, self.slots)
        except ValueError as e:
            raise ValueError(f"KernelConfig: {e}") from None
        if self.grid_order not in _GRID_ORDERS:
            raise ValueError(
                f"KernelConfig.grid_order must be a permutation in "
                f"{_GRID_ORDERS}, got {self.grid_order!r}")
        if self.quant not in _QUANTS:
            raise ValueError(
                f"KernelConfig.quant must be one of {_QUANTS}, "
                f"got {self.quant!r}")
        if self.out_dtype is not None:
            name = dtype_name(self.out_dtype)
            dtype_from_name(name)
            object.__setattr__(self, "out_dtype", name)

    @property
    def resolved_slots(self) -> int:
        """Buffer depth: explicit ``slots`` wins, else variant default."""
        return resolve_slots(self.variant, self.slots)

    def resolved_bk(self, dtype: torch.dtype) -> int:
        """The k tile for inputs of ``dtype`` (see the class docstring)."""
        if self.bk is not None:
            return self.bk
        if dtype == torch.int8:
            return 256
        return 64 if dtype == torch.float32 else 128

    def matmul_kwargs(self, dtype: torch.dtype, *,
                      grouped: bool = False) -> dict:
        """Kwargs for the matmul kernel wrappers on inputs of ``dtype``;
        ``grouped`` leaves out the grid order, which the grouped kernels
        do not have (their Pallas originals walk "ijk" only)."""
        kw = {"bm": self.bm, "bn": self.bn,
              "bk": self.resolved_bk(dtype),
              "variant": self.variant, "slots": self.slots}
        if not grouped:
            kw["grid_order"] = self.grid_order
        return kw
