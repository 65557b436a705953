"""`KernelConfig` and `OpKey`: the typed vocabulary of execution plans.

The port's counterpart of ``repro.plan.config``.  ``backend`` is
``"auto"`` (the hand-written CUDA kernel on a CUDA tensor, its plain
PyTorch version on a CPU tensor) or ``"torch"`` (the plain version on
any device, the counterpart of the JAX package's ``"jnp"``).

An :class:`OpKey` names one kernel call site by its mathematical
signature ``(op, M, N, K, groups, dtype)``; keys bucket their shape to
the next power of two, the same rule as the tune cache's keys
(:func:`_next_pow2`), so a ragged serving shape resolves to its
bucket's entry.

JSON (``KernelConfig.to_json`` / ``from_json``) is the JAX package's
plan schema: a field is written where it differs from the schema's
default, which is the JAX package's default config (128 x 128 x 128
tiles, 128 x 128 attention tiles), and a field left out reads as that
default, so a plan file moves between the two packages unchanged.
The port's own defaults differ (``bk=None``, ``bq=bkv=32``, see
:class:`KernelConfig`), so they are written out; ``bk=None`` is written
as the k tile it resolves to wherever the dtype is known.
"""

from __future__ import annotations

import dataclasses

import torch

__all__ = ["BACKENDS", "UNSET", "KernelConfig", "OpKey", "resolve_slots",
           "dtype_name", "dtype_from_name"]


class _Unset:
    """Sentinel for 'keyword not passed' with a stable repr."""

    _instance = None

    def __new__(cls):
        if cls._instance is None:
            cls._instance = super().__new__(cls)
        return cls._instance

    def __repr__(self):
        return "<unset>"


#: Module-wide "keyword not passed" sentinel.
UNSET = _Unset()

BACKENDS = ("auto", "torch")
# the JAX package's backend names, read from its plan files: its plain
# "jnp" is the port's "torch", its kernel backends the port's "auto"
_JAX_BACKENDS = {"jnp": "torch", "pallas": "auto", "interpret": "auto"}
_OPS = ("matmul", "grouped_matmul", "attention")
_QUANTS = (None, "int8", "fp8")
_VARIANTS = ("dobu", "single")
_GRID_ORDERS = ("ijk", "jik")
_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}
_DTYPE_BYTES = {"float64": 8, "float32": 4, "int32": 4, "bfloat16": 2,
                "float16": 2, "int8": 1, "uint8": 1, "float8_e4m3fn": 1,
                "float8_e5m2": 1}
# the plan schema's defaults: the JAX package's KernelConfig()
_JSON_DEFAULTS = {"backend": "auto", "bm": 128, "bn": 128, "bk": 128,
                  "variant": "dobu", "slots": None, "grid_order": "ijk",
                  "bq": 128, "bkv": 128, "quant": None, "out_dtype": None}


def dtype_name(dtype) -> str:
    """Canonical dtype name ('float32', 'bfloat16', ...)."""
    if isinstance(dtype, str):
        return dtype
    return str(dtype).removeprefix("torch.")


def dtype_bytes(name: str) -> int:
    """Bytes an element of the named dtype."""
    if name not in _DTYPE_BYTES:
        raise ValueError(f"unknown dtype name {name!r}; have "
                         f"{sorted(_DTYPE_BYTES)}")
    return _DTYPE_BYTES[name]


def _next_pow2(n: int) -> int:
    """THE shape-bucketing rule: OpKey.bucketed and the tune cache's keys
    round every dim up to the next power of two with it."""
    return 1 if n <= 1 else 1 << (n - 1).bit_length()


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
    name (the kernels write fp32 or bf16; another known name loads and
    is refused where it is used).
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
            # any known dtype name, as the JAX package's schema: a plan
            # asking the kernels for an int8 output loads, and the static
            # analyzer rejects it (ZS-L004) before it runs
            name = dtype_name(self.out_dtype)
            dtype_bytes(name)
            object.__setattr__(self, "out_dtype", name)

    @property
    def resolved_slots(self) -> int:
        """Buffer depth: explicit ``slots`` wins, else variant default."""
        return resolve_slots(self.variant, self.slots)

    def resolved_bk(self, dtype) -> int:
        """The k tile for inputs of ``dtype`` (a torch dtype or its name;
        see the class docstring)."""
        if self.bk is not None:
            return self.bk
        size = dtype_bytes(dtype_name(dtype))
        return 256 // size if size in (1, 2, 4) else 128

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

    # ------------------------------------------------------------------
    def to_json(self, dtype=None) -> dict:
        """The fields that differ from the plan schema's defaults (the
        JAX package's config); ``bk=None`` becomes the k tile it resolves
        to for inputs of ``dtype`` when that is given, else JSON null."""
        out = {}
        for f in dataclasses.fields(self):
            v = getattr(self, f.name)
            if f.name == "bk" and v is None and dtype is not None:
                v = self.resolved_bk(dtype)
            if v != _JSON_DEFAULTS[f.name]:
                out[f.name] = v
        return out

    @classmethod
    def from_json(cls, d: dict) -> "KernelConfig":
        """Inverse of :meth:`to_json`, and the reader of the JAX
        package's plan entries: a field left out is the schema's default,
        and a JAX backend name maps to the port's."""
        kw = dict(_JSON_DEFAULTS)
        kw.update({k: v for k, v in d.items() if k in _JSON_DEFAULTS})
        kw["backend"] = _JAX_BACKENDS.get(kw["backend"], kw["backend"])
        return cls(**kw)

    @classmethod
    def from_candidate(cls, cand, **overrides) -> "KernelConfig":
        """Build from a :class:`repro_torch.tune.Candidate` (duck-typed)."""
        kw = {"bm": cand.bm, "bn": cand.bn, "bk": cand.bk,
              "variant": cand.variant, "slots": cand.slots,
              "grid_order": cand.grid_order}
        kw.update(overrides)
        return cls(**kw)


@dataclasses.dataclass(frozen=True, order=True)
class OpKey:
    """The signature of one kernel call site.

    For matmuls, ``(M, N, K)`` are the GEMM dims (``groups`` > 1 for the
    grouped/MoE form; int8 products carry dtype ``"int8"``); for
    attention, ``M`` = query length, ``N`` = head dim, ``K`` = kv
    length: the convention of :class:`repro_torch.tune.Problem`.
    """

    op: str
    M: int
    N: int
    K: int
    groups: int = 1
    dtype: str = "float32"

    def __post_init__(self):
        if self.op not in _OPS:
            raise ValueError(f"OpKey.op must be one of {_OPS}, "
                             f"got {self.op!r}")

    def bucketed(self) -> "OpKey":
        """Power-of-two shape bucket (same rounding as the tune cache)."""
        return dataclasses.replace(
            self, M=_next_pow2(self.M), N=_next_pow2(self.N),
            K=_next_pow2(self.K), groups=_next_pow2(self.groups))

    @property
    def dtype_bytes(self) -> int:
        return dtype_bytes(self.dtype)

    def to_str(self) -> str:
        return (f"{self.op}|{self.M}x{self.N}x{self.K}"
                f"|g{self.groups}|{self.dtype}")

    @classmethod
    def from_str(cls, s: str) -> "OpKey":
        op, dims, g, dtype = s.split("|")
        M, N, K = (int(d) for d in dims.split("x"))
        return cls(op=op, M=M, N=N, K=K, groups=int(g[1:]), dtype=dtype)
