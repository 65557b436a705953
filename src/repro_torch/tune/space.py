"""Kernel configuration space: what the tuner may pick on Hopper.

The port's counterpart of ``repro.tune.space``.  A :class:`Candidate` is
one execution configuration of the zero-stall matmul kernels: tiles
``bm`` / ``bn`` / ``bk``, the ring depth ``slots`` (which implies the
paper's dobu/single variant) and the grid order.  :class:`KernelSpace`
enumerates the legal candidates of a problem over the tiles the port's
kernels take:

* ``bm`` from ``SM90_ROWS`` (the rows of A a block may own), ``bn`` from
  ``SM90_BN``, ``bk`` in 128-byte multiples up to 512 bytes (the TMA
  boxes of a stage), ``slots`` 1-4 and the grid orders ``ijk`` / ``jik``
  (``zero_stall_matmul.py``); the grouped kernels walk their tiles in one
  order, so a grouped problem sees ``ijk`` only;
* legal means the wrapper of the problem's design
  (:func:`~repro_torch.kernels.zero_stall_matmul.select_design` at
  aligned bases) takes the tiles: its own checks, shared memory against
  ``SMEM_LIMIT`` included (the TPU space's VMEM budget);
* on the sm90 design a ``bm`` at or above the rows the problem fills is
  one launch whatever its value, so the space keeps only the largest
  such ``bm`` (the default's 128); the ring design runs bm rows, so a
  ``bm`` past M rounded up to its granule (8 rows in fp32, 32 on the
  tensor cores) is left out; a ``bk`` longer than K rounded up to a
  128-byte box,
  or a ``bn`` wider than N rounded up to 64 (a wgmma's weight rows),
  would stream only padding and is left out;
* a decode step's product (M at most 16 rows) runs the revolving buffer
  (``slots >= 2``) where the space offers it: the decode path is
  bandwidth-bound, and the static analyzer holds plans to it
  (``ZS-L006``).

Flash-attention tiles ``(bq, bkv)`` are legal by the kernel's own rules:
:func:`~repro_torch.kernels.flash_attention.fit_tiles`, the tensor-core
tile and register checks for bf16, and shared memory.

:meth:`KernelSpace.default` is the fixed :class:`KernelConfig` of the
port, and :meth:`KernelSpace.candidates` yields it first, so that a
search whose oracle cannot tell candidates apart keeps the default.
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import Iterator

import torch

from repro_torch.core.cyclemodel import HopperPipelineModel
from repro_torch.plan.config import KernelConfig

__all__ = ["Candidate", "Problem", "KernelSpace", "DEFAULT_SPACE",
           "SMALL_SPACE"]

_DTYPES = {1: torch.int8, 2: torch.bfloat16, 4: torch.float32}
_DECODE_ROWS = 16            # the bucketed M of a few-token decode step


@dataclasses.dataclass(frozen=True, order=True)
class Candidate:
    """One execution configuration of the zero-stall matmul kernels."""

    bm: int
    bn: int
    bk: int
    slots: int = 2
    grid_order: str = "ijk"

    @property
    def variant(self) -> str:
        """The paper's two-point vocabulary, derived from depth."""
        return "dobu" if self.slots >= 2 else "single"

    def kernel_kwargs(self) -> dict:
        """Kwargs for ``zero_stall_matmul`` (grouped drops grid_order)."""
        return {"bm": self.bm, "bn": self.bn, "bk": self.bk,
                "slots": self.slots, "variant": self.variant,
                "grid_order": self.grid_order}

    def to_json(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_json(cls, d: dict) -> "Candidate":
        return cls(bm=int(d["bm"]), bn=int(d["bn"]), bk=int(d["bk"]),
                   slots=int(d.get("slots", 2)),
                   grid_order=str(d.get("grid_order", "ijk")))


@dataclasses.dataclass(frozen=True)
class Problem:
    """A shape-bucketed matmul (or attention) instance the tuner
    optimises for."""

    op: str                      # "matmul" | "grouped_matmul" | "attention"
    M: int
    N: int
    K: int
    dtype_bytes: int = 2
    groups: int = 1              # grouped_matmul only

    @property
    def flops(self) -> float:
        return 2.0 * self.groups * self.M * self.N * self.K


class KernelSpace:
    """Enumerator of the candidates the port's kernels take (see the
    module docstring)."""

    def __init__(self, *, rows: tuple[int, ...] | None = None,
                 bn_options: tuple[int, ...] | None = None,
                 k_bytes: tuple[int, ...] = (128, 256, 384, 512),
                 slot_options: tuple[int, ...] = (1, 2, 3, 4),
                 grid_orders: tuple[str, ...] = ("ijk", "jik"),
                 attention_tiles: tuple[int, ...] | None = None,
                 model: HopperPipelineModel | None = None):
        from repro_torch.kernels import flash_attention as fa
        from repro_torch.kernels import zero_stall_matmul as zs
        self.rows = tuple(sorted(rows or zs.SM90_ROWS))
        self.bn_options = tuple(sorted(bn_options or zs.SM90_BN))
        if any(b % 128 or not 128 <= b <= 512 for b in k_bytes):
            raise ValueError(f"k tiles {k_bytes} must be 128-byte multiples "
                             f"up to 512 bytes")
        self.k_bytes = tuple(sorted(k_bytes))
        self.slot_options = tuple(sorted(slot_options))
        self.grid_orders = tuple(grid_orders)
        self.attention_tiles = tuple(sorted(attention_tiles
                                            or fa.TC_TILES))
        self.model = model or HopperPipelineModel()

    # ------------------------------------------------------------------
    def k_tiles(self, dtype_bytes: int) -> tuple[int, ...]:
        """The dtype axis: k tiles of ``k_bytes`` at this operand width."""
        return tuple(b // dtype_bytes for b in self.k_bytes)

    def orders(self, problem: Problem) -> tuple[str, ...]:
        return ("ijk",) if problem.op == "grouped_matmul" \
            else self.grid_orders

    def feasible(self, c: Candidate, problem: Problem) -> bool:
        """Whether the wrapper of the problem's design takes ``c``."""
        from repro_torch.kernels import zero_stall_matmul as zs
        if (c.slots not in self.slot_options
                or c.grid_order not in self.orders(problem)
                or c.bm not in self.rows or c.bn not in self.bn_options
                or c.bk not in self.k_tiles(problem.dtype_bytes)):
            return False
        eb = problem.dtype_bytes
        sm90 = self.model.design(eb, problem.K, problem.N) == "sm90"
        if sm90 and c.bm != self.rows[-1] and \
                c.bm >= zs.sm90_rows(problem.M, self.rows[-1]):
            return False            # the same launch as the largest bm
        gran = 8 if eb == 4 else 32
        if not sm90 and c.bm > max(gran, -(-problem.M // gran) * gran):
            return False            # the ring runs bm rows: padding only
        box = 128 // eb
        if c.bk > max(box, -(-problem.K // box) * box):
            return False            # a stage of padding only
        if c.bn > max(self.bn_options[0], -(-problem.N // 64) * 64):
            return False            # weight rows of padding only
        if (problem.M <= _DECODE_ROWS and c.slots < 2
                and max(self.slot_options) >= 2):
            return False            # the decode path runs the ring
        dtype = _DTYPES[eb]
        try:
            if sm90:
                zs._check_sm90_config(problem.M, c.bm, c.bn, c.bk, c.slots,
                                      dtype)
            else:
                zs._check_config(c.bm, c.bn, c.bk, c.slots, dtype, False)
        except ValueError:
            return False
        return True

    def candidates(self, problem: Problem) -> Iterator[Candidate]:
        """All legal candidates, the default first, then a deterministic
        order."""
        default = self.default(problem)
        if self.feasible(default, problem):
            yield default
        for bm, bn, bk, slots, order in itertools.product(
                self.rows, self.bn_options,
                self.k_tiles(problem.dtype_bytes), self.slot_options,
                self.orders(problem)):
            c = Candidate(bm, bn, bk, slots, order)
            if c != default and self.feasible(c, problem):
                yield c

    def size(self, problem: Problem) -> int:
        return sum(1 for _ in self.candidates(problem))

    def default(self, problem: Problem) -> Candidate:
        """The port's fixed configuration (``KernelConfig()``) as a
        candidate: 128 x 128 tiles, 256 bytes of k a stage, two slots."""
        cfg = KernelConfig()
        return Candidate(cfg.bm, cfg.bn,
                         cfg.resolved_bk(_DTYPES[problem.dtype_bytes]),
                         cfg.resolved_slots, cfg.grid_order)

    def corners(self, problem: Problem) -> list[Candidate]:
        """Scattered hill-climbing seeds: the smallest and largest tiles
        at the shallowest and deepest rings (feasible ones only)."""
        ks = self.k_tiles(problem.dtype_bytes)
        out = []
        for i in (0, -1):
            for s in (self.slot_options[0], self.slot_options[-1]):
                c = Candidate(self.rows[i], self.bn_options[i], ks[i], s,
                              self.grid_orders[0])
                if self.feasible(c, problem):
                    out.append(c)
        return out

    def neighbors(self, c: Candidate, problem: Problem
                  ) -> Iterator[Candidate]:
        """Single-axis moves for hill-climbing."""
        def moves(options, cur):
            if cur in options:
                idx = options.index(cur)
                for j in (idx - 1, idx + 1):
                    if 0 <= j < len(options):
                        yield options[j]
            else:
                yield options[0]

        for bm in moves(self.rows, c.bm):
            yield Candidate(bm, c.bn, c.bk, c.slots, c.grid_order)
        for bn in moves(self.bn_options, c.bn):
            yield Candidate(c.bm, bn, c.bk, c.slots, c.grid_order)
        for bk in moves(self.k_tiles(problem.dtype_bytes), c.bk):
            yield Candidate(c.bm, c.bn, bk, c.slots, c.grid_order)
        for slots in moves(self.slot_options, c.slots):
            yield Candidate(c.bm, c.bn, c.bk, slots, c.grid_order)
        for order in self.orders(problem):
            if order != c.grid_order:
                yield Candidate(c.bm, c.bn, c.bk, c.slots, order)

    # ------------------------------------------------------------------
    def attention_feasible(self, bq: int, bkv: int, *, s_q: int, s_kv: int,
                           head_dim: int, dtype_bytes: int = 2) -> bool:
        """Whether flash attention takes tiles ``(bq, bkv)`` at this
        shape, after :func:`fit_tiles` (a tile fit down to its sequence
        is the same launch as the fitted one, so only fixed points
        count)."""
        from repro_torch.kernels import flash_attention as fa
        dtype = _DTYPES[dtype_bytes]
        if fa.fit_tiles(dtype, s_q, s_kv, bq, bkv) != (bq, bkv):
            return False
        if fa.design(dtype) == "tensor_core":
            try:
                fa.check_tc_tiles(head_dim, bq, bkv)
            except ValueError:
                return False
        return fa.smem_bytes(head_dim, bq, bkv, dtype) <= fa.SMEM_LIMIT

    def attention_candidates(self, *, s_q: int, s_kv: int, head_dim: int,
                             dtype_bytes: int = 2
                             ) -> Iterator[tuple[int, int]]:
        """Legal ``(bq, bkv)``: the default first (fitted to the
        shape), then the tile grid."""
        from repro_torch.kernels import flash_attention as fa
        cfg = KernelConfig()
        first = fa.fit_tiles(_DTYPES[dtype_bytes], s_q, s_kv, cfg.bq,
                             cfg.bkv)
        kw = dict(s_q=s_q, s_kv=s_kv, head_dim=head_dim,
                  dtype_bytes=dtype_bytes)
        if self.attention_feasible(*first, **kw):
            yield first
        for bq, bkv in itertools.product(self.attention_tiles, repeat=2):
            if (bq, bkv) != first and self.attention_feasible(bq, bkv,
                                                              **kw):
                yield bq, bkv


#: The Hopper space the kernels on the card are tuned in.
DEFAULT_SPACE = KernelSpace()

#: A small space for tests (the counterpart of the JAX package's
#: ``INTERPRET_SPACE``): two row tiles, two k tiles, two ring depths.
SMALL_SPACE = KernelSpace(rows=(32, 128), k_bytes=(128, 256),
                          slot_options=(1, 2), grid_orders=("ijk",))
