"""Roofline terms of a traced program on the H100 (the port of
``repro.core.roofline``).

JAX's dry run lowers and compiles every (arch x shape x mesh) cell and
derives the roofline terms from the compiled module.  The port traces
the cell's step eagerly, on ``meta`` tensors, under
:mod:`repro_torch.core.trace_costs`, and derives the same terms:

    compute term    = FLOPs / (chips * peak FLOP/s)
    memory term     = bytes / (chips * HBM bytes/s)
    collective term = collective bytes / (chips * link bytes/s)

The counter sees one rank's local ops, so its figures are multiplied by
``chips`` to get module totals before the formulas apply (JAX's
convention).  Collective bytes carry JAX's traffic weights: an
all-reduce moves 2x its input (ring reduce-scatter + all-gather), an
all-gather its gathered output, reduce-scatter, all-to-all and
collective-permute their input.

Hardware constants: one NVIDIA H100 80GB HBM3 (SXM) at a 700.00 W power
limit, as ``nvidia-smi --query-gpu=name,power.limit
--format=csv,noheader`` prints it.  ``peak_flops`` (dense bf16) and
``hbm_bw`` are :class:`~repro_torch.core.cyclemodel.HopperParams`'s, so
the tuner's model and the roofline read one source.
"""

from __future__ import annotations

import dataclasses

from repro_torch.core.cyclemodel import HopperParams
from repro_torch.core.trace_costs import TraceCosts

__all__ = ["HW", "CollectiveStats", "RooflineReport", "analyze_trace",
           "collective_stats", "model_flops"]

_H100 = HopperParams()


@dataclasses.dataclass(frozen=True)
class HW:
    # NVIDIA H100 80GB HBM3, 700.00 W: the dense bf16 tensor-core rate
    peak_flops: float = _H100.peak("bfloat16")
    # NVIDIA H100 80GB HBM3, 700.00 W: HBM3 bytes/s
    hbm_bw: float = _H100.hbm_bw
    # NVIDIA H100 80GB HBM3 (SXM), 700.00 W: NVLink 4, 900 GB/s a card
    # (18 links), the counterpart of JAX's per-chip ICI figure
    link_bw: float = 900e9
    # NVIDIA H100 80GB HBM3, 700.00 W:
    # torch.cuda.get_device_properties(0).total_memory
    hbm_bytes: int = 85_017_493_504


@dataclasses.dataclass
class CollectiveStats:
    bytes_by_kind: dict[str, float]
    count_by_kind: dict[str, int]

    @property
    def total_bytes(self) -> float:
        return sum(self.bytes_by_kind.values())


def collective_stats(costs: TraceCosts) -> CollectiveStats:
    """The collectives the trace recorded (the counterpart of JAX's
    ``parse_collective_bytes`` over HLO text): weighted bytes and counts
    by JAX's kind names."""
    return CollectiveStats(dict(costs.collective_by_kind),
                           dict(costs.collective_count))


@dataclasses.dataclass
class RooflineReport:
    name: str
    chips: int
    # module totals (per-device figures x chips)
    hlo_flops: float
    hlo_bytes: float
    collective_bytes: float
    collectives: CollectiveStats
    per_device_bytes_peak: float    # argument + output + temp bytes
    model_flops_useful: float = 0.0
    hw: HW = dataclasses.field(default_factory=HW)

    @property
    def t_compute(self) -> float:
        return self.hlo_flops / (self.chips * self.hw.peak_flops)

    @property
    def t_memory(self) -> float:
        return self.hlo_bytes / (self.chips * self.hw.hbm_bw)

    @property
    def t_collective(self) -> float:
        return self.collective_bytes / (self.chips * self.hw.link_bw)

    @property
    def bottleneck(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)

    @property
    def roofline_fraction(self) -> float:
        """max(term)/sum(terms): 1.0 = perfectly overlapped single bound."""
        s = self.t_compute + self.t_memory + self.t_collective
        if s == 0:
            return 0.0
        return max(self.t_compute, self.t_memory, self.t_collective) / s

    @property
    def useful_flop_ratio(self) -> float:
        """MODEL_FLOPS / traced FLOPs: catches remat and redundant work."""
        if self.hlo_flops == 0:
            return 0.0
        return self.model_flops_useful / self.hlo_flops

    def row(self) -> dict:
        return {
            "cell": self.name,
            "chips": self.chips,
            "t_compute_s": self.t_compute,
            "t_memory_s": self.t_memory,
            "t_collective_s": self.t_collective,
            "bottleneck": self.bottleneck,
            "roofline_fraction": self.roofline_fraction,
            "hlo_gflops": self.hlo_flops / 1e9,
            "hlo_gbytes": self.hlo_bytes / 1e9,
            "coll_gbytes": self.collective_bytes / 1e9,
            "useful_flop_ratio": self.useful_flop_ratio,
            "peak_device_bytes": self.per_device_bytes_peak,
        }


def analyze_trace(name: str, costs: TraceCosts, chips: int, *,
                  model_flops_useful: float = 0.0,
                  hw: HW | None = None) -> RooflineReport:
    """A :class:`RooflineReport` from one rank's :class:`TraceCosts`
    (JAX's ``analyze_compiled`` over a compiled module)."""
    coll = collective_stats(costs)
    return RooflineReport(
        name=name, chips=chips,
        hlo_flops=costs.flops * chips,
        hlo_bytes=costs.bytes * chips,
        collective_bytes=coll.total_bytes * chips,
        collectives=coll,
        per_device_bytes_peak=float(sum(
            costs.memory.get(k, 0) for k in ("argument", "output", "temp"))),
        model_flops_useful=model_flops_useful,
        hw=hw or HW())


def model_flops(n_params_active: float, tokens: float, *,
                train: bool = True) -> float:
    """Useful model FLOPs: 6*N*D for training, 2*N*D for inference."""
    return (6.0 if train else 2.0) * n_params_active * tokens
