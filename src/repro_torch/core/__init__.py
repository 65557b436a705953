"""Core: the paper's contribution, adapted to Hopper execution (the port
of ``repro.core``).

- loopnest:   zero-overhead loop-nest IR (FREP sequencer analogue)
- pipeline:   dobu revolving-buffer schedules (zero-conflict analogue)
- cyclemodel: the Hopper pipeline model of the port's kernels (the
              counterpart of the JAX package's TPU model)
"""

from repro_torch.core.cyclemodel import (HopperParams, HopperPipelineModel,
                                         KernelEstimate)
from repro_torch.core.loopnest import Loop, LoopNest, matmul_nest
from repro_torch.core.pipeline import DobuSchedule, Phase, RevolvingSchedule

__all__ = [
    "Loop", "LoopNest", "matmul_nest",
    "DobuSchedule", "RevolvingSchedule", "Phase",
    "HopperParams", "HopperPipelineModel", "KernelEstimate",
]
