"""Core: the paper's contribution, adapted to Hopper execution (the port
of ``repro.core``).

- loopnest:   zero-overhead loop-nest IR (FREP sequencer analogue)
- pipeline:   dobu revolving-buffer schedules (zero-conflict analogue)
- cyclemodel: the Hopper pipeline model of the port's kernels (the
              counterpart of the JAX package's TPU model) and the
              paper's Snitch cluster model
"""

from repro_torch.core.cyclemodel import (SNITCH_CONFIGS, HopperParams,
                                         HopperPipelineModel, KernelEstimate,
                                         MatmulResult, SnitchClusterModel,
                                         SnitchConfig)
from repro_torch.core.loopnest import Loop, LoopNest, matmul_nest
from repro_torch.core.pipeline import DobuSchedule, Phase, RevolvingSchedule

__all__ = [
    "Loop", "LoopNest", "matmul_nest",
    "DobuSchedule", "RevolvingSchedule", "Phase",
    "HopperParams", "HopperPipelineModel", "KernelEstimate",
    "SnitchConfig", "SNITCH_CONFIGS", "SnitchClusterModel", "MatmulResult",
]
