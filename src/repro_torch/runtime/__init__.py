"""Runtime (the port of ``repro.runtime``): fault tolerance
(:class:`ResilientExecutor`: retry, checkpoint-restart, re-queue,
heartbeats, straggler detection; :func:`elastic_restore`: a checkpoint
restored onto another mesh of ranks), the sharding rules
(:mod:`repro_torch.runtime.sharding`: partition specs over a mesh and
DTensor placement) and pipeline parallelism (:func:`pp_loss_fn`: GPipe
over a mesh axis of ranks)."""

from repro_torch.runtime.fault_tolerance import (Heartbeat, ResilientExecutor,
                                                 RetryPolicy,
                                                 StragglerDetector,
                                                 TransientError,
                                                 elastic_restore)
from repro_torch.runtime.pipeline_parallel import (pp_loss_fn,
                                                   split_layers_for_stages)

__all__ = ["ResilientExecutor", "RetryPolicy", "StragglerDetector",
           "Heartbeat", "TransientError", "elastic_restore", "pp_loss_fn",
           "split_layers_for_stages"]
