"""Runtime (the port of ``repro.runtime``): fault tolerance
(:class:`ResilientExecutor`: retry, checkpoint-restart, re-queue,
heartbeats, straggler detection) and the sharding rules
(:mod:`repro_torch.runtime.sharding`: partition specs over a mesh).
Pipeline parallelism and ``elastic_restore`` exist only across devices
and are not ported yet."""

from repro_torch.runtime.fault_tolerance import (Heartbeat, ResilientExecutor,
                                                 RetryPolicy,
                                                 StragglerDetector,
                                                 TransientError)

__all__ = ["ResilientExecutor", "RetryPolicy", "StragglerDetector",
           "Heartbeat", "TransientError"]
