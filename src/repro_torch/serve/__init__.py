from repro_torch.serve.cluster import (ReplicaTimeout, RequeueExhausted,
                                       Router, ShardedEngine)
from repro_torch.serve.engine import ServeEngine, lockstep_generate
from repro_torch.serve.paging import (TRASH_PAGE, OutOfPages, PageAllocator,
                                      PageGeometry, PrefixCache)
from repro_torch.serve.request import GenerationResult, Request
from repro_torch.serve.stats import EngineStats

__all__ = ["EngineStats", "GenerationResult", "OutOfPages", "PageAllocator",
           "PageGeometry", "PrefixCache", "ReplicaTimeout",
           "RequeueExhausted", "Request", "Router", "ServeEngine",
           "ShardedEngine", "TRASH_PAGE", "lockstep_generate"]
