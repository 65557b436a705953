from repro_torch.serve.engine import ServeEngine, lockstep_generate
from repro_torch.serve.paging import (TRASH_PAGE, OutOfPages, PageAllocator,
                                      PageGeometry, PrefixCache)
from repro_torch.serve.request import GenerationResult, Request
from repro_torch.serve.stats import EngineStats

__all__ = ["EngineStats", "GenerationResult", "OutOfPages", "PageAllocator",
           "PageGeometry", "PrefixCache", "Request", "ServeEngine",
           "TRASH_PAGE", "lockstep_generate"]
