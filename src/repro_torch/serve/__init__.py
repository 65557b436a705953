from repro_torch.serve.engine import ServeEngine, lockstep_generate
from repro_torch.serve.request import GenerationResult, Request
from repro_torch.serve.stats import EngineStats

__all__ = ["EngineStats", "GenerationResult", "Request", "ServeEngine",
           "lockstep_generate"]
