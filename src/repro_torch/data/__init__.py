"""Input pipeline (the port of ``repro.data``): deterministic synthetic
token streams, seeded per step, so restarts replay the same batches."""

from repro_torch.data.pipeline import (DataConfig, SyntheticTokenPipeline,
                                       make_pipeline)

__all__ = ["DataConfig", "SyntheticTokenPipeline", "make_pipeline"]
