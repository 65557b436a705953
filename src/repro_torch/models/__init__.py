from repro_torch.models.layers import Ctx
from repro_torch.models.model import Model, build_model

__all__ = ["Ctx", "Model", "build_model"]
