from repro_torch.configs.base import (SHAPES, ModelConfig, RunConfig,
                                     ShapeSpec, get_config, list_configs,
                                     input_specs, register, token_count)

__all__ = ["ModelConfig", "RunConfig", "ShapeSpec", "SHAPES", "get_config",
           "list_configs", "register", "token_count", "input_specs"]
