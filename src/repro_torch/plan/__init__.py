from repro_torch.plan.config import (BACKENDS, KernelConfig, dtype_from_name,
                                    dtype_name, resolve_slots)

__all__ = ["BACKENDS", "KernelConfig", "dtype_from_name", "dtype_name",
           "resolve_slots"]
