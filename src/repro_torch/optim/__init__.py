"""Optimizers (the port of ``repro.optim``): AdamW + gradient compression.

AdamW (decoupled weight decay, global-norm clipping, warmup-cosine
schedule) on the parameter trees the models emit, in place for the
train loop and functional as JAX's, plus
:mod:`repro_torch.optim.compression`: int8 / top-k gradient codecs with
error feedback.
"""

from repro_torch.optim import compression
from repro_torch.optim.adamw import (OptState, adamw_update, adamw_update_,
                                     clip_by_global_norm, global_norm,
                                     init_opt_state, make_schedule)

__all__ = ["OptState", "adamw_update", "adamw_update_", "init_opt_state",
           "make_schedule", "global_norm", "clip_by_global_norm",
           "compression"]
