"""Checkpointing (the port of ``repro.checkpoint``): async (a background
thread behind a synchronous device-to-host copy), atomic (tmp directory
+ rename), keep-k garbage collected."""

from repro_torch.checkpoint.checkpointer import Checkpointer

__all__ = ["Checkpointer"]
