"""Convert the JAX package's parameters, given as numpy arrays, to the port's.

The caller turns the JAX pytree into numpy first
(``jax.tree.map(np.asarray, params)``), so this module needs neither
JAX nor ml_dtypes: a bfloat16 array is recognised by its dtype name and
reinterpreted through a uint16 view.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig

__all__ = ["params_from_numpy", "tensor_from_numpy"]


def tensor_from_numpy(a: Any, device=None) -> torch.Tensor:
    """One numpy array (fp32, int, or ml_dtypes bfloat16) -> tensor on
    ``device`` (None: the card, as every entry point of the port)."""
    device = resolve_device(device)
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(np.ascontiguousarray(a).view(np.uint16).copy())
        t = t.view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(a, copy=True))
    return t.to(device)


def _tree(x: Any, device) -> Any:
    if isinstance(x, dict):
        return {k: _tree(v, device) for k, v in x.items()}
    return tensor_from_numpy(x, device)


def params_from_numpy(tree: dict, cfg: ModelConfig, *, device=None) -> dict:
    """JAX dense-family params (numpy leaves) -> the port's params.

    The JAX package stacks every per-layer leaf along a leading
    ``n_layers`` axis (``params["layers"]``); the port keeps a list of
    per-layer dicts, so that axis is unstacked here.  The tensors land
    on ``device`` (None: the card; pass ``device="cpu"`` for the host).
    """
    device = resolve_device(device)
    def unstack(x: Any, i: int) -> Any:
        if isinstance(x, dict):
            return {k: unstack(v, i) for k, v in x.items()}
        a = np.asarray(x)
        if a.shape[0] != cfg.n_layers:
            raise ValueError(f"layer leaf of shape {a.shape} does not lead "
                             f"with n_layers={cfg.n_layers}")
        return tensor_from_numpy(a[i], device)

    return {
        "embed": _tree(tree["embed"], device),
        "layers": [unstack(tree["layers"], i) for i in range(cfg.n_layers)],
        "final_norm": _tree(tree["final_norm"], device),
    }
