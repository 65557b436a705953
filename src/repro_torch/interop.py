"""Convert the JAX package's parameters, given as numpy arrays, to the
port's, and back (:func:`params_to_numpy`).

The caller turns the JAX pytree into numpy first
(``jax.tree.map(np.asarray, params)``), so this module needs neither
JAX nor ml_dtypes: a bfloat16 array is recognised by its dtype name and
reinterpreted through a uint16 view, an fp8 (e4m3) array through a uint8
view.  A quantized tree's ``QTensor`` leaves come through
``jax.tree.map`` as QTensors holding numpy arrays; they are recognised
by their attributes (``data``, ``scale``, ``fmt``, ``w8a8``), since
``repro.quant`` may not be imported here, and become the port's
:class:`~repro_torch.quant.QTensor` with its K-major codes.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.quant.tensor import QTensor, k_major

__all__ = ["params_from_numpy", "params_to_numpy", "tensor_from_numpy"]


def tensor_from_numpy(a: Any, device=None) -> torch.Tensor:
    """One numpy array (fp32, int, or ml_dtypes bfloat16) -> tensor on
    ``device`` (None: the card, as every entry point of the port)."""
    device = resolve_device(device)
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(np.ascontiguousarray(a).view(np.uint16).copy())
        t = t.view(torch.bfloat16)
    elif a.dtype.name == "float8_e4m3fn":
        t = torch.from_numpy(np.ascontiguousarray(a).view(np.uint8).copy())
        t = t.view(torch.float8_e4m3fn)
    else:
        t = torch.from_numpy(np.array(a, copy=True))
    return t.to(device)


def _is_qtensor(x: Any) -> bool:
    # an array is never one; asking a bfloat16 array for its ``data``
    # buffer raises ValueError, which hasattr does not catch
    if isinstance(x, (np.ndarray, np.generic)):
        return False
    return all(hasattr(x, a) for a in ("data", "scale", "fmt", "w8a8"))


def _leaf(x: Any, device, take=lambda a: a) -> Any:
    """One leaf (``take`` picks its layer slice): an array, or a
    QTensor-like whose codes are stored K-major."""
    if _is_qtensor(x):
        data = tensor_from_numpy(take(np.asarray(x.data)), device)
        return QTensor(k_major(data),
                       tensor_from_numpy(take(np.asarray(x.scale)), device),
                       x.fmt, bool(x.w8a8))
    return tensor_from_numpy(take(np.asarray(x)), device)


def _tree(x: Any, device) -> Any:
    if isinstance(x, dict):
        return {k: _tree(v, device) for k, v in x.items()}
    return _leaf(x, device)


def params_from_numpy(tree: dict, cfg: ModelConfig, *, device=None) -> dict:
    """JAX params of any family (numpy leaves) -> the port's params.

    The JAX package stacks every per-layer leaf along leading axes:
    ``(n_layers, ...)`` under ``params["layers"]`` for the dense, vlm,
    MoE and SSM families, ``(n_layers / attn_every, attn_every, ...)``
    for the hybrid's groups of mamba layers, and ``(encoder_layers,
    ...)`` under ``"encoder"`` and ``(decoder_layers, ...)`` under
    ``"decoder"`` for the encdec family.  The port keeps a list of
    per-layer dicts (a list of such lists for the hybrid), so those axes
    are unstacked here (for the MoE router and expert banks as for any
    leaf, and for a QTensor's codes and scales alike); a leaf whose
    leading axes are not these raises.  The hybrid's ``shared`` block
    and the encdec ``enc_norm`` convert as plain trees, and an untied LM
    head is stored K-major (the transposed view of a contiguous (V, d)
    buffer, the layout the port's ``unembed`` reads).  The tensors land
    on ``device`` (None: the card; pass ``device="cpu"`` for the host).
    """
    device = resolve_device(device)

    def unstack(x: Any, idx: tuple[int, ...], lead, what) -> Any:
        if isinstance(x, dict):
            return {k: unstack(v, idx, lead, what) for k, v in x.items()}
        shape = np.shape(x.data if _is_qtensor(x) else x)
        if tuple(shape[:len(lead)]) != lead:
            raise ValueError(f"layer leaf of shape {shape} does not lead "
                             f"with {what}")
        return _leaf(x, device, lambda a: a[idx])

    def stack(name: str, n: int, what: str) -> list:
        return [unstack(tree[name], (i,), (n,), f"{what}={n}")
                for i in range(n)]

    embed = _tree(tree["embed"], device)
    if "lm_head" in embed:
        embed["lm_head"] = k_major(embed["lm_head"])
    out = {"embed": embed, "final_norm": _tree(tree["final_norm"], device)}
    if cfg.family == "encdec":
        out["encoder"] = stack("encoder", cfg.encoder_layers,
                               "encoder_layers")
        out["decoder"] = stack("decoder", cfg.decoder_layers,
                               "decoder_layers")
        out["enc_norm"] = _tree(tree["enc_norm"], device)
    elif cfg.family == "hybrid":
        lead = (cfg.n_layers // cfg.attn_every, cfg.attn_every)
        what = f"(n_layers / attn_every, attn_every)={lead}"
        out["layers"] = [[unstack(tree["layers"], (g, i), lead, what)
                          for i in range(lead[1])] for g in range(lead[0])]
    else:
        out["layers"] = stack("layers", cfg.n_layers, "n_layers")
    if "shared" in tree:
        out["shared"] = _tree(tree["shared"], device)
    return out


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        # a bfloat16 numpy dtype exists once ml_dtypes is loaded (JAX
        # loads it); the words are copied as they are
        return t.view(torch.int16).numpy().view(np.dtype("bfloat16"))
    return t.numpy().copy()


def params_to_numpy(params: dict, cfg: ModelConfig) -> dict:
    """The port's params -> JAX's layout with numpy leaves: the inverse
    of :func:`params_from_numpy` for plain (unquantized) trees.  The
    per-layer lists are stacked back along JAX's leading axes
    (``(n_layers, ...)``, the hybrid's ``(n_layers / attn_every,
    attn_every, ...)``, the encdec's encoder and decoder stacks), and an
    untied LM head comes back in its logical (d, V) shape, so a tree of
    the port (gradients, moments, updated parameters) compares leaf by
    leaf with JAX's."""
    def tree(x: Any) -> Any:
        if isinstance(x, dict):
            return {k: tree(v) for k, v in x.items()}
        return _to_numpy(x)

    def stack(items: list) -> Any:
        if isinstance(items[0], dict):
            return {k: stack([it[k] for it in items]) for k in items[0]}
        if isinstance(items[0], list):
            return stack([stack(it) for it in items])
        return np.stack([it if isinstance(it, np.ndarray) else _to_numpy(it)
                         for it in items])

    out = {"embed": tree(params["embed"]),
           "final_norm": tree(params["final_norm"])}
    if cfg.family == "encdec":
        out["encoder"] = stack(params["encoder"])
        out["decoder"] = stack(params["decoder"])
        out["enc_norm"] = tree(params["enc_norm"])
    else:
        out["layers"] = stack(params["layers"])
    if "shared" in params:
        out["shared"] = tree(params["shared"])
    return out
