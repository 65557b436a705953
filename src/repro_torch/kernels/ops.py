"""Kernel entry points with backend dispatch (the port of ``repro.kernels.ops``).

Model code calls these; they route to

  * backend ``"auto"``: the hand-written kernel wrappers
    (:mod:`~repro_torch.kernels.zero_stall_matmul`,
    :mod:`~repro_torch.kernels.flash_attention`), which launch the CUDA
    kernel on a CUDA tensor and run their plain version on a CPU tensor;
  * backend ``"torch"``: the plain versions in :mod:`.ref` on any device
    (the counterpart of the JAX package's ``"jnp"``).

``config`` is ``None`` (the default :class:`KernelConfig`), a backend
name, or a :class:`KernelConfig`.  The kernels mask ragged edges
themselves, so nothing is padded.
"""

from __future__ import annotations

import contextlib
import warnings

import torch

from repro_torch.kernels import ref as _ref
from repro_torch.kernels.flash_attention import flash_attention as _flash
from repro_torch.kernels.zero_stall_matmul import zero_stall_matmul
from repro_torch.plan.config import KernelConfig, dtype_from_name

__all__ = ["matmul", "attention", "as_config", "fallback_counts",
           "reset_fallback_warnings", "strict_fallbacks", "FallbackError"]


def as_config(config) -> KernelConfig:
    """Normalise the ``config`` vocabulary to one :class:`KernelConfig`."""
    if config is None:
        return KernelConfig()
    if isinstance(config, KernelConfig):
        return config
    if isinstance(config, str):
        return KernelConfig(backend=config)
    raise ValueError(f"config must be a KernelConfig, a backend name or "
                     f"None, got {config!r}")


def matmul(a: torch.Tensor, b: torch.Tensor, *, config=None,
           out_dtype: torch.dtype | None = None,
           trans_b: bool = False) -> torch.Tensor:
    """C = A @ B through the zero-stall engine.

    Every linear layer routes here (``models.layers.linear``).  The
    output dtype follows one priority: the ``out_dtype`` argument, then
    the config's ``out_dtype``, then A's dtype.  ``trans_b`` takes B as
    (N, K) row-major and computes A @ B.T (the tied LM head).
    """
    cfg = as_config(config)
    if out_dtype is None and cfg.out_dtype is not None:
        out_dtype = dtype_from_name(cfg.out_dtype)
    if cfg.backend == "torch":
        return _ref.matmul_ref(a, b.t() if trans_b else b, out_dtype)
    return zero_stall_matmul(a.contiguous(), b, out_dtype=out_dtype,
                             trans_b=trans_b,
                             **cfg.matmul_kwargs(a.dtype))


_FALLBACK_COUNTS: dict[str, int] = {}
_FALLBACK_WARNED: set[str] = set()
_STRICT = {"on": False, "allow": ()}


class FallbackError(RuntimeError):
    """An ops.* entry point would leave the kernel path (strict mode)."""


@contextlib.contextmanager
def strict_fallbacks(enable: bool = True, *, allow: tuple[str, ...] = ()):
    """Treat any kernel fallback as an error inside this context;
    ``allow`` lists fallback keys that stay on warn-once behaviour."""
    prev = dict(_STRICT)
    _STRICT.update(on=bool(enable), allow=tuple(allow))
    try:
        yield
    finally:
        _STRICT.update(prev)


def reset_fallback_warnings() -> None:
    """Forget which fallbacks have warned and zero their counters."""
    _FALLBACK_WARNED.clear()
    _FALLBACK_COUNTS.clear()


def fallback_counts() -> dict[str, int]:
    """{fallback key -> times taken} since the last reset."""
    return dict(_FALLBACK_COUNTS)


def _warn_fallback_once(key: str, reason: str,
                        strict: bool | None = None) -> None:
    """Count a fallback every time, warn once per key, and raise
    :class:`FallbackError` under strict mode unless allowlisted."""
    _FALLBACK_COUNTS[key] = _FALLBACK_COUNTS.get(key, 0) + 1
    if strict is None:
        strict = _STRICT["on"]
    if strict and key not in _STRICT["allow"]:
        raise FallbackError(
            f"ops fallback {key!r}: {reason} (strict mode: allowlist the key "
            f"via strict_fallbacks(allow=...) if this is intentional)")
    if key not in _FALLBACK_WARNED:
        _FALLBACK_WARNED.add(key)
        warnings.warn(f"ops.attention: {reason}", RuntimeWarning,
                      stacklevel=3)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              config=None, causal: bool = True, scale: float | None = None,
              q_lens: torch.Tensor | None = None,
              kv_lens: torch.Tensor | None = None,
              q_offsets: torch.Tensor | None = None,
              strict: bool | None = None) -> torch.Tensor:
    """(B,H,S,D) flash attention; the plain reference on the torch path.

    ``q_lens``/``kv_lens``: optional (B,) valid lengths; ``q_offsets``:
    optional (B,) absolute position of query row 0.  Causal attention
    with Sq != Skv and no length operand follows the reference's
    documented dispatch rule: it is counted under
    ``attention_causal_unaligned`` (a :class:`FallbackError` under strict
    mode) and warned about once, because the kernel's causal mask is
    start-aligned and the reference's end-aligned.  With Sq < Skv the
    kernel then runs end-aligned, through ``q_offsets = Skv - Sq``.  With
    Sq > Skv the leading rows see no key at all, which the reference
    averages uniformly and the kernel zeroes: that case runs the plain
    reference on a CPU tensor and raises on a CUDA one.
    """
    cfg = as_config(config)
    B, H, Sq, D = q.shape
    Skv = k.shape[2]
    if cfg.backend == "torch":
        return _ref.flash_attention_ref(q, k, v, causal=causal, scale=scale,
                                        q_lens=q_lens, kv_lens=kv_lens,
                                        q_offsets=q_offsets)
    if (causal and Sq != Skv and q_lens is None and kv_lens is None
            and q_offsets is None):
        if Sq > Skv:
            _warn_fallback_once("attention_causal_unaligned",
                                "causal attention with Sq > Skv and no "
                                "length operands has ambiguous alignment; "
                                "falling back to the plain reference",
                                strict=strict)
            if q.device.type != "cpu":
                raise ValueError(
                    f"ops.attention: causal attention with Sq={Sq} > "
                    f"Skv={Skv} and no length operands has rows that see no "
                    f"key; pass q_lens/kv_lens/q_offsets to run the kernel")
            return _ref.flash_attention_ref(q, k, v, causal=causal,
                                            scale=scale)
        _warn_fallback_once("attention_causal_unaligned",
                            "causal attention with Sq < Skv and no length "
                            "operands has ambiguous alignment; the kernel "
                            "runs it end-aligned (q_offsets = Skv - Sq)",
                            strict=strict)
        q_offsets = torch.full((B,), Skv - Sq, dtype=torch.int32,
                               device=q.device)
        q_lens = kv_lens = torch.full((B,), Skv, dtype=torch.int32,
                                      device=q.device)
    bq, bkv = min(cfg.bq, Sq), min(cfg.bkv, Skv)
    if Sq % bq or Skv % bkv:
        # ragged tiles: the lengths default to the unragged extents
        # (absolute, so offsets shift them); the kernel masks the edge
        if q_lens is None:
            q_lens = torch.full((B,), Sq, dtype=torch.int32, device=q.device)
            if q_offsets is not None:
                q_lens = q_lens + q_offsets.to(q.device)
        if kv_lens is None:
            kv_lens = torch.full((B,), Skv, dtype=torch.int32,
                                 device=q.device)
    return _flash(q, k, v, q_lens=q_lens, kv_lens=kv_lens,
                  q_offsets=q_offsets, bq=bq, bkv=bkv, causal=causal,
                  scale=scale)
