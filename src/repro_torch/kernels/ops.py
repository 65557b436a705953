"""Kernel entry points with backend dispatch (the port of ``repro.kernels.ops``).

Model code calls these; they route to

  * backend ``"auto"``: the hand-written kernel wrappers
    (:mod:`~repro_torch.kernels.zero_stall_matmul`,
    :mod:`~repro_torch.kernels.grouped_matmul`,
    :mod:`~repro_torch.kernels.quantized_matmul`,
    :mod:`~repro_torch.kernels.flash_attention`,
    :mod:`~repro_torch.kernels.paged_attention`), which launch the CUDA
    kernel on a CUDA tensor and run their plain version on a CPU tensor;
    on a meta tensor (a plan's trace, shapes only) the entry point
    returns an empty result of the kernel's shape and records the launch
    geometry the wrapper would run (:mod:`~repro_torch.kernels.meta`),
    in place of the launch;
  * backend ``"torch"``: the plain versions in :mod:`.ref` on any device
    (the counterpart of the JAX package's ``"jnp"``).

Execution configuration: the single ``config`` argument
(:mod:`repro_torch.plan`), resolved ahead of the kernel launch like the
paper's loop-nest CSR writes, with the JAX package's vocabulary:

  * ``None``: the fixed default ``KernelConfig()``;
  * ``"auto"``: resolve through :mod:`repro_torch.tune` (the Hopper
    model's search, memoized in a persistent cache); a backend name
    (``"auto"`` or ``"torch"``) sets the backend;
  * ``(bm, bn, bk)``: explicit matmul tiles (``(bq, bkv)`` for
    :func:`attention`);
  * a :class:`~repro_torch.plan.KernelConfig`: one complete configuration,
    backend included;
  * a :class:`~repro_torch.plan.Plan`: per-call-site lookup by bucketed
    ``OpKey``; misses follow the plan's default policy and are memoized,
    so a traced plan never consults the tuner at run time.

DTensor operands (a model placed across ranks,
:mod:`repro_torch.runtime.sharding`): on the ``"auto"`` backend the four
matmul entry points run their kernels on each rank's local shards and
wrap the result back with the placements DTensor's own ``mm`` / ``bmm``
strategy gives (:func:`_on_shards`); the int8 ones quantize the
activation's rows on the DTensor first, so a row's scale is its global
absmax even where its contraction is sharded.  Attention reaches its
kernel on local shards through ``sharding.map_heads``, so
:func:`attention` itself takes no DTensor; :func:`paged_attention`
refuses one (paged serving across ranks is refused, as in the JAX
package).  No entry point falls back to a plain version on a DTensor; on
the ``"torch"`` backend DTensors run the plain versions through
DTensor's own operators (the dry run).

Resolution happens on the kernel path whatever the tensors' device (the
CPU and the meta device included), so a trace on the CPU resolves the
call sites the card runs; the plain ``"torch"`` backend resolves
nothing, as the JAX package's ``"jnp"``.  int8 products resolve as
``matmul`` / ``grouped_matmul`` at dtype ``int8``; paged attention takes
no tiles (its config selects the backend only).  Each entry point
reports its dispatch to :mod:`repro_torch.obs.kernel_watch` when
observability is on.  The kernels mask ragged edges themselves, so
nothing is padded.
"""

from __future__ import annotations

import contextlib
import warnings

import torch

from repro_torch import obs as _obs
from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import grouped_matmul as _grouped
from repro_torch.kernels import meta as _meta
from repro_torch.kernels import paged_attention as _pa
from repro_torch.kernels import quantized_matmul as _quant
from repro_torch.kernels import ref as _ref
from repro_torch.kernels import zero_stall_matmul as _zs
from repro_torch.kernels.flash_attention import flash_attention as _flash
from repro_torch.kernels.flash_attention import fit_tiles
from repro_torch.kernels.grouped_matmul import grouped_zero_stall_matmul
from repro_torch.kernels.paged_attention import paged_attention as _paged
from repro_torch.kernels.quantized_matmul import (
    quantized_grouped_zero_stall_matmul, quantized_zero_stall_matmul)
from repro_torch.kernels.zero_stall_matmul import zero_stall_matmul
from repro_torch.plan.config import KernelConfig, OpKey, dtype_from_name, \
    dtype_name
from repro_torch.plan.plan import Plan, config_backend, resolve
from repro_torch.quant.tensor import QTensor, k_major, quantize_rows
from repro_torch.runtime.sharding import (from_replicated, is_dtensor,
                                          reduce_partial)

__all__ = ["matmul", "grouped_matmul", "quantized_matmul",
           "quantized_grouped_matmul", "attention", "paged_attention",
           "host_tiled_matmul", "fallback_counts", "reset_fallback_warnings",
           "strict_fallbacks", "FallbackError"]


def _record(op: str, *, M, N, K, dtype, backend, config=None, groups=1,
            batch_heads=1) -> None:
    """Report this dispatch to :mod:`repro_torch.obs.kernel_watch` (when
    observability is on; off, one boolean check)."""
    if _obs.enabled():
        _obs.record_dispatch(op, M=M, N=N, K=K, dtype=dtype,
                             backend=backend, config=config, groups=groups,
                             batch_heads=batch_heads)


def _out_dtype(out_dtype, config, key: tuple, default: torch.dtype):
    """The output dtype priority of every matmul entry point: the
    argument, then the config's ``out_dtype`` (for a Plan: the entry of
    the call site ``key`` = (op, M, N, K, groups, dtype name), a pure
    lookup with no tuning, then its default config), then ``default``."""
    if out_dtype is not None:
        return out_dtype
    candidates = []
    if isinstance(config, KernelConfig):
        candidates.append(config)
    elif isinstance(config, Plan):
        if config.entries:
            op, M, N, K, groups, dtype = key
            hit = config.lookup(OpKey(op, M, N, K, groups=groups,
                                      dtype=dtype))
            if hit is not None:
                candidates.append(hit)
        if isinstance(config.default, KernelConfig):
            candidates.append(config.default)
    for cfg in candidates:
        if cfg.out_dtype is not None:
            return dtype_from_name(cfg.out_dtype)
    return default


def _dtensors(*xs) -> bool:
    return any(type(x) is not torch.Tensor and is_dtensor(x) for x in xs)


def _on_shards(a: torch.Tensor, b: torch.Tensor, run, *,
               out_dtype: torch.dtype, trans_b: bool = False,
               b_scale: torch.Tensor | None = None) -> torch.Tensor:
    """A product ``a (..., M, K) @ b (..., K, N)`` of DTensor operands (a
    plain operand counts as replicated), 2-D (``mm``) or with a leading
    group dim on both (``bmm``, the expert banks), run on each rank's
    local shards and wrapped back as a DTensor with the placements of
    DTensor's own strategy, a mesh dim at a time: rows of ``a`` sharded
    give rows, columns of ``b`` give columns, groups sharded on both give
    groups, the contraction sharded on both gives a ``Partial`` sum, and
    a partial operand against a replicated one stays partial.  Where one
    operand is sharded on the contraction or the groups and the other
    replicated, the replicated one is sliced to match (a local slice, as
    DTensor does).  Any other pair gathers (or reduces) ``a``, the
    activation, on that mesh dim first, never the weight; a pair that
    still has no local form raises ``ValueError``.  A partial sum of an
    fp32 output is reduced where the next constraint asks for it; one of
    a narrower ``out_dtype`` is computed in fp32, reduced at once and then
    rounded, so that the ranks' partials are rounded once, as one rank
    rounds its sum (an int8 product's codes downstream move with a
    rounding).

    ``run(local a, local b, dtype)`` computes a local product in
    ``dtype``; with ``b_scale`` (the per-column scales of int8 codes
    ``b``, (..., 1, N)) ``a`` is an activation, quantized per row here on
    the DTensor (so a row's scale is its global absmax, whichever dim is
    sharded), and ``run(local codes, local b, local row scales, local
    b_scale, dtype)``."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    mesh = (a if _dtensors(a) else b).device_mesh
    a = a if _dtensors(a) else from_replicated(a, mesh)
    b = b if _dtensors(b) else from_replicated(b, mesh)
    nd = a.ndim
    grouped = nd == 3
    ma, ka = nd - 2, nd - 1
    kb, nb = (nd - 1, nd - 2) if trans_b else (nd - 2, nd - 1)

    def local_form(x, y):
        """(a's, b's, the output's placement) of a local product, with
        a replicated operand sliced to match its partner, or None."""
        if x.is_shard(ka) and y.is_replicate():
            y = Shard(kb)
        elif y.is_shard(kb) and x.is_replicate():
            x = Shard(ka)
        elif grouped and x.is_shard(0) and y.is_replicate():
            y = Shard(0)
        elif grouped and y.is_shard(0) and x.is_replicate():
            x = Shard(0)
        if x.is_replicate() and y.is_replicate():
            return x, y, Replicate()
        if grouped and x.is_shard(0) and y.is_shard(0):
            return x, y, Shard(0)
        if x.is_shard(ma) and y.is_replicate():
            return x, y, Shard(nd - 2)
        if x.is_replicate() and y.is_shard(nb):
            return x, y, Shard(nd - 1)
        if (x.is_shard(ka) and y.is_shard(kb)) or (
                x.is_partial() and y.is_replicate()) or (
                x.is_replicate() and y.is_partial()):
            return x, y, Partial()
        return None

    pa, pb, out = list(a.placements), list(b.placements), []
    for i in range(mesh.ndim):
        form = (local_form(pa[i], pb[i])
                or local_form(Replicate(), pb[i]))
        if form is None:
            raise ValueError(
                f"ops: operands placed {pa[i]} and {pb[i]} on mesh dim "
                f"{mesh.mesh_dim_names[i]!r} have no local product")
        pa[i], pb[i], o = form
        out.append(o)
    if pa != list(a.placements):
        a = a.redistribute(mesh, pa)
    if pb != list(b.placements):
        b = b.redistribute(mesh, pb)
    shape = (*a.shape[:-1], b.shape[nb])
    stride = torch.empty(shape, device="meta").stride()
    dt = (torch.float32 if any(p.is_partial() for p in out)
          else out_dtype)

    def wrap(c):
        c = DTensor.from_local(c, mesh, out, run_check=False, shape=shape,
                               stride=stride)
        return c if dt == out_dtype else reduce_partial(c).to(out_dtype)

    if b_scale is None:
        return wrap(run(a.to_local(), b.to_local(), dt))

    def scale_like(s, pl, dim):
        # the scales of the rows (columns) a local shard holds: sharded
        # where the rows (columns) or the groups are, else replicated
        s = s if _dtensors(s) else from_replicated(s, mesh)
        want = [Shard(dim) if p.is_shard(dim) else
                Shard(0) if grouped and p.is_shard(0) else Replicate()
                for p in pl]
        if list(s.placements) != want:
            s = s.redistribute(mesh, want)
        return s.to_local()

    a_q, a_s = quantize_rows(a)
    return wrap(run(a_q.to_local(), b.to_local(), scale_like(a_s, pa, ma),
                    scale_like(b_scale.to(torch.float32), pb, nb), dt))


def matmul(a: torch.Tensor, b: torch.Tensor, *, config=None,
           out_dtype: torch.dtype | None = None,
           trans_b: bool = False) -> torch.Tensor:
    """C = A @ B through the zero-stall engine.

    Every linear layer routes here (``models.layers.linear``).  The
    output dtype follows one priority: the ``out_dtype`` argument, then
    the config's ``out_dtype``, then A's dtype.  ``trans_b`` takes B as
    (N, K) row-major and computes A @ B.T (the tied LM head).
    DTensor operands run the kernel on each rank's local shards
    (:func:`_on_shards`).
    """
    backend = config_backend(config, "matmul")
    M, K = a.shape
    N = b.shape[0] if trans_b else b.shape[1]
    out_dtype = _out_dtype(out_dtype, config,
                           ("matmul", M, N, K, 1, dtype_name(a.dtype)),
                           a.dtype)
    if backend != "torch" and _dtensors(a, b):
        return _on_shards(a, b, lambda x, y, dt: matmul(
            x, y, config=config, out_dtype=dt, trans_b=trans_b),
            out_dtype=out_dtype, trans_b=trans_b)
    if backend == "torch":
        _record("matmul", M=M, N=N, K=K, dtype=a.dtype, backend=backend)
        return _ref.matmul_ref(a, b.t() if trans_b else b, out_dtype)
    cfg = resolve(config, op="matmul", M=M, N=N, K=K, dtype=a.dtype)
    _record("matmul", M=M, N=N, K=K, dtype=a.dtype, backend=backend,
            config=cfg)
    if a.is_meta:
        _meta.note(lambda: _zs.launch_geometry(
            M, N, K, dtype=a.dtype, trans_b=trans_b, sms=_zs.sms_of(a.device),
            **cfg.matmul_kwargs(a.dtype)))
        return a.new_empty((M, N), dtype=out_dtype)
    return zero_stall_matmul(a.contiguous(), b, out_dtype=out_dtype,
                             trans_b=trans_b,
                             **cfg.matmul_kwargs(a.dtype))


def grouped_matmul(a: torch.Tensor, b: torch.Tensor, *, config=None,
                   out_dtype: torch.dtype | None = None) -> torch.Tensor:
    """(G, M, K) @ (G, K, N) -> (G, M, N) per-expert matmul through the
    grouped zero-stall engine (the MoE dispatch path,
    ``models.moe.moe_mlp``).  Same ``config`` vocabulary and out_dtype
    priority as :func:`matmul`; DTensor operands run each rank's groups
    and columns (:func:`_on_shards`)."""
    backend = config_backend(config, "grouped_matmul")
    G, M, K = a.shape
    N = b.shape[2]
    out_dtype = _out_dtype(out_dtype, config,
                           ("grouped_matmul", M, N, K, G, dtype_name(a.dtype)),
                           a.dtype)
    if backend != "torch" and _dtensors(a, b):
        return _on_shards(a, b, lambda x, y, dt: grouped_matmul(
            x, y, config=config, out_dtype=dt), out_dtype=out_dtype)
    if backend == "torch":
        _record("grouped_matmul", M=M, N=N, K=K, dtype=a.dtype,
                backend=backend, groups=G)
        return _ref.grouped_matmul_ref(a, b, out_dtype)
    cfg = resolve(config, op="grouped_matmul", M=M, N=N, K=K, dtype=a.dtype,
                  groups=G)
    _record("grouped_matmul", M=M, N=N, K=K, dtype=a.dtype, backend=backend,
            config=cfg, groups=G)
    if a.is_meta:
        _meta.note(lambda: _grouped.launch_geometry(
            G, M, N, K, dtype=a.dtype, sms=_zs.sms_of(a.device),
            **cfg.matmul_kwargs(a.dtype, grouped=True)))
        return a.new_empty((G, M, N), dtype=out_dtype)
    return grouped_zero_stall_matmul(
        a.contiguous(), b.contiguous(), out_dtype=out_dtype,
        **cfg.matmul_kwargs(a.dtype, grouped=True))


def _check_qtensor(qw) -> None:
    if not isinstance(qw, QTensor):
        raise TypeError(f"qw must be a QTensor, got {type(qw).__name__}")


def quantized_matmul(x: torch.Tensor, qw: QTensor, *, config=None,
                     out_dtype: torch.dtype | None = None) -> torch.Tensor:
    """C = x @ qw through the int8 zero-stall engine (W8A8).

    ``x`` (M, K) is a full-precision activation, quantized per row here,
    outside the kernel (:func:`~repro_torch.quant.quantize_rows`, as in
    the JAX package); ``qw`` a :class:`~repro_torch.quant.QTensor`.  The
    kernel accumulates in exact int32 and fuses the dequantising
    epilogue.  The output dtype priority is that of :func:`matmul`; the
    call site resolves as ``matmul`` at dtype ``int8`` (the int8 tile
    space, whose plan entries never collide with bf16's).  An fp8
    QTensor takes the simulated-fp8 route: dequantize to x's dtype and
    run :func:`matmul`.  DTensor operands (``x`` and the QTensor's codes
    and scales) run each rank's local shards (:func:`_on_shards`), with
    every row's scale taken over its whole contraction.
    """
    _check_qtensor(qw)
    if qw.fmt != "int8":
        return matmul(x, qw.dequantize(x.dtype), config=config,
                      out_dtype=out_dtype)
    return _int8_product("matmul", x, qw, config, out_dtype)


def quantized_grouped_matmul(x: torch.Tensor, qw: QTensor, *, config=None,
                             out_dtype: torch.dtype | None = None
                             ) -> torch.Tensor:
    """(G, M, K) activations @ a QTensor (G, K, N) expert bank (W8A8
    MoE), with the contracts of :func:`quantized_matmul` (resolved as
    ``grouped_matmul`` at dtype ``int8``); an fp8 bank dequantizes onto
    :func:`grouped_matmul`."""
    _check_qtensor(qw)
    if qw.fmt != "int8":
        return grouped_matmul(x, qw.dequantize(x.dtype), config=config,
                              out_dtype=out_dtype)
    return _int8_product("grouped_matmul", x, qw, config, out_dtype)


def _int8_product(op: str, x: torch.Tensor, qw: QTensor, config,
                  out_dtype: torch.dtype | None) -> torch.Tensor:
    """The int8 product of :func:`quantized_matmul` (``op`` "matmul") or
    :func:`quantized_grouped_matmul` ("grouped_matmul")."""
    backend = config_backend(config, op)
    if backend != "torch" and _dtensors(x, qw.data, qw.scale):
        G = x.shape[0] if op == "grouped_matmul" else 1
        M, K = x.shape[-2:]
        od = _out_dtype(out_dtype, config, (op, M, qw.shape[-1], K, G,
                                            "int8"), x.dtype)
        # a local slice of the codes along K is no longer K-major, as
        # the kernels read B: it is copied so (a no-op for any other)
        return _on_shards(x, qw.data, lambda x_q, b, x_s, w_s, dt:
                          _int8_local(op, x_q, x_s, k_major(b), w_s, config,
                                      dt, x.dtype),
                          out_dtype=od, b_scale=qw.scale)
    x_q, x_s = quantize_rows(x)
    return _int8_local(op, x_q, x_s, qw.data, qw.scale, config, out_dtype,
                       x.dtype)


def _int8_local(op: str, x_q: torch.Tensor, x_s: torch.Tensor,
                codes: torch.Tensor, w_s: torch.Tensor, config,
                out_dtype: torch.dtype | None,
                dtype: torch.dtype) -> torch.Tensor:
    """The int8 product of row-quantized activation codes ``x_q`` (scales
    ``x_s``) and weight codes ``codes`` (scales ``w_s``) on one device;
    ``dtype`` is the activation's, the output's default."""
    backend = config_backend(config, op)
    grouped = op == "grouped_matmul"
    G = x_q.shape[0] if grouped else 1
    M, K = x_q.shape[-2:]
    N = codes.shape[-1]
    out_dtype = _out_dtype(out_dtype, config, (op, M, N, K, G, "int8"),
                           dtype)
    w_s = w_s.to(torch.float32)
    if backend == "torch":
        _record(op, M=M, N=N, K=K, dtype="int8", backend=backend, groups=G)
        ref = (_ref.quantized_grouped_matmul_ref if grouped
               else _ref.quantized_matmul_ref)
        return ref(x_q, codes, x_s, w_s, out_dtype)
    cfg = resolve(config, op=op, M=M, N=N, K=K, dtype=torch.int8, groups=G)
    _record(op, M=M, N=N, K=K, dtype="int8", backend=backend, config=cfg,
            groups=G)
    kw = cfg.matmul_kwargs(torch.int8, grouped=grouped)
    if x_q.is_meta:
        sms = _zs.sms_of(x_q.device)
        _meta.note(lambda: _quant.grouped_launch_geometry(
            G, M, N, K, sms=sms, **kw) if grouped else
            _quant.launch_geometry(M, N, K, sms=sms, **kw))
        return x_q.new_empty((*x_q.shape[:-1], N), dtype=out_dtype)
    kernel = (quantized_grouped_zero_stall_matmul if grouped
              else quantized_zero_stall_matmul)
    return kernel(x_q, codes, x_s, w_s.contiguous(), out_dtype=out_dtype,
                  **kw)


_FALLBACK_PREFIX = "ops.fallback."
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
    _obs.reset_counters(_FALLBACK_PREFIX)


def fallback_counts() -> dict[str, int]:
    """{fallback key -> times taken} since the last reset.

    Every occurrence increments an always-on :mod:`repro_torch.obs`
    counter under ``ops.fallback.``, so runs and tests can assert
    ``ops.fallback_counts() == {}``.  Counts are per Python call of an
    entry point: a CUDA graph that captured a fallback counted it once,
    at its capture, and its replays add nothing (the JAX package counts
    once per trace of a compiled program)."""
    pre = _FALLBACK_PREFIX
    return {k[len(pre):]: v for k, v in _obs.counters(pre).items()}


def _warn_fallback_once(key: str, reason: str,
                        strict: bool | None = None) -> None:
    """Count a fallback every time, warn once per key, and raise
    :class:`FallbackError` under strict mode unless allowlisted."""
    _obs.counter_inc(_FALLBACK_PREFIX + key)
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

    ``config`` follows the module vocabulary (tile tuples are ``(bq,
    bkv)`` pairs here; a KernelConfig contributes its ``bq``/``bkv``);
    the resolved tiles are fit to the sequences (:func:`fit_tiles`).
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
    reference on a CPU tensor (resolving nothing, recorded as
    ``"torch"``, as the JAX package records its fallback as ``"jnp"``)
    and raises on a CUDA one.
    """
    backend = config_backend(config, "attention")
    if backend != "torch" and _dtensors(q, k, v):
        raise ValueError(
            "ops.attention takes local tensors: run it on each rank's "
            "batch and head shards through sharding.map_heads")
    B, H, Sq, D = q.shape
    Skv = k.shape[2]
    rec = dict(M=Sq, N=D, K=Skv, dtype=q.dtype, batch_heads=B * H)
    if backend == "torch":
        _record("attention", backend=backend, **rec)
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
            if q.device.type == "cuda":
                raise ValueError(
                    f"ops.attention: causal attention with Sq={Sq} > "
                    f"Skv={Skv} and no length operands has rows that see no "
                    f"key; pass q_lens/kv_lens/q_offsets to run the kernel")
            _record("attention", backend="torch", **rec)
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
    cfg = resolve(config, op="attention", M=Sq, N=D, K=Skv, dtype=q.dtype,
                  batch_heads=B * H)
    _record("attention", backend=backend, config=cfg, **rec)
    bq, bkv = fit_tiles(q.dtype, Sq, Skv, cfg.bq, cfg.bkv)
    if q.is_meta:
        _meta.note(lambda: _fa.launch_geometry(B, H, Sq, Skv, D, dtype=q.dtype,
                                               bq=bq, bkv=bkv, causal=causal))
        return torch.empty_like(q)
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


def paged_attention(q: torch.Tensor, k_pool: torch.Tensor,
                    v_pool: torch.Tensor, page_table: torch.Tensor, *,
                    kv_lens: torch.Tensor, config=None,
                    scale: float | None = None) -> torch.Tensor:
    """Decode attention over a paged KV pool (see
    :mod:`repro_torch.kernels.paged_attention`).

    ``q`` (B, H, D) holds the batch's last-position queries, ``k_pool``
    / ``v_pool`` (P, ps, KV, D) the shared page pool, ``page_table``
    (B, T) each slot's logical -> physical pages and ``kv_lens`` (B,)
    the valid kv extents.  ``config`` only selects the backend: the page
    geometry is the schedule (one page per step), so there is no tile
    to resolve and no fallback rule.  The dispatch is recorded as an
    ``attention`` of M = H // KV query rows over K = T * ps keys, as in
    the JAX package.
    """
    backend = config_backend(config, "attention")
    if backend != "torch" and _dtensors(q, k_pool, v_pool):
        raise NotImplementedError(
            "ops.paged_attention on DTensors: paged serving across ranks is "
            "refused (ShardedEngine takes no page_size, as in the JAX "
            "package)")
    B, H, D = q.shape
    ps, KV = k_pool.shape[1], k_pool.shape[2]
    T = page_table.shape[1]
    _record("attention", M=H // KV, N=D, K=T * ps, dtype=q.dtype,
            backend=backend, batch_heads=B * KV)
    if backend == "torch":
        return _ref.paged_attention_ref(q, k_pool, v_pool, page_table,
                                        kv_lens=kv_lens, scale=scale)
    if q.is_meta:
        _meta.note(lambda: _pa.launch_geometry(
            B, H, D, KV, T, ps, elt=q.element_size(),
            sms=_zs.sms_of(q.device)))
        return torch.empty_like(q)
    return _paged(q, k_pool, v_pool, page_table, kv_lens=kv_lens,
                  scale=scale)


def _mm_fp32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """One tile product accumulated in fp32 (``preferred_element_type``
    in JAX): cuBLAS reads the bf16 tiles as they are on the card; the
    host's mm has no fp32 output for them, so it widens the tiles
    first (exact)."""
    if a.dtype == torch.float32:
        return torch.mm(a, b)
    if a.is_cuda:
        return torch.mm(a, b, out_dtype=torch.float32)
    return torch.mm(a.float(), b.float())


def host_tiled_matmul(a: torch.Tensor, b: torch.Tensor, *, bm: int = 128,
                      bn: int = 128, bk: int = 128) -> torch.Tensor:
    """Pre-ZONL baseline: a software-managed tile loop.

    The host walks the (i, j, k) tile nest itself, one ``torch.mm`` on
    tile slices a tile, accumulating in fp32, instead of a kernel's
    grid sequencing it: the analogue of Snitch's bookkeeping
    instructions an outer iteration, which zero-overhead loop nests
    remove.  Benchmarks use it to measure that win; the math is
    :func:`matmul`'s.  Deliberately outside the plan and config API, as
    in the JAX package: this is the old world the plan replaces, and no
    kernel of the port runs it.
    """
    (M, K), (_, N) = a.shape, b.shape
    if M % bm or N % bn or K % bk:
        raise ValueError(f"host_tiled_matmul: shape {(M, K, N)} not tiled "
                         f"by (bm, bn, bk)={(bm, bn, bk)}")
    c = torch.zeros((M, N), dtype=torch.float32, device=a.device)
    for i in range(M // bm):
        rows = slice(i * bm, (i + 1) * bm)
        for j in range(N // bn):
            cols = slice(j * bn, (j + 1) * bn)
            for k in range(K // bk):
                ks = slice(k * bk, (k + 1) * bk)
                c[rows, cols] += _mm_fp32(a[rows, ks], b[ks, cols])
    return c.to(a.dtype)
