"""Model building blocks (plain functions on tensors).

The port of ``repro.models.layers`` for the dense decoder.  Every
matmul routes through :mod:`repro_torch.kernels.ops`, so the zero-stall
kernels (int8 ones for QTensor weights under ``plan.quant="int8"``) are
the compute path on the card.  Params are plain nested dicts
of tensors with the JAX package's names and ``(d_in, d_out)`` weight
layout; the tied embedding table stays ``(vocab, d_model)`` and the LM
head reads it through the kernel's transposed-B layout.

``Ctx.mesh`` carries JAX's activation sharding constraints
(:func:`shard_seq`, :func:`shard_act`, :func:`_head_shard`, the
merged-head attention of :func:`_merged_head_plan`): on DTensors each
constraint is a redistribution to the placements JAX's ``P(...)`` names
(:func:`repro_torch.runtime.sharding.constrain`), and a weight sharded
over ``data`` is gathered at its use (``sharding.gather_fsdp``); on plain
tensors they return their input.  The merged-head plan reads only the
mesh's shape, so under a mesh it pads the heads of plain tensors too.
With ``mesh=None`` nothing changes.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch import obs
from repro_torch.configs.base import ModelConfig
from repro_torch.core.trace_costs import counted_times
from repro_torch.kernels import ops
from repro_torch.kernels.ref import NEG_INF
from repro_torch.plan.plan import Plan, as_plan
from repro_torch.quant.tensor import QTensor
from repro_torch.runtime.sharding import (P, constrain, gather_fsdp,
                                          gather_inner, is_dtensor,
                                          label_logits, like, map_heads,
                                          reduce_partial, split_columns,
                                          write_row)

__all__ = ["Ctx", "Params", "linear", "rms_norm", "rope", "attention",
           "attention_decode", "attention_decode_paged",
           "attention_decode_quantized", "mlp", "embed", "unembed",
           "gather_last", "cross_entropy", "shard_seq", "shard_act"]

Params = dict[str, Any]


@dataclasses.dataclass(frozen=True)
class Ctx:
    """Per-call execution context.

    ``plan`` is the one execution-configuration field
    (:mod:`repro_torch.plan`): a backend name (``"auto"``, kernel configs
    tuned per call site through :mod:`repro_torch.tune` and memoized
    into the plan; ``"torch"``, the plain versions), a
    :class:`~repro_torch.plan.KernelConfig` (one fixed config
    everywhere), a :class:`~repro_torch.plan.Plan` (a per-call-site
    table, e.g. from :func:`repro_torch.plan.trace_model`), a tile
    tuple, or ``None`` (the fixed default ``KernelConfig()``).  It is
    normalized to a ``Plan`` at construction; quantized execution is the
    plan's ``quant`` field.  ``dtype`` is the compute dtype.  ``mesh``
    (a :class:`repro_torch.launch.mesh.Mesh`, or anything with its
    ``axis_names`` and ``devices.shape``), when set, applies the
    activation sharding constraints (module docstring).
    """
    plan: Any = "auto"
    dtype: torch.dtype = torch.bfloat16
    mesh: Any = None

    def __post_init__(self):
        object.__setattr__(self, "plan", as_plan(self.plan))

    def with_plan(self, plan) -> "Ctx":
        """This context with a different execution plan."""
        return Ctx(plan=plan, dtype=self.dtype, mesh=self.mesh)


def _sizes(mesh) -> dict[str, int]:
    return dict(zip(mesh.axis_names, mesh.devices.shape))


def _dp(mesh) -> tuple[tuple, int]:
    """The data-parallel axes of ``mesh`` and the product of their sizes."""
    sizes = _sizes(mesh)
    dp = tuple(a for a in ("pod", "data") if a in sizes)
    n = 1
    for a in dp:
        n *= sizes[a]
    return dp, n


def shard_seq(x: torch.Tensor, ctx: Ctx) -> torch.Tensor:
    """Sequence-parallel constraint on a (B, S, d) activation: batch over
    the DP axes, sequence over 'model' (Megatron SP).

    Applied at layer boundaries and on the attention / MLP block
    outputs: on a block output (a partial sum over 'model' under TP) it
    is the reduce-scatter of the Megatron form, where replicating would
    be an all-reduce followed by a slice."""
    if ctx.mesh is None or x.ndim != 3:
        return x
    sizes = _sizes(ctx.mesh)
    dp, dp_size = _dp(ctx.mesh)
    b_ax = dp if dp_size > 1 and x.shape[0] >= dp_size else None
    s_ax = ("model" if "model" in sizes and x.shape[1] >= sizes["model"]
            else None)
    if b_ax is None and s_ax is None:
        return x
    return constrain(x, P(b_ax, s_ax, None))


def shard_act(x: torch.Tensor, ctx: Ctx) -> torch.Tensor:
    """Sequence-parallel constraint at a layer boundary: the residual
    (B, S, d), the backward pass's dominant live state, is held with its
    sequence over 'model'.  JAX also pins the carry with an optimization
    barrier against XLA hoisting the fp32 upcast of the saved-residual
    stack out of its layer scan; an eager program hoists nothing, so
    this is :func:`shard_seq`."""
    return shard_seq(x, ctx)


def _head_shard(t: torch.Tensor, ctx: "Ctx | None") -> torch.Tensor:
    """Constrain a (B, S, H, D) attention tensor to head-TP layout (heads
    over 'model', batch over the DP axes when it divides), so the score
    products contract locally instead of over a sharded dim."""
    if ctx is None or ctx.mesh is None or "model" not in ctx.mesh.axis_names:
        return t
    sizes = _sizes(ctx.mesh)
    if t.shape[2] % sizes["model"] != 0:
        return t
    dp, dps = _dp(ctx.mesh)
    b_ax = dp if t.shape[0] % dps == 0 and dps > 1 else None
    return constrain(t, P(b_ax, None, "model", None))


def _seq_shard4(t: torch.Tensor, ctx: "Ctx | None") -> torch.Tensor:
    """Pin a (B, S, KV, D) tensor to the SP layout (S over 'model'), batch
    over the DP axes when it divides.  The reference defines it beside
    :func:`_head_shard` and calls it nowhere; so does the port."""
    if ctx is None or ctx.mesh is None or "model" not in ctx.mesh.axis_names:
        return t
    sizes = _sizes(ctx.mesh)
    if t.shape[1] % sizes["model"] != 0:
        return t
    dp, dps = _dp(ctx.mesh)
    b_ax = dp if t.shape[0] % dps == 0 and dps > 1 else None
    return constrain(t, P(b_ax, "model", None, None))


def _merged_head_plan(n_heads: int, kv_heads: int, ctx: Ctx) -> int | None:
    """Whether attention takes the merged-head TP form, and its head pad.

    The reference uses it only where the grouped form cannot shard and
    padding is cheap: heads and KV heads both indivisible by the 'model'
    axis (deepseek's and llava's 56 heads pad to 64 on a 16-way axis,
    +14% attention FLOPs), the pad at most 25% (qwen's 40 -> 80 keeps the
    grouped form), and never on a multi-pod mesh.  None: the grouped
    form; else the number of zero query heads to append."""
    if (ctx.mesh is None or "model" not in ctx.mesh.axis_names
            or "pod" in ctx.mesh.axis_names):
        return None
    tp = _sizes(ctx.mesh)["model"]
    if n_heads % tp == 0 or kv_heads % tp == 0:
        return None          # the grouped form shards already
    target = n_heads
    while target % tp or (kv_heads and (target % kv_heads)):
        target += 1
    if target > n_heads * 1.25:
        return None          # the pad would cost too much
    return target - n_heads


def linear(p: Params, x: torch.Tensor, ctx: Ctx) -> torch.Tensor:
    """x: (..., d_in) @ w -> (..., d_out) through the zero-stall engine.

    A :class:`~repro_torch.quant.QTensor` weight
    (``Model.quantize_weights``) dispatches on ``ctx.plan.quant``:
    ``"int8"`` runs an int8 W8A8 weight on the int8 kernel (per-row
    activation quantization, fused dequantising epilogue); anything else
    dequantizes the weight and runs the standard kernel.  Parameters
    built by the port already hold the compute dtype, so the cast of a
    plain weight is a no-op on the serving path (the JAX code casts fp32
    parameters on every call).  A ``b`` leaf (``init_linear(bias=True)``)
    is cast to ``ctx.dtype`` and added after the product, as in JAX."""
    x = gather_inner(x)
    w = split_columns(gather_fsdp(p["w"]), x, -1)
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1])
    if isinstance(w, QTensor):
        if ctx.plan.quant == "int8" and w.fmt == "int8" and w.w8a8:
            y = ops.quantized_matmul(x2, w, config=ctx.plan,
                                     out_dtype=ctx.dtype)
        else:
            y = ops.matmul(x2, w.dequantize(ctx.dtype), config=ctx.plan,
                           out_dtype=ctx.dtype)
    else:
        y = ops.matmul(x2, w.to(ctx.dtype), config=ctx.plan,
                       out_dtype=ctx.dtype)
    y = y.reshape(*lead, w.shape[-1])
    if "b" in p:
        y = y + p["b"].to(ctx.dtype)
    return y


def rms_norm(p: Params, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    xf = x.to(torch.float32)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * p["scale"].to(torch.float32)).to(x.dtype)


def rope(x: torch.Tensor, positions: torch.Tensor,
         theta: float) -> torch.Tensor:
    """x: (B, S, H, D); positions: (B, S) or (S,)."""
    half = x.shape[-1] // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                    device=x.device) / half)
    ang = positions[..., None].to(torch.float32) * freqs
    cos = torch.cos(ang)[..., None, :]
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                     dim=-1).to(x.dtype)


def _qkv(p: Params, x: torch.Tensor, cfg: ModelConfig, ctx: Ctx):
    B, S, _ = x.shape
    hd = cfg.resolved_head_dim
    q = linear(p["wq"], x, ctx).reshape(B, S, cfg.n_heads, hd)
    k = linear(p["wk"], x, ctx).reshape(B, S, cfg.n_kv_heads, hd)
    v = linear(p["wv"], x, ctx).reshape(B, S, cfg.n_kv_heads, hd)
    return q, k, v


def _lengths_mask(S: int, T: int, lengths: torch.Tensor, causal: bool,
                  offsets: torch.Tensor | None = None) -> torch.Tensor:
    """(B, S, T) validity mask for per-sequence valid lengths, in
    absolute positions (query row i == position ``offsets[b] + i``)."""
    dev = lengths.device
    rows = torch.arange(S, device=dev)[:, None]
    if offsets is not None:
        rows = rows[None] + offsets[:, None, None]
    cols = torch.arange(T, device=dev)[None, :]
    m = (rows < lengths[:, None, None]) & (cols < lengths[:, None, None])
    if causal:
        m = m & (rows >= cols)
    return torch.broadcast_to(m, (lengths.shape[0], S, T))


def _gqa_full(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool, config: Plan,
              lengths: torch.Tensor | None = None,
              q_offset: torch.Tensor | None = None,
              ctx: Ctx | None = None) -> torch.Tensor:
    """q: (B,S,H,D), k/v: (B,T,KV,D) -> (B,S,H,D).

    On the ``"auto"`` backend the KV heads are repeated up to H and the
    flash kernel runs in (B, H, S, D) layout with ``lengths`` as both its
    q and kv lengths.  On the ``"torch"`` backend the grouped einsum of
    the JAX package's plain path runs (no head materialisation), or,
    given a ``ctx`` with a mesh (callers gate it through
    :func:`_merged_head_plan`), the merged-head form: KV heads repeated
    up to H and q, K and V held head-sharded, so the one head dim shards
    over 'model'.  ``lengths``: optional (B,) valid lengths, rows/cols at
    >= length masked, fully-masked rows zero; ``q_offset``: optional (B,)
    absolute position of query row 0.  Past the reference's threshold
    (no ``lengths``, S x T above ``_ATTN_CHUNK_ELEMS``, S and T multiples
    of the 1024-row chunks) the ``"torch"`` backend runs the reference's
    blockwise forms instead (:func:`_gqa_chunked`, merged-head
    :func:`_mha_chunked`), which never hold the whole score matrix.  On
    DTensors every form, the kernel's too, runs on each rank's batch and
    head shards (:func:`repro_torch.runtime.sharding.map_heads`).
    """
    if config.backend == "auto":
        return map_heads(functools.partial(_gqa_full_kernel, causal=causal,
                                           config=config),
                         q, k, v, lengths, q_offset)
    rep = q.shape[2] // k.shape[2]
    merged = ctx is not None and ctx.mesh is not None
    if merged:
        k = _head_shard(torch.repeat_interleave(k, rep, dim=2), ctx)
        v = _head_shard(torch.repeat_interleave(v, rep, dim=2), ctx)
        q = _head_shard(q, ctx)
    S, T = q.shape[1], k.shape[1]
    if (lengths is None and S * T > _ATTN_CHUNK_ELEMS
            and S % _Q_CHUNK == 0 and T % _KV_CHUNK == 0):
        return map_heads(functools.partial(
            _mha_chunked if merged else _gqa_chunked, causal=causal),
            q, k, v)
    return map_heads(functools.partial(_gqa_full_grouped, causal=causal),
                     q, k, v, lengths, q_offset)


def _gqa_full_kernel(q, k, v, lengths, q_offset, *, causal: bool,
                     config: Plan) -> torch.Tensor:
    """:func:`_gqa_full`'s ``"auto"`` backend on local tensors: the KV
    heads repeated up to H and the flash kernel in (B, H, S, D)
    layout."""
    rep = q.shape[2] // k.shape[2]
    if rep > 1:
        k = torch.repeat_interleave(k, rep, dim=2)
        v = torch.repeat_interleave(v, rep, dim=2)
    o = ops.attention(q.transpose(1, 2).contiguous(),
                      k.transpose(1, 2).contiguous(),
                      v.transpose(1, 2).contiguous(), config=config,
                      causal=causal, q_lens=lengths, kv_lens=lengths,
                      q_offsets=q_offset)
    return o.transpose(1, 2)


def _gqa_full_grouped(q, k, v, lengths, q_offset, *,
                      causal: bool) -> torch.Tensor:
    """The einsums of :func:`_gqa_full`'s ``"torch"`` backend, grouped
    over the KV heads (no head materialisation; the merged-head form is
    this with K and V repeated to q's heads)."""
    B, S, H, D = q.shape
    KV, T = k.shape[2], k.shape[1]
    rep = H // KV
    qg = q.reshape(B, S, KV, rep, D)
    logits = torch.einsum("bskrd,btkd->bkrst", qg.to(torch.float32),
                          k.to(torch.float32)) * (D ** -0.5)
    if lengths is not None:
        m = _lengths_mask(S, T, lengths, causal, q_offset)
        logits = torch.where(m[:, None, None], logits, NEG_INF)
    elif causal:
        mask = torch.ones((S, T), dtype=torch.bool,
                          device=q.device).tril(T - S)
        logits = torch.where(mask, logits, NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    o = torch.einsum("bkrst,btkd->bskrd", probs.to(v.dtype), v)
    if lengths is not None:
        o = torch.where(m.any(-1)[:, :, None, None, None], o,
                        torch.zeros((), dtype=o.dtype, device=o.device))
    return o.reshape(B, S, H, D)


# the reference's chunk rule: the whole (S, T) score matrix only up to
# this element count; past it 1024-row q blocks over 1024-row kv blocks
_ATTN_CHUNK_ELEMS = 1024 * 1024
_Q_CHUNK = 1024
_KV_CHUNK = 1024


def _online_block(q_blk: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  qi: int, *, causal: bool, kv_chunk: int, scores: str,
                  values: str) -> torch.Tensor:
    """One q block of the blockwise forms against every kv block in turn
    (the reference's inner scan, the masked blocks included): the online
    softmax in fp32, the causal fill against absolute row and column
    indices, ``den == 0`` guarded.  ``scores`` / ``values`` are the two
    einsums, whose score axes are the last two; returns the normalised
    fp32 accumulator.  On ``meta`` tensors (the dry run's trace, shapes
    only) kv steps 1 to the last cost alike: one is traced and counted
    for all
    (``trace_costs.counted_times``)."""
    q_chunk, D = q_blk.shape[1], q_blk.shape[-1]
    scale = D ** -0.5
    qf = q_blk.to(torch.float32)

    def step(kj, state):
        cols = slice(kj * kv_chunk, (kj + 1) * kv_chunk)
        s = torch.einsum(scores, qf, k[:, cols].to(torch.float32)) * scale
        if causal:
            rows = qi * q_chunk + torch.arange(q_chunk, device=s.device)
            keys = kj * kv_chunk + torch.arange(kv_chunk, device=s.device)
            s = torch.where(rows[:, None] >= keys[None, :], s, NEG_INF)
        if state is None:
            m = torch.full_like(s[..., :1], NEG_INF)
            den = torch.zeros_like(m)
            acc = torch.zeros(*s.shape[:-1], D, dtype=torch.float32,
                              device=s.device)
        else:
            m, den, acc = state
        m_new = torch.maximum(m, torch.amax(s, dim=-1, keepdim=True))
        p = torch.exp(s - m_new)
        alpha = torch.exp(m - m_new)
        den = alpha * den + torch.sum(p, dim=-1, keepdim=True)
        acc = acc * alpha + torch.einsum(
            values, p.to(v.dtype).to(torch.float32),
            v[:, cols].to(torch.float32))
        return m_new, den, acc

    nkv = k.shape[1] // kv_chunk
    state = step(0, None)
    if k.is_meta and nkv > 1:
        with counted_times(nkv - 1):
            state = step(1, state)
    else:
        for kj in range(1, nkv):
            state = step(kj, state)
    _, den, acc = state
    return acc / torch.where(den == 0.0, torch.ones_like(den), den)


def _remat_blocks(block, q_blocks, k, v) -> list[torch.Tensor]:
    """``block(qi, q_blk, k, v)`` for each q block, each rematerialised in
    the backward (the reference's ``jax.checkpoint(..., nothing_saveable)``
    on its outer scan's body) when autograd records it.  Unrecorded on
    ``meta`` tensors (a dry run's prefill) the q blocks cost alike: one is
    traced and counted for all, the others allocated."""
    grads = torch.is_grad_enabled() and any(
        t.requires_grad for t in (q_blocks[0], k, v))
    if not grads and q_blocks[0].is_meta:
        with counted_times(len(q_blocks)):
            first = block(0, q_blocks[0], k, v)
        return [first] + [torch.empty_like(first) for _ in q_blocks[1:]]
    if not grads:
        return [block(qi, qb, k, v) for qi, qb in enumerate(q_blocks)]
    return [checkpoint(functools.partial(block, qi), qb, k, v,
                       use_reentrant=False, preserve_rng_state=False)
            for qi, qb in enumerate(q_blocks)]


def _gqa_chunked(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                 causal: bool, q_chunk: int = _Q_CHUNK,
                 kv_chunk: int = _KV_CHUNK) -> torch.Tensor:
    """The reference's blockwise grouped attention, q (B, S, H, D) and
    k, v (B, T, KV, D) -> (B, S, H, D): q blocks outer (rematerialised),
    kv blocks inner with the online softmax, so the (S, T) score matrix
    is never held."""
    B, S, H, D = q.shape
    KV = k.shape[2]
    rep = H // KV

    def block(qi, q_blk, k, v):
        out = _online_block(q_blk, k, v, qi, causal=causal,
                            kv_chunk=kv_chunk, scores="bqkrd,btkd->bkrqt",
                            values="bkrqt,btkd->bkrqd")
        # (B, KV, rep, qc, D) -> (B, qc, KV, rep, D), cast before stacking
        return out.permute(0, 3, 1, 2, 4).to(q.dtype)

    qg = q.reshape(B, S // q_chunk, q_chunk, KV, rep, D)
    blocks = _remat_blocks(block, qg.unbind(1), k, v)
    return torch.stack(blocks, dim=1).reshape(B, S, H, D)


def _mha_chunked(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                 causal: bool, q_chunk: int = _Q_CHUNK,
                 kv_chunk: int = _KV_CHUNK) -> torch.Tensor:
    """The reference's merged-head blockwise attention (q, k, v all (B,
    S|T, H, D), K and V already repeated to q's heads), as
    :func:`_gqa_chunked`."""
    B, S, H, D = q.shape

    def block(qi, q_blk, k, v):
        out = _online_block(q_blk, k, v, qi, causal=causal,
                            kv_chunk=kv_chunk, scores="bqhd,bthd->bhqt",
                            values="bhqt,bthd->bhqd")
        return out.transpose(1, 2).to(q.dtype)     # (B, qc, H, D)

    qg = q.reshape(B, S // q_chunk, q_chunk, H, D)
    blocks = _remat_blocks(block, qg.unbind(1), k, v)
    return torch.stack(blocks, dim=1).reshape(B, S, H, D)


def attention(p: Params, x: torch.Tensor, cfg: ModelConfig, ctx: Ctx, *,
              positions: torch.Tensor, causal: bool = True,
              lengths: torch.Tensor | None = None) -> torch.Tensor:
    """Full-sequence self-attention (forward / prefill / encoder)."""
    B, S, _ = x.shape
    hd = cfg.resolved_head_dim
    q, k, v = _qkv(p, x, cfg, ctx)
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)
    n_pad = _merged_head_plan(cfg.n_heads, k.shape[2], ctx)
    if n_pad is not None:
        q = F.pad(q, (0, 0, 0, n_pad))
    o = _gqa_full(q, k, v, causal=causal, config=ctx.plan, lengths=lengths,
                  ctx=ctx if n_pad is not None else None)
    if n_pad:
        o = o[:, :, :cfg.n_heads]
    return linear(p["wo"], o.reshape(B, S, cfg.n_heads * hd), ctx)


def _scatter_at(c: torch.Tensor, new: torch.Tensor,
                pos: torch.Tensor) -> torch.Tensor:
    """c: (B, S, KV, D); new: (B, 1, KV, D); write new at ``pos``.

    Updates ``c`` IN PLACE (the JAX version returns a new array that XLA
    updates in place on the donated cache) and returns it.  ``pos`` is a
    scalar (all rows at one step) or (B,) per-row positions; like the
    dynamic-update-slice it replaces, a position past the end is clamped
    to the last row, which is where a frozen, retired slot's writes land.
    """
    S = c.shape[1]
    pos = torch.as_tensor(pos, device=c.device).to(torch.long).clamp(0, S - 1)
    if is_dtensor(c):
        return write_row(c, new, pos)
    new = new[:, 0].to(c.dtype)
    if pos.dim() == 0:
        c[:, pos] = new
    else:
        c[torch.arange(c.shape[0], device=c.device), pos] = new
    return c


def attention_decode_masked(q: torch.Tensor, ck: torch.Tensor,
                            cv: torch.Tensor, pos_b: torch.Tensor,
                            cfg: ModelConfig, ctx: Ctx) -> torch.Tensor:
    """The masked einsum of one-token decode over a contiguous (B, S, KV,
    D) view of the cache, shared by :func:`attention_decode` and the
    plain path of :func:`attention_decode_paged`, so that the two are
    the same operations on the same shapes.  Returns (B, 1, H*D).  On
    DTensors it runs on each rank's batch and head shards
    (``sharding.map_heads``).  (Its name, and its body's, keep the
    ``attention_decode`` prefix that the program lint's allowlist
    sanctions, as the reference's einsums sit in ``attention_decode``
    itself.)"""
    B = q.shape[0]
    o = map_heads(attention_decode_local, q, ck, cv, pos_b)
    return o.reshape(B, 1, cfg.n_heads * cfg.resolved_head_dim).to(ctx.dtype)


def attention_decode_local(q: torch.Tensor, ck: torch.Tensor,
                           cv: torch.Tensor,
                           pos_b: torch.Tensor) -> torch.Tensor:
    """:func:`attention_decode_masked`'s einsums on (B, 1, H, D) queries:
    (B, 1, H, D) out, in the cache dtype."""
    B, _, H, hd = q.shape
    KV = ck.shape[2]
    qg = q.reshape(B, 1, KV, H // KV, hd)
    # the score product stays in the cache dtype; only the small logits
    # are upcast for the softmax (as in the reference)
    scores = torch.einsum("bskrd,btkd->bkrst", qg.to(ck.dtype), ck)
    logits = scores.to(torch.float32) * (hd ** -0.5)
    t_idx = torch.arange(ck.shape[1], device=q.device)
    mask = t_idx[None, :] <= pos_b[:, None]
    logits = torch.where(mask[:, None, None, None, :], logits, NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    o = torch.einsum("bkrst,btkd->bskrd", probs.to(cv.dtype), cv)
    return o.reshape(B, 1, H, hd)


def attention_decode(p: Params, x: torch.Tensor, cfg: ModelConfig, ctx: Ctx,
                     *, cache: Params, pos: torch.Tensor
                     ) -> tuple[torch.Tensor, Params]:
    """One-token decode against a contiguous KV cache (plain torch, as in
    the reference).  x: (B, 1, d); cache: {"k": (B, S_max, KV, D), "v"};
    pos: (B,) or scalar write index.  The cache is updated in place.

    Its regions (:func:`repro_torch.obs.region`), as in the paged and the
    int8 decode: ``attention.qkv`` (the projections and rope),
    ``attention.cache_write``, ``attention.core`` (scores, mask, softmax,
    the value product and the layout copies they make) and
    ``attention.out``."""
    B = x.shape[0]
    with obs.region("attention.qkv"):
        q, k, v = _qkv(p, x, cfg, ctx)
        pos_b = torch.broadcast_to(torch.as_tensor(pos, device=x.device),
                                   (B,))
        q = rope(q, pos_b[:, None], cfg.rope_theta)
        k = rope(k, pos_b[:, None], cfg.rope_theta)
    with obs.region("attention.cache_write"):
        ck = _scatter_at(cache["k"], k, pos)
        cv = _scatter_at(cache["v"], v, pos)
    with obs.region("attention.core"):
        o = attention_decode_masked(q, ck, cv, pos_b, cfg, ctx)
    with obs.region("attention.out"):
        return linear(p["wo"], o, ctx), {"k": ck, "v": cv}


def _scatter_paged(pool: torch.Tensor, new: torch.Tensor,
                   page_table: torch.Tensor,
                   pos: torch.Tensor) -> torch.Tensor:
    """pool: (P, ps, KV, D); new: (B, 1, KV, D); write row b's token at
    sequence position ``pos[b]`` through its page table.

    Updates ``pool`` IN PLACE (as :func:`_scatter_at` does) and returns
    it.  The logical page index clips to the table length, so a slot
    decoding past its allocation lands on whatever its table's last
    entry points at: for retired and overflowing rows that is the trash
    page (id 0), whose contents are never read unmasked.  Duplicate
    trash writes across rows are fine for the same reason."""
    ps = pool.shape[1]
    T = page_table.shape[1]
    pos = pos.to(torch.long)
    idx = (pos // ps).clamp(0, T - 1)
    pids = page_table.gather(1, idx[:, None].to(page_table.device))[:, 0]
    pool[pids.to(torch.long), pos % ps] = new[:, 0].to(pool.dtype)
    return pool


def attention_decode_paged(p: Params, x: torch.Tensor, cfg: ModelConfig,
                           ctx: Ctx, *, cache: Params,
                           page_table: torch.Tensor, pos: torch.Tensor
                           ) -> tuple[torch.Tensor, Params]:
    """One-token decode against a paged KV pool.

    x: (B, 1, d); cache: {"k": (P, ps, KV, D), "v"}, the shared page
    pool; page_table: (B, T) int32 logical -> physical page map; pos:
    (B,) or scalar write index.  The new token's K/V are scattered in
    place into the page holding ``pos``.  On the ``"torch"`` backend the
    table is gathered into a contiguous (B, T*ps, KV, D) view and
    :func:`attention_decode`'s masked einsum runs on it, so paged decode
    is bitwise equal to contiguous decode there (garbage positions mask
    to exactly -1e30 in both).  On ``"auto"`` the paged-attention kernel
    walks the table itself with ``kv_lens = pos + 1`` and never
    materialises the gathered copy.
    """
    B = x.shape[0]
    hd = cfg.resolved_head_dim
    with obs.region("attention.qkv"):
        q, k, v = _qkv(p, x, cfg, ctx)
        pos_b = torch.broadcast_to(torch.as_tensor(pos, device=x.device),
                                   (B,))
        q = rope(q, pos_b[:, None], cfg.rope_theta)
        k = rope(k, pos_b[:, None], cfg.rope_theta)
    with obs.region("attention.cache_write"):
        ck = _scatter_paged(cache["k"], k, page_table, pos_b)
        cv = _scatter_paged(cache["v"], v, page_table, pos_b)
    with obs.region("attention.core"):
        if ctx.plan.backend == "auto":
            o = ops.paged_attention(
                q.reshape(B, cfg.n_heads, hd).to(ck.dtype), ck, cv,
                page_table, kv_lens=(pos_b + 1).to(torch.int32),
                config=ctx.plan, scale=hd ** -0.5)
            o = o.reshape(B, 1, cfg.n_heads * hd).to(ctx.dtype)
        else:
            ps, KV = ck.shape[1], ck.shape[2]
            T = page_table.shape[1]
            pt = page_table.to(torch.long)
            kg = ck[pt].reshape(B, T * ps, KV, hd)
            vg = cv[pt].reshape(B, T * ps, KV, hd)
            o = attention_decode_masked(q, kg, vg, pos_b, cfg, ctx)
    with obs.region("attention.out"):
        return linear(p["wo"], o, ctx), {"k": ck, "v": cv}


def _quantize_kv(t: torch.Tensor, dtype: torch.dtype
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-(position, kv head) absmax int8 codes of ``t`` (..., D) and
    their scales (..., 1) in ``dtype``: scale = max|t| / 127 + 1e-8 in
    fp32, codes round half to even and clip to +-127, as the reference."""
    scale = t.abs().amax(-1, keepdim=True).to(torch.float32) / 127.0 + 1e-8
    codes = torch.clamp(torch.round(t.to(torch.float32) / scale), -127, 127)
    return codes.to(torch.int8), scale.to(dtype)


def attention_decode_quantized(p: Params, x: torch.Tensor, cfg: ModelConfig,
                               ctx: Ctx, *, cache: Params, pos: torch.Tensor
                               ) -> tuple[torch.Tensor, Params]:
    """One-token decode against an int8-quantized KV cache (plain torch,
    as in the reference).

    cache: {"k", "v": int8 (B, S, KV, D), "k_scale", "v_scale": (B, S,
    KV, 1)}, updated in place.  The new K/V are quantized with per
    (position, kv head) absmax scales; the scores are the product of q
    and the int8 codes followed by each position's k scale, and the v
    scales are folded into the probabilities before P.V.
    """
    B = x.shape[0]
    hd = cfg.resolved_head_dim
    with obs.region("attention.qkv"):
        q, k, v = _qkv(p, x, cfg, ctx)
        pos_b = torch.broadcast_to(torch.as_tensor(pos, device=x.device),
                                   (B,))
        q = rope(q, pos_b[:, None], cfg.rope_theta)
        k = rope(k, pos_b[:, None], cfg.rope_theta)
    with obs.region("attention.cache_write"):
        qk, ks = _quantize_kv(k, ctx.dtype)
        qv, vs = _quantize_kv(v, ctx.dtype)
        ck = _scatter_at(cache["k"], qk, pos)
        cks = _scatter_at(cache["k_scale"], ks, pos)
        cv = _scatter_at(cache["v"], qv, pos)
        cvs = _scatter_at(cache["v_scale"], vs, pos)
    with obs.region("attention.core"):
        KV = ck.shape[2]
        qg = q.reshape(B, 1, KV, cfg.n_heads // KV, hd)
        # the int8 product, then each position's scale (equal to
        # dequantizing first)
        raw = torch.einsum("bskrd,btkd->bkrst", qg.to(ctx.dtype),
                           ck.to(ctx.dtype))
        scores = raw * cks[:, :, :, 0].permute(0, 2, 1)[:, :, None, None, :]
        logits = scores.to(torch.float32) * (hd ** -0.5)
        t_idx = torch.arange(ck.shape[1], device=x.device)
        mask = t_idx[None, :] <= pos_b[:, None]
        logits = torch.where(mask[:, None, None, None, :], logits, NEG_INF)
        probs = torch.softmax(logits, dim=-1)
        pv = probs * cvs[:, :, :, 0].permute(0, 2, 1)[
            :, :, None, None, :].to(probs.dtype)
        o = torch.einsum("bkrst,btkd->bskrd", pv.to(ctx.dtype),
                         cv.to(ctx.dtype))
        o = o.reshape(B, 1, cfg.n_heads * hd)
    with obs.region("attention.out"):
        return linear(p["wo"], o, ctx), {"k": ck, "v": cv, "k_scale": cks,
                                         "v_scale": cvs}


def mlp(p: Params, x: torch.Tensor, cfg: ModelConfig, ctx: Ctx) -> torch.Tensor:
    """The dense MLP, one region (``mlp``) of a graph's map."""
    with obs.region("mlp"):
        h = linear(p["wi"], x, ctx)
        if cfg.mlp_type == "swiglu":
            h = F.silu(linear(p["wg"], x, ctx)) * h
        elif cfg.mlp_type == "geglu":
            # jax.nn.gelu defaults to the tanh approximation
            h = F.gelu(linear(p["wg"], x, ctx), approximate="tanh") * h
        elif cfg.mlp_type == "mlp":
            h = F.gelu(h, approximate="tanh")
        else:
            raise ValueError(f"unknown mlp_type {cfg.mlp_type!r}")
        return linear(p["wo"], h, ctx)


def embed(p: Params, tokens: torch.Tensor, ctx: Ctx) -> torch.Tensor:
    """The rows of the (V, d) table at ``tokens`` (JAX's
    ``table[tokens]``).  On a DTensor table it is an embedding lookup:
    sharded over the vocabulary, each rank looks up its own rows and the
    partial sums are all-reduced at once (Megatron's vocabulary-parallel
    embedding), where an index would move the table."""
    table = gather_fsdp(p["tokens"]).to(ctx.dtype)
    if not is_dtensor(table):
        return table[tokens]
    return reduce_partial(F.embedding(tokens, table))


def unembed(p: Params, x: torch.Tensor, ctx: Ctx) -> torch.Tensor:
    """(B, S, d) -> (B, S, V) fp32 logits through the zero-stall engine.

    Both heads are read K-major, through the kernel's transposed-B
    layout: a tied head the (V, d) embedding table in place, an untied
    one the (V, d) buffer behind its (d, V) view (the layout of
    ``transformer.init_embed`` and ``params_from_numpy``).  So no copy is
    made per call, and a vocabulary whose (d, V) rows are not 16-byte
    multiples (seamless's 256206) still takes the TMA design."""
    x = gather_inner(x)
    B, S, d = x.shape
    w = gather_fsdp(p["lm_head"]).t() if "lm_head" in p \
        else gather_fsdp(p["tokens"])
    w = split_columns(w, x, 0)
    logits = ops.matmul(x.reshape(B * S, d), w.to(ctx.dtype).contiguous(),
                        config=ctx.plan, out_dtype=torch.float32,
                        trans_b=True)
    return logits.reshape(B, S, logits.shape[-1])


def gather_last(x: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """x: (B, S, d) -> (B, 1, d): per-row x[b, lengths[b] - 1]."""
    idx = (lengths.to(torch.long) - 1).clamp(0, x.shape[1] - 1)
    return x[torch.arange(x.shape[0], device=x.device), idx][:, None]


def cross_entropy(logits: torch.Tensor, targets: torch.Tensor,
                  mask: torch.Tensor | None = None) -> torch.Tensor:
    """Mean token NLL: fp32 log-sum-exp minus the label logit; logits
    (B, S, V), targets (B, S) int, ``mask`` (B, S) optional weights (the
    masked mean over at least one token).  The label logit is a one-hot
    contraction, as in the reference; on a DTensor the label logit is
    read vocabulary-parallel (``sharding.label_logits``), with no
    one-hot."""
    logits = logits.to(torch.float32)
    if is_dtensor(logits):
        # the max and the sum reduce over the sharded vocabulary
        # (logsumexp's strategy would gather it whole), each all-reduced
        # into the logits' layout (and so their gradients on the way
        # back); the max is a constant, as in JAX's logsumexp
        m = like(logits.amax(dim=-1, keepdim=True), logits,
                 reduced=-1).detach()
        s = like(torch.exp(logits - m).sum(-1, keepdim=True), logits,
                 reduced=-1)
        lse = (m + torch.log(s))[..., 0]
        nll = lse - label_logits(logits, targets)
    else:
        lse = torch.logsumexp(logits, dim=-1)
        onehot = F.one_hot(targets.to(torch.long),
                           logits.shape[-1]).to(logits.dtype)
        nll = lse - torch.einsum("bsv,bsv->bs", logits, onehot)
    if mask is not None:
        mask = mask.to(nll.dtype)
        return torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1.0)
    return torch.mean(nll)
