"""Mamba2 (SSD, state-space duality) blocks and the pure-SSM LM (port of
``repro.models.ssm``).

Prefill runs the chunked SSD algorithm: the intra-chunk work is batched
products, the inter-chunk state a short loop over chunks
(arXiv:2405.21060 §6).  Decode runs the O(1) recurrence
h_t = a_t h_{t-1} + dt_t (B_t ⊗ x_t), y_t = C_t h_t on an fp32 state.
The in and out projections of every block are linear layers, so on the
card they run the zero-stall matmul kernel (dequantized W8A16 under
``quant="int8"``); the SSD algebra, the causal conv and the recurrence
are plain PyTorch, as they are plain jnp in the JAX package (no Pallas
kernel stands behind them).  :func:`ssd_chunked` is held against the
sequential :func:`repro_torch.kernels.ref.ssd_scan_ref`.

As in :mod:`repro_torch.models.transformer`, a Python loop over a list
of per-layer dicts replaces ``lax.scan`` and the decode state is updated
in place.  JAX's ``_head_constraint`` (a sharding hint of the SSD head
axis over a device mesh) and ``shard_act`` have no counterpart on one
card.  A layer body runs under
:func:`~repro_torch.models.transformer.remat` when autograd records it,
as JAX checkpoints it by ``remat_policy``.
"""

from __future__ import annotations

import functools

import torch
import torch.nn.functional as F

from repro_torch import make_generator, resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models.layers import Ctx, Params
from repro_torch.models.transformer import init_embed, init_linear, remat
from repro_torch.runtime.sharding import (P, constrain, gather_dims,
                                          is_dtensor, like, map_shards,
                                          write_layers)

__all__ = ["ssd_chunked", "init_mamba", "mamba_forward", "mamba_decode",
           "mamba_prefill", "init_ssm_state", "init_params", "forward",
           "loss_fn", "decode_step", "init_cache", "prefill",
           "DEFAULT_CHUNK"]

DEFAULT_CHUNK = 64


# ----------------------------------------------------------------------
# chunked SSD
# ----------------------------------------------------------------------
def ssd_chunked(x: torch.Tensor, a_log: torch.Tensor, b: torch.Tensor,
                c: torch.Tensor, *, chunk: int = DEFAULT_CHUNK,
                h0: torch.Tensor | None = None
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """Chunk-parallel SSD.

    x: (B, S, H, P) inputs (dt already folded in), a_log: (B, S, H)
    log-decays (<= 0), b/c: (B, S, H, N), h0: optional (B, H, N, P)
    initial state.  Returns (y (B, S, H, P) in x's dtype, h_final
    (B, H, N, P) fp32).  The work is fp32 whatever the input dtype.
    """
    B, S, H, P = x.shape
    N = b.shape[-1]
    Q = min(chunk, S)
    if S % Q:
        raise ValueError(f"seq {S} not divisible by chunk {Q}")
    nc = S // Q
    f32 = torch.float32
    xr = x.reshape(B, nc, Q, H, P).to(f32)
    br = b.reshape(B, nc, Q, H, N).to(f32)
    cr = c.reshape(B, nc, Q, H, N).to(f32)
    al = a_log.reshape(B, nc, Q, H).to(f32)

    cum = torch.cumsum(al, dim=2)                           # (B,nc,Q,H)
    # intra-chunk: y_q += sum_{k<=q} exp(cum_q - cum_k) (c_q . b_k) x_k;
    # masked BEFORE exp, so the q < k entries are exp(-inf) = 0, never
    # an overflow
    diff = cum[:, :, :, None, :] - cum[:, :, None, :, :]    # (B,nc,Q,K,H)
    mask = torch.ones((Q, Q), dtype=torch.bool, device=x.device).tril()
    lmat = torch.exp(diff.masked_fill(~mask[None, None, :, :, None],
                                      float("-inf")))
    g = torch.einsum("bnqhd,bnkhd->bnqkh", cr, br)
    y = torch.einsum("bnqkh,bnkhp->bnqhp", g * lmat, xr)

    # per-chunk state contribution and total decay
    decay_end = torch.exp(cum[:, :, -1:, :] - cum)          # (B,nc,Q,H)
    s_chunk = torch.einsum("bnkhd,bnkhp->bnhdp",
                           br * decay_end[..., None], xr)
    total = torch.exp(cum[:, :, -1, :])                     # (B,nc,H)
    c_dec = cr * torch.exp(cum)[..., None]                  # (B,nc,Q,H,N)

    h = (torch.zeros((B, H, N, P), dtype=f32, device=x.device)
         if h0 is None else h0.to(f32))
    y_inter = []
    for n in range(nc):
        y_inter.append(torch.einsum("bqhd,bhdp->bqhp", c_dec[:, n], h))
        h = total[:, n, :, None, None] * h + s_chunk[:, n]
    y = y + torch.stack(y_inter, dim=1)
    return y.reshape(B, S, H, P).to(x.dtype), h


# ----------------------------------------------------------------------
# mamba2 block
# ----------------------------------------------------------------------
def init_mamba(g: torch.Generator, cfg: ModelConfig, dtype=torch.float32,
               device=None) -> Params:
    """One block's params, drawn as JAX's ``init_mamba`` draws them."""
    d, di, N = cfg.d_model, cfg.d_inner, cfg.ssm_state
    H, gr, ck = cfg.ssm_heads, cfg.ssm_groups, cfg.conv_kernel
    conv_dim = di + 2 * gr * N
    in_proj = init_linear(g, d, 2 * di + 2 * gr * N + H, dtype=dtype,
                          device=device)
    conv_w = torch.empty((ck, conv_dim), dtype=torch.float32, device=device)
    conv_w.normal_(0.0, 1.0, generator=g)
    return {
        "in_proj": in_proj,
        "conv_w": (conv_w * ck ** -0.5).to(dtype),
        "conv_b": torch.zeros((conv_dim,), dtype=dtype, device=device),
        "A_log": torch.log(torch.linspace(1.0, 16.0, H, device=device)
                           ).to(dtype),
        "D": torch.ones((H,), dtype=dtype, device=device),
        "dt_bias": torch.zeros((H,), dtype=dtype, device=device),
        "norm": {"scale": torch.ones((di,), dtype=dtype, device=device)},
        "out_proj": init_linear(g, di, d, dtype=dtype, device=device),
    }


def _split_zxbcdt(zxbcdt: torch.Tensor, cfg: ModelConfig):
    di, gN, H = cfg.d_inner, cfg.ssm_groups * cfg.ssm_state, cfg.ssm_heads
    # the split cuts across a 'model'-sharded width: gathered explicitly
    # (DTensor would gather it for the slices too), so that the gradient
    # returns to the projection in its shards, not whole on every rank
    zxbcdt = gather_dims(zxbcdt, [-1])
    z = zxbcdt[..., :di]
    xbc = zxbcdt[..., di:di + di + 2 * gN]
    dt = zxbcdt[..., di + di + 2 * gN:]
    if dt.shape[-1] != H:
        raise ValueError(f"in_proj width {zxbcdt.shape[-1]} does not split "
                         f"into z, xBC and {H} dt heads")
    return z, xbc, dt


def _causal_conv(xbc: torch.Tensor, w: torch.Tensor,
                 b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv + SiLU: xbc (B, S, Cd), w (ck, Cd), b (Cd,).

    The cross-correlation of JAX's feature-grouped ``lax.conv`` (left pad
    of ck - 1), written as ck shifted multiply-adds summed in fp32 and
    rounded once to the input dtype: no library convolution (cuDNN would
    run fp32 in TF32 unless told otherwise), and ck is 4."""
    if is_dtensor(xbc):
        # across ranks: on each rank's batch shard, the window's sequence
        # and the channels whole (a pending partial sum reduced), with the
        # conv's few weights gathered: torch 2.11's DTensor plans the
        # broadcast of a channel-sharded weight against this input wrong
        from torch.distributed.tensor import DTensor, Replicate
        x = xbc.redistribute(xbc.device_mesh, [
            p if p.is_shard(0) else Replicate() for p in xbc.placements])
        out = _causal_conv(x.to_local(), w.full_tensor(), b.full_tensor())
        return DTensor.from_local(out, x.device_mesh, x.placements,
                                  run_check=False, shape=x.shape,
                                  stride=x.stride())
    ck = w.shape[0]
    S = xbc.shape[1]
    xp = F.pad(xbc, (0, 0, ck - 1, 0)).to(torch.float32)
    wf = w.to(torch.float32)
    out = xp[:, 0:S] * wf[0]
    for k in range(1, ck):
        out = out + xp[:, k:k + S] * wf[k]
    return F.silu(out.to(xbc.dtype) + b[None, None, :])


def _ssm_inputs(p: Params, xbc_conv: torch.Tensor, dt_raw: torch.Tensor,
                cfg: ModelConfig):
    di, N, H, gr = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads, cfg.ssm_groups
    P = cfg.ssm_head_dim
    x = xbc_conv[..., :di]
    bc = xbc_conv[..., di:]
    lead = x.shape[:-1]
    b_ = bc[..., :gr * N].reshape(*lead, gr, N)
    c_ = bc[..., gr * N:].reshape(*lead, gr, N)
    rep = H // gr
    b_ = torch.repeat_interleave(b_, rep, dim=-2)
    c_ = torch.repeat_interleave(c_, rep, dim=-2)
    xh = x.reshape(*lead, H, P)
    dt = F.softplus(dt_raw.to(torch.float32)
                    + p["dt_bias"].to(torch.float32))
    a_log = -torch.exp(p["A_log"].to(torch.float32)) * dt
    return xh, dt, a_log, b_, c_


def _gate_out(p: Params, y: torch.Tensor, z: torch.Tensor,
              cfg: ModelConfig, ctx: Ctx) -> torch.Tensor:
    """The gated RMSNorm and the out projection: (B, S, d_inner) ->
    (B, S, d)."""
    y = L.rms_norm(p["norm"], y * F.silu(z), cfg.norm_eps)
    return L.linear(p["out_proj"], y, ctx)


def _head_constraint(t: torch.Tensor, ctx: Ctx) -> torch.Tensor:
    """Shard the SSD head dim (axis 2 of (B, S, H[, *])) over 'model'
    (no-op without a mesh, or where the heads do not divide).

    The reference's reasons: the intra-chunk SSD tensors (decay matrices,
    c.b scores) stop replicating across the model axis, and the sequence
    dim goes local, so the inter-chunk recurrence walks an unsharded
    chunk axis instead of rotating sequence shards every step."""
    if (ctx.mesh is None or t.ndim not in (3, 4)
            or "model" not in ctx.mesh.axis_names):
        return t
    sizes = dict(zip(ctx.mesh.axis_names, ctx.mesh.devices.shape))
    if t.shape[2] % sizes["model"] != 0:
        return t
    spec = (P(None, None, "model") if t.ndim == 3
            else P(None, None, "model", None))
    return constrain(t, spec)


def _ssd(x, a_log, b, c, chunk: int):
    """:func:`ssd_chunked` on each rank's batch and head shards
    (``sharding.map_shards``; the scan is independent across both): y
    (B, S, H, P) and the final state (B, H, N, P)."""
    return map_shards(functools.partial(ssd_chunked, chunk=chunk),
                      (x, a_log, b, c), (2, 2, 2, 2), (2, 1))


def mamba_forward(p: Params, u: torch.Tensor, cfg: ModelConfig, ctx: Ctx,
                  *, chunk: int = DEFAULT_CHUNK) -> torch.Tensor:
    """u: (B, S, d) -> (B, S, d)."""
    B, S = u.shape[:2]
    zxbcdt = L.linear(p["in_proj"], u, ctx)
    z, xbc, dt_raw = _split_zxbcdt(zxbcdt, cfg)
    xbc = _causal_conv(xbc, p["conv_w"].to(ctx.dtype),
                       p["conv_b"].to(ctx.dtype))
    xh, dt, a_log, b_, c_ = _ssm_inputs(p, xbc, dt_raw, cfg)
    xh = _head_constraint(xh, ctx)
    b_ = _head_constraint(b_, ctx)
    c_ = _head_constraint(c_, ctx)
    a_log = _head_constraint(a_log, ctx)
    y, _ = _ssd(xh * dt[..., None].to(xh.dtype), a_log, b_, c_, chunk)
    y = y + p["D"].to(y.dtype)[None, None, :, None] * xh
    return _gate_out(p, y.reshape(B, S, cfg.d_inner), z, cfg, ctx)


def mamba_prefill(p: Params, u: torch.Tensor, cfg: ModelConfig, ctx: Ctx,
                  *, lengths: torch.Tensor, chunk: int = DEFAULT_CHUNK
                  ) -> tuple[torch.Tensor, Params]:
    """One fused pass over the prompt, returning (y, decode state).

    ``u``: (B, S, d) padded prompts; ``lengths``: (B,) valid prefixes.
    Every step past a row's length is an exact identity on the state:
    ``dt`` is zeroed there, so the decay is exp(0) = 1 and the input
    ``dt * x`` is 0, and ``h_final`` is each row's state at its own last
    valid step.  The conv decode window is the last ``conv_kernel - 1``
    raw (pre-activation) xBC rows before each row's length, gathered per
    row in fp32 (zeros where the prompt is shorter than the window).
    """
    B, S = u.shape[:2]
    zxbcdt = L.linear(p["in_proj"], u, ctx)
    z, xbc, dt_raw = _split_zxbcdt(zxbcdt, cfg)
    xbc_conv = _causal_conv(xbc, p["conv_w"].to(ctx.dtype),
                            p["conv_b"].to(ctx.dtype))
    xh, dt, a_log, b_, c_ = _ssm_inputs(p, xbc_conv, dt_raw, cfg)
    lengths = lengths.to(device=u.device, dtype=torch.long)
    valid = torch.arange(S, device=u.device)[None, :] < lengths[:, None]
    a_log = a_log * valid[..., None]
    x_in = (xh * dt[..., None].to(xh.dtype)
            * valid[..., None, None].to(xh.dtype))
    y, h_final = _ssd(x_in, a_log, b_, c_, chunk)
    y = y + p["D"].to(y.dtype)[None, None, :, None] * xh
    out = _gate_out(p, y.reshape(B, S, cfg.d_inner), z, cfg, ctx)

    ck = cfg.conv_kernel
    idx = lengths[:, None] - (ck - 1) + torch.arange(ck - 1,
                                                     device=u.device)[None]
    win = torch.gather(xbc.to(torch.float32), 1,
                       idx.clamp(0, S - 1)[..., None].expand(
                           -1, -1, xbc.shape[-1]))
    win = torch.where((idx >= 0)[..., None], win, 0.0)
    return out, {"conv": win, "ssm": h_final}


def init_ssm_state(cfg: ModelConfig, batch: int, dtype=torch.float32,
                   device=None) -> Params:
    """One block's decode state: the conv window in ``dtype`` and the
    SSM state, always fp32."""
    conv_dim = cfg.d_inner + 2 * cfg.ssm_groups * cfg.ssm_state
    return {
        "conv": torch.zeros((batch, cfg.conv_kernel - 1, conv_dim),
                            dtype=dtype, device=device),
        "ssm": torch.zeros((batch, cfg.ssm_heads, cfg.ssm_state,
                            cfg.ssm_head_dim), dtype=torch.float32,
                           device=device),
    }


def mamba_decode(p: Params, u: torch.Tensor, cfg: ModelConfig, ctx: Ctx,
                 state: Params) -> tuple[torch.Tensor, Params]:
    """One-token recurrent step. u: (B, 1, d) -> (B, 1, d).

    ``state`` ({"conv": (B, ck-1, Cd), "ssm": (B, H, N, P) fp32}) is
    updated IN PLACE (the JAX version returns new arrays) and returned,
    so that a captured CUDA graph of the step has no state to copy
    back."""
    zxbcdt = L.linear(p["in_proj"], u, ctx)
    z, xbc, dt_raw = _split_zxbcdt(zxbcdt, cfg)
    window = torch.cat([state["conv"], xbc.to(state["conv"].dtype)],
                       dim=1)                               # (B, ck, Cd)
    w = p["conv_w"].to(torch.float32)
    conv_out = torch.einsum("bkc,kc->bc", window.to(torch.float32), w)
    conv_out = F.silu(conv_out + p["conv_b"].to(torch.float32))
    xbc_t = conv_out[:, None, :].to(ctx.dtype)              # (B, 1, Cd)
    xh, dt, a_log, b_, c_ = _ssm_inputs(p, xbc_t, dt_raw, cfg)
    # the recurrence, on the fp32 state
    xt = (xh * dt[..., None].to(xh.dtype))[:, 0]            # (B, H, P)
    at = torch.exp(a_log[:, 0])                             # (B, H)
    bt = b_[:, 0].to(torch.float32)                         # (B, H, N)
    ct = c_[:, 0].to(torch.float32)
    # the recurrence's operands in the state's layout (batch over the DP
    # axes, heads over 'model'; no-ops on plain tensors), where DTensor
    # would carry on the conv's and repeat the recurrence on each rank
    # of 'data'
    xt, at, bt, ct = (like(t, state["ssm"]) for t in (xt, at, bt, ct))
    h = state["ssm"] * at[:, :, None, None] \
        + torch.einsum("bhd,bhp->bhdp", bt, xt.to(torch.float32))
    # the new state in the cache's layout (contiguous: a no-op on a plain
    # tensor)
    h = like(h, state["ssm"]).contiguous()
    y = torch.einsum("bhd,bhdp->bhp", ct, h).to(ctx.dtype)
    y = y + p["D"].to(y.dtype)[None, :, None] * xh[:, 0]
    B = u.shape[0]
    out = _gate_out(p, y.reshape(B, 1, cfg.d_inner), z, cfg, ctx)
    state["conv"].copy_(window[:, 1:])
    state["ssm"].copy_(h)
    return out, state


# ----------------------------------------------------------------------
# pure-SSM LM (mamba2-130m)
# ----------------------------------------------------------------------
def init_layer(g: torch.Generator, cfg: ModelConfig, dtype,
               device) -> Params:
    """One residual layer: the pre-norm and the mamba2 block."""
    return {"norm": {"scale": torch.ones((cfg.d_model,), dtype=dtype,
                                         device=device)},
            "mamba": init_mamba(g, cfg, dtype, device)}


def init_params(cfg: ModelConfig, *, seed: int = 0,
                dtype: torch.dtype = torch.float32, device=None) -> Params:
    """Random parameters made from ``seed`` on the target device with the
    JAX package's distributions (see
    :func:`repro_torch.models.transformer.init_params`)."""
    device = resolve_device(device)
    g = make_generator(device, seed)
    return {"embed": init_embed(g, cfg, dtype, device),
            "layers": [init_layer(g, cfg, dtype, device)
                       for _ in range(cfg.n_layers)],
            "final_norm": {"scale": torch.ones((cfg.d_model,), dtype=dtype,
                                               device=device)}}


def forward(params: Params, tokens: torch.Tensor, cfg: ModelConfig,
            ctx: Ctx, *, last_only: bool = False) -> torch.Tensor:
    """tokens: (B, S) -> logits (B, S, V), or (B, 1, V) with last_only."""
    x = L.embed(params["embed"], tokens, ctx)

    def layer(x, lp):
        x = L.shard_act(x, ctx)
        h = L.rms_norm(lp["norm"], x, cfg.norm_eps)
        return x + mamba_forward(lp["mamba"], h, cfg, ctx)

    body = remat(layer, cfg, params["layers"])
    for lp in params["layers"]:
        x = body(x, lp)
    x = L.rms_norm(params["final_norm"], x, cfg.norm_eps)
    if last_only:
        x = x[:, -1:]
    return L.unembed(params["embed"], x, ctx)


def loss_fn(params: Params, batch: dict, cfg: ModelConfig,
            ctx: Ctx) -> torch.Tensor:
    """The training objective: the cross entropy of the logits against
    ``batch["targets"]``, as the reference."""
    logits = forward(params, batch["tokens"], cfg, ctx)
    return L.cross_entropy(logits, batch["targets"])


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               dtype: torch.dtype = torch.bfloat16, *, device=None) -> Params:
    """The O(1) decode state, stacked over layers: conv (n_layers, B,
    ck-1, Cd) and ssm (n_layers, B, H, N, P), both fp32 whatever
    ``dtype`` (as in JAX); ``max_len`` is not read."""
    del max_len, dtype
    device = resolve_device(device)
    st = init_ssm_state(cfg, batch, torch.float32, device="meta")
    cache = {name: torch.zeros((cfg.n_layers,) + tuple(t.shape),
                               dtype=torch.float32, device=device)
             for name, t in st.items()}
    cache["pos"] = torch.zeros((), dtype=torch.int32, device=device)
    return cache


def _pad_to_chunk(tokens: torch.Tensor) -> torch.Tensor:
    """Pad (B, S0) tokens to a whole number of SSD chunks.  Always: the
    masked steps are exact identities, and a FIXED chunk grid keeps the
    float summation order independent of the padded prompt length, so
    engine buckets and lock-step batches give a request bit-identical
    states."""
    S0 = tokens.shape[1]
    if S0 % DEFAULT_CHUNK:
        S = -(-S0 // DEFAULT_CHUNK) * DEFAULT_CHUNK
        tokens = F.pad(tokens, (0, S - S0))
    return tokens


def _lengths(tokens: torch.Tensor, lengths) -> torch.Tensor:
    B, S0 = tokens.shape
    if lengths is None:
        return torch.full((B,), S0, dtype=torch.int32, device=tokens.device)
    return torch.as_tensor(lengths, device=tokens.device).to(torch.int32)


def _pos(tokens: torch.Tensor, lengths, lens: torch.Tensor) -> torch.Tensor:
    """The cache's ``pos``: the scalar prompt length, or the (B,) lengths."""
    if lengths is None:
        return torch.tensor(tokens.shape[1], dtype=torch.int32,
                            device=tokens.device)
    return lens


def stack_states(cache: Params | None, convs: list, ssms: list,
                 lead: tuple = ()) -> tuple[torch.Tensor, torch.Tensor]:
    """Each layer's conv window and SSD state stacked, the layer axis
    unflattened to ``lead`` where given: new tensors, or written into
    ``cache``'s ``conv`` and ``ssm``."""
    out = []
    for name, states in (("conv", convs), ("ssm", ssms)):
        t = torch.stack(states)
        if lead:
            t = t.unflatten(0, lead)
        if cache is not None:
            t = cache[name].copy_(t)
        out.append(t)
    return out[0], out[1]


def prefill(params: Params, tokens: torch.Tensor, cfg: ModelConfig, ctx: Ctx,
            max_len: int, *, lengths: torch.Tensor | None = None,
            cache: Params | None = None) -> tuple[torch.Tensor, Params]:
    """Fused prompt ingestion: one chunked-SSD pass per layer instead of
    ``prompt_len`` recurrent steps.

    Returns (last-valid-position logits, decode cache).  With
    ``lengths`` ((B,) ragged prompts) ``cache["pos"]`` is the (B,)
    position vector; padded steps are exact identities on the state
    (see :func:`mamba_prefill`).  ``cache``: an ``init_cache(B, max_len)``
    whose state takes the result in place of a fresh one (the same
    values), as a serving engine's static buffer.
    """
    del max_len  # O(1) state
    lens = _lengths(tokens, lengths)
    x = L.embed(params["embed"], _pad_to_chunk(tokens), ctx)
    convs, ssms = [], []
    for lp in params["layers"]:
        h = L.rms_norm(lp["norm"], x, cfg.norm_eps)
        y, st = mamba_prefill(lp["mamba"], h, cfg, ctx, lengths=lens)
        x = x + y
        convs.append(st["conv"])
        ssms.append(st["ssm"])
    x = L.rms_norm(params["final_norm"], x, cfg.norm_eps)
    logits = L.unembed(params["embed"], L.gather_last(x, lens), ctx)
    conv, ssm_state = stack_states(cache, convs, ssms)
    return logits, {"conv": conv, "ssm": ssm_state,
                    "pos": _pos(tokens, lengths, lens)}


def decode_step(params: Params, cache: Params, tokens: torch.Tensor,
                cfg: ModelConfig, ctx: Ctx) -> tuple[torch.Tensor, Params]:
    """tokens: (B, 1) -> (logits (B, 1, V), cache).  The conv and ssm
    state are updated in place; the returned dict carries ``pos + 1``."""
    x = L.embed(params["embed"], tokens, ctx)
    for i, lp in enumerate(params["layers"]):
        h = L.rms_norm(lp["norm"], x, cfg.norm_eps)
        y, st = mamba_decode(lp["mamba"], h, cfg, ctx,
                             {"conv": cache["conv"][i],
                              "ssm": cache["ssm"][i]})
        write_layers(cache, st, (i,))
        x = x + y
    x = L.rms_norm(params["final_norm"], x, cfg.norm_eps)
    logits = L.unembed(params["embed"], x, ctx)
    return logits, {"conv": cache["conv"], "ssm": cache["ssm"],
                    "pos": cache["pos"] + 1}
