"""The plain reference of the served models: PyTorch only, float32 with TF32
off, computed layer by layer.

It follows the port's model as the configuration file states it (its
``departures`` list where that differs from the published model):
token embedding, then in every layer RMSNorm, attention with rotary
positions (the half-split rotation) over all heads, grouped-query where
``num_key_value_heads`` is smaller, a residual add, RMSNorm and a SwiGLU
MLP, or for a mixture of experts the router (softmax over the experts,
the top ``k`` by a stable sort, the gates renormalised where
``norm_topk_prob``), the capacity rule (assignments ranked within their
expert in token order, those past ``capacity`` dropped) and the experts,
then a residual add; a final RMSNorm and the untied head.  The weights
are drawn again from the seed (:mod:`perfbench.weights`), one piece at a
time, so at most one layer is held in float32 beside the hidden states.

``precision="fp8"`` is the control: every product's operands rounded to
float8 e4m3 (a scale per activation row and per weight column) before a
float32 product, the step below the bfloat16 the configurations serve in.
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F

from perfbench import weights
from perfbench.spec import ModelSpec

__all__ = ["forward", "rms_norm", "rope", "attention", "moe", "mm"]

_FP8_MAX = 448.0


@contextlib.contextmanager
def _no_tf32():
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def _fp8(t: torch.Tensor, dim: int) -> torch.Tensor:
    """``t`` rounded to e4m3 with one absmax scale per slice along ``dim``."""
    amax = t.abs().amax(dim=dim, keepdim=True).clamp_min(1e-12)
    scale = amax / _FP8_MAX
    return (t / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale


def mm(x: torch.Tensor, w: torch.Tensor, precision: str) -> torch.Tensor:
    """x (..., K) @ w (K, N) in float32; ``"fp8"`` rounds x first (the
    weights are rounded once a piece, by :func:`_load`)."""
    if precision == "fp8":
        x = _fp8(x, -1)
    return x @ w


def _load(piece: dict, precision: str) -> dict:
    """A drawn piece in float32; under ``"fp8"`` every matrix rounded
    with a scale per output column (the head per vocabulary row)."""
    out = {}
    for name, t in piece.items():
        t = t.to(torch.float32)
        if name == "head":
            t = t.t()
        if precision == "fp8" and t.dim() >= 2 and name != "tokens":
            t = _fp8(t, -2)
        out[name] = t
    return out


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * scale


def rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """x (S, H, D) at positions 0..S-1."""
    S, _, D = x.shape
    half = D // 2
    freqs = theta ** (-torch.arange(half, dtype=torch.float32,
                                    device=x.device) / half)
    ang = torch.arange(S, dtype=torch.float32, device=x.device)[:, None] * freqs
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              head_block: int = 16) -> torch.Tensor:
    """Causal softmax attention, q (S, H, D) over k, v (S, KV, D), a
    block of heads at a time -> (S, H, D)."""
    S, H, D = q.shape
    rep = H // k.shape[1]
    k = k.repeat_interleave(rep, dim=1)
    v = v.repeat_interleave(rep, dim=1)
    causal = torch.ones((S, S), dtype=torch.bool, device=q.device).tril()
    out = torch.empty_like(q)
    for h in range(0, H, head_block):
        hs = slice(h, h + head_block)
        s = torch.einsum("shd,thd->hst", q[:, hs], k[:, hs]) * D ** -0.5
        s = s.masked_fill(~causal, float("-inf"))
        out[:, hs] = torch.einsum("hst,thd->shd", torch.softmax(s, -1),
                                  v[:, hs])
    return out


def moe(x: torch.Tensor, w: dict, spec: ModelSpec, precision: str
        ) -> torch.Tensor:
    """The expert layer over the T tokens of one routing call, x (T, d)."""
    T = x.shape[0]
    E, k = spec.n_experts, spec.experts_per_token
    probs = torch.softmax(mm(x, w["router"], precision), dim=-1)
    gates, experts = torch.sort(probs, dim=-1, descending=True, stable=True)
    gates, experts = gates[:, :k], experts[:, :k]
    if spec.norm_topk_prob:
        gates = gates / gates.sum(-1, keepdim=True)
    flat_e = experts.reshape(-1)
    tok = torch.arange(T * k, device=x.device) // k
    # an assignment's rank within its expert, in token order
    onehot = F.one_hot(flat_e, E)
    rank = ((torch.cumsum(onehot, 0) - 1) * onehot).sum(-1)
    keep = rank < spec.capacity(T)
    out = torch.zeros_like(x)
    g = gates.reshape(-1)
    for e in range(E):
        sel = ((flat_e == e) & keep).nonzero()[:, 0]
        if sel.numel() == 0:
            continue
        xe = x[tok[sel]]
        h = F.silu(mm(xe, w["e_wg"][e], precision)) \
            * mm(xe, w["e_wi"][e], precision)
        y = mm(h, w["e_wo"][e], precision)
        out.index_add_(0, tok[sel], y * g[sel, None])
    return out


def _layer(x: torch.Tensor, w: dict, spec: ModelSpec,
           precision: str) -> torch.Tensor:
    """One block over a (B, S, d) batch; an expert layer routes all B * S
    tokens in one call, batch-major, as the port's batched forward."""
    B, S, d = x.shape
    hd = spec.head_dim
    h = rms_norm(x, w["attn_norm"], spec.norm_eps)
    q = mm(h, w["wq"], precision).view(B, S, spec.n_heads, hd)
    k = mm(h, w["wk"], precision).view(B, S, spec.n_kv_heads, hd)
    v = mm(h, w["wv"], precision).view(B, S, spec.n_kv_heads, hd)
    o = torch.stack([attention(rope(q[b], spec.rope_theta),
                               rope(k[b], spec.rope_theta), v[b])
                     for b in range(B)])
    x = x + mm(o.reshape(B, S, -1), w["wo"], precision)
    h = rms_norm(x, w["mlp_norm"], spec.norm_eps)
    if spec.family == "moe":
        y = moe(h.reshape(B * S, d), w, spec, precision).view(B, S, d)
    else:
        y = mm(F.silu(mm(h, w["wg"], precision)) * mm(h, w["wi"], precision),
               w["w_down"], precision)
    return x + y


def forward(spec: ModelSpec, seed: int, batches: list[torch.Tensor], device,
            *, start: list[int] | None = None, precision: str = "fp32"
            ) -> list[torch.Tensor]:
    """Float32 logits of each (B, S) token batch of ``batches`` over the
    weights drawn from ``seed``: (B, S - start, V) for the rows from
    ``start[i]`` on (0 by default).  The layers run outermost, so each
    is drawn once for all the batches."""
    start = start or [0] * len(batches)
    with _no_tf32(), torch.no_grad():
        table = weights.embed(spec, seed, device)["tokens"]
        xs = [table[b.to(device)].to(torch.float32) for b in batches]
        del table
        for i in range(spec.n_layers):
            w = _load(weights.layer(spec, seed, i, device), precision)
            xs = [_layer(x, w, spec, precision) for x in xs]
            del w
        e = _load(weights.embed(spec, seed, device), precision)
        return [mm(rms_norm(x[:, s:], e["final_norm"], spec.norm_eps),
                   e["head"], precision)
                for x, s in zip(xs, start)]
