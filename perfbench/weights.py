"""Weights made from the run's seed, on the device, for the program and the
reference alike.

Each piece of the model (a layer; the embedding, head and final norm) is
one flat buffer in the type it is served in, filled by one ``normal_``
call of a ``torch.Generator`` seeded from (run seed, piece), then scaled
segment by segment: a weight by ``d_in ** -0.5``, the embedding by 0.02
(the port's init scales), a norm's scale to ``1 + 0.1 * N(0, 1)`` so
that a norm that dropped its scale would show.  The program gets views
into these buffers in its own parameter layout; the reference draws a
piece again, layer by layer, with the same call on the same device, and
so reads the same numbers without taking anything the program made.
"""

from __future__ import annotations

import hashlib
import math

import torch

from perfbench.spec import ModelSpec

__all__ = ["piece_seed", "segments", "draw", "layer", "embed",
           "program_params", "redraw"]


def piece_seed(seed: int, piece: str) -> int:
    digest = hashlib.blake2b(f"perfbench:{int(seed)}:{piece}".encode(),
                             digest_size=8).digest()
    return int.from_bytes(digest, "little") & (2 ** 63 - 1)


def segments(spec: ModelSpec, piece: str) -> list[tuple[str, tuple, object]]:
    """(name, shape, scale) of each segment of ``piece`` ("layer" or
    "embed"), in buffer order; ``scale`` is a std or ``"norm"``."""
    d, hd, f = spec.d_model, spec.head_dim, spec.d_ff
    H, KV, E = spec.n_heads, spec.n_kv_heads, spec.n_experts
    if piece == "embed":
        return [("tokens", (spec.vocab, d), 0.02),
                ("head", (spec.vocab, d), d ** -0.5),
                ("final_norm", (d,), "norm")]
    seg = [("wq", (d, H * hd), d ** -0.5), ("wk", (d, KV * hd), d ** -0.5),
           ("wv", (d, KV * hd), d ** -0.5), ("wo", (H * hd, d), (H * hd) ** -0.5)]
    if spec.family == "moe":
        seg += [("router", (d, E), d ** -0.5), ("e_wi", (E, d, f), d ** -0.5),
                ("e_wg", (E, d, f), d ** -0.5), ("e_wo", (E, f, d), f ** -0.5)]
    else:
        seg += [("wi", (d, f), d ** -0.5), ("wg", (d, f), d ** -0.5),
                ("w_down", (f, d), f ** -0.5)]
    return seg + [("attn_norm", (d,), "norm"), ("mlp_norm", (d,), "norm")]


def _fill(flat: torch.Tensor, spec: ModelSpec, seed: int, piece: str,
          kind: str) -> dict[str, torch.Tensor]:
    g = torch.Generator(device=flat.device)
    g.manual_seed(piece_seed(seed, piece))
    flat.normal_(generator=g)
    out, off = {}, 0
    for name, shape, scale in segments(spec, kind):
        n = math.prod(shape)
        view = flat[off:off + n]
        if scale == "norm":
            view.mul_(0.1).add_(1.0)
        else:
            view.mul_(scale)
        out[name] = view.view(shape)
        off += n
    return out


def draw(spec: ModelSpec, seed: int, piece: str, device,
         dtype=torch.bfloat16) -> dict[str, torch.Tensor]:
    """The segments of ``piece`` ("layer.<i>" or "embed"), freshly drawn."""
    kind = "embed" if piece == "embed" else "layer"
    n = sum(math.prod(s) for _, s, _ in segments(spec, kind))
    flat = torch.empty(n, dtype=dtype, device=device)
    return _fill(flat, spec, seed, piece, kind)


def layer(spec: ModelSpec, seed: int, i: int, device,
          dtype=torch.bfloat16) -> dict[str, torch.Tensor]:
    return draw(spec, seed, f"layer.{i}", device, dtype)


def embed(spec: ModelSpec, seed: int, device,
          dtype=torch.bfloat16) -> dict[str, torch.Tensor]:
    return draw(spec, seed, "embed", device, dtype)


def _layer_tree(spec: ModelSpec, w: dict) -> dict:
    attn = {n: {"w": w[n]} for n in ("wq", "wk", "wv", "wo")}
    if spec.family == "moe":
        mlp = {"router": w["router"], "wi": w["e_wi"], "wg": w["e_wg"],
               "wo": w["e_wo"]}
    else:
        mlp = {"wi": {"w": w["wi"]}, "wg": {"w": w["wg"]},
               "wo": {"w": w["w_down"]}}
    return {"attn_norm": {"scale": w["attn_norm"]}, "attn": attn,
            "mlp_norm": {"scale": w["mlp_norm"]}, "mlp": mlp}


def program_params(spec: ModelSpec, seed: int, device,
                   dtype=torch.bfloat16) -> dict:
    """The port's parameter tree (``repro_torch.models`` layout) over the
    pieces drawn from ``seed``: the head as the (d, V) transposed view of
    its contiguous (V, d) buffer, the layout the port's head reads."""
    e = embed(spec, seed, device, dtype)
    return {"embed": {"tokens": e["tokens"], "lm_head": e["head"].t()},
            "layers": [_layer_tree(spec, layer(spec, seed, i, device, dtype))
                       for i in range(spec.n_layers)],
            "final_norm": {"scale": e["final_norm"]}}


def redraw(params: dict, spec: ModelSpec, seed: int) -> None:
    """Refill ``program_params``'s buffers in place from another seed, so
    that graphs captured over them stay valid."""
    flat = params["embed"]["tokens"]._base
    _fill(flat, spec, seed, "embed", "embed")
    for i, lp in enumerate(params["layers"]):
        _fill(lp["attn"]["wq"]["w"]._base, spec, seed, f"layer.{i}", "layer")
