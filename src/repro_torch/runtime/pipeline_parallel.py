"""GPipe-style pipeline parallelism over a mesh axis of ranks (the port
of ``repro.runtime.pipeline_parallel``).

The multi-pod mesh's 'pod' axis has the slowest links, which is where
pipeline parallelism beats data parallelism: a tick hands one
microbatch's activation across the stage boundary instead of every
gradient.

Schedule: JAX's GPipe, tick for tick: P stages, M microbatches, M + P - 1
ticks; stage p processes microbatch t - p at tick t, and an inactive
tick's output is masked to zero.  The embedding runs on stage 0, the
final norm, head and loss on the last stage; the loss is summed over the
stage axis (JAX's ``psum``) and divided by M.  JAX runs the rotation
inside one ``shard_map``; the port runs one process a rank, each rank
holding its stage's slice of the layer list (within a stage the other
mesh axes hold replicas, as JAX's replicated ``in_specs`` do).

The hand-off is :func:`ppermute` to stage ``(p + 1) % P``, an
``autograd.Function`` over ``batch_isend_irecv`` whose backward sends
the gradient back the other way, so ``loss.backward()`` flows through
the stages as ``jax.grad`` does through JAX's permutes.  As in JAX,
every stage embeds and runs the head and loss at every tick, and the
masks keep stage 0's input and the last stage's loss; so every rank's
graph is alike and every rank takes part in every hand-off, forward and
backward, and the ranks' point-to-point calls pair up.  The embedding
and final norm are replicated inputs: their gradients are summed over
the stage axis when the backward pass ends (the transpose of JAX's
replicated ``in_specs``), so every rank holds their full gradient and
each stage the full gradient of its layers.

This module pipelines the dense transformer family, as JAX's does.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.runtime.ranks import device_mesh, exchange

__all__ = ["pp_loss_fn", "split_layers_for_stages", "ppermute"]


def split_layers_for_stages(layers: list, n_stages: int) -> list[list]:
    """The layer list cut into ``n_stages`` equal consecutive slices (JAX
    reshapes its stacked (L, ...) leaves to (P, L / P, ...)); a count
    that does not divide the layers raises ``ValueError``."""
    n = len(layers)
    if n % n_stages:
        raise ValueError(f"{n} layers not divisible by {n_stages}")
    k = n // n_stages
    return [layers[i * k:(i + 1) * k] for i in range(n_stages)]


class _PPermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dst: int, src: int):
        ctx.peers = (dst, src)
        return exchange(x, dst, src)

    @staticmethod
    def backward(ctx, g):
        dst, src = ctx.peers
        return exchange(g, src, dst), None, None


def ppermute(x: torch.Tensor, dst: int, src: int) -> torch.Tensor:
    """JAX's ``ppermute`` as seen by one rank: ``x`` goes to rank ``dst``,
    the result is what rank ``src`` sent; the gradient flows back the
    other way (every rank of the permutation must call it)."""
    return _PPermute.apply(x, dst, src)


class _AllReduce(torch.autograd.Function):
    """The sum of ``x`` over ``group``; its gradient passes through
    unchanged (every rank holds the same sum, and the loss of any one
    of them is the objective)."""

    @staticmethod
    def forward(ctx, x, group):
        y = x.clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        return g, None


class _SumGradOver(torch.autograd.Function):
    """``x`` itself; its gradient summed over ``group`` (the transpose of
    handing one replicated input to every rank of the group)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


def pp_loss_fn(params: Any, batch: dict, cfg, ctx, mesh, *,
               n_microbatches: int, axis: str = "pod") -> torch.Tensor:
    """Pipeline-parallel train loss of the dense family over ``mesh``'s
    ``axis`` (a mesh over ranks, :mod:`repro_torch.launch.mesh`).

    ``params``: {"embed", "layers", "final_norm"} (the port's layer
    list; this rank reads its stage's slice only); ``batch``: "tokens"
    and "targets" (B, S), alike on every rank.  Returns the loss (a
    scalar, alike on every rank); its backward fills this stage's layer
    gradients and, on every rank, the embedding's and final norm's."""
    from repro_torch.models import layers as L
    from repro_torch.models.transformer import layer_fwd
    ax = mesh.axis_names.index(axis)
    n_p = mesh.devices.shape[ax]
    stages = split_layers_for_stages(params["layers"], n_p)
    coord = tuple(int(c) for c in
                  np.argwhere(mesh.ranks == dist.get_rank())[0])
    p = coord[ax]

    def rank_at(stage):
        c = list(coord)
        c[ax] = stage % n_p
        return int(mesh.ranks[tuple(c)])

    dst, src = rank_at(p + 1), rank_at(p - 1)
    group = device_mesh(mesh).get_group(axis)
    tokens, targets = batch["tokens"], batch["targets"]
    B, S = tokens.shape
    M = n_microbatches
    if B % M:
        raise ValueError(f"batch {B} not divisible by microbatches {M}")
    mb = B // M
    tok_mb = tokens.reshape(M, mb, S)
    tgt_mb = targets.reshape(M, mb, S)
    # first, so that their gradients are summed after every other
    # backward step, the ranks' point-to-point ones included
    embed_p = {k: _SumGradOver.apply(v, group)
               for k, v in params["embed"].items()}
    final_norm_p = {k: _SumGradOver.apply(v, group)
                    for k, v in params["final_norm"].items()}
    dev = tokens.device
    positions = torch.arange(S, device=dev)[None, :].expand(mb, S)
    zero_act = torch.zeros((mb, S, cfg.d_model), dtype=ctx.dtype,
                           device=dev)
    first = torch.tensor(p == 0, device=dev)

    recv = zero_act
    loss_sum = torch.zeros((), dtype=torch.float32, device=dev)
    for t in range(M + n_p - 1):
        active = torch.tensor(0 <= t - p < M, device=dev)
        x_first = L.embed(embed_p, tok_mb[min(t, M - 1)], ctx)
        x = torch.where(first, x_first, recv)
        for lp in stages[p]:
            x, _ = layer_fwd(cfg, ctx, None, x, lp, positions)
        y = torch.where(active, x, zero_act)
        # last stage: head + loss for its microbatch
        h = L.rms_norm(final_norm_p, y, cfg.norm_eps)
        logits = L.unembed(embed_p, h, ctx)
        mb_loss = L.cross_entropy(logits,
                                  tgt_mb[min(max(t - (n_p - 1), 0), M - 1)])
        take = active & torch.tensor(p == n_p - 1, device=dev)
        loss_sum = loss_sum + torch.where(take, mb_loss, 0.0)
        recv = ppermute(y, dst, src)
    # only the last stage holds the loss; share it.  JAX then takes the
    # mean over the other axes, whose replicas hold the same value.
    return _AllReduce.apply(loss_sum, group) / M
