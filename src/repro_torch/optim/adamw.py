"""AdamW + LR schedules + global-norm clipping (the port of
``repro.optim.adamw``).

The math is the JAX package's, in fp32: decoupled weight decay,
bias-corrected moments (``b1 ** step`` in fp32), clipping by the global
norm, linear warmup then a cosine to 10% of the peak.  Two forms compute
the same numbers: :func:`adamw_update_` updates the parameters, the
moments and the step in place with PyTorch's multi-tensor ``_foreach``
ops (the train loop's form: JAX's train step donates them, so no second
copy is held), and :func:`adamw_update`, JAX's functional signature,
runs it on copies and returns new trees.
"""

from __future__ import annotations

import math
from typing import Any, Callable, NamedTuple

import torch

from repro_torch.configs.base import RunConfig
from repro_torch.tree import leaves, tree_map

__all__ = ["OptState", "init_opt_state", "adamw_update", "adamw_update_",
           "make_schedule", "global_norm", "clip_by_global_norm"]

Params = Any


class OptState(NamedTuple):
    """First and second moments (trees shaped like the parameters) and
    the step count (an int32 scalar on the parameters' device)."""
    mu: Params
    nu: Params
    step: torch.Tensor


def init_opt_state(params: Params, *, moments_dtype=None) -> OptState:
    """moments_dtype: e.g. torch.bfloat16 halves the optimizer's memory
    (the update math still runs in fp32)."""
    def z(p):
        return torch.zeros_like(p, dtype=moments_dtype or p.dtype)
    device = leaves(params)[0].device
    return OptState(mu=tree_map(z, params), nu=tree_map(z, params),
                    step=torch.zeros((), dtype=torch.int32, device=device))


def make_schedule(run: RunConfig) -> Callable[[torch.Tensor], torch.Tensor]:
    """Linear warmup + cosine decay to 10% of peak, in fp32."""
    def sched(step):
        step = torch.as_tensor(step).to(torch.float32)
        warm = torch.clamp((step + 1) / max(1, run.warmup_steps), max=1.0)
        prog = torch.clamp((step - run.warmup_steps)
                           / max(1, run.total_steps - run.warmup_steps),
                           0.0, 1.0)
        cos = 0.55 + 0.45 * torch.cos(math.pi * prog)
        return run.lr * warm * cos
    return sched


def global_norm(tree: Params) -> torch.Tensor:
    """The fp32 norm of every leaf taken together."""
    norms = torch._foreach_norm([x.float() for x in leaves(tree)])
    return torch.linalg.vector_norm(torch.stack(norms))


def clip_by_global_norm(grads: Params, max_norm: float
                        ) -> tuple[Params, torch.Tensor]:
    norm = global_norm(grads)
    scale = torch.clamp(max_norm / (norm + 1e-9), max=1.0)
    return tree_map(lambda g: g * scale.to(g.dtype), grads), norm


def _store(dst: list, src: list) -> None:
    """Write fp32 results back into moments held in another dtype."""
    for d, s in zip(dst, src):
        if d is not s:
            d.copy_(s)


@torch.no_grad()
def adamw_update_(params: Params, grads: Params, state: OptState,
                  run: RunConfig, *, lr: torch.Tensor | None = None) -> dict:
    """One AdamW step in place: ``params``, ``state.mu``, ``state.nu``
    and ``state.step`` are updated, and ``grads`` is consumed (clipped
    and scaled in place).  Returns ``{"grad_norm", "lr"}``."""
    p, g = leaves(params), leaves(grads)
    m, v = leaves(state.mu), leaves(state.nu)
    gnorm = global_norm(g)
    torch._foreach_mul_(g, torch.clamp(run.grad_clip / (gnorm + 1e-9),
                                       max=1.0))
    state.step.add_(1)
    lr = make_schedule(run)(state.step) if lr is None else lr
    b1, b2 = run.b1, run.b2
    g32 = [x.float() for x in g]
    # nu = b2 * v + (1 - b2) * g^2, then mu = b1 * m + (1 - b1) * g
    sq = torch._foreach_mul(g32, g32)
    torch._foreach_mul_(sq, 1 - b2)
    v32 = [x.float() for x in v]
    torch._foreach_mul_(v32, b2)
    torch._foreach_add_(v32, sq)
    del sq
    _store(v, v32)
    torch._foreach_mul_(g32, 1 - b1)
    m32 = [x.float() for x in m]
    torch._foreach_mul_(m32, b1)
    torch._foreach_add_(m32, g32)
    _store(m, m32)
    del g32, m32, v32
    step = state.step.to(torch.float32)
    bc1, bc2 = 1 - b1 ** step, 1 - b2 ** step
    # delta = mhat / (sqrt(vhat) + 1e-8) + weight_decay * p
    delta = torch._foreach_div([x.float() for x in m], bc1)
    den = torch._foreach_div([x.float() for x in v], bc2)
    torch._foreach_sqrt_(den)
    torch._foreach_add_(den, 1e-8)
    torch._foreach_div_(delta, den)
    del den
    wd = torch._foreach_mul(p, run.weight_decay)
    torch._foreach_add_(delta, wd)
    del wd
    torch._foreach_mul_(delta, lr)
    torch._foreach_sub_(p, delta)
    return {"grad_norm": gnorm, "lr": lr}


def adamw_update(params: Params, grads: Params, state: OptState,
                 run: RunConfig, *, lr: torch.Tensor | None = None
                 ) -> tuple[Params, OptState, dict]:
    """One AdamW step (decoupled weight decay, bias-corrected moments):
    (new params, new state, metrics); the arguments are left as they
    were.  :func:`adamw_update_` on copies, so both compute the same
    numbers."""
    def copy(tree):
        return tree_map(torch.clone, tree)
    params = copy(params)
    state = OptState(copy(state.mu), copy(state.nu), state.step.clone())
    metrics = adamw_update_(params, copy(grads), state, run, lr=lr)
    return params, state, metrics
