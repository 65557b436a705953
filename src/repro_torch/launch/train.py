"""End-to-end training launcher (the port of ``repro.launch.train``).

Wires every substrate together: config -> model -> data pipeline ->
train step (autograd through ``Model.loss``, optional gradient
accumulation and gradient compression, AdamW in place) -> async
checkpointing -> resilient executor (retry / heartbeat / straggler
detection).  The step runs as compiled programs where JAX jits it
(:func:`compile_train_step`: one CUDA graph a batch shape on the card,
the first step of a shape eager; the same body eagerly on the CPU and
across ranks).  As in the JAX package, training runs the plain path
(``Ctx(plan="torch")``: the kernels of the port have no backward, and
JAX trains on its ``jnp`` path).  In one process it runs on one device;
across ranks (:func:`repro_torch.runtime.ranks.init_ranks`, e.g. under
``torch.distributed.run``) ``train_loop`` spans a ('data', 'model') mesh
of every rank (``make_host_mesh``, as JAX's spans its local devices),
places the state by the sharding rules and sets ``ctx.mesh``, and the
step runs on DTensors under :func:`repro_torch.runtime.sharding.
across_ranks`.  Example:

  PYTHONPATH=src python -m repro_torch.launch.train --arch gemma-7b \\
      --device cpu --reduced --steps 100 --seq-len 128 --global-batch 8

``--device`` defaults to the card (it raises without one); ``--layers
N`` trains the first N layers of a layer-list family at the config's
widths, for a model whose full depth does not fit the card.
"""

from __future__ import annotations

import argparse
import dataclasses
import time

import torch
import torch.distributed

from repro_torch import graphs, resolve_device
from repro_torch.checkpoint import Checkpointer
from repro_torch.configs import RunConfig, get_config
from repro_torch.data import make_pipeline
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import Ctx, build_model
from repro_torch.optim import adamw_update_, init_opt_state
from repro_torch.optim.compression import apply_error_feedback, init_residuals
from repro_torch.runtime import sharding as shr
from repro_torch.runtime.fault_tolerance import (Heartbeat, ResilientExecutor,
                                                 StragglerDetector)
from repro_torch.runtime.ranks import device_mesh
from repro_torch.tree import flatten, leaves, unflatten

__all__ = ["train_loop", "make_train_step", "compile_train_step",
           "state_shardings"]


def make_train_step(model, ctx: Ctx, run: RunConfig):
    """``train_step(params, opt, residuals, batch) -> (params, opt,
    residuals, metrics)``, JAX's step: the loss and its gradients (with
    ``run.microbatches > 1`` accumulated over equal slices of the batch,
    ``loss + loss_mb / mb`` and ``g + g_mb / mb`` as JAX's scan), error
    feedback, then AdamW.  ``params`` and ``opt`` are updated in place
    (JAX donates them) and returned; ``metrics`` holds the loss, the
    gradient norm and the learning rate as device scalars.  Under
    ``ctx.mesh`` each microbatch is held batch-sharded, as JAX's scan
    over the reshaped batch keeps it."""
    def value_and_grad(params, batch):
        ps, treedef = flatten(params)
        xs = [p.detach().requires_grad_() for p in ps]
        with torch.enable_grad():
            loss = model.loss(unflatten(treedef, xs), batch, ctx)
            grads = torch.autograd.grad(loss, xs)
        # a DTensor gradient in its parameter's layout (a pending partial
        # sum over the batch shards reduced), as JAX's gradients come
        # out in their parameters' shardings
        grads = [shr.like(g, p) for g, p in zip(grads, ps)]
        return loss.detach(), list(grads)

    def train_step(params, opt, residuals, batch):
        if run.microbatches > 1:
            mb = run.microbatches
            ps = flatten(params)[0]
            loss = torch.zeros((), dtype=torch.float32, device=ps[0].device)
            grads = [torch.zeros_like(p) for p in ps]
            for i in range(mb):
                one = {k: shr.microbatch(v, mb, i)
                       for k, v in batch.items()}
                if ctx.mesh is not None:
                    one = shr.constrain_tree(
                        one, shr.batch_shardings(ctx.mesh, one))
                loss_mb, g = value_and_grad(params, one)
                loss = loss + loss_mb / mb
                torch._foreach_div_(g, mb)
                torch._foreach_add_(grads, g)
                del g
        else:
            loss, grads = value_and_grad(params, batch)
        grads = unflatten(flatten(params)[1], grads)
        # error-feedback compression of what would cross the slow links
        grads, residuals = apply_error_feedback(
            grads, residuals, scheme=run.grad_compression)
        metrics = adamw_update_(params, grads, opt, run)
        return params, opt, residuals, {"loss": loss, **metrics}

    return train_step


class CompiledTrainStep:
    """The train step as compiled programs, the port of JAX's
    ``jax.jit(make_train_step(model, ctx, run), donate_argnums=(0, 1,
    2))``: called as the step is, it returns the same 4-tuple.

    One program a batch key (each batch leaf's name, shape and dtype):
    the batch is copied into the key's static tensors and the step runs
    over them, then copies the residuals that error feedback returns
    anew back into the state's (parameters, moments and the step counter
    are updated in place).  On a CUDA device a key's first call runs the
    body eagerly (a real step, and the warm-up), then the body is
    captured as a CUDA graph (:func:`repro_torch.graphs.capture`: the
    capture advances nothing), and every later call of the key replays
    it; ``captures`` records each capture.  On the CPU the same body runs
    eagerly on the same static tensors.  ``metrics`` are copies, which
    the next replay does not overwrite.

    The programs read and write the state tensors of the first call, as
    JAX's donated buffers become its outputs.  A call with other state
    tensors (``Checkpointer.restore`` hands back new ones) has them
    copied into those, and gets those back: a copy of the state costs
    far less than an eager step and a capture, and the graphs and their
    pool stay as they are; no program ever replays over tensors the
    caller no longer holds.

    Under ``ctx.mesh``, or with DTensor parameters, the eager step runs
    on the caller's tensors and nothing is captured: gloo's host-staged
    collectives cannot be captured in a CUDA graph."""

    def __init__(self, model, ctx: Ctx, run: RunConfig):
        self.step = make_train_step(model, ctx, run)
        self.ctx = ctx
        self.batches: dict[tuple, dict] = {}   # key -> static batch
        self.programs: dict[tuple, tuple] = {}  # key -> its capture
        self.captures: list[dict] = []
        # the state the programs read and write: (params, opt,
        # residuals), its leaves and its structure
        self._state: tuple | None = None
        self._leaves: list = []
        self._treedef = None

    def __call__(self, params, opt, residuals, batch):
        if self.ctx.mesh is not None or any(
                shr.is_dtensor(p) for p in leaves(params)):
            return self.step(params, opt, residuals, batch)
        self._hold((params, opt, residuals))
        key = tuple((k, tuple(v.shape), v.dtype)
                    for k, v in sorted(batch.items()))
        static = self.batches.setdefault(
            key, {k: torch.empty_like(v) for k, v in batch.items()})
        for k, v in batch.items():
            static[k].copy_(v)
        device = self._leaves[0].device
        if device.type != "cuda":
            metrics = self._body(static)
        elif key not in self.programs:
            metrics = self._body(static)
            self.programs[key] = graphs.capture(
                lambda: self._body(static), device,
                "train_step:" + ",".join(f"{k}{s}" for k, s, _ in key),
                self.captures)
        else:
            metrics = graphs.replay(self.programs[key])
        return (*self._state, {k: v.clone() for k, v in metrics.items()})

    def _hold(self, state: tuple) -> None:
        """Bind the programs to the first call's state; copy a later
        call's other tensors into it."""
        given, treedef = flatten(state)
        if self._state is None:
            self._state, self._leaves, self._treedef = state, given, treedef
            return
        if treedef != self._treedef:
            raise ValueError("the train state's structure changed")
        with torch.no_grad():
            for held, x in zip(self._leaves, given):
                if x is not held:
                    held.copy_(x)

    def _body(self, batch: dict) -> dict:
        params, opt, residuals = self._state
        _, _, new, metrics = self.step(params, opt, residuals, batch)
        for held, x in zip(leaves(residuals), leaves(new)):
            if x is not held:
                held.copy_(x)
        return metrics


def compile_train_step(model, ctx: Ctx, run: RunConfig) -> CompiledTrainStep:
    """``make_train_step(model, ctx, run)`` as compiled programs (see
    :class:`CompiledTrainStep`), where JAX jits it."""
    return CompiledTrainStep(model, ctx, run)


def state_shardings(mesh, state: dict) -> dict:
    """The :class:`~repro_torch.runtime.sharding.NamedSharding` of each
    leaf of a train state {"params", "opt", "residuals"}: the parameter
    rules for the params, their moments and residuals, the step
    replicated (JAX's optimizer state inherits its parameters'
    shardings)."""
    opt = state["opt"]
    return {"params": shr.param_shardings(mesh, state["params"]),
            "opt": type(opt)(mu=shr.param_shardings(mesh, opt.mu),
                             nu=shr.param_shardings(mesh, opt.nu),
                             step=shr.replicated(mesh)),
            "residuals": shr.param_shardings(mesh, state["residuals"])}


def train_loop(arch: str, run: RunConfig, *, reduced: bool = True,
               resume: bool = True, failure_hook=None, log_every: int = 10,
               device=None, n_layers: int | None = None) -> dict:
    """Train ``arch`` for ``run.total_steps`` steps (resuming from the
    latest checkpoint in ``run.ckpt_dir`` when ``resume``), as JAX's
    ``train_loop``: parameters made from ``run.seed`` in fp32 on
    ``device`` (None: the card; it raises when there is none), the
    compute dtype ``run.dtype``, a checkpoint every ``run.ckpt_every``
    steps and a blocking one at the last step.  ``n_layers`` keeps the
    first ``n_layers`` blocks of a dense, vlm, MoE or SSM model.
    Returns ``{"losses", "state", "executor", "final_loss"}``."""
    device = resolve_device(device)
    cfg = get_config(arch, reduced=reduced)
    if n_layers is not None:
        if cfg.family in ("encdec", "hybrid"):
            raise ValueError(f"n_layers cuts the depth of the dense, vlm, "
                             f"MoE and SSM families, not {cfg.family!r}")
        cfg = dataclasses.replace(cfg, n_layers=int(n_layers))
    model = build_model(cfg)
    mesh = make_host_mesh(device=device)
    ranked = mesh.size > 1
    ctx = Ctx(plan="torch",
              dtype=torch.float32 if run.dtype == "float32"
              else torch.bfloat16, mesh=mesh if ranked else None)

    params = model.init(seed=run.seed, dtype=torch.float32, device=device)
    opt = init_opt_state(params)
    residuals = (init_residuals(params)
                 if run.grad_compression != "none" else {})
    state = {"params": params, "opt": opt, "residuals": residuals}
    restore_kw = {"device": device}
    if ranked:
        dm = device_mesh(mesh)
        shardings = state_shardings(mesh, state)
        state = shr.place(state, shardings, dm)
        restore_kw = {"shardings": shardings, "device_mesh": dm}

    pipe = make_pipeline(cfg.vocab_size, run.seq_len, run.global_batch,
                         seed=run.seed)
    ckpt = Checkpointer(run.ckpt_dir, keep=run.keep_ckpts)
    start_step = 0
    if resume and ckpt.latest_step() is not None:
        state, start_step = ckpt.restore(state, **restore_kw)
        start_step += 1

    step_fn = compile_train_step(model, ctx, run)
    detector = StragglerDetector()
    # one heartbeat file a rank
    hb = Heartbeat(run.ckpt_dir,
                   host_id=torch.distributed.get_rank() if ranked else 0)

    def restore_fn():
        st, _ = ckpt.restore(state, **restore_kw)
        return st

    def run_one(st, batch):
        if ranked:
            batch = shr.place(batch, shr.batch_shardings(mesh, batch), dm)
        with shr.across_ranks(ranked):
            p, o, r, m = step_fn(st["params"], st["opt"], st["residuals"],
                                 batch)
        return {"params": p, "opt": o, "residuals": r}, m

    executor = ResilientExecutor(run_one, restore_fn=restore_fn,
                                 heartbeat=hb, detector=detector,
                                 failure_hook=failure_hook)

    losses = []
    t0 = time.time()
    for step in range(start_step, run.total_steps):
        batch = pipe.torch_batch(step, device)
        state, metrics = executor.run_step(step, state, batch)
        losses.append(float(shr.unplace(metrics["loss"])))
        if step % log_every == 0 or step == run.total_steps - 1:
            m = shr.unplace(metrics)
            if not ranked or torch.distributed.get_rank() == 0:
                print(f"step {step:5d} loss {losses[-1]:.4f} "
                      f"lr {float(m['lr']):.2e} "
                      f"gnorm {float(m['grad_norm']):.3f} "
                      f"({(time.time()-t0):.1f}s)", flush=True)
        if run.ckpt_every and step and step % run.ckpt_every == 0:
            ckpt.save(step, state)
    ckpt.save(run.total_steps - 1, state, blocking=True)
    return {"losses": losses, "state": state, "executor": executor,
            "final_loss": losses[-1] if losses else float("nan")}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="gemma-7b")
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--full", dest="reduced", action="store_false")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--compression", default="none",
                    choices=["none", "int8", "topk"])
    ap.add_argument("--ckpt-dir", default="/tmp/repro_ckpt")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    ap.add_argument("--layers", type=int, default=None,
                    help="train only the first N layers (a depth cut for "
                    "a model that does not fit the card)")
    args = ap.parse_args(argv)
    run = RunConfig(seq_len=args.seq_len, global_batch=args.global_batch,
                    lr=args.lr, total_steps=args.steps,
                    warmup_steps=max(1, args.steps // 10),
                    microbatches=args.microbatches,
                    grad_compression=args.compression,
                    ckpt_dir=args.ckpt_dir, ckpt_every=args.steps // 2,
                    dtype="float32")
    out = train_loop(args.arch, run, reduced=args.reduced,
                     device=args.device, n_layers=args.layers)
    print(f"final loss: {out['final_loss']:.4f} "
          f"(retries={out['executor'].retries_total}, "
          f"restarts={out['executor'].restarts_total})")


if __name__ == "__main__":
    main()
