"""Serving launcher: continuous batching over random-weight models.

Requests with (optionally mixed-length) prompts are prefilled one at a
time and decode together in the engine's slot pool.  On the card every
projection and the LM head run the zero-stall matmul kernel, prefill
attention the flash-attention kernel and, with a paged cache, decode
attention the paged-attention kernel.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma-7b \\
      --no-reduced --dtype bfloat16 --batch 8 --num-slots 4 \\
      --prompt-len 128 --gen-len 32 --mixed --steps-per-dispatch 4 \\
      --page-size 16 --prefill-chunk 96

The encoder-decoder and vision-language families serve the same way:
each request then carries random stub embeddings (the encoder's source
frames, or the image's patch positions before the prompt):

  PYTHONPATH=src python -m repro_torch.launch.serve \
      --arch seamless-m4t-large-v2 --no-reduced --dtype bfloat16 \
      --batch 8 --prompt-len 128 --gen-len 32 --mixed --page-size 16

Pass ``--device cpu`` to run the plain versions of the kernels on the
host (at the reduced size), and ``--trace-out PATH`` to stream the
engine's spans and events to a JSONL file.  ``--plan trace`` resolves
every kernel config of the engine's call shapes ahead of serving
(:func:`repro_torch.plan.trace_model` on the meta device), ``--plan
PATH`` serves under a saved plan (the JAX package's plan files load
too), and ``--plan-out PATH`` saves the engine's active plan.
``--validate-plan`` runs the static analyzer over the active plan (and,
paged, the page geometry) when the engine is built
(``ServeEngine(validate=True)``) and refuses a plan with an error
diagnostic.

Cluster serving (:mod:`repro_torch.serve.cluster`): ``--replicas N``
fronts N engine replicas, sharing one set of params, with a ``Router``
(load-aware placement, fault-tolerant re-queue); ``--kill-replica R``
fails replica R at router step ``--kill-at-step`` (fault injection: its
in-flight requests finish on the survivors); ``--mesh DxM`` builds each
engine as a ``ShardedEngine`` over a ('data', 'model') mesh: 1x1 in one
process, or, under ``torch.distributed.run`` with D x M processes, one
rank a process (every replica over the same ranks; rank 0 alone
prints; a mesh whose size is not the world's raises).  ``--metrics`` prints the TTFT, queue-wait and per-token latency
percentiles, the mean dispatch occupancy and the per-op utilization
table (:func:`repro_torch.obs.utilization_table`):

  PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma-7b \\
      --no-reduced --dtype bfloat16 --batch 8 --prompt-len 128 \\
      --gen-len 32 --mixed --steps-per-dispatch 4 --replicas 2 \\
      --kill-replica 1 --metrics

Across ranks (four ranks share one H100 over gloo, or use four cards):

  PYTHONPATH=src python -m torch.distributed.run --nproc-per-node 4 \
      -m repro_torch.launch.serve --arch gemma-7b --mesh 1x4
"""

from __future__ import annotations

import argparse
import dataclasses
import hashlib
import os

import numpy as np
import torch

from repro_torch import obs, resolve_device
from repro_torch.configs import get_config
from repro_torch.models import Ctx, build_model
from repro_torch.plan import Plan
from repro_torch.plan.config import dtype_from_name
from repro_torch.serve import Request, Router, ServeEngine, ShardedEngine
from repro_torch.serve.cluster import place_in_turn

__all__ = ["serve_batch", "make_requests", "frontend_len"]


def _parse_mesh(spec: str, device=None):
    """``"DxM"`` -> a ('data', 'model') mesh over the local devices."""
    from repro_torch.launch.mesh import make_mesh_compat
    try:
        d, m = (int(x) for x in spec.lower().split("x"))
    except ValueError:
        raise ValueError(f"--mesh must look like 'DxM' (e.g. 1x8), "
                         f"got {spec!r}") from None
    return make_mesh_compat((d, m), ("data", "model"), device=device)


def frontend_len(cfg, prompt_len: int) -> int:
    """Rows of a request's stub frontend: the encdec source's frames
    (``prompt_len`` of them) or the vlm prefix's ``frontend_tokens``
    patch positions; 0 for a text-only family."""
    if cfg.family == "encdec":
        return prompt_len
    return cfg.frontend_tokens if cfg.frontend else 0


def make_requests(cfg, seed: int, batch: int, prompt_len: int, gen_len: int,
                  mixed: bool, *, temperature: float = 0.0, top_k: int = 0,
                  top_p: float = 1.0, device=None,
                  dtype: torch.dtype = torch.float32) -> list[Request]:
    """``batch`` requests with prompts drawn from ``seed``; with
    ``mixed``, prompt lengths cycle through {1, 1/2, 1/4, 3/4} of
    ``prompt_len`` (the ragged traffic continuous batching exists for).

    For the encdec and vlm families each request carries a stub frontend
    of :func:`frontend_len` rows (normal * 0.1, as in the JAX launcher),
    drawn in fp32 on ``device`` (None: the card) from request ``i``'s
    own generator, seeded from (``seed``, i), and stored in ``dtype``."""
    toks = np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (batch, prompt_len))
    n_front = frontend_len(cfg, prompt_len)
    dev = resolve_device(device) if n_front else None
    reqs = []
    for i in range(batch):
        frac = (1.0, 0.5, 0.25, 0.75)[i % 4] if mixed else 1.0
        n = max(1, int(prompt_len * frac))
        front = None
        if n_front:
            g = torch.Generator(device=dev)
            g.manual_seed(int(np.random.SeedSequence(
                [seed, i]).generate_state(1)[0]))
            front = (torch.randn((n_front, cfg.d_model), generator=g,
                                 device=dev) * 0.1).to(dtype)
        reqs.append(Request(rid=i, prompt=toks[i, :n].tolist(),
                            max_new_tokens=gen_len, frontend_embeds=front,
                            temperature=temperature, top_k=top_k,
                            top_p=top_p))
    return reqs


def serve_batch(arch: str, *, reduced: bool = True, batch: int = 4,
                prompt_len: int = 32, gen_len: int = 32, seed: int = 0,
                dtype: torch.dtype = torch.float32,
                num_slots: int | None = None, mixed: bool = False,
                backend: str = "auto", steps_per_dispatch: int = 1,
                temperature: float = 0.0, top_k: int = 0, top_p: float = 1.0,
                step_timeout_s: float | None = None, device=None,
                page_size: int | None = None, num_pages: int | None = None,
                prefill_chunk: int | None = None,
                n_layers: int | None = None, plan=None,
                plan_out: str | None = None,
                validate_plan: bool = False, replicas: int = 1,
                mesh: str | None = None, kill_replica: int | None = None,
                kill_at_step: int = 2) -> dict:
    """Run a synthetic request batch through the serving engine.

    Parameters are made from ``seed`` directly in ``dtype`` on
    ``device`` (``None``: the CUDA device; it raises when there is
    none).  ``backend`` is ``"auto"`` (the kernels on the card) or
    ``"torch"`` (the plain versions).  Returns the generated tokens
    (``(batch, gen_len)``, -1 past a request's end), throughput, the
    engine's stats snapshot and its CUDA graph captures (none on the
    CPU).  The encdec and vlm families get :func:`make_requests`' stub
    frontends; a vlm prefix widens ``max_len`` to prompt + prefix +
    generation, and an encdec engine's cross-attention extent is
    ``enc_len = prompt_len``.  ``page_size`` switches the KV cache to
    the paged pool (it must divide ``max_len``), ``num_pages`` sizes the pool
    (default: no oversubscription) and ``prefill_chunk`` ingests long
    prompts chunk by chunk between decode dispatches.  ``n_layers``
    cuts a layer-list family's depth (the first ``n_layers`` blocks at
    the config's widths), for a model whose full depth does not fit one
    card.  ``plan`` is forwarded to :class:`ServeEngine` (a
    :class:`~repro_torch.plan.Plan`, a path to a saved plan JSON, or
    ``"trace"``); ``plan_out`` saves the engine's active plan there;
    ``validate_plan`` builds the engine with ``validate=True``.

    Cluster knobs (:mod:`repro_torch.serve.cluster`): ``replicas`` fronts
    that many engines, sharing the params, with a
    :class:`~repro_torch.serve.Router` (with ``validate_plan``, the
    router's ``validate=True`` too); ``mesh`` (``"DxM"``) builds each
    engine as a :class:`~repro_torch.serve.ShardedEngine` over a
    ('data', 'model') mesh of ``device``'s kind; ``kill_replica`` fails
    that replica at router step ``kill_at_step`` and raises if the run
    ends before it fires.  Routed, ``stats`` is the router's snapshot
    (the fleet's merged stats, ``per_replica`` and ``router``),
    ``captures`` every replica's (each with its ``replica``), and the
    output gains a ``cluster`` section: the router's counters and each
    replica's dispatches.
    """
    device = resolve_device(device)
    cfg = get_config(arch, reduced=reduced)
    if n_layers is not None:
        if cfg.family in ("encdec", "hybrid"):
            raise ValueError(f"n_layers cuts the depth of the dense, vlm, "
                             f"MoE and SSM families, not {cfg.family!r}")
        cfg = dataclasses.replace(cfg, n_layers=int(n_layers))
    model = build_model(cfg)
    ctx = Ctx(plan=backend, dtype=dtype)
    device_mesh = (_parse_mesh(mesh, device) if mesh is not None else None)
    if device_mesh is not None and device_mesh.ranks is not None \
            and device_mesh.size > 1:
        params = place_in_turn(
            lambda: model.init(seed=seed, dtype=dtype, device=device),
            device_mesh)
    else:
        params = model.init(seed=seed, dtype=dtype, device=device)
    if isinstance(plan, str) and plan != "trace":
        plan = Plan.load(plan)
    slots = num_slots or min(batch, 4)
    n_prefix = 0 if cfg.family == "encdec" else frontend_len(cfg, prompt_len)

    def make_engine():
        kw = dict(num_slots=slots, max_len=prompt_len + n_prefix + gen_len,
                  cache_dtype=dtype, steps_per_dispatch=steps_per_dispatch,
                  seed=seed, page_size=page_size, num_pages=num_pages,
                  prefill_chunk=prefill_chunk,
                  cache_kwargs=({"enc_len": prompt_len}
                                if cfg.family == "encdec" else None),
                  plan=plan, validate=validate_plan)
        if device_mesh is not None:
            return ShardedEngine(model, params, ctx, mesh=device_mesh, **kw)
        return ServeEngine(model, params, ctx, device=device, **kw)

    reqs = make_requests(cfg, seed, batch, prompt_len, gen_len, mixed,
                         temperature=temperature, top_k=top_k, top_p=top_p,
                         device=device, dtype=dtype)
    cluster = None
    if replicas > 1:
        engines = [make_engine() for _ in range(replicas)]
        router = Router(engines, validate=validate_plan,
                        step_timeout_s=step_timeout_s)
        for r in reqs:
            router.submit(r)
        step = 0
        while not router.idle:
            if kill_replica is not None and step == kill_at_step:
                router.kill(kill_replica)
            router.step()
            step += 1
        if kill_replica is not None and router.deaths == 0:
            raise RuntimeError(
                f"kill_replica={kill_replica} never fired: the run "
                f"finished in {step} steps (<= kill_at_step="
                f"{kill_at_step}) — the fault-injection smoke was "
                f"vacuous; raise --gen-len or lower --kill-at-step")
        results = router.results
        fleet = router.stats()
        stats = router.snapshot()
        cluster = dict(stats["router"], per_replica_dispatches=[
            r["dispatches"] for r in stats["per_replica"]])
        engine = engines[0]
        captures = [dict(c, replica=i) for i, e in enumerate(engines)
                    for c in e.captures]
        tp = {"prefill_tok_s": fleet.prefill_tok_s,
              "decode_tok_s": fleet.decode_tok_s,
              "prefill_s": fleet.prefill_s, "decode_s": fleet.decode_s}
    else:
        engine = make_engine()
        results = engine.run(reqs, step_timeout_s=step_timeout_s)
        stats, captures = engine.stats.snapshot(), engine.captures
        tp = engine.throughput()
    if plan_out:
        engine.plan.save(plan_out)
    gen = np.full((batch, gen_len), -1, np.int64)
    for rid, res in results.items():
        gen[rid, :len(res.tokens)] = res.tokens
    out = {"generated": gen, **tp, "stats": stats, "captures": captures,
           "plan": engine.plan}
    if cluster is not None:
        out["cluster"] = cluster
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="gemma-7b")
    ap.add_argument("--reduced", action=argparse.BooleanOptionalAction,
                    default=True, help="the smoke-size config (--no-reduced "
                    "for the published widths)")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--num-slots", type=int, default=None)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen-len", type=int, default=32)
    ap.add_argument("--mixed", action="store_true",
                    help="mixed prompt lengths (ragged traffic)")
    ap.add_argument("--backend", default="auto", choices=["auto", "torch"])
    ap.add_argument("--dtype", default="float32",
                    choices=["float32", "bfloat16"])
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    ap.add_argument("--steps-per-dispatch", type=int, default=1)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--top-k", type=int, default=0)
    ap.add_argument("--top-p", type=float, default=1.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--step-timeout", type=float, default=None)
    ap.add_argument("--page-size", type=int, default=None,
                    help="tokens per KV page: the paged pool with prefix "
                    "sharing (default: contiguous per-slot cache)")
    ap.add_argument("--num-pages", type=int, default=None,
                    help="page-pool size including the trash page "
                    "(default: no oversubscription)")
    ap.add_argument("--prefill-chunk", type=int, default=None,
                    help="ingest prompts longer than this in chunks of "
                    "this many tokens between decode dispatches")
    ap.add_argument("--layers", type=int, default=None,
                    help="serve only the first N layers (a depth cut for "
                    "a model that does not fit the card)")
    ap.add_argument("--plan", default=None, metavar="trace|PATH",
                    help="'trace' to resolve every kernel config ahead of "
                    "time, or a path to a saved plan JSON")
    ap.add_argument("--plan-out", default=None, metavar="PATH",
                    help="save the engine's active execution plan here")
    ap.add_argument("--validate-plan", action="store_true",
                    help="run the static analyzer over the active plan "
                    "(and page geometry) at engine construction; a plan "
                    "with an error diagnostic is refused")
    ap.add_argument("--replicas", type=int, default=1,
                    help="front N engine replicas with the cluster Router "
                    "(load-aware placement, fault-tolerant re-queue)")
    ap.add_argument("--mesh", default=None, metavar="DxM",
                    help="build each engine as a ShardedEngine over a "
                    "('data', 'model') mesh: 1x1 in one process, or the "
                    "ranks of torch.distributed.run (D x M of them)")
    ap.add_argument("--kill-replica", type=int, default=None,
                    help="fail this replica mid-run (fault injection: its "
                    "in-flight requests re-queue onto the survivors)")
    ap.add_argument("--kill-at-step", type=int, default=2,
                    help="router step at which --kill-replica fires")
    ap.add_argument("--metrics", action="store_true",
                    help="print per-request latency percentiles (TTFT, "
                    "queue wait, per-token p50/p99) and the per-op "
                    "utilization table after the run")
    ap.add_argument("--trace-out", default=None, metavar="PATH",
                    help="write a JSONL span/event trace of the run here "
                    "(implies tracing on; one JSON object per line)")
    args = ap.parse_args(argv)
    ranked = int(os.environ.get("WORLD_SIZE", "1")) > 1
    if ranked:
        from repro_torch.runtime.ranks import init_ranks
        init_ranks(device=args.device)
    try:
        _run(args, quiet=ranked and int(os.environ["RANK"]) != 0)
    finally:
        if ranked:
            import torch.distributed as dist
            dist.destroy_process_group()


def _run(args, *, quiet: bool) -> None:
    """Serve as ``main``'s arguments say; ``quiet`` on every rank but
    rank 0 of a world."""
    # --trace-out / --metrics turn observability on for the run: spans
    # and events stream to the JSONL sink (if any), kernel dispatches
    # feed the utilization table
    if args.trace_out:
        obs.enable(trace_path=args.trace_out)
    elif args.metrics:
        obs.enable()
    try:
        out = serve_batch(
            args.arch, reduced=args.reduced, batch=args.batch,
            prompt_len=args.prompt_len, gen_len=args.gen_len,
            seed=args.seed, dtype=dtype_from_name(args.dtype),
            num_slots=args.num_slots, mixed=args.mixed,
            backend=args.backend, steps_per_dispatch=args.steps_per_dispatch,
            temperature=args.temperature, top_k=args.top_k,
            top_p=args.top_p, step_timeout_s=args.step_timeout,
            device=args.device, page_size=args.page_size,
            num_pages=args.num_pages, prefill_chunk=args.prefill_chunk,
            n_layers=args.layers, plan=args.plan, plan_out=args.plan_out,
            validate_plan=args.validate_plan, replicas=args.replicas,
            mesh=args.mesh, kill_replica=args.kill_replica,
            kill_at_step=args.kill_at_step)
        if quiet:
            return
        s = out["stats"]
        print(f"generated shape: {out['generated'].shape}")
        print(f"generated digest: "
              f"{hashlib.sha256(out['generated'].tobytes()).hexdigest()[:16]}")
        print(f"prefill: {out['prefill_s']:.2f}s "
              f"({out['prefill_tok_s']:.1f} tok/s)  decode: "
              f"{out['decode_s']:.2f}s ({out['decode_tok_s']:.1f} tok/s)")
        print(f"steps: {s['decode_steps']}  dispatches: {s['dispatches']}  "
              f"admitted: {s['admitted']}  retired: {s['retired']}  "
              f"max concurrent: {s['max_concurrent']}")
        if args.page_size is not None or args.prefill_chunk is not None:
            print(f"pages in use (peak): {s['pages_in_use']}  "
                  f"shared: {s['pages_shared']}  "
                  f"prefill chunks: {s['prefill_chunks']}")
        if "cluster" in out:
            c = out["cluster"]
            print(f"cluster: replicas: {c['replicas']}  "
                  f"alive: {c['alive']}  deaths: {c['deaths']}  "
                  f"requeues: {c['requeues']}  "
                  f"per-replica dispatches: "
                  f"{c['per_replica_dispatches']}")
        print(f"plan: {out['plan']!r} fingerprint "
              f"{out['plan'].fingerprint()}")
        if args.metrics:
            for name in ("ttft", "queue_wait", "token_latency"):
                m = s[name]
                print(f"{name}: p50={m['p50']:.4f}s p99={m['p99']:.4f}s "
                      f"max={m['max']:.4f}s (n={m['n']})")
            print(f"mean dispatch occupancy: "
                  f"{s['mean_dispatch_occupancy']:.2f}")
            print("op,M,N,K,dtype,backend,config,count,predicted_util")
            for r in obs.utilization_table():
                print(f"{r['op']},{r['M']},{r['N']},{r['K']},{r['dtype']},"
                      f"{r['backend']},{r['config']},{r['count']},"
                      f"{r['predicted_util']:.4f}")
        if args.plan_out:
            print(f"plan written to {args.plan_out}")
        if args.trace_out:
            print(f"trace written to {args.trace_out}")
    finally:
        if args.trace_out or args.metrics:
            obs.reset_records()
            obs.disable()


if __name__ == "__main__":
    main()
