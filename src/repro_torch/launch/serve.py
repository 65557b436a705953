"""Serving launcher: continuous batching over random-weight models.

Requests with (optionally mixed-length) prompts are prefilled one at a
time and decode together in the engine's slot pool.  On the card every
projection and the LM head run the zero-stall matmul kernel and prefill
attention the flash-attention kernel.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma-7b \\
      --no-reduced --dtype bfloat16 --batch 8 --num-slots 4 \\
      --prompt-len 128 --gen-len 32 --mixed --steps-per-dispatch 4

Pass ``--device cpu`` to run the plain versions of the kernels on the
host (at the reduced size).
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs import get_config
from repro_torch.models import Ctx, build_model
from repro_torch.plan.config import dtype_from_name
from repro_torch.serve import Request, ServeEngine

__all__ = ["serve_batch", "make_requests"]


def make_requests(cfg, seed: int, batch: int, prompt_len: int, gen_len: int,
                  mixed: bool, *, temperature: float = 0.0, top_k: int = 0,
                  top_p: float = 1.0) -> list[Request]:
    """``batch`` requests with prompts drawn from ``seed``; with
    ``mixed``, prompt lengths cycle through {1, 1/2, 1/4, 3/4} of
    ``prompt_len`` (the ragged traffic continuous batching exists for)."""
    toks = np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (batch, prompt_len))
    reqs = []
    for i in range(batch):
        frac = (1.0, 0.5, 0.25, 0.75)[i % 4] if mixed else 1.0
        n = max(1, int(prompt_len * frac))
        reqs.append(Request(rid=i, prompt=toks[i, :n].tolist(),
                            max_new_tokens=gen_len, temperature=temperature,
                            top_k=top_k, top_p=top_p))
    return reqs


def serve_batch(arch: str, *, reduced: bool = True, batch: int = 4,
                prompt_len: int = 32, gen_len: int = 32, seed: int = 0,
                dtype: torch.dtype = torch.float32,
                num_slots: int | None = None, mixed: bool = False,
                backend: str = "auto", steps_per_dispatch: int = 1,
                temperature: float = 0.0, top_k: int = 0, top_p: float = 1.0,
                step_timeout_s: float | None = None, device=None) -> dict:
    """Run a synthetic request batch through the serving engine.

    Parameters are made from ``seed`` directly in ``dtype`` on
    ``device`` (``None``: the CUDA device; it raises when there is
    none).  ``backend`` is ``"auto"`` (the kernels on the card) or
    ``"torch"`` (the plain versions).  Returns the generated tokens
    (``(batch, gen_len)``, -1 past a request's end), throughput and the
    engine's stats snapshot.
    """
    device = resolve_device(device)
    cfg = get_config(arch, reduced=reduced)
    model = build_model(cfg)
    ctx = Ctx(plan=backend, dtype=dtype)
    params = model.init(seed=seed, dtype=dtype, device=device)
    slots = num_slots or min(batch, 4)
    engine = ServeEngine(model, params, ctx, num_slots=slots,
                         max_len=prompt_len + gen_len, cache_dtype=dtype,
                         steps_per_dispatch=steps_per_dispatch, seed=seed,
                         device=device)
    reqs = make_requests(cfg, seed, batch, prompt_len, gen_len, mixed,
                         temperature=temperature, top_k=top_k, top_p=top_p)
    results = engine.run(reqs, step_timeout_s=step_timeout_s)
    tp = engine.throughput()
    gen = np.full((batch, gen_len), -1, np.int64)
    for rid, res in results.items():
        gen[rid, :len(res.tokens)] = res.tokens
    return {"generated": gen, **tp, "stats": engine.stats.snapshot()}


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
    args = ap.parse_args(argv)
    out = serve_batch(args.arch, reduced=args.reduced, batch=args.batch,
                      prompt_len=args.prompt_len, gen_len=args.gen_len,
                      seed=args.seed, dtype=dtype_from_name(args.dtype),
                      num_slots=args.num_slots, mixed=args.mixed,
                      backend=args.backend,
                      steps_per_dispatch=args.steps_per_dispatch,
                      temperature=args.temperature, top_k=args.top_k,
                      top_p=args.top_p, step_timeout_s=args.step_timeout,
                      device=args.device)
    s = out["stats"]
    print(f"generated shape: {out['generated'].shape}")
    print(f"prefill: {out['prefill_s']:.2f}s ({out['prefill_tok_s']:.1f} "
          f"tok/s)  decode: {out['decode_s']:.2f}s "
          f"({out['decode_tok_s']:.1f} tok/s)")
    print(f"steps: {s['decode_steps']}  dispatches: {s['dispatches']}  "
          f"admitted: {s['admitted']}  retired: {s['retired']}  "
          f"max concurrent: {s['max_concurrent']}")


if __name__ == "__main__":
    main()
