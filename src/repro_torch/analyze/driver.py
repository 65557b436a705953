"""Repo-wide static-analysis driver: family -> traced plan -> Report.

The port of ``repro.analyze.driver``.  :func:`analyze_arch` is the
one-stop entry of the CLI (``python -m repro_torch.analyze``): build a
reduced model for one architecture, resolve its execution plan by a
meta-device trace (:func:`repro_torch.plan.trace_model`: shapes only, no
FLOPs), then run the analyzer layers over the result:

  1. :func:`repro_torch.analyze.lint_plan` — plan artifact legality plus
     the per-entry revolving-buffer hazard simulation (ZS-S*/ZS-L*);
  2. :func:`repro_torch.analyze.lint_program` over the prefill, decode
     and loss programs on the meta device — fallback matmuls, host
     syncs (ZS-P*);
  3. the same program lint over a fused K-step decode + greedy-argmax
     block, the dispatch shape ``ServeEngine(steps_per_dispatch=K)``
     runs: any host sync inside it would serialize the decode loop.

:func:`analyze_families` additionally audits the allowlist: across a
full five-family sweep every ``DEFAULT_ALLOW`` entry must sanction at
least one real product site, or it is stale (``ZS-P004``).  The kernel
launch verifier (:func:`repro_torch.analyze.kernel_lint.lint_kernels`)
is a separate sweep (``--kernels``).

The models are traced in bf16 (the serving dtype, whose products run
the TMA + wgmma designs); model imports are deferred so that ``import
repro_torch.analyze`` stays cheap for users who only want the checkers.
"""

from __future__ import annotations

__all__ = ["FAMILY_ARCHS", "analyze_arch", "analyze_families"]

# one representative (reduced) architecture per model family
FAMILY_ARCHS = {
    "dense": "gemma-7b",
    "moe": "olmoe-1b-7b",
    "ssm": "mamba2-130m",
    "hybrid": "zamba2-2.7b",
    "encdec": "seamless-m4t-large-v2",
}


def analyze_arch(arch: str, *, backend: str = "auto",
                 quant: str | None = None, prompt_len: int = 16,
                 max_len: int = 32, fused_steps: int = 4, policy=None,
                 dtype=None):
    """Statically verify one architecture end to end.

    Traces a fresh plan for the reduced config under ``backend``
    (``"auto"`` resolves the Hopper kernels' configs through the tuner's
    model, no card needed), lints the plan (+ optional fault
    ``policy``), then lints the prefill / decode / loss / fused-block
    programs on the meta device.  Returns a
    :class:`repro_torch.analyze.Report`; ``report.meta`` carries
    counters (entries checked, programs linted).
    """
    import torch

    from repro_torch.analyze.plan_lint import lint_plan
    from repro_torch.analyze.program_lint import lint_program, merge_allow_hits
    from repro_torch.configs import get_config
    from repro_torch.models import Ctx, build_model
    from repro_torch.plan import Plan, trace_model

    dtype = dtype or torch.bfloat16
    meta = torch.device("meta")
    cfg = get_config(arch, reduced=True)
    model = build_model(cfg)
    ctx = Ctx(plan=Plan(backend=backend, quant=quant), dtype=dtype)

    batch = {"tokens": torch.zeros((1, prompt_len), dtype=torch.int32,
                                   device=meta),
             "lengths": torch.zeros((1,), dtype=torch.int32, device=meta)}
    shapes = {"tokens": ((1, prompt_len), torch.int32),
              "lengths": ((1,), torch.int32)}
    if cfg.family == "encdec" or cfg.frontend:
        n = prompt_len if cfg.family == "encdec" else cfg.frontend_tokens
        batch["frontend_embeds"] = torch.zeros((1, n, cfg.d_model),
                                               dtype=dtype, device=meta)
        shapes["frontend_embeds"] = ((1, n, cfg.d_model), dtype)
    cache_kwargs = {"enc_len": prompt_len} if cfg.family == "encdec" else {}

    params = model.init(seed=0, dtype=dtype, device=meta)
    if quant is not None:
        params = model.quantize_weights(params, fmt=quant)
    plan = trace_model(model, [shapes], ctx, max_len=max_len,
                       cache_dtype=dtype, cache_kwargs=cache_kwargs,
                       params=params)
    report = lint_plan(plan, policy=policy)

    # program lint under the resolved plan: no tuner call, and a kernel
    # launch shows up as no product at all on the meta device
    ctx = ctx.with_plan(plan)
    programs = 0
    allow_hits: dict = {}

    def run_lint(fn):
        nonlocal programs, allow_hits
        sub = lint_program(fn, quant=quant is not None)
        report.extend(sub)
        allow_hits = merge_allow_hits(allow_hits, sub.meta["allow_hits"])
        programs += 1

    def cache():
        c = model.init_cache(1, max_len, dtype, device=meta, **cache_kwargs)
        c["pos"] = torch.zeros((1,), dtype=torch.int32, device=meta)
        return c

    tok = torch.zeros((1, 1), dtype=torch.int32, device=meta)
    run_lint(lambda: model.prefill(params, batch, ctx, max_len))
    run_lint(lambda: model.decode(params, cache(), tok, ctx))
    # the training objective: exercises the loss-side sanctioned sites
    # (cross_entropy) no serving trace reaches
    run_lint(lambda: model.loss(params, {**batch, "targets": batch["tokens"]},
                                ctx))
    if fused_steps > 1:
        # the fused K-step dispatch: decode + on-device greedy sampling,
        # one host sync per block (at its end, outside the program)
        def block():
            c, t, toks = cache(), tok, []
            for _ in range(fused_steps):
                logits, c = model.decode(params, c, t, ctx)
                t = torch.argmax(logits[:, -1], dim=-1)
                t = t.to(torch.int32)[:, None]
                toks.append(t[:, 0])
            return torch.stack(toks, dim=1)

        run_lint(block)

    out = report.dedupe()
    out.meta.update({"arch": arch, "family": cfg.family,
                     "backend": backend, "quant": quant,
                     "plan_entries": len(plan.entries),
                     "programs_linted": programs,
                     "allow_hits": allow_hits})
    return out


def analyze_families(families=None, *, backend: str = "auto",
                     quant: str | None = None, fused_steps: int = 4,
                     policy=None) -> dict:
    """Run :func:`analyze_arch` over the family representatives.

    Returns ``{arch: Report}`` for ``families`` (all five by default;
    names may be family keys or explicit arch names).  When the sweep
    covers every family, two audit entries are added:

    * ``"<dense-arch>@torch"`` — the dense representative re-linted on
      the plain ``"torch"`` backend (the JAX package's ``"@jnp"``
      entry), whose reference paths (``repro_torch/kernels/`` products,
      the ``_gqa_full`` einsums) never appear under the kernel backend;
    * ``"allowlist"`` — the merged ``DEFAULT_ALLOW`` hit counts audited
      for stale entries (``ZS-P004``).

    Partial sweeps skip both: a single-family run legitimately leaves
    other families' sanctioned sites unmatched.
    """
    from repro_torch.analyze.program_lint import (check_allowlist,
                                                  merge_allow_hits)

    picks = [FAMILY_ARCHS.get(name, name)
             for name in (families or list(FAMILY_ARCHS))]
    out = {arch: analyze_arch(arch, backend=backend, quant=quant,
                              fused_steps=fused_steps, policy=policy)
           for arch in picks}
    covered = {rep.meta.get("family") for rep in out.values()}
    if covered >= set(FAMILY_ARCHS):
        dense = FAMILY_ARCHS["dense"]
        out[f"{dense}@torch"] = analyze_arch(
            dense, backend="torch", quant=quant, fused_steps=fused_steps,
            policy=policy)
        merged = merge_allow_hits(*(rep.meta.get("allow_hits", {})
                                    for rep in out.values()))
        out["allowlist"] = check_allowlist(merged)
    return out
