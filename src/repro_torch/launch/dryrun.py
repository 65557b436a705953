"""Multi-pod dry run: trace every (arch x shape x mesh) cell on ``meta``
shards (the port of ``repro.launch.dryrun``).

The proof that the distribution config is coherent without real
hardware.  JAX stands 512 placeholder host devices in for 2 TPU pods
and compiles each cell; the port stands a fake process group of 256 or
512 ranks in for the production meshes (:func:`repro_torch.launch.mesh.
fake_device_mesh`), places the parameters, optimizer state, batch and
caches as DTensors of ``meta`` shards by the production rules
(:mod:`repro_torch.runtime.sharding`), runs the real step function
eagerly as rank 0 (the train step with its optimizer update, serving
prefill, one-token decode against populated caches) on the plain path
(``Ctx(plan="torch", mesh=...)``, as JAX's uses ``plan="jnp"``), and
extracts from the trace (:mod:`repro_torch.core.trace_costs`)

  * the memory by kind, the counterpart of ``memory_analysis()``: the
    per-device footprint against the card's memory (``HW.hbm_bytes``),
  * FLOPs, bytes and collective bytes of one rank's local ops, which
    feed the roofline (:mod:`repro_torch.core.roofline`) on the H100's
    numbers.

Rows keep JAX's keys; ``t_lower_s`` is the time to build and place the
cell, ``t_compile_s`` the time to trace it.  The memory term counts every
op's operands and result as if nothing were fused (no fusion happens on
the plain path): JAX's reads the bytes of XLA's fused kernels.  So
``t_memory_s``, and the ``bottleneck`` and ``roofline_fraction`` read
from it, are op-by-op, not comparable with JAX's (``hbm_bytes_basis``
says so in each row), and bound nothing on the card, where the serving
path runs fused kernels.  The FLOPs are JAX's on the cells that its own
plan does not repeat (tests/test_torch_dryrun.py).  JAX's
``dev_bytes_tpu_adj``, ``fits_hbm_tpu_adj`` and its helper
``kv_cache_dev_bytes`` are dropped: they subtract an XLA-CPU artifact
(the CPU backend upcasts the bf16 KV cache to fp32 and hoists the copy
out of its decode loop), which tracing on ``meta`` does not produce.

Where DTensor has no sharding strategy for an operation, or its
propagator fails for its operands' placements (a view that would split
a dim sharded unevenly or over nested shards, which GSPMD reshards on its
own), or its plan leaves a local shard a view cannot read, and the
operation runs at its operands' global shapes (so the program's shapes
are right), the operands are replicated explicitly and the operation is
run again (:class:`repro_torch.runtime.sharding.ReplicateOnGap`, shared with
real runs across ranks; the MoE layer does it for its
dispatch and combine), each replication counted as
``dryrun.redistribute_for_op.<op>`` and printed with the cell; an
in-place operation or any other failure ends the cell as an ``[ERR]``
row naming the operator, as JAX's ``run_cell`` reports errors.  Past the
reference's threshold the plain attention runs its 1024-row chunked
forms (``models.layers._gqa_chunked`` / ``_mha_chunked``), a Python
double loop over q and kv blocks that computes every block pair, as
JAX's scans do, so a long-sequence cell holds no whole (S, T) score
matrix and counts JAX's attention FLOPs.

The environment variables ``REPRO_REMAT`` (the remat mode),
``REPRO_MB`` (train microbatches) and ``REPRO_MOMENTS_FP32`` (fp32 Adam
moments) are the reference's, read where it reads them.

Usage (no card needed):
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch gemma-7b \\
      --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both \\
      --out build/dryrun.jsonl
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
import traceback

import torch

from repro_torch import obs
from repro_torch.configs import (SHAPES, RunConfig, get_config, input_specs,
                                 list_configs, token_count)
from repro_torch.core.roofline import HW, analyze_trace, model_flops
from repro_torch.core.trace_costs import trace_costs
from repro_torch.launch.mesh import fake_device_mesh, make_production_mesh
from repro_torch.launch.train import make_train_step
from repro_torch.models import Ctx, build_model
from repro_torch.models import transformer
from repro_torch.optim import OptState, init_opt_state
from repro_torch.runtime import sharding as shr
from repro_torch.runtime.sharding import ReplicateOnGap

__all__ = ["build_cell", "run_cell", "main", "ReplicateOnGap",
           "TRAIN_MICROBATCHES", "PREFILL_MICROBATCHES", "KV_INT8_ARCHS"]

SKIP = {}  # (arch, shape) -> reason, filled by main()


def _skips():
    out = {}
    for name in list_configs():
        cfg = get_config(name)
        if not cfg.sub_quadratic:
            out[(name, "long_500k")] = (
                "full self-attention is super-quadratic at 512k; "
                "per-spec skip (DESIGN.md §5)")
    return out


# Gradient-accumulation defaults for the train_4k cells (the
# reference's): global batch 256 x 4096 tokens does not fit one device's
# memory in one shot for the >=7B dense archs (the per-layer backward
# working set scales with the microbatch).
TRAIN_MICROBATCHES = {
    "mistral-large-123b": 8,
    "llava-next-34b": 4,
    "deepseek-coder-33b": 4,
    "qwen1.5-32b": 4,
    "gemma-7b": 2,
    "seamless-m4t-large-v2": 2,
    # MoE: the top-k dispatch working set is O(tokens * k) and
    # replicated across the mesh; bound it per microbatch
    "granite-moe-1b-a400m": 8,
    "olmoe-1b-7b": 32,
    "zamba2-2.7b": 8,
}

# Batch-chunked prefill for the same reason (no optimizer state in
# serving, so chunking the request batch is free).
PREFILL_MICROBATCHES = {
    "granite-moe-1b-a400m": 8,
    "olmoe-1b-7b": 16,
    "zamba2-2.7b": 4,
}

# int8-quantized KV cache for decode: qwen1.5-32b is full MHA (40 kv
# heads), whose bf16 cache at 128 x 32k is the reference's reason.
KV_INT8_ARCHS = {"qwen1.5-32b"}


def _split(batch: dict, n: int, i: int, mesh) -> dict:
    """Microbatch ``i`` of ``n`` equal slices of the batch's leading dim,
    held batch-sharded as JAX's map over the reshaped batch keeps it."""
    mb = {k: shr.microbatch(v, n, i) for k, v in batch.items()}
    return shr.constrain_tree(mb, shr.batch_shardings(mesh, mb))


def build_cell(arch: str, shape_name, mesh, device_mesh, *,
               run: RunConfig | None = None, reduced: bool = False):
    """``(fn, args, donate, model_flops_useful)``: the cell's step, its
    arguments placed on ``device_mesh`` by ``mesh``'s rules, and the
    positions of the arguments it updates in place (JAX's donated
    buffers).  ``shape_name`` names a ``SHAPES`` entry or is a
    ``ShapeSpec``; ``reduced`` takes the arch's reduced config (tests)."""
    cfg = get_config(arch, reduced=reduced)
    if os.environ.get("REPRO_REMAT"):
        cfg = dataclasses.replace(cfg, remat=os.environ["REPRO_REMAT"])
    shape = (SHAPES[shape_name] if isinstance(shape_name, str)
             else shape_name)
    model = build_model(cfg)
    # ctx.mesh enables the sequence-parallel activation constraints
    ctx = Ctx(plan="torch", dtype=torch.bfloat16, mesh=mesh)
    mb_env = os.environ.get("REPRO_MB")
    run = run or RunConfig(
        seq_len=shape.seq_len, global_batch=shape.global_batch,
        microbatches=(int(mb_env) if mb_env else
                      TRAIN_MICROBATCHES.get(arch, 1))
        if shape.kind == "train" else 1)

    params_g = model.init(seed=0, dtype=torch.float32, device="meta")
    params = shr.place(params_g, shr.param_shardings(mesh, params_g),
                       device_mesh)
    specs = input_specs(cfg, shape)
    batch = shr.place(specs, shr.batch_shardings(mesh, specs), device_mesh)
    tokens = token_count(shape)
    n_active = cfg.active_param_count()

    if shape.kind == "train":
        # bf16 Adam moments by default (the update math stays fp32);
        # opt out with REPRO_MOMENTS_FP32=1
        mdt = None if os.environ.get("REPRO_MOMENTS_FP32") \
            else torch.bfloat16
        opt_g = init_opt_state(params_g, moments_dtype=mdt)
        opt = OptState(
            mu=shr.place(opt_g.mu, shr.param_shardings(mesh, opt_g.mu),
                         device_mesh),
            nu=shr.place(opt_g.nu, shr.param_shardings(mesh, opt_g.nu),
                         device_mesh),
            step=shr.place(opt_g.step, shr.replicated(mesh), device_mesh))
        step = make_train_step(model, ctx, run)

        def train_step(params, opt, batch):
            params, opt, _, metrics = step(params, opt, {}, batch)
            return params, opt, metrics

        return (train_step, (params, opt, batch), (0, 1),
                model_flops(n_active, tokens, train=True))

    if shape.kind == "prefill":
        pmb = PREFILL_MICROBATCHES.get(arch, 1)

        def prefill_step(params, batch):
            if pmb == 1:
                return model.prefill_logits(params, batch, ctx)
            # batch-chunked prefill (vLLM-style): bounds the MoE dispatch
            # and SSD working set; requests are independent across batch
            return torch.stack([
                model.prefill_logits(params, _split(batch, pmb, i, mesh),
                                     ctx)
                for i in range(pmb)])

        return (prefill_step, (params, batch), (),
                model_flops(n_active, tokens, train=False))

    # decode: the int8 KV cache for the MHA arch whose bf16 cache is the
    # largest
    if arch in KV_INT8_ARCHS and cfg.family in ("dense", "vlm"):
        cache_g = transformer.init_cache(
            cfg, shape.global_batch, shape.seq_len, torch.bfloat16,
            device="meta", quantize_kv=True)
    else:
        cache_g = model.init_cache(shape.global_batch, shape.seq_len,
                                   torch.bfloat16, device="meta")
    cache = shr.place(cache_g, shr.cache_shardings(mesh, cache_g),
                      device_mesh)

    def decode_step(params, cache, tokens_in):
        return model.decode(params, cache, tokens_in, ctx)

    return (decode_step, (params, cache, batch["tokens"]), (1,),
            model_flops(n_active, tokens, train=False))


def run_cell(arch: str, shape_name: str, *, multi_pod: bool,
             hw: HW | None = None) -> dict:
    import torch.distributed as dist
    from torch.distributed.tensor.experimental import implicit_replication

    mesh_name = "pod2x16x16" if multi_pod else "pod16x16"
    cell = f"{arch}/{shape_name}/{mesh_name}"
    if (arch, shape_name) in SKIP:
        return {"cell": cell, "status": "skipped",
                "reason": SKIP[(arch, shape_name)]}
    t0 = time.time()
    try:
        mesh = make_production_mesh(multi_pod=multi_pod, device="meta")
        chips = mesh.size
        obs.reset_counters("dryrun.")
        device_mesh = fake_device_mesh(mesh)
        try:
            # plain tensors the step makes (positions, masks) take part
            # as replicated, as constants do under GSPMD
            with implicit_replication(), torch.no_grad():
                fn, args, donate, useful = build_cell(arch, shape_name,
                                                      mesh, device_mesh)
                t_lower = time.time() - t0
                _, costs = trace_costs(fn, *args, donate=donate,
                                       inner=ReplicateOnGap())
            t_compile = time.time() - t0 - t_lower
        finally:
            dist.destroy_process_group()
        rep = analyze_trace(cell, costs, chips, model_flops_useful=useful,
                            hw=hw)
        hbm = (hw or HW()).hbm_bytes
        ma = costs.memory
        dev_bytes = (ma["argument"] + ma["temp"] + ma["output"]
                     - ma["alias"])
        row = rep.row()
        row.update({
            "status": "ok",
            "kind": SHAPES[shape_name].kind,
            "t_lower_s": round(t_lower, 1),
            "t_compile_s": round(t_compile, 1),
            "arg_bytes_dev": ma["argument"],
            "temp_bytes_dev": ma["temp"],
            "out_bytes_dev": ma["output"],
            "alias_bytes_dev": ma["alias"],
            "dev_bytes_total": dev_bytes,
            "fits_hbm": bool(dev_bytes <= hbm),
            # the bytes behind t_memory_s, bottleneck and
            # roofline_fraction (module docstring)
            "hbm_bytes_basis": "op-by-op",
            "collectives": {k: int(v) for k, v in
                            rep.collectives.count_by_kind.items()},
            "redistribute_for_op": {
                k[len("dryrun.redistribute_for_op."):]: v
                for k, v in obs.counters("dryrun.redistribute_for_op.")
                .items()},
        })
        return row
    except Exception as e:
        return {"cell": cell, "status": "error",
                "error": f"{type(e).__name__}: {e}".splitlines()[0],
                "trace": traceback.format_exc()[-6000:]}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", choices=["single", "multi", "both"],
                    default="single")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    global SKIP
    SKIP = _skips()

    archs = list_configs() if args.all or not args.arch else [args.arch]
    shapes = list(SHAPES) if args.all or not args.shape else [args.shape]
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]

    out_f = open(args.out, "a") if args.out else None
    for arch in archs:
        for shape in shapes:
            for multi in meshes:
                row = run_cell(arch, shape, multi_pod=multi)
                status = row["status"]
                if status == "ok":
                    redis = "".join(
                        f" redistribute_for_op[{k}]={v}"
                        for k, v in row["redistribute_for_op"].items())
                    print(f"[OK]   {row['cell']:50s} "
                          f"trace={row['t_compile_s']:6.1f}s "
                          f"bottleneck={row['bottleneck']:10s} "
                          f"roofline={row['roofline_fraction']:.3f} "
                          f"(op-by-op bytes) "
                          f"dev_mem={row['dev_bytes_total']/2**30:6.2f}GiB "
                          f"fits={row['fits_hbm']}{redis}", flush=True)
                elif status == "skipped":
                    print(f"[SKIP] {row['cell']:50s} {row['reason']}",
                          flush=True)
                else:
                    print(f"[ERR]  {row['cell']:50s} {row['error']}",
                          flush=True)
                if out_f:
                    out_f.write(json.dumps(
                        {k: v for k, v in row.items() if k != "trace"}) + "\n")
                    out_f.flush()
    if out_f:
        out_f.close()


if __name__ == "__main__":
    main()
