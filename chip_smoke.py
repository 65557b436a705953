#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one H100.

    python3 chip_smoke.py

Phases, each printed as it runs:

1. the card's name and power limit (``nvidia-smi``);
2. the build of every CUDA kernel from ``src/repro_torch/kernels/csrc``
   (one nvcc per source, all at once) and its time;
3. each kernel against its plain PyTorch version on the card at the
   shapes of the main path (full-width gemma-7b in bf16), plus fp32
   matmul at a ragged shape for every ring depth and grid order, flash
   attention with lengths, offsets, causal and non-causal masks, a
   fully-masked row and, through ``ops.attention``, causal Sq < Skv
   without lengths (end-aligned), the 96-token prefill chunks of phase
   5b against a 160-token stripe, and paged attention with scattered
   page ids, a row parked on the trash page, a row with no valid column
   and a row whose length runs past its table, in bf16 at the decode
   shape and in fp32 with four query heads per kv head;
4. the reduced gemma-7b and deepseek-coder-33b configs in fp32: the
   serving engine's greedy tokens through the kernels must equal those
   of the plain ``backend="torch"`` path, at K = 1 and K = 4, with the
   contiguous cache, the paged cache, and the paged cache with chunked
   prefill;
5. full-width gemma-7b (28 layers, random weights from a seed) in bf16
   serving 8 mixed-length requests through ``serve_batch``: prefill and
   decode tokens/s, each kernel's launch count against the count the
   path implies, and the first prefill's logits against the plain path;
5b. full-width gemma-7b paged: 8 requests behind one shared 64-token
   prefix through ``ServeEngine`` with 16-token pages and 96-token
   prefill chunks, run contiguous, paged, paged, contiguous on one copy
   of the weights: shared pages, chunk and launch counts against what
   the traffic implies, tokens/s of both modes, the host time spent
   waiting on chunks, and, for the first four requests, the first
   tokens and prefill logits of the paged engine with chunked prefill
   against the contiguous engine's monolithic prefill, and the first
   decode step's logits on the paged cache (kernel) against the
   contiguous cache (plain einsum);
6. each kernel's time at the main-path shapes with CUDA events, beside
   its plain version, its bound on the card and, where one exists, one
   PyTorch library call that computes the same function (a yardstick
   only: the port never calls it);
7. a ``{"kernels": [...]}`` line, the card line, and the final
   ``{"ok": true, ...}`` line.

Any failed check raises, so the script exits non-zero and prints no
``ok`` line.  It exits non-zero at once without a CUDA device, or when
it is not run from a checkout that holds ``src/repro_torch``.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
import warnings
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit)
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}

BF16_TOL = 2e-2     # relative to the reference's largest magnitude
FP32_TOL = 2e-5


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def ptxas_summary(report: str) -> str:
    """One 'instantiation: registers, spills' item per compiled kernel of
    an ``nvcc -Xptxas -v`` log (template arguments read off the mangled
    name: the element type and the Lb0/Lb1 bool flags)."""
    items, entry, spill = [], "?", ""
    for ln in report.splitlines():
        if "Compiling entry function" in ln:
            mangled = ln.split("'")[1]
            dtype = "bf16" if "bfloat16" in mangled else "fp32"
            bits = [f[0] for f in mangled.split("Lb")[1:]]
            entry = dtype + (f" trans_b={bits[0]} vec={bits[1]}"
                             if len(bits) == 2 else "")
        elif "spill stores" in ln:
            spill = ln.strip().split(",")[1].strip()
        elif "registers" in ln:
            regs = ln.split("Used")[1].split("registers")[0].strip()
            items.append(f"{entry}: {regs} regs, {spill}")
    return "; ".join(items)


def main() -> int:
    if not (ROOT / "src" / "repro_torch" / "kernels" / "csrc").is_dir():
        print("chip_smoke: src/repro_torch is not next to this script; run it "
              "from a checkout of the repository", file=sys.stderr)
        return 2
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script needs one H100",
              file=sys.stderr)
        return 3
    sys.path.insert(0, str(ROOT / "src"))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.paged_attention import paged_attention
    from repro_torch.kernels.zero_stall_matmul import zero_stall_matmul

    # -- 1. card ---------------------------------------------------------
    card = card_line()
    print(f"[1] card: {card}", flush=True)

    # -- 2. build --------------------------------------------------------
    t0 = time.perf_counter()
    _build.build_all()
    print(f"[2] built {', '.join(_build.SOURCES)} for sm_90a in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    for name in _build.SOURCES:
        print(f"    {name} ptxas: {ptxas_summary(_build.ptxas_report(name))}")

    kern = {"zero_stall_matmul": zero_stall_matmul,
            "flash_attention": flash_attention,
            "paged_attention": paged_attention}
    errs = check_kernels(torch, kern)
    check_reduced_engines(torch, kern)
    counts = serve_full_width(torch, kern)
    counts.update(serve_paged_full_width(torch, kern))
    timings = time_kernels(torch, kern)

    kernels = [
        {"name": "zero_stall_matmul", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/zero_stall_matmul.cu",
         "replaces": "src/repro/kernels/zero_stall_matmul.py:200",
         "launches": counts["zero_stall_matmul"],
         "max_abs_err": errs["zero_stall_matmul"], **timings["matmul"]},
        {"name": "flash_attention", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
         "replaces": "src/repro/kernels/flash_attention.py:164",
         "launches": counts["flash_attention"],
         "max_abs_err": errs["flash_attention"], **timings["attention"]},
        {"name": "paged_attention", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/paged_attention.cu",
         "replaces": "src/repro/kernels/paged_attention.py:141",
         "launches": counts["paged_attention"],
         "max_abs_err": errs["paged_attention"], **timings["paged"]},
    ]
    leaked = sorted(m for m in sys.modules
                    if m == "jax" or m.startswith(("jax.", "repro.")))
    require(not leaked, f"JAX or the JAX package got imported: {leaked}")
    print(json.dumps({"kernels": kernels}))
    print(f"card: {card_line()}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


# ----------------------------------------------------------------------
# 3. kernels against their plain versions
# ----------------------------------------------------------------------
GEMMA = {"d": 3072, "H": 16, "hd": 256, "ff": 24576, "V": 256000,
         "layers": 28, "slots": 4}


def gemma_matmul_shapes(M: int) -> list[tuple[str, int, int, int, int]]:
    """(name, M, K, N, calls per layer or per step) of one gemma-7b pass
    over M rows: the seven projections of a layer.  The LM head is
    listed separately (its M differs between prefill and decode)."""
    g = GEMMA
    qkv = g["H"] * g["hd"]
    return [("wq/wk/wv", M, g["d"], qkv, 3), ("attn wo", M, qkv, g["d"], 1),
            ("mlp wi/wg", M, g["d"], g["ff"], 2),
            ("mlp wo", M, g["ff"], g["d"], 1)]


def paged_case(torch, gen, *, B, H, KV, D, ps, T, kv_lens, dtype,
               trash_rows=()):
    """Decode-attention operands on the card: q (B, H, D), (P, ps, KV, D)
    pools with random contents on every page (the trash page too), page
    ids scattered over the pool, ``trash_rows`` parked on the trash page,
    and int32 ``kv_lens``."""
    dev = "cuda"
    P = B * T + 1

    def rnd(*shape):
        return torch.randn(*shape, device=dev, generator=gen).to(dtype)

    table = 1 + torch.randperm(P - 1, device=dev, generator=gen)[:B * T]
    table = table.reshape(B, T).to(torch.int32)
    for b in trash_rows:
        table[b] = 0
    lens = torch.tensor(kv_lens, dtype=torch.int32, device=dev)
    return (rnd(B, H, D), rnd(P, ps, KV, D), rnd(P, ps, KV, D),
            table.contiguous(), lens)


def check_kernels(torch, kern) -> dict:
    from repro_torch.kernels.ref import (flash_attention_ref, matmul_ref,
                                         paged_attention_ref)
    zero_stall_matmul = kern["zero_stall_matmul"]
    flash_attention = kern["flash_attention"]
    paged_attention = kern["paged_attention"]
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)

    def rnd(*shape, dtype=torch.bfloat16):
        return torch.randn(*shape, device=dev, generator=gen).to(dtype)

    errs = {name: 0.0 for name in kern}
    print(f"[3] kernels against their plain versions (matmul bf16: |err| <= "
          f"{BF16_TOL} * max|ref|; fp32: |err| <= {FP32_TOL} * max(1, "
          f"max|ref|); attention, per output row: bf16 |err| <= {BF16_TOL} "
          f"* that row's max|ref|, fp32 |err| <= {FP32_TOL} * max(1, that "
          f"row's max|ref|))", flush=True)

    def judge(kernel, what, got, want, dtype):
        err = (got.float() - want.float()).abs().max().item()
        scale = want.float().abs().max().item()
        tol = (BF16_TOL * scale if dtype == torch.bfloat16
               else FP32_TOL * max(1.0, scale))
        print(f"    {kernel} {what}: max|err| {err:.3g} (tol {tol:.3g})")
        require(err <= tol, f"{kernel} {what} disagrees with its plain "
                f"version: {err} > {tol}")
        errs[kernel] = max(errs[kernel], err)

    def judge_rows(what, got, want, kernel="flash_attention"):
        """Attention per output row: a row that averages many keys is
        small, so a tolerance scaled by the largest row would hide its
        errors.  A bf16 fully-masked row (all zeros) must be exact."""
        err = (got.float() - want.float()).abs().amax(-1)
        scale = want.float().abs().amax(-1)
        tol = (BF16_TOL * scale if got.dtype == torch.bfloat16
               else FP32_TOL * scale.clamp_min(1.0))
        worst = (err / tol.clamp_min(1e-30)).max().item()
        e = err.max().item()
        print(f"    {kernel} {what}: max|err| {e:.3g}, worst row "
              f"|err|/tol {worst:.3g} (smallest row tol "
              f"{tol[tol > 0].min().item() if (tol > 0).any() else 0:.3g})")
        require(bool((err <= tol).all()), f"{kernel} {what} "
                f"disagrees with its plain version in some row (worst "
                f"|err|/tol {worst})")
        errs[kernel] = max(errs[kernel], e)

    # matmul at every gemma-7b projection shape, decode and prefill
    for M in (GEMMA["slots"], 128):
        for name, m, k, n, _ in gemma_matmul_shapes(M):
            a, b = rnd(m, k), rnd(k, n)
            judge("zero_stall_matmul", f"{name} M={m} K={k} N={n} bf16",
                  zero_stall_matmul(a, b), matmul_ref(a, b), torch.bfloat16)
    for M in (1, GEMMA["slots"]):
        a, table = rnd(M, GEMMA["d"]), rnd(GEMMA["V"], GEMMA["d"])
        judge("zero_stall_matmul", f"LM head M={M} N={GEMMA['V']} "
              f"(tied, transposed B, fp32 out)",
              zero_stall_matmul(a, table, trans_b=True,
                                out_dtype=torch.float32),
              matmul_ref(a, table.t(), torch.float32), torch.bfloat16)
    del table
    # fp32 at a ragged shape, every ring depth and both grid orders
    a, b = rnd(37, 45, dtype=torch.float32), rnd(45, 29, dtype=torch.float32)
    for slots in (1, 2, 3):
        for order in ("ijk", "jik"):
            got = zero_stall_matmul(
                a, b, bm=16, bn=16, bk=8, slots=slots, grid_order=order,
                variant="single" if slots == 1 else "dobu")
            judge("zero_stall_matmul", f"fp32 37x45x29 slots={slots} "
                  f"{order}", got, matmul_ref(a, b), torch.float32)

    # flash attention at the prefill shape (1, 16, bucket, 256)
    S, H, D = 128, GEMMA["H"], GEMMA["hd"]
    q, k, v = rnd(1, H, S, D), rnd(1, H, S, D), rnd(1, H, S, D)

    def i32(*xs):
        return torch.tensor(xs, dtype=torch.int32, device=dev)

    cases = [
        ("causal, lengths 96", dict(causal=True, q_lens=i32(96),
                                    kv_lens=i32(96))),
        ("causal, full bucket", dict(causal=True)),
        ("non-causal, lengths 80", dict(causal=False, q_lens=i32(80),
                                        kv_lens=i32(80))),
        ("causal, q_offsets 16", dict(causal=True, q_offsets=i32(16),
                                      q_lens=i32(S + 16), kv_lens=i32(S))),
        ("masked: kv_len 0", dict(causal=False, q_lens=i32(S),
                                  kv_lens=i32(0))),
    ]
    for what, kw in cases:
        full = {"q_offsets": i32(0), **kw}
        full.setdefault("q_lens", full["q_offsets"] + S)
        full.setdefault("kv_lens", i32(S))
        got = flash_attention(q, k, v, **kw)
        judge_rows(what, got, flash_attention_ref(q, k, v, **full))
        if "masked" in what:
            require(bool((got == 0).all()), "a fully-masked row is not "
                    "exact zeros")
    # causal, fewer queries than keys and no lengths: ops.attention runs
    # the kernel end-aligned, the reference's convention without lengths
    from repro_torch.kernels import ops
    launched = flash_attention.launches
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        got = ops.attention(q[:, :, S // 2:].contiguous(), k, v, causal=True)
    require(flash_attention.launches == launched + 1,
            "ops.attention with Sq < Skv did not launch the kernel")
    judge_rows("ops.attention causal Sq=64 < Skv=128, no lengths "
               "(end-aligned)", got,
               flash_attention_ref(q[:, :, S // 2:], k, v, causal=True))
    # the chunked-prefill calls of phase 5b: 96 queries of one chunk
    # against the whole 160-token stripe, q_offsets at the chunk's start,
    # q_lens = kv_lens = the prompt's valid end after the chunk (the
    # second chunk of a 128- or 112-token prompt has 32 or 16 valid rows,
    # the rest all zeros)
    C, stripe = 96, 160
    q, k, v = rnd(1, H, C, D), rnd(1, H, stripe, D), rnd(1, H, stripe, D)
    for off, end in ((0, 96), (96, 128), (96, 112)):
        kw = dict(causal=True, q_offsets=i32(off), q_lens=i32(end),
                  kv_lens=i32(end))
        judge_rows(f"chunk (1, {H}, {C}, {D}) over a {stripe}-token stripe, "
                   f"causal, q_offsets {off}, lengths {end}",
                   flash_attention(q, k, v, **kw),
                   flash_attention_ref(q, k, v, **kw))

    # paged attention at the decode shape: 4 slots, 16 heads of 256,
    # 16-token pages, a 10-page table (max_len 160)
    B, T, ps = GEMMA["slots"], 10, 16
    cases = [
        ("bf16 (4, 16, 256), ps 16, scattered pages, kv 160/129/80/17",
         dict(B=B, H=H, KV=H, D=D, ps=ps, T=T, kv_lens=[160, 129, 80, 17],
              dtype=torch.bfloat16)),
        ("bf16, row 1 on the trash page, row 2 kv 0, row 3 kv 185 > T*ps",
         dict(B=B, H=H, KV=H, D=D, ps=ps, T=T, kv_lens=[96, 50, 0, 185],
              dtype=torch.bfloat16, trash_rows=(1,))),
        ("fp32 rep 4 (4, 16 heads over 4 kv, 128), ps 16, row 2 on the "
         "trash page, row 3 kv 0",
         dict(B=B, H=16, KV=4, D=128, ps=ps, T=T, kv_lens=[160, 33, 70, 0],
              dtype=torch.float32, trash_rows=(2,))),
    ]
    for what, kw in cases:
        ops_in = paged_case(torch, gen, **kw)
        launched = paged_attention.launches
        got = paged_attention(*ops_in[:4], kv_lens=ops_in[4])
        require(paged_attention.launches == launched + 1,
                "paged_attention did not launch its kernel")
        judge_rows(what, got, paged_attention_ref(*ops_in[:4],
                                                  kv_lens=ops_in[4]),
                   kernel="paged_attention")
        for b, n in enumerate(kw["kv_lens"]):
            if n == 0:
                require(bool((got[b] == 0).all()), "a paged row with no "
                        "valid column is not exact zeros")
    torch.cuda.synchronize()
    return errs


# ----------------------------------------------------------------------
# 4. reduced configs: kernel path vs plain path, token for token
# ----------------------------------------------------------------------
REDUCED_MODES = {"contiguous": {}, "paged": {"page_size": 4},
                 "paged+chunked": {"page_size": 4, "prefill_chunk": 4}}


def check_reduced_engines(torch, kern) -> None:
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.models import Ctx, build_model
    from repro_torch.serve import Request, ServeEngine

    print("[4] reduced configs in fp32: engine greedy tokens, kernels vs "
          f"backend='torch', modes {list(REDUCED_MODES)}", flush=True)
    paged_attention = kern["paged_attention"]
    for arch in ("gemma-7b", "deepseek-coder-33b"):
        cfg = get_config(arch, reduced=True)
        model = build_model(cfg)
        params = model.init(seed=0, dtype=torch.float32, device="cuda")
        prompts = [np.random.default_rng(i).integers(0, cfg.vocab_size, n)
                   for i, n in enumerate((5, 11, 3, 8))]
        max_new = [6, 3, 5, 7]
        outs = {}
        for mode, mode_kw in REDUCED_MODES.items():
            for backend in ("auto", "torch"):
                for K in (1, 4):
                    launched = paged_attention.launches
                    eng = ServeEngine(model, params,
                                      Ctx(plan=backend, dtype=torch.float32),
                                      num_slots=2, max_len=32,
                                      steps_per_dispatch=K, device="cuda",
                                      **mode_kw)
                    res = eng.run([Request(rid=i, prompt=p,
                                           max_new_tokens=m)
                                   for i, (p, m) in enumerate(zip(prompts,
                                                                  max_new))])
                    outs[mode, backend, K] = [res[i].tokens
                                              for i in range(4)]
                    on_kernel = paged_attention.launches > launched
                    require(on_kernel == (backend == "auto"
                                          and "page_size" in mode_kw),
                            f"{arch} {mode} {backend}: paged_attention "
                            f"launches do not follow the path")
        ref = outs["contiguous", "torch", 1]
        for key, toks in outs.items():
            require(toks == ref, f"{arch} {key}: tokens {toks} differ from "
                    f"the plain contiguous path's {ref}")
        print(f"    {arch}: {sum(map(len, ref))} tokens equal on both paths "
              f"at K=1 and K=4 in every mode")


# ----------------------------------------------------------------------
# 5. full-width gemma-7b serving
# ----------------------------------------------------------------------
def serve_full_width(torch, kern):
    zero_stall_matmul = kern["zero_stall_matmul"]
    flash_attention = kern["flash_attention"]
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import make_requests, serve_batch
    from repro_torch.models import Ctx, build_model

    kw = dict(batch=8, prompt_len=128, gen_len=32, mixed=True, num_slots=4,
              steps_per_dispatch=4, seed=0)
    print(f"[5] gemma-7b full width, 28 layers, bf16, random weights: "
          f"serve_batch({kw})", flush=True)
    for k in kern.values():
        k.launches = 0
    out = serve_batch("gemma-7b", reduced=False, dtype=torch.bfloat16,
                      device="cuda", **kw)
    torch.cuda.synchronize()
    counts = {"zero_stall_matmul": zero_stall_matmul.launches,
              "flash_attention": flash_attention.launches}
    require(kern["paged_attention"].launches == 0,
            "the contiguous cache launched the paged kernel")
    s = out["stats"]
    L = GEMMA["layers"]
    want_mm = (7 * L + 1) * (s["admitted"] + s["decode_steps"])
    want_fa = L * s["admitted"]
    print(f"    prefill {out['prefill_tok_s']:.1f} tok/s over "
          f"{out['prefill_s']:.3f} s; decode {out['decode_tok_s']:.1f} tok/s "
          f"over {out['decode_s']:.3f} s ({s['decode_steps']} steps, "
          f"{s['dispatches']} dispatches, {s['admitted']} admissions)")
    print(f"    launches: zero_stall_matmul {counts['zero_stall_matmul']} "
          f"(path implies (7*{L}+1)*({s['admitted']}+{s['decode_steps']}) = "
          f"{want_mm}), flash_attention {counts['flash_attention']} (path "
          f"implies {L}*{s['admitted']} = {want_fa})")
    require(counts["zero_stall_matmul"] == want_mm > 0,
            "matmul launch count differs from the path's")
    require(counts["flash_attention"] == want_fa > 0,
            "flash-attention launch count differs from the path's")
    gen = out["generated"]
    require(gen.shape == (8, 32) and (gen >= 0).all()
            and (gen < GEMMA["V"]).all(), "not every request completed")
    del out
    torch.cuda.empty_cache()

    # the first request's prefill logits, kernels vs the plain path
    cfg = get_config("gemma-7b")
    model = build_model(cfg)
    params = model.init(seed=0, dtype=torch.bfloat16, device="cuda")
    req = make_requests(cfg, 0, 8, 128, 32, True)[0]
    batch = {"tokens": torch.tensor([req.prompt], device="cuda"),
             "lengths": torch.tensor([len(req.prompt)], dtype=torch.int32,
                                     device="cuda")}
    logits = {}
    for backend in ("auto", "torch"):
        lg, _ = model.prefill(params, batch,
                              Ctx(plan=backend, dtype=torch.bfloat16), 160)
        logits[backend] = lg.float()
    err = (logits["auto"] - logits["torch"]).abs().max().item()
    scale = logits["torch"].abs().max().item()
    tol = 0.05 * scale
    require(bool(torch.isfinite(logits["auto"]).all()),
            "non-finite prefill logits")
    print(f"    first prefill logits (1, 1, {GEMMA['V']}): max|kernels - "
          f"plain| {err:.4g}, max|plain| {scale:.4g} (tol 0.05 * max|plain| "
          f"= {tol:.4g}: bf16 rounding through 28 layers)")
    require(err <= tol, "full-width prefill logits disagree")
    del params, logits
    torch.cuda.empty_cache()
    return counts


# ----------------------------------------------------------------------
# 5b. full-width gemma-7b, paged, chunked prefill, shared prefix pages
# ----------------------------------------------------------------------
def serve_paged_full_width(torch, kern) -> dict:
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.launch.serve import make_requests
    from repro_torch.models import Ctx, build_model
    from repro_torch.serve import Request, ServeEngine

    L, V = GEMMA["layers"], GEMMA["V"]
    cfg = get_config("gemma-7b")
    model = build_model(cfg)
    params = model.init(seed=0, dtype=torch.bfloat16, device="cuda")
    ctx = Ctx(plan="auto", dtype=torch.bfloat16)
    # one shared 64-token prefix (a system prompt) before the mixed tails
    # of 64, 32, 16 and 48 tokens: prompts of 128, 96, 80 and 112
    prefix = np.random.default_rng(1).integers(0, V, 64).tolist()
    reqs = [Request(rid=r.rid, prompt=prefix + list(r.prompt),
                    max_new_tokens=r.max_new_tokens)
            for r in make_requests(cfg, 0, 8, 64, 32, True)]
    ps, chunk, max_len = 16, 96, 160
    base = dict(num_slots=GEMMA["slots"], max_len=max_len,
                cache_dtype=torch.bfloat16, steps_per_dispatch=4, seed=0,
                device="cuda")
    paged = dict(page_size=ps, prefill_chunk=chunk)
    n_chunked = sum(len(r.prompt) > chunk for r in reqs)
    want_chunks = sum(-(-len(r.prompt) // chunk) for r in reqs
                      if len(r.prompt) > chunk)
    print(f"[5b] gemma-7b full width, 28 layers, bf16, paged: 8 requests of "
          f"{sorted({len(r.prompt) for r in reqs})} prompt tokens behind one "
          f"shared 64-token prefix, 32 new tokens each, {base['num_slots']} "
          f"slots, K=4, page_size {ps}, prefill_chunk {chunk}, default pool "
          f"of {base['num_slots'] * max_len // ps + 1} pages; runs "
          f"contiguous, paged, paged, contiguous", flush=True)

    # the engine waits for each prefill chunk (a departure from the JAX
    # engine, which leaves it in flight): time those waits, an upper
    # bound on the host work they keep from overlapping the chunk
    from repro_torch.serve import engine as engine_mod
    waited = []
    wait = engine_mod._wait

    def timed_wait(device):
        t0 = time.perf_counter()
        wait(device)
        waited.append(time.perf_counter() - t0)

    engine_mod._wait = timed_wait
    counts = {}
    for mode in ("contiguous", "paged", "paged", "contiguous"):
        for k in kern.values():
            k.launches = 0
        waited.clear()
        eng = ServeEngine(model, params, ctx, **base,
                          **(paged if mode == "paged" else {}))
        t_run = time.perf_counter()
        res = eng.run(reqs)
        torch.cuda.synchronize()
        t_run = time.perf_counter() - t_run
        got = {name: k.launches for name, k in kern.items()}
        s = eng.stats
        require(sorted(res) == list(range(8)) and all(
            len(r.tokens) == 32 and all(0 <= t < V for t in r.tokens)
            for r in res.values()), f"{mode}: not every request completed")
        chunks = s.prefill_chunks
        mono = s.admitted - (n_chunked if mode == "paged" else 0)
        want = {"zero_stall_matmul": (7 * L + 1) * (mono + chunks
                                                    + s.decode_steps),
                "flash_attention": L * (mono + chunks),
                "paged_attention": L * s.decode_steps if mode == "paged"
                else 0}
        print(f"    {mode}: prefill {s.prefill_tok_s:.1f} tok/s over "
              f"{s.prefill_s:.3f} s; decode {s.decode_tok_s:.1f} tok/s over "
              f"{s.decode_s:.3f} s ({s.decode_steps} steps, {s.dispatches} "
              f"dispatches, {mono} monolithic prefills, {chunks} chunks); "
              f"pages in use (peak) {s.pages_in_use}, shared {s.pages_shared}"
              f"; run {t_run:.3f} s, of which the host waited on chunks "
              f"{1e3 * sum(waited):.1f} ms ({len(waited)} waits)")
        print(f"      launches {got} (path implies {want})")
        require(got == want and got["zero_stall_matmul"] > 0,
                f"{mode}: launch counts differ from the path's")
        if mode == "paged":
            require(s.pages_shared >= 4, "fewer than 4 shared prefix pages")
            require(chunks == want_chunks, f"{chunks} prefill chunks, the "
                    f"traffic implies {want_chunks}")
            require(eng.pages_in_use_now == len(eng._prefix.pages),
                    "pages still held after every request retired")
            counts.setdefault("paged_attention", got["paged_attention"])
        del eng, res
        torch.cuda.empty_cache()
    engine_mod._wait = wait

    # the first four requests (prompts of 128, 96, 80 and 112 tokens):
    # the paged engine admits the 128- and 112-token ones through its
    # chunk path (two 96-token chunks each), the contiguous engine
    # prefills all four whole.  Their first tokens and prefill logits
    # must agree; then one decode step of both caches from the same
    # tokens: paged through the kernel, contiguous through the plain
    # einsum
    n = GEMMA["slots"]
    logits, first, pre = {}, {}, {}
    for mode in ("contiguous", "paged"):
        eng = ServeEngine(model, params, ctx, **base,
                          **(paged if mode == "paged" else {}))
        pre[mode] = {}
        record_first_logits(eng, pre[mode])
        launched = kern["flash_attention"].launches
        first[mode] = []
        for slot, r in enumerate(reqs[:n]):
            if eng._chunkable(r):
                eng._start_chunking(r, slot, 0.0, time.perf_counter())
                events = []
                while not events:
                    events = eng._advance_chunk(slot)
                first[mode].append(events[0][1])
            else:
                first[mode].append(eng._admit(r, slot))
        lens = [len(r.prompt) for r in reqs[:n] if eng._chunkable(r)]
        chunks = eng.stats.prefill_chunks
        require(chunks == sum(-(-m // chunk) for m in lens)
                == (4 if mode == "paged" else 0)
                and kern["flash_attention"].launches - launched
                == L * (n - len(lens) + chunks),
                f"{mode}: the admissions did not take the path's chunks")
        tok = torch.tensor(first["contiguous"], device="cuda")[:, None]
        launched = kern["paged_attention"].launches
        lg, _ = model.decode(params, eng.cache, tok, ctx)
        require((kern["paged_attention"].launches > launched)
                == (mode == "paged"), "decode did not take the paged kernel")
        logits[mode] = lg.float()
        if mode == "paged":
            require(eng.stats.pages_shared >= 4, "the 4 admissions share "
                    "fewer than 4 prefix pages")
        del eng
    first_pre = torch.cat([pre["paged"][i] for i in range(n)])
    want_pre = torch.cat([pre["contiguous"][i] for i in range(n)])
    err = (first_pre - want_pre).abs().max().item()
    scale = want_pre.abs().max().item()
    print(f"    first tokens: paged, chunked {first['paged']}, contiguous "
          f"{first['contiguous']}; prefill logits ({n}, {V}): max|paged "
          f"chunked - contiguous whole| {err:.4g}, max|contiguous| "
          f"{scale:.4g} (tol 0.05 * max = {0.05 * scale:.4g})")
    require(first["paged"] == first["contiguous"], "chunked prefill's first "
            "tokens differ from monolithic prefill's")
    require(err <= 0.05 * scale, "chunked prefill logits disagree with "
            "monolithic prefill's")
    require(bool(torch.isfinite(logits["paged"]).all()),
            "non-finite paged decode logits")
    err = (logits["paged"] - logits["contiguous"]).abs().max().item()
    scale = logits["contiguous"].abs().max().item()
    tol = 0.05 * scale
    print(f"    first decode step's logits ({n}, 1, {V}): max|paged kernel - "
          f"contiguous plain| {err:.4g}, max|contiguous| {scale:.4g} (tol "
          f"0.05 * max = {tol:.4g}: bf16 rounding through 28 layers)")
    require(err <= tol, "paged decode logits disagree with contiguous")
    del params, logits
    torch.cuda.empty_cache()
    return counts


def record_first_logits(eng, out: dict) -> None:
    """Have ``eng`` keep each admission's last-position prefill logits
    in ``out[slot]`` when it samples the first token."""
    first_token = eng._first_token

    def recording(req, slot, logits):
        out[slot] = logits[:, -1].float()
        return first_token(req, slot, logits)

    eng._first_token = recording


# ----------------------------------------------------------------------
# 6. timing
# ----------------------------------------------------------------------
def time_ms(torch, fns, iters: int = 20) -> float:
    """Mean time of one call, cycling over ``fns`` (distinct operands, so
    that the 50 MB L2 cache does not hold them between calls)."""
    for f in fns:
        f()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(iters):
        fns[i % len(fns)]()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def time_kernels(torch, kern) -> dict:
    from repro_torch.kernels.ref import (flash_attention_ref, matmul_ref,
                                         paged_attention_ref)
    zero_stall_matmul = kern["zero_stall_matmul"]
    flash_attention = kern["flash_attention"]
    paged_attention = kern["paged_attention"]
    dev = "cuda"
    F = torch.nn.functional
    print("[6] kernel times at main-path shapes (CUDA events; operands "
          "cycled past L2)", flush=True)

    def mm_cell(name, M, K, N, trans_b=False, out=torch.bfloat16):
        copies = max(1, -(-128 * 2 ** 20 // (K * N * 2)))
        a = torch.randn(M, K, device=dev).to(torch.bfloat16)
        bs = [torch.randn((N, K) if trans_b else (K, N),
                          device=dev).to(torch.bfloat16)
              for _ in range(copies)]
        ms = time_ms(torch, [lambda b=b: zero_stall_matmul(
            a, b, trans_b=trans_b, out_dtype=out) for b in bs])
        plain = time_ms(torch, [lambda b=b: matmul_ref(
            a, b.t() if trans_b else b, out) for b in bs], iters=5)
        lib = time_ms(torch, [lambda b=b: torch.matmul(
            a, b.t() if trans_b else b) for b in bs])
        nbytes = (M * K + K * N) * 2 + M * N * (4 if out == torch.float32
                                                 else 2)
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = 2 * M * N * K / PEAK_FLOPS["bfloat16"] * 1e3
        print(f"    zero_stall_matmul {name} M={M} K={K} N={N}: {ms:.4f} ms "
              f"(plain {plain:.4f}, torch.matmul {lib:.4f}, bound "
              f"{max(t_bytes, t_ops):.4f} by "
              f"{'bytes' if t_bytes >= t_ops else 'operations'})")
        del bs
        return ms, plain, lib, t_bytes, t_ops

    def step_total(M, lm_M):
        """Times of one full pass of the path over M rows: 28 layers of
        seven projections plus the LM head over lm_M rows."""
        tot = [0.0] * 5
        for name, m, k, n, calls in gemma_matmul_shapes(M):
            cell = mm_cell(name, m, k, n)
            for i in range(5):
                tot[i] += cell[i] * calls * GEMMA["layers"]
        cell = mm_cell("LM head", lm_M, GEMMA["d"], GEMMA["V"],
                       trans_b=True, out=torch.float32)
        for i in range(5):
            tot[i] += cell[i]
        return tot

    dec = step_total(GEMMA["slots"], GEMMA["slots"])
    pre = step_total(128, 1)
    for label, tot in (("decode step (M=4)", dec),
                       ("prefill of 128 tokens", pre)):
        print(f"    zero_stall_matmul, one {label}, 197 launches: "
              f"{tot[0]:.3f} ms (plain {tot[1]:.3f}, torch.matmul "
              f"{tot[2]:.3f}, bound {max(tot[3], tot[4]):.3f} by "
              f"{'bytes' if tot[3] >= tot[4] else 'operations'})")
    matmul = {"ms": dec[0], "plain_ms": dec[1],
              "bound_ms": max(dec[3], dec[4]),
              "bound_by": "bytes" if dec[3] >= dec[4] else "operations",
              "library_ms": dec[2]}

    S, H, D = 128, GEMMA["H"], GEMMA["hd"]
    qs = [tuple(torch.randn(1, H, S, D, device=dev).to(torch.bfloat16)
                for _ in range(3)) for _ in range(4)]
    lens = torch.tensor([S], dtype=torch.int32, device=dev)
    zero = torch.zeros(1, dtype=torch.int32, device=dev)
    ms = time_ms(torch, [lambda t=t: flash_attention(
        *t, q_lens=lens, kv_lens=lens, causal=True) for t in qs])
    plain = time_ms(torch, [lambda t=t: flash_attention_ref(
        *t, q_lens=lens, kv_lens=lens, q_offsets=zero, causal=True)
        for t in qs])
    lib = time_ms(torch, [lambda t=t: F.scaled_dot_product_attention(
        *t, is_causal=True) for t in qs])
    t_bytes = 4 * H * S * D * 2 / HBM_BYTES_PER_S * 1e3
    pairs = S * (S + 1) // 2            # causal (row, col) pairs this data has
    t_ops = 4 * H * pairs * D / PEAK_FLOPS["bfloat16"] * 1e3
    print(f"    flash_attention (1, {H}, {S}, {D}) bf16 causal: {ms:.4f} ms "
          f"(plain {plain:.4f}, scaled_dot_product_attention {lib:.4f}, "
          f"bound {max(t_bytes, t_ops):.5f} by "
          f"{'bytes' if t_bytes >= t_ops else 'operations'})")
    attention = {"ms": ms, "plain_ms": plain,
                 "bound_ms": max(t_bytes, t_ops),
                 "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                 "library_ms": lib}

    # paged attention at the decode shape of phase 5b: 4 slots, 16 heads
    # of 256, a 41-page pool of 16-token pages, 10-page tables, kv lengths
    # of the four prompts 16 tokens into decode; 8 pool copies (86 MB)
    # cycle past L2
    B, T, ps = GEMMA["slots"], 10, 16
    kv = [144, 112, 96, 128]
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    cases = [paged_case(torch, gen, B=B, H=H, KV=H, D=D, ps=ps, T=T,
                        kv_lens=kv, dtype=torch.bfloat16) for _ in range(8)]
    ms = time_ms(torch, [lambda c=c: paged_attention(*c[:4], kv_lens=c[4])
                         for c in cases])
    plain = time_ms(torch, [lambda c=c: paged_attention_ref(
        *c[:4], kv_lens=c[4]) for c in cases])
    keys = sum(min(n, T * ps) for n in kv)
    nbytes = (keys * H * D * 2 * 2          # the K and V rows it must read
              + 2 * B * H * D * 2           # q in, o out
              + B * T * 4 + B * 4)          # page table, kv_lens
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = 4 * H * D * keys / PEAK_FLOPS["bfloat16"] * 1e3
    print(f"    paged_attention ({B}, {H}, {D}) bf16 over {keys} keys "
          f"(kv {kv}, 16-token pages): {ms:.4f} ms (plain {plain:.4f}, no "
          f"single PyTorch call reads a page table; bound "
          f"{max(t_bytes, t_ops):.5f} by "
          f"{'bytes' if t_bytes >= t_ops else 'operations'}); per decode "
          f"step ({GEMMA['layers']} calls) {GEMMA['layers'] * ms:.3f} ms")
    paged = {"ms": ms, "plain_ms": plain, "bound_ms": max(t_bytes, t_ops),
             "bound_by": "bytes" if t_bytes >= t_ops else "operations",
             "library_ms": None}
    return {"matmul": matmul, "attention": attention, "paged": paged}


if __name__ == "__main__":
    sys.exit(main())
