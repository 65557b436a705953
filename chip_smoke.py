#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one H100.

    python3 chip_smoke.py

Phases, each printed as it runs:

1. the card's name and power limit (``nvidia-smi``);
2. the build of every CUDA kernel from ``src/repro_torch/kernels/csrc``
   (one nvcc per source, all at once) and its time;
3. each kernel against its plain PyTorch version on the card at the
   shapes of the main paths (full-width gemma-7b and olmoe-1b-7b in
   bf16 and W8A8: the int8 kernels must be bit-equal; every bf16
   matmul on the TMA + wgmma design, every bf16 flash call on the
   tensor-core design, every int8 matmul and bf16 grouped matmul on
   its TMA + wgmma design), plus the bf16 matmul at an aligned non-square
   shape in both B layouts for every ring depth and grid order, with
   and without split-k, two calls of a split-k product bitwise equal,
   fp32 matmul at a ragged shape for every ring depth and grid order,
   flash attention at head dims 256 and 128 with lengths, offsets,
   causal and non-causal masks, a fully-masked row and, through
   ``ops.attention``, causal Sq < Skv without lengths (end-aligned),
   the 96-token prefill chunks of phase 5b against a 160-token stripe,
   and paged attention on its split-KV design with scattered
   page ids, a row parked on the trash page, a row with no valid column
   and a row whose length runs past its table, in bf16 at the decode
   shape and in fp32 with four query heads per kv head, at a one-page
   table (one split) and a 7-page one (splits that do not divide it),
   two calls bitwise equal; the int8
   matmul at the aligned non-square (4, 80, 200) for every ring depth,
   grid order and k tile of 128 and 256 codes, its int32 split-k twice
   bitwise equal; the bf16 grouped matmul at ragged shapes for every
   ring depth; the int8 grouped matmul on its TMA + wgmma design at the
   expert banks and at ragged shapes for every ring depth, both k tiles
   and both output types; the int8 and grouped kernels at a ragged shape
   in fp32 for every ring depth, and the int8 grouped kernel on codes 8
   bytes off a 16-byte line (the cp.async ring); and for the SSM and
   hybrid paths: the bf16 matmul at every zamba2-2.7b and mamba2-130m
   projection shape and tied head, decode and prefill, each on the TMA +
   wgmma design (the design of each printed), flash attention at head
   dim 80 (zamba2's (1, 32, S, 80) prefill, S 64 and 128) with lengths,
   causal and non-causal masks and a fully-masked row, and paged
   attention at (4, 32, 80) with one query head a kv head, scattered
   pages, the trash page, a row with no valid column and one past its
   table, two calls bitwise equal; and for the encdec, vlm and last
   dense paths: the bf16 matmul at every seamless-m4t-large-v2,
   llava-next-34b, qwen1.5-32b and mistral-large-123b projection shape
   (decode, a 128-token prefill, llava's 3008-row prefill) and K-major
   head (seamless's N = 256206), each on the TMA + wgmma design; flash
   attention at seamless's cross-attention decode (4, 16, 1, 128, 64),
   non-causal, eagerly and captured in a CUDA graph, at its prefill
   buckets (Sq != Skv) and encoder, and at llava's (1, 56, 3008, 128)
   causal prefill with lengths; paged attention at rep 1 (D 64), rep 7
   over 3040 keys a slot and rep 12 over 480;
4. the reduced gemma-7b and deepseek-coder-33b configs in fp32, plain
   and W8A8, the reduced olmoe-1b-7b and granite-moe-1b-a400m configs
   with bf16 weights and W8A8, and the reduced mamba2-130m and
   zamba2-2.7b configs in fp32, plain and W8A8 (mamba2, asked for
   pages, must report zero page gauges), and the reduced qwen1.5-32b,
   mistral-large-123b, seamless-m4t-large-v2 (source frames, enc_len)
   and llava-next-34b (patch positions) configs in fp32: the serving
   engine's greedy
   tokens through the kernels must equal those of the plain
   ``backend="torch"`` path, at K = 1 and K = 4, with the contiguous
   cache, the paged cache, and (dense only) the paged cache with
   chunked prefill; and, sampled (temperature 0.9, top-k 20, top-p
   0.95, seeded and engine-derived keys), the tokens of the engine's
   CUDA graphs (decode block and prefill) must equal those of its
   eager block and eager prefill, bit for bit, at K = 1 and K = 4
   (dense: K = 1's equal K = 4's);
5. full-width gemma-7b (28 layers, random weights from a seed) in bf16
   serving 8 mixed-length requests through ``serve_batch``: prefill and
   decode tokens/s, each kernel's launch count against the count the
   path implies (and, in 5-5e, every bf16 and int8 matmul, plain and
   grouped, and every flash call on its Hopper design), and the first
   prefill's logits against the plain path; then, on the logits
   check's weights, the same traffic through ``ServeEngine``, its
   decode step under the block's CUDA graph against the eager loop of
   the same block, and the device-busy share of one graphed and one
   eager dispatch (``torch.profiler``);
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
5c. full-width olmoe-1b-7b (16 layers, 64 experts, random weights from
   a seed) in bf16 with phase 5's traffic through ``serve_batch``;
5d. the same weights quantized W8A8 through ``ServeEngine`` with
   ``KernelConfig(quant="int8")``, and how far its logits sit from 5c's;
5e. full-width gemma-7b in W8A8 with phase 5's traffic (each of 5c-5e:
   tokens/s, launch counts against the path's, the first prefill's
   logits against the plain path; 5d and 5e: the decode step under the
   graph against the eager loop);
5f. full-width gemma-7b bf16 on phase 5's weights with phase 5's
   requests sampled (temperature 0.8, top-k 50, top-p 0.95, a seed
   each) at K = 4: tokens equal to the eager block's and to K = 1's,
   launch counts against the path's, decode tokens/s;
5g. full-width zamba2-2.7b (54 mamba2 layers, a shared attention block
   invoked 9 times, head dim 80; random weights from a seed) in bf16
   with phase 5's traffic through ``serve_batch``, then ``ServeEngine``
   contiguous and paged (16-token pages) on the same weights, then W8A8
   (``KernelConfig(quant="int8")``): tokens/s, launch counts against the
   path's (kernel 1: 181 a pass, 109 under W8A8 beside kernel 4's 72;
   kernel 2: 9 a prefill; kernel 3: 9 a paged decode step), the first
   prefill's logits within 5% of the largest plain logit (bf16 and
   W8A8) beside the bf16 rounding floor (the plain bf16 path against
   the plain fp32 path on the same weights), the first decode step's
   logits on the paged cache against the contiguous cache, the decode
   step under the graph against the eager loop, the captures and their
   pool bytes, and the device-busy share;
5h. full-width mamba2-130m in bf16 with phase 5's traffic through
   ``serve_batch``, contiguous and asked for pages (zero page gauges,
   the same tokens): 49 kernel-1 launches a pass and no attention
   launch, the first prefill's logits against the plain path within
   the bf16 rounding floor (a random 24-layer mamba2 moves more than 5%
   under bf16 rounding alone), the graph step against the eager loop
   and the device-busy share;
5i. seamless-m4t-large-v2 at full size (24 + 24 layers, d 1024, untied
   vocab 256206) in bf16, 128 source frames a request, through
   ``serve_batch`` and ``ServeEngine`` paged with enc_len 128: launch
   counts (kernel 1: 385 a prefill, 193 a decode step; kernel 2: 72 a
   prefill, 24 a decode step, inside the graph; kernel 3: 24 a paged
   step), the first prefill's logits within 5% of the largest plain one
   or within the bf16 rounding floor, the first paged decode step's
   logits (kernels 2 and 3) against the plain path, the graph step
   against the eager loop and the device-busy share;
5j. llava-next-34b at full width, 8 of 60 layers, 2880 patch positions a
   request, ``ServeEngine`` contiguous and paged (no page shared), then
   the same prompts text only behind a shared 64-token prefix (pages
   shared);
5k. qwen1.5-32b at full width, 8 of 64 layers, through ``serve_batch``,
   and a biased projection on the card against its plain version;
5l. mistral-large-123b at full width, 4 of 88 layers, ``ServeEngine``
   paged (kernel 3 at 12 query heads a kv head); each of 5j-5l: launch
   counts (7 L + 1 matmuls a pass, L flash calls a prefill, L paged
   calls a paged step), the first prefill's logits as in 5i, the graph
   step against the eager loop;
5m. execution plans and the tuner (the tuner's cache a fresh file under
   the git-ignored ``build/``, as for every phase): (a) the measured
   oracle (CUDA events over a CUDA graph) over a bounded Hopper space at
   phase 6's main-path shapes (gemma-7b's decode and 128-token prefill
   products and head, bf16 and W8A8; olmoe-1b-7b's expert banks, decode
   and prefill, bf16 and W8A8; flash at (1, 16, 128, 256)), per shape
   the fixed default's time, the analytic choice with its predicted and
   measured time and the measured choice, within 90 s; (b) gemma-7b bf16
   at full width on phase 5's weights and traffic through
   ``ServeEngine(plan="trace")``: the plan saved, reloaded and its
   fingerprint checked, no tuner call after the constructor, launch
   counts as phase 5's, the first prefill's logits within 5% under the
   reloaded plan, and the graphed decode step under the fixed default,
   the analytic plan (at most 1.05x the default's) and a plan of (a)'s
   measured winners (``Plan.from_tune_cache``); (c)
   ``kernel_watch.utilization_table(measure=True)`` over one decode
   dispatch, predicted and measured utilization a row; (e) phase 5e's
   logits margin (gemma-7b W8A8) under the analytic plan, and with flash
   attention, then the bf16 head, swapped for its plain version;
5n. the int8 KV cache and the static analyzer, on phase 5's gemma-7b
   bf16 weights: (a) 4 rows, 128 prompt tokens fed through
   ``Model.decode`` one at a time, then 32 greedy tokens, on an int8
   cache (``init_cache(quantize_kv=True)``) beside a bf16 cache: every
   step's logits within 5% of the largest bf16-cache logit (the JAX
   package's own gate), argmax agreement, ms a step and both caches'
   bytes; (b) ``ServeEngine(plan="trace", validate=True)`` contiguous and
   paged (16-token pages) and the launcher's ``validate_plan`` on phase
   5's traffic: no error diagnostic, phase 5's first tokens; a plan
   accumulating int8 in int8 refused naming ZS-L004; (c) ``lint_program``
   over one eager K = 4 dispatch of the engine on CUDA tensors: no
   ZS-P001, no ZS-P002, the allowlist hits; (d) ``lint_kernel_ir`` over
   the launch geometry the six wrappers record at real launches (phase
   6's shapes, and a prefill and a decode pass under 5m's measured plan):
   no ZS-K error;
5o. training on the card, in fp32 with TF32 off, on the plain path
   (``Ctx(plan="torch")``, as JAX trains on its ``jnp`` path): (a) one
   ``make_train_step`` of reduced gemma-7b and mamba2-130m from the same
   state on the card and on the CPU: loss and grad norm within 1e-5
   relative, updated parameters within 2 lr (the bound the CPU tests
   against JAX derive); (b) mamba2-130m at its published size (24
   layers, d 768, vocab 50280) through ``train_loop``: 30 steps of 8 x
   1024 tokens at lr 3e-3 with a checkpoint every 10 steps and two
   injected ``TransientError``s: the last five steps' mean loss more than
   0.05 under the first five's, ``retries_total == 2``; its last two
   checkpoints removed, a second ``train_loop`` resumes from step 10 and
   gives the unbroken run's losses for steps 11-29 within 1e-4
   relative; ``microbatches=2`` gives its first loss within 1e-5
   relative; ``grad_compression="int8"`` runs (``train_loop`` steps
   through ``compile_train_step``: a CUDA graph after its first step);
   (c) gemma-7b at full width, 4 of 28 layers, remat "full", 4 x 512
   tokens; (d) no launch of any of the six kernel wrappers over (a)-(c)
   and (e); (e) on (b)'s and (c)'s configurations, 3 steps from the
   state drawn from seed 0, twice through the eager ``make_train_step``
   and once through ``compile_train_step`` (its first step eager, then
   the capture, then replays): the graphed state bit-equal to the first
   eager run's, or no further from it than the second eager run is (both
   distances printed), one capture; then each path's median step time,
   tokens/s, the model FLOP/s as a share of the fp32 peak, one step's
   device-busy share under ``torch.profiler``, the capture's seconds and
   pool, and the peak memory (in (c) beside its reckoning);
5p. cluster serving on phase 5's gemma-7b bf16 weights and traffic (run
   inside phase 5, after 5f): (a) a ``Router`` over two contiguous
   replicas: every token phase 5's, the ``on_token`` stream with no
   duplicate and no gap, work on both replicas, one greedy CUDA graph a
   replica, launch counts against the fleet's merged stats
   (``EngineStats.merge``); (b) two paged replicas (16-token pages) with
   ``router.kill(1)`` after router step 2: the tokens of one paged engine
   on the same weights, one death, a re-queue for each request in flight
   on replica 1 at the kill, each finishing on replica 0, the seconds
   from the kill to each replayed result, and the memory allocated
   before, with the fleet and after it is dropped; (c) ``ShardedEngine``
   on ``make_mesh_compat((1, 1), ("data", "model"))``: phase 5's tokens
   and its specs, ``page_size`` refused; (d) ``serve_batch(replicas=2,
   kill_replica=1, kill_at_step=2, mesh="1x1")`` on weights drawn anew
   from the seed (phase 5's tokens), then ``python -m
   repro_torch.launch.serve ... --replicas 2 --kill-replica 1 --metrics``
   in a subprocess: its cluster line and a utilization table naming the
   matmul and flash-attention kernels; each: the fleet's prefill and
   decode tokens/s and each replica's captures with their pool bytes;
5q. the dry run and the roofline on the card's numbers: (a) ``python
   -m repro_torch.launch.dryrun`` for mamba2-130m ``decode_32k`` on the
   multi-pod mesh (JAX's own smoke cell, 512 fake ranks) and gemma-7b
   ``train_4k`` on the single pod, two subprocesses at once with
   timeouts, each ``[OK]``, each row's terms, bottleneck, per-device
   bytes and collective counts printed; (b) ``roofline.HW`` against the
   card: ``hbm_bytes`` equal to ``total_memory``, ``HopperParams.sms`` to
   ``multi_processor_count``; (c) inside phase 5 on its weights: the
   trace costs (``core.trace_costs`` on the meta device, unsharded, one
   chip) of phase 5's decode step (4 slots, a 160-position cache) and of
   one 128-token prefill pass, their compute and memory terms on the
   H100's numbers and the bound (the larger) beside the measured device
   time of the same work (phase 5's graphed step; a prefill pass with
   CUDA events), each share printed: the compute term's share at most
   1.05 (the products the kernels run are the ones counted), the memory
   term's printed only (the plain path's op-by-op bytes count what flash
   and the fused kernels never move);
5r. execution across ranks (after 5o, the parent holding no model on
   the card, the kernels built by it before any rank starts): four
   ranks share the one card over gloo, the all-gathers and
   point-to-point transfers of CUDA tensors staged through pinned host
   memory (``runtime.ranks.HostStagedGloo``), in worlds of
   ``runtime.ranks.spawn_ranks`` with timeouts: (a) gemma-7b
   at full width and 8 of its 28 layers (the cut makes room for (g) and
   (h)), bf16, ``ShardedEngine`` on (1, 4) ('data', 'model') with phase
   5's traffic on weights drawn from seed 0 in turn
   (``serve.cluster.place_in_turn``): on every rank kernel 1's launches
   (7 * 8 + 1) x (admissions + decode steps), kernel 2's 8 x
   admissions, none of kernels 3-6, param leaves sharded, no decode
   graph and rank 0's tokens; rank 0's first-prefill logits of request 0
   within 5% of the largest of one rank's on the same weights and
   traffic (made on the card first); printed: tokens equal to one
   rank's, prefill and decode tokens/s (four ranks time-sharing one card:
   no four-card price), the staged collectives by kind a pass, each
   rank's peak memory; (b) reduced gemma-7b in fp32 on (1, 4) and (2, 2),
   the requests of JAX's ``test_sharded_engine_8_device_parity``: the
   one-rank engine's tokens; (c) the train step of reduced olmoe-1b-7b
   and gemma-7b, fp32, TF32 off, on (2, 2), five steps: each loss within
   1e-5 of one rank's, falling, no kernel launch; (d) ``pp_loss_fn`` of
   reduced gemma-7b on (2, 2) ('pod', 'data'), B 4, S 16, two
   microbatches: the loss and every gradient within 1e-5 of
   ``model.loss``'s on one rank; (e) the reduced gemma-7b params placed
   on (2, 2) saved at step 10 and restored by ``elastic_restore`` onto
   (1, 2) in a two-rank world: step 10, every leaf bit-equal, each shard
   the new mesh's shape; (f) ``python -m torch.distributed.run
   --nproc-per-node 4 -m repro_torch.launch.serve --arch gemma-7b
   --reduced --mesh 1x4 ...`` in a subprocess with a timeout: the
   one-rank launcher's tokens (its digest line); (g) W8A8 at full width:
   gemma-7b W8A8 at 8 of 28 layers (5e's draw), olmoe-1b-7b bf16 and
   W8A8 (5c's and 5d's weights), each drawn in turn onto (1, 4) and
   served by ``ShardedEngine`` with the first 2 requests of phase 5's
   traffic, 16 new tokens each, in a four-rank world after one-rank
   references of
   the same weights and traffic made on the card first: on every rank
   each kernel's launches equal to one rank's (kernels 4, 5 and 6 among
   them, none zero where one rank launches it), no decode graph, rank
   0's first-prefill logits of request 0 within 5% of the largest of the
   one-rank run's; printed: tokens equal to one rank's, prefill and
   decode tokens/s, each rank's peak memory, what DTensor could not plan
   (replicated, counted); (h) the same at full width for
   seamless-m4t-large-v2 at full size in bf16 (128 source frames a
   request), zamba2-2.7b in bf16 at 6 of 54 mamba layers (one
   shared-block invocation), mamba2-130m in fp32 at 8 of 24 layers
   (bf16 rounding alone moves its logits by about 10% of the largest,
   5h) and llava-next-34b in bf16 at 8 of 60 layers (2880 patch
   positions a request), with kernels 1 and 2's launch counts; every
   configuration is printed before a failed gate ends the phase;
   (5s (d)) no engine across ranks captures a graph, prefill included;
5s. prefill as compiled programs (one CUDA graph a prompt bucket and
   frontend shape, one a chunk shape, every one writing the engine's one
   batch-1 cache): (a) inside phase 5, on
   its weights and traffic, one ``ServeEngine`` prefilling through its
   graphs and one with the private hook stubbed (eager prefill): each
   request's first-prefill logits and its batch-1 cache rows up to
   ``pos`` bit-equal, the 256 greedy tokens equal, launch counts the
   path's, one prefill graph a bucket; a prefill pass a bucket (32, 64,
   128) under the graph and eagerly, in turns graph, eager, eager,
   graph, and the device-busy share of a graphed and an eager 128-token
   pass; then the graphs' memory at gemma-7b's 8192-token context: one
   admission at each of the 11 buckets (8 to 8192) of a one-slot
   engine, each capture's pool, the memory allocated and reserved, the
   allocated growth after the first capture under one batch-1 cache
   (3.76 GB; a graph a bucket holding its own would need 11), and all
   of it back when the engine is dropped; (b) inside 5b, on its weights and traffic, chunked prefill
   (96-token chunks, two chunked admissions in flight at once)
   contiguous and paged, graphed against eager chunks: logits and
   tokens bit-equal, the same chunk count, one chunk graph, the stripe
   handed between the admissions in flight; (c)
   inside 5c, 5d, 5g, 5h, 5i and 5j, on their weights, one request
   each (olmoe-1b-7b bf16 and W8A8, zamba2-2.7b, mamba2-130m,
   seamless-m4t-large-v2 with its frames, llava-next-34b with 2880
   patch positions): the first-prefill logits of the graph's replay
   bit-equal to the eager body's;
5t. the lock-step oracle's decode as a CUDA graph (inside phase 5, on its
   weights): ``lockstep_generate`` over the first 4 requests of phase 5's
   traffic, 32 new tokens (its first decode step eager, then one step
   captured and replayed) against the eager loop of ``Model.decode``
   calls: tokens equal, launch counts the path's (kernel 1 at every
   projection of the batched prefill and of 31 decode steps), how many
   tokens equal phase 5's engine's printed;
6. each kernel's time at the main-path shapes with CUDA events over a
   CUDA graph of many calls (device time, with the host's launch work
   taken out; operands cycled past the 50 MB L2), beside its plain
   version, its bound on the card and, where one exists, one PyTorch
   library call that computes the same function, timed the same way (a
   yardstick only: the port never calls it); the bf16 matmul's decode
   step at ring depths 1, 2 and 4, its split counts, and its step timed
   eagerly (paced by the host) as well; the int8 matmul's decode step at
   ring depths 1, 2 and 4 and k tiles of 128 and 256 codes, its split
   counts, and a 128-token prefill; the grouped matmul's decode step at
   ring depths 1, 2 and 4, and a prefill; the int8 grouped matmul's
   decode step and prefill at ring depths 1, 2 and 4 and k tiles of 128
   and 256 codes, beside its earlier design, the cp.async ring, on the
   same operands;
   paged attention's time a call with its split count, and at other
   split counts; and for the SSM and hybrid paths flash attention at
   (1, 32, 128, 80) beside SDPA, paged attention at (4, 32, 80) over 480
   keys a slot, and the bf16 matmul's zamba2 decode step (181 launches)
   beside cuBLAS; and for the encdec, vlm and last dense paths flash
   attention at (4, 16, 1, 128, 64) and (1, 56, 3008, 128) beside SDPA,
   paged attention at rep 7 and rep 12, and the bf16 matmul's decode step
   of seamless, llava, qwen and mistral beside cuBLAS; and the paper's ZONL
   comparison: one (512, 3072, 3072) bf16 product as
   ``ops.host_tiled_matmul`` (the host's loop of one cuBLAS call a
   128-tile) over a CUDA graph and issued eagerly, beside kernel 1 and
   cuBLAS (printed, not gated);
7. the script's wall time, a ``{"kernels": [...]}`` line (with each
   kernel's launches on the paths of 5p, 5g-5l, 5r (rank 0), 5s and 5t,
   the zamba2
   shapes' and
   the slice-9 shapes' timings of kernels 1-3 and kernel 1's ZONL
   comparison), the card line, and the
   final
   ``{"ok": true, ...}`` line.

On the card the engine decodes through one CUDA graph a variant
(greedy only, sampled), captured after the variant's first dispatch,
and prefills through one graph a prompt bucket and one a chunk shape,
each captured after its first (eager) use; the train step runs as one
graph a batch shape and the lock-step oracle's decode as one graph a
call, in the same way; every serving phase prints its engines' captures
and their pool bytes, and each wrapper's launch count counts the
launches a replay runs.

Any failed check raises, so the script exits non-zero and prints no
``ok`` line.  It exits non-zero at once without a CUDA device, or when
it is not run from a checkout that holds ``src/repro_torch``.
"""

from __future__ import annotations

import collections
import gc
import json
import math
import re
import subprocess
import sys
import time
import warnings
from pathlib import Path

ROOT = Path(__file__).resolve().parent
T_START = time.perf_counter()

# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit)
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12, "int8": 1979e12}

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


def ptxas_entries(report: str) -> list[tuple[str, str, int]]:
    """(instantiation, registers, bytes of spill stores) per compiled
    kernel of an ``nvcc -Xptxas -v`` log; template arguments are read off
    the mangled name (the element type, the Li<n>E ints and the Lb0/Lb1
    bool flags)."""
    items, entry, spill = [], "?", 0
    for ln in report.splitlines():
        if "Compiling entry function" in ln:
            mangled = ln.split("'")[1]
            ints = re.findall(r"Li(\d+)E", mangled)
            bits = [f[0] for f in mangled.split("Lb")[1:]]
            if "sm90_kernel" in mangled:
                dtype = "int8" if "sm90_kernelIa" in mangled else "bf16"
                entry = (f"sm90 {dtype} bn={64 * int(ints[0])} "
                         f"rows={ints[1]} trans_b={bits[0]}")
            elif "flash_tc_kernel" in mangled:
                entry = f"tensor-core D={ints[0]} bkv={ints[1]}"
            elif "paged_split_kernel" in mangled:
                dtype = "bf16" if "bfloat16" in mangled else "fp32"
                entry = f"paged split {dtype} rows={ints[0]} nv={ints[1]}"
            elif "paged_combine_kernel" in mangled:
                entry = ("paged combine "
                         + ("bf16" if "bfloat16" in mangled else "fp32"))
            elif "splitk_reduce" in mangled:
                entry = ("split-k reduce "
                         + ("int8" if "splitk_reduceIa" in mangled else "bf16"))
            else:
                dtype = ("bf16" if "bfloat16" in mangled else
                         "int8" if "kernelIa" in mangled else "fp32")
                entry = dtype + (f" trans_b={bits[0]} vec={bits[1]}"
                                 if len(bits) == 2 else "")
        elif "spill stores" in ln:
            spill = int(ln.strip().split(",")[1].split()[0])
        elif re.search(r"Used \d+ registers", ln):
            regs = re.search(r"Used (\d+) registers", ln).group(1)
            items.append((entry, regs, spill))
    return items


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
    from repro_torch.kernels.grouped_matmul import grouped_zero_stall_matmul
    from repro_torch.kernels.paged_attention import paged_attention
    from repro_torch.kernels.quantized_matmul import (
        quantized_grouped_zero_stall_matmul, quantized_zero_stall_matmul)
    from repro_torch.kernels.zero_stall_matmul import zero_stall_matmul

    # -- 1. card ---------------------------------------------------------
    card = card_line()
    print(f"[1] card: {card}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}", flush=True)

    # -- 2. build --------------------------------------------------------
    t0 = time.perf_counter()
    _build.build_all()
    print(f"[2] built {', '.join(_build.SOURCES)} for sm_90a in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    for name in _build.SOURCES:
        entries = ptxas_entries(_build.ptxas_report(name))
        print(f"    {name} ptxas: " + "; ".join(
            f"{e}: {r} regs, {s} bytes spill stores" for e, r, s in entries))
        # the Hopper designs of the main path keep their accumulators in
        # registers: a spill would put them in local memory
        spilled = [e for e, _, s in entries
                   if s and e.startswith(("sm90", "tensor-core", "paged"))]
        require(not spilled, f"{name}: {spilled} spill registers")
        remarks = {}
        for ln in _build.ptxas_report(name).splitlines():
            code = re.search(r"\((C7\d+)\) (.*?) (?:in|around) ", ln)
            if code:
                remarks.setdefault(code.groups(), 0)
                remarks[code.groups()] += 1
        for (code, what), n in remarks.items():
            print(f"      ptxas remark {code} x {n}: {what}")

    # the tuner's cache: a fresh file, so that a run depends on no earlier
    # one (every Ctx(plan="auto") below tunes through it)
    from repro_torch import tune
    TUNE_CACHE.unlink(missing_ok=True)
    tune.set_cache(tune.TuneCache(TUNE_CACHE))

    kern = {"zero_stall_matmul": zero_stall_matmul,
            "flash_attention": flash_attention,
            "paged_attention": paged_attention,
            "quantized_zero_stall_matmul": quantized_zero_stall_matmul,
            "grouped_zero_stall_matmul": grouped_zero_stall_matmul,
            "quantized_grouped_zero_stall_matmul":
                quantized_grouped_zero_stall_matmul}
    t_run = time.perf_counter()
    errs = check_kernels(torch, kern)
    for more in (check_new_kernels, check_slice9_kernels):
        for name, err in more(torch, kern).items():
            errs[name] = max(errs.get(name, 0.0), err)
    check_reduced_engines(torch, kern)
    counts = serve_full_width(torch, kern)
    counts.update(serve_paged_full_width(torch, kern))
    counts.update(serve_moe_full_width(torch, kern))
    # kernel 4 runs on two paths (5d, 5e); the line reads 5e's, where it
    # carries every projection, so that each count is that of one run
    counts["quantized_zero_stall_matmul"] = serve_gemma_w8a8(torch, kern)
    by_path = {"5p": PHASE5["5p"], "5s": PHASE5["5s"], "5t": PHASE5["5t"]}
    by_path.update(serve_zamba2_full_width(torch, kern))
    by_path.update(serve_mamba2_full_width(torch, kern))
    for phase in (serve_seamless_full_width, serve_llava_full_width,
                  serve_qwen_full_width, serve_mistral_full_width):
        by_path.update(phase(torch, kern))
    serve_under_plans(torch, kern)
    dryrun_cells(torch)
    serve_int8_kv_and_analyze(torch, kern)
    train_on_the_card(torch, kern)
    by_path["5r"] = across_ranks(torch, kern)
    timings = time_kernels(torch, kern)
    timings.update(time_new_kernels(torch, kern))
    slice8 = time_slice8(torch, kern)
    slice9 = time_slice9(torch, kern)
    zonl = time_host_tiled(torch, kern)

    kernels = [
        {"name": "zero_stall_matmul", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/zero_stall_sm90.cu",
         "design": "bf16: TMA + mbarrier ring, wgmma (swap AB), split-k; "
                   "decode and prefill replay it inside the engine's CUDA "
                   "graphs",
         "replaces": "src/repro/kernels/zero_stall_matmul.py:200",
         "launches": counts["zero_stall_matmul"],
         "max_abs_err": errs["zero_stall_matmul"], **timings["matmul"]},
        {"name": "flash_attention", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
         "design": "bf16: tensor cores (mma.sync, register accumulators, "
                   "2-stage cp.async ring)",
         "replaces": "src/repro/kernels/flash_attention.py:164",
         "launches": counts["flash_attention"],
         "max_abs_err": errs["flash_attention"], **timings["attention"]},
        {"name": "paged_attention", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/paged_attention.cu",
         "design": "split-KV: contiguous page ranges a block, TMA bulk "
                   "row copies into a ring of page windows, q and "
                   "accumulators in registers, a programmatic-dependent "
                   "combine launch",
         "replaces": "src/repro/kernels/paged_attention.py:141",
         "launches": counts["paged_attention"],
         "max_abs_err": errs["paged_attention"], **timings["paged"]},
        {"name": "quantized_zero_stall_matmul", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/quantized_sm90.cu",
         "design": "int8: TMA + mbarrier ring, int8 wgmma (swap AB), "
                   "int32 split-k",
         "replaces": "src/repro/kernels/quantized_matmul.py:187",
         "launches": counts["quantized_zero_stall_matmul"],
         "max_abs_err": errs["quantized_zero_stall_matmul"],
         **timings["quantized"]},
        {"name": "grouped_zero_stall_matmul", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/zero_stall_sm90.cu",
         "design": "bf16: TMA + mbarrier ring over rank-3 maps, wgmma "
                   "(swap AB), persistent walk over the experts' tiles",
         "replaces": "src/repro/kernels/grouped_matmul.py:137",
         "launches": counts["grouped_zero_stall_matmul"],
         "max_abs_err": errs["grouped_zero_stall_matmul"],
         **timings["grouped"]},
        {"name": "quantized_grouped_zero_stall_matmul", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/quantized_sm90.cu",
         "design": "int8: TMA + mbarrier ring over rank-3 maps, int8 wgmma "
                   "(swap AB), persistent walk over the experts' tiles",
         "replaces": "src/repro/kernels/quantized_matmul.py:317",
         "launches": counts["quantized_grouped_zero_stall_matmul"],
         "by_design": counts["quantized_grouped_by_design"],
         "max_abs_err": errs["quantized_grouped_zero_stall_matmul"],
         **timings["quantized_grouped"]},
    ]
    # the SSM, hybrid and rank paths: each path's launches (its counts set
    # to 0 just before it; 5r's on rank 0 of four) and, for kernels 1-3,
    # the zamba2 shapes' timings
    # (kernel 2 and 3 at head dim 80)
    for entry in kernels:
        name = entry["name"]
        entry["launches_by_path"] = {path: got[name]
                                     for path, got in by_path.items()
                                     if got.get(name)}
    for entry, key, what in ((kernels[0], "matmul", "zamba2_decode_step"),
                             (kernels[1], "attention", "d80"),
                             (kernels[2], "paged", "d80")):
        entry[what] = slice8[key]
    # the encdec, vlm and last dense paths' shapes of kernels 1-3
    for entry, key in ((kernels[0], "matmul"), (kernels[1], "attention"),
                       (kernels[2], "paged")):
        entry.update(slice9[key])
    # the paper's ZONL comparison at (512, 3072, 3072): the host's tile
    # loop (ops.host_tiled_matmul) beside kernel 1 (printed, not gated)
    kernels[0]["host_tiled"] = zonl
    leaked = sorted(m for m in sys.modules
                    if m == "jax" or m.startswith(("jax.", "repro.")))
    require(not leaked, f"JAX or the JAX package got imported: {leaked}")
    print(f"[7] all phases passed in {time.perf_counter() - t_run:.1f} s "
          f"after the build; the script's wall time "
          f"{time.perf_counter() - T_START:.1f} s")
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
OLMOE = {"d": 2048, "H": 16, "hd": 128, "ff": 1024, "E": 64, "k": 8,
         "V": 50304, "layers": 16, "slots": 4}
# the SSM and hybrid paths: zamba2-2.7b (54 mamba layers, a shared
# block after every 6: 9 invocations) and mamba2-130m
ZAMBA2 = {"d": 2560, "H": 32, "hd": 80, "ff": 10240, "V": 32000,
          "layers": 54, "groups": 9, "d_inner": 5120, "in_proj": 10448,
          "slots": 4}
MAMBA2 = {"d": 768, "V": 50280, "layers": 24, "d_inner": 1536,
          "in_proj": 3352}
# kernel-1 launches of one pass (a prefill or a decode step): zamba2's
# in and out projections of 54 mamba layers, 8 projections of each of
# the 9 shared-block invocations (pre_proj, q, k, v, o, wi, wg, wo) and
# the head; W8A8 moves the shared block's 72 to kernel 4.  mamba2: two
# projections of 24 layers and the head.
ZAMBA2_MM = 2 * 54 + 8 * 9 + 1
ZAMBA2_Q4 = 8 * 9
MAMBA2_MM = 2 * 24 + 1
NEW_KERNELS = ("quantized_zero_stall_matmul", "grouped_zero_stall_matmul",
               "quantized_grouped_zero_stall_matmul")
# phase 5's traffic, served again by phases 5c-5e
SERVE_KW = dict(batch=8, prompt_len=128, gen_len=32, mixed=True,
                num_slots=4, steps_per_dispatch=4, seed=0)


def gemma_matmul_shapes(M: int) -> list[tuple[str, int, int, int, int]]:
    """(name, M, K, N, calls per layer or per step) of one gemma-7b pass
    over M rows: the seven projections of a layer.  The LM head is
    listed separately (its M differs between prefill and decode)."""
    g = GEMMA
    qkv = g["H"] * g["hd"]
    return [("wq/wk/wv", M, g["d"], qkv, 3), ("attn wo", M, qkv, g["d"], 1),
            ("mlp wi/wg", M, g["d"], g["ff"], 2),
            ("mlp wo", M, g["ff"], g["d"], 1)]


def slice8_matmul_shapes(M: int) -> list[tuple[str, int, int, int, int]]:
    """(name, M, K, N, calls per pass) of the projections of one
    zamba2-2.7b pass and one mamba2-130m pass over M rows (their heads
    are listed apart)."""
    z, m = ZAMBA2, MAMBA2
    g = z["groups"]
    return [("zamba2 in_proj", M, z["d"], z["in_proj"], z["layers"]),
            ("zamba2 out_proj", M, z["d_inner"], z["d"], z["layers"]),
            ("zamba2 pre_proj", M, 2 * z["d"], z["d"], g),
            ("zamba2 wq/wk/wv/wo", M, z["d"], z["H"] * z["hd"], 4 * g),
            ("zamba2 mlp wi/wg", M, z["d"], z["ff"], 2 * g),
            ("zamba2 mlp wo", M, z["ff"], z["d"], g),
            ("mamba2 in_proj", M, m["d"], m["in_proj"], m["layers"]),
            ("mamba2 out_proj", M, m["d_inner"], m["d"], m["layers"])]


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
    from repro_torch.kernels.zero_stall_matmul import split_plan
    zero_stall_matmul = kern["zero_stall_matmul"]
    flash_attention = kern["flash_attention"]
    paged_attention = kern["paged_attention"]
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)

    def rnd(*shape, dtype=torch.bfloat16):
        return torch.randn(*shape, device=dev, generator=gen).to(dtype)

    errs = {name: 0.0 for name in kern}
    print(f"[3] kernels against their plain versions, per output row "
          f"(bf16: |err| <= {BF16_TOL} * that row's max|ref|; fp32: |err| "
          f"<= {FP32_TOL} * max(1, that row's max|ref|))", flush=True)

    def judge(kernel, what, got, want, dtype):
        """Per output row: |err| <= tol * that row's largest magnitude
        (bf16), or tol * max(1, it) (fp32)."""
        err = (got.float() - want.float()).abs().amax(-1)
        scale = want.float().abs().amax(-1)
        tol = (BF16_TOL * scale if dtype == torch.bfloat16
               else FP32_TOL * scale.clamp_min(1.0))
        worst = (err / tol.clamp_min(1e-30)).max().item()
        e = err.max().item()
        print(f"    {kernel} {what}: max|err| {e:.3g}, worst row |err|/tol "
              f"{worst:.3g}")
        require(bool((err <= tol).all()), f"{kernel} {what} disagrees with "
                f"its plain version in some row (worst |err|/tol {worst})")
        errs[kernel] = max(errs[kernel], e)

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

    # bf16 matmul at every gemma-7b projection shape, decode and prefill,
    # the tied head, olmoe-1b-7b's projections and untied head: all on
    # the TMA + wgmma design
    mm_before = dict(zero_stall_matmul.launches_by_design)
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
    od, oV = OLMOE["d"], OLMOE["V"]
    for M in (OLMOE["slots"], 128):
        a, b = rnd(M, od), rnd(od, od)
        judge("zero_stall_matmul", f"olmoe wq/wk/wv/wo M={M} K=N={od} bf16",
              zero_stall_matmul(a, b), matmul_ref(a, b), torch.bfloat16)
    for M in (1, OLMOE["slots"]):
        a, w = rnd(M, od), rnd(od, oV)
        judge("zero_stall_matmul", f"olmoe LM head M={M} N={oV} (untied, "
              f"fp32 out)", zero_stall_matmul(a, w, out_dtype=torch.float32),
              matmul_ref(a, w, torch.float32), torch.bfloat16)
    del w
    # an aligned non-square shape in both B layouts, every ring depth and
    # grid order, one stage (bk 128) and two split stages (bk 64): TMA
    # boxes past every edge, the swizzle against the wgmma descriptors
    a, bt = rnd(4, 72), rnd(200, 72)
    for trans_b, b in ((False, bt.t().contiguous()), (True, bt)):
        want = matmul_ref(a, b.t() if trans_b else b)
        for slots in (1, 2, 3):
            for order in ("ijk", "jik"):
                for bk in (128, 64):
                    got = zero_stall_matmul(
                        a, b, trans_b=trans_b, bk=bk, slots=slots,
                        grid_order=order,
                        variant="single" if slots == 1 else "dobu")
                    judge("zero_stall_matmul", f"4x72x200 "
                          f"{'(N, K)' if trans_b else '(K, N)'} B "
                          f"slots={slots} {order} bk={bk}", got, want,
                          torch.bfloat16)
    # split-k is deterministic: two calls give the same bits
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for M in (GEMMA["slots"], 128):
        K, N = GEMMA["ff"], GEMMA["d"]
        a, b = rnd(M, K), rnd(K, N)
        splits, per = split_plan(M, N, K, 128, 128, 128, sms)
        first, second = zero_stall_matmul(a, b), zero_stall_matmul(a, b)
        same = torch.equal(first, second)
        print(f"    zero_stall_matmul mlp wo M={M}: {splits} splits of {per} "
              f"k stages on {sms} SMs, two calls bitwise equal {same}")
        require(splits > 1 and same, "split-k is not deterministic")
    ran = {k: zero_stall_matmul.launches_by_design[k] - mm_before[k]
           for k in mm_before}
    print(f"    bf16 matmul checks by design: {ran}")
    require(ran["ring"] == 0 and ran["sm90"] > 0,
            "a bf16 matmul of phase 3 did not run the TMA + wgmma design")
    # fp32 at a ragged shape, every ring depth and both grid orders
    a, b = rnd(37, 45, dtype=torch.float32), rnd(45, 29, dtype=torch.float32)
    for slots in (1, 2, 3):
        for order in ("ijk", "jik"):
            got = zero_stall_matmul(
                a, b, bm=16, bn=16, bk=8, slots=slots, grid_order=order,
                variant="single" if slots == 1 else "dobu")
            judge("zero_stall_matmul", f"fp32 37x45x29 slots={slots} "
                  f"{order}", got, matmul_ref(a, b), torch.float32)

    # flash attention at the prefill shape (1, 16, bucket, D), gemma-7b's
    # D = 256 and olmoe-1b-7b's 128, on the tensor-core design
    def i32(*xs):
        return torch.tensor(xs, dtype=torch.int32, device=dev)

    from repro_torch.kernels import ops
    fa_before = dict(flash_attention.launches_by_design)
    S, H = 128, GEMMA["H"]
    for D in (GEMMA["hd"], OLMOE["hd"]):
        q, k, v = rnd(1, H, S, D), rnd(1, H, S, D), rnd(1, H, S, D)
        cases = [
            ("causal, lengths 96", dict(causal=True, q_lens=i32(96),
                                        kv_lens=i32(96))),
            ("causal, full bucket", dict(causal=True)),
            ("non-causal, lengths 80", dict(causal=False, q_lens=i32(80),
                                            kv_lens=i32(80))),
            ("causal, q_offsets 16", dict(causal=True, q_offsets=i32(16),
                                          q_lens=i32(S + 16),
                                          kv_lens=i32(S))),
            ("masked: kv_len 0", dict(causal=False, q_lens=i32(S),
                                      kv_lens=i32(0))),
        ]
        for what, kw in cases:
            full = {"q_offsets": i32(0), **kw}
            full.setdefault("q_lens", full["q_offsets"] + S)
            full.setdefault("kv_lens", i32(S))
            got = flash_attention(q, k, v, **kw)
            judge_rows(f"D={D} {what}", got,
                       flash_attention_ref(q, k, v, **full))
            if "masked" in what:
                require(bool((got == 0).all()), "a fully-masked row is not "
                        "exact zeros")
        # causal, fewer queries than keys and no lengths: ops.attention
        # runs the kernel end-aligned, the reference's convention without
        # lengths
        launched = flash_attention.launches
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", RuntimeWarning)
            got = ops.attention(q[:, :, S // 2:].contiguous(), k, v,
                                causal=True)
        require(flash_attention.launches == launched + 1,
                "ops.attention with Sq < Skv did not launch the kernel")
        judge_rows(f"D={D} ops.attention causal Sq=64 < Skv=128, no "
                   f"lengths (end-aligned)", got,
                   flash_attention_ref(q[:, :, S // 2:], k, v, causal=True))
        # the chunked-prefill calls of phase 5b: 96 queries of one chunk
        # against the whole 160-token stripe, q_offsets at the chunk's
        # start, q_lens = kv_lens = the prompt's valid end after the chunk
        # (the second chunk of a 128- or 112-token prompt has 32 or 16
        # valid rows, the rest all zeros)
        C, stripe = 96, 160
        q, k, v = rnd(1, H, C, D), rnd(1, H, stripe, D), rnd(1, H, stripe, D)
        for off, end in ((0, 96), (96, 128), (96, 112)):
            kw = dict(causal=True, q_offsets=i32(off), q_lens=i32(end),
                      kv_lens=i32(end))
            judge_rows(f"D={D} chunk (1, {H}, {C}, {D}) over a {stripe}-"
                       f"token stripe, causal, q_offsets {off}, lengths "
                       f"{end}", flash_attention(q, k, v, **kw),
                       flash_attention_ref(q, k, v, **kw))
    ran = {k: flash_attention.launches_by_design[k] - fa_before[k]
           for k in fa_before}
    print(f"    bf16 flash checks by design: {ran}")
    require(ran["cuda_core"] == 0 and ran["tensor_core"] > 0,
            "a bf16 flash call of phase 3 did not run the tensor-core design")

    # paged attention at the decode shape: 4 slots, 16 heads of 256,
    # 16-token pages, a 10-page table (max_len 160), on the split-KV
    # design (splits from B, KV, T and the SM count); then one page (one
    # split) and a 7-page table (splits that do not divide T)
    from repro_torch.kernels.paged_attention import paged_splits
    B, T, ps, H, D = GEMMA["slots"], 10, 16, GEMMA["H"], GEMMA["hd"]
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
        ("bf16 T 1, kv 16/9/0/40 > T*ps",
         dict(B=B, H=H, KV=H, D=D, ps=ps, T=1, kv_lens=[16, 9, 0, 40],
              dtype=torch.bfloat16)),
        ("bf16 T 7, kv 112/100/33/17",
         dict(B=B, H=H, KV=H, D=D, ps=ps, T=7, kv_lens=[112, 100, 33, 17],
              dtype=torch.bfloat16)),
    ]
    for what, kw in cases:
        ops_in = paged_case(torch, gen, **kw)
        splits, per = paged_splits(kw["B"], kw["KV"], kw["T"], sms)
        launched = paged_attention.launches
        got = paged_attention(*ops_in[:4], kv_lens=ops_in[4])
        require(paged_attention.launches == launched + 1,
                "paged_attention did not launch its kernel")
        judge_rows(f"{what}: {splits} split(s) of {per} page(s)", got,
                   paged_attention_ref(*ops_in[:4], kv_lens=ops_in[4]),
                   kernel="paged_attention")
        require((splits == 1) == (kw["T"] == 1), f"paged {what}: {splits} "
                f"splits")
        for b, n in enumerate(kw["kv_lens"]):
            if n == 0:
                require(bool((got[b] == 0).all()), "a paged row with no "
                        "valid column is not exact zeros")
        if kw["T"] == 7:
            require(kw["T"] % splits != 0, "T 7 is divided by the splits")
    # the split and its combine are deterministic: two calls, one result
    ops_in = paged_case(torch, gen, **cases[0][1])
    first = paged_attention(*ops_in[:4], kv_lens=ops_in[4])
    same = torch.equal(first, paged_attention(*ops_in[:4],
                                              kv_lens=ops_in[4]))
    print(f"    paged_attention {cases[0][0]}: two calls bitwise equal "
          f"{same}")
    require(same, "split paged attention is not deterministic")

    # -- the SSM and hybrid paths (zamba2-2.7b, mamba2-130m) -------------
    # kernel 1 at every new projection shape, decode (M = 4) and a
    # 128-token prefill, and the tied heads: each on the TMA + wgmma
    # design (N = 3352 and 10448 are ragged against bn = 128: the TMA
    # boxes zero-fill the edge)
    from repro_torch.kernels.zero_stall_matmul import select_design
    mm_before = dict(zero_stall_matmul.launches_by_design)
    designs = {}
    for M in (ZAMBA2["slots"], 128):
        for name, m, k, n, _ in slice8_matmul_shapes(M):
            a, b = rnd(m, k), rnd(k, n)
            designs[name] = select_design(torch.bfloat16, k, n, False,
                                          a.data_ptr(), b.data_ptr())
            judge("zero_stall_matmul", f"{name} M={m} K={k} N={n} bf16",
                  zero_stall_matmul(a, b), matmul_ref(a, b), torch.bfloat16)
    for arch, d, V in (("zamba2", ZAMBA2["d"], ZAMBA2["V"]),
                       ("mamba2", MAMBA2["d"], MAMBA2["V"])):
        a, table = rnd(ZAMBA2["slots"], d), rnd(V, d)
        designs[f"{arch} LM head"] = select_design(torch.bfloat16, d, V, True)
        judge("zero_stall_matmul", f"{arch} LM head M={ZAMBA2['slots']} "
              f"N={V} (tied, transposed B, fp32 out)",
              zero_stall_matmul(a, table, trans_b=True,
                                out_dtype=torch.float32),
              matmul_ref(a, table.t(), torch.float32), torch.bfloat16)
    del table
    ran = {k: zero_stall_matmul.launches_by_design[k] - mm_before[k]
           for k in mm_before}
    print(f"    design of each new kernel-1 shape: {designs}; by design "
          f"{ran}")
    require(ran["ring"] == 0 and set(designs.values()) == {"sm90"},
            "a zamba2 or mamba2 projection landed on the ring design")

    # kernel 2 at zamba2's prefill, (1, 32, S, 80) after the 64-token
    # chunk padding: the D = 80 instantiation of the tensor-core design
    fa_before = dict(flash_attention.launches_by_design)
    H, D = ZAMBA2["H"], ZAMBA2["hd"]
    for S in (64, 128):
        q, k, v = rnd(1, H, S, D), rnd(1, H, S, D), rnd(1, H, S, D)
        cases = [
            (f"causal, lengths {S - 7}", dict(causal=True, q_lens=i32(S - 7),
                                              kv_lens=i32(S - 7))),
            ("causal, full", dict(causal=True)),
            (f"non-causal, lengths {S}/{S - 20}",
             dict(causal=False, q_lens=i32(S), kv_lens=i32(S - 20))),
            ("masked: kv_len 0", dict(causal=True, q_lens=i32(S),
                                      kv_lens=i32(0))),
        ]
        for what, kw in cases:
            full = {"q_offsets": i32(0), **kw}
            full.setdefault("q_lens", i32(S))
            full.setdefault("kv_lens", i32(S))
            got = flash_attention(q, k, v, **kw)
            judge_rows(f"D=80 (1, {H}, {S}, {D}) {what}", got,
                       flash_attention_ref(q, k, v, **full))
            if "masked" in what:
                require(bool((got == 0).all()), "a fully-masked D = 80 row "
                        "is not exact zeros")
    ran = {k: flash_attention.launches_by_design[k] - fa_before[k]
           for k in fa_before}
    require(ran["cuda_core"] == 0 and ran["tensor_core"] == 8,
            f"the D = 80 flash calls ran {ran}, not 8 tensor-core launches")

    # kernel 3 at zamba2's paged decode, (4, 32, 80), one query head a kv
    # head: a row is 10 16-byte vectors in a lane group of 16.  The
    # serving table (10 pages: max_len 160) and a 30-page one (480 keys)
    cases = [
        ("bf16 (4, 32, 80) rep 1, T 10, scattered pages, kv 160/129/80/17",
         dict(B=4, H=H, KV=H, D=D, ps=16, T=10, kv_lens=[160, 129, 80, 17],
              dtype=torch.bfloat16)),
        ("bf16 (4, 32, 80) rep 1, T 30, kv 480/300/17/1",
         dict(B=4, H=H, KV=H, D=D, ps=16, T=30, kv_lens=[480, 300, 17, 1],
              dtype=torch.bfloat16)),
        ("bf16 (4, 32, 80), row 1 on the trash page, row 2 kv 0, row 3 kv "
         "500 > T*ps",
         dict(B=4, H=H, KV=H, D=D, ps=16, T=30, kv_lens=[96, 50, 0, 500],
              dtype=torch.bfloat16, trash_rows=(1,))),
    ]
    for what, kw in cases:
        ops_in = paged_case(torch, gen, **kw)
        splits, per = paged_splits(kw["B"], kw["KV"], kw["T"], sms)
        launched = paged_attention.launches
        got = paged_attention(*ops_in[:4], kv_lens=ops_in[4])
        require(paged_attention.launches == launched + 1,
                "paged_attention did not launch its kernel")
        judge_rows(f"{what}: {splits} split(s) of {per} page(s)", got,
                   paged_attention_ref(*ops_in[:4], kv_lens=ops_in[4]),
                   kernel="paged_attention")
        for b, n in enumerate(kw["kv_lens"]):
            if n == 0:
                require(bool((got[b] == 0).all()), "a D = 80 paged row with "
                        "no valid column is not exact zeros")
        same = torch.equal(got, paged_attention(*ops_in[:4],
                                                kv_lens=ops_in[4]))
        require(same, f"paged {what}: two calls differ")
    print("    paged_attention at D = 80: two calls bitwise equal in every "
          "case")
    torch.cuda.synchronize()
    return errs


def expert_shapes(M: int) -> list[tuple[str, int, int, int, int, int]]:
    """(name, G, M, K, N, calls per layer) of one olmoe-1b-7b MoE layer
    over expert buffers of M = C rows: wi and wg, then wo."""
    o = OLMOE
    return [("wi/wg", o["E"], M, o["d"], o["ff"], 2),
            ("wo", o["E"], M, o["ff"], o["d"], 1)]


def moe_capacity(tokens: int) -> int:
    """The expert capacity C of an olmoe-1b-7b call over ``tokens``
    tokens (capacity factor 1.25, top-8 of 64)."""
    return max(1, int(1.25 * OLMOE["k"] * tokens / OLMOE["E"]))


def check_new_kernels(torch, kern) -> dict:
    """Phase 3 for the int8 and grouped kernels: bit-equal int8 products
    at the W8A8 projection shapes of gemma-7b and olmoe-1b-7b and the
    bf16 grouped kernel at the expert shapes, all on the TMA + wgmma
    design with the path's tiles; the int8 design at an aligned
    non-square shape for every ring depth, grid order and two k tiles,
    its split-k twice bitwise equal; the grouped design at ragged shapes
    for every ring depth; the int8 grouped kernel, and the ring at a
    ragged fp32 shape for every ring depth."""
    from repro_torch.kernels.ref import (grouped_matmul_ref,
                                         quantized_grouped_matmul_ref,
                                         quantized_matmul_ref)
    from repro_torch.kernels.zero_stall_matmul import split_plan
    from repro_torch.plan import KernelConfig
    from repro_torch.quant import quantize, quantize_rows
    q4 = kern["quantized_zero_stall_matmul"]
    g5 = kern["grouped_zero_stall_matmul"]
    q6 = kern["quantized_grouped_zero_stall_matmul"]
    q4_kw = KernelConfig().matmul_kwargs(torch.int8)       # the path's
    q6_kw = KernelConfig().matmul_kwargs(torch.int8, grouped=True)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(3)
    errs = {n: 0.0 for n in NEW_KERNELS}
    print("[3] int8 kernels against their plain versions: bit-equal; "
          f"grouped bf16: per output row |err| <= {BF16_TOL} * that row's "
          f"max|ref|, fp32: |err| <= {FP32_TOL} * max(1, max|ref|)",
          flush=True)

    def rnd(*shape):
        return torch.randn(*shape, device=dev, generator=gen)

    def ring_kw(slots):
        return dict(slots=slots, variant="single" if slots == 1 else "dobu")

    def exact(name, what, fn, want):
        launched = kern[name].launches
        got = fn()
        require(kern[name].launches == launched + 1,
                f"{name} did not launch its kernel")
        diff = (got.float() - want.float()).abs().max().item()
        print(f"    {name} {what}: bit-equal {torch.equal(got, want)}, "
              f"max|err| {diff:.3g}")
        require(torch.equal(got, want), f"{name} {what} is not bit-equal "
                f"to its plain version")
        return got

    def close(what, got, want, dtype):
        """bf16 per output row (each row's |err| within BF16_TOL of that
        row's largest magnitude), fp32 against the whole tensor's."""
        got, want = got.float().flatten(0, -2), want.float().flatten(0, -2)
        err = (got - want).abs().amax(-1)
        scale = want.abs().amax(-1)
        tol = (BF16_TOL * scale if dtype == torch.bfloat16
               else FP32_TOL * max(1.0, scale.max().item()))
        worst = (err / tol.clamp_min(1e-30) if dtype == torch.bfloat16
                 else err / tol).max().item()
        print(f"    grouped_zero_stall_matmul {what}: max|err| "
              f"{err.max().item():.3g}, worst row |err|/tol {worst:.3g}")
        require(bool((err <= tol).all()), f"grouped_zero_stall_matmul "
                f"{what} disagrees with its plain version (worst |err|/tol "
                f"{worst})")
        errs["grouped_zero_stall_matmul"] = max(
            errs["grouped_zero_stall_matmul"], err.max().item())

    def by_design(name, before, want):
        ran = {k: kern[name].launches_by_design[k] - before[k]
               for k in before}
        print(f"    {name} checks by design: {ran}")
        require(ran == {**{k: 0 for k in ran}, **want},
                f"{name}: designs {ran}, the checks imply {want}")

    # kernel 4: every W8A8 projection of gemma-7b and olmoe-1b-7b with the
    # path's tiles, then (4, 80, 200) -- the scales under swap AB, TMA
    # boxes past every edge -- at every ring depth, grid order and k tile
    od = OLMOE["d"]
    shapes = [(f"gemma {n}", m, k, n_) for M in (GEMMA["slots"], 128)
              for n, m, k, n_, _ in gemma_matmul_shapes(M)]
    shapes += [(f"olmoe wq/wk/wv/wo", M, od, od) for M in (OLMOE["slots"],
                                                          128)]
    before = dict(q4.launches_by_design)
    for what, M, K, N in shapes:
        x_q, x_s = quantize_rows(rnd(M, K).bfloat16())
        qw = quantize(rnd(K, N).bfloat16())
        exact("quantized_zero_stall_matmul", f"{what} M={M} K={K} N={N} "
              f"bf16 out", lambda: q4(x_q, qw.data, x_s, qw.scale,
                                      out_dtype=torch.bfloat16, **q4_kw),
              quantized_matmul_ref(x_q, qw.data, x_s, qw.scale,
                                   torch.bfloat16))
    x_q, x_s = quantize_rows(rnd(4, 80))
    qw = quantize(rnd(80, 200))
    n_odd = 0
    for slots in (1, 2, 3):
        for order in ("ijk", "jik"):
            for bk in (128, 256):
                for out in (torch.float32, torch.bfloat16):
                    exact("quantized_zero_stall_matmul",
                          f"4x80x200 slots={slots} {order} bk={bk} "
                          f"{str(out).removeprefix('torch.')} out",
                          lambda: q4(x_q, qw.data, x_s, qw.scale, bk=bk,
                                     slots=slots, grid_order=order,
                                     variant="single" if slots == 1
                                     else "dobu", out_dtype=out),
                          quantized_matmul_ref(x_q, qw.data, x_s, qw.scale,
                                               out))
                    n_odd += 1
    # int32 split-k is exact and deterministic: two calls, the same bits
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for M in (GEMMA["slots"], 128):
        K, N = GEMMA["ff"], GEMMA["d"]
        x_q, x_s = quantize_rows(rnd(M, K))
        qw = quantize(rnd(K, N))
        splits, per = split_plan(M, N, K, 128, 128, q4_kw["bk"], sms)
        first = exact("quantized_zero_stall_matmul", f"mlp wo M={M}, "
                      f"{splits} splits of {per} k stages",
                      lambda: q4(x_q, qw.data, x_s, qw.scale, **q4_kw),
                      quantized_matmul_ref(x_q, qw.data, x_s, qw.scale))
        exact("quantized_zero_stall_matmul", f"mlp wo M={M}, a second call",
              lambda: q4(x_q, qw.data, x_s, qw.scale, **q4_kw), first)
        require(splits > 1, "the int8 mlp wo ran no split-k")
    by_design("quantized_zero_stall_matmul", before,
              {"sm90": len(shapes) + n_odd + 4})

    # kernels 5 and 6: the olmoe expert banks at decode (C = 1) and at a
    # 128-token prefill bucket (C = 20), both on their TMA + wgmma designs
    # with the path's tiles
    before = dict(g5.launches_by_design)
    q6_before = dict(q6.launches_by_design)
    n_grouped = n_q6 = 0
    for M in (moe_capacity(OLMOE["slots"]), moe_capacity(128)):
        for what, G, m, K, N, _ in expert_shapes(M):
            a, b = rnd(G, m, K).bfloat16(), rnd(G, K, N).bfloat16()
            launched = g5.launches
            got = g5(a, b)
            require(g5.launches == launched + 1, "grouped_zero_stall_matmul "
                    "did not launch its kernel")
            close(f"{what} G={G} M={m} K={K} N={N} bf16", got,
                  grouped_matmul_ref(a, b), torch.bfloat16)
            n_grouped += 1
            x_q, x_s = quantize_rows(a)
            qw = quantize(b)
            exact("quantized_grouped_zero_stall_matmul", f"{what} G={G} "
                  f"M={m} K={K} N={N} bf16 out, bk {q6_kw['bk']}",
                  lambda: q6(x_q, qw.data, x_s, qw.scale,
                             out_dtype=torch.bfloat16, **q6_kw),
                  quantized_grouped_matmul_ref(x_q, qw.data, x_s, qw.scale,
                                               torch.bfloat16))
            n_q6 += 1
            del a, b, qw
    # kernel 6 at ragged shapes (K past a stage, N past a tile, M past 128
    # rows) for every ring depth, both k tiles and both output types
    for G, M, K, N in ((5, 3, 80, 208), (3, 130, 144, 264)):
        x_q, x_s = quantize_rows(rnd(G, M, K))
        qw = quantize(rnd(G, K, N))
        for slots in (1, 2, 3):
            for bk in (128, 256):
                for out in (torch.float32, torch.bfloat16):
                    exact("quantized_grouped_zero_stall_matmul",
                          f"ragged {G}x{M}x{K}x{N} slots={slots} bk={bk} "
                          f"{str(out).removeprefix('torch.')} out",
                          lambda: q6(x_q, qw.data, x_s, qw.scale, bk=bk,
                                     out_dtype=out, **ring_kw(slots)),
                          quantized_grouped_matmul_ref(x_q, qw.data, x_s,
                                                       qw.scale, out))
                    n_q6 += 1
    by_design("quantized_grouped_zero_stall_matmul", q6_before,
              {"sm90": n_q6})
    # ragged K (72 < bk; 136 and 200 past a whole stage), N past a tile, M
    # past 128 rows: rank-3 boxes zero-fill inside their own group
    for G, M, K, N in ((5, 3, 72, 200), (5, 3, 200, 72), (3, 130, 136, 264)):
        a, b = rnd(G, M, K).bfloat16(), rnd(G, K, N).bfloat16()
        want = grouped_matmul_ref(a, b)
        for slots in (1, 2, 3):
            close(f"ragged {G}x{M}x{K}x{N} bf16 slots={slots}",
                  g5(a, b, slots=slots,
                     variant="single" if slots == 1 else "dobu"),
                  want, torch.bfloat16)
            n_grouped += 1
    by_design("grouped_zero_stall_matmul", before, {"sm90": n_grouped})
    # a ragged shape in fp32 at every ring depth (and, for kernel 4, both
    # grid orders): the cp.async ring's element-wise loaders and masks;
    # kernel 6 there and on codes that start 8 bytes off a 16-byte line
    before = {n: dict(kern[n].launches_by_design)
              for n in ("quantized_zero_stall_matmul",
                        "grouped_zero_stall_matmul",
                        "quantized_grouped_zero_stall_matmul")}
    a, b = rnd(37, 45), rnd(45, 29)
    ga, gb = rnd(5, 3, 45), rnd(5, 45, 29)
    x_q, x_s = quantize_rows(a)
    qw = quantize(b)
    gx_q, gx_s = quantize_rows(ga)
    gqw = quantize(gb)
    for slots in (1, 2, 3):
        ring = dict(slots=slots, variant="single" if slots == 1 else "dobu")
        for order in ("ijk", "jik"):
            exact("quantized_zero_stall_matmul", f"fp32 out 37x45x29 "
                  f"slots={slots} {order}",
                  lambda: q4(x_q, qw.data, x_s, qw.scale, bm=32, bn=32,
                             bk=32, grid_order=order, **ring),
                  quantized_matmul_ref(x_q, qw.data, x_s, qw.scale))
        close(f"fp32 5x3x45x29 slots={slots}",
              g5(ga, gb, bm=16, bn=16, bk=8, **ring),
              grouped_matmul_ref(ga, gb), torch.float32)
        exact("quantized_grouped_zero_stall_matmul", f"fp32 out 5x3x45x29 "
              f"slots={slots}",
              lambda: q6(gx_q, gqw.data, gx_s, gqw.scale, bm=32, bn=32,
                         bk=32, **ring),
              quantized_grouped_matmul_ref(gx_q, gqw.data, gx_s, gqw.scale))
    gx_q, gx_s = quantize_rows(rnd(5, 3, 64))
    gqw = quantize(rnd(5, 64, 48))
    off = torch.empty(gx_q.numel() + 8, dtype=torch.int8, device=dev)
    off = off[8:].view(gx_q.shape)
    off.copy_(gx_q)
    require(off.data_ptr() % 16 == 8, "the offset codes are 16-byte aligned")
    exact("quantized_grouped_zero_stall_matmul", "5x3x64x48, A 8 bytes off "
          "a 16-byte line", lambda: q6(off, gqw.data, gx_s, gqw.scale,
                                       **q6_kw),
          quantized_grouped_matmul_ref(gx_q, gqw.data, gx_s, gqw.scale))
    by_design("quantized_zero_stall_matmul",
              before["quantized_zero_stall_matmul"], {"ring": 6})
    by_design("grouped_zero_stall_matmul",
              before["grouped_zero_stall_matmul"], {"ring": 3})
    by_design("quantized_grouped_zero_stall_matmul",
              before["quantized_grouped_zero_stall_matmul"], {"ring": 4})
    torch.cuda.synchronize()
    return errs


# ----------------------------------------------------------------------
# 3 (the encdec, vlm and last dense paths): kernels at their new shapes
# ----------------------------------------------------------------------
# seamless-m4t-large-v2 at full size: 24 encoder and 24 decoder layers
SEAMLESS = {"d": 1024, "H": 16, "hd": 64, "ff": 8192, "V": 256206,
            "enc": 24, "dec": 24, "frames": 128}
# kernel-1 launches of a seamless prefill (6 products an encoder layer:
# q, k, v, o, wi, wo; 10 a decoder layer: self q, k, v, o, cross q, k,
# v, o, wi, wo; the head) and of a decode step (the cross K/V come from
# the cache: 8 a decoder layer, the head); kernel-2 launches of a
# prefill (encoder, decoder self and cross attention) and of a decode
# step (cross attention; self attention is the plain einsum, or kernel
# 3 paged)
SEAMLESS_MM = {"prefill": 6 * 24 + 10 * 24 + 1, "decode": 8 * 24 + 1}
SEAMLESS_FA = {"prefill": 3 * 24, "decode": 24}
# the last three configs at full width, at a cut depth (full depth in
# bf16: llava 69 GB, qwen 70 GB, mistral 246 GB)
LLAVA = {"d": 7168, "H": 56, "KV": 8, "hd": 128, "ff": 20480, "V": 64000,
         "layers": 8, "of": 60, "P": 2880}
QWEN = {"d": 5120, "H": 40, "KV": 40, "hd": 128, "ff": 27392, "V": 152064,
        "layers": 8, "of": 64}
MISTRAL = {"d": 12288, "H": 96, "KV": 8, "hd": 128, "ff": 28672,
           "V": 32768, "layers": 4, "of": 88}


def slice9_matmul_shapes(arch: str, M: int
                         ) -> list[tuple[str, int, int, int, int, bool]]:
    """(name, M, K, N, calls a decode step, K-major B) of kernel 1 over M
    rows for ``arch`` ("seamless", "llava", "qwen", "mistral"), head
    included (every LM head is read K-major)."""
    if arch == "seamless":
        s = SEAMLESS
        d, L = s["d"], s["dec"]
        return [("seamless q/k/v/o, cross q/o", M, d, d, 6 * L, False),
                ("seamless mlp wi", M, d, s["ff"], L, False),
                ("seamless mlp wo", M, s["ff"], d, L, False),
                ("seamless LM head", M, d, s["V"], 1, True)]
    c = {"llava": LLAVA, "qwen": QWEN, "mistral": MISTRAL}[arch]
    d, L, q, kv = c["d"], c["layers"], c["H"] * c["hd"], c["KV"] * c["hd"]
    shapes = [(f"{arch} wq", M, d, q, L, False),
              (f"{arch} wk/wv", M, d, kv, 2 * L, False),
              (f"{arch} wo", M, q, d, L, False),
              (f"{arch} mlp wi/wg", M, d, c["ff"], 2 * L, False),
              (f"{arch} mlp wo", M, c["ff"], d, L, False),
              (f"{arch} LM head", M, d, c["V"], 1, True)]
    if q == kv:     # qwen: MHA, wq/wk/wv one shape
        shapes = [(f"{arch} wq/wk/wv", M, d, q, 3 * L, False)] + shapes[2:]
    return shapes


def check_slice9_kernels(torch, kern) -> dict:
    """Phase 3 for the encdec, vlm and last dense paths: kernel 1 at every
    new projection shape (decode M = 4 and a 128-token prefill; llava
    also at its 3008-row prefill) and at the K-major heads, seamless's N =
    256206 ragged against bn = 128, each on the TMA + wgmma design;
    kernel 2 at seamless's cross-attention decode (4, 16, 1, 128, 64),
    non-causal, eagerly and captured in a CUDA graph and replayed on new
    operands, at its prefill (1, 16, S, 128, 64) with S != 128 and its
    encoder (S = 128), and at llava's (1, 56, 3008, 128) causal prefill
    with lengths; kernel 3 at seamless (rep 1, D 64), llava (rep 7 over
    about 3040 keys a slot) and mistral (rep 12 over 480), with scattered
    pages, the trash page, kv_len 0 and a length past the table, two
    calls bitwise equal."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.flash_attention import fit_tiles
    from repro_torch.kernels.paged_attention import paged_rows, paged_splits
    from repro_torch.kernels.ref import (flash_attention_ref, matmul_ref,
                                         paged_attention_ref)
    from repro_torch.kernels.zero_stall_matmul import select_design
    mm = kern["zero_stall_matmul"]
    fa = kern["flash_attention"]
    pa = kern["paged_attention"]
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(9)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    errs = {n: 0.0 for n in ("zero_stall_matmul", "flash_attention",
                             "paged_attention")}
    print(f"[3] the encdec, vlm and last dense paths' kernel shapes against "
          f"the plain versions, per output row (bf16: |err| <= {BF16_TOL} "
          f"* that row's max|ref|)", flush=True)

    def rnd(*shape):
        return torch.randn(*shape, device=dev, generator=gen).to(
            torch.bfloat16)

    def judge(kernel, what, got, want):
        err = (got.float() - want.float()).abs().amax(-1)
        tol = BF16_TOL * want.float().abs().amax(-1)
        worst = (err / tol.clamp_min(1e-30)).max().item()
        e = err.max().item()
        print(f"    {kernel} {what}: max|err| {e:.3g}, worst row |err|/tol "
              f"{worst:.3g}")
        require(bool((err <= tol).all()), f"{kernel} {what} disagrees with "
                f"its plain version in some row (worst |err|/tol {worst})")
        errs[kernel] = max(errs[kernel], e)

    # kernel 1
    before = dict(mm.launches_by_design)
    n_mm, designs = 0, set()
    for arch in ("seamless", "llava", "qwen", "mistral"):
        Ms = (4, 128) + ((3008,) if arch == "llava" else ())
        for M in Ms:
            for name, m, k, n, _, head in slice9_matmul_shapes(arch, M):
                if M > 128 and head:
                    continue        # a prefill's head takes its last row
                a = rnd(m, k)
                b = rnd(n, k) if head else rnd(k, n)
                designs.add(select_design(torch.bfloat16, k, n, head,
                                          a.data_ptr(), b.data_ptr()))
                o = torch.float32 if head else torch.bfloat16
                judge("zero_stall_matmul", f"{name} M={m} K={k} N={n}"
                      + (" (K-major B, fp32 out)" if head else ""),
                      mm(a, b, trans_b=head, out_dtype=o),
                      matmul_ref(a, b.t() if head else b, o))
                n_mm += 1
                del a, b
    ran = {k: mm.launches_by_design[k] - before[k] for k in before}
    print(f"    new kernel-1 shapes by design: {ran}")
    require(designs == {"sm90"} and ran == {"sm90": n_mm, "ring": 0},
            "a new kernel-1 shape left the TMA + wgmma design")

    # kernel 2
    i32 = lambda *xs: torch.tensor(xs, dtype=torch.int32, device=dev)  # noqa
    fa_before = dict(fa.launches_by_design)
    H, D, S_enc = SEAMLESS["H"], SEAMLESS["hd"], SEAMLESS["frames"]
    q, k, v = rnd(4, H, 1, D), rnd(4, H, S_enc, D), rnd(4, H, S_enc, D)
    print(f"    flash tiles at one query row: "
          f"{fit_tiles(torch.bfloat16, 1, S_enc, 32, 32)}")
    judge("flash_attention", f"(4, {H}, 1, {S_enc}, {D}) non-causal "
          f"(seamless cross-attention at decode), eager",
          ops.attention(q, k, v, causal=False),
          flash_attention_ref(q, k, v, causal=False))
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    launched = fa.launches
    with torch.cuda.graph(graph):
        got = ops.attention(q, k, v, causal=False)
    require(fa.launches == launched + 1, "the captured cross-attention did "
            "not call the kernel")
    for t in (q, k, v):
        t.copy_(rnd(*t.shape))
    graph.replay()
    torch.cuda.synchronize()
    judge("flash_attention", f"(4, {H}, 1, {S_enc}, {D}) non-causal, "
          f"captured in a CUDA graph, replayed on new operands", got,
          flash_attention_ref(q, k, v, causal=False))
    del graph
    for S in (32, 64, 96, 128):
        q, k, v = rnd(1, H, S, D), rnd(1, H, S_enc, D), rnd(1, H, S_enc, D)
        judge("flash_attention", f"(1, {H}, {S}, {S_enc}, {D}) non-causal "
              f"(seamless cross-attention at a {S}-token bucket"
              + (", and the encoder" if S == S_enc else "") + ")",
              ops.attention(q, k, v, causal=False),
              flash_attention_ref(q, k, v, causal=False))
    H, D, S = LLAVA["H"], LLAVA["hd"], LLAVA["P"] + 128
    q, k, v = rnd(1, H, S, D), rnd(1, H, S, D), rnd(1, H, S, D)
    for n in (S, LLAVA["P"] + 97):
        kw = dict(causal=True, q_lens=i32(n), kv_lens=i32(n))
        judge("flash_attention", f"(1, {H}, {S}, {D}) causal, lengths {n} "
              f"(llava's prefill)", ops.attention(q, k, v, **kw),
              flash_attention_ref(q, k, v, q_offsets=i32(0), **kw))
    del q, k, v
    ran = {k: fa.launches_by_design[k] - fa_before[k] for k in fa_before}
    require(ran == {"tensor_core": 8, "cuda_core": 0}, f"the new flash "
            f"calls ran {ran}, not 8 tensor-core launches")

    # kernel 3
    cases = [
        ("bf16 (4, 16, 64) rep 1 (seamless), T 10, row 1 on the trash page, "
         "row 2 kv 0, row 3 kv 170 > T*ps",
         dict(B=4, H=16, KV=16, D=64, ps=16, T=10, kv_lens=[160, 97, 0, 170],
              dtype=torch.bfloat16, trash_rows=(1,))),
        ("bf16 (4, 56, 128) rep 7 (llava), T 190, kv 3040/2901/0/17, row 2 "
         "on the trash page",
         dict(B=4, H=56, KV=8, D=128, ps=16, T=190,
              kv_lens=[3040, 2901, 0, 17], dtype=torch.bfloat16,
              trash_rows=(2,))),
        ("bf16 (4, 96, 128) rep 12 (mistral), T 30, kv 480/300/0/500, row 1 "
         "on the trash page",
         dict(B=4, H=96, KV=8, D=128, ps=16, T=30, kv_lens=[480, 300, 0, 500],
              dtype=torch.bfloat16, trash_rows=(1,))),
    ]
    for what, kw in cases:
        ops_in = paged_case(torch, gen, **kw)
        splits, per = paged_splits(kw["B"], kw["KV"], kw["T"], sms)
        rep = kw["H"] // kw["KV"]
        launched = pa.launches
        got = pa(*ops_in[:4], kv_lens=ops_in[4])
        require(pa.launches == launched + 1, "paged_attention did not "
                "launch its kernel")
        judge("paged_attention", f"{what}: {paged_rows(rep, kw['D'], 2)} "
              f"rows a block, {splits} split(s) of {per} page(s)", got,
              paged_attention_ref(*ops_in[:4], kv_lens=ops_in[4]))
        for b, n in enumerate(kw["kv_lens"]):
            if n == 0:
                require(bool((got[b] == 0).all()), "a paged row with no "
                        "valid column is not exact zeros")
        require(torch.equal(got, pa(*ops_in[:4], kv_lens=ops_in[4])),
                f"paged {what}: two calls differ")
        del ops_in
    print("    paged_attention at rep 1 (D 64), rep 7 and rep 12: two calls "
          "bitwise equal in every case")
    torch.cuda.synchronize()
    return errs


# ----------------------------------------------------------------------
# 4. reduced configs: kernel path vs plain path, token for token
# ----------------------------------------------------------------------
REDUCED_MODES = {"contiguous": {}, "paged": {"page_size": 4},
                 "paged+chunked": {"page_size": 4, "prefill_chunk": 4}}


REDUCED_CASES = (
    # (arch, weights): "fp32" dense, "bf16" weights under fp32 compute,
    # "w8a8" int8 weights and activations
    ("gemma-7b", "fp32"), ("deepseek-coder-33b", "fp32"),
    ("gemma-7b", "w8a8"), ("deepseek-coder-33b", "w8a8"),
    ("olmoe-1b-7b", "bf16"), ("granite-moe-1b-a400m", "bf16"),
    ("olmoe-1b-7b", "w8a8"), ("granite-moe-1b-a400m", "w8a8"),
    ("mamba2-130m", "fp32"), ("zamba2-2.7b", "fp32"),
    ("mamba2-130m", "w8a8"), ("zamba2-2.7b", "w8a8"),
    ("qwen1.5-32b", "fp32"), ("mistral-large-123b", "fp32"),
    ("seamless-m4t-large-v2", "fp32"), ("llava-next-34b", "fp32"),
)
# the reduced encdec config's source frames a request
REDUCED_ENC_LEN = 12


def variants(eng) -> list[str]:
    """The decode variants (greedy, sampled) of the CUDA graphs ``eng``
    (an engine, or its list of captures) captured, in capture order; its
    prefill and chunk graphs are left out (:func:`prefill_variants`)."""
    caps = eng if isinstance(eng, list) else eng.captures
    return [c["variant"] for c in caps
            if not c["variant"].startswith("prefill")]


def prefill_variants(eng) -> list[str]:
    """The prefill and chunk graphs ``eng`` captured, in capture order."""
    return [c["variant"] for c in eng.captures
            if c["variant"].startswith("prefill")]


def print_captures(label: str, captures: list[dict]) -> None:
    print(f"    {label}: {len(captures)} CUDA graph capture(s): " + "; ".join(
        f"{c['variant']}, pool {c['pool_bytes'] / 2 ** 20:.1f} MiB, "
        f"captured in {1e3 * c['capture_s']:.1f} ms" for c in captures))


def check_reduced_engines(torch, kern) -> None:
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.models import Ctx, build_model
    from repro_torch.plan import KernelConfig
    from repro_torch.serve import Request, ServeEngine

    print("[4] reduced configs in fp32 compute (dense, W8A8, MoE with bf16 "
          "weights and W8A8, SSM and hybrid in fp32 and W8A8, encdec and "
          "vlm with a frontend a request, qwen's QKV bias, mistral's 4 "
          "query heads a kv head): engine greedy tokens, kernels vs "
          f"backend='torch', modes {list(REDUCED_MODES)} (chunked prefill: "
          f"dense and vlm, whose frontend requests are never chunked)",
          flush=True)
    for arch, weights in REDUCED_CASES:
        cfg = get_config(arch, reduced=True)
        model = build_model(cfg)
        params = model.init(seed=0, device="cuda", dtype=torch.bfloat16
                            if weights == "bf16" else torch.float32)
        quant = "int8" if weights == "w8a8" else None
        if quant:
            params = model.quantize_weights(params)
        moe = cfg.family == "moe"
        ssm = cfg.family == "ssm"
        prompts = [np.random.default_rng(i).integers(0, cfg.vocab_size, n)
                   for i, n in enumerate((5, 11, 3, 8))]
        max_new = [6, 3, 5, 7]
        # encdec: each request's source frames, the engine's enc_len; vlm:
        # each request's patch positions
        n_front = (REDUCED_ENC_LEN if cfg.family == "encdec"
                   else cfg.frontend_tokens)
        fronts = [None] * 4
        if n_front:
            g = torch.Generator(device="cuda").manual_seed(11)
            fronts = list(0.1 * torch.randn(4, n_front, cfg.d_model,
                                            generator=g, device="cuda"))
        enc_kw = ({"cache_kwargs": {"enc_len": REDUCED_ENC_LEN}}
                  if cfg.family == "encdec" else {})
        outs, sampled = {}, {}
        for mode, mode_kw in REDUCED_MODES.items():
            if model.prefill_chunk is None and "prefill_chunk" in mode_kw:
                continue
            for backend in ("auto", "torch"):
                for K in (1, 4):
                    before = {n: k.launches for n, k in kern.items()}
                    ctx = Ctx(plan=KernelConfig(backend=backend, quant=quant),
                              dtype=torch.float32)
                    eng = ServeEngine(model, params, ctx, num_slots=2,
                                      max_len=32, steps_per_dispatch=K,
                                      device="cuda", **mode_kw, **enc_kw)
                    res = eng.run([Request(rid=i, prompt=p,
                                           max_new_tokens=m,
                                           frontend_embeds=fronts[i])
                                   for i, (p, m) in enumerate(zip(prompts,
                                                                  max_new))])
                    outs[mode, backend, K] = [res[i].tokens
                                              for i in range(4)]
                    launched = {n for n, k in kern.items()
                                if k.launches > before[n]}
                    want = set()
                    if backend == "auto":
                        want = {"zero_stall_matmul"}
                        if not ssm:       # mamba2 runs no attention
                            want.add("flash_attention")
                        if "page_size" in mode_kw and not ssm:
                            want.add("paged_attention")
                        if quant and not ssm:  # its projections: W8A16
                            want.add("quantized_zero_stall_matmul")
                        if moe:
                            want.add("quantized_grouped_zero_stall_matmul"
                                     if quant else
                                     "grouped_zero_stall_matmul")
                    require(launched == want, f"{arch} {weights} {mode} "
                            f"{backend}: launched {sorted(launched)}, the "
                            f"path implies {sorted(want)}")
                    require(variants(eng) == ["greedy"]
                            and eng.stats.dispatches > 1,
                            f"{arch} {weights} {mode} {backend} K={K}: "
                            f"captures {eng.captures}, not one greedy graph "
                            f"replayed")
                    if ssm and "page_size" in mode_kw:
                        # no leaf grows with max_len: pages degrade to
                        # the contiguous cache, with zero gauges
                        require(not eng._pages_active
                                and eng.stats.pages_in_use == 0
                                and eng.stats.pages_shared == 0,
                                f"{arch} {mode}: page gauges "
                                f"{eng.stats.pages_in_use}, "
                                f"{eng.stats.pages_shared}")
            # sampled: the graph against the eager block, same keys (rids
            # 0 and 2 seeded, 1 and 3 derived from the engine seed)
            for K in (1, 4):
                for eager in (False, True):
                    eng = ServeEngine(
                        model, params, Ctx(plan=KernelConfig(quant=quant),
                                           dtype=torch.float32),
                        num_slots=2, max_len=32, steps_per_dispatch=K,
                        seed=3, device="cuda", **mode_kw, **enc_kw)
                    if eager:
                        # no graph at all: the eager block and prefill
                        eng._capture = lambda greedy_only: None
                        eng._capture_prefill = lambda key: None
                    res = eng.run([Request(rid=i, prompt=p, max_new_tokens=m,
                                           frontend_embeds=fronts[i],
                                           temperature=0.9, top_k=20,
                                           top_p=0.95,
                                           seed=None if i % 2 else 10 + i)
                                   for i, (p, m) in enumerate(zip(prompts,
                                                                  max_new))])
                    sampled[mode, K, eager] = [res[i].tokens
                                               for i in range(4)]
                    require(variants(eng) == ([] if eager else ["sampled"])
                            and bool(prefill_variants(eng)) != eager,
                            f"{arch} {weights} {mode} sampled K={K}: "
                            f"captures {eng.captures}")
                require(sampled[mode, K, False] == sampled[mode, K, True],
                        f"{arch} {weights} {mode} sampled K={K}: graph "
                        f"tokens {sampled[mode, K, False]} differ from the "
                        f"eager block's {sampled[mode, K, True]}")
            require(moe or sampled[mode, 1, False] == sampled[mode, 4, False],
                    f"{arch} {weights} {mode} sampled: K=1 and K=4 differ")
        for (mode, backend, K), toks in outs.items():
            # MoE routing is batch-global: a slot that idles or re-feeds
            # its last token inside a K-step block takes expert capacity,
            # so MoE tokens are held at the same mode and K only
            ref = outs[(mode, "torch", K) if moe else ("contiguous", "torch",
                                                       1)]
            require(toks == ref, f"{arch} {weights} {(mode, backend, K)}: "
                    f"tokens {toks} differ from the plain path's {ref}")
        print(f"    {arch} ({weights} weights): "
              f"{sum(map(len, outs['contiguous', 'torch', 1]))} tokens "
              f"equal on both paths at K=1 and K=4 in {len(outs) // 4} modes"
              + (" (each mode and K against itself)" if moe else "")
              + "; sampled, graphs (decode and prefill) == eager block "
              "and prefill at K=1 and K=4"
              + ("" if moe else ", K=1 == K=4"))


# ----------------------------------------------------------------------
# 5. full-width gemma-7b serving
# ----------------------------------------------------------------------
def reset_counts(kern) -> None:
    """Set every kernel's launch count, and its counts by design, to 0."""
    for k in kern.values():
        k.launches = 0
        for design in getattr(k, "launches_by_design", {}):
            k.launches_by_design[design] = 0


def check_designs(label: str, kern) -> None:
    """Every bf16 matmul (plain and grouped), int8 matmul (plain and
    grouped) and flash call of a full-width run went through the Hopper
    designs: none took the cp.async ring or the CUDA-core flash kernel."""
    designs = {n: kern[n].launches_by_design for n in (
        "zero_stall_matmul", "quantized_zero_stall_matmul",
        "grouped_zero_stall_matmul", "quantized_grouped_zero_stall_matmul",
        "flash_attention")}
    print("      by design: " + ", ".join(f"{n} {d}"
                                          for n, d in designs.items()))
    require(all(d.get("ring", 0) == 0 and d.get("cuda_core", 0) == 0
                for d in designs.values()),
            f"{label}: a matmul or flash call left the Hopper designs")


def serve_full_width(torch, kern):
    zero_stall_matmul = kern["zero_stall_matmul"]
    flash_attention = kern["flash_attention"]
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import make_requests, serve_batch
    from repro_torch.models import Ctx, build_model

    kw = SERVE_KW
    print(f"[5] gemma-7b full width, 28 layers, bf16, random weights: "
          f"serve_batch({kw})", flush=True)
    reset_counts(kern)
    out = serve_batch("gemma-7b", reduced=False, dtype=torch.bfloat16,
                      device="cuda", **kw)
    torch.cuda.synchronize()
    counts = {"zero_stall_matmul": zero_stall_matmul.launches,
              "flash_attention": flash_attention.launches}
    require(all(kern[n].launches == 0 for n in NEW_KERNELS
                + ("paged_attention",)),
            "the contiguous bf16 dense path launched the paged, int8 or "
            "grouped kernels")
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
    check_designs("5", kern)
    print_captures("serve_batch's engine", out["captures"])
    require(variants(out["captures"]) == ["greedy"],
            "5: the engine did not decode through one greedy CUDA graph")
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
    PHASE5["first_logits"] = logits["auto"][0, -1].cpu().numpy()
    del logits
    greedy = serve_block_full_width(torch, kern, model, params, gen)
    PHASE5["tokens"] = greedy
    PHASE5["5t"] = oracle_full_width(torch, kern, model, params, greedy)
    serve_sampled_full_width(torch, kern, model, params, greedy)
    PHASE5["5s"] = prefill_graphs_full_width(torch, kern, model, params,
                                             greedy)
    PHASE5["5p"] = serve_cluster_full_width(torch, kern, model, params,
                                            greedy)
    roofline_of_the_card(torch, model, params)
    del params
    torch.cuda.empty_cache()
    add_counts(PHASE5["5p"], serve_cluster_launcher(torch, kern, greedy))
    return counts


# ----------------------------------------------------------------------
# 5q. the dry run and the roofline on the card's numbers
# ----------------------------------------------------------------------
DRYRUN_CELLS = (("mamba2-130m", "decode_32k", "multi"),
                ("gemma-7b", "train_4k", "single"))
# the compute term against the measured time: the traced products are the
# ones the kernels run, so a share above 1 is a miscount
COMPUTE_SHARE_MAX = 1.05


def dryrun_cells(torch) -> None:
    """5q (a) two dry-run cells through the CLI, in two subprocesses at
    once, and (b) the roofline's constants against the card."""
    import os

    from repro_torch.core.cyclemodel import HopperParams
    from repro_torch.core.roofline import HW
    print(f"[5q] the dry run on the CPU beside the card ({card_line()})",
          flush=True)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               REPRO_TORCH_TUNE_CACHE=str(TUNE_CACHE))
    runs = []
    t0 = time.perf_counter()
    for arch, shape, mesh in DRYRUN_CELLS:
        out = ROOT / "build" / f"chip_smoke_5q_{arch}_{shape}.jsonl"
        out.parent.mkdir(parents=True, exist_ok=True)
        out.unlink(missing_ok=True)
        cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
               arch, "--shape", shape, "--mesh", mesh, "--out", str(out)]
        runs.append((arch, out, subprocess.Popen(
            cmd, cwd=ROOT, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True)))
    for arch, out, proc in runs:
        try:
            stdout, stderr = proc.communicate(timeout=240)
        except subprocess.TimeoutExpired:
            for _, _, p in runs:
                p.kill()
                p.communicate()
            require(False, f"5q (a): the {arch} dry run ran past 240 s")
        require(proc.returncode == 0 and "[OK]" in stdout,
                f"5q (a): the {arch} dry run failed: {stdout[-1000:]} "
                f"{stderr[-2000:]}")
        row = json.loads(out.read_text().splitlines()[0])
        out.unlink()
        print(f"    (a) {row['cell']}: [OK] after "
              f"{time.perf_counter() - t0:.1f} s; {row['chips']} chips, "
              f"{row['hlo_gflops']:.1f} GFLOP, {row['hlo_gbytes']:.1f} GB, "
              f"{row['coll_gbytes']:.1f} GB of collectives; terms on the "
              f"H100's numbers: compute {row['t_compute_s']:.4g} s, memory "
              f"{row['t_memory_s']:.4g} s, collective "
              f"{row['t_collective_s']:.4g} s, bottleneck "
              f"{row['bottleneck']} (op-by-op bytes); per device "
              f"{row['dev_bytes_total']} "
              f"bytes (arguments {row['arg_bytes_dev']}, temp "
              f"{row['temp_bytes_dev']}), fits {row['fits_hbm']}; "
              f"collectives {row['collectives']}; replicated for an op "
              f"{row['redistribute_for_op']}")
        require(row["hlo_gflops"] > 0 and row["dev_bytes_total"] > 0,
                f"5q (a): {row['cell']} counted nothing")
    props = torch.cuda.get_device_properties(0)
    print(f"    (b) HW.hbm_bytes {HW().hbm_bytes}, total_memory "
          f"{props.total_memory}; HopperParams.sms {HopperParams().sms}, "
          f"multi_processor_count {props.multi_processor_count}")
    require(HW().hbm_bytes == props.total_memory,
            "5q (b): roofline.HW.hbm_bytes is not the card's memory")
    require(HopperParams().sms == props.multi_processor_count,
            "5q (b): HopperParams.sms is not the card's SM count")


def roofline_of_the_card(torch, model, params) -> None:
    """5q (c): the trace costs of phase 5's decode step and of one
    128-token prefill pass (the plain path on the meta device, unsharded)
    on the H100's numbers, beside the same work's measured device time."""
    from repro_torch.core.roofline import analyze_trace
    from repro_torch.core.trace_costs import trace_costs
    from repro_torch.launch.serve import make_requests
    from repro_torch.models import Ctx
    kw = SERVE_KW
    slots, max_len = kw["num_slots"], kw["prompt_len"] + kw["gen_len"]
    print(f"[5q] (c) gemma-7b full width, the trace costs against the card "
          f"({card_line()})", flush=True)
    plain = Ctx(plan="torch", dtype=torch.bfloat16)
    meta = model.init(seed=0, dtype=torch.bfloat16, device="meta")
    cache = model.init_cache(slots, max_len, torch.bfloat16, device="meta")
    cache["pos"] = torch.zeros((slots,), dtype=torch.int32, device="meta")
    with torch.no_grad():
        _, decode = trace_costs(
            model.decode, meta, cache,
            torch.zeros((slots, 1), dtype=torch.long, device="meta"), plain)
        batch = {"tokens": torch.zeros((1, kw["prompt_len"]),
                                       dtype=torch.long, device="meta"),
                 "lengths": torch.full((1,), kw["prompt_len"],
                                       dtype=torch.int32, device="meta")}
        _, prefill = trace_costs(model.prefill, meta, batch, plain, max_len)

    # the prefill pass on the card: phase 5's first (128-token) request
    req = make_requests(model.cfg, kw["seed"], kw["batch"], kw["prompt_len"],
                        kw["gen_len"], kw["mixed"])[0]
    require(len(req.prompt) == kw["prompt_len"],
            "5q (c): phase 5's first request is not 128 tokens")
    real = {"tokens": torch.tensor([req.prompt], device="cuda"),
            "lengths": torch.tensor([len(req.prompt)], dtype=torch.int32,
                                    device="cuda")}
    ctx = Ctx(plan="auto", dtype=torch.bfloat16)
    with torch.no_grad():
        for _ in range(2):
            model.prefill(params, real, ctx, max_len)
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        n = 5
        start.record()
        for _ in range(n):
            model.prefill(params, real, ctx, max_len)
        end.record()
        torch.cuda.synchronize()
    measured = {"decode step": sum(PHASE5["step_ms"])
                / len(PHASE5["step_ms"]),
                "prefill pass": start.elapsed_time(end) / n}
    for what, costs in (("decode step", decode), ("prefill pass", prefill)):
        rep = analyze_trace(f"gemma-7b {what}", costs, 1)
        bound_ms = 1e3 * max(rep.t_compute, rep.t_memory)
        ms = measured[what]
        share_c, share_m = 1e3 * rep.t_compute / ms, 1e3 * rep.t_memory / ms
        print(f"    {what}: {costs.flops / 1e9:.2f} GFLOP, "
              f"{costs.bytes / 1e9:.3f} GB op by op; t_compute "
              f"{1e3 * rep.t_compute:.4f} ms, t_memory "
              f"{1e3 * rep.t_memory:.4f} ms, bound {bound_ms:.4f} ms "
              f"({'compute' if rep.t_compute >= rep.t_memory else 'memory'})"
              f"; measured {ms:.4f} ms; shares: compute {share_c:.3f} "
              f"(gate <= {COMPUTE_SHARE_MAX}), memory {share_m:.3f} (not "
              f"gated: the plain path's op-by-op bytes count what flash "
              f"and the fused kernels never move)")
        require(share_c <= COMPUTE_SHARE_MAX,
                f"5q (c): the {what}'s compute term is {share_c:.3f} of "
                f"its measured time")


def engine_for(torch, model, params, ctx, *, K: int, eager: bool = False,
               max_len: int | None = None, **kw):
    """A ``ServeEngine`` with phase 5's slots and length (or ``max_len``)
    on the card; with ``eager`` it never captures the decode block, so
    every dispatch runs the block's eager loop (the engine's private
    hook; no public switch exists)."""
    from repro_torch.serve import ServeEngine
    eng = ServeEngine(model, params, ctx, num_slots=SERVE_KW["num_slots"],
                      max_len=max_len or (SERVE_KW["prompt_len"]
                                          + SERVE_KW["gen_len"]),
                      cache_dtype=torch.bfloat16, steps_per_dispatch=K,
                      seed=SERVE_KW["seed"], device="cuda", **kw)
    if eager:
        eng._capture = lambda greedy_only: None
    return eng


def block_step_ms(torch, eng, n: int = 3, greedy_only: bool = True
                  ) -> dict:
    """ms a decode step of a dispatch of ``eng``'s block (the greedy or
    the sampled variant, with the knobs of the slots' last requests) with
    every slot active, under the block's CUDA graph and as the eager loop
    of the same block (the private ``_block``, which reads the operands
    the graphed dispatch loaded), in turns graph, eager, eager, graph;
    each turn ``n`` dispatches, each ending in the host's read of the
    tile.  The launch counters are left as the served run left them."""
    import numpy as np

    from repro_torch.kernels import launches
    from repro_torch.serve.engine import _host
    before = launches.snapshot()
    S, K = eng.num_slots, eng.steps_per_dispatch
    args = (np.zeros(S, np.int32), np.zeros(S, bool),
            np.full(S, 2 ** 30, np.int32))
    fns = {"graph": lambda: eng._decode_block(*args,
                                              greedy_only=greedy_only),
           "eager": lambda: eng._block(greedy_only)}
    fns["graph"]()
    fns["graph"]()      # captured by now, whatever ran before
    torch.cuda.synchronize()
    times = {"graph": [], "eager": []}
    for how in ("graph", "eager", "eager", "graph"):
        t0 = time.perf_counter()
        for _ in range(n):
            _host(fns[how]())
        times[how].append(1e3 * (time.perf_counter() - t0) / (n * K))
    launches.add(launches.since(before), -1)
    return times


def print_step_ms(label: str, times: dict) -> None:
    g, e = (sum(times[k]) / len(times[k]) for k in ("graph", "eager"))
    print(f"    {label} decode step, all slots active (ms; turns graph, "
          f"eager, eager, graph): CUDA graph "
          f"{' / '.join(f'{t:.3f}' for t in times['graph'])}, eager loop "
          f"{' / '.join(f'{t:.3f}' for t in times['eager'])}: "
          f"{e / g:.2f}x")


def busy_share(torch, eng, times: dict) -> None:
    """The device-busy share of one graphed and one eager dispatch of
    ``eng``'s greedy block: the union of the device events that
    ``torch.profiler`` records over the dispatch (kernels and copies),
    against the dispatch's host time under the profiler and against the
    unprofiled step time of :func:`block_step_ms`.  The launch counters
    are left as the served run left them."""
    import numpy as np

    from repro_torch.kernels import launches
    from repro_torch.serve.engine import _host
    before = launches.snapshot()
    S, K = eng.num_slots, eng.steps_per_dispatch
    args = (np.zeros(S, np.int32), np.zeros(S, bool),
            np.full(S, 2 ** 30, np.int32))
    fns = {"graph": lambda: _host(eng._decode_block(*args,
                                                     greedy_only=True)),
           "eager": lambda: _host(eng._block(True))}
    for how, fn in fns.items():
        fn()
        torch.cuda.synchronize()
        busy, wall_us, top, events = device_busy(torch, fn)
        if not events:
            print(f"    {how} dispatch: the profiler recorded no device "
                  f"event: device-busy share not measured")
            continue
        step_us = 1e3 * K * sum(times[how]) / len(times[how])
        print(f"    {how} dispatch (K={K}) under torch.profiler: {events} "
              f"device events, device busy {busy:.0f} us of {wall_us:.0f} "
              f"us of host time ({busy / wall_us:.1%}); against the "
              f"unprofiled dispatch ({step_us:.0f} us): "
              f"{busy / step_us:.1%} busy, {1 - busy / step_us:.1%} idle")
        print("      most device time: " + "; ".join(
            f"{name[:60]} {us:.0f} us" for name, us in top))
    launches.add(launches.since(before), -1)


def serve_block_full_width(torch, kern, model, params, gen) -> dict:
    """Phase 5's traffic through ``ServeEngine`` on the logits check's
    weights: greedy tokens equal to ``serve_batch``'s (the same weights
    from the same seed), launch counts, then the decode step under the
    graph against the eager loop and the device-busy share."""
    from repro_torch.launch.serve import make_requests
    from repro_torch.models import Ctx
    kw, L = SERVE_KW, GEMMA["layers"]
    reqs = make_requests(model.cfg, kw["seed"], kw["batch"], kw["prompt_len"],
                         kw["gen_len"], kw["mixed"])
    eng = engine_for(torch, model, params,
                     Ctx(plan="auto", dtype=torch.bfloat16),
                     K=kw["steps_per_dispatch"])
    reset_counts(kern)
    res = eng.run(reqs)
    torch.cuda.synchronize()
    s = eng.stats
    got = {n: k.launches for n, k in kern.items()}
    want = {n: 0 for n in kern}
    want.update(zero_stall_matmul=(7 * L + 1) * (s.admitted + s.decode_steps),
                flash_attention=L * s.admitted)
    print(f"    ServeEngine on the same weights: decode {s.decode_tok_s:.1f} "
          f"tok/s over {s.decode_s:.3f} s ({s.decode_steps} steps, "
          f"{s.dispatches} dispatches)")
    check_counts("5 ServeEngine", got, want, f"(7*{L}+1) matmuls per pass "
                 f"over {s.admitted} + {s.decode_steps} passes, {L} flash "
                 f"calls per prefill")
    print_captures("ServeEngine", eng.captures)
    tokens = {i: r.tokens for i, r in res.items()}
    require(all(list(gen[i]) == tokens[i] for i in tokens),
            "5: ServeEngine's tokens differ from serve_batch's on the same "
            "weights")
    times = block_step_ms(torch, eng)
    print_step_ms("5", times)
    PHASE5["step_ms"] = times["graph"]
    busy_share(torch, eng, times)
    del eng, res
    torch.cuda.empty_cache()
    return tokens


def eager_oracle(torch, model, params, ctx, prompts, new: int,
                 max_len: int) -> list[list[int]]:
    """The lock-step oracle's loop, every decode step an eager
    ``Model.decode`` call: one ragged prefill, then ``new - 1`` greedy
    steps."""
    lens = [len(p) for p in prompts]
    toks = torch.zeros((len(prompts), max(lens)), dtype=torch.long)
    for i, p in enumerate(prompts):
        toks[i, :lens[i]] = torch.tensor(p)
    batch = {"tokens": toks.cuda(),
             "lengths": torch.tensor(lens, dtype=torch.int32, device="cuda")}
    logits, cache = model.prefill(params, batch, ctx, max_len)
    tok = torch.argmax(logits[:, -1].float(), dim=-1)
    outs = [[int(t)] for t in tok.tolist()]
    for _ in range(new - 1):
        logits, cache = model.decode(params, cache, tok[:, None], ctx)
        tok = torch.argmax(logits[:, -1].float(), dim=-1)
        for out, t in zip(outs, tok.tolist()):
            out.append(int(t))
    return outs


def oracle_full_width(torch, kern, model, params, greedy: dict) -> dict:
    """5t: ``lockstep_generate`` (its decode a CUDA graph after the first
    step) over the first 4 requests of phase 5's traffic against the
    eager oracle's loop on the same weights: tokens equal, launches the
    path's -> the graphed run's launch counts."""
    from repro_torch.launch.serve import make_requests
    from repro_torch.models import Ctx
    from repro_torch.serve import lockstep_generate
    kw, L, n = SERVE_KW, GEMMA["layers"], 4
    prompts = [r.prompt for r in make_requests(
        model.cfg, kw["seed"], kw["batch"], kw["prompt_len"], kw["gen_len"],
        kw["mixed"])[:n]]
    ctx = Ctx(plan="auto", dtype=torch.bfloat16)
    new, max_len = kw["gen_len"], kw["prompt_len"] + kw["gen_len"]
    print(f"[5t] lockstep_generate on phase 5's weights: the first {n} "
          f"requests, {new} new tokens, its decode graphed against the "
          f"eager oracle", flush=True)
    t0 = time.perf_counter()
    want = eager_oracle(torch, model, params, ctx, prompts, new, max_len)
    t1 = time.perf_counter()
    reset_counts(kern)
    got = lockstep_generate(model, params, ctx, prompts, new,
                            max_len=max_len, device="cuda")
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    counts = {name: k.launches for name, k in kern.items()}
    same = sum(a == b for i in range(n) for a, b in zip(got[i], greedy[i]))
    print(f"    eager oracle {t1 - t0:.3f} s, graphed {t2 - t1:.3f} s (each "
          f"with its prefill; the graphed one with its first step and "
          f"capture); tokens equal: {got == want}; {same} of {n * new} equal "
          f"phase 5's engine's (a batched, padded prefill against the "
          f"engine's batch-1 prefills: bf16 rounding may differ)", flush=True)
    require(got == want, "5t: the graphed oracle's tokens differ from the "
            "eager oracle's")
    want_counts = {name: 0 for name in kern}
    want_counts.update(zero_stall_matmul=(7 * L + 1) * new,
                       flash_attention=L)
    check_counts("5t", counts, want_counts,
                 f"(7*{L}+1) matmuls per pass over a prefill and {new - 1} "
                 f"decode steps, {L} flash calls in the prefill")
    return {name: c for name, c in counts.items() if c}


def serve_sampled_full_width(torch, kern, model, params, greedy: dict
                             ) -> None:
    """5f: phase 5's requests sampled, each with a seed, on phase 5's
    weights: the graph at K = 4 against the eager block at K = 4 and the
    graph at K = 1, token for token."""
    import dataclasses

    from repro_torch.launch.serve import make_requests
    from repro_torch.models import Ctx
    kw, L = SERVE_KW, GEMMA["layers"]
    knobs = dict(temperature=0.8, top_k=50, top_p=0.95)
    reqs = [dataclasses.replace(r, seed=1000 + r.rid) for r in make_requests(
        model.cfg, kw["seed"], kw["batch"], kw["prompt_len"], kw["gen_len"],
        kw["mixed"], **knobs)]
    print(f"[5f] gemma-7b full width, bf16, phase 5's weights and requests "
          f"sampled ({knobs}, seeds 1000 + rid): the graph at K=4 against "
          f"the eager block at K=4 and the graph at K=1", flush=True)
    toks = {}
    for how, K in (("graph", 4), ("eager", 4), ("graph", 1)):
        eng = engine_for(torch, model, params,
                         Ctx(plan="auto", dtype=torch.bfloat16), K=K,
                         eager=how == "eager")
        reset_counts(kern)
        res = eng.run(reqs)
        torch.cuda.synchronize()
        s = eng.stats
        got = {n: k.launches for n, k in kern.items()}
        want = {n: 0 for n in kern}
        want.update(
            zero_stall_matmul=(7 * L + 1) * (s.admitted + s.decode_steps),
            flash_attention=L * s.admitted)
        print(f"    {how} K={K}: prefill {s.prefill_tok_s:.1f} tok/s; "
              f"decode {s.decode_tok_s:.1f} tok/s over {s.decode_s:.3f} s "
              f"({s.decode_steps} steps, {s.dispatches} dispatches)")
        check_counts(f"5f {how} K={K}", got, want, f"(7*{L}+1) matmuls per "
                     f"pass, {L} flash calls per prefill")
        check_designs(f"5f {how} K={K}", kern)
        print_captures(f"{how} K={K}", eng.captures)
        require(variants(eng) == ([] if how == "eager" else ["sampled"]),
                f"5f {how} K={K}: captures {eng.captures}")
        require(sorted(res) == list(range(kw["batch"])) and all(
            len(r.tokens) == kw["gen_len"]
            and all(0 <= t < GEMMA["V"] for t in r.tokens)
            for r in res.values()), f"5f {how}: not every request completed")
        toks[how, K] = {i: r.tokens for i, r in res.items()}
        if how == "graph" and K == 4:
            print_step_ms("5f sampled", block_step_ms(torch, eng,
                                                      greedy_only=False))
        del eng, res
        torch.cuda.empty_cache()
    differ = sum(a != b for i in greedy for a, b in zip(toks["graph", 4][i],
                                                        greedy[i]))
    print(f"    tokens: graph K=4 == eager K=4 "
          f"{toks['graph', 4] == toks['eager', 4]}, == graph K=1 "
          f"{toks['graph', 4] == toks['graph', 1]}; {differ} of "
          f"{kw['batch'] * kw['gen_len']} differ from phase 5's greedy tokens")
    require(toks["graph", 4] == toks["eager", 4],
            "5f: the graph's sampled tokens differ from the eager block's")
    require(toks["graph", 4] == toks["graph", 1],
            "5f: sampled tokens at K=4 differ from K=1's")
    require(differ > 0, "5f: every sampled token is the greedy one")


# ----------------------------------------------------------------------
# 5p. cluster serving: the router, fault-tolerant re-queue, the sharded
# engine and the launcher's cluster flags
# ----------------------------------------------------------------------
# 5p (b) and (d): the router step after which replica 1 is killed
KILL_AT = 2


def add_counts(total: dict, got: dict) -> None:
    for name, n in got.items():
        total[name] = total.get(name, 0) + n


def fleet_want(kern, adm: int, steps: int, *, paged: bool
               ) -> tuple[dict, str]:
    """The launches that ``adm`` admissions and ``steps`` decode steps
    (the merged stats of a contiguous or paged gemma-7b fleet) imply, and
    how."""
    L = GEMMA["layers"]
    want = {n: 0 for n in kern}
    want.update(zero_stall_matmul=(7 * L + 1) * (adm + steps),
                flash_attention=L * adm,
                paged_attention=L * steps if paged else 0)
    return want, (f"(7*{L}+1) matmuls a pass over {adm} admissions + "
                  f"{steps} decode steps of every replica, {L} flash calls a "
                  f"prefill" + (f", {L} paged calls a step" if paged else ""))


def route(router, reqs, *, kill: int | None = None) -> tuple[dict, dict,
                                                             dict]:
    """Drive ``router`` over ``reqs``, streaming every event, and with
    ``kill`` fail that replica after router step ``KILL_AT``.  Returns the
    results, the streamed tokens a request and, with ``kill``, the rids
    in flight on the replica at the kill and the host seconds from the
    kill to each of their results."""
    for r in reqs:
        router.submit(r)
    streamed, info, steps = {}, {}, 0
    while not router.idle:
        for rid, tok in router.step():
            streamed.setdefault(rid, []).append(tok)
        steps += 1
        if kill is not None and steps == KILL_AT:
            info["requeued"] = sorted(router.replicas[kill].inflight)
            info["t_kill"] = time.perf_counter()
            info["done_s"] = {}
            router.kill(kill)
        elif "requeued" in info:
            done = router.results
            for rid in info["requeued"]:
                if rid in done and rid not in info["done_s"]:
                    info["done_s"][rid] = time.perf_counter() - info["t_kill"]
    return router.results, streamed, info


def check_fleet(torch, label: str, kern, router, res, streamed, *,
                paged: bool, want_tokens: dict) -> dict:
    """The checks of one routed run: tokens, a clean stream, one greedy
    CUDA graph a replica, launch counts against the fleet's merged stats
    and, with no replica dead, work on both replicas; prints the fleet's
    tokens/s and each replica's captures.  Returns the launches."""
    torch.cuda.synchronize()
    got = {n: k.launches for n, k in kern.items()}
    s = router.stats()
    tokens = {i: r.tokens for i, r in res.items()}
    placed = collections.Counter(r.replica for r in res.values())
    print(f"    {label}: fleet (EngineStats.merge of {len(router.replicas)} "
          f"replicas) prefill {s.prefill_tok_s:.1f} tok/s over "
          f"{s.prefill_s:.3f} s, decode {s.decode_tok_s:.1f} tok/s over "
          f"{s.decode_s:.3f} s; admitted {s.admitted}, retired {s.retired}; "
          f"dispatches a replica "
          f"{[r.engine.stats.dispatches for r in router.replicas]}; results "
          f"a replica {dict(placed)}; router {router.snapshot()['router']}")
    for rep in router.replicas:
        print_captures(f"  replica {rep.rid}", rep.engine.captures)
        require(variants(rep.engine) == ["greedy"],
                f"{label}: replica {rep.rid} did not decode through one "
                f"greedy CUDA graph")
    want, how = fleet_want(kern, s.admitted, s.decode_steps, paged=paged)
    check_counts(label, got, want, how)
    check_designs(label, kern)
    require(tokens == want_tokens, f"{label}: tokens differ from the "
            f"single engine's")
    require(streamed == tokens, f"{label}: the stream has a duplicate or a "
            f"gap")
    require(router.deaths or {r.replica for r in res.values()} == {0, 1},
            f"{label}: the work did not land on both replicas")
    require(s.retired == SERVE_KW["batch"], f"{label}: {s.retired} retired")
    return got


def serve_cluster_full_width(torch, kern, model, params, greedy: dict
                             ) -> dict:
    """5p (a)-(c) on phase 5's weights and traffic: two contiguous
    replicas behind a ``Router``; two paged replicas with replica 1
    killed after router step 2; ``ShardedEngine`` on a one-device mesh.
    Returns the launches of the three runs."""
    from repro_torch.launch.mesh import make_mesh_compat
    from repro_torch.launch.serve import make_requests
    from repro_torch.models import Ctx
    from repro_torch.serve import Router, ShardedEngine
    kw, V = SERVE_KW, GEMMA["V"]
    ctx = Ctx(plan="auto", dtype=torch.bfloat16)

    def reqs():
        return make_requests(model.cfg, kw["seed"], kw["batch"],
                             kw["prompt_len"], kw["gen_len"], kw["mixed"])

    total: dict = {}
    print(f"[5p] gemma-7b full width, 28 layers, bf16, phase 5's weights and "
          f"traffic ({kw['batch']} requests of {kw['prompt_len']}, "
          f"{kw['prompt_len'] // 2}, {kw['prompt_len'] // 4} and "
          f"{3 * kw['prompt_len'] // 4} prompt tokens, {kw['gen_len']} new "
          f"tokens), {kw['num_slots']} slots a replica, K="
          f"{kw['steps_per_dispatch']}; card {card_line()}", flush=True)
    mem0 = torch.cuda.memory_allocated()

    # (a) two contiguous replicas
    reset_counts(kern)
    t0 = time.perf_counter()
    router = Router([engine_for(torch, model, params, ctx,
                                K=kw["steps_per_dispatch"])
                     for _ in range(2)])
    res, streamed, _ = route(router, reqs())
    torch.cuda.synchronize()
    print(f"    (a) Router over 2 contiguous replicas: {len(res)} requests "
          f"in {time.perf_counter() - t0:.3f} s of wall time")
    add_counts(total, check_fleet(torch, "5p (a)", kern, router, res,
                                  streamed, paged=False, want_tokens=greedy))
    # a replica's executor holds a closure over the router: a cycle, so
    # the fleet's memory goes back only after a collection
    del router, res
    gc.collect()
    torch.cuda.empty_cache()

    # (b) two paged replicas, replica 1 killed after step KILL_AT; the
    # reference is one paged engine on the same weights (paged decode
    # runs kernel 3, so its tokens are held to phase 5's only as printed)
    paged = {"page_size": 16}
    single = engine_for(torch, model, params, ctx,
                        K=kw["steps_per_dispatch"], **paged)
    want_b = {i: r.tokens for i, r in single.run(reqs()).items()}
    del single
    torch.cuda.empty_cache()
    differ = sum(a != b for i in greedy for a, b in zip(want_b[i],
                                                        greedy[i]))
    print(f"    (b) one paged engine (16-token pages): {differ} of "
          f"{kw['batch'] * kw['gen_len']} tokens differ from phase 5's "
          f"contiguous greedy tokens")
    reset_counts(kern)
    t0 = time.perf_counter()
    router = Router([engine_for(torch, model, params, ctx,
                                K=kw["steps_per_dispatch"], **paged)
                     for _ in range(2)])
    res, streamed, info = route(router, reqs(), kill=1)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    mem_alive = torch.cuda.memory_allocated()
    res_alive = torch.cuda.memory_reserved()
    fleet_pools = sum(c["pool_bytes"] for rep in router.replicas
                      for c in rep.engine.captures
                      if c["variant"].startswith("prefill"))
    print(f"    (b) Router over 2 paged replicas, router.kill(1) after step "
          f"{KILL_AT}: {len(res)} requests in {wall:.3f} s of wall time; "
          f"in flight on replica 1 at the kill {info['requeued']}; seconds "
          f"from the kill to each replayed request's result "
          f"{ {r: round(t, 4) for r, t in info['done_s'].items()} } (the "
          f"last {max(info['done_s'].values()):.3f} s)")
    add_counts(total, check_fleet(torch, "5p (b)", kern, router, res,
                                  streamed, paged=True, want_tokens=want_b))
    require(router.deaths == 1 and not router.replicas[1].alive,
            "5p (b): replica 1 is not the one dead replica")
    require(router.requeues == len(info["requeued"]) > 0,
            f"5p (b): {router.requeues} re-queues for "
            f"{len(info['requeued'])} requests in flight at the kill")
    require(all(res[r].replica == 0 for r in info["requeued"]),
            "5p (b): a re-queued request did not finish on replica 0")
    require(router.stats().admitted == kw["batch"] + router.requeues,
            "5p (b): admissions are not the requests plus their replays")
    del router, res
    gc.collect()
    torch.cuda.empty_cache()
    mem_after = torch.cuda.memory_allocated()
    print(f"    memory allocated: {mem0 / 2 ** 30:.3f} GiB before 5p, "
          f"{mem_alive / 2 ** 30:.3f} GiB with (b)'s router (its dead "
          f"replica's cache and graphs included), "
          f"{mem_after / 2 ** 30:.3f} GiB after it is dropped; reserved "
          f"{res_alive / 2 ** 30:.3f} GiB with the router, "
          f"{torch.cuda.memory_reserved() / 2 ** 30:.3f} GiB after; the "
          f"two replicas' prefill graphs' pools "
          f"{fleet_pools / 2 ** 20:.1f} MiB")
    # one replica's page pool alone is 41 pages of 16 rows (300 MiB)
    require(mem_after <= mem0 + 2 ** 26, "5p (b): the dropped fleet left "
            "memory allocated")

    # (c) ShardedEngine on a one-device mesh
    mesh = make_mesh_compat((1, 1), ("data", "model"))
    try:
        ShardedEngine(model, params, ctx, mesh=mesh, max_len=160,
                      page_size=16)
        require(False, "5p (c): ShardedEngine accepted page_size")
    except ValueError as e:
        require("page_size" in str(e), f"5p (c): {e}")
    reset_counts(kern)
    eng = ShardedEngine(model, params, ctx, mesh=mesh,
                        num_slots=kw["num_slots"],
                        max_len=kw["prompt_len"] + kw["gen_len"],
                        cache_dtype=torch.bfloat16,
                        steps_per_dispatch=kw["steps_per_dispatch"],
                        seed=kw["seed"])
    res = eng.run(reqs())
    torch.cuda.synchronize()
    got = {n: k.launches for n, k in kern.items()}
    want, how = fleet_want(kern, eng.stats.admitted,
                           eng.stats.decode_steps, paged=False)
    wq = eng.param_specs["layers"][0]["attn"]["wq"]["w"]
    print(f"    (c) ShardedEngine on {mesh!r}: wq's spec {wq.spec}, the "
          f"cache's k spec {eng.cache_specs['k'].spec}; decode "
          f"{eng.stats.decode_tok_s:.1f} tok/s")
    check_counts("5p (c)", got, want, how)
    print_captures("ShardedEngine", eng.captures)
    require({i: r.tokens for i, r in res.items()} == greedy,
            "5p (c): ShardedEngine's tokens differ from phase 5's")
    add_counts(total, got)
    del eng, res
    torch.cuda.empty_cache()
    return total


def serve_cluster_launcher(torch, kern, greedy: dict) -> dict:
    """5p (d): ``serve_batch`` with two replicas, replica 1 killed after
    router step 2, each engine a ``ShardedEngine`` on a 1x1 mesh (weights
    drawn anew from phase 5's seed), then the launcher's CLI with
    ``--replicas 2 --kill-replica 1 --metrics`` in a subprocess.  Returns
    the in-process run's launches."""
    import os

    from repro_torch.launch.serve import serve_batch
    kw = SERVE_KW
    reset_counts(kern)
    t0 = time.perf_counter()
    out = serve_batch("gemma-7b", reduced=False, dtype=torch.bfloat16,
                      device="cuda", replicas=2, kill_replica=1,
                      kill_at_step=KILL_AT, mesh="1x1", **kw)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    got = {n: k.launches for n, k in kern.items()}
    c, s = out["cluster"], out["stats"]
    print(f"    (d) serve_batch(replicas=2, kill_replica=1, kill_at_step="
          f"{KILL_AT}, mesh='1x1') in {wall:.3f} s (weights drawn anew "
          f"included): cluster {c}; fleet prefill "
          f"{out['prefill_tok_s']:.1f} tok/s, decode "
          f"{out['decode_tok_s']:.1f} tok/s")
    print("    (d) captures: " + "; ".join(
        f"replica {cap['replica']} {cap['variant']}, pool "
        f"{cap['pool_bytes'] / 2 ** 20:.1f} MiB" for cap in out["captures"]))
    want, how = fleet_want(kern, s["admitted"], s["decode_steps"],
                           paged=False)
    check_counts("5p (d)", got, want, how)
    require(c["deaths"] == 1 and c["alive"] == 1 and c["requeues"] > 0,
            f"5p (d): cluster {c}")
    gen = out["generated"]
    require({i: list(gen[i]) for i in greedy} == greedy,
            "5p (d): serve_batch's routed tokens differ from phase 5's")
    del out
    gc.collect()
    torch.cuda.empty_cache()

    cmd = [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
           "gemma-7b", "--no-reduced", "--dtype", "bfloat16", "--batch",
           str(kw["batch"]), "--prompt-len", str(kw["prompt_len"]),
           "--gen-len", str(kw["gen_len"]), "--mixed", "--num-slots",
           str(kw["num_slots"]), "--steps-per-dispatch",
           str(kw["steps_per_dispatch"]), "--replicas", "2",
           "--kill-replica", "1", "--metrics"]
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               REPRO_TORCH_TUNE_CACHE=str(TUNE_CACHE))
    t0 = time.perf_counter()
    run = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True,
                         text=True, timeout=300)
    lines = run.stdout.splitlines()
    print(f"    (d) python -m repro_torch.launch.serve ... --replicas 2 "
          f"--kill-replica 1 --metrics: exit {run.returncode} after "
          f"{time.perf_counter() - t0:.1f} s")
    require(run.returncode == 0, f"5p (d): the launcher failed: "
            f"{run.stderr[-2000:]}")
    head = lines.index("op,M,N,K,dtype,backend,config,count,predicted_util")
    for ln in lines[:head + 1]:
        print(f"      {ln}")
    rows = [ln.split(",") for ln in lines[head + 1:] if ln.count(",") == 8]
    ops_seen = {(r[0], r[5]) for r in rows}
    print(f"      ... {len(rows)} utilization rows in all, (op, backend) "
          f"{sorted(ops_seen)}")
    cluster = [ln for ln in lines if ln.startswith("cluster:")]
    require(cluster and "deaths: 1" in cluster[0], "5p (d): no cluster line "
            "with one death")
    require({("matmul", "auto"), ("attention", "auto")} <= ops_seen,
            "5p (d): the utilization table does not name the matmul and "
            "flash-attention kernels")
    return got


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
        reset_counts(kern)
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
                else 0, **{n: 0 for n in NEW_KERNELS}}
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
        print_captures(mode, eng.captures)
        require(variants(eng) == ["greedy"],
                f"{mode}: the engine did not decode through one greedy "
                f"CUDA graph")
        check_designs(f"5b {mode}", kern)
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
    chunk_graphs_full_width(torch, kern, model, params, ctx, reqs, base,
                            chunk, ps)

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
        pre[mode] = prefill_recorder(eng)["logits"]
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
    first_pre = torch.cat([pre["paged"][i][:, -1] for i in range(n)])
    want_pre = torch.cat([pre["contiguous"][i][:, -1] for i in range(n)])
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


# ----------------------------------------------------------------------
# 5s. prefill as compiled programs: one CUDA graph a prompt bucket and
# frontend shape, one a chunk shape
# ----------------------------------------------------------------------
GEMMA_CONTEXT = 8192        # gemma-7b's published context length
def eager_prefill(eng):
    """``eng`` with the private hook stubbed: no prefill or chunk program
    is ever captured, so every one runs eagerly (no public switch)."""
    eng._capture_prefill = lambda key: None
    return eng


def prefill_recorder(eng) -> dict:
    """Have ``eng`` keep, by request id, each admission's first-prefill
    logits and its batch-1 cache as installed: the ``k`` and ``v`` rows
    up to ``pos`` and ``pos`` itself."""
    rec = {"logits": {}, "rows": {}}
    install, first_token = eng._install, eng._first_token

    def installing(req, slot, cache1, n_prompt):
        rec["rows"][req.rid] = {n: cache1[n][:, :, :n_prompt].clone()
                                for n in ("k", "v")}
        rec["rows"][req.rid]["pos"] = cache1["pos"].clone()
        return install(req, slot, cache1, n_prompt)

    def sampling(req, slot, logits):
        rec["logits"][req.rid] = logits.clone()
        return first_token(req, slot, logits)

    eng._install, eng._first_token = installing, sampling
    return rec


def same_prefills(torch, label: str, got: dict, want: dict,
                  rows: bool = True) -> None:
    """Two recorders' logits (and cache rows) bit-equal, request by
    request; the largest difference printed where they are not."""
    bad = []
    for rid, lg in want["logits"].items():
        if not torch.equal(got["logits"][rid], lg):
            bad.append(f"request {rid} logits, max |diff| "
                       f"{(got['logits'][rid] - lg).abs().max().item():.4g}")
        for name, t in (want["rows"][rid].items() if rows else ()):
            if not torch.equal(got["rows"][rid][name], t):
                bad.append(f"request {rid} cache {name}")
    print(f"    {label}: {len(want['logits'])} requests' first-prefill "
          f"logits" + (" and cache rows up to pos" if rows else "")
          + (" bit-equal" if not bad else f" DIFFER: {bad}"))
    require(not bad and got["logits"].keys() == want["logits"].keys(),
            f"{label}: graphed and eager prefill differ: {bad}")


def prefill_passes(eng, reqs, bucket: int) -> dict:
    """The graphed and the eager prefill pass of ``eng`` at ``bucket``, on
    the first of ``reqs`` whose prompt fills it, each ended by the host's
    read of its logits."""
    from repro_torch.serve.engine import _host
    req = next(r for r in reqs if len(r.prompt) == bucket)
    key = eng._load_prefill(req)
    graph, (logits, _) = eng._pf_graphs[key][:2]
    return {"graph": lambda: (graph.replay(), _host(logits)),
            "eager": lambda: _host(eng._prefill_program(key)[0])}


def prefill_pass_ms(torch, eng, reqs, n: int = 3) -> dict:
    """ms of one prefill pass of ``eng`` at each bucket that a prompt of
    ``reqs`` fills, the graph's replay against the eager body, in turns
    graph, eager, eager, graph of ``n`` passes (:func:`prefill_passes`);
    then the device-busy share of a graphed and an eager pass at the
    largest of them.  The launch counters are left as they were."""
    from repro_torch.kernels import launches
    before = launches.snapshot()
    out = {}
    for b in sorted({len(r.prompt) for r in reqs
                     if eng._bucket(len(r.prompt), eng.max_len)
                     == len(r.prompt)}):
        fns = prefill_passes(eng, reqs, b)
        for fn in fns.values():
            fn()
        torch.cuda.synchronize()
        times = {"graph": [], "eager": []}
        for how in ("graph", "eager", "eager", "graph"):
            t0 = time.perf_counter()
            for _ in range(n):
                fns[how]()
            times[how].append(1e3 * (time.perf_counter() - t0) / n)
        out[b] = times
        g, e = (sum(times[k]) / 2 for k in ("graph", "eager"))
        print(f"    prefill pass at bucket {b} (ms; turns graph, eager, "
              f"eager, graph): graph "
              f"{' / '.join(f'{t:.3f}' for t in times['graph'])}, eager "
              f"{' / '.join(f'{t:.3f}' for t in times['eager'])}: "
              f"{e / g:.2f}x")
    top = max(out)
    for how, fn in prefill_passes(eng, reqs, top).items():
        busy, wall_us, names, events = device_busy(torch, fn)
        if not events:
            print(f"    {how} {top}-token pass: the profiler recorded no "
                  f"device event: device-busy share not measured")
            continue
        pass_us = 1e3 * sum(out[top][how]) / 2
        print(f"    {how} {top}-token pass under torch.profiler: {events} "
              f"device events, device busy {busy:.0f} us of {wall_us:.0f} "
              f"us of host time ({busy / wall_us:.1%}); against the "
              f"unprofiled pass ({pass_us:.0f} us): {busy / pass_us:.1%} "
              f"busy, {1 - busy / pass_us:.1%} idle")
        print("      most device time: " + "; ".join(
            f"{name[:60]} {us:.0f} us" for name, us in names))
    launches.add(launches.since(before), -1)
    return out


def prefill_graphs_full_width(torch, kern, model, params, greedy: dict
                              ) -> dict:
    """5s (a): phase 5's traffic through ``ServeEngine`` on phase 5's
    weights, prefilling through its graphs (one a prompt bucket) and
    then eagerly (the private hook stubbed): each request's first-prefill
    logits and cache rows up to ``pos`` bit-equal, the greedy tokens
    equal to each other and to phase 5's, the launches the path's; then
    :func:`prefill_pass_ms`.  Returns the graphed run's launch counts
    (this slice's path, its counts set to 0 just before it)."""
    from repro_torch.launch.serve import make_requests
    from repro_torch.models import Ctx
    kw, L = SERVE_KW, GEMMA["layers"]
    print("[5s] prefill as compiled programs, gemma-7b full width bf16 on "
          "phase 5's weights and traffic: (a) ServeEngine prefilling "
          "through one CUDA graph a prompt bucket, then eagerly",
          flush=True)
    ctx = Ctx(plan="auto", dtype=torch.bfloat16)
    runs, engines = {}, {}
    for how in ("graph", "eager"):
        reqs = make_requests(model.cfg, kw["seed"], kw["batch"],
                             kw["prompt_len"], kw["gen_len"], kw["mixed"])
        eng = engine_for(torch, model, params, ctx,
                         K=kw["steps_per_dispatch"])
        if how == "eager":
            eager_prefill(eng)
        rec = prefill_recorder(eng)
        reset_counts(kern)
        t0 = time.perf_counter()
        res = eng.run(reqs)
        torch.cuda.synchronize()
        t_run = time.perf_counter() - t0
        s = eng.stats
        got = {n: k.launches for n, k in kern.items()}
        want = {n: 0 for n in kern}
        want.update(
            zero_stall_matmul=(7 * L + 1) * (s.admitted + s.decode_steps),
            flash_attention=L * s.admitted)
        print(f"    {how} prefill: prefill {s.prefill_tok_s:.1f} tok/s over "
              f"{s.prefill_s:.3f} s ({s.admitted} admissions); decode "
              f"{s.decode_tok_s:.1f} tok/s over {s.decode_s:.3f} s; run "
              f"{t_run:.3f} s")
        check_counts(f"5s (a) {how}", got, want, f"(7*{L}+1) matmuls per "
                     f"pass over {s.admitted} + {s.decode_steps} passes, "
                     f"{L} flash calls per prefill")
        print_captures(f"5s (a) {how}", eng.captures)
        runs[how] = {"tokens": {i: r.tokens for i, r in res.items()},
                     "rec": rec, "launches": got}
        engines[how] = eng
    buckets = sorted({eng._bucket(n, eng.max_len)
                      for n in (len(r.prompt) for r in reqs)})
    pf = prefill_variants(engines["graph"])
    require(sorted(pf) == sorted(f"prefill:{b}" for b in buckets)
            and len(engines["graph"]._pf_graphs) == len(buckets),
            f"5s (a): prefill graphs {pf}, one a bucket of {buckets} "
            f"expected")
    require(not prefill_variants(engines["eager"]),
            "5s (a): the eager engine captured a prefill")
    same_prefills(torch, "5s (a) graph against eager",
                  runs["graph"]["rec"], runs["eager"]["rec"])
    n_tok = sum(map(len, runs["eager"]["tokens"].values()))
    require(runs["graph"]["tokens"] == runs["eager"]["tokens"] == greedy,
            "5s (a): graphed prefill's tokens differ from eager prefill's "
            "or phase 5's")
    print(f"    5s (a): all {n_tok} greedy tokens equal (graph, eager, "
          f"phase 5); {len(buckets)} prefill graphs for "
          f"{len(runs['graph']['rec']['logits'])} admissions")
    launched = runs["graph"]["launches"]
    del engines["eager"], runs
    prefill_pass_ms(torch, engines["graph"], reqs)
    del engines
    torch.cuda.empty_cache()
    prefill_memory_at_context(torch, model, params)
    return launched


def prefill_memory_at_context(torch, model, params) -> None:
    """5s (a), memory: a one-slot bf16 ``ServeEngine`` at gemma-7b's
    8192-token context admits one prompt at each of its buckets (8 to
    8192, random tokens from seed 0), each admission's first use eager
    and then its capture.  Prints each capture's pool and the memory
    allocated and reserved; requires the allocated growth after the
    first capture to stay under one batch-1 cache (the graphs write the
    engine's one buffer: a graph that held a cache of its own would add
    one a bucket) and everything to go back when the engine is dropped.
    The launch counters are left as they were."""
    import numpy as np

    from repro_torch.kernels import launches
    from repro_torch.models import Ctx
    from repro_torch.serve import Request, ServeEngine
    gc.collect()
    torch.cuda.empty_cache()
    before = launches.snapshot()
    mem0 = torch.cuda.memory_allocated()
    res0 = torch.cuda.memory_reserved()
    eng = ServeEngine(model, params, Ctx(plan="auto", dtype=torch.bfloat16),
                      num_slots=1, max_len=GEMMA_CONTEXT,
                      cache_dtype=torch.bfloat16, device="cuda")
    one = sum(t.numel() * t.element_size()
              for t in eng._batch1(torch.bfloat16).values())
    rng = np.random.default_rng(0)
    t0 = time.perf_counter()
    mem = []
    for i, b in enumerate(eng.bucket_sizes):
        prompt = [int(t) for t in rng.integers(1, GEMMA["V"], b)]
        eng._admit(Request(rid=i, prompt=prompt, max_new_tokens=1), 0)
        torch.cuda.synchronize()
        mem.append(torch.cuda.memory_allocated())
    wall = time.perf_counter() - t0
    res1 = torch.cuda.memory_reserved()
    pools = sum(c["pool_bytes"] for c in eng.captures)
    print_captures(f"5s (a) memory at a {GEMMA_CONTEXT}-token context",
                   eng.captures)
    grow = mem[-1] - mem[0]
    print(f"    5s (a) memory at a {GEMMA_CONTEXT}-token context: "
          f"{len(eng.captures)} prefill graphs (buckets "
          f"{list(eng.bucket_sizes)}) in {wall:.3f} s; one batch-1 cache "
          f"{one / 2 ** 30:.3f} GiB; allocated {mem0 / 2 ** 30:.3f} GiB "
          f"before the engine, {mem[0] / 2 ** 30:.3f} GiB after the first "
          f"capture, {mem[-1] / 2 ** 30:.3f} GiB after the last (+"
          f"{grow / 2 ** 20:.1f} MiB); reserved {res0 / 2 ** 30:.3f} -> "
          f"{res1 / 2 ** 30:.3f} GiB, the graphs' pool "
          f"{pools / 2 ** 30:.3f} GiB")
    require(prefill_variants(eng) == [f"prefill:{b}"
                                      for b in eng.bucket_sizes],
            f"5s (a) memory: captures {prefill_variants(eng)}")
    require(grow < one, "5s (a) memory: the prefill graphs hold a cache "
            "each")
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    mem_after = torch.cuda.memory_allocated()
    print(f"    5s (a) memory: {mem_after / 2 ** 30:.3f} GiB allocated "
          f"after the engine is dropped, reserved "
          f"{torch.cuda.memory_reserved() / 2 ** 30:.3f} GiB")
    require(mem_after <= mem0 + 2 ** 26, "5s (a) memory: the dropped "
            "engine left memory allocated")
    launches.add(launches.since(before), -1)


def chunk_graphs_full_width(torch, kern, model, params, ctx, reqs, base: dict,
                            chunk: int, ps: int) -> None:
    """5s (b): 5b's traffic with ``prefill_chunk`` contiguous and paged,
    chunks through one graph against eager chunks (the private hook
    stubbed): at least two chunked admissions in flight at once, the
    stripe handed between them,
    each request's first-prefill logits bit-equal, the tokens and the
    chunk and launch counts equal."""
    from repro_torch.serve import ServeEngine
    print(f"    5s (b) chunked prefill through CUDA graphs, {chunk}-token "
          f"chunks, on 5b's weights and traffic: contiguous and paged "
          f"(page_size {ps}), graph against eager", flush=True)
    for mode, mode_kw in (("contiguous", {}), ("paged", {"page_size": ps})):
        runs = {}
        for how in ("graph", "eager"):
            eng = ServeEngine(model, params, ctx, **base, **mode_kw,
                              prefill_chunk=chunk)
            if how == "eager":
                eager_prefill(eng)
            rec = prefill_recorder(eng)
            in_flight, handoffs = [], []
            advance, take = eng._advance_chunk, eng._take_stripe

            def counting(slot, eng=eng, advance=advance):
                in_flight.append(len(eng._chunking))
                return advance(slot)

            def taking(slot, eng=eng, take=take):
                if None not in (eng._stripe_slot, slot) \
                        and eng._stripe_slot != slot:
                    handoffs.append(slot)
                return take(slot)

            eng._advance_chunk, eng._take_stripe = counting, taking
            reset_counts(kern)
            res = eng.run(reqs)
            torch.cuda.synchronize()
            runs[how] = {"tokens": {i: r.tokens for i, r in res.items()},
                         "rec": rec, "chunks": eng.stats.prefill_chunks,
                         "launches": {n: k.launches
                                      for n, k in kern.items()},
                         "in_flight": max(in_flight, default=0),
                         "handoffs": len(handoffs),
                         "captures": eng.captures}
            print(f"      {mode} {how}: {eng.stats.prefill_chunks} chunks, "
                  f"at most {runs[how]['in_flight']} chunked admissions in "
                  f"flight, the stripe handed between them "
                  f"{len(handoffs)} times, prefill "
                  f"{eng.stats.prefill_tok_s:.1f} tok/s, launches "
                  f"{runs[how]['launches']}")
            print_captures(f"5s (b) {mode} {how}", eng.captures)
            del eng, res
        g, e = runs["graph"], runs["eager"]
        chunk_graphs = [c["variant"] for c in g["captures"]
                        if c["variant"].startswith("prefill_chunk")]
        require(e["in_flight"] >= 2 and g["in_flight"] >= 2,
                f"5s (b) {mode}: fewer than two chunked admissions in "
                f"flight at once")
        require(g["chunks"] == e["chunks"] > 0 and g["launches"]
                == e["launches"], f"5s (b) {mode}: chunk counts "
                f"{g['chunks']} / {e['chunks']} or launches differ")
        require(chunk_graphs == [f"prefill_chunk:{chunk}"]
                and g["handoffs"] > 0
                and not any(c["variant"].startswith("prefill")
                            for c in e["captures"]),
                f"5s (b) {mode}: chunk graphs {chunk_graphs}, the stripe "
                f"handed over {g['handoffs']} times")
        same_prefills(torch, f"5s (b) {mode} graph against eager chunks",
                      g["rec"], e["rec"])
        require(g["tokens"] == e["tokens"], f"5s (b) {mode}: graphed "
                f"chunks' tokens differ from eager chunks'")
        print(f"      5s (b) {mode}: tokens equal, {g['chunks']} chunks "
              f"each, one chunk graph")
    torch.cuda.empty_cache()


def prefill_graph_vs_eager(torch, label: str, model, params, ctx) -> None:
    """5s (c): the first request of phase 5's traffic (its frontend
    included) through a one-slot ``ServeEngine`` on the phase's weights:
    its prefill program's first use runs eagerly and captures the graph,
    the next use replays it, and the eager body runs once more; the
    three give the same logits bit for bit.  The launch counters are
    left as they were."""
    from repro_torch.kernels import launches
    from repro_torch.launch.serve import frontend_len, make_requests
    from repro_torch.serve import ServeEngine
    cfg = model.cfg
    req = make_requests(cfg, 0, 8, 128, 32, True, device="cuda",
                        dtype=torch.bfloat16)[0]
    kw, max_len = {}, 160
    if cfg.family == "encdec":
        kw["cache_kwargs"] = {"enc_len": int(req.frontend_embeds.shape[0])}
    else:
        max_len += frontend_len(cfg, 128)
    eng = ServeEngine(model, params, ctx, num_slots=1, max_len=max_len,
                      cache_dtype=torch.bfloat16, device="cuda", **kw)
    before = launches.snapshot()
    key = eng._load_prefill(req)

    def program():
        logits, _ = eng._run(eng._pf_graphs, key,
                             lambda: eng._prefill_program(key),
                             eng._capture_prefill)
        return logits.clone()

    first = program()
    graph = program()
    eager = eng._prefill_program(key)[0].clone()
    torch.cuda.synchronize()
    launches.add(launches.since(before), -1)
    err = (graph - eager).abs().max().item()
    cap = eng.captures[-1]
    print(f"    5s (c) {label}: first-prefill logits {tuple(graph.shape)}, "
          f"the graph's replay against the eager body: bit-equal "
          f"{torch.equal(graph, eager)} (max |diff| {err:.4g}); the first "
          f"(eager) use {torch.equal(first, eager)}; {cap['variant']} "
          f"captured in {1e3 * cap['capture_s']:.1f} ms, pool "
          f"{cap['pool_bytes'] / 2 ** 20:.1f} MiB")
    require(prefill_variants(eng) == [cap["variant"]]
            and torch.equal(graph, eager) and torch.equal(first, eager),
            f"5s (c) {label}: the prefill graph's logits differ from the "
            f"eager prefill's")
    del eng
    torch.cuda.empty_cache()


# ----------------------------------------------------------------------
# 5c-5e. full-width olmoe-1b-7b (bf16, W8A8) and gemma-7b (W8A8)
# ----------------------------------------------------------------------
def first_prefill_logits(torch, model, params, ctxs: dict) -> dict:
    """The first request of phase 5's traffic, its frontend included,
    prefilled alone at the engine's 128-token bucket (max_len 160, plus a
    vlm prefix) under each of ``ctxs``: {name: (1, 1, V) fp32 logits}."""
    from repro_torch.launch.serve import frontend_len, make_requests
    cfg = model.cfg
    req = make_requests(cfg, 0, 8, 128, 32, True, device="cuda",
                        dtype=torch.bfloat16)[0]
    batch = {"tokens": torch.tensor([req.prompt], device="cuda"),
             "lengths": torch.tensor([len(req.prompt)], dtype=torch.int32,
                                     device="cuda")}
    if req.frontend_embeds is not None:
        batch["frontend_embeds"] = req.frontend_embeds[None]
    max_len = 160 + (0 if cfg.family == "encdec" else frontend_len(cfg, 128))
    return {name: model.prefill(params, batch, ctx, max_len)[0].float()
            for name, ctx in ctxs.items()}


def judge_logits(torch, what: str, got, want) -> float:
    """Full-width logits: within 5% of the largest plain magnitude (bf16
    rounding, and W8A8 codes and expert choices that the rounding can
    move, through every layer)."""
    require(bool(torch.isfinite(got).all()), f"{what}: non-finite logits")
    err = (got - want).abs().max().item()
    scale = want.abs().max().item()
    print(f"    {what}: max|kernels - plain| {err:.4g}, max|plain| "
          f"{scale:.4g} (tol 0.05 * max|plain| = {0.05 * scale:.4g})")
    require(err <= 0.05 * scale, f"{what}: logits disagree")
    return err


def serve_w8a8(torch, kern, model, qparams, label: str) -> tuple[dict, dict]:
    """Phase 5's traffic through ``ServeEngine`` on W8A8 params: (launch
    counts, stats snapshot), the counts set to 0 just before."""
    from repro_torch.launch.serve import make_requests
    from repro_torch.models import Ctx
    from repro_torch.plan import KernelConfig
    from repro_torch.serve import ServeEngine
    kw = SERVE_KW
    reqs = make_requests(model.cfg, kw["seed"], kw["batch"], kw["prompt_len"],
                         kw["gen_len"], kw["mixed"])
    eng = ServeEngine(model, qparams, Ctx(plan=KernelConfig(quant="int8"),
                                          dtype=torch.bfloat16),
                      num_slots=kw["num_slots"],
                      max_len=kw["prompt_len"] + kw["gen_len"],
                      cache_dtype=torch.bfloat16,
                      steps_per_dispatch=kw["steps_per_dispatch"],
                      seed=kw["seed"], device="cuda")
    reset_counts(kern)
    res = eng.run(reqs)
    torch.cuda.synchronize()
    counts = {n: k.launches for n, k in kern.items()}
    check_designs(label, kern)
    s = eng.stats
    require(sorted(res) == list(range(kw["batch"])) and all(
        len(r.tokens) == kw["gen_len"]
        and all(0 <= t < model.cfg.vocab_size for t in r.tokens)
        for r in res.values()), f"{label}: not every request completed")
    print(f"    {label}: prefill {s.prefill_tok_s:.1f} tok/s over "
          f"{s.prefill_s:.3f} s; decode {s.decode_tok_s:.1f} tok/s over "
          f"{s.decode_s:.3f} s ({s.decode_steps} steps, {s.dispatches} "
          f"dispatches, {s.admitted} admissions)")
    print_captures(label, eng.captures)
    require(variants(eng) == ["greedy"], f"{label}: the engine did not "
            f"decode through one greedy CUDA graph")
    snap = s.snapshot()
    snap["step_ms"] = block_step_ms(torch, eng)
    del eng, res
    torch.cuda.empty_cache()
    return counts, snap


def check_counts(label: str, got: dict, want: dict, derivation: str) -> None:
    print(f"    {label} launches {got}")
    print(f"      path implies {want}: {derivation}")
    require(got == want, f"{label}: launch counts differ from the path's")


def serve_moe_full_width(torch, kern) -> dict:
    """5c (bf16 through serve_batch) and 5d (W8A8 through ServeEngine) on
    one set of olmoe-1b-7b weights; returns the launch counts of the
    grouped kernels (5c's bf16, 5d's int8)."""
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import serve_batch
    from repro_torch.models import Ctx, build_model
    from repro_torch.plan import KernelConfig

    L, V = OLMOE["layers"], OLMOE["V"]
    print(f"[5c] olmoe-1b-7b full width, {L} layers, 64 experts top-8, bf16, "
          f"random weights: serve_batch({SERVE_KW})", flush=True)
    reset_counts(kern)
    out = serve_batch("olmoe-1b-7b", reduced=False, dtype=torch.bfloat16,
                      device="cuda", **SERVE_KW)
    torch.cuda.synchronize()
    got = {n: k.launches for n, k in kern.items()}
    check_designs("5c", kern)
    print_captures("serve_batch's engine", out["captures"])
    require(variants(out["captures"]) == ["greedy"],
            "5c: the engine did not decode through one greedy CUDA graph")
    s = out["stats"]
    passes = s["admitted"] + s["decode_steps"]
    print(f"    prefill {out['prefill_tok_s']:.1f} tok/s over "
          f"{out['prefill_s']:.3f} s; decode {out['decode_tok_s']:.1f} tok/s "
          f"over {out['decode_s']:.3f} s ({s['decode_steps']} steps, "
          f"{s['dispatches']} dispatches, {s['admitted']} admissions)")
    want = {n: 0 for n in kern}
    want.update(zero_stall_matmul=(4 * L + 1) * passes,
                grouped_zero_stall_matmul=3 * L * passes,
                flash_attention=L * s["admitted"])
    check_counts("5c", got, want, f"per pass (each prefill and decode "
                 f"step) 4 projections (wq, wk, wv, wo) x {L} layers + the "
                 f"LM head = {4 * L + 1} matmuls and 3 expert banks (wi, "
                 f"wg, wo) x {L} = {3 * L} grouped matmuls, over "
                 f"{s['admitted']} + {s['decode_steps']} passes; {L} flash "
                 f"calls per prefill")
    gen = out["generated"]
    require(gen.shape == (8, 32) and (gen >= 0).all() and (gen < V).all(),
            "5c: not every request completed")
    counts = {"grouped_zero_stall_matmul": got["grouped_zero_stall_matmul"]}
    del out
    torch.cuda.empty_cache()

    cfg = get_config("olmoe-1b-7b")
    model = build_model(cfg)
    params = model.init(seed=0, dtype=torch.bfloat16, device="cuda")
    bf16 = first_prefill_logits(torch, model, params, {
        "auto": Ctx(plan="auto", dtype=torch.bfloat16),
        "torch": Ctx(plan="torch", dtype=torch.bfloat16)})
    judge_logits(torch, f"5c first prefill logits (1, 1, {V})",
                 bf16["auto"], bf16["torch"])
    prefill_graph_vs_eager(torch, "olmoe-1b-7b bf16", model, params,
                           Ctx(plan="auto", dtype=torch.bfloat16))

    torch.cuda.reset_peak_memory_stats()
    qparams = model.quantize_weights(params)
    del params
    torch.cuda.empty_cache()
    print(f"[5d] olmoe-1b-7b full width, W8A8 (int8 projections and expert "
          f"banks, bf16 LM head) quantized from the same weights: "
          f"ServeEngine with KernelConfig(quant='int8'), the traffic of 5c; "
          f"peak while quantizing "
          f"{torch.cuda.max_memory_allocated() / 2 ** 30:.1f} GiB, after "
          f"{torch.cuda.memory_allocated() / 2 ** 30:.1f} GiB", flush=True)
    got, s = serve_w8a8(torch, kern, model, qparams, "5d")
    print_step_ms("5d", s["step_ms"])
    passes = s["admitted"] + s["decode_steps"]
    want = {n: 0 for n in kern}
    want.update(quantized_zero_stall_matmul=4 * L * passes,
                zero_stall_matmul=passes,
                quantized_grouped_zero_stall_matmul=3 * L * passes,
                flash_attention=L * s["admitted"])
    check_counts("5d", got, want, f"per pass {4 * L} int8 projections, "
                 f"1 bf16 LM head and {3 * L} int8 expert banks, over "
                 f"{s['admitted']} + {s['decode_steps']} passes")
    counts["quantized_grouped_zero_stall_matmul"] = \
        got["quantized_grouped_zero_stall_matmul"]
    counts["quantized_grouped_by_design"] = dict(
        kern["quantized_grouped_zero_stall_matmul"].launches_by_design)
    w8a8 = first_prefill_logits(torch, model, qparams, {
        "auto": Ctx(plan=KernelConfig(quant="int8"), dtype=torch.bfloat16),
        "torch": Ctx(plan=KernelConfig(backend="torch", quant="int8"),
                     dtype=torch.bfloat16)})
    judge_logits(torch, f"5d first prefill logits (1, 1, {V})",
                 w8a8["auto"], w8a8["torch"])
    prefill_graph_vs_eager(torch, "olmoe-1b-7b W8A8", model, qparams,
                           Ctx(plan=KernelConfig(quant="int8"),
                               dtype=torch.bfloat16))
    dist = (w8a8["auto"] - bf16["auto"]).abs().max().item()
    scale = bf16["auto"].abs().max().item()
    print(f"    5d W8A8 logits against 5c's bf16 logits (kernel paths; "
          f"reported, not gated): max|W8A8 - bf16| {dist:.4g}, "
          f"max|bf16| {scale:.4g} ({dist / scale:.3%}); same argmax "
          f"{bool(w8a8['auto'].argmax() == bf16['auto'].argmax())}")
    del qparams, bf16, w8a8
    torch.cuda.empty_cache()
    return counts


def serve_gemma_w8a8(torch, kern) -> int:
    """5e: full-width gemma-7b W8A8 with phase 5's traffic; returns the
    launches of kernel 4."""
    from repro_torch.configs import get_config
    from repro_torch.models import Ctx, build_model
    from repro_torch.plan import KernelConfig

    L, V = GEMMA["layers"], GEMMA["V"]
    model = build_model(get_config("gemma-7b"))
    params = model.init(seed=0, dtype=torch.bfloat16, device="cuda")
    qparams = model.quantize_weights(params)
    del params
    torch.cuda.empty_cache()
    print(f"[5e] gemma-7b full width, {L} layers, W8A8 (int8 projections, "
          f"bf16 tied LM head; {torch.cuda.memory_allocated() / 2 ** 30:.1f}"
          f" GiB of weights): ServeEngine with KernelConfig(quant='int8'), "
          f"phase 5's traffic", flush=True)
    got, s = serve_w8a8(torch, kern, model, qparams, "5e")
    print_step_ms("5e", s["step_ms"])
    passes = s["admitted"] + s["decode_steps"]
    want = {n: 0 for n in kern}
    want.update(quantized_zero_stall_matmul=7 * L * passes,
                zero_stall_matmul=passes, flash_attention=L * s["admitted"])
    check_counts("5e", got, want, f"per pass 7 int8 projections x {L} "
                 f"layers = {7 * L} and 1 bf16 LM head, over "
                 f"{s['admitted']} + {s['decode_steps']} passes")
    logits = first_prefill_logits(torch, model, qparams, {
        "auto": Ctx(plan=KernelConfig(quant="int8"), dtype=torch.bfloat16),
        "torch": Ctx(plan=KernelConfig(backend="torch", quant="int8"),
                     dtype=torch.bfloat16)})
    judge_logits(torch, f"5e first prefill logits (1, 1, {V})",
                 logits["auto"], logits["torch"])
    del qparams, logits
    torch.cuda.empty_cache()
    return got["quantized_zero_stall_matmul"]


# ----------------------------------------------------------------------
# 5g-5h. full-width zamba2-2.7b (bf16, paged, W8A8) and mamba2-130m
# ----------------------------------------------------------------------
def upcast(tree):
    """A copy of a params tree with every tensor in fp32."""
    if isinstance(tree, dict):
        return {k: upcast(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [upcast(v) for v in tree]
    return tree.float()


def rounding_floor(torch, label: str, model, params, bf16: dict) -> float:
    """How far bf16 rounding alone moves the first prefill's logits at
    full width: the plain bf16 path against the plain fp32 path on the
    same weights upcast (the kernel path beside it).  Returns max|plain
    bf16 - plain fp32|."""
    from repro_torch.models import Ctx
    p32 = upcast(params)
    ref = first_prefill_logits(torch, model, p32, {
        "fp32": Ctx(plan="torch", dtype=torch.float32)})["fp32"]
    del p32
    torch.cuda.empty_cache()
    plain = (bf16["torch"] - ref).abs().max().item()
    kern = (bf16["auto"] - ref).abs().max().item()
    scale = ref.abs().max().item()
    print(f"    {label} bf16 rounding floor: against the plain fp32 path on "
          f"the same weights, max|plain bf16 - fp32| {plain:.4g} "
          f"({plain / scale:.2%} of max|fp32| {scale:.4g}), max|kernels "
          f"bf16 - fp32| {kern:.4g} ({kern / scale:.2%}); argmax fp32 "
          f"{int(ref.argmax())}, plain bf16 {int(bf16['torch'].argmax())}, "
          f"kernels {int(bf16['auto'].argmax())}")
    return plain


def serve_engine_mode(torch, kern, label, model, params, ctx, reqs, want_fn,
                      **mode) -> tuple:
    """Phase 5's traffic through ``ServeEngine`` (4 slots, K = 4) with the
    launch counts set to 0 just before: the counts against ``want_fn(stats)``
    -> (tokens by rid, the engine)."""
    eng = engine_for(torch, model, params, ctx,
                     K=SERVE_KW["steps_per_dispatch"], **mode)
    reset_counts(kern)
    res = eng.run(reqs)
    torch.cuda.synchronize()
    s = eng.stats
    got = {n: k.launches for n, k in kern.items()}
    want, why = want_fn(s)
    print(f"    {label}: prefill {s.prefill_tok_s:.1f} tok/s over "
          f"{s.prefill_s:.3f} s; decode {s.decode_tok_s:.1f} tok/s over "
          f"{s.decode_s:.3f} s ({s.decode_steps} steps, {s.dispatches} "
          f"dispatches, {s.admitted} admissions); pages in use (peak) "
          f"{s.pages_in_use}, shared {s.pages_shared}")
    check_counts(label, got, want, why)
    check_designs(label, kern)
    print_captures(label, eng.captures)
    require(variants(eng) == ["greedy"], f"{label}: the engine did not "
            f"decode through one greedy CUDA graph")
    V = model.cfg.vocab_size
    require(sorted(res) == list(range(SERVE_KW["batch"])) and all(
        len(r.tokens) == SERVE_KW["gen_len"]
        and all(0 <= t < V for t in r.tokens) for r in res.values()),
        f"{label}: not every request completed")
    return {i: r.tokens for i, r in res.items()}, eng


def serve_zamba2_full_width(torch, kern) -> dict:
    """5g: zamba2-2.7b at full width in bf16 through ``serve_batch``, then
    ``ServeEngine`` contiguous and paged (16-token pages) on the same
    weights, then W8A8; returns {path: launch counts}."""
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import make_requests, serve_batch
    from repro_torch.models import Ctx, build_model
    from repro_torch.plan import KernelConfig

    kw, G, V = SERVE_KW, ZAMBA2["groups"], ZAMBA2["V"]
    print(f"[5g] zamba2-2.7b full width (54 mamba2 layers, one shared "
          f"attention block invoked {G} times, head dim 80), bf16, random "
          f"weights: serve_batch({kw})", flush=True)
    reset_counts(kern)
    out = serve_batch("zamba2-2.7b", reduced=False, dtype=torch.bfloat16,
                      device="cuda", **kw)
    torch.cuda.synchronize()
    got = {n: k.launches for n, k in kern.items()}
    s = out["stats"]
    passes = s["admitted"] + s["decode_steps"]
    print(f"    prefill {out['prefill_tok_s']:.1f} tok/s over "
          f"{out['prefill_s']:.3f} s; decode {out['decode_tok_s']:.1f} tok/s "
          f"over {out['decode_s']:.3f} s ({s['decode_steps']} steps, "
          f"{s['dispatches']} dispatches, {s['admitted']} admissions)")
    want = {n: 0 for n in kern}
    want.update(zero_stall_matmul=ZAMBA2_MM * passes,
                flash_attention=G * s["admitted"])
    check_counts("5g serve_batch", got, want, f"{ZAMBA2_MM} matmuls a pass "
                 f"(2 x 54 mamba projections, 8 x {G} shared-block "
                 f"projections, the head) over {s['admitted']} + "
                 f"{s['decode_steps']} passes, {G} flash calls a prefill")
    check_designs("5g", kern)
    print_captures("serve_batch's engine", out["captures"])
    require(variants(out["captures"]) == ["greedy"],
            "5g: the engine did not decode through one greedy CUDA graph")
    gen = out["generated"]
    require(gen.shape == (8, 32) and (gen >= 0).all() and (gen < V).all(),
            "5g: not every request completed")
    counts = {"5g serve_batch": got}
    del out
    torch.cuda.empty_cache()

    model = build_model(get_config("zamba2-2.7b"))
    params = model.init(seed=0, dtype=torch.bfloat16, device="cuda")
    ctx = Ctx(plan="auto", dtype=torch.bfloat16)
    bf16 = first_prefill_logits(torch, model, params, {
        "auto": ctx, "torch": Ctx(plan="torch", dtype=torch.bfloat16)})
    judge_logits(torch, f"5g first prefill logits (1, 1, {V})",
                 bf16["auto"], bf16["torch"])
    rounding_floor(torch, "5g", model, params, bf16)
    prefill_graph_vs_eager(torch, "zamba2-2.7b bf16", model, params, ctx)

    reqs = make_requests(model.cfg, kw["seed"], kw["batch"], kw["prompt_len"],
                         kw["gen_len"], kw["mixed"])
    tokens = {}
    for mode, mode_kw in (("contiguous", {}), ("paged", {"page_size": 16})):
        def want_fn(s, paged=bool(mode_kw)):
            want = {n: 0 for n in kern}
            want.update(
                zero_stall_matmul=ZAMBA2_MM * (s.admitted + s.decode_steps),
                flash_attention=G * s.admitted,
                paged_attention=G * s.decode_steps if paged else 0)
            return want, (f"{ZAMBA2_MM} matmuls a pass, {G} flash calls a "
                          f"prefill" + (f", {G} paged calls a decode step"
                                        if paged else ""))
        tokens[mode], eng = serve_engine_mode(
            torch, kern, f"5g ServeEngine {mode}", model, params, ctx, reqs,
            want_fn, **mode_kw)
        counts[f"5g {mode}"] = {n: k.launches for n, k in kern.items()}
        if mode == "contiguous":
            require(all(list(gen[i]) == tokens[mode][i] for i in tokens[mode]),
                    "5g: ServeEngine's tokens differ from serve_batch's on "
                    "the same weights")
        else:
            require(eng._pages_active and eng.stats.pages_in_use > 0,
                    "5g paged: no page in use")
        times = block_step_ms(torch, eng)
        print_step_ms(f"5g {mode}", times)
        if mode == "contiguous":
            busy_share(torch, eng, times)
        del eng
        torch.cuda.empty_cache()
    differ = sum(a != b for i in tokens["paged"]
                 for a, b in zip(tokens["paged"][i], tokens["contiguous"][i]))
    print(f"    paged tokens against contiguous (reported): {differ} of "
          f"{kw['batch'] * kw['gen_len']} differ")
    # one decode step of the first four admissions on the paged cache
    # (kernel 3) and on the contiguous cache (plain einsum), from the same
    # tokens
    logits, first = {}, None
    for mode, mode_kw in (("contiguous", {}), ("paged", {"page_size": 16})):
        eng = engine_for(torch, model, params, ctx, K=4, **mode_kw)
        toks = [eng._admit(r, slot) for slot, r in enumerate(reqs[:4])]
        first = first or toks
        launched = kern["paged_attention"].launches
        logits[mode], _ = model.decode(
            params, eng.cache, torch.tensor(first, device="cuda")[:, None],
            ctx)
        require((kern["paged_attention"].launches - launched == G)
                == (mode == "paged"), "5g: decode did not take the paged "
                "kernel on the paged cache only")
        logits[mode] = logits[mode].float()
        del eng
    judge_logits(torch, f"5g first decode step's logits (4, 1, {V}), paged "
                 f"(kernel 3) against contiguous (plain)", logits["paged"],
                 logits["contiguous"])
    del logits

    qparams = model.quantize_weights(params)
    del params
    torch.cuda.empty_cache()
    print(f"[5g W8A8] zamba2-2.7b full width, W8A8 shared block and "
          f"pre_proj (int8 kernel 4), W8A16 mamba projections (kernel 1 on "
          f"dequantized weights), bf16 tied head; "
          f"{torch.cuda.memory_allocated() / 2 ** 30:.1f} GiB: ServeEngine "
          f"with KernelConfig(quant='int8'), phase 5's traffic", flush=True)
    got, s = serve_w8a8(torch, kern, model, qparams, "5g W8A8")
    print_step_ms("5g W8A8", s["step_ms"])
    passes = s["admitted"] + s["decode_steps"]
    want = {n: 0 for n in kern}
    want.update(quantized_zero_stall_matmul=ZAMBA2_Q4 * passes,
                zero_stall_matmul=(ZAMBA2_MM - ZAMBA2_Q4) * passes,
                flash_attention=G * s["admitted"])
    check_counts("5g W8A8", got, want, f"per pass {ZAMBA2_Q4} int8 "
                 f"shared-block projections and {ZAMBA2_MM - ZAMBA2_Q4} bf16 "
                 f"products (108 dequantized mamba projections, the head), "
                 f"over {s['admitted']} + {s['decode_steps']} passes")
    counts["5g W8A8"] = got
    w8a8 = first_prefill_logits(torch, model, qparams, {
        "auto": Ctx(plan=KernelConfig(quant="int8"), dtype=torch.bfloat16),
        "torch": Ctx(plan=KernelConfig(backend="torch", quant="int8"),
                     dtype=torch.bfloat16)})
    judge_logits(torch, f"5g W8A8 first prefill logits (1, 1, {V})",
                 w8a8["auto"], w8a8["torch"])
    dist = (w8a8["auto"] - bf16["auto"]).abs().max().item()
    scale = bf16["auto"].abs().max().item()
    print(f"    5g W8A8 logits against bf16 (kernel paths; reported, not "
          f"gated): max|W8A8 - bf16| {dist:.4g} ({dist / scale:.2%} of "
          f"max|bf16|); same argmax "
          f"{bool(w8a8['auto'].argmax() == bf16['auto'].argmax())}")
    del qparams, w8a8
    torch.cuda.empty_cache()
    return counts


def serve_mamba2_full_width(torch, kern) -> dict:
    """5h: mamba2-130m at full width in bf16 through ``serve_batch``,
    contiguous and asked for pages (it has no pageable leaf), then the
    logits against the plain path and the decode step under the graph
    against the eager loop; returns {path: launch counts}."""
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import make_requests, serve_batch
    from repro_torch.models import Ctx, build_model

    kw, V = SERVE_KW, MAMBA2["V"]
    print(f"[5h] mamba2-130m full width (24 mamba2 layers, no attention), "
          f"bf16, random weights: serve_batch({kw}), contiguous and with "
          f"page_size 16", flush=True)
    counts, gens = {}, {}
    for mode, mode_kw in (("contiguous", {}), ("paged", {"page_size": 16})):
        reset_counts(kern)
        out = serve_batch("mamba2-130m", reduced=False, dtype=torch.bfloat16,
                          device="cuda", **kw, **mode_kw)
        torch.cuda.synchronize()
        got = {n: k.launches for n, k in kern.items()}
        s = out["stats"]
        print(f"    {mode}: prefill {out['prefill_tok_s']:.1f} tok/s over "
              f"{out['prefill_s']:.3f} s; decode {out['decode_tok_s']:.1f} "
              f"tok/s over {out['decode_s']:.3f} s ({s['decode_steps']} "
              f"steps, {s['dispatches']} dispatches); pages in use "
              f"{s['pages_in_use']}, shared {s['pages_shared']}")
        want = {n: 0 for n in kern}
        want.update(zero_stall_matmul=MAMBA2_MM * (s["admitted"]
                                                   + s["decode_steps"]))
        check_counts(f"5h {mode}", got, want, f"{MAMBA2_MM} matmuls a pass "
                     f"(2 x 24 mamba projections, the head), no attention")
        check_designs(f"5h {mode}", kern)
        print_captures(f"5h {mode}", out["captures"])
        require(variants(out["captures"]) == ["greedy"],
                f"5h {mode}: not one greedy CUDA graph")
        require(s["pages_in_use"] == 0 and s["pages_shared"] == 0,
                f"5h {mode}: page gauges are not zero")
        gens[mode] = out["generated"]
        require(gens[mode].shape == (8, 32) and (gens[mode] >= 0).all()
                and (gens[mode] < V).all(), "5h: not every request completed")
        counts[f"5h {mode}"] = got
        del out
    require((gens["paged"] == gens["contiguous"]).all(), "5h: the engine "
            "asked for pages gave other tokens than the contiguous one")

    model = build_model(get_config("mamba2-130m"))
    params = model.init(seed=0, dtype=torch.bfloat16, device="cuda")
    bf16 = first_prefill_logits(torch, model, params, {
        "auto": Ctx(plan="auto", dtype=torch.bfloat16),
        "torch": Ctx(plan="torch", dtype=torch.bfloat16)})
    require(bool(torch.isfinite(bf16["auto"]).all()), "5h: non-finite "
            "logits")
    err = (bf16["auto"] - bf16["torch"]).abs().max().item()
    scale = bf16["torch"].abs().max().item()
    floor = rounding_floor(torch, "5h", model, params, bf16)
    # bf16 rounding alone moves a random 24-layer mamba2's logits by more
    # than 5% of the largest one (the floor printed above), so the gate
    # is that floor: the kernels may depart from the plain bf16 path no
    # further than the plain bf16 path departs from fp32
    print(f"    5h first prefill logits (1, 1, {V}): max|kernels - plain| "
          f"{err:.4g} ({err / scale:.2%} of max|plain| {scale:.4g}); gate: "
          f"<= the bf16 rounding floor {floor:.4g}")
    require(err <= floor, "5h: the kernel path departs from the plain path "
            "further than bf16 rounding moves the plain path")
    ctx = Ctx(plan="auto", dtype=torch.bfloat16)
    prefill_graph_vs_eager(torch, "mamba2-130m bf16", model, params, ctx)
    eng = engine_for(torch, model, params, ctx, K=kw["steps_per_dispatch"])
    eng.run(make_requests(model.cfg, kw["seed"], kw["batch"],
                          kw["prompt_len"], kw["gen_len"], kw["mixed"]))
    times = block_step_ms(torch, eng)
    print_step_ms("5h", times)
    busy_share(torch, eng, times)
    del eng, params
    torch.cuda.empty_cache()
    return counts


# ----------------------------------------------------------------------
# 5i-5l. seamless-m4t-large-v2 (encdec), llava-next-34b (vlm),
# qwen1.5-32b (QKV bias) and mistral-large-123b
# ----------------------------------------------------------------------
def judge_first_logits(torch, label: str, model, params) -> float:
    """The first request of phase 5's traffic (its frontend included),
    prefilled alone on the kernel and the plain bf16 paths: within 5% of
    the largest plain logit, or within the bf16 rounding floor (the plain
    bf16 path against the plain fp32 path on the same weights) where that
    is larger.  Returns the gate."""
    from repro_torch.models import Ctx
    V = model.cfg.vocab_size
    bf16 = first_prefill_logits(torch, model, params, {
        "auto": Ctx(plan="auto", dtype=torch.bfloat16),
        "torch": Ctx(plan="torch", dtype=torch.bfloat16)})
    require(bool(torch.isfinite(bf16["auto"]).all()), f"{label}: non-finite "
            f"prefill logits")
    err = (bf16["auto"] - bf16["torch"]).abs().max().item()
    scale = bf16["torch"].abs().max().item()
    floor = rounding_floor(torch, label, model, params, bf16)
    gate = max(0.05 * scale, floor)
    print(f"    {label} first prefill logits (1, 1, {V}): max|kernels - "
          f"plain| {err:.4g} ({err / scale:.2%} of max|plain| {scale:.4g}); "
          f"gate max(0.05 * max|plain|, the floor {floor:.4g}) = {gate:.4g}")
    require(err <= gate, f"{label}: the kernel path's prefill logits depart "
            f"from the plain path's")
    return gate


def first_decode_logits(torch, kern, label: str, model, params, reqs,
                        gate: float, want: dict, **engine_kw) -> None:
    """One decode step of the first four of ``reqs`` admitted into a
    paged engine, on copies of its cache: the kernel path's logits
    against the plain path's (the paged cache gathered, the einsum),
    within max(5% of the largest plain logit, ``gate``), and the kernel
    path's attention launches ``want`` (the plain path launches none)."""
    from repro_torch.models import Ctx
    eng = engine_for(torch, model, params,
                     Ctx(plan="auto", dtype=torch.bfloat16), K=4,
                     **engine_kw)
    first = [eng._admit(r, slot) for slot, r in enumerate(reqs[:4])]
    toks = torch.tensor(first, device="cuda")[:, None]
    logits = {}
    for backend in ("auto", "torch"):
        cache = {n: t.clone() for n, t in eng.cache.items()}
        before = {n: kern[n].launches for n in want}
        lg, _ = model.decode(params, cache, toks,
                             Ctx(plan=backend, dtype=torch.bfloat16))
        ran = {n: kern[n].launches - before[n] for n in want}
        require(ran == (want if backend == "auto" else dict.fromkeys(want, 0)),
                f"{label} decode on {backend}: attention launches {ran}")
        logits[backend] = lg.float()
        del cache
    err = (logits["auto"] - logits["torch"]).abs().max().item()
    scale = logits["torch"].abs().max().item()
    tol = max(0.05 * scale, gate)
    print(f"    {label} first paged decode step's logits "
          f"{tuple(logits['auto'].shape)}, kernels ({', '.join(want)}) "
          f"against the plain path: max|err| {err:.4g} ({err / scale:.2%} "
          f"of max|plain| {scale:.4g}); gate {tol:.4g}")
    require(bool(torch.isfinite(logits["auto"]).all()) and err <= tol,
            f"{label}: decode logits disagree")
    del eng, logits
    torch.cuda.empty_cache()


def step_times(torch, label: str, model, params, **kw) -> dict:
    """The decode step of a fresh engine's block (4 slots, K = 4, every
    slot active) under its CUDA graph and as the eager loop; the launch
    counters are left as they were."""
    from repro_torch.kernels import launches
    from repro_torch.models import Ctx
    before = launches.snapshot()
    eng = engine_for(torch, model, params,
                     Ctx(plan="auto", dtype=torch.bfloat16),
                     K=SERVE_KW["steps_per_dispatch"], **kw)
    times = block_step_ms(torch, eng)
    print_step_ms(label, times)
    print_captures(label, eng.captures)
    del eng
    launches.add(launches.since(before), -1)
    torch.cuda.empty_cache()
    return times


def passes(snapshot: dict):
    """A stats snapshot's admissions and decode steps as the attributes
    of ``EngineStats`` that the launch-count derivations read."""
    import types
    return types.SimpleNamespace(admitted=snapshot["admitted"],
                                 decode_steps=snapshot["decode_steps"])


def dense_want(kern, L: int, s, *, paged: bool) -> tuple[dict, str]:
    """Launch counts of a dense or vlm path of ``L`` layers: 7 products a
    layer and the head a pass, ``L`` flash calls a prefill and, paged,
    ``L`` paged calls a decode step."""
    want = {n: 0 for n in kern}
    want.update(zero_stall_matmul=(7 * L + 1) * (s.admitted + s.decode_steps),
                flash_attention=L * s.admitted,
                paged_attention=L * s.decode_steps if paged else 0)
    return want, (f"(7*{L}+1) matmuls a pass over {s.admitted} + "
                  f"{s.decode_steps} passes, {L} flash calls a prefill"
                  + (f", {L} paged calls a decode step" if paged else ""))


def serve_seamless_full_width(torch, kern) -> dict:
    """5i: seamless-m4t-large-v2 at full size in bf16 through
    ``serve_batch``, then ``ServeEngine`` paged with ``enc_len``; returns
    {path: launch counts}."""
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import make_requests, serve_batch
    from repro_torch.models import Ctx, build_model

    kw, s9 = SERVE_KW, SEAMLESS
    cfg = get_config("seamless-m4t-large-v2")
    print(f"[5i] seamless-m4t-large-v2 full size ({s9['enc']} encoder + "
          f"{s9['dec']} decoder layers, d {s9['d']}, {s9['H']} x {s9['hd']} "
          f"MHA, gelu MLP {s9['ff']}, untied vocab {s9['V']}; "
          f"{cfg.param_count() / 1e9:.2f} B parameters, no depth cut), bf16, "
          f"random weights, {s9['frames']} source frames a request: "
          f"serve_batch({kw})", flush=True)

    def want_fn(s, paged=False):
        want = {n: 0 for n in kern}
        want.update(
            zero_stall_matmul=SEAMLESS_MM["prefill"] * s.admitted
            + SEAMLESS_MM["decode"] * s.decode_steps,
            flash_attention=SEAMLESS_FA["prefill"] * s.admitted
            + SEAMLESS_FA["decode"] * s.decode_steps,
            paged_attention=s9["dec"] * s.decode_steps if paged else 0)
        return want, (
            f"{SEAMLESS_MM['prefill']} matmuls a prefill (6 x 24 encoder, "
            f"10 x 24 decoder, the head) and {SEAMLESS_MM['decode']} a "
            f"decode step (8 x 24, the head); {SEAMLESS_FA['prefill']} "
            f"flash calls a prefill (encoder, self, cross) and "
            f"{SEAMLESS_FA['decode']} a decode step (cross attention, in the "
            f"graph)" + (f"; {s9['dec']} paged calls a decode step"
                         if paged else ""))

    reset_counts(kern)
    out = serve_batch("seamless-m4t-large-v2", reduced=False,
                      dtype=torch.bfloat16, device="cuda", **kw)
    torch.cuda.synchronize()
    got = {n: k.launches for n, k in kern.items()}
    st = out["stats"]
    print(f"    prefill {out['prefill_tok_s']:.1f} tok/s over "
          f"{out['prefill_s']:.3f} s; decode {out['decode_tok_s']:.1f} tok/s "
          f"over {out['decode_s']:.3f} s ({st['decode_steps']} steps, "
          f"{st['dispatches']} dispatches, {st['admitted']} admissions)")
    check_counts("5i serve_batch", got, *want_fn(passes(st)))
    check_designs("5i", kern)
    print_captures("serve_batch's engine", out["captures"])
    require(variants(out["captures"]) == ["greedy"],
            "5i: the engine did not decode through one greedy CUDA graph")
    gen = out["generated"]
    require(gen.shape == (8, 32) and (gen >= 0).all()
            and (gen < s9["V"]).all(), "5i: not every request completed")
    counts = {"5i serve_batch": got}
    del out
    torch.cuda.empty_cache()

    model = build_model(cfg)
    params = model.init(seed=0, dtype=torch.bfloat16, device="cuda")
    gate = judge_first_logits(torch, "5i", model, params)
    ctx = Ctx(plan="auto", dtype=torch.bfloat16)
    prefill_graph_vs_eager(torch, "seamless-m4t-large-v2 bf16 (128 frames)",
                           model, params, ctx)
    reqs = make_requests(cfg, kw["seed"], kw["batch"], kw["prompt_len"],
                         kw["gen_len"], kw["mixed"], device="cuda",
                         dtype=torch.bfloat16)
    paged_kw = dict(page_size=16, cache_kwargs={"enc_len": s9["frames"]})
    tokens, eng = serve_engine_mode(
        torch, kern, "5i ServeEngine paged, enc_len 128", model, params, ctx,
        reqs, lambda s: want_fn(s, paged=True), **paged_kw)
    counts["5i paged"] = {n: k.launches for n, k in kern.items()}
    require(eng._paged == {"k", "v"} and eng.stats.pages_shared == 0,
            f"5i: paged leaves {eng._paged}, shared pages "
            f"{eng.stats.pages_shared} (the cross K/V stay per slot, encdec "
            f"shares nothing)")
    differ = sum(a != b for i in tokens for a, b in zip(tokens[i], gen[i]))
    print(f"    paged tokens against serve_batch's contiguous ones "
          f"(reported): {differ} of {kw['batch'] * kw['gen_len']} differ")
    times = block_step_ms(torch, eng)
    print_step_ms("5i paged", times)
    busy_share(torch, eng, times)
    del eng
    torch.cuda.empty_cache()

    # one decode step of the first four admissions: kernels (flash at one
    # query row for the cross attention, paged for the self attention)
    # against the plain path, on copies of one cache
    first_decode_logits(torch, kern, "5i", model, params, reqs, gate,
                        {"flash_attention": s9["dec"],
                         "paged_attention": s9["dec"]}, **paged_kw)
    del params
    torch.cuda.empty_cache()
    return counts


def cut(arch: str, n_layers: int):
    """The full-width config of ``arch`` at ``n_layers`` layers."""
    import dataclasses

    from repro_torch.configs import get_config
    return dataclasses.replace(get_config(arch), n_layers=n_layers)


def serve_llava_full_width(torch, kern) -> dict:
    """5j: llava-next-34b at full width and 8 of 60 layers in bf16, every
    request with 2880 patch positions, through ``ServeEngine`` contiguous
    and paged; then the same prompts text only behind a shared 64-token
    prefix, paged; returns {path: launch counts}."""
    import dataclasses

    import numpy as np

    from repro_torch.launch.serve import make_requests
    from repro_torch.models import Ctx, build_model

    kw, c = SERVE_KW, LLAVA
    cfg = cut("llava-next-34b", c["layers"])
    model = build_model(cfg)
    params = model.init(seed=0, dtype=torch.bfloat16, device="cuda")
    max_len = kw["prompt_len"] + c["P"] + kw["gen_len"]
    print(f"[5j] llava-next-34b full width (d {c['d']}, {c['H']} heads of "
          f"{c['hd']} over {c['KV']} kv heads, SwiGLU {c['ff']}, vocab "
          f"{c['V']}), depth cut to {c['layers']} of {c['of']} layers "
          f"({torch.cuda.memory_allocated() / 2 ** 30:.1f} GiB of bf16 "
          f"weights), random weights; each request carries {c['P']} patch "
          f"positions (max_len {max_len}): ServeEngine contiguous and paged, "
          f"phase 5's traffic", flush=True)
    gate = judge_first_logits(torch, "5j", model, params)
    ctx = Ctx(plan="auto", dtype=torch.bfloat16)
    prefill_graph_vs_eager(torch, f"llava-next-34b bf16 ({c['P']} patch "
                           f"positions)", model, params, ctx)
    reqs = make_requests(cfg, kw["seed"], kw["batch"], kw["prompt_len"],
                         kw["gen_len"], kw["mixed"], device="cuda",
                         dtype=torch.bfloat16)
    counts, tokens = {}, {}
    for mode, mode_kw in (("contiguous", {}), ("paged", {"page_size": 16})):
        tokens[mode], eng = serve_engine_mode(
            torch, kern, f"5j ServeEngine {mode}", model, params, ctx, reqs,
            lambda s, p=bool(mode_kw): dense_want(kern, c["layers"], s,
                                                  paged=p),
            max_len=max_len, **mode_kw)
        counts[f"5j {mode}"] = {n: k.launches for n, k in kern.items()}
        require(eng.stats.pages_shared == 0, "5j: a request with a frontend "
                "shared a prefix page")
        times = block_step_ms(torch, eng)
        print_step_ms(f"5j {mode}", times)
        if mode == "paged":
            busy_share(torch, eng, times)
        del eng
        torch.cuda.empty_cache()
    differ = sum(a != b for i in tokens["paged"]
                 for a, b in zip(tokens["paged"][i], tokens["contiguous"][i]))
    print(f"    paged tokens against contiguous (reported): {differ} of "
          f"{kw['batch'] * kw['gen_len']} differ")
    first_decode_logits(torch, kern, "5j", model, params, reqs, gate,
                        {"paged_attention": c["layers"]}, max_len=max_len,
                        page_size=16)
    prefix = np.random.default_rng(64).integers(0, c["V"], 64).tolist()
    text = [dataclasses.replace(r, prompt=prefix + list(r.prompt),
                                frontend_embeds=None) for r in reqs]
    _, eng = serve_engine_mode(
        torch, kern, "5j ServeEngine paged, text only behind a shared "
        "64-token prefix", model, params, ctx, text,
        lambda s: dense_want(kern, c["layers"], s, paged=True),
        max_len=max_len, page_size=16)
    counts["5j paged, text only"] = {n: k.launches for n, k in kern.items()}
    print(f"    pages shared: {eng.stats.pages_shared} text only, 0 with "
          f"frontends")
    require(eng.stats.pages_shared > 0, "5j: text-only requests behind a "
            "shared prefix shared no page")
    del eng, params
    torch.cuda.empty_cache()
    return counts


def serve_qwen_full_width(torch, kern) -> dict:
    """5k: qwen1.5-32b at full width and 8 of 64 layers in bf16 through
    ``serve_batch``, a biased projection on the card against its plain
    version, and the graph step; returns {path: launch counts}."""
    from repro_torch.launch.serve import serve_batch
    from repro_torch.models import Ctx, build_model
    from repro_torch.models import layers as L

    kw, c = SERVE_KW, QWEN
    print(f"[5k] qwen1.5-32b full width (d {c['d']}, {c['H']} x {c['hd']} "
          f"MHA with QKV bias, SwiGLU {c['ff']}, vocab {c['V']}), depth cut "
          f"to {c['layers']} of {c['of']} layers, bf16, random weights: "
          f"serve_batch({kw}, n_layers={c['layers']})", flush=True)
    reset_counts(kern)
    out = serve_batch("qwen1.5-32b", reduced=False, dtype=torch.bfloat16,
                      device="cuda", n_layers=c["layers"], **kw)
    torch.cuda.synchronize()
    got = {n: k.launches for n, k in kern.items()}
    st = out["stats"]
    print(f"    prefill {out['prefill_tok_s']:.1f} tok/s over "
          f"{out['prefill_s']:.3f} s; decode {out['decode_tok_s']:.1f} tok/s "
          f"over {out['decode_s']:.3f} s ({st['decode_steps']} steps, "
          f"{st['dispatches']} dispatches, {st['admitted']} admissions)")
    check_counts("5k serve_batch", got,
                 *dense_want(kern, c["layers"], passes(st), paged=False))
    check_designs("5k", kern)
    require(variants(out["captures"]) == ["greedy"],
            "5k: the engine did not decode through one greedy CUDA graph")
    gen = out["generated"]
    require(gen.shape == (8, 32) and (gen >= 0).all()
            and (gen < c["V"]).all(), "5k: not every request completed")
    del out
    torch.cuda.empty_cache()

    cfg = cut("qwen1.5-32b", c["layers"])
    model = build_model(cfg)
    params = model.init(seed=0, dtype=torch.bfloat16, device="cuda")
    wq = params["layers"][0]["attn"]["wq"]
    require("b" in wq and "b" in params["layers"][0]["attn"]["wv"]
            and "b" not in params["layers"][0]["attn"]["wo"],
            "5k: qwen's wq/wk/wv carry no bias leaf")
    g = torch.Generator(device="cuda").manual_seed(5)
    x = torch.randn(SERVE_KW["num_slots"], c["d"], device="cuda",
                    generator=g).bfloat16()
    p = {"w": wq["w"], "b": (0.5 * torch.randn(c["d"], device="cuda",
                                               generator=g)).bfloat16()}
    ys = {b: L.linear(p, x, Ctx(plan=b, dtype=torch.bfloat16)).float()
          for b in ("auto", "torch")}
    err = (ys["auto"] - ys["torch"]).abs().amax(-1)
    tol = BF16_TOL * ys["torch"].abs().amax(-1)
    print(f"    biased wq (4, {c['d']}) @ ({c['d']}, {c['H'] * c['hd']}) + b "
          f"on the card against the plain version: max|err| "
          f"{err.max().item():.3g}, worst row |err|/tol "
          f"{(err / tol).max().item():.3g}")
    require(bool((err <= tol).all()), "5k: the biased projection disagrees")
    judge_first_logits(torch, "5k", model, params)
    step_times(torch, "5k", model, params)
    del params
    torch.cuda.empty_cache()
    return {"5k serve_batch": got}


def serve_mistral_full_width(torch, kern) -> dict:
    """5l: mistral-large-123b at full width and 4 of 88 layers in bf16
    through ``ServeEngine`` paged (kernel 3 at 12 query heads a kv head);
    returns {path: launch counts}."""
    from repro_torch.launch.serve import make_requests
    from repro_torch.models import Ctx, build_model

    kw, c = SERVE_KW, MISTRAL
    cfg = cut("mistral-large-123b", c["layers"])
    model = build_model(cfg)
    params = model.init(seed=0, dtype=torch.bfloat16, device="cuda")
    print(f"[5l] mistral-large-123b full width (d {c['d']}, {c['H']} heads "
          f"of {c['hd']} over {c['KV']} kv heads, SwiGLU {c['ff']}, vocab "
          f"{c['V']}), depth cut to {c['layers']} of {c['of']} layers "
          f"({torch.cuda.memory_allocated() / 2 ** 30:.1f} GiB of bf16 "
          f"weights; all 88 would be 246 GB), random weights: ServeEngine "
          f"paged (16-token pages), phase 5's traffic", flush=True)
    gate = judge_first_logits(torch, "5l", model, params)
    reqs = make_requests(cfg, kw["seed"], kw["batch"], kw["prompt_len"],
                         kw["gen_len"], kw["mixed"])
    first_decode_logits(torch, kern, "5l", model, params, reqs, gate,
                        {"paged_attention": c["layers"]}, page_size=16)
    _, eng = serve_engine_mode(
        torch, kern, "5l ServeEngine paged", model, params,
        Ctx(plan="auto", dtype=torch.bfloat16), reqs,
        lambda s: dense_want(kern, c["layers"], s, paged=True),
        page_size=16)
    counts = {"5l paged": {n: k.launches for n, k in kern.items()}}
    times = block_step_ms(torch, eng)
    print_step_ms("5l paged", times)
    busy_share(torch, eng, times)
    del eng, params
    torch.cuda.empty_cache()
    return counts


# ----------------------------------------------------------------------
# 5m. plans and the tuner on the card
# ----------------------------------------------------------------------
TUNE_CACHE = ROOT / "build" / "chip_smoke_tune.json"
MEASURED_CACHE = ROOT / "build" / "chip_smoke_tune_measured.json"
PLAN_FILE = ROOT / "build" / "chip_smoke_5m.plan.json"
MEASURE_LOG = ROOT / "build" / "chip_smoke_5m_measure.jsonl"
TUNE_BUDGET_S = 90.0


def tune_problems() -> list[tuple[str, str, int, int, int, int, int]]:
    """(label, op, M, N, K, groups, bytes an element) of phase 5m's
    measured tuning: gemma-7b's four decode (M = 4) and four 128-token
    prefill products and its head (bf16, then W8A8 with the bf16 head
    left out: it stays bf16), olmoe-1b-7b's expert banks at decode
    (C = 1) and a 128-token prefill (C = 20), bf16 and W8A8."""
    out = []
    for eb, dt in ((2, "bf16"), (1, "int8")):
        for M, what in ((4, "decode"), (128, "prefill")):
            for name, m, k, n, _ in gemma_matmul_shapes(M):
                out.append((f"gemma {what} {name} {dt}", "matmul", m, n, k,
                            1, eb))
        if eb == 2:
            out.append(("gemma decode head bf16", "matmul", 4, GEMMA["V"],
                        GEMMA["d"], 1, 2))
        for C, what in ((1, "decode"), (moe_capacity(128), "prefill")):
            for name, G, m, k, n, _ in expert_shapes(C):
                out.append((f"olmoe {what} {name} {dt}", "grouped_matmul",
                            m, n, k, G, eb))
    return out


def measured_tuning(torch, tune, cache) -> None:
    """5m (a): the measured oracle over the Hopper space (one grid order)
    at phase 6's main-path shapes, every candidate measured, into
    ``cache``; per shape the fixed default's time, the analytic choice
    (its predicted and measured time) and the measured choice.  Every
    measurement is written to ``MEASURE_LOG`` (the ``tune.measure``
    events, JSONL): the data the Hopper model is held to."""
    from repro_torch import obs
    from repro_torch.tune import AnalyticOracle, KernelSpace, MeasuredOracle
    space = KernelSpace(grid_orders=("ijk",))
    analytic, measured = AnalyticOracle(), MeasuredOracle(calls=10,
                                                          repeats=3)
    MEASURE_LOG.unlink(missing_ok=True)
    obs.enable(trace_path=MEASURE_LOG)
    t0 = time.perf_counter()
    print(f"    the measured space: bm {space.rows}, bn {space.bn_options}, "
          f"k tiles of {space.k_bytes} bytes, slots {space.slot_options}, "
          f"ijk, every legal candidate; CUDA events over a graph of "
          f"{measured.calls} calls, best of {measured.repeats}; every "
          f"measurement to {MEASURE_LOG.relative_to(ROOT)}", flush=True)
    try:
        tune_shapes(torch, tune, cache, space, analytic, measured)
    finally:
        obs.disable()
    took = time.perf_counter() - t0
    print(f"    5m (a) took {took:.1f} s (budget {TUNE_BUDGET_S:.0f} s); "
          f"{len(cache)} measured entries", flush=True)
    require(took < TUNE_BUDGET_S, f"5m (a): measured tuning took {took:.1f} "
            f"s, over its {TUNE_BUDGET_S:.0f} s budget")


def tune_shapes(torch, tune, cache, space, analytic, measured) -> None:
    """The shapes of :func:`measured_tuning`, each printed as it runs."""
    from repro_torch.tune import Problem, search
    per_layer = {name: n for name, *_, n in gemma_matmul_shapes(4)}
    passes: dict[tuple, list] = {}
    for label, op, M, N, K, G, eb in tune_problems():
        p = Problem(op, M, N, K, eb, G)
        dtype = torch.int8 if eb == 1 else torch.bfloat16
        default = space.default(p)
        t_def = measured.estimate(default, p)
        a = tune.best_config(op, M, N, K, dtype=dtype, groups=G)
        a_pred, a_meas = analytic.estimate(a, p), measured.estimate(a, p)
        res = search(space, measured, p, exhaustive_limit=512)
        best, t_best = res.best, res.predicted_s
        if best != default and t_def <= t_best * (1 + tune.MIN_GAIN):
            best, t_best = default, t_def
        cache.put(tune.TuneCache.key(p, backend=tune.BACKEND,
                                     dtype="int8" if eb == 1 else "bfloat16"),
                  best, predicted_s=t_best)
        bound = analytic.model.matmul(M, N, K, default.bm, default.bn,
                                      default.bk, dtype_bytes=eb,
                                      groups=G).bound_s
        print(f"    {label} (G {G}, M {M}, K {K}, N {N}): default "
              f"{default.bm}x{default.bn}x{default.bk}/s{default.slots} "
              f"{1e3 * t_def:.4f} ms; analytic {a.bm}x{a.bn}x{a.bk}/"
              f"s{a.slots}/{a.grid_order} predicted {1e3 * a_pred:.4f}, "
              f"measured {1e3 * a_meas:.4f} ms; measured choice "
              f"{best.bm}x{best.bn}x{best.bk}/s{best.slots} "
              f"{1e3 * t_best:.4f} ms ({res.evaluated} measured, "
              f"{res.method}); bound {1e3 * bound:.4f} ms", flush=True)
        model, what, name = label.split(" ", 2)
        name = name.rsplit(" ", 1)[0]
        if model == "gemma" and name in per_layer:
            n = per_layer[name] * GEMMA["layers"]
            passes.setdefault((what, eb), []).append(
                (n * t_def, n * a_meas, n * t_best))
    for (what, eb), parts in passes.items():
        d, a, m = (1e3 * sum(x[i] for x in parts) for i in range(3))
        print(f"    one gemma-7b {what} pass's {7 * GEMMA['layers']} "
              f"{'W8A8' if eb == 1 else 'bf16'} projections (the head left "
              f"out): fixed default {d:.3f} ms, analytic {a:.3f} ms "
              f"({a / d:.3f}x), measured choices {m:.3f} ms ({m / d:.3f}x)")
    # flash attention at gemma's prefill (1, 16, 128, 256), causal
    kw = dict(s_q=128, s_kv=128, head_dim=GEMMA["hd"], dtype_bytes=2,
              batch_heads=GEMMA["H"])
    first = next(iter(space.attention_candidates(
        s_q=128, s_kv=128, head_dim=GEMMA["hd"], dtype_bytes=2)))
    t_def = measured.estimate_attention(*first, **kw)
    a = tune.best_attention_config(128, 128, GEMMA["hd"],
                                   dtype=torch.bfloat16,
                                   batch_heads=GEMMA["H"])
    a_pred = analytic.estimate_attention(*a, **kw)
    a_meas = measured.estimate_attention(*a, **kw)
    m = tune.best_attention_config(128, 128, GEMMA["hd"],
                                   dtype=torch.bfloat16,
                                   batch_heads=GEMMA["H"], oracle=measured,
                                   cache=cache, force=True)
    t_m = measured.estimate_attention(*m, **kw)
    print(f"    flash (1, {GEMMA['H']}, 128, {GEMMA['hd']}) causal bf16: "
          f"default {first[0]}x{first[1]} {1e3 * t_def:.4f} ms; analytic "
          f"{a[0]}x{a[1]} predicted {1e3 * a_pred:.4f}, measured "
          f"{1e3 * a_meas:.4f} ms; measured choice {m[0]}x{m[1]} "
          f"{1e3 * t_m:.4f} ms")


def graph_steps_ms(torch, engines: dict, n: int = 5) -> dict:
    """ms a decode step under each engine's CUDA graph (K = 4, every slot
    active), each dispatch ending in the host's read of the tile, in
    turns forward then backward over ``engines``: {label: [ms, ms]}.  The
    launch counters are left as they were."""
    import numpy as np

    from repro_torch.kernels import launches
    from repro_torch.serve.engine import _host
    before = launches.snapshot()
    fns = {}
    for label, eng in engines.items():
        S = eng.num_slots
        args = (np.zeros(S, np.int32), np.zeros(S, bool),
                np.full(S, 2 ** 30, np.int32))
        fns[label] = (lambda e=eng, a=args:
                      e._decode_block(*a, greedy_only=True))
        fns[label]()
        fns[label]()        # captured by now
    torch.cuda.synchronize()
    times = {label: [] for label in engines}
    order = list(engines)
    for label in order + order[::-1]:
        K = engines[label].steps_per_dispatch
        t0 = time.perf_counter()
        for _ in range(n):
            _host(fns[label]())
        times[label].append(1e3 * (time.perf_counter() - t0) / (n * K))
    launches.add(launches.since(before), -1)
    return times


def logits_margin_5e(torch, model, qparams) -> None:
    """5m (e): the margin of phase 5e (gemma-7b W8A8's first prefill
    logits against the plain path) under the analytic plan and the fixed
    config, and the kernel path with one op at a time swapped for its
    plain version, to localise the op that carries the margin."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.ref import flash_attention_ref, matmul_ref
    from repro_torch.models import Ctx
    from repro_torch.plan import KernelConfig, Plan
    ctxs = {"analytic plan": Ctx(plan=Plan(quant="int8"),
                                 dtype=torch.bfloat16),
            "fixed KernelConfig(quant='int8')":
                Ctx(plan=KernelConfig(quant="int8"), dtype=torch.bfloat16),
            "plain": Ctx(plan=KernelConfig(backend="torch", quant="int8"),
                         dtype=torch.bfloat16)}
    logits = first_prefill_logits(torch, model, qparams, ctxs)
    want = logits.pop("plain")
    scale = want.abs().max().item()

    def margin(got) -> str:
        err = (got - want).abs().max().item()
        return f"{err:.4g} ({err / scale:.2%} of max|plain| {scale:.4g})"

    for name, got in logits.items():
        print(f"    5e margin under the {name}: {margin(got)}")
    judge_logits(torch, "5m (e) W8A8 first prefill logits, analytic plan",
                 logits["analytic plan"], want)

    def plain_flash(q, k, v, *, q_lens, kv_lens, q_offsets, bq, bkv, causal,
                    scale):
        return flash_attention_ref(q, k, v, causal=causal, scale=scale,
                                   q_lens=q_lens, kv_lens=kv_lens,
                                   q_offsets=q_offsets)

    def plain_head(a, b, *, out_dtype, trans_b, **_):
        return matmul_ref(a, b.t() if trans_b else b, out_dtype)

    for what, attr, fn in (("flash attention", "_flash", plain_flash),
                           ("the bf16 LM head (kernel 1)",
                            "zero_stall_matmul", plain_head)):
        kept = getattr(ops, attr)
        setattr(ops, attr, fn)
        try:
            got = first_prefill_logits(torch, model, qparams, {
                "x": ctxs["analytic plan"]})["x"]
        finally:
            setattr(ops, attr, kept)
        print(f"    5e margin with {what} plain, the rest on the kernels "
              f"(analytic plan): {margin(got)}")


def serve_under_plans(torch, kern) -> None:
    """5m: plans and the tuner on the card (see the module docstring)."""
    from repro_torch import obs, tune
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import make_requests
    from repro_torch.models import Ctx, build_model
    from repro_torch.plan import Plan

    kw, L, V = SERVE_KW, GEMMA["layers"], GEMMA["V"]
    print(f"[5m] execution plans and the tuner: (a) the measured oracle at "
          f"phase 6's shapes; (b) gemma-7b bf16 at full width on phase 5's "
          f"weights and traffic through ServeEngine(plan='trace'); (c) "
          f"kernel_watch's utilization of one decode dispatch; (e) the 5e "
          f"margin under the analytic plan", flush=True)
    MEASURED_CACHE.unlink(missing_ok=True)
    measured_cache = tune.TuneCache(MEASURED_CACHE)
    measured_tuning(torch, tune, measured_cache)

    model = build_model(get_config("gemma-7b"))
    params = model.init(seed=0, dtype=torch.bfloat16, device="cuda")
    reqs = make_requests(model.cfg, kw["seed"], kw["batch"],
                         kw["prompt_len"], kw["gen_len"], kw["mixed"])
    obs.reset_counters("tune.")
    t0 = time.perf_counter()
    eng = engine_for(torch, model, params,
                     Ctx(plan="auto", dtype=torch.bfloat16),
                     K=kw["steps_per_dispatch"], plan="trace")
    traced_s, traced_calls = time.perf_counter() - t0, tune.calls()
    eng.plan.save(PLAN_FILE)
    loaded = Plan.load(PLAN_FILE)
    print(f"    (b) ServeEngine(plan='trace') built in {traced_s:.2f} s: "
          f"{len(eng.plan)} plan entries from {traced_calls} tuner calls; "
          f"saved to {PLAN_FILE.relative_to(ROOT)} and reloaded: "
          f"fingerprint {eng.plan.fingerprint()} / {loaded.fingerprint()}",
          flush=True)
    require(loaded.fingerprint() == eng.plan.fingerprint(),
            "5m: the reloaded plan's fingerprint differs")
    obs.reset_counters("tune.")
    reset_counts(kern)
    res = eng.run(reqs)
    torch.cuda.synchronize()
    s = eng.stats
    got = {n: k.launches for n, k in kern.items()}
    want, why = dense_want(kern, L, s, paged=False)
    print(f"    (b) served: decode {s.decode_tok_s:.1f} tok/s over "
          f"{s.decode_s:.3f} s, prefill {s.prefill_tok_s:.1f} tok/s "
          f"({s.decode_steps} steps, {s.admitted} admissions)")
    check_counts("5m traced plan", got, want, why)
    check_designs("5m", kern)
    print_captures("5m traced plan", eng.captures)
    require(sorted(res) == list(range(kw["batch"])) and all(
        len(r.tokens) == kw["gen_len"] for r in res.values()),
        "5m: not every request completed")
    logits = first_prefill_logits(torch, model, params, {
        "plan": Ctx(plan=loaded, dtype=torch.bfloat16),
        "torch": Ctx(plan="torch", dtype=torch.bfloat16)})
    judge_logits(torch, f"5m first prefill logits (1, 1, {V}) under the "
                 f"reloaded traced plan", logits["plan"], logits["torch"])
    del logits
    measured_plan = Plan.from_tune_cache(measured_cache)
    engines = {
        "fixed default (plan=None)": engine_for(
            torch, model, params, Ctx(plan=None, dtype=torch.bfloat16),
            K=kw["steps_per_dispatch"]),
        "analytic (the traced plan)": eng,
        "measured (Plan.from_tune_cache)": engine_for(
            torch, model, params, Ctx(plan="auto", dtype=torch.bfloat16),
            K=kw["steps_per_dispatch"], plan=measured_plan)}
    tune_calls = tune.calls()
    steps = graph_steps_ms(torch, engines)
    require(tune.calls() == tune_calls == 0, f"5m: the tuner was called "
            f"{tune.calls()} times after the traced engine's constructor")
    mean = {k: sum(v) / len(v) for k, v in steps.items()}
    fixed, analytic = mean["fixed default (plan=None)"], \
        mean["analytic (the traced plan)"]
    for label, ms in steps.items():
        print(f"    (b) {label}: graphed decode step "
              f"{' / '.join(f'{t:.3f}' for t in ms)} ms (turns forward, "
              f"then back), {mean[label] / fixed:.3f}x the fixed default")
    print(f"    (b) tuner calls after the traced engine's constructor: "
          f"{tune.calls()}")
    require(analytic <= 1.05 * fixed, f"5m: the analytic plan's decode "
            f"step {analytic:.3f} ms is over 1.05x the fixed default's "
            f"{fixed:.3f} ms")
    del engines

    # (c) one decode dispatch (the eager loop of the traced engine's block,
    # K = 4: a graph replay calls no entry point) through kernel_watch
    from repro_torch.kernels import launches
    before = launches.snapshot()
    obs.reset_records()
    with obs.capture():
        eng._block(True)
    torch.cuda.synchronize()
    rows = obs.utilization_table(measure=True)
    obs.reset_records()
    launches.add(launches.since(before), -1)
    print(f"    (c) kernel_watch over one decode dispatch (K = 4): "
          f"{len(rows)} records; utilization = bound / time (bound: bytes "
          f"over 3.35 TB/s or operations over the peak, the data sheet's)")
    for r in rows:
        print(f"      {r['op']} M {r['M']} N {r['N']} K {r['K']} "
              f"{r['dtype']} x{r['count']} {r['config']}: bound "
              f"{1e3 * r['bound_s']:.4f} ms; predicted "
              f"{1e3 * r['predicted_s']:.4f} ms ({r['predicted_util']:.1%}); "
              f"measured {1e3 * r['measured_s']:.4f} ms "
              f"({r['measured_util']:.1%})")
    require(rows and all(r["measured_s"] > 0 for r in rows),
            "5m: kernel_watch measured nothing")
    del eng, res
    torch.cuda.empty_cache()

    qparams = model.quantize_weights(params)
    del params
    torch.cuda.empty_cache()
    logits_margin_5e(torch, model, qparams)
    del qparams
    torch.cuda.empty_cache()


# ----------------------------------------------------------------------
# 5n. the int8 KV cache and the static analyzer on the card
# ----------------------------------------------------------------------
# phase 5's greedy tokens (ServeEngine on phase 5's weights), which the
# validated engines of 5n must reproduce
PHASE5: dict = {}
# 5n (a): rows, prompt tokens fed one at a time, greedy tokens after them
KV8 = {"B": 4, "prompt": 128, "gen": 32}


def int8_kv_decode(torch, kern, model, params, ctx) -> None:
    """5n (a): the int8 KV cache (``init_cache(quantize_kv=True)``)
    against the bf16 cache on the same weights, token by token through
    ``Model.decode``: the prompt teacher-forced, then the bf16 cache's
    greedy tokens fed to both."""
    import numpy as np
    B, P, G = KV8["B"], KV8["prompt"], KV8["gen"]
    L, V, S = GEMMA["layers"], GEMMA["V"], KV8["prompt"] + KV8["gen"]
    toks = torch.tensor(np.random.default_rng(7).integers(0, V, (B, P)),
                        device="cuda")
    caches = {"bf16": model.init_cache(B, S, torch.bfloat16, device="cuda"),
              "int8": model.init_cache(B, S, torch.bfloat16, device="cuda",
                                       quantize_kv=True)}
    nbytes = {name: {leaf: t.numel() * t.element_size()
                     for leaf, t in c.items() if leaf != "pos"}
              for name, c in caches.items()}
    reset_counts(kern)
    spent = {"bf16": 0.0, "int8": 0.0}
    worst = agree = 0
    tok = toks[:, :1]
    for s in range(S):
        last = {}
        for name in ("bf16", "int8"):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            lg, caches[name] = model.decode(params, caches[name], tok, ctx)
            torch.cuda.synchronize()
            spent[name] += time.perf_counter() - t0
            last[name] = lg[:, -1].float()
        require(bool(torch.isfinite(last["int8"]).all()),
                f"5n (a): non-finite int8-cache logits at step {s}")
        rel = ((last["int8"] - last["bf16"]).abs().max()
               / last["bf16"].abs().max()).item()
        worst = max(worst, rel)
        best = last["bf16"].argmax(-1)
        agree += int((last["int8"].argmax(-1) == best).sum())
        tok = toks[:, s + 1:s + 2] if s + 1 < P else best[:, None]
    got = {n: k.launches for n, k in kern.items()}
    want = {n: 0 for n in kern}
    want["zero_stall_matmul"] = 2 * S * (7 * L + 1)
    check_counts("5n (a)", got, want, f"two caches x {S} decode steps x "
                 f"(7*{L}+1) matmuls; decode attention is plain torch on "
                 f"both caches")
    kb = sum(nbytes["int8"][k] for k in ("k", "v"))
    sb = sum(nbytes["int8"][k] for k in ("k_scale", "v_scale"))
    print(f"    (a) int8 KV cache vs bf16 cache, {B} rows, {P} prompt "
          f"tokens one at a time then {G} greedy: worst step max|int8 - "
          f"bf16| / max|bf16| {worst:.4g} (gate 0.05); argmax agreement "
          f"{agree}/{B * S}; ms a step (eager, host-paced, {L} layers): bf16 "
          f"{1e3 * spent['bf16'] / S:.2f}, int8 {1e3 * spent['int8'] / S:.2f};"
          f" cache bytes: bf16 {sum(nbytes['bf16'].values())}, int8 {kb} "
          f"codes + {sb} scales", flush=True)
    require(worst < 0.05, f"5n (a): the int8 cache's logits sit {worst:.4g} "
            f"of the largest bf16-cache logit from it, over 0.05")
    del caches


def validated_engines(torch, kern, model, params, ctx):
    """5n (b): ``ServeEngine(plan="trace", validate=True)`` contiguous
    and paged, and ``serve_batch(validate_plan=True)`` (the launcher's
    ``--validate-plan``), on phase 5's traffic: no error diagnostic and
    phase 5's first tokens; a plan accumulating int8 in int8 is refused.
    Returns the contiguous engine (its eager block is 5n (c)'s program)."""
    from repro_torch.analyze import lint_plan
    from repro_torch.launch.serve import make_requests, serve_batch
    from repro_torch.plan import KernelConfig, OpKey, Plan
    kw = SERVE_KW
    want = [PHASE5["tokens"][i][0] for i in range(kw["batch"])]
    kept = None
    for label, mode in (("contiguous", {}), ("paged", {"page_size": 16})):
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always", RuntimeWarning)
            eng = engine_for(torch, model, params, ctx,
                             K=kw["steps_per_dispatch"], plan="trace",
                             validate=True, **mode)
        report = lint_plan(eng.plan)
        require(not report.errors, f"5n (b) {label}: the traced plan has "
                f"error diagnostics: {report.format()}")
        res = eng.run(make_requests(model.cfg, kw["seed"], kw["batch"],
                                    kw["prompt_len"], kw["gen_len"],
                                    kw["mixed"]))
        first = [res[i].tokens[0] for i in range(kw["batch"])]
        print(f"    (b) ServeEngine(plan='trace', validate=True) {label}: "
              f"{len(eng.plan)} plan entries, {report!r} ({len(caught)} "
              f"analysis warnings raised); first tokens {first}, phase 5's "
              f"{want}")
        require(first == want, f"5n (b) {label}: first tokens differ from "
                f"phase 5's engine")
        if kept is None:
            kept = eng
        else:
            del eng
    out = serve_batch("gemma-7b", reduced=False, dtype=torch.bfloat16,
                      device="cuda", plan="trace", validate_plan=True, **kw)
    first = [int(t) for t in out["generated"][:, 0]]
    print(f"    (b) launch.serve --validate-plan (serve_batch(validate_plan="
          f"True, plan='trace')): {out['plan']!r}; decode "
          f"{out['decode_tok_s']:.1f} tok/s; first tokens {first}")
    require(first == want, "5n (b): the launcher's first tokens differ "
            "from phase 5's engine")
    del out
    bad = Plan(quant="int8")
    bad.add(OpKey("matmul", 64, 64, 64, dtype="int8").bucketed(),
            KernelConfig(bm=16, bn=16, bk=16, slots=2, out_dtype="int8"))
    try:
        engine_for(torch, model, params, ctx, K=1, plan=bad, validate=True)
    except ValueError as e:
        require("ZS-L004" in str(e), f"5n (b): the refusal names no "
                f"ZS-L004: {e}")
        print("    (b) a plan accumulating int8 in int8: refused, "
              "ValueError naming ZS-L004")
    else:
        require(False, "5n (b): ServeEngine(validate=True) took a plan "
                "accumulating int8 in int8")
    torch.cuda.empty_cache()
    return kept


def lint_engine_block(torch, eng) -> None:
    """5n (c): ``lint_program`` over one eager K = 4 dispatch of the
    engine's block on its CUDA tensors (the program its graph captures):
    no fallback product, no host sync."""
    from repro_torch.analyze import lint_program
    from repro_torch.kernels import launches
    before = launches.snapshot()
    rep = lint_program(eng._block, True)
    torch.cuda.synchronize()
    launches.add(launches.since(before), -1)
    rules = rep.rule_counts()
    hits = {k: v for k, v in rep.meta["allow_hits"].items() if v}
    print(f"    (c) lint_program over one eager K = "
          f"{eng.steps_per_dispatch} dispatch on the card: {rep!r}, rule "
          f"counts {rules}; allowlist hits {hits}")
    require(not rules.get("ZS-P001") and not rules.get("ZS-P002"),
            f"5n (c): the engine's block has fallback products or host "
            f"syncs: {rep.format()}")


def lint_recorded_launches(torch, kern, model, params) -> None:
    """5n (d): ``lint_kernel_ir`` over the geometry the wrappers record at
    real launches: each kernel once at phase 6's shapes, then a prefill
    and a decode pass under 5m's measured plan."""
    import numpy as np
    from repro_torch import tune
    from repro_torch.analyze import lint_kernel_ir
    from repro_torch.kernels.meta import record_launches
    from repro_torch.models import Ctx
    from repro_torch.plan import Plan
    dev = "cuda"
    gen = torch.Generator(device=dev)
    gen.manual_seed(5)

    def bf(*shape):
        return torch.randn(*shape, device=dev, generator=gen).to(
            torch.bfloat16)

    def i8(*shape):
        return torch.randint(-127, 128, shape, device=dev, generator=gen,
                             dtype=torch.int8)

    d, V = GEMMA["d"], GEMMA["V"]
    with record_launches() as recorded:
        for M in (4, 128):
            for _, m, k, n, _ in gemma_matmul_shapes(M):
                kern["zero_stall_matmul"](bf(m, k), bf(k, n))
                kern["quantized_zero_stall_matmul"](
                    i8(m, k), i8(n, k).t(), torch.rand(m, 1, device=dev),
                    torch.rand(1, n, device=dev))
            for _, g, c, k, n, _ in expert_shapes(moe_capacity(M)):
                kern["grouped_zero_stall_matmul"](bf(g, c, k), bf(g, k, n))
                kern["quantized_grouped_zero_stall_matmul"](
                    i8(g, c, k), i8(g, n, k).mT,
                    torch.rand(g, c, 1, device=dev),
                    torch.rand(g, 1, n, device=dev))
        kern["zero_stall_matmul"](bf(4, d), bf(V, d), trans_b=True,
                                  out_dtype=torch.float32)
        q = bf(1, GEMMA["H"], 128, GEMMA["hd"])
        for lens in (None, torch.tensor([101], dtype=torch.int32,
                                        device=dev)):
            kern["flash_attention"](q, bf(*q.shape), bf(*q.shape),
                                    q_lens=lens, kv_lens=lens)
        case = paged_case(torch, gen, B=GEMMA["slots"], H=GEMMA["H"],
                          KV=GEMMA["H"], D=GEMMA["hd"], ps=16, T=10,
                          kv_lens=[144, 112, 96, 128], dtype=torch.bfloat16)
        kern["paged_attention"](*case[:4], kv_lens=case[4])
        n_phase6 = len(recorded)
        measured = Plan.from_tune_cache(tune.TuneCache(MEASURED_CACHE))
        ctx = Ctx(plan=measured, dtype=torch.bfloat16)
        toks = np.random.default_rng(3).integers(0, V, (1, 128))
        batch = {"tokens": torch.tensor(toks, device=dev),
                 "lengths": torch.tensor([128], dtype=torch.int32,
                                         device=dev)}
        _, cache = model.prefill(params, batch, ctx, 160)
        model.decode(params, cache, batch["tokens"][:, :1], ctx)
    torch.cuda.synchronize()
    errors, families = {}, {}
    for ir in recorded:
        rep = lint_kernel_ir(ir)
        families[ir.family] = families.get(ir.family, 0) + 1
        for dg in rep.errors:
            errors[dg.rule] = errors.get(dg.rule, 0) + 1
            if errors[dg.rule] <= 3:
                print(f"      {dg.format()}")
    print(f"    (d) lint_kernel_ir over {len(recorded)} recorded launches "
          f"({n_phase6} at phase 6's shapes, {len(recorded) - n_phase6} of "
          f"a prefill and a decode pass under 5m's measured plan, "
          f"{len(measured)} entries): kernels_verified {len(recorded)}, by "
          f"family {families}; ZS-K errors {errors}")
    require(set(families) == set(kern), f"5n (d): launches of "
            f"{sorted(set(kern) - set(families))} were not recorded")
    require(not errors, f"5n (d): ZS-K errors {errors}")


def serve_int8_kv_and_analyze(torch, kern) -> None:
    """5n: the int8 KV cache and the static analyzer on the card (see the
    module docstring), on phase 5's gemma-7b bf16 weights."""
    from repro_torch.configs import get_config
    from repro_torch.models import Ctx, build_model
    t0 = time.perf_counter()
    print("[5n] gemma-7b full width bf16 on phase 5's weights: (a) the int8 "
          "KV cache against the bf16 cache; (b) validated engines and the "
          "launcher's --validate-plan; (c) program lint of one eager "
          "dispatch; (d) kernel lint of recorded launches", flush=True)
    model = build_model(get_config("gemma-7b"))
    params = model.init(seed=0, dtype=torch.bfloat16, device="cuda")
    ctx = Ctx(plan="auto", dtype=torch.bfloat16)
    ta = time.perf_counter()
    int8_kv_decode(torch, kern, model, params, ctx)
    tb = time.perf_counter()
    eng = validated_engines(torch, kern, model, params, ctx)
    tc = time.perf_counter()
    lint_engine_block(torch, eng)
    del eng
    torch.cuda.empty_cache()
    td = time.perf_counter()
    lint_recorded_launches(torch, kern, model, params)
    del params
    torch.cuda.empty_cache()
    print(f"    5n took {time.perf_counter() - t0:.1f} s: weights "
          f"{ta - t0:.1f}, (a) {tb - ta:.1f}, (b) {tc - tb:.1f}, (c) "
          f"{td - tc:.1f}, (d) {time.perf_counter() - td:.1f}", flush=True)


# ----------------------------------------------------------------------
# 5o. training on the card
# ----------------------------------------------------------------------
TRAIN_DIR = ROOT / "build" / "chip_smoke_5o"
# 5o (b): the published mamba2-130m, the arch JAX's tests/test_e2e_train.py
# trains
TRAIN_B = dict(seq_len=1024, global_batch=8, lr=3e-3, warmup_steps=3,
               total_steps=30, ckpt_every=10, dtype="float32")
# 5o (c): gemma-7b at full width; 4 layers keep parameters, gradients and
# both moments in fp32 (16 bytes a parameter) and the loss's one-hot
# contraction over 256000 columns inside 80 GB
TRAIN_C = dict(layers=4, seq_len=512, global_batch=4)


def train_step_device_vs_host(torch) -> None:
    """5o (a): one train step of the reduced configs on the card and on
    the CPU from the same state."""
    from repro_torch.configs import RunConfig, get_config
    from repro_torch.data import make_pipeline
    from repro_torch.launch.train import make_train_step
    from repro_torch.models import Ctx, build_model
    from repro_torch.optim import init_opt_state
    from repro_torch.tree import leaves, tree_map

    run = RunConfig(seq_len=64, global_batch=4, lr=3e-3, warmup_steps=2,
                    total_steps=10, dtype="float32")
    ctx = Ctx(plan="torch", dtype=torch.float32)
    for arch in ("gemma-7b", "mamba2-130m"):
        cfg = get_config(arch, reduced=True)
        model = build_model(cfg)
        host = model.init(seed=0, dtype=torch.float32, device="cpu")
        pipe = make_pipeline(cfg.vocab_size, run.seq_len, run.global_batch)
        out = {}
        for dev in ("cpu", "cuda"):
            params = tree_map(lambda t: t.to(dev, copy=True), host)
            p, _, _, m = make_train_step(model, ctx, run)(
                params, init_opt_state(params), {},
                pipe.torch_batch(0, dev))
            out[dev] = (float(m["loss"]), float(m["grad_norm"]),
                        float(m["lr"]), [t.cpu() for t in leaves(p)])
        (lc, gc, lr, pc), (lg, gg, _, pg) = out["cpu"], out["cuda"]
        dp = max(float((a - b).abs().max()) for a, b in zip(pc, pg))
        print(f"    (a) {arch} reduced: loss card {lg:.7f} host {lc:.7f} "
              f"(rel {abs(lg - lc) / lc:.3g}), grad norm card {gg:.7f} host "
              f"{gc:.7f} (rel {abs(gg - gc) / gc:.3g}); updated params "
              f"within {dp:.3g} = {dp / lr:.3g} lr", flush=True)
        require(abs(lg - lc) <= 1e-5 * abs(lc), f"5o (a) {arch}: loss")
        require(abs(gg - gc) <= 1e-5 * abs(gc), f"5o (a) {arch}: grad norm")
        require(dp <= 2 * lr + 1e-6, f"5o (a) {arch}: updated params")


def train_mamba2_full(torch) -> None:
    """5o (b): mamba2-130m at its published size through ``train_loop``."""
    import shutil
    from repro_torch.configs import RunConfig, get_config
    from repro_torch.launch.train import train_loop
    from repro_torch.runtime.fault_tolerance import TransientError

    def run_cfg(name, **kw):
        return RunConfig(**{**TRAIN_B, "ckpt_dir": str(TRAIN_DIR / name),
                            **kw})

    fail_at, starts = {7, 13}, []

    def hook(step):
        starts.append((step, time.perf_counter()))
        if step in fail_at:
            fail_at.discard(step)
            raise TransientError("injected preemption")

    t0 = time.perf_counter()
    out = train_loop("mamba2-130m", run_cfg("unbroken"), reduced=False,
                     failure_hook=hook, log_every=10, device="cuda")
    t1 = time.perf_counter()
    losses = out["losses"]
    first, last = sum(losses[:5]) / 5, sum(losses[-5:]) / 5
    # a step's time: from one step's start to the next's (the hook runs
    # first in each attempt), the first step (a warm-up) left out
    times = [b[1] - a[1] for a, b in zip(starts, starts[1:])
             if b[0] == a[0] + 1][1:]
    med = sorted(times)[len(times) // 2]
    tokens = TRAIN_B["seq_len"] * TRAIN_B["global_batch"]
    print(f"    (b) mamba2-130m full size, {TRAIN_B['total_steps']} steps of "
          f"{TRAIN_B['global_batch']} x {TRAIN_B['seq_len']}: loss "
          f"{losses[0]:.4f} -> {losses[-1]:.4f}, first five {first:.4f}, "
          f"last five {last:.4f}; retries {out['executor'].retries_total}, "
          f"restarts {out['executor'].restarts_total}; {t1 - t0:.1f} s, a "
          f"step {1e3 * med:.1f} ms (median), {tokens / med:.0f} tokens/s",
          flush=True)
    require(last < first - 0.05, f"5o (b): the loss fell from {first:.4f} "
            f"to {last:.4f}, not by more than 0.05")
    require(out["executor"].retries_total == 2, "5o (b): retries != 2")
    del out
    steps = sorted(int(p.name.split("_")[1])
                   for p in (TRAIN_DIR / "unbroken").glob("step_*"))
    require(steps == [10, 20, 29], f"5o (b): checkpoints {steps}")
    for s in (20, 29):
        shutil.rmtree(TRAIN_DIR / "unbroken" / f"step_{s:010d}")
    resumed = train_loop("mamba2-130m", run_cfg("unbroken"), reduced=False,
                         log_every=100, device="cuda")["losses"]
    worst = max(abs(a - b) / abs(b) for a, b in zip(resumed, losses[11:]))
    print(f"    (b) resumed from step 10: {len(resumed)} steps, losses "
          f"within {worst:.3g} relative of the unbroken run's", flush=True)
    require(len(resumed) == 19 and worst <= 1e-4,
            f"5o (b): the resumed run is not the unbroken one ({worst:.3g})")
    mb2 = train_loop("mamba2-130m", run_cfg("mb2", total_steps=1,
                                             microbatches=2),
                     reduced=False, device="cuda")["losses"][0]
    int8 = train_loop("mamba2-130m", run_cfg("int8", total_steps=2,
                                              grad_compression="int8"),
                      reduced=False, device="cuda")["losses"]
    print(f"    (b) microbatches=2: first loss {mb2:.7f} against "
          f"{losses[0]:.7f} (rel {abs(mb2 - losses[0]) / losses[0]:.3g}); "
          f"int8 compression: losses {int8}", flush=True)
    require(abs(mb2 - losses[0]) <= 1e-5 * losses[0],
            "5o (b): microbatches=2 changed the first loss")
    require(all(math.isfinite(x) for x in int8), "5o (b): int8 diverged")
    shutil.rmtree(TRAIN_DIR)
    train_graph_vs_eager(torch, "mamba2-130m", get_config("mamba2-130m"),
                         TRAIN_B["seq_len"], TRAIN_B["global_batch"])


def device_busy(torch, fn) -> tuple[float, float, list, int]:
    """One call of ``fn`` under ``torch.profiler``: (device-busy us, the
    call's host us, the five names with the most device time, the number
    of device events), busy being the union of the call's device events
    (kernels and copies)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = 1e6 * (time.perf_counter() - t0)
    dev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    busy, end = 0.0, float("-inf")
    for a, b in sorted((e.time_range.start, e.time_range.end) for e in dev):
        if b > end:
            busy += b - max(a, end)
            end = b
    by_name: dict[str, float] = {}
    for e in dev:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
    return (busy, wall_us, sorted(by_name.items(), key=lambda kv: -kv[1])[:5],
            len(dev))


def tree_distance(torch, got: list, want: list) -> float:
    """The largest elementwise distance between two lists of tensors
    (``want`` may be on the host)."""
    return max(float((g - w.to(g.device)).abs().max())
               for g, w in zip(got, want))


def train_graph_vs_eager(torch, label: str, cfg, S: int, B: int,
                         steps: int = 3, more: int = 3) -> None:
    """5o (e) on ``label``'s configuration, fp32 on the card: ``steps``
    train steps of B x S tokens from the state drawn from seed 0, twice
    through the eager ``make_train_step`` (E1, E2) and once through
    ``compile_train_step`` (G: its first step eager, then the capture,
    then replays).  The determinism gate: G's parameters and losses
    bit-equal to E1's, or no further from them than E2's are.  Then E1
    and G take one more step under ``torch.profiler`` (G ``more`` timed
    replays first).  Prints the losses, the eager and graphed median
    step (E1's first step left out: the warm-up; G's replays only),
    tokens/s, the model FLOP/s (6 N tokens, x 4/3 under full remat)
    against the fp32 peak, the device-busy share, the capture's seconds
    and pool, and the peak memory allocated and reserved over E1's steps
    and over G's (its first step and capture included)."""
    from repro_torch.configs import RunConfig
    from repro_torch.data import make_pipeline
    from repro_torch.launch.train import compile_train_step, make_train_step
    from repro_torch.models import Ctx, build_model
    from repro_torch.optim import init_opt_state
    from repro_torch.tree import leaves

    run = RunConfig(seq_len=S, global_batch=B, lr=3e-4, warmup_steps=1,
                    total_steps=steps + more + 2, dtype="float32")
    model = build_model(cfg)
    ctx = Ctx(plan="torch", dtype=torch.float32)
    pipe = make_pipeline(cfg.vocab_size, S, B)
    batches = [pipe.torch_batch(i, "cuda") for i in range(steps + more + 1)]

    def steps_of(step, n):
        """n steps of ``step`` on a fresh state -> (state, losses, the
        host time of each step)."""
        params = model.init(seed=0, dtype=torch.float32, device="cuda")
        state, losses, times = (params, init_opt_state(params), {}), [], []
        for i in range(n):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            *state, m = step(*state, batches[i])
            losses.append(float(m["loss"]))
            times.append(time.perf_counter() - t0)
        return state, losses, times

    def release():
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()

    release()
    eager = make_train_step(model, ctx, run)
    state, loss_e1, t_e1 = steps_of(eager, steps)
    peak_e = (torch.cuda.max_memory_allocated(),
              torch.cuda.max_memory_reserved())
    ref = [t.to("cpu", copy=True) for t in leaves(state[0])]
    busy_e = device_busy(torch, lambda: eager(*state, batches[steps]))
    del state
    release()
    state, loss_e2, t_e2 = steps_of(eager, steps)
    d_eager = tree_distance(torch, leaves(state[0]), ref)
    del state, eager
    release()
    compiled = compile_train_step(model, ctx, run)
    state, loss_g, t_g = steps_of(compiled, steps)
    peak_g = (torch.cuda.max_memory_allocated(),
              torch.cuda.max_memory_reserved())
    d_graph = tree_distance(torch, leaves(state[0]), ref)
    for i in range(steps, steps + more):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        *state, m = compiled(*state, batches[i])
        float(m["loss"])
        t_g.append(time.perf_counter() - t0)
    busy_g = device_busy(torch, lambda: compiled(*state,
                                                 batches[steps + more]))
    cap = compiled.captures
    del state, compiled
    release()

    dl_eager = max(abs(a - b) for a, b in zip(loss_e2, loss_e1))
    dl_graph = max(abs(a - b) for a, b in zip(loss_g, loss_e1))
    print(f"    (e) {label}, {steps} steps of {B} x {S} from seed 0's state: "
          f"losses eager {loss_e1}, again {loss_e2}, graph {loss_g}; the "
          f"graph's parameters within {d_graph:.3g} of the eager run's "
          f"(losses {dl_graph:.3g}), a second eager run's within "
          f"{d_eager:.3g} (losses {dl_eager:.3g})", flush=True)
    require(len(cap) == 1, f"5o (e) {label}: {len(cap)} captures, not 1")
    require((d_graph == 0.0 and dl_graph == 0.0)
            or (d_graph <= d_eager and dl_graph <= dl_eager),
            f"5o (e) {label}: the graphed step is further from the eager "
            f"step than a second eager run is")
    n, tokens = cfg.param_count(), S * B
    flops = 6 * n * tokens * (4 / 3 if cfg.remat == "full" else 1)
    for path, times, busy, peak in (
            ("eager", t_e1[1:] + t_e2, busy_e, peak_e),
            ("graph", t_g[1:], busy_g, peak_g)):
        med = sorted(times)[len(times) // 2]
        b_us, wall, top, events = busy
        print(f"    (e) {label} {path}: step times "
              f"{[round(1e3 * t, 1) for t in times]} ms, median "
              f"{1e3 * med:.1f} ms, {tokens / med:.0f} tokens/s, model "
              f"FLOP/s {flops / med / 1e12:.2f} T "
              f"({100 * flops / med / PEAK_FLOPS['float32']:.1f}% of the "
              f"{PEAK_FLOPS['float32'] / 1e12:.0f} TFLOP/s fp32 peak); peak "
              f"memory {peak[0] / 1e9:.2f} GB allocated, {peak[1] / 1e9:.2f} "
              f"GB reserved; one step under torch.profiler: "
              f"{events} device events, busy {b_us / 1e3:.1f} ms of "
              f"{wall / 1e3:.1f} ms ({b_us / wall:.1%}), "
              f"{b_us / 1e3 / (1e3 * med):.1%} of the unprofiled median; "
              "most device time: " + "; ".join(
                  f"{name[:40]} {us / 1e3:.1f} ms" for name, us in top[:3]),
              flush=True)
    print(f"    (e) {label} graph: the first step (eager) and the capture "
          f"{1e3 * t_g[0]:.1f} ms, the capture {cap[0]['capture_s']:.3f} s, "
          f"its pool {cap[0]['pool_bytes'] / 2**20:.1f} MiB", flush=True)
    require(all(math.isfinite(x) for x in loss_e1 + loss_g),
            f"5o (e) {label}: loss not finite")


def train_gemma_full_width(torch) -> None:
    """5o (c): gemma-7b at full width, a cut depth, remat "full"."""
    import dataclasses
    from repro_torch.configs import get_config

    L, S, B = TRAIN_C["layers"], TRAIN_C["seq_len"], TRAIN_C["global_batch"]
    cfg = dataclasses.replace(get_config("gemma-7b"), n_layers=L)
    require(cfg.remat == "full", "5o (c): gemma-7b's remat is not full")
    n = cfg.param_count()
    emb = cfg.vocab_size * cfg.d_model
    # fp32 params, gradients, mu and nu; the loss's logits, one-hot and
    # their gradients are (tokens, vocab) fp32 tensors
    reckon = 16 * n
    print(f"    (c) gemma-7b full width, {L} of 28 layers: {n / 1e9:.4f} B "
          f"parameters ({emb / 1e6:.1f} M embedding, "
          f"{(n - emb - cfg.d_model) / L / 1e6:.1f} M a layer); reckoned "
          f"{reckon / 1e9:.1f} GB of fp32 state (16 bytes a parameter) + "
          f"{4 * S * B * cfg.vocab_size / 1e9:.2f} GB a (tokens, vocab) fp32 "
          f"tensor of the loss", flush=True)
    train_graph_vs_eager(torch, "gemma-7b", cfg, S, B)


def train_on_the_card(torch, kern) -> None:
    """5o: training on the card (see the module docstring)."""
    from repro_torch.kernels import launches
    t0 = time.perf_counter()
    print("[5o] training in fp32 on the plain path: (a) the card against the "
          "host; (b) mamba2-130m full size through train_loop; (c) gemma-7b "
          "full width; (d) no kernel launch; (e) the graphed step against "
          "the eager step on (b)'s and (c)'s configurations", flush=True)
    torch.cuda.empty_cache()
    before = launches.snapshot()
    train_step_device_vs_host(torch)
    ta = time.perf_counter()
    train_mamba2_full(torch)
    tb = time.perf_counter()
    train_gemma_full_width(torch)
    tc = time.perf_counter()
    made = launches.since(before)
    print(f"    (d) kernel launches over (a)-(c) and (e): {made or 'none'} "
          f"(each of {', '.join(kern)})")
    require(not made, f"5o: the train path launched kernels: {made}")
    print(f"    5o took {tc - t0:.1f} s: (a) {ta - t0:.1f}, (b) and its (e) "
          f"{tb - ta:.1f}, (c) and its (e) {tc - tb:.1f}", flush=True)


# ----------------------------------------------------------------------
# 5r. execution across ranks: four ranks on the one card over gloo
# ----------------------------------------------------------------------
# The main path's model across ranks: every rank a process on the one
# H100 (NCCL refuses two ranks on one card), each holding DTensor shards
# and launching the kernels on them.  The times price four ranks
# time-sharing one card, not a four-card deployment.
R5_WORLD = 4
# (a)'s depth: gemma-7b at full width, 8 of its 28 layers, so that 5r's
# new parts (g) and (h) fit the script's time
R5_A_LAYERS = 8
R5_DIR = ROOT / "build" / "chip_smoke_5r"
# the ranks tune through a file of their own (each rank merges its writes)
R5_TUNE_CACHE = R5_DIR / "tune.json"


def r5_tune_cache() -> None:
    """Point this rank's tuner at :data:`R5_TUNE_CACHE`."""
    from repro_torch import tune
    tune.set_cache(tune.TuneCache(R5_TUNE_CACHE))
# the requests of JAX's test_sharded_engine_8_device_parity
R5_LENS, R5_NEW = (5, 11, 3, 8), (6, 3, 5, 7)


def r5_requests(cfg):
    import numpy as np
    from repro_torch.serve import Request
    prompts = [np.random.default_rng(i).integers(0, cfg.vocab_size, n)
               for i, n in enumerate(R5_LENS)]
    return [Request(rid=i, prompt=[int(t) for t in p], max_new_tokens=m)
            for i, (p, m) in enumerate(zip(prompts, R5_NEW))]


def r5_engine_kw():
    import torch
    return dict(num_slots=2, max_len=32, steps_per_dispatch=4,
                cache_dtype=torch.float32)


def r5_batch(vocab: int, B: int = 4, S: int = 16, seed: int = 1) -> dict:
    import numpy as np
    import torch
    rng = np.random.default_rng(seed)
    t = rng.integers(0, vocab, (B, S))
    return {"tokens": torch.from_numpy(t).cuda(),
            "targets": torch.from_numpy(np.roll(t, -1, 1)).cuda()}


def r5_train(arch: str, mesh=None) -> list[float]:
    """Five fp32 train steps of the reduced ``arch`` (plain path), on
    ``mesh``'s ranks or on one device."""
    import torch
    from repro_torch.configs import RunConfig, get_config
    from repro_torch.runtime.ranks import device_mesh
    from repro_torch.launch.train import make_train_step
    from repro_torch.models import Ctx, build_model
    from repro_torch.optim import init_opt_state
    from repro_torch.runtime import sharding as shr
    cfg = get_config(arch, reduced=True)
    model = build_model(cfg)
    params = model.init(seed=0, dtype=torch.float32, device="cuda")
    batch = r5_batch(cfg.vocab_size)
    if mesh is not None:
        dm = device_mesh(mesh)
        params = shr.place(params, shr.param_shardings(mesh, params), dm)
        batch = shr.place(batch, shr.batch_shardings(mesh, batch), dm)
    opt = init_opt_state(params)
    step = make_train_step(model, Ctx(plan="torch", dtype=torch.float32,
                                      mesh=mesh),
                           RunConfig(seq_len=16, global_batch=4, lr=1e-3))
    losses = []
    with shr.across_ranks(mesh is not None):
        for _ in range(5):
            params, opt, _, m = step(params, opt, {}, batch)
            losses.append(float(shr.unplace(m["loss"])))
    return losses


def r5_pp_grads(mesh=None) -> tuple[float, list]:
    """The reduced gemma-7b loss of ``r5_batch`` and its gradients (numpy,
    None for the layers of another stage): ``pp_loss_fn`` over ``mesh``'s
    ('pod', 'data') ranks with two microbatches, or ``model.loss``."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import Ctx, build_model
    from repro_torch.runtime import pp_loss_fn
    from repro_torch.tree import flatten, unflatten
    cfg = get_config("gemma-7b", reduced=True)
    model = build_model(cfg)
    ps, treedef = flatten(model.init(seed=0, dtype=torch.float32,
                                     device="cuda"))
    xs = [p.detach().requires_grad_() for p in ps]
    params, batch = unflatten(treedef, xs), r5_batch(cfg.vocab_size)
    ctx = Ctx(plan="torch", dtype=torch.float32)
    loss = (model.loss(params, batch, ctx) if mesh is None else
            pp_loss_fn(params, batch, cfg, ctx, mesh, n_microbatches=2))
    loss.backward()
    return float(loss), [None if x.grad is None else x.grad.cpu().numpy()
                         for x in xs]


def r5_world(rank: int, n: int, want_first_of: int) -> dict:
    """One rank of 5r's four-rank world: sub-phases (a)-(d), the save of
    (e), then (g) and (h) (:func:`r5_families`).  Returns what the parent
    gates and prints."""
    import torch
    r5_tune_cache()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch import obs
    from repro_torch.checkpoint import Checkpointer
    from repro_torch.configs import get_config
    from repro_torch.kernels import launches
    from repro_torch.launch.mesh import make_mesh_compat
    from repro_torch.runtime.ranks import device_mesh
    from repro_torch.launch.serve import make_requests
    from repro_torch.models import Ctx, build_model
    from repro_torch.runtime import sharding as shr
    from repro_torch.serve import ShardedEngine
    from repro_torch.serve.cluster import place_in_turn
    from repro_torch.tree import leaves
    out: dict = {}

    # (a) gemma-7b at full width and R5_A_LAYERS layers, bf16, the kernel
    # path, on (1, 4)
    t0 = time.perf_counter()
    cfg = cut("gemma-7b", R5_A_LAYERS)
    model = build_model(cfg)
    mesh = make_mesh_compat((1, R5_WORLD), ("data", "model"))
    torch.cuda.reset_peak_memory_stats()
    params = place_in_turn(lambda: model.init(seed=0, dtype=torch.bfloat16,
                                              device="cuda"), mesh)
    out["a_draw_s"] = time.perf_counter() - t0
    kw = SERVE_KW
    eng = ShardedEngine(model, params, Ctx(plan="auto", dtype=torch.bfloat16),
                        mesh=mesh, num_slots=kw["num_slots"],
                        max_len=kw["prompt_len"] + kw["gen_len"],
                        cache_dtype=torch.bfloat16,
                        steps_per_dispatch=kw["steps_per_dispatch"],
                        seed=kw["seed"])
    out["a_sharded_leaves"] = sum(
        any(not p.is_replicate() for p in x.placements)
        for x in leaves(eng.params))
    out["a_leaves"] = len(leaves(eng.params))
    first = {}
    first_token = eng._first_token

    def recording(req, slot, logits):
        if req.rid == want_first_of and req.rid not in first:
            first[req.rid] = logits[:, -1].float().cpu().numpy()
        return first_token(req, slot, logits)

    eng._first_token = recording
    reqs = make_requests(cfg, kw["seed"], kw["batch"], kw["prompt_len"],
                         kw["gen_len"], kw["mixed"])
    torch.cuda.synchronize()
    obs.reset_counters("dist.")
    before = launches.snapshot()
    t1 = time.perf_counter()
    res = eng.run(reqs)
    torch.cuda.synchronize()
    out["a_run_s"] = time.perf_counter() - t1
    out["a_launches"] = launches.since(before)
    out["a_staged"] = obs.counters("dist.host_staged.")
    s = eng.stats
    out["a_stats"] = {"admitted": s.admitted, "decode_steps": s.decode_steps,
                      "dispatches": s.dispatches,
                      "prefill_tok_s": s.prefill_tok_s,
                      "decode_tok_s": s.decode_tok_s,
                      "prefill_s": s.prefill_s, "decode_s": s.decode_s}
    out["a_captures"] = list(eng.captures)
    out["a_tokens"] = {i: r.tokens for i, r in res.items()}
    out["a_first_logits"] = first.get(want_first_of)
    out["a_peak_bytes"] = torch.cuda.max_memory_allocated()
    del eng, params, res
    torch.cuda.empty_cache()

    # (b) reduced gemma-7b, fp32, the kernel path, on (1, 4) and (2, 2)
    small = get_config("gemma-7b", reduced=True)
    smodel = build_model(small)
    sparams = smodel.init(seed=0, dtype=torch.float32, device="cuda")
    for shape in ((1, R5_WORLD), (2, R5_WORLD // 2)):
        m = make_mesh_compat(shape, ("data", "model"))
        e = ShardedEngine(smodel, sparams,
                          Ctx(plan="auto", dtype=torch.float32), mesh=m,
                          **r5_engine_kw())
        got = e.run(r5_requests(small))
        out[f"b_tokens_{shape}"] = {i: r.tokens for i, r in got.items()}
        out[f"b_sharded_{shape}"] = sum(
            any(not p.is_replicate() for p in x.placements)
            for x in leaves(e.params))
    # (c) the train step, reduced olmoe-1b-7b and gemma-7b on (2, 2)
    grid = make_mesh_compat((2, R5_WORLD // 2), ("data", "model"))
    before = launches.snapshot()
    obs.reset_counters("dryrun.")
    for arch in ("olmoe-1b-7b", "gemma-7b"):
        out[f"c_losses_{arch}"] = r5_train(arch, grid)
    out["c_replicated"] = obs.counters("dryrun.redistribute_for_op.")
    out["c_launches"] = launches.since(before)
    # (d) pp_loss_fn on (2, 2) ('pod', 'data')
    pods = make_mesh_compat((2, R5_WORLD // 2), ("pod", "data"))
    out["d_loss"], out["d_grads"] = r5_pp_grads(pods)
    # (e) the save: reduced gemma-7b params placed on (2, 2), step 10
    Checkpointer(str(R5_DIR / "ckpt"), keep=1).save(
        10, {"params": shr.place(sparams, shr.param_shardings(grid, sparams),
                                 device_mesh(grid))}, blocking=True)
    out["peak_bytes"] = torch.cuda.max_memory_allocated()
    del sparams
    gc.collect()
    torch.cuda.empty_cache()
    out["gh"] = r5_families()
    return out


def r5_a_reference(torch) -> dict:
    """(a)'s one-rank reference on the card: the same cut gemma-7b, weights
    and traffic through ``ServeEngine`` (tokens, request 0's first-prefill
    logits)."""
    from repro_torch.launch.serve import make_requests
    from repro_torch.models import Ctx, build_model
    from repro_torch.serve import ServeEngine
    kw = SERVE_KW
    cfg = cut("gemma-7b", R5_A_LAYERS)
    model = build_model(cfg)
    params = model.init(seed=0, dtype=torch.bfloat16, device="cuda")
    eng = ServeEngine(model, params, Ctx(plan="auto", dtype=torch.bfloat16),
                      num_slots=kw["num_slots"],
                      max_len=kw["prompt_len"] + kw["gen_len"],
                      cache_dtype=torch.bfloat16,
                      steps_per_dispatch=kw["steps_per_dispatch"],
                      seed=kw["seed"], device="cuda")
    got = r5_serve(eng, make_requests(cfg, kw["seed"], kw["batch"],
                                      kw["prompt_len"], kw["gen_len"],
                                      kw["mixed"]))
    del eng, params
    torch.cuda.empty_cache()
    return got


def r5_restore(rank: int, n: int) -> dict:
    """(e) in a two-rank world: the checkpoint of the four-rank world
    restored onto (1, 2)."""
    import torch
    r5_tune_cache()
    from repro_torch.checkpoint import Checkpointer
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_mesh_compat
    from repro_torch.models import build_model
    from repro_torch.runtime import elastic_restore
    from repro_torch.runtime import sharding as shr
    from repro_torch.tree import leaves
    model = build_model(get_config("gemma-7b", reduced=True))
    params = model.init(seed=0, dtype=torch.float32, device="cuda")
    mesh = make_mesh_compat((1, 2), ("data", "model"))
    state, step = elastic_restore(Checkpointer(str(R5_DIR / "ckpt"), keep=1),
                                  {"params": params}, mesh)
    got = leaves(state["params"])
    specs = leaves(shr.param_shardings(mesh, params))
    return {"step": step,
            "equal": all(bool(torch.equal(g.full_tensor(), p))
                         for g, p in zip(got, leaves(params))),
            "shapes": all(tuple(g.to_local().shape)
                          == shr.shard_shape(sp, p.shape)
                          for g, sp, p in zip(got, specs, leaves(params))),
            "leaves": len(got)}


# 5r (g) and (h): W8A8 and every family across ranks at full width, each
# (label, arch, layers kept (None: all), W8A8, dtype) on weights drawn from
# seed 0 as its one-card phase draws them (5e, 5c, 5d, 5h, 5g, 5i, 5j),
# with the first R5_FAM_REQS requests of phase 5's traffic, R5_FAM_NEW
# new tokens each.  mamba2-130m runs in fp32: bf16 rounding alone moves a
# random 24-layer mamba2's logits by about 10% of the largest (5h's
# rounding floor), so only fp32 can hold it to one rank within 5%.  The
# depth of gemma-7b, mamba2-130m and zamba2-2.7b is cut so that (g) and
# (h) fit the script's time: the SSM layers' decode moves their states
# between layouts through staged all-gathers (about 100 a pass at full
# depth: 152 s for zamba2's 18 passes).
R5_FAMILIES = (
    ("gemma-7b W8A8, 8 of 28 layers", "gemma-7b", 8, True, "bfloat16"),
    ("olmoe-1b-7b bf16", "olmoe-1b-7b", None, False, "bfloat16"),
    ("olmoe-1b-7b W8A8", "olmoe-1b-7b", None, True, "bfloat16"),
    ("mamba2-130m fp32, 8 of 24 layers", "mamba2-130m", 8, False,
     "float32"),
    ("zamba2-2.7b bf16, 6 of 54 mamba layers", "zamba2-2.7b", 6, False,
     "bfloat16"),
    ("seamless-m4t-large-v2 bf16", "seamless-m4t-large-v2", None, False,
     "bfloat16"),
    ("llava-next-34b bf16, 8 of 60 layers", "llava-next-34b", 8, False,
     "bfloat16"),
)
# the kernels each configuration must launch (on one rank, and so on
# every rank): kernels 1 and 2 where nothing else is named
R5_FAM_KERNELS = {
    "gemma-7b W8A8, 8 of 28 layers": ("quantized_zero_stall_matmul",
                                      "zero_stall_matmul",
                      "flash_attention"),
    "olmoe-1b-7b bf16": ("grouped_zero_stall_matmul", "zero_stall_matmul",
                         "flash_attention"),
    "olmoe-1b-7b W8A8": ("quantized_grouped_zero_stall_matmul",
                         "quantized_zero_stall_matmul", "zero_stall_matmul",
                         "flash_attention"),
    "mamba2-130m fp32, 8 of 24 layers": ("zero_stall_matmul",),
}
R5_FAM_REQS, R5_FAM_NEW = 2, 16


def r5_family(arch: str, layers, quant: bool, dtype: str):
    """One (g)/(h) configuration on the card: (model, a function drawing
    its weights, ctx, engine kwargs, requests)."""
    import dataclasses

    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import frontend_len, make_requests
    from repro_torch.models import Ctx, build_model
    from repro_torch.plan import KernelConfig
    cfg = get_config(arch) if layers is None else cut(arch, layers)
    model = build_model(cfg)

    dt = getattr(torch, dtype)

    def make():
        params = model.init(seed=0, dtype=dt, device="cuda")
        return model.quantize_weights(params) if quant else params

    kw = SERVE_KW
    reqs = [dataclasses.replace(r, max_new_tokens=R5_FAM_NEW)
            for r in make_requests(cfg, kw["seed"], kw["batch"],
                                   kw["prompt_len"], kw["gen_len"],
                                   kw["mixed"], device="cuda",
                                   dtype=dt)[:R5_FAM_REQS]]
    front = frontend_len(cfg, kw["prompt_len"])
    eng_kw = dict(num_slots=kw["num_slots"], cache_dtype=dt,
                  steps_per_dispatch=kw["steps_per_dispatch"],
                  seed=kw["seed"], max_len=kw["prompt_len"] + R5_FAM_NEW)
    if cfg.family == "encdec":
        eng_kw["cache_kwargs"] = {"enc_len": front}
    else:
        eng_kw["max_len"] += front
    ctx = Ctx(plan=KernelConfig(quant="int8") if quant else "auto",
              dtype=dt)
    return model, make, ctx, eng_kw, reqs


def r5_serve(eng, reqs) -> dict:
    """``eng.run(reqs)`` with the launch counts, staged collectives and
    replications for DTensor's gaps set to 0 just before: tokens, request
    0's first-prefill logits (numpy fp32), launches, stats, replications,
    staged collectives and captures."""
    import torch
    from repro_torch import obs
    from repro_torch.kernels import launches
    first = {}
    first_token = eng._first_token

    def recording(req, slot, logits):
        if req.rid == 0 and 0 not in first:
            first[0] = logits[:, -1].float().cpu().numpy()
        return first_token(req, slot, logits)

    eng._first_token = recording
    torch.cuda.synchronize()
    obs.reset_counters("dryrun.")
    obs.reset_counters("dist.")
    before = launches.snapshot()
    t0 = time.perf_counter()
    res = eng.run(reqs)
    torch.cuda.synchronize()
    s = eng.stats
    return {"tokens": {i: r.tokens for i, r in res.items()},
            "first_logits": first.get(0), "launches": launches.since(before),
            "run_s": time.perf_counter() - t0,
            "stats": {"admitted": s.admitted, "decode_steps": s.decode_steps,
                      "prefill_tok_s": s.prefill_tok_s,
                      "decode_tok_s": s.decode_tok_s},
            "replicated": obs.counters("dryrun.redistribute_for_op."),
            "staged": obs.counters("dist.host_staged."),
            "captures": list(eng.captures)}


def r5_sharded(tree) -> tuple[int, int]:
    """(sharded, all) DTensor leaves of ``tree``, a QTensor's codes and
    scales counted apart."""
    from repro_torch.quant.tensor import QTensor
    from repro_torch.tree import leaves
    xs = [y for x in leaves(tree)
          for y in ((x.data, x.scale) if isinstance(x, QTensor) else (x,))]
    return (sum(any(not p.is_replicate() for p in x.placements) for x in xs),
            len(xs))


def r5_families() -> dict:
    """(g) and (h) on one rank of 5r's world: each of :data:`R5_FAMILIES`
    in turn, drawn in turn (``place_in_turn``) onto (1, 4) and served by
    ``ShardedEngine``, then freed."""
    import torch
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_mesh_compat
    from repro_torch.serve import ShardedEngine
    from repro_torch.serve.cluster import place_in_turn
    mesh = make_mesh_compat((1, R5_WORLD), ("data", "model"))
    out = {}
    for label, *config in R5_FAMILIES:
        model, make, ctx, eng_kw, reqs = r5_family(*config)
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        params = place_in_turn(make, mesh)
        draw_s = time.perf_counter() - t0
        eng = ShardedEngine(model, params, ctx, mesh=mesh, **eng_kw)
        got = r5_serve(eng, reqs)
        got.update(draw_s=draw_s, sharded=r5_sharded(eng.params),
                   peak_bytes=torch.cuda.max_memory_allocated())
        out[label] = got
        if dist.get_rank() == 0:
            print(f"      rank 0: {label} drawn in {draw_s:.1f} s, served in "
                  f"{got['run_s']:.1f} s", flush=True)
        del eng, params
        gc.collect()
        torch.cuda.empty_cache()
    return out


def r5_family_refs(torch) -> dict:
    """(g)/(h)'s one-rank references on the card: each of
    :data:`R5_FAMILIES` drawn and served by ``ServeEngine`` alone, then
    freed."""
    from repro_torch.serve import ServeEngine
    refs = {}
    for label, *config in R5_FAMILIES:
        model, make, ctx, eng_kw, reqs = r5_family(*config)
        params = make()
        eng = ServeEngine(model, params, ctx, device="cuda", **eng_kw)
        refs[label] = r5_serve(eng, reqs)
        del eng, params
        gc.collect()
        torch.cuda.empty_cache()
    return refs


def check_families(kern, refs: dict, outs: list) -> dict:
    """5r (g) and (h)'s gates and prints (see the module docstring) on the
    four ranks' results ``outs`` against the one-rank ``refs``.  Returns
    rank 0's launches, summed over the configurations."""
    import numpy as np
    print(f"    (g)/(h) W8A8 and every family across ranks at full width, "
          f"(1, {R5_WORLD}), the first {R5_FAM_REQS} requests of phase 5's "
          f"traffic, {R5_FAM_NEW} new tokens each: "
          f"{', '.join(c[0] for c in R5_FAMILIES)}", flush=True)
    total = {name: 0 for name in kern}
    failed = []     # every configuration is printed before a gate fails
    for label, *_ in R5_FAMILIES:
        ref = refs[label]
        want = {name: ref["launches"].get(name, 0) for name in kern}
        for name in R5_FAM_KERNELS.get(label, ("zero_stall_matmul",
                                               "flash_attention")):
            if not want[name]:
                failed.append(f"{label}: one rank launched no {name}")
        for r, o in enumerate(outs):
            got = o[label]
            counts = {name: got["launches"].get(name, 0) for name in kern}
            if counts != want:
                failed.append(f"{label} rank {r}: launches {counts} against "
                              f"one rank's {want}")
            if got["captures"]:
                failed.append(f"{label}: a decode or prefill graph across "
                              f"ranks (5s (d))")
            if not got["sharded"][0]:
                failed.append(f"{label} rank {r}: no param leaf sharded")
            if got["tokens"].keys() != ref["tokens"].keys() or any(
                    len(t) != R5_FAM_NEW for t in got["tokens"].values()):
                failed.append(f"{label} rank {r}: not every request "
                              f"completed")
            if got["tokens"] != outs[0][label]["tokens"]:
                failed.append(f"{label}: rank {r}'s tokens differ from rank "
                              f"0's")
        o0 = outs[0][label]
        for name in kern:
            total[name] += o0["launches"].get(name, 0)
        logits, want_logits = o0["first_logits"], ref["first_logits"]
        if logits is None or not bool(np.isfinite(logits).all()):
            failed.append(f"{label}: no finite first-prefill logits of "
                          f"request 0")
            continue
        err = float(np.abs(logits - want_logits).max())
        scale = float(np.abs(want_logits).max())
        if err > 0.05 * scale:
            failed.append(f"{label}: first-prefill logits disagree")
        same = sum(a == b for i, toks in o0["tokens"].items()
                   for a, b in zip(toks, ref["tokens"][i]))
        s, rs = o0["stats"], ref["stats"]
        peaks = ", ".join(f"{o[label]['peak_bytes'] / 2**30:.2f}"
                          for o in outs)
        print(f"      {label}: launches on every rank "
              f"{ {k: v for k, v in o0['launches'].items() if v} }, one "
              f"rank's { {k: v for k, v in want.items() if v} }; request 0's "
              f"first prefill logits max|ranks - one rank| {err:.4g}, "
              f"max|one rank| {scale:.4g} ({err / scale:.2%}; tol 5%); "
              f"tokens equal to one rank's {same} of "
              f"{R5_FAM_REQS * R5_FAM_NEW}; prefill "
              f"{s['prefill_tok_s']:.1f} / decode {s['decode_tok_s']:.2f} "
              f"tok/s (rank 0, four ranks time-sharing the card; one rank "
              f"{rs['prefill_tok_s']:.1f} / {rs['decode_tok_s']:.1f}); "
              f"draw in turn {o0['draw_s']:.1f} s, serve {o0['run_s']:.1f} "
              f"s; sharded leaves {o0['sharded'][0]} of {o0['sharded'][1]}; "
              f"peak memory a rank {peaks} GiB; replicated for DTensor's "
              f"gaps {o0['replicated']}; "
              f"staged {o0['staged']}", flush=True)
    require(not failed, "5r (g)/(h): " + "; ".join(failed))
    print(f"    5s (d): no engine across ranks captured a graph, decode or "
          f"prefill: (a) and {len(R5_FAMILIES)} configurations of (g)/(h) "
          f"on each of the {len(outs)} ranks")
    return total


def across_ranks(torch, kern) -> dict:
    """5r (see the module docstring): four ranks on the one card.  Returns
    rank 0's launches of (a), the main path across ranks, (g) and (h)."""
    import os
    import shutil
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.runtime.ranks import spawn_ranks
    from repro_torch.launch.serve import serve_batch
    from repro_torch.models import Ctx, build_model
    from repro_torch.serve import ServeEngine
    t0 = time.perf_counter()
    print(f"[5r] execution across ranks: {R5_WORLD} ranks share the one "
          f"card over gloo (CUDA all-gathers and point-to-point transfers "
          f"staged through pinned host memory); times price time-sharing, "
          f"not a four-card deployment",
          flush=True)
    torch.cuda.empty_cache()
    shutil.rmtree(R5_DIR, ignore_errors=True)
    R5_DIR.mkdir(parents=True)
    # the one-rank references on the card, made before any rank starts
    small = get_config("gemma-7b", reduced=True)
    smodel = build_model(small)
    sparams = smodel.init(seed=0, dtype=torch.float32, device="cuda")
    ref_tokens = {i: r.tokens for i, r in ServeEngine(
        smodel, sparams, Ctx(plan="auto", dtype=torch.float32),
        device="cuda", **r5_engine_kw()).run(
            r5_requests(small)).items()}
    ref_losses = {arch: r5_train(arch) for arch in ("olmoe-1b-7b",
                                                     "gemma-7b")}
    ref_loss, ref_grads = r5_pp_grads()
    del sparams
    torch.cuda.empty_cache()
    a_ref = r5_a_reference(torch)
    t1 = time.perf_counter()
    gh_refs = r5_family_refs(torch)
    t2 = time.perf_counter()
    outs = spawn_ranks(r5_world, R5_WORLD, store_dir=str(R5_DIR),
                       args=(0,), timeout_s=900.0)
    print(f"    the one-rank references took {t2 - t0:.1f} s ((g) and (h)'s "
          f"{t2 - t1:.1f} s), the four-rank world "
          f"{time.perf_counter() - t2:.1f} s (spawn, draws, (a)-(d), the save "
          f"of (e), (g) and (h))", flush=True)

    # (a)
    L, o0 = R5_A_LAYERS, outs[0]
    s = o0["a_stats"]
    want = {n: 0 for n in kern}
    want.update(zero_stall_matmul=(7 * L + 1) * (s["admitted"]
                                                + s["decode_steps"]),
                flash_attention=L * s["admitted"])
    print(f"    (a) gemma-7b full width, {L} of {GEMMA['layers']} layers, on "
          f"(1, 4), bf16, phase 5's traffic: "
          f"draw in turn {o0['a_draw_s']:.1f} s, serve {o0['a_run_s']:.1f} "
          f"s; prefill {s['prefill_tok_s']:.1f} tok/s over "
          f"{s['prefill_s']:.3f} s, decode {s['decode_tok_s']:.1f} tok/s "
          f"over {s['decode_s']:.3f} s ({s['decode_steps']} steps, "
          f"{s['dispatches']} dispatches, {s['admitted']} admissions), "
          f"rank 0; four ranks time-sharing one card")
    for r, o in enumerate(outs):
        got = {n: o["a_launches"].get(n, 0) for n in kern}
        check_counts(f"5r (a) rank {r}", got, want,
                     f"(7*{L}+1) matmuls per pass over {s['admitted']} + "
                     f"{s['decode_steps']} passes, {L} flash calls per "
                     f"prefill, on each rank's shards")
        require(o["a_sharded_leaves"] > 0,
                f"5r (a) rank {r}: no param leaf is sharded")
        require(o["a_tokens"] == o0["a_tokens"],
                f"5r (a): rank {r}'s tokens differ from rank 0's")
        require(not o["a_captures"], "5r (a): a decode or prefill graph "
                "across ranks (5s (d))")
        print(f"      rank {r}: sharded leaves {o['a_sharded_leaves']} of "
              f"{o['a_leaves']}; staged collectives {o['a_staged']}; peak "
              f"memory (a) {o['a_peak_bytes'] / 2**30:.2f} GiB, over "
              f"(a)-(e) {o['peak_bytes'] / 2**30:.2f} GiB")
    passes = s["admitted"] + s["decode_steps"]
    print("      staged collectives a pass (prefill or decode step): " +
          ", ".join(f"{k[len('dist.host_staged.'):]} {v / passes:.1f}"
                    for k, v in sorted(o0["a_staged"].items())))
    want_logits = a_ref["first_logits"]
    got_logits = o0["a_first_logits"]
    require(got_logits is not None and bool(np.isfinite(got_logits).all()),
            "5r (a): no finite first-prefill logits of request 0")
    err = float(np.abs(got_logits - want_logits).max())
    scale = float(np.abs(want_logits).max())
    print(f"      request 0's first prefill logits: max|ranks - one rank| "
          f"{err:.4g}, max|one rank| {scale:.4g} (tol 0.05 * max: bf16 "
          f"partial sums reduced in another order)")
    require(err <= 0.05 * scale, "5r (a): first-prefill logits disagree")
    same = sum(a == b for i, toks in o0["a_tokens"].items()
               for a, b in zip(toks, a_ref["tokens"][i]))
    total = sum(len(t) for t in a_ref["tokens"].values())
    print(f"      tokens equal to one rank's: {same} of {total} (printed, not "
          f"gated: a greedy tie may break otherwise)")
    # (b)
    for shape in ((1, R5_WORLD), (2, R5_WORLD // 2)):
        for r, o in enumerate(outs):
            require(o[f"b_tokens_{shape}"] == ref_tokens,
                    f"5r (b) {shape} rank {r}: tokens differ from the "
                    f"one-rank engine's")
        print(f"    (b) reduced gemma-7b fp32 on {shape}: tokens equal the "
              f"one-rank engine's on every rank; sharded leaves "
              f"{o0[f'b_sharded_{shape}']}")
    # (c)
    for arch, ref in ref_losses.items():
        for r, o in enumerate(outs):
            got = o[f"c_losses_{arch}"]
            dev = max(abs(a - b) for a, b in zip(got, ref))
            require(dev <= 1e-5, f"5r (c) {arch} rank {r}: losses {got} vs "
                    f"one rank {ref}")
        require(got[-1] < got[0], f"5r (c) {arch}: the loss does not fall")
        print(f"    (c) {arch} on (2, 2), 5 steps: {['%.6f' % x for x in got]}"
              f", max|ranks - one rank| {dev:.3g} (tol 1e-5)")
    print(f"      replicated for DTensor's gaps: {o0['c_replicated']}")
    require(not any(o["c_launches"] for o in outs),
            "5r (c): the train path launched kernels")
    # (d)
    worst = 0.0
    for r, o in enumerate(outs):
        require(abs(o["d_loss"] - ref_loss) <= 1e-5,
                f"5r (d) rank {r}: pp loss {o['d_loss']} vs {ref_loss}")
        for g, want_g in zip(o["d_grads"], ref_grads):
            if g is not None:
                worst = max(worst, float(np.abs(g - want_g).max()))
    covered = [any(o["d_grads"][i] is not None for o in outs)
               for i in range(len(ref_grads))]
    require(all(covered), "5r (d): a gradient no rank holds")
    require(worst <= 1e-5, f"5r (d): gradients differ by {worst}")
    print(f"    (d) pp_loss_fn on (2, 2) ('pod', 'data'), 2 microbatches: "
          f"loss {outs[0]['d_loss']:.6f} vs model.loss {ref_loss:.6f}; "
          f"every gradient within {worst:.3g} of one rank's (tol 1e-5)")
    # (e)
    t3 = time.perf_counter()
    got = spawn_ranks(r5_restore, 2, store_dir=str(R5_DIR / "e"),
                      timeout_s=180.0)
    for r, o in enumerate(got):
        require(o["step"] == 10 and o["equal"] and o["shapes"],
                f"5r (e) rank {r}: {o}")
    print(f"    (e) elastic_restore of the (2, 2) save onto (1, 2) in a "
          f"two-rank world: step 10, {got[0]['leaves']} leaves bit-equal, "
          f"each shard the new mesh's shape ({time.perf_counter() - t3:.1f} "
          f"s)", flush=True)
    # (f) the launcher under torch.distributed.run
    t4 = time.perf_counter()
    args = ["--arch", "gemma-7b", "--reduced", "--batch", "4",
            "--prompt-len", "16", "--gen-len", "8", "--mixed"]
    one = serve_batch("gemma-7b", reduced=True, batch=4, prompt_len=16,
                      gen_len=8, mixed=True, device="cuda", mesh="1x1")
    import hashlib
    digest = hashlib.sha256(one["generated"].tobytes()).hexdigest()[:16]
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               REPRO_TORCH_TUNE_CACHE=str(R5_TUNE_CACHE))
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", str(R5_WORLD), "-m", "repro_torch.launch.serve",
         *args, "--mesh", f"1x{R5_WORLD}"],
        capture_output=True, text=True, timeout=240, env=env, cwd=ROOT)
    require(proc.returncode == 0,
            f"5r (f): the launcher failed:\n{proc.stdout}\n{proc.stderr}")
    line = [ln for ln in proc.stdout.splitlines()
            if ln.startswith("generated digest:")]
    require(line == [f"generated digest: {digest}"],
            f"5r (f): the launcher's tokens {line} differ from the one-rank "
            f"launcher's {digest}")
    print(f"    (f) python -m torch.distributed.run --nproc-per-node "
          f"{R5_WORLD} -m repro_torch.launch.serve {' '.join(args)} --mesh "
          f"1x{R5_WORLD}: the one-rank launcher's tokens (digest {digest}), "
          f"rank 0 alone printing ({time.perf_counter() - t4:.1f} s)")
    # (g) W8A8 and (h) every other family
    more = check_families(kern, gh_refs, [o["gh"] for o in outs])
    shutil.rmtree(R5_DIR, ignore_errors=True)
    print(f"    5r took {time.perf_counter() - t0:.1f} s", flush=True)
    return {n: o0["a_launches"].get(n, 0) + more[n] for n in kern}


# ----------------------------------------------------------------------
# 6. timing
# ----------------------------------------------------------------------
def time_ms(torch, fns, iters: int = 20, graph: bool = True) -> float:
    """Mean time of one call, cycling over ``fns`` (distinct operands, so
    that the 50 MB L2 cache does not hold them between calls).  Every fn
    runs once first (the build, shared-memory attributes, a library's
    refusal of a shape).  Then ``iters`` calls are captured in one CUDA
    graph and replayed between two events: the device's time, without
    the host's launch work per call.  ``graph=False`` times the calls
    as issued one by one, paced by the host wherever the host is slower
    than the device (as on the serving path)."""
    for f in fns:
        f()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    if graph:
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            for i in range(iters):
                fns[i % len(fns)]()
        g.replay()
        torch.cuda.synchronize()
        start.record()
        g.replay()
        stop.record()
    else:
        start.record()
        for i in range(iters):
            fns[i % len(fns)]()
        stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def time_kernels(torch, kern) -> dict:
    from repro_torch.kernels.paged_attention import (paged_splits,
                                                     paged_stages)
    from repro_torch.kernels.ref import (flash_attention_ref, matmul_ref,
                                         paged_attention_ref)
    from repro_torch.kernels.zero_stall_matmul import split_plan
    from repro_torch.plan import KernelConfig
    zero_stall_matmul = kern["zero_stall_matmul"]
    flash_attention = kern["flash_attention"]
    paged_attention = kern["paged_attention"]
    dev = "cuda"
    F = torch.nn.functional
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    print("[6] kernel times at main-path shapes (CUDA events over a CUDA "
          "graph of calls, operands cycled past L2; 'eager': the same "
          "calls issued one by one, as the path issues them)", flush=True)

    def mm_cell(name, M, K, N, trans_b=False, out=torch.bfloat16,
                depths=(2,)):
        """Times of one product at the ring depths ``depths`` (2, the
        path's, first), eagerly at depth 2, of its plain version and of
        torch.matmul, and its two bounds."""
        copies = max(1, -(-128 * 2 ** 20 // (K * N * 2)))
        a = torch.randn(M, K, device=dev).to(torch.bfloat16)
        bs = [torch.randn((N, K) if trans_b else (K, N),
                          device=dev).to(torch.bfloat16)
              for _ in range(copies)]

        def calls(slots):
            return [lambda b=b: zero_stall_matmul(
                a, b, trans_b=trans_b, out_dtype=out, slots=slots,
                variant="single" if slots == 1 else "dobu") for b in bs]

        cell = {f"slots{s}": time_ms(torch, calls(s)) for s in depths}
        cell["ms"] = cell["slots2"]
        cell["eager"] = time_ms(torch, calls(2), graph=False)
        cell["plain"] = time_ms(torch, [lambda b=b: matmul_ref(
            a, b.t() if trans_b else b, out) for b in bs], iters=5,
            graph=False)
        cell["lib"] = time_ms(torch, [lambda b=b: torch.matmul(
            a, b.t() if trans_b else b) for b in bs])
        nbytes = (M * K + K * N) * 2 + M * N * (4 if out == torch.float32
                                                 else 2)
        cell["t_bytes"] = nbytes / HBM_BYTES_PER_S * 1e3
        cell["t_ops"] = 2 * M * N * K / PEAK_FLOPS["bfloat16"] * 1e3
        splits, per = split_plan(M, N, K, 128, 128, 128, sms)
        others = ", ".join(f"slots {s} {cell[f'slots{s}']:.4f}"
                           for s in depths if s != 2)
        print(f"    zero_stall_matmul {name} M={M} K={K} N={N}: "
              f"{cell['ms']:.4f} ms at slots 2 ({others + '; ' if others else ''}"
              f"eager {cell['eager']:.4f}; {splits} split(s) of {per} k "
              f"stages; plain {cell['plain']:.4f}, torch.matmul "
              f"{cell['lib']:.4f}, bound "
              f"{max(cell['t_bytes'], cell['t_ops']):.4f} by "
              f"{'bytes' if cell['t_bytes'] >= cell['t_ops'] else 'operations'})")
        del bs
        return cell

    def step_total(M, lm_M, depths):
        """Times of one full pass of the path over M rows: 28 layers of
        seven projections plus the LM head over lm_M rows."""
        tot = {}
        cells = [(cell, calls * GEMMA["layers"]) for cell, calls in (
            (mm_cell(name, m, k, n, depths=depths), calls)
            for name, m, k, n, calls in gemma_matmul_shapes(M))]
        cells.append((mm_cell("LM head", lm_M, GEMMA["d"], GEMMA["V"],
                              trans_b=True, out=torch.float32,
                              depths=depths), 1))
        for cell, n in cells:
            for key, v in cell.items():
                tot[key] = tot.get(key, 0.0) + v * n
        return tot

    dec = step_total(GEMMA["slots"], GEMMA["slots"], (2, 1, 4))
    pre = step_total(128, 1, (2,))
    for label, tot in (("decode step (M=4)", dec),
                       ("prefill of 128 tokens", pre)):
        print(f"    zero_stall_matmul, one {label}, 197 launches: "
              f"{tot['ms']:.3f} ms (eager {tot['eager']:.3f}; plain "
              f"{tot['plain']:.3f}, torch.matmul {tot['lib']:.3f}, bound "
              f"{max(tot['t_bytes'], tot['t_ops']):.3f} by "
              f"{'bytes' if tot['t_bytes'] >= tot['t_ops'] else 'operations'})")
    print(f"    zero_stall_matmul, one decode step by ring depth (the "
          f"paper's single against revolving buffers): slots 1 "
          f"{dec['slots1']:.3f} ms, slots 2 {dec['slots2']:.3f} ms, slots 4 "
          f"{dec['slots4']:.3f} ms")
    matmul = {"ms": dec["ms"], "plain_ms": dec["plain"],
              "bound_ms": max(dec["t_bytes"], dec["t_ops"]),
              "bound_by": ("bytes" if dec["t_bytes"] >= dec["t_ops"]
                           else "operations"),
              "library_ms": dec["lib"]}

    # flash attention at the prefill shapes of gemma-7b (D 256, the
    # kernels line) and olmoe-1b-7b (D 128), causal, lengths = the bucket
    bq = KernelConfig().bq
    attention = None
    for D in (GEMMA["hd"], OLMOE["hd"]):
        S, H = 128, GEMMA["H"]
        per_set = 3 * H * S * D * 2
        n_sets = -(-128 * 2 ** 20 // per_set)
        qs = [tuple(torch.randn(1, H, S, D, device=dev).to(torch.bfloat16)
                    for _ in range(3)) for _ in range(n_sets)]
        lens = torch.tensor([S], dtype=torch.int32, device=dev)
        zero = torch.zeros(1, dtype=torch.int32, device=dev)
        calls = [lambda t=t: flash_attention(
            *t, q_lens=lens, kv_lens=lens, causal=True) for t in qs]
        ms = time_ms(torch, calls, iters=n_sets)
        eager = time_ms(torch, calls, iters=n_sets, graph=False)
        plain = time_ms(torch, [lambda t=t: flash_attention_ref(
            *t, q_lens=lens, kv_lens=lens, q_offsets=zero, causal=True)
            for t in qs], graph=False)
        lib = time_ms(torch, [lambda t=t: F.scaled_dot_product_attention(
            *t, is_causal=True) for t in qs], iters=n_sets)
        t_bytes = 4 * H * S * D * 2 / HBM_BYTES_PER_S * 1e3
        pairs = S * (S + 1) // 2        # causal (row, col) pairs this data has
        t_ops = 4 * H * pairs * D / PEAK_FLOPS["bfloat16"] * 1e3
        print(f"    flash_attention (1, {H}, {S}, {D}) bf16 causal: {ms:.4f} "
              f"ms on {H * -(-S // bq)} blocks of {bq} query rows (eager "
              f"{eager:.4f}; plain {plain:.4f}, scaled_dot_product_attention "
              f"{lib:.4f}, bound {max(t_bytes, t_ops):.5f} by "
              f"{'bytes' if t_bytes >= t_ops else 'operations'}); {n_sets} "
              f"operand sets of {per_set / 2 ** 20:.0f} MiB cycled")
        if attention is None:
            attention = {"ms": ms, "plain_ms": plain,
                         "bound_ms": max(t_bytes, t_ops),
                         "bound_by": ("bytes" if t_bytes >= t_ops
                                      else "operations"),
                         "library_ms": lib}
        del qs

    # paged attention at the decode shape of phase 5b: 4 slots, 16 heads
    # of 256, a 41-page pool of 16-token pages, 10-page tables, kv lengths
    # of the four prompts 16 tokens into decode; 8 pool copies (86 MB)
    # cycle past L2
    B, T, ps, H, D = GEMMA["slots"], 10, 16, GEMMA["H"], GEMMA["hd"]
    kv = [144, 112, 96, 128]
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    cases = [paged_case(torch, gen, B=B, H=H, KV=H, D=D, ps=ps, T=T,
                        kv_lens=kv, dtype=torch.bfloat16) for _ in range(8)]
    ms = time_ms(torch, [lambda c=c: paged_attention(*c[:4], kv_lens=c[4])
                         for c in cases])
    plain = time_ms(torch, [lambda c=c: paged_attention_ref(
        *c[:4], kv_lens=c[4]) for c in cases], graph=False)
    eager = time_ms(torch, [lambda c=c: paged_attention(*c[:4], kv_lens=c[4])
                            for c in cases], graph=False)
    keys = sum(min(n, T * ps) for n in kv)
    nbytes = (keys * H * D * 2 * 2          # the K and V rows it must read
              + 2 * B * H * D * 2           # q in, o out
              + B * T * 4 + B * 4)          # page table, kv_lens
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = 4 * H * D * keys / PEAK_FLOPS["bfloat16"] * 1e3
    splits, per = paged_splits(B, H, T, sms)
    print(f"    paged_attention ({B}, {H}, {D}) bf16 over {keys} keys "
          f"(kv {kv}, 16-token pages): {ms:.4f} ms on {B * H} x {splits} "
          f"blocks ({splits} splits of {per} pages, "
          f"{paged_stages(per, D, ps, 1, 2)} ring stages; eager "
          f"{eager:.4f}; plain {plain:.4f}, no single PyTorch call reads a "
          f"page table; bound {max(t_bytes, t_ops):.5f} by "
          f"{'bytes' if t_bytes >= t_ops else 'operations'}); per decode "
          f"step ({GEMMA['layers']} calls) {GEMMA['layers'] * ms:.3f} ms")
    # the same calls at other split counts (the C entry bound directly,
    # with the tiles the wrapper would give each count)
    by_split = {}
    for want in (1, 2, 4, 10):
        per = -(-T // want)
        by_split[-(-T // per)] = time_ms(torch, [
            lambda c=c: paged_at(c, -(-T // per), per) for c in cases])
    print(f"    paged_attention by split count (the path's {splits} "
          f"{ms:.4f}): " + ", ".join(f"{k} {v:.4f}" for k, v in
                                     sorted(by_split.items())) + " ms")
    # other points of a 5b decode: its start, a later step, its end
    for mix in ([81, 97, 113, 129], [112, 128, 144, 160], [160] * B):
        other = [paged_case(torch, gen, B=B, H=H, KV=H, D=D, ps=ps, T=T,
                            kv_lens=mix, dtype=torch.bfloat16)
                 for _ in range(8)]
        t = time_ms(torch, [lambda c=c: paged_attention(*c[:4],
                                                        kv_lens=c[4])
                            for c in other])
        print(f"    paged_attention at kv {mix}: {t:.4f} ms")
        del other
    # the same tables with every kv_len 0: no copy and no key, only what
    # the design costs whatever the data (two launches, the merges, the
    # workspace round trip)
    empty = [paged_case(torch, gen, B=B, H=H, KV=H, D=D, ps=ps, T=T,
                        kv_lens=[0] * B, dtype=torch.bfloat16)
             for _ in range(8)]
    fixed = time_ms(torch, [lambda c=c: paged_attention(*c[:4], kv_lens=c[4])
                            for c in empty])
    print(f"    paged_attention with every kv_len 0 (no copy, no key): "
          f"{fixed:.4f} ms")
    del empty
    paged = {"ms": ms, "plain_ms": plain, "bound_ms": max(t_bytes, t_ops),
             "bound_by": "bytes" if t_bytes >= t_ops else "operations",
             "library_ms": None}
    return {"matmul": matmul, "attention": attention, "paged": paged}


def time_host_tiled(torch, kern) -> dict:
    """The paper's ZONL comparison on the card: one (512, 3072, 3072) bf16
    product as ``ops.host_tiled_matmul`` (the host walks 4 x 24 x 24
    tiles of 128, one cuBLAS mm and one add a tile) against kernel 1,
    both over a CUDA graph (device time) and the tile loop also issued
    eagerly, as the host paces it.  Printed, not gated."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.ref import matmul_ref
    zero_stall_matmul = kern["zero_stall_matmul"]
    M, K, N = 512, 3072, 3072
    g = torch.Generator(device="cuda").manual_seed(11)
    a = torch.randn((M, K), generator=g, device="cuda").bfloat16()
    b = (torch.randn((K, N), generator=g, device="cuda") * 0.02).bfloat16()
    got = ops.host_tiled_matmul(a, b)
    want = matmul_ref(a, b)
    err = (got.float() - want.float()).abs().max().item()
    scale = want.float().abs().max().item()
    require(err <= BF16_TOL * scale, f"host_tiled_matmul disagrees: {err}")
    times = {
        "ms": time_ms(torch, [lambda: zero_stall_matmul(a, b)]),
        "host_tiled_ms": time_ms(torch, [lambda: ops.host_tiled_matmul(
            a, b)], iters=2),
        "host_tiled_eager_ms": time_ms(torch, [lambda: ops.host_tiled_matmul(
            a, b)], iters=2, graph=False),
        "library_ms": time_ms(torch, [lambda: torch.mm(a, b)]),
    }
    bound_ms, bound_by = bound(2 * (M * K + K * N + M * N), 2 * M * N * K,
                               "bfloat16")
    times.update(bound_ms=bound_ms, bound_by=bound_by, max_abs_err=err,
                 tiles=(M // 128) * (N // 128) * (K // 128))
    print(f"[6] ZONL at ({M}, {K}, {N}) bf16 on {card_line()}: kernel 1 "
          f"{times['ms']:.4f} ms; host_tiled_matmul ({times['tiles']} tile "
          f"mms) {times['host_tiled_ms']:.4f} ms over a CUDA graph, "
          f"{times['host_tiled_eager_ms']:.4f} ms issued eagerly "
          f"({times['host_tiled_eager_ms'] / times['ms']:.1f}x kernel 1); "
          f"cuBLAS {times['library_ms']:.4f} ms; bound {bound_ms:.4f} ms "
          f"({bound_by}); max|tiled - plain| {err:.4g} of {scale:.4g}",
          flush=True)
    return times


def paged_at(case, splits: int, per: int):
    """Kernel 3 on ``case`` (``paged_case``'s operands) at a given split
    count: the C entry of ``csrc/paged_attention.cu`` bound directly,
    with the wrapper's rows and ring for that split; a yardstick for the
    wrapper's choice (``paged_splits``)."""
    import torch

    from repro_torch.kernels import _build
    from repro_torch.kernels.paged_attention import (_ARGTYPES, paged_rows,
                                                     paged_stages)
    q, kp, vp, table, lens = case
    B, H, D = q.shape
    _, ps, KV, _ = kp.shape
    rep, elt = H // KV, q.element_size()
    o = torch.empty_like(q)
    ws = (torch.empty(B * KV * splits * rep * (D + 2), dtype=torch.float32,
                      device=q.device) if splits > 1 else None)
    fn = _build.bind("paged_attention", _ARGTYPES)
    code = fn(q.data_ptr(), kp.data_ptr(), vp.data_ptr(), o.data_ptr(),
              table.data_ptr(), lens.data_ptr(),
              None if ws is None else ws.data_ptr(), B, KV, table.shape[1],
              ps, D, rep, paged_rows(rep, D, elt), splits, per,
              paged_stages(per, D, ps, rep, elt), D ** -0.5,
              int(q.dtype == torch.bfloat16),
              torch.cuda.current_stream(q.device).cuda_stream)
    _build.check("paged_attention", code)
    return o


def bound(nbytes: float, ops: float, dtype: str) -> tuple[float, str]:
    """The least time (ms) the card could take: bytes over the HBM rate
    or operations over the peak rate of ``dtype``, whichever is larger."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_FLOPS[dtype] * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def time_new_kernels(torch, kern) -> dict:
    """Phase 6 for kernels 4-6: one gemma-7b W8A8 decode step's 196
    projections (M = 4) on the int8 TMA + wgmma design at ring depths 1,
    2 and 4 (and its stage of 128 codes beside the path's 256), one
    128-token prefill's; one olmoe-1b-7b decode step's 48 expert banks
    (G = 64, M = C = 1) in bf16 on the persistent grouped design at ring
    depths 1, 2 and 4, and a prefill's (C = 20); the int8 banks on their
    persistent TMA + wgmma design at ring depths 1, 2 and 4 and k tiles
    of 128 and 256 codes, at decode and at a prefill, beside the
    cp.async ring (its earlier design) on the same operands."""
    import math

    from repro_torch.kernels.ref import (grouped_matmul_ref,
                                         quantized_grouped_matmul_ref,
                                         quantized_matmul_ref)
    from repro_torch.kernels.zero_stall_matmul import split_plan
    from repro_torch.plan import KernelConfig
    from repro_torch.quant import quantize, quantize_rows
    q4 = kern["quantized_zero_stall_matmul"]
    g5 = kern["grouped_zero_stall_matmul"]
    q6 = kern["quantized_grouped_zero_stall_matmul"]
    q4_bk = KernelConfig().matmul_kwargs(torch.int8)["bk"]
    q6_bk = KernelConfig().matmul_kwargs(torch.int8, grouped=True)["bk"]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    dev = "cuda"
    out = {}

    def copies(nbytes):
        return max(1, math.ceil(128 * 2 ** 20 / nbytes))

    def ring(slots):
        return dict(slots=slots, variant="single" if slots == 1 else "dobu")

    def add(tot, cell, n):
        for key, v in cell.items():
            tot[key] = tot.get(key, 0.0) + v * n

    # kernel 4: the 196 int8 projections of a gemma-7b pass over M rows
    def int8_step(M, depths, bks, library):
        tot, refused = {}, None
        for name, m, K, N, calls in gemma_matmul_shapes(M):
            n = calls * GEMMA["layers"]
            x_q, x_s = quantize_rows(torch.randn(m, K, device=dev))
            qws = [quantize(torch.randn(K, N, device=dev))
                   for _ in range(copies(K * N))]
            cell = {}
            for bk in bks:
                for slots in depths:
                    cell[f"bk{bk} slots{slots}"] = time_ms(torch, [
                        lambda w=w: q4(x_q, w.data, x_s, w.scale, bk=bk,
                                       out_dtype=torch.bfloat16,
                                       **ring(slots)) for w in qws])
            cell["ms"] = cell[f"bk{q4_bk} slots2"]
            cell["plain_ms"] = time_ms(torch, [lambda w=w: quantized_matmul_ref(
                x_q, w.data, x_s, w.scale, torch.bfloat16) for w in qws],
                iters=5, graph=False)
            lib_note = ""
            if library:
                try:
                    cell["library_ms"] = time_ms(torch, [
                        lambda w=w: torch._int_mm(x_q, w.data) for w in qws])
                    lib_note = f"torch._int_mm {cell['library_ms']:.4f}"
                except RuntimeError as e:
                    refused = str(e).splitlines()[0][:160]
                    pad = torch.zeros(32, K, dtype=torch.int8, device=dev)
                    pad[:m] = x_q
                    cell["library_ms"] = time_ms(torch, [
                        lambda w=w: torch._int_mm(pad, w.data) for w in qws])
                    lib_note = (f"torch._int_mm refused M={m}; at M=32 "
                                f"{cell['library_ms']:.4f}")
            cell["nbytes"] = m * K + K * N + 4 * (m + N) + 2 * m * N
            cell["ops"] = 2 * m * N * K
            b, by = bound(cell["nbytes"], cell["ops"], "int8")
            splits, per = split_plan(m, N, K, 128, 128, q4_bk, sms)
            others = ", ".join(f"{k} {v:.4f}" for k, v in cell.items()
                               if k.startswith("bk"))
            print(f"    quantized_zero_stall_matmul gemma {name} M={m} K={K} "
                  f"N={N}: {cell['ms']:.4f} ms ({others}; {splits} split(s) "
                  f"of {per} k stages of {q4_bk}; plain "
                  f"{cell['plain_ms']:.4f}{', ' + lib_note if lib_note else ''}"
                  f", bound {b:.4f} by {by}) x {n} a pass")
            add(tot, cell, n)
            del qws
        return tot, refused

    dec, refused = int8_step(GEMMA["slots"], (2, 1, 4),
                             sorted({128, q4_bk}), True)
    b, by = bound(dec["nbytes"], dec["ops"], "int8")
    print(f"    quantized_zero_stall_matmul, one gemma-7b W8A8 decode step "
          f"(M=4), {7 * GEMMA['layers']} launches: {dec['ms']:.3f} ms (plain "
          f"{dec['plain_ms']:.3f}, torch._int_mm "
          + (f"refused M=4 ({refused}); padded to M=32 "
             f"{dec['library_ms']:.3f}" if refused
             else f"{dec['library_ms']:.3f}")
          + f", bound {b:.3f} by {by}: {dec['nbytes'] / 1e9:.2f} GB)")
    print(f"    quantized_zero_stall_matmul, one decode step by ring depth "
          f"and k tile: " + ", ".join(f"{k} {v:.3f} ms" for k, v in
                                       dec.items() if k.startswith("bk")))
    out["quantized"] = {"ms": dec["ms"], "plain_ms": dec["plain_ms"],
                        "bound_ms": b, "bound_by": by,
                        "library_ms": None if refused
                        else dec["library_ms"]}
    pre, _ = int8_step(128, (2,), (q4_bk,), True)
    b, by = bound(pre["nbytes"], pre["ops"], "int8")
    print(f"    quantized_zero_stall_matmul, one 128-token W8A8 prefill "
          f"(M=128), {7 * GEMMA['layers']} launches: {pre['ms']:.3f} ms "
          f"(plain {pre['plain_ms']:.3f}, torch._int_mm "
          f"{pre['library_ms']:.3f}, bound {b:.3f} by {by})")

    # kernels 1 and 4 at olmoe-1b-7b's decode projections (printed for
    # the breakdown of phases 5c and 5d)
    M, d, L = OLMOE["slots"], OLMOE["d"], OLMOE["layers"]
    x = torch.randn(M, d, device=dev)
    x_q, x_s = quantize_rows(x)
    ws = [torch.randn(d, d, device=dev) for _ in range(copies(d * d))]
    qws = [quantize(w) for w in ws]
    ws = [w.bfloat16() for w in ws]
    xb = x.bfloat16()
    mm = time_ms(torch, [lambda w=w: kern["zero_stall_matmul"](xb, w)
                         for w in ws])
    qm = time_ms(torch, [lambda w=w: q4(x_q, w.data, x_s, w.scale, bk=q4_bk,
                                        out_dtype=torch.bfloat16)
                         for w in qws])
    head = [torch.randn(d, OLMOE["V"], device=dev).bfloat16()
            for _ in range(copies(d * OLMOE["V"] * 2))]
    hm = time_ms(torch, [lambda w=w: kern["zero_stall_matmul"](
        xb, w, out_dtype=torch.float32) for w in head])
    print(f"    olmoe projections M={M} K=N={d}: zero_stall_matmul {mm:.4f} "
          f"ms, quantized_zero_stall_matmul {qm:.4f} ms; LM head (M={M}, "
          f"N={OLMOE['V']}, fp32 out) {hm:.4f} ms; per decode step "
          f"{4 * L} projections + the head: bf16 {4 * L * mm + hm:.3f} ms, "
          f"W8A8 {4 * L * qm + hm:.3f} ms")
    del ws, qws, head

    # kernels 5 and 6: the 48 expert banks of an olmoe-1b-7b pass
    def banks(C, int8, depths):
        tot = {}
        for what, G, m, K, N, calls in expert_shapes(C):
            n = calls * OLMOE["layers"]
            a = torch.randn(G, m, K, device=dev)
            bs = [torch.randn(G, K, N, device=dev)
                  for _ in range(copies(G * K * N))]
            cell = {}
            if int8:
                name = "quantized_grouped_zero_stall_matmul"
                x_q, x_s = quantize_rows(a)
                qws = [quantize(b) for b in bs]
                del bs
                for bk in (128, 256):
                    for slots in depths:
                        cell[f"bk{bk} slots{slots}"] = time_ms(torch, [
                            lambda w=w: q6(x_q, w.data, x_s, w.scale, bk=bk,
                                           out_dtype=torch.bfloat16,
                                           **ring(slots)) for w in qws])
                cell["ms"] = cell[f"bk{q6_bk} slots2"]
                w = qws[0]
                require(torch.equal(
                    ring_q6(x_q, w.data, x_s, w.scale),
                    quantized_grouped_matmul_ref(x_q, w.data, x_s, w.scale,
                                                 torch.bfloat16)),
                        "the cp.async ring's grouped int8 product disagrees")
                cell["ring"] = time_ms(torch, [lambda w=w: ring_q6(
                    x_q, w.data, x_s, w.scale) for w in qws])
                cell["plain_ms"] = time_ms(torch, [
                    lambda w=w: quantized_grouped_matmul_ref(
                        x_q, w.data, x_s, w.scale, torch.bfloat16)
                    for w in qws], iters=5, graph=False)
                lib_note = (f"the cp.async ring (bk 128, slots 2) "
                            f"{cell['ring']:.4f}, no library call")
                cell["nbytes"] = (G * m * K + G * K * N + 4 * G * (m + N)
                                  + 2 * G * m * N)
                del qws
            else:
                name = "grouped_zero_stall_matmul"
                a = a.bfloat16()
                bs = [b.bfloat16() for b in bs]
                for slots in depths:
                    cell[f"slots{slots}"] = time_ms(torch, [
                        lambda b=b: g5(a, b, **ring(slots)) for b in bs])
                cell["ms"] = cell["slots2"]
                cell["plain_ms"] = time_ms(torch, [
                    lambda b=b: grouped_matmul_ref(a, b) for b in bs],
                    iters=5, graph=False)
                cell["library_ms"] = time_ms(torch, [
                    lambda b=b: torch.bmm(a, b) for b in bs])
                lib_note = f"torch.bmm {cell['library_ms']:.4f}"
                cell["nbytes"] = 2 * (G * m * K + G * K * N + G * m * N)
                del bs
            cell["ops"] = 2 * G * m * K * N
            b, by = bound(cell["nbytes"], cell["ops"],
                          "int8" if int8 else "bfloat16")
            others = ", ".join(f"{k} {v:.4f}" for k, v in cell.items()
                               if k.startswith(("slots", "bk")))
            print(f"    {name} olmoe {what} G={G} M={m} K={K} N={N}: "
                  f"{cell['ms']:.4f} ms ({others + '; ' if others else ''}"
                  f"plain {cell['plain_ms']:.4f}, {lib_note}, bound "
                  f"{b:.4f} by {by}) x {n} a pass")
            add(tot, cell, n)
        b, by = bound(tot["nbytes"], tot["ops"], "int8" if int8
                      else "bfloat16")
        return tot, b, by

    C, Cp = moe_capacity(OLMOE["slots"]), moe_capacity(128)
    for key, name, int8 in (("grouped", "grouped_zero_stall_matmul", False),
                            ("quantized_grouped",
                             "quantized_grouped_zero_stall_matmul", True)):
        tot, b, by = banks(C, int8, (2, 1, 4))
        print(f"    {name}, one olmoe-1b-7b decode step (C={C}), "
              f"{3 * OLMOE['layers']} launches: {tot['ms']:.3f} ms (plain "
              f"{tot['plain_ms']:.3f}"
              + (f", the cp.async ring {tot['ring']:.3f}" if int8
                 else f", torch.bmm {tot['library_ms']:.3f}")
              + f", bound {b:.3f} by {by}: {tot['nbytes'] / 1e9:.2f} GB)")
        print(f"    {name}, one decode step by "
              + ("k tile and ring depth: " if int8 else "ring depth: ")
              + ", ".join(f"{k} {v:.3f} ms" for k, v in tot.items()
                          if k.startswith(("slots", "bk"))))
        out[key] = {"ms": tot["ms"], "plain_ms": tot["plain_ms"],
                    "bound_ms": b, "bound_by": by,
                    "library_ms": None if int8 else tot["library_ms"]}
        tot, b, by = banks(Cp, int8, (2, 1, 4) if int8 else (2,))
        print(f"    {name}, one olmoe-1b-7b 128-token prefill (C={Cp}), "
              f"{3 * OLMOE['layers']} launches: {tot['ms']:.3f} ms (plain "
              f"{tot['plain_ms']:.3f}"
              + (f", the cp.async ring {tot['ring']:.3f}" if int8
                 else f", torch.bmm {tot['library_ms']:.3f}")
              + f", bound {b:.3f} by {by})")
        if int8:
            print(f"    {name}, one prefill by k tile and ring depth: "
                  + ", ".join(f"{k} {v:.3f} ms" for k, v in tot.items()
                              if k.startswith("bk")))
    torch.cuda.empty_cache()
    return out


def time_slice8(torch, kern) -> dict:
    """Phase 6 for the SSM and hybrid paths: kernel 2 at zamba2's prefill
    shape (1, 32, 128, 80), causal, beside its bound and SDPA; kernel 3
    at zamba2's paged decode (4, 32, 80) over 480 keys a slot, beside
    its bound; kernel 1's zamba2 decode step (181 launches at M = 4)
    beside its bound and cuBLAS (torch.matmul) on the same shapes.  The
    same method as :func:`time_kernels`: CUDA events over a CUDA graph,
    operands cycled past L2."""
    import math

    from repro_torch.kernels.paged_attention import paged_splits
    from repro_torch.kernels.ref import (flash_attention_ref, matmul_ref,
                                         paged_attention_ref)
    F = torch.nn.functional
    dev = "cuda"
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    out = {}

    def copies(nbytes):
        return max(1, math.ceil(128 * 2 ** 20 / nbytes))

    # kernel 2
    S, H, D = 128, ZAMBA2["H"], ZAMBA2["hd"]
    n_sets = copies(3 * H * S * D * 2)
    qs = [tuple(torch.randn(1, H, S, D, device=dev).to(torch.bfloat16)
                for _ in range(3)) for _ in range(n_sets)]
    lens = torch.tensor([S], dtype=torch.int32, device=dev)
    zero = torch.zeros(1, dtype=torch.int32, device=dev)
    fa = kern["flash_attention"]
    ms = time_ms(torch, [lambda t=t: fa(*t, q_lens=lens, kv_lens=lens,
                                        causal=True) for t in qs],
                 iters=n_sets)
    plain = time_ms(torch, [lambda t=t: flash_attention_ref(
        *t, q_lens=lens, kv_lens=lens, q_offsets=zero, causal=True)
        for t in qs], graph=False)
    lib = time_ms(torch, [lambda t=t: F.scaled_dot_product_attention(
        *t, is_causal=True) for t in qs], iters=n_sets)
    b, by = bound(4 * H * S * D * 2, 4 * H * (S * (S + 1) // 2) * D,
                  "bfloat16")
    print(f"    flash_attention (1, {H}, {S}, {D}) bf16 causal (zamba2's "
          f"prefill): {ms:.4f} ms (plain {plain:.4f}, "
          f"scaled_dot_product_attention {lib:.4f}, bound {b:.5f} by {by}); "
          f"{ZAMBA2['groups']} calls a prefill: "
          f"{ZAMBA2['groups'] * ms:.3f} ms", flush=True)
    out["attention"] = {"ms": ms, "plain_ms": plain, "bound_ms": b,
                        "bound_by": by, "library_ms": lib}
    del qs

    # kernel 3
    B, T, ps = ZAMBA2["slots"], 30, 16
    kv = [T * ps] * B
    gen = torch.Generator(device=dev)
    gen.manual_seed(2)
    pool_bytes = 2 * (B * T + 1) * ps * H * D * 2
    cases = [paged_case(torch, gen, B=B, H=H, KV=H, D=D, ps=ps, T=T,
                        kv_lens=kv, dtype=torch.bfloat16)
             for _ in range(copies(pool_bytes))]
    pa = kern["paged_attention"]
    ms = time_ms(torch, [lambda c=c: pa(*c[:4], kv_lens=c[4])
                         for c in cases])
    plain = time_ms(torch, [lambda c=c: paged_attention_ref(
        *c[:4], kv_lens=c[4]) for c in cases], graph=False)
    keys = sum(kv)
    nbytes = (keys * H * D * 2 * 2 + 2 * B * H * D * 2 + B * T * 4 + B * 4)
    b, by = bound(nbytes, 4 * H * D * keys, "bfloat16")
    splits, per = paged_splits(B, H, T, sms)
    print(f"    paged_attention ({B}, {H}, {D}) bf16 rep 1 over {keys} keys "
          f"({kv[0]} a slot, 16-token pages, {nbytes / 1e6:.1f} MB): "
          f"{ms:.4f} ms on {B * H} x {splits} blocks ({splits} splits of "
          f"{per} pages; plain {plain:.4f}, no single PyTorch call reads a "
          f"page table; bound {b:.5f} by {by}); {ZAMBA2['groups']} calls a "
          f"decode step: {ZAMBA2['groups'] * ms:.3f} ms", flush=True)
    out["paged"] = {"ms": ms, "plain_ms": plain, "bound_ms": b,
                    "bound_by": by, "library_ms": None}
    del cases

    # kernel 1: one zamba2 decode step
    M = ZAMBA2["slots"]
    shapes = [(name, m, k, n, calls, False) for name, m, k, n, calls in
              slice8_matmul_shapes(M) if name.startswith("zamba2")]
    shapes.append(("zamba2 LM head", M, ZAMBA2["d"], ZAMBA2["V"], 1, True))
    mm = kern["zero_stall_matmul"]
    tot = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "nbytes": 0,
           "ops": 0, "calls": 0}
    for name, m, k, n, calls, head in shapes:
        a = torch.randn(m, k, device=dev).to(torch.bfloat16)
        bs = [torch.randn((n, k) if head else (k, n),
                          device=dev).to(torch.bfloat16)
              for _ in range(copies(k * n * 2))]
        o = torch.float32 if head else torch.bfloat16
        cell = {
            "ms": time_ms(torch, [lambda w=w: mm(a, w, trans_b=head,
                                                 out_dtype=o) for w in bs]),
            "plain_ms": time_ms(torch, [lambda w=w: matmul_ref(
                a, w.t() if head else w, o) for w in bs], iters=5,
                graph=False),
            "library_ms": time_ms(torch, [lambda w=w: torch.matmul(
                a, w.t() if head else w) for w in bs])}
        nbytes = (m * k + k * n) * 2 + m * n * (4 if head else 2)
        b, by = bound(nbytes, 2 * m * n * k, "bfloat16")
        print(f"    zero_stall_matmul {name} M={m} K={k} N={n}: "
              f"{cell['ms']:.4f} ms (plain {cell['plain_ms']:.4f}, "
              f"torch.matmul {cell['library_ms']:.4f}, bound {b:.4f} by "
              f"{by}) x {calls} a step")
        for key in ("ms", "plain_ms", "library_ms"):
            tot[key] += cell[key] * calls
        tot["nbytes"] += nbytes * calls
        tot["ops"] += 2 * m * n * k * calls
        tot["calls"] += calls
        del bs
    require(tot["calls"] == ZAMBA2_MM, f"{tot['calls']} products timed, "
            f"the step has {ZAMBA2_MM}")
    b, by = bound(tot["nbytes"], tot["ops"], "bfloat16")
    print(f"    zero_stall_matmul, one zamba2-2.7b decode step (M={M}), "
          f"{tot['calls']} launches: {tot['ms']:.3f} ms (plain "
          f"{tot['plain_ms']:.3f}, torch.matmul {tot['library_ms']:.3f}, "
          f"bound {b:.3f} by {by}: {tot['nbytes'] / 1e9:.2f} GB)", flush=True)
    out["matmul"] = {"ms": tot["ms"], "plain_ms": tot["plain_ms"],
                     "bound_ms": b, "bound_by": by,
                     "library_ms": tot["library_ms"]}
    torch.cuda.empty_cache()
    return out


def time_slice9(torch, kern) -> dict:
    """Phase 6 for the encdec, vlm and last dense paths: kernel 2 at
    seamless's cross-attention decode (4, 16, 1, 128, 64) and llava's
    causal prefill (1, 56, 3008, 128), each beside its bound and SDPA;
    kernel 3 at llava's (4, 56, 128) rep 7 over 3040 keys a slot and
    mistral's (4, 96, 128) rep 12 over 480, beside their bounds; kernel
    1's decode step (M = 4) of each of seamless (193 launches), llava and
    qwen at 8 layers (57) and mistral at 4 (29), beside its bound and
    cuBLAS (torch.matmul) on the same shapes.  The method of
    :func:`time_kernels`: CUDA events over a CUDA graph, operands cycled
    past L2."""
    import math

    from repro_torch.kernels.flash_attention import fit_tiles
    from repro_torch.kernels.paged_attention import paged_splits
    from repro_torch.kernels.ref import (flash_attention_ref, matmul_ref,
                                         paged_attention_ref)
    F = torch.nn.functional
    dev = "cuda"
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    fa, pa, mm = (kern[n] for n in ("flash_attention", "paged_attention",
                                    "zero_stall_matmul"))
    out = {"attention": {}, "paged": {}, "matmul": {}}
    print("[6] the encdec, vlm and last dense paths' kernel shapes (CUDA "
          "events over a CUDA graph, operands cycled past L2)", flush=True)

    def copies(nbytes):
        return max(1, math.ceil(128 * 2 ** 20 / nbytes))

    def bf(*shape):
        return torch.randn(*shape, device=dev).to(torch.bfloat16)

    # kernel 2
    for key, (B, H, Sq, Skv, D, causal) in (
            ("seamless_cross_decode", (4, SEAMLESS["H"], 1,
                                       SEAMLESS["frames"], SEAMLESS["hd"],
                                       False)),
            ("llava_prefill", (1, LLAVA["H"], LLAVA["P"] + 128,
                               LLAVA["P"] + 128, LLAVA["hd"], True))):
        nbytes = (2 * B * H * Sq * D + 2 * B * H * Skv * D) * 2
        sets = [(bf(B, H, Sq, D), bf(B, H, Skv, D), bf(B, H, Skv, D))
                for _ in range(copies(nbytes))]
        ql = torch.full((B,), Sq, dtype=torch.int32, device=dev)
        kl = torch.full((B,), Skv, dtype=torch.int32, device=dev)
        zero = torch.zeros((B,), dtype=torch.int32, device=dev)
        bq, bkv = fit_tiles(torch.bfloat16, Sq, Skv, 32, 32)
        ms = time_ms(torch, [lambda t=t: fa(*t, q_lens=ql, kv_lens=kl,
                                            bq=bq, bkv=bkv, causal=causal)
                             for t in sets], iters=max(20, len(sets)))
        plain = time_ms(torch, [lambda t=t: flash_attention_ref(
            *t, q_lens=ql, kv_lens=kl, q_offsets=zero, causal=causal)
            for t in sets], iters=5, graph=False)
        lib = time_ms(torch, [lambda t=t: F.scaled_dot_product_attention(
            *t, is_causal=causal) for t in sets], iters=max(20, len(sets)))
        pairs = Sq * (Sq + 1) // 2 if causal else Sq * Skv
        b, by = bound(nbytes, 4 * B * H * pairs * D, "bfloat16")
        print(f"    flash_attention ({B}, {H}, {Sq}, {Skv}, {D}) bf16 "
              f"{'causal' if causal else 'non-causal'} ({key}, tiles "
              f"{(bq, bkv)}): {ms:.4f} ms (plain {plain:.4f}, "
              f"scaled_dot_product_attention {lib:.4f}, bound {b:.5f} by "
              f"{by})", flush=True)
        out["attention"][key] = {"ms": ms, "plain_ms": plain, "bound_ms": b,
                                 "bound_by": by, "library_ms": lib}
        del sets

    # kernel 3
    gen = torch.Generator(device=dev)
    gen.manual_seed(4)
    for key, (H, KV, T) in (("llava_rep7", (LLAVA["H"], LLAVA["KV"], 190)),
                            ("mistral_rep12", (MISTRAL["H"], MISTRAL["KV"],
                                               30))):
        B, ps, D = 4, 16, 128
        kv = [T * ps] * B
        pool_bytes = 2 * (B * T + 1) * ps * KV * D * 2
        cases = [paged_case(torch, gen, B=B, H=H, KV=KV, D=D, ps=ps, T=T,
                            kv_lens=kv, dtype=torch.bfloat16)
                 for _ in range(copies(pool_bytes))]
        ms = time_ms(torch, [lambda c=c: pa(*c[:4], kv_lens=c[4])
                             for c in cases])
        plain = time_ms(torch, [lambda c=c: paged_attention_ref(
            *c[:4], kv_lens=c[4]) for c in cases], iters=5, graph=False)
        keys = sum(kv)
        nbytes = (keys * KV * D * 2 * 2 + 2 * B * H * D * 2 + B * T * 4
                  + B * 4)
        b, by = bound(nbytes, 4 * H * D * keys, "bfloat16")
        splits, per = paged_splits(B, KV, T, sms)
        print(f"    paged_attention ({B}, {H}, {D}) bf16 rep {H // KV} over "
              f"{keys} keys ({kv[0]} a slot, {nbytes / 1e6:.1f} MB; {splits} "
              f"splits of {per} pages): {ms:.4f} ms (plain {plain:.4f}, no "
              f"single PyTorch call reads a page table; bound {b:.5f} by "
              f"{by})", flush=True)
        out["paged"][key] = {"ms": ms, "plain_ms": plain, "bound_ms": b,
                             "bound_by": by, "library_ms": None}
        del cases

    # kernel 1: one decode step of each path
    want_calls = {"seamless": SEAMLESS_MM["decode"],
                  "llava": 7 * LLAVA["layers"] + 1,
                  "qwen": 7 * QWEN["layers"] + 1,
                  "mistral": 7 * MISTRAL["layers"] + 1}
    for arch, calls_want in want_calls.items():
        tot = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "nbytes": 0,
               "ops": 0, "calls": 0}
        for name, m, k, n, calls, head in slice9_matmul_shapes(arch, 4):
            a = bf(m, k)
            ws = [bf(n, k) if head else bf(k, n)
                  for _ in range(copies(k * n * 2))]
            o = torch.float32 if head else torch.bfloat16
            cell = {
                "ms": time_ms(torch, [lambda w=w: mm(a, w, trans_b=head,
                                                     out_dtype=o)
                                      for w in ws]),
                "plain_ms": time_ms(torch, [lambda w=w: matmul_ref(
                    a, w.t() if head else w, o) for w in ws], iters=5,
                    graph=False),
                "library_ms": time_ms(torch, [lambda w=w: torch.matmul(
                    a, w.t() if head else w) for w in ws])}
            nbytes = (m * k + k * n) * 2 + m * n * (4 if head else 2)
            for key in ("ms", "plain_ms", "library_ms"):
                tot[key] += cell[key] * calls
            tot["nbytes"] += nbytes * calls
            tot["ops"] += 2 * m * n * k * calls
            tot["calls"] += calls
            b, by = bound(nbytes, 2 * m * n * k, "bfloat16")
            print(f"    zero_stall_matmul {name} M={m} K={k} N={n}: "
                  f"{cell['ms']:.4f} ms (plain {cell['plain_ms']:.4f}, "
                  f"torch.matmul {cell['library_ms']:.4f}, bound {b:.4f} by "
                  f"{by}) x {calls} a step")
            del ws
        require(tot["calls"] == calls_want, f"{arch}: {tot['calls']} "
                f"products timed, the step has {calls_want}")
        b, by = bound(tot["nbytes"], tot["ops"], "bfloat16")
        print(f"    zero_stall_matmul, one {arch} decode step (M=4), "
              f"{tot['calls']} launches: {tot['ms']:.3f} ms (plain "
              f"{tot['plain_ms']:.3f}, torch.matmul {tot['library_ms']:.3f}, "
              f"bound {b:.3f} by {by}: {tot['nbytes'] / 1e9:.2f} GB)",
              flush=True)
        out["matmul"][f"{arch}_decode_step"] = {
            "ms": tot["ms"], "plain_ms": tot["plain_ms"], "bound_ms": b,
            "bound_by": by, "library_ms": tot["library_ms"]}
        torch.cuda.empty_cache()
    return out


def ring_q6(x_q, w, x_s, w_s):
    """The earlier design of kernel 6 at its path tiles (bm 128, bn 128, bk
    128 codes, slots 2): the cp.async ring's grouped int8 entry of
    ``csrc/quantized_matmul.cu``, bound directly (the wrapper sends only
    ragged and misaligned shapes there), as a yardstick: bf16 out."""
    import torch

    from repro_torch.kernels import _build
    from repro_torch.kernels.quantized_matmul import _ARGTYPES
    from repro_torch.kernels.zero_stall_matmul import _vec_ok
    G, M, K = x_q.shape
    N = w.shape[-1]
    c = torch.empty((G, M, N), dtype=torch.bfloat16, device=x_q.device)
    fn = _build.bind("quantized_grouped_zero_stall_matmul", _ARGTYPES,
                     "quantized_matmul")
    code = fn(x_q.data_ptr(), w.data_ptr(), x_s.data_ptr(), w_s.data_ptr(),
              c.data_ptr(), G, M, N, K, 128, 128, 128, 2, 0,
              int(_vec_ok(x_q, w, K, N, True)),
              torch.cuda.current_stream(x_q.device).cuda_stream)
    _build.check("quantized_matmul", code)
    return c


if __name__ == "__main__":
    sys.exit(main())
